#!/usr/bin/env python3
"""Host and card rates behind the checkpoint plane, and the repeat of
the dense engine's MAll draw.

    python3 scripts/checkpoint_probe.py [--gib 8] [--no-card]

Prints one JSON line:

* host: zlib.crc32 and sha256 over the array (GB/s), a raw write of it
  in 64 MiB slices and its fsync, a readinto back; the container's
  save and load of it (qrack_tpu_torch/checkpoint/container.py, with the
  parts of LAST_SAVE/LAST_LOAD); np.savez_compressed and np.load of
  1 GiB of it, the deflated form the JAX package's container writes;
* card (with a CUDA device): a card -> host copy of the array
  (pageable), and 30 MAll draws on one seeded w20 ket in each plane
  dtype through a torch.cumsum on the card and through
  gatekernels.draw_index, counted as distinct values.

Files go to a temporary directory under QRACK_SMOKE_TMP, else the
system's, and are deleted.
"""

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def gbps(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9


def host_rates(a: np.ndarray, root: str) -> dict:
    from qrack_tpu_torch.checkpoint import container as ckc

    out = {"bytes": a.nbytes}
    mv = a.reshape(-1).view(np.uint8).data
    t0 = time.perf_counter()
    zlib.crc32(mv)
    out["crc32_gbps"] = gbps(a.nbytes, time.perf_counter() - t0)
    t0 = time.perf_counter()
    hashlib.sha256(mv).hexdigest()
    out["sha256_gbps"] = gbps(a.nbytes, time.perf_counter() - t0)
    path = os.path.join(root, "raw.bin")
    with open(path, "wb") as f:
        t0 = time.perf_counter()
        for s in range(0, a.nbytes, 1 << 26):
            f.write(mv[s:s + (1 << 26)])
        f.flush()
        out["write_gbps"] = gbps(a.nbytes, time.perf_counter() - t0)
        t0 = time.perf_counter()
        os.fsync(f.fileno())
        out["fsync_s"] = time.perf_counter() - t0
    b = np.empty_like(a)
    with open(path, "rb") as f:
        t0 = time.perf_counter()
        f.readinto(b.reshape(-1).view(np.uint8).data)
        out["readinto_gbps"] = gbps(a.nbytes, time.perf_counter() - t0)
    os.unlink(path)
    del b
    path = os.path.join(root, "c.qckpt")
    t0 = time.perf_counter()
    ckc.save_container(path, {"planes": a})
    out["container_save_s"] = time.perf_counter() - t0
    out["container_save_parts"] = dict(ckc.LAST_SAVE)
    t0 = time.perf_counter()
    _, _, got = ckc.load_container(path)
    out["container_load_s"] = time.perf_counter() - t0
    out["container_load_parts"] = dict(ckc.LAST_LOAD)
    assert np.array_equal(got["planes"], a)
    del got
    os.unlink(path)
    one = a.reshape(-1)[:1 << 28]    # 1 GiB of float32
    path = os.path.join(root, "z.npz")
    t0 = time.perf_counter()
    np.savez_compressed(path, planes=one)
    out["deflated_1gib_save_s"] = time.perf_counter() - t0
    out["deflated_1gib_file_share"] = os.path.getsize(path) / one.nbytes
    t0 = time.perf_counter()
    with np.load(path) as z:
        z["planes"]
    out["deflated_1gib_load_s"] = time.perf_counter() - t0
    os.unlink(path)
    return out


def card_rates(a: np.ndarray) -> dict:
    import torch

    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import gatekernels as gk
    from qrack_tpu_torch.utils.rng import QrackRandom

    out = {}
    g = torch.from_numpy(a).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g.cpu()
    out["d2h_pageable_gbps"] = gbps(a.nbytes, time.perf_counter() - t0)
    del g
    draws = {}
    for dt in ("float32", "bfloat16", "float16"):
        q = qt.create_quantum_interface("cuda", 20, dtype=dt,
                                        rng=QrackRandom(7))
        q.QFT(0, 20)
        for t in range(0, 20, 3):
            q.T(t)
            q.CNOT(t, (t + 7) % 20)
        q.H(3)
        st = q.device_planes
        u = 0.6180339887

        def cumsum_draw():
            p = st[0] ** 2 + st[1] ** 2
            cdf = torch.cumsum(p, 0)
            return int(torch.searchsorted(cdf, cdf[-1:] * u, right=True)[0])
        draws[dt] = {
            "cumsum_distinct": len({cumsum_draw() for _ in range(30)}),
            "draw_index_distinct": len({gk.draw_index(st, u)
                                        for _ in range(30)})}
    out["mall_draws_30_calls"] = draws
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=int, default=8)
    ap.add_argument("--no-card", action="store_true")
    args = ap.parse_args()
    a = np.random.default_rng(0).standard_normal(
        (2, (args.gib << 30) // 8)).astype(np.float32)
    root = tempfile.mkdtemp(prefix="qrack-probe-",
                            dir=os.environ.get("QRACK_SMOKE_TMP"))
    try:
        out = {"host": host_rates(a, root)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not args.no_card:
        out["card"] = card_rates(a)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
