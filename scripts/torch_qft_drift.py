"""Does a tree's code move the dense w30 QFT wall between chip_smoke.py's
phase 4 and phases 37-38?  Phases 37 and 38 hold the disabled-telemetry
and plane-off w30 engine QFT to at most 2% above phase 4's warm walls,
taken ten minutes earlier in a full run.  This script runs, for each
tree given (a checkout of the repo, the port's package and its
chip_smoke.py), on one CUDA card:

1. a phase-4 reference: three engine QFTs on a fresh w30 engine, the
   last two kept (phase 4's ``engine_qft_ms[1:]``), which becomes the
   tree's ``PHASE4_WARM``;
2. the tree's own phases 29-38 as its full run orders them (pager,
   wide, telemetry, resilience), with its own bars; a failed bar of
   phase 37 or 38 is recorded, not raised;
3. the reference again.

Each tree runs in a process of its own, in the order given, so
``python3 scripts/torch_qft_drift.py PARENT . . PARENT`` alternates a
parent checkout and this one.  One JSON line a run, ``DRIFT {...}``:
the references before and after, phase 37's disabled and phase 38's
plane-off walls with their ratio to the first reference, and the bars'
outcome.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _reference(cs) -> list:
    """Phase 4's warm walls: three QFTs on a fresh engine, the last two."""
    import qrack_tpu_torch as qt

    cs.release()
    q = qt.create_quantum_interface("cuda", cs.WIDTH)
    walls = []
    for _ in range(3):
        q.SetPermutation(cs.PERM)
        walls.append(cs.timed(lambda: (q.QFT(0, cs.WIDTH), q.device_planes)))
    del q
    cs.release()
    return walls[1:]


def run_one(tree: str) -> dict:
    """Steps 1-3 of the module docstring on `tree`, in this process."""
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from qrack_tpu_torch.ops import cuda_build
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.ops import window_kernel as wk

    seen = []
    real_emit = cs.emit

    def emit(obj):
        seen.append(obj)
        real_emit(obj)

    cs.emit = emit
    card = cs.card_line()
    dev = torch.device(cs.DEVICE)
    cuda_build.build([wk.SOURCE, tqk.SOURCE])
    wk.load_library()
    tqk.load_library()
    t0 = time.time()
    before = _reference(cs)
    cs.PHASE4_WARM[:] = before
    probe = cs.PageProbe(wk, cs.PAGER_SEED, cs.PAGER_HELD)
    cs.pager_parity(card, dev, probe)
    cs.pager_qft(card, dev)
    cs.pager_w33(card, dev)
    cs.pager_factory(card, dev)
    cs.wide_ops(card, dev)
    cs.page_programs(card, dev)
    cs.tq_pager(card, dev)
    cs.unit_multi(card, dev)
    bars = {}
    for name, fn in (("phase37", cs.telemetry_phase),
                     ("phase38", cs.resilience_phase)):
        try:
            fn(card, dev)
            bars[name] = "passed"
        except AssertionError as e:
            bars[name] = str(e)
    after = _reference(cs)
    ref = float(np.median(before))
    out = {"tree": tree, "card": card, "ref_before_ms": before,
           "ref_after_ms": after,
           "after_rel": float(np.median(after)) / ref - 1.0, "bars": bars,
           "seconds": time.time() - t0}
    for o in seen:
        if o.get("phase") == "telemetry":
            out["phase37_disabled_ms"] = o["disabled_ms"]
            out["phase37_rel"] = o["disabled_median_ms"] / ref - 1.0
        if o.get("phase") == "resilience":
            out["phase38_off_ms"] = o["off"]["off_ms"]
            off = float(np.median(o["off"]["off_ms"]))
            out["phase38_rel"] = off / ref - 1.0
    return out


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print("DRIFT " + json.dumps(run_one(args[1])), flush=True)
        return 0
    if not args:
        print(__doc__)
        return 2
    rc = 0
    for tree in args:
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True, text=True)
        lines = [ln for ln in got.stdout.splitlines()
                 if ln.startswith("DRIFT ")]
        print(lines[-1] if lines else json.dumps(
            {"tree": tree, "rc": got.returncode,
             "stderr": got.stderr[-2000:]}), flush=True)
        rc = rc or got.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
