"""The fleet on the card.  These need a CUDA device (each worker's dense
sessions run the window kernel, which has no CPU mode) and skip without
one; this file imports no JAX, so on a machine without it run
``python3 -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py``.

* Two workers serve a w20 dense session on the card; the owner is
  killed with SIGKILL, the next job lands once on the peer, and the
  adopted ket (read back from the store's every-job snapshot in this
  process) equals an uninterrupted in-process ``QrackService`` run of
  the same jobs bit for bit (``torch.equal``); the dead worker comes
  back ``healthy`` with one crash, and the workers' K1/K2 launches (from
  their beats) are nonzero.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from qrack_tpu_torch import matrices as mat
from qrack_tpu_torch.checkpoint.store import CheckpointStore
from qrack_tpu_torch.fleet import FleetFrontDoor, FleetSupervisor
from qrack_tpu_torch.layers.qcircuit import QCircuit
from qrack_tpu_torch.models.qft import qft_qcircuit
from qrack_tpu_torch.ops import cuda_build
from qrack_tpu_torch.ops import turboquant_kernel as tqk
from qrack_tpu_torch.ops import window_kernel as wk
from qrack_tpu_torch.serve import QrackService

pytestmark = pytest.mark.cuda

N = 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _wave(n, seed, gates=24):
    rng = np.random.Generator(np.random.PCG64(seed))
    c = QCircuit(n)
    for _ in range(gates):
        t = int(rng.integers(0, n))
        if rng.random() < 0.6:
            c.append_1q(t, mat.u3_mtrx(*(float(x) for x in
                                         rng.uniform(0, 2 * np.pi, 3))))
        else:
            c.append_ctrl([(t + 1 + int(rng.integers(0, n - 1))) % n], t,
                          mat.X2, 1)
    return c


def settled_planes(store_dir, sid, device, timeout_s=60.0):
    """The session's planes from its every-job snapshot, once its last
    job settled (the WAL entry goes after the snapshot is written)."""
    store = CheckpointStore(store_dir)
    deadline = time.monotonic() + timeout_s
    while store.wal_pending_tags(sids=[sid]):
        assert time.monotonic() < deadline, "the last job never settled"
        time.sleep(0.01)
    store.reload()
    return store.load(sid, device=device).device_planes


def test_kill9_adoption_on_the_card_equals_an_uninterrupted_run(
        cuda_device, tmp_path, monkeypatch):
    # no prefix split in the workers (they inherit it) nor in the
    # reference service: both run each job whole
    monkeypatch.setenv("QRACK_SERVE_PREFIX", "0")
    jobs = [qft_qcircuit(N), _wave(N, 1), _wave(N, 2)]
    root = tmp_path / "fleet"
    store_dir = str(root / "store")
    # the workers load the libraries this process builds into the store
    cache = os.path.join(store_dir, "kernel_cache")
    os.makedirs(cache, exist_ok=True)
    cuda_build.set_build_dir(cache)
    try:
        cuda_build.build([wk.SOURCE, tqk.SOURCE])
    finally:
        cuda_build.set_build_dir(None)
    with FleetSupervisor(2, str(root), ready_timeout_s=300.0) as sup:
        sup.start()
        front = FleetFrontDoor(sup)
        sid = front.create_session(N, seed=3, rand_global_phase=False)
        front.apply(sid, jobs[0])
        owner = sup.owner_of(sid)
        os.kill(sup.stats()["workers"][owner]["pid"], signal.SIGKILL)
        for c in jobs[1:]:
            front.apply(sid, c)
        adopter = sup.owner_of(sid)
        assert adopter != owner
        deadline = time.monotonic() + 120
        while {w["state"] for w in sup.stats()["workers"].values()} \
                != {"healthy"}:
            assert time.monotonic() < deadline, sup.stats()
            time.sleep(0.1)
        assert sup.stats()["workers"][owner]["crashes"] == 1
        assert [d["reason"] for d in sup.stats()["deaths"]] == ["exit"]
        got = settled_planes(store_dir, sid, cuda_device)
        launched = sup.kernel_launches()
    with QrackService(engine_layers="cuda", device=cuda_device,
                      tick_s=0.02) as ref:
        rsid = ref.create_session(N, seed=3, rand_global_phase=False)
        for c in jobs:
            ref.apply(rsid, c, timeout=300)
        want = ref.call(rsid, lambda e: e.device_planes.clone(),
                        mutates=False).result(300)
    assert torch.equal(got, want)
    total = {k: sum(v.get("window", {}).get("float32", {}).get(k, 0)
                    for v in launched.values()) for k in ("in_tile", "pair")}
    assert total["in_tile"] > 0 and total["pair"] > 0, launched
