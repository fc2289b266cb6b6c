"""The serving plane's folded batch on the card.  These need a CUDA device
(the fold runs the window kernel, which has no CPU mode) and skip
without one; this file imports no JAX, so on a machine without it run
``python3 -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py``.

* A fold of 8 w20 lanes through K1/K2 equals the window's plain version
  on the same fold at chip_smoke.py's dense bar (max abs diff <= min(1e-6,
  1e-4 x largest |amp|)), launches once per planned sweep of the fold,
  and matches each lane's solo ``compile_fn_pallas`` run at that bar.
* Lane groups under the width cap (lowered to 21 qubits): 4 lanes of w20
  run as two folds of two lanes, each lane as its solo run.
* Four co-batched sessions of a service on the card land in one dispatch
  whose launches are the fold's planned sweeps.
"""

import numpy as np
import pytest
import torch

from qrack_tpu_torch import telemetry as tele
from qrack_tpu_torch.models.qft import qft_qcircuit
from qrack_tpu_torch.ops import window_kernel as wk
from qrack_tpu_torch.serve import batcher

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _lanes(n, b, dev, seed):
    gen = np.random.Generator(np.random.PCG64(seed))
    out = []
    for _ in range(b):
        v = torch.from_numpy(gen.standard_normal((2, 1 << n),
                                                 dtype=np.float32)).to(dev)
        out.append(v / torch.sqrt((v.double() ** 2).sum()).float())
    return out


def _bar(ref) -> float:
    return min(1e-6, 1e-4 * float(ref.abs().max()))


def test_fold_matches_plain_and_solo_runs(cuda_device):
    n, b = 20, 8
    circ = qft_qcircuit(n)
    lanes = _lanes(n, b, cuda_device, 19)
    before = [x.clone() for x in lanes]
    prog = batcher.FoldProgram(circ, n, torch.float32, cuda_device)
    wk.reset_launches()
    out = prog(lanes)
    torch.cuda.synchronize()
    got = wk.launches()
    assert got["in_tile"] + got["pair"] == prog.planned_sweeps(b)
    # the same fold through the plain version
    fold = torch.stack(before, dim=1)
    wk.apply_window(fold.view(2, b << n), n + 3, prog.structure, prog.fv,
                    prog.iv, prog.table, prog.block_pow, plain=True)
    for i in range(b):
        assert torch.equal(lanes[i], before[i])   # no lane written
        ref = fold[:, i]
        assert float((out[i] - ref).abs().max()) <= _bar(ref)
        solo = before[i].clone()
        circ.compile_fn_pallas(n)(solo)
        assert float((out[i] - solo).abs().max()) <= _bar(solo)


def test_lane_groups_at_the_width_cap(cuda_device, monkeypatch):
    """With the cap lowered to 21 qubits, 4 lanes of w20 run as two folds
    of two lanes, each lane as its solo run."""
    monkeypatch.setattr(batcher, "MAX_DENSE_QB", 21)
    n, b = 20, 4
    circ = qft_qcircuit(n)
    assert batcher.group_lanes(n, b) == [2, 2]
    lanes = _lanes(n, b, cuda_device, 29)
    prog = batcher.FoldProgram(circ, n, torch.float32, cuda_device)
    wk.reset_launches()
    out = prog(lanes)
    got = wk.launches()
    assert got["in_tile"] + got["pair"] == 2 * prog.sweeps(2)
    for i in range(b):
        solo = lanes[i].clone()
        circ.compile_fn_pallas(n)(solo)
        assert float((out[i] - solo).abs().max()) <= _bar(solo)


def test_service_cobatch_launches_the_folds_sweeps(cuda_device,
                                                   monkeypatch):
    from qrack_tpu_torch.serve import QrackService

    monkeypatch.setenv("QRACK_SERVE_PREFIX", "0")
    n = 18
    tele.enable()
    tele.reset()
    try:
        with QrackService(engine_layers="cuda", batch_window_ms=500.0,
                          max_batch=4, tick_s=0.02) as svc:
            sids = [svc.create_session(n, seed=k, rand_global_phase=False)
                    for k in range(4)]
            for k, sid in enumerate(sids):
                svc.call(sid, lambda e, k=k: e.X(k)).result(60)
            pre = [svc.call(s, lambda e: e.device_planes.clone()).result(60)
                   for s in sids]
            wk.reset_launches()
            for h in [svc.submit(s, qft_qcircuit(n)) for s in sids]:
                h.result(60)
            got = wk.launches()
            post = [svc.call(s, lambda e: e.device_planes.clone()).result(60)
                    for s in sids]
        c = tele.snapshot()["counters"]
    finally:
        tele.disable()
        tele.reset()
        batcher.clear_programs()
    assert c["serve.batch.dispatches"] == 1 and c["serve.batch.jobs"] == 4
    prog = batcher.FoldProgram(qft_qcircuit(n), n, torch.float32,
                               cuda_device)
    assert got["in_tile"] + got["pair"] == prog.planned_sweeps(4)
    for p, q in zip(pre, post):
        qft_qcircuit(n).compile_fn_pallas(n)(p)
        assert float((p - q).abs().max()) <= _bar(p)
