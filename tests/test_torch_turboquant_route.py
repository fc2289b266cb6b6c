"""The routed TurboQuant tier through the port's serving plane against
the JAX package's: the counterparts of tests/test_turboquant_route.py's
two service tests (an over-budget dense job routed onto the compressed
rung and served, a quantized session's checkpoint round trip through
drain and recover).  The port's stacks run with ``device="cpu"``;
quantized kets are held to the JAX tests' floors (1e-3 for the ladder's
serving contract, 1 - 1e-5 for 16-bit codes at w6) against the
complex128 oracle and against each other.

Also its drift give-up: a routed w4 session whose corrupted window
exhausts its replays escalates to the dense rung on both packages (the
JAX strike at ``tpu.fuse.flush``, the port's at ``turboquant.dispatch``),
with the same give-up and escalation counts.

Not ported here: the file's cost-model, fused-window, fuzz and guard
tests.
"""

import pytest

from qrack_tpu import QEngineCPU
from qrack_tpu import create_quantum_interface as j_create
from qrack_tpu.models.qft import qft_qcircuit as j_qft
from qrack_tpu.serve import QrackService as JService
from qrack_tpu.utils.rng import QrackRandom as JR

from qrack_tpu_torch import create_quantum_interface as t_create
from qrack_tpu_torch.models.qft import qft_qcircuit as t_qft
from qrack_tpu_torch.resilience import integrity as tinteg
from qrack_tpu_torch.serve import QrackService as TService
from qrack_tpu_torch.utils.rng import QrackRandom as TR

from qrack_tpu.resilience import integrity as jinteg

from test_torch_serve import (JAX, SIDES, _clean_serve,  # noqa: F401
                              fidelity)

N = 6
_TQ = {"bits": 16, "chunk_qb": 3, "block_pow": 2}
_TQ_FLOOR = 1 - 1e-5


@pytest.fixture(autouse=True)
def _clean(monkeypatch, _clean_serve):
    monkeypatch.delenv("QRACK_ROUTE", raising=False)
    monkeypatch.delenv("QRACK_ROUTE_HBM_BYTES", raising=False)
    yield
    for integ in (jinteg, tinteg):
        integ.reset()
        integ.set_enabled(False)


def _service(side, **kw):
    if side is JAX:
        return JService(engine_layers="route", **kw)
    return TService(engine_layers="route", device="cpu", **kw)


def _oracle(n, seed=5):
    o = QEngineCPU(n, rng=JR(seed), rand_global_phase=False)
    j_qft(n).Run(o)
    return o.GetQuantumState()


def test_overbudget_dense_job_routes_to_turboquant_and_serves(monkeypatch):
    monkeypatch.setenv("QRACK_ROUTE_HBM_BYTES", "2048")  # blocks dense w8
    states = {}
    for side in SIDES:
        side.tele.enable()
        side.tele.reset()
        qft = j_qft if side is JAX else t_qft
        with _service(side, batch_window_ms=5.0, tick_s=0.02) as svc:
            sid = svc.create_session(8, seed=5, rand_global_phase=False,
                                     **_TQ)
            svc.apply(sid, qft(8), timeout=120)
            states[side.name] = svc.get_state(sid, timeout=120)
            stack = svc.sessions.get(sid).engine.current_stack()
        assert stack == "turboquant"
        snap = side.tele.snapshot()
        assert snap["counters"].get("route.built.turboquant", 0) >= 1
    assert fidelity(_oracle(8), states["port"]) > 1 - 1e-3
    assert fidelity(states["jax"], states["port"]) > 1 - 1e-3


def test_quantized_session_checkpoint_roundtrip_serve_recover(
        monkeypatch, tmp_path):
    monkeypatch.setenv("QRACK_ROUTE", "turboquant")
    states = {}
    for side in SIDES:
        ck = str(tmp_path / side.name / "ck")
        qft = j_qft if side is JAX else t_qft
        a = _service(side, checkpoint_dir=ck, batch_window_ms=5.0,
                     tick_s=0.02)
        try:
            sid = a.create_session(N, seed=5, rand_global_phase=False,
                                   **_TQ)
            a.apply(sid, qft(N), timeout=120)
            assert a.drain() == {"drained": [sid], "busy": []}
            with _service(side, checkpoint_dir=ck, recover=True,
                          batch_window_ms=5.0, tick_s=0.02) as b:
                assert sid in b.sessions.ids()
                states[side.name] = b.get_state(sid, timeout=120)
                assert b.sessions.get(sid).engine.current_stack() == \
                    "turboquant"
        finally:
            a.close()
    assert fidelity(_oracle(N), states["port"]) > _TQ_FLOOR
    assert fidelity(states["jax"], states["port"]) > _TQ_FLOOR


# ---------------------------------------------------------------------------
# fidelity guard: exhausted drift replays escalate up the ladder
# ---------------------------------------------------------------------------

def test_drift_giveup_escalates_routed_session_to_dense(monkeypatch):
    monkeypatch.setenv("QRACK_ROUTE", "turboquant")
    monkeypatch.setenv("QRACK_TPU_INTEGRITY_REPLAYS", "0")
    out = {}
    for side in SIDES:
        integ = jinteg if side is JAX else tinteg
        side.tele.enable()
        side.tele.reset()
        if side is JAX:
            q = j_create(("route",), 4, rng=JR(7),
                         rand_global_phase=False, **_TQ)
            site = "tpu.fuse.flush"
        else:
            q = t_create(("route",), 4, rng=TR(7),
                         rand_global_phase=False, device="cpu", **_TQ)
            site = "turboquant.dispatch"
        # spread mass into every block row first, as the JAX test does
        for t in range(4):
            q.H(t)
        q.RZ(1.0, 0)
        _ = q.Prob(0)  # clean flush of the prep
        assert q.current_stack() == "turboquant"
        integ.set_enabled(True)
        side.res.enable()
        q.H(1)
        q.H(2)
        # the seeded strike lands on the scale of block 3, which H(2)
        # empties: the port's window cancels it exactly, so only the
        # scale-beside-zero-codes invariant sees it (ROADMAP §C)
        side.faults.inject(site, "amp-corrupt", times=1, seed=11)
        state = q.GetQuantumState()
        side.faults.clear()
        assert q.current_stack() == "dense"
        assert q._escalated
        c = side.tele.snapshot()["counters"]
        assert c.get("integrity.violation", 0) == 1
        assert c.get("integrity.replay.giveup", 0) == 1
        assert c.get("route.misroute.escalated", 0) == 1
        out[side.name] = state
    oracle = QEngineCPU(4, rng=JR(7), rand_global_phase=False)
    for t in range(4):
        oracle.H(t)
    oracle.RZ(1.0, 0)
    oracle.H(1)
    oracle.H(2)
    want = oracle.GetQuantumState()
    for name in ("jax", "port"):
        assert fidelity(want, out[name]) > 1 - 1e-3
    assert fidelity(out["jax"], out["port"]) > 1 - 1e-3
