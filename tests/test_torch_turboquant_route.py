"""The routed TurboQuant tier through the port's serving plane against
the JAX package's: the counterparts of tests/test_turboquant_route.py's
two service tests (an over-budget dense job routed onto the compressed
rung and served, a quantized session's checkpoint round trip through
drain and recover).  The port's stacks run with ``device="cpu"``;
quantized kets are held to the JAX tests' floors (1e-3 for the ladder's
serving contract, 1 - 1e-5 for 16-bit codes at w6) against the
complex128 oracle and against each other.

Not ported here: the file's cost-model, fused-window, fuzz and guard
tests, and ``test_drift_giveup_escalates_routed_session_to_dense``: on
the port's routed w4 session (16-bit codes, block_pow 2, chunk_qb 3) the
amp-corrupt at ``turboquant.dispatch`` fires and is not detected, so
nothing gives up or escalates (ROADMAP §C).
"""

import pytest

from qrack_tpu import QEngineCPU
from qrack_tpu.models.qft import qft_qcircuit as j_qft
from qrack_tpu.serve import QrackService as JService
from qrack_tpu.utils.rng import QrackRandom as JR

from qrack_tpu_torch.models.qft import qft_qcircuit as t_qft
from qrack_tpu_torch.resilience import integrity as tinteg
from qrack_tpu_torch.serve import QrackService as TService

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
