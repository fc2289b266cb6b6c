"""The port's QStabilizerHybrid against the JAX package's on the same
seeded streams, after tests/test_stabilizer_hybrid.py.

The port runs over its ``cpu`` terminal (QEngineCPU) and over ``hybrid``
with the CUDA half on ``device="cpu"`` and a threshold of 3 qubits; the
JAX side runs over its QEngineCPU.  After every gate both stacks must
agree on ``on_tableau()`` and the gadget ancilla count, so they switch
to the dense engine at the same gate.  Bars: kets within 1e-10 over the
complex128 ``cpu`` terminal, 1e-6 where float32 planes take part; equal
measurement outcomes from equal seeds.
"""

import numpy as np
import pytest

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu.layers.stabilizerhybrid import QStabilizerHybrid as JaxSH
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.engines.cpu import QEngineCPU
from qrack_tpu_torch.engines.cuda import QEngineCUDA
from qrack_tpu_torch.engines.hybrid import QHybrid
from qrack_tpu_torch.layers.stabilizerhybrid import QStabilizerHybrid
from qrack_tpu_torch.utils.rng import QrackRandom

from test_torch_stabilizer import clifford_stream

TERMINALS = {
    "cpu": (lambda n, **kw: QEngineCPU(n, **kw), 1e-10),
    "hybrid": (lambda n, **kw: QHybrid(n, tpu_threshold_qubits=3,
                                       device="cpu", **kw), 1e-6),
}


def jax_factory(n, **kw):
    return JaxCPU(n, **kw)


def make(n, seed, terminal):
    fac, atol = TERMINALS[terminal]
    port = QStabilizerHybrid(n, engine_factory=fac, rng=QrackRandom(seed),
                             rand_global_phase=False)
    ref = JaxSH(n, engine_factory=jax_factory, rng=JaxRandom(seed),
                rand_global_phase=False)
    return port, ref, atol


def mixed_stream(seed, n, depth, general=True):
    """Seeded near-Clifford calls: Cliffords, T/IT, small RZ, CNOT/CZ
    and, when `general`, RY and U payloads that force the engine."""
    rng = np.random.default_rng(seed)
    cliff = clifford_stream(seed + 7, n, depth)
    out = []
    for i in range(depth):
        kind = int(rng.integers(8 if general else 6))
        t = int(rng.integers(n))
        c = int((t + 1 + rng.integers(n - 1)) % n)
        ang = float(rng.uniform(-np.pi, np.pi))
        out.append([cliff[i % len(cliff)], ("T", (t,)), ("IT", (t,)),
                    ("RZ", (ang, t)), ("CNOT", (c, t)), ("CZ", (c, t)),
                    ("RY", (ang, t)), ("U", (t, ang, 0.3, -0.2))][kind])
    return out


def run_lockstep(port, ref, stream):
    """Apply a stream to both stacks; they must stay on the tableau, and
    keep the same number of gadget ancillae, gate for gate."""
    for name, args in stream:
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
        assert port.on_tableau() == ref.on_tableau(), name
        assert port._anc == ref._anc, name


def assert_kets(port, ref, atol):
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("terminal", sorted(TERMINALS))
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_mixed_streams_match_jax(seed, terminal):
    n = 5
    port, ref, atol = make(n, seed, terminal)
    run_lockstep(port, ref, mixed_stream(seed, n, 50))
    assert_kets(port, ref, atol)
    assert port.GetUnitaryFidelity() == pytest.approx(
        ref.GetUnitaryFidelity(), abs=1e-12)
    assert [port.M(q) for q in range(n)] == [ref.M(q) for q in range(n)]


@pytest.mark.parametrize("terminal", sorted(TERMINALS))
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_t_gadget_keeps_the_tableau(seed, terminal):
    """Near-Clifford streams (no general payload): the T-gadget moves
    every blocked phase onto ancillae, equally in both packages."""
    n = 4
    port, ref, atol = make(n, seed, terminal)
    run_lockstep(port, ref, mixed_stream(seed, n, 40, general=False))
    assert port.on_tableau() and ref.on_tableau()
    assert port._anc == ref._anc
    assert_kets(port, ref, atol)
    port.SwitchToEngine()
    ref.SwitchToEngine()
    assert port._anc == ref._anc == 0
    assert_kets(port, ref, atol)


@pytest.mark.parametrize("terminal", sorted(TERMINALS))
def test_switch_builds_the_terminal_on_the_callers_device(terminal):
    port, ref, atol = make(4, 8, terminal)
    run_lockstep(port, ref, [("H", (0,)), ("RY", (0.7, 1)), ("CNOT", (0, 1)),
                             ("T", (2,)), ("CNOT", (2, 3))])
    assert not port.on_tableau()
    if terminal == "hybrid":
        assert isinstance(port.engine, QHybrid)
        assert isinstance(port.engine._engine, QEngineCUDA)
        assert port.engine._engine.device.type == "cpu"
    else:
        assert isinstance(port.engine, QEngineCPU)
    assert_kets(port, ref, atol)
    c = port.Clone()
    assert type(c.engine) is type(port.engine)
    assert_kets(c, ref, atol)


@pytest.mark.parametrize("ncrp", [0.0, 0.2])
def test_near_clifford_rounding_log_fidelity(ncrp):
    port, ref, atol = make(3, 9, "cpu")
    port.SetNcrp(ncrp)
    ref.SetNcrp(ncrp)
    run_lockstep(port, ref, [("H", (0,)), ("RZ", (0.1, 0)), ("H", (0,)),
                             ("H", (1,)), ("RZ", (0.3, 1)), ("CNOT", (1, 2)),
                             ("H", (1,))])
    assert port.log_fidelity == pytest.approx(ref.log_fidelity, abs=1e-14)
    assert (port.log_fidelity < 0) == (ncrp > 0)
    assert_kets(port, ref, atol)


@pytest.mark.parametrize("terminal", sorted(TERMINALS))
def test_structure_ops_match_jax(terminal):
    n = 4
    port, ref, atol = make(n, 10, terminal)
    run_lockstep(port, ref, mixed_stream(10, n, 20, general=False))
    fac, _ = TERMINALS[terminal]
    op = QStabilizerHybrid(2, engine_factory=fac, rng=QrackRandom(11),
                           rand_global_phase=False)
    oref = JaxSH(2, engine_factory=jax_factory, rng=JaxRandom(11),
                 rand_global_phase=False)
    for e in (op, oref):
        e.H(0)
        e.CNOT(0, 1)
        e.S(1)
    assert port.Compose(op) == ref.Compose(oref) == n
    assert port.on_tableau() == ref.on_tableau()
    assert_kets(port, ref, atol)
    # mid insertion goes to the engine in both
    x = [QStabilizerHybrid(1, engine_factory=fac, rng=QrackRandom(12),
                           rand_global_phase=False),
         JaxSH(1, engine_factory=jax_factory, rng=JaxRandom(12),
               rand_global_phase=False)]
    for e in x:
        e.X(0)
    assert port.Compose(x[0], 1) == ref.Compose(x[1], 1) == 1
    assert port.on_tableau() == ref.on_tableau()
    assert_kets(port, ref, atol)
    assert port.Allocate(port.qubit_count, 2) == ref.Allocate(
        ref.qubit_count, 2)
    port.Dispose(port.qubit_count - 2, 2)
    ref.Dispose(ref.qubit_count - 2, 2)
    dp = QStabilizerHybrid(2, engine_factory=fac, rng=QrackRandom(13),
                           rand_global_phase=False)
    dr = JaxSH(2, engine_factory=jax_factory, rng=JaxRandom(13),
               rand_global_phase=False)
    port.Decompose(n + 1, dp)
    ref.Decompose(n + 1, dr)
    assert_kets(port, ref, atol)
    assert_kets(dp, dr, atol)


def test_alu_forwarding_switches_to_the_engine():
    port, ref, atol = make(7, 14, "hybrid")
    for e in (port, ref):
        e.HReg(0, 3)
        e.INC(3, 0, 4)
        e.T(0)
        e.INC(1, 0, 4)
    assert not port.on_tableau() and not ref.on_tableau()
    assert_kets(port, ref, atol)
    assert port.MAll() == ref.MAll()


def test_teleport_outcomes_match_jax():
    for t in range(6):
        port, ref, atol = make(3, 40 + t, "cpu")
        res = []
        for q in (port, ref):
            q.U(0, 0.8, 0.3, -0.5)
            want = q.Prob(0)
            q.H(1)
            q.CNOT(1, 2)
            q.CNOT(0, 1)
            q.H(0)
            m0, m1 = q.M(0), q.M(1)
            if m1:
                q.X(2)
            if m0:
                q.Z(2)
            assert abs(q.Prob(2) - want) < 1e-6
            res.append((m0, m1))
        assert res[0] == res[1]


def test_t_injection_toggle():
    port, ref, atol = make(2, 15, "cpu")
    for e in (port, ref):
        e.SetTInjection(False)
        assert not e.GetTInjection()
    run_lockstep(port, ref, [("H", (0,)), ("T", (0,)), ("H", (0,)),
                             ("CNOT", (0, 1))])
    assert not port.on_tableau()
    assert_kets(port, ref, atol)


def test_factory_stack_defaults_to_qhybrid():
    q = qt.create_quantum_interface(["stabilizer_hybrid", "hybrid"], 4,
                                    device="cpu", rng=QrackRandom(16),
                                    rand_global_phase=False)
    assert isinstance(q, QStabilizerHybrid)
    q.H(0)
    q.RX(0.3, 0)
    q.CNOT(0, 1)
    assert not q.on_tableau() and isinstance(q.engine, QHybrid)
    o = QEngineCPU(4, rng=QrackRandom(1), rand_global_phase=False)
    o.H(0)
    o.RX(0.3, 0)
    o.CNOT(0, 1)
    np.testing.assert_allclose(q.GetQuantumState(), o.GetQuantumState(),
                               atol=1e-12)
