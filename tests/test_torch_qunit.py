"""The port's QUnit and QUnitClifford against the JAX package's on the
same seeded streams, after tests/test_qunit.py, tests/test_qunit_fusion.py
and tests/test_qunitclifford.py.

Stacks, port against JAX:

* "engine": QUnit over QEngineCPU units, both packages;
* "stab_cpu": QUnit -> QStabilizerHybrid -> QEngineCPU, both packages;
* "optimal": the port's OPTIMAL stack on ``device="cpu"`` with QHybrid's
  threshold at 3 qubits, so its CUDA engine (float32 planes) holds the
  wider units, against the JAX stack "stab_cpu".

Kets, ``GetUnitCount``, ``GetMaxUnitSize`` and ``dispatch_count`` must
be equal on the same streams (so phase fusion and factoring match),
measurements equal from equal seeds.  Bars: kets within 1e-10 over
complex128 units, 1e-6 where float32 planes take part.
"""

import numpy as np
import pytest

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu.layers.qunit import QUnit as JaxQUnit
from qrack_tpu.layers.qunitclifford import QUnitClifford as JaxQUC
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch import matrices as mat
from qrack_tpu_torch.engines.cpu import QEngineCPU
from qrack_tpu_torch.engines.hybrid import QHybrid
from qrack_tpu_torch.layers.qunit import QUnit
from qrack_tpu_torch.layers.qunitclifford import QUnitClifford
from qrack_tpu_torch.layers.stabilizer import CliffordError
from qrack_tpu_torch.utils.rng import QrackRandom

from test_torch_stabilizer import clifford_stream

EXACT, F32 = 1e-10, 1e-6
STACKS = ("engine", "stab_cpu", "optimal")


def make(stack, n, seed, **kw):
    common = dict(rand_global_phase=False, **kw)
    if stack == "engine":
        port = QUnit(n, unit_factory=lambda m, **k: QEngineCPU(m, **k),
                     rng=QrackRandom(seed), **common)
        ref = JaxQUnit(n, unit_factory=lambda m, **k: JaxCPU(m, **k),
                       rng=JaxRandom(seed), **common)
        return port, ref, EXACT
    ref = jax_create(["unit", "stabilizer_hybrid", "cpu"], n,
                     rng=JaxRandom(seed), **common)
    if stack == "stab_cpu":
        port = qt.create_quantum_interface(["unit", "stabilizer_hybrid", "cpu"],
                                           n, rng=QrackRandom(seed), **common)
        return port, ref, EXACT
    port = qt.create_quantum_interface("optimal", n, rng=QrackRandom(seed),
                                       device="cpu", tpu_threshold_qubits=3,
                                       **common)
    return port, ref, F32


def universal_stream(seed, n, depth):
    """Seeded universal calls: 1-qubit Cliffords and rotations, T,
    CNOT/CZ/CY/Swap, CPhase-style controlled diagonals, CCNOT and a
    doubly controlled general payload."""
    rng = np.random.default_rng(seed)
    cliff = clifford_stream(seed + 3, n, depth)
    out = []
    for i in range(depth):
        kind = int(rng.integers(12))
        a, b, c = (int(x) for x in rng.choice(n, 3, replace=False))
        ang = [float(x) for x in rng.uniform(-np.pi, np.pi, 3)]
        out.append([
            cliff[i % len(cliff)], ("T", (a,)), ("RZ", (ang[0], a)), ("RY", (ang[1], a)),
            ("U", (a, *ang)), ("CNOT", (a, b)), ("CZ", (a, b)),
            ("CY", (a, b)), ("MCPhase", ((a,), 1.0, np.exp(1j * ang[2]), b)),
            ("CCNOT", (a, b, c)),
            ("MCMtrx", ((a, b), mat.u3_mtrx(*ang), c)),
            ("Swap", (a, b))][kind])
    return out


def run(engines, stream):
    for name, args in stream:
        for e in engines:
            getattr(e, name)(*args)


def assert_twins(port, ref, atol):
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=atol, rtol=0)
    assert port.GetUnitCount() == ref.GetUnitCount()
    assert port.GetMaxUnitSize() == ref.GetMaxUnitSize()
    assert port.dispatch_count == ref.dispatch_count


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("fusion", [True, False])
def test_universal_streams_match_jax(stack, seed, fusion):
    n = 6
    port, ref, atol = make(stack, n, seed, phase_fusion=fusion)
    run((port, ref), universal_stream(seed, n, 40))
    assert_twins(port, ref, atol)
    for q in range(n):
        assert port.Prob(q) == pytest.approx(ref.Prob(q), abs=atol)
    assert [port.M(q) for q in (0, 2, 4)] == [ref.M(q) for q in (0, 2, 4)]
    assert port.GetUnitCount() == ref.GetUnitCount()
    assert port.MAll() == ref.MAll()


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("seed", [4, 5])
def test_clifford_streams_stay_factored_like_jax(stack, seed):
    n = 8
    port, ref, atol = make(stack, n, seed)
    run((port, ref), clifford_stream(seed, n, 60))
    assert_twins(port, ref, atol)
    assert port.compose_count >= 0 and port.swap_count >= 0


@pytest.mark.parametrize("stack", STACKS)
def test_try_separate_matches_jax(stack):
    port, ref, atol = make(stack, 3, 11)
    for e in (port, ref):
        e.RY(0.3, 0)
        e.RY(0.7, 1)
        e.CNOT(0, 1)
        e.Prob(1)
        e.CNOT(0, 1)
        e.Prob(1)
    assert port.GetMaxUnitSize() == ref.GetMaxUnitSize() == 2
    assert port._try_separate_1qb(0, 1e-8) == ref._try_separate_1qb(0, 1e-8)
    assert port.TrySeparate((0, 1)) == ref.TrySeparate((0, 1)) is True
    assert_twins(port, ref, atol)
    port, ref, atol = make(stack, 3, 12)
    for e in (port, ref):
        e.H(0)
        e.CNOT(0, 1)
        e.Prob(1)
        e.RY(0.4, 1)
    assert port.TrySeparate((0, 1)) == ref.TrySeparate((0, 1)) is False
    assert port.TrySeparate(1) == ref.TrySeparate(1) is False
    assert_twins(port, ref, atol)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("entangled", [False, True])
def test_try_decompose_matches_jax(stack, entangled):
    port, ref, atol = make(stack, 5, 13)
    run((port, ref), [("H", (0,)), ("CNOT", (0, 1)), ("RY", (0.6, 3)),
                      ("CNOT", (3, 4)), ("T", (4,))])
    if entangled:
        run((port, ref), [("CNOT", (1, 3))])
    dp, dr = make(stack, 2, 14)[:2]
    ok = port.TryDecompose(3, dp)
    assert ok == ref.TryDecompose(3, dr) == (not entangled)
    assert_twins(port, ref, atol)
    if ok:
        np.testing.assert_allclose(dp.GetQuantumState(), dr.GetQuantumState(),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("case", range(6))
def test_product_fourier_matches_jax(stack, case):
    n = 7
    perm = (case * 37) & 127
    start, length = (0, 7) if case % 2 == 0 else (1, 5)
    inverse = case >= 3
    port, ref, atol = make(stack, n, 20 + case)
    for e in (port, ref):
        e.SetPermutation(perm)
        (e.IQFT if inverse else e.QFT)(start, length)
    assert port.dispatch_count == ref.dispatch_count == 0
    assert port.GetMaxUnitSize() == 1
    assert_twins(port, ref, atol)
    # a register that is no basis state takes the gate path in both
    for e in (port, ref):
        e.RY(0.7, 2)
        e.QFT(0, n)
    assert_twins(port, ref, atol)


def test_product_fourier_wide_closed_form():
    """w40 permutation-init QFT: amplitude k is 2^-20 exp(2 pi i x rev(k)
    / 2^40), rev reversing the 40 bits (this package's QFT has no final
    bit reversal); no unit is built.  Bar: 1e-9 of the modulus."""
    n = 40
    x = 0x9E3779B97F & ((1 << n) - 1)
    q = qt.create_quantum_interface("optimal", n, rng=QrackRandom(1),
                                    device="cpu", rand_global_phase=False)
    q.SetPermutation(x)
    q.QFT(0, n)
    assert q.GetMaxUnitSize() == 1 and q.dispatch_count == 0
    for k in np.random.default_rng(2).integers(0, 1 << n, 16):
        krev = int(f"{int(k):0{n}b}"[::-1], 2)
        want = 2.0 ** -20 * np.exp(2j * np.pi * ((x * krev) % (1 << n))
                                   / 2.0 ** n)
        assert abs(q.GetAmplitude(int(k)) - want) < 1e-9 * 2.0 ** -20


@pytest.mark.parametrize("stack", ["engine", "stab_cpu"])
def test_ace_log_fidelity_with_guard_off(stack, monkeypatch):
    monkeypatch.setenv("QRACK_DISABLE_QUNIT_FIDELITY_GUARD", "1")
    port, ref, atol = make(stack, 5, 30)
    for e in (port, ref):
        assert e.is_ace
        e.SetAceMaxQubits(2)
    run((port, ref), [("RY", (0.3, 0)), ("RY", (1.1, 1)), ("CNOT", (0, 1)),
                      ("RY", (0.5, 2)), ("CNOT", (1, 2)), ("RY", (2.0, 3)),
                      ("CZ", (2, 3)), ("H", (3,)), ("CNOT", (3, 4)),
                      ("CNOT", (0, 4))])
    assert port.log_fidelity == pytest.approx(ref.log_fidelity, abs=1e-12)
    assert port.log_fidelity < 0
    assert port.GetUnitaryFidelity() == pytest.approx(
        ref.GetUnitaryFidelity(), abs=1e-12)
    assert_twins(port, ref, atol)


def test_ace_guard_on_raises_like_jax():
    port, ref, atol = make("engine", 3, 31)
    errs = []
    for e in (port, ref):
        e.SetAceMaxQubits(1)
        e.H(0)
        e.RY(0.4, 1)
        with pytest.raises(RuntimeError, match="ACE") as info:
            e.CNOT(0, 1)
            e.Prob(1)
        errs.append(str(info.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("stack", STACKS)
def test_register_ops_and_structure_match_jax(stack):
    n = 8
    port, ref, atol = make(stack, n, 40)
    run((port, ref), [("H", (0,)), ("CNOT", (0, 3)), ("H", (5,)),
                      ("T", (5,)), ("X", (6,))])
    for e in (port, ref):
        e.INC(3, 0, 4)
        e.CINC(1, 4, 3, (7,))
        e.ROL(1, 2, 4)
    assert_twins(port, ref, atol)
    assert port.swap_count >= 0
    ep, er = make(stack, 2, 41)[:2]
    for e in (ep, er):
        e.H(0)
        e.CNOT(0, 1)
    assert port.Compose(ep) == ref.Compose(er) == n
    assert_twins(port, ref, atol)
    dp, dr = make(stack, 2, 42)[:2]
    port.Decompose(n, dp)
    ref.Decompose(n, dr)
    assert_twins(port, ref, atol)
    assert_twins(dp, dr, atol)
    for e in (port, ref):
        e.ForceM(6, True)
        e.Dispose(6, 1, 1)
    assert_twins(port, ref, atol)
    c = port.Clone()
    np.testing.assert_allclose(c.GetQuantumState(), ref.GetQuantumState(),
                               atol=atol, rtol=0)
    assert c.GetUnitCount() == ref.GetUnitCount()


@pytest.mark.parametrize("stack", ["engine", "stab_cpu"])
def test_lossy_save_per_factor_crosses_packages(stack, tmp_path):
    n = 6
    port, ref, atol = make(stack, n, 50)
    run((port, ref), [("H", (0,)), ("CNOT", (0, 1)), ("RY", (0.4, 1)),
                      ("H", (3,)), ("T", (3,)), ("CNOT", (3, 4)),
                      ("RY", (1.3, 5))])
    port.LossySaveStateVector(str(tmp_path / "p"))
    ref.LossySaveStateVector(str(tmp_path / "r"))
    a, b = make(stack, n, 51)[:2]
    a.LossyLoadStateVector(str(tmp_path / "r.npz"))
    b.LossyLoadStateVector(str(tmp_path / "p.npz"))
    np.testing.assert_allclose(a.GetQuantumState(), b.GetQuantumState(),
                               atol=atol, rtol=0)
    assert a.GetUnitCount() == b.GetUnitCount()
    want = ref.GetQuantumState()
    fid = abs(np.vdot(a.GetQuantumState(), want)) ** 2
    assert fid > 0.999


@pytest.mark.parametrize("seed", [60, 61, 62])
def test_unit_clifford_matches_jax(seed):
    n = 8
    port = qt.create_quantum_interface("unit_clifford", n, rng=QrackRandom(seed),
                                       rand_global_phase=False)
    ref = JaxQUC(n, rng=JaxRandom(seed), rand_global_phase=False)
    assert isinstance(port, QUnitClifford)
    run((port, ref), clifford_stream(seed, n, 70))
    assert_twins(port, ref, EXACT)
    assert [port.M(q) for q in range(n)] == [ref.M(q) for q in range(n)]


@pytest.mark.parametrize("gate", ["T", "RY", "CT", "trimmed_CT"])
def test_unit_clifford_rejects_non_clifford(gate):
    for q in (QUnitClifford(3, rng=QrackRandom(1)),
              JaxQUC(3, rng=JaxRandom(1))):
        q.H(0)
        if gate == "CT":
            q.H(1)
        elif gate == "trimmed_CT":
            q.X(1)  # a definite control trims away onto a cached shard
        with pytest.raises(Exception) as info:
            if gate == "T":
                q.T(0)
            elif gate == "RY":
                q.RY(0.3, 0)
            else:
                q.MCMtrx((1,), mat.T2, 0)
        assert type(info.value).__name__ == "CliffordError"
    assert issubclass(CliffordError, Exception)


def test_default_units_and_devices():
    """A bare QUnit defaults to QStabilizerHybrid units over QHybrid, and
    ``device="cpu"`` reaches the CUDA engine of every unit."""
    q = QUnit(4, rng=QrackRandom(70), device="cpu", tpu_threshold_qubits=2,
              rand_global_phase=False)
    q.H(0)
    q.RY(0.3, 1)
    q.CNOT(0, 1)
    q.T(1)
    q.CNOT(1, 2)
    q.Prob(2)
    unit = q.shards[0].unit
    assert type(unit).__name__ == "QStabilizerHybrid"
    assert not unit.on_tableau() and isinstance(unit.engine, QHybrid)
    assert unit.engine._engine.device.type == "cpu"
