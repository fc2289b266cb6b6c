"""The port's QCircuit.PastLightCone, QTensorNetwork and QInterfaceNoisy
against the JAX package's on the same seeded inputs: the cone's gate
lists equal, gate for gate and payload for payload; QTensorNetwork's
kets and Prob equal (1e-12 over complex128 terminals, 1e-6 where the
port's float32 CUDA engine serves the cone), with the re-buffering
after a measurement and the measurement outcomes draw for draw; and
QInterfaceNoisy's log-fidelity accounting and outcomes for the same seed.
"""

import numpy as np
import pytest

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu.layers.noisy import QInterfaceNoisy as JaxNoisy
from qrack_tpu.layers.qcircuit import QCircuit as JaxCircuit
from qrack_tpu.layers.qtensornetwork import QTensorNetwork as JaxTN
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.engines.cpu import QEngineCPU
from qrack_tpu_torch.engines.cuda import QEngineCUDA
from qrack_tpu_torch.layers.noisy import QInterfaceNoisy
from qrack_tpu_torch.layers.qcircuit import QCircuit
from qrack_tpu_torch.layers.qtensornetwork import QTensorNetwork
from qrack_tpu_torch.utils.rng import QrackRandom

from test_torch_qunit import run, universal_stream


def port_cpu(n, **kw):
    return QEngineCPU(n, **{**kw, "rand_global_phase": False})


def ref_cpu(n, **kw):
    return JaxCPU(n, **{**kw, "rand_global_phase": False})


def circuit_pair(seed, n, depth):
    """The same seeded gates appended to a circuit of each package."""
    port, ref = QCircuit(n), JaxCircuit(n)
    rng = np.random.default_rng(seed)
    for _ in range(depth):
        t = int(rng.integers(n))
        m = np.linalg.qr(rng.standard_normal((2, 2))
                         + 1j * rng.standard_normal((2, 2)))[0]
        if rng.integers(2):
            c = int(rng.integers(n))
            if c != t:
                perm = int(rng.integers(2))
                port.append_ctrl((c,), t, m, perm)
                ref.append_ctrl((c,), t, m, perm)
                continue
        port.append_1q(t, m)
        ref.append_1q(t, m)
    return port, ref


def gate_list(circ):
    return [(g.target, g.controls, {p: m.tolist() for p, m in
                                    sorted(g.payloads.items())})
            for g in circ.gates]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_past_light_cone_gates_match_jax(seed):
    n = 8
    port, ref = circuit_pair(seed, n, 40)
    assert gate_list(port) == gate_list(ref)
    for qubits in ([0], [3], [7], [1, 6], list(range(n))):
        a, b = port.PastLightCone(qubits), ref.PastLightCone(qubits)
        assert gate_list(a) == gate_list(b)
        assert a.qubit_count == b.qubit_count
    # the cone's gates are clones: writing one leaves the circuit alone
    before = gate_list(port)
    cone = port.PastLightCone([0])
    for g in cone.gates:
        for m in g.payloads.values():
            m[:] = 0
    assert gate_list(port) == before


def tn_pair(n, seed):
    port = QTensorNetwork(n, stack_factory=port_cpu, rng=QrackRandom(seed),
                          rand_global_phase=False)
    ref = JaxTN(n, stack_factory=ref_cpu, rng=JaxRandom(seed),
                rand_global_phase=False)
    return port, ref


@pytest.mark.parametrize("seed", [4, 5])
def test_tensor_network_matches_jax(seed):
    n = 6
    port, ref = tn_pair(n, seed)
    run((port, ref), universal_stream(seed, n, 30))
    assert port.isBuffering() and ref.isBuffering()
    for q in range(n):
        assert port.Prob(q) == pytest.approx(ref.Prob(q), abs=1e-12)
    assert port.isBuffering()
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-12, rtol=0)
    assert port.GetAmplitude(5) == pytest.approx(ref.GetAmplitude(5),
                                                 abs=1e-12)
    assert port.M(2) == ref.M(2)
    assert not port.circuit.gates and not ref.circuit.gates
    run((port, ref), universal_stream(seed + 10, n, 12))
    assert port.isBuffering()
    assert port.Prob(3) == pytest.approx(ref.Prob(3), abs=1e-12)
    assert [port.M(q) for q in range(n)] == [ref.M(q) for q in range(n)]
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-12, rtol=0)


def test_tensor_network_rebuffers_after_measurement_like_jax():
    n = 6
    port, ref = tn_pair(n, 8)
    for eng in (port, ref):
        eng.H(0)
        eng.CNOT(0, 1)
        eng.rng.seed(4)
    assert port.M(0) == ref.M(0)
    assert not port.circuit.gates
    for eng in (port, ref):
        eng.H(2)
        eng.CNOT(2, 3)
        eng.T(3)
    assert port.isBuffering() and len(port.circuit.gates) == len(
        ref.circuit.gates) > 0
    assert port.Prob(3) == pytest.approx(ref.Prob(3), abs=1e-12)
    # the queries above drew nothing from the measurement stream
    assert port.M(2) == ref.M(2)
    for eng in (port, ref):
        eng.H(4)
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-12, rtol=0)


def test_tensor_network_structure_ops_match_jax():
    n = 5
    port, ref = tn_pair(n, 12)
    run((port, ref), universal_stream(12, n, 16))
    for eng in (port, ref):
        eng.Allocate(n, 2)
        eng.H(n)
        eng.CNOT(n, n + 1)
    assert port.qubit_count == ref.qubit_count == n + 2
    assert port.isBuffering()
    c, d = port.Clone(), ref.Clone()
    for eng in (c, d):
        eng.T(1)
        eng.Dispose(n, 2)
    np.testing.assert_allclose(c.GetQuantumState(), d.GetQuantumState(),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-12, rtol=0)


def brickwork(n, depth, seed):
    """Seeded non-Clifford 2-qubit bricks as (name, args) calls."""
    rng = np.random.default_rng(seed)
    out = []
    for layer in range(depth):
        for a in range(layer % 2, n - 1, 2):
            th = [float(x) for x in rng.uniform(-np.pi, np.pi, 4)]
            out += [("U", (a, th[0], th[1], th[2])), ("RY", (th[3], a + 1)),
                    ("CNOT", (a, a + 1)),
                    ("MCPhase", ((a,), 1.0, np.exp(1j * th[1]), a + 1))]
    return out


def test_cone_on_the_cuda_engine_through_the_stack():
    """("tensor_network", "unit", "stabilizer_hybrid", "hybrid") on the
    CPU device with the hybrid threshold at 4: the cone of a brickwork
    read runs on QHybrid's CUDA half, and Prob matches the JAX stack over
    the complex128 oracle to float32."""
    n = 10
    layers = ["tensor_network", "unit", "stabilizer_hybrid", "hybrid"]
    port = qt.create_quantum_interface(layers, n, rng=QrackRandom(6),
                                       device="cpu", tpu_threshold_qubits=4,
                                       rand_global_phase=False)
    ref = jax_create(["tensor_network", "unit", "stabilizer_hybrid", "cpu"],
                     n, rng=JaxRandom(6), rand_global_phase=False)
    run((port, ref), brickwork(n, 3, 6))
    seen = []
    real = port._factory

    def spy(m, **kw):
        s = real(m, **kw)
        seen.append(s)
        return s

    port._factory = spy
    for q in (0, 4, 9):
        assert port.Prob(q) == pytest.approx(ref.Prob(q), abs=1e-6)
    assert port.isBuffering() and len(seen) == 3
    units = [sh.unit for s in seen for sh in s.shards]
    engines = [u.engine._engine for u in units
               if getattr(u, "engine", None) is not None]
    assert any(isinstance(e, QEngineCUDA) and e.device.type == "cpu"
               for e in engines)
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6, rtol=0)


def noisy_pair(n, seed, lam):
    port = QInterfaceNoisy(n, inner_factory=port_cpu, noise=lam,
                           rng=QrackRandom(seed), rand_global_phase=False)
    ref = JaxNoisy(n, inner_factory=ref_cpu, noise=lam, rng=JaxRandom(seed),
                   rand_global_phase=False)
    return port, ref


@pytest.mark.parametrize("lam", [0.0, 0.05, 0.3])
def test_noisy_wrapper_matches_jax(lam):
    n = 5
    port, ref = noisy_pair(n, 3, lam)
    run((port, ref), universal_stream(3, n, 30))
    assert port.GetUnitaryFidelity() == ref.GetUnitaryFidelity()
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-12, rtol=0)
    assert [port.M(q) for q in range(n)] == [ref.M(q) for q in range(n)]
    c, d = port.Clone(), ref.Clone()
    assert c.GetUnitaryFidelity() == d.GetUnitaryFidelity()
    port.ResetUnitaryFidelity()
    assert port.GetUnitaryFidelity() == 1.0


def test_noisy_fidelity_counts_each_gate_qubit_once():
    """(1 - lam)^k with k the distinct qubits of every call that reaches
    a funnel point (MCMtrxPerm, Apply4x4, Swap)."""
    lam = 0.01
    port, ref = noisy_pair(4, 9, lam)
    for eng in (port, ref):
        eng.H(0)                # 1
        eng.CNOT(0, 1)          # 2
        eng.CCNOT(0, 1, 2)      # 3
        eng.Swap(2, 3)          # 2
        eng.MCMtrxPerm((3,), np.eye(2), 3, 1)  # target == control: 1
    assert port.GetUnitaryFidelity() == pytest.approx((1 - lam) ** 9,
                                                      abs=1e-15)
    assert port.GetUnitaryFidelity() == ref.GetUnitaryFidelity()


def test_noisy_stacks_through_the_factory_match_jax():
    n = 5
    port = qt.create_quantum_interface(["noisy", "unit", "cpu"], n,
                                       noise=0.1, rng=QrackRandom(21),
                                       rand_global_phase=False)
    ref = jax_create(["noisy", "unit", "cpu"], n, noise=0.1,
                     rng=JaxRandom(21), rand_global_phase=False)
    assert isinstance(port, QInterfaceNoisy) and port.noise == 0.1
    run((port, ref), universal_stream(21, n, 25))
    assert port.GetUnitaryFidelity() == ref.GetUnitaryFidelity() < 1.0
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-10, rtol=0)
    assert [port.M(q) for q in range(n)] == [ref.M(q) for q in range(n)]
    full = qt.create_arranged_layers_full(nw=True, tn=True, bdt=True,
                                          qubit_count=4, device="cpu",
                                          rng=QrackRandom(2),
                                          rand_global_phase=False)
    jfull = jax_create(["noisy", "tensor_network", "unit",
                        "stabilizer_hybrid", "bdt_hybrid", "cpu"], 4,
                       rng=JaxRandom(2), rand_global_phase=False)
    assert isinstance(full, QInterfaceNoisy)
    assert isinstance(full.inner, QTensorNetwork)
    run((full, jfull), universal_stream(2, 4, 20))
    np.testing.assert_allclose(full.GetQuantumState(), jfull.GetQuantumState(),
                               atol=1e-6, rtol=0)
