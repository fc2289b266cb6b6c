"""The OPTIMAL stack and the tableau -> dense switch on the card: a
small quantum volume circuit through create_quantum_interface("optimal")
against the bare "cuda" engine, and SwitchToEngine into a QEngineCUDA.
Both need a CUDA device (the window kernel has no CPU mode) and skip
without one; this file imports no JAX, so on a machine without it run
``python3 -m pytest --noconftest -m cuda tests/test_torch_layers_cuda.py``.

Bars: Prob(q) within 1e-5 and ket fidelity >= 1 - 1e-5 (float32
planes on both sides).
"""

import numpy as np
import pytest
import torch

import qrack_tpu_torch as qt
from qrack_tpu_torch.engines.cuda import QEngineCUDA
from qrack_tpu_torch.models import algorithms as al
from qrack_tpu_torch.ops import window_kernel as wk
from qrack_tpu_torch.utils.rng import QrackRandom


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window kernel has no CPU mode")
    return torch.device("cuda")


def fidelity(a, b):
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)


@pytest.mark.cuda
def test_cuda_optimal_quantum_volume_matches_the_engine(cuda_device):
    n = 16
    ops = list(al.quantum_volume_ops(n, n, QrackRandom(16)))
    wk.reset_launches()
    q = qt.create_quantum_interface("optimal", n, rng=QrackRandom(1),
                                    rand_global_phase=False)
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(1),
                                    rand_global_phase=False)
    for _layer, name, args in ops:
        getattr(q, name)(*args)
    launches = wk.launches()
    for _layer, name, args in ops:
        getattr(c, name)(*args)
    assert launches["in_tile"] + launches["pair"] > 0
    assert q.GetMaxUnitSize() == n
    assert max(abs(q.Prob(b) - c.Prob(b)) for b in range(n)) <= 1e-5
    assert fidelity(q.GetQuantumState(), c.GetQuantumState()) >= 1 - 1e-5


@pytest.mark.cuda
def test_cuda_stabilizer_switch_lands_in_the_cuda_engine(cuda_device):
    n = 14
    rng = np.random.default_rng(n)
    ops = []
    for _ in range(200):
        a, b = (int(v) for v in rng.choice(n, 2, replace=False))
        ops.append([("H", (a,)), ("S", (a,)), ("CNOT", (a, b)),
                    ("CZ", (a, b))][int(rng.integers(4))])
    ops += [("RX", (0.3, 0)), ("CNOT", (0, 1))]
    q = qt.create_quantum_interface(["stabilizer_hybrid", "hybrid"], n,
                                    rng=QrackRandom(2), rand_global_phase=False)
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(2),
                                    rand_global_phase=False)
    for name, args in ops:
        getattr(q, name)(*args)
        getattr(c, name)(*args)
    assert not q.on_tableau()
    assert isinstance(q.engine._engine, QEngineCUDA)
    assert q.engine._engine.device.type == "cuda"
    assert fidelity(q.GetQuantumState(), c.GetQuantumState()) >= 1 - 1e-5


# ---------------------------------------------------------------------------
# the decision tree, the tensor network and the noise plane on the card
# ---------------------------------------------------------------------------

def _random_layers(q, qubits, depth, seed):
    rng = np.random.default_rng(seed)
    for layer in range(depth):
        for b in qubits:
            q.U(b, *(float(v) for v in rng.uniform(-np.pi, np.pi, 3)))
        for i in range(layer % 2, len(qubits) - 1, 2):
            q.CNOT(qubits[i], qubits[i + 1])


@pytest.mark.cuda
def test_cuda_bdt_device_leaves_live_on_the_card(cuda_device, monkeypatch):
    """Device leaves (forced from 3 attached qubits) are float32 planes on
    the card and give the host tree's ket to float32."""
    from qrack_tpu_torch.layers.qbdt import QBdt, _EngLeaf

    monkeypatch.setenv("QRACK_QBDT_LEAF_DEVICE_QB", "3")
    n = 8
    q = QBdt(n, attached_qubits=3, rng=QrackRandom(3), rand_global_phase=False)
    h = QBdt(n, rng=QrackRandom(3), rand_global_phase=False, device="cpu")
    for e in (q, h):
        _random_layers(e, list(range(n)), 3, 8)
    leaves, todo = [], [q.root]
    while todo:
        node = todo.pop()
        if isinstance(node, _EngLeaf):
            leaves.append(node)
        elif isinstance(node, tuple):
            todo += [node[1], node[3]]
    assert leaves and all(lf.planes.is_cuda for lf in leaves)
    assert fidelity(q.GetQuantumState(), h.GetQuantumState()) >= 1 - 1e-6
    assert max(abs(q.Prob(b) - h.Prob(b)) for b in range(n)) <= 1e-6


@pytest.mark.cuda
def test_cuda_bdt_hybrid_switches_into_the_cuda_engine(cuda_device):
    n = 14
    q = qt.create_quantum_interface(["bdt_hybrid", "hybrid"], n,
                                    rng=QrackRandom(4), rand_global_phase=False,
                                    ratio_threshold=1 / 64)
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(4),
                                    rand_global_phase=False)
    rng = np.random.default_rng(n)
    for e in (q, c):
        for b in range(n):
            e.H(b)
    while q.isBinaryDecisionTree():
        a, b = sorted(int(v) for v in rng.choice(n, 2, replace=False))
        ph = np.exp(1j * rng.uniform(-np.pi, np.pi))
        for e in (q, c):
            e.MCPhase((a,), 1.0, ph, b)
    wk.reset_launches()
    for e in (q, c):
        _random_layers(e, list(range(n)), 4, 5)
    assert isinstance(q.engine._engine, QEngineCUDA)
    q.Finish()
    assert sum(wk.launches().values()) > 0
    assert fidelity(q.GetQuantumState(), c.GetQuantumState()) >= 1 - 1e-5


@pytest.mark.cuda
def test_cuda_cone_reads_run_on_the_card(cuda_device):
    n = 24
    layers = ["tensor_network", "unit", "stabilizer_hybrid", "hybrid"]
    q = qt.create_quantum_interface(layers, n, rng=QrackRandom(6),
                                    rand_global_phase=False)
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(6),
                                    rand_global_phase=False)
    for e in (q, c):
        _random_layers(e, list(range(n)), 8, 6)
    wk.reset_launches()
    got = q.Prob(12)
    assert sum(wk.launches().values()) > 0 and q.isBuffering()
    assert abs(got - c.Prob(12)) <= 1e-5


@pytest.mark.cuda
def test_cuda_trajectories_match_the_cpu_device(cuda_device):
    from qrack_tpu_torch import matrices as mat
    from qrack_tpu_torch.layers.qcircuit import QCircuit
    from qrack_tpu_torch.noise import (NoiseModel, amplitude_damping,
                                       depolarizing, run_trajectories)

    n = 10
    circ = QCircuit(n)
    rng = np.random.default_rng(n)
    for layer in range(6):
        for b in range(n):
            circ.append_1q(b, mat.u3_mtrx(*rng.uniform(-np.pi, np.pi, 3)))
        for i in range(layer % 2, n - 1, 2):
            circ.append_ctrl((i,), i + 1, mat.X2, 1)
    model = NoiseModel(default=depolarizing(0.05),
                       per_qubit={3: [amplitude_damping(0.1)]})
    a = run_trajectories(circ, model, 16, key=9)
    b = run_trajectories(circ, model, 16, key=9, device="cpu")
    assert np.array_equal(a.samples, b.samples)
    assert np.abs(a.p1 - b.p1).max() <= 1e-5
    assert np.abs(a.weights - b.weights).max() <= 1e-5 * b.weights.max()


@pytest.mark.cuda
def test_cuda_noisy_terminal_runs_on_the_card(cuda_device):
    """The factory's "noisy" terminal, built without a device, runs its
    trajectory over a QEngineCUDA on the card, and draws what the
    complex128 host oracle draws."""
    from qrack_tpu_torch import matrices as mat
    from qrack_tpu_torch.layers.qcircuit import QCircuit
    from qrack_tpu_torch.noise import (NoiseModel, amplitude_damping,
                                       depolarizing)

    n = 14
    circ = QCircuit(n)
    rng = np.random.default_rng(n)
    for layer in range(4):
        for b in range(n):
            circ.append_1q(b, mat.u3_mtrx(*rng.uniform(-np.pi, np.pi, 3)))
        for i in range(layer % 2, n - 1, 2):
            circ.append_ctrl((i,), i + 1, mat.X2, 1)
    model = NoiseModel(default=depolarizing(0.05),
                       per_qubit={3: [amplitude_damping(0.1)]})
    wk.reset_launches()
    card = qt.create_quantum_interface("noisy", n, model=model, key=4,
                                       trajectory_id=2,
                                       rand_global_phase=False)
    host = qt.create_quantum_interface("noisy", n, model=model, key=4,
                                       trajectory_id=2, device="cpu",
                                       rand_global_phase=False)
    assert isinstance(card.inner, QEngineCUDA)
    assert card.inner.device.type == "cuda"
    card.run_circuit(circ)
    host.run_circuit(circ)
    assert card.app_seq == host.app_seq
    assert card.weight == pytest.approx(host.weight, rel=1e-5)
    assert fidelity(card.GetQuantumState(), host.GetQuantumState()) >= \
        1 - 1e-5
    assert sum(wk.launches().values()) > 0
