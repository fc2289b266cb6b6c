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
