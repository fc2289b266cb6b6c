"""The pager's split-index ALU on the card: a w24 pager of 4 pages on one
CUDA device with ``force_wide_alu`` set (every gate-set and ALU op
through its split form, K1/K2 per page around them) against the port's
complex128 host oracle, and the TurboQuant pager's chunk programs.
These need a CUDA device (the per-page windows launch the window kernel)
and skip without one; this file imports no JAX, so on a machine without
it run ``python3 -m pytest --noconftest -m cuda
tests/test_torch_wide_alu_cuda.py``.

Bars: the pager's ket within fidelity 1 - 1e-5 of the oracle (float32
planes), Prob within 1e-5; the TurboQuant pager's Prob within 2e-2 at
int8 (the bar of the compressed engine's w32 phase).
"""

import numpy as np
import pytest
import torch

import qrack_tpu_torch as qt
from qrack_tpu_torch.utils.rng import QrackRandom

pytestmark = pytest.mark.cuda

N = 24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pages' windows launch the "
                    "window kernel, which has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _fidelity(a, b):
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)


def _sequence(q):
    for i in (0, 3, 9, 21, 22, 23):
        q.H(i)
    q.CNOT(22, 5)
    q.INC(77, 18, 6)               # the register spans the page boundary
    q.CINC(5, 2, 4, (23,))         # a page-bit control
    q.XMask((1 << 23) | 0b101)
    q.ZMask((1 << 22) | (1 << 3))
    q.PhaseParity(0.7, (1 << 21) | 0b1001)
    q.UniformParityRZ((1 << 23) | (1 << 9), 0.3)
    q.CUniformParityRZ((22,), (1 << 21) | 1, 0.4)
    q.PhaseFlipIfLess(40, 18, 6)
    q.ROL(3, 17, 7)
    q.Hash(20, 4, list(np.random.RandomState(3).permutation(16)))
    q.MUL(3, 0, 4, 3)
    q.DIV(3, 0, 4, 3)
    q.ForceMParity((1 << 22) | (1 << 3), True)


def test_wide_pager_on_the_card_matches_the_oracle(cuda_device):
    q = qt.create_quantum_interface("pager", N, devices=[cuda_device] * 4,
                                    rng=QrackRandom(5),
                                    rand_global_phase=False)
    q.force_wide_alu = True
    o = qt.create_quantum_interface("cpu", N, rng=QrackRandom(5),
                                    rand_global_phase=False)
    for e in (q, o):
        _sequence(e)
    assert _fidelity(q.GetQuantumState(), o.GetQuantumState()) >= 1 - 1e-5
    for b in (0, 5, 21, 23):
        assert q.Prob(b) == pytest.approx(o.Prob(b), abs=1e-5)
    assert all(p.device.type == "cuda" for p in q.page_planes)


def test_turboquant_pager_on_the_card(cuda_device):
    q = qt.create_quantum_interface("turboquant_pager", N, bits=8,
                                    devices=[cuda_device] * 4,
                                    rng=QrackRandom(6),
                                    rand_global_phase=False)
    q.H(0)
    for i in range(N - 1):
        q.CNOT(i, i + 1)
    q.ZMask((1 << 23) | 1)
    q.UniformParityRZ((1 << 22) | 1, 0.25)
    for b in (0, 12, 22, 23):
        assert q.Prob(b) == pytest.approx(0.5, abs=2e-2)
    assert all(c.device.type == "cuda" for c in q._codes)
