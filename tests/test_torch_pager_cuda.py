"""The pager's per-page window kernel (K1/K2 on each page) on the card.
These need a CUDA device (the window kernel has no CPU mode) and skip
without one; this file imports no JAX, so on a machine without it run
``python3 -m pytest --noconftest -m cuda tests/test_torch_pager_cuda.py``.

Bars: each window's pages within 1e-6 of the same body on CPU pages
(the kernel's plain version); the pager's QFT against the dense engine's
at fidelity >= 1 - 1e-5 (float32 planes on both sides).
"""

import numpy as np
import pytest
import torch

import qrack_tpu_torch as qt
from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import window_kernel as wk
from qrack_tpu_torch.parallel import pager as pg
from qrack_tpu_torch.utils.rng import QrackRandom


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _ops(rng, n, L, k):
    """k fused ops: in-page inv/gen (some with page-bit controls), diag
    and cphase anywhere, paged gens."""
    ops = []
    for _ in range(k):
        kind = int(rng.integers(0, 4))
        t = int(rng.integers(0, n if kind < 2 else L))
        if kind == 3 and rng.integers(0, 4) == 0:
            t = int(rng.integers(L, n))
        others = [q for q in range(n) if q != t]
        cm = 0
        for c in rng.choice(others, int(rng.integers(0, 3)), replace=False):
            cm |= 1 << int(c)
        cv = cm if kind == 0 else cm & int(rng.integers(0, 1 << n))
        a, b = np.exp(1j * rng.uniform(0, 2 * np.pi, 2))
        if kind == 0:
            m = np.diag([1.0 + 0j, b])
        elif kind == 1:
            m = np.diag([a, b])
        elif kind == 2:
            m = np.array([[0, a], [b, 0]])
        else:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            m, _ = np.linalg.qr(z)
        m = np.asarray(m, dtype=np.complex128)
        ops.append(fu.FusedOp(fu.classify(m, cm, cv), t, cm, cv, m))
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_per_page_kernel_against_plain(cuda_device, seed):
    n, G, bp = 18, 4, 6
    L = n - 2
    rng = np.random.default_rng(60 + seed)
    ops = _ops(rng, n, L, 24)
    structure = fu.sharded_structure_of(ops)
    oper = fu.sharded_operands(ops, L, torch.float32, device="cpu")
    v = rng.normal(size=(2, 1 << n)).astype(np.float32)
    v /= np.linalg.norm(v)
    host = [torch.from_numpy(v[:, p << L:(p + 1) << L].copy())
            for p in range(G)]
    card = [h.to(cuda_device) for h in host]
    body = fu.sharded_kernel_window_body(L, G, structure, block_pow=bp,
                                         remap=((1, L), (3, L + 1)))
    wk.reset_launches()
    got = body(card, *oper)
    torch.cuda.synchronize()
    n_global = sum(1 for kind, t, _ in structure if kind == "gen" and t >= L)
    assert sum(wk.launches().values()) == G * (body.sweeps - n_global)
    want = body(host, *oper)
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_pager_qft_matches_the_dense_engine(cuda_device):
    n = 20
    wk.reset_launches()
    pg.reset_flushes()
    q = qt.create_quantum_interface("pager", n, devices=[cuda_device] * 4,
                                    rng=QrackRandom(1),
                                    rand_global_phase=False)
    q.SetPermutation(0x5A5A5)
    q.QFT(0, n)
    q.Finish()
    got = q.GetQuantumState()
    launched = sum(wk.launches().values())
    assert launched > 0 and launched == pg.FLUSHES["predicted_launches"]
    d = qt.create_quantum_interface("cuda", n, device=cuda_device,
                                    rng=QrackRandom(1),
                                    rand_global_phase=False)
    d.SetPermutation(0x5A5A5)
    d.QFT(0, n)
    want = d.GetQuantumState()
    f = abs(np.vdot(got, want)) ** 2
    assert f >= 1 - 1e-5
