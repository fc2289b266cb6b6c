"""The checkpoint plane on the card: a w20 dense round trip in each plane
dtype, a pager saved on 4 pages and loaded into 2, and a TurboQuant
round trip.  These need a CUDA device (the continuations run the window
kernel and the TurboQuant kernels, which have no CPU mode) and skip
without one; this file imports no JAX, so on a machine without it run
``python3 -m pytest --noconftest -m cuda tests/test_torch_checkpoint_cuda.py``.

Bars: the dense and TurboQuant continuations equal bit for bit, with
``MAll`` equal; the 4 -> 2-page load at fidelity >= 1 - 1e-6 after the
continuation (its passes run in another page layout).
"""

import numpy as np
import pytest
import torch

import qrack_tpu_torch as qt
from qrack_tpu_torch.checkpoint import load_state, save_state
from qrack_tpu_torch.utils.rng import QrackRandom

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _prefix(q, n):
    q.QFT(0, n)
    for t in range(0, n, 3):
        q.T(t)
    q.CNOT(n - 1, 0)


def _tail(q, n):
    rng = np.random.default_rng(5)
    for _ in range(3 * n):
        k = int(rng.integers(0, 3))
        t = int(rng.integers(0, n))
        if k == 0:
            q.H(t)
        elif k == 1:
            q.T(t)
        else:
            q.CNOT(t, (t + 1 + int(rng.integers(0, n - 1))) % n)


def _fidelity(a, b):
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16",
                                   "float16"])
def test_dense_w20_round_trip(dtype, cuda_device, tmp_path):
    n = 20
    a = qt.create_quantum_interface("cuda", n, dtype=dtype,
                                    rng=QrackRandom(7))
    _prefix(a, n)
    path = str(tmp_path / "d.qckpt")
    save_state(a, path)
    b = load_state(path, into=qt.create_quantum_interface(
        "cuda", n, dtype=dtype, rng=QrackRandom(991)))
    assert b.device.type == "cuda" and b.dtype == getattr(torch, dtype)
    c = load_state(path)
    assert c.device.type == "cuda"
    for q in (a, b, c):
        _tail(q, n)
    assert torch.equal(a._state, b._state) and torch.equal(a._state, c._state)
    assert a.MAll() == b.MAll() == c.MAll()


def test_pager_four_pages_load_into_two(cuda_device, tmp_path):
    n = 20
    a = qt.create_quantum_interface("pager", n, n_pages=4,
                                    devices=[cuda_device] * 4,
                                    rng=QrackRandom(3),
                                    rand_global_phase=False)
    _prefix(a, n)
    path = str(tmp_path / "p.qckpt")
    save_state(a, path)
    b = load_state(path, into=qt.create_quantum_interface(
        "pager", n, n_pages=2, devices=[cuda_device] * 2,
        rand_global_phase=False))
    c = load_state(path)
    assert b.n_pages == 2 and c.n_pages == 4
    assert all(d.type == "cuda" for d in c.devices)
    for q in (a, b, c):
        _tail(q, n)
    sa = a.GetQuantumState()
    assert np.array_equal(sa, c.GetQuantumState())
    assert _fidelity(sa, b.GetQuantumState()) >= 1 - 1e-6


def test_turboquant_round_trip(cuda_device, tmp_path):
    n = 16
    a = qt.create_quantum_interface("turboquant", n, rng=QrackRandom(4),
                                    rand_global_phase=False)
    _prefix(a, n)
    codes, scales = a.host_codes()
    path = str(tmp_path / "t.qckpt")
    save_state(a, path)
    b = load_state(path)
    assert b._codes.device.type == "cuda"
    bc, bs = b.host_codes()
    assert np.array_equal(bc, codes) and np.array_equal(bs, scales)
    for q in (a, b):
        _tail(q, n)
    ac, as_ = a.host_codes()
    bc, bs = b.host_codes()
    assert np.array_equal(ac, bc) and np.array_equal(as_, bs)
    assert a.MAll() == b.MAll()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_mall_draw_repeats_on_the_card(dtype, cuda_device):
    """The dense engine's MAll draw on the card repeats on the same planes
    and uniform (a torch.cumsum there did not: two bfloat16 draws in 30
    calls on one w20 ket), so a loaded engine measures as the saver."""
    from qrack_tpu_torch.ops import gatekernels as gk

    q = qt.create_quantum_interface("cuda", 20, dtype=dtype,
                                    rng=QrackRandom(7))
    _prefix(q, 20)
    _tail(q, 20)
    st = q._state
    draws = {int(gk.sample(st, 0.6180339887)) for _ in range(30)}
    assert len(draws) == 1


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16",
                                   "float16"])
def test_multishot_draw_repeats_on_the_card(dtype, cuda_device):
    """The dense engine's MultiShotMeasureMask on the card draws the same
    keys on 30 calls with the same planes and rng position, in every
    plane dtype (gatekernels.draw_indices; the cumsum draw it replaced
    on the card does not repeat its rounding)."""
    q = qt.create_quantum_interface("cuda", 20, dtype=dtype,
                                    rng=QrackRandom(7))
    _prefix(q, 20)
    _tail(q, 20)
    powers = [1 << b for b in (0, 3, 9, 14, 19)]
    seen = set()
    for _ in range(30):
        q.rng.seed(11)
        seen.add(tuple(sorted(q.MultiShotMeasureMask(powers, 1024).items())))
    assert len(seen) == 1
    (counts,) = seen
    assert sum(c for _, c in counts) == 1024
