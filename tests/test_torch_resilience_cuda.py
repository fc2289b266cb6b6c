"""The resilience plane on the card (no JAX import, so it runs where the
JAX package is not installed):

    python3 -m pytest --noconftest -m cuda tests/test_torch_resilience_cuda.py

The window kernel writes the planes through a raw pointer, which the
CPU tests cannot reach: here the integrity replay relaunches K1/K2 on a
restored window, a window that fails after its launches is refused
(torn) or replayed from the snapshot, and the probe initialises
``cuda:0`` in a child process.  Every case skips without a CUDA device.
"""

import pytest
import torch

import qrack_tpu_torch as qt
from qrack_tpu_torch import resilience as res
from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import window_kernel as wk
from qrack_tpu_torch.resilience import faults
from qrack_tpu_torch.resilience import integrity as integ
from qrack_tpu_torch.utils.rng import QrackRandom

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA device: the window kernel and "
                              "the probe run on the card"),
]

N = 20


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    res.reset_breaker()
    res.configure(max_retries=2, backoff_s=0.0, timeout_s=0.0)
    integ.reset()
    yield
    faults.clear()
    res.reset_breaker()
    res.configure()
    res.disable()
    integ.reset()
    integ.set_enabled(True)


def _qft_planes(corrupt: bool):
    res.enable()
    q = qt.create_quantum_interface("cuda", N, rng=QrackRandom(4),
                                    rand_global_phase=False)
    if corrupt:
        faults.inject("cuda.fuse.flush", "amp-corrupt", after_n=1, times=1)
    wk.reset_launches()
    q.SetPermutation(0x5A5A5)
    q.QFT(0, N)
    q.Finish()
    launched = sum(wk.launches().values())
    faults.clear()
    return q.engine._state_raw.clone(), launched


def test_replay_relaunches_the_kernel_bit_for_bit():
    clean, n_clean = _qft_planes(False)
    got, n_got = _qft_planes(True)
    assert n_got > n_clean > 0          # the replayed window launched again
    assert torch.equal(got, clean)


@pytest.mark.parametrize("integrity", [False, True])
def test_window_failing_after_its_launches(integrity, monkeypatch):
    """The kernel wrote the planes, then the dispatch failed: refused
    (torn) without a snapshot, replayed exactly once with one."""
    clean, _ = _qft_planes(False)
    integ.set_enabled(integrity)
    res.enable()
    q = qt.create_quantum_interface("cuda", N, rng=QrackRandom(4),
                                    rand_global_phase=False)
    real = fu.flush_window
    fired = []

    def fail_after(planes, *a, **k):
        out = real(planes, *a, **k)
        if not fired:
            fired.append(1)
            raise RuntimeError("CUDA error: out of memory")
        return out

    monkeypatch.setattr(fu, "flush_window", fail_after)
    q.SetPermutation(0x5A5A5)
    if not integrity:
        with pytest.raises(res.DispatchGiveUp) as ei:
            q.QFT(0, N)
            q.Finish()
        assert ei.value.torn
        return
    q.QFT(0, N)
    q.Finish()
    assert torch.equal(q.engine._state_raw, clean)


def test_pager_shrink_and_grow_on_the_card():
    res.enable()
    q = qt.create_quantum_interface("pager", N, devices=["cuda:0"] * 4,
                                    rng=QrackRandom(2),
                                    rand_global_phase=False)
    for t in range(0, N, 3):
        q.H(t)
    q.CNOT(N - 1, 0)
    q.Finish()
    q.engine._unmap()          # a re-page leaves the identity placement
    before = torch.cat([p.clone() for p in q.engine.page_planes], dim=1)
    q.engine.shrink_pages()
    assert q.engine.n_pages == 2
    assert q.engine.maybe_reexpand() and q.engine.n_pages == 4
    after = torch.cat(q.engine.page_planes, dim=1)
    assert torch.equal(before, after)


def test_probe_roundtrip_on_the_card():
    r = res.run_probe(timeout_s=120.0)
    assert r.ok, r.output
