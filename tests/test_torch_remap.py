"""The port's remap planner and placement table against the JAX
package's (ops/fusion.py plan_remaps / translate_ops and the QPager
table), on the virtual CPU devices that tests/conftest.py pins.

The planner is host code copied into the port, so with the same ops,
lookahead and table both must return the same swaps and table, one for
one.  The fuzz drives one seeded op stream (tests/test_fuzz_api.py's
vocabulary, SetBit left out as in tests/test_remap.py) through the
port's QPager and the JAX QPager with QRACK_TPU_REMAP and
QRACK_TPU_COLLECTIVE on and off: the tables must be equal after every
op (every flushed window) and the kets within float32 rounding
(fidelity >= 1 - 1e-6, mid-stream Prob within 3e-5).
"""

import numpy as np
import pytest

from qrack_tpu.ops import fusion as jfu
from qrack_tpu.parallel.pager import QPager as JaxPager
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.parallel.pager import QPager
from qrack_tpu_torch.utils.rng import QrackRandom

from test_fuzz_api import N, _ops


def _fidelity(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real
                                            * np.vdot(b, b).real))


def _random_window(rng, n, k):
    kinds = ("gen", "inv", "cphase", "diag")
    port, ref = [], []
    for _ in range(k):
        kind = kinds[int(rng.integers(0, 4))]
        t = int(rng.integers(0, n))
        others = [q for q in range(n) if q != t]
        cm = 0
        for c in rng.choice(others, int(rng.integers(0, 3)), replace=False):
            cm |= 1 << int(c)
        cv = cm if kind == "cphase" else cm & int(rng.integers(0, 1 << n))
        m = np.eye(2, dtype=np.complex128)
        port.append(fu.FusedOp(kind, t, cm, cv, m))
        ref.append(jfu.FusedOp(kind, t, cm, cv, m))
    return port, ref


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("seed", range(60))
def test_plan_remaps_and_translate_equal(seed, batched):
    rng = np.random.default_rng(5000 + seed)
    n = int(rng.integers(3, 12))
    L = int(rng.integers(1, n + 1))
    qmap = [int(x) for x in rng.permutation(n)]
    port, ref = _random_window(rng, n, int(rng.integers(1, 20)))
    look = None
    if seed % 3:
        look = tuple(("gen" if rng.integers(0, 2) else "diag",
                      int(rng.integers(0, n)))
                     for _ in range(int(rng.integers(0, 30))))
    weights = None
    if seed % 5 == 0 and n > L:
        weights = [float(x) for x in rng.integers(1, 4, size=n - L)]
    got = fu.plan_remaps(port, L, qmap, look, weights=weights,
                         batched=batched)
    want = jfu.plan_remaps(ref, L, qmap, look, weights=weights,
                           batched=batched)
    assert got == want
    new_qmap = got[1]
    for a, b in zip(fu.translate_ops(port, new_qmap),
                    jfu.translate_ops(ref, new_qmap)):
        assert (a.kind, a.target, a.cmask, a.cval) == \
            (b.kind, b.target, b.cmask, b.cval)
    assert fu.batched_exchange_cost(tuple(range(n - L)), weights) == \
        jfu.batched_exchange_cost(tuple(range(n - L)), weights)


def _op_skip_setbit(rng):
    # SetBit measures; the measuring ops are held by test_torch_pager.py
    while True:
        name, args = _ops(rng)
        if name != "SetBit":
            return name, args


@pytest.mark.parametrize("remap,collective,window", [
    ("on", "auto", "16"), ("on", "off", "16"), ("off", "auto", "16"),
    ("on", "auto", "1")])
@pytest.mark.parametrize("trial", range(2))
def test_fuzz_parity_tables_match(trial, remap, collective, window,
                                  monkeypatch):
    monkeypatch.setenv("QRACK_TPU_REMAP", remap)
    monkeypatch.setenv("QRACK_TPU_COLLECTIVE", collective)
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", window)
    rng = np.random.Generator(np.random.PCG64(7000 + trial))
    ref = JaxPager(N, n_pages=8, rng=JaxRandom(trial),
                   rand_global_phase=False)
    port = QPager(N, n_pages=8, device="cpu", rng=QrackRandom(trial),
                  rand_global_phase=False)
    nonid = 0
    for step in range(25):
        name, args = _op_skip_setbit(rng)
        getattr(ref, name)(*args)
        getattr(port, name)(*args)
        if rng.integers(0, 8) == 0:      # mid-stream reads flush windows
            qb = int(rng.integers(0, N))
            assert abs(ref.Prob(qb) - port.Prob(qb)) < 3e-5, (step, name)
        assert port._qmap == ref._qmap, (step, name)
        nonid += port._map_nonid()
    f = _fidelity(ref.GetQuantumState(), port.GetQuantumState())
    assert f > 1 - 1e-6, (trial, f)
    if remap == "off":
        assert nonid == 0


def test_qft_windows_move_tables_alike():
    """The engine-path QFT on 8 pages: after every flushed window of its
    descending-H stream the two tables agree, and the planner fired."""
    n = 9
    ref = JaxPager(n, n_pages=8, rng=JaxRandom(3), rand_global_phase=False)
    port = QPager(n, n_pages=8, device="cpu", rng=QrackRandom(3),
                  rand_global_phase=False)
    seen = set()
    for eng in (ref, port):
        eng.SetPermutation(0b101100111)
    for i in range(n):          # registers.py QFT, one H at a time
        h = n - 1 - i
        for eng in (ref, port):
            for j in range(i):
                eng.CPhaseRootN(j + 2, h, h + 1 + j)
            eng.H(h)
        assert port._qmap == ref._qmap, i
        seen.add(tuple(port._qmap))
    assert len(seen) > 1
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-5)
