"""The port's page algebra (qrack_tpu_torch/ops/sharded.py, pages as a
list of torch tensors on the CPU) against the JAX package's per-shard
bodies (qrack_tpu/ops/sharded.py) under ``shard_map`` on the virtual
CPU devices that tests/conftest.py pins.

The same seeded numpy ket and the same masks go to both.  Bars: float32
amplitudes within 1e-5 (one gate or exchange; exchanges and relabelings
move values exactly and are held bit for bit); the host planning
(plan_exchange, exchange_cost) equal.  Every gate body also runs with
``sharded.CHUNK`` cut to 4 amplitudes, so the block decomposition of a
page is exercised at these sizes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qrack_tpu.ops import gatekernels as jgk
from qrack_tpu.ops import sharded as jsh
from qrack_tpu.utils.compat import shard_map

from qrack_tpu_torch.ops import gatekernels as gk
from qrack_tpu_torch.ops import sharded as shb

ATOL = 1e-5


@pytest.fixture(params=["whole", "blocks"])
def chunk(request, monkeypatch):
    if request.param == "blocks":
        monkeypatch.setattr(shb, "CHUNK", 4)
    return request.param


def _ket(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(2, 1 << n))
    return (v / np.linalg.norm(v)).astype(np.float32)


def _jax_run(body, state, G, *scalars):
    mesh = Mesh(np.array(jax.devices()[:G]), ("pages",))
    fn = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=(P(None, "pages"),) + (P(),) * len(scalars),
                           out_specs=P(None, "pages")))
    x = jax.device_put(jnp.asarray(state),
                       NamedSharding(mesh, P(None, "pages")))
    return np.asarray(fn(x, *scalars))


def _pages(state, G):
    L = (state.shape[1] // G).bit_length() - 1
    return [torch.from_numpy(state[:, p << L:(p + 1) << L].copy())
            for p in range(G)]


def _joined(pages):
    return torch.cat(list(pages), dim=1).numpy()


def _unitary(seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    m, _ = np.linalg.qr(z)
    return m


@pytest.mark.parametrize("target,masks", [
    (1, (0, 0, 0, 0)), (2, (0b001, 0b001, 0, 0)),
    (0, (0b100, 0, 0b101, 0b001)), (2, (0b011, 0b010, 0b010, 0b010))])
def test_apply_local_2x2(target, masks, chunk):
    n, G = 6, 8
    L = n - 3
    st = _ket(n, 1)
    m = _unitary(target + 10)
    mp = np.stack([m.real, m.imag]).astype(np.float32)
    want = _jax_run(lambda loc, mp_, a, b, c, d: jsh.apply_local_2x2(
        loc, mp_, L, target, a, b, c, d), st, G, jnp.asarray(mp), *masks)
    got = _joined(shb.apply_local_2x2(_pages(st, G), torch.from_numpy(mp),
                                      L, target, *masks))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n,G,gpos,masks", [
    (6, 8, 0, (0, 0, 0, 0)), (6, 8, 2, (0b101, 0b100, 0, 0)),
    (6, 8, 1, (0b010, 0b010, 0b101, 0b001)), (7, 4, 1, (0, 0, 0b01, 0b01)),
    (3, 8, 1, (0, 0, 0b001, 0b001))])   # L = 0: one-amplitude pages
def test_apply_global_2x2(n, G, gpos, masks, chunk):
    st = _ket(n, 2)
    m = _unitary(gpos + 20)
    mp = np.stack([m.real, m.imag]).astype(np.float32)
    want = _jax_run(lambda loc, mp_, a, b, c, d: jsh.apply_global_2x2(
        loc, mp_, G, gpos, a, b, c, d), st, G, jnp.asarray(mp), *masks)
    got = _joined(shb.apply_global_2x2(_pages(st, G), torch.from_numpy(mp),
                                       gpos, *masks))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("tbit,masks", [
    (1, (0, 0, 0, 0)), (4, (0, 0, 0, 0)), (2, (0b001, 0b001, 0b100, 0)),
    (5, (0b110, 0b010, 0b001, 0b001)), (0, (0, 0, 0b011, 0b011))])
def test_apply_diag(tbit, masks, chunk):
    n, G = 6, 8
    L = n - 3
    st = _ket(n, 3)
    d0, d1 = np.exp(0.3j), np.exp(-1.1j)
    tm = 1 << tbit
    tlo, thi = tm & ((1 << L) - 1), tm >> L
    args = (d0.real, d0.imag, d1.real, d1.imag, tlo, thi) + masks
    want = _jax_run(jsh.apply_diag, st, G, *args)
    got = _joined(shb.apply_diag(_pages(st, G), *args))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("g1,g2", [(0, 1), (0, 2), (1, 2)])
def test_page_swap_relabels(g1, g2):
    n, G = 6, 8
    st = _ket(n, 4)
    want = _jax_run(lambda loc: jsh.page_swap(loc, G, g1, g2), st, G)
    pages = _pages(st, G)
    ptrs = {pg.data_ptr() for pg in pages}
    out = shb.page_swap(pages, g1, g2)
    np.testing.assert_array_equal(_joined(out), want)
    # on one device a MetaSwap is a pure relabeling: no page is copied
    assert {pg.data_ptr() for pg in out} == ptrs


@pytest.mark.parametrize("lpos,gpos", [(0, 0), (2, 1), (1, 2)])
def test_mixed_swap(lpos, gpos, chunk):
    n, G = 6, 8
    L = n - 3
    st = _ket(n, 5)
    want = _jax_run(lambda loc: jsh.mixed_swap(loc, G, L, lpos, gpos), st, G)
    got = _joined(shb.mixed_swap(_pages(st, G), L, lpos, gpos))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q1,q2", [(0, 1), (0, 3), (2, 4)])
def test_swap_bits_in_place(q1, q2, chunk):
    L = 5
    st = _ket(L, 6)
    want = np.asarray(jgk.swap_bits(jnp.asarray(st), L, q1, q2))
    page = torch.from_numpy(st.copy())
    ptr = page.data_ptr()
    shb.swap_bits_(page, L, q1, q2)
    assert page.data_ptr() == ptr
    np.testing.assert_array_equal(page.numpy(), want)


@pytest.mark.parametrize("k,gpos", [(1, (2,)), (2, (0, 2)), (3, (2, 0, 1))])
def test_batched_mixed_swap(k, gpos, chunk):
    n, G = 7, 8
    L = n - 3
    st = _ket(n, 7)
    want = _jax_run(lambda loc: jsh.batched_mixed_swap(loc, G, k, gpos),
                    st, G)
    got = _joined(shb.batched_mixed_swap(_pages(st, G), L, k, gpos))
    np.testing.assert_array_equal(got, want)


def _random_swaps(rng, n, count):
    out = []
    for _ in range(count):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        out.append((a, b))
    return tuple(out)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_apply_remap_random_swaps(seed, batched, chunk):
    n, G = 7, 8
    L = n - 3
    rng = np.random.default_rng(300 + seed)
    swaps = _random_swaps(rng, n, int(rng.integers(1, 7)))
    st = _ket(n, 8 + seed)
    want = _jax_run(lambda loc: jsh.apply_remap(loc, G, L, swaps,
                                                batched=batched), st, G)
    got = _joined(shb.apply_remap(_pages(st, G), L, swaps, batched=batched))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(40))
def test_plan_exchange_and_cost_equal(seed):
    rng = np.random.default_rng(900 + seed)
    L = int(rng.integers(2, 7))
    g = int(rng.integers(1, 4))
    swaps = _random_swaps(rng, L + g, int(rng.integers(0, 8)))
    assert shb.plan_exchange(L, g, swaps) == jsh.plan_exchange(L, g, swaps)
    w = [float(x) for x in rng.integers(1, 4, size=g)]
    for weights in (None, w):
        for batched in (True, False):
            assert shb.exchange_cost(L, g, swaps, weights, batched) == \
                jsh.exchange_cost(L, g, swaps, weights, batched)
    if shb.plan_exchange(L, g, swaps) is not None:
        pd = shb.plan_exchange(L, g, swaps).page_dest
        if pd is not None:
            assert shb.page_perm_of(pd, g) == jsh.page_perm_of(pd, g)


def _xor_split(mask):
    def body(xp, pid, lidx, L):
        src = ((pid << L) | lidx) ^ mask
        return src >> L, src & ((1 << L) - 1)
    return body


@pytest.mark.parametrize("mask", [0b000101, 0b110010, 0b111111])
def test_gather_ring(mask, chunk):
    n, G = 6, 8
    L = n - 3
    st = _ket(n, 9)
    want = _jax_run(lambda loc: jsh.gather_ring(loc, G, L, _xor_split(mask),
                                                ()), st, G)
    got = _joined(shb.gather_ring(_pages(st, G), L, _xor_split(mask), ()))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", [0, 2, 3, 5, 6])
def test_compose_ring_all_starts(start, chunk):
    n1, n2, G = 6, 3, 8
    L = n1 - 3
    a = _ket(n1, 10)
    b = _ket(n2, 11)
    mesh = Mesh(np.array(jax.devices()[:G]), ("pages",))
    fn = jax.jit(shard_map(
        lambda x, y: jsh.compose_ring(x, y, G, L, start, n1, n2), mesh=mesh,
        in_specs=(P(None, "pages"), P()), out_specs=P(None, "pages")))
    x = jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(None, "pages")))
    want = np.asarray(fn(x, jnp.asarray(b)))
    got = _joined(shb.compose_ring(_pages(a, G), torch.from_numpy(b), L,
                                   start, n1, n2))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and the host oracle's compose of the same kets
    full = gk.compose(torch.from_numpy(a), torch.from_numpy(b), n1, n2, start)
    np.testing.assert_allclose(got, full.numpy(), atol=ATOL)


def test_collapse_prob_mask_and_page_probs(chunk):
    n, G = 6, 8
    L = n - 3
    st = _ket(n, 12)
    p = st[0] ** 2 + st[1] ** 2
    idx = np.arange(1 << n)
    mask, val = 0b100110, 0b100010
    sel = (idx & mask) == val
    lm, lv, gm, gv = shb.split_masks(mask, val, L)
    assert shb.prob_mask(_pages(st, G), lm, lv, gm, gv) == pytest.approx(
        float(p[sel].sum()), abs=1e-6)
    assert shb.page_probs(_pages(st, G)) == pytest.approx(
        list(p.reshape(G, -1).sum(axis=1)), abs=1e-6)
    scale = 1.0 / np.sqrt(np.float32(p[sel].sum()))
    got = _joined(shb.collapse(_pages(st, G), lm, lv, gm, gv, float(scale)))
    np.testing.assert_allclose(got, np.where(sel, st * scale, 0.0), atol=ATOL)


@pytest.mark.parametrize("seed", range(6))
def test_apply_remap_planner_pairs_run_in_place(seed, chunk):
    """The planner's prologues (disjoint in-page/page pairs, and a page
    pair) take the batched exchange on the carriers where they are, with
    no in-page bit swap, and land where the JAX lowering lands."""
    n, G = 8, 8
    L = n - 3
    rng = np.random.default_rng(700 + seed)
    k = int(rng.integers(1, 4))
    loc = [int(x) for x in rng.choice(L, k, replace=False)]
    top = [int(x) for x in rng.choice(np.arange(L, n), k, replace=False)]
    swaps = tuple(zip(loc, top))
    if seed % 2 and k < 3:
        rest = [t for t in range(L, n) if t not in top]
        swaps += ((rest[0], rest[1]),)
    st = _ket(n, 20 + seed)
    want = _jax_run(lambda x: jsh.apply_remap(x, G, L, swaps), st, G)
    shb.reset_exchanges()
    got = _joined(shb.apply_remap(_pages(st, G), L, swaps))
    np.testing.assert_array_equal(got, want)
    assert shb.EXCHANGES["local_swap"] == 0
    assert shb.EXCHANGES["batched_swap"] == 1


@pytest.mark.parametrize("carriers,gpos", [([0], (1,)), ([1, 3], (2, 0)),
                                           ([4, 0, 2], (0, 1, 2))])
def test_batched_mixed_swap_on_any_carriers(carriers, gpos, chunk):
    n, G = 8, 8
    L = n - 3
    st = _ket(n, 30)
    swaps = tuple((c, L + g) for c, g in zip(carriers, gpos))
    want = _jax_run(lambda x: jsh.apply_remap(x, G, L, swaps,
                                              batched=False), st, G)
    got = _joined(shb.batched_mixed_swap(_pages(st, G), L, len(carriers),
                                         gpos, carriers))
    np.testing.assert_array_equal(got, want)
