"""The pair sweep's register layout (qrack_tpu_torch/ops/window_kernel.py:
pair_layout, pair_route, pair_sweep_emulated) against the plain pair sweep
and the JAX package's Pallas window kernel.

The CUDA pair kernel keeps a tile pair in registers and sends each op of
its segment down one route by the op's target bit: the leading
cross-tile op and register bits mix registers, lane bits exchange by warp
shuffle, warp bits through shared memory, and diagonal ops stay in
registers.  ``pair_sweep_emulated`` computes a segment in that layout and
order with the kernel's mask split, so these CPU tests check the layout
and the decode; the kernel itself is held against the plain version on
the card (marker ``cuda``, and chip_smoke.py at full width).

Tolerance: atol 1e-6 on unit-norm float32 planes; the three agree to
rounding (they differ only in operation order and FMA contraction).
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from qrack_tpu.ops import fusion as jfu
    from qrack_tpu.ops import pallas_kernels as pk
except ImportError:  # without JAX only the tests against the kernel run
    jnp = jfu = pk = None

from qrack_tpu_torch.models.qft import qft_qcircuit
from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import window_kernel as wk

ATOL = 1e-6


@pytest.fixture
def jax_kernel():
    if pk is None:
        pytest.skip("needs the JAX package")
    return pk


def unit_planes(rng, n):
    psi = rng.normal(size=(2, 1 << n)).astype(np.float32)
    return psi / np.float32(np.sqrt(float((psi.astype(np.float64) ** 2).sum())))


def matrix(rng, kind):
    a, b = np.exp(1j * rng.uniform(0.0, 2 * np.pi, 2))
    if kind == "cphase":
        return np.diag([1.0 + 0j, b])
    if kind == "diag":
        return np.diag([a, b])
    if kind == "inv":
        return np.array([[0, a], [b, 0]], dtype=np.complex128)
    z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    return np.linalg.qr(z)[0]


def controls(rng, n, t, mixed):
    """0-2 controls anywhere but t; with `mixed`, random control values."""
    others = [q for q in range(n) if q != t]
    nc = min(int(rng.integers(0, 3)), len(others))
    cm = 0
    for c in rng.choice(others, nc, replace=False) if nc else ():
        cm |= 1 << int(c)
    cv = cm & int(rng.integers(1 << n)) if mixed and cm else cm
    return cm, cv


def pair_segment(rng, n, bp, k):
    """A pair-led segment as (target, cmask, cval, m): a cross-tile
    inv/gen, then k ops, half of them diagonal (targets anywhere) and
    half in-tile inv/gen whose targets cycle through the register, lane
    and warp bits of the pair layout."""
    lay = wk.pair_layout(bp)
    classes = [c for c in (lay["register"], lay["lane"], lay["warp"]) if c]
    kind = ("inv", "gen")[int(rng.integers(2))]
    t = int(rng.integers(bp, n))
    out = [(t, *controls(rng, n, t, True), matrix(rng, kind))]
    for i in range(k):
        if i % 2:
            kind = ("cphase", "diag")[int(rng.integers(2))]
            t = int(rng.integers(n))
        else:
            kind = ("inv", "gen")[int(rng.integers(2))]
            bits = classes[(i // 2) % len(classes)]
            t = int(bits[int(rng.integers(len(bits)))])
        cm, cv = controls(rng, n, t, kind != "cphase")
        out.append((t, cm, cv, matrix(rng, kind)))
    return out


def fused(raw, mod):
    return [mod.FusedOp(mod.classify(m, cm, cv), t, cm, cv, m)
            for t, cm, cv, m in raw]


def qft_ops(n):
    return fu.lower_gates(qft_qcircuit(n).gates)


def pair_sweeps(n, bp, ops, psi):
    """(plain, emulated) results of the one pair-led segment `ops`."""
    structure = fu.structure_of(ops)
    assert wk.segment_launches(structure, bp) == [(0, 1, len(ops) - 1)]
    fv, iv = wk.pack_operands(structure, fu.dense_operands(ops), device="cpu")
    table = wk.op_table(structure, device="cpu")
    args = (n, bp, table, fv, iv, 0, 1, len(ops) - 1)
    plain = wk.pair_sweep_plain(torch.tensor(psi), *args).numpy()
    emulated = wk.pair_sweep_emulated(torch.tensor(psi), *args).numpy()
    return plain, emulated


def jax_window(pk, n, bp, raw, psi):
    jops = fused(raw, jfu)
    fn = pk.make_window_fn(n, jfu.structure_of(jops), block_pow=bp,
                           interpret=True)
    return np.asarray(fn(jnp.asarray(psi),
                         *jfu.dense_operands(jops, jnp.float32)))


# ---------------------------------------------------------------------------
# the layout and the routes: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bp", range(1, wk.MAX_BLOCK_POW + 1))
def test_pair_layout_partitions_the_tile(bp):
    lay = wk.pair_layout(bp)
    bits = lay["register"] + lay["lane"] + lay["warp"]
    assert sorted(bits) == list(range(bp))
    rin = min(wk.PAIR_REG_BITS, bp)
    assert len(lay["register"]) == rin
    assert lay["register"][:2] == list(range(min(2, bp)))
    assert lay["threads"] == 1 << (bp - rin) <= 512
    assert len(lay["lane"]) == min(wk.LANE_BITS, bp - rin)
    # the thread bits are contiguous, lanes below warps
    lo = min(2, bp)
    assert lay["lane"] + lay["warp"] == list(range(lo, lo + bp - rin))


def test_pair_layout_at_the_default_tile():
    assert wk.pair_layout(wk.DEFAULT_BLOCK_POW) == {
        "register": [0, 1, 10, 11], "lane": [2, 3, 4, 5, 6],
        "warp": [7, 8, 9], "threads": 256}


@pytest.mark.parametrize("seed", range(12))
def test_every_op_gets_one_route(seed):
    rng = np.random.default_rng(4000 + seed)
    n = int(rng.integers(6, 17))
    bp = int(rng.integers(1, n))
    raw = pair_segment(rng, n, bp, int(rng.integers(1, 60)))
    ops = fused(raw, fu)
    lay = wk.pair_layout(bp)
    for seg in wk.plan_window(fu.structure_of(ops), bp):
        slots = ([seg["xgen"]] if seg["xgen"] is not None else []) + seg["ops"]
        for idx, kind, t, _has_ctrl in slots:
            route = wk.pair_route(kind, t, bp)
            assert route in wk.PAIR_ROUTES
            homes = [r for r in ("register", "lane", "warp") if t in lay[r]]
            if kind in ("cphase", "diag"):
                assert route == "diagonal"
            elif t >= bp:
                assert route == "pair" and seg["xgen"][0] == idx and not homes
            else:
                assert homes == [route]


# ---------------------------------------------------------------------------
# the emulation against the plain pair sweep and the JAX kernel
# ---------------------------------------------------------------------------

_QFT_CASES = [(10, 3), (11, 4), (12, 5), (12, 6)]


@pytest.mark.parametrize("n,bp", _QFT_CASES)
def test_qft_trailing_segment(jax_kernel, n, bp):
    """qft_qcircuit(n)'s last segment, led by H(bp), holds most ops."""
    ops = qft_ops(n)
    xop, first, count = wk.segment_launches(fu.structure_of(ops), bp)[-1]
    assert xop == first - 1 and first + count == len(ops)
    assert count + 1 > len(ops) / 2
    seg = ops[xop:]
    psi = unit_planes(np.random.default_rng(n * 10 + bp), n)
    plain, emulated = pair_sweeps(n, bp, seg, psi)
    want = jax_window(jax_kernel, n, bp,
                      [(op.target, op.cmask, op.cval, op.m) for op in seg], psi)
    assert np.abs(emulated - plain).max() <= ATOL
    assert np.abs(emulated - want).max() <= ATOL


_ROUTE_CASES = [(11, 10, 24), (12, 10, 40), (12, 9, 30), (9, 4, 30),
                (8, 3, 20), (6, 2, 12)]


@pytest.mark.parametrize("n,bp,k", _ROUTE_CASES)
def test_random_segment_every_route(jax_kernel, n, bp, k):
    rng = np.random.default_rng(n * 1000 + bp * 10 + k)
    raw = pair_segment(rng, n, bp, k)
    psi = unit_planes(rng, n)
    plain, emulated = pair_sweeps(n, bp, fused(raw, fu), psi)
    want = jax_window(jax_kernel, n, bp, raw, psi)
    assert np.abs(emulated - plain).max() <= ATOL
    assert np.abs(emulated - want).max() <= ATOL


def test_route_cases_cover_routes_and_controls():
    """The cases above reach every route, and controls below and above
    bp with mixed values."""
    routes, low, high, mixed = set(), 0, 0, 0
    for n, bp, k in _ROUTE_CASES:
        rng = np.random.default_rng(n * 1000 + bp * 10 + k)
        for op in fused(pair_segment(rng, n, bp, k), fu):
            routes.add(wk.pair_route(op.kind, op.target, bp))
            low += (op.cmask & ((1 << bp) - 1)) != 0
            high += (op.cmask >> bp) != 0
            mixed += op.cval != op.cmask
    assert routes == set(wk.PAIR_ROUTES)
    assert low >= 10 and high >= 10 and mixed >= 10


@pytest.mark.parametrize("seed", range(8))
def test_emulation_matches_plain_pair_sweep(seed):
    """Many random pair-led segments, the emulation against the plain
    sweep alone (cheap): any tile pow, targets and controls anywhere."""
    rng = np.random.default_rng(5000 + seed)
    n = int(rng.integers(3, 13))
    bp = int(rng.integers(1, n))
    raw = pair_segment(rng, n, bp, int(rng.integers(0, 50)))
    plain, emulated = pair_sweeps(n, bp, fused(raw, fu), unit_planes(rng, n))
    assert np.abs(emulated - plain).max() <= ATOL


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pair kernel has no CPU mode")
    return torch.device("cuda")


def kernel_and_plain(dev, n, bp, ops, psi):
    structure = fu.structure_of(ops)
    fv, iv = wk.pack_operands(structure, fu.dense_operands(ops), device=dev)
    table = wk.op_table(structure, device=dev)
    args = (n, bp, table, fv, iv, 0, 1, len(ops) - 1)
    x = torch.tensor(psi, device=dev)
    wk.reset_launches()
    got = wk.pair_sweep(x.clone(), *args)
    torch.cuda.synchronize()
    assert wk.launches() == {"in_tile": 0, "pair": 1}
    want = wk.pair_sweep_plain(x.clone(), *args)
    return float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_cuda_pair_kernel_matches_plain(cuda_device, seed):
    rng = np.random.default_rng(6000 + seed)
    n, bp = 16, 12
    raw = pair_segment(rng, n, bp, 60)
    err = kernel_and_plain(cuda_device, n, bp, fused(raw, fu),
                           unit_planes(rng, n))
    assert err <= ATOL


@pytest.mark.cuda
def test_cuda_pair_kernel_qft_segment(cuda_device):
    n, bp = 16, 12
    ops = qft_ops(n)
    xop, _first, _count = wk.segment_launches(fu.structure_of(ops), bp)[-1]
    err = kernel_and_plain(cuda_device, n, bp, ops[xop:],
                           unit_planes(np.random.default_rng(16), n))
    assert err <= ATOL
