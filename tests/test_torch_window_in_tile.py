"""The in-tile sweep's register layout (qrack_tpu_torch/ops/window_kernel.py:
tile_layout, tile_route, in_tile_sweep_emulated) against the plain
in-tile sweep and the JAX package's Pallas window kernel, in float32.

The CUDA kernel runs the in-tile sweep (K1) and the pair sweep (K2) on
one register engine: a block keeps its tile in registers and sends each
op of the segment down one route by the op's target bit.  Register bits
mix registers, lane bits exchange by warp shuffle, warp bits through
shared memory, and diagonal ops stay in registers whatever their
target.  ``in_tile_sweep_emulated`` computes a segment in that layout
and order with the kernel's mask split (tile part ``m >> bp``, thread
part, register part), so these CPU tests check the layout and the
decode; the kernel itself is held against the plain version on the card
(marker ``cuda``, and chip_smoke.py at full width).  The other plane
dtypes are in test_torch_window_in_tile_dtypes.py.

Tolerances: atol 1e-6 on unit-norm float32 planes (the three differ
only in operation order and FMA contraction).  The kernel against its
plain version on the card: min(1e-6, 1e-4 * the largest |amp|) in
float32, 1e-13 of the largest |amp| in float64, 4 units in the last
place of the dtype at the largest |amp| in 16 bits (chip_smoke.py's
bars: both compute in float32 and round once a sweep).
"""

import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from qrack_tpu.ops import fusion as jfu
    from qrack_tpu.ops import pallas_kernels as pk
except ImportError:  # without JAX only the tests against the kernel run
    jnp = jfu = pk = None

import qrack_tpu_torch as qt
from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import window_kernel as wk

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_window_pair import (  # noqa: E402
    controls, fused, matrix, unit_planes)

ATOL = 1e-6
DTYPES = ("float32", "float64", "bfloat16", "float16")
HALF = {"bfloat16": 7, "float16": 10}   # significand bits after the 1


@pytest.fixture
def jax_kernel():
    if pk is None:
        pytest.skip("needs the JAX package")
    return pk


def tile_segment(rng, n, bp, k, dtype=torch.float32):
    """An in-tile segment as (target, cmask, cval, m): k ops, half of
    them diagonal (targets anywhere, so also above the tile) and half
    inv/gen whose targets cycle through the register, lane and warp bits
    of the tile layout of `dtype` planes."""
    lay = wk.tile_layout(bp, dtype)
    classes = [c for c in (lay["register"], lay["lane"], lay["warp"]) if c]
    out = []
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


def operands(ops, dtype, device="cpu"):
    structure = fu.structure_of(ops)
    fv, iv = wk.pack_operands(structure, fu.dense_operands(ops, dtype),
                              dtype, device)
    return structure, wk.op_table(structure, device), fv, iv


def tile_sweeps(n, bp, ops, psi, dtype=torch.float32):
    """(plain, emulated) results of the one in-tile segment `ops`."""
    structure, table, fv, iv = operands(ops, dtype)
    assert wk.segment_launches(structure, bp) == [(None, 0, len(ops))]
    x = torch.tensor(psi).to(dtype)
    args = (n, bp, table, fv, iv, 0, len(ops))
    plain = wk.in_tile_sweep_plain(x.clone(), *args)
    emulated = wk.in_tile_sweep_emulated(x.clone(), *args)
    return plain.double().numpy(), emulated.double().numpy()


def jax_window(pk, n, bp, raw, psi):
    jops = fused(raw, jfu)
    fn = pk.make_window_fn(n, jfu.structure_of(jops), block_pow=bp,
                           interpret=True)
    return np.asarray(fn(jnp.asarray(psi),
                         *jfu.dense_operands(jops, jnp.float32)))


def ulp(x: float, name: str) -> float:
    """One unit in the last place of the 16-bit dtype `name` at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - HALF[name])


def plain_bar(name: str, scale: float) -> float:
    """The kernel-against-plain bar of the module docstring."""
    if name == "float64":
        return 1e-13 * scale
    if name in HALF:
        return 4 * ulp(scale, name)
    return min(ATOL, 1e-4 * scale)


# ---------------------------------------------------------------------------
# the layout and the routes: exact
# ---------------------------------------------------------------------------

_LAYOUT_CASES = [(name, bp) for name in DTYPES for bp in
                 range(1, wk.max_block_pow(getattr(torch, name)) + 1)]


@pytest.mark.parametrize("name,bp", _LAYOUT_CASES)
def test_tile_layout_partitions_the_tile(name, bp):
    dt = getattr(torch, name)
    lay = wk.tile_layout(bp, dt)
    bits = lay["register"] + lay["lane"] + lay["warp"]
    assert sorted(bits) == list(range(bp))   # each bit exactly once
    rin = min(wk.reg_bits(dt), bp)
    assert rin == min(5 if dt == torch.float32 else 4, bp)
    assert len(lay["register"]) == rin
    assert lay["register"][:2] == list(range(min(2, bp)))
    assert lay["threads"] == 1 << (bp - rin) <= 512   # launch bounds
    assert len(lay["lane"]) == min(wk.LANE_BITS, bp - rin)
    # the thread bits are contiguous, lanes below warps, registers the
    # lowest two and the highest
    lo = min(2, bp)
    assert lay["lane"] + lay["warp"] == list(range(lo, lo + bp - rin))
    assert lay["register"][lo:] == list(range(bp - (rin - lo), bp))
    # 2^rin amplitudes a thread: 32 a plane in float32 (16 in the
    # others), the registers the cphase and bit switches of the kernel
    # cover
    assert (1 << rin) <= (32 if dt == torch.float32 else 16)


def test_tile_layout_at_the_default_tile():
    bp = wk.DEFAULT_BLOCK_POW
    assert wk.tile_layout(bp, torch.float32) == {
        "register": [0, 1, 9, 10, 11], "lane": [2, 3, 4, 5, 6],
        "warp": [7, 8], "threads": 128}
    for dt in (torch.float64, torch.bfloat16, torch.float16):
        assert wk.tile_layout(bp, dt) == {
            "register": [0, 1, 10, 11], "lane": [2, 3, 4, 5, 6],
            "warp": [7, 8, 9], "threads": 256}


@pytest.mark.parametrize("name", DTYPES)
def test_pair_names_are_the_pair_form(name):
    """pair_layout and pair_route are the pair form of the one layout;
    the pair holds 4 register bits of each tile, 3 in float64."""
    dt = getattr(torch, name)
    for bp in range(1, wk.max_block_pow(dt) + 1):
        assert wk.pair_layout(bp, dt) == wk.tile_layout(bp, dt, pair=True)
        assert (len(wk.pair_layout(bp, dt)["register"])
                == min(3 if dt == torch.float64 else 4, bp)
                == min(wk.reg_bits(dt, pair=True), bp))
        for t in range(bp):
            assert (wk.pair_route("gen", t, bp, dt)
                    == wk.tile_route("gen", t, bp, dt, pair=True))
        assert wk.pair_route("inv", bp + 1, bp, dt) == "pair"


def test_in_tile_route_refuses_a_cross_tile_op():
    assert wk.tile_route("diag", 14, 12) == "diagonal"
    assert wk.tile_route("cphase", 3, 12) == "diagonal"
    with pytest.raises(ValueError):
        wk.tile_route("gen", 12, 12)


@pytest.mark.parametrize("seed", range(12))
def test_every_op_gets_one_route(seed):
    rng = np.random.default_rng(7000 + seed)
    dt = getattr(torch, DTYPES[seed % 4])
    bp = int(rng.integers(1, wk.max_block_pow(dt) + 1))
    n = bp + int(rng.integers(0, 4))
    ops = fused(tile_segment(rng, n, bp, int(rng.integers(1, 60)), dt), fu)
    assert wk.segment_launches(fu.structure_of(ops), bp) == [
        (None, 0, len(ops))]
    lay = wk.tile_layout(bp, dt)
    for op in ops:
        route = wk.tile_route(op.kind, op.target, bp, dt)
        assert route in wk.TILE_ROUTES
        homes = [r for r in ("register", "lane", "warp")
                 if op.target in lay[r]]
        if op.kind in ("cphase", "diag"):
            assert route == "diagonal"
        else:
            assert homes == [route]


# ---------------------------------------------------------------------------
# the emulation against the plain in-tile sweep and the JAX kernel
# ---------------------------------------------------------------------------

# (n, bp, ops): n 6-14 and bp 3-8, where a float32 tile has register and
# lane bits; bp 11 and 12 add the warp bits (a block of 64 or 128 threads)
_ROUTE_CASES = [(6, 3, 20), (8, 5, 24), (9, 6, 24), (10, 8, 30), (12, 8, 30),
                (13, 11, 30), (14, 12, 40)]


def route_case(n, bp, k):
    rng = np.random.default_rng(n * 1000 + bp * 10 + k)
    return tile_segment(rng, n, bp, k), unit_planes(rng, n)


@pytest.mark.parametrize("n,bp,k", _ROUTE_CASES)
def test_random_segment_every_route(jax_kernel, n, bp, k):
    raw, psi = route_case(n, bp, k)
    plain, emulated = tile_sweeps(n, bp, fused(raw, fu), psi)
    want = jax_window(jax_kernel, n, bp, raw, psi)
    assert np.abs(emulated - plain).max() <= ATOL
    assert np.abs(emulated - want).max() <= ATOL


def test_route_cases_cover_routes_and_controls():
    """The cases above reach every route, and controls below and above
    bp with mixed values."""
    routes, low, high, mixed = set(), 0, 0, 0
    for n, bp, k in _ROUTE_CASES:
        for op in fused(route_case(n, bp, k)[0], fu):
            routes.add(wk.tile_route(op.kind, op.target, bp))
            low += (op.cmask & ((1 << bp) - 1)) != 0
            high += (op.cmask >> bp) != 0
            mixed += op.cval != op.cmask
    assert routes == set(wk.TILE_ROUTES)
    assert low >= 10 and high >= 10 and mixed >= 10


@pytest.mark.parametrize("bp", range(1, wk.MAX_BLOCK_POW + 1))
def test_every_tile_size_matches_pallas(jax_kernel, bp):
    """float32 at every tile size the planner makes: the tile the whole
    ket's width less two, so controls and diagonal targets reach above
    it."""
    n = bp + 2
    rng = np.random.default_rng(7100 + bp)
    raw = tile_segment(rng, n, bp, 16)
    psi = unit_planes(rng, n)
    plain, emulated = tile_sweeps(n, bp, fused(raw, fu), psi)
    want = jax_window(jax_kernel, n, bp, raw, psi)
    assert np.abs(emulated - plain).max() <= ATOL
    assert np.abs(emulated - want).max() <= ATOL


@pytest.mark.parametrize("name,bp", _LAYOUT_CASES)
def test_emulation_matches_plain_at_every_tile_size(name, bp):
    """Every dtype and tile size, the emulation against the plain sweep
    (cheap): the ket as wide as the tile (QUnit's small units launch
    bp = n) and two bits wider."""
    dt = getattr(torch, name)
    for n in (bp, bp + 2):
        rng = np.random.default_rng(7200 + 16 * bp + n)
        plain, emulated = tile_sweeps(n, bp, fused(
            tile_segment(rng, n, bp, 24, dt), fu), unit_planes(rng, n), dt)
        bar = plain_bar(name, np.abs(plain).max())
        assert np.abs(emulated - plain).max() <= bar


def segment_ops(table, fv, iv, first, count):
    """The JAX FusedOps of table rows [first, first + count), rebuilt
    from the packed operands (their payloads are the planes' floats)."""
    names = {v: k for k, v in wk.KIND_CODE.items()}
    f = fv.double().numpy()
    out = []
    for kind, t, has_ctrl, foff, ioff in table[first:first + count].tolist():
        kind = names[kind]
        cm, cv = (int(iv[ioff]), int(iv[ioff + 1])) if has_ctrl else (0, 0)
        z = f[foff:foff + 8:2] + 1j * f[foff + 1:foff + 8:2]
        if kind == "cphase":
            m = np.diag([1.0 + 0j, z[0]])
        elif kind == "diag":
            m = np.diag([z[0], z[1]])
        elif kind == "inv":
            m = np.array([[0, z[0]], [z[1], 0]])
        else:   # mtrx_planes: [re00, re01, re10, re11, im00, ...]
            g = f[foff:foff + 8]
            m = (g[:4] + 1j * g[4:]).reshape(2, 2)
        out.append(jfu.FusedOp(kind, t, cm, cv, np.asarray(m, np.complex128)))
    return out


def test_engine_qft_in_tile_segments(jax_kernel, monkeypatch):
    """The QFT's own in-tile segments: the engine path's QFT(0, 14) on
    the kernel lowering (the plain version on the CPU), every in-tile
    launch replayed through the emulation and the Pallas kernel."""
    n = 14
    launches = []
    real = wk.in_tile_sweep

    def record(planes, n_, bp, table, fv, iv, first, count):
        launches.append((planes.clone(), bp, table, fv, iv, first, count))
        return real(planes, n_, bp, table, fv, iv, first, count)

    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "on")
    monkeypatch.setattr(wk, "in_tile_sweep", record)
    q = qt.QEngineCUDA(n, device="cpu", rand_global_phase=False)
    q.SetPermutation(0x2A5C % (1 << n))
    q.QFT(0, n)
    q.Finish()
    assert len(launches) >= 2
    for x, bp, table, fv, iv, first, count in launches:
        args = (n, bp, table, fv, iv, first, count)
        plain = wk.in_tile_sweep_plain(x.clone(), *args).numpy()
        emulated = wk.in_tile_sweep_emulated(x.clone(), *args).numpy()
        jops = segment_ops(table, fv, iv, first, count)
        fn = pk.make_window_fn(n, jfu.structure_of(jops), block_pow=bp,
                               interpret=True)
        assert fn.sweeps == 1
        want = np.asarray(fn(jnp.asarray(x.numpy()),
                             *jfu.dense_operands(jops, jnp.float32)))
        assert np.abs(emulated - plain).max() <= ATOL
        assert np.abs(emulated - want).max() <= ATOL


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the in-tile kernel has no CPU mode")
    return torch.device("cuda")


def kernel_and_plain(dev, n, bp, ops, psi, dtype):
    """max |kernel - plain| over one window of in-tile `ops`, and the
    largest |amp|; the kernel must launch once per planned sweep."""
    structure = fu.structure_of(ops)
    x = torch.tensor(psi, device=dev).to(dtype)
    wk.reset_launches()
    got = wk.make_window_fn(n, structure, block_pow=bp)(
        x.clone(), *fu.dense_operands(ops, dtype))
    torch.cuda.synchronize()
    assert wk.launches() == {"in_tile": wk.plan_sweeps(structure, bp, n),
                             "pair": 0}
    want = wk.make_window_fn(n, structure, block_pow=bp, plain=True)(
        x.clone(), *fu.dense_operands(ops, dtype))
    err = float((got.double() - want.double()).abs().max())
    return err, float(want.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bp", [1, 2, 3, 4, 5, 7, 12, "max"])
@pytest.mark.parametrize("name", DTYPES)
def test_cuda_in_tile_kernel_matches_plain(cuda_device, name, bp):
    dt = getattr(torch, name)
    bp = wk.max_block_pow(dt) if bp == "max" else bp
    if bp > wk.max_block_pow(dt):
        pytest.skip(f"{name} tiles stop at bp = {wk.max_block_pow(dt)}")
    lay = wk.tile_layout(bp, dt)
    for n in (bp, bp + 4):
        rng = np.random.default_rng(7300 + 16 * bp + n)
        ops = fused(tile_segment(rng, n, bp, 150, dt), fu)
        assert ({wk.tile_route(op.kind, op.target, bp, dt) for op in ops}
                == {"diagonal"} | {r for r in ("register", "lane", "warp")
                                   if lay[r]})
        err, scale = kernel_and_plain(cuda_device, n, bp, ops,
                                      unit_planes(rng, n), dt)
        assert err <= plain_bar(name, scale), (n, bp, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPES)
def test_cuda_in_tile_diagonal_run(cuda_device, name):
    """A 256-op diagonal run (four descriptor chunks) with targets and
    controls anywhere, then an in-tile gen on a warp bit."""
    dt = getattr(torch, name)
    n, bp = 16, wk.DEFAULT_BLOCK_POW
    rng = np.random.default_rng(7400)
    raw = []
    for _ in range(256):
        kind = ("cphase", "diag")[int(rng.integers(2))]
        t = int(rng.integers(n))
        raw.append((t, *controls(rng, n, t, kind != "cphase"),
                    matrix(rng, kind)))
    t = wk.tile_layout(bp, dt)["warp"][0]
    raw.append((t, *controls(rng, n, t, True), matrix(rng, "gen")))
    err, scale = kernel_and_plain(cuda_device, n, bp, fused(raw, fu),
                                  unit_planes(rng, n), dt)
    assert err <= plain_bar(name, scale)
