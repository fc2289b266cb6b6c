"""Single-sweep window kernel: a fused gate window applied in one pass
over the ket per planned segment (CUDA C++ kernel in
csrc/window_kernel.cu, with its plain PyTorch version here).

It computes what the JAX package's Pallas window kernel computes
(``pallas_kernels.make_window_fn``: the in-tile body of
``_segment_program`` and its cross-tile pair body) over the same packed
operand vectors:

* cphase / diag — ANY target and controls.  Masks split into a tile-local
  part tested against the in-tile index and a high part tested against
  the tile id.
* inv / gen with target < block_pow — in-tile pair mix.
* inv / gen with target >= block_pow — CROSS-TILE: the planner starts a
  new segment led by the op; that segment's sweep handles tile PAIRS
  ``i`` and ``i ^ (1 << (target - block_pow))``.

``sweeps == len(segments)``: a window with no cross-tile non-diagonal
op is one sweep; each cross-tile op opens one more.

Two entry points carry the sweeps, each with a launch count:
:func:`in_tile_sweep` (a segment with no cross-tile op) and
:func:`pair_sweep` (a segment led by one).  Each takes the planes, an
int32 op table (one row per window op: kind, target, has_ctrl, float
offset, int offset — :func:`op_table`), the packed float and int
operand vectors, and the range of table rows the segment applies.  On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain version (:func:`in_tile_sweep_plain`, :func:`pair_sweep_plain`),
which follows the kernel's decomposition: planes viewed as
``(2, n_tiles, 2^bp)``, the same lo/hi mask split and the same pair
mapping.  Both update the planes in place.

The planes may be float32, float64, float16 or bfloat16, and fv is in
their dtype (:data:`DTYPE_CODE`).  The kernel computes in float64 for
float64 planes and in float32 for the others: 16-bit planes are read
into float32, the whole segment runs there, and each amplitude is
rounded back once per sweep.  The plain versions do the same.

Both sweeps run on one register engine: a block keeps its tile (the
in-tile sweep) or its tile pair (the pair sweep) in registers
(:func:`tile_layout`) and sends each op down one route
(:func:`tile_route`); it decodes both from the op table on the device.
:func:`in_tile_sweep_emulated` and :func:`pair_sweep_emulated` compute a
sweep in that layout and route by route, for the tests only.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from . import gatekernels as gk
from ..utils.device import resolve_device

# A tile is 2^bp amplitudes of both planes.  A block of the kernel keeps
# its tile (or tile pair) in registers, and an exchange buffer of the same
# size in shared memory for the ops on a warp bit: 32 KiB at bp = 12 in
# float32 for a tile, 64 KiB for a pair.  (The Pallas kernel's 2^16 tile
# is a TPU VMEM size; a block has at most 227 KB.)
DEFAULT_BLOCK_POW = 12
MAX_QB = 30                 # int32 masks and tile ids, as in the JAX kernel

# The planes' dtypes the kernel takes, by the code its C entry points
# read.  Arithmetic runs in float64 for float64 planes and in float32 for
# the others; 16-bit planes round once per sweep, at the store.
DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
              torch.bfloat16: 3}
# A tile pair must fit a block's shared memory: the pair kernel's exchange
# buffer holds it in the compute type, 2^(bp + 2) values, so float64
# planes take one tile bit less (max_block_pow).
MAX_BLOCK_POW = 13
# The kernel's groups of four amplitudes move as one vector access a
# plane (two 16-byte halves for float64); the planes' start must be
# aligned to it.  The Im plane then is too: the groups exist from bp = 2
# on, so it starts 2^n >= 4 values later.
VECTOR_BYTES = {torch.float32: 16, torch.float64: 16, torch.float16: 8,
                torch.bfloat16: 8}


def max_block_pow(dtype=torch.float32) -> int:
    """The widest tile the kernel takes for planes of `dtype`."""
    return MAX_BLOCK_POW - 1 if dtype == torch.float64 else MAX_BLOCK_POW


# values each op contributes to the packed scalar vector (dense layout
# order: cphase [f.re,f.im]; diag [d0.re,d0.im,d1.re,d1.im];
# inv [tr.re,tr.im,bl.re,bl.im]; gen mtrx_planes (2,2,2) row-major)
_NFLOATS = {"cphase": 2, "diag": 4, "inv": 4, "gen": 8}
KIND_CODE = {"cphase": 0, "diag": 1, "inv": 2, "gen": 3}
_ROW = 5  # op-table columns: kind, target, has_ctrl, float offset, int offset

#: kernel launches per entry point, by the planes' dtype name: one count
#: per dtype form (never the plain version's calls)
DTYPE_LAUNCHES = {gk.dtype_name(dt): {"in_tile": 0, "pair": 0}
                  for dt in DTYPE_CODE}


def launches() -> dict:
    """Kernel launches per entry point, over every dtype."""
    return {k: sum(c[k] for c in DTYPE_LAUNCHES.values())
            for k in ("in_tile", "pair")}


def reset_launches() -> None:
    for counts in DTYPE_LAUNCHES.values():
        for k in counts:
            counts[k] = 0


def _count(entry: str, dtype) -> None:
    DTYPE_LAUNCHES[gk.dtype_name(dtype)][entry] += 1


# ---------------------------------------------------------------------------
# host-side planning (pure Python, shared by the kernel and its plain twin)
# ---------------------------------------------------------------------------

def segment_compatible(kind: str, target: int, block_pow: int) -> bool:
    """Can this op join an in-tile segment?  diag/cphase always can
    (high bits resolve against the tile id); non-diagonal ops need their
    pair partner inside the tile, else they lead a cross-tile segment."""
    return kind in ("cphase", "diag") or target < block_pow


def plan_window(structure: Tuple, block_pow: int) -> List[dict]:
    """Split a window structure into single-sweep segments.

    Returns a list of ``{"xgen": slot | None, "ops": [slot, ...]}``
    where each slot is ``(op_index, kind, target, has_ctrl)``.  A
    cross-tile inv/gen (target >= block_pow) leads its own segment."""
    segs: List[dict] = []
    cur = {"xgen": None, "ops": []}
    for idx, (kind, target, has_ctrl) in enumerate(structure):
        slot = (idx, kind, target, has_ctrl)
        if not segment_compatible(kind, target, block_pow):
            if cur["ops"] or cur["xgen"] is not None:
                segs.append(cur)
            cur = {"xgen": slot, "ops": []}
        else:
            cur["ops"].append(slot)
    segs.append(cur)
    return segs


def plan_sweeps(structure: Tuple, block_pow: int = DEFAULT_BLOCK_POW,
                n: Optional[int] = None) -> int:
    """Sweeps over the ket the kernel lowering pays for this window (the
    window chain pays ~len(structure))."""
    bp = min(block_pow, n) if n is not None else block_pow
    return len(plan_window(structure, bp))


def _operand_slots(structure: Tuple):
    """Per-op (float, int) offsets into the packed scalar vectors."""
    slots = []
    f = i = 0
    for kind, target, has_ctrl in structure:
        slots.append((f, i))
        f += _NFLOATS[kind]
        i += 2 if has_ctrl else 0
    return slots, f, i


def pack_operands(structure: Tuple, operands: Sequence,
                  dtype=torch.float32, device=None):
    """Flatten a dense-layout operand vector (fusion.dense_operands) into
    the kernel's packed scalar vectors: fv (F,) in `dtype`, iv (I,) int32
    — the same values, in the same order, as the Pallas kernel's columns
    (``pallas_kernels.pack_operands(structure, operands, planes.dtype)``)
    — on `device`, ``cuda`` by default.  Payloads already in `dtype`
    (as dense_operands gives them) pass unchanged."""
    device = resolve_device(device)
    fs: List[torch.Tensor] = []
    iv: List[int] = []
    k = 0
    for kind, target, has_ctrl in structure:
        fs.append(torch.as_tensor(operands[k]).reshape(-1).to(dtype))
        k += 1
        if has_ctrl:
            iv += [int(operands[k]), int(operands[k + 1])]
            k += 2
    if not iv:
        iv = [0]  # keep the vector non-empty; never read
    fv = torch.cat(fs) if fs else torch.zeros(0, dtype=dtype)
    ivec = torch.tensor(iv, dtype=torch.int32).to(device)
    return fv.to(device), ivec


def op_table(structure: Tuple, device=None):
    """(ops, 5) int32 table: kind code, target, has_ctrl, float offset,
    int offset — the window's structure as a runtime operand, so one
    compiled kernel serves every structure — on `device`, ``cuda`` by
    default."""
    slots, _nf, _ni = _operand_slots(structure)
    rows = [(KIND_CODE[kind], target, int(has_ctrl), f, i)
            for (kind, target, has_ctrl), (f, i) in zip(structure, slots)]
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, _ROW).to(
        resolve_device(device))


# ---------------------------------------------------------------------------
# plain version (runs the kernel's decomposition with torch ops)
# ---------------------------------------------------------------------------

def _rows(table, first: int, count: int):
    return table[first:first + count].cpu().tolist()


def _masks(iv, has_ctrl, ioff, bp, like):
    """(lm, lv, gm, gv) of an op's control mask, split at bp."""
    if has_ctrl:
        cm, cv = iv[ioff], iv[ioff + 1]
    else:
        cm = cv = torch.zeros((), dtype=torch.int32, device=like.device)
    lbits = (1 << bp) - 1
    return cm & lbits, cv & lbits, cm >> bp, cv >> bp


def _cmul_where(sel, fre, fim, v):
    """v * (sel ? f : 1) on (2, ...) planes views."""
    one = torch.ones((), dtype=v.dtype, device=v.device)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    fr = torch.where(sel, fre, one)
    fi = torch.where(sel, fim, zero)
    return torch.stack([v[0] * fr - v[1] * fi, v[0] * fi + v[1] * fr])


# ---------------------------------------------------------------------------
# shared tile primitives (pallas_kernels.py:149-204): one implementation
# of the cphase / diag / in-tile 2x2 tile math for the TurboQuant
# kernels' plain versions (ops/turboquant_kernel.py) and the compressed
# engine's chunk bodies (engines/turboquant.py).  Planes are batched:
# v is (2, ..., T) over tiles of T amplitudes, lidx the (T,) in-tile
# index and hi_id the tile ids, shaped (..., 1).  Masks and payloads are
# Python numbers or 0-d tensors.  Each returns (planes, hi_ok), hi_ok the
# per-tile result of the high part of the control test.
# ---------------------------------------------------------------------------

def tile_cphase(v, lidx, hi_id, clo, chi, fre, fim):
    """Combined-mask phase: the factor applies where (index & comb) ==
    comb, with comb split at the tile into (clo, chi)."""
    hi_ok = (hi_id & chi) == chi
    hit = ((lidx & clo) == clo) & hi_ok
    return _cmul_where(hit, fre, fim, v), hi_ok


def tile_diag(v, lidx, hi_id, target, L, d0re, d0im, d1re, d1im,
              lm, lv, gm, gv):
    """Diagonal at any target: an in-tile target selects its factor per
    element, a higher one per tile through hi_id's bit."""
    tmask_lo = (1 << target) if target < L else 0
    tb_hi = 0 if target < L else (1 << (target - L))
    hi_bit = (hi_id & tb_hi) != 0
    bit = ((lidx & tmask_lo) != 0) | hi_bit
    fre = torch.where(bit, d1re, d0re)
    fim = torch.where(bit, d1im, d0im)
    hi_ok = (hi_id & gm) == gv
    active = ((lidx & lm) == lv) & hi_ok
    return _cmul_where(active, fre, fim, v), hi_ok


def tile_local_2x2(v, lidx, hi_id, target, mp, lm, lv, gm, gv):
    """Generic 2x2 with the pair inside the tile (target < tile pow); mp
    indexes like mtrx_planes (2, 2, 2) [plane, row, col]."""
    T = v.shape[-1]
    vv = v.reshape(v.shape[:-1] + (T >> (target + 1), 2, 1 << target))
    a0r, a1r = vv[0, ..., 0, :], vv[0, ..., 1, :]
    a0i, a1i = vv[1, ..., 0, :], vv[1, ..., 1, :]
    n0r = (mp[0][0][0] * a0r - mp[1][0][0] * a0i
           + mp[0][0][1] * a1r - mp[1][0][1] * a1i)
    n0i = (mp[0][0][0] * a0i + mp[1][0][0] * a0r
           + mp[0][0][1] * a1i + mp[1][0][1] * a1r)
    n1r = (mp[0][1][0] * a0r - mp[1][1][0] * a0i
           + mp[0][1][1] * a1r - mp[1][1][1] * a1i)
    n1i = (mp[0][1][0] * a0i + mp[1][1][0] * a0r
           + mp[0][1][1] * a1i + mp[1][1][1] * a1r)
    nv = torch.stack([torch.stack([n0r, n1r], dim=-2),
                      torch.stack([n0i, n1i], dim=-2)]).reshape(v.shape)
    hi_ok = (hi_id & gm) == gv
    sel = ((lidx & lm) == lv) & hi_ok
    return torch.where(sel, nv, v), hi_ok


def _tile_op_plain(v, lidx, blk, bp, row, fv, iv):
    """One in-tile op on tiles v (2, T, 2^bp) with tile ids blk (T, 1);
    writes v in place."""
    kind, t, has_ctrl, foff, ioff = row
    if kind == KIND_CODE["cphase"]:
        cm = iv[ioff] if has_ctrl else 0
        comb = cm | (1 << t)
        clo = comb & ((1 << bp) - 1)
        chi = comb >> bp
        hit = ((lidx & clo) == clo) & ((blk & chi) == chi)
        v.copy_(_cmul_where(hit, fv[foff], fv[foff + 1], v))
        return
    lm, lv, gm, gv = _masks(iv, has_ctrl, ioff, bp, v)
    sel = ((lidx & lm) == lv) & ((blk & gm) == gv)
    if kind == KIND_CODE["diag"]:
        if t < bp:
            bit = (lidx & (1 << t)) != 0
        else:
            bit = ((blk >> (t - bp)) & 1) != 0
        fre = torch.where(bit, fv[foff + 2], fv[foff])
        fim = torch.where(bit, fv[foff + 3], fv[foff + 1])
        v.copy_(_cmul_where(sel, fre, fim, v))
        return
    T, block = v.shape[1], v.shape[2]
    vv = v.reshape(2, T, block >> (t + 1), 2, 1 << t)
    a0r, a1r = vv[0, :, :, 0, :], vv[0, :, :, 1, :]
    a0i, a1i = vv[1, :, :, 0, :], vv[1, :, :, 1, :]
    f = fv[foff:foff + _NFLOATS["gen" if kind == KIND_CODE["gen"] else "inv"]]
    if kind == KIND_CODE["inv"]:
        n0r = f[0] * a1r - f[1] * a1i
        n0i = f[0] * a1i + f[1] * a1r
        n1r = f[2] * a0r - f[3] * a0i
        n1i = f[2] * a0i + f[3] * a0r
    else:  # gen: [re00, re01, re10, re11, im00, im01, im10, im11]
        n0r = f[0] * a0r - f[4] * a0i + f[1] * a1r - f[5] * a1i
        n0i = f[0] * a0i + f[4] * a0r + f[1] * a1i + f[5] * a1r
        n1r = f[2] * a0r - f[6] * a0i + f[3] * a1r - f[7] * a1i
        n1i = f[2] * a0i + f[6] * a0r + f[3] * a1i + f[7] * a1r
    nv = torch.stack([torch.stack([n0r, n1r], dim=2),
                      torch.stack([n0i, n1i], dim=2)]).reshape(2, T, block)
    v.copy_(torch.where(sel, nv, v))


def _tiles(planes, n: int, bp: int):
    nblk = 1 << (n - bp)
    v = planes.view(2, nblk, 1 << bp)
    lidx = gk._iota(1 << bp, planes.device)
    blk = gk._iota(nblk, planes.device).view(nblk, 1)
    return v, lidx, blk


def _in_compute_type(planes, fv, body):
    """Run ``body(w, fv)`` on the planes in the kernel's compute type: in
    place for float32 and float64 planes; for 16-bit planes on a float32
    copy, rounded back to the planes once at the end, as the kernel
    rounds once at its store.  Returns planes."""
    if gk.compute_dtype(planes.dtype) == planes.dtype:
        body(planes, fv)
        return planes
    w = planes.to(torch.float32)
    body(w, fv.to(torch.float32))
    planes.copy_(w)
    return planes


# amplitudes a plain sweep takes at a time: tiles and tile pairs are
# independent, so steps of this size bound its temporaries (a float64
# w30 ket is 16 GiB) without changing a value
PLAIN_STEP = 1 << 24


def _in_tile_body(planes, n: int, bp: int, table, fv, iv, first: int,
                  count: int):
    v, lidx, blk = _tiles(planes, n, bp)
    rows = _rows(table, first, count)
    step = max(1, PLAIN_STEP >> bp)
    for b0 in range(0, v.shape[1], step):
        vc, bc = v[:, b0:b0 + step], blk[b0:b0 + step]
        for row in rows:
            _tile_op_plain(vc, lidx, bc, bp, row, fv, iv)


def in_tile_sweep_plain(planes, n: int, bp: int, table, fv, iv,
                        first: int, count: int):
    """Plain version of :func:`in_tile_sweep` (in place, returns planes)."""
    return _in_compute_type(planes, fv, lambda w, f: _in_tile_body(
        w, n, bp, table, f, iv, first, count))


def _pair_mix(lo, hi, f, kind, sel_lo, sel_hi):
    """The leading op's 2x2 on tile views lo (target bit clear) and hi,
    in place; sel_* are the control selects or None."""
    lo_r, lo_i, hi_r, hi_i = lo[0], lo[1], hi[0], hi[1]
    if kind == KIND_CODE["gen"]:
        nlo_r = f[0] * lo_r - f[4] * lo_i + f[1] * hi_r - f[5] * hi_i
        nlo_i = f[0] * lo_i + f[4] * lo_r + f[1] * hi_i + f[5] * hi_r
        nhi_r = f[2] * lo_r - f[6] * lo_i + f[3] * hi_r - f[7] * hi_i
        nhi_i = f[2] * lo_i + f[6] * lo_r + f[3] * hi_i + f[7] * hi_r
    else:  # inv: [tr.re, tr.im, bl.re, bl.im]
        nlo_r = f[0] * hi_r - f[1] * hi_i
        nlo_i = f[0] * hi_i + f[1] * hi_r
        nhi_r = f[2] * lo_r - f[3] * lo_i
        nhi_i = f[2] * lo_i + f[3] * lo_r
    nlo = torch.stack([nlo_r, nlo_i])
    nhi = torch.stack([nhi_r, nhi_i])
    if sel_lo is not None:
        nlo = torch.where(sel_lo, nlo, lo)
        nhi = torch.where(sel_hi, nhi, hi)
    lo.copy_(nlo)
    hi.copy_(nhi)


def _pair_body(planes, n: int, bp: int, table, fv, iv, xop: int,
               first: int, count: int):
    kind, t, has_ctrl, foff, ioff = _rows(table, xop, 1)[0]
    h = t - bp
    nblk = 1 << (n - bp)
    block = 1 << bp
    A, B = nblk >> (h + 1), 1 << h
    pv = planes.view(2, A, 2, B, block)
    f = fv[foff:foff + _NFLOATS["gen" if kind == KIND_CODE["gen"] else "inv"]]
    if has_ctrl:
        lm, lv, gm, gv = _masks(iv, has_ctrl, ioff, bp, planes)
        lsel = (gk._iota(block, planes.device) & lm) == lv
        ids = gk._iota(nblk, planes.device).view(A, 2, B, 1)
    # steps over the (A, B) grid of tile pairs, PLAIN_STEP amplitudes each
    sb = min(B, max(1, PLAIN_STEP // (2 * block)))
    sa = max(1, PLAIN_STEP // (2 * block * B)) if sb == B else 1
    for a0 in range(0, A, sa):
        for b0 in range(0, B, sb):
            lo = pv[:, a0:a0 + sa, 0, b0:b0 + sb]
            hi = pv[:, a0:a0 + sa, 1, b0:b0 + sb]
            sel_lo = sel_hi = None
            if has_ctrl:
                cid = ids[a0:a0 + sa, :, b0:b0 + sb]
                sel_lo = lsel & ((cid[:, 0] & gm) == gv)
                sel_hi = lsel & ((cid[:, 1] & gm) == gv)
            _pair_mix(lo, hi, f, kind, sel_lo, sel_hi)
    _in_tile_body(planes, n, bp, table, fv, iv, first, count)


def pair_sweep_plain(planes, n: int, bp: int, table, fv, iv, xop: int,
                     first: int, count: int):
    """Plain version of :func:`pair_sweep` (in place, returns planes):
    tile i (target bit clear) and its partner j = i | (1 << h) mix
    through the leading op's 2x2, each with its own control select, then
    the segment's in-tile ops run on every tile."""
    return _in_compute_type(planes, fv, lambda w, f: _pair_body(
        w, n, bp, table, f, iv, xop, first, count))


# ---------------------------------------------------------------------------
# the kernel's register layout and routes (csrc/window_kernel.cu)
# ---------------------------------------------------------------------------

# in-tile register bits of a thread in float32 planes: the in-tile
# sweep's and the pair sweep's (Amp<T> of the source; reg_bits by dtype)
TILE_REG_BITS = 5
PAIR_REG_BITS = 4
LANE_BITS = 5       # a warp's 32 lanes
PAIR_ROUTES = ("pair", "diagonal", "register", "lane", "warp")
TILE_ROUTES = PAIR_ROUTES[1:]


def reg_bits(dtype=torch.float32, pair: bool = False) -> int:
    """In-tile register bits of a thread at bp >= them.  The pair sweep
    takes 4, 3 in float64, whose values take two registers each.  The
    in-tile sweep holds one tile, so float32 takes one bit more, 5;
    float64 and 16-bit planes take 4 (16-bit K1 reads best with the
    wider block)."""
    if pair:
        return PAIR_REG_BITS - (dtype == torch.float64)
    return TILE_REG_BITS if dtype == torch.float32 else TILE_REG_BITS - 1


def tile_layout(bp: int, dtype=torch.float32, pair: bool = False) -> dict:
    """Where the kernel keeps each in-tile bit of a tile of `dtype`
    planes (of both tiles of a pair with ``pair``).

    A thread holds the amplitudes of its ``register`` bits (the two
    lowest in-tile bits and the highest ``min(R, bp) - 2``, R =
    :func:`reg_bits`): 2^len(register) of them, twice that for a pair.
    The other in-tile bits index the thread, low to high: ``lane`` bits
    first (up to five), then ``warp`` bits.  Neighbouring threads hold
    neighbouring groups of four amplitudes."""
    rin = min(reg_bits(dtype, pair), bp)
    lo = min(2, rin)
    hs = bp - (rin - lo)
    thread = list(range(lo, hs))
    return {"register": list(range(lo)) + list(range(hs, bp)),
            "lane": thread[:LANE_BITS], "warp": thread[LANE_BITS:],
            "threads": 1 << len(thread)}


def pair_layout(bp: int, dtype=torch.float32) -> dict:
    """:func:`tile_layout` of the pair sweep."""
    return tile_layout(bp, dtype, pair=True)


def tile_route(kind: str, target: int, bp: int, dtype=torch.float32,
               pair: bool = False) -> str:
    """The kernel's route for one op of a segment: cphase and diag run in
    registers whatever their target (``diagonal``); an in-tile inv/gen on
    a ``register`` bit mixes registers, on a ``lane`` bit exchanges by
    warp shuffle, on a ``warp`` bit through shared memory; the pair
    sweep's leading cross-tile inv/gen (``pair``) mixes registers.  An
    in-tile segment holds no cross-tile inv/gen (ValueError)."""
    if kind in ("cphase", "diag"):
        return "diagonal"
    if target >= bp:
        if not pair:
            raise ValueError(f"{kind} on bit {target} >= bp = {bp} leads a "
                             "pair sweep; an in-tile segment has none")
        return "pair"
    lay = tile_layout(bp, dtype, pair)
    return next(r for r in ("register", "lane", "warp") if target in lay[r])


def pair_route(kind: str, target: int, bp: int,
               dtype=torch.float32) -> str:
    """:func:`tile_route` of the pair sweep."""
    return tile_route(kind, target, bp, dtype, pair=True)


def in_tile_sweep_emulated(planes, n: int, bp: int, table, fv, iv,
                           first: int, count: int):
    """The in-tile kernel's computation in torch, for the tests (never on
    the main path): see :func:`pair_sweep_emulated`, on one tile."""
    return _in_compute_type(planes, fv, lambda w, f: _emulated_body(
        w, n, bp, table, f, iv, None, first, count, planes.dtype))


def pair_sweep_emulated(planes, n: int, bp: int, table, fv, iv, xop: int,
                        first: int, count: int):
    """The pair kernel's computation in torch, for the tests (never on the
    main path): each tile pair gathered into the kernel's layout
    ``(2, pairs, threads, registers)``, every op decoded as the kernel
    decodes it (its masks split into tile, thread and register parts) and
    applied by its route, in order; then scattered back.  In place,
    returns planes; 16-bit planes compute in float32 and round once, as
    the kernel does."""
    return _in_compute_type(planes, fv, lambda w, f: _emulated_body(
        w, n, bp, table, f, iv, xop, first, count, planes.dtype))


def _emulated_body(planes, n, bp, table, fv, iv, xop, first, count, dtype):
    """Body of both emulations; ``xop`` None is the in-tile sweep."""
    names = {v: k for k, v in KIND_CODE.items()}
    rows = table.cpu().tolist()
    ivh = iv.cpu().tolist()
    pair = xop is not None
    lay = tile_layout(bp, dtype, pair)
    dev = planes.device
    if pair:
        h = rows[xop][1] - bp
        q = gk._iota(1 << (n - bp - 1), dev)
        tile = ((q >> h) << (h + 1)) | (q & ((1 << h) - 1))
        regbits = lay["register"] + [bp + h]  # register index bit -> index bit
        tile_mask = ~(1 << h)                 # the pair bit is a register bit
        order = [xop] + list(range(first, first + count))
    else:
        tile = gk._iota(1 << (n - bp), dev)
        regbits = lay["register"]
        tile_mask = -1
        order = list(range(first, first + count))
    thrbits = lay["lane"] + lay["warp"]       # thread index bit -> index bit
    nr, nt = 1 << len(regbits), lay["threads"]
    tid = gk._iota(nt, dev)
    k = gk._iota(nr, dev)

    def spread(ids, bits):
        out = torch.zeros_like(ids)
        for b, gb in enumerate(bits):
            out |= ((ids >> b) & 1) << gb
        return out

    def part(m, bits):
        return sum(((m >> gb) & 1) << b for b, gb in enumerate(bits))

    index = ((tile << bp).view(-1, 1, 1) + spread(tid, thrbits).view(1, -1, 1)
             + spread(k, regbits).view(1, 1, -1)).reshape(-1)
    v = planes[:, index].view(2, -1, nt, nr)
    zero = torch.zeros((), dtype=planes.dtype, device=dev)

    def mix(v, own, partner, sel):
        """v -> own * v + partner-coefficient * partner values, where sel."""
        (cor, coi, cpr, cpi), (pr, pi) = own, partner
        nr_ = cor * v[0] - coi * v[1] + cpr * pr - cpi * pi
        ni_ = cor * v[1] + coi * v[0] + cpr * pi + cpi * pr
        return torch.where(sel, torch.stack([nr_, ni_]), v)

    def row_of(s, m):
        """(own, partner) coefficients of row s of the 2x2 m."""
        return (torch.where(s, m[3], m[0]), torch.where(s, m[7], m[4]),
                torch.where(s, m[2], m[1]), torch.where(s, m[6], m[5]))

    for r in order:
        kind, t, has_ctrl, foff, ioff = rows[r]
        kind = names[kind]
        cm, cv = (ivh[ioff], ivh[ioff + 1]) if has_ctrl else (0, 0)
        if kind == "cphase":
            cm = cv = cm | (1 << t)
        gm = (cm >> bp) & tile_mask
        gv = (cv >> bp) & tile_mask
        sel = (((tile & gm) == gv).view(-1, 1, 1)
               & ((tid & part(cm, thrbits)) == part(cv, thrbits)).view(1, -1, 1)
               & ((k & part(cm, regbits)) == part(cv, regbits)).view(1, 1, -1))
        f = fv[foff:foff + _NFLOATS[kind]]
        if kind == "cphase":
            v = _cmul_where(sel, f[0], f[1], v)
            continue
        if kind == "diag":
            if t in regbits:
                bit = ((k >> regbits.index(t)) & 1).bool().view(1, 1, -1)
            elif t in thrbits:
                bit = ((tid >> thrbits.index(t)) & 1).bool().view(1, -1, 1)
            else:
                bit = ((tile >> (t - bp)) & 1).bool().view(-1, 1, 1)
            v = _cmul_where(sel, torch.where(bit, f[2], f[0]),
                            torch.where(bit, f[3], f[1]), v)
            continue
        m = (list(f) if kind == "gen"
             else [zero, f[0], f[2], zero, zero, f[1], f[3], zero])
        if t in regbits:       # pair / register: the partner is a register
            b = regbits.index(t)
            s = ((k >> b) & 1).bool().view(1, 1, -1)
            p = v[:, :, :, k ^ (1 << b)]
        else:                  # lane / warp: the partner is a thread
            b = thrbits.index(t)
            s = ((tid >> b) & 1).bool().view(1, -1, 1)
            p = v[:, :, tid ^ (1 << b), :]
        v = mix(v, row_of(s, m), (p[0], p[1]), sel)
    planes[:, index] = v.reshape(2, -1)
    return planes


# ---------------------------------------------------------------------------
# the CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

SOURCE = cuda_build.CSRC / "window_kernel.cu"


def load_library():
    """The built kernel library (ops/cuda_build.py), loaded once per
    process."""
    lib = cuda_build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qtt_window_in_tile.argtypes = [ptr, i32, i32, i32, ptr, i32, i32,
                                       ptr, ptr, ptr]
    lib.qtt_window_in_tile.restype = i32
    lib.qtt_window_pair.argtypes = [ptr, i32, i32, i32, ptr, i32, i32, i32,
                                    ptr, ptr, ptr]
    lib.qtt_window_pair.restype = i32
    return lib


def _check_launch(planes, n: int, bp: int, table, fv, iv, rows: Sequence[int]):
    if planes.dtype not in DTYPE_CODE:
        raise ValueError(f"window kernel takes {sorted(map(str, DTYPE_CODE))} "
                         f"planes, not {planes.dtype}")
    if tuple(planes.shape) != (2, 1 << n) or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous (2, 2^{n}), got "
                         f"{tuple(planes.shape)}")
    vec = VECTOR_BYTES[planes.dtype]
    if planes.data_ptr() % vec:
        raise ValueError(f"{planes.dtype} planes must start on a {vec}-byte "
                         "boundary (the pair kernel's vector accesses)")
    top = max_block_pow(planes.dtype)
    if not (1 <= bp <= min(n, top)) or n > MAX_QB:
        raise ValueError(f"window kernel needs 1 <= bp <= min(n, {top}) and "
                         f"n <= {MAX_QB} at {planes.dtype} (n={n}, bp={bp})")
    for name, t, dt in (("table", table, torch.int32),
                        ("fv", fv, planes.dtype), ("iv", iv, torch.int32)):
        if t.device != planes.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{planes.device}")
    if table.dim() != 2 or table.shape[1] != _ROW:
        raise ValueError("op table must be (ops, 5)")
    if rows and (min(rows) < 0 or max(rows) > table.shape[0]):
        raise ValueError("segment rows outside the op table")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"window kernel {what} launch failed: CUDA error "
                           f"{err}")


def in_tile_sweep(planes, n: int, bp: int, table, fv, iv,
                  first: int, count: int):
    """One sweep applying table rows [first, first + count) to every tile
    (in place, returns planes)."""
    if planes.device.type == "cpu":
        return in_tile_sweep_plain(planes, n, bp, table, fv, iv, first, count)
    if planes.device.type != "cuda":
        raise ValueError(f"window kernel: unsupported device {planes.device}")
    _check_launch(planes, n, bp, table, fv, iv, [first, first + count])
    lib = load_library()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.qtt_window_in_tile(planes.data_ptr(),
                                     DTYPE_CODE[planes.dtype], n, bp,
                                     table.data_ptr(), first, count,
                                     fv.data_ptr(), iv.data_ptr(), stream)
    _raise_on(err, "in_tile")
    _count("in_tile", planes.dtype)
    return planes


def pair_sweep(planes, n: int, bp: int, table, fv, iv, xop: int,
               first: int, count: int):
    """One sweep over tile pairs: the cross-tile op at table row `xop`,
    then rows [first, first + count) in-tile (in place, returns planes)."""
    if planes.device.type == "cpu":
        return pair_sweep_plain(planes, n, bp, table, fv, iv, xop, first, count)
    if planes.device.type != "cuda":
        raise ValueError(f"window kernel: unsupported device {planes.device}")
    _check_launch(planes, n, bp, table, fv, iv, [xop, xop + 1, first,
                                                 first + count])
    lib = load_library()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.qtt_window_pair(planes.data_ptr(),
                                  DTYPE_CODE[planes.dtype], n, bp,
                                  table.data_ptr(), xop, first, count,
                                  fv.data_ptr(), iv.data_ptr(), stream)
    _raise_on(err, "pair")
    _count("pair", planes.dtype)
    return planes


# ---------------------------------------------------------------------------
# whole windows
# ---------------------------------------------------------------------------

def segment_launches(structure: Tuple, bp: int):
    """The window's sweeps as (xop or None, first, count) table ranges."""
    out = []
    for seg in plan_window(structure, bp):
        first = seg["ops"][0][0] if seg["ops"] else 0
        xop = seg["xgen"][0] if seg["xgen"] is not None else None
        out.append((xop, first, len(seg["ops"])))
    return out


def apply_window(planes, n: int, structure: Tuple, fv, iv, table,
                 block_pow: int = DEFAULT_BLOCK_POW, plain: bool = False):
    """Run every planned sweep of a window (in place, returns planes).
    ``plain=True`` runs the plain version whatever the device (the
    kernel-against-plain comparison on the card)."""
    bp = min(block_pow, n)
    for xop, first, count in segment_launches(structure, bp):
        if xop is None:
            sweep = in_tile_sweep_plain if plain else in_tile_sweep
            sweep(planes, n, bp, table, fv, iv, first, count)
        else:
            sweep = pair_sweep_plain if plain else pair_sweep
            sweep(planes, n, bp, table, fv, iv, xop, first, count)
    return planes


def make_window_fn(n: int, structure: Tuple,
                   block_pow: int = DEFAULT_BLOCK_POW, plain: bool = False):
    """The parametric window kernel: fn(planes, *operands) with the dense
    fusion operand layout, paying ``fn.sweeps`` sweeps (one per planned
    segment).  Updates the planes in place and returns them."""
    bp = min(block_pow, n)

    def fn(planes, *operands):
        fv, iv = pack_operands(structure, operands, planes.dtype, planes.device)
        table = op_table(structure, planes.device)
        return apply_window(planes, n, structure, fv, iv, table, bp, plain)

    fn.sweeps = plan_sweeps(structure, bp)
    fn.block_pow = bp
    return fn


def make_segment_fn(ops: Sequence[Tuple], n: int,
                    block_pow: int = DEFAULT_BLOCK_POW):
    """Window kernel over a list of (kind, target, cmask, cval, m) tuples
    with baked matrices: fn(planes) -> planes."""
    from . import fusion as fu

    fused = [fu.FusedOp(fu.classify(np.asarray(m), cmask, cval), target,
                        cmask, cval, np.asarray(m))
             for (kind, target, cmask, cval, m) in ops]
    structure = fu.structure_of(fused)
    wfn = make_window_fn(n, structure, block_pow=block_pow)
    operands = fu.dense_operands(fused)

    def fn(planes):
        return wfn(planes, *operands)

    fn.sweeps = wfn.sweeps
    return fn
