"""Fused dequantize -> gate(s) -> requantize sweeps over the TurboQuant
engine's compressed ket (CUDA C++ kernel in csrc/turboquant_kernel.cu,
with its plain PyTorch versions here).

The counterpart of the JAX package's ops/pallas_turboquant.py, over the
same operands: codes (B, 2D) int8/int16 and scales (B,) float32 (one row
per block of D = 2^bp amplitudes, rotated by the shared (2D, 2D)
matrix), the rotation and its transpose, and the gate's payload and
masks.  Per tile of T = 2^tp amplitudes (TB = T / D rows): dequantize,
apply the gate or the window, rotate back, requantize.  Tiles that no op
acts on keep their codes and scales bit for bit.

Three entry points, each with a launch count:

* :func:`tq_gate_low` — one generic 2x2 with target < tp (make_tq_gate_low);
* :func:`tq_diag` — one diagonal at any target (make_tq_diag);
* :func:`tq_window` — a whole fused window in one sweep (make_tq_window),
  its structure as an int32 op table over the split-mask operand layout
  of ``fusion.sharded_operands`` (:func:`pack_window`).

On a CUDA tensor each launches the kernel or raises; on a CPU tensor it
runs the plain version (:func:`tq_gate_low_plain`, :func:`tq_diag_plain`,
:func:`tq_window_plain`), which follows the kernel's decomposition: codes
viewed as (tiles, TB, 2D), the same lo/hi mask split and the same dirty
rule, over groups of tiles so that a wide ket never decodes at once.
Both update codes and scales in place and return them.

The kernel takes both products on the tensor cores with a split-TF32
operand (csrc/turboquant_kernel.cu); :func:`split_tf32_matmul` emulates
that arithmetic on the CPU, and the plain versions take it with
``split_tf32=True`` (the CPU tests hold it against the JAX kernels).  The
main path never does.

The port's default tile is 2^12 amplitudes, not the Pallas kernels'
2^18 (a TPU VMEM size): a CUDA block holds the rotation, the tile in
float32 and two tiles of codes in at most 227 KB of shared memory.  The
tile decides which tiles count as dirty, so parity tests pin the same
tile on both sides.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from . import window_kernel as wk
from ..storage import turboquant as tq
from ..utils.device import resolve_device

DEFAULT_TILE_POW = 12
MAX_BLOCK_POW = 6                 # 2D = 128, the kernel's product width
SMEM_LIMIT = 232_448              # bytes of shared memory a block may use
#: f32 amplitudes a plain-version step decodes at once (512 MiB of planes)
PLAIN_GROUP_AMPS = 1 << 26

_NFLOATS = {"cphase": 2, "diag": 4, "gen": 8}
_NINTS = {"cphase": 2, "diag": 4, "gen": 4}
_ROW = 5  # op-table columns: kind, target, has_ctrl, float offset, int offset

#: kernel launches per entry point (never the plain versions' calls)
LAUNCHES = {"gate_low": 0, "diag": 0, "window": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(block_pow: int, tile_pow: int, code_bytes: int = 2) -> int:
    """Shared memory of one block (csrc/turboquant_kernel.cu smem_bytes):
    the 128 x 128 rotation, the tile as float32 rows 128 wide (at least
    64 of them), two code buffers of that shape and two scale buffers.
    code_bytes 2 (int16) is the larger."""
    rows = max(64, -(-(2 << tile_pow) // 128))
    tb = 1 << (tile_pow - block_pow)
    return 4 * (128 * 128 + rows * 128 + 2 * tb) + 2 * rows * 128 * code_bytes


def layout(codes, tile_pow: int) -> Tuple[int, int, int, int]:
    """(block_pow, T, TB, n_tiles) of a code array swept in 2^tile_pow
    amplitude tiles."""
    D = codes.shape[1] // 2
    bp = D.bit_length() - 1
    if D != 1 << bp:
        raise ValueError(f"code rows must hold 2 * 2^bp values, not "
                         f"{codes.shape[1]}")
    if tile_pow < bp:
        raise ValueError(f"a tile must cover whole blocks: tile_pow "
                         f"{tile_pow} < block_pow {bp}")
    T = 1 << tile_pow
    TB = T >> bp
    if codes.shape[0] % TB:
        raise ValueError(f"{codes.shape[0]} code rows do not split into "
                         f"tiles of {TB} rows")
    return bp, T, TB, codes.shape[0] // TB


# ---------------------------------------------------------------------------
# the window's operand table (shared by the kernel and its plain version)
# ---------------------------------------------------------------------------

def pack_window(structure: Tuple, operands: Sequence, device=None):
    """(table, fv, iv) of a window: the (ops, 5) int32 op table (kind
    code, target, has_ctrl, float offset, int offset), the float32
    payloads and the int32 masks, in the split-mask layout of
    ``fusion.sharded_operands``, on `device` (``cuda`` by default)."""
    dev = resolve_device(device)
    rows: List[Tuple[int, ...]] = []
    fs: List = []
    ints: List = []
    f = i = k = 0
    for kind, target, has_ctrl in structure:
        if kind not in _NFLOATS:
            raise ValueError(f"the TurboQuant window takes cphase/diag/gen "
                             f"ops, not {kind!r}")
        rows.append((wk.KIND_CODE[kind], target, int(has_ctrl), f, i))
        fs.append(torch.as_tensor(operands[k], dtype=torch.float32,
                                  device=dev).reshape(-1))
        f += _NFLOATS[kind]
        k += 1
        if has_ctrl:
            for v in operands[k:k + _NINTS[kind]]:
                ints.append(torch.as_tensor(v, dtype=torch.int32,
                                            device=dev).reshape(()))
            i += _NINTS[kind]
            k += _NINTS[kind]
    table = torch.tensor(rows, dtype=torch.int32).reshape(-1, _ROW).to(dev)
    fv = torch.cat(fs) if fs else torch.zeros(1, dtype=torch.float32,
                                              device=dev)
    iv = (torch.stack(ints) if ints
          else torch.zeros(1, dtype=torch.int32, device=dev))
    return table, fv, iv


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gate_low_dirty(blk, hm: int, hv: int):
    """Tiles (ids `blk`) that make_tq_gate_low requantizes."""
    return (blk & hm) == hv


def diag_dirty(blk, dp, tm_lo: int, tb_hi: int, lm: int, hm: int, hv: int):
    """Tiles that make_tq_diag requantizes: the high control test holds
    and the factor is not identically 1."""
    d = np.asarray(dp, dtype=np.float32)
    hi_bit = (blk & tb_hi) != 0
    cf_re = torch.where(hi_bit, float(d[0, 0, 1]), float(d[0, 0, 0]))
    cf_im = torch.where(hi_bit, float(d[1, 0, 1]), float(d[1, 0, 0]))
    ident = (tm_lo == 0) & (lm == 0) & (cf_re == 1.0) & (cf_im == 0.0)
    return ((blk & hm) == hv) & ~ident


def _op_masks(iv, has_ctrl: int, ioff: int, n: int):
    if has_ctrl:
        return [iv[ioff + j] for j in range(n)]
    return [0] * n


def window_dirty(blk, tile_pow: int, rows, fv, iv):
    """Tiles a window requantizes (make_tq_window's dirty accumulator):
    any op whose high control test holds, where a whole-tile diagonal
    whose factor is identically 1 does not count."""
    dirty = torch.zeros_like(blk, dtype=torch.bool)
    for kind, t, has_ctrl, foff, ioff in rows:
        if kind == wk.KIND_CODE["cphase"]:
            if has_ctrl:
                chi = iv[ioff + 1]
            else:
                chi = (1 << t) >> tile_pow
            dirty = dirty | ((blk & chi) == chi)
            continue
        lm, _lv, gm, gv = _op_masks(iv, has_ctrl, ioff, 4)
        hi_ok = (blk & gm) == gv
        if kind == wk.KIND_CODE["diag"] and t >= tile_pow:
            hi_bit = (blk & (1 << (t - tile_pow))) != 0
            cf_re = torch.where(hi_bit, fv[foff + 2], fv[foff])
            cf_im = torch.where(hi_bit, fv[foff + 3], fv[foff + 1])
            ident = (lm == 0) & (cf_re == 1.0) & (cf_im == 0.0)
            dirty = dirty | (hi_ok & ~ident)
        else:
            dirty = dirty | hi_ok
    return dirty


def tf32_rna(x):
    """float32 `x` rounded to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``: add half of the
    13 dropped bits to the bit pattern, then clear them (the same for
    both signs, since the sign sits apart from the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_matmul(a, b):
    """a @ b as the kernel's tensor cores take it ("3xTF32"): each
    operand split as x = hi + lo with hi = tf32(x), lo = tf32(x - hi),
    and hi·hi + hi·lo + lo·hi summed in float32 (lo·lo dropped).  Every
    product of two TF32 values is exact in float32.  For codes that are
    exact in TF32 (int8) lo is 0, so only the rotation is split."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _sweep_plain(codes, scales, rot, rot_t, bits: int, tile_pow: int,
                 dirty_fn, apply_fn, split_tf32: bool = False):
    """The kernel's decomposition with torch ops, over groups of tiles:
    dequantize, apply_fn(planes (2, g, T), lidx, blk), requantize, keep
    the tiles dirty_fn(blk) leaves clean bit for bit.  With split_tf32
    the two products follow the kernel's tensor-core arithmetic
    (:func:`split_tf32_matmul`, the codes times the rotation with the
    row factor scale / qmax after); without, both are float32 matmuls
    on the dequantized rows, in the JAX kernels' order."""
    bp, T, TB, nblk = layout(codes, tile_pow)
    D = 1 << bp
    qmax = float(tq.qmax(bits))
    c3 = codes.view(nblk, TB, 2 * D)
    s2 = scales.view(nblk, TB)
    dev = codes.device
    lidx = torch.arange(T, dtype=torch.int32, device=dev)
    G = max(1, min(nblk, PLAIN_GROUP_AMPS // T))
    for b0 in range(0, nblk, G):
        b1 = min(nblk, b0 + G)
        g = b1 - b0
        blk = torch.arange(b0, b1, dtype=torch.int32, device=dev).view(g, 1)
        dirty = dirty_fn(blk).reshape(g, 1)
        if not bool(dirty.any()):
            continue
        cc, ss = c3[b0:b1], s2[b0:b1]
        fq = (ss / qmax).unsqueeze(-1)
        if split_tf32:
            rows = split_tf32_matmul(cc.to(torch.float32), rot_t) * fq
        else:
            rows = (cc.to(torch.float32) * fq) @ rot_t
        v = rows.view(g, TB, 2, D).permute(2, 0, 1, 3).reshape(2, g, T)
        v = apply_fn(v, lidx, blk)
        back = v.reshape(2, g, TB, D).permute(1, 2, 0, 3).reshape(g, TB, 2 * D)
        y2 = split_tf32_matmul(back, rot) if split_tf32 else back @ rot
        sc = y2.abs().amax(-1)
        safe = torch.where(sc > 0, sc, 1.0)
        nc = torch.round(y2 / safe.unsqueeze(-1) * qmax).to(codes.dtype)
        cc.copy_(torch.where(dirty.unsqueeze(-1), nc, cc))
        ss.copy_(torch.where(dirty, sc, ss))
    return codes, scales


def tq_gate_low_plain(codes, scales, rot, rot_t, bits: int, tile_pow: int,
                      mp, target: int, hm: int, hv: int, lm: int, lv: int,
                      split_tf32: bool = False):
    """Plain version of :func:`tq_gate_low` (in place); split_tf32 as in
    :func:`_sweep_plain`."""
    m = np.asarray(mp, dtype=np.float32).tolist()
    return _sweep_plain(
        codes, scales, rot, rot_t, bits, tile_pow,
        lambda blk: gate_low_dirty(blk, hm, hv),
        lambda v, lidx, blk: wk.tile_local_2x2(v, lidx, blk, target, m,
                                               lm, lv, 0, 0)[0], split_tf32)


def tq_diag_plain(codes, scales, rot, rot_t, bits: int, tile_pow: int, dp,
                  tm_lo: int, tb_hi: int, lm: int, lv: int, hm: int, hv: int,
                  split_tf32: bool = False):
    """Plain version of :func:`tq_diag` (in place); split_tf32 as in
    :func:`_sweep_plain`."""
    d = np.asarray(dp, dtype=np.float32)
    d0re, d1re, d0im, d1im = (float(d[0, 0, 0]), float(d[0, 0, 1]),
                              float(d[1, 0, 0]), float(d[1, 0, 1]))

    def apply(v, lidx, blk):
        hi_bit = (blk & tb_hi) != 0
        bit = ((lidx & tm_lo) != 0) | hi_bit
        fre = torch.where(bit, d1re, d0re)
        fim = torch.where(bit, d1im, d0im)
        return wk._cmul_where((lidx & lm) == lv, fre, fim, v)

    return _sweep_plain(
        codes, scales, rot, rot_t, bits, tile_pow,
        lambda blk: diag_dirty(blk, dp, tm_lo, tb_hi, lm, hm, hv), apply,
        split_tf32)


def tq_window_plain(codes, scales, rot, rot_t, bits: int, tile_pow: int,
                    structure: Tuple, operands: Sequence,
                    split_tf32: bool = False):
    """Plain version of :func:`tq_window` (in place): the same op table,
    every op through the shared tile primitives (window_kernel.tile_*);
    split_tf32 as in :func:`_sweep_plain`."""
    _check_structure(structure, tile_pow)
    table, fv, iv = pack_window(structure, operands, codes.device)
    rows = table.cpu().tolist()
    lbits = (1 << tile_pow) - 1

    def apply(v, lidx, blk):
        for kind, t, has_ctrl, foff, ioff in rows:
            if kind == wk.KIND_CODE["cphase"]:
                if has_ctrl:
                    clo, chi = iv[ioff], iv[ioff + 1]
                else:
                    comb = 1 << t
                    clo, chi = comb & lbits, comb >> tile_pow
                v = wk.tile_cphase(v, lidx, blk, clo, chi,
                                   fv[foff], fv[foff + 1])[0]
                continue
            lm, lv, gm, gv = _op_masks(iv, has_ctrl, ioff, 4)
            if kind == wk.KIND_CODE["diag"]:
                v = wk.tile_diag(v, lidx, blk, t, tile_pow, fv[foff],
                                 fv[foff + 1], fv[foff + 2], fv[foff + 3],
                                 lm, lv, gm, gv)[0]
            else:
                mp = fv[foff:foff + 8].view(2, 2, 2)
                v = wk.tile_local_2x2(v, lidx, blk, t, mp, lm, lv, gm, gv)[0]
        return v

    return _sweep_plain(
        codes, scales, rot, rot_t, bits, tile_pow,
        lambda blk: window_dirty(blk, tile_pow, rows, fv, iv), apply,
        split_tf32)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

SOURCE = cuda_build.CSRC / "turboquant_kernel.cu"


def load_library():
    """The built kernel library (ops/cuda_build.py), loaded once per
    process."""
    lib = cuda_build.load(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [ptr, i32, ptr, ptr, ptr, i32, i32, i32, f32]
    lib.qtt_tq_gate_low.argtypes = head + [ptr, i32, i32, i32, i32, i32, ptr]
    lib.qtt_tq_diag.argtypes = head + [ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.qtt_tq_window.argtypes = head + [ptr, i32, ptr, ptr, ptr]
    for fn in (lib.qtt_tq_gate_low, lib.qtt_tq_diag, lib.qtt_tq_window):
        fn.restype = i32
    return lib


def _check(codes, scales, rot, bits: int, tile_pow: int):
    """Shapes, dtypes and fit of a launch; returns (bp, n_tiles).  The
    kernel reads the rotation alone in both orders, so rot_t is not
    checked: the entry points still take it, and a later change of their
    C signatures can drop it."""
    want = torch.int8 if bits <= 8 else torch.int16
    if codes.dtype != want:
        raise ValueError(f"{bits}-bit codes are {want}, not {codes.dtype}")
    if codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous (B, 2D) tensor")
    bp, _T, _TB, nblk = layout(codes, tile_pow)
    if bp > MAX_BLOCK_POW:
        raise ValueError(f"the kernel takes block_pow <= {MAX_BLOCK_POW}, "
                         f"not {bp}")
    need = smem_bytes(bp, tile_pow, codes.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(
            f"a 2^{tile_pow}-amplitude tile of {bits}-bit codes needs {need} "
            f"bytes of shared memory, more than a block's {SMEM_LIMIT}")
    n = 2 << bp
    for name, t, shape in (("scales", scales, (codes.shape[0],)),
                           ("rot", rot, (n, n))):
        if (t.device != codes.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {codes.device}")
    return bp, nblk


def _launch(entry: str, codes, scales, rot, rot_t, bits, tile_pow, *args):
    if codes.device.type != "cuda":
        raise ValueError(f"TurboQuant kernel: unsupported device "
                         f"{codes.device}")
    bp, nblk = _check(codes, scales, rot, bits, tile_pow)
    lib = load_library()
    fn = getattr(lib, f"qtt_tq_{entry}")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = fn(codes.data_ptr(), codes.element_size(), scales.data_ptr(),
                 rot.data_ptr(), rot_t.data_ptr(), bp, tile_pow, nblk,
                 float(tq.qmax(bits)), *args, stream)
    if err != 0:
        raise RuntimeError(f"TurboQuant {entry} launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[entry] += 1
    return codes, scales


def _floats(a, n: int):
    host = np.ascontiguousarray(np.asarray(a, dtype=np.float32).reshape(-1))
    if host.size != n:
        raise ValueError(f"expected {n} payload floats, got {host.size}")
    return host


def tq_gate_low(codes, scales, rot, rot_t, bits: int, tile_pow: int, mp,
                target: int, hm: int, hv: int, lm: int, lv: int):
    """One generic 2x2 with target < tile_pow (in place, returns codes
    and scales).  mp is (2, 2, 2) host matrix planes; (hm, hv) the
    control mask's part above the tile, tested against the tile id,
    (lm, lv) its part inside, tested against the in-tile index."""
    if codes.device.type == "cpu":
        return tq_gate_low_plain(codes, scales, rot, rot_t, bits, tile_pow,
                                 mp, target, hm, hv, lm, lv)
    if not 0 <= target < tile_pow:
        raise ValueError(f"target {target} is not inside the 2^{tile_pow} "
                         "tile")
    m = _floats(mp, 8)
    return _launch("gate_low", codes, scales, rot, rot_t, bits, tile_pow,
                   m.ctypes.data, target, hm, hv, lm, lv)


def tq_diag(codes, scales, rot, rot_t, bits: int, tile_pow: int, dp,
            tm_lo: int, tb_hi: int, lm: int, lv: int, hm: int, hv: int):
    """One diagonal at any target (in place, returns codes and scales).
    dp is (2, 2, 2) host planes holding dp[0,0,0] = d0.re, dp[0,0,1] =
    d1.re, dp[1,0,0] = d0.im, dp[1,0,1] = d1.im (make_tq_diag's packing);
    the target is the in-tile bit tm_lo or the tile-id bit tb_hi."""
    if codes.device.type == "cpu":
        return tq_diag_plain(codes, scales, rot, rot_t, bits, tile_pow, dp,
                             tm_lo, tb_hi, lm, lv, hm, hv)
    d = np.asarray(dp, dtype=np.float32)
    dh = _floats([d[0, 0, 0], d[1, 0, 0], d[0, 0, 1], d[1, 0, 1]], 4)
    return _launch("diag", codes, scales, rot, rot_t, bits, tile_pow,
                   dh.ctypes.data, tm_lo, tb_hi, lm, lv, hm, hv)


def _check_structure(structure: Tuple, tile_pow: int) -> None:
    """A gen op needs its pair inside the tile (the engine's _fuse_admit
    guarantees it)."""
    for kind, target, _c in structure:
        if kind == "gen" and target >= tile_pow:
            raise ValueError(f"gen target {target} is not inside the "
                             f"2^{tile_pow} tile")


def tq_window(codes, scales, rot, rot_t, bits: int, tile_pow: int,
              structure: Tuple, operands: Sequence):
    """A whole window in one sweep — one dequantize, every op, one
    requantize — (in place, returns codes and scales).  `structure` is
    fusion.sharded_structure_of's, `operands` fusion.sharded_operands'
    split at `tile_pow`; they reach the kernel as a runtime op table
    (:func:`pack_window`), so one binary serves every window."""
    if codes.device.type == "cpu":
        return tq_window_plain(codes, scales, rot, rot_t, bits, tile_pow,
                               structure, operands)
    _check_structure(structure, tile_pow)
    table, fv, iv = pack_window(structure, operands, codes.device)
    return _launch("window", codes, scales, rot, rot_t, bits, tile_pow,
                   table.data_ptr(), table.shape[0], fv.data_ptr(),
                   iv.data_ptr())
