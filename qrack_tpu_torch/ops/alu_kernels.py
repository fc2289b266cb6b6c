"""Vectorized index-map functions for the dense-engine ALU surface.

Counterpart of the reference's OpenCL/CUDA ALU kernel set (reference:
src/common/qheader_alu.cl:13-810 — inc/cinc/incdecc/incs/incdecsc/mul/
div/*modnout/indexedLda/indexedAdc/indexedSbc/hash/cphaseflipifless;
src/common/qheader_bcd.cl:1-143 — incbcd/incdecbcdc).  Each op is a
closed-form map on the basis-index vector: `*_src(xp, dst_idx, ...)`
returns, for every destination index, the source index whose amplitude
it receives (one gather), and the `*_pair` functions return the
(source, destination) index pairs of the out-of-place ops (one
scatter).  None of this is a hand-written kernel: it is plain index
algebra, the role XLA played in the JAX package.

Every function takes `xp`, the array module: numpy on the host oracle
(engines/cpu.py), torch on the CUDA engine.  On the CUDA engine:

  * the index vector is int32 (`gatekernels.IDX_DTYPE`) and every mask
    and constant here is a Python int below 2^31, so no temporary is
    promoted to int64;
  * a lookup table (`hash_src`'s inverse, the `indexed_*` tables) must
    already lie on the index vector's device, as an int32 tensor (the
    engine's `_index_table` puts it there);
  * the `*_pair` functions build their index pairs on the host, from
    numpy `deposit_indices`; the engine moves them to the device.

The split-index forms (``*_split``) take a ket index as a (page id,
in-page index) pair and serve the pager past 31 qubits and the
compressed engine's chunks, where no global index fits int32.  Here
the page id ``pid`` is a Python int (a page of the pager) or an int32
tensor that broadcasts against ``lidx`` (the chunk ids of the
compressed engine); ``lidx`` is an int32 tensor.  A value read from the
page id alone comes back as a 0-d tensor on ``lidx``'s device, so every
result broadcasts.  The JAX package computes the products of its
table-free MUL/DIV in uint32 lanes, which torch lacks; here they run in
int64 lanes with explicit masks and give the same bits.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _reg_get(xp, idx, start, length):
    return (idx >> start) & ((1 << length) - 1)


def _reg_set(xp, idx, start, length, value):
    mask = ((1 << length) - 1) << start
    return (idx & ~mask) | ((value << start) & mask)


def _ctrl_match(xp, idx, controls, perm):
    """Boolean vector: all control bits at their required values."""
    cmask = 0
    cval = 0
    for j, c in enumerate(controls):
        cmask |= 1 << c
        if (perm >> j) & 1:
            cval |= 1 << c
    return (idx & cmask) == cval


def inc_src(xp, idx, to_add, start, length, controls=(), perm=0):
    """INC: dst reg v receives src reg (v - to_add) mod 2^L
    (reference kernel inc, qheader_alu.cl:13)."""
    v = _reg_get(xp, idx, start, length)
    src_v = (v - to_add) & ((1 << length) - 1)
    src = _reg_set(xp, idx, start, length, src_v)
    if controls:
        src = xp.where(_ctrl_match(xp, idx, controls, perm), src, idx)
    return src


def incdecc_src(xp, idx, to_add, start, length, carry_index):
    """INCDECC: add over the (length+1)-bit register whose top bit is the
    carry qubit (reference kernel incdecc, qheader_alu.cl)."""
    v = _reg_get(xp, idx, start, length)
    c = (idx >> carry_index) & 1
    ext = v | (c << length)
    src_ext = (ext - to_add) & ((1 << (length + 1)) - 1)
    src = _reg_set(xp, idx, start, length, src_ext & ((1 << length) - 1))
    src_c = src_ext >> length
    src = (src & ~(1 << carry_index)) | (src_c << carry_index)
    return src


def incs_src(xp, idx, to_add, start, length, overflow_index):
    """INCS: INC plus overflow-qubit flip on signed overflow
    (reference kernel incs, qheader_alu.cl)."""
    to_add &= (1 << length) - 1
    v = _reg_get(xp, idx, start, length)
    src_v = (v - to_add) & ((1 << length) - 1)
    s = 1 << (length - 1)
    if to_add == 0:
        ovf = xp.zeros_like(v, dtype=bool)
    elif to_add < s:
        ovf = (src_v >= (s - to_add)) & (src_v < s)
    else:
        ovf = (src_v >= s) & (src_v < ((1 << length) + s - to_add))
    src = _reg_set(xp, idx, start, length, src_v)
    src = xp.where(ovf, src ^ (1 << overflow_index), src)
    return src


def incdecsc_src(xp, idx, to_add, start, length, carry_index, overflow_index=None):
    """INCDECSC: carry-extended add, optional signed-overflow flag flip
    (reference kernels incdecsc1/incdecsc2, qheader_alu.cl)."""
    src = incdecc_src(xp, idx, to_add, start, length, carry_index)
    if overflow_index is None:
        return src
    to_add_l = to_add & ((1 << length) - 1)
    src_v = _reg_get(xp, src, start, length)
    s = 1 << (length - 1)
    if to_add_l == 0:
        return src
    if to_add_l < s:
        ovf = (src_v >= (s - to_add_l)) & (src_v < s)
    else:
        ovf = (src_v >= s) & (src_v < ((1 << length) + s - to_add_l))
    return xp.where(ovf, src ^ (1 << overflow_index), src)


def rol_src(xp, idx, shift, start, length):
    """ROL: circular left shift of register bits (reference kernel rol,
    qengine.cl:1085).  The left shift may wrap an int32 lane; only the
    low `length` bits are kept, and those a wrap leaves intact."""
    shift %= length
    v = _reg_get(xp, idx, start, length)
    src_v = ((v >> shift) | (v << (length - shift))) & ((1 << length) - 1)
    return _reg_set(xp, idx, start, length, src_v)


def hash_src(xp, idx, start, length, inverse_table):
    """Hash: reg -> table[reg] bijection (reference kernel hash,
    qheader_alu.cl); `inverse_table` is an xp int array on the index
    vector's device with inverse_table[table[v]] = v."""
    v = _reg_get(xp, idx, start, length)
    src_v = inverse_table[v]
    return _reg_set(xp, idx, start, length, src_v)


def mul_pair(xp, n_qubits, to_mul, in_out_start, carry_start, length):
    """MUL: scatter map for in-place multiply with L-bit carry register
    (reference kernel mul, qheader_alu.cl:~260). Returns (src_idx, dst_idx)
    over the carry==0 subspace: dst[(x*toMul) split across inOut+carry]
    = src[x, carry=0]. Amplitudes outside the subspace are dropped, per
    reference contract (carry must be |0>)."""
    low_mask = (1 << length) - 1
    # enumerate the carry==0 subspace: free bits = all except carry register
    from ..utils.bits import deposit_indices

    skip = list(range(carry_start, carry_start + length))
    base = deposit_indices(n_qubits, skip)
    base = xp.asarray(base)
    x = (base >> in_out_start) & low_mask
    prod = x * to_mul
    dst = _reg_set(xp, base, in_out_start, length, prod & low_mask)
    dst = _reg_set(xp, dst, carry_start, length, (prod >> length) & low_mask)
    return base, dst


def mulmodnout_pair(xp, n_qubits, to_mul, mod_n, in_start, out_start, length, out_length):
    """MULModNOut: dst[x, out=(x*toMul) mod N] = src[x, out=0]
    (reference kernel mulmodnout, qheader_alu.cl)."""
    from ..utils.bits import deposit_indices

    skip = list(range(out_start, out_start + out_length))
    base = deposit_indices(n_qubits, skip)
    base = xp.asarray(base)
    x = (base >> in_start) & ((1 << length) - 1)
    res = (x * to_mul) % mod_n
    dst = _reg_set(xp, base, out_start, out_length, res)
    return base, dst


def powmodnout_pair(xp, n_qubits, base_int, mod_n, in_start, out_start, length, out_length):
    """POWModNOut: dst[x, out=base^x mod N] = src[x, out=0]
    (reference kernel powmodnout, qheader_alu.cl)."""
    import numpy as np

    from ..utils.bits import deposit_indices

    skip = list(range(out_start, out_start + out_length))
    base_idx = deposit_indices(n_qubits, skip)
    x = (base_idx >> in_start) & ((1 << length) - 1)
    # host-side modular-exponent table over input register values
    table = np.array([pow(base_int, v, mod_n) for v in range(1 << length)], dtype=np.int64)
    res = table[np.asarray(x, dtype=np.int64)]
    dst = _reg_set(np, base_idx, out_start, out_length, res)
    return xp.asarray(base_idx), xp.asarray(dst)


def indexed_lda_src(xp, idx, index_start, index_length, value_start, value_length, table):
    """IndexedLDA: value reg ^= table[index reg] (reference kernel
    indexedLda, qheader_alu.cl:~600). XOR form makes it a bijection."""
    key = _reg_get(xp, idx, index_start, index_length)
    loaded = table[key]
    return idx ^ (loaded << value_start)


def indexed_adc_src(xp, idx, index_start, index_length, value_start, value_length,
                    carry_index, table, sign: int = 1):
    """IndexedADC/SBC: value reg +/-= table[index reg] + carry, with carry
    out (reference kernels indexedAdc/indexedSbc)."""
    key = _reg_get(xp, idx, index_start, index_length)
    delta = table[key]
    v = _reg_get(xp, idx, value_start, value_length)
    c = (idx >> carry_index) & 1
    ext = v | (c << value_length)
    src_ext = (ext - sign * delta) & ((1 << (value_length + 1)) - 1)
    src = _reg_set(xp, idx, value_start, value_length, src_ext & ((1 << value_length) - 1))
    src_c = src_ext >> value_length
    return (src & ~(1 << carry_index)) | (src_c << carry_index)


def phase_flip_less_factor(xp, idx, greater_perm, start, length, flag_index=None):
    """(C)PhaseFlipIfLess real factor: -1 where reg < greater_perm (and
    flag set), else +1 (reference kernels cphaseflipifless/
    phaseflipifless, qheader_alu.cl:780-810)."""
    v = _reg_get(xp, idx, start, length)
    # a register value is below 2^length: a larger bound flips every
    # value, and clamping it keeps the comparison in the lane's range
    cond = v < min(greater_perm, 1 << length)
    if flag_index is not None:
        cond = cond & (((idx >> flag_index) & 1) == 1)
    return xp.where(cond, -1.0, 1.0)


# ---------------------------------------------------------------------------
# BCD arithmetic (reference kernels incbcd/incdecbcdc,
# src/common/qheader_bcd.cl:1-143): the register is packed 4-bit decimal
# digits; to_add is a DECIMAL integer whose digits add nibble-wise with
# decimal carries.  Non-BCD inputs (any nibble > 9) pass through
# unchanged.  Gather form: dst digits v (valid) receive src
# bcd_sub(v, to_add); the borrow out of the top digit reproduces the
# forward kernel's carry-out.
# ---------------------------------------------------------------------------


def bcd_digits(to_add: int, nibbles: int):
    """Decimal digits of to_add, little-endian, host-side."""
    ds = []
    ta = int(to_add)
    for _ in range(nibbles):
        ds.append(ta % 10)
        ta //= 10
    return ds


def _bcd_sub(xp, v, digits, nibbles: int):
    """(src_value, borrow_out, valid): decimal digit-wise v - digits
    (mod 10^nibbles), vectorized with a static digit unroll over the
    host ints `digits`."""
    out = xp.zeros_like(v)
    borrow = xp.zeros_like(v)
    valid = xp.ones_like(v, dtype=bool)
    for j in range(nibbles):
        d = (v >> (4 * j)) & 15
        valid = valid & (d <= 9)
        s = d - digits[j] - borrow
        neg = s < 0
        s = xp.where(neg, s + 10, s)
        out = out | (s << (4 * j))
        borrow = xp.where(neg, xp.ones_like(borrow), xp.zeros_like(borrow))
    return out, borrow, valid


def incbcd_src(xp, idx, to_add, start, length):
    """INCBCD (reference kernel incbcd, qheader_bcd.cl:1-67)."""
    nibbles = length // 4
    v = _reg_get(xp, idx, start, length)
    src_v, _, valid = _bcd_sub(xp, v, bcd_digits(to_add, nibbles), nibbles)
    src = _reg_set(xp, idx, start, length, src_v)
    return xp.where(valid, src, idx)


def incdecbcdc_src(xp, idx, to_add, start, length, carry_index):
    """INCDECBCDC (reference kernel incdecbcdc, qheader_bcd.cl:67-143):
    carry-out = carry-in XOR decimal-overflow, so the inverse XORs the
    top-digit borrow back into the carry bit."""
    nibbles = length // 4
    v = _reg_get(xp, idx, start, length)
    src_v, borrow, valid = _bcd_sub(xp, v, bcd_digits(to_add, nibbles), nibbles)
    src = _reg_set(xp, idx, start, length, src_v)
    src = src ^ (borrow << carry_index)
    return xp.where(valid, src, idx)


# ---------------------------------------------------------------------------
# split-index forms: (page, local) index pairs, exact past 31 qubits
#
# The global index i = (pid << L) | lidx never materializes: all
# register and bit algebra runs on the two halves (reference ALU kernels
# are width-generic the same way, qheader_alu.cl:13-810).  Register and
# field lengths stay <= 31 bits (the register VALUE fits an int32 lane
# even where the ket index cannot); the carry- and overflow-extended ops
# need one more lane bit, so they cap at length <= 30.
# ---------------------------------------------------------------------------


def _lane(v, lidx):
    """`v` as a tensor that broadcasts against `lidx` (a value read from
    a Python page id becomes a 0-d int32 tensor on lidx's device)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(int(v), dtype=lidx.dtype, device=lidx.device)


def split_ctrl_match(xp, pid, lidx, L, controls, perm):
    cm_lo = cv_lo = cm_hi = cv_hi = 0
    for j, c in enumerate(controls):
        want = (perm >> j) & 1
        if c < L:
            cm_lo |= 1 << c
            cv_lo |= want << c
        else:
            cm_hi |= 1 << (c - L)
            cv_hi |= want << (c - L)
    return ((lidx & cm_lo) == cv_lo) & (_lane(pid & cm_hi, lidx) == cv_hi)


def split_reg_get(xp, pid, lidx, L, start, length):
    if length > 31:
        raise ValueError("register length > 31 bits exceeds int32 lanes")
    if start >= L:
        return _lane((pid >> (start - L)) & ((1 << length) - 1), lidx)
    lo_len = min(length, L - start)
    v = (lidx >> start) & ((1 << lo_len) - 1)
    if lo_len < length:
        v = v | ((pid & ((1 << (length - lo_len)) - 1)) << lo_len)
    return v


def split_reg_set(xp, pid, lidx, L, start, length, value):
    if start >= L:
        m = ((1 << length) - 1) << (start - L)
        return (pid & ~m) | ((value << (start - L)) & m), lidx
    lo_len = min(length, L - start)
    m_lo = ((1 << lo_len) - 1) << start
    nl = (lidx & ~m_lo) | ((value & ((1 << lo_len) - 1)) << start)
    if lo_len < length:
        m_hi = (1 << (length - lo_len)) - 1
        return (pid & ~m_hi) | ((value >> lo_len) & m_hi), nl
    return pid, nl


def split_bit_get(xp, pid, lidx, L, b):
    if b < L:
        return (lidx >> b) & 1
    return _lane((pid >> (b - L)) & 1, lidx)


def split_bit_set(xp, pid, lidx, L, b, bit):
    if b < L:
        return pid, (lidx & ~(1 << b)) | (bit << b)
    return (pid & ~(1 << (b - L))) | (bit << (b - L)), lidx


def xor_split(xp, pid, lidx, L, mask_lo, mask_hi):
    return pid ^ mask_hi, lidx ^ mask_lo


def inc_src_split(xp, pid, lidx, L, to_add, start, length, controls=(), perm=0):
    v = split_reg_get(xp, pid, lidx, L, start, length)
    src_v = (v - to_add) & ((1 << length) - 1)
    sp, sl = split_reg_set(xp, pid, lidx, L, start, length, src_v)
    if controls:
        ok = split_ctrl_match(xp, pid, lidx, L, controls, perm)
        sp = torch.where(ok, _lane(sp, lidx), _lane(pid, lidx))
        sl = torch.where(ok, sl, lidx)
    return sp, sl


def incdecc_src_split(xp, pid, lidx, L, to_add, start, length, carry_index):
    if length > 30:
        raise ValueError("carry-extended register length > 30 exceeds int32 lanes")
    v = split_reg_get(xp, pid, lidx, L, start, length)
    c = split_bit_get(xp, pid, lidx, L, carry_index)
    ext = v | (c << length)
    src_ext = (ext - to_add) & ((1 << (length + 1)) - 1)
    sp, sl = split_reg_set(xp, pid, lidx, L, start, length,
                           src_ext & ((1 << length) - 1))
    return split_bit_set(xp, sp, sl, L, carry_index, src_ext >> length)


def _signed_ovf(xp, src_v, to_add: int, length):
    """Signed-overflow window: below the sign bit s it is [s - a, s); at
    or above it [s, 2^len + s - a).  Every bound fits int32 for
    length <= 30."""
    s = 1 << (length - 1)
    lo, hi = (s - to_add, s) if to_add < s else (s, (1 << length) + s - to_add)
    return (src_v >= lo) & (src_v < hi) & (to_add != 0)


def incs_src_split(xp, pid, lidx, L, to_add, start, length, overflow_index):
    if length > 30:
        raise ValueError("overflow-extended register length > 30 exceeds int32 lanes")
    v = split_reg_get(xp, pid, lidx, L, start, length)
    src_v = (v - to_add) & ((1 << length) - 1)
    ovf = _signed_ovf(xp, src_v, to_add, length)
    sp, sl = split_reg_set(xp, pid, lidx, L, start, length, src_v)
    ob = split_bit_get(xp, sp, sl, L, overflow_index)
    fp, fl = split_bit_set(xp, sp, sl, L, overflow_index, ob ^ 1)
    return (torch.where(ovf, _lane(fp, lidx), _lane(sp, lidx)),
            torch.where(ovf, fl, sl))


def rol_src_split(xp, pid, lidx, L, shift, start, length):
    shift %= length
    v = split_reg_get(xp, pid, lidx, L, start, length)
    src_v = ((v >> shift) | (v << (length - shift))) & ((1 << length) - 1)
    return split_reg_set(xp, pid, lidx, L, start, length, src_v)


def hash_src_split(xp, pid, lidx, L, inverse_table, start, length):
    v = split_reg_get(xp, pid, lidx, L, start, length)
    return split_reg_set(xp, pid, lidx, L, start, length, inverse_table[v])


def modnout_gather_split(xp, pid, lidx, L, res_table, in_start, length,
                         out_start, out_length, inverse=False):
    """Gather form of (I)MULModNOut / POWModNOut: `res_table[x]` is the
    modular image of each input-register value (built with exact Python
    ints on the host).  Forward: dst[x, out=res] = src[x, out=0] and
    everything else zeroes; inverse undoes it."""
    x = split_reg_get(xp, pid, lidx, L, in_start, length)
    res = res_table[x]
    out = split_reg_get(xp, pid, lidx, L, out_start, out_length)
    if inverse:
        keep = out == 0
        sp, sl = split_reg_set(xp, pid, lidx, L, out_start, out_length, res)
    else:
        keep = out == res
        sp, sl = split_reg_set(xp, pid, lidx, L, out_start, out_length,
                               torch.zeros_like(out))
    return sp, sl, keep


def indexed_lda_src_split(xp, pid, lidx, L, table, index_start, index_length,
                          value_start, value_length):
    key = split_reg_get(xp, pid, lidx, L, index_start, index_length)
    v = split_reg_get(xp, pid, lidx, L, value_start, value_length)
    return split_reg_set(xp, pid, lidx, L, value_start, value_length,
                         v ^ table[key])


def indexed_adc_src_split(xp, pid, lidx, L, table, index_start, index_length,
                          value_start, value_length, carry_index, sign=1):
    if value_length > 30:
        raise ValueError("carry-extended register length > 30 exceeds int32 lanes")
    key = split_reg_get(xp, pid, lidx, L, index_start, index_length)
    delta = table[key]
    v = split_reg_get(xp, pid, lidx, L, value_start, value_length)
    c = split_bit_get(xp, pid, lidx, L, carry_index)
    ext = v | (c << value_length)
    src_ext = (ext - sign * delta) & ((1 << (value_length + 1)) - 1)
    sp, sl = split_reg_set(xp, pid, lidx, L, value_start, value_length,
                           src_ext & ((1 << value_length) - 1))
    return split_bit_set(xp, sp, sl, L, carry_index, src_ext >> value_length)


def mul_tables(to_mul: int, length: int):
    """Host-built int32 tables for width-generic MUL/DIV (reference
    kernels mul/div, qheader_alu.cl:~260). For each L-bit input x the
    split product halves lo[x] = (x*toMul) & (2^L-1) and
    hi[x] = ((x*toMul) >> L) & (2^L-1); plus the modular inverse table
    inv[(x*odd) mod 2^L] = x where odd = toMul >> k, k = v2(toMul) —
    x -> (x*odd) mod 2^L is a bijection because odd is invertible mod a
    power of two. Register values stay < 2^31, so every lane is int32."""
    if to_mul <= 0:
        raise ValueError("MUL/DIV multiplier must be positive")
    cap = int(os.environ.get("QRACK_WIDE_MUL_TABLE_QB", "24"))
    if length > min(cap, 31):
        # three 2^L int32 tables: 24 bits is already 200 MB of host RAM,
        # and each extra bit doubles it
        raise ValueError(
            f"wide MUL/DIV register length {length} exceeds the host "
            f"product-table cap ({min(cap, 31)} bits, "
            "QRACK_WIDE_MUL_TABLE_QB to raise; 3 int32 tables of 2^L "
            "entries each)")
    k = (to_mul & -to_mul).bit_length() - 1
    if k > length:
        raise ValueError(
            "v2(to_mul) exceeds the register length: the carry-truncated "
            "product map is not a bijection")
    size = 1 << length
    mask = size - 1
    odd = to_mul >> k
    # products decomposed into masked halves: every intermediate fits
    # int64 even at length = 31
    x = np.arange(size, dtype=np.int64)
    tm_l = to_mul & mask
    tm_h = (to_mul >> length) & mask
    p_l = x * tm_l
    lo = (p_l & mask).astype(np.int32)
    hi = (((p_l >> length) + x * tm_h) & mask).astype(np.int32)
    inv = np.empty(size, dtype=np.int32)
    inv[(x * (odd & mask)) & mask] = x
    return lo, hi, inv, k


def mul_consts(to_mul: int, length: int):
    """Host constants of the table-free wide MUL/DIV: the 2-adic
    valuation k and the operand vector [t_lo, t_hi, inv_odd] (the
    multiplier's halves mod 2^length and the odd part's inverse mod
    2^length), each below 2^31."""
    if to_mul <= 0:
        raise ValueError("MUL/DIV multiplier must be positive")
    k = (to_mul & -to_mul).bit_length() - 1
    if k > length:
        raise ValueError(
            "v2(to_mul) exceeds the register length: the carry-truncated "
            "product map is not a bijection")
    mask = (1 << length) - 1
    inv_odd = pow((to_mul >> k) & mask, -1, 1 << length)
    consts = np.asarray([to_mul & mask, (to_mul >> length) & mask, inv_odd],
                        dtype=np.int64)
    return k, consts


_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


def _u32(v):
    """A lane or scalar as int64 holding its uint32 bits."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _M32
    return int(v) & _M32


def _mul64_limbs(xp, x, t):
    """Exact 16-bit limbs (l0, l1, l2, l3) of x * t for lanes x < 2^31 and
    a scalar t < 2^31, each as int64 holding a value below 2^16: the
    JAX package's uint32 limb arithmetic in int64 lanes (every partial
    product of two 16-bit limbs and every carry sum fits; the masks keep
    the uint32 results bit for bit)."""
    xu, tu = _u32(x), _u32(t)
    x0, x1 = xu & _M16, xu >> 16
    t0, t1 = tu & _M16, tu >> 16
    m0 = x0 * t0
    m1a = x0 * t1
    m1b = x1 * t0
    m2 = x1 * t1
    l0 = m0 & _M16
    s1 = (m0 >> 16) + (m1a & _M16) + (m1b & _M16)
    l1 = s1 & _M16
    s2 = (s1 >> 16) + (m1a >> 16) + (m1b >> 16) + (m2 & _M16)
    l2 = s2 & _M16
    l3 = ((s2 >> 16) + (m2 >> 16)) & _M16
    return l0, l1, l2, l3


def _product_split(xp, x, t_lo, t_hi, length: int):
    """(lo, hi) = ((x*t) & mask, ((x*t) >> length) & mask) for the
    multiplier t = t_lo + t_hi*2^length, as int64 lanes holding the
    uint32 results of the JAX package (the table-free equivalent of the
    `mul_tables` lookups, reference mul/div, qheader_alu.cl:~260)."""
    mask = (1 << length) - 1
    l0, l1, l2, l3 = _mul64_limbs(xp, x, t_lo)
    w0 = l0 | (l1 << 16)            # product bits 0..31
    w1 = l2 | (l3 << 16)            # product bits 32..63
    lo = w0 & mask
    # bits [length, length + 31] of the product, masked to `length` bits,
    # plus the t_hi part of the carry half (mod 2^length)
    hi = ((w0 >> length) | ((w1 << (32 - length)) & _M32)) & mask
    hi = (hi + _u32(x) * _u32(t_hi)) & mask
    return lo, hi


def mul_src_split_tf(xp, pid, lidx, L, consts, k,
                     in_out_start, carry_start, length):
    """Table-free gather form of wide MUL: the map of `mul_src_split`,
    with the candidate source x = u * odd^-1 mod 2^L and its product
    halves computed per lane instead of looked up (no 2^L host tables).
    `consts` is the [t_lo, t_hi, inv_odd] operand vector."""
    t_lo, t_hi, inv_odd = consts[0], consts[1], consts[2]
    o = split_reg_get(xp, pid, lidx, L, in_out_start, length)
    c = split_reg_get(xp, pid, lidx, L, carry_start, length)
    if k:
        u = ((c & ((1 << k) - 1)) << (length - k)) | (o >> k)
    else:
        u = o
    mask = (1 << length) - 1
    x = (_u32(u) * _u32(inv_odd)) & mask
    lo, hi = _product_split(xp, x, t_lo, t_hi, length)
    keep = (lo == _u32(o)) & (hi == _u32(c))
    xi = x.to(o.dtype)
    sp, sl = split_reg_set(xp, pid, lidx, L, in_out_start, length, xi)
    sp, sl = split_reg_set(xp, sp, sl, L, carry_start, length,
                           torch.zeros_like(xi))
    return sp, sl, keep


def div_src_split_tf(xp, pid, lidx, L, consts, k,
                     in_out_start, carry_start, length):
    """Table-free gather form of wide DIV (the exact inverse of MUL);
    `k` is unused but keeps one signature for both directions."""
    t_lo, t_hi = consts[0], consts[1]
    x = split_reg_get(xp, pid, lidx, L, in_out_start, length)
    c = split_reg_get(xp, pid, lidx, L, carry_start, length)
    keep = c == 0
    lo, hi = _product_split(xp, x, t_lo, t_hi, length)
    sp, sl = split_reg_set(xp, pid, lidx, L, in_out_start, length,
                           lo.to(x.dtype))
    sp, sl = split_reg_set(xp, sp, sl, L, carry_start, length,
                           hi.to(x.dtype))
    return sp, sl, keep


def mul_src_split(xp, pid, lidx, L, lo_tab, hi_tab, inv_tab, k,
                  in_out_start, carry_start, length):
    """Gather form of MUL past int32 widths: destination (inOut=o,
    carry=c) receives src (inOut=x, carry=0) when x*toMul == (c<<L)|o,
    else zero. The unique candidate x comes from the odd-part inverse:
    (product >> k) mod 2^L == (x*odd) mod 2^L, whose low L bits are
    recoverable from (o, c) without ever forming the 2L-bit product."""
    o = split_reg_get(xp, pid, lidx, L, in_out_start, length)
    c = split_reg_get(xp, pid, lidx, L, carry_start, length)
    if k:
        u = ((c & ((1 << k) - 1)) << (length - k)) | (o >> k)
    else:
        u = o
    x = inv_tab[u]
    keep = (lo_tab[x] == o) & (hi_tab[x] == c)
    sp, sl = split_reg_set(xp, pid, lidx, L, in_out_start, length, x)
    sp, sl = split_reg_set(xp, sp, sl, L, carry_start, length,
                           torch.zeros_like(x))
    return sp, sl, keep


def div_src_split(xp, pid, lidx, L, lo_tab, hi_tab, inv_tab, k,
                  in_out_start, carry_start, length):
    """Gather form of DIV (the exact inverse of MUL): destination
    (inOut=x, carry=0) receives src (inOut=lo[x], carry=hi[x]); any
    destination with carry != 0 zeroes (the MUL image never lands
    there). `inv_tab`/`k` are unused but keep one table signature for
    both directions."""
    x = split_reg_get(xp, pid, lidx, L, in_out_start, length)
    c = split_reg_get(xp, pid, lidx, L, carry_start, length)
    keep = c == 0
    sp, sl = split_reg_set(xp, pid, lidx, L, in_out_start, length, lo_tab[x])
    sp, sl = split_reg_set(xp, sp, sl, L, carry_start, length, hi_tab[x])
    return sp, sl, keep


def split_parity(xp, pid, lidx, L, mask):
    """Parity of (global_index & mask) from the two halves: parity is
    XOR-linear, so fold (lidx & mask_lo) ^ (pid & mask_hi)."""
    w = (lidx & (mask & ((1 << L) - 1))) ^ (pid & (mask >> L))
    width = w.dtype.itemsize * 8
    for s in (32, 16, 8, 4, 2, 1):
        if s < width:
            w = w ^ (w >> s)
    return w & 1


def phase_flip_less_factor_split(xp, pid, lidx, L, greater_perm, start,
                                 length, flag_index=None):
    """Split-index (C)PhaseFlipIfLess factor (reference kernels
    cphaseflipifless/phaseflipifless, qheader_alu.cl:780-810); the bound
    is clamped to 2^length as in :func:`phase_flip_less_factor`."""
    v = split_reg_get(xp, pid, lidx, L, start, length)
    cond = v < min(greater_perm, 1 << length)
    if flag_index is not None:
        cond = cond & (split_bit_get(xp, pid, lidx, L, flag_index) == 1)
    return xp.where(cond, -1.0, 1.0)


def incdecsc_src_split(xp, pid, lidx, L, to_add, start, length, carry_index,
                       overflow_index=None):
    sp, sl = incdecc_src_split(xp, pid, lidx, L, to_add, start, length,
                               carry_index)
    if overflow_index is None:
        return sp, sl
    to_add_l = to_add & ((1 << length) - 1)
    src_v = split_reg_get(xp, sp, sl, L, start, length)
    ovf = _signed_ovf(xp, src_v, to_add_l, length)
    ob = split_bit_get(xp, sp, sl, L, overflow_index)
    fp, fl = split_bit_set(xp, sp, sl, L, overflow_index, ob ^ 1)
    return (torch.where(ovf, _lane(fp, lidx), _lane(sp, lidx)),
            torch.where(ovf, fl, sl))


def incbcd_src_split(xp, pid, lidx, L, digits, start, length):
    nibbles = length // 4
    v = split_reg_get(xp, pid, lidx, L, start, length)
    src_v, _, valid = _bcd_sub(torch, v, digits, nibbles)
    sp, sl = split_reg_set(xp, pid, lidx, L, start, length, src_v)
    return (torch.where(valid, _lane(sp, lidx), _lane(pid, lidx)),
            torch.where(valid, sl, lidx))


def incdecbcdc_src_split(xp, pid, lidx, L, digits, start, length,
                         carry_index):
    nibbles = length // 4
    v = split_reg_get(xp, pid, lidx, L, start, length)
    src_v, borrow, valid = _bcd_sub(torch, v, digits, nibbles)
    sp, sl = split_reg_set(xp, pid, lidx, L, start, length, src_v)
    if carry_index < L:
        sl = sl ^ (borrow << carry_index)
    else:
        sp = sp ^ (borrow << (carry_index - L))
    return (torch.where(valid, _lane(sp, lidx), _lane(pid, lidx)),
            torch.where(valid, sl, lidx))
