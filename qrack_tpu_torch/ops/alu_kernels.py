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

The split-index (page, local) forms of the JAX package serve only its
pager and are not here.
"""

from __future__ import annotations


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
