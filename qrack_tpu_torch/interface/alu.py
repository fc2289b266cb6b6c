"""Quantum arithmetic-logic default syntheses (the QAlu surface).

Mirrors the reference's ALU API and fallback constructions (reference:
include/qalu.hpp:22-249; src/qalu.cpp — carry/borrow wrappers;
src/qinterface/arithmetic.cpp:20-420 — CNOT/CCNOT-ladder INC/CINC,
shift-add MULModNOut, full-adder chains). Dense engines override the
hot ops with vectorized index-permutation kernels
(ops/alu_kernels.py through engines/qengine.py — the analogue of the
reference's qheader_alu.cl kernel set).

Register convention matches the reference: `start` is the LSB of a
`length`-bit little-endian register; signed ops use two's complement
with the sign at bit `length-1`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .. import matrices as mat


def _range_to_cubes(lo: int, hi: int, length: int) -> List[Tuple[int, int]]:
    """Decompose integer range [lo, hi) over `length`-bit values into
    aligned blocks (bit_count k, block_index m) with block = [m*2^k, (m+1)*2^k).

    Bounds are clamped to the representable values here — an
    out-of-range bound (e.g. PhaseFlipIfLess with greater_perm >=
    2^length) must never emit impossible-value cubes, which mis-fire as
    extra flips (fuzz-soak regression, round 5)."""
    lo = max(lo, 0)
    hi = min(hi, 1 << length)
    cubes: List[Tuple[int, int]] = []
    k = 0
    while lo < hi:
        # close lowest-aligned blocks from the left
        while k < length and (lo & ((1 << (k + 1)) - 1)) == 0 and lo + (1 << (k + 1)) <= hi:
            k += 1
        while (lo & ((1 << k) - 1)) != 0 or lo + (1 << k) > hi:
            k -= 1
        cubes.append((k, lo >> k))
        lo += 1 << k
    return cubes


class AluMixin:
    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _flip_if_in_range(self, lo: int, hi: int, start: int, length: int, target: int,
                          extra_controls: Sequence[int] = (), extra_perm: int = 0) -> None:
        """X `target` for every basis state whose [start,length) register
        value lies in [lo, hi) — used for carry/overflow flags.
        Bounds are clamped by _range_to_cubes."""
        if length == 0:
            # a zero-bit register has value 0: unconditional flip iff
            # 0 is in range (matches the engine kernels' v-in-range test)
            if lo <= 0 < hi:
                self.MCMtrxPerm(tuple(extra_controls), mat.X2, target,
                                extra_perm)
            return
        if lo >= hi or hi <= 0 or lo >= (1 << length):
            return
        for (k, m) in _range_to_cubes(lo, hi, length):
            ctrls = list(extra_controls)
            perm = extra_perm
            pos = len(ctrls)
            for b in range(k, length):
                ctrls.append(start + b)
                if (m >> (b - k)) & 1:
                    perm |= 1 << pos
                pos += 1
            self.MCMtrxPerm(tuple(ctrls), mat.X2, target, perm)

    def _phase_flip_if_in_range(self, lo: int, hi: int, start: int, length: int,
                                extra_controls: Sequence[int] = (), extra_perm: int = 0) -> None:
        """-1 phase on every basis state whose register value is in
        [lo, hi).  Bounds are clamped by _range_to_cubes."""
        minus_i2 = np.array([[-1, 0], [0, -1]], dtype=np.complex128)
        if length == 0:
            # zero-bit register: value 0 — global flip iff 0 in range
            # (-I on any qubit outside the controls is a global -1)
            if lo <= 0 < hi:
                ctrls = tuple(extra_controls)
                t = 0
                while t in ctrls:
                    t += 1
                if t < self.qubit_count:
                    self.MCMtrxPerm(ctrls, minus_i2, t, extra_perm)
                elif ctrls:
                    # every qubit is a control: demote the last control
                    # to the target with a one-sided phase matrix — the
                    # -1 fires on exactly the same basis states (a bare
                    # scan here used to pick t == qubit_count and throw)
                    pos = len(ctrls) - 1
                    want1 = (extra_perm >> pos) & 1
                    ph = (mat.phase_mtrx(1, -1) if want1
                          else mat.phase_mtrx(-1, 1))
                    self.MCMtrxPerm(ctrls[:pos], ph, ctrls[pos],
                                    extra_perm & ((1 << pos) - 1))
                # zero-qubit interface: nothing to phase, silently done
            return
        if lo >= hi or hi <= 0 or lo >= (1 << length):
            return
        for (k, m) in _range_to_cubes(lo, hi, length):
            ctrls = list(extra_controls)
            perm = extra_perm
            pos = len(ctrls)
            if k > 0:
                # at least one free register bit: controlled -I on it
                for b in range(k, length):
                    ctrls.append(start + b)
                    if (m >> (b - k)) & 1:
                        perm |= 1 << pos
                    pos += 1
                self.MCMtrxPerm(tuple(ctrls), minus_i2, start, perm)
            else:
                # fully specified value: fold lowest bit into the phase payload
                for b in range(1, length):
                    ctrls.append(start + b)
                    if (m >> b) & 1:
                        perm |= 1 << pos
                    pos += 1
                ph = mat.phase_mtrx(-1, 1) if (m & 1) == 0 else mat.phase_mtrx(1, -1)
                self.MCMtrxPerm(tuple(ctrls), ph, start, perm)

    # ------------------------------------------------------------------
    # add/subtract (reference: src/qinterface/arithmetic.cpp:20-125)
    # ------------------------------------------------------------------

    def INC(self, to_add: int, start: int, length: int) -> None:
        if not length:
            return
        to_add &= (1 << length) - 1
        if not to_add:
            return
        # Increment by each set power of two: MCX carry cascade, high to low.
        for k in range(length):
            if not (to_add >> k) & 1:
                continue
            for i in range(length - 1, k, -1):
                ctrls = tuple(start + b for b in range(k, i))
                self.MCMtrxPerm(ctrls, mat.X2, start + i, (1 << len(ctrls)) - 1)
            self.X(start + k)

    def DEC(self, to_sub: int, start: int, length: int) -> None:
        self.INC((1 << length) - (to_sub & ((1 << length) - 1)), start, length)

    def CINC(self, to_add: int, start: int, length: int, controls: Sequence[int]) -> None:
        controls = tuple(controls)
        if not controls:
            return self.INC(to_add, start, length)
        if not length:
            return
        to_add &= (1 << length) - 1
        cperm = (1 << len(controls)) - 1
        for k in range(length):
            if not (to_add >> k) & 1:
                continue
            for i in range(length - 1, k, -1):
                reg_ctrls = tuple(start + b for b in range(k, i))
                ctrls = reg_ctrls + controls
                perm = ((1 << len(reg_ctrls)) - 1) | (cperm << len(reg_ctrls))
                self.MCMtrxPerm(ctrls, mat.X2, start + i, perm)
            self.MCMtrxPerm(controls, mat.X2, start + k, cperm)

    def CDEC(self, to_sub: int, start: int, length: int, controls: Sequence[int]) -> None:
        self.CINC((1 << length) - (to_sub & ((1 << length) - 1)), start, length, controls)

    def INCDECC(self, to_add: int, start: int, length: int, carry_index: int) -> None:
        """Add over the (length+1)-bit register whose top bit is the carry
        qubit (reference: src/qinterface/arithmetic.cpp:53)."""
        self.CINCDECC(to_add, start, length, carry_index, ())

    def CINCDECC(self, to_add: int, start: int, length: int, carry_index: int,
                 controls: Sequence[int]) -> None:
        """Controlled carry-extended add (building block for the modular
        arithmetic syntheses below)."""
        if not length:
            return
        controls = tuple(controls)
        cperm = (1 << len(controls)) - 1
        to_add &= (1 << (length + 1)) - 1
        ext = length + 1

        def bit_q(i: int) -> int:
            return carry_index if i == length else start + i

        for k in range(ext):
            if not (to_add >> k) & 1:
                continue
            for i in range(ext - 1, k, -1):
                reg = tuple(bit_q(b) for b in range(k, i))
                ctrls = reg + controls
                perm = ((1 << len(reg)) - 1) | (cperm << len(reg))
                self.MCMtrxPerm(ctrls, mat.X2, bit_q(i), perm)
            self.MCMtrxPerm(controls, mat.X2, bit_q(k), cperm)

    def INCC(self, to_add: int, start: int, length: int, carry_index: int) -> None:
        """Carry-in + carry-out add (reference: src/qalu.cpp INCC). The
        +1 from a consumed carry-in is NOT masked to `length` bits — the
        2^length term must reach the carry qubit via INCDECC."""
        if not length:
            return
        if self.M(carry_index):
            self.X(carry_index)
            self.INCDECC(to_add + 1, start, length, carry_index)
        else:
            self.INCDECC(to_add, start, length, carry_index)

    def DECC(self, to_sub: int, start: int, length: int, carry_index: int) -> None:
        has_carry = self.M(carry_index)
        # unmasked: to_sub == 0 gives inv == 2^length, which must flip carry
        inv = (1 << length) - (to_sub & ((1 << length) - 1))
        if has_carry:
            self.X(carry_index)
        else:
            inv -= 1
        self.INCDECC(inv, start, length, carry_index)

    # -- BCD derived ops over the INCBCD/INCDECBCDC primitives
    #    (reference: src/qalu.cpp:155-189 DECBCD/INCBCDC/DECBCDC) --

    def DECBCD(self, to_sub: int, start: int, length: int) -> None:
        max_val = 10 ** (length // 4) if length else 1
        self.INCBCD(max_val - (to_sub % max_val), start, length)

    def INCBCDC(self, to_add: int, start: int, length: int, carry_index: int) -> None:
        if self.M(carry_index):
            self.X(carry_index)
            to_add = to_add + 1
        self.INCDECBCDC(to_add, start, length, carry_index)

    def DECBCDC(self, to_sub: int, start: int, length: int, carry_index: int) -> None:
        if self.M(carry_index):
            self.X(carry_index)
        else:
            to_sub = to_sub + 1
        max_val = 10 ** (length // 4) if length else 1
        self.INCDECBCDC(max_val - (to_sub % max_val), start, length, carry_index)

    # -- signed variants (reference: src/qalu.cpp INCS/INCSC/DECS/DECSC) --

    def _signed_overflow_range(self, to_add: int, length: int) -> Tuple[int, int]:
        s = 1 << (length - 1)
        c = to_add & ((1 << length) - 1)
        if c == 0:
            return (0, 0)
        if c < s:
            return (s - c, s)
        return (s, (1 << length) + s - c)

    def INCS(self, to_add: int, start: int, length: int, overflow_index: int) -> None:
        lo, hi = self._signed_overflow_range(to_add, length)
        self._flip_if_in_range(lo, hi, start, length, overflow_index)
        self.INC(to_add, start, length)

    def DECS(self, to_sub: int, start: int, length: int, overflow_index: int) -> None:
        inv = ((1 << length) - to_sub) & ((1 << length) - 1)
        self.INCS(inv, start, length, overflow_index)

    def INCDECSC(self, to_add: int, start: int, length: int, *flags) -> None:
        """(length+1)-bit add with carry top bit; optional signed-overflow
        flag qubit (reference kernels incdecsc1/incdecsc2,
        src/common/qheader_alu.cl)."""
        if len(flags) == 2:
            overflow_index, carry_index = flags
            lo, hi = self._signed_overflow_range(to_add & ((1 << length) - 1), length)
            self._flip_if_in_range(lo, hi, start, length, overflow_index)
        else:
            (carry_index,) = flags
        self.INCDECC(to_add, start, length, carry_index)

    def INCSC(self, to_add: int, start: int, length: int, *flags) -> None:
        if not length:
            return
        carry_index = flags[-1]
        if self.M(carry_index):
            self.X(carry_index)
            self.INCDECSC(to_add + 1, start, length, *flags)
        else:
            self.INCDECSC(to_add, start, length, *flags)

    def DECSC(self, to_sub: int, start: int, length: int, *flags) -> None:
        carry_index = flags[-1]
        has_carry = self.M(carry_index)
        inv = (1 << length) - (to_sub & ((1 << length) - 1))
        if has_carry:
            self.X(carry_index)
        else:
            inv -= 1
        self.INCDECSC(inv, start, length, *flags)

    # ------------------------------------------------------------------
    # full adders (reference: src/qinterface/arithmetic.cpp:276-420)
    # ------------------------------------------------------------------

    def FullAdd(self, input1: int, input2: int, carry_in_sum_out: int, carry_out: int) -> None:
        self.CFullAdd((), input1, input2, carry_in_sum_out, carry_out)

    def IFullAdd(self, input1: int, input2: int, carry_in_sum_out: int, carry_out: int) -> None:
        self.CIFullAdd((), input1, input2, carry_in_sum_out, carry_out)

    def CFullAdd(self, controls, input1, input2, carry_in_sum_out, carry_out) -> None:
        controls = tuple(controls)
        cp = (1 << len(controls)) - 1

        def mcx(extra, target):
            ctrls = controls + tuple(extra)
            self.MCMtrxPerm(ctrls, mat.X2, target, cp | (((1 << len(extra)) - 1) << len(controls)))

        mcx((input1, input2), carry_out)
        mcx((input1,), input2)
        mcx((input2, carry_in_sum_out), carry_out)
        mcx((input2,), carry_in_sum_out)
        mcx((input1,), input2)

    def CIFullAdd(self, controls, input1, input2, carry_in_sum_out, carry_out) -> None:
        controls = tuple(controls)
        cp = (1 << len(controls)) - 1

        def mcx(extra, target):
            ctrls = controls + tuple(extra)
            self.MCMtrxPerm(ctrls, mat.X2, target, cp | (((1 << len(extra)) - 1) << len(controls)))

        mcx((input1,), input2)
        mcx((input2,), carry_in_sum_out)
        mcx((input2, carry_in_sum_out), carry_out)
        mcx((input1,), input2)
        mcx((input1, input2), carry_out)

    def ADC(self, input1: int, input2: int, output: int, length: int, carry: int) -> None:
        """Ripple add two registers into a zeroed output register with
        carry-in/out (reference: src/qinterface/arithmetic.cpp:330).
        Deviation: the reference's chain leaves sum bits scrambled across
        output/carry; here output holds the plain binary sum and `carry`
        the carry-out (IADC remains the exact inverse)."""
        self.CADC((), input1, input2, output, length, carry)

    def IADC(self, input1: int, input2: int, output: int, length: int, carry: int) -> None:
        self.CIADC((), input1, input2, output, length, carry)

    def CADC(self, controls, input1, input2, output, length, carry) -> None:
        controls = tuple(controls)
        for i in range(length):
            # FullAdd leaves sum in the carry slot and carry-out in
            # output+i; the swap puts them in their proper places.
            self.CFullAdd(controls, input1 + i, input2 + i, carry, output + i)
            if controls:
                self.CSwap(controls, carry, output + i)
            else:
                self.Swap(carry, output + i)

    def CIADC(self, controls, input1, input2, output, length, carry) -> None:
        controls = tuple(controls)
        for i in range(length - 1, -1, -1):
            if controls:
                self.CSwap(controls, carry, output + i)
            else:
                self.Swap(carry, output + i)
            self.CIFullAdd(controls, input1 + i, input2 + i, carry, output + i)

    # ------------------------------------------------------------------
    # modular multiply, out of place.
    # The reference synthesizes these by shift-adding residues into the
    # out register without modular reduction (reference:
    # src/qinterface/arithmetic.cpp:127-275), which wraps at 2^oLength
    # instead of modN for some operand combinations. Here the default is
    # a correct Vedral-style modular adder using one allocated ancilla.
    # Dense engines override with exact index-permutation kernels.
    # ------------------------------------------------------------------

    def _mod_out_length(self, mod_n: int) -> int:
        from ..utils.bits import is_pow2, log2

        return log2(mod_n) if is_pow2(mod_n) else (log2(mod_n) + 1)

    def _c_add_mod_n(self, a: int, mod_n: int, start: int, length: int,
                     controls: Sequence[int]) -> None:
        """Controlled (reg := reg + a mod mod_n), valid for reg < mod_n.

        One-ancilla comparator construction: extended add, subtract N,
        conditionally restore, then uncompute the borrow flag."""
        from ..utils.bits import is_pow2

        controls = tuple(controls)
        a %= mod_n
        if a == 0:
            return
        if is_pow2(mod_n):
            self.CINC(a, start, length, controls)
            return
        cperm = (1 << len(controls)) - 1
        anc = self.Allocate(self.qubit_count, 1)
        ext_mod = 1 << (length + 1)
        # reg+anc := x + a
        self.CINCDECC(a, start, length, anc, controls)
        # reg+anc := x + a - N  (anc becomes 1 iff x + a < N)
        self.CINCDECC(ext_mod - mod_n, start, length, anc, controls)
        # if anc: reg += N (low bits only) -> reg = (x + a) mod N
        self.CINC(mod_n, start, length, controls + (anc,))
        # uncompute anc: borrow of (reg - a) tells whether reduction happened
        self.CINCDECC(ext_mod - a, start, length, anc, controls)
        self.MCMtrxPerm(controls, mat.X2, anc, cperm)
        self.CINC(a, start, length, controls)
        self.Dispose(anc, 1, 0)

    def _c_sub_mod_n(self, a: int, mod_n: int, start: int, length: int,
                     controls: Sequence[int]) -> None:
        self._c_add_mod_n(mod_n - (a % mod_n), mod_n, start, length, controls)

    def MULModNOut(self, to_mul: int, mod_n: int, in_start: int, out_start: int, length: int) -> None:
        self.CMULModNOut(to_mul, mod_n, in_start, out_start, length, ())

    def IMULModNOut(self, to_mul: int, mod_n: int, in_start: int, out_start: int, length: int) -> None:
        self.CIMULModNOut(to_mul, mod_n, in_start, out_start, length, ())

    def CMULModNOut(self, to_mul, mod_n, in_start, out_start, length, controls) -> None:
        controls = tuple(controls)
        o_length = self._mod_out_length(mod_n)
        for i in range(length):
            part = (to_mul << i) % mod_n
            if part:
                self._c_add_mod_n(part, mod_n, out_start, o_length, controls + (in_start + i,))

    def CIMULModNOut(self, to_mul, mod_n, in_start, out_start, length, controls) -> None:
        controls = tuple(controls)
        o_length = self._mod_out_length(mod_n)
        for i in range(length - 1, -1, -1):
            part = (to_mul << i) % mod_n
            if part:
                self._c_sub_mod_n(part, mod_n, out_start, o_length, controls + (in_start + i,))

    # ------------------------------------------------------------------
    # engine-level ops (no universal synthesis; dense engines implement
    # via index-permutation kernels, layers forward)
    # ------------------------------------------------------------------

    def MUL(self, to_mul: int, in_out_start: int, carry_start: int, length: int) -> None:
        raise NotImplementedError

    def DIV(self, to_div: int, in_out_start: int, carry_start: int, length: int) -> None:
        raise NotImplementedError

    def CMUL(self, to_mul, in_out_start, carry_start, length, controls) -> None:
        raise NotImplementedError

    def CDIV(self, to_div, in_out_start, carry_start, length, controls) -> None:
        raise NotImplementedError

    def POWModNOut(self, base: int, mod_n: int, in_start: int, out_start: int, length: int) -> None:
        raise NotImplementedError

    def CPOWModNOut(self, base, mod_n, in_start, out_start, length, controls) -> None:
        raise NotImplementedError

    def IndexedLDA(self, index_start, index_length, value_start, value_length, values,
                   reset_value: bool = True) -> int:
        raise NotImplementedError

    def IndexedADC(self, index_start, index_length, value_start, value_length, carry_index, values) -> int:
        raise NotImplementedError

    def IndexedSBC(self, index_start, index_length, value_start, value_length, carry_index, values) -> int:
        raise NotImplementedError

    def Hash(self, start: int, length: int, values) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # comparator phase flips (reference: c/phaseflipifless kernels,
    # src/common/qheader_alu.cl:780-810) — universal synthesis here
    # ------------------------------------------------------------------

    def PhaseFlipIfLess(self, greater_perm: int, start: int, length: int) -> None:
        self._phase_flip_if_in_range(0, greater_perm, start, length)

    def CPhaseFlipIfLess(self, greater_perm: int, start: int, length: int, flag_index: int) -> None:
        self._phase_flip_if_in_range(0, greater_perm, start, length,
                                     extra_controls=(flag_index,), extra_perm=1)

    def PhaseFlip(self) -> None:
        """Global -1 phase (reference: include/qinterface.hpp PhaseFlip)."""
        self._phase_flip_if_in_range(0, 2, 0, 1)
