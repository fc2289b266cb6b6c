"""QEngine: abstract dense ("Schrödinger") state-vector engine.

Re-design of the reference's QEngine contract (reference:
include/qengine.hpp:31-299 — Apply2x2/ApplyM/ProbReg/ProbMask/
GetAmplitudePage/SetAmplitudePage/ShuffleBuffers/CloneEmpty/queued-norm;
common measurement logic src/qengine/qengine.cpp). A concrete engine
(engines/cpu.py, engines/cuda.py) implements the `_k_*` kernel
contract below; everything else — the whole QInterface surface, the
ALU, parity, sampling — is provided here once, shared by all dense
backends.  The ALU overrides run each op as one index gather, one
out-of-place scatter or one phase pass (ops/alu_kernels.py).  Each
gather and phase op also hands over its split-index form (``split=``,
ops/alu_kernels.py ``*_split``), which the pager runs past 31 qubits
and the compressed engine over its chunks (the JAX package's forms
also carry a program-cache key, which eager torch has no use for).

Kernel contract (the analogue of the reference's OCLAPI enum,
include/common/oclapi.hpp:19-99):

  _k_apply_2x2(m2, target, controls, perm)     generic 2x2 (apply2x2*)
  _k_apply_diag(d0, d1, target, controls, perm) phase fast path (phase/z)
  _k_gather(src_fn, split)                      basis permutation (ALU, xmask, rol)
  _k_out_of_place(src, dst, passthrough)        mul/div/*modnout scatter
  _k_phase_fn(fn, split)                        diagonal complex factor:
                                                fn(xp, idx) -> (re, im)
  _k_probs()                                    |amp|^2 vector (host numpy)
  _k_prob_mask(mask, perm)                      masked-probability reduce
  _k_collapse(mask, val, nrm_sq)                projective collapse (applym/applymreg)
  _k_compose(other, start)                      tensor product (compose kernel)
  _k_decompose(start, length) -> dest_state     split separable subsystem
  _k_dispose(start, length, perm)               drop separable subsystem
  _k_allocate(start, length)                    insert |0> qubits
  _k_normalize(nrm_sq)                          nrmlze kernel
  _k_sum_sqr_diff(other)                        approxcompare kernel
  _k_swap_bits(q1, q2)                          swap as index relabel
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from .. import telemetry as _tele
from ..config import FP_NORM_EPSILON
from ..interface import QInterface
from ..ops import alu_kernels as alu
from .. import matrices as mat
from ..utils.bits import bit_reg_mask, is_pow2, log2


def _parity_rz_split(mask):
    """Shared split-index body of the parity-phase family: factor
    cc + i*(+-ss) chosen by the parity of (index & mask); PhaseParity
    and UniformParityRZ differ only in their host-side angles."""
    def body(xp, pid, lidx, L, cc, ss):
        par = alu.split_parity(xp, pid, lidx, L, mask)
        return cc, xp.where(par == 1, ss, -ss)
    return body


class QEngine(QInterface):
    """Dense-ket engine base; see module docstring for the kernel contract."""

    # numpy-compatible module used by index kernels (torch for the CUDA
    # engine)
    _xp = np

    # engine label in telemetry counter names (gate.<label>.<kind>.w<n>)
    _tele_name = "engine"

    # lazy gate-stream fusion (ops/fusion.py): engines that can lower a
    # pending gate window into one parametric window set _fuse_capable
    # and install a GateStreamFuser in __init__
    _fuser = None
    _fuse_capable = False

    def _fuse_tick(self) -> None:
        """Per-logical-gate hook from GateStreamFuser.queue (no-op until
        the f64 drift escalation is ported)."""

    # ------------------------------------------------------------------
    # gate primitive dispatch
    # ------------------------------------------------------------------

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        self._check_qubit(target)
        for c in controls:
            self._check_qubit(c)
        m = np.asarray(mtrx, dtype=np.complex128).reshape(2, 2)
        if mat.is_identity(m) and abs(m[0, 0] - 1.0) <= 1e-14:
            return
        # gate.* counters record logical gates REQUESTED; the fused path
        # accounts its (fewer) physical sweeps under fuse.*
        if mat.is_phase(m):
            if _tele._ENABLED:
                _tele.inc(f"gate.{self._tele_name}.diag.w{self.qubit_count}")
            fuser = self._fuser
            if fuser is not None and fuser.queue(tuple(controls), m, target, perm):
                return
            self._k_apply_diag(m[0, 0], m[1, 1], target, tuple(controls), perm)
        else:
            if _tele._ENABLED:
                _tele.inc(f"gate.{self._tele_name}.2x2.w{self.qubit_count}")
            fuser = self._fuser
            if fuser is not None and fuser.queue(tuple(controls), m, target, perm):
                return
            self._k_apply_2x2(m, target, tuple(controls), perm)

    # fast paths: X on many bits is one gather; Z/phase masks are diagonal
    # (reference kernels xmask/phasemask, src/common/qengine.cl:266-340)

    def XMask(self, mask: int) -> None:
        if not mask:
            return
        if _tele._ENABLED:
            _tele.inc(f"gate.{self._tele_name}.permute.w{self.qubit_count}")
        self._k_gather(
            lambda idx: idx ^ mask,
            split=(lambda xp, pid, lidx, L: alu.xor_split(
                xp, pid, lidx, L, mask & ((1 << L) - 1), mask >> L), ()))

    def ZMask(self, mask: int) -> None:
        if not mask:
            return
        if _tele._ENABLED:
            _tele.inc(f"gate.{self._tele_name}.phase_mask.w{self.qubit_count}")

        def fn(xp, idx):
            par = self._parity_of(xp, idx, mask)
            return xp.where(par == 1, -1.0, 1.0), 0.0

        self._k_phase_fn(fn, split=(
            lambda xp, pid, lidx, L: (
                xp.where(alu.split_parity(xp, pid, lidx, L, mask) == 1,
                         -1.0, 1.0), 0.0),
            ()))

    @staticmethod
    def _parity_of(xp, idx, mask):
        v = idx & mask
        # O(log n) parity fold; skip shifts >= the index dtype width
        width = v.dtype.itemsize * 8 if hasattr(v, "dtype") else 64
        for s in (32, 16, 8, 4, 2, 1):
            if s < width:
                v = v ^ (v >> s)
        return v & 1

    def PhaseParity(self, radians: float, mask: int) -> None:
        if not mask:
            return
        c, s_ = math.cos(radians / 2), math.sin(radians / 2)

        def fn(xp, idx):
            par = self._parity_of(xp, idx, mask)
            return c, xp.where(par == 1, s_, -s_)

        self._k_phase_fn(fn, split=(_parity_rz_split(mask), (c, s_)))

    def Swap(self, q1: int, q2: int) -> None:
        if q1 == q2:
            return
        if _tele._ENABLED:
            _tele.inc(f"gate.{self._tele_name}.swap.w{self.qubit_count}")
        self._k_swap_bits(q1, q2)

    def Apply4x4(self, m: np.ndarray, q1: int, q2: int) -> None:
        if _tele._ENABLED:
            _tele.inc(f"gate.{self._tele_name}.4x4.w{self.qubit_count}")
        self._k_apply_4x4(np.asarray(m, dtype=np.complex128), q1, q2)

    def _k_apply_4x4(self, m4, q1, q2) -> None:
        # default: two-level synthesis (engines override with tensor op)
        from ..interface.synth import apply_small_unitary_via_primitive

        apply_small_unitary_via_primitive(self, m4, (q1, q2))

    # ------------------------------------------------------------------
    # probability / measurement
    # ------------------------------------------------------------------

    def Prob(self, q: int) -> float:
        self._check_qubit(q)
        return self._k_prob_mask(1 << q, 1 << q)

    def ProbAll(self, perm: int) -> float:
        return abs(self.GetAmplitude(perm)) ** 2

    def ProbReg(self, start: int, length: int, perm: int) -> float:
        return self._k_prob_mask(bit_reg_mask(start, length), perm << start)

    def ProbMask(self, mask: int, perm: int) -> float:
        return self._k_prob_mask(mask, perm)

    def ForceM(self, q: int, result: bool, do_force: bool = True, do_apply: bool = True) -> bool:
        self._check_qubit(q)
        prob_one = self.Prob(q)
        if do_force:
            res = bool(result)
        elif prob_one >= 1.0 - FP_NORM_EPSILON:
            res = True   # deterministic: no RNG draw (keeps streams
        elif prob_one <= FP_NORM_EPSILON:
            res = False  # aligned with the tableau engines)
        else:
            res = self.Rand() <= prob_one
        nrm_sq = prob_one if res else (1.0 - prob_one)
        if nrm_sq <= 0.0:
            raise RuntimeError("ForceM: forced result has zero probability")
        if do_apply:
            self._k_collapse(1 << q, (1 << q) if res else 0, nrm_sq)
        return res

    def ForceMParity(self, mask: int, result: bool, do_force: bool = True) -> bool:
        odd_prob = self.ProbParity(mask)
        if not do_force:
            if odd_prob >= 1.0 - FP_NORM_EPSILON:
                result = True   # deterministic: no draw (stream-aligned
            elif odd_prob <= FP_NORM_EPSILON:
                result = False  # with ForceM and the tableau path)
            else:
                result = self.Rand() <= odd_prob
        nrm_sq = odd_prob if result else (1.0 - odd_prob)
        if nrm_sq <= 0.0:
            raise RuntimeError("ForceMParity: forced result has zero probability")
        want = 1 if result else 0
        scale = 1.0 / math.sqrt(nrm_sq)

        def fn(xp, idx):
            par = self._parity_of(xp, idx, mask)
            return xp.where(par == want, scale, 0.0), 0.0

        self._k_phase_fn(fn, split=(
            lambda xp, pid, lidx, L, sc: (
                xp.where(alu.split_parity(xp, pid, lidx, L, mask) == want,
                         sc, 0.0), 0.0),
            (scale,)))
        return bool(result)

    def MAll(self) -> int:
        """Vectorized full measurement: sample one index from |amp|^2 and
        collapse (reference: per-engine MAll / SetPermutation)."""
        probs = self._k_probs()
        result = int(self.rng.choice_from_probs(probs, 1)[0])
        self.SetPermutation(result)
        return result

    def MultiShotMeasureMask(self, q_powers: Sequence[int], shots: int) -> dict:
        """Sampling without collapse via the masked marginal distribution
        (reference: src/qinterface/qinterface.cpp:807, engine-vectorized)."""
        bits = [log2(p) for p in q_powers]
        dist = self.ProbBitsAll(bits)
        draws = self.rng.choice_from_probs(dist, shots)
        out: dict = {}
        for d in draws:
            d = int(d)
            out[d] = out.get(d, 0) + 1
        return out

    def GetProbs(self) -> np.ndarray:
        return self._k_probs()

    # ------------------------------------------------------------------
    # ALU overrides: vectorized index-map kernels
    # (reference: qheader_alu.cl via src/qengine/arithmetic.cpp)
    # ------------------------------------------------------------------

    def INC(self, to_add: int, start: int, length: int) -> None:
        if not length:
            return
        self._check_range(start, length)
        to_add &= (1 << length) - 1
        if not to_add:
            return
        self._k_gather(
            lambda idx: alu.inc_src(self._xp, idx, to_add, start, length),
            split=(lambda xp, pid, lidx, L, ta: alu.inc_src_split(
                xp, pid, lidx, L, ta, start, length), (to_add,)))

    def CINC(self, to_add: int, start: int, length: int, controls) -> None:
        controls = tuple(controls)
        if not controls:
            return self.INC(to_add, start, length)
        if not length:
            return
        to_add &= (1 << length) - 1
        if not to_add:
            return
        perm = (1 << len(controls)) - 1
        self._k_gather(
            lambda idx: alu.inc_src(self._xp, idx, to_add, start, length,
                                    controls, perm),
            split=(lambda xp, pid, lidx, L, ta: alu.inc_src_split(
                xp, pid, lidx, L, ta, start, length, controls, perm),
                (to_add,)))

    def INCDECC(self, to_add: int, start: int, length: int, carry_index: int) -> None:
        if not length:
            return
        to_add &= (1 << (length + 1)) - 1
        if not to_add:
            return
        self._k_gather(
            lambda idx: alu.incdecc_src(self._xp, idx, to_add, start, length,
                                        carry_index),
            split=(lambda xp, pid, lidx, L, ta: alu.incdecc_src_split(
                xp, pid, lidx, L, ta, start, length, carry_index),
                (to_add,)))

    def INCBCD(self, to_add: int, start: int, length: int) -> None:
        """Packed-BCD add of decimal `to_add` (reference kernel incbcd,
        src/common/qheader_bcd.cl:1-67; QEngineCPU::INCBCD,
        src/qengine/arithmetic.cpp:777). Register length must be a
        multiple of 4; non-BCD basis states pass through."""
        if not length:
            return
        if length % 4:
            raise ValueError("BCD register length must be a multiple of 4")
        self._check_range(start, length)
        to_add %= 10 ** (length // 4)
        if not to_add:
            return
        self._k_gather(
            lambda idx: alu.incbcd_src(self._xp, idx, to_add, start, length),
            split=(lambda xp, pid, lidx, L, digits: alu.incbcd_src_split(
                xp, pid, lidx, L, digits, start, length),
                (alu.bcd_digits(to_add, length // 4),)))

    def INCDECBCDC(self, to_add: int, start: int, length: int, carry_index: int) -> None:
        """Packed-BCD add with carry-out XOR (reference kernel
        incdecbcdc, src/common/qheader_bcd.cl:67-143)."""
        if not length:
            return
        if length % 4:
            raise ValueError("BCD register length must be a multiple of 4")
        self._check_range(start, length)
        to_add %= 10 ** (length // 4)
        self._k_gather(
            lambda idx: alu.incdecbcdc_src(self._xp, idx, to_add, start,
                                           length, carry_index),
            split=(lambda xp, pid, lidx, L, digits: alu.incdecbcdc_src_split(
                xp, pid, lidx, L, digits, start, length, carry_index),
                (alu.bcd_digits(to_add, length // 4),)))

    def INCS(self, to_add: int, start: int, length: int, overflow_index: int) -> None:
        if not length:
            return
        self._k_gather(
            lambda idx: alu.incs_src(self._xp, idx, to_add, start, length,
                                     overflow_index),
            split=(lambda xp, pid, lidx, L, ta: alu.incs_src_split(
                xp, pid, lidx, L, ta, start, length, overflow_index),
                (to_add & ((1 << length) - 1),)))

    def INCDECSC(self, to_add: int, start: int, length: int, *flags) -> None:
        if not length:
            return
        if len(flags) == 2:
            overflow_index, carry_index = flags
        else:
            overflow_index, carry_index = None, flags[0]
        self._k_gather(
            lambda idx: alu.incdecsc_src(self._xp, idx, to_add, start, length,
                                         carry_index, overflow_index),
            split=(lambda xp, pid, lidx, L, ta: alu.incdecsc_src_split(
                xp, pid, lidx, L, ta, start, length, carry_index,
                overflow_index),
                (to_add & ((1 << (length + 1)) - 1),)))

    def ROL(self, shift: int, start: int, length: int) -> None:
        if length < 2 or not (shift % length):
            return
        sh = shift % length
        self._k_gather(
            lambda idx: alu.rol_src(self._xp, idx, sh, start, length),
            split=(lambda xp, pid, lidx, L: alu.rol_src_split(
                xp, pid, lidx, L, sh, start, length), ()))

    def ROR(self, shift: int, start: int, length: int) -> None:
        self.ROL(length - (shift % length) if length else 0, start, length)

    # engines whose ket index passes int32 (the pager past 31 qubits, or
    # a pager with force_wide_alu) run MUL/DIV and the *ModNOut family as
    # split-index gathers: the pair-scatter forms build full-width host
    # index arrays
    _wide_alu = False

    def MUL(self, to_mul: int, in_out_start: int, carry_start: int, length: int) -> None:
        if to_mul == 1 or not length:
            return
        if self._wide_alu:
            return self._muldiv_wide(to_mul, in_out_start, carry_start, length, False)
        src, dst = alu.mul_pair(self._xp, self.qubit_count, to_mul, in_out_start, carry_start, length)
        self._k_out_of_place(src, dst, None)

    def DIV(self, to_div: int, in_out_start: int, carry_start: int, length: int) -> None:
        if to_div == 1 or not length:
            return
        if self._wide_alu:
            return self._muldiv_wide(to_div, in_out_start, carry_start, length, True)
        src, dst = alu.mul_pair(self._xp, self.qubit_count, to_div, in_out_start, carry_start, length)
        self._k_out_of_place(dst, src, None)

    def CMUL(self, to_mul, in_out_start, carry_start, length, controls) -> None:
        controls = tuple(controls)
        if not controls:
            return self.MUL(to_mul, in_out_start, carry_start, length)
        if to_mul == 1 or not length:
            return
        if self._wide_alu:
            return self._muldiv_wide(to_mul, in_out_start, carry_start, length,
                                     False, controls)
        src, dst = alu.mul_pair(self._xp, self.qubit_count, to_mul, in_out_start, carry_start, length)
        self._ctrl_out_of_place(src, dst, controls)

    def CDIV(self, to_div, in_out_start, carry_start, length, controls) -> None:
        controls = tuple(controls)
        if not controls:
            return self.DIV(to_div, in_out_start, carry_start, length)
        if to_div == 1 or not length:
            return
        if self._wide_alu:
            return self._muldiv_wide(to_div, in_out_start, carry_start, length,
                                     True, controls)
        src, dst = alu.mul_pair(self._xp, self.qubit_count, to_div, in_out_start, carry_start, length)
        self._ctrl_out_of_place(dst, src, controls)

    @staticmethod
    def _split_ctrl(body, controls):
        """A split gather body restricted to the control-matching
        subspace: everything else passes through (reference kernels
        cmul/cdiv)."""
        if not controls:
            return body
        perm_all = (1 << len(controls)) - 1

        def ctrl_body(xp, pid, lidx, L, *targs):
            sp, sl, keep = body(xp, pid, lidx, L, *targs)
            ok = alu.split_ctrl_match(xp, pid, lidx, L, controls, perm_all)
            sp = xp.where(ok, alu._lane(sp, lidx), alu._lane(pid, lidx))
            return sp, xp.where(ok, sl, lidx), keep | ~ok

        return ctrl_body

    def _muldiv_wide(self, to_mul, in_out_start, carry_start, length,
                     inverse, controls=()) -> None:
        """Width-generic MUL/DIV: the pair-scatter path builds full-width
        host index arrays, so past int32 widths the same map runs as a
        split-index gather, with host-built product tables below the
        table cap (QRACK_WIDE_MUL_TABLE_QB, 24 bits) and products
        recomputed per lane in 16-bit limbs above it or with
        QRACK_WIDE_MUL_TABLE_FREE=1.  The register itself stays <= 31 bits
        (reference width-generic mul/div kernels, qheader_alu.cl:~260)."""
        import os

        cap = min(int(os.environ.get("QRACK_WIDE_MUL_TABLE_QB", "24")), 31)
        if os.environ.get("QRACK_WIDE_MUL_TABLE_FREE") == "1" or length > cap:
            k, consts = alu.mul_consts(to_mul, length)
            src_split = alu.div_src_split_tf if inverse else alu.mul_src_split_tf

            def body(xp, pid, lidx, L, consts_op):
                return src_split(xp, pid, lidx, L, consts_op, k,
                                 in_out_start, carry_start, length)

            targs = (consts,)
        else:
            lo, hi, inv, k = alu.mul_tables(to_mul, length)
            src_split = alu.div_src_split if inverse else alu.mul_src_split

            def body(xp, pid, lidx, L, lo_t, hi_t, inv_t):
                return src_split(xp, pid, lidx, L, lo_t, hi_t, inv_t, k,
                                 in_out_start, carry_start, length)

            targs = (lo, hi, inv)
        self._k_gather(None, split=(self._split_ctrl(body, controls), targs))

    def _modnout_wide(self, res_fn, in_start, length, out_start, ol,
                      inverse, controls=()) -> None:
        """Width-generic (I)MULModNOut / POWModNOut: a split-index gather
        with the residues of every input value in one host table (exact
        Python ints; each residue < 2^ol fits int32)."""
        table = np.asarray([res_fn(v) for v in range(1 << length)],
                           dtype=np.int32)

        def body(xp, pid, lidx, L, tbl):
            return alu.modnout_gather_split(xp, pid, lidx, L, tbl, in_start,
                                            length, out_start, ol,
                                            inverse=inverse)

        self._k_gather(None, split=(self._split_ctrl(body, controls), (table,)))

    def _ctrl_out_of_place(self, src, dst, controls) -> None:
        """Restrict an out-of-place map to the control-matching subspace;
        everything else passes through (reference kernels cmul/cdiv)."""
        cmask = 0
        for c in controls:
            cmask |= 1 << c
        sel = (src & cmask) == cmask
        self._k_out_of_place(src[sel], dst[sel] | cmask, cmask)

    def _mod_out_len(self, mod_n: int) -> int:
        return log2(mod_n) if is_pow2(mod_n) else (log2(mod_n) + 1)

    def MULModNOut(self, to_mul, mod_n, in_start, out_start, length) -> None:
        ol = self._mod_out_len(mod_n)
        if self._wide_alu:
            return self._modnout_wide(
                lambda v: (v * to_mul) % mod_n, in_start, length, out_start, ol, False)
        src, dst = alu.mulmodnout_pair(
            self._xp, self.qubit_count, to_mul, mod_n, in_start, out_start, length, ol
        )
        self._k_out_of_place(src, dst, None)

    def IMULModNOut(self, to_mul, mod_n, in_start, out_start, length) -> None:
        ol = self._mod_out_len(mod_n)
        if self._wide_alu:
            return self._modnout_wide(
                lambda v: (v * to_mul) % mod_n, in_start, length, out_start, ol, True)
        src, dst = alu.mulmodnout_pair(
            self._xp, self.qubit_count, to_mul, mod_n, in_start, out_start, length, ol
        )
        self._k_out_of_place(dst, src, None)

    def CMULModNOut(self, to_mul, mod_n, in_start, out_start, length, controls) -> None:
        controls = tuple(controls)
        if not controls:
            return self.MULModNOut(to_mul, mod_n, in_start, out_start, length)
        ol = self._mod_out_len(mod_n)
        if self._wide_alu:
            return self._modnout_wide(
                lambda v: (v * to_mul) % mod_n, in_start, length, out_start, ol, False, controls)
        src, dst = alu.mulmodnout_pair(
            self._xp, self.qubit_count, to_mul, mod_n, in_start, out_start, length, ol
        )
        self._ctrl_out_of_place(src, dst, controls)

    def CIMULModNOut(self, to_mul, mod_n, in_start, out_start, length, controls) -> None:
        controls = tuple(controls)
        if not controls:
            return self.IMULModNOut(to_mul, mod_n, in_start, out_start, length)
        ol = self._mod_out_len(mod_n)
        if self._wide_alu:
            return self._modnout_wide(
                lambda v: (v * to_mul) % mod_n, in_start, length, out_start, ol, True, controls)
        src, dst = alu.mulmodnout_pair(
            self._xp, self.qubit_count, to_mul, mod_n, in_start, out_start, length, ol
        )
        self._ctrl_out_of_place(dst, src, controls)

    def POWModNOut(self, base: int, mod_n: int, in_start, out_start, length) -> None:
        ol = self._mod_out_len(mod_n)
        if self._wide_alu:
            return self._modnout_wide(
                lambda v: pow(base, v, mod_n), in_start, length, out_start, ol, False)
        src, dst = alu.powmodnout_pair(
            self._xp, self.qubit_count, base, mod_n, in_start, out_start, length, ol
        )
        self._k_out_of_place(src, dst, None)

    def CPOWModNOut(self, base, mod_n, in_start, out_start, length, controls) -> None:
        controls = tuple(controls)
        if not controls:
            return self.POWModNOut(base, mod_n, in_start, out_start, length)
        ol = self._mod_out_len(mod_n)
        if self._wide_alu:
            return self._modnout_wide(
                lambda v: pow(base, v, mod_n), in_start, length, out_start, ol, False, controls)
        src, dst = alu.powmodnout_pair(
            self._xp, self.qubit_count, base, mod_n, in_start, out_start, length, ol
        )
        self._ctrl_out_of_place(src, dst, controls)

    def IndexedLDA(self, index_start, index_length, value_start, value_length, values,
                   reset_value: bool = True) -> int:
        if reset_value:
            # reference zeroes the value register before loading
            # (src/qengine/arithmetic.cpp IndexedLDA: SetReg(..., 0))
            self.SetReg(value_start, value_length, 0)
        tbl = self._index_table(values)
        self._k_gather(
            lambda idx: alu.indexed_lda_src(
                self._xp, idx, index_start, index_length, value_start,
                value_length, tbl),
            split=(lambda xp, pid, lidx, L, t: alu.indexed_lda_src_split(
                xp, pid, lidx, L, t, index_start, index_length, value_start,
                value_length), (np.asarray(values, dtype=np.int32),)))
        return int(round(self.ExpectationBitsAll(
            list(range(value_start, value_start + value_length)))))

    def IndexedADC(self, index_start, index_length, value_start, value_length, carry_index, values) -> int:
        tbl = self._index_table(values)
        self._k_gather(
            lambda idx: alu.indexed_adc_src(
                self._xp, idx, index_start, index_length, value_start,
                value_length, carry_index, tbl, sign=1),
            split=(lambda xp, pid, lidx, L, t: alu.indexed_adc_src_split(
                xp, pid, lidx, L, t, index_start, index_length, value_start,
                value_length, carry_index, sign=1),
                (np.asarray(values, dtype=np.int32),)))
        return int(round(self.ExpectationBitsAll(
            list(range(value_start, value_start + value_length)))))

    def IndexedSBC(self, index_start, index_length, value_start, value_length, carry_index, values) -> int:
        tbl = self._index_table(values)
        self._k_gather(
            lambda idx: alu.indexed_adc_src(
                self._xp, idx, index_start, index_length, value_start,
                value_length, carry_index, tbl, sign=-1),
            split=(lambda xp, pid, lidx, L, t: alu.indexed_adc_src_split(
                xp, pid, lidx, L, t, index_start, index_length, value_start,
                value_length, carry_index, sign=-1),
                (np.asarray(values, dtype=np.int32),)))
        return int(round(self.ExpectationBitsAll(
            list(range(value_start, value_start + value_length)))))

    def Hash(self, start: int, length: int, values) -> None:
        tbl = np.asarray(values, dtype=np.int64)
        inv = np.empty_like(tbl)
        inv[tbl] = np.arange(tbl.shape[0], dtype=np.int64)
        inv_dev = self._index_table(inv)
        self._k_gather(
            lambda idx: alu.hash_src(self._xp, idx, start, length, inv_dev),
            split=(lambda xp, pid, lidx, L, t: alu.hash_src_split(
                xp, pid, lidx, L, t, start, length), (inv.astype(np.int32),)))

    def PhaseFlipIfLess(self, greater_perm: int, start: int, length: int) -> None:
        self._k_phase_fn(
            lambda xp, idx: (alu.phase_flip_less_factor(
                xp, idx, greater_perm, start, length), 0.0),
            split=(lambda xp, pid, lidx, L, gp: (
                alu.phase_flip_less_factor_split(
                    xp, pid, lidx, L, gp, start, length), 0.0),
                (greater_perm,)))

    def CPhaseFlipIfLess(self, greater_perm: int, start: int, length: int, flag_index: int) -> None:
        self._k_phase_fn(
            lambda xp, idx: (alu.phase_flip_less_factor(
                xp, idx, greater_perm, start, length, flag_index), 0.0),
            split=(lambda xp, pid, lidx, L, gp: (
                alu.phase_flip_less_factor_split(
                    xp, pid, lidx, L, gp, start, length, flag_index), 0.0),
                (greater_perm,)))

    def PhaseFlip(self) -> None:
        self._k_phase_fn(lambda xp, idx: (-1.0, 0.0),
                         split=(lambda xp, pid, lidx, L: (-1.0, 0.0), ()))

    def UniformParityRZ(self, mask: int, angle: float) -> None:
        c, s_ = math.cos(angle), math.sin(angle)

        def fn(xp, idx):
            par = self._parity_of(xp, idx, mask)
            return c, xp.where(par == 1, s_, -s_)

        self._k_phase_fn(fn, split=(_parity_rz_split(mask), (c, s_)))

    def CUniformParityRZ(self, controls, mask: int, angle: float) -> None:
        controls = tuple(controls)
        if not controls:
            return self.UniformParityRZ(mask, angle)
        c, s_ = math.cos(angle), math.sin(angle)
        cmask = 0
        for ctl in controls:
            cmask |= 1 << ctl

        def fn(xp, idx):
            par = self._parity_of(xp, idx, mask)
            active = (idx & cmask) == cmask
            fre = xp.where(active, c, 1.0)
            fim = xp.where(active, xp.where(par == 1, s_, -s_), 0.0)
            return fre, fim

        perm_all = (1 << len(controls)) - 1

        def body(xp, pid, lidx, L, cc, ss):
            par = alu.split_parity(xp, pid, lidx, L, mask)
            active = alu.split_ctrl_match(xp, pid, lidx, L, controls, perm_all)
            fre = xp.where(active, cc, 1.0)
            fim = xp.where(active, xp.where(par == 1, ss, -ss), 0.0)
            return fre, fim

        self._k_phase_fn(fn, split=(body, (c, s_)))

    # ------------------------------------------------------------------
    # structure ops
    # ------------------------------------------------------------------

    def Compose(self, other, start: Optional[int] = None) -> int:
        if start is None:
            start = self.qubit_count
        self._check_capacity(self.qubit_count + other.qubit_count)
        self._k_compose(other, start)
        self.qubit_count += other.qubit_count
        return start

    def Decompose(self, start: int, dest) -> None:
        length = dest.qubit_count
        self._check_range(start, length)
        dest_state = self._k_decompose(start, length)
        self.qubit_count -= length
        dest.SetQuantumState(dest_state)

    def Dispose(self, start: int, length: int, disposed_perm: Optional[int] = None) -> None:
        self._check_range(start, length)
        self._k_dispose(start, length, disposed_perm)
        self.qubit_count -= length

    def Allocate(self, start: int, length: int = 1) -> int:
        if length == 0:
            return start
        self._check_capacity(self.qubit_count + length)
        self._k_allocate(start, length)
        self.qubit_count += length
        return start

    def _check_capacity(self, qubit_count: int) -> None:
        """Growth guard (reference: allocation guards, oclengine.cpp:388);
        engines override with their width ceilings."""

    # ------------------------------------------------------------------
    # norm bookkeeping (reference: include/qengine.hpp:100-152)
    # ------------------------------------------------------------------

    def GetRunningNorm(self) -> float:
        return self.running_norm

    def UpdateRunningNorm(self, norm_thresh: float = -1.0) -> None:
        self.running_norm = float(self._k_probs().sum())

    def NormalizeState(self, nrm: float = -1.0, norm_thresh: float = -1.0, phase_arg: float = 0.0) -> None:
        if nrm < 0:
            self.UpdateRunningNorm()
            nrm = self.running_norm
        if nrm > 0 and abs(nrm - 1.0) > FP_NORM_EPSILON:
            self._k_normalize(nrm)
            self.running_norm = 1.0

    def SumSqrDiff(self, other) -> float:
        return self._k_sum_sqr_diff(other)

    # ------------------------------------------------------------------
    # kernel contract (subclass responsibilities)
    # ------------------------------------------------------------------

    def _k_apply_2x2(self, m2, target, controls, perm) -> None:
        raise NotImplementedError

    def _k_apply_diag(self, d0, d1, target, controls, perm) -> None:
        raise NotImplementedError

    def _k_gather(self, src_fn, split=None) -> None:
        """Basis permutation new[i] = old[src_fn(i)].  ``split`` is the
        op's split-index form (body, targs): body(xp, pid, lidx, L,
        *targs) -> (src page, src local[, keep]); engines whose index
        fits int32 ignore it."""
        raise NotImplementedError

    def _k_out_of_place(self, src_idx, dst_idx, passthrough_cmask) -> None:
        """new[dst] = old[src] over zeros; with a control mask, indices
        outside the control subspace keep their amplitudes."""
        raise NotImplementedError

    def _index_table(self, values):
        """An ALU lookup table as an index array of `_xp` beside the
        engine's index vector."""
        return np.asarray(values, dtype=np.int64)

    def _k_phase_fn(self, fn, split=None) -> None:
        """Apply a per-index complex factor: fn(xp, idx) -> (re, im).
        ``split`` is the split-index form (body, targs): body(xp, pid,
        lidx, L, *targs) -> (re, im)."""
        raise NotImplementedError

    def _k_probs(self) -> np.ndarray:
        raise NotImplementedError

    def _k_prob_mask(self, mask, perm) -> float:
        raise NotImplementedError

    def _k_collapse(self, mask, val, nrm_sq) -> None:
        raise NotImplementedError

    def _k_compose(self, other, start) -> None:
        raise NotImplementedError

    def _k_decompose(self, start, length) -> np.ndarray:
        raise NotImplementedError

    def _k_dispose(self, start, length, perm) -> None:
        raise NotImplementedError

    def _k_allocate(self, start, length) -> None:
        raise NotImplementedError

    def _k_normalize(self, nrm_sq) -> None:
        raise NotImplementedError

    def _k_sum_sqr_diff(self, other) -> float:
        raise NotImplementedError

    def _k_swap_bits(self, q1, q2) -> None:
        raise NotImplementedError

    # -- cross-engine data plane (reference: include/qengine.hpp:128-145) --

    def ZeroAmplitudes(self) -> None:
        raise NotImplementedError

    def IsZeroAmplitude(self) -> bool:
        raise NotImplementedError

    def CopyStateVec(self, other) -> None:
        self.SetQuantumState(other.GetQuantumState())

    def GetAmplitudePage(self, offset: int, length: int) -> np.ndarray:
        raise NotImplementedError

    def SetAmplitudePage(self, page: np.ndarray, offset: int) -> None:
        raise NotImplementedError

    def ShuffleBuffers(self, other) -> None:
        """Swap the top half of self's ket with the bottom half of other's
        (reference: include/qengine.hpp:143; kernel shufflebuffers
        src/common/qengine.cl:1059)."""
        half = self.GetMaxQPower() >> 1
        top = self.GetAmplitudePage(half, half)
        bot = other.GetAmplitudePage(0, half)
        self.SetAmplitudePage(bot, half)
        other.SetAmplitudePage(top, 0)

    def CloneEmpty(self) -> "QEngine":
        raise NotImplementedError
