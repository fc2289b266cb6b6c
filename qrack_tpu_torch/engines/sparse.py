"""QEngineSparse: map-style sparse state vector on host.

Re-design of the reference's sparse storage (reference:
include/statevector.hpp StateVectorSparse — hash map of nonzero
amplitudes under QEngineCPU; Apply2x2Sparse src/qengine/state.cpp:535;
truncation env controls QRACK_SPARSE_TRUNCATION_THRESHOLD /
QRACK_SPARSE_MAX_ALLOC_MB README.md:96-100).

Representation: parallel sorted arrays (int64 indices, complex128
amplitudes) — numpy-vectorized merge/pair algebra instead of a hash
map, which keeps every gate O(nnz log nnz) and sampling O(nnz). Widths
to 62 qubits are exact as long as the support stays small (the role the
reference fills for beyond-memory registers).

A copy of the JAX package's engines/sparse.py, which is numpy only: a
host engine like QEngineCPU, it takes no ``device=``.  Its ALU runs the
dense engine's index maps (ops/alu_kernels.py) on numpy int64 indices,
which keep int64 throughout.  Its checkpoint hooks are the JAX
package's (checkpoint/registry.py, kind ``"sparse"``)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..config import FP_NORM_EPSILON
from ..interface import QInterface
from ..ops import alu_kernels as alu
from .. import matrices as mat


class QEngineSparse(QInterface):
    def __init__(self, qubit_count: int, init_state: int = 0,
                 truncation_threshold: Optional[float] = None,
                 max_entries: Optional[int] = None, **kwargs):
        if kwargs.pop("device", None) is not None:
            raise ValueError("QEngineSparse runs on the host and takes no "
                             "device")
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        if qubit_count > 62:
            raise MemoryError("QEngineSparse indexes with int64 (<= 62 qubits)")
        import os

        self.trunc = (truncation_threshold if truncation_threshold is not None
                      else float(os.environ.get("QRACK_SPARSE_TRUNCATION_THRESHOLD",
                                                "1e-16")))
        if max_entries is None:
            mb = int(os.environ.get("QRACK_SPARSE_MAX_ALLOC_MB", "512"))
            max_entries = (mb << 20) // 24  # 8B index + 16B amplitude
        self.max_entries = max_entries
        self._idx = np.array([init_state], dtype=np.int64)
        self._amp = np.array([self._rand_phase()], dtype=np.complex128)

    # ------------------------------------------------------------------

    def _rand_phase(self) -> complex:
        if self.rand_global_phase:
            ang = 2.0 * math.pi * self.Rand()
            return complex(math.cos(ang), math.sin(ang))
        return 1.0 + 0j

    def nnz(self) -> int:
        return int(self._idx.shape[0])

    def _prune(self) -> None:
        keep = (self._amp.real ** 2 + self._amp.imag ** 2) > self.trunc
        if not keep.all():
            self._idx = self._idx[keep]
            self._amp = self._amp[keep]
        if self._idx.shape[0] > self.max_entries:
            self.TruncateBySize(self.max_entries)

    def TruncateBySize(self, k: int) -> None:
        """Keep the k largest amplitudes then renormalize (reference:
        TruncateBySize include/qengine_cpu.hpp:111)."""
        if self._idx.shape[0] <= k:
            return
        p = self._amp.real ** 2 + self._amp.imag ** 2
        top = np.argpartition(p, -k)[-k:]
        order = np.argsort(self._idx[top])
        self._idx = self._idx[top][order]
        self._amp = self._amp[top][order]
        self.SparseRenorm()

    def SparseRenorm(self) -> None:
        """(reference: SparseRenorm include/qengine_cpu.hpp:118)."""
        nrm = np.linalg.norm(self._amp)
        if nrm > 0:
            self._amp = self._amp / nrm

    def _sort(self) -> None:
        order = np.argsort(self._idx)
        self._idx = self._idx[order]
        self._amp = self._amp[order]

    def _ctrl_sel(self, controls, perm):
        cmask = 0
        cval = 0
        for j, c in enumerate(controls):
            cmask |= 1 << c
            if (perm >> j) & 1:
                cval |= 1 << c
        return (self._idx & cmask) == cval

    # ------------------------------------------------------------------
    # gate primitive (reference: Apply2x2Sparse, state.cpp:535)
    # ------------------------------------------------------------------

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        self._check_qubit(target)
        m = np.asarray(mtrx, dtype=np.complex128).reshape(2, 2)
        sel = self._ctrl_sel(tuple(controls), perm)
        tpow = np.int64(1 << target)
        if mat.is_phase(m):
            bit = (self._idx & tpow) != 0
            f = np.where(bit, m[1, 1], m[0, 0])
            self._amp = np.where(sel, self._amp * f, self._amp)
            self._prune()
            return
        if mat.is_invert(m):
            # an entry with target bit b flips to 1-b and picks up the
            # <1-b|M|b> coefficient
            bit = (self._idx & tpow) != 0
            f = np.where(bit, m[0, 1], m[1, 0])
            self._amp = np.where(sel, self._amp * f, self._amp)
            self._idx = np.where(sel, self._idx ^ tpow, self._idx)
            self._sort()
            self._prune()
            return
        # general: merge pairs over the participating base set
        part_idx = self._idx[sel]
        part_amp = self._amp[sel]
        rest_idx = self._idx[~sel]
        rest_amp = self._amp[~sel]
        base = np.unique(part_idx & ~tpow)
        # gather existing amplitudes at base and base|tpow
        a0 = np.zeros(base.shape[0], dtype=np.complex128)
        a1 = np.zeros(base.shape[0], dtype=np.complex128)
        pos0 = np.searchsorted(part_idx, base)
        hit0 = (pos0 < part_idx.shape[0])
        hit0 &= part_idx[np.minimum(pos0, part_idx.shape[0] - 1)] == base
        a0[hit0] = part_amp[pos0[hit0]]
        hi = base | tpow
        pos1 = np.searchsorted(part_idx, hi)
        hit1 = (pos1 < part_idx.shape[0])
        hit1 &= part_idx[np.minimum(pos1, part_idx.shape[0] - 1)] == hi
        a1[hit1] = part_amp[pos1[hit1]]
        n0 = m[0, 0] * a0 + m[0, 1] * a1
        n1 = m[1, 0] * a0 + m[1, 1] * a1
        self._idx = np.concatenate([rest_idx, base, hi])
        self._amp = np.concatenate([rest_amp, n0, n1])
        self._sort()
        self._prune()

    def Swap(self, q1: int, q2: int) -> None:
        if q1 == q2:
            return
        b1 = (self._idx >> q1) & 1
        b2 = (self._idx >> q2) & 1
        x = b1 ^ b2
        self._idx = self._idx ^ ((x << q1) | (x << q2))
        self._sort()

    def XMask(self, mask: int) -> None:
        if not mask:
            return
        self._idx = self._idx ^ np.int64(mask)
        self._sort()

    # ------------------------------------------------------------------
    # probability / measurement
    # ------------------------------------------------------------------

    def _probs_arr(self) -> np.ndarray:
        return self._amp.real ** 2 + self._amp.imag ** 2

    def Prob(self, q: int) -> float:
        self._check_qubit(q)
        bit = (self._idx >> q) & 1
        p = float(self._probs_arr()[bit == 1].sum())
        return min(max(p, 0.0), 1.0)

    def ProbMask(self, mask: int, perm: int) -> float:
        sel = (self._idx & mask) == perm
        return float(min(max(self._probs_arr()[sel].sum(), 0.0), 1.0))

    def ProbReg(self, start: int, length: int, perm: int) -> float:
        from ..utils.bits import bit_reg_mask

        return self.ProbMask(bit_reg_mask(start, length), perm << start)

    def ForceM(self, q: int, result: bool, do_force: bool = True, do_apply: bool = True) -> bool:
        p1 = self.Prob(q)
        if do_force:
            res = bool(result)
        elif p1 >= 1.0 - FP_NORM_EPSILON:
            res = True
        elif p1 <= FP_NORM_EPSILON:
            res = False
        else:
            res = self.Rand() <= p1
        nrm_sq = p1 if res else (1.0 - p1)
        if nrm_sq <= 0.0:
            raise RuntimeError("ForceM: forced result has zero probability")
        if do_apply:
            keep = (((self._idx >> q) & 1) == 1) == res
            self._idx = self._idx[keep]
            self._amp = self._amp[keep] / math.sqrt(nrm_sq)
        return res

    def MAll(self) -> int:
        p = self._probs_arr()
        pick = int(self.rng.choice_from_probs(p, 1)[0])
        result = int(self._idx[pick])
        self.SetPermutation(result)
        return result

    def MultiShotMeasureMask(self, q_powers, shots: int) -> dict:
        from ..utils.bits import log2

        p = self._probs_arr()
        draws = self.rng.choice_from_probs(p, shots)
        bits = [log2(int(pw)) for pw in q_powers]
        out: dict = {}
        for d in draws:
            i = int(self._idx[int(d)])
            key = 0
            for j, b in enumerate(bits):
                if (i >> b) & 1:
                    key |= 1 << j
            out[key] = out.get(key, 0) + 1
        return out

    # ------------------------------------------------------------------
    # ALU: forward index maps (reuse the kernel algebra with negated
    # operands — the reference mirrors this relationship between its
    # gather kernels and the sparse map update)
    # ------------------------------------------------------------------

    def INC(self, to_add: int, start: int, length: int) -> None:
        if not length:
            return
        self._idx = alu.inc_src(np, self._idx, -(to_add), start, length)
        self._sort()

    def CINC(self, to_add: int, start: int, length: int, controls) -> None:
        controls = tuple(controls)
        if not controls:
            return self.INC(to_add, start, length)
        perm = (1 << len(controls)) - 1
        self._idx = alu.inc_src(np, self._idx, -(to_add), start, length, controls, perm)
        self._sort()

    def INCDECC(self, to_add: int, start: int, length: int, carry_index: int) -> None:
        self._idx = alu.incdecc_src(np, self._idx, -(to_add), start, length, carry_index)
        self._sort()

    def ROL(self, shift: int, start: int, length: int) -> None:
        if length < 2 or not (shift % length):
            return
        self._idx = alu.rol_src(np, self._idx, length - (shift % length), start, length)
        self._sort()

    def ROR(self, shift: int, start: int, length: int) -> None:
        self.ROL(length - (shift % length) if length else 0, start, length)

    def Hash(self, start: int, length: int, values) -> None:
        tbl = np.asarray(values, dtype=np.int64)
        self._idx = alu.hash_src(np, self._idx, start, length, tbl)
        self._sort()

    def PhaseFlipIfLess(self, greater_perm: int, start: int, length: int) -> None:
        v = (self._idx >> start) & ((1 << length) - 1)
        self._amp = np.where(v < greater_perm, -self._amp, self._amp)

    # -- out-of-place arithmetic as forward maps over the nonzero list
    #    (reference kernels mul/div/*modnout, qheader_alu.cl; amplitudes
    #    outside the contract subspace are dropped, per reference) -----

    def _ctrl_keep(self, controls):
        if not controls:
            return np.ones_like(self._idx, dtype=bool)
        cmask = 0
        for c in controls:
            cmask |= 1 << c
        return (self._idx & cmask) == cmask

    def _apply_oop(self, fire, keep, new_idx) -> None:
        """Entries where fire&keep map to new_idx; fire&~keep drop;
        ~fire pass through."""
        ok = ~fire | keep
        idx = np.where(fire, new_idx, self._idx)[ok]
        amp = self._amp[ok]
        self._idx, self._amp = idx, amp
        self._sort()

    def MUL(self, to_mul: int, in_out_start: int, carry_start: int, length: int) -> None:
        self.CMUL(to_mul, in_out_start, carry_start, length, ())

    def CMUL(self, to_mul, in_out_start, carry_start, length, controls) -> None:
        if to_mul == 1 or not length:
            return
        lm = (1 << length) - 1
        fire = self._ctrl_keep(tuple(controls))
        x = (self._idx >> in_out_start) & lm
        c = (self._idx >> carry_start) & lm
        prod = x * int(to_mul)
        ni = alu._reg_set(np, self._idx, in_out_start, length, prod & lm)
        ni = alu._reg_set(np, ni, carry_start, length, (prod >> length) & lm)
        self._apply_oop(fire, c == 0, ni)

    def DIV(self, to_div: int, in_out_start: int, carry_start: int, length: int) -> None:
        self.CDIV(to_div, in_out_start, carry_start, length, ())

    def CDIV(self, to_div, in_out_start, carry_start, length, controls) -> None:
        if to_div == 1 or not length:
            return
        lm = (1 << length) - 1
        fire = self._ctrl_keep(tuple(controls))
        x = (self._idx >> in_out_start) & lm
        c = (self._idx >> carry_start) & lm
        combined = (c << length) | x
        keep = (combined % int(to_div)) == 0
        q = combined // int(to_div)
        keep &= q <= lm
        ni = alu._reg_set(np, self._idx, in_out_start, length, q & lm)
        ni = alu._reg_set(np, ni, carry_start, length, np.zeros_like(q))
        self._apply_oop(fire, keep, ni)

    def _mod_res(self, x, fn):
        ux, inv = np.unique(x, return_inverse=True)
        return np.asarray([fn(int(v)) for v in ux], dtype=np.int64)[inv]

    def _modnout(self, res_fn, mod_n, in_start, out_start, length, controls,
                 inverse: bool) -> None:
        ol = self._mod_out_length(mod_n)
        lm = (1 << length) - 1
        om = (1 << ol) - 1
        fire = self._ctrl_keep(tuple(controls))
        x = (self._idx >> in_start) & lm
        out = (self._idx >> out_start) & om
        res = self._mod_res(x, res_fn)
        if inverse:
            keep = out == res
            ni = alu._reg_set(np, self._idx, out_start, ol, np.zeros_like(res))
        else:
            keep = out == 0
            ni = alu._reg_set(np, self._idx, out_start, ol, res)
        self._apply_oop(fire, keep, ni)

    def MULModNOut(self, to_mul, mod_n, in_start, out_start, length) -> None:
        self._modnout(lambda v: (v * to_mul) % mod_n, mod_n,
                      in_start, out_start, length, (), False)

    def IMULModNOut(self, to_mul, mod_n, in_start, out_start, length) -> None:
        self._modnout(lambda v: (v * to_mul) % mod_n, mod_n,
                      in_start, out_start, length, (), True)

    def CMULModNOut(self, to_mul, mod_n, in_start, out_start, length, controls) -> None:
        self._modnout(lambda v: (v * to_mul) % mod_n, mod_n,
                      in_start, out_start, length, tuple(controls), False)

    def CIMULModNOut(self, to_mul, mod_n, in_start, out_start, length, controls) -> None:
        self._modnout(lambda v: (v * to_mul) % mod_n, mod_n,
                      in_start, out_start, length, tuple(controls), True)

    def POWModNOut(self, base, mod_n, in_start, out_start, length) -> None:
        self._modnout(lambda v: pow(base, v, mod_n), mod_n,
                      in_start, out_start, length, (), False)

    def CPOWModNOut(self, base, mod_n, in_start, out_start, length, controls) -> None:
        self._modnout(lambda v: pow(base, v, mod_n), mod_n,
                      in_start, out_start, length, tuple(controls), False)

    def IndexedLDA(self, index_start, index_length, value_start, value_length,
                   values, reset_value: bool = True) -> int:
        if reset_value:
            self.SetReg(value_start, value_length, 0)
        tbl = np.asarray(values, dtype=np.int64)
        # XOR-load is self-inverse, so the gather source map IS the
        # forward map
        self._idx = alu.indexed_lda_src(
            np, self._idx, index_start, index_length, value_start,
            value_length, tbl)
        self._sort()
        return int(round(self.ExpectationBitsAll(
            list(range(value_start, value_start + value_length)))))

    def IndexedADC(self, index_start, index_length, value_start, value_length,
                   carry_index, values) -> int:
        tbl = np.asarray(values, dtype=np.int64)
        self._idx = alu.indexed_adc_src(
            np, self._idx, index_start, index_length, value_start,
            value_length, carry_index, tbl, sign=-1)
        self._sort()
        return int(round(self.ExpectationBitsAll(
            list(range(value_start, value_start + value_length)))))

    def IndexedSBC(self, index_start, index_length, value_start, value_length,
                   carry_index, values) -> int:
        tbl = np.asarray(values, dtype=np.int64)
        self._idx = alu.indexed_adc_src(
            np, self._idx, index_start, index_length, value_start,
            value_length, carry_index, tbl, sign=1)
        self._sort()
        return int(round(self.ExpectationBitsAll(
            list(range(value_start, value_start + value_length)))))

    # ------------------------------------------------------------------
    # structure / state
    # ------------------------------------------------------------------

    def Compose(self, other, start: Optional[int] = None) -> int:
        if start is None:
            start = self.qubit_count
        if start != self.qubit_count:
            raise NotImplementedError("mid-insertion Compose on sparse engine")
        if self.qubit_count + other.qubit_count > 62:
            raise MemoryError("QEngineSparse indexes with int64 (<= 62 qubits)")
        if isinstance(other, QEngineSparse):
            oi, oa = other._idx, other._amp
        else:
            st = np.asarray(other.GetQuantumState())
            oi = np.nonzero(np.abs(st) > 1e-16)[0].astype(np.int64)
            oa = st[oi]
        self._idx = (self._idx[None, :] | (oi[:, None] << self.qubit_count)).reshape(-1)
        self._amp = (self._amp[None, :] * oa[:, None]).reshape(-1)
        self.qubit_count += other.qubit_count
        self._sort()
        self._prune()
        return start

    def Dispose(self, start: int, length: int, disposed_perm: Optional[int] = None) -> None:
        self._check_range(start, length)
        mask = ((1 << length) - 1) << start
        if disposed_perm is None:
            # qubits must be separable-deterministic: measure them out
            # (collapse leaves every entry agreeing on the disposed bits,
            # so the compaction below needs no projection)
            for i in range(length):
                self.M(start + i)
        else:
            keep = (self._idx & mask) == (disposed_perm << start)
            self._idx = self._idx[keep]
            self._amp = self._amp[keep]
            self.SparseRenorm()
        low = self._idx & ((1 << start) - 1)
        high = (self._idx >> (start + length)) << start
        self._idx = low | high
        self.qubit_count -= length
        self._sort()

    def Allocate(self, start: int, length: int = 1) -> int:
        if start < 0 or start > self.qubit_count:
            raise ValueError("Allocate start out of range")
        if self.qubit_count + length > 62:
            raise MemoryError("QEngineSparse indexes with int64 (<= 62 qubits)")
        low = self._idx & ((1 << start) - 1)
        high = (self._idx >> start) << (start + length)
        self._idx = low | high
        self.qubit_count += length
        return start

    def Decompose(self, start: int, dest) -> None:
        length = dest.qubit_count
        mask = ((1 << length) - 1) << start
        sub = (self._idx & mask) >> start
        # separable split: group by sub value; take dominant profile
        dense_sub = np.zeros(1 << length, dtype=np.complex128)
        np.add.at(dense_sub, sub, self._probs_arr())
        amps = np.sqrt(dense_sub.real)
        # recover phases from a representative entry per sub value
        for v in np.nonzero(amps)[0]:
            i = np.nonzero(sub == v)[0][0]
            ph = self._amp[i] / abs(self._amp[i])
            dense_sub[v] = amps[v] * ph
        dn = np.linalg.norm(dense_sub)
        if dn > 0:
            dense_sub = dense_sub / dn
        dest.SetQuantumState(dense_sub)
        # remainder: project onto the dominant sub value
        v0 = int(np.argmax(np.abs(dense_sub)))
        keep = sub == v0
        self._idx = self._idx[keep]
        self._amp = self._amp[keep]
        low = self._idx & ((1 << start) - 1)
        high = (self._idx >> (start + length)) << start
        self._idx = low | high
        self.qubit_count -= length
        self.SparseRenorm()
        self._sort()

    def GetAmplitude(self, perm: int) -> complex:
        pos = np.searchsorted(self._idx, perm)
        if pos < self._idx.shape[0] and self._idx[pos] == perm:
            return complex(self._amp[pos])
        return 0j

    def SetAmplitude(self, perm: int, amp: complex) -> None:
        pos = int(np.searchsorted(self._idx, perm))
        if pos < self._idx.shape[0] and self._idx[pos] == perm:
            self._amp[pos] = amp
        else:
            self._idx = np.insert(self._idx, pos, perm)
            self._amp = np.insert(self._amp, pos, amp)

    def GetQuantumState(self) -> np.ndarray:
        if self.qubit_count > 28:
            raise MemoryError("sparse state too wide to densify")
        out = np.zeros(1 << self.qubit_count, dtype=np.complex128)
        out[self._idx] = self._amp
        return out

    def SetQuantumState(self, state) -> None:
        st = np.asarray(state, dtype=np.complex128).reshape(-1)
        if st.shape[0] != (1 << self.qubit_count):
            raise ValueError("state length mismatch")
        nz = np.nonzero(np.abs(st) > 1e-16)[0]
        self._idx = nz.astype(np.int64)
        self._amp = st[nz]

    def SetPermutation(self, perm: int, phase=None) -> None:
        self._idx = np.array([perm], dtype=np.int64)
        self._amp = np.array([self._rand_phase() if phase is None else phase],
                             dtype=np.complex128)

    def Clone(self) -> "QEngineSparse":
        c = QEngineSparse(self.qubit_count, rng=self.rng.spawn(),
                          truncation_threshold=self.trunc,
                          max_entries=self.max_entries,
                          rand_global_phase=self.rand_global_phase)
        c._idx = self._idx.copy()
        c._amp = self._amp.copy()
        return c

    def SumSqrDiff(self, other) -> float:
        if isinstance(other, QEngineSparse):
            common, ia, ib = np.intersect1d(self._idx, other._idx,
                                            return_indices=True)
            inner = np.vdot(self._amp[ia], other._amp[ib])
        else:
            b = np.asarray(other.GetQuantumState(), dtype=np.complex128)
            inner = np.vdot(self._amp, b[self._idx])
        return float(max(0.0, 1.0 - abs(inner) ** 2))

    def GetProbs(self) -> np.ndarray:
        if self.qubit_count > 28:
            raise MemoryError("sparse state too wide to densify")
        out = np.zeros(1 << self.qubit_count, dtype=np.float64)
        out[self._idx] = self._probs_arr()
        return out

    def UpdateRunningNorm(self, norm_thresh: float = -1.0) -> None:
        self.running_norm = float(self._probs_arr().sum())

    def NormalizeState(self, nrm: float = -1.0, norm_thresh: float = -1.0,
                       phase_arg: float = 0.0) -> None:
        self.SparseRenorm()
        self.running_norm = 1.0

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py)
    # ------------------------------------------------------------------

    _ckpt_kind = "sparse"

    def _ckpt_capture(self, capture_child):
        return {"kind": "sparse",
                "meta": {"n": self.qubit_count, "trunc": float(self.trunc),
                         "max_entries": int(self.max_entries),
                         "running_norm": float(self.running_norm)},
                "arrays": {"idx": self._idx, "amp": self._amp}}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self.trunc = float(meta.get("trunc", self.trunc))
        self.max_entries = int(meta.get("max_entries", self.max_entries))
        self._idx = np.ascontiguousarray(arrays["idx"], dtype=np.int64)
        self._amp = np.ascontiguousarray(arrays["amp"], dtype=np.complex128)
        self.running_norm = float(meta.get("running_norm", 1.0))
