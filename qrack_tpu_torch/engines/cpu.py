"""QEngineCPU: dense state vector on host, the conformance oracle.

Re-design of the reference CPU engine (reference:
include/qengine_cpu.hpp:36; hot loop src/qengine/state.cpp:392-511
par_for_mask): the skip-bit strided loops become vectorized numpy index
algebra (deposit_indices == the par_for_mask index walk), SIMD complex2
math becomes numpy ufuncs. Default dtype is complex128 — this engine is
the accuracy oracle the BASELINE L2-parity metric compares against —
with complex64 available for width parity with the CUDA engine.

It runs on the host only: it takes no ``device``, and it runs only when
the caller names the ``cpu`` terminal, or inside QHybrid below its
width threshold (engines/hybrid.py).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..utils.bits import deposit_indices, control_offset
from .qengine import QEngine


class QEngineCPU(QEngine):
    _xp = np
    _tele_name = "cpu"

    def __init__(self, qubit_count: int, init_state: int = 0, dtype=np.complex128, **kwargs):
        if kwargs.pop("device", None) is not None:
            raise ValueError("QEngineCPU runs on the host and takes no device")
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        self._check_capacity(qubit_count)
        self.dtype = np.dtype(dtype)
        self._state = np.zeros(1 << qubit_count, dtype=self.dtype)
        self.SetPermutation(init_state)
        self._idx_cache: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _check_capacity(self, qubit_count: int) -> None:
        if qubit_count > self.config.max_cpu_qubits:
            raise MemoryError(
                f"QEngineCPU width {qubit_count} exceeds QRACK_MAX_CPU_QB="
                f"{self.config.max_cpu_qubits}"
            )

    @property
    def _idx(self) -> np.ndarray:
        if self._idx_cache is None or self._idx_cache.shape[0] != self._state.shape[0]:
            self._idx_cache = np.arange(self._state.shape[0], dtype=np.int64)
        return self._idx_cache

    def _rand_phase(self) -> complex:
        if self.rand_global_phase:
            ang = 2.0 * math.pi * self.Rand()
            return complex(math.cos(ang), math.sin(ang))
        return 1.0 + 0.0j

    # ------------------------------------------------------------------
    # kernel contract
    # ------------------------------------------------------------------

    def _k_apply_2x2(self, m2, target, controls, perm) -> None:
        n = self.qubit_count
        skip = [target] + list(controls)
        base = deposit_indices(n, skip)
        base = base | control_offset(controls, perm)
        i1 = base | (1 << target)
        a0 = self._state[base]
        a1 = self._state[i1]
        m = m2.astype(self.dtype)
        self._state[base] = m[0, 0] * a0 + m[0, 1] * a1
        self._state[i1] = m[1, 0] * a0 + m[1, 1] * a1

    def _k_apply_diag(self, d0, d1, target, controls, perm) -> None:
        n = self.qubit_count
        skip = [target] + list(controls)
        base = deposit_indices(n, skip)
        base = base | control_offset(controls, perm)
        if abs(d0 - 1.0) > 1e-15:
            self._state[base] *= self.dtype.type(d0)
        if abs(d1 - 1.0) > 1e-15:
            i1 = base | (1 << target)
            self._state[i1] *= self.dtype.type(d1)

    def _k_apply_4x4(self, m4, q1, q2) -> None:
        n = self.qubit_count
        base = deposit_indices(n, [q1, q2])
        p1, p2 = 1 << q1, 1 << q2
        rows = [base, base | p1, base | p2, base | p1 | p2]
        amps = [self._state[r] for r in rows]
        m = m4.astype(self.dtype)
        for r_i, row in enumerate(rows):
            acc = m[r_i, 0] * amps[0]
            for c_i in range(1, 4):
                if m[r_i, c_i] != 0:
                    acc = acc + m[r_i, c_i] * amps[c_i]
            self._state[row] = acc

    def _k_gather(self, src_fn, split=None) -> None:
        self._state = self._state[src_fn(self._idx)]

    def _k_out_of_place(self, src_idx, dst_idx, passthrough_cmask) -> None:
        new = np.zeros_like(self._state)
        if passthrough_cmask is not None:
            keep = (self._idx & passthrough_cmask) != passthrough_cmask
            new[keep] = self._state[keep]
        new[dst_idx] = self._state[src_idx]
        self._state = new

    def _k_phase_fn(self, fn, split=None) -> None:
        fre, fim = fn(np, self._idx)
        if np.isscalar(fim) and fim == 0.0:
            # pure-real factor (Z/phase flips): skip the complex promote
            self._state = (self._state * fre).astype(self.dtype, copy=False)
        else:
            self._state = (self._state * (np.asarray(fre) + 1j * np.asarray(fim))).astype(
                self.dtype, copy=False)

    def _k_probs(self) -> np.ndarray:
        return (self._state.real.astype(np.float64) ** 2
                + self._state.imag.astype(np.float64) ** 2)

    def _k_prob_mask(self, mask, perm) -> float:
        sel = (self._idx & mask) == perm
        p = self._k_probs()[sel].sum()
        return float(min(max(p, 0.0), 1.0))

    def _k_collapse(self, mask, val, nrm_sq) -> None:
        sel = (self._idx & mask) == val
        nrm = 1.0 / math.sqrt(nrm_sq)
        self._state = np.where(sel, self._state * self.dtype.type(nrm),
                               np.zeros((), dtype=self.dtype))

    def _k_compose(self, other, start) -> None:
        n, m = self.qubit_count, other.qubit_count
        other_state = np.asarray(other.GetQuantumState(), dtype=self.dtype)
        if start == n:
            self._state = np.kron(other_state, self._state)
            return
        from ..utils.states import compose_states

        self._state = compose_states(self._state, other_state, n, m, start).astype(self.dtype)

    def _split_matrix(self, start, length) -> np.ndarray:
        """Reshape ket to M[remainder, dest] for dest = [start, start+length)."""
        n = self.qubit_count
        t = self._state.reshape((2,) * n)
        dest_axes = [n - 1 - q for q in range(start + length - 1, start - 1, -1)]
        rem_axes = [a for a in range(n) if a not in dest_axes]
        tt = np.transpose(t, rem_axes + dest_axes)
        return tt.reshape(1 << (n - length), 1 << length)

    def _k_decompose(self, start, length) -> np.ndarray:
        m = self._split_matrix(start, length)
        row_norms = (np.abs(m) ** 2).sum(axis=1)
        r0 = int(np.argmax(row_norms))
        dest = m[r0] / math.sqrt(row_norms[r0])
        rem = m @ np.conj(dest)
        nrm = np.linalg.norm(rem)
        if nrm > 0:
            rem = rem / nrm
        self._state = rem.astype(self.dtype)
        self._idx_cache = None
        return dest.astype(self.dtype)

    def _k_dispose(self, start, length, perm) -> None:
        m = self._split_matrix(start, length)
        if perm is not None:
            rem = m[:, perm]
        else:
            row_norms = (np.abs(m) ** 2).sum(axis=1)
            r0 = int(np.argmax(row_norms))
            dest = m[r0] / math.sqrt(row_norms[r0])
            rem = m @ np.conj(dest)
        nrm = np.linalg.norm(rem)
        if nrm > 0:
            rem = rem / nrm
        self._state = rem.astype(self.dtype)
        self._idx_cache = None

    def _k_allocate(self, start, length) -> None:
        n = self.qubit_count
        new = np.zeros(1 << (n + length), dtype=self.dtype)
        pos = deposit_indices(n + length, list(range(start, start + length)))
        new[pos] = self._state
        self._state = new
        self._idx_cache = None

    def _k_normalize(self, nrm_sq) -> None:
        self._state = self._state / self.dtype.type(math.sqrt(nrm_sq))

    def _k_sum_sqr_diff(self, other) -> float:
        # phase-invariant: 1 - |<a|b>|^2, matching the reference
        # (src/qengine/state.cpp SumSqrDiff returns 1 - norm(inner))
        a = self._state.astype(np.complex128)
        b = np.asarray(other.GetQuantumState(), dtype=np.complex128)
        inner = np.vdot(a, b)
        return float(max(0.0, 1.0 - abs(inner) ** 2))

    def _k_swap_bits(self, q1, q2) -> None:
        p1, p2 = 1 << q1, 1 << q2

        def src(idx):
            b1 = (idx >> q1) & 1
            b2 = (idx >> q2) & 1
            x = b1 ^ b2
            return idx ^ ((x << q1) | (x << q2))

        self._k_gather(src)

    # ------------------------------------------------------------------
    # state access
    # ------------------------------------------------------------------

    def GetQuantumState(self) -> np.ndarray:
        return self._state.copy()

    def SetQuantumState(self, state) -> None:
        st = np.asarray(state, dtype=self.dtype).reshape(-1)
        if st.shape[0] != (1 << self.qubit_count):
            raise ValueError("state length mismatch")
        self._state = st.copy()

    def GetAmplitude(self, perm: int) -> complex:
        return complex(self._state[perm])

    def SetAmplitude(self, perm: int, amp: complex) -> None:
        self._state[perm] = amp

    def SetPermutation(self, perm: int, phase=None) -> None:
        self._state = np.zeros(1 << self.qubit_count, dtype=self.dtype)
        self._state[perm] = self._rand_phase() if phase is None else phase
        self.running_norm = 1.0

    def Clone(self) -> "QEngineCPU":
        c = QEngineCPU(
            self.qubit_count,
            dtype=self.dtype,
            rng=self.rng.spawn(),
            do_normalize=self.do_normalize,
            rand_global_phase=self.rand_global_phase,
        )
        c._state = self._state.copy()
        return c

    def CloneEmpty(self) -> "QEngineCPU":
        return QEngineCPU(
            self.qubit_count,
            dtype=self.dtype,
            rng=self.rng.spawn(),
            do_normalize=self.do_normalize,
            rand_global_phase=self.rand_global_phase,
        )

    # -- cross-engine data plane --

    def ZeroAmplitudes(self) -> None:
        self._state[:] = 0

    def IsZeroAmplitude(self) -> bool:
        return not np.any(self._state)

    def GetAmplitudePage(self, offset: int, length: int) -> np.ndarray:
        return self._state[offset:offset + length].copy()

    def SetAmplitudePage(self, page, offset: int) -> None:
        self._state[offset:offset + len(page)] = np.asarray(page, dtype=self.dtype)

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py)
    # ------------------------------------------------------------------

    _ckpt_kind = "cpu"

    def _ckpt_capture(self, capture_child):
        return {"kind": "cpu",
                "meta": {"n": self.qubit_count, "dtype": str(self.dtype),
                         "running_norm": float(self.running_norm)},
                "arrays": {"ket": self._state}}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self.dtype = np.dtype(meta["dtype"])
        self._state = np.ascontiguousarray(arrays["ket"], dtype=self.dtype)
        self.running_norm = float(meta.get("running_norm", 1.0))
        self._idx_cache = None
