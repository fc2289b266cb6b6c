"""QStabilizer: Aaronson–Gottesman CHP tableau simulator.

Re-design of the reference's extended CHP engine (reference:
include/qstabilizer.hpp:49-77 — x/z/r bit matrices + amplitude
extraction via cached Gaussian elimination; gates
src/qstabilizer.cpp:944-1610; ForceM :1999). Implementation is
vectorized numpy over uint8 bit matrices (tableaus are tiny next to
kets — clarity and row-op vectorization beat bit packing at these
sizes; the hot ops are O(n) column ops over 2n+1 rows).

Clifford-only by contract: MCMtrxPerm raises CliffordError for any
non-Clifford payload, which is the signal QStabilizerHybrid uses to
buffer/switch (reference: src/qstabilizerhybrid.cpp:206-239).

Phase note: with `rand_global_phase=False` the global phase is tracked
through EVERY tableau primitive (H/S/X/Y/Z/CNOT/collapse), so amplitude
streams match the dense oracle exactly (reference: per-gate phaseOffset
updates, src/qstabilizer.cpp:944-1010 and the AmplitudeEntry pattern at
:1193). Mechanism here is independent: after each primitive the true
amplitude at the new canonical seed state is computed from one or two
pre-gate amplitudes (poly-time single-amplitude closure over the
canonical form — stabilizer rows commute, so generator order is free),
and `phase_offset` absorbs the difference from the extraction's
+real-seed convention. With the default `rand_global_phase=True` none
of this runs (matching the reference's randGlobalPhase fast path).

Port note: a copy of the JAX package's layers/stabilizer.py.  The
tableau stays numpy uint8 on the host and the hot loops run through the
port's own build of native/tableau.cpp, with the same Python fallback;
the ``qrack_tpu-stabilizer v1`` text file format is kept byte for byte,
so a tableau saved by either package loads in the other, as does a
checkpoint (``_ckpt_*``, kind ``"stabilizer"``).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..interface import QInterface
from ..native import get_tableau_lib
from .. import matrices as mat


def _as_u8p(arr):
    import ctypes

    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class CliffordError(Exception):
    """Raised when a non-Clifford operation reaches the tableau."""


def _iphase(v) -> Optional[int]:
    """p with v == i^p (p in 0..3), or None."""
    for p in range(4):
        if abs(v - 1j ** p) < 1e-8:
            return p
    return None


# ---------------------------------------------------------------------------
# single-qubit Clifford recognition: matrix -> H/S sequence
# ---------------------------------------------------------------------------

_CLIFFORD_SEQS: Optional[dict] = None


def _phase_normalize(m: np.ndarray) -> Optional[np.ndarray]:
    flat = m.reshape(-1)
    nz = None
    for v in flat:
        if abs(v) > 1e-8:
            nz = v
            break
    if nz is None:
        return None
    return m * (abs(nz) / nz)


def _bucket(m: np.ndarray) -> tuple:
    return tuple(np.round(m.reshape(-1) * 4).astype(np.complex128).view(np.float64).round(1))


def clifford_sequence(m: np.ndarray) -> Optional[str]:
    """Return an 'H'/'S' op string realizing m up to global phase, or None.

    Coarse-bucket dict narrows candidates; an exact allclose comparison
    confirms (coarse keys alone collide with near-Clifford rotations)."""
    global _CLIFFORD_SEQS
    if _CLIFFORD_SEQS is None:
        table: dict = {}

        def add(u, seq):
            cn = _phase_normalize(u)
            b = _bucket(cn)
            bucketed = table.setdefault(b, [])
            for (u0, _) in bucketed:
                if np.allclose(u0, cn, atol=1e-9):
                    return False
            bucketed.append((cn, seq))
            return True

        frontier = [("", mat.I2)]
        add(mat.I2, "")
        while frontier:
            nxt = []
            for (seq, u) in frontier:
                if len(seq) > 7:
                    continue
                for (g, gm) in (("H", mat.H2), ("S", mat.S2)):
                    u2 = gm @ u
                    if add(u2, seq + g):
                        nxt.append((seq + g, u2))
            frontier = nxt
        _CLIFFORD_SEQS = table
    cn = _phase_normalize(np.asarray(m, dtype=np.complex128))
    if cn is None:
        return None
    for (u0, seq) in _CLIFFORD_SEQS.get(_bucket(cn), ()):
        if np.allclose(u0, cn, atol=1e-8):
            return seq
    return None


class QStabilizer(QInterface):
    def __init__(self, qubit_count: int, init_state: int = 0, **kwargs):
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        n = qubit_count
        # rows 0..n-1 destabilizers, n..2n-1 stabilizers, 2n scratch
        self.x = np.zeros((2 * n + 1, n), dtype=np.uint8)
        self.z = np.zeros((2 * n + 1, n), dtype=np.uint8)
        self.r = np.zeros(2 * n + 1, dtype=np.uint8)
        self.phase_offset: complex = 1.0 + 0j
        self._phase_paused = 0
        for i in range(n):
            self.x[i, i] = 1          # destabilizer X_i
            self.z[n + i, i] = 1      # stabilizer Z_i
        if init_state:
            with self._phase_freeze():
                for q in range(n):
                    if (init_state >> q) & 1:
                        self._x_gate(q)

    # ------------------------------------------------------------------
    # per-gate global-phase tracking (see module docstring)
    # ------------------------------------------------------------------

    @property
    def _track_phase(self) -> bool:
        return not self.rand_global_phase and not self._phase_paused

    @contextmanager
    def _phase_freeze(self):
        """Suspend tracking around net-identity conjugations and the
        constructors that set phase_offset explicitly."""
        self._phase_paused += 1
        try:
            yield
        finally:
            self._phase_paused -= 1

    @classmethod
    def _row_mul_into(cls, x, z, r, h, i) -> None:
        """Phase-tracked CHP row multiply: row h *= row i (the single
        source of the rowsum sign algebra for every elimination here)."""
        phase = 2 * int(r[h]) + 2 * int(r[i]) + int(
            cls._g_vec(x[i], z[i], x[h], z[h]).sum())
        r[h] = 1 if (phase % 4) == 2 else 0
        x[h] ^= x[i]
        z[h] ^= z[i]

    def _amp_closure(self, canon=None):
        """Single-amplitude oracle over the CURRENT state: perm -> the
        complex amplitude up to the (positive) norm factor, 0 outside
        the support. O(k*n) per query via the canonical form; the
        stabilizer group is abelian, so generator product order is
        immaterial.  `canon` reuses a precomputed _canonical_stab()."""
        n = self.qubit_count
        x, z, r, k = self._canonical_stab() if canon is None else canon
        v0 = self._seed_state(x, z, r, k)
        pivots = [int(np.nonzero(x[j])[0][0]) for j in range(k)]
        po = self.phase_offset

        def amp(perm: int) -> complex:
            d = perm ^ v0
            cur_x = np.zeros(n, dtype=np.uint8)
            cur_z = np.zeros(n, dtype=np.uint8)
            ph = 0
            for j in range(k):
                if (d >> pivots[j]) & 1:
                    ph += 2 * int(r[j]) + int(
                        self._g_vec(x[j], z[j], cur_x, cur_z).sum())
                    cur_x ^= x[j]
                    cur_z ^= z[j]
            rem = d
            for c in np.nonzero(cur_x)[0]:
                rem ^= 1 << int(c)
            if rem:
                return 0j  # not in the support coset
            zdot = 0
            for c in np.nonzero(cur_z)[0]:
                zdot ^= (v0 >> int(c)) & 1
            y_count = int(np.count_nonzero(cur_x & cur_z))
            return po * (1j ** ((ph + 2 * zdot + y_count) % 4))

        return amp

    def _phase_track(self, update, true_amp) -> None:
        """Run a tableau `update`; then set phase_offset so extraction
        reproduces the physical state: `true_amp(old_amp, v0_new)` gives
        the post-gate amplitude at the new canonical seed in terms of
        pre-gate amplitudes, and the raw extraction there is +norm by
        construction, so the offset is exactly that amplitude's phase."""
        old = self._amp_closure()
        update()
        x, z, r, k = self._canonical_stab()
        v0 = self._seed_state(x, z, r, k)
        t = complex(true_amp(old, v0))
        a = abs(t)
        if a > 1e-12:
            self.phase_offset = t / a

    # ------------------------------------------------------------------
    # tableau primitives (reference: src/qstabilizer.cpp:944-1610)
    # ------------------------------------------------------------------

    def _cnot(self, c: int, t: int) -> None:
        def upd():
            x, z, r = self.x, self.z, self.r
            r ^= x[:, c] & z[:, t] & (x[:, t] ^ z[:, c] ^ 1)
            x[:, t] ^= x[:, c]
            z[:, c] ^= z[:, t]

        if not self._track_phase:
            return upd()
        self._phase_track(
            upd, lambda old, w: old(w ^ (((w >> c) & 1) << t)))

    def _h_gate(self, q: int) -> None:
        def upd():
            x, z, r = self.x, self.z, self.r
            r ^= x[:, q] & z[:, q]
            tmp = x[:, q].copy()
            x[:, q] = z[:, q]
            z[:, q] = tmp

        if not self._track_phase:
            return upd()
        m = 1 << q
        self._phase_track(
            upd,
            lambda old, w: (old(w & ~m) + old(w | m)) if not (w >> q) & 1
            else (old(w & ~m) - old(w | m)))

    def _s_gate(self, q: int) -> None:
        def upd():
            x, z, r = self.x, self.z, self.r
            r ^= x[:, q] & z[:, q]
            z[:, q] ^= x[:, q]

        if not self._track_phase:
            return upd()
        self._phase_track(
            upd, lambda old, w: old(w) * (1j if (w >> q) & 1 else 1.0))

    def _x_gate(self, q: int) -> None:
        if not self._track_phase:
            self.r ^= self.z[:, q]
            return
        self._phase_track(
            lambda: self.r.__ixor__(self.z[:, q]),
            lambda old, w: old(w ^ (1 << q)))

    def _z_gate(self, q: int) -> None:
        if not self._track_phase:
            self.r ^= self.x[:, q]
            return
        self._phase_track(
            lambda: self.r.__ixor__(self.x[:, q]),
            lambda old, w: old(w) * (-1.0 if (w >> q) & 1 else 1.0))

    def _y_gate(self, q: int) -> None:
        if not self._track_phase:
            self.r ^= self.x[:, q] ^ self.z[:, q]
            return
        self._phase_track(
            lambda: self.r.__ixor__(self.x[:, q] ^ self.z[:, q]),
            lambda old, w: old(w ^ (1 << q)) * (1j if (w >> q) & 1 else -1j))

    def _apply_seq(self, seq: str, q: int) -> None:
        for g in seq:
            if g == "H":
                self._h_gate(q)
            else:
                self._s_gate(q)

    @staticmethod
    def _g_vec(x1, z1, x2, z2):
        """Vectorized AG exponent function g (per column), values in
        {-1, 0, 1}."""
        x1 = x1.astype(np.int8)
        z1 = z1.astype(np.int8)
        x2 = x2.astype(np.int8)
        z2 = z2.astype(np.int8)
        out = np.zeros_like(x1)
        both = (x1 == 1) & (z1 == 1)
        out = np.where(both, z2 - x2, out)
        xonly = (x1 == 1) & (z1 == 0)
        out = np.where(xonly, z2 * (2 * x2 - 1), out)
        zonly = (x1 == 0) & (z1 == 1)
        out = np.where(zonly, x2 * (1 - 2 * z2), out)
        return out

    def _rowsum(self, h: int, i: int) -> None:
        """Row h *= row i (Pauli product with sign bookkeeping)."""
        self._row_mul_into(self.x, self.z, self.r, h, i)

    # ------------------------------------------------------------------
    # QInterface primitive contract
    # ------------------------------------------------------------------

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        self._check_qubit(target)
        controls = tuple(controls)
        m = np.asarray(mtrx, dtype=np.complex128).reshape(2, 2)
        if not controls:
            seq = clifford_sequence(m)
            if seq is None:
                raise CliffordError(f"non-Clifford 1q gate on {target}")
            if self._track_phase:
                # one composite tracking pass over the whole H/S
                # sequence, with the true amplitude map taken from m
                # itself — this also folds m's global phase, which the
                # sequence only realizes up to a factor (reference:
                # SetPhaseOffset(... + arg(mtrx0)) per recognized gate,
                # src/qstabilizer.cpp:2770-2891)
                mk = 1 << target

                def upd():
                    with self._phase_freeze():
                        self._apply_seq(seq, target)

                self._phase_track(
                    upd,
                    lambda old, w: (m[(w >> target) & 1, 0] * old(w & ~mk)
                                    + m[(w >> target) & 1, 1] * old(w | mk)))
                return
            self._apply_seq(seq, target)
            return
        if len(controls) > 1:
            raise CliffordError("multiply-controlled gate on a tableau")
        c = controls[0]
        anti = perm == 0
        if anti:
            self._x_gate(c)
        try:
            # any controlled monomial with entries in {±1, ±i} whose
            # entry ratio is ±1 is Clifford: diag(1,1,d0,d1) =
            # [diag(1,d0) on c] · CZ^[(d1/d0)==-1], and an invert is
            # that times CNOT (covers CX/CY/CZ and the phased variants
            # QUnit link resolution emits; reference enumerates these
            # case-by-case, src/qstabilizer.cpp:2770-2891)
            if mat.is_phase(m):
                self._ctrl_diag(c, target, m[0, 0], m[1, 1])
            elif mat.is_invert(m):
                self._ctrl_diag(c, target, m[1, 0], m[0, 1])
                self._cnot(c, target)
            else:
                raise CliffordError("non-Clifford controlled gate")
        finally:
            if anti:
                self._x_gate(c)

    def _ctrl_diag(self, c: int, t: int, d0: complex, d1: complex) -> None:
        """Apply diag(1,1,d0,d1) over (control c, target t)."""
        p0 = _iphase(d0)
        p1 = _iphase(d1)
        if p0 is None or p1 is None or (p1 - p0) % 2:
            raise CliffordError("non-Clifford controlled phase")
        for _ in range(p0 % 4):
            self._s_gate(c)
        if (p1 - p0) % 4 == 2:
            self._h_gate(t)
            self._cnot(c, t)
            self._h_gate(t)

    # fast paths used heavily by layers
    def H(self, q: int) -> None:
        self._check_qubit(q)
        self._h_gate(q)

    def S(self, q: int) -> None:
        self._s_gate(q)

    def IS(self, q: int) -> None:
        self._s_gate(q)
        self._s_gate(q)
        self._s_gate(q)

    def X(self, q: int) -> None:
        self._x_gate(q)

    def Y(self, q: int) -> None:
        self._y_gate(q)

    def Z(self, q: int) -> None:
        self._z_gate(q)

    def CNOT(self, c: int, t: int) -> None:
        self._cnot(c, t)

    def CZ(self, c: int, t: int) -> None:
        def upd():
            with self._phase_freeze():
                self._h_gate(t)
                self._cnot(c, t)
                self._h_gate(t)

        if not self._track_phase:
            return upd()
        # one tracking pass over the composite (diagonal: -1 on |11>)
        m = (1 << c) | (1 << t)
        self._phase_track(
            upd, lambda old, w: old(w) * (-1.0 if (w & m) == m else 1.0))

    def Swap(self, q1: int, q2: int) -> None:
        if q1 == q2:
            return

        def upd():
            with self._phase_freeze():
                self._cnot(q1, q2)
                self._cnot(q2, q1)
                self._cnot(q1, q2)

        if not self._track_phase:
            return upd()

        def true_amp(old, w):
            b1, b2 = (w >> q1) & 1, (w >> q2) & 1
            if b1 != b2:
                w ^= (1 << q1) | (1 << q2)
            return old(w)

        self._phase_track(upd, true_amp)

    def PermuteQubits(self, perm) -> None:
        """Relabel qubits: new column j holds old column perm[j].  A pure
        column permutation of the x/z bit matrices — no sign changes, so
        far cheaper than chains of Swap (3 CNOTs each)."""
        perm = np.asarray(perm, dtype=np.intp)
        if perm.shape[0] != self.qubit_count:
            raise ValueError("permutation length mismatch")

        def upd():
            self.x = np.ascontiguousarray(self.x[:, perm])
            self.z = np.ascontiguousarray(self.z[:, perm])

        if not self._track_phase:
            return upd()

        def true_amp(old, w):
            # new bit j holds old bit perm[j]
            old_w = 0
            for j in range(perm.shape[0]):
                old_w |= ((w >> j) & 1) << int(perm[j])
            return old(old_w)

        self._phase_track(upd, true_amp)

    def IsSeparable(self, q: int) -> bool:
        """Separable from the rest in some single-qubit basis
        (reference: QStabilizer::IsSeparable)."""
        return self.IsSeparableZ(q) or self.IsSeparableX(q) or self.IsSeparableY(q)

    def EntangledWith(self, q: int, lo: int, hi: int) -> bool:
        """Conservative check: does qubit q share a generator-support
        connected component with any qubit in [lo, hi)?  False means q
        is provably uncorrelated with that range; True may
        over-approximate (generator support can exceed entanglement)."""
        n = self.qubit_count
        sup = (self.x[n:2 * n] | self.z[n:2 * n]).astype(bool)  # (n gens, n qubits)
        comp = np.zeros(n, dtype=bool)
        comp[q] = True
        while True:
            rows = sup[:, comp].any(axis=1)
            new = sup[rows].any(axis=0) | comp
            if new[lo:hi].any():
                return True
            if (new == comp).all():
                return False
            comp = new

    # ------------------------------------------------------------------
    # measurement (reference: src/qstabilizer.cpp:1999 ForceM)
    # ------------------------------------------------------------------

    def _find_random_row(self, q: int) -> Optional[int]:
        n = self.qubit_count
        hits = np.nonzero(self.x[n:2 * n, q])[0]
        return (int(hits[0]) + n) if hits.size else None

    def Prob(self, q: int) -> float:
        self._check_qubit(q)
        lib = get_tableau_lib()
        if lib is not None and self.x.flags["C_CONTIGUOUS"]:
            if not lib.tb_is_separable_z(_as_u8p(self.x), self.qubit_count, q):
                return 0.5
        elif self._find_random_row(q) is not None:
            return 0.5
        return 1.0 if self._deterministic_outcome(q) else 0.0

    def _deterministic_outcome(self, q: int) -> bool:
        n = self.qubit_count
        self.x[2 * n] = 0
        self.z[2 * n] = 0
        self.r[2 * n] = 0
        for i in range(n):
            if self.x[i, q]:
                self._rowsum(2 * n, i + n)
        return bool(self.r[2 * n])

    def ForceM(self, q: int, result: bool, do_force: bool = True, do_apply: bool = True) -> bool:
        self._check_qubit(q)
        n = self.qubit_count
        # projective collapse preserves surviving amplitudes up to the
        # positive renormalization, so the tracked phase update is the
        # identity map on the new seed (reference: post-measurement
        # AmplitudeEntry fix, src/qstabilizer.cpp:2623)
        old = (self._amp_closure()
               if (self._track_phase and do_apply
                   and self._find_random_row(q) is not None) else None)
        lib = get_tableau_lib()
        if (lib is not None and self.x.flags["C_CONTIGUOUS"]
                and self.z.flags["C_CONTIGUOUS"]):
            rand_bit = 0
            if not do_force and self._find_random_row(q) is not None:
                rand_bit = 1 if self.Rand() < 0.5 else 0
            out = lib.tb_force_m(_as_u8p(self.x), _as_u8p(self.z), _as_u8p(self.r),
                                 n, q, 1 if result else 0,
                                 1 if do_force else 0, 1 if do_apply else 0,
                                 rand_bit)
            if out < 0:
                raise RuntimeError("ForceM: forced result has zero probability")
            if old is not None:
                self._phase_fix(old)
            return bool(out)
        p = self._find_random_row(q)
        if p is None:
            out = self._deterministic_outcome(q)
            if do_force and bool(result) != out:
                raise RuntimeError("ForceM: forced result has zero probability")
            return out
        out = bool(result) if do_force else (self.Rand() < 0.5)
        if not do_apply:
            return out
        for i in range(2 * n):
            if i != p and self.x[i, q]:
                self._rowsum(i, p)
        self.x[p - n] = self.x[p]
        self.z[p - n] = self.z[p]
        self.r[p - n] = self.r[p]
        self.x[p] = 0
        self.z[p] = 0
        self.z[p, q] = 1
        self.r[p] = 1 if out else 0
        if old is not None:
            self._phase_fix(old)
        return out

    def _phase_fix(self, old) -> None:
        """Re-anchor phase_offset after a state change whose amplitude
        map is the identity on surviving support states."""
        x, z, r, k = self._canonical_stab()
        v0 = self._seed_state(x, z, r, k)
        t = complex(old(v0))
        a = abs(t)
        if a > 1e-12:
            self.phase_offset = t / a

    # ------------------------------------------------------------------
    # amplitudes (reference: GetAmplitude + gaussianCached,
    # include/qstabilizer.hpp:55-60)
    # ------------------------------------------------------------------

    def _canonical_stab(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Gaussian-eliminated copy of the stabilizer block."""
        n = self.qubit_count
        # MUST be copies: ascontiguousarray on a contiguous slice returns
        # an aliasing view, and canonicalization would corrupt the live
        # stabilizer rows against their destabilizer pairs
        x = self.x[n:2 * n].copy()
        z = self.z[n:2 * n].copy()
        r = self.r[n:2 * n].copy()
        lib = get_tableau_lib()
        if lib is not None:
            x_rank = int(lib.tb_canonical(_as_u8p(x), _as_u8p(z), _as_u8p(r), n))
            return x, z, r, x_rank

        def mul_into(h, i):
            self._row_mul_into(x, z, r, h, i)

        row = 0
        for col in range(n):  # X part first
            piv = None
            for i in range(row, n):
                if x[i, col]:
                    piv = i
                    break
            if piv is None:
                continue
            if piv != row:
                for arr in (x, z):
                    arr[[row, piv]] = arr[[piv, row]]
                r[[row, piv]] = r[[piv, row]]
            for i in range(n):
                if i != row and x[i, col]:
                    mul_into(i, row)
            row += 1
        x_rank = row
        for col in range(n):  # then Z part below
            piv = None
            for i in range(row, n):
                if z[i, col]:
                    piv = i
                    break
            if piv is None:
                continue
            if piv != row:
                for arr in (x, z):
                    arr[[row, piv]] = arr[[piv, row]]
                r[[row, piv]] = r[[piv, row]]
            for i in range(row, n):
                if i != row and z[i, col]:
                    mul_into(i, row)
            row += 1
        return x, z, r, x_rank

    def _seed_state(self, x, z, r, x_rank) -> int:
        """One support basis state: satisfy the Z-only generators."""
        n = self.qubit_count
        v = 0
        # Z-only rows (x_rank..n): r == (z·v mod 2); solve greedily using
        # each row's pivot column
        for i in range(n - 1, x_rank - 1, -1):
            cols = np.nonzero(z[i])[0]
            if cols.size == 0:
                continue
            piv = int(cols[0])
            par = 0
            for c in cols[1:]:
                par ^= (v >> int(c)) & 1
            want = int(r[i])
            if par != want:
                v |= 1 << piv
        return v

    def GetQuantumState(self) -> np.ndarray:
        n = self.qubit_count
        x, z, r, k = self._canonical_stab()
        v0 = self._seed_state(x, z, r, k)
        dim = 1 << n
        state = np.zeros(dim, dtype=np.complex128)
        norm = 1.0 / math.sqrt(1 << k)
        # enumerate the coset v0 ^ span(x rows 0..k-1) in Gray-code order,
        # tracking the accumulated Pauli product phase exactly
        state[v0] = norm
        if k == 0:
            if self.phase_offset != 1.0 + 0j:
                state *= self.phase_offset
            return state
        cur_x = np.zeros(n, dtype=np.uint8)
        cur_z = np.zeros(n, dtype=np.uint8)
        cur_ph = 0  # units of i: 0..3, with sign folded in
        prev_gray = 0
        for t in range(1, 1 << k):
            gray = t ^ (t >> 1)
            bit = (gray ^ prev_gray).bit_length() - 1
            prev_gray = gray
            # multiply current Pauli by generator `bit` (CHP sign algebra)
            gi = bit
            phase = 2 * int(r[gi]) + int(self._g_vec(x[gi], z[gi], cur_x, cur_z).sum())
            cur_ph = (cur_ph + phase) % 4
            cur_x ^= x[gi]
            cur_z ^= z[gi]
            # amplitude of v0 ^ cur_x:
            #   P = (-1)^(cur_ph/2) * i^{|x∧z|} * X^x Z^z   (Y = iXZ)
            #   P|v0> = sign * i^{|x∧z|} * (-1)^{z·v0} |v0 ^ x>
            zdot = 0
            for c in np.nonzero(cur_z)[0]:
                zdot ^= (v0 >> int(c)) & 1
            y_count = int(np.count_nonzero(cur_x & cur_z))
            ph = (cur_ph + 2 * zdot + y_count) % 4
            idx = v0
            for c in np.nonzero(cur_x)[0]:
                idx ^= 1 << int(c)
            state[idx] = norm * (1j ** ph)
        if self.phase_offset != 1.0 + 0j:
            state *= self.phase_offset
        return state

    def GetAmplitude(self, perm: int) -> complex:
        """Width-generic single-amplitude query: the canonical-form
        oracle (O(n^2) bit ops) times the 1/sqrt(2^k) support norm —
        never materializes the 2^n ket (reference: GetAmplitude walks
        its cached gaussian elimination, src/qstabilizer.cpp)."""
        canon = self._canonical_stab()
        return (complex(self._amp_closure(canon)(perm))
                / math.sqrt(1 << canon[3]))

    def GetProbs(self) -> np.ndarray:
        s = self.GetQuantumState()
        return (s.real ** 2 + s.imag ** 2)

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------

    def Compose(self, other: "QStabilizer", start: Optional[int] = None) -> int:
        if start is None:
            start = self.qubit_count
        if start != self.qubit_count:
            raise NotImplementedError("mid-insertion Compose on tableau")
        n1, n2 = self.qubit_count, other.qubit_count
        n = n1 + n2
        x = np.zeros((2 * n + 1, n), dtype=np.uint8)
        z = np.zeros((2 * n + 1, n), dtype=np.uint8)
        r = np.zeros(2 * n + 1, dtype=np.uint8)
        # destabilizers then stabilizers, block-diagonal
        x[0:n1, 0:n1] = self.x[0:n1]
        z[0:n1, 0:n1] = self.z[0:n1]
        r[0:n1] = self.r[0:n1]
        x[n1:n, n1:n] = other.x[0:n2]
        z[n1:n, n1:n] = other.z[0:n2]
        r[n1:n] = other.r[0:n2]
        x[n:n + n1, 0:n1] = self.x[n1:2 * n1]
        z[n:n + n1, 0:n1] = self.z[n1:2 * n1]
        r[n:n + n1] = self.r[n1:2 * n1]
        x[n + n1:2 * n, n1:n] = other.x[n2:2 * n2]
        z[n + n1:2 * n, n1:n] = other.z[n2:2 * n2]
        r[n + n1:2 * n] = other.r[n2:2 * n2]
        self.x, self.z, self.r = x, z, r
        self.qubit_count = n
        self.phase_offset *= getattr(other, "phase_offset", 1.0 + 0j)
        return start

    def Allocate(self, start: int, length: int = 1) -> int:
        if length == 0:
            return start
        if start != self.qubit_count:
            raise NotImplementedError("mid-insertion Allocate on tableau")
        fresh = QStabilizer(length, rng=self.rng.spawn())
        self.Compose(fresh)
        return start

    # -- tableau serialization (reference: qstabilizer_out_to_file /
    #    in_from_file, include/pinvoke_api.hpp:55-56) --------------------

    def SaveToFile(self, path: str) -> None:
        """Write the tableau as text: header, width, phase offset, then
        the x/z bit matrices row-major and the r sign vector."""
        n = self.qubit_count
        with open(path, "w") as f:
            f.write("qrack_tpu-stabilizer v1\n")
            f.write(f"{n}\n")
            f.write(f"{float(self.phase_offset.real)!r} {float(self.phase_offset.imag)!r}\n")
            for mat_ in (self.x, self.z):
                for row in mat_[:2 * n]:
                    f.write("".join("1" if b else "0" for b in row) + "\n")
            f.write("".join(str(int(v) & 3) for v in self.r[:2 * n]) + "\n")

    @classmethod
    def LoadFromFile(cls, path: str, rng=None) -> "QStabilizer":
        with open(path) as f:
            header = f.readline().strip()
            if header != "qrack_tpu-stabilizer v1":
                raise ValueError(f"not a qrack_tpu stabilizer file: {header!r}")
            n = int(f.readline())
            pre, pim = (float(t) for t in f.readline().split())
            st = cls(n, rng=rng)
            st.phase_offset = complex(pre, pim)
            for mat_ in (st.x, st.z):
                for i in range(2 * n):
                    row = f.readline().strip()
                    mat_[i, :] = [c == "1" for c in row]
            rline = f.readline().strip()
            for i in range(2 * n):
                st.r[i] = int(rline[i])
        return st

    def IsSeparableZ(self, q: int) -> bool:
        """Deterministic Z measurement <=> Z eigenstate (reference:
        IsSeparableZ, include/qstabilizer.hpp)."""
        return self._find_random_row(q) is None

    def IsSeparableX(self, q: int) -> bool:
        with self._phase_freeze():  # net-identity conjugation
            self._h_gate(q)
            out = self.IsSeparableZ(q)
            self._h_gate(q)
        return out

    def IsSeparableY(self, q: int) -> bool:
        # conjugate by S^dag H? Y-basis: apply S^dag then H
        with self._phase_freeze():  # net-identity conjugation
            self.IS(q)
            self._h_gate(q)
            out = self.IsSeparableZ(q)
            self._h_gate(q)
            self.S(q)
        return out

    def DisposeZ(self, q: int) -> bool:
        """Tableau-native disposal of ONE Z-eigenstate qubit: O(n) row
        ops + one row/column delete, exact at any width (closes the
        round-2 'wide tableau disposal pending' hole; the reference
        disposes via its Decompose machinery, src/qstabilizer.cpp).
        Returns the eigenvalue bit of the disposed qubit.

        Method: the destabilizer rows with X support on q index exactly
        the stabilizer generators whose product is ±Z_q (the
        Aaronson–Gottesman determinism argument).  Folding them into a
        pivot (with contravariant destabilizer fixes) makes the pivot
        stabilizer literally ±Z_q; multiplying it away clears Z_q
        support everywhere else, the pivot destabilizer is re-seated as
        X_q, and the decoupled (X_q, ±Z_q) pair plus column q delete."""
        self._check_qubit(q)
        if not self.IsSeparableZ(q):
            raise CliffordError("DisposeZ requires a Z-eigenstate qubit")
        n = self.qubit_count
        out = {}

        def upd():
            hits = np.nonzero(self.x[0:n, q])[0]
            p = int(hits[0])
            for i in hits[1:]:
                i = int(i)
                self._rowsum(p + n, i + n)   # pivot stab *= partner stab
                self._rowsum(i, p)           # contravariant destab fix
            out["b"] = bool(self.r[p + n])   # pivot is now exactly ±Z_q
            for i in range(2 * n):
                if i != p + n and i != p and self.z[i, q]:
                    self._rowsum(i, p + n)   # clear Z_q support elsewhere
            rows = ([i for i in range(n) if i != p]
                    + [i + n for i in range(n) if i != p])
            cols = [j for j in range(n) if j != q]
            nn = n - 1
            x = np.zeros((2 * nn + 1, nn), dtype=np.uint8)
            z = np.zeros((2 * nn + 1, nn), dtype=np.uint8)
            r = np.zeros(2 * nn + 1, dtype=np.uint8)
            if nn:
                x[:2 * nn] = self.x[np.ix_(rows, cols)]
                z[:2 * nn] = self.z[np.ix_(rows, cols)]
            r[:2 * nn] = self.r[rows]
            self.x = np.ascontiguousarray(x)
            self.z = np.ascontiguousarray(z)
            self.r = r
            self.qubit_count = nn

        if not self._track_phase:
            upd()
            return out["b"]

        lo = (1 << q) - 1

        def true_amp(old, w):
            w = int(w)
            return old((w & lo) | ((w >> q) << (q + 1)) | (out["b"] << q))

        self._phase_track(upd, true_amp)
        return out["b"]

    def Dispose(self, start: int, length: int, disposed_perm: Optional[int] = None) -> None:
        """Drop qubits that are each single-basis separable (Z, X, or Y
        eigenstates): non-Z qubits rotate to the Z basis first, then one
        tableau-native DisposeZ each — exact at any width.  A span
        entangled within itself (even if separable from the rest) raises
        NotImplementedError; callers must measure first (reference
        disposes via its Decompose machinery, src/qstabilizer.cpp)."""
        states = self._separable_span_states(start, length)
        if states is None:
            raise NotImplementedError(
                "tableau Dispose requires per-qubit separable (Z/X/Y "
                "eigenstate) qubits; measure first")
        self._dispose_separable_span(start, states)

    def _separable_span_states(self, start: int, length: int):
        """Per-qubit (basis, bit) for a span of single-basis-separable
        qubits, or None if any qubit is entangled (incl. within-span)."""
        states = []
        for q in range(start, start + length):
            s = self._separable_1q_state(q)
            if s is None:
                return None
            states.append(s)
        return states

    def _dispose_separable_span(self, start: int, states) -> None:
        """Rotate each span qubit to Z per its recorded basis and
        DisposeZ it, descending so indices stay valid."""
        for q in range(start + len(states) - 1, start - 1, -1):
            basis, _ = states[q - start]
            if basis == "X":
                self.H(q)
            elif basis == "Y":
                self.IS(q)
                self.H(q)
            self.DisposeZ(q)

    def _separable_1q_state(self, q: int):
        """(basis, bit) for a single-basis-separable qubit: basis in
        {'Z','X','Y'} and the eigenvalue bit, or None.  Each candidate
        basis costs one net-identity conjugation (check + bit read in
        the same rotated frame)."""
        if self.IsSeparableZ(q):
            return "Z", self._deterministic_outcome(q)
        with self._phase_freeze():
            self._h_gate(q)
            if self.IsSeparableZ(q):
                b = self._deterministic_outcome(q)
                self._h_gate(q)
                return "X", b
            self._h_gate(q)
            self.IS(q)
            self._h_gate(q)
            if self.IsSeparableZ(q):
                b = self._deterministic_outcome(q)
                self._h_gate(q)
                self.S(q)
                return "Y", b
            self._h_gate(q)
            self.S(q)
        return None

    def _decompose_product_span(self, start: int, dest: "QStabilizer") -> bool:
        """Width-generic Decompose of a span whose qubits are each
        single-basis separable (the common post-measurement shape):
        read each qubit's eigenstate, rotate it to Z, DisposeZ it, and
        synthesize `dest` as the product tableau — O(n) row ops per
        qubit at ANY width (no 2^n ket is ever formed)."""
        length = dest.qubit_count
        states = self._separable_span_states(start, length)
        if states is None:
            return False
        self._dispose_separable_span(start, states)
        dest.SetPermutation(0, phase=1.0)
        for j, (basis, b) in enumerate(states):
            if b:
                dest.X(j)
            if basis == "X":
                dest.H(j)
            elif basis == "Y":
                dest.H(j)
                dest.S(j)
        return True

    @staticmethod
    def _symp(x1, z1, x2, z2) -> int:
        """Symplectic product mod 2 (1 = the two Paulis anticommute)."""
        return (int((x1 & z2).sum()) + int((z1 & x2).sum())) & 1

    @classmethod
    def _from_generators(cls, xs, zs, rs, rng=None):
        """Tableau for the state stabilized by m independent commuting
        generators on m qubits, built purely symplectically (no 2^m
        object): destabilizers come from symplectic Gram-Schmidt over
        the standard basis — pick D_i anticommuting with S_i, then fold
        (S_i, D_i) out of every remaining candidate, multiplying later
        generators by S_i (phase-tracked rowsum) when they anticommute
        with D_i.  Destabilizer phase bits are bookkeeping and start 0."""
        m = int(xs.shape[0])
        sx, sz = xs.astype(np.uint8).copy(), zs.astype(np.uint8).copy()
        sr = rs.astype(np.uint8).copy()
        cand = []
        for j in range(m):
            ex = np.zeros(m, dtype=np.uint8)
            ez = np.zeros(m, dtype=np.uint8)
            ex[j] = 1
            cand.append((ex, ez.copy()))
            cand.append((ez.copy(), ex.copy()))  # (x=0,z=e_j)
        dx = np.zeros((m, m), dtype=np.uint8)
        dz = np.zeros((m, m), dtype=np.uint8)
        for i in range(m):
            pick = None
            for ci, (cx, cz) in enumerate(cand):
                if cls._symp(sx[i], sz[i], cx, cz):
                    pick = ci
                    break
            if pick is None:
                raise ValueError("generators are not independent")
            dx[i], dz[i] = cand.pop(pick)
            kept = []
            for (cx, cz) in cand:
                if cls._symp(cx, cz, dx[i], dz[i]):
                    cx, cz = cx ^ sx[i], cz ^ sz[i]
                if cls._symp(cx, cz, sx[i], sz[i]):
                    cx, cz = cx ^ dx[i], cz ^ dz[i]
                if cx.any() or cz.any():
                    kept.append((cx, cz))
            cand = kept
            for j in range(i + 1, m):
                if cls._symp(sx[j], sz[j], dx[i], dz[i]):
                    cls._row_mul_into(sx, sz, sr, j, i)
        out = cls(m, rng=rng)
        out.x[:m], out.z[:m] = dx, dz
        out.x[m:2 * m], out.z[m:2 * m] = sx, sz
        out.r[:] = 0
        out.r[m:2 * m] = sr
        return out

    def _extract_product_generators(self, start: int, length: int):
        """Split the stabilizer group into span-only and rest-only
        generator sets via phase-tracked Gaussian elimination over the
        outside coordinates; None if the span is entangled with the
        rest.  O(n^3) bit ops, no 2^n object — width-generic."""
        n = self.qubit_count
        x = self.x[n:2 * n].copy()
        z = self.z[n:2 * n].copy()
        r = self.r[n:2 * n].copy()

        def mul_into(h, i):
            self._row_mul_into(x, z, r, h, i)

        def eliminate(rows_lo, coords):
            """Row-reduce over (array, col) coords; returns next free row."""
            row = rows_lo
            for (arr, c) in coords:
                piv = None
                for i in range(row, n):
                    if arr[i, c]:
                        piv = i
                        break
                if piv is None:
                    continue
                if piv != row:
                    for a in (x, z):
                        a[[row, piv]] = a[[piv, row]]
                    r[[row, piv]] = r[[piv, row]]
                for i in range(n):
                    if i != row and arr[i, c]:
                        mul_into(i, row)
                row += 1
            return row

        outside = [c for c in range(n)
                   if not (start <= c < start + length)]
        cut = eliminate(0, [(x, c) for c in outside]
                        + [(z, c) for c in outside])
        if n - cut != length:
            return None
        # rows [cut, n): no outside support -> span-only generators.
        # Clean residual span support out of the outside rows using them.
        span = [c for c in range(start, start + length)]
        eliminate(cut, [(x, c) for c in span] + [(z, c) for c in span])
        for i in range(cut):
            if any(x[i, c] or z[i, c] for c in span):
                return None  # genuinely entangled across the cut
        rest_idx = np.asarray(outside, dtype=np.intp)
        span_idx = np.asarray(span, dtype=np.intp)
        return ((x[cut:, span_idx], z[cut:, span_idx], r[cut:]),
                (x[:cut, rest_idx], z[:cut, rest_idx], r[:cut]))

    def Decompose(self, start: int, dest: "QStabilizer") -> None:
        length = dest.qubit_count
        n = self.qubit_count
        if self._decompose_product_span(start, dest):
            return
        split = self._extract_product_generators(start, length)
        if split is not None:
            (gsx, gsz, gsr), (grx, grz, grr) = split
            # exact global phase: one amplitude of the ORIGINAL state at
            # a product support point, vs the factor tableaus' product
            d_new = self._from_generators(gsx, gsz, gsr,
                                          rng=self.rng.spawn())
            rem = self._from_generators(grx, grz, grr,
                                        rng=self.rng.spawn())
            lo_mask = (1 << start) - 1
            vd = d_new._seed_state(*d_new._canonical_stab())
            vr = rem._seed_state(*rem._canonical_stab())
            combined = ((vr & lo_mask) | (vd << start)
                        | ((vr >> start) << (start + length)))
            # the factors' own amplitudes at their canonical seeds are
            # +norm by construction (phase_offset == 1, see _amp_closure
            # docstring), so the original's phase there IS the correction
            t = self.GetAmplitude(combined)
            if abs(t) > 1e-12:
                rem.phase_offset *= t / abs(t)
            dest.x, dest.z, dest.r = d_new.x, d_new.z, d_new.r
            dest.phase_offset = d_new.phase_offset
            dest.qubit_count = length
            self.x, self.z, self.r = rem.x, rem.z, rem.r
            self.phase_offset = rem.phase_offset
            self.qubit_count = n - length
            return
        if n > 20:
            raise NotImplementedError(
                "tableau Decompose of a span entangled ACROSS the cut is "
                "undefined (reference raises too); spans separable from "
                "the remainder decompose at any width")
        st = self.GetQuantumState()
        from ..engines.cpu import QEngineCPU

        tmp = QEngineCPU(n, rng=self.rng.spawn(), rand_global_phase=False)
        tmp.SetQuantumState(st)
        tmp_dest = QEngineCPU(length, rng=self.rng.spawn(), rand_global_phase=False)
        tmp.Decompose(start, tmp_dest)
        # shrink this tableau before re-synthesizing the remainder
        shrunk = QStabilizer(n - length, rng=self.rng.spawn())
        shrunk.SetQuantumState(tmp.GetQuantumState())
        self.x, self.z, self.r = shrunk.x, shrunk.z, shrunk.r
        self.phase_offset = shrunk.phase_offset
        self.qubit_count = n - length
        dest.SetQuantumState(tmp_dest.GetQuantumState())

    # ------------------------------------------------------------------
    # state IO
    # ------------------------------------------------------------------

    def SetPermutation(self, perm: int, phase=None) -> None:
        n = self.qubit_count
        self.x[:] = 0
        self.z[:] = 0
        self.r[:] = 0
        if phase is not None:
            ph = complex(phase)
            self.phase_offset = ph / abs(ph) if abs(ph) > 0 else 1.0 + 0j
        elif self.rand_global_phase:
            ang = 2.0 * math.pi * self.Rand()
            self.phase_offset = complex(math.cos(ang), math.sin(ang))
        else:
            self.phase_offset = 1.0 + 0j
        for i in range(n):
            self.x[i, i] = 1
            self.z[n + i, i] = 1
        with self._phase_freeze():  # offset already set explicitly above
            for q in range(n):
                if (perm >> q) & 1:
                    self._x_gate(q)

    def SetQuantumState(self, state) -> None:
        """Only stabilizer states are representable: synthesize by
        matching against basis/graph preparation of up to 2 qubits or
        raise (reference requires the same)."""
        state = np.asarray(state, dtype=np.complex128).reshape(-1)
        n = self.qubit_count
        if state.shape[0] != (1 << n):
            raise ValueError("state length mismatch")
        # basis state?
        nz = np.nonzero(np.abs(state) > 1e-8)[0]
        if nz.size == 1:
            amp = complex(state[nz[0]])
            self.SetPermutation(int(nz[0]), phase=amp / abs(amp))
            return
        # general stabilizer synthesis via Clifford circuit extraction
        self._synthesize_from_ket(state)

    def _synthesize_from_ket(self, state: np.ndarray) -> None:
        """Exact stabilizer-ket synthesis via the affine-support normal
        form: every stabilizer ket is uniform-magnitude over an affine
        subspace {v0 ⊕ B·u} with phases i^{l·u} (-1)^{u^T Q u} (Dehaene–
        De Moor). Recognize that structure, then prepare it with
        X / H / CNOT / S / Z / CZ on the tableau. Raises CliffordError
        (cheaply, via the structure prechecks) for non-stabilizer kets."""
        n = self.qubit_count
        mags = np.abs(state)
        support = np.nonzero(mags > 1e-7)[0]
        ssz = support.size
        if ssz == 0 or (ssz & (ssz - 1)):
            raise CliffordError("support size is not a power of two")
        if not np.allclose(mags[support], mags[support][0], atol=1e-6):
            raise CliffordError("non-uniform support magnitudes")
        k = ssz.bit_length() - 1
        v0 = int(support[0])
        # GF(2) RREF basis of the support coset: each b_j has a unique
        # pivot (leading) bit absent from every other row and from v0
        by_lead: dict = {}
        for s_ in support[1:]:
            vec = int(s_) ^ v0
            while vec:
                lead = vec.bit_length() - 1
                if lead in by_lead:
                    vec ^= by_lead[lead]
                else:
                    by_lead[lead] = vec
                    break
            if len(by_lead) == k:
                break
        if len(by_lead) != k:
            raise CliffordError("support is not an affine subspace")
        # back-substitute highest pivot first so cleared bits stay cleared
        for p in sorted(by_lead, reverse=True):
            for p2 in by_lead:
                if p2 != p and (by_lead[p2] >> p) & 1:
                    by_lead[p2] ^= by_lead[p]
        pivots = sorted(by_lead)
        basis = [by_lead[p] for p in pivots]
        for i, b in enumerate(basis):
            if (v0 >> pivots[i]) & 1:
                v0 ^= b
        amp0 = state[v0]

        def coset(u: int) -> int:
            x = v0
            for j in range(k):
                if (u >> j) & 1:
                    x ^= basis[j]
            return x

        def cph(u: int) -> int:
            """Phase of amp(coset(u))/amp0 as a power of i, or raise."""
            ratio = state[coset(u)] / amp0
            for p in range(4):
                if abs(ratio - (1j ** p)) < 1e-5:
                    return p
            raise CliffordError("support phase not in {±1, ±i}")

        l = [cph(1 << j) for j in range(k)]
        q_mat = np.zeros((k, k), dtype=np.uint8)
        for i in range(k):
            for j in range(i + 1, k):
                pij = (cph((1 << i) | (1 << j)) - l[i] - l[j]) % 4
                if pij == 2:
                    q_mat[i, j] = 1
                elif pij != 0:
                    raise CliffordError("support phases not quadratic")
        # verify the full phase table (O(2^k) scalar work)
        for u in range(1 << k):
            expect = 0
            for j in range(k):
                if (u >> j) & 1:
                    expect += l[j]
            for i in range(k):
                for j in range(i + 1, k):
                    if ((u >> i) & 1) and ((u >> j) & 1) and q_mat[i, j]:
                        expect += 2
            if cph(u) != expect % 4:
                raise CliffordError("support phases not quadratic")
        # build the state on a fresh tableau; the construction realizes
        # amp(v0) = +1/sqrt(2^k), so the input's v0 phase is the offset
        # (tracking frozen: the offset above already carries the phase)
        self.SetPermutation(0, phase=amp0 / abs(amp0))
        with self._phase_freeze():
            for b in range(n):
                if (v0 >> b) & 1:
                    self._x_gate(b)
            for j in range(k):
                pj = pivots[j]
                self._h_gate(pj)
                for b in range(n):
                    if b != pj and (basis[j] >> b) & 1:
                        self._cnot(pj, b)
                for _ in range(l[j] % 4):
                    self._s_gate(pj)
            for i in range(k):
                for j in range(i + 1, k):
                    if q_mat[i, j]:
                        self.CZ(pivots[i], pivots[j])

    def Clone(self) -> "QStabilizer":
        c = QStabilizer(self.qubit_count, rng=self.rng.spawn(),
                        rand_global_phase=self.rand_global_phase)
        c.x = self.x.copy()
        c.z = self.z.copy()
        c.r = self.r.copy()
        c.phase_offset = self.phase_offset
        return c

    def SumSqrDiff(self, other) -> float:
        a = self.GetQuantumState()
        b = np.asarray(other.GetQuantumState(), dtype=np.complex128)
        inner = np.vdot(a, b)
        return float(max(0.0, 1.0 - abs(inner) ** 2))

    def isClifford(self, q: Optional[int] = None) -> bool:
        return True

    def GetQubitCount(self) -> int:
        return self.qubit_count

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py): the whole tableau
    # plus the tracked global phase
    # ------------------------------------------------------------------

    _ckpt_kind = "stabilizer"

    def _ckpt_capture(self, capture_child):
        return {"kind": "stabilizer",
                "meta": {"n": self.qubit_count,
                         "phase_offset": [self.phase_offset.real,
                                          self.phase_offset.imag]},
                "arrays": {"x": self.x, "z": self.z, "r": self.r}}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self.x = np.ascontiguousarray(arrays["x"], dtype=np.uint8)
        self.z = np.ascontiguousarray(arrays["z"], dtype=np.uint8)
        self.r = np.ascontiguousarray(arrays["r"], dtype=np.uint8)
        po = meta.get("phase_offset", [1.0, 0.0])
        self.phase_offset = complex(po[0], po[1])
