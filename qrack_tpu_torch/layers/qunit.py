"""QUnit: Schmidt-decomposition qubit factoring.

Re-design of the reference's largest optimizer layer (reference:
include/qunit.hpp:28, src/qunit.cpp — arXiv:1710.05867): only entangled
clumps of qubits pay exponential cost. Each logical qubit owns a shard
(reference: include/qengineshard.hpp:32-100) that is either

  * a cached single-qubit state (amp0, amp1) — gates on it are 2-vector
    host math, no engine at all, or
  * a (unit, mapped) reference into a shared lower-layer instance.

Entangling ops Compose the participating units (reference:
EntangleInCurrentBasis src/qunit.cpp:431, EntangleRange :565-618,
OrderContiguous :857); measurement and TrySeparate split them back
(SeparateBit :1350, TrySeparate :696). Controls with definite cached
values are elided (TrimControls :2549). Swap of two logical qubits is a
pure shard exchange (no engine work).

Gate-fusion buffers (reference: PhaseShard maps + Pauli basis tags,
include/qengineshard.hpp:32-100, applied in Mtrx src/qunit.cpp:2433-2487)
are re-designed here as a two-level lazy stack per shard:

  logical state = (per-shard pending 2x2)  .  (2-qubit phase links)  .  base

* ``pending`` — a buffered single-qubit unitary per shard.  Any 1q gate
  on an entangled shard is a 2x2 host multiply, never an engine
  dispatch; H.H, basis changes, and rotation merges cancel
  algebraically.  This generalizes the reference's X/Y/Z basis tags (a
  shard "in the X basis" is exactly ``pending == H``).
* ``links`` — buffered 2-qubit *diagonal* gates (CZ/CPhase/controlled
  rotations) between any two shards, entangled or not.  All 2-qubit
  diagonals commute, so links form an unordered bag keyed by shard
  pair; merging is elementwise phase multiplication and CZ.CZ == I
  cancels to nothing — the gate never reaches an engine and never
  entangles.  A link whose endpoint collapses to a definite bit
  *reduces* to a 1-qubit phase on its partner (the reference's buffered
  CZ elision on measurement).

Buffers are flushed (links resolved bottom-up, then pendings) only when
an operation genuinely needs the engine: non-diagonal multi-qubit gates,
state reads, ALU spans.  Z-basis probabilities and parities need no
flush at all — diagonal links never change Z marginals, and monomial
pendings just relabel outcomes.  ``QRACK_QUNIT_PHASE_FUSION=0`` or
``phase_fusion=False`` disables buffering (dispatch-per-gate, round-1
behavior); ``dispatch_count`` counts engine gate dispatches for tests.

Port note: a copy of the JAX package's layers/qunit.py whose default
unit is the port's QStabilizerHybrid; units take the constructor's
keyword arguments (``device``, ``dtype``) and ``self.rng.spawn()`` in
the JAX package's order, so measurement outcomes agree draw for draw.
``compose_count`` and ``swap_count`` count the unit Composes of
``_merge`` and the in-unit Swaps of ``_order_contiguous``.  A merge past
one device's dense width (QRACK_MAX_PAGE_QB, 30) takes QHybrid's pager
mode: over a ``devices`` list (a keyword the units take) the ket goes
into pages; without one, one page on one card is too narrow and the
pager raises MemoryError, which ACE catches, as in the JAX package.
Telemetry: the JAX package's ``qunit.gate.dispatch``,
``qunit.fidelity_guard.trip``, ``qunit.unit_fresh``, ``qunit.compose``
and ``qunit.separate``.  Checkpoints: the JAX package's structured
capture (kind ``"unit"``), recursing into each unit.
"""

from __future__ import annotations

import cmath
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import telemetry as _tele
from ..config import FP_NORM_EPSILON, TRYDECOMPOSE_EPSILON
from ..interface import QInterface
from .. import matrices as mat


def _default_unit_factory(n, **kw):
    from .stabilizerhybrid import QStabilizerHybrid

    return QStabilizerHybrid(n, **kw)


_EPS = 1e-10
_ID2 = np.eye(2, dtype=np.complex128)


def _mat_kind(m: Optional[np.ndarray]) -> str:
    """Classify a 2x2: 'id' | 'diag' | 'anti' (anti-diagonal) | 'gen'."""
    if m is None:
        return "id"
    if abs(m[0, 1]) < _EPS and abs(m[1, 0]) < _EPS:
        if abs(m[0, 0] - 1) < _EPS and abs(m[1, 1] - 1) < _EPS:
            return "id"
        return "diag"
    if abs(m[0, 0]) < _EPS and abs(m[1, 1]) < _EPS:
        return "anti"
    return "gen"


class _PhaseLink:
    """A buffered 2-qubit controlled-monomial gate between shards a and b.

    The operator is M = V · D (D applied first):
      * D — diagonal: d[bit_a][bit_b] unit-modulus phases (reference
        analogue: PhaseShard, include/qengineshard.hpp:32-61, "phase"
        case);
      * V — optional controlled-invert: X applied to endpoint `xt` when
        the OTHER endpoint (the control) has bit value v with x[v] == 1
        (reference analogue: PhaseShard isInvert,
        include/qengineshard.hpp:62-100).
    A plain diagonal link has xt None.  CNOT-echo pairs cancel in the
    bag: merging two identical controlled-inverts XORs x back to zero
    and the link normalizes to (or toward) identity."""

    __slots__ = ("a", "b", "d", "xt", "x")

    def __init__(self, a: "_Shard", b: "_Shard", d: np.ndarray):
        self.a = a
        self.b = b
        self.d = d
        self.xt: Optional["_Shard"] = None  # invert target endpoint
        self.x = [0, 0]                     # X^(x[control_bit]) on xt

    @property
    def has_invert(self) -> bool:
        return self.xt is not None and bool(self.x[0] or self.x[1])

    def _normalize(self) -> None:
        if self.xt is not None and not (self.x[0] or self.x[1]):
            self.xt = None
            self.x = [0, 0]

    def phases_for(self, shard: "_Shard", bit: int) -> np.ndarray:
        """Diagonal on the OTHER endpoint once `shard` collapses to bit
        (plain links only)."""
        return self.d[bit, :] if shard is self.a else self.d[:, bit]

    def resolve_for(self, shard: "_Shard", bit: int) -> np.ndarray:
        """2x2 monomial applied to the OTHER endpoint once `shard`'s
        base collapses to `bit`.  `shard` must not be the invert target
        (callers flush such links before collapsing the target)."""
        ph = self.phases_for(shard, bit)
        op = np.diag(ph).astype(np.complex128)
        if self.has_invert and self.x[bit]:
            op = np.array([[0, ph[1]], [ph[0], 0]], dtype=np.complex128)
        return op

    def _orient(self, shard_a: "_Shard", d: np.ndarray) -> np.ndarray:
        return d if shard_a is self.a else d.T

    def absorb_diag(self, shard_a: "_Shard", d: np.ndarray) -> None:
        """Merge a NEW diagonal payload arriving on top: M' = g·V·D =
        V·(V†gV)·D, where conjugation by the controlled-invert permutes
        g's target index on the control rows that fire."""
        g = self._orient(shard_a, d).copy()
        if self.has_invert:
            if self.xt is self.b:  # control = a (axis 0)
                for cb in (0, 1):
                    if self.x[cb]:
                        g[cb] = g[cb, ::-1]
            else:                  # control = b (axis 1)
                for cb in (0, 1):
                    if self.x[cb]:
                        g[:, cb] = g[::-1, cb]
        self.d = self.d * g

    def absorb_invert(self, ctrl: "_Shard", d2: np.ndarray, x2) -> None:
        """Merge a NEW controlled-invert V2·D2 (ctrl-major d2) arriving
        on top of V·D with the SAME orientation (self.xt is the other
        endpoint, or self plain): V2·D2·V·D = (V2·V)·(V†·D2·V)·D."""
        tgt = self.b if ctrl is self.a else self.a
        self.absorb_diag(ctrl, d2)
        if self.xt is None:
            self.xt = tgt
            self.x = list(x2)
        else:
            self.x = [self.x[0] ^ x2[0], self.x[1] ^ x2[1]]
        self._normalize()

    def is_identity(self) -> bool:
        return not self.has_invert and bool(np.allclose(self.d, 1.0, atol=_EPS))

    def uniform_scalar(self) -> Optional[complex]:
        if self.has_invert:
            return None
        c = self.d[0, 0]
        if np.allclose(self.d, c, atol=_EPS):
            return complex(c)
        return None


class _Shard:
    __slots__ = ("unit", "mapped", "amp0", "amp1", "pending", "links")

    def __init__(self, amp0=1.0 + 0j, amp1=0.0 + 0j):
        self.unit = None
        self.mapped = 0
        self.amp0 = complex(amp0)
        self.amp1 = complex(amp1)
        # lazy gate-fusion buffers (see module docstring)
        self.pending: Optional[np.ndarray] = None   # buffered 1q unitary
        self.links: Dict["_Shard", _PhaseLink] = {}  # partner -> link

    @property
    def cached(self) -> bool:
        return self.unit is None

    def base_z_value(self) -> Optional[int]:
        """This shard's definite Z bit at the *base* level (below
        buffers), or None."""
        if not self.cached:
            return None
        nrm = abs(self.amp0) ** 2 + abs(self.amp1) ** 2
        if nrm <= 0.0:
            return None
        p1 = (abs(self.amp1) ** 2) / nrm
        if p1 <= FP_NORM_EPSILON:
            return 0
        if p1 >= 1.0 - FP_NORM_EPSILON:
            return 1
        return None


class QUnit(QInterface):
    def __init__(self, qubit_count: int, init_state: int = 0,
                 unit_factory: Optional[Callable] = None,
                 separability_threshold: Optional[float] = None,
                 phase_fusion: Optional[bool] = None, **kwargs):
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        self._factory = unit_factory or _default_unit_factory
        self._unit_kwargs = {k: v for k, v in kwargs.items() if k != "rng"}
        import os

        if phase_fusion is None:
            phase_fusion = os.environ.get("QRACK_QUNIT_PHASE_FUSION", "1") != "0"
        self.phase_fusion = bool(phase_fusion)
        self.dispatch_count = 0  # engine gate dispatches (test observability)
        self.compose_count = 0   # unit Composes in _merge
        self.swap_count = 0      # in-unit Swaps in _order_contiguous
        # ACE (approximate circuit elision) + fidelity guard (reference:
        # include/qunit.hpp:107-146 CheckFidelity/ElideCz; README.md:118)
        self.is_ace = (os.environ.get("QRACK_DISABLE_QUNIT_FIDELITY_GUARD", "0")
                       not in ("", "0"))
        self.ace_qubits: Optional[int] = None  # extra width cap (SetAceMaxQubits)
        # per-instance sparse-entangle budget (reference: QUnit::aceMb
        # seeded from QRACK_SPARSE_MAX_ALLOC_MB_DEFAULT, src/qunit.cpp:94)
        self.ace_mb: Optional[int] = int(
            os.environ.get("QRACK_SPARSE_MAX_ALLOC_MB", "512"))
        self.log_fidelity = 0.0
        # TrySeparate tolerance (reference: QRACK_QUNIT_SEPARABILITY_THRESHOLD)
        self.sep_threshold = (
            separability_threshold if separability_threshold is not None
            else max(self.config.separability_threshold, TRYDECOMPOSE_EPSILON)
        )
        self.reactive_separate = True
        self.shards: List[_Shard] = []
        for q in range(qubit_count):
            s = _Shard()
            if (init_state >> q) & 1:
                s.amp0, s.amp1 = 0.0 + 0j, 1.0 + 0j
            self.shards.append(s)

    def SetReactiveSeparate(self, flag: bool) -> None:
        self.reactive_separate = bool(flag)

    def GetReactiveSeparate(self) -> bool:
        return self.reactive_separate

    # ------------------------------------------------------------------
    # ACE: approximate circuit elision + fidelity accounting
    # (reference: include/qunit.hpp:107-146, src/qunit.cpp:1823-1840)
    # ------------------------------------------------------------------

    def SetAceMaxQubits(self, qb: Optional[int]) -> None:
        self.ace_qubits = qb

    def SetSparseAceMaxMb(self, mb: Optional[int]) -> None:
        """Per-instance RAM cap for entangling SPARSE subsystems
        (reference: QUnit::aceMb, include/qunit.hpp:705; enforced at
        entangle time against the PRODUCT of sparse amplitude counts,
        src/qunit.cpp:451-461) — distinct from the global dense-ket
        QRACK_MAX_ALLOC_MB cap."""
        self.ace_mb = mb

    def GetUnitaryFidelity(self) -> float:
        f = math.exp(self.log_fidelity)
        seen = set()
        for s in self.shards:
            if s.unit is not None and id(s.unit) not in seen:
                seen.add(id(s.unit))
                f *= s.unit.GetUnitaryFidelity()
        return f

    def ResetUnitaryFidelity(self) -> None:
        self.log_fidelity = 0.0

    def _dispatch(self, n: int = 1) -> None:
        """One (or n) engine gate dispatches escaped the fusion buffers."""
        self.dispatch_count += n
        if _tele._ENABLED:
            _tele.inc("qunit.gate.dispatch", n)

    def _check_fidelity(self) -> None:
        # NOTE: matches the reference exactly — the SAME env toggle gates
        # both ACE and this floor (include/qunit.hpp:107-118), so from the
        # ACE elision sites (reachable only with is_ace) this guard is
        # intentionally vacuous; it exists for non-ACE accrual paths
        # (future SDRP-style rounding) and for callers that flip is_ace
        # mid-run.
        if (not self.is_ace
                and self.log_fidelity <= math.log(FP_NORM_EPSILON)):
            if _tele._ENABLED:
                _tele.event("qunit.fidelity_guard.trip",
                            log_fidelity=self.log_fidelity)
            raise RuntimeError(
                "QUnit fidelity estimate is effectively 0! (This does NOT "
                "necessarily mean the true fidelity is near 0 — consider "
                "setting QRACK_DISABLE_QUNIT_FIDELITY_GUARD=1.)")

    def _merge_budget_check(self, qubits: Sequence[int]) -> None:
        """Width/RAM guard before composing units (reference:
        EntangleInCurrentBasis aceQubits/aceMb checks,
        src/qunit.cpp:455-477; enforces QRACK_MAX_ALLOC_MB)."""
        total = 0
        seen = set()
        units = []
        for q in qubits:
            s = self.shards[q]
            if s.cached:
                total += 1
            elif id(s.unit) not in seen:
                seen.add(id(s.unit))
                units.append(s.unit)
                total += s.unit.qubit_count
        if self.ace_qubits is not None and total > self.ace_qubits:
            raise MemoryError(
                f"QUnit entangle would span {total} qubits > ACE cap "
                f"{self.ace_qubits}")
        if units and all(hasattr(u, "nnz") for u in units) and self.ace_mb:
            # sparse subsystems: account the PRODUCT of amplitude counts
            # against this instance's sparse-ACE budget (reference:
            # SPARSE_KEY_BYTES * prod(GetAmplitudeCount()) > aceMb,
            # src/qunit.cpp:451-461)
            mem = 24  # 8B index + 16B amplitude per entry
            for u in units:
                mem *= max(u.nnz(), 1)
            mem <<= max(total - sum(u.qubit_count for u in units), 0)
            if mem > (self.ace_mb << 20):
                raise MemoryError(
                    f"QUnit sparse entangle worst case {mem >> 20} MB "
                    f"> sparse ACE cap {self.ace_mb} MB")
            return
        # sparse cap disabled (or mixed/dense units): the dense
        # worst-case guard below still applies
        max_mb = self.config.max_alloc_mb
        if max_mb and (16 << total) > (max_mb << 20):
            raise MemoryError(
                f"QUnit entangle would allocate 2^{total} amplitudes "
                f"> QRACK_MAX_ALLOC_MB={max_mb}")

    def _elide_cz(self, c: int, t: int, d: np.ndarray) -> None:
        """Classical shadow for an un-entangleable buffered phase link
        (reference: ElideCz, include/qunit.hpp:119-146): apply the more
        decisive qubit's most likely branch phases locally and pay the
        fidelity cost of ignoring the correlation."""
        pc, pt = self.Prob(c), self.Prob(t)
        # pick the endpoint whose state is most nearly definite
        c_decisive = abs(pc - 0.5) >= abs(pt - 0.5)
        src, dst = (c, t) if c_decisive else (t, c)
        p1 = pc if c_decisive else pt
        bit = 1 if p1 >= 0.5 else 0
        self.log_fidelity += math.log(
            max(min(p1 if bit else (1.0 - p1), 1.0), FP_NORM_EPSILON))
        self._check_fidelity()
        phases = d[bit, :] if (src == c) else d[:, bit]
        self._buffer_1q(dst, np.diag(phases))

    # ------------------------------------------------------------------
    # shard/unit plumbing
    # ------------------------------------------------------------------

    def _unit_qubits(self, unit) -> List[int]:
        """Logical qubits living in `unit`, sorted by mapped index."""
        qs = [q for q, s in enumerate(self.shards) if s.unit is unit]
        qs.sort(key=lambda q: self.shards[q].mapped)
        return qs

    def _to_unit(self, q: int):
        s = self.shards[q]
        if s.unit is not None:
            return s.unit
        eng = self._factory(1, rng=self.rng.spawn(), **self._unit_kwargs)
        eng.SetQuantumState(np.array([s.amp0, s.amp1], dtype=np.complex128))
        s.unit = eng
        s.mapped = 0
        if _tele._ENABLED:
            _tele.inc("qunit.unit_fresh")
        return eng

    _ACE_ADVISORY = ("QUnit needed to engage automatic circuit elision (ACE) "
                     "but the fidelity guard is active — set "
                     "QRACK_DISABLE_QUNIT_FIDELITY_GUARD=1 to allow "
                     "approximate elision instead of this error.")

    def _merge(self, qubits: Sequence[int]):
        """Compose the units behind `qubits` into one; returns it."""
        self._merge_budget_check(qubits)
        units = []
        for q in qubits:
            u = self._to_unit(q)
            if all(u is not v for v in units):
                units.append(u)
        base = units[0]
        for u in units[1:]:
            offset = base.qubit_count
            base.Compose(u)
            self.compose_count += 1
            if _tele._ENABLED:
                _tele.inc("qunit.compose")
            for s in self.shards:
                if s.unit is u:
                    s.unit = base
                    s.mapped += offset
        return base

    def _order_contiguous(self, qubits: Sequence[int]) -> Tuple[object, int]:
        """Entangle `qubits` into one unit and arrange them at consecutive
        mapped positions in the given order (reference: EntangleRange +
        OrderContiguous, src/qunit.cpp:565-883). Returns (unit, base)."""
        unit = self._merge(qubits)
        members = self._unit_qubits(unit)
        base = min(self.shards[q].mapped for q in qubits)
        # place qubits[i] at mapped position base + i by in-unit swaps
        pos_of = {q: self.shards[q].mapped for q in members}
        qubit_at = {m: q for q, m in pos_of.items()}
        for i, q in enumerate(qubits):
            want = base + i
            cur = pos_of[q]
            if cur == want:
                continue
            other = qubit_at[want]
            unit.Swap(cur, want)
            self.swap_count += 1
            pos_of[q], pos_of[other] = want, cur
            qubit_at[want], qubit_at[cur] = q, other
        for q in members:
            self.shards[q].mapped = pos_of[q]
        return unit, base

    def _release_if_single(self, unit) -> None:
        """Collapse a 1-qubit unit back into a cached shard."""
        if unit.qubit_count != 1:
            return
        qs = self._unit_qubits(unit)
        if len(qs) != 1:
            return
        st = np.asarray(unit.GetQuantumState(), dtype=np.complex128)
        s = self.shards[qs[0]]
        s.unit = None
        s.mapped = 0
        s.amp0, s.amp1 = complex(st[0]), complex(st[1])

    def _separate_bit(self, q: int, value: bool) -> None:
        """Drop a qubit whose *base* (below-buffer) state collapsed to
        `value` out of its unit and re-register it as a cached shard
        (reference: SeparateBit, src/qunit.cpp:1350).  The shard's links
        reduce to 1q phases on their partners; its pending folds into
        the cached amplitudes."""
        vec = np.array([0j, 1 + 0j] if value else [1 + 0j, 0j])
        self._detach_raw(q, value, vec)

    # ------------------------------------------------------------------
    # gate-fusion buffers: phase links + pending 2x2s
    # (reference: PhaseShard algebra, include/qengineshard.hpp:32-100 and
    #  src/qengineshard.cpp; basis tags src/qunit.cpp:2433-2487 — here
    #  re-designed as a commuting diagonal-link bag under per-shard
    #  pending unitaries, see module docstring)
    # ------------------------------------------------------------------

    def _apply_base_diag(self, s: _Shard, phases: np.ndarray) -> None:
        """Apply diag(phases) at the *base* level of shard s (below its
        pending, below remaining links — legal because diagonals commute
        with every link)."""
        if abs(phases[0] - 1) < _EPS and abs(phases[1] - 1) < _EPS:
            return
        if s.cached:
            s.amp0 *= complex(phases[0])
            s.amp1 *= complex(phases[1])
        else:
            s.unit.MCMtrxPerm((), np.diag(phases), s.mapped, 0)
            self._dispatch()

    def _apply_base_monomial(self, s: _Shard, op: np.ndarray) -> None:
        """Apply a 2x2 monomial at the *base* level of shard s."""
        if _mat_kind(op) in ("id", "diag"):
            self._apply_base_diag(s, np.array([op[0, 0], op[1, 1]]))
            return
        if s.cached:
            s.amp0, s.amp1 = op[0, 1] * s.amp1, op[1, 0] * s.amp0
        else:
            s.unit.MCMtrxPerm((), op, s.mapped, 0)
            self._dispatch()

    def _base_prob1(self, s: _Shard) -> float:
        """P(bit = 1) at the *base* level of shard s (below pendings and
        links)."""
        if s.cached:
            nrm = abs(s.amp0) ** 2 + abs(s.amp1) ** 2
            return (abs(s.amp1) ** 2 / nrm) if nrm > 0 else 0.0
        return s.unit.Prob(s.mapped)

    def _is_x_target(self, s: _Shard) -> bool:
        return any(l.has_invert and l.xt is s for l in s.links.values())

    def _flush_invert_links(self, q: int) -> None:
        """Resolve only the link(s) whose invert TARGETS q (they change
        its Z marginal); buffered diagonal links stay lazy."""
        s = self.shards[q]
        for link in list(s.links.values()):
            if link.has_invert and link.xt is s:
                self._resolve_link(link)

    def _reduce_links(self, s: _Shard, bit: int) -> None:
        """Shard s's base collapsed to `bit`: every link reduces to a
        1q monomial on its partner (the buffered-CZ elision win).  A
        link whose invert TARGETS s cannot reduce (s's value depends on
        the partner) and resolves fully instead."""
        for partner, link in list(s.links.items()):
            if link.has_invert and link.xt is s:
                self._resolve_link(link)
                continue
            self._apply_base_monomial(partner, link.resolve_for(s, bit))
            del s.links[partner]
            partner.links.pop(s, None)

    def _qubit_of(self, s: _Shard) -> int:
        return next(i for i, t in enumerate(self.shards) if t is s)

    def _resolve_link(self, link: _PhaseLink) -> None:
        """Push one link down into the base (engine), entangling its
        endpoints if neither is base-definite."""
        a, b = link.a, link.b
        a.links.pop(b, None)
        b.links.pop(a, None)
        za, zb = a.base_z_value(), b.base_z_value()
        if za is not None and not (link.has_invert and link.xt is a):
            self._apply_base_monomial(b, link.resolve_for(a, za))
            return
        if zb is not None and not (link.has_invert and link.xt is b):
            self._apply_base_monomial(a, link.resolve_for(b, zb))
            return
        qa, qb = self._qubit_of(a), self._qubit_of(b)
        try:
            unit = self._merge((qa, qb))
        except MemoryError as exc:
            if not self.is_ace:
                raise RuntimeError(self._ACE_ADVISORY) from exc
            if not link.has_invert:
                self._elide_cz(qa, qb, link.d)
                return
            # invert link under ACE: condition the control on its most
            # likely BASE value and apply the reduced monomial at base
            # level — the link lives BELOW the pendings, so both the
            # probability and the insertion point must ignore them
            ctrl, tgt = (a, b) if link.xt is b else (b, a)
            pc = self._base_prob1(ctrl)
            bit = 1 if pc >= 0.5 else 0
            self.log_fidelity += math.log(
                max(min(pc if bit else (1.0 - pc), 1.0), FP_NORM_EPSILON))
            self._check_fidelity()
            self._apply_base_monomial(tgt, link.resolve_for(ctrl, bit))
            return
        # diagonal part first (M = V . D, D acts first)
        d0, d1 = link.d[0], link.d[1]
        if np.allclose(d0, 1.0, atol=_EPS):
            if not np.allclose(d1, 1.0, atol=_EPS):
                unit.MCMtrxPerm((a.mapped,), np.diag(d1), b.mapped, 1)
                self._dispatch()
        elif np.allclose(d1, 1.0, atol=_EPS):
            unit.MCMtrxPerm((a.mapped,), np.diag(d0), b.mapped, 0)
            self._dispatch()
        else:
            unit.MCMtrxPerm((), np.diag(d0), b.mapped, 0)
            unit.MCMtrxPerm((a.mapped,), np.diag(d1 / d0), b.mapped, 1)
            self._dispatch(2)
        if link.has_invert:
            ctrl, tgt = (a, b) if link.xt is b else (b, a)
            if link.x[0] and link.x[1]:
                unit.MCMtrxPerm((), mat.X2, tgt.mapped, 0)
                self._dispatch()
            else:
                fire = 1 if link.x[1] else 0
                unit.MCMtrxPerm((ctrl.mapped,), mat.X2, tgt.mapped, fire)
                self._dispatch()

    def _flush_links(self, q: int) -> None:
        s = self.shards[q]
        for link in list(s.links.values()):
            self._resolve_link(link)

    def _flush_pending(self, q: int) -> None:
        s = self.shards[q]
        if s.pending is None:
            return
        # links are always drained first (_flush orders links, then
        # pending), so no link commutation is needed here
        m = s.pending
        s.pending = None
        if s.cached:
            a0 = m[0, 0] * s.amp0 + m[0, 1] * s.amp1
            a1 = m[1, 0] * s.amp0 + m[1, 1] * s.amp1
            s.amp0, s.amp1 = a0, a1
        else:
            s.unit.MCMtrxPerm((), m, s.mapped, 0)
            self._dispatch()

    def _flush(self, q: int) -> None:
        """Clear all buffers above qubit q (links first, then pending)."""
        self._flush_links(q)
        self._flush_pending(q)

    def _flush_all(self) -> None:
        for q in range(self.qubit_count):
            self._flush(q)

    def _buffer_1q(self, q: int, m: np.ndarray) -> None:
        """Apply a 1q unitary lazily at the top of qubit q's stack."""
        s = self.shards[q]
        if not self.phase_fusion and not s.cached:
            s.unit.MCMtrxPerm((), m, s.mapped, 0)
            self._dispatch()
            return
        if s.cached and not s.links:
            # free host math on the cached amplitudes (pending is only
            # ever non-None on cached shards that carry links)
            if s.pending is not None:
                m = m @ s.pending
                s.pending = None
            a0 = m[0, 0] * s.amp0 + m[0, 1] * s.amp1
            a1 = m[1, 0] * s.amp0 + m[1, 1] * s.amp1
            s.amp0, s.amp1 = a0, a1
            return
        if (s.cached and _mat_kind(m) == "diag" and s.pending is None
                and not self._is_x_target(s)):
            # diagonals commute with every link that doesn't X this
            # shard: fold into the base amps
            self._apply_base_diag(s, np.array([m[0, 0], m[1, 1]]))
            return
        nm = m if s.pending is None else m @ s.pending
        s.pending = None if _mat_kind(nm) == "id" else nm

    def _unbuffer_conflicting_links(self, sc: _Shard, st: _Shard) -> None:
        """The link bag is unordered, so members must mutually commute:
        an arriving payload touching (sc, st) conflicts with any OTHER
        pair's link whose invert targets sc or st (X vs. target-indexed
        phases).  Resolve those before buffering."""
        for s in (sc, st):
            for partner, link in list(s.links.items()):
                if (link.has_invert and link.xt is s
                        and partner is not sc and partner is not st):
                    self._resolve_link(link)

    def _link_cancel_check(self, sc: _Shard, st: _Shard, link: _PhaseLink) -> None:
        if link.has_invert:
            return
        scalar = link.uniform_scalar()
        if scalar is not None:
            # pure (global-per-pair) phase: the gate pair cancelled
            del sc.links[st]
            del st.links[sc]
            if abs(scalar - 1) > _EPS:
                self._apply_base_diag(sc, np.array([scalar, scalar]))

    def _buffer_phase_link(self, c: int, t: int, m: np.ndarray,
                           fire_on: int) -> None:
        """Buffer a single-control diagonal gate as a phase link."""
        sc, st = self.shards[c], self.shards[t]
        # pendings must be monomial to commute the diagonal past them
        for q, s in ((c, sc), (t, st)):
            if _mat_kind(s.pending) == "gen":
                self._flush(q)
        self._unbuffer_conflicting_links(sc, st)
        d = np.ones((2, 2), dtype=np.complex128)
        d[fire_on, 0] = m[0, 0]
        d[fire_on, 1] = m[1, 1]
        if _mat_kind(sc.pending) == "anti":
            d = d[::-1, :]
        if _mat_kind(st.pending) == "anti":
            d = d[:, ::-1]
        link = sc.links.get(st)
        if link is None:
            link = _PhaseLink(sc, st, d)
            sc.links[st] = link
            st.links[sc] = link
        else:
            link.absorb_diag(sc, d)
        self._link_cancel_check(sc, st, link)

    def _buffer_invert_link(self, c: int, t: int, m: np.ndarray,
                            fire_on: int) -> None:
        """Buffer a single-control ANTI-diagonal gate (CNOT/CY/phased
        variants) as an invert link: V·D with D = diag(m[1,0], m[0,1])
        on the fire row and V = controlled-X on t (reference: PhaseShard
        isInvert buffering, include/qengineshard.hpp:62-100).  A second
        identical controlled-invert XORs the X away — CNOT echoes never
        reach an engine."""
        sc, st = self.shards[c], self.shards[t]
        if _mat_kind(sc.pending) == "gen":
            self._flush(c)
        if _mat_kind(st.pending) == "gen":
            self._flush(t)
        # X on t does not commute with OTHER links touching t at all
        # (diagonal or invert: either the X or our fire-row phases break
        # the bag's commutation); resolve them first
        for partner, link in list(st.links.items()):
            if partner is not sc:
                self._resolve_link(link)
        self._unbuffer_conflicting_links(sc, st)
        # same-pair link with roles crossed (its invert targets c): the
        # two inverts do not commute; flush it
        link = sc.links.get(st)
        if link is not None and link.has_invert and link.xt is sc:
            self._resolve_link(link)
            link = None
        d2 = np.ones((2, 2), dtype=np.complex128)
        d2[fire_on, 0] = m[1, 0]   # anti = X . diag(bl, tr)
        d2[fire_on, 1] = m[0, 1]
        x2 = [0, 0]
        x2[fire_on] = 1
        # commute the arriving gate below the endpoint pendings:
        # control-side anti swaps which value fires (phases cancel);
        # target-side monomial P = X^p·diag(u0,u1) flips d2's target
        # index if p and adds (ū1·u0, ū0·u1) on the firing rows
        if _mat_kind(sc.pending) == "anti":
            d2 = d2[::-1, :]
            x2 = [x2[1], x2[0]]
        pk = _mat_kind(st.pending)
        if pk in ("diag", "anti"):
            p = st.pending
            if pk == "anti":
                u0, u1 = p[1, 0], p[0, 1]
                d2 = d2[:, ::-1]
            else:
                u0, u1 = p[0, 0], p[1, 1]
            extra = np.array([np.conj(u1) * u0, np.conj(u0) * u1])
            for cb in (0, 1):
                if x2[cb]:
                    d2[cb] = d2[cb] * extra
        if link is None:
            link = _PhaseLink(sc, st, np.ones((2, 2), dtype=np.complex128))
            sc.links[st] = link
            st.links[sc] = link
        link.absorb_invert(sc, d2, x2)
        if link.is_identity():
            del sc.links[st]
            del st.links[sc]
            return
        self._link_cancel_check(sc, st, link)

    # ------------------------------------------------------------------
    # gate primitive with control trimming
    # ------------------------------------------------------------------

    def _logical_z_value(self, s: _Shard) -> Optional[int]:
        """Definite logical Z bit of a cached shard, seen through its
        buffers, or None."""
        if not s.cached:
            return None
        if self._is_x_target(s):
            return None  # value depends on the link's control
        zb = s.base_z_value()
        if zb is not None:
            if s.pending is None:
                return zb
            vec = s.pending[:, zb]
        elif not s.links:
            vec = np.array([s.amp0, s.amp1], dtype=np.complex128)
            if s.pending is not None:
                vec = s.pending @ vec
        else:
            # indefinite base with pending entanglement: unknown
            return None
        nrm = abs(vec[0]) ** 2 + abs(vec[1]) ** 2
        if nrm <= 0.0:
            return None
        p1 = (abs(vec[1]) ** 2) / nrm
        if p1 <= FP_NORM_EPSILON:
            return 0
        if p1 >= 1.0 - FP_NORM_EPSILON:
            return 1
        return None

    def _trim_controls(self, controls, perm) -> Optional[Tuple[tuple, int]]:
        """Elide controls whose cached value is definite (reference:
        TrimControls, src/qunit.cpp:2549). Returns None if the gate
        cannot fire; else (live_controls, live_perm)."""
        live: List[int] = []
        live_perm = 0
        for j, c in enumerate(controls):
            want = (perm >> j) & 1
            have = self._logical_z_value(self.shards[c])
            if have is not None:
                if have != want:
                    return None
                continue
            if want:
                live_perm |= 1 << len(live)
            live.append(c)
        return tuple(live), live_perm

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        self._check_qubit(target)
        m = np.asarray(mtrx, dtype=np.complex128).reshape(2, 2)
        trimmed = self._trim_controls(tuple(controls), perm)
        if trimmed is None:
            return
        live, live_perm = trimmed
        if not live:
            self._buffer_1q(target, m)
            return
        if self.phase_fusion and len(live) == 1 and live[0] != target:
            k = _mat_kind(m)
            if k == "diag":
                self._buffer_phase_link(live[0], target, m, live_perm & 1)
                return
            if k == "anti":
                self._buffer_invert_link(live[0], target, m, live_perm & 1)
                return
        for q in live + (target,):
            self._flush(q)
        try:
            unit = self._merge(tuple(live) + (target,))
        except MemoryError as exc:
            if not self.is_ace:
                raise RuntimeError(self._ACE_ADVISORY) from exc
            # ACE classical shadow: condition on each control's most
            # likely value and pay the fidelity cost of decorrelating
            # (reference: src/qunit.cpp:2715-2760 shadow fallback)
            p_ok, fire = 1.0, True
            for j, cq in enumerate(live):
                want = (live_perm >> j) & 1
                pc = self.Prob(cq)
                p_ok *= max(pc, 1.0 - pc)
                if (1 if pc >= 0.5 else 0) != want:
                    fire = False
            self.log_fidelity += math.log(max(p_ok, FP_NORM_EPSILON))
            self._check_fidelity()
            if fire:
                self._buffer_1q(target, m)
            return
        mapped_ctrls = tuple(self.shards[c].mapped for c in live)
        unit.MCMtrxPerm(mapped_ctrls, m, self.shards[target].mapped, live_perm)
        self._dispatch()

    def Swap(self, q1: int, q2: int) -> None:
        """Logical shard exchange — zero engine work (reference:
        src/qunit.cpp Swap)."""
        if q1 == q2:
            return
        self.shards[q1], self.shards[q2] = self.shards[q2], self.shards[q1]

    def Apply4x4(self, m: np.ndarray, q1: int, q2: int) -> None:
        self._flush(q1)
        self._flush(q2)
        try:
            unit = self._merge((q1, q2))
        except MemoryError as exc:
            if not self.is_ace:
                raise RuntimeError(self._ACE_ADVISORY) from exc
            # synthesize into 1q + controlled primitives, which elide
            # individually under ACE
            from ..interface.synth import apply_small_unitary_via_primitive

            apply_small_unitary_via_primitive(self, m, (q1, q2))
            return
        if hasattr(unit, "Apply4x4"):
            self._dispatch()
            unit.Apply4x4(m, self.shards[q1].mapped, self.shards[q2].mapped)
        else:
            from ..interface.synth import apply_small_unitary_via_primitive

            apply_small_unitary_via_primitive(self, m, (q1, q2))

    # ------------------------------------------------------------------
    # measurement / probability
    # ------------------------------------------------------------------

    def Prob(self, q: int) -> float:
        self._check_qubit(q)
        s = self.shards[q]
        if self._is_x_target(s):
            # an invert link targeting q DOES change its Z marginal
            self._flush_invert_links(q)
        k = _mat_kind(s.pending)
        if k == "gen":
            # a general pending mixes branches whose relative phases the
            # links carry: push the stack down before measuring
            self._flush(q)
            k = "id"
        if s.cached:
            nrm = abs(s.amp0) ** 2 + abs(s.amp1) ** 2
            p1 = (abs(s.amp1) ** 2) / nrm if nrm > 0 else 0.0
        else:
            p1 = s.unit.Prob(s.mapped)
        # diagonal pendings/links never change Z marginals; an
        # anti-diagonal pending just relabels the outcome
        return 1.0 - p1 if k == "anti" else p1

    def ForceM(self, q: int, result: bool, do_force: bool = True, do_apply: bool = True) -> bool:
        self._check_qubit(q)
        s = self.shards[q]
        p1 = self.Prob(q)  # flushes a general pending if present
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
        if not do_apply:
            return res
        base_bit = res ^ (_mat_kind(s.pending) == "anti")
        unit = s.unit
        if not s.cached:
            s.unit.ForceM(s.mapped, base_bit, do_force=True)
        self._separate_bit(q, base_bit)
        if unit is not None and self.reactive_separate:
            # collapse often disentangles the rest (e.g. GHZ): peel off any
            # member that became a Z eigenstate (reference: reactive
            # TrySeparate on measurement, include/qunit.hpp SetReactiveSeparate)
            for qq in list(self._unit_qubits(unit)):
                ss = self.shards[qq]
                if ss.unit is None:
                    continue
                p = ss.unit.Prob(ss.mapped)
                if p <= FP_NORM_EPSILON:
                    ss.unit.ForceM(ss.mapped, False, do_force=True)
                    self._separate_bit(qq, False)
                elif p >= 1.0 - FP_NORM_EPSILON:
                    ss.unit.ForceM(ss.mapped, True, do_force=True)
                    self._separate_bit(qq, True)
        return res

    def MAll(self) -> int:
        """Per-unit measurement: cached qubits draw directly; each unit
        measures once (reference: src/qunit.cpp:1534).  Diagonal links
        never change the joint Z distribution, so they are simply
        dropped after the collapse; monomial pendings relabel outcomes
        (general pendings are flushed first)."""
        for q in range(self.qubit_count):
            if self._is_x_target(self.shards[q]):
                self._flush_invert_links(q)
            if _mat_kind(self.shards[q].pending) == "gen":
                self._flush(q)
        result = 0
        done_units: Dict[int, int] = {}
        for q in range(self.qubit_count):
            s = self.shards[q]
            flip = _mat_kind(s.pending) == "anti"
            if s.cached:
                p1 = self.Prob(q)  # logical prob (anti already folded in)
                if p1 >= 1.0 - FP_NORM_EPSILON:
                    bit = True
                elif p1 <= FP_NORM_EPSILON:
                    bit = False
                else:
                    bit = self.Rand() <= p1
                if bit:
                    result |= 1 << q
            else:
                uid = id(s.unit)
                if uid not in done_units:
                    s.unit.rng = self.rng
                    done_units[uid] = s.unit.MAll()
                if ((done_units[uid] >> s.mapped) & 1) ^ flip:
                    result |= 1 << q
        # everything is separable now; buffers are consumed by collapse
        for q in range(self.qubit_count):
            s = self.shards[q]
            bit = bool((result >> q) & 1)
            s.unit = None
            s.mapped = 0
            s.amp0, s.amp1 = ((0j, 1 + 0j) if bit else (1 + 0j, 0j))
            s.pending = None
            s.links.clear()
        return result

    def ProbParity(self, mask: int) -> float:
        bits = [q for q in range(self.qubit_count) if (mask >> q) & 1]
        # parity is a Z-diagonal observable: diagonal links don't affect
        # it and monomial pendings just flip contributions (invert links
        # targeting a measured bit must resolve first)
        for q in bits:
            if self._is_x_target(self.shards[q]):
                self._flush_invert_links(q)
            if _mat_kind(self.shards[q].pending) == "gen":
                self._flush(q)
        # split by unit: parity distribution composes by XOR convolution
        groups: Dict[int, List[int]] = {}
        singles: List[int] = []
        for q in bits:
            s = self.shards[q]
            if s.cached:
                singles.append(q)
            else:
                groups.setdefault(id(s.unit), []).append(q)
        odds: List[float] = [self.Prob(q) for q in singles]
        for qs in groups.values():
            unit = self.shards[qs[0]].unit
            sub_mask = 0
            flips = 0
            for q in qs:
                sub_mask |= 1 << self.shards[q].mapped
                if _mat_kind(self.shards[q].pending) == "anti":
                    flips ^= 1
            o = unit.ProbParity(sub_mask)
            odds.append(1.0 - o if flips else o)
        p = 0.0
        for o in odds:
            p = p * (1 - o) + (1 - p) * o
        return p

    # ------------------------------------------------------------------
    # separation (reference: TrySeparate, src/qunit.cpp:696-781)
    # ------------------------------------------------------------------

    def TrySeparate(self, qubits, error_tol: Optional[float] = None) -> bool:
        if isinstance(qubits, (int, np.integer)):
            qubits = (int(qubits),)
        tol = error_tol if error_tol is not None else self.sep_threshold
        # buffered links are pending entanglement: resolve them so the
        # probes judge the true state, not the bare base
        for q in qubits:
            if self.shards[q].links:
                self._flush_links(q)
        if len(qubits) == 2:
            return self._try_separate_2qb(qubits[0], qubits[1], tol)
        ok = True
        for q in qubits:
            ok &= self._try_separate_1qb(q, tol)
        return ok

    def _try_separate_2qb(self, q1: int, q2: int, tol: float) -> bool:
        """Two-qubit separation by controlled inverse state preparation
        (reference: src/qunit.cpp:781-856): estimate qubit2's Bloch
        vector conditioned on each value of qubit1, conditionally rotate
        both branches to the pole, attempt 1-qubit separations, then
        restore the state by re-applying the preparations at the logical
        level (where a successful separation makes them cheap buffered/
        trimmed gates).  Non-destructive when separation fails."""
        self._check_qubit(q1)
        self._check_qubit(q2)
        s1, s2 = self.shards[q1], self.shards[q2]
        if s1.cached or s2.cached or s1.unit is not s2.unit:
            ok1 = self._try_separate_1qb(q1, tol)
            ok2 = self._try_separate_1qb(q2, tol)
            return ok1 and ok2
        self._flush(q1)
        self._flush(q2)
        s1, s2 = self.shards[q1], self.shards[q2]
        if s1.cached or s2.cached or s1.unit is not s2.unit:
            ok1 = self._try_separate_1qb(q1, tol)
            ok2 = self._try_separate_1qb(q2, tol)
            return ok1 and ok2
        unit, m1, m2 = s1.unit, s1.mapped, s2.mapped
        # "controlled inverse state preparation": estimate qubit2's
        # conditional Bloch vector (Z; X via H frame; Y via H.S^dag
        # frame, each conjugation undone) and rotate each branch to |0>.
        # The reference's probe sequence (src/qunit.cpp:825-833) layers
        # CH then CS without undoing, which re-measures <X> — here the
        # frames conjugate correctly so <Y> is really <Y>.
        cm, tm = 1 << m1, 1 << m2
        angles = []
        for anti in (False, True):
            ch = unit.AntiCH if anti else unit.CH
            cphase = unit.MACPhase if anti else unit.MCPhase
            cval = 0 if anti else cm
            # the control marginal is invariant under target rotations:
            # one denominator per branch, ProbMask kernel reductions only
            denom = unit.ProbMask(cm, cval)

            def cprob_t1():
                if denom <= FP_NORM_EPSILON:
                    return 0.5
                return min(1.0, unit.ProbMask(cm | tm, cval | tm) / denom)

            z = 1.0 - 2.0 * cprob_t1()
            ch(m1, m2)
            x = 1.0 - 2.0 * cprob_t1()
            ch(m1, m2)
            cphase((m1,), 1.0, -1j, m2)   # (anti)controlled S^dag
            ch(m1, m2)
            y = 1.0 - 2.0 * cprob_t1()
            ch(m1, m2)
            cphase((m1,), 1.0, 1j, m2)    # undo
            inclination = math.atan2(math.hypot(x, y), z)
            azimuth = math.atan2(y, x)
            (unit.AntiCIAI if anti else unit.CIAI)(m1, m2, azimuth, inclination)
            angles.append((azimuth, inclination))
        # q2's conditional branches were both rotated to |0>, so probe it
        # first: its separation shrinks the unit and releases q1's (pure
        # but possibly off-axis) state into the cached shard
        ok2 = self._try_separate_1qb(q2, tol)
        ok1 = self._try_separate_1qb(q1, tol)
        if ok1 and ok2:
            # separation proved the state is a product, so both branch
            # rotations prepare the SAME q2 state (or only one branch is
            # live): restore with one unconditional rotation — no merge
            def bloch(azim, incl):
                return (math.sin(incl) * math.cos(azim),
                        math.sin(incl) * math.sin(azim), math.cos(incl))

            z1 = self._logical_z_value(self.shards[q1])
            if z1 == 1:
                self.AI(q2, *angles[0])
            elif z1 == 0:
                self.AI(q2, *angles[1])
            else:
                v0, v1 = bloch(*angles[0]), bloch(*angles[1])
                if max(abs(a - b) for a, b in zip(v0, v1)) < 1e-6:
                    self.AI(q2, *angles[0])
                else:
                    # branches genuinely differ (e.g. a Bell pair whose
                    # conditionals are pure): the exact restore below
                    # re-entangles, so the pair did NOT end separated
                    self.AntiCAI(q1, q2, *angles[1])
                    self.CAI(q1, q2, *angles[0])
                    return False
            return True
        # failure: exactly undo the unit-level derotations
        self.AntiCAI(q1, q2, *angles[1])
        self.CAI(q1, q2, *angles[0])
        return False

    def _try_separate_1qb(self, q: int, tol: float) -> bool:
        """Probe the *base* (engine) state of q for separability; the
        shard's pending/links stay buffered above whatever it detaches
        to (links reduce only when the detached base is Z-definite)."""
        s = self.shards[q]
        if s.cached:
            return True
        unit = s.unit
        # Z-basis eigenstate?
        p1 = unit.Prob(s.mapped)
        if p1 <= tol:
            unit.ForceM(s.mapped, False, do_force=True)
            self._separate_bit(q, False)
            return True
        if p1 >= 1.0 - tol:
            unit.ForceM(s.mapped, True, do_force=True)
            self._separate_bit(q, True)
            return True
        # X/Y basis probes via cheap conjugation
        for basis, fwd, inv in (
            ("x", (mat.H2,), (mat.H2,)),
            ("y", (mat.H2, mat.IS2), (mat.S2, mat.H2)),
        ):
            for g in fwd:
                unit.MCMtrxPerm((), g, s.mapped, 0)
            p = unit.Prob(s.mapped)
            if p <= tol or p >= 1.0 - tol:
                val = p >= 0.5
                unit.ForceM(s.mapped, val, do_force=True)
                vec = np.array([0.0 + 0j, 0.0 + 0j])
                vec[1 if val else 0] = 1.0
                for g in inv:
                    vec = np.asarray(g) @ vec
                self._detach_raw(q, val, vec)
                return True
            for g in inv:
                unit.MCMtrxPerm((), g, s.mapped, 0)
        return False

    def _detach_raw(self, q: int, collapsed_val: bool, base_vec: np.ndarray) -> None:
        """Remove q from its unit after a raw collapse to `collapsed_val`
        and re-register it cached with base state `base_vec`; buffers
        stay above it (links reduce only for a Z-definite base)."""
        s = self.shards[q]
        unit = s.unit
        mapped = s.mapped
        if unit is not None:
            if _tele._ENABLED:
                _tele.inc("qunit.separate")
            if unit.qubit_count > 1:
                unit.Dispose(mapped, 1, 1 if collapsed_val else 0)
                for other in self.shards:
                    if other.unit is unit and other.mapped > mapped:
                        other.mapped -= 1
            s.unit = None
            s.mapped = 0
        s.amp0, s.amp1 = complex(base_vec[0]), complex(base_vec[1])
        zb = s.base_z_value()
        if zb is not None:
            self._reduce_links(s, zb)
            if s.pending is not None:
                vec = s.pending[:, zb]
                phase = complex(s.amp1 if zb else s.amp0)
                s.amp0, s.amp1 = phase * complex(vec[0]), phase * complex(vec[1])
                s.pending = None
        if unit is not None:
            self._release_if_single(unit)

    # speculative decompose with error check (reference: TryDecompose,
    # include/qinterface.hpp:452; engine TryDecompose + TRYDECOMPOSE_EPSILON)
    def TryDecompose(self, start: int, dest, error_tol: float = TRYDECOMPOSE_EPSILON) -> bool:
        clone = self.Clone()
        try:
            clone.Decompose(start, dest)
        except Exception:
            return False
        # verify the product reconstructs the original
        rebuilt = clone
        rebuilt.Compose(dest.Clone() if hasattr(dest, "Clone") else dest, start)
        if rebuilt.SumSqrDiff(self) > error_tol:
            return False
        self.Decompose(start, dest)
        return True

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------

    def Compose(self, other: "QUnit", start: Optional[int] = None) -> int:
        if start is None:
            start = self.qubit_count
        if isinstance(other, QUnit):
            clone = other.Clone()
            new_shards = clone.shards
        else:
            # foreign engine: wrap it as one unit
            eng = other.Clone() if hasattr(other, "Clone") else other
            new_shards = []
            for i in range(eng.qubit_count):
                s = _Shard()
                s.unit = eng
                s.mapped = i
                new_shards.append(s)
        self.shards[start:start] = new_shards
        self.qubit_count += len(new_shards)
        return start

    def Decompose(self, start: int, dest) -> None:
        length = dest.qubit_count
        self._check_range(start, length)
        qubits = list(range(start, start + length))
        for q in qubits:
            self._flush(q)
        # if the span is exactly a set of whole units + cached shards,
        # hand them over without touching amplitudes
        clean = all(
            self.shards[q].cached or
            all((qq in qubits) for qq in self._unit_qubits(self.shards[q].unit))
            for q in qubits
        )
        state = None
        if clean:
            tmp = QUnit(length, unit_factory=self._factory, rng=self.rng.spawn(),
                        **self._unit_kwargs)
            tmp.shards = [self.shards[q] for q in qubits]
            # remap inside tmp: keep unit refs, mapped stays valid
            state = tmp.GetQuantumState()
        else:
            unit, base = self._order_contiguous(qubits)
            tmp_dest = self._factory(length, rng=self.rng.spawn(), **self._unit_kwargs)
            unit.Decompose(base, tmp_dest)
            for other in self.shards:
                if other.unit is unit and other.mapped >= base + length:
                    other.mapped -= length
            state = np.asarray(tmp_dest.GetQuantumState(), dtype=np.complex128)
            # detach the span's shards before probing the leftover unit,
            # or the 1-qubit release check sees stale members
            for q in qubits:
                self.shards[q].unit = None
            self._release_if_single(unit)
        dest.SetQuantumState(state)
        del self.shards[start:start + length]
        self.qubit_count -= length

    def Dispose(self, start: int, length: int, disposed_perm: Optional[int] = None) -> None:
        self._check_range(start, length)
        if disposed_perm is not None:
            for i in range(length):
                self.ForceM(start + i, bool((disposed_perm >> i) & 1))
        else:
            for i in range(length):
                s = self.shards[start + i]
                if not s.cached or s.links:
                    # measure it out (separable disposal contract); a
                    # cached shard with pending links is link-entangled,
                    # and collapse reduces those links onto the partners
                    self.M(start + i)
        del self.shards[start:start + length]
        self.qubit_count -= length

    def Allocate(self, start: int, length: int = 1) -> int:
        if start < 0 or start > self.qubit_count:
            raise ValueError(f"Allocate start {start} out of range (n={self.qubit_count})")
        self.shards[start:start] = [_Shard() for _ in range(length)]
        self.qubit_count += length
        return start

    # ------------------------------------------------------------------
    # ALU / register ops: entangle the span, forward to the unit
    # (reference: QUnit ALU forwarding via EntangleRange)
    # ------------------------------------------------------------------

    def _reg_op(self, name, regs: Sequence[Tuple[int, int]], extra_bits: Sequence[int],
                call: Callable) -> None:
        """Entangle all registers + extra bits contiguously and invoke
        `call(unit, bases, extra_mapped)`."""
        qubits: List[int] = []
        for (st, ln) in regs:
            qubits.extend(range(st, st + ln))
        qubits.extend(extra_bits)
        for q in qubits:
            self._flush(q)
        unit, base = self._order_contiguous(qubits)
        bases = []
        off = base
        for (st, ln) in regs:
            bases.append(off)
            off += ln
        extra_mapped = list(range(off, off + len(extra_bits)))
        call(unit, bases, extra_mapped)

    # ------------------------------------------------------------------
    # Fourier transforms: closed-form product fast path
    # ------------------------------------------------------------------

    def _product_fourier(self, start: int, length: int, inverse: bool) -> bool:
        """Closed-form QFT/IQFT on a computational-basis register.

        With every shard in range cached, definite, and bufferless, the
        qrack gate order (reference: QInterface::QFT,
        src/qinterface/qinterface.cpp:114) keeps the register a product
        state — every controlled phase has a definite control (QFT) or
        definite target (IQFT) — so the whole transform reduces to one
        O(length^2) host pass over per-qubit phases instead of
        length^2/2 buffered gate calls.  This is the reference
        benchmark protocol's headline optimizer-stack case
        (test_qft_permutation_init)."""
        if not length:
            return True
        sh = self.shards[start:start + length]
        bits = []
        for s in sh:
            if not s.cached or s.pending is not None or s.links:
                return False
            b = s.base_z_value()
            if b is None:
                return False
            bits.append(b)
        n = length
        bv = np.asarray(bits, dtype=np.float64)
        k = np.arange(n)
        d = k[None, :] - k[:, None]                 # t - c
        w = np.where(d > 0, np.exp2(-d.astype(np.float64)), 0.0)
        if not inverse:
            theta = math.pi * (bv @ w)              # on targets t
        else:
            theta = -math.pi * (w @ bv)             # on controls c
        ph = np.exp(1j * theta) / math.sqrt(2.0)
        inv_s2 = 1.0 / math.sqrt(2.0)
        for idx, s in enumerate(sh):
            a = s.amp0 + s.amp1                     # definite amp's phase
            sgn = -1.0 if bits[idx] else 1.0
            s.amp0 = a * inv_s2
            s.amp1 = a * sgn * complex(ph[idx])
        return True

    def QFT(self, start: int, length: int, try_separate: bool = False) -> None:
        if self._product_fourier(start, length, inverse=False):
            return
        super().QFT(start, length, try_separate)

    def IQFT(self, start: int, length: int, try_separate: bool = False) -> None:
        if self._product_fourier(start, length, inverse=True):
            return
        super().IQFT(start, length, try_separate)

    def INC(self, to_add: int, start: int, length: int) -> None:
        if not length:
            return
        self._reg_op("INC", [(start, length)], [],
                     lambda u, b, e: u.INC(to_add, b[0], length))

    def CINC(self, to_add: int, start: int, length: int, controls) -> None:
        trimmed = self._trim_controls(tuple(controls), (1 << len(controls)) - 1)
        if trimmed is None:
            return
        live, _ = trimmed
        if not live:
            return self.INC(to_add, start, length)
        self._reg_op("CINC", [(start, length)], list(live),
                     lambda u, b, e: u.CINC(to_add, b[0], length, tuple(e)))

    def INCDECC(self, to_add: int, start: int, length: int, carry_index: int) -> None:
        self._reg_op("INCDECC", [(start, length)], [carry_index],
                     lambda u, b, e: u.INCDECC(to_add, b[0], length, e[0]))

    def INCS(self, to_add: int, start: int, length: int, overflow_index: int) -> None:
        self._reg_op("INCS", [(start, length)], [overflow_index],
                     lambda u, b, e: u.INCS(to_add, b[0], length, e[0]))

    def INCBCD(self, to_add: int, start: int, length: int) -> None:
        self._reg_op("INCBCD", [(start, length)], [],
                     lambda u, b, e: u.INCBCD(to_add, b[0], length))

    def INCDECBCDC(self, to_add: int, start: int, length: int, carry_index: int) -> None:
        self._reg_op("INCDECBCDC", [(start, length)], [carry_index],
                     lambda u, b, e: u.INCDECBCDC(to_add, b[0], length, e[0]))

    def INCDECSC(self, to_add: int, start: int, length: int, *flags) -> None:
        self._reg_op("INCDECSC", [(start, length)], list(flags),
                     lambda u, b, e: u.INCDECSC(to_add, b[0], length, *e))

    def MUL(self, to_mul: int, in_out_start: int, carry_start: int, length: int) -> None:
        self._reg_op("MUL", [(in_out_start, length), (carry_start, length)], [],
                     lambda u, b, e: u.MUL(to_mul, b[0], b[1], length))

    def DIV(self, to_div: int, in_out_start: int, carry_start: int, length: int) -> None:
        self._reg_op("DIV", [(in_out_start, length), (carry_start, length)], [],
                     lambda u, b, e: u.DIV(to_div, b[0], b[1], length))

    def CMUL(self, to_mul, in_out_start, carry_start, length, controls) -> None:
        self._reg_op("CMUL", [(in_out_start, length), (carry_start, length)],
                     list(controls),
                     lambda u, b, e: u.CMUL(to_mul, b[0], b[1], length, tuple(e)))

    def CDIV(self, to_div, in_out_start, carry_start, length, controls) -> None:
        self._reg_op("CDIV", [(in_out_start, length), (carry_start, length)],
                     list(controls),
                     lambda u, b, e: u.CDIV(to_div, b[0], b[1], length, tuple(e)))

    def MULModNOut(self, to_mul, mod_n, in_start, out_start, length) -> None:
        ol = self._mod_out_length(mod_n)
        self._reg_op("MULModNOut", [(in_start, length), (out_start, ol)], [],
                     lambda u, b, e: u.MULModNOut(to_mul, mod_n, b[0], b[1], length))

    def IMULModNOut(self, to_mul, mod_n, in_start, out_start, length) -> None:
        ol = self._mod_out_length(mod_n)
        self._reg_op("IMULModNOut", [(in_start, length), (out_start, ol)], [],
                     lambda u, b, e: u.IMULModNOut(to_mul, mod_n, b[0], b[1], length))

    def POWModNOut(self, base, mod_n, in_start, out_start, length) -> None:
        ol = self._mod_out_length(mod_n)
        self._reg_op("POWModNOut", [(in_start, length), (out_start, ol)], [],
                     lambda u, b, e: u.POWModNOut(base, mod_n, b[0], b[1], length))

    def IndexedLDA(self, index_start, index_length, value_start, value_length, values,
                   reset_value: bool = True) -> int:
        out = []
        self._reg_op("IndexedLDA", [(index_start, index_length),
                                    (value_start, value_length)], [],
                     lambda u, b, e: out.append(u.IndexedLDA(
                         b[0], index_length, b[1], value_length, values, reset_value)))
        return out[0]

    def IndexedADC(self, index_start, index_length, value_start, value_length,
                   carry_index, values) -> int:
        out = []
        self._reg_op("IndexedADC", [(index_start, index_length),
                                    (value_start, value_length)], [carry_index],
                     lambda u, b, e: out.append(u.IndexedADC(
                         b[0], index_length, b[1], value_length, e[0], values)))
        return out[0]

    def IndexedSBC(self, index_start, index_length, value_start, value_length,
                   carry_index, values) -> int:
        out = []
        self._reg_op("IndexedSBC", [(index_start, index_length),
                                    (value_start, value_length)], [carry_index],
                     lambda u, b, e: out.append(u.IndexedSBC(
                         b[0], index_length, b[1], value_length, e[0], values)))
        return out[0]

    def Hash(self, start: int, length: int, values) -> None:
        self._reg_op("Hash", [(start, length)], [],
                     lambda u, b, e: u.Hash(b[0], length, values))

    def PhaseFlipIfLess(self, greater_perm: int, start: int, length: int) -> None:
        self._reg_op("PhaseFlipIfLess", [(start, length)], [],
                     lambda u, b, e: u.PhaseFlipIfLess(greater_perm, b[0], length))

    def CPhaseFlipIfLess(self, greater_perm: int, start: int, length: int,
                         flag_index: int) -> None:
        self._reg_op("CPhaseFlipIfLess", [(start, length)], [flag_index],
                     lambda u, b, e: u.CPhaseFlipIfLess(greater_perm, b[0], length, e[0]))

    # ------------------------------------------------------------------
    # state access
    # ------------------------------------------------------------------

    def _factors(self):
        """Yield (state_vector, qubits) per Schmidt factor: cached
        shards as normalized 2-vectors, units once at first appearance.
        Callers must have flushed the fusion buffers."""
        seen = set()
        for q in range(self.qubit_count):
            s = self.shards[q]
            if s.cached:
                vec = np.array([s.amp0, s.amp1], dtype=np.complex128)
                nrm = np.linalg.norm(vec)
                if nrm > 0:
                    vec = vec / nrm
                yield vec, [q]
            elif id(s.unit) not in seen:
                seen.add(id(s.unit))
                qs = self._unit_qubits(s.unit)
                yield (np.asarray(s.unit.GetQuantumState(),
                                  dtype=np.complex128), qs)

    def GetQuantumState(self) -> np.ndarray:
        self._flush_all()
        n = self.qubit_count
        # factor order: cached qubits and first-appearance units
        factors: List[Tuple[np.ndarray, List[int]]] = list(self._factors())
        raw = np.array([1.0 + 0j])
        order: List[int] = []  # raw bit position -> logical qubit
        for (vec, qs) in factors:
            raw = np.kron(vec, raw)
            order.extend(qs)
        # permute raw bit positions into logical order
        out = np.zeros(1 << n, dtype=np.complex128)
        idx = np.arange(1 << n, dtype=np.int64)
        logical = np.zeros_like(idx)
        for pos, q in enumerate(order):
            logical |= ((idx >> pos) & 1) << q
        out[logical] = raw
        return out

    def SetQuantumState(self, state) -> None:
        state = np.asarray(state, dtype=np.complex128).reshape(-1)
        if state.shape[0] != (1 << self.qubit_count):
            raise ValueError("state length mismatch")
        for s in self.shards:
            s.pending = None
            s.links.clear()
        unit = self._factory(self.qubit_count, rng=self.rng.spawn(), **self._unit_kwargs)
        unit.SetQuantumState(state)
        for q in range(self.qubit_count):
            s = self.shards[q]
            s.unit = unit
            s.mapped = q
        # opportunistic re-factoring
        for q in range(self.qubit_count):
            self._try_separate_1qb(q, TRYDECOMPOSE_EPSILON)

    def GetAmplitude(self, perm: int) -> complex:
        self._flush_all()
        amp = 1.0 + 0j
        seen = {}
        for q in range(self.qubit_count):
            s = self.shards[q]
            if s.cached:
                vec = np.array([s.amp0, s.amp1])
                nrm = np.linalg.norm(vec)
                a = (vec / nrm)[(perm >> q) & 1] if nrm > 0 else 0.0
                amp *= a
            else:
                uid = id(s.unit)
                if uid in seen:
                    continue
                seen[uid] = True
                sub = 0
                for qq in self._unit_qubits(s.unit):
                    if (perm >> qq) & 1:
                        sub |= 1 << self.shards[qq].mapped
                amp *= s.unit.GetAmplitude(sub)
        return complex(amp)

    def SetPermutation(self, perm: int, phase=None) -> None:
        self.shards = []
        for q in range(self.qubit_count):
            s = _Shard()
            if (perm >> q) & 1:
                s.amp0, s.amp1 = 0j, 1 + 0j
            self.shards.append(s)
        if phase is not None or self.rand_global_phase:
            ph = (cmath.exp(2j * math.pi * self.Rand())
                  if phase is None else complex(phase))
            s0 = self.shards[0] if self.shards else None
            if s0 is not None:
                if abs(s0.amp1) > 0.5:
                    s0.amp1 *= ph
                else:
                    s0.amp0 *= ph

    def Clone(self) -> "QUnit":
        c = QUnit(self.qubit_count, unit_factory=self._factory,
                  rng=self.rng.spawn(), phase_fusion=self.phase_fusion,
                  **self._unit_kwargs)
        c.is_ace = self.is_ace
        c.ace_qubits = self.ace_qubits
        c.log_fidelity = self.log_fidelity
        cloned: Dict[int, object] = {}
        shard_map: Dict[int, _Shard] = {}
        c.shards = []
        for s in self.shards:
            ns = _Shard(s.amp0, s.amp1)
            if s.unit is not None:
                uid = id(s.unit)
                if uid not in cloned:
                    cloned[uid] = s.unit.Clone()
                ns.unit = cloned[uid]
                ns.mapped = s.mapped
            if s.pending is not None:
                ns.pending = s.pending.copy()
            shard_map[id(s)] = ns
            c.shards.append(ns)
        # re-create phase links between the cloned shards
        seen_links = set()
        for s in self.shards:
            for link in s.links.values():
                if id(link) in seen_links:
                    continue
                seen_links.add(id(link))
                na, nb = shard_map[id(link.a)], shard_map[id(link.b)]
                nl = _PhaseLink(na, nb, link.d.copy())
                if link.xt is not None:
                    nl.xt = shard_map[id(link.xt)]
                    nl.x = list(link.x)
                na.links[nb] = nl
                nb.links[na] = nl
        return c

    def SumSqrDiff(self, other) -> float:
        a = self.GetQuantumState()
        b = np.asarray(other.GetQuantumState(), dtype=np.complex128)
        inner = np.vdot(a, b)
        return float(max(0.0, 1.0 - abs(inner) ** 2))

    def GetProbs(self) -> np.ndarray:
        s = self.GetQuantumState()
        return s.real ** 2 + s.imag ** 2

    # separability introspection (reference: test_are_factorized-style)
    def GetUnitCount(self) -> int:
        units = {id(s.unit) for s in self.shards if s.unit is not None}
        return len(units) + sum(1 for s in self.shards if s.cached)

    def GetMaxUnitSize(self) -> int:
        sizes = [s.unit.qubit_count for s in self.shards if s.unit is not None]
        return max(sizes, default=1)

    # ------------------------------------------------------------------
    # structure-aware lossy checkpoints (reference: per-subsystem streams
    # + logical-qubit map, src/qunit_turboquant.cpp:10-45) — each
    # Schmidt factor compresses independently, so a fully-factored
    # 50-qubit register costs 50 two-amplitude records instead of 2^50
    # ------------------------------------------------------------------

    def LossySaveStateVector(self, path: str, bits: int = 8, block_pow: int = 12) -> None:
        import json

        from ..checkpoint.container import save_container
        from ..storage.turboquant import _npz_path, quantize_blocks

        self._flush_all()
        arrays = {}
        factors = []
        idx = 0
        for st, qs in self._factors():
            scales, codes, n = quantize_blocks(st, bits=bits, block_pow=block_pow)
            arrays[f"scales_{idx}"] = scales
            arrays[f"codes_{idx}"] = codes
            factors.append({"qubits": [int(x) for x in qs], "n": int(n)})
            idx += 1
        meta = {"format": "qunit-turboquant-v2", "bits": bits,
                "qubit_count": self.qubit_count, "factors": factors}
        # the json "meta" member keeps the pre-container layout readable
        # by older loaders; the manifest adds checksums + versioning
        arrays["meta"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
        save_container(_npz_path(path), arrays, meta=meta,
                       kind="qunit-turboquant")

    def LossyLoadStateVector(self, path: str) -> None:
        import json

        from ..checkpoint.container import load_container
        from ..storage.turboquant import (_npz_path, dequantize_blocks,
                                          dequantize_blocks_v1, lossy_load)

        kind, meta, z = load_container(_npz_path(path), legacy_ok=True)
        if kind is None and "meta" in z:
            # legacy (pre-container) per-factor archive: json-in-npz meta
            meta = json.loads(bytes(z["meta"]).decode())
            kind = "qunit-turboquant"
        if kind not in ("qunit-turboquant", None, "turboquant-lossy-ket"):
            raise ValueError(f"unsupported QUnit checkpoint kind {kind!r}")
        if kind != "qunit-turboquant":
            self.SetQuantumState(lossy_load(path))  # whole-ket fallback
            return
        fmt = meta.get("format")
        if fmt == "qunit-turboquant-v1":
            decode = dequantize_blocks_v1  # pre-rotation round-<=3 archive
        elif fmt == "qunit-turboquant-v2":
            decode = dequantize_blocks
        else:
            # a per-factor archive in an unknown format can never be
            # decoded by the whole-ket fallback (no top-level codes/
            # scales keys) — fail with the real reason
            raise ValueError(f"unsupported QUnit checkpoint format {fmt!r}")
        if meta["qubit_count"] != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self.shards = [_Shard() for _ in range(self.qubit_count)]
        for i, fm in enumerate(meta["factors"]):
            st = decode(z[f"scales_{i}"], z[f"codes_{i}"],
                        fm["n"], meta["bits"])
            qs = fm["qubits"]
            if len(qs) == 1:
                s = self.shards[qs[0]]
                s.amp0, s.amp1 = complex(st[0]), complex(st[1])
            else:
                unit = self._factory(len(qs), rng=self.rng.spawn(),
                                     **self._unit_kwargs)
                unit.SetQuantumState(st)
                for pos, q in enumerate(qs):
                    self.shards[q].unit = unit
                    self.shards[q].mapped = pos

    def Finish(self) -> None:
        seen = set()
        for s in self.shards:
            if s.unit is not None and id(s.unit) not in seen:
                seen.add(id(s.unit))
                s.unit.Finish()

    def isClifford(self, q: Optional[int] = None) -> bool:
        if q is None:
            return all(s.cached or s.unit.isClifford() for s in self.shards)
        s = self.shards[q]
        return s.cached or s.unit.isClifford()

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py): structured capture —
    # every unit via its own protocol (children), every shard's
    # placement, and the lazy buffers (pending 1q unitaries + the
    # phase-link bag) verbatim.  Nothing is quantized and nothing is
    # FLUSHED: a capture must not change when units get created
    # relative to an uninterrupted run, or the unit-spawning rng draws
    # would land at different stream positions and measurement
    # histories after restore would diverge.
    # ------------------------------------------------------------------

    _ckpt_kind = "unit"

    def _ckpt_capture(self, capture_child):
        arrays = {}
        shards_meta = []
        links_meta = []
        children = {}
        unit_names: Dict[int, str] = {}
        qubit_of = {id(s): q for q, s in enumerate(self.shards)}
        seen_links = set()
        for q in range(self.qubit_count):
            s = self.shards[q]
            sm = {}
            if s.cached:
                sm["amp"] = [s.amp0.real, s.amp0.imag,
                             s.amp1.real, s.amp1.imag]
            else:
                name = unit_names.get(id(s.unit))
                if name is None:
                    name = f"u{len(unit_names)}"
                    unit_names[id(s.unit)] = name
                    children[name] = capture_child(s.unit)
                sm["unit"] = name
                sm["mapped"] = int(s.mapped)
            if s.pending is not None:
                arrays[f"pending_{q}"] = np.asarray(s.pending,
                                                    dtype=np.complex128)
                sm["pending"] = True
            shards_meta.append(sm)
            for link in s.links.values():
                if id(link) in seen_links:
                    continue
                seen_links.add(id(link))
                i = len(links_meta)
                arrays[f"link_{i}_d"] = np.asarray(link.d,
                                                   dtype=np.complex128)
                links_meta.append({
                    "a": qubit_of[id(link.a)], "b": qubit_of[id(link.b)],
                    "xt": (None if link.xt is None
                           else qubit_of[id(link.xt)]),
                    "x": [int(link.x[0]), int(link.x[1])]})
        return {"kind": self._ckpt_kind,
                "meta": {"n": self.qubit_count, "shards": shards_meta,
                         "links": links_meta,
                         "log_fidelity": float(self.log_fidelity)},
                "arrays": arrays, "children": children}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self.shards = [_Shard() for _ in range(self.qubit_count)]
        units = {}
        for name, snap in children.items():
            fresh = self._factory(int(snap["meta"]["n"]),
                                  rng=self.rng.spawn(), **self._unit_kwargs)
            units[name] = restore_child(snap, fresh)
        for q, sm in enumerate(meta["shards"]):
            s = self.shards[q]
            if "unit" in sm:
                s.unit = units[sm["unit"]]
                s.mapped = int(sm["mapped"])
            else:
                a = sm["amp"]
                s.amp0 = complex(a[0], a[1])
                s.amp1 = complex(a[2], a[3])
            if sm.get("pending"):
                s.pending = np.ascontiguousarray(arrays[f"pending_{q}"],
                                                 dtype=np.complex128)
        for i, lm in enumerate(meta.get("links", [])):
            sa, sb = self.shards[lm["a"]], self.shards[lm["b"]]
            link = _PhaseLink(sa, sb, np.ascontiguousarray(
                arrays[f"link_{i}_d"], dtype=np.complex128))
            if lm.get("xt") is not None:
                link.xt = self.shards[lm["xt"]]
                link.x = [int(lm["x"][0]), int(lm["x"][1])]
            sa.links[sb] = link
            sb.links[sa] = link
        self.log_fidelity = float(meta.get("log_fidelity", 0.0))
