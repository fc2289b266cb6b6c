"""QStabilizerHybrid: Clifford tableau until a non-Clifford op forces a
dense engine.

Re-design of the reference layer (reference:
include/qstabilizerhybrid.hpp:42; src/qstabilizerhybrid.cpp:206-239
gate triage, :435-500 SwitchToEngine): Clifford ops run on the CHP
tableau; non-Clifford single-qubit gates are buffered as per-qubit
"MpsShards" (pending 2x2 matrices, reference: include/mpsshard.hpp) and
folded back into the tableau whenever the accumulated shard becomes
Clifford again.

When a blocked non-Clifford *phase* shard would force materialization,
the **reverse T-gadget** (reference: src/qstabilizerhybrid.cpp:206-239,
after Pashayan et al., PRX Quantum 3, 020361 App. A) instead moves the
magic onto a fresh tableau ancilla: CNOT(target -> ancilla), the phase
shard re-attaches to the ancilla, then H composes into that shard.  The
tableau stays Clifford with the non-Clifford content buffered on
ancillae; materialization post-selects every ancilla to |0> (each
outcome has probability exactly 1/2, so forcing is always legal) and
disposes it.  The Clifford part of each phase angle is flushed into the
tableau first (S/Z/IS sectors — reference FractionalRzAngleWithFlush,
include/qstabilizerhybrid.hpp:228-259), and residual angles below
QRACK_NONCLIFFORD_ROUNDING_THRESHOLD are rounded away with the fidelity
loss tracked in log_fidelity (reference: README.md:112).

Port note: a copy of the JAX package's layers/stabilizerhybrid.py whose
default engine is the port's QHybrid.  Every engine this layer builds
takes the constructor's keyword arguments (``device``, ``dtype``) with
a fresh ``rng`` spawn.  The switch to the engine is the telemetry event
``stabilizer.to_dense``.  Checkpoints: the JAX package's hooks (kind
``"stabilizer_hybrid"``).  The router's probes: ``on_tableau`` and
``can_run_cheaply``.
"""

from __future__ import annotations

import cmath
import math
import os
from typing import Callable, List, Optional

import numpy as np

from .. import telemetry as _tele
from ..interface import QInterface
from .. import matrices as mat
from .stabilizer import QStabilizer, CliffordError, clifford_sequence


def _default_engine_factory(n, **kw):
    from ..engines.hybrid import QHybrid

    return QHybrid(n, **kw)


class QStabilizerHybrid(QInterface):
    def __init__(self, qubit_count: int, init_state: int = 0,
                 engine_factory: Optional[Callable] = None, **kwargs):
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        self._factory = engine_factory or _default_engine_factory
        self._eng_kwargs = {k: v for k, v in kwargs.items() if k != "rng"}
        self.stab: Optional[QStabilizer] = QStabilizer(
            qubit_count, init_state=init_state, rng=self.rng.spawn(),
            rand_global_phase=self.rand_global_phase)
        self.engine = None
        self.shards: List[Optional[np.ndarray]] = [None] * qubit_count
        # reverse T-gadget state: ancillae live at tableau positions
        # [qubit_count, qubit_count + _anc)
        self._anc = 0
        self.use_t_gadget = os.environ.get("QRACK_DISABLE_T_INJECTION", "0") == "0"
        # budget so that an eventual SwitchToEngine materialization
        # (2^(n + ancillae)) stays within practical dense-engine size
        # (reference ties maxAncillaCount to maxEngineQubitCount,
        # src/qstabilizerhybrid.cpp:83-91)
        self.max_ancilla = int(os.environ.get(
            "QRACK_MAX_ANCILLA_QB", str(max(4, 20 - qubit_count))))
        self.ncrp = self.config.nonclifford_rounding_threshold
        self.log_fidelity = 0.0

    def SetTInjection(self, flag: bool) -> None:
        self.use_t_gadget = bool(flag)

    def GetTInjection(self) -> bool:
        return self.use_t_gadget

    def SetNcrp(self, ncrp: float) -> None:
        self.ncrp = float(ncrp)

    def GetUnitaryFidelity(self) -> float:
        base = math.exp(self.log_fidelity)
        if self.engine is not None:
            return base * self.engine.GetUnitaryFidelity()
        return base

    def ResetUnitaryFidelity(self) -> None:
        self.log_fidelity = 0.0

    # ------------------------------------------------------------------

    def isClifford(self, q: Optional[int] = None) -> bool:
        if self.stab is None:
            return False
        if q is None:
            return all(s is None for s in self.shards)
        return self.shards[q] is None

    def on_tableau(self) -> bool:
        """True while the state is still tableau-resident (no internal
        dense materialization)."""
        return self.engine is None

    def can_run_cheaply(self, circuit) -> bool:
        """Feasibility probe for the router: can `circuit` run without
        forcing SwitchToEngine?  Host-side feature scan only — no gates
        are applied.  Conservative: a general (non-monomial,
        non-Clifford) payload or a magic count past the remaining
        ancilla room means "no"."""
        if self.engine is not None:
            return False
        from ..route.features import extract_features

        f = extract_features(circuit, self.qubit_count)
        room = max(self.max_ancilla - self._anc, 0)
        return f.general_count == 0 and (not self.use_t_gadget
                                         or f.magic_count <= room)

    def SwitchToEngine(self) -> None:
        """Materialize the tableau ket + pending shards into a dense
        engine (reference: src/qstabilizerhybrid.cpp:435).  Gadget
        ancillae are post-selected to |0> (probability exactly 1/2
        each) and disposed, which applies their buffered magic to the
        logical qubits."""
        if self.engine is not None:
            return
        width = self.qubit_count + self._anc
        if _tele._ENABLED:
            _tele.event("stabilizer.to_dense", width=width,
                        ancillae=self._anc)
        ket = self.stab.GetQuantumState()
        self.engine = self._factory(width, rng=self.rng.spawn(),
                                    **self._eng_kwargs)
        self.engine.SetQuantumState(ket)
        for q, s in enumerate(self.shards):
            if s is not None:
                self.engine.Mtrx(s, q)
        while self._anc:
            a = self.qubit_count + self._anc - 1
            self.engine.ForceM(a, False, do_force=True)
            self.engine.Dispose(a, 1, 0)
            self._anc -= 1
        self.stab = None
        self.shards = [None] * self.qubit_count

    def _invert_to_phase(self, q: int) -> None:
        """Convert an anti-diagonal shard D.X into tableau X + phase
        shard D (reference: InvertBuffer)."""
        s = self.shards[q]
        self.stab.X(q)
        self.shards[q] = np.array([[s[0, 1], 0.0], [0.0, s[1, 0]]],
                                  dtype=np.complex128)

    def _flush_shard(self, q: int) -> None:
        """Fold a pending shard into the tableau if it turned Clifford;
        move a non-Clifford phase (or invert) shard onto a gadget
        ancilla; only a general (non-monomial) shard forces the engine."""
        s = self.shards[q]
        if s is None:
            return
        if clifford_sequence(s) is not None:
            # through the tableau's gate path so any global factor of
            # the composed shard folds into phase_offset
            self.stab.MCMtrxPerm((), s, q, 0)
            self.shards[q] = None
            return
        if mat.is_invert(s):
            self._invert_to_phase(q)
            s = self.shards[q]
        if mat.is_phase(s) and self.use_t_gadget and self._ancilla_room():
            self._t_gadget(q)
        else:
            self.SwitchToEngine()

    def _recycle_ancillae(self, only: Optional[int] = None) -> int:
        """Dispose gadget ancillae whose magic went dead (reference
        reuses/disposes dead ancillae, src/qstabilizerhybrid.cpp:206-239
        and the ancilla disposal in FlushBuffers).

        Once the tableau separates an ancilla into a Z eigenstate |b>
        (a later collapse, or a gadget on an eigenstate qubit), the
        deferred postselection <0| shard |b> reduces to a scalar: it
        folds into phase_offset exactly (probability 1/2, no fidelity
        cost) and the tableau column frees via DisposeZ.  This bounds
        ancilla growth under long T streams with interleaved
        measurements instead of forcing SwitchToEngine."""
        freed = 0
        n = self.qubit_count
        positions = ([only] if only is not None
                     else range(n + self._anc - 1, n - 1, -1))
        for a in positions:
            s = self.shards[a]
            # rotate a separable ancilla into the Z basis; the shard is
            # compensated by the inverse rotation on its input side
            if self.stab.IsSeparableZ(a):
                eff, undo = s, None
            elif self.stab.IsSeparableX(a):
                self.stab.H(a)
                eff, undo = s @ np.asarray(mat.H2), ("H",)
            elif self.stab.IsSeparableY(a):
                self.stab.IS(a)
                self.stab.H(a)
                eff = s @ (np.asarray(mat.S2) @ np.asarray(mat.H2))
                undo = ("IS", "H")  # applied order to revert: H then S
            else:
                continue
            b = 1 if self.stab.Prob(a) >= 0.5 else 0
            amp = complex(eff[0, b])
            if abs(amp) <= 1e-12:
                # postselection annihilates this branch: leave the
                # ancilla for the (error-raising) materialized path
                if undo == ("H",):
                    self.stab.H(a)
                elif undo:
                    self.stab.H(a)
                    self.stab.S(a)
                continue
            self.stab.DisposeZ(a)
            self.stab.phase_offset *= amp / abs(amp)
            del self.shards[a]
            self._anc -= 1
            freed += 1
        return freed

    def _ancilla_room(self) -> bool:
        """Room for one more gadget ancilla, recycling dead ones first."""
        if self._anc < self.max_ancilla:
            return True
        self._recycle_ancillae()
        return self._anc < self.max_ancilla

    def _t_gadget(self, q: int) -> None:
        """Reverse T-injection (reference: src/qstabilizerhybrid.cpp:
        206-239): flush the Clifford sector of the shard's phase angle
        into the tableau, then defer the residual onto a fresh ancilla."""
        s = self.shards[q]
        self.shards[q] = None
        angle = cmath.phase(s[1, 1] / s[0, 0]) % (2.0 * math.pi)
        sector = round(angle / (math.pi / 2.0))
        if sector % 4 == 1:
            self.stab.S(q)
        elif sector % 4 == 2:
            self.stab.Z(q)
        elif sector % 4 == 3:
            self.stab.IS(q)
        angle -= sector * (math.pi / 2.0)
        half = angle / 2.0
        # the applied ops are diag(1, i^sector) . diag(e^{-ih}, e^{ih});
        # the shard's leftover global phase folds into the tableau's
        # phase_offset so exact-amplitude parity survives the gadget
        self.stab.phase_offset *= complex(s[0, 0]) * cmath.exp(1j * half)
        if abs(half) <= 1e-12:
            return
        if abs(math.sin(half)) <= self.ncrp:
            # near-Clifford rounding: drop the residual, track fidelity
            # (reference: QRACK_NONCLIFFORD_ROUNDING_THRESHOLD)
            self.log_fidelity += math.log(max(math.cos(half) ** 2, 1e-300))
            self.stab.phase_offset *= cmath.exp(-1j * half)
            return
        a = self.stab.qubit_count
        self.stab.Allocate(a, 1)
        self._anc += 1
        self.stab.CNOT(q, a)
        gate = np.array([[cmath.exp(-1j * half), 0.0],
                         [0.0, cmath.exp(1j * half)]], dtype=np.complex128)
        # ancilla shard = H . P(residual): buffered magic, never blocked
        # because ancillae receive no further gates
        self.shards.append(np.asarray(mat.H2, dtype=np.complex128) @ gate)
        # a gadget on a Z-eigenstate qubit leaves THE FRESH ancilla
        # separable: its magic is already a scalar — reclaim it now
        # (older ancillae cannot have separated here; skip their scans)
        self._recycle_ancillae(only=a)

    # ------------------------------------------------------------------
    # gate primitive
    # ------------------------------------------------------------------

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        if self.engine is not None:
            return self.engine.MCMtrxPerm(controls, mtrx, target, perm)
        m = np.asarray(mtrx, dtype=np.complex128).reshape(2, 2)
        controls = tuple(controls)
        if not controls:
            cur = self.shards[target]
            new = m if cur is None else (m @ cur)
            seq = clifford_sequence(new)
            if seq is not None:
                # through the tableau's own gate path so the composed
                # shard's global phase folds into phase_offset
                self.stab.MCMtrxPerm((), new, target, 0)
                self.shards[target] = None
                return
            if mat.is_phase(new) or mat.is_invert(new):
                self.shards[target] = new
                return
            # composed shard went general: salvage the buffered monomial
            # part before it poisons the qubit (reference gadgets the
            # phase shard the moment a non-commuting gate arrives,
            # src/qstabilizerhybrid.cpp:206-239)
            if cur is not None and self.use_t_gadget and self._ancilla_room():
                # stored shards are never Clifford (they'd have folded at
                # store time), so only the monomial salvage paths exist
                if mat.is_invert(cur):
                    self._invert_to_phase(target)
                    cur = self.shards[target]
                if mat.is_phase(cur):
                    self._t_gadget(target)
                    return self.MCMtrxPerm((), m, target, 0)
            self.shards[target] = new
            return
        # controlled op: shards on participants must be resolved first
        if self.shards[target] is not None and mat.is_phase(m) and mat.is_phase(self.shards[target]):
            pass  # diagonal shard commutes with a diagonal controlled gate
        elif self.shards[target] is not None:
            self._flush_shard(target)
        for c in controls:
            if self.shards[c] is not None:
                if mat.is_phase(self.shards[c]):
                    continue  # diagonal on a control commutes
                self._flush_shard(c)
                if self.engine is not None:
                    break
        if self.engine is not None:
            return self.engine.MCMtrxPerm(controls, mtrx, target, perm)
        try:
            self.stab.MCMtrxPerm(controls, m, target, perm)
        except CliffordError:
            self.SwitchToEngine()
            self.engine.MCMtrxPerm(controls, mtrx, target, perm)

    # ------------------------------------------------------------------
    # measurement / probability
    # ------------------------------------------------------------------

    def Prob(self, q: int) -> float:
        if self.engine is not None:
            return self.engine.Prob(q)
        s = self.shards[q]
        if s is not None and not mat.is_phase(s):
            if self.stab.IsSeparableZ(q):
                # deterministic tableau bit rotated by the shard
                amp = s[:, 1 if self.stab.Prob(q) > 0.5 else 0]
                return float(abs(amp[1]) ** 2)
            self.SwitchToEngine()
            return self.engine.Prob(q)
        if self._anc and self._touches_ancilla(q):
            # entangled with buffered ancilla magic: the raw tableau
            # marginal is wrong — materialize a clone to measure
            # (reference: src/qstabilizerhybrid.cpp:1435-1443)
            c = self.Clone()
            c.SwitchToEngine()
            return c.engine.Prob(q)
        return self.stab.Prob(q)

    def _touches_ancilla(self, q: int) -> bool:
        """Is q (transitively) in the same generator-support component as
        any gadget ancilla?  Unitaries on other qubits never change q's
        marginal — only the ancillae's post-selected shards can."""
        n = self.qubit_count
        return self.stab.EntangledWith(q, n, n + self._anc)

    def ForceM(self, q: int, result: bool, do_force: bool = True, do_apply: bool = True) -> bool:
        if self.engine is not None:
            return self.engine.ForceM(q, result, do_force, do_apply)
        s = self.shards[q]
        if s is not None and not mat.is_phase(s):
            self.SwitchToEngine()
            return self.engine.ForceM(q, result, do_force, do_apply)
        if self._anc and self._touches_ancilla(q):
            # the outcome must follow the true (ancilla-weighted)
            # marginal (reference: src/qstabilizerhybrid.cpp:1560-1570),
            # but the Z collapse itself commutes with the ancilla
            # shards + postselection (they act on DIFFERENT qubits): so
            # draw via a materialized clone, then force the collapse on
            # the live tableau — the stabilizer representation survives
            # the measurement and dead ancillae recycle right after
            p1 = self.Prob(q)
            if not do_force:
                result = bool(self.rng.rand() < p1)
            else:
                result = bool(result)
                if (p1 if result else 1.0 - p1) <= 1e-12:
                    raise RuntimeError("ForceM on zero-probability branch")
            if not do_apply:
                return result
            if s is not None:
                self.shards[q] = None  # diagonal shard dies with collapse
            self.stab.ForceM(q, result, do_force=True, do_apply=True)
            self._recycle_ancillae()
            return result
        if s is not None and do_apply:
            self.shards[q] = None  # diagonal shard is destroyed by collapse
        # the tableau draws from OUR stream for reproducibility
        self.stab.rng = self.rng
        # this branch is only reached when q is disjoint from every
        # ancilla (_touches_ancilla was False), so the collapse cannot
        # have separated any — no recycle sweep needed here
        return self.stab.ForceM(q, result, do_force, do_apply)

    # ------------------------------------------------------------------
    # structure / state access — forward to whichever side is live
    # ------------------------------------------------------------------

    def _live(self):
        return self.engine if self.engine is not None else self.stab

    def Compose(self, other: "QStabilizerHybrid", start: Optional[int] = None) -> int:
        if start is None:
            start = self.qubit_count
        inner = other
        if isinstance(other, QStabilizerHybrid):
            self.log_fidelity += other.log_fidelity
            if self.engine is None and other.engine is None and start == self.qubit_count:
                n, a_cnt = self.qubit_count, self._anc
                m = other.qubit_count
                try:
                    # append at the tableau end, then relabel columns so
                    # the layout stays [logical | ancillae]:
                    # [n][A][m][B] -> [n][m][A][B]
                    self.stab.Compose(other.stab, self.stab.qubit_count)
                    perm = (list(range(n))
                            + list(range(n + a_cnt, n + a_cnt + m))
                            + list(range(n, n + a_cnt))
                            + list(range(n + a_cnt + m, n + a_cnt + m + other._anc)))
                    self.stab.PermuteQubits(perm)
                    self.shards = (self.shards[:n] + list(other.shards[:m])
                                   + self.shards[n:]
                                   + list(other.shards[m:]))
                    self._anc = a_cnt + other._anc
                    self.qubit_count += m
                    return start
                except (NotImplementedError, CliffordError):
                    pass  # fall through to the engine
            self.SwitchToEngine()
            other_clone = other.Clone()
            other_clone.SwitchToEngine()
            inner = other_clone.engine
        else:
            self.SwitchToEngine()
        res = self.engine.Compose(inner, start)
        self.qubit_count = self.engine.qubit_count
        self.shards = [None] * self.qubit_count
        return res

    def Decompose(self, start: int, dest: "QStabilizerHybrid") -> None:
        length = dest.qubit_count
        if self.engine is None:
            try:
                if isinstance(dest, QStabilizerHybrid):
                    self.stab.Decompose(start, dest.stab)
                    dest.shards = self.shards[start:start + length]
                else:
                    self.stab.Decompose(start, dest)
                del self.shards[start:start + length]
                self.qubit_count -= length
                return
            except (NotImplementedError, CliffordError):
                self.SwitchToEngine()
        if isinstance(dest, QStabilizerHybrid):
            dest.SwitchToEngine()
            self.engine.Decompose(start, dest.engine)
            dest.qubit_count = dest.engine.qubit_count
        else:
            self.engine.Decompose(start, dest)
        del self.shards[start:start + length]
        self.qubit_count = self.engine.qubit_count

    def Dispose(self, start: int, length: int, disposed_perm: Optional[int] = None) -> None:
        if self.engine is None:
            try:
                self.stab.Dispose(start, length, disposed_perm)
                del self.shards[start:start + length]
                self.qubit_count -= length
                return
            except (NotImplementedError, CliffordError):
                self.SwitchToEngine()
        self.engine.Dispose(start, length, disposed_perm)
        del self.shards[start:start + length]
        self.qubit_count = self.engine.qubit_count

    def Allocate(self, start: int, length: int = 1) -> int:
        if self.engine is None:
            if start != self.qubit_count:
                self.SwitchToEngine()
            else:
                n, a_cnt = self.qubit_count, self._anc
                self.stab.Allocate(self.stab.qubit_count, length)
                if a_cnt:
                    perm = (list(range(n))
                            + list(range(n + a_cnt, n + a_cnt + length))
                            + list(range(n, n + a_cnt)))
                    self.stab.PermuteQubits(perm)
                self.shards[n:n] = [None] * length
                self.qubit_count += length
                return start
        res = self.engine.Allocate(start, length)
        self.shards[start:start] = [None] * length
        self.qubit_count = self.engine.qubit_count
        return res

    def GetQuantumState(self) -> np.ndarray:
        if self.engine is not None:
            return self.engine.GetQuantumState()
        if self._anc == 0 and all(s is None for s in self.shards):
            return self.stab.GetQuantumState()
        c = self.Clone()
        c.SwitchToEngine()
        return c.engine.GetQuantumState()

    def SetQuantumState(self, state) -> None:
        state = np.asarray(state, dtype=np.complex128).reshape(-1)
        self.shards = [None] * self.qubit_count
        self._anc = 0
        self.log_fidelity = 0.0
        try:
            stab = QStabilizer(self.qubit_count, rng=self.rng.spawn(),
                               rand_global_phase=self.rand_global_phase)
            stab.SetQuantumState(state)
            self.stab = stab
            self.engine = None
        except (CliffordError, NotImplementedError):
            if self.engine is None:
                self.engine = self._factory(self.qubit_count, rng=self.rng.spawn(),
                                            **self._eng_kwargs)
                self.stab = None
            self.engine.SetQuantumState(state)

    def GetAmplitude(self, perm: int) -> complex:
        if self.engine is not None:
            return self.engine.GetAmplitude(perm)
        if self._anc == 0 and all(s is None for s in self.shards):
            return self.stab.GetAmplitude(perm)
        return complex(self.GetQuantumState()[perm])

    def SetAmplitude(self, perm: int, amp: complex) -> None:
        self.SwitchToEngine()
        self.engine.SetAmplitude(perm, amp)

    def SetPermutation(self, perm: int, phase=None) -> None:
        # reset returns to the cheap representation (reference behavior)
        self.engine = None
        self.stab = QStabilizer(self.qubit_count, init_state=perm,
                                rng=self.rng.spawn(),
                                rand_global_phase=self.rand_global_phase)
        self.shards = [None] * self.qubit_count
        self._anc = 0
        self.log_fidelity = 0.0

    def Clone(self) -> "QStabilizerHybrid":
        c = QStabilizerHybrid(self.qubit_count, engine_factory=self._factory,
                              rng=self.rng.spawn(), **self._eng_kwargs)
        if self.engine is not None:
            c.engine = self.engine.Clone()
            c.stab = None
        else:
            c.stab = self.stab.Clone()
        c.shards = [None if s is None else s.copy() for s in self.shards]
        c._anc = self._anc
        c.use_t_gadget = self.use_t_gadget
        c.max_ancilla = self.max_ancilla
        c.ncrp = self.ncrp
        c.log_fidelity = self.log_fidelity
        return c

    def SumSqrDiff(self, other) -> float:
        a = self.GetQuantumState()
        b = np.asarray(other.GetQuantumState(), dtype=np.complex128)
        inner = np.vdot(a, b)
        return float(max(0.0, 1.0 - abs(inner) ** 2))

    def GetProbs(self) -> np.ndarray:
        if self.engine is not None:
            return self.engine.GetProbs()
        s = self.GetQuantumState()
        return s.real ** 2 + s.imag ** 2

    def Finish(self) -> None:
        if self.engine is not None:
            self.engine.Finish()


    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py): mode state — the
    # tableau (ancillae included) or the dense engine — plus the
    # pending per-qubit 2x2 shards and the T-gadget bookkeeping
    # ------------------------------------------------------------------

    _ckpt_kind = "stabilizer_hybrid"

    def _ckpt_capture(self, capture_child):
        arrays = {}
        shard_qubits = []
        for q, s in enumerate(self.shards):
            if s is not None:
                arrays[f"shard_{q}"] = np.asarray(s, dtype=np.complex128)
                shard_qubits.append(q)
        children = {}
        if self.stab is not None:
            children["stab"] = capture_child(self.stab)
        if self.engine is not None:
            children["engine"] = capture_child(self.engine)
        return {"kind": "stabilizer_hybrid",
                "meta": {"n": self.qubit_count, "anc": int(self._anc),
                         "shard_qubits": shard_qubits,
                         "log_fidelity": float(self.log_fidelity),
                         "use_t_gadget": bool(self.use_t_gadget),
                         "max_ancilla": int(self.max_ancilla),
                         "ncrp": float(self.ncrp)},
                "arrays": arrays, "children": children}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self._anc = int(meta.get("anc", 0))
        self.use_t_gadget = bool(meta.get("use_t_gadget", True))
        self.max_ancilla = int(meta.get("max_ancilla", self.max_ancilla))
        self.ncrp = float(meta.get("ncrp", self.ncrp))
        self.log_fidelity = float(meta.get("log_fidelity", 0.0))
        self.shards = [None] * self.qubit_count
        for q in meta.get("shard_qubits", []):
            self.shards[q] = np.ascontiguousarray(arrays[f"shard_{q}"],
                                                  dtype=np.complex128)
        if "stab" in children:
            snap = children["stab"]
            fresh = QStabilizer(int(snap["meta"]["n"]),
                                rng=self.rng.spawn(),
                                rand_global_phase=self.rand_global_phase)
            self.stab = restore_child(snap, fresh)
        else:
            self.stab = None
        if "engine" in children:
            snap = children["engine"]
            fresh = self._factory(int(snap["meta"]["n"]),
                                  rng=self.rng.spawn(), **self._eng_kwargs)
            self.engine = restore_child(snap, fresh)
        else:
            self.engine = None


# ALU / register ops: not Clifford — materialize, then use the engine's
# vectorized kernels (reference: ALU is engine-level; the tableau never
# sees it)
for _name in ("INC", "CINC", "INCDECC", "INCS", "INCDECSC",
              "INCBCD", "INCDECBCDC",
              "MUL", "DIV",
              "CMUL", "CDIV", "MULModNOut", "IMULModNOut", "CMULModNOut",
              "CIMULModNOut", "POWModNOut", "CPOWModNOut", "IndexedLDA",
              "IndexedADC", "IndexedSBC", "Hash", "PhaseFlipIfLess",
              "CPhaseFlipIfLess", "ROL", "ROR"):
    def _mk_switch(n):
        def fwd(self, *args, **kw):
            if self.engine is None:
                self.SwitchToEngine()
            return getattr(self.engine, n)(*args, **kw)

        fwd.__name__ = n
        return fwd

    setattr(QStabilizerHybrid, _name, _mk_switch(_name))

# Clifford-safe or representation-independent ops: engine when dense,
# universal defaults (which reduce to the primitives above) on tableau
for _name in ("XMask", "ZMask", "PhaseParity", "UniformParityRZ",
              "CUniformParityRZ", "ProbParity", "ForceMParity",
              "MultiShotMeasureMask", "ExpectationBitsAll", "MAll"):
    def _mk_fallback(n):
        def fwd(self, *args, **kw):
            if self.engine is not None:
                return getattr(self.engine, n)(*args, **kw)
            return getattr(QInterface, n)(self, *args, **kw)

        fwd.__name__ = n
        return fwd

    setattr(QStabilizerHybrid, _name, _mk_fallback(_name))
