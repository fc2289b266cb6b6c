"""QBdtHybrid: decision-tree representation until it stops compressing.

Re-design of the reference layer (reference: include/qbdthybrid.hpp:33
— SwitchMode between QBdt and QHybrid on entanglement/compression
ratio). The tree wins while node_count << 2^n; once a gate inflates the
tree past `ratio_threshold * 2^n` nodes, the ket materializes into the
dense engine stack and stays there (the reverse direction is a
later-round refinement, as in the reference's one-way hysteresis).

Port note: a copy of the JAX package's layers/qbdthybrid.py whose
default engine is the port's QHybrid, so a switched register of 13
qubits or more lands on the card (QEngineCUDA, the window kernel).
``device``/``dtype`` reach the tree (its device leaves) and the default
engine; an engine factory from the factory carries its own.  The switch
is the telemetry event ``qbdt.to_dense``.  Checkpoints: the JAX
package's hooks (kind ``"bdt_hybrid"``)."""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from .. import telemetry as _tele
from ..interface import QInterface
from .qbdt import QBdt


class QBdtHybrid(QInterface):
    def __init__(self, qubit_count: int, init_state: int = 0,
                 engine_factory: Optional[Callable] = None,
                 ratio_threshold: float = 0.25,
                 attached_qubits: Optional[int] = None, device=None,
                 dtype=None, **kwargs):
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        self._device, self._dtype = device, dtype
        self._factory = engine_factory or self._default_engine_factory
        self._kw = {k: v for k, v in kwargs.items() if k != "rng"}
        self.ratio = ratio_threshold
        # tree-top/dense-bottom form inside the tree half (reference:
        # Attach under QBdt, include/qbdt.hpp:37-70): the `attached`
        # high qubits terminate in dense leaf kets.  Default off; set
        # explicitly or via QRACK_QBDT_ATTACH_QB.
        if attached_qubits is None:
            attached_qubits = int(os.environ.get("QRACK_QBDT_ATTACH_QB", "0"))
        self.attached_qubits = min(max(int(attached_qubits), 0), qubit_count)
        # before abandoning the tree entirely, try the attached form
        # once (bottom-half entanglement is exactly what dense leaves
        # absorb); off via QRACK_QBDT_ADAPTIVE_ATTACH=0
        self._adaptive_attach = bool(int(os.environ.get(
            "QRACK_QBDT_ADAPTIVE_ATTACH", "1")))
        self.bdt: Optional[QBdt] = QBdt(
            qubit_count, init_state=init_state, rng=self.rng.spawn(),
            attached_qubits=self.attached_qubits, **self._tree_kw())
        self.engine = None

    def _default_engine_factory(self, n, **kw):
        from ..engines.hybrid import QHybrid

        return QHybrid(n, device=self._device, dtype=self._dtype, **kw)

    def _tree_kw(self) -> dict:
        return {**self._kw, "device": self._device, "dtype": self._dtype}

    def _live(self):
        return self.engine if self.engine is not None else self.bdt

    def SwitchToEngine(self, state=None) -> None:
        if self.engine is not None:
            return
        if state is None:
            state = self.bdt.GetQuantumState()
        if _tele._ENABLED:
            _tele.event("qbdt.to_dense", width=self.qubit_count)
        self.engine = self._factory(self.qubit_count, rng=self.rng.spawn(), **self._kw)
        self.engine.SetQuantumState(state)
        self.bdt = None

    def _maybe_switch(self) -> None:
        if self.engine is not None:
            return
        # switch on compression failure: ratio of the dense size for
        # narrow registers, absolute node budget for wide ones (a wide
        # tree must hand off before it exhausts host memory)
        budget = min(self.ratio * (1 << min(self.qubit_count, 30)), float(1 << 20))
        half_dense = (1 << min(self.qubit_count, 30)) // 2
        if self.bdt.attached_qubits:
            # attached trees hold amplitude payloads in their leaves:
            # stay while they genuinely compress vs a dense ket (same
            # criterion that admitted the form below)
            if self.bdt.footprint_amps() <= half_dense:
                return
        elif self.bdt.node_count() <= budget + 8:
            return
        if (self._adaptive_attach and self.attached_qubits == 0
                and self.qubit_count <= 26):
            # one-shot escalation pure-tree -> tree-top/dense-bottom:
            # costs the same 2^n pass the engine switch would, and wins
            # whenever the blowup lives in the bottom half (the
            # "attached beats both pure forms" regime, tests/test_qbdt)
            state = self.bdt.GetQuantumState()
            cand = QBdt(self.qubit_count,
                        attached_qubits=self.qubit_count // 2,
                        rng=self.rng.spawn(), **self._tree_kw())
            cand.rand_global_phase = self.rand_global_phase
            cand.SetQuantumState(state)
            # adopt when the blowup was concentrated in the bottom half:
            # the top tree is back under the node budget (per-gate cost
            # is node-bound — leaves run vectorized kernels) and the
            # leaves actually compress vs a dense ket
            if (cand.node_count() <= budget + 8
                    and cand.footprint_amps() <= half_dense):
                self.bdt = cand
                self.attached_qubits = cand.attached_qubits
                return
            # attached form failed too: hand the already-materialized
            # ket straight to the engine
            self.SwitchToEngine(state)
            return
        self.SwitchToEngine()

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        self._live().MCMtrxPerm(controls, mtrx, target, perm)
        self._maybe_switch()

    def Prob(self, q: int) -> float:
        return self._live().Prob(q)

    def ForceM(self, q, result, do_force=True, do_apply=True) -> bool:
        live = self._live()
        live.rng = self.rng
        return live.ForceM(q, result, do_force, do_apply)

    def MAll(self) -> int:
        live = self._live()
        live.rng = self.rng
        return live.MAll()

    def GetQuantumState(self) -> np.ndarray:
        return np.asarray(self._live().GetQuantumState())

    def SetQuantumState(self, state) -> None:
        if self.engine is not None:
            self.engine.SetQuantumState(state)
        else:
            self.bdt.SetQuantumState(state)
            self._maybe_switch()

    def GetAmplitude(self, perm: int) -> complex:
        return self._live().GetAmplitude(perm)

    def SetPermutation(self, perm: int, phase=None) -> None:
        # reset returns to the compressed representation; phase (explicit
        # or random-global) must survive the rebuild
        self.engine = None
        self.bdt = QBdt(self.qubit_count, rng=self.rng.spawn(),
                        attached_qubits=min(self.attached_qubits,
                                            self.qubit_count),
                        **self._tree_kw())
        self.bdt.rand_global_phase = self.rand_global_phase
        self.bdt.SetPermutation(perm, phase)

    def Compose(self, other, start=None) -> int:
        inner = other._live() if isinstance(other, QBdtHybrid) else other
        res = self._live().Compose(
            inner.Clone() if hasattr(inner, "Clone") else inner, start)
        self.qubit_count = self._live().qubit_count
        self._maybe_switch()
        return res

    def Decompose(self, start, dest) -> None:
        inner = dest._live() if isinstance(dest, QBdtHybrid) else dest
        self._live().Decompose(start, inner)
        if isinstance(dest, QBdtHybrid):
            dest.qubit_count = inner.qubit_count
        self.qubit_count = self._live().qubit_count

    def Dispose(self, start, length, disposed_perm=None) -> None:
        self._live().Dispose(start, length, disposed_perm)
        self.qubit_count = self._live().qubit_count

    def Allocate(self, start, length=1) -> int:
        res = self._live().Allocate(start, length)
        self.qubit_count = self._live().qubit_count
        return res

    def Clone(self) -> "QBdtHybrid":
        c = QBdtHybrid(self.qubit_count, engine_factory=self._factory,
                       ratio_threshold=self.ratio,
                       attached_qubits=self.attached_qubits,
                       rng=self.rng.spawn(), device=self._device,
                       dtype=self._dtype, **self._kw)
        if self.engine is not None:
            c.engine = self.engine.Clone()
            c.bdt = None
        else:
            c.bdt = self.bdt.Clone()
        return c

    def SumSqrDiff(self, other) -> float:
        a = self.GetQuantumState()
        b = np.asarray(other.GetQuantumState(), dtype=np.complex128)
        inner = np.vdot(a, b)
        return float(max(0.0, 1.0 - abs(inner) ** 2))

    def GetProbs(self) -> np.ndarray:
        s = self.GetQuantumState()
        return s.real ** 2 + s.imag ** 2

    def isBinaryDecisionTree(self) -> bool:
        return self.engine is None

    def Finish(self) -> None:
        if self.engine is not None:
            self.engine.Finish()

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py): mode flag + the
    # live half (tree snapshots recurse through QBdt's protocol; the
    # dense half through the factory-built engine)
    # ------------------------------------------------------------------

    _ckpt_kind = "bdt_hybrid"

    def _ckpt_capture(self, capture_child):
        children = {}
        if self.engine is not None:
            children["engine"] = capture_child(self.engine)
        else:
            children["bdt"] = capture_child(self.bdt)
        return {"kind": "bdt_hybrid",
                "meta": {"n": self.qubit_count, "ratio": float(self.ratio),
                         "attached_qubits": int(self.attached_qubits)},
                "children": children}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self.ratio = float(meta.get("ratio", self.ratio))
        self.attached_qubits = int(meta.get("attached_qubits", 0))
        if "engine" in children:
            fresh = self._factory(self.qubit_count, rng=self.rng.spawn(),
                                  **self._kw)
            self.engine = restore_child(children["engine"], fresh)
            self.bdt = None
        else:
            snap = children["bdt"]
            fresh = QBdt(self.qubit_count, rng=self.rng.spawn(),
                         attached_qubits=int(
                             snap["meta"].get("attached_qubits", 0)),
                         **self._tree_kw())
            self.bdt = restore_child(snap, fresh)
            self.engine = None


# heavy ALU / indexed ops: the tree gains nothing from them — hand the
# ket to the dense engine's vectorized kernels (reference: QBdtHybrid
# forwards through its engine half, include/qbdthybrid.hpp)
for _name in ("IndexedLDA", "IndexedADC", "IndexedSBC", "Hash",
              "MUL", "DIV", "CMUL", "CDIV", "MULModNOut", "IMULModNOut",
              "CMULModNOut", "CIMULModNOut", "POWModNOut", "CPOWModNOut"):
    def _mk_engine_fwd(n):
        def fwd(self, *args, **kw):
            self.SwitchToEngine()
            return getattr(self.engine, n)(*args, **kw)

        fwd.__name__ = n
        return fwd

    setattr(QBdtHybrid, _name, _mk_engine_fwd(_name))
