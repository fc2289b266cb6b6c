"""QLightCone: lazy circuit buffering with compact-register cone reads.

Like :class:`~qrack_tpu_torch.layers.qtensornetwork.QTensorNetwork`,
gates buffer into a :class:`~qrack_tpu_torch.layers.qcircuit.QCircuit`
instead of
dispatching (reference: include/qtensornetwork.hpp:30).  The difference
is what a read builds: QTensorNetwork runs the cone-sliced circuit on a
FULL-WIDTH stack (a w80 register still allocates w80 state), while this
engine relabels the cone onto a compact register of cone width and
executes it through the routed ladder (``"route"`` — stabilizer / bdt /
turboquant / dense), so the heavy machinery below (fusion windows,
the K1/K2 window kernel and K3-K5, integrity guard, roofline ledger)
prices the CONE, not the declared width.  A w50 depth-4 local expectation costs a w7 dense
ket; the full-width ket is never built.

Relabeling is sound because a gate's control-permutation keys index
control POSITIONS, not qubit numbers (layers/qcircuit.py compile_fn:
perm bit j is the required state of ``controls[j]``), so mapping
target/control indices onto the compact register and keeping payloads +
perm keys verbatim preserves semantics exactly.

Mid-circuit measurement follows the tentpole contract: while the
measured qubit's cone stays narrow (<= QRACK_LIGHTCONE_M_MAX_QB,
default: the dense route cap) the collapse is recorded INTO the buffer
as a normalized projector ``diag(1,0)/sqrt(1-p1)`` / ``diag(0,1)/
sqrt(p1)`` — later cones through the measured qubit replay the
collapse exactly — else the whole buffer materializes into a
full-width base stack (the QTensorNetwork measurement-layer idiom) and
buffering resumes on top of the collapsed base.

Cone engines are cached per cone-qubit set and invalidated on every
buffer mutation; a repeated read (the serve plane polling one
observable) re-uses the materialized cone ket
(``lightcone.cache.hit``).  Reads check the ``lightcone.slice`` fault
site (resilience/faults.py) before slicing, so the integrity soak can
prove a fault here surfaces as a typed error, not silent garbage.

Port notes (the JAX package's lightcone/engine.py otherwise): the
constructor resolves the device at once (``cuda`` unless the caller
passes ``device="cpu"``, raising where there is no GPU) and forwards
``device``/``dtype`` to every cone and base stack; the cone cache is
unbounded, as in the JAX package.  The same seeds give the same cone
stacks, cone-cache keys and draws as the JAX engine on the CPU.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .. import telemetry as _tele
from ..config import FP_NORM_EPSILON
from ..interface import QInterface
from ..layers.qcircuit import QCircuit, QCircuitGate
from ..resilience import faults as _faults
from ..utils.device import resolve_device


def _route_factory(n, **kw):
    from ..factory import create_quantum_interface
    from ..route.cost import route_mode

    # a pinned QRACK_ROUTE=lightcone applies to SESSIONS, not to the
    # cone stacks each read builds — masking it here (auto: route by
    # cost at cone width) is what keeps the rung from recursing into
    # itself; every other pin passes through
    mode = "auto" if route_mode() == "lightcone" else None
    return create_quantum_interface(("route",), n, route_mode=mode, **kw)


def _m_width_cap() -> int:
    """Cone-width ceiling for buffer-projector measurement; past it a
    mid-circuit M forces full materialization."""
    from ..route import cost as _cost

    raw = os.environ.get("QRACK_LIGHTCONE_M_MAX_QB", "")
    try:
        return int(raw) if raw else _cost.RouteKnobs.from_env().dense_max_qb
    except ValueError:
        return _cost.RouteKnobs.from_env().dense_max_qb


def _reverse_cone(gates, seed) -> set:
    """Qubit set of the past light cone of ``seed`` over ``gates`` —
    the same reverse walk as QCircuit.PastLightCone, set-only."""
    cone = set(seed)
    for g in reversed(gates):
        if set(g.qubits()) & cone:
            cone |= set(g.qubits())
    return cone


def _nonunitary(m) -> bool:
    m = np.asarray(m)
    return not np.allclose(m @ m.conj().T, np.eye(2), atol=1e-9)


def compact_over(circuit: QCircuit, qubits) -> Tuple[QCircuit, list]:
    """(compact, order): `circuit`'s past light cone of `qubits`,
    relabeled onto a register of cone width.  ``order[i]`` is the
    original index of compact qubit i.  Gates append DIRECTLY to the
    compact list (no AppendGate peephole: the buffer is already
    merge-normal and the bit-identical gate sequence is what the cone
    digest and checkpoint contract key on)."""
    sliced = circuit.PastLightCone(qubits)
    cone = set(int(q) for q in qubits)
    for g in sliced.gates:
        cone.update(g.qubits())
    order = sorted(cone)
    qmap = {q: i for i, q in enumerate(order)}
    compact = QCircuit(max(len(order), 1))
    compact.gates = [
        QCircuitGate(qmap[g.target],
                     {p: m.copy() for p, m in g.payloads.items()},
                     tuple(qmap[c] for c in g.controls))
        for g in sliced.gates
    ]
    return compact, order


def sliced_shape_key(circuit: QCircuit) -> Tuple[int, int, str]:
    """Batch-bucket key for a lightcone-routed job: the sub-circuit
    relabeled onto its touched qubits (width-independent), so two w50+
    tenants running the same local structure at different qubit offsets
    share a bucket (serve/service.py admission)."""
    touched = sorted({q for g in circuit.gates for q in g.qubits()})
    compact, _ = compact_over(circuit, touched)
    return compact.shape_key(compact.qubit_count)


class QLightCone(QInterface):
    """Buffering engine whose reads build cone-width kets only."""

    _ckpt_kind = "lightcone"

    def __init__(self, qubit_count: int, init_state: int = 0,
                 stack_factory: Optional[Callable] = None, **kwargs):
        # no stack is built until a read, but the device is resolved now
        resolve_device(kwargs.get("device"))
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        self._factory = stack_factory or _route_factory
        self._kw = {k: v for k, v in kwargs.items() if k != "rng"}
        self._init_state = int(init_state)
        self.circuit = QCircuit(qubit_count)
        self.sim = None  # full-width base (post-materialization only)
        # dedicated stream for cone/base construction so reads never
        # consume from the measurement stream (reproducibility)
        self._stack_rng = self.rng.spawn()
        # cone-qubit tuple -> materialized compact engine
        self._cones: Dict[Tuple[int, ...], object] = {}

    # ------------------------------------------------------------------

    def _buffering(self) -> bool:
        return bool(self.circuit.gates) or self.sim is None

    def _touched(self) -> set:
        return {q for g in self.circuit.gates for q in g.qubits()}

    def _cone_request(self, qubits) -> Tuple[int, ...]:
        """Close the requested qubit set over recorded measurement
        projectors.  The reverse cone walk elides trailing gates, which
        is sound for unitaries but NOT for a projector: a collapse on a
        qubit entangled with the read changes the read's marginal even
        when no later gate couples them (Bell pair: M(0) fixes Prob(1)).
        Any non-unitary site whose own past cone intersects the read's
        cone is pulled into the request, to a fixpoint, so the compact
        circuit replays every relevant collapse."""
        req = {int(q) for q in qubits}
        gates = self.circuit.gates
        sites = [(i, g.target) for i, g in enumerate(gates)
                 if not g.controls
                 and any(_nonunitary(m) for m in g.payloads.values())]
        while sites:
            cone = _reverse_cone(gates, req)
            add = {q for i, q in sites
                   if q not in req
                   and _reverse_cone(gates[:i + 1], (q,)) & cone}
            if not add:
                break
            req |= add
        return tuple(sorted(req))

    def _slice(self, qubits) -> Tuple[QCircuit, list]:
        directive = _faults.check("lightcone.slice")
        if directive:
            raise RuntimeError(f"lightcone.slice injected fault: {directive}")
        return compact_over(self.circuit, self._cone_request(qubits))

    def _cone_engine(self, qubits):
        """(engine, qmap) for the past light cone of `qubits`: a cached
        compact-register stack holding the cone ket."""
        compact, order = self._slice(qubits)
        qmap = {q: i for i, q in enumerate(order)}
        # keyed by (cone qubits, sliced-circuit digest): two reads can
        # share a qubit set with DIFFERENT gate subsets (a trailing gate
        # on q is elided from Prob(q') cones but not from a full-state
        # read), so the qubit set alone would alias distinct cone kets
        key = (tuple(order), compact.structure_digest())
        eng = self._cones.get(key)
        if eng is not None:
            if _tele._ENABLED:
                _tele.inc("lightcone.cache.hit")
            return eng, qmap
        base = 0
        for i, q in enumerate(order):
            if (self._init_state >> q) & 1:
                base |= 1 << i
        eng = self._factory(compact.qubit_count, init_state=base,
                            rng=self._stack_rng.spawn(), **self._kw)
        # routed admission + dispatch happen inside Run (route_for), so
        # the cone sub-circuit gets the same ladder/fusion/telemetry
        # treatment a directly-submitted circuit would
        compact.Run(eng)
        if _tele._ENABLED:
            _tele.inc("lightcone.cache.miss")
            _tele.observe("lightcone.cone_width", float(compact.qubit_count))
            _tele.inc("lightcone.gates.cone", len(compact.gates))
            _tele.inc("lightcone.gates.elided",
                      max(len(self.circuit.gates) - len(compact.gates), 0))
        self._cones[key] = eng
        return eng, qmap

    def _note_read(self, eng) -> None:
        if not _tele._ENABLED:
            return
        _tele.inc("lightcone.reads")
        cur = getattr(eng, "current_stack", None)
        stack = cur() if callable(cur) else None
        _tele.inc(f"lightcone.reads.{stack or 'direct'}")

    def _cone_query(self, qubits, fn):
        """Evaluate ``fn(engine, qmap)`` on a cone-width stack; ``qmap``
        maps an original qubit index to the engine's index.  With a
        materialized base the query runs full-width on (a clone of) the
        base — cones no longer compose past a collapsed base state —
        and ``qmap`` is the identity."""
        if self.sim is not None:
            if self.circuit.gates:
                tmp = self.sim.Clone()
                self.circuit.PastLightCone(
                    self._cone_request(qubits)).Run(tmp)
            else:
                tmp = self.sim
            self._note_read(self.sim)
            return fn(tmp, lambda q: q)
        eng, qmap = self._cone_engine(tuple(qubits))
        self._note_read(eng)
        return fn(eng, qmap.__getitem__)

    def _materialize(self) -> None:
        """Run the whole buffer into a full-width base stack (the
        QTensorNetwork measurement-layer idiom).  The routed admission
        inside RunFused may refuse (MisrouteError) — that raise happens
        BEFORE the buffer is reset, so a refused materialization leaves
        the session intact."""
        if self.sim is not None and not self.circuit.gates:
            return   # already materialized, nothing buffered on top
        if _tele._ENABLED:
            _tele.inc("lightcone.materialize.full")
        sim = self.sim
        if sim is None:
            sim = self._factory(self.qubit_count,
                                init_state=self._init_state,
                                rng=self._stack_rng.spawn(), **self._kw)
        if self.circuit.gates:
            self.circuit.RunFused(sim)
        self.sim = sim
        self.circuit = QCircuit(self.qubit_count)
        self._cones.clear()

    # ------------------------------------------------------------------
    # gate primitive: buffer (never dispatch)
    # ------------------------------------------------------------------

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        m = np.asarray(mtrx, dtype=np.complex128).reshape(2, 2)
        self.circuit.append_ctrl(tuple(controls), target, m, perm)
        self._cones.clear()

    # ------------------------------------------------------------------
    # observables: every read is cone-priced
    # ------------------------------------------------------------------

    def Prob(self, q: int) -> float:
        return self._cone_query((q,), lambda s, m: s.Prob(m(q)))

    def ProbParity(self, mask: int) -> float:
        if mask == 0:
            return 0.0
        bits = [q for q in range(self.qubit_count) if (mask >> q) & 1]

        def fn(s, m):
            sub = 0
            for q in bits:
                sub |= 1 << m(q)
            return s.ProbParity(sub)

        return self._cone_query(bits, fn)

    def ProbMask(self, mask: int, perm: int) -> float:
        bits = [q for q in range(self.qubit_count) if (mask >> q) & 1]
        if not bits:
            return 1.0

        def fn(s, m):
            sub_mask = sub_perm = 0
            for q in bits:
                sub_mask |= 1 << m(q)
                if (perm >> q) & 1:
                    sub_perm |= 1 << m(q)
            return s.ProbMask(sub_mask, sub_perm)

        return self._cone_query(bits, fn)

    def ProbMaskAll(self, mask: int) -> np.ndarray:
        bits = [q for q in range(self.qubit_count) if (mask >> q) & 1]
        if not bits:
            return np.ones(1, dtype=np.float64)
        return self.ProbBitsAll(bits)

    def ProbBitsAll(self, bits) -> np.ndarray:
        bits = list(bits)

        def fn(s, m):
            return np.asarray(s.ProbBitsAll([m(b) for b in bits]))

        return self._cone_query(bits, fn)

    def ExpectationBitsAll(self, bits, offset: int = 0) -> float:
        bits = list(bits)

        def fn(s, m):
            return s.ExpectationBitsAll([m(b) for b in bits], offset)

        return self._cone_query(bits, fn)

    def MultiShotMeasureMask(self, q_powers, shots: int) -> dict:
        from ..utils.bits import log2

        bits = [log2(int(p)) for p in q_powers]

        # result keys index q_powers POSITIONS, so remapping the powers
        # onto the compact register preserves every key verbatim
        def fn(s, m):
            return s.MultiShotMeasureMask([1 << m(b) for b in bits], shots)

        return self._cone_query(bits, fn)

    def GetAmplitude(self, perm: int) -> complex:
        if self.sim is not None:
            return self._cone_query(range(self.qubit_count),
                                    lambda s, m: complex(s.GetAmplitude(perm)))
        touched = self._touched()
        # untouched qubits are still exactly |init bit>: they factor out
        # of the amplitude, contributing 1 when the requested bit
        # matches and 0 when it does not
        for q in range(self.qubit_count):
            if q not in touched and ((perm >> q) ^ (self._init_state >> q)) & 1:
                return 0j
        order = sorted(touched) if touched else [0]

        def fn(s, m):
            sub = 0
            for q in order:
                if (perm >> q) & 1:
                    sub |= 1 << m(q)
            return complex(s.GetAmplitude(sub))

        return self._cone_query(order, fn)

    def GetQuantumState(self) -> np.ndarray:
        return self._cone_query(range(self.qubit_count),
                                lambda s, m: np.asarray(s.GetQuantumState()))

    def GetProbs(self) -> np.ndarray:
        return self._cone_query(range(self.qubit_count),
                                lambda s, m: np.asarray(s.GetProbs()))

    # ------------------------------------------------------------------
    # measurement: buffer-projector while the cone is narrow
    # ------------------------------------------------------------------

    def ForceM(self, q: int, result: bool, do_force: bool = True,
               do_apply: bool = True) -> bool:
        if not do_apply:
            return self._cone_query(
                (q,), lambda s, m: s.ForceM(m(q), result, do_force, False))
        if self.sim is not None:
            return self._collapse_on_base(q, result, do_force)
        compact, order = self._slice((q,))
        if len(order) > _m_width_cap():
            # cone too wide for a cheap marginal: fall back to the
            # QTensorNetwork measurement layer (full materialization)
            self._materialize()
            return self._collapse_on_base(q, result, do_force)
        p1 = self._cone_query((q,), lambda s, m: s.Prob(m(q)))
        if do_force:
            res = bool(result)
        elif p1 >= 1.0 - FP_NORM_EPSILON:
            res = True   # deterministic: no rng draw (keeps streams
        elif p1 <= FP_NORM_EPSILON:
            res = False  # aligned with the concrete engines)
        else:
            res = self.Rand() <= p1
        nrm_sq = p1 if res else (1.0 - p1)
        if nrm_sq <= 0.0:
            raise RuntimeError("ForceM: forced result has zero probability")
        proj = np.zeros((2, 2), dtype=np.complex128)
        proj[int(res), int(res)] = 1.0 / math.sqrt(nrm_sq)
        # the recorded (normalized, non-unitary) projector replays the
        # collapse inside every later cone through q — features.py
        # classifies it "general", keeping stabilizer rungs off it
        self.circuit.append_1q(q, proj)
        self._cones.clear()
        if _tele._ENABLED:
            _tele.inc("lightcone.m.projector")
        return res

    def _collapse_on_base(self, q: int, result: bool, do_force: bool) -> bool:
        self._materialize()
        # draw the collapse from OUR measurement stream, then restore
        # the base's own stream (the QTensorNetwork rng-swap idiom)
        saved = self.sim.rng
        self.sim.rng = self.rng
        try:
            return self.sim.ForceM(q, result, do_force, True)
        finally:
            self.sim.rng = saved

    # ------------------------------------------------------------------
    # structure / state
    # ------------------------------------------------------------------

    def SetPermutation(self, perm: int, phase=None) -> None:
        self.circuit = QCircuit(self.qubit_count)
        self.sim = None
        self._init_state = int(perm)
        self._cones.clear()

    def _sync_from_sim(self) -> None:
        self.qubit_count = self.sim.qubit_count
        self.circuit = QCircuit(self.qubit_count)
        self._cones.clear()

    def SetQuantumState(self, state) -> None:
        self._materialize()
        self.sim.SetQuantumState(state)

    def Compose(self, other, start: Optional[int] = None) -> int:
        self._materialize()
        inner = other
        if isinstance(other, QLightCone):
            oc = other.Clone()
            oc._materialize()
            inner = oc.sim
        res = self.sim.Compose(inner, start)
        self._sync_from_sim()
        return res

    def Decompose(self, start: int, dest) -> None:
        self._materialize()
        if isinstance(dest, QLightCone):
            dest._materialize()
            self.sim.Decompose(start, dest.sim)
            dest._sync_from_sim()
        else:
            self.sim.Decompose(start, dest)
        self._sync_from_sim()

    def Dispose(self, start: int, length: int,
                disposed_perm: Optional[int] = None) -> None:
        self._materialize()
        self.sim.Dispose(start, length, disposed_perm)
        self._sync_from_sim()

    def Allocate(self, start: int, length: int = 1) -> int:
        if start == self.qubit_count:
            # append never shifts existing indices: widen the register
            # (new qubits start |0>); cached cones stay valid — the new
            # qubits are untouched by every buffered gate
            if self.sim is not None:
                self.sim.Allocate(start, length)
            self.qubit_count += length
            self.circuit.qubit_count = self.qubit_count
            return start
        self._materialize()
        res = self.sim.Allocate(start, length)
        self._sync_from_sim()
        return res

    def Clone(self) -> "QLightCone":
        c = QLightCone(self.qubit_count, init_state=self._init_state,
                       stack_factory=self._factory, rng=self.rng.spawn(),
                       **self._kw)
        c._stack_rng = self._stack_rng.spawn()
        c.circuit = self.circuit.clone()
        c.sim = self.sim.Clone() if self.sim is not None else None
        return c

    def SumSqrDiff(self, other) -> float:
        a = self.GetQuantumState()
        b = np.asarray(other.GetQuantumState(), dtype=np.complex128)
        inner = np.vdot(a, b)
        return float(max(0.0, 1.0 - abs(inner) ** 2))

    def GetDepth(self) -> int:
        return self.circuit.GetDepth()

    def Finish(self) -> None:
        if self.sim is not None:
            self.sim.Finish()

    def isBuffering(self) -> bool:
        return self._buffering()

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py, kind "lightcone")
    # ------------------------------------------------------------------

    def _ckpt_capture(self, capture_child):
        from ..checkpoint.registry import rng_state

        arrays = {}
        gates_meta = []
        for i, g in enumerate(self.circuit.gates):
            perms = sorted(int(p) for p in g.payloads)
            gates_meta.append({"t": int(g.target),
                               "c": [int(c) for c in g.controls],
                               "p": perms})
            for p in perms:
                arrays[f"g{i}_p{p}"] = np.asarray(g.payloads[p],
                                                  dtype=np.complex128)
        children = {}
        cones_meta = []
        for idx, key in enumerate(sorted(self._cones)):
            order, digest = key
            cones_meta.append({"order": [int(q) for q in order],
                               "digest": str(digest)})
            children[f"cone{idx}"] = capture_child(self._cones[key])
        if self.sim is not None:
            children["sim"] = capture_child(self.sim)
        return {"kind": "lightcone",
                "meta": {"n": self.qubit_count,
                         "init_state": int(self._init_state),
                         "gates": gates_meta,
                         "cones": cones_meta,
                         "stack_rng": rng_state(self._stack_rng)},
                "arrays": arrays,
                "children": children}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        from ..checkpoint.registry import restore_rng

        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self._init_state = int(meta["init_state"])
        circ = QCircuit(self.qubit_count)
        # rebuild the gate list DIRECTLY (no AppendGate peephole): the
        # captured sequence is already merge-normal and must round-trip
        # bit-identically, recorded projectors included
        for i, gm in enumerate(meta.get("gates", [])):
            payloads = {int(p): arrays[f"g{i}_p{p}"] for p in gm["p"]}
            circ.gates.append(QCircuitGate(int(gm["t"]), payloads,
                                           tuple(int(c) for c in gm["c"])))
        self.circuit = circ
        self.sim = (restore_child(children["sim"], self.sim)
                    if "sim" in children else None)
        self._cones = {}
        for idx, cm in enumerate(meta.get("cones", [])):
            key = (tuple(int(q) for q in cm["order"]), str(cm["digest"]))
            self._cones[key] = restore_child(children[f"cone{idx}"])
        if "stack_rng" in meta:
            restore_rng(self._stack_rng, meta["stack_rng"])

    def __repr__(self) -> str:
        return (f"QLightCone(n={self.qubit_count}, "
                f"buffered={len(self.circuit.gates)}, "
                f"cones={len(self._cones)}, "
                f"base={'yes' if self.sim is not None else 'no'})")


__all__ = ["QLightCone", "compact_over", "sliced_shape_key"]
