"""QRouted: lazily-instantiated, feature-routed simulator stack.

The ``"route"`` factory pseudo-layer builds this wrapper instead of a
concrete stack.  Construction is free — no tableau, no planes, no
device traffic — so a w100 session costs nothing until its first
circuit arrives.  The first submitted ``QCircuit`` is classified
(features.py), scored (cost.py), and the winning stack is built by the
ordinary factory, which keeps resilience wrapping and telemetry
counting identical to a hand-picked stack.  Eager gate callers (no
circuit to inspect) get the width-appropriate default: the stabilizer
hybrid, whose own dense escape hatch handles non-Clifford streams.

Thread discipline mirrors serve/: :meth:`plan` is pure host work and
safe on the submit (caller) thread; :meth:`apply_plan` constructs or
escalates engines and runs ONLY on the dispatch-owner thread
(serve/executor.py calls it before each job).  Library callers do both
implicitly on their own thread.

Mis-routes escalate to dense **exactly once** per wrapper, through the
same snapshot-carry the failover chain uses (GetQuantumState onto the
new stack, rng object carried so measurement streams continue):

* a planned escalation — a later circuit's features are infeasible for
  the resident cheap stack — lands BEFORE the circuit runs;
* a stabilizer forced off-tableau mid-stream materializes its internal
  dense engine on its own (layers/stabilizerhybrid.py SwitchToEngine);
  the post-job probe just observes and re-labels it;
* a QBdt whose node count blows past QRACK_ROUTE_BDT_MAX_NODES is
  re-materialized onto dense at the next job/read boundary.

"Dense" is the top of a LADDER, not a single rung: when the width (or
the device HBM budget — cost.py's memory axis) rules the f32 planes
out, the compressed turboquant tier is the dense-equivalent target, and
a quantized session whose drift replays exhaust (DispatchGiveUp from
the integrity plane) escalates turboquant→dense the same monotone
direction when the width allows.  A mis-route that CANNOT escalate
(width past every ladder rung) raises the typed :class:`MisrouteError`
at plan time, before any state is lost.

Port notes (the JAX package's route/router.py otherwise): the dense
rung's terminal is ``"cuda"``; construction resolves the device at
once (``cuda`` unless the caller passes ``device="cpu"``, raising where
there is no GPU), though it still builds no stack; a checkpoint's
``meta["layers"]`` names the dense terminal ``"tpu"``, as the JAX
package writes it, and reads it back as ``"cuda"``.  The serving plane
splits plan and apply across threads (serve/service.py ``submit``
plans through ``route.admit``, serve/executor.py applies); the library
path (``route_for``) does both.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .. import telemetry as _tele
from ..utils.device import resolve_device
from ..utils.rng import QrackRandom
from . import cost as _cost
from .features import extract_features


class MisrouteError(RuntimeError):
    """A routed session needs a dense-equivalent representation but no
    ladder rung (dense planes, compressed turboquant) can hold its
    width on this device budget — the circuit is refused at admission
    rather than destroying the session's cheap-representation state."""


# escalations are monotone UP this ladder: cheap host-side stacks, then
# the compressed dense-equivalent tier, then full f32 planes.  A plan
# may upgrade a pending plan's rung; it never downgrades one.
_RANK = {"stabilizer": 0, "bdt": 0, "qunit": 0, "lightcone": 0,
         "turboquant": 1, "dense": 2}

_QUANT_STACKS = ("turboquant", "turboquant_pager")

# ctor kwargs owned by the quantized tier — stripped when the ladder
# builds any other stack (a quantized session escalating to dense must
# not forward `bits=` into QEngineCUDA)
_TQ_KWARGS = ("bits", "block_pow", "chunk_qb", "seed_rot")


@dataclass
class RouteDecision:
    stack: str
    layers: Tuple[str, ...]
    reason: str                      # "cost" | "pinned" | "default" | ...
    scores: Dict[str, float] = field(default_factory=dict)
    features: Optional[Dict[str, float]] = None


# fleet brownout rung (set via set_brownout, from the worker's
# brownout RPC op): while active, auto-routed circuits that would take
# the full-f32 dense rung are pushed onto the compressed turboquant
# tier instead when it is feasible — ~4x less device memory per session
# buys the overloaded fleet headroom at a bounded (guarded) fidelity
# cost.  Pinned modes are never overridden: an explicit stack choice is
# the tenant's, not the ladder's.
_BROWNOUT = False


def set_brownout(active: bool) -> None:
    global _BROWNOUT
    _BROWNOUT = bool(active)


def brownout_active() -> bool:
    return _BROWNOUT


def decide(circuit, width: int, mode: Optional[str] = None,
           device=None) -> RouteDecision:
    """Score `circuit` at `width` and return the winning decision —
    pure host work, no engine construction (the testable core of the
    admission step).  `device` prices the memory axis against that
    device's budget (cost.RouteKnobs.for_device)."""
    knobs = _cost.RouteKnobs.for_device(device)
    mode = mode or _cost.route_mode()
    f = extract_features(circuit, width)
    stack, scores = _cost.choose_stack(f, knobs, mode=mode)
    reason = "pinned" if mode != "auto" else "cost"
    if (_BROWNOUT and mode == "auto" and stack == "dense"
            and scores.get("turboquant", _cost.INFEASIBLE)
            != _cost.INFEASIBLE):
        stack = "turboquant"
        reason = "brownout"
        if _tele._ENABLED:
            _tele.inc("serve.brownout.quantized")
    if _tele._ENABLED:
        _tele.gauge("route.hbm.budget_bytes",
                    float(_cost.hbm_budget_bytes(knobs)))
        _tele.gauge(f"route.hbm.{stack}.bytes",
                    _cost.hbm_bytes(stack, f, knobs))
        if (scores.get("dense") == _cost.INFEASIBLE
                and width <= knobs.dense_max_qb):
            # the width knob allowed dense; the memory axis vetoed it
            _tele.inc("route.hbm.dense_blocked")
    return RouteDecision(stack=stack,
                         layers=_cost.layers_for(stack, width, knobs),
                         reason=reason,
                         scores=scores, features=f.as_dict())


# live wrappers, for the residency gauges (weak: a dropped session must
# not be pinned alive by its own telemetry)
_LIVE: "weakref.WeakSet[QRouted]" = weakref.WeakSet()


def update_residency() -> None:
    if not _tele._ENABLED:
        return
    counts = {s: 0 for s in _cost.STACKS + ("lightcone",)}
    unrouted = 0
    for eng in list(_LIVE):
        stack = eng.current_stack()
        if stack is None:
            unrouted += 1
        elif stack in counts:
            counts[stack] += 1
    for stack, n in counts.items():
        _tele.gauge(f"route.residency.{stack}", n)
    _tele.gauge("route.residency.unrouted", unrouted)


# reads whose observable result may depend on a cheap representation
# that has silently stopped being cheap — probe (and possibly re-label/
# escalate) before serving them on the library path
_PROBE_BEFORE = frozenset({
    "Prob", "ProbAll", "M", "ForceM", "MAll", "MReg",
    "MultiShotMeasureMask", "GetQuantumState", "GetAmplitude",
    "GetProbs", "ApproxCompare",
})


class QRouted:
    """Forwarding wrapper (the engines/hybrid.py pattern) whose inner
    stack does not exist until routing picks one."""

    _is_routed = True
    _ckpt_kind = "routed"

    def __init__(self, qubit_count: int, init_state: int = 0,
                 rng: Optional[QrackRandom] = None, **kwargs):
        self.qubit_count = int(qubit_count)
        self.rng = rng if rng is not None else QrackRandom()
        self._init_state = int(init_state)
        # explicit mode override (None: QRACK_ROUTE).  The lightcone
        # engine builds its cone stacks with route_mode="auto" so a
        # pinned QRACK_ROUTE=lightcone cannot recurse into the cones.
        self._route_mode = kwargs.pop("route_mode", None)
        self._kwargs = dict(kwargs)       # forwarded to the chosen stack
        # the device every stack of this wrapper lands on, resolved now:
        # a wrapper without a GPU and without device="cpu" raises here,
        # not at its first gate
        self.device = resolve_device(kwargs.get("device"))
        self._decision: Optional[RouteDecision] = None
        self._pending: Optional[RouteDecision] = None
        self._engine = None
        self._escalated = False
        self._misroute_counted = False
        self._lock = threading.Lock()
        _LIVE.add(self)
        update_residency()

    # -- introspection -------------------------------------------------

    @property
    def engine(self):
        return self._engine if self._engine is not None else self

    def current_stack(self) -> Optional[str]:
        d = self._decision
        return d.stack if d is not None else None

    def plans_dense(self) -> bool:
        with self._lock:
            d = self._pending or self._decision
        return d is not None and d.stack == "dense"

    def plans_lightcone(self) -> bool:
        with self._lock:
            d = self._pending or self._decision
        return d is not None and d.stack == "lightcone"

    def note_job(self) -> None:
        """Count a served circuit job under the stack that runs it
        (``route.jobs.<stack>``; serve/executor.py)."""
        if _tele._ENABLED:
            _tele.inc(f"route.jobs.{self.current_stack() or 'pending'}")

    def _knobs(self) -> "_cost.RouteKnobs":
        """The env knobs, priced against this wrapper's device."""
        return _cost.RouteKnobs.for_device(self.device)

    # -- admission: plan (caller thread) / apply (dispatch thread) -----

    def plan(self, circuit) -> RouteDecision:
        """Record the routing decision `circuit` implies.  Pure host
        work.  Decisions are monotone toward dense: once a wrapper
        plans (or holds) the dense stack it never goes back, and a
        cheap-stack session whose new circuit is infeasible for its
        representation gets a planned escalation here — or a typed
        MisrouteError when the width makes escalation impossible."""
        knobs = self._knobs()
        with self._lock:
            if self._engine is None:
                if (self._pending is not None
                        and self._pending.stack == "dense"):
                    return self._pending
                d = decide(circuit, self.qubit_count,
                           mode=self._route_mode, device=self.device)
                if (d.reason == "pinned" and d.stack == "dense"
                        and self.qubit_count
                        > max(knobs.dense_max_qb, _cost._TQ_BASE_CAP)):
                    # a forced-dense pin past every plane-representable
                    # width would build a hybrid that cannot hold the
                    # ket; refuse at admission (the lightcone rung is
                    # what serves these jobs under auto routing)
                    raise MisrouteError(
                        f"QRACK_ROUTE=dense pinned but width "
                        f"{self.qubit_count} exceeds the dense ladder "
                        f"(cap {knobs.dense_max_qb}); unpin to let the "
                        "lightcone/compressed rungs take it")
                if (self._pending is None
                        or _RANK.get(d.stack, 0)
                        > _RANK.get(self._pending.stack, 0)):
                    # first circuit decides; later pre-build circuits
                    # may only upgrade the plan UP the ladder
                    self._pending = d
                    self._note_decision(d)
                return self._pending
            d = self._decision
            if self._escalated or d is None or d.stack == "dense":
                return self._pending or d
            if d.stack == "stabilizer":
                f = extract_features(circuit, self.qubit_count)
                if f.general_count > 0 or f.magic_count > knobs.max_magic:
                    # the cheapest dense-equivalent rung that can hold
                    # this width on the device budget; no rung => refuse
                    target = _cost.ladder_stack(self.qubit_count, knobs)
                    if target is None:
                        raise MisrouteError(
                            f"circuit needs a dense-equivalent "
                            f"representation but width {self.qubit_count} "
                            f"exceeds every ladder rung (dense cap "
                            f"{knobs.dense_max_qb}); refusing rather "
                            "than destroying the stabilizer state")
                    self._pending = RouteDecision(
                        stack=target,
                        layers=_cost.layers_for(target, self.qubit_count,
                                                knobs),
                        reason="misroute:planned", features=f.as_dict())
                    self._note_misroute("planned")
            return self._pending or d

    def apply_plan(self) -> None:
        """Realize the recorded plan: build the first engine, or
        escalate a mis-routed cheap stack to dense.  DISPATCH-OWNER
        THREAD ONLY on the serve path (engine construction and state
        re-materialization are device traffic)."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        if self._engine is None:
            self._build(pending)
        elif (_RANK.get(pending.stack, 0)
                > _RANK.get(self.current_stack(), 0)):
            self._escalate(pending.reason, to_stack=pending.stack)

    # -- engine lifecycle ----------------------------------------------

    def _kwargs_for(self, stack: str) -> dict:
        """Forwarded ctor kwargs, filtered per target stack: the
        quantized tier's knobs must not leak into a dense/cheap build
        (an escalating session would TypeError in QEngineCUDA)."""
        kw = dict(self._kwargs)
        if stack not in _QUANT_STACKS:
            for k in _TQ_KWARGS:
                kw.pop(k, None)
        return kw

    def _build(self, decision: RouteDecision) -> None:
        from ..factory import create_quantum_interface

        self._engine = create_quantum_interface(
            decision.layers, self.qubit_count,
            init_state=self._init_state, rng=self.rng,
            **self._kwargs_for(decision.stack))
        self._decision = decision
        if _tele._ENABLED:
            _tele.inc(f"route.built.{decision.stack}")
            _tele.event("route.build", stack=decision.stack,
                        width=self.qubit_count, reason=decision.reason)
        update_residency()

    def _build_default(self) -> None:
        """Eager-gate path: no circuit to inspect, route by width."""
        with self._lock:
            pending, self._pending = self._pending, None
        if self._engine is not None:
            return
        if pending is None:
            knobs = self._knobs()
            stack = _cost.default_stack(self.qubit_count, knobs,
                                        mode=self._route_mode)
            pending = RouteDecision(
                stack=stack,
                layers=_cost.layers_for(stack, self.qubit_count, knobs),
                reason="default")
            self._note_decision(pending)
        self._build(pending)

    def _escalate(self, reason: str, to_stack: str = "dense") -> None:
        """Snapshot-carry the state onto a higher ladder rung (the
        failover chain's rehydration idiom: full-state read,
        SetQuantumState on the replacement, rng OBJECT carried so the
        measurement stream position survives)."""
        from ..factory import create_quantum_interface

        knobs = self._knobs()
        if to_stack == "dense" and self.qubit_count > knobs.dense_max_qb:
            # a quantized session may still land on the width-switching
            # hybrid up to the engine's representable cap; any other
            # over-cap escalation refuses before state is lost
            if (self.current_stack() not in _QUANT_STACKS
                    or self.qubit_count > _cost._TQ_BASE_CAP):
                raise MisrouteError(
                    f"cannot escalate width {self.qubit_count} to dense "
                    f"(cap {knobs.dense_max_qb})")
        old_stack = self.current_stack()
        state = self._engine.GetQuantumState()
        layers = _cost.layers_for(to_stack, self.qubit_count, knobs)
        new = create_quantum_interface(
            layers, self.qubit_count, rng=self.rng,
            **self._kwargs_for(to_stack))
        new.SetQuantumState(state)
        self._engine = new
        self._decision = RouteDecision(
            stack=to_stack, layers=layers, reason=f"escalated:{reason}")
        # only the TOP rung is terminal: a session escalated into the
        # quantized tier can still climb to dense on drift giveup
        self._escalated = to_stack == "dense"
        if _tele._ENABLED:
            _tele.inc("route.misroute.escalated")
            _tele.event("route.escalate", reason=reason,
                        from_stack=old_stack, to_stack=to_stack,
                        width=self.qubit_count)
        update_residency()

    def _escalate_giveup(self) -> bool:
        """Exhausted drift replays (DispatchGiveUp out of the integrity
        plane) on a quantized stack: climb the ladder to dense rather
        than serving garbage.  The integrity envelope restored the
        pre-window planes before raising and the fuser KEPT the window,
        so reading the state under faults.suspended() re-runs the kept
        gates onto a good base — the triggering call (disjoint from the
        window by the fuser's admit-after-flush discipline) is then
        replayed by the caller, preserving exactly-once.  Returns False
        when no higher rung can hold this width."""
        if (self.current_stack() not in _QUANT_STACKS
                or self.qubit_count > _cost._TQ_BASE_CAP):
            return False
        from ..resilience import faults

        with faults.suspended():
            self._escalate("quant_drift", to_stack="dense")
        return True

    def route_for(self, circuit):
        """Library-path admission (layers/qcircuit.py Run/RunFused):
        plan on the calling thread, realize immediately, and return the
        engine the circuit should dispatch into.  May raise
        :class:`MisrouteError` exactly as the serve admission does."""
        if getattr(circuit, "gates", None):
            self.plan(circuit)
            self.apply_plan()
        if self._engine is None:
            self._build_default()
        return self._engine

    # -- mis-route probes ----------------------------------------------

    def misroute_check(self) -> None:
        """Job/read-boundary probe: has the cheap representation
        silently stopped being cheap?  Re-labels a stabilizer that
        materialized its internal dense engine (that switch WAS the
        escalation — state already lives on the dense escape hatch) and
        escalates a QBdt past its node budget.  Never raises: a tree
        too wide to escalate keeps running exactly, just slowly."""
        if self._engine is None or self._escalated:
            return
        d = self._decision
        if d is None:
            return
        knobs = self._knobs()
        if d.stack == "stabilizer":
            from ..layers.stabilizerhybrid import QStabilizerHybrid

            inner = self._engine
            if (isinstance(inner, QStabilizerHybrid)
                    and inner.engine is not None):
                self._note_misroute("off_tableau")
                self._decision = RouteDecision(
                    stack="dense", layers=d.layers,
                    reason="escalated:off_tableau")
                self._escalated = True
                if _tele._ENABLED:
                    _tele.inc("route.misroute.escalated")
                    _tele.event("route.escalate", reason="off_tableau",
                                from_stack="stabilizer", to_stack="dense",
                                width=self.qubit_count)
                update_residency()
        elif d.stack == "bdt":
            from ..layers.qbdt import QBdt

            inner = self._engine
            if (isinstance(inner, QBdt)
                    and not inner.within_node_budget(knobs.bdt_max_nodes)):
                self._note_misroute("bdt_nodes")
                if self.qubit_count <= knobs.dense_max_qb:
                    self._escalate("bdt_nodes")
                elif _tele._ENABLED:
                    _tele.inc("route.misroute.unescalatable")
        elif d.stack in _QUANT_STACKS:
            # a resilient quantized session whose drift replays gave up
            # already climbed the ladder inside the failover chain
            # (resilience/failover.py rehydrates onto dense); that swap
            # WAS the escalation — observe and re-label
            from ..resilience.failover import ResilientEngine

            inner = self._engine
            if isinstance(inner, ResilientEngine):
                inner = inner.engine
            if getattr(inner, "_tq_bits", None) is None:
                self._note_misroute("quant_drift")
                self._decision = RouteDecision(
                    stack="dense", layers=d.layers,
                    reason="escalated:quant_drift")
                self._escalated = True
                if _tele._ENABLED:
                    _tele.inc("route.misroute.escalated")
                    _tele.event("route.escalate", reason="quant_drift",
                                from_stack=d.stack, to_stack="dense",
                                width=self.qubit_count)
                update_residency()

    def _note_decision(self, d: RouteDecision) -> None:
        if _tele._ENABLED:
            _tele.inc("route.decisions")
            _tele.inc(f"route.decision.{d.stack}")
            _tele.event("route.decision", stack=d.stack, reason=d.reason,
                        **(d.features or {"width": self.qubit_count}))

    def _note_misroute(self, reason: str) -> None:
        if self._misroute_counted:
            return
        self._misroute_counted = True
        if _tele._ENABLED:
            # telemetry.event() also bumps a counter under the event's
            # own name, so the aggregate counter takes the plural
            _tele.inc("route.misroutes")
            _tele.event("route.misroute", reason=reason,
                        stack=self.current_stack() or "pending",
                        width=self.qubit_count)

    # -- forwarding ----------------------------------------------------

    def __getattr__(self, name):
        # private/dunder probes must never force an engine into
        # existence (hasattr checks, pickling, elastic probes)
        if name.startswith("_"):
            raise AttributeError(name)
        if self.__dict__.get("_engine") is None:
            self._build_default()
        if name in _PROBE_BEFORE:
            self.misroute_check()
        attr = getattr(self._engine, name)
        d = self.__dict__.get("_decision")
        if callable(attr) and d is not None and d.stack in _QUANT_STACKS:
            return self._ladder_guard(name, attr)
        return attr

    def _ladder_guard(self, name, attr):
        """Last-resort DispatchGiveUp net for quantized sessions whose
        terminal is not resilient-wrapped (resilience armed after the
        engine was built, so no ResilientEngine sits below to fail over
        first): climb the ladder to dense and replay the triggering
        call exactly once (disjoint from the kept window)."""
        import functools

        from ..resilience.errors import DispatchGiveUp

        @functools.wraps(attr)
        def call(*args, **kwargs):
            try:
                return attr(*args, **kwargs)
            except DispatchGiveUp:
                if not self._escalate_giveup():
                    raise
                return getattr(self._engine, name)(*args, **kwargs)

        return call

    def __repr__(self) -> str:
        stack = self.current_stack() or "unrouted"
        return (f"QRouted(n={self.qubit_count}, stack={stack}, "
                f"engine={type(self._engine).__name__})")

    # -- checkpoint protocol (checkpoint/registry.py) ------------------

    def _ckpt_capture(self, capture_child):
        if self._engine is None:
            # materialize the default stack so the snapshot holds real
            # state; spill-before-first-use is rare and |0..0> is cheap
            # on every default stack
            self._build_default()
        d = self._decision
        return {"kind": "routed",
                "meta": {"n": self.qubit_count,
                         "stack": d.stack if d else None,
                         # the file names the dense terminal "tpu",
                         # as the JAX package writes it
                         "layers": (["tpu" if x == "cuda" else x
                                     for x in d.layers] if d else None),
                         "reason": d.reason if d else None,
                         "escalated": bool(self._escalated),
                         "misroute_counted": bool(self._misroute_counted)},
                "children": {"engine": capture_child(self._engine)}}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        layers = tuple("cuda" if x == "tpu" else x
                       for x in meta.get("layers") or ())
        stack = meta.get("stack")
        self._escalated = bool(meta.get("escalated", False))
        self._misroute_counted = bool(meta.get("misroute_counted", False))
        self._pending = None
        if stack is not None and (self._engine is None
                                  or self.current_stack() != stack):
            from ..factory import create_quantum_interface

            self._engine = create_quantum_interface(
                layers, self.qubit_count, rng=self.rng,
                **self._kwargs_for(stack))
        self._decision = (RouteDecision(stack=stack, layers=layers,
                                        reason=meta.get("reason")
                                        or "restored")
                          if stack is not None else None)
        if self._engine is not None:
            self._engine = restore_child(children["engine"], self._engine)
            rng = getattr(self._engine, "rng", None)
            if rng is not None:
                self.rng = rng
        update_residency()


__all__ = ["QRouted", "RouteDecision", "MisrouteError", "decide",
           "update_residency", "set_brownout", "brownout_active"]
