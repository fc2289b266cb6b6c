"""Fleet placement: cost-model bin packing of sessions onto workers
(the port of the JAX package's fleet/placement.py; host only).

The cost model is the router's coarse truth (docs/ROUTING.md) folded
to one number per session: a stabilizer/Clifford session is nearly
free regardless of width (tableau state is O(w²) host bytes — a w100
Clifford costs ~nothing), while a dense session's footprint doubles
per qubit until it owns a whole device budget at
``QRACK_FLEET_DENSE_BUDGET_W`` (default 22, the width whose complex128
ket is ~64 MiB hot plus workspace)::

    cost(layers, width) = 0.01                      stabilizer-family
                          min(1, 2**(w - budget))   otherwise

Every knob is the JAX package's (``DEFAULT_DENSE_BUDGET_W``,
``QRACK_FLEET_DENSE_BUDGET_W``, ``STABILIZER_COST``), as the router kept
its own: the port's dense terminals (``"cuda"``, ``"pager"``,
``"hybrid"``, ``"turboquant"``, ``"turboquant_pager"``, ``"sparse"``,
``"cpu"``, ``"route"``) price as dense exactly as the JAX package's
``"tpu"`` does.  Re-deriving the budget for an 80 GB card is speed work.

Workers have capacity 1.0.  ``place`` picks the least-loaded healthy
worker that still fits; when nothing fits, the least-loaded healthy
worker takes the overflow anyway (the budget is admission *guidance* —
refusing service outright is the front door's call, not placement's)
and ``fleet.placement.overflow`` counts it.  Batch re-placement after
a worker death goes first-fit-decreasing (:meth:`place_all`) so one
big dense session doesn't strand behind twenty tiny Cliffords.

States: ``healthy`` (placeable), ``draining`` (serving but closed to
new sessions — rolling restart), ``quarantined`` (restart budget
exhausted; the breaker owns when it may probe back), ``dead``.
Placement is pure bookkeeping — no I/O, no locks beyond its own; the
supervisor serializes all mutation under its monitor lock.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from .. import telemetry as _tele

DEFAULT_DENSE_BUDGET_W = 22
STABILIZER_COST = 0.01
WORKER_STATES = ("healthy", "draining", "quarantined", "dead")

# terminal layers whose state is polynomial in width (factory.py
# stabilizer family; the routed pseudo-layer classifies per-circuit so
# it prices as dense — the conservative direction)
_CHEAP_LAYERS = ("stabilizer", "clifford", "qunitclifford", "bdt")
# the port's terminals that hold a ket (every name not cheap prices so;
# listed for the reader and the tests)
DENSE_TERMINALS = ("cuda", "pager", "hybrid", "turboquant",
                   "turboquant_pager", "sparse", "cpu", "route")


class NoHealthyWorkers(RuntimeError):
    """Every worker is draining, quarantined, or dead."""


def dense_budget_w() -> int:
    try:
        return int(os.environ.get("QRACK_FLEET_DENSE_BUDGET_W", "")
                   or DEFAULT_DENSE_BUDGET_W)
    except ValueError:
        return DEFAULT_DENSE_BUDGET_W


def session_cost(layers, width: int,
                 budget_w: Optional[int] = None) -> float:
    """Fraction of one worker's device budget this session occupies."""
    if budget_w is None:
        budget_w = dense_budget_w()
    terminal = layers if isinstance(layers, str) else \
        (layers[-1] if layers else "cpu")
    name = str(terminal).lower()
    if any(c in name for c in _CHEAP_LAYERS):
        return STABILIZER_COST
    return float(min(1.0, 2.0 ** (int(width) - budget_w)))


class Placement:
    def __init__(self, capacity: float = 1.0):
        self.capacity = float(capacity)
        self._workers: Dict[str, dict] = {}
        self._owner: Dict[str, str] = {}     # sid -> worker name

    # -- membership ----------------------------------------------------

    def add_worker(self, name: str, capacity: Optional[float] = None
                   ) -> None:
        self._workers[name] = {
            "capacity": self.capacity if capacity is None else capacity,
            "state": "healthy", "sessions": {}}

    def remove_worker(self, name: str) -> None:
        """Forget a retired worker (autoscaler scale-down).  The caller
        must have evicted + re-placed its sessions first; removing a
        worker that still owns sessions would orphan their sids, so it
        is a hard error — the zero-loss protocol bug it would hide is
        worse than the raise."""
        w = self._workers.get(name)
        if w is None:
            return
        if w["sessions"]:
            raise RuntimeError(
                f"remove_worker({name!r}): {len(w['sessions'])} sessions "
                "still placed — evict + re-place before retiring")
        del self._workers[name]

    def set_state(self, name: str, state: str) -> None:
        if state not in WORKER_STATES:
            raise ValueError(f"unknown worker state {state!r} "
                             f"(states: {', '.join(WORKER_STATES)})")
        self._workers[name]["state"] = state

    def state(self, name: str) -> str:
        return self._workers[name]["state"]

    def workers(self, state: Optional[str] = None) -> List[str]:
        return [n for n, w in self._workers.items()
                if state is None or w["state"] == state]

    # -- accounting ----------------------------------------------------

    def load(self, name: str) -> float:
        return sum(self._workers[name]["sessions"].values())

    def owner_of(self, sid: str) -> Optional[str]:
        return self._owner.get(sid)

    def sessions_on(self, name: str) -> List[str]:
        return list(self._workers[name]["sessions"])

    def assign(self, sid: str, name: str, cost: float) -> None:
        prev = self._owner.get(sid)
        if prev is not None:
            self._workers[prev]["sessions"].pop(sid, None)
        self._workers[name]["sessions"][sid] = float(cost)
        self._owner[sid] = name

    def release(self, sid: str) -> None:
        name = self._owner.pop(sid, None)
        if name is not None:
            self._workers[name]["sessions"].pop(sid, None)

    def evict(self, name: str) -> List[Tuple[str, float]]:
        """Strip every session off `name` (death / restart); returns
        ``[(sid, cost)]`` for re-placement."""
        out = sorted(self._workers[name]["sessions"].items())
        for sid, _ in out:
            self._owner.pop(sid, None)
        self._workers[name]["sessions"].clear()
        return out

    # -- decisions -----------------------------------------------------

    def _pick(self, cost: float, exclude: Sequence[str] = ()) -> str:
        healthy = [n for n in self.workers("healthy") if n not in exclude]
        if not healthy:
            raise NoHealthyWorkers(
                "no healthy worker to place onto "
                f"(states: { {n: w['state'] for n, w in self._workers.items()} })")
        # least-loaded that still fits; ties -> fewest sessions -> name
        def key(n):
            return (self.load(n), len(self._workers[n]["sessions"]), n)

        fits = [n for n in healthy
                if self.load(n) + cost <= self._workers[n]["capacity"]]
        if fits:
            return min(fits, key=key)
        if _tele._ENABLED:
            _tele.inc("fleet.placement.overflow")
        return min(healthy, key=key)

    def place(self, sid: str, layers, width: int,
              exclude: Sequence[str] = ()) -> str:
        """Bind `sid` to a worker and return its name."""
        cost = session_cost(layers, width)
        name = self._pick(cost, exclude=exclude)
        self.assign(sid, name, cost)
        if _tele._ENABLED:
            _tele.inc("fleet.placement.placed")
        return name

    def place_all(self, items: Sequence[Tuple[str, float]],
                  exclude: Sequence[str] = ()) -> Dict[str, str]:
        """First-fit-decreasing batch re-placement of ``[(sid, cost)]``
        (a dead worker's evicted set); returns sid -> new worker."""
        out = {}
        for sid, cost in sorted(items, key=lambda t: -t[1]):
            name = self._pick(cost, exclude=exclude)
            self.assign(sid, name, cost)
            out[sid] = name
        if out and _tele._ENABLED:
            _tele.inc("fleet.placement.replaced", len(out))
        return out

    def snapshot(self) -> dict:
        return {name: {"state": w["state"], "load": round(self.load(name), 6),
                       "capacity": w["capacity"],
                       "sessions": sorted(w["sessions"])}
                for name, w in self._workers.items()}


__all__ = ["Placement", "NoHealthyWorkers", "session_cost",
           "dense_budget_w", "DEFAULT_DENSE_BUDGET_W", "STABILIZER_COST",
           "WORKER_STATES", "DENSE_TERMINALS"]
