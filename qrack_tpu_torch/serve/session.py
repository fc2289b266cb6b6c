"""Multi-tenant simulator sessions (the port of the JAX package's
serve/session.py).

A Session owns one engine stack (built through the factory, so
resilience wrapping and telemetry counting apply unchanged) plus the
bookkeeping the scheduler and evictor need: a private seeded rng
stream (utils/rng.py — tenant measurement streams must never couple),
idle timestamps, an in-flight counter, and per-session stats that back
the `serve.*` telemetry attribution.

Engine CONSTRUCTION is device traffic (SetPermutation dispatches), so
SessionManager.create is only ever called on the executor thread —
the service routes it there as an admin job (executor.py is the single
dispatch owner).

Port notes: a session's engine is built by the port's factory, on
``cuda`` unless its keyword arguments carry ``device="cpu"``; a store
record written by the JAX package names the dense terminal ``"tpu"``,
which :func:`port_layers` reads as ``"cuda"`` (spill fault-in and
recovery both rebuild through it).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .. import telemetry as _tele
from ..factory import _HOST_TERMINALS as HOST_TERMINALS
from ..factory import create_quantum_interface, touches_accelerator
from ..utils.rng import QrackRandom
from .errors import SessionNotFound


def port_layers(layers):
    """A layer spec with the JAX package's dense terminal ``"tpu"`` read
    as the port's ``"cuda"`` (store records of either package)."""
    if isinstance(layers, str):
        return "cuda" if layers == "tpu" else layers
    return [("cuda" if x == "tpu" else x) for x in layers]


def terminal(layers) -> str:
    """The terminal of a layer spec ("optimal" names its own)."""
    layers = port_layers(layers)
    if isinstance(layers, str):
        return layers
    return layers[-1] if layers else ""


def planes_engine(engine):
    """Unwrap `engine` to its plane-backed dense core (QEngineCUDA) if it
    has one — through the router, the ResilientEngine proxy and QHybrid's
    width switch — else None.  Only such engines can join a batch: their
    whole ket is one (2, 2^n) tensor the batcher can fold.
    Paged/compressed/CPU engines run as singleton jobs."""
    from ..engines.cuda import QEngineCUDA

    seen = 0
    while seen < 6:  # proxy -> router -> hybrid -> engine chains are short
        seen += 1
        if getattr(engine, "_is_routed", False):
            # QRouted: inner stack may not exist yet (not batchable
            # until the router builds a dense engine) — never forward
            # through __getattr__ here, it would force construction
            engine = engine._engine
            if engine is None:
                return None
            continue
        from ..resilience.failover import ResilientEngine

        if isinstance(engine, ResilientEngine):
            engine = engine.engine
            continue
        from ..engines.hybrid import QHybrid

        if isinstance(engine, QHybrid):
            engine = engine._engine
            continue
        break
    if getattr(engine, "_tq_bits", None) is not None:
        # QEngineCUDATurboQuant IS-A QEngineCUDA but its ket is
        # codes+scales, not foldable (2, 2^n) planes — quantized
        # sessions run as singleton jobs
        return None
    return engine if isinstance(engine, QEngineCUDA) else None


def engine_touches_tunnel(engine) -> bool:
    """True when `engine`'s current core dispatches on the card (the
    name is the JAX package's).  Re-evaluated per submit: a session that
    failed over to QEngineCPU stops being sheddable the moment the
    failover lands."""
    from ..engines.cpu import QEngineCPU

    inner = engine
    seen = 0
    while seen < 6:
        seen += 1
        if getattr(inner, "_is_routed", False):
            inner = inner._engine
            if inner is None:
                # unrouted session: no engine, nothing dispatches
                return False
            continue
        from ..resilience.failover import ResilientEngine

        if isinstance(inner, ResilientEngine):
            inner = inner.engine
            continue
        from ..engines.hybrid import QHybrid

        if isinstance(inner, QHybrid):
            inner = inner._engine
            continue
        break
    if isinstance(inner, QEngineCPU):
        return False
    kind = type(inner).__name__
    return kind in ("QEngineCUDA", "QPager", "QEngineCUDATurboQuant",
                    "QPagerTurboQuant")


class Session:
    """One tenant's simulator plus scheduling bookkeeping."""

    def __init__(self, sid: str, width: int, layers, engine,
                 seed: Optional[int], engine_kwargs: Optional[dict] = None,
                 weight: float = 1.0):
        self.sid = sid
        self.width = width
        self.layers = layers
        self.engine = engine
        self.seed = seed
        self.engine_kwargs = dict(engine_kwargs or {})  # restore recipe
        # weighted-round-robin share: each dispatched job charges the
        # session 1/weight of virtual service time (scheduler.py), so a
        # weight-2 tenant gets twice the lane of a weight-1 one
        self.weight = max(float(weight), 1e-6)
        self.spilled = False       # engine persisted to disk, not resident
        # True while the engine is still in its freshly-constructed
        # |0…0⟩ state: only then may service.submit seed it from the
        # shared prefix cache (prefix_cache.py).  Cleared by the first
        # state-mutating submit and by checkpoint restore (mid-stream
        # state is not |0…0⟩).
        self.pristine = True
        now = time.perf_counter()
        self.created_s = now
        self.last_used_s = now
        self.inflight = 0          # queued + executing jobs (evict guard)
        self.jobs_completed = 0
        self.jobs_failed = 0
        self.failovers = 0
        self.spills = 0
        self.restores = 0
        self._lock = threading.Lock()

    def touch(self) -> None:
        self.last_used_s = time.perf_counter()

    def begin_job(self) -> None:
        with self._lock:
            self.inflight += 1
            self.last_used_s = time.perf_counter()

    def end_job(self, ok: bool) -> None:
        with self._lock:
            self.inflight -= 1
            self.last_used_s = time.perf_counter()
            if ok:
                self.jobs_completed += 1
            else:
                self.jobs_failed += 1

    def touches_tunnel(self) -> bool:
        if self.engine is None:
            return False
        return engine_touches_tunnel(self.engine)

    def stats(self) -> dict:
        return {
            "sid": self.sid,
            "width": self.width,
            "layers": self.layers,
            "engine": ("<spilled>" if self.engine is None else
                       type(planes_engine(self.engine)
                            or getattr(self.engine, "engine", self.engine)
                            ).__name__),
            "idle_s": time.perf_counter() - self.last_used_s,
            "inflight": self.inflight,
            "jobs_completed": self.jobs_completed,
            "jobs_failed": self.jobs_failed,
            "failovers": self.failovers,
            "spilled": self.spilled,
            "spills": self.spills,
            "restores": self.restores,
        }


class SessionManager:
    """Thread-safe registry: create / get / destroy / idle-evict.

    With a ``spill_store`` (checkpoint.CheckpointStore), idle eviction
    SPILLS instead of discarding — the engine's full state lands on
    disk and the session stays addressable; the executor faults it back
    in (:meth:`ensure_resident`) when its next job runs.  The store's
    live-session manifest doubles as the crash-recovery record."""

    def __init__(self, idle_evict_s: float = 0.0, spill_store=None):
        self.idle_evict_s = idle_evict_s
        self.spill_store = spill_store
        self._sessions: Dict[str, Session] = {}
        self._lock = threading.Lock()
        self._counter = 0
        if spill_store is not None:
            # the store's budget evictor must never delete the only copy
            # of a live spilled session's state
            spill_store.protected_sids = self._spilled_sids

    def _spilled_sids(self) -> List[str]:
        with self._lock:
            return [s.sid for s in self._sessions.values() if s.spilled]

    def create(self, width: int, layers="cuda", seed: Optional[int] = None,
               sid: Optional[str] = None, weight: float = 1.0,
               **engine_kwargs) -> Session:
        """Build a session's engine (EXECUTOR THREAD ONLY — see module
        doc) and register it.  Each session gets its own QrackRandom so
        tenant measurement streams are independent and, when seeded,
        exactly reproducible.  `sid` is only passed by crash recovery,
        which must rebuild sessions under their original ids."""
        layers = port_layers(layers)
        if terminal(layers) in HOST_TERMINALS:
            # a host session takes no device or plane dtype (a service's
            # default device= is for its card-bound sessions)
            engine_kwargs = {k: v for k, v in engine_kwargs.items()
                             if k not in ("device", "dtype")}
        rng = QrackRandom(seed)
        engine = create_quantum_interface(layers, width, rng=rng,
                                          **engine_kwargs)
        with self._lock:
            if sid is None:
                self._counter += 1
                sid = f"s{self._counter:06d}"
            else:
                # keep the counter ahead of recovered ids so new sessions
                # never collide with them
                try:
                    self._counter = max(self._counter, int(sid.lstrip("s")))
                except ValueError:
                    pass
            sess = Session(sid, width, layers, engine, seed,
                           engine_kwargs=engine_kwargs, weight=weight)
            self._sessions[sid] = sess
        if self.spill_store is not None:
            self.spill_store.register(sid, width, layers, seed,
                                      engine_kwargs)
        if _tele._ENABLED:
            _tele.inc("serve.session.created")
            # sessions whose engines were built while the cluster spans
            # processes keep pages over its page homes — their exchanges
            # cross processes, so operators want them visible (every
            # process must drive the same dispatch order)
            from ..parallel import cluster as _cluster

            if _cluster.is_initialized() and _cluster.process_count() > 1:
                _tele.inc("serve.session.multihost")
            _tele.event("serve.session.create", sid=sid, width=width,
                        accel=touches_accelerator(layers))
            _tele.gauge("serve.sessions.active", len(self._sessions))
        return sess

    def get(self, sid: str) -> Session:
        with self._lock:
            sess = self._sessions.get(sid)
        if sess is None:
            raise SessionNotFound(sid)
        return sess

    def destroy(self, sid: str) -> None:
        with self._lock:
            sess = self._sessions.pop(sid, None)
        if sess is None:
            raise SessionNotFound(sid)
        if self.spill_store is not None:
            self.spill_store.unregister(sid)
        if _tele._ENABLED:
            _tele.inc("serve.session.destroyed")
            _tele.gauge("serve.sessions.active", len(self._sessions))

    def release(self, sid: str) -> None:
        """Drop `sid` from THIS process without touching the store: the
        manifest entry and state file survive for whichever process
        adopts the session next (the drain handoff — QrackService.drain
        persists state and disowns the sid before calling this)."""
        with self._lock:
            sess = self._sessions.pop(sid, None)
        if sess is None:
            raise SessionNotFound(sid)
        if _tele._ENABLED:
            _tele.inc("serve.session.released")
            _tele.event("serve.session.release", sid=sid)
            _tele.gauge("serve.sessions.active", len(self._sessions))

    def evict_idle(self) -> List[str]:
        """Spill (with a store) or drop sessions idle past the budget
        with nothing in flight.  Called from the executor's idle ticks
        so engine teardown/serialization happens on the dispatch-owner
        thread."""
        if self.idle_evict_s <= 0:
            return []
        now = time.perf_counter()
        with self._lock:
            idle = [s for s in self._sessions.values()
                    if s.inflight == 0 and not s.spilled
                    and now - s.last_used_s > self.idle_evict_s]
            if self.spill_store is None:
                for s in idle:
                    del self._sessions[s.sid]
        evicted = []
        spilled = 0
        for s in idle:
            if self.spill_store is not None:
                try:
                    self.spill_store.save(s.sid, s.engine)
                except Exception:  # noqa: BLE001 — spill failure = plain evict
                    with self._lock:
                        self._sessions.pop(s.sid, None)
                else:
                    s.engine = None
                    s.spilled = True
                    s.spills += 1
                    spilled += 1
            evicted.append(s.sid)
        if evicted and _tele._ENABLED:
            _tele.inc("serve.session.evicted", len(evicted))
            if spilled:  # failed spills were plain evictions, not spills
                _tele.inc("serve.session.spilled", spilled)
            _tele.gauge("serve.sessions.active", len(self._sessions))
        return evicted

    def ensure_resident(self, sess: Session) -> None:
        """Fault a spilled session back in (EXECUTOR THREAD ONLY): build
        a fresh stack through the same factory recipe and restore the
        spilled state into it — rng stream position included, so the
        tenant's measurement stream continues as if never evicted."""
        if not sess.spilled:
            return
        if self.spill_store is None:
            raise SessionNotFound(sess.sid)
        from ..checkpoint.container import CheckpointError

        engine = create_quantum_interface(
            port_layers(sess.layers), sess.width,
            rng=QrackRandom(sess.seed), **sess.engine_kwargs)
        try:
            sess.engine = self.spill_store.load(sess.sid, into=engine)
        except CheckpointError:
            # spill file missing or corrupt (e.g. another process
            # sharing the store evicted it): keep the fresh cold engine
            # so the session survives instead of failing every future
            # job, and say so loudly in telemetry
            sess.engine = engine
            sess.spilled = False
            if _tele._ENABLED:
                _tele.inc("serve.session.restore_lost")
                _tele.event("serve.session.restore_lost", sid=sess.sid)
            return
        sess.spilled = False
        sess.pristine = False  # restored mid-stream state is not |0…0⟩
        sess.restores += 1
        self.spill_store.drop_state(sess.sid)
        # the disk copy is gone; the live state it held is now only in
        # memory, so recovery must not treat this session as clean
        self.spill_store.mark_dirty(sess.sid)
        if _tele._ENABLED:
            _tele.inc("serve.session.restored")
            _tele.event("serve.session.restore", sid=sess.sid)

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._sessions)

    def __len__(self) -> int:
        return len(self._sessions)

    def stats(self) -> List[dict]:
        with self._lock:
            sessions = list(self._sessions.values())
        return [s.stats() for s in sessions]
