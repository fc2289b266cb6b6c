"""Graceful degradation down a failover chain that stays on the card
(the port of the JAX package's resilience/failover.py).

When a guarded dispatch escalates past retry — the breaker is open
(:class:`~.errors.BreakerOpen`) or retries are exhausted
(:class:`~.errors.DispatchGiveUp`) — the circuit in flight should still
complete.  The chain (resilience/__init__.py states the rule):

1. ``QPager`` of 2^k pages → 2^(k-1) pages: ``shrink_pages`` re-pages
   on the card, in place (the JAX package hands its shrink a host
   snapshot instead);
2. ``QPager`` → ``QEngineCUDA`` where the width is at most 30 and the
   breaker is closed; ``turboquant``/``turboquant_pager`` →
   ``QEngineCUDA`` where the width is at most 30 (the precision
   ladder, not breaker-gated).  The ket moves on the card: the pages
   concatenated, or the codes decoded;
3. ``QEngineCPU`` only when the caller named it (``failover_cpu=True``),
   from a host copy of the ket taken under ``faults.suspended()``.

Without the CPU rung the end of the chain re-raises the cause, and the
planes stay on the card as they were before the failed call: every
injected fault fires at site entry, a device error after an in-place
write is replayed from the integrity snapshot or refused
(``DispatchGiveUp.torn``: such planes are no state to continue from,
so no rung takes them), and a shrink keeps the ket.  The replayed call
therefore produces what the healthy path would have.

The shrink rung keeps a faulting pager on the card, so a persistent
fault re-fires on the shrunk engine's replay: recovery is a LOOP
(:func:`replay_with_failover`) that keeps descending the strictly
shrinking chain.  Degraded pagers grow back at call boundaries
(resilience/elastic.py).

With ``QRACK_TPU_FAILOVER_PERSIST`` set to a directory, every move
first writes the failing engine's checkpoint there
(:func:`_persist_snapshot`, the JAX package's file names, events and
counters): one ``failover-<time>-<pid>-<seq>.qckpt`` a move, which
``checkpoint.load_state`` reads back.  A snapshot with a non-finite
plane is rejected, and a failed write is counted; neither blocks the
move.

A pager whose pages live in several processes (parallel/cluster.py)
takes the same chain on every rank at the same call, because its
dispatches agree on their outcome (dispatch.py): its shrink re-pages
onto the surviving slot prefix, across processes, and the dense rung
gathers the whole ket onto every rank, each of which builds its own
replica (:data:`BY_DESIGN`).

Two consumers: :class:`ResilientEngine`, the forwarding proxy the
factory wraps around the ``cuda``/``pager``/``turboquant``/
``turboquant_pager`` terminals (factory.py ``_maybe_resilient``), and
``QHybrid``, which fails over in place (engines/hybrid.py).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from .. import telemetry as _tele
from . import breaker as _breaker
from . import faults as _faults
from .errors import FAILOVER_ERRORS

_persist_seq = 0

#: where the chain of a pager over several processes differs from the
#: JAX package's, with the reason
BY_DESIGN = {
    "dense replica on each rank": "the dense rung gathers the whole ket "
        "through the transport onto every rank, and each rank builds a "
        "QEngineCUDA replica on its own card with the rng every rank "
        "holds in step, so its draws equal the other ranks': the port's "
        "counterpart of every JAX process running the same program on "
        "the same global array (the CPU rung, with failover_cpu=True, "
        "builds a QEngineCPU on each rank from the replicated read)",
    "persist file from rank 0": "QRACK_TPU_FAILOVER_PERSIST receives one "
        "file a move: every rank takes the replicated capture (a "
        "collective read), rank 0 alone writes it and records "
        "resilience.failover.persisted",
}


def _snapshot_is_finite(snap) -> bool:
    """Walk a captured snapshot tree and reject any non-finite float
    array.  Guards the persist path: a nan-poisoned ket written over the
    previous good snapshot would turn recovery evidence into the thing
    that re-poisons the recovery."""
    import numpy as np

    for arr in snap.get("arrays", {}).values():
        a = np.asarray(arr)
        if (np.issubdtype(a.dtype, np.floating)
                or np.issubdtype(a.dtype, np.complexfloating)):
            if not np.all(np.isfinite(a)):
                return False
    return all(_snapshot_is_finite(c)
               for c in snap.get("children", {}).values())


def _persist_snapshot(engine, cause) -> Optional[str]:
    """Durable post-mortem evidence: with QRACK_TPU_FAILOVER_PERSIST set
    to a directory, write the failing engine's full checkpoint container
    (ket + rng stream) there before the move, so the pre-call state
    survives even if the fallback itself dies.  Best-effort: a persist
    failure must never block the failover it documents.

    The capture is VERIFIED before it is written: a snapshot holding a
    non-finite plane is rejected (`resilience.failover.persist_rejected`)
    so the newest file in the persist directory stays the newest GOOD
    state.  Write-side integrity beyond finiteness rides the checkpoint
    container's own per-array sha256 manifest (checkpoint/container.py),
    which load_container re-verifies."""
    global _persist_seq
    root = os.environ.get("QRACK_TPU_FAILOVER_PERSIST")
    if not root:
        return None
    try:
        from ..checkpoint.registry import capture, save_snapshot

        snap = capture(engine)
        if getattr(engine, "_on_cluster", False):
            from ..parallel import cluster

            if cluster.process_index() != 0:
                return None   # rank 0 writes the one file (BY_DESIGN)
        if not _snapshot_is_finite(snap):
            if _tele._ENABLED:
                _tele.event("resilience.failover.persist_rejected",
                            cause=type(cause).__name__ if cause else "")
            return None
        os.makedirs(root, exist_ok=True)
        _persist_seq += 1
        name = (f"failover-{int(time.time())}-{os.getpid()}"
                f"-{_persist_seq:03d}.qckpt")
        path = os.path.join(root, name)
        save_snapshot(snap, path)
    except Exception:  # noqa: BLE001
        if _tele._ENABLED:
            _tele.inc("resilience.failover.persist_failed")
        return None
    if _tele._ENABLED:
        _tele.event("resilience.failover.persisted", path=path,
                    cause=type(cause).__name__ if cause else "")
        _tele.inc("resilience.failover.persisted")
    return path


# attributes that live on the proxy itself, never forwarded
_SELF_ATTRS = ("_engine", "_failover_cpu")


def _engine_kind(engine) -> str:
    name = type(engine).__name__
    return {"QPager": "pager", "QEngineCUDA": "cuda",
            "QEngineCPU": "cpu",
            "QEngineCUDATurboQuant": "turboquant",
            "QPagerTurboQuant": "turboquant_pager"}.get(name, name.lower())


def _to_cuda(engine, rng):
    """A QEngineCUDA holding `engine`'s ket, moved on the card: a pager's
    pages in logical order side by side, or a TurboQuant engine's codes
    decoded to float32 planes.  Over page homes the whole ket is gathered
    onto every rank, which builds its own replica (BY_DESIGN).  Runs
    under ``faults.suspended()``."""
    from ..engines.cuda import QEngineCUDA
    from ..ops import sharded as shb

    if _engine_kind(engine) == "pager":
        engine._unmap()
        dev = engine.device
        planes = shb.all_gather_pages(engine._pages_raw, dev)
        dtype = engine.dtype
    else:
        planes = engine._decompress_planes()
        dev, dtype = planes.device, planes.dtype
    eng = QEngineCUDA(engine.qubit_count, rng=rng, device=dev, dtype=dtype,
                      do_normalize=engine.do_normalize,
                      rand_global_phase=engine.rand_global_phase)
    eng._state = planes.contiguous()
    eng.running_norm = engine.running_norm
    return eng


def _to_cpu(engine, rng):
    from ..engines.cpu import QEngineCPU

    eng = QEngineCPU(engine.qubit_count, rng=rng,
                     do_normalize=engine.do_normalize,
                     rand_global_phase=engine.rand_global_phase)
    eng.SetQuantumState(engine.GetQuantumState())
    return eng


def _fallback_candidates(engine, failover_cpu: bool = False):
    """Yield (kind, build) pairs downstream of `engine`; each build
    takes the rng.  The CPU rung only with ``failover_cpu``."""
    from ..engines.cuda import MAX_DENSE_QB

    kind = _engine_kind(engine)
    n = engine.qubit_count
    if kind in ("pager", "turboquant_pager") \
            and getattr(engine, "can_shrink", None) and engine.can_shrink():
        # elastic first: halve the page count and stay on the card.
        # Mutates the SAME engine object.
        yield "pager_shrunk", lambda rng: engine.shrink_pages()
    if kind == "pager" and n <= MAX_DENSE_QB \
            and _breaker.get_breaker().state == "closed":
        # the dense engine is only worth trying when the device is not
        # the thing that just failed (breaker still closed => the
        # failure was local to the paged path)
        yield "cuda", lambda rng: _to_cuda(engine, rng)
    if kind in ("turboquant", "turboquant_pager") and n <= MAX_DENSE_QB:
        # a precision ladder, not a device failure: not breaker-gated
        yield "cuda", lambda rng: _to_cuda(engine, rng)
    if failover_cpu:
        yield "cpu", lambda rng: _to_cpu(engine, rng)


def fail_over_engine(engine, cause: Optional[BaseException] = None,
                     failover_cpu: bool = False):
    """Return the next engine down the chain, holding `engine`'s ket.
    Raises the original `cause` (or the last rung's construction error)
    when the chain is exhausted, and refuses a torn dispatch outright."""
    if getattr(cause, "torn", False):
        raise cause
    src = _engine_kind(engine)
    with _faults.suspended():
        _persist_snapshot(engine, cause)
        rng = getattr(engine, "rng", None)
        last_err: Optional[BaseException] = cause
        for kind, build in _fallback_candidates(engine, failover_cpu):
            try:
                fallback = build(rng)
            except Exception as e:  # noqa: BLE001 — try next in chain
                last_err = e
                continue
            if _tele._ENABLED:
                _tele.event(f"resilience.failover.{src}_to_{kind}",
                            width=engine.qubit_count,
                            cause=type(cause).__name__ if cause else "")
                _tele.inc("resilience.failovers")
            return fallback
    raise last_err if last_err is not None else RuntimeError(
        f"no failover target for {src} width {engine.qubit_count}")


def replay_with_failover(engine, cause, replay, commit=None, max_steps=16,
                         failover_cpu: bool = False):
    """Descend the failover chain until the failed call replays cleanly;
    returns ``(engine, result)``.  Each iteration moves strictly down
    the chain (2^k pages → … → 1 page → cuda → cpu when named), so the
    loop terminates: :func:`fail_over_engine` raises when the chain is
    exhausted.  ``commit(new_engine)`` runs after EVERY transition so
    the caller's reference is durable even when the replay fails too."""
    err = cause
    for _ in range(max_steps):
        engine = fail_over_engine(engine, err, failover_cpu)
        if commit is not None:
            commit(engine)
        try:
            return engine, replay(engine)
        except FAILOVER_ERRORS as e:
            err = e
    raise err


class ResilientEngine:
    """Forwarding proxy: any engine method that escalates with a
    FAILOVER_ERRORS exception is replayed down the failover chain until
    it lands.  After a terminal move (cuda/cpu) later calls stay on the
    fallback; an ELASTIC move (pager shrink) grows back: while the
    wrapped pager is degraded, every call boundary probes for recovery
    and re-expands in place (resilience/elastic.py)."""

    def __init__(self, engine, failover_cpu: bool = False):
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_failover_cpu", bool(failover_cpu))

    @classmethod
    def build(cls, factory, *args, failover_cpu: bool = False, **kwargs):
        """Construction-time failover: when building the primary engine
        itself dies on a guarded site (discover), fall back to a
        QEngineCPU at the same width — only with ``failover_cpu``; else
        the failure propagates."""
        try:
            return cls(factory(*args, **kwargs), failover_cpu)
        except FAILOVER_ERRORS as e:
            if not failover_cpu:
                raise
            from ..engines.cpu import QEngineCPU

            n = args[0] if args else kwargs.get("qubit_count")
            if _tele._ENABLED:
                _tele.event("resilience.failover.init_to_cpu", width=n,
                            cause=type(e).__name__)
                _tele.inc("resilience.failovers")
            kw = {k: kwargs[k] for k in ("init_state", "rng") if k in kwargs}
            return cls(QEngineCPU(n, **kw), failover_cpu)

    # -- plumbing ------------------------------------------------------

    def _fail_over(self, cause):
        fallback = fail_over_engine(self._engine, cause, self._failover_cpu)
        object.__setattr__(self, "_engine", fallback)
        return fallback

    def __getattr__(self, name):
        val = getattr(object.__getattribute__(self, "_engine"), name)
        if not callable(val):
            return val

        def call(*args, **kwargs):
            eng = object.__getattribute__(self, "_engine")
            if getattr(eng, "_elastic_target_g", None) is not None:
                # degraded pager: one probe per call boundary, growing
                # back to full page count as soon as the device returns
                from . import elastic as _elastic

                _elastic.maybe_reexpand(eng)
            try:
                return getattr(self._engine, name)(*args, **kwargs)
            except FAILOVER_ERRORS as e:
                _, out = replay_with_failover(
                    self._engine, e,
                    lambda fb: getattr(fb, name)(*args, **kwargs),
                    commit=lambda fb: object.__setattr__(self, "_engine", fb),
                    failover_cpu=self._failover_cpu)
                return out

        call.__name__ = name
        return call

    def __setattr__(self, name, value):
        if name in _SELF_ATTRS:
            object.__setattr__(self, name, value)
        else:
            setattr(self._engine, name, value)

    def __repr__(self):
        return f"ResilientEngine({self._engine!r})"

    @property
    def engine(self):
        return self._engine
