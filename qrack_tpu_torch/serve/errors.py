"""Typed errors for the serving layer (a copy of the JAX package's
serve/errors.py).

Admission rejections are SYNCHRONOUS — submit() raises them directly,
so a front-end can map each to a distinct response (429 queue full,
503 shedding w/ retry-after, 404 unknown session) without string
matching.  Errors delivered through a JobHandle (executor-side
failures) re-raise from .result() unchanged.
"""

from __future__ import annotations

from typing import Optional


class ServeError(RuntimeError):
    """Base class for every serving-layer error."""


class SessionNotFound(ServeError):
    def __init__(self, session_id: str):
        super().__init__(f"unknown session {session_id!r}")
        self.session_id = session_id


class AdmissionRejected(ServeError):
    """Base for submit()-time rejections (backpressure contract)."""


class QueueFull(AdmissionRejected):
    """Queue depth reached QRACK_SERVE_MAX_DEPTH — shed at the door
    instead of growing an unbounded backlog."""

    def __init__(self, depth: int, max_depth: int):
        super().__init__(
            f"serve queue full ({depth}/{max_depth}); retry later or "
            "raise QRACK_SERVE_MAX_DEPTH")
        self.depth = depth
        self.max_depth = max_depth


class LoadShed(AdmissionRejected):
    """The circuit breaker is open: the card keeps failing and this job's
    session would dispatch on it.  Piling jobs onto a failing device only
    deepens the failure, so card-bound work is refused up front with the
    cooldown remaining as a retry hint.  CPU-backed sessions — including
    ones that already failed over — are never shed."""

    def __init__(self, session_id: str, retry_in_s: float):
        super().__init__(
            f"load shed: breaker open, session {session_id!r} targets the "
            f"accelerator (retry in ~{retry_in_s:.1f}s)")
        self.session_id = session_id
        self.retry_in_s = retry_in_s


class Overloaded(AdmissionRejected):
    """The fleet is past capacity and the brownout ladder refused this
    job at the front door — either its priority band is being shed
    (level 1+) or the ladder's top rung is refusing all new work while
    scale-up races the surge (level 3).  Carries the ladder level and a
    retry-after hint; the job was NOT journaled, executed, or queued —
    retrying after ``retry_in_s`` is always safe."""

    def __init__(self, retry_in_s: float, level: int = 1,
                 band: Optional[int] = None):
        what = ("shedding priority band <= %s" % band if band is not None
                else "refusing new work")
        super().__init__(
            f"overloaded (brownout level {level}, {what}); "
            f"retry in ~{retry_in_s:.1f}s")
        self.retry_in_s = retry_in_s
        self.level = level
        self.band = band


class QueueBudgetExceeded(ServeError):
    """The job sat queued past QRACK_SERVE_QUEUE_BUDGET_MS and was
    expired unexecuted — the bounded-latency half of backpressure."""

    def __init__(self, waited_s: float, budget_s: float):
        super().__init__(
            f"job expired after {waited_s:.3f}s queued "
            f"(budget {budget_s:.3f}s)")
        self.waited_s = waited_s
        self.budget_s = budget_s


class ServiceStopped(ServeError):
    """The service was shut down; queued jobs drain with this error and
    new submissions are refused."""
