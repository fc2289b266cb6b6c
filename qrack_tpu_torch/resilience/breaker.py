"""Circuit breaker for the device (the one-client discipline; a copy of
the JAX package's resilience/breaker.py, whose only import is its
telemetry, here the port's).

A device that fails again and again is not helped by more retries, so
after ``QRACK_TPU_BREAKER_THRESHOLD`` consecutive dispatch failures the
breaker OPENS and every guarded site refuses to dispatch at all
(:class:`~.errors.BreakerOpen`, which engine wrappers turn into a move
down the failover chain; the pager -> dense engine rung on the card is
taken only while the breaker is closed).  After
``QRACK_TPU_BREAKER_COOLDOWN`` seconds the breaker HALF-OPENS: exactly
one probe dispatch is let through; success closes the breaker, failure
re-opens it and restarts the cooldown.

State machine::

    closed --(threshold consecutive failures)--> open
    open --(cooldown elapsed, next allow())--> half_open
    half_open --(success)--> closed
    half_open --(failure)--> open

One process-wide breaker guards the device (it is a per-process
resource); :func:`get_breaker` returns it, :func:`reset_breaker`
installs a fresh one (tests).  The ranks of a pager whose pages live in
several processes record the outcome they agreed on
(resilience/dispatch.py ``call_guarded(cohort=True)``), so their
breakers move together; only the cooldown runs on each host's clock, and
an open breaker's allow is agreed before it half-opens (:meth:`reject`
refuses on every rank while any rank still cools down).  Transitions are telemetry events
(`resilience.breaker.trip/half_open/close`), rejections a counter
(`resilience.breaker.rejected`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from .. import telemetry as _tele
from .errors import BreakerOpen


class CircuitBreaker:
    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if threshold is None:
            threshold = int(os.environ.get("QRACK_TPU_BREAKER_THRESHOLD", "5"))
        if cooldown_s is None:
            cooldown_s = float(os.environ.get("QRACK_TPU_BREAKER_COOLDOWN", "30"))
        self.threshold = max(1, threshold)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.trips = 0

    def allow(self, site: str = "") -> None:
        """Gate one dispatch attempt; raises BreakerOpen while open.
        The first call after the cooldown transitions to half_open and
        is allowed through as the probe."""
        with self._lock:
            if self.state == "closed":
                return
            if self.state == "open":
                elapsed = self._clock() - self.opened_at
                if elapsed < self.cooldown_s:
                    if _tele._ENABLED:
                        _tele.inc("resilience.breaker.rejected")
                    raise BreakerOpen(site, self.cooldown_s - elapsed)
                self.state = "half_open"
                if _tele._ENABLED:
                    _tele.event("resilience.breaker.half_open", site=site)
            # half_open: the probe dispatch proceeds

    def reject(self, site: str = "") -> None:
        """Refuse one dispatch attempt as an open breaker does, without
        a transition: the ranks of a pager over page homes refuse
        together while any rank's cooldown still runs
        (resilience/dispatch.py)."""
        if _tele._ENABLED:
            _tele.inc("resilience.breaker.rejected")
        raise BreakerOpen(site, self.open_remaining_s())

    def record_success(self) -> None:
        with self._lock:
            if self.state != "closed" and _tele._ENABLED:
                _tele.event("resilience.breaker.close")
            self.state = "closed"
            self.consecutive_failures = 0
            self.opened_at = None

    def record_failure(self, site: str = "") -> None:
        with self._lock:
            self.consecutive_failures += 1
            trip = (self.state == "half_open"
                    or (self.state == "closed"
                        and self.consecutive_failures >= self.threshold))
            if trip:
                self.state = "open"
                self.opened_at = self._clock()
                self.trips += 1
                if _tele._ENABLED:
                    _tele.event("resilience.breaker.trip", site=site,
                                consecutive_failures=self.consecutive_failures)

    def open_remaining_s(self) -> float:
        """Seconds until an OPEN breaker would half-open (0 when closed,
        half-open, or past cooldown).  Read-only — unlike allow() it
        never transitions state, so admission-control callers (the serve
        scheduler's load shedding) can consult it without consuming the
        half-open probe slot that belongs to the dispatch path."""
        with self._lock:
            if self.state != "open":
                return 0.0
            return max(0.0, self.cooldown_s - (self._clock() - self.opened_at))

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state,
                    "consecutive_failures": self.consecutive_failures,
                    "threshold": self.threshold,
                    "cooldown_s": self.cooldown_s,
                    "trips": self.trips}


_BREAKER: Optional[CircuitBreaker] = None
_BREAKER_LOCK = threading.Lock()


def get_breaker() -> CircuitBreaker:
    global _BREAKER
    with _BREAKER_LOCK:
        if _BREAKER is None:
            _BREAKER = CircuitBreaker()
        return _BREAKER


def reset_breaker(breaker: Optional[CircuitBreaker] = None) -> CircuitBreaker:
    """Install a fresh (or caller-provided) breaker; returns it."""
    global _BREAKER
    with _BREAKER_LOCK:
        _BREAKER = breaker if breaker is not None else CircuitBreaker()
        return _BREAKER
