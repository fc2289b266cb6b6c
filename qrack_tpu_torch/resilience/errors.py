"""Resilience exception hierarchy (a copy of the JAX package's
resilience/errors.py, which is stdlib only).

Two tiers, matching the two recovery levels:

* :class:`DispatchFailure` — ONE dispatch attempt at a guarded site
  failed (watchdog timeout, injected fault, a CUDA runtime error).  The
  dispatch wrapper (dispatch.py) catches these and retries with
  exponential backoff where a retry can run the dispatch exactly once;
  callers never see one unless they call the raw fault API themselves.
* :class:`DispatchGiveUp` / :class:`BreakerOpen` — the site is
  unrecoverable from where the engine sits (retries exhausted, device
  lost, or the circuit breaker refuses to dispatch at all).  These are
  the FAILOVER_ERRORS: the engine wrappers (engines/hybrid.py,
  resilience/failover.py) catch them and move the ket down the failover
  chain, which stays on the card unless the caller names the CPU.

Everything subclasses RuntimeError so un-wrapped callers fail loudly
rather than silently swallowing a resilience signal.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base of every resilience-layer exception."""


class DispatchFailure(ResilienceError):
    """One failed dispatch attempt at a guarded site (retryable unless
    the subclass says otherwise)."""

    retryable = True
    kind = "failure"

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        self.detail = detail
        msg = f"dispatch failure at site {site!r}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class DispatchTimeout(DispatchFailure):
    """The watchdog expired before the dispatch completed (a wedged
    device, or the injected `timeout`/`hang` fault kinds)."""

    kind = "timeout"

    def __init__(self, site: str, timeout_s: float = 0.0, detail: str = ""):
        self.timeout_s = timeout_s
        super().__init__(site, detail or f"no completion within {timeout_s}s")


class DeviceLost(DispatchFailure):
    """The device went away mid-circuit; retrying the same dispatch
    cannot help — fail over immediately (injected `device-loss`, or a
    sticky CUDA error that leaves the context unusable)."""

    retryable = False
    kind = "device-loss"


class NaNPoisoned(DispatchFailure):
    """Output failed the finite check (QRACK_TPU_VALIDATE=1), or the
    injected `nan-poison` kind fired at site entry."""

    kind = "nan-poison"


class InjectedFault(DispatchFailure):
    """The generic `raise` fault kind."""

    kind = "raise"


class CorruptionDetected(DispatchFailure):
    """An integrity invariant (resilience/integrity.py) caught silent
    data corruption AFTER a dispatch committed its result.  Never
    retried in place — the kernels write the planes in place — so the
    guard plane restores a pre-flush snapshot and replays the kept
    window instead; ``fp`` carries the offending fingerprint for
    attribution."""

    retryable = False
    kind = "amp-corrupt"

    def __init__(self, site: str, detail: str = "", fp=None):
        self.fp = fp
        super().__init__(site, detail)


class DispatchGiveUp(ResilienceError):
    """Every retry at a guarded site failed; carries the last attempt's
    failure as `cause`.  Triggers engine failover.

    ``torn`` is True when the last attempt failed AFTER the dispatch may
    have written its operands in place (a device error that surfaced
    past a launch): the resident planes are then no state to continue
    from.  Only the integrity envelope, which holds a pre-flush snapshot,
    replays such a dispatch; the failover chain refuses it."""

    def __init__(self, site: str, cause: DispatchFailure = None,
                 torn: bool = False):
        self.site = site
        self.cause = cause
        self.torn = torn
        super().__init__(
            f"dispatch at site {site!r} failed after retries"
            + (" after writing its operands in place" if torn else "")
            + (f" (last: {cause})" if cause is not None else ""))


class BreakerOpen(ResilienceError):
    """The circuit breaker is open: no dispatch is attempted at all (the
    one-client discipline — stop hammering a failing device).  Triggers
    engine failover."""

    def __init__(self, site: str, retry_in_s: float = 0.0):
        self.site = site
        self.retry_in_s = retry_in_s
        super().__init__(
            f"circuit breaker open: refusing dispatch at site {site!r}"
            + (f" (half-open probe in {retry_in_s:.1f}s)"
               if retry_in_s > 0 else ""))


#: errors that mean "stop using this engine and fail over"
FAILOVER_ERRORS = (DispatchGiveUp, BreakerOpen)
