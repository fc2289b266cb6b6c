"""Watchdogged dispatch: timeout / retry / exponential backoff around the
guarded sites (the port of the JAX package's resilience/dispatch.py).

Env knobs (read into :func:`params`, overridable via :func:`configure`),
the JAX package's:

* ``QRACK_TPU_DISPATCH_TIMEOUT`` — seconds one dispatch may take
  before the watchdog declares it timed out (0, the default, disables
  the watchdog: dispatch runs inline with no extra thread).
* ``QRACK_TPU_MAX_RETRIES`` — retries after the first failed attempt
  (default 2 → up to 3 attempts).
* ``QRACK_TPU_BACKOFF`` — base backoff seconds; attempt k sleeps
  ``backoff * 2**k`` (default 0.05).
* ``QRACK_TPU_VALIDATE`` — 1 = finite-check every guarded output
  (reads a flag back from the device; an opt-in debugging net).

The watchdog runs the dispatch on a daemon thread and abandons it on
timeout: a wedged CUDA call cannot be cancelled from Python, but the
CALLER gets control back (:class:`~.errors.DispatchTimeout`).  PyTorch
launches asynchronously, so a hang shows at a sync (``.item()``,
``.cpu()``, ``torch.cuda.synchronize``): the ``cuda.device_get`` sites,
which return host values, are where the watchdog bites.  Abandoned
threads are counted (`resilience.abandoned_threads`).

**Exactly once.**  The port's kernels and page passes write their
operands IN PLACE, where the JAX package's programs are functional.  A
retry is therefore sound only when nothing was written:

* an injected fault fires at site entry (faults.py), before the
  callable runs — always retried;
* a callable that writes in place passes ``writes``, a zero-argument
  function whose value moves with every write (:func:`write_token`:
  the operands' version counters and the hand-written kernels' launch
  counts).  A device error whose ``writes`` did not move was reported
  by the launch itself, before any write, and is retried; one that
  surfaced after a write (or a watchdog timeout of a callable that may
  still be running) gives up at once with ``DispatchGiveUp(torn=True)``.
  Only the integrity envelope (integrity.py), which holds a pre-flush
  snapshot, replays such a dispatch; the failover chain refuses it;
* a sticky CUDA error (an illegal address, a device-side assert, an
  unspecified launch failure...) leaves the context unusable: it is
  :class:`~.errors.DeviceLost` and is never retried on the card.

The counterpart of the JAX package's ``_is_xla_runtime_error`` is
:func:`is_device_error`: ``torch.cuda.OutOfMemoryError``, torch's
accelerator error class where the installed torch has one, and
``RuntimeError`` s whose text starts with ``CUDA error`` (or the
kernel wrappers' ``launch failed: CUDA error``).  Anything else — a
failed ``nvcc`` build, a ValueError of a wrapper — propagates untouched:
a kernel never quietly gives way to its plain version.
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Optional

from .. import telemetry as _tele
from . import breaker as _breaker
from . import faults as _faults
from .errors import (DeviceLost, DispatchFailure, DispatchGiveUp,
                     DispatchTimeout, NaNPoisoned)

_ABANDONED = 0  # threads left behind by watchdog timeouts (diagnostic)


@dataclass
class DispatchParams:
    timeout_s: float = 0.0
    max_retries: int = 2
    backoff_s: float = 0.05
    validate: bool = False

    @classmethod
    def from_env(cls) -> "DispatchParams":
        return cls(
            timeout_s=float(os.environ.get("QRACK_TPU_DISPATCH_TIMEOUT", "0")),
            max_retries=int(os.environ.get("QRACK_TPU_MAX_RETRIES", "2")),
            backoff_s=float(os.environ.get("QRACK_TPU_BACKOFF", "0.05")),
            validate=os.environ.get("QRACK_TPU_VALIDATE", "") not in ("", "0"),
        )


_PARAMS: Optional[DispatchParams] = None


def params() -> DispatchParams:
    global _PARAMS
    if _PARAMS is None:
        _PARAMS = DispatchParams.from_env()
    return _PARAMS


def configure(**kw) -> DispatchParams:
    """Override dispatch params at runtime (tests); unknown keys fail.
    Call with no arguments to re-read the environment."""
    global _PARAMS
    if not kw:
        _PARAMS = DispatchParams.from_env()
        return _PARAMS
    p = params()
    for k, v in kw.items():
        if not hasattr(p, k):
            raise AttributeError(f"unknown dispatch param {k!r}")
        setattr(p, k, v)
    return p


# CUDA errors after which the context is unusable (cudaError_t codes:
# illegal address, launch timeout, device-side assert, hardware stack
# error, illegal instruction, misaligned address, invalid address
# space, invalid program counter, launch failure, uncorrectable ECC)
_STICKY_CODES = {700, 702, 710, 714, 715, 716, 717, 718, 719, 214}
_STICKY_TEXT = ("illegal memory access", "the launch timed out",
                "device-side assert", "hardware stack error",
                "illegal instruction", "misaligned address",
                "invalid address space", "invalid program counter",
                "unspecified launch failure", "uncorrectable ecc")
_CODE = re.compile(r"CUDA error:? (\d+)")


def is_device_error(exc: BaseException) -> bool:
    """True for the device's runtime errors (the JAX package's
    ``_is_xla_runtime_error``): out of memory, torch's accelerator error
    class, and RuntimeErrors whose text starts with ``CUDA error`` or is
    a kernel wrapper's ``launch failed: CUDA error``."""
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None and isinstance(exc, acc):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    text = str(exc)
    return text.startswith("CUDA error") or "launch failed: CUDA error" in text


def is_sticky(exc: BaseException) -> bool:
    """True for a CUDA error that leaves the context unusable."""
    text = str(exc)
    m = _CODE.search(text)
    if m and int(m.group(1)) in _STICKY_CODES:
        return True
    low = text.lower()
    return any(s in low for s in _STICKY_TEXT)


def _classify(site: str, exc: BaseException) -> DispatchFailure:
    detail = f"{type(exc).__name__}: {exc}"
    if is_sticky(exc):
        return DeviceLost(site, detail)
    return DispatchFailure(site, detail)


def write_token(tensors):
    """A value that moves with every write to `tensors` (a tensor or a
    sequence of them; another process's page placeholders are skipped):
    their version counters, which every in-place torch op bumps, and
    the window and TurboQuant kernels' launch counts, since a kernel
    writes through a raw pointer that the counters do not see."""
    import torch

    from ..ops import turboquant_kernel as tqk
    from ..ops import window_kernel as wk

    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    try:
        versions = tuple(t._version for t in tensors
                         if isinstance(t, torch.Tensor))
    except RuntimeError:      # tensors that track no version counter
        versions = (object(),)
    launches = (sum(sum(c.values()) for c in wk.DTYPE_LAUNCHES.values())
                + sum(tqk.LAUNCHES.values()))
    return versions, launches


def _hang_stub(timeout_s: float):
    """Stand-in body for the injected `hang` kind: sleeps long enough
    that only the watchdog can end the dispatch, but bounded so a
    watchdog-less run does not wedge forever."""
    nap = min(max(4.0 * timeout_s, 0.5), 30.0)

    def stub():
        time.sleep(nap)
        raise DispatchTimeout("<hang>", timeout_s or nap,
                              "injected hang outlived the dispatch")

    return stub


def _run_with_watchdog(site: str, fn, args, kwargs, timeout_s: float):
    box = {}

    def worker():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised in caller
            box["err"] = e

    t = threading.Thread(target=worker, daemon=True,
                         name=f"qrack-dispatch-{site}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        global _ABANDONED
        _ABANDONED += 1
        if _tele._ENABLED:
            _tele.event(f"resilience.timeout.{site}", timeout_s=timeout_s,
                        abandoned_threads=_ABANDONED)
            _tele.inc("resilience.abandoned_threads")
        raise DispatchTimeout(site, timeout_s)
    if "err" in box:
        raise box["err"]
    return box["out"]


# outcomes of one guarded attempt, ordered by severity: the ranks of a
# cohort agree on the MAX, and a rank that saw a milder outcome than the
# agreed one takes the agreed one's class (so retry or give-up is one
# decision)
_OK, _FAILED, _TIMEOUT, _NAN, _LOST, _FOREIGN = range(6)
_AGREED_CLASS = {_FAILED: DispatchFailure, _NAN: NaNPoisoned,
                 _LOST: DeviceLost}


def _code(err) -> int:
    if err is None:
        return _OK
    if isinstance(err, DeviceLost):
        return _LOST
    if isinstance(err, NaNPoisoned):
        return _NAN
    if isinstance(err, DispatchTimeout):
        return _TIMEOUT
    if isinstance(err, DispatchFailure):
        return _FAILED
    return _FOREIGN


def _agreed(site: str, err, got: int):
    """This rank's failure after the cohort agreed on `got` (the MAX of
    every rank's outcome code): None when every rank succeeded, its own
    failure when it is of the agreed kind, else one of the agreed kind
    raised on another rank."""
    if got == _OK:
        return None
    if _code(err) == got:
        return err
    if got == _FOREIGN:
        raise RuntimeError(
            f"another rank failed at site {site!r} outside the resilience "
            "plane")
    if got == _TIMEOUT:
        return DispatchTimeout(site, detail="timed out on another rank")
    return _AGREED_CLASS[got](site, "failed on another rank")


def cohort_of(eng) -> bool:
    """True for an engine whose pages live in several processes (a pager
    over the cluster's page homes, or a QHybrid whose pager half is
    one): its guarded calls, fingerprints and health probes are agreed
    across the ranks."""
    return bool(getattr(eng, "_on_cluster", False))


def call_guarded(site: str, fn, args=(), kwargs=None, writes=None,
                 cohort: bool = False):
    """Run `fn(*args, **kwargs)` as one guarded dispatch at `site`:
    breaker gate, fault injection, watchdog timeout, finite validation,
    then retry with exponential backoff where a retry runs the dispatch
    exactly once (module docstring; ``writes`` for callables that write
    in place).  Raises BreakerOpen (breaker refused) or DispatchGiveUp
    (retries exhausted, or a torn in-place dispatch) — the
    FAILOVER_ERRORS the engine wrappers recover from.

    ``cohort``: `fn` is one pass of a pager whose pages live in several
    processes, which every rank runs together.  Each rank learns its own
    outcome and the ranks agree (parallel/cluster.py ``agree``) twice an
    attempt: on site entry (the breaker's gate and the fault directive,
    a hang once its watchdog fired), so no rank enters the pass's
    transport unless every rank does, and on exit (the outcome and
    whether this rank wrote, whatever its own outcome).  The one-process
    rule then acts on the union: a retry in place only when no rank
    wrote, ``torn`` on every rank when any did.  The breaker refuses on
    every rank while any rank's breaker is open and still cooling down
    (a dispatch outside the cohort, a replica's, may have moved one
    rank's breaker alone); a rank whose breaker is blocked draws no
    fault directive, as the one-process gate refuses before it."""
    kwargs = kwargs or {}
    if _faults.is_suspended():
        # recovery path (failover move, verification read): raw call —
        # an open breaker must not refuse the read that gets state OFF
        # the failing engine
        return fn(*args, **kwargs)
    p = params()
    agree = None
    if cohort:
        from ..parallel import cluster

        if p.timeout_s > cluster.AGREE_TIMEOUT_S:
            raise ValueError(
                f"the dispatch watchdog ({p.timeout_s} s) outlasts the "
                f"cluster's agreement timeout ({cluster.AGREE_TIMEOUT_S} s)")
        agree = cluster.agree
    br = _breaker.get_breaker()
    last: Optional[DispatchFailure] = None
    attempts = max(1, p.max_retries + 1)
    for attempt in range(attempts):
        # a cohort reads the gate without a transition first: an open
        # breaker still cooling down (a read-only test) is agreed on
        blocked = agree is not None and br.open_remaining_s() > 0
        if not blocked:
            br.allow(site)  # raises BreakerOpen: stop hammering the device
        ran = False     # the real callable was entered
        w0 = writes() if writes is not None else None
        err = foreign = None
        try:
            if not blocked:
                directive = _faults.check(site)  # may raise DispatchFailure
                if directive == "hang":
                    _run_with_watchdog(site, _hang_stub(p.timeout_s), (),
                                       {}, p.timeout_s if p.timeout_s > 0
                                       else 35.0)
        except DispatchFailure as e:
            err = e
        if agree is not None:
            code, shut = agree([_code(err), int(blocked)])
            if shut:
                br.reject(site)
            err = _agreed(site, err, code)
        if err is None:
            ran = True
            try:
                if p.timeout_s > 0:
                    out = _run_with_watchdog(site, fn, args, kwargs,
                                             p.timeout_s)
                else:
                    out = fn(*args, **kwargs)
                if _faults._HAS_CORRUPT:
                    # amp-corrupt fires at site EXIT: the dispatch
                    # SUCCEEDS and hands back a silently-wrong result
                    # (faults.py)
                    out = _faults.corrupt_output(site, out)
                if p.validate:
                    _faults.validate_finite(site, out)
            except DispatchFailure as e:
                err = e
            except Exception as e:  # noqa: BLE001 — only device errors handled
                if not is_device_error(e):
                    if agree is None:
                        raise
                    err = foreign = e
                else:
                    err = _classify(site, e)
        # the operands may hold part of this dispatch (or a timed-out
        # callable may still be writing them): if the dispatch failed on
        # any rank, no retry in place can run it exactly once
        wrote = bool(ran and writes is not None and (
            writes() != w0 or isinstance(err, (DispatchTimeout,
                                               NaNPoisoned))))
        if agree is not None and ran:
            code, wrote = agree([_code(err), int(wrote)])
            if foreign is not None:
                raise foreign
            err = _agreed(site, err, code)
        torn = err is not None and bool(wrote)
        if err is None:
            br.record_success()
            return out
        last = err
        br.record_failure(site)
        if _tele._ENABLED:
            _tele.inc(f"resilience.failure.{site}")
        if torn:
            raise DispatchGiveUp(site, last, torn=True)
        if not last.retryable:
            break
        if attempt + 1 < attempts:
            if _tele._ENABLED:
                _tele.event(f"resilience.retry.{site}", attempt=attempt + 1,
                            cause=getattr(last, "kind", "failure"))
            if p.backoff_s > 0:
                time.sleep(p.backoff_s * (2 ** attempt))
    raise DispatchGiveUp(site, last)


def guard_callable(site: str, fn):
    """Closure form for callables fetched per dispatch: returns a
    callable routing through call_guarded."""
    def run(*args, **kwargs):
        return call_guarded(site, fn, args, kwargs)

    run._guarded_site = site
    run._guarded_fn = fn
    return run


_RES_PKG = None  # the qrack_tpu_torch.resilience module, bound after its init


def _res_pkg():
    global _RES_PKG
    if _RES_PKG is None:
        import importlib

        _RES_PKG = importlib.import_module(__package__)
    return _RES_PKG


class _GuardedProgram:
    """Persistent wrapper over a function that dispatches device work
    (the dense engine's gate functions).  Disabled cost is one
    module-attribute read and a truth test."""

    __slots__ = ("_fn", "_site")

    def __init__(self, site: str, fn):
        self._fn = fn
        self._site = site

    def __call__(self, *args, **kwargs):
        pkg = _RES_PKG or _res_pkg()  # late: runtime enable() must be seen
        if not pkg._ACTIVE:
            return self._fn(*args, **kwargs)
        return call_guarded(self._site, self._fn, args, kwargs)

    def __getattr__(self, attr):
        return getattr(self._fn, attr)


def instrument_dispatch(site: str, fn):
    return _GuardedProgram(site, fn)
