"""qrack_tpu_torch.resilience — watchdogged dispatch, circuit breaker,
fault injection, integrity replay, elastic re-paging and failover (the
port of the JAX package's resilience/).

The whole layer is OFF by default: every guarded site costs one
module-attribute read plus a truth test until :data:`_ACTIVE` flips.
Activation, with the JAX package's variables (so the environment arms
both packages at once, as ``QRACK_TPU_TELEMETRY`` turns on both
telemetry planes):

* env — ``QRACK_TPU_RESILIENCE=1``, or any nonempty
  ``QRACK_TPU_FAULTS`` (injecting faults implies you want the layer
  that catches them);
* runtime — :func:`enable` / :func:`disable` (tests).

**The failover rule of the port.**  The chain stays on the card:

* a QPager of 2^k pages shrinks to 2^(k-1) pages, re-paged on the card
  (``QPager.shrink_pages``), and grows back at a later call boundary
  once the health probe passes (elastic.py);
* a QPager becomes one QEngineCUDA where the width is at most 30 and
  the breaker is closed;
* a ``turboquant``/``turboquant_pager`` engine becomes a QEngineCUDA
  where the width is at most 30 (the precision ladder, not gated by
  the breaker).

The CPU rung exists only when the caller names it, with the argument
``failover_cpu=True`` of ``create_quantum_interface``,
:meth:`failover.ResilientEngine.build` and ``QHybrid`` — never an
environment variable.  Without it the end of the chain re-raises the
cause (``DispatchGiveUp`` / ``BreakerOpen``), the planes stay on the card
as they were before the failed call, and a construction that fails on a
guarded site raises where the JAX package builds a QEngineCPU.  Every
move is the event ``resilience.failover.<src>_to_<kind>`` (the JAX
names, with ``cuda`` for ``tpu``) and the counter
``resilience.failovers``; the re-pages are ``elastic.repage.*`` and
``integrity.quarantine.*``, QHybrid's un-pin ``hybrid.unpin.*`` and
``elastic.hybrid.unpinned``.  A kernel never quietly gives way to its
plain version: a failed ``nvcc`` build or library load is not a device
error and propagates, and no guard re-runs a window through the plain
version on a CUDA tensor.

The kernels write the planes in place, so a retry runs only what can
run exactly once (dispatch.py): a fault raised before any write is
retried in place; a device error after a write is replayed only from
the integrity envelope's snapshot (integrity.py), else it gives up at
once; a sticky CUDA error is a lost device.

Layout (import order matters — no cycles, no engine imports here):

* errors.py    — exception hierarchy (FAILOVER_ERRORS is the contract)
* faults.py    — deterministic injection (QRACK_TPU_FAULTS grammar)
* breaker.py   — process-wide circuit breaker
* dispatch.py  — call_guarded / instrument_dispatch (watchdog+retry)
* probe.py     — SIGTERM-first subprocess probe of the card
* failover.py  — ResilientEngine + fail_over_engine (imports engines;
  loaded lazily by consumers, NOT here)
* integrity.py — silent-corruption detection, window replay from an
  on-card snapshot, page-slot quarantine (loaded lazily by the flush)
* elastic.py   — the grow half of elastic paging

``QRACK_TPU_FAILOVER_PERSIST`` names a directory that receives the
failing engine's checkpoint before every failover move (failover.py
``_persist_snapshot``, the JAX package's failover snapshot file).
"""

from __future__ import annotations

import os as _os

from .errors import (BreakerOpen, CorruptionDetected, DeviceLost,
                     DispatchFailure, DispatchGiveUp, DispatchTimeout,
                     FAILOVER_ERRORS, InjectedFault, NaNPoisoned,
                     ResilienceError)
from . import faults
from .breaker import CircuitBreaker, get_breaker, reset_breaker
from .dispatch import (DispatchParams, call_guarded, configure,
                       guard_callable, instrument_dispatch, params)
from .probe import ProbeResult, ensure_backend, run_probe

__all__ = [
    "ResilienceError", "DispatchFailure", "DispatchTimeout", "DeviceLost",
    "NaNPoisoned", "InjectedFault", "CorruptionDetected",
    "DispatchGiveUp", "BreakerOpen",
    "FAILOVER_ERRORS",
    "faults",
    "CircuitBreaker", "get_breaker", "reset_breaker",
    "DispatchParams", "params", "configure",
    "call_guarded", "guard_callable", "instrument_dispatch",
    "run_probe", "ProbeResult", "ensure_backend",
    "active", "enable", "disable",
]


_ACTIVE: bool = (
    _os.environ.get("QRACK_TPU_RESILIENCE", "") not in ("", "0")
    or bool(_os.environ.get("QRACK_TPU_FAULTS", "").strip())
)


def active() -> bool:
    return _ACTIVE


def enable() -> None:
    global _ACTIVE
    _ACTIVE = True


def disable() -> None:
    global _ACTIVE
    _ACTIVE = False
