"""Elastic recovery probe: decide when a degraded engine may grow back
(the port of the JAX package's resilience/elastic.py).

The shrink half of elasticity lives where the state lives —
``QPager.shrink_pages``, which re-pages on the card (the first rung of
failover.py's chain and the fuser's shrink-and-redispatch), and the
QHybrid pin.  This module is the GROW half: a cheap, read-only health
probe consulted at call boundaries before a degraded engine re-expands
onto the page slots it gave up.

:func:`health_probe` is conservative by construction — every check is
a reason NOT to grow:

* ``faults.is_suspended()`` — a failover move or verification read is
  in flight; recovery paths must never change the topology under it.
* the circuit breaker still has cooldown left (``open_remaining_s``
  is read-only, so probing never consumes the half-open trial call).
* :func:`faults.device_down` — an armed ``device-loss``/``flap`` spec
  whose window is open (the injected analogue of "still unplugged").
* optionally (``QRACK_TPU_ELASTIC_PROBE=1``) a real watchdogged
  subprocess probe via :func:`~.probe.run_probe` — off by default
  because it costs a fresh CUDA init per check.

On a pager whose pages live in several processes the ranks agree on the
probe (``cohort=True``): a fault armed on one rank, or one breaker still
cooling down, keeps every rank degraded.

:func:`maybe_reexpand` is the one entry point callers use: it walks
wrapper layers (ResilientEngine, QHybrid) down to the engine that
actually owns pages, asks the probe, and calls ``expand_pages()``.  A
failed expansion is counted by the pager itself
(``elastic.repage.expand_failed``) and leaves the engine
degraded-but-serving.
"""

from __future__ import annotations

import os
from typing import Optional

from . import breaker as _breaker
from . import faults as _faults

#: probe outcomes are cheap to recompute, so no caching: every check
#: reads live breaker/fault state (a flap can heal between two calls).


def health_probe(site: Optional[str] = None, cohort: bool = False) -> bool:
    """True when re-expansion onto the lost device looks safe NOW.

    Read-only: consumes no breaker half-open trial and advances no
    fault-spec call counters.  ``site`` narrows the injected-fault
    check to one dispatch site (None = any armed loss counts).
    ``cohort``: the engine's pages live in several processes; every
    rank probes and the ranks agree (parallel/cluster.py ``agree_all``),
    so no rank expands unless every rank is healthy.
    """
    ok = _probe(site)
    if cohort:
        from ..parallel import cluster

        ok = cluster.agree_all(ok)
    return ok


def _probe(site: Optional[str]) -> bool:
    """This process's health probe (:func:`health_probe`)."""
    if _faults.is_suspended():
        return False  # mid-snapshot / oracle read: stand still
    br = _breaker.get_breaker()
    if br.open_remaining_s() > 0:
        return False  # breaker still cooling down
    if _faults.device_down(site):
        return False  # injected loss window still open
    if os.environ.get("QRACK_TPU_ELASTIC_PROBE", "") not in ("", "0"):
        from .probe import run_probe

        timeout_s = float(os.environ.get("QRACK_TPU_ELASTIC_PROBE_TIMEOUT",
                                         "60"))
        if not run_probe(timeout_s=timeout_s).ok:
            return False
    return True


def elastic_core(engine):
    """Unwrap forwarding layers (ResilientEngine._engine,
    QHybrid._engine, ...) down to the first object that owns elastic
    paging state, or None when nothing in the stack does."""
    seen = 0
    while engine is not None and seen < 4:
        if getattr(engine, "_elastic_target_g", None) is not None \
                and hasattr(engine, "expand_pages"):
            return engine
        engine = getattr(engine, "_engine", None)
        seen += 1
    return None


def maybe_reexpand(engine) -> bool:
    """Grow a degraded pager back to its construction page count when
    the health probe passes.  Safe to call on ANY engine at any call
    boundary: no-op unless something in the wrapper stack is degraded.
    Returns True when a re-expansion actually happened."""
    core = elastic_core(engine)
    if core is None:
        return False
    return bool(core.maybe_reexpand())
