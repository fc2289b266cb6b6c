"""Deterministic fault injection for the resilience layer (the port of
the JAX package's resilience/faults.py: the same grammar, kinds, seeded
firing and corruption model; the sites carry the port's ``cuda`` label).

Grammar (``QRACK_TPU_FAULTS``, comma-separated specs):

    site:kind:after_n[:seed]

* ``site`` — a full dispatch-site name (``cuda.compile``,
  ``pager.exchange``, ...), a bare site category matching any engine
  (``discover``, ``compile``, ``dispatch``, ``device_get``,
  ``exchange``, ``flush``), or ``*`` for every site.
* ``kind`` — ``timeout`` | ``hang`` | ``raise`` | ``nan-poison`` |
  ``device-loss`` | ``flap`` | ``torn-write`` | ``amp-corrupt`` |
  ``kill``.
* ``after_n`` — how many calls at the site pass through before the
  fault arms.  ``N`` fires once at call N+1 then heals (the transient
  case retry must recover); ``N+M`` fires on M consecutive calls;
  ``N+`` never heals (the persistent case that must trip the breaker
  or fail over).
* ``seed`` — optional; when set, each armed call fires with
  probability 1/2 drawn from a PCG64(seed) stream private to the spec.

``flap`` is device-loss with declarative auto-recovery: it raises
:class:`DeviceLost` at site entry exactly like ``device-loss``, but is
meant to be written with a bounded window (``site:flap:N+M``).  While
either kind's window is open, :func:`device_down` reports the device
as unhealthy so the elastic recovery probe (resilience/elastic.py)
refuses to re-expand onto it.

Specs are validated at parse time against :data:`SITES` and
:data:`KINDS`: an unknown site or kind raises ValueError listing the
valid values.  A site of the JAX package that can never fire in the
port (the JAX dense engine's ``tpu.*`` names) raises ValueError naming
the port's site (:data:`NOT_PORTED`): a spec that can never fire must
not pass silently.

Every kind except ``amp-corrupt`` fires at SITE ENTRY, before the
guarded callable runs, so nothing has been written when it raises and
a retry runs the dispatch exactly once.  ``amp-corrupt`` fires at SITE
EXIT instead: it perturbs one amplitude of the dispatch OUTPUT on its
device (finite, order-unity, seeded — the silent-data-corruption
model, at the element the JAX package picks from the same seed), so
nothing raises at the site and only the integrity guard plane
(resilience/integrity.py) can catch it downstream.  On a pager whose
pages live in several processes every rank draws the same element and
only the page's owner writes it; a fault on one rank only is armed by
giving that rank's process its own ``QRACK_TPU_FAULTS``.

Injection is recorded as `resilience.fault.<site>.<kind>` telemetry
events.  Tests drive the programmatic API (:func:`inject`,
:func:`clear`, :func:`suspended`) instead of the env var; it is not
validated, so tests may name synthetic sites.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import List, Optional

from .. import telemetry as _tele
from .errors import (DeviceLost, InjectedFault, NaNPoisoned)

KINDS = ("timeout", "hang", "raise", "nan-poison", "device-loss",
         "flap", "torn-write", "amp-corrupt", "kill")

# every guarded site of the port (grep '"<name>"' call_guarded /
# instrument_dispatch / faults.check call sites when adding one)
SITES = (
    "discover",
    # the dense engine: each gate-function dispatch, each host read, and
    # each fused window (engines/cuda.py; parallel/pager.py and
    # noise/trajectories.py run their windows at cuda.fuse.flush too)
    "cuda.compile", "cuda.device_get", "cuda.fuse.flush",
    "pager.dispatch", "pager.exchange", "pager.device_get",
    "turboquant.dispatch", "turboquant_pager.exchange",
    # host-side branch pre-sampling for trajectory batches
    # (noise/trajectories.py _sample_operands) — checked directly
    "noise.sample",
    "checkpoint.save", "checkpoint.restore",
    # each light-cone read before it slices the buffer
    # (lightcone/engine.py _slice) — checked directly
    "lightcone.slice",
    # the serving plane: each batched dispatch, its honest sync, and the
    # prefix materialization (checked directly; amp-corrupt strikes the
    # copy that would be cached) — serve/batcher.py, serve/executor.py
    "serve.dispatch", "serve.device_get", "prefix.materialize",
    # process-plane sites (fleet/): checked by the supervisor's monitor
    # tick, the worker's heartbeat writer and the supervisor's spawn —
    # ``fleet.worker:kill:after_n`` makes the supervisor SIGKILL its own
    # worker, ``fleet.heartbeat:hang:after_n`` makes a worker stop
    # beating while it keeps serving (the missed-beat path), and
    # ``fleet.spawn:hang`` wedges a boot (the spawned process never
    # becomes ready) while ``fleet.spawn:raise`` kills it at exec
    "fleet.worker", "fleet.heartbeat", "fleet.spawn",
)
# bare last-segment categories that match the site family on any engine
CATEGORIES = ("discover", "compile", "dispatch", "device_get", "exchange",
              "flush")

#: sites of the JAX package that cannot fire in the port, with the
#: port's site that takes each one's place
NOT_PORTED = {
    "tpu.compile": "the port's dense engine sites are 'cuda.*' "
                   "(cuda.compile)",
    "tpu.device_get": "the port's dense engine sites are 'cuda.*' "
                      "(cuda.device_get)",
    "tpu.fuse.flush": "the port's dense engine sites are 'cuda.*' "
                      "(cuda.fuse.flush)",
}


def validate_site(site: str) -> None:
    """Raise ValueError for a site token that can never match a guarded
    site of the port: a JAX-only one names the port's site, an unknown
    one lists the valid values."""
    if site == "*" or site in SITES or site in CATEGORIES:
        return
    if site in NOT_PORTED:
        raise ValueError(f"fault site {site!r} is not ported yet: "
                         f"{NOT_PORTED[site]}")
    raise ValueError(
        f"unknown fault site {site!r}; valid sites: {', '.join(SITES)}; "
        f"categories: {', '.join(CATEGORIES)}; or '*'")


_LOCK = threading.RLock()
_SPECS: List["FaultSpec"] = []
_SUSPENDED = 0  # re-entrant suspension depth (failover snapshots)
# fast-path flag for the site-EXIT hook: call_guarded only pays the
# corrupt_output call when an amp-corrupt spec is actually armed
_HAS_CORRUPT = False


def _recount_locked() -> None:
    global _HAS_CORRUPT
    _HAS_CORRUPT = any(s.kind == "amp-corrupt" for s in _SPECS)


@dataclass
class FaultSpec:
    site: str
    kind: str
    after_n: int = 0
    times: Optional[int] = 1       # None = persistent (never heals)
    seed: Optional[int] = None
    calls: int = 0                 # matching calls observed
    fired: int = 0                 # faults actually delivered
    # amp-corrupt only (programmatic API; no env grammar): pin every
    # strike to ONE page so attribution lands on one page slot
    page: Optional[int] = None
    n_pages: Optional[int] = None
    _rng: object = field(default=None, repr=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (kinds: {', '.join(KINDS)})")
        if self.seed is not None:
            import numpy as np

            self._rng = np.random.Generator(np.random.PCG64(self.seed))

    def matches(self, site: str) -> bool:
        return (self.site == "*" or self.site == site
                or site.rsplit(".", 1)[-1] == self.site)

    def should_fire(self) -> bool:
        """Advance this spec's call counter; True when the fault fires."""
        self.calls += 1
        if self.calls <= self.after_n:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self._rng is not None and self._rng.random() >= 0.5:
            return False
        self.fired += 1
        return True


def parse_spec(text: str) -> FaultSpec:
    parts = text.strip().split(":")
    if len(parts) < 3 or len(parts) > 4:
        raise ValueError(
            f"bad fault spec {text!r}: want site:kind:after_n[:seed]")
    site, kind, after = parts[0], parts[1], parts[2]
    validate_site(site)
    try:
        seed = int(parts[3]) if len(parts) == 4 else None
        if "+" in after:
            n, m = after.split("+", 1)
            times = None if m in ("", "inf") else int(m)
            after_n = int(n)
        else:
            after_n, times = int(after), 1
    except ValueError:
        raise ValueError(
            f"bad fault spec {text!r}: after_n/seed must be integers "
            "(grammar: site:kind:after_n[:seed], after_n = N | N+M | N+)")
    return FaultSpec(site=site, kind=kind, after_n=after_n,
                     times=times, seed=seed)


def load_env(value: Optional[str] = None) -> int:
    """(Re)load specs from QRACK_TPU_FAULTS; returns the spec count.  A
    spec that fails to parse raises and leaves the loaded set as it
    was."""
    if value is None:
        value = os.environ.get("QRACK_TPU_FAULTS", "")
    parsed = [parse_spec(tok) for tok in value.split(",") if tok.strip()]
    with _LOCK:
        _SPECS[:] = parsed
        _recount_locked()
        return len(_SPECS)


def inject(site: str, kind: str, after_n: int = 0,
           times: Optional[int] = 1, seed: Optional[int] = None,
           page: Optional[int] = None,
           n_pages: Optional[int] = None) -> FaultSpec:
    """Programmatic injection (tests).  Activates the resilience layer
    so guarded sites start checking.  ``page``/``n_pages`` pin an
    ``amp-corrupt`` strike to one page (quarantine tests)."""
    spec = FaultSpec(site=site, kind=kind, after_n=after_n,
                     times=times, seed=seed, page=page, n_pages=n_pages)
    with _LOCK:
        _SPECS.append(spec)
        _recount_locked()
    from . import enable

    enable()
    return spec


def clear() -> None:
    with _LOCK:
        _SPECS.clear()
        _recount_locked()


def specs() -> List[FaultSpec]:
    with _LOCK:
        return list(_SPECS)


def is_suspended() -> bool:
    with _LOCK:
        return _SUSPENDED > 0


def device_down(site: Optional[str] = None) -> bool:
    """True while an armed ``device-loss``/``flap`` spec still has fires
    left — the injected analogue of "the device is unhealthy right now".
    Read-only: does NOT advance call counters."""
    with _LOCK:
        if _SUSPENDED:
            return False
        for spec in _SPECS:
            if spec.kind not in ("device-loss", "flap"):
                continue
            if site is not None and not spec.matches(site):
                continue
            if spec.calls < spec.after_n:
                continue  # window not open yet
            if spec.times is not None and spec.fired >= spec.times:
                continue  # healed
            return True
    return False


class suspended:
    """Re-entrant context manager standing down the WHOLE resilience
    machinery (injection here; breaker/watchdog via dispatch.py checking
    :func:`is_suspended`).  Failover moves and verification reads run
    through it: neither an injected fault nor an already-open breaker
    may block the recovery path that exists to get state OFF the failing
    engine."""

    def __enter__(self):
        global _SUSPENDED
        with _LOCK:
            _SUSPENDED += 1
        return self

    def __exit__(self, *exc):
        global _SUSPENDED
        with _LOCK:
            _SUSPENDED -= 1
        return False


def check(site: str) -> Optional[str]:
    """Evaluate injection at a dispatch site.

    Raises the matching DispatchFailure subclass for the
    ``timeout``/``raise``/``nan-poison``/``device-loss``/``flap`` kinds,
    returns a directive string for the kinds the SITE must act out
    itself — ``"hang"`` (the dispatch wrapper swaps in a sleeping stub),
    ``"torn-write"`` (checkpoint.save truncates the payload mid-write)
    and ``"kill"`` (the fleet supervisor SIGKILLs its own worker) — or
    returns None (no fault).
    """
    with _LOCK:
        if not _SPECS or _SUSPENDED:
            return None
        fired_kind = None
        for spec in _SPECS:
            if spec.kind == "amp-corrupt":
                continue  # fires at site EXIT via corrupt_output()
            if spec.matches(site) and spec.should_fire():
                fired_kind = spec.kind
                break
    if fired_kind is None:
        return None
    if _tele._ENABLED:
        _tele.event(f"resilience.fault.{site}.{fired_kind}")
    if fired_kind in ("hang", "torn-write", "kill"):
        return fired_kind
    if fired_kind == "timeout":
        from .errors import DispatchTimeout

        raise DispatchTimeout(site, detail="injected timeout")
    if fired_kind == "device-loss":
        raise DeviceLost(site, "injected device loss")
    if fired_kind == "flap":
        raise DeviceLost(site, "injected device flap")
    if fired_kind == "nan-poison":
        raise NaNPoisoned(site, "injected non-finite output")
    raise InjectedFault(site, "injected failure")


def _values(out) -> list:
    """The arrays of a dispatch output, in order: a tuple's elements, or
    the output itself.  A list is the pages of ONE array (a pager's
    pages, in physical order)."""
    return list(out) if isinstance(out, tuple) else [out]


def _is_float(v) -> bool:
    import numpy as np
    import torch

    from ..ops.sharded import is_remote

    if isinstance(v, list):
        # a pager's pages; another process's placeholders hold no values
        here = [p for p in v if not is_remote(p)]
        return bool(here) and all(_is_float(p) for p in here)
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    dt = getattr(v, "dtype", None)
    return (isinstance(v, np.ndarray) and dt is not None
            and np.issubdtype(dt, np.floating))


def validate_finite(site: str, out) -> None:
    """QRACK_TPU_VALIDATE=1 hook: raise NaNPoisoned when a float array
    in `out` holds a non-finite value.  Reads a flag back from the
    device (a sync), so this is an opt-in."""
    import numpy as np
    import torch

    from ..ops.sharded import is_remote

    for v in _values(out):
        if not _is_float(v):
            continue
        for t in (v if isinstance(v, list) else [v]):
            if is_remote(t):
                continue
            ok = (bool(torch.isfinite(t).all().item())
                  if isinstance(t, torch.Tensor) else
                  bool(np.all(np.isfinite(t))))
            if not ok:
                raise NaNPoisoned(site, "non-finite value in dispatch output")


def _corrupt_value(v, rng, page=None, n_pages=None):
    """Perturb ONE element of float array `v` (a tensor, a list of page
    tensors read as their concatenation along the last axis, or a host
    numpy array) by an order-unity finite delta, ON ITS DEVICE and in
    place for tensors.  The element and the delta are those the JAX
    package picks from the same rng: an index over the flattened array
    (or, with ``page`` pinned, inside that page's contiguous slice of
    the last axis), pushed away from zero."""
    import numpy as np
    import torch

    from ..ops.sharded import is_remote

    if isinstance(v, np.ndarray):
        flat = v.reshape(-1).copy()
        parts, lead, total = None, None, v.shape[-1] if v.ndim else 1
        size = flat.size
        ndim = v.ndim
    else:
        parts = v if isinstance(v, list) else [v]
        lead = tuple(parts[0].shape[:-1])
        total = sum(int(p.shape[-1]) for p in parts)
        size = int(np.prod(lead, dtype=np.int64)) * total
        ndim = len(lead) + 1
    if size == 0:
        return v
    if page is not None and n_pages and ndim >= 2 and total % n_pages == 0:
        chunk = total // n_pages
        # element (0, col) of the planes flattens to index `col`
        idx = page * chunk + int(rng.integers(0, chunk))
    else:
        idx = int(rng.integers(0, size))
    # push AWAY from zero: the element's probability grows by at least
    # delta**2 ~ 0.06, far over any norm budget
    delta = 0.25 + 0.5 * float(rng.random())
    if parts is None:
        flat[idx] += delta if flat[idx] >= 0 else -delta
        return flat.reshape(v.shape).astype(v.dtype)
    row, col = divmod(idx, total)
    for p in parts:
        if col < p.shape[-1]:
            break
        col -= int(p.shape[-1])
    if is_remote(p):
        # the element lies on a page of another process, whose spec
        # (the same draws: every rank runs the same dispatches) strikes it
        return v
    elem = p.reshape(-1, p.shape[-1])[row, col]   # a view: p is contiguous
    sign = torch.where(elem >= 0, 1.0, -1.0).to(elem.dtype)
    elem.add_(sign * delta)
    return v


def corrupt_output(site: str, out):
    """SITE-EXIT hook (dispatch.py): deliver any armed ``amp-corrupt``
    spec by perturbing the first float array in the dispatch output.
    Returns the (possibly corrupted) output.  Unlike entry kinds this
    never raises — the corruption is the whole point."""
    with _LOCK:
        if not _SPECS or _SUSPENDED:
            return out
        spec_fired = None
        for spec in _SPECS:
            if (spec.kind == "amp-corrupt" and spec.matches(site)
                    and spec.should_fire()):
                spec_fired = spec
                break
    if spec_fired is None:
        return out
    if _tele._ENABLED:
        _tele.event(f"resilience.fault.{site}.amp-corrupt")
    import numpy as np

    rng = spec_fired._rng
    if rng is None:  # unseeded specs still corrupt deterministically
        rng = np.random.Generator(np.random.PCG64(
            0xA3C0 ^ (spec_fired.after_n << 8) ^ spec_fired.fired))
    vals = _values(out)
    for i, v in enumerate(vals):
        if _is_float(v):
            vals[i] = _corrupt_value(v, rng, page=spec_fired.page,
                                     n_pages=spec_fired.n_pages)
            break
    return tuple(vals) if isinstance(out, tuple) else vals[0]


# env-armed at import so `QRACK_TPU_FAULTS=... python app.py` needs no
# code change
if os.environ.get("QRACK_TPU_FAULTS", "").strip():
    load_env()
