"""Integrity guard plane: silent-data-corruption detection, scoped
window replay, and page-slot quarantine (the port of the JAX package's
resilience/integrity.py).

Three mechanisms, all gated behind the resilience layer's off-by-default
switch (one module attribute read + truth test per site when inactive):

* **Boundary invariants** — every state fingerprint is checked against
  finiteness and a norm-drift budget scheduled on gates since the last
  verified fingerprint (a freshly verified ket must sum to
  ``running_norm`` within ``tol``; each further gate earns
  ``tol_per_gate`` of slack).  Fingerprints are reductions on the card:
  one total probability for the dense engine, one a page for the pager
  (:func:`_prob64`: the norms of rows of 4096 plane entries in one read
  of the planes, their squares summed in float64), the per-chunk masses
  straight off the codes for TurboQuant.  At the host
  read boundaries (``cuda.device_get``, ``pager.device_get``) the value
  already fetched is checked in place (:func:`check_host`).

* **Scoped window replay** — detection wraps the gate-stream flush
  (ops/fusion.py): the fuser holds its gates until a flush succeeds, so
  a violated invariant restores the pre-flush planes (and the pager's
  placement table) from a snapshot and re-dispatches the SAME kept
  window — exactly once by construction.  The same snapshot replays a
  dispatch that failed after writing the planes in place
  (``DispatchGiveUp(torn=True)``, dispatch.py).  A replay that comes
  back clean proves the corruption transient; the page whose
  fingerprint differed between the corrupt and clean runs is the
  attribution.  A replay that corrupts again escalates as
  DispatchGiveUp into the shrink / failover chain with the GOOD planes
  restored.

  The snapshot stays on the card: a ``clone()`` of the planes (page by
  page for the pager, codes and scales for TurboQuant), where the JAX
  package copies to the host because donation invalidates its input.
  Where the card's free memory (what ``cudaMemGetInfo`` reports, plus
  what the caching allocator holds unused) cannot hold the copy and one more tensor of
  the largest size beside it, the copy goes to the host instead (a w33
  float32 pager: 64 GiB of pages).  Either way the restore is a
  ``copy_`` back, bit for bit.

* **Pages in several processes** — on a pager over the cluster's page
  homes each rank fingerprints its own pages and the page values are
  all-reduced in float64 in page order, so every rank verifies the same
  fingerprint, attributes the same slot and replays the same kept window
  (the dispatch's own outcome is agreed in dispatch.py); the snapshot
  and its restore cover this process's pages, beside the placement
  table every rank keeps.

* **Quarantine** — attributed strikes accumulate per PAGE SLOT (the
  page's index in the pager's construction device list, spares after
  it): the JAX package keys them by device id, and its tests run one
  page a device, so the numbers agree wherever the JAX mesh is
  ``jax.devices()[:P]``; here one card may fill every slot.  Past
  ``QRACK_TPU_QUARANTINE_STRIKES`` a slot joins the quarantine set,
  which the pager's re-paging consumes (parallel/pager.py
  ``_device_pool``): the slot is excluded and a spare takes its place at
  the next call boundary.

Env knobs (the JAX package's): ``QRACK_TPU_INTEGRITY`` ("0" disables the
plane even when resilience is active), ``QRACK_TPU_INTEGRITY_TOL``
(1e-3), ``QRACK_TPU_INTEGRITY_TOL_PER_GATE`` (1e-6),
``QRACK_TPU_INTEGRITY_TOL_QUANT`` (4 / qmax),
``QRACK_TPU_INTEGRITY_REPLAYS`` (2), ``QRACK_TPU_QUARANTINE_STRIKES``
(3).

Telemetry: ``integrity.violation`` events (site/reason/attempt),
``integrity.replay.repaired`` / ``integrity.replay.giveup``,
``integrity.quarantine.strike`` / ``integrity.quarantine.device`` and
the ``integrity.quarantined`` gauge.  The serving canary that feeds the
same strike table comes with ROADMAP item 16.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np

from .. import telemetry as _tele
from . import dispatch as _dispatch
from .errors import FAILOVER_ERRORS, CorruptionDetected, DispatchGiveUp

_ENABLED: bool = os.environ.get("QRACK_TPU_INTEGRITY", "") != "0"

_LOCK = threading.Lock()
_STRIKES: Dict[int, int] = {}      # page slot -> attributed strikes
_QUARANTINED: frozenset = frozenset()
#: bumped on every quarantine-set change; the pager's call-boundary
#: probe caches the last epoch seen, so the healthy-path cost is one
#: module attribute read + int compare
_EPOCH: int = 0

#: plane entries a row of the fingerprint reduction holds
_FP_ROW = 1 << 12


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


# -- budgets -----------------------------------------------------------


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def drift_budget(gates_since: int) -> float:
    """Norm tolerance scheduled on gates since the last verified
    fingerprint: base + per-gate slack for legitimate rounding."""
    base = _env_float("QRACK_TPU_INTEGRITY_TOL", 1e-3)
    per_gate = _env_float("QRACK_TPU_INTEGRITY_TOL_PER_GATE", 1e-6)
    return base + per_gate * max(0, int(gates_since))


def quant_slack(eng) -> float:
    """Extra norm tolerance for TurboQuant engines: every flush
    requantizes the touched chunks, so chunk masses walk by
    O(scale/qmax) per window."""
    qmax = getattr(eng, "_qmax", None)
    if qmax is None or getattr(eng, "_tq_bits", None) is None:
        return 0.0
    return _env_float("QRACK_TPU_INTEGRITY_TOL_QUANT", 4.0 / float(qmax))


def max_replays() -> int:
    try:
        return int(os.environ.get("QRACK_TPU_INTEGRITY_REPLAYS", "2"))
    except ValueError:
        return 2


def strike_threshold() -> int:
    try:
        return int(os.environ.get("QRACK_TPU_QUARANTINE_STRIKES", "3"))
    except ValueError:
        return 3


# -- the resident state ------------------------------------------------


def _is_tq(eng) -> bool:
    return getattr(eng, "_tq_bits", None) is not None


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _resident(eng) -> list:
    """The tensors that hold the engine's ket, read raw (the guard runs
    inside a flush, where the property getters are a re-entry hazard):
    TurboQuant's codes then scales, the pager's pages, or the dense
    engine's planes."""
    if _is_tq(eng):
        return _as_list(eng._codes_raw) + _as_list(eng._scales_raw)
    pages = getattr(eng, "_pages_raw", None)
    if pages is not None:
        return list(pages)
    return [eng._state_raw]


def _assign(eng, tensors: list) -> None:
    """Install `tensors` (the layout of :func:`_resident`) as the ket,
    through the raw attributes."""
    if _is_tq(eng):
        half = len(tensors) // 2
        if isinstance(eng._codes_raw, (list, tuple)):
            eng._codes_raw, eng._scales_raw = (list(tensors[:half]),
                                               list(tensors[half:]))
        else:
            eng._codes_raw, eng._scales_raw = tensors
    elif getattr(eng, "_pages_raw", None) is not None:
        eng._pages_raw = list(tensors)
    else:
        eng._state_raw = tensors[0]


# -- fingerprints ------------------------------------------------------


def _prob64(planes):
    """Total probability of (2, N) planes as a float64 scalar on their
    device: the norms of rows of _FP_ROW entries (one read of the planes;
    a float32 or float64 reduction a row, never a copy), squared and
    summed in float64.  16-bit planes reduce in float32, a block of rows
    at a time."""
    import torch

    flat = planes.reshape(-1)
    rows = flat.view(-1, min(_FP_ROW, flat.numel()))
    if planes.dtype in (torch.float16, torch.bfloat16):
        acc = torch.zeros((), dtype=torch.float64, device=planes.device)
        step = max(1, (1 << 24) // rows.shape[1])
        for r0 in range(0, rows.shape[0], step):
            rn = torch.linalg.vector_norm(rows[r0:r0 + step], dim=1,
                                          dtype=torch.float32)
            acc += torch.sum(rn.to(torch.float64) ** 2)
        return acc
    rn = torch.linalg.vector_norm(rows, dim=1)
    return torch.sum(rn.to(torch.float64) ** 2)


def _tq_masses(eng, codes: list, scales: list) -> list:
    """Per-chunk probability masses of TurboQuant (codes, scales), a
    float64 array a page (zeros for another process's page), without a
    decode (the block rotation is orthogonal, so a row's norm survives
    compression)."""
    import torch

    from ..ops.sharded import is_remote

    cb, twoD = eng._chunk_blocks, 2 * eng._block
    out = []
    for c, s in zip(codes, scales):
        if is_remote(c):
            out.append(np.zeros(c.shape[0] // cb, dtype=np.float64))
            continue
        c3 = c.reshape(-1, cb, twoD)
        s2 = s.reshape(-1, cb)
        step = max(1, eng._GROUP_AMPS // eng._chunk_amps)
        got = []
        for c0 in range(0, c3.shape[0], step):
            y = (c3[c0:c0 + step].to(torch.float32)
                 * (s2[c0:c0 + step] / float(eng._qmax)).unsqueeze(-1))
            got.append(torch.sum(y * y, dim=(1, 2)).to(torch.float64))
        out.append(torch.cat(got).to("cpu").numpy())
    return out


def _fingerprint_of(eng, tensors: list) -> np.ndarray:
    """The fingerprint of `tensors` (the layout of :func:`_resident`):
    each page's part on the page's owner, the parts of a pager over
    page homes all-reduced in float64 in page order."""
    import torch

    from ..ops.sharded import is_remote

    if _is_tq(eng):
        half = len(tensors) // 2
        parts = _tq_masses(eng, tensors[:half], tensors[half:])
        fp = np.concatenate(parts) if parts else np.zeros(0)
    else:
        fp = np.zeros(len(tensors), dtype=np.float64)
        here = [i for i, t in enumerate(tensors) if not is_remote(t)]
        if here:
            sums = [_prob64(tensors[i]) for i in here]
            dev = sums[0].device
            fp[here] = torch.stack([x.to(dev) for x in sums]).to(
                "cpu").numpy()
    if _dispatch.cohort_of(eng):
        from ..parallel import cluster

        fp = cluster.all_reduce_f64(fp)
    return np.asarray(fp, dtype=np.float64)


def fingerprint(eng) -> np.ndarray:
    """Per-page probability sums (pager), the one-element norm vector
    (dense engine) or the per-chunk masses (TurboQuant) of the RESIDENT
    state, reduced on its device — the cheap proxy every invariant is
    checked against.  A pager over page homes sums each page on its
    owner and all-reduces the pages' values, so every rank checks the
    same fingerprint and takes the same decision."""
    from . import faults as _faults

    with _faults.suspended():
        # the verification read must neither advance fault-spec call
        # counters nor be corrupted or refused itself
        return _fingerprint_of(eng, _resident(eng))


def host_fingerprint(planes, n_pages: int = 1) -> np.ndarray:
    """Fingerprint of host planes (2, N): per-page probability sums in
    numpy, page p owning the p-th contiguous slice of axis 1."""
    planes = np.asarray(planes, dtype=np.float64)
    pages = planes.reshape(2, n_pages, -1)
    return np.sum(pages[0] ** 2 + pages[1] ** 2, axis=1)


def verify(eng, site: str) -> np.ndarray:
    """Check the resident state against the boundary invariants.
    Returns the (clean) fingerprint; raises CorruptionDetected with the
    offending fingerprint attached on a violation.  A pass re-anchors
    the engine's drift budget (``_integ_mark``)."""
    fp = fingerprint(eng)
    gate_count = int(getattr(eng, "_gate_count", 0))
    if not np.all(np.isfinite(fp)):
        raise CorruptionDetected(site, "non-finite fingerprint", fp=fp)
    expected = float(getattr(eng, "running_norm", 1.0) or 1.0)
    gates_since = gate_count - int(getattr(eng, "_integ_mark", 0))
    budget = drift_budget(gates_since)
    total = float(fp.sum())
    drift = abs(total - expected)
    slack = quant_slack(eng)
    if slack:
        # quantized engines: also accept the last verified mass as an
        # anchor — corruption jumps against both, quantization drift
        # tracks the anchor
        budget += slack
        anchor = getattr(eng, "_integ_mass_anchor", None)
        if anchor is not None:
            drift = min(drift, abs(total - float(anchor)))
    if drift > budget:
        raise CorruptionDetected(
            site, f"norm drift {drift:.3e} exceeds budget {budget:.3e} "
            f"({gates_since} gates since last verify)", fp=fp)
    eng._integ_mark = gate_count
    if slack:
        eng._integ_mass_anchor = total
    return fp


def check_host(site: str, arr, *, norm_expected: Optional[float] = None,
               gates_since: int = 0) -> None:
    """Boundary invariant over an ALREADY-FETCHED host value (the
    device_get read path) — no extra device traffic.  Finiteness
    always; norm only when the caller read a whole ket and passes its
    expected norm."""
    from . import faults as _faults

    if _faults.is_suspended():
        return  # recovery reads (failover moves, re-page gathers)
    a = np.asarray(arr)
    if not np.issubdtype(a.dtype, np.floating) and \
            not np.issubdtype(a.dtype, np.complexfloating):
        return
    if not np.all(np.isfinite(a)):
        _violation(site, "non-finite host read")
        raise CorruptionDetected(site, "non-finite value in host read")
    if norm_expected is not None:
        nrm = float(np.sum(np.abs(a) ** 2))
        budget = drift_budget(gates_since)
        if abs(nrm - norm_expected) > budget:
            _violation(site, "host-read norm drift")
            raise CorruptionDetected(
                site, f"host-read norm {nrm:.6f} vs expected "
                f"{norm_expected:.6f} (budget {budget:.3e})")


def _violation(site: str, reason: str, **fields) -> None:
    if _tele._ENABLED:
        _tele.event("integrity.violation", site=site, reason=reason,
                    **fields)


# -- scoped window replay ----------------------------------------------


def _free_bytes(dev) -> int:
    """Bytes a new tensor on CUDA device `dev` can take: the free memory
    ``torch.cuda.mem_get_info`` reports plus what torch's caching
    allocator holds unused."""
    import torch

    free, _total = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev)
               - torch.cuda.memory_allocated(dev))


def _on_card(tensors: list) -> bool:
    """True when a copy of `tensors` fits beside them on their devices,
    with room for one more tensor of the largest size (the transient of
    one functional gate, or of a page pass).  Another process's pages
    are its own."""
    from ..ops.sharded import is_remote

    need: Dict = {}
    largest = 0
    for t in tensors:
        if is_remote(t):
            continue
        nb = t.numel() * t.element_size()
        largest = max(largest, nb)
        if t.device.type == "cuda":
            need[t.device] = need.get(t.device, 0) + nb
    return all(nb + largest <= _free_bytes(dev) for dev, nb in need.items())


def snapshot_placement(eng) -> str:
    """Where a pre-flush snapshot of `eng` would go now: "device" (a
    copy beside the planes on their card; also for CPU tensors) or
    "host"."""
    return "device" if _on_card(_resident(eng)) else "host"


def _snapshot(eng) -> list:
    """Copy of the resident state taken BEFORE a flush dispatch: on the
    card when it fits there (:func:`_on_card`), else on the host.  The
    kernels write the planes in place, so replay is only possible from
    a copy.  A pager over page homes copies this process's pages only
    (another process's placeholders stay as they are)."""
    from ..ops.sharded import is_remote

    ts = _resident(eng)
    if _on_card(ts):
        return [t if is_remote(t) else t.clone() for t in ts]
    return [t if is_remote(t) else t.to("cpu", copy=True) for t in ts]


def _restore(eng, keep: list) -> None:
    """Put the pre-flush state back, bit for bit: a ``copy_`` into the
    resident tensors where the flush kept their layout, else new tensors
    on the resident devices.  Assigns raw attributes — the property
    setters' drop-on-overwrite must not fire for a repair that is about
    to re-dispatch the kept window."""
    from ..ops.sharded import is_remote

    cur = _resident(eng)
    if len(cur) == len(keep) and all(
            c is not None and c.shape == k.shape and c.dtype == k.dtype
            and is_remote(c) == is_remote(k) for c, k in zip(cur, keep)):
        for c, k in zip(cur, keep):
            if not is_remote(c):
                c.copy_(k)
        return
    devs = ([k.device if c is None or is_remote(c) else c.device
             for c, k in zip(cur, keep)] if len(cur) == len(keep) else
            [None if is_remote(k) else k.device for k in keep])
    _assign(eng, [k if is_remote(k) else k.to(d, copy=True)
                  for k, d in zip(keep, devs)])


def _slot(eng, page: int) -> Optional[int]:
    """The page slot of page `page` (its index in the pager's
    construction device list), or None for an engine without pages."""
    slots = getattr(eng, "page_slots", None)
    if not slots:
        return None
    return slots[page] if 0 <= page < len(slots) else None


def _attribute(eng, corrupt_fp: np.ndarray, clean_fp: np.ndarray,
               site: str) -> Optional[int]:
    """Which page slot produced the corruption: the page whose
    fingerprint differs between the corrupt and the clean run of the
    SAME window — exact for a repaired replay, a pre-flush-baseline
    heuristic when escalating."""
    if corrupt_fp is None or clean_fp is None or \
            corrupt_fp.shape != clean_fp.shape:
        return None
    bad = ~np.isfinite(corrupt_fp)
    if bad.any():
        page = int(np.argmax(bad))
    else:
        # the first page at the largest difference, counting as ties the
        # differences within the fingerprints' rounding (1e-6 relative),
        # so an exact tie goes to the lowest page whatever the rounding
        d = np.abs(corrupt_fp - clean_fp)
        page = int(np.argmax(d >= d.max() * (1 - 1e-6)))
    slot = _slot(eng, page)
    if slot is None:
        return None
    record_strike(slot, site, page=page)
    return slot


def guarded_flush(eng, flush_fn, site: str = "cuda.fuse.flush") -> int:
    """Snapshot → dispatch → verify → replay envelope around one fused
    window flush.  Corruption inside the window restores the pre-flush
    state and re-dispatches the same kept gates; so does a dispatch that
    failed after writing the planes in place (``torn``).  A replay that
    fails again gives up with the good state restored, handing the
    shrink / failover chain an uncorrupted base.  A failure raised
    before any write (an injected entry fault, an open breaker)
    propagates at once: the planes are as they were."""
    keep = _snapshot(eng)
    # the placement table travels with the planes: a flush that commits
    # a remap before verify catches corruption must roll BOTH back
    keep_map = getattr(eng, "_qmap", None)
    keep_map = list(keep_map) if keep_map is not None else None

    def restore() -> None:
        _restore(eng, keep)
        if keep_map is not None:
            eng._map_assign(keep_map)

    corrupt_fp = None
    cause = None
    try:
        for attempt in range(max_replays() + 1):
            try:
                dispatched = flush_fn()
            except FAILOVER_ERRORS as e:
                if not getattr(e, "torn", False):
                    raise
                _violation(site, "dispatch failed after writing the planes",
                           attempt=attempt)
                cause = e.cause
                restore()
                continue
            try:
                clean_fp = verify(eng, site)
            except CorruptionDetected as e:
                _violation(site, e.detail, attempt=attempt)
                corrupt_fp, cause = e.fp, e
                restore()
                continue
            if attempt:
                _attribute(eng, corrupt_fp, clean_fp, site)
                if _tele._ENABLED:
                    _tele.event("integrity.replay.repaired", site=site,
                                replays=attempt)
            return dispatched
        # every replay failed: attribute against the pre-flush baseline
        # (heuristic — a legitimate window moves mass between pages too),
        # restore the good state, and escalate to shrink/failover
        if corrupt_fp is not None:
            _attribute(eng, corrupt_fp, _fingerprint_of(eng, keep), site)
        restore()
        if _tele._ENABLED:
            _tele.event("integrity.replay.giveup", site=site,
                        replays=max_replays())
        raise DispatchGiveUp(site, cause)
    finally:
        del keep


# -- quarantine --------------------------------------------------------


def record_strike(slot, site: str, page: Optional[int] = None) -> None:
    """One attributed corruption against page slot `slot`; quarantines
    the slot once strikes reach the threshold."""
    global _QUARANTINED, _EPOCH
    if slot is None:
        return
    with _LOCK:
        n = _STRIKES.get(slot, 0) + 1
        _STRIKES[slot] = n
        newly = n >= strike_threshold() and slot not in _QUARANTINED
        if newly:
            _QUARANTINED = _QUARANTINED | {slot}
            _EPOCH += 1
    if _tele._ENABLED:
        _tele.event("integrity.quarantine.strike", device=slot,
                    site=site, strikes=n,
                    **({} if page is None else {"page": page}))
        if newly:
            _tele.event("integrity.quarantine.device", device=slot,
                        site=site)
        _tele.gauge("integrity.quarantined", float(len(_QUARANTINED)))


def quarantined() -> frozenset:
    return _QUARANTINED


def strikes() -> Dict[int, int]:
    with _LOCK:
        return dict(_STRIKES)


def healthy_devices(devices: List) -> List:
    """Filter page slots (or objects with an ``id``) through the
    quarantine set, order kept; never down to an empty pool — a fully
    quarantined list still has to serve."""
    q = _QUARANTINED
    if not q:
        return list(devices)
    out = [d for d in devices if getattr(d, "id", d) not in q]
    return out if out else list(devices)


def reset() -> None:
    """Drop all strikes and quarantined slots (tests)."""
    global _QUARANTINED, _EPOCH
    with _LOCK:
        _STRIKES.clear()
        _QUARANTINED = frozenset()
        _EPOCH += 1

