"""Per-dispatch roofline ledger: planned HBM bytes against synced walls
(the port of the JAX package's telemetry/roofline.py).

Every dispatch site (``cuda.fuse.flush``, ``pager.exchange``,
``tq.sweep``) reports the bytes it *planned* to move through
:func:`note_bytes`; a caller that also owns a synced wall (a span with
``sync=``, or CUDA events) calls :func:`record`, which derives the
implied HBM bandwidth through the one shared formula in
:mod:`qrack_tpu_torch.telemetry.sentinel` and publishes

- ``roofline.<site>.implied_hbm_gbps``   histogram (+ p50/p95/p99 gauges)
- ``roofline.<site>.peak_frac``          achieved-vs-peak-fraction gauge
  (with per-width / per-stack facets when the caller supplies them)
- ``roofline.<site>.planned_bytes`` / ``.dispatches`` counters

The honesty clamp: a sample whose implied bandwidth exceeds the device
class's peak timed less than the work (a wall that stopped before the
device finished).  Such samples bump ``roofline.honesty.clamped``
(counter + event) and ``roofline.<site>.clamped``, and are **excluded**
from the histogram and gauges.

The device-class fingerprint (kind, HBM bytes, peak GB/s) is read from
torch only once CUDA is initialised — probing never initialises a
device — and can be persisted as ``device_class.json`` in a directory
the caller names, and loaded back from ``QRACK_SERVE_CHECKPOINT_DIR``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Optional

from .. import telemetry as _tele
from .sentinel import implied_gbps, peak_gbps, plane_pass_bytes  # noqa: F401

FINGERPRINT_FILE = "device_class.json"

_FP: Optional[dict] = None


def _probe_backend() -> dict:
    """Device identity from an already-initialised CUDA runtime: {}
    unless torch is imported and ``torch.cuda.is_initialized()``, so the
    ledger never starts a device context of its own."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    try:
        if not torch.cuda.is_initialized():
            return {}
        i = torch.cuda.current_device()
        return {"platform": "cuda",
                "kind": torch.cuda.get_device_name(i),
                "hbm_bytes": int(torch.cuda.get_device_properties(i)
                                 .total_memory),
                "n_devices": torch.cuda.device_count()}
    except RuntimeError:
        return {}


def device_class(refresh: bool = False,
                 platform_hint: Optional[str] = None) -> dict:
    """The device-class fingerprint: kind, platform, HBM bytes, peak GB/s.

    Resolution order: ``QRACK_TPU_DEVICE_KIND`` env override, the live
    probe (side-effect free), the fingerprint persisted in
    ``QRACK_SERVE_CHECKPOINT_DIR``, then the caller's platform hint."""
    global _FP
    if _FP is not None and not refresh:
        if _FP.get("kind") not in ("", "unknown") or platform_hint is None:
            return dict(_FP)
    fp = {"kind": "unknown", "platform": "", "hbm_bytes": None}
    env_kind = os.environ.get("QRACK_TPU_DEVICE_KIND", "")
    probed = _probe_backend()
    if probed:
        fp.update(probed)
    else:
        loaded = load_fingerprint(os.environ.get(
            "QRACK_SERVE_CHECKPOINT_DIR", ""))
        if loaded:
            fp.update({k: loaded[k] for k in
                       ("kind", "platform", "hbm_bytes", "n_devices")
                       if k in loaded})
        elif platform_hint:
            fp["kind"] = fp["platform"] = str(platform_hint)
    if env_kind:
        fp["kind"] = env_kind
    fp["peak_gbps"] = peak_gbps(fp["kind"])
    _FP = dict(fp)
    return fp


def _reset_fingerprint_cache() -> None:
    """Drop the cached fingerprint (tests, and a process that changes
    its device)."""
    global _FP
    _FP = None


def persist_fingerprint(checkpoint_dir: str) -> Optional[str]:
    """Write the fingerprint as <dir>/device_class.json (atomically).

    A persisted known kind is never overwritten by an unknown one.
    Best-effort: returns None when the directory cannot be written."""
    try:
        fp = device_class()
        path = os.path.join(checkpoint_dir, FINGERPRINT_FILE)
        if fp.get("kind") in ("", "unknown"):
            prior = load_fingerprint(checkpoint_dir)
            if prior and prior.get("kind") not in ("", "unknown", None):
                return path
        os.makedirs(checkpoint_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=checkpoint_dir, suffix=".tmp")
        with os.fdopen(fd, "w") as fh:
            json.dump(fp, fh, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def load_fingerprint(checkpoint_dir: str) -> Optional[dict]:
    if not checkpoint_dir:
        return None
    try:
        with open(os.path.join(checkpoint_dir, FINGERPRINT_FILE)) as fh:
            fp = json.load(fh)
        return fp if isinstance(fp, dict) else None
    except (OSError, ValueError):
        return None


def note_bytes(site: str, nbytes: float) -> None:
    """Ledger entry for a dispatch whose wall is timed elsewhere (or not at
    all): planned HBM bytes + dispatch count per site."""
    if not _tele._ENABLED:
        return
    _tele.inc(f"roofline.{site}.dispatches")
    _tele.inc(f"roofline.{site}.planned_bytes", float(nbytes))


def record(site: str, nbytes: float, wall_s: float,
           width: Optional[int] = None, stack: Optional[str] = None,
           platform: Optional[str] = None) -> dict:
    """Full roofline sample for a synced dispatch: planned bytes + wall →
    implied GB/s, peak fraction, and the honesty clamp.

    Returns the sample dict (implied_hbm_gbps, hbm_peak_gbps,
    hbm_roofline_frac, clamped, device_class); telemetry publication is
    skipped when disabled, but the sample is always computed."""
    gbps = implied_gbps(nbytes, wall_s)
    dev = device_class(platform_hint=platform)
    peak = dev["peak_gbps"]
    frac = gbps / peak if peak else 0.0
    clamped = gbps > peak
    sample = {
        "implied_hbm_gbps": round(gbps, 2),
        "hbm_peak_gbps": peak,
        "hbm_roofline_frac": round(frac, 4),
        "clamped": clamped,
        "device_class": dev,
    }
    if not _tele._ENABLED:
        return sample
    note_bytes(site, nbytes)
    if clamped:
        _tele.inc(f"roofline.{site}.clamped")
        _tele.event("roofline.honesty.clamped", site=site,
                    gbps=round(gbps, 1), peak=peak, width=width)
        return sample
    _tele.observe(f"roofline.{site}.implied_hbm_gbps", gbps)
    _tele.gauge(f"roofline.{site}.peak_frac", round(frac, 4))
    if width is not None:
        facet = f"{stack}.w{width}" if stack else f"w{width}"
        _tele.gauge(f"roofline.{site}.{facet}.peak_frac", round(frac, 4))
    return sample


def note_verdict(v: str) -> None:
    """Count a sentinel verdict (better/same/worse/new/replay)."""
    if _tele._ENABLED and v:
        _tele.inc(f"roofline.sentinel.{v}")
