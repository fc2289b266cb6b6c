"""Shared roofline formula, device peak table, and the perf-regression
sentinel (a copy of the JAX package's telemetry/sentinel.py with the
device rows replaced by NVIDIA cards).

This module is deliberately **stdlib-only**: no torch, no numpy, and no
package-relative imports, so a script can load it by file path with
``importlib`` without initialising a device.  Everything here is the
single source of truth:

- ``implied_gbps``      — the one implied-bandwidth formula
  (bytes / wall / 1e9).
- ``PEAK_GBPS`` / ``peak_gbps`` — the one HBM peak table per device
  class (the H100 SXM's 3350 GB/s by default, and for cpu or unknown
  kinds), env-overridable via ``QRACK_TPU_PEAK_GBPS``.
- ``plane_pass_bytes``  — bytes moved by one full sweep over the two ket
  planes (read + write).
- Trajectory loading + verdicts — parse evidence files the caller names
  (JSONL lines, or a JSON document whose ``"tail"`` string holds JSONL
  lines) and stamp every fresh line better/same/worse/new within a noise
  band (``QRACK_SENTINEL_NOISE_BAND``, default 10%).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

# HBM peak bandwidth per device class, GB/s, from NVIDIA's data sheets.
# Matched by substring against the lowercased device name that
# torch.cuda.get_device_name gives (e.g. "NVIDIA H100 80GB HBM3"), first
# match wins, so the specific rows come first.  The H100 SXM figure
# (3350) is the one every bound of this package is computed with; it is
# also the fallback for cpu/unknown kinds, so a CPU line quotes its
# fraction of the card's roofline.
DEFAULT_PEAK_GBPS = 3350.0
PEAK_GBPS = (
    ("h100 80gb hbm3", 3350.0),   # H100 SXM5
    ("h100 pcie", 2000.0),
    ("h100 nvl", 3900.0),
    ("h200", 4800.0),
    ("h100", 3350.0),
    ("a100-sxm4-80gb", 2039.0),
    ("a100 80gb pcie", 1935.0),
    ("a100", 1555.0),             # the 40 GB parts
)

# Relative noise band for sentinel verdicts: a fresh wall within +/- band of
# the best committed wall is "same".
DEFAULT_NOISE_BAND = 0.10

VERDICTS = ("better", "same", "worse", "new", "replay")


def peak_gbps(kind: Optional[str]) -> float:
    """Peak HBM GB/s for a device-kind string; env override wins."""
    env = os.environ.get("QRACK_TPU_PEAK_GBPS", "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    low = (kind or "").lower()
    for sub, peak in PEAK_GBPS:
        if sub in low:
            return peak
    return DEFAULT_PEAK_GBPS


def noise_band() -> float:
    env = os.environ.get("QRACK_SENTINEL_NOISE_BAND", "")
    if env:
        try:
            return max(0.0, float(env))
        except ValueError:
            pass
    return DEFAULT_NOISE_BAND


def implied_gbps(nbytes: float, wall_s: float) -> float:
    """The one implied-bandwidth formula: bytes moved / wall seconds / 1e9."""
    return float(nbytes) / max(float(wall_s), 1e-12) / 1e9


def plane_pass_bytes(width: int, esize: int = 4) -> int:
    """HBM bytes for one full sweep over the ket: 2 planes * 2^width amps
    * esize bytes, read + write."""
    return 2 * (1 << int(width)) * int(esize) * 2


def is_clamped(line: dict, peak: Optional[float] = None) -> bool:
    """True when a line's implied bandwidth exceeds the device-class peak:
    a wall that stopped before the work finished."""
    gbps = line.get("implied_hbm_gbps")
    if gbps is None:
        gbps = line.get("implied_codes_gbps")
    if gbps is None:
        return False
    if peak is None:
        dev = line.get("device_class") or {}
        peak = dev.get("peak_gbps") or peak_gbps(dev.get("kind"))
    try:
        return float(gbps) > float(peak)
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# Committed-trajectory loading and verdicts
# ---------------------------------------------------------------------------

def line_key(line: dict) -> Optional[str]:
    """Stable comparison key for an evidence line (replay suffix folded in)."""
    metric = line.get("metric")
    if metric:
        key = str(metric)
        if key.endswith("_committed_evidence"):
            key = key[: -len("_committed_evidence")]
        return key
    gate = line.get("gate")
    if gate:
        key = "gate_%s_w%s" % (gate, line.get("width", "?"))
        bits = line.get("bits")
        if bits:
            key += "_b%s" % bits
        return key
    return None


def line_value(line: dict) -> Optional[float]:
    """Lower-is-better wall seconds for an evidence line, or None."""
    for field in ("value", "wall_s", "avg_wall_s", "avg"):
        v = line.get(field)
        if v is not None:
            try:
                v = float(v)
            except (TypeError, ValueError):
                return None
            return v if v > 0 else None
    return None


def _iter_jsonl(text: str):
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw.startswith("{"):
            continue
        try:
            d = json.loads(raw)
        except ValueError:
            continue
        if isinstance(d, dict):
            yield d


def load_trajectory(paths: Sequence[str]) -> Dict[str, List[float]]:
    """Per-key wall history from the evidence files `paths` names: each
    is read as JSONL lines, or, when it is one JSON document, from the
    JSONL lines of its ``"tail"`` string.  Nothing is read that the
    caller does not name.  Suspect or clamped lines never enter."""
    hist: Dict[str, List[float]] = {}

    def add(d: dict) -> None:
        if d.get("suspect_timing") or d.get("roofline_clamped"):
            return
        key, val = line_key(d), line_value(d)
        if key and val is not None:
            hist.setdefault(key, []).append(val)

    for path in paths:
        try:
            with open(path) as fh:
                text = fh.read()
        except OSError:
            continue
        try:
            doc = json.loads(text)
        except ValueError:
            doc = None
        if isinstance(doc, dict) and isinstance(doc.get("tail"), str):
            text = doc["tail"]
        for d in _iter_jsonl(text):
            add(d)
    return hist


def verdict(key: Optional[str], value: Optional[float],
            traj: Dict[str, List[float]],
            band: Optional[float] = None) -> str:
    """Compare a fresh wall against the best committed wall for its key."""
    if key is None or value is None:
        return "new"
    prior = traj.get(key)
    if not prior:
        return "new"
    if band is None:
        band = noise_band()
    best = min(prior)
    if value <= best * (1.0 - band):
        return "better"
    if value >= best * (1.0 + band):
        return "worse"
    return "same"


def stamp(line: dict, traj: Dict[str, List[float]],
          band: Optional[float] = None) -> str:
    """Stamp sentinel verdict (+ reference wall) into a line, in place.
    Replayed `_committed_evidence` lines get the "replay" verdict so they are
    distinguishable from fresh on-chip measurements at a glance."""
    metric = str(line.get("metric") or "")
    if metric.endswith("_committed_evidence") or line.get("replayed"):
        line["sentinel"] = "replay"
        line["fresh"] = False
        return "replay"
    key, val = line_key(line), line_value(line)
    v = verdict(key, val, traj, band)
    line["sentinel"] = v
    line["fresh"] = True
    prior = traj.get(key or "")
    if prior:
        line["sentinel_ref_wall_s"] = min(prior)
        line["sentinel_band"] = band if band is not None else noise_band()
    return v


def stamp_evidence_line(line: dict, traj: Dict[str, List[float]],
                        stage: Optional[str] = None,
                        default_device: Optional[dict] = None) -> dict:
    """Full campaign-evidence stamping: timestamp, stage, sentinel verdict,
    and a device-class fingerprint (kept if the line already carries one)."""
    line.setdefault("ts", time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
    if stage:
        line.setdefault("stage", stage)
    stamp(line, traj)
    if "device_class" not in line:
        dev = dict(default_device or {})
        if not dev:
            kind = os.environ.get("QRACK_TPU_DEVICE_KIND", "") or "unknown"
            dev = {"kind": kind, "peak_gbps": peak_gbps(kind)}
        line["device_class"] = dev
    return line
