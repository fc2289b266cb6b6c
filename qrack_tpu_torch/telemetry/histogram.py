"""Bounded log-bucket histogram: the merge-able distribution type
behind :func:`qrack_tpu_torch.telemetry.observe` (a copy of the JAX
package's telemetry/histogram.py, stdlib only, so a histogram written by
one package merges into the other's).

Buckets are geometric with ``SUBBUCKETS`` sub-buckets per octave
(ratio ``2**(1/8) ~ 1.09``), so any reported percentile is within
``2**(1/16) - 1 ~ 4.4%`` of the true sample — comfortably inside the
10% SLO-accuracy bar in docs/OBSERVABILITY.md — while a histogram
spanning a nanosecond to ~34 years of latency costs at most
``IDX_MAX - IDX_MIN + 1`` integer cells.  The bucket array is sparse
(dict) and JSON-safe via :meth:`to_dict`, which is what rides in
heartbeat records and fleet JSONL; :meth:`merge` adds another
histogram (or its dict form) cell-wise, which is exactly how the
supervisor folds N worker processes into one fleet distribution.

Exact ``min``/``max``/``sum``/``count`` are carried alongside the
buckets, so merged extremes stay exact and every percentile is clamped
into ``[min, max]``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

SUBBUCKETS = 8                      # sub-buckets per octave (2x range)
_INV_LN2_SUB = SUBBUCKETS / math.log(2.0)
IDX_MIN = -30 * SUBBUCKETS          # ~1e-9 s: clamp, don't grow, below
IDX_MAX = 30 * SUBBUCKETS           # ~1e9 s: clamp, don't grow, above
_TINY = 2.0 ** -30


def bucket_index(value: float) -> int:
    """Bucket index for a positive value (non-positive values clamp to
    the lowest bucket — durations are never negative in practice)."""
    if value <= _TINY:
        return IDX_MIN
    i = math.floor(math.log(value) * _INV_LN2_SUB)
    if i < IDX_MIN:
        return IDX_MIN
    if i > IDX_MAX:
        return IDX_MAX
    return i


def bucket_mid(index: int) -> float:
    """Geometric midpoint of a bucket — the value a percentile reports."""
    return 2.0 ** ((index + 0.5) / SUBBUCKETS)


class Histogram:
    """Mergeable log-bucket histogram of non-negative samples."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}

    # -- recording -----------------------------------------------------

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        i = bucket_index(value)
        self.buckets[i] = self.buckets.get(i, 0) + 1

    @classmethod
    def of(cls, values: Iterable[float]) -> "Histogram":
        h = cls()
        for v in values:
            h.record(v)
        return h

    # -- accessors -----------------------------------------------------

    @property
    def mean(self) -> Optional[float]:
        return (self.sum / self.count) if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile (`q` in [0, 100]) from the bucket
        midpoints, clamped into the exact observed [min, max]."""
        if not self.count:
            return None
        target = max(1, math.ceil((q / 100.0) * self.count))
        cum = 0
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum >= target:
                return min(max(bucket_mid(i), self.min), self.max)
        return self.max  # unreachable unless counts drifted

    def percentiles(self, qs=(50, 95, 99)) -> Dict[str, Optional[float]]:
        return {f"p{q:g}": self.percentile(q) for q in qs}

    # -- merge + codec -------------------------------------------------

    def merge(self, other) -> "Histogram":
        """Fold another histogram (or its :meth:`to_dict` form) into
        this one, cell-wise; returns self."""
        if isinstance(other, dict):
            other = Histogram.from_dict(other)
        if not other.count:
            return self
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        return self

    def to_dict(self) -> dict:
        """JSON-safe form (bucket keys become strings)."""
        out = {"count": self.count, "sum": self.sum,
               "buckets": {str(i): c for i, c in self.buckets.items()}}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls()
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.min = float(d.get("min", math.inf))
        h.max = float(d.get("max", -math.inf))
        h.buckets = {int(i): int(c)
                     for i, c in (d.get("buckets") or {}).items()}
        return h

    @classmethod
    def merge_all(cls, dicts: Iterable) -> "Histogram":
        h = cls()
        for d in dicts:
            h.merge(d)
        return h

    def __repr__(self):
        if not self.count:
            return "Histogram(empty)"
        return (f"Histogram(n={self.count}, min={self.min:.3g}, "
                f"p50={self.percentile(50):.3g}, "
                f"p99={self.percentile(99):.3g}, max={self.max:.3g})")


__all__ = ["Histogram", "SUBBUCKETS", "IDX_MIN", "IDX_MAX",
           "bucket_index", "bucket_mid"]
