"""Crash flight recorder: a bounded ring of recent telemetry, persisted
atomically so a kill -9 leaves a readable black box (the port of the
JAX package's telemetry/blackbox.py).

A process owns one :class:`FlightRecorder` pointed at a file of its own
(one per process incarnation: a restarted process must not overwrite
the box of the one that died).  :meth:`FlightRecorder.flush` snapshots
the last-N events and spans plus the counter/gauge totals under the
telemetry lock and lands them with a temporary file, fsync and rename,
so a reader never sees a torn file and the newest complete flush
survives any crash.

The file doubles as a merge source for
:func:`~qrack_tpu_torch.telemetry.export.merged_chrome_trace`: it carries
the process's ``epoch_unix_s`` wall anchor beside the span ring.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

DEFAULT_LAST_N = 256


class FlightRecorder:
    """Atomically-persisted ring of this process's recent telemetry."""

    def __init__(self, path: str, name: Optional[str] = None,
                 last_n: int = DEFAULT_LAST_N):
        self.path = path
        self.name = name or os.path.basename(path)
        self.last_n = int(last_n)
        self.flushes = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def flush(self) -> dict:
        """Write the current black box; returns the dict written.
        No-op (returns {}) while telemetry is disabled."""
        from . import _ENABLED, _EPOCH_WALL, _EVENTS, _LOCK, _TRACE, snapshot

        if not _ENABLED:
            return {}
        with _LOCK:
            events = list(_EVENTS)[-self.last_n:]
            spans = list(_TRACE)[-self.last_n:]
        snap = snapshot(include_events=False)
        self.flushes += 1
        box = {
            "name": self.name,
            "pid": os.getpid(),
            "epoch_unix_s": _EPOCH_WALL,
            "t_wall": time.time(),
            "flush_seq": self.flushes,
            "events": events,
            "spans": spans,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(box, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        return box


def read_blackbox(path: str) -> Optional[dict]:
    """Load a black box; None when absent or unreadable (a crash between
    the temporary write and the rename leaves the previous complete
    flush, but an empty or garbled path must not raise)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


__all__ = ["FlightRecorder", "read_blackbox", "DEFAULT_LAST_N"]
