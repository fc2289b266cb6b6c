"""Worker liveness: atomic heartbeat files + pid checks (the port of
the JAX package's fleet/heartbeat.py; host only).

A worker beats by atomically replacing ``<name>.hb`` with a small JSON
record every ``interval_s``.  The supervisor reads beats instead of
polling RPC because a worker wedged inside a dispatch still has a
healthy socket accept loop — the beat comes from a dedicated thread
whose ONLY job is proving the process is scheduling threads, and the
record carries enough state (ready flag, session count, time-to-first
-result) for the monitor to make placement decisions without an RPC.

Two liveness signals compose:

* **pid death** — waitpid via the supervisor's Popen handle: instant,
  authoritative, catches kill -9.
* **missed beats** — ``age > interval_s * deadline_beats``: catches
  the live-but-wedged process a pid check can't.

The writer is a guarded fault site: ``fleet.heartbeat:hang:after_n``
makes :meth:`HeartbeatWriter.beat` skip the write while the worker
keeps serving — the deterministic trigger for testing the missed-beat
path without wedging anything for real.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

DEFAULT_INTERVAL_S = 0.5
DEFAULT_DEADLINE_BEATS = 6.0


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def write_heartbeat(path: str, record: dict) -> None:
    """Atomic beat: temp file + fsync + rename, same discipline as the
    checkpoint container — a reader never sees a torn record."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".hb-", suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(record, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_heartbeat(path: str) -> Optional[dict]:
    """The last complete beat, or None (missing file, or a torn legacy
    record — both read as 'no beat', which ages into 'dead')."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def beat_age_s(path: str, now: Optional[float] = None) -> Optional[float]:
    rec = read_heartbeat(path)
    if rec is None or "t" not in rec:
        return None
    return (time.time() if now is None else now) - float(rec["t"])


class HeartbeatWriter:
    """Background beat thread for one worker process.

    `info_fn` (optional) returns extra JSON-able fields merged into
    every record — the worker wires session count / ready / ttfr
    through it.  The thread never raises: a beat that fails to write
    (disk full) is indistinguishable from a hang upstream, which is
    exactly the semantics the supervisor wants."""

    def __init__(self, path: str, interval_s: float = DEFAULT_INTERVAL_S,
                 info_fn: Optional[Callable[[], dict]] = None):
        self.path = str(path)
        self.interval_s = float(interval_s)
        self.info_fn = info_fn
        self.seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-heartbeat")

    def start(self) -> "HeartbeatWriter":
        self.beat()  # first beat synchronous: exists before start returns
        self._thread.start()
        return self

    def beat(self) -> bool:
        """Write one beat; False when skipped (injected hang) or the
        write failed."""
        try:
            from ..resilience import faults as _faults

            directive = _faults.check("fleet.heartbeat")
        except Exception:  # noqa: BLE001 — raise-type kinds are
            directive = None  # meaningless at this site; don't beat-fail
        if directive == "hang":
            return False  # the injected wedge: serve on, beat off
        self.seq += 1
        rec = {"pid": os.getpid(), "t": time.time(), "seq": self.seq,
               "interval_s": self.interval_s}
        if self.info_fn is not None:
            try:
                rec.update(self.info_fn())
            except Exception:  # noqa: BLE001 — a beat must never raise
                pass
        try:
            write_heartbeat(self.path, rec)
        except OSError:
            return False
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self, final_beat: bool = True) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.interval_s * 4)
        if final_beat:
            self.beat()


__all__ = ["HeartbeatWriter", "write_heartbeat", "read_heartbeat",
           "beat_age_s", "pid_alive", "DEFAULT_INTERVAL_S",
           "DEFAULT_DEADLINE_BEATS"]
