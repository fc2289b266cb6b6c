"""Telemetry exporters: JSONL snapshots, Chrome trace-event JSON, the
merged multi-process trace, and a torch.profiler bracket (the port of
the JAX package's telemetry/export.py).

Formats:

* **JSONL** — one :func:`qrack_tpu_torch.telemetry.snapshot` dict per
  line, appended (a long campaign accumulates a history; consumers take
  the last line).  Armed at process exit by ``QRACK_TPU_TELEMETRY_OUT``.
* **Chrome trace-event JSON** — the ``{"traceEvents": [...]}`` object
  format: spans become ``"ph": "X"`` complete events, discrete telemetry
  events ``"ph": "i"`` instants, and every counter's final value one
  ``"ph": "C"`` sample at the end of the trace.  Loads in Perfetto or
  chrome://tracing.
* **Merged trace** — :func:`merged_chrome_trace` folds N processes'
  trace sources (live snapshots or flight-recorder black boxes, each
  with its own ``epoch_unix_s`` wall anchor) into ONE timeline, one
  track per source, with every span's trace id in its args.
* **torch.profiler** — :func:`profiler_bracket` runs a region under
  ``torch.profiler`` (host and, where there is one, CUDA activity) and
  writes its Chrome trace: the kernels the card ran, by name.  The JAX
  package's bracket is ``jax.profiler``'s (xplane dumps), so this one's
  event is ``telemetry.profiler.dump``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

_US = 1e6
_ATEXIT_ARMED = False
# host seconds left between the profiler's capture window and the first
# and last device work of a bracket: the profiler drops a kernel whose
# converted device timestamps fall outside its window
_PROFILE_EDGE_S = 0.01


def write_jsonl(path: Optional[str] = None) -> str:
    """Append one snapshot line to `path` (default:
    QRACK_TPU_TELEMETRY_OUT).  Returns the path written."""
    from . import snapshot

    if path is None:
        path = os.environ.get("QRACK_TPU_TELEMETRY_OUT", "")
    if not path:
        raise ValueError(
            "no output path: pass one or set QRACK_TPU_TELEMETRY_OUT")
    with open(path, "a") as f:
        f.write(json.dumps(snapshot()) + "\n")
    return path


def _dump() -> None:
    """The registered exit hook: re-reads the enable gate and the out
    path at exit time, and never raises."""
    from . import _ENABLED

    if _ENABLED and os.environ.get("QRACK_TPU_TELEMETRY_OUT"):
        try:
            write_jsonl()
        except Exception:
            pass  # exit hooks must never raise


def arm_atexit() -> None:
    """Register the one-shot exit dump (idempotent; no-op without an
    out path at exit time)."""
    global _ATEXIT_ARMED
    if _ATEXIT_ARMED:
        return
    _ATEXIT_ARMED = True
    import atexit

    atexit.register(_dump)


def chrome_trace() -> dict:
    """Trace-event JSON object for the current telemetry state."""
    from . import _EVENTS, _LOCK, _TRACE, snapshot

    pid = os.getpid()
    evs = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "qrack_tpu_torch"},
    }]
    with _LOCK:
        trace = list(_TRACE)
        events = list(_EVENTS)
    end_us = 0.0
    for t in trace:
        ts = t["ts_s"] * _US
        dur = t["dur_s"] * _US
        end_us = max(end_us, ts + dur)
        evs.append({
            "name": t["name"], "ph": "X", "cat": "span",
            "ts": ts, "dur": dur, "pid": pid, "tid": t["tid"],
            "args": {"depth": t["depth"], "synced": t["synced"]},
        })
    for e in events:
        ts = e["t_s"] * _US
        end_us = max(end_us, ts)
        args = {k: v for k, v in e.items() if k not in ("name", "t_s")}
        evs.append({
            "name": e["name"], "ph": "i", "cat": "event", "s": "p",
            "ts": ts, "pid": pid, "tid": 0, "args": args,
        })
    snap = snapshot(include_events=False)
    for name, value in sorted(snap["counters"].items()):
        evs.append({
            "name": name, "ph": "C", "ts": end_us, "pid": pid, "tid": 0,
            "args": {"value": value},
        })
    # roofline gauges ride as counter tracks too: achieved-vs-peak
    # fractions next to the spans that produced them
    for name, value in sorted(snap["gauges"].items()):
        if name.startswith("roofline."):
            evs.append({
                "name": name, "ph": "C", "ts": end_us, "pid": pid,
                "tid": 0, "args": {"value": value},
            })
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return path


# ---------------------------------------------------------------------------
# merged multi-process trace
# ---------------------------------------------------------------------------

def local_trace_source(name: Optional[str] = None) -> dict:
    """This process's trace rings as a merge source for
    :func:`merged_chrome_trace` (same shape as a flight-recorder black
    box: name/pid/epoch_unix_s/spans/events)."""
    from . import _EPOCH_WALL, _EVENTS, _GAUGES, _LOCK, _TRACE

    pid = os.getpid()
    with _LOCK:
        return {"name": name or f"pid{pid}", "pid": pid,
                "epoch_unix_s": _EPOCH_WALL,
                "spans": list(_TRACE), "events": list(_EVENTS),
                "gauges": dict(_GAUGES)}


def merged_chrome_trace(sources) -> dict:
    """One Perfetto-loadable timeline from N processes' trace sources.

    Each source dict carries ``name`` (track label), ``pid``,
    ``epoch_unix_s`` (the wall clock at that process's telemetry import
    — see telemetry/__init__.py), and ``spans``/``events`` ring dumps.
    Relative timestamps are re-anchored as ``epoch_unix_s + ts_s`` and
    normalized to the earliest instant across the sources, so spans
    from different processes land in true wall-clock order.  Every
    source gets its OWN display pid (sequential) even when OS pids
    collide — one track per process incarnation; span trace ids ride in
    ``args`` so Perfetto's args panel correlates work across tracks.
    """
    evs = []
    anchors = []
    for src in sources:
        epoch = float(src.get("epoch_unix_s") or 0.0)
        for t in src.get("spans") or []:
            anchors.append(epoch + t["ts_s"])
        for e in src.get("events") or []:
            anchors.append(epoch + e["t_s"])
    t0 = min(anchors) if anchors else 0.0
    for disp_pid, src in enumerate(sources, start=1):
        epoch = float(src.get("epoch_unix_s") or 0.0)
        label = src.get("name") or f"pid{src.get('pid')}"
        evs.append({"name": "process_name", "ph": "M", "pid": disp_pid,
                    "tid": 0,
                    "args": {"name": f"{label} (pid {src.get('pid')})"}})
        for t in src.get("spans") or []:
            args = {"depth": t.get("depth"), "synced": t.get("synced")}
            if t.get("trace") is not None:
                args["trace"] = t["trace"]
            evs.append({
                "name": t["name"], "ph": "X", "cat": "span",
                "ts": (epoch + t["ts_s"] - t0) * _US,
                "dur": t["dur_s"] * _US,
                "pid": disp_pid, "tid": t.get("tid", 0), "args": args,
            })
        src_end = 0.0
        for e in src.get("events") or []:
            args = {k: v for k, v in e.items() if k not in ("name", "t_s")}
            evs.append({
                "name": e["name"], "ph": "i", "cat": "event", "s": "p",
                "ts": (epoch + e["t_s"] - t0) * _US,
                "pid": disp_pid, "tid": 0, "args": args,
            })
        for t in src.get("spans") or []:
            src_end = max(src_end, (epoch + t["ts_s"] - t0 + t["dur_s"]))
        for e in src.get("events") or []:
            src_end = max(src_end, (epoch + e["t_s"] - t0))
        # roofline gauges (live snapshots and flight-recorder black
        # boxes both carry them) become per-source Perfetto counter
        # tracks, sampled at that source's last instant
        for gname, gval in sorted((src.get("gauges") or {}).items()):
            if gname.startswith("roofline."):
                evs.append({
                    "name": gname, "ph": "C", "ts": src_end * _US,
                    "pid": disp_pid, "tid": 0, "args": {"value": gval},
                })
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def write_merged_chrome_trace(path: str, sources) -> str:
    with open(path, "w") as f:
        json.dump(merged_chrome_trace(sources), f)
    return path


@contextlib.contextmanager
def profiler_bracket(logdir: Optional[str] = None, name: str = "telemetry"):
    """Run a region under ``torch.profiler`` when telemetry is on and a
    log dir is given (argument or ``QRACK_TPU_TELEMETRY_PROFILE``), and
    write its Chrome trace to ``<logdir>/<name>.<pid>.trace.json``;
    otherwise a pass-through that yields None and touches nothing.
    Yields the trace's path.  CUDA activity (each kernel, by name) is
    traced where a CUDA device exists; there the region is synchronized
    on exit, and _PROFILE_EDGE_S of host time pads the window at both
    ends, so the kernels at its edges stay inside it."""
    from . import _ENABLED, event

    if logdir is None:
        logdir = os.environ.get("QRACK_TPU_TELEMETRY_PROFILE", "")
    if not (_ENABLED and logdir):
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{name}.{os.getpid()}.trace.json")
    cuda = torch.cuda.is_available()
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            time.sleep(_PROFILE_EDGE_S)
        yield path
        if cuda:
            torch.cuda.synchronize()
            time.sleep(_PROFILE_EDGE_S)
    prof.export_chrome_trace(path)
    event("telemetry.profiler.dump", path=path, region=name)
