"""Process-wide telemetry: counters, synced spans, and exporters (the
port of the JAX package's telemetry/__init__.py).

Everything is gated on ``QRACK_TPU_TELEMETRY=1`` (or :func:`enable`):
when disabled, every entry point returns after one module-global boolean
read and records NOTHING — hot gate paths guard with
``if _tele._ENABLED:`` so even the counter-name f-string is never built.
The gate is the same variable as the JAX package's, so the environment
turns both packages' telemetry on at once.

Three surfaces:

* **counters** — :func:`inc` monotonic named counters, :func:`gauge`
  last-write-wins values, :func:`event` annotated events (a bounded ring
  that drops the oldest), and :func:`observe`, which feeds a duration into
  the span aggregate and a merge-able log-bucket
  :class:`~qrack_tpu_torch.telemetry.histogram.Histogram` (so
  :func:`percentile` answers p50/p95/p99 per process and, after
  :func:`merge_snapshots`, across processes).
* **spans** — ``with telemetry.span("qft.w30", sync=planes):`` nestable
  wall-clock timers.  With ``sync=`` (a tensor, or a sequence of them, as
  a pager's pages) the exit calls ``torch.cuda.synchronize`` on each CUDA
  device the tensors live on before the clock stops (utils/timing.py
  ``device_sync``); a CPU tensor needs no sync.  Nothing is subtracted:
  the synchronise itself, some microseconds on an empty queue, stays in
  the wall.  A span without ``sync=`` is a host wall only and is marked
  ``synced: False`` in the trace.  Spans and events carry the thread's
  trace id (:func:`set_trace` / :func:`current_trace`); timestamps are
  relative to the import epoch, whose wall-clock anchor
  (``epoch_unix_s``) rides in every snapshot so exporters can merge
  processes onto one timeline.
* **export** — :func:`snapshot` (plain dict), :func:`write_jsonl`
  (armed at exit via ``QRACK_TPU_TELEMETRY_OUT=path``),
  :func:`chrome_trace` (Perfetto-loadable trace-event JSON), the merged
  multi-process trace, the flight recorder (:class:`FlightRecorder`) and
  :func:`profiler_bracket` (a ``torch.profiler`` trace of a region).

The roofline ledger (planned bytes, device class, the implied-bandwidth
honesty clamp) and the stdlib-only peak table live in
:mod:`~qrack_tpu_torch.telemetry.roofline` and
:mod:`~qrack_tpu_torch.telemetry.sentinel`; import them explicitly.

**The namespace** is the JAX package's (docs/OBSERVABILITY.md), name for
name, with ONE rename: the dense engine's label, ``tpu`` there, is
``cuda`` here, wherever a name carries it — ``gate.cuda.*``,
``fuse.cuda.*``, the roofline site ``cuda.fuse.flush``,
``factory.create.cuda``, ``engine.cuda.f64_escalation`` and QHybrid's
mode in ``hybrid.switch.*``/``hybrid.grow.*``.  The hooks of the port:

* ``gate.<engine>.{diag,2x2,permute,phase_mask,swap,4x4}.w<n>`` — logical
  gates requested (engines/qengine.py);
* ``fuse.<engine>.{queued,flush.<reason>,gates,sweeps_saved,dropped.*}``,
  ``fuse.<engine>.queue_depth``/``window_len``, ``fuse.kernel.*``,
  ``fuse.xla.*`` (the window chain, the JAX package's XLA chain),
  ``fuse.kernel.fallback.<reason>`` (ops/fusion.py);
* ``exchange.pager.<pass>``/``.bytes`` (ops/sharded.py, beside
  ``sharded.EXCHANGES``), ``exchange.pager.collective_bytes``,
  ``exchange.pager.host_fetch[_bytes]``, ``remap.pager.*``
  (parallel/pager.py); ``exchange.turboquant_pager.*``;
* ``tq.sweeps``, ``tq.resident.*``, ``fuse.tq.*`` (engines/turboquant.py);
* ``qunit.*``, ``qunitmulti.redistribute``, ``stabilizer.to_dense``,
  ``qbdt.to_dense``, ``hybrid.switch.*``, ``hybrid.grow.*``,
  ``noise.traj.*``, ``factory.create.*``, ``checkpoint.save``/``restore``;
* ``serve.*`` (jobs, queue, batches, overlap, prefix cache, sessions,
  latency histograms by tenant and stack), ``integrity.canary.*`` and
  ``checkpoint.warmstart.*`` — the serving plane (serve/);
* ``compile.kernel.<library>.{hit,miss}`` — a kernel library found built
  in the build directory or compiled by nvcc (ops/cuda_build.py);
* ``compile.<name>.{hit,miss,eviction}`` — :class:`ProgramCache`, whose
  one user is the serving batcher (``compile.serve_batch.*``: a cached
  fold program is the lowered ops, the packed operands and the window
  fn, serve/batcher.py).  Torch traces nothing, so the JAX package's
  per-jit counters (``instrument_jit``) have no counterpart;
* ``roofline.<site>.*`` — roofline.py.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional

from .histogram import Histogram

__all__ = [
    "enabled", "enable", "disable", "inc", "event", "span", "record_span",
    "observe", "gauge", "percentile", "set_trace", "current_trace",
    "snapshot", "merge_snapshots", "reset", "write_jsonl", "chrome_trace",
    "write_chrome_trace", "merged_chrome_trace",
    "write_merged_chrome_trace", "local_trace_source", "profiler_bracket",
    "Histogram", "FlightRecorder", "read_blackbox", "ProgramCache",
]

# single hot-path gate: instrumentation sites read this module attribute
# directly (`if _tele._ENABLED:`) so the disabled cost is one attribute
# test, with no call and no string formatting
_ENABLED: bool = os.environ.get("QRACK_TPU_TELEMETRY", "") not in ("", "0")

_LOCK = threading.Lock()
# trace timestamps are relative to import; the wall clock sampled at the
# same instant anchors them to an absolute timeline (epoch_unix_s in
# every snapshot / black box) so N processes' traces can be merged
_EPOCH = time.perf_counter()
_EPOCH_WALL = time.time()

_TRACE_CAP = int(os.environ.get("QRACK_TPU_TELEMETRY_TRACE_CAP", "65536"))
_EVENT_CAP = int(os.environ.get("QRACK_TPU_TELEMETRY_EVENT_CAP", "4096"))
_HIST_CAP = int(os.environ.get("QRACK_TPU_TELEMETRY_HIST_CAP", "1024"))

_COUNTERS: Dict[str, float] = {}
_GAUGES: Dict[str, float] = {}        # name -> last observed value
_SPANS: Dict[str, List[float]] = {}   # name -> [count, total_s, min_s, max_s]
_HISTS: Dict[str, Histogram] = {}     # name -> log-bucket distribution
# both rings drop OLDEST on overflow (drops counted): a postmortem needs
# what the process was doing last, not what it did at start
_TRACE: Deque[dict] = deque(maxlen=_TRACE_CAP)  # chrome-trace "X" events
_EVENTS: Deque[dict] = deque(maxlen=_EVENT_CAP)  # discrete annotated events

_TLS = threading.local()  # per-thread span stack (nesting depth) + trace id


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    """Turn telemetry on at runtime (the equivalent of the env gate).
    Arms the exit JSONL dump if QRACK_TPU_TELEMETRY_OUT is set."""
    global _ENABLED
    _ENABLED = True
    from . import export

    export.arm_atexit()


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop all recorded data (counters, spans, hists, traces, events).
    The rings are rebuilt from the CURRENT cap globals, so a caller may
    shrink ``_EVENT_CAP``/``_TRACE_CAP`` and reset to apply them."""
    global _TRACE, _EVENTS
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _SPANS.clear()
        _HISTS.clear()
        _TRACE = deque(maxlen=_TRACE_CAP)
        _EVENTS = deque(maxlen=_EVENT_CAP)


# ---------------------------------------------------------------------------
# counters + events
# ---------------------------------------------------------------------------

def inc(name: str, n: float = 1) -> None:
    """Add `n` to the named monotonic counter (no-op when disabled)."""
    if not _ENABLED:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Record the latest value of a named gauge (last write wins)."""
    if not _ENABLED:
        return
    with _LOCK:
        _GAUGES[name] = float(value)


def _fold(name: str, seconds: float) -> None:
    """Add one duration to the named span aggregate (caller holds the
    lock)."""
    agg = _SPANS.get(name)
    if agg is None:
        _SPANS[name] = [1, seconds, seconds, seconds]
    else:
        agg[0] += 1
        agg[1] += seconds
        agg[2] = min(agg[2], seconds)
        agg[3] = max(agg[3], seconds)


def observe(name: str, seconds: float) -> None:
    """Feed one measured duration into the named span aggregate AND the
    named log-bucket histogram, for durations measured outside a span.
    The name space of histograms is bounded
    (``QRACK_TPU_TELEMETRY_HIST_CAP``): names past it keep their span
    aggregate but no distribution (counted in
    ``telemetry.hists.dropped``)."""
    if not _ENABLED:
        return
    with _LOCK:
        _fold(name, seconds)
        h = _HISTS.get(name)
        if h is None:
            if len(_HISTS) >= _HIST_CAP:
                _COUNTERS["telemetry.hists.dropped"] = \
                    _COUNTERS.get("telemetry.hists.dropped", 0) + 1
                return
            h = _HISTS[name] = Histogram()
        h.record(seconds)


def percentile(name: str, q: float) -> Optional[float]:
    """p`q` of the named observed distribution (None when unrecorded)."""
    with _LOCK:
        h = _HISTS.get(name)
        return h.percentile(q) if h is not None else None


def event(name: str, **fields) -> None:
    """Record a discrete annotated event AND bump its counter.  The ring
    holds the most recent QRACK_TPU_TELEMETRY_EVENT_CAP events (the
    oldest drop first, counted in ``telemetry.events.dropped``).  The
    thread's trace id, if any, is attached."""
    if not _ENABLED:
        return
    tid = getattr(_TLS, "trace", None)
    if tid is not None and "trace" not in fields:
        fields["trace"] = tid
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + 1
        if len(_EVENTS) == _EVENTS.maxlen:
            _COUNTERS["telemetry.events.dropped"] = \
                _COUNTERS.get("telemetry.events.dropped", 0) + 1
        _EVENTS.append({"name": name,
                        "t_s": time.perf_counter() - _EPOCH, **fields})


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------

def set_trace(trace_id: Optional[str]) -> Optional[str]:
    """Set (or clear, with None) the calling thread's trace id; returns
    the previous value so callers can restore it.  Spans and events
    recorded while it is set carry ``trace: <id>``."""
    prev = getattr(_TLS, "trace", None)
    _TLS.trace = trace_id
    return prev


def current_trace() -> Optional[str]:
    return getattr(_TLS, "trace", None)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _append_trace(entry: dict, wall: float) -> None:
    with _LOCK:
        _fold(entry["name"], wall)
        if len(_TRACE) == _TRACE.maxlen:
            _COUNTERS["telemetry.trace.dropped"] = \
                _COUNTERS.get("telemetry.trace.dropped", 0) + 1
        _TRACE.append(entry)


class _Span:
    __slots__ = ("name", "sync", "t0", "depth", "trace")

    def __init__(self, name: str, sync=None, trace=None):
        self.name = name
        self.sync = sync
        self.trace = trace

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        self.depth = len(stack)
        stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            # the clock stops after the queued work on the tensors'
            # devices has finished, never before
            from ..utils.timing import device_sync

            device_sync(self.sync)
        wall = time.perf_counter() - self.t0
        _TLS.stack.pop()
        trace = self.trace if self.trace is not None \
            else getattr(_TLS, "trace", None)
        entry = {
            "name": self.name,
            "ts_s": self.t0 - _EPOCH,
            "dur_s": wall,
            "tid": threading.get_ident(),
            "depth": self.depth,
            "synced": self.sync is not None,
        }
        if trace is not None:
            entry["trace"] = trace
        _append_trace(entry, wall)
        return False


def span(name: str, sync=None, trace=None):
    """Nestable wall-clock timer.  `sync` takes the tensor (e.g. the
    (2, 2^n) planes) or tensors whose devices the span must drain before
    its clock stops — without it the span is a host wall only.  `trace`
    pins a trace id on the recorded span (default: the thread's
    :func:`current_trace`)."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, sync, trace)


def record_span(name: str, start_s: float, dur_s: float,
                trace=None) -> None:
    """Append an already-measured interval to the trace ring and span
    aggregates, for callers that own their stopwatch.  `start_s` is a
    ``time.perf_counter()`` reading from THIS process."""
    if not _ENABLED:
        return
    if trace is None:
        trace = getattr(_TLS, "trace", None)
    entry = {
        "name": name,
        "ts_s": start_s - _EPOCH,
        "dur_s": dur_s,
        "tid": threading.get_ident(),
        "depth": 0,
        "synced": False,
    }
    if trace is not None:
        entry["trace"] = trace
    _append_trace(entry, dur_s)


# ---------------------------------------------------------------------------
# program cache
# ---------------------------------------------------------------------------

class ProgramCache:
    """Bounded LRU of built programs with hit/miss/eviction stats (the
    JAX package's, less its mesh tokens: the port keys no program by a
    mesh).  Stats are kept unconditionally (they are O(1) ints); the
    telemetry counters mirror them only while telemetry is enabled."""

    def __init__(self, name: str, cap: Optional[int] = None,
                 cap_env: str = "QRACK_TPU_PROGRAM_CACHE_CAP",
                 default_cap: int = 256):
        if cap is None:
            cap = int(os.environ.get(cap_env, str(default_cap)))
        self.name = name
        self.cap = max(1, cap)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._od: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()

    def get_or_build(self, key, builder):
        with self._lock:
            fn = self._od.get(key)
            if fn is not None:
                self._od.move_to_end(key)
                self.hits += 1
                if _ENABLED:
                    inc(f"compile.{self.name}.hit")
                return fn
        fn = builder()  # build outside the lock
        with self._lock:
            self._od[key] = fn
            self._od.move_to_end(key)
            self.misses += 1
            if _ENABLED:
                inc(f"compile.{self.name}.miss")
            while len(self._od) > self.cap:
                self._od.popitem(last=False)
                self.evictions += 1
                if _ENABLED:
                    inc(f"compile.{self.name}.eviction")
        return fn

    def stats(self) -> dict:
        return {"size": len(self._od), "cap": self.cap, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions}

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key) -> bool:
        return key in self._od

    def clear(self) -> None:
        with self._lock:
            self._od.clear()


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------

def snapshot(include_events: bool = True) -> dict:
    """Plain-dict view of everything recorded so far (JSON-safe).

    Every observed distribution also publishes ``<name>.p50/.p95/.p99``
    in the returned ``gauges`` (computed here, never stored).  The
    ``epoch_unix_s`` wall anchor converts this process's relative span
    timestamps to absolute time for cross-process merging."""
    with _LOCK:
        gauges = dict(_GAUGES)
        hists = {name: h.to_dict() for name, h in _HISTS.items()}
        for name, h in _HISTS.items():
            for pname, v in h.percentiles().items():
                if v is not None:
                    gauges[f"{name}.{pname}"] = v
        out = {
            "enabled": _ENABLED,
            "pid": os.getpid(),
            "epoch_unix_s": _EPOCH_WALL,
            "counters": dict(_COUNTERS),
            "gauges": gauges,
            "hists": hists,
            "spans": {
                name: {"count": int(agg[0]), "total_s": agg[1],
                       "min_s": agg[2], "max_s": agg[3]}
                for name, agg in _SPANS.items()
            },
        }
        if include_events:
            out["events"] = list(_EVENTS)
    return out


def merge_snapshots(snaps) -> dict:
    """Fold N snapshot dicts (one per process) into one: counters sum,
    span aggregates combine, histograms merge cell-wise, gauges last
    write wins in input order — except the percentile gauges, which are
    recomputed from the merged distributions."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    spans: Dict[str, dict] = {}
    hists: Dict[str, Histogram] = {}
    for s in snaps:
        for k, v in (s.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        gauges.update(s.get("gauges") or {})
        for k, d in (s.get("spans") or {}).items():
            agg = spans.get(k)
            if agg is None:
                spans[k] = dict(d)
            else:
                agg["count"] += d["count"]
                agg["total_s"] += d["total_s"]
                agg["min_s"] = min(agg["min_s"], d["min_s"])
                agg["max_s"] = max(agg["max_s"], d["max_s"])
        for k, d in (s.get("hists") or {}).items():
            h = hists.get(k)
            if h is None:
                hists[k] = Histogram.from_dict(d)
            else:
                h.merge(d)
    for name, h in hists.items():
        for pname, v in h.percentiles().items():
            if v is not None:
                gauges[f"{name}.{pname}"] = v
    return {"counters": counters, "gauges": gauges,
            "hists": {k: h.to_dict() for k, h in hists.items()},
            "spans": spans}


# exporters live in export.py; re-export the public surface
from .export import (  # noqa: E402  (export reads this module lazily)
    chrome_trace, local_trace_source, merged_chrome_trace, profiler_bracket,
    write_chrome_trace, write_jsonl, write_merged_chrome_trace,
)
from .blackbox import FlightRecorder, read_blackbox  # noqa: E402

# arm the exit JSONL dump when the env gate and the out path are both set
if _ENABLED and os.environ.get("QRACK_TPU_TELEMETRY_OUT"):
    from .export import arm_atexit as _arm

    _arm()
