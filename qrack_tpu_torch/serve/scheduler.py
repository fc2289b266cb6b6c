"""Priority job queue with admission control and backpressure (a copy
of the JAX package's serve/scheduler.py; host only).

Admission (all checks at submit(), synchronous, typed — errors.py):

* bounded depth — past QRACK_SERVE_MAX_DEPTH jobs, QueueFull;
* breaker-aware load shedding — while the resilience breaker is OPEN
  and still cooling down, jobs whose session would dispatch on the
  card are refused with LoadShed (+ retry hint).  CPU-backed
  sessions, including already-failed-over ones, keep flowing;
* queue-time budget — a job queued past QRACK_SERVE_QUEUE_BUDGET_MS
  is expired with QueueBudgetExceeded instead of executing stale.

Dispatch order is fair aged priority, not a bare (-priority, seq)
heap.  Each queued job's *effective band* is
``priority + waited_s / aging_s`` (QRACK_SERVE_AGING_S, 0 = strict
priority): sustained high-priority load can no longer starve a
priority-0 tenant forever, because every second waited promotes it one
band.  Within a band, selection is weighted round-robin across
sessions — each dispatched job charges its session ``1/weight`` of
virtual service time and the least-served session goes first — so one
chatty tenant can't monopolize the lane.  Ties break on submit
sequence, which keeps two jobs from one session at equal priority in
submit order (the batcher additionally never co-batches one session
twice).

next_batch() is the executor's main entry point: it pops the best
runnable job and, when the job is batchable, holds the door open up to
QRACK_SERVE_BATCH_WINDOW_MS for same-shape jobs from OTHER sessions,
up to QRACK_SERVE_MAX_BATCH.  The window closes early once the batch
is full, so a saturated queue pays no added latency.  take_joiners()
is the pipelined executor's second entry point: same-shape arrivals
that landed while the previous batch's sync was in flight join the
staged (not yet dispatched) batch instead of waiting a full cycle.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, List, Optional

from .. import telemetry as _tele
from ..resilience import breaker as _breaker
from .errors import (LoadShed, Overloaded, QueueBudgetExceeded, QueueFull,
                     ServiceStopped)
from .session import Session


class JobHandle:
    """Caller's view of a submitted job: wait, result, and the
    timestamps queue/execute latency are derived from."""

    __slots__ = ("sid", "kind", "t_submit", "t_start", "t_done",
                 "_event", "_result", "_error")

    def __init__(self, sid: str, kind: str):
        self.sid = sid
        self.kind = kind
        self.t_submit = time.perf_counter()
        self.t_start: Optional[float] = None
        self.t_done: Optional[float] = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"job on session {self.sid} still pending "
                               f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.t_start is None else self.t_start - self.t_submit

    @property
    def execute_s(self) -> Optional[float]:
        if self.t_start is None or self.t_done is None:
            return None
        return self.t_done - self.t_start

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    # executor-side completion
    def _start(self) -> None:
        self.t_start = time.perf_counter()

    def _complete(self, result) -> None:
        self.t_done = time.perf_counter()
        self._result = result
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self.t_done = time.perf_counter()
        self._error = error
        self._event.set()


class Job:
    __slots__ = ("session", "kind", "circuit", "fn", "shape_key",
                 "priority", "seq", "handle", "wal_path", "mutates",
                 "tag", "trace", "prefix_len", "prefix_digest",
                 "prefix_circuit", "prefix_entry", "prefix_insert")

    def __init__(self, session: Optional[Session], kind: str, *,
                 circuit=None, fn: Optional[Callable] = None,
                 shape_key=None, priority: int = 0,
                 mutates: bool = True):
        self.session = session
        self.kind = kind          # "circuit" | "call" | "trajectories" | "admin"
        self.circuit = circuit
        self.fn = fn
        self.shape_key = shape_key  # non-None => batchable (one fold)
        self.priority = priority
        self.seq = 0              # assigned by the scheduler
        self.handle = JobHandle(session.sid if session else "-", kind)
        self.wal_path = None      # journal entry to settle (checkpointing)
        self.tag = None           # fleet dedup tag (durable ack at settle)
        # prefix-cache split (service.submit / executor._seed_prefixes):
        # when prefix_len > 0, self.circuit is the SUFFIX only — the
        # executor seeds the engine from prefix_entry (hit) or
        # materializes prefix_circuit first (prefix_insert: popular
        # miss, insert after).  The WAL always journals the FULL
        # circuit, so recovery replays from |0…0⟩ unchanged.
        self.prefix_len = 0
        self.prefix_digest = None
        self.prefix_circuit = None
        self.prefix_entry = None
        self.prefix_insert = False
        # does settling this job advance the session past its on-disk
        # snapshot?  Circuits always do; "call" jobs that collapse state
        # or consume the rng stream (MAll, sampling) do too, while pure
        # reads (Prob, GetQuantumState) leave the snapshot valid.
        # Conservative default: unknown fns are assumed mutating.
        self.mutates = mutates
        # distributed-trace id, captured from the SUBMITTING thread
        # (the worker RPC thread sets it from the frame's trace field);
        # the executor pins it back onto serve.execute spans so a
        # submit is one correlated trace across processes
        self.trace = _tele.current_trace() if _tele._ENABLED else None

    @property
    def batchable(self) -> bool:
        # "trajectories" jobs are structurally non-batchable: their
        # batch axis is pre-stacked (B trajectories of ONE tenant), so
        # the batcher must never join two tenants into one trajectory
        # dispatch (noise/trajectories.py)
        return self.kind == "circuit" and self.shape_key is not None


class Scheduler:
    def __init__(self, max_depth: int, queue_budget_s: float,
                 batch_window_s: float, max_batch: int,
                 aging_s: float = 1.0):
        self.max_depth = max(1, max_depth)
        self.queue_budget_s = queue_budget_s
        self.batch_window_s = max(0.0, batch_window_s)
        self.max_batch = max(1, max_batch)
        # waited-time aging: one priority band gained per aging_s
        # queued (0 = strict priority, the pre-fairness behavior)
        self.aging_s = max(0.0, aging_s)
        self._heap: List[tuple] = []   # (-priority, seq, Job)
        # weighted round-robin state: virtual service time per sid —
        # each dispatched job charges its session 1/weight, and the
        # least-served session in the top band dispatches first
        self._served: dict = {}
        self._cond = threading.Condition()
        self._seq = 0
        self._stopped = False
        # brownout admission (fleet autoscaler broadcast): while set,
        # jobs at or below the shed band are refused with the typed
        # Overloaded — (level, shed_band, retry_in_s) or None
        self._brownout: Optional[tuple] = None

    # -- brownout (graceful degradation under fleet overload) ----------

    def set_brownout(self, level: int, shed_band: int = 0,
                     retry_in_s: float = 0.5) -> None:
        """Install (level >= 1) or clear (level <= 0) brownout shedding
        at admission.  Worker-side defense in depth behind the front
        door's synchronous check — direct submitters degrade the same
        way fleet tenants do."""
        with self._cond:
            self._brownout = (None if level <= 0
                              else (int(level), int(shed_band),
                                    float(retry_in_s)))

    def brownout_level(self) -> int:
        with self._cond:
            return self._brownout[0] if self._brownout else 0

    # -- submit side ---------------------------------------------------

    def submit(self, job: Job) -> JobHandle:
        with self._cond:
            if self._stopped:
                raise ServiceStopped("service is shut down")
            if _tele._ENABLED:
                _tele.inc("serve.jobs.submitted")
            if len(self._heap) >= self.max_depth:
                if _tele._ENABLED:
                    _tele.inc("serve.jobs.rejected_full")
                raise QueueFull(len(self._heap), self.max_depth)
            if self._brownout is not None:
                level, shed_band, retry_in_s = self._brownout
                if level >= 3 or job.priority <= shed_band:
                    if _tele._ENABLED:
                        _tele.inc("serve.brownout.shed")
                    raise Overloaded(retry_in_s, level=level,
                                     band=None if level >= 3
                                     else shed_band)
            if job.session is not None:
                remaining = _breaker.get_breaker().open_remaining_s()
                if remaining > 0 and job.session.touches_tunnel():
                    if _tele._ENABLED:
                        _tele.inc("serve.jobs.shed")
                    raise LoadShed(job.session.sid, remaining)
            self._seq += 1
            job.seq = self._seq
            heapq.heappush(self._heap, (-job.priority, job.seq, job))
            if _tele._ENABLED:
                _tele.inc("serve.jobs.admitted")
                _tele.gauge("serve.queue.depth", len(self._heap))
            self._cond.notify()
        return job.handle

    def depth(self) -> int:
        with self._cond:
            return len(self._heap)

    def stop(self) -> None:
        """Refuse new submissions and drain queued jobs with
        ServiceStopped so no caller blocks forever on a handle."""
        with self._cond:
            self._stopped = True
            drained = [entry[2] for entry in self._heap]
            self._heap.clear()
            self._cond.notify_all()
        for job in drained:
            job.handle._fail(ServiceStopped("service shut down with job "
                                            "still queued"))
            if job.session is not None:
                job.session.end_job(ok=False)

    # -- executor side -------------------------------------------------

    def _expire_locked(self, now: float) -> None:
        """Complete over-budget queued jobs exceptionally (bounded
        queueing latency).  Caller holds the lock."""
        if self.queue_budget_s <= 0 or not self._heap:
            return
        live, expired = [], []
        for entry in self._heap:
            job = entry[2]
            waited = now - job.handle.t_submit
            (expired if waited > self.queue_budget_s else live).append(entry)
        if not expired:
            return
        self._heap = live
        heapq.heapify(self._heap)
        for entry in expired:
            job = entry[2]
            waited = now - job.handle.t_submit
            job.handle._fail(QueueBudgetExceeded(waited, self.queue_budget_s))
            if job.session is not None:
                job.session.end_job(ok=False)
            if _tele._ENABLED:
                _tele.inc("serve.jobs.expired")
        if _tele._ENABLED:
            _tele.gauge("serve.queue.depth", len(self._heap))

    def _charge_locked(self, job: Job) -> None:
        """Accrue virtual service time against the dispatched job's
        session (1/weight per job).  Caller holds the lock."""
        sess = job.session
        sid = sess.sid if sess is not None else "-"
        weight = getattr(sess, "weight", 1.0) if sess is not None else 1.0
        if len(self._served) > 4096:
            # bound tenant-churn growth; resetting everyone to zero is
            # fair-neutral (relative order restarts from scratch)
            self._served.clear()
        self._served[sid] = (self._served.get(sid, 0.0)
                             + 1.0 / max(weight, 1e-6))

    def _pop_best_locked(self) -> Job:
        """Remove and return the next job to dispatch: highest aged
        priority band first, then least virtual service time (weighted
        round-robin across sids), then submit order.  Caller holds the
        lock; the heap is non-empty."""
        now = time.perf_counter()
        best_i, best_key = 0, None
        for i, entry in enumerate(self._heap):
            job = entry[2]
            band = job.priority
            if self.aging_s > 0:
                band += int((now - job.handle.t_submit) / self.aging_s)
            sid = job.session.sid if job.session is not None else "-"
            key = (-band, self._served.get(sid, 0.0), job.seq)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        job = self._heap.pop(best_i)[2]
        heapq.heapify(self._heap)
        self._charge_locked(job)
        return job

    def _take_matching_locked(self, key, exclude_sids: set,
                              limit: int) -> List[Job]:
        """Remove up to `limit` queued batchable jobs with shape `key`,
        at most one per session AND only a session's earliest queued job
        (a session's jobs must stay ordered: co-batching a later circuit
        past an earlier queued op would reorder that tenant's stream).
        Caller holds the lock."""
        first_seq: dict = {}
        for entry in self._heap:
            job = entry[2]
            if job.session is not None:
                sid = job.session.sid
                if sid not in first_seq or job.seq < first_seq[sid]:
                    first_seq[sid] = job.seq
        taken: List[Job] = []
        keep: List[tuple] = []
        for entry in sorted(self._heap):  # priority order
            job = entry[2]
            if (len(taken) < limit and job.batchable
                    and job.shape_key == key
                    and job.session.sid not in exclude_sids
                    and job.seq == first_seq.get(job.session.sid)):
                taken.append(job)
                exclude_sids.add(job.session.sid)
                self._charge_locked(job)
            else:
                keep.append(entry)
        if taken:
            self._heap = keep
            heapq.heapify(self._heap)
        return taken

    def take_joiners(self, key, exclude_sids: set,
                     limit: int) -> List[Job]:
        """Pipelined executor's late-join grab: pull same-shape-key
        jobs that arrived while the previous batch's sync was in flight
        into the staged (not yet dispatched) batch — same per-session
        ordering rules as the batch window, no extra wait."""
        if limit <= 0:
            return []
        with self._cond:
            self._expire_locked(time.perf_counter())
            taken = self._take_matching_locked(key, exclude_sids, limit)
            if taken and _tele._ENABLED:
                _tele.gauge("serve.queue.depth", len(self._heap))
        return taken

    def next_batch(self, timeout: float = 0.25) -> Optional[List[Job]]:
        """Block up to `timeout` for work; returns one batch (singleton
        for non-batchable jobs) or None on idle timeout / stop."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                self._expire_locked(time.perf_counter())
                if self._heap:
                    break
                remaining = deadline - time.monotonic()
                if self._stopped or remaining <= 0:
                    return None
                self._cond.wait(remaining)
            job = self._pop_best_locked()
            batch = [job]
            if job.batchable and self.max_batch > 1:
                sids = {job.session.sid}
                window_end = time.monotonic() + self.batch_window_s
                while len(batch) < self.max_batch:
                    batch.extend(self._take_matching_locked(
                        job.shape_key, sids, self.max_batch - len(batch)))
                    if len(batch) >= self.max_batch:
                        break
                    remaining = window_end - time.monotonic()
                    if remaining <= 0 or self._stopped:
                        break
                    self._cond.wait(remaining)
            if _tele._ENABLED:
                _tele.gauge("serve.queue.depth", len(self._heap))
        return batch
