"""The single dispatch-owner thread (the port of the JAX package's
serve/executor.py).

ALL device traffic in a serving process flows through this one daemon
thread — engine construction (admin jobs), batched circuit dispatch,
and synchronous reads (measure/sample/get_state as "call" jobs).  One
thread owns the card's stream, so every launch, write-back and read of
a session's planes is ordered without locks.

Two dispatch modes, both on this one thread (QRACK_SERVE_PIPELINE):

* **serial** (=0): pull a batch, run it to honest completion,
  then look at the queue again — the original loop, preserved
  byte-for-byte for A/B honesty.
* **pipelined** (default): dispatch is split into submit-then-sync.
  CUDA launches return at once, so after submitting batch N the owner
  thread goes straight back to the scheduler and *stages* batch N+1
  (batch assembly + the co-batch window, pre-dispatch shed, spill
  fault-in, routing apply_plan) while batch N executes on device; only
  then does it pay batch N's honest one-element read.  Same-shape jobs
  that arrive while batch N is syncing join the staged batch
  (scheduler.take_joiners) instead of waiting a full cycle.  Staging
  never moves device work off this thread; what overlaps is the
  host-side scheduling wait with device execution.

Every batched dispatch is wrapped in resilience.call_guarded at site
"serve.dispatch" and its completing read at "serve.device_get" (when
the resilience layer is active), so the watchdog / retry / breaker
machinery applies to serving exactly as it does to the library path.
When a dispatch escalates past retry (FAILOVER_ERRORS), every job in
the batch fails over INDIVIDUALLY: the session's pre-batch ket is
still intact (the fold is a fresh buffer and each lane a fresh copy;
no batch writes a session's planes), so fail_over_engine moves it onto
the next engine of the chain (resilience/failover.py: it stays on the
card, and ends on the CPU only for a session built with
``failover_cpu=True``) and the job replays gate-at-a-time there.  In
pipelined mode the exactly-once window widens to one in-flight + one
staged batch, but the staged batch is never dispatched before the
in-flight one fully settles (including any failover replay), and its
engines are re-resolved at its own dispatch — so a failed-over session
in the staged batch simply takes the gate-at-a-time path and no job
ever applies twice.

Job completion is honest: a handle only completes after a real
one-element device-to-host read of the batched output (batcher.py
``sync_scalar``), since a launch returns before the kernel runs.

Prefix seeding is copy-on-write by copy: the JAX package pins a shared
buffer and copies at its donating dispatches; the port's planes change
in place (the window kernel, SetAmplitude, every pager pass), so a
seeded engine takes its own copy of the cache entry at seed time
(:meth:`Executor._seed_prefix`), one ket copy a hit, and no later pass
can reach the entry.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from .. import telemetry as _tele
from ..telemetry import roofline as _roofline
from ..resilience.errors import FAILOVER_ERRORS
from . import batcher as _batcher
from .errors import QueueBudgetExceeded
from .scheduler import Job, Scheduler
from .session import SessionManager, planes_engine


class _InFlight:
    """One submitted-but-unsynced batch: everything the deferred sync
    needs to settle it (or roll it back and fail it over)."""

    __slots__ = ("jobs", "engines", "pre_planes", "out", "span", "t0")

    def __init__(self, jobs, engines, pre_planes, out, span, t0):
        self.jobs = jobs
        self.engines = engines
        self.pre_planes = pre_planes
        self.out = out
        self.span = span          # open serve.execute span (submit->sync)
        self.t0 = t0


class Executor:
    def __init__(self, scheduler: Scheduler, sessions: SessionManager,
                 tick_s: float = 0.25, sync: bool = True, canary=None,
                 checkpoint_every_job: bool = False,
                 pipeline: bool = True, prefix_cache=None):
        self.scheduler = scheduler
        self.sessions = sessions
        self.tick_s = tick_s
        self.sync = sync  # honest completion (QRACK_SERVE_SYNC)
        # QRACK_SERVE_PIPELINE: submit-then-sync double buffering (the
        # serial loop is preserved exactly under =0)
        self.pipeline = pipeline
        # sampled oracle-replay verification (serve/canary.py); None
        # unless QRACK_SERVE_CANARY_RATE > 0 — the default costs one
        # attribute test per batch
        self.canary = canary
        # prefix-sharing COW ket cache (serve/prefix_cache.py); None
        # unless QrackService wired one in — seeding/materialization is
        # device traffic, so it happens here, on the dispatch owner
        self.prefix_cache = prefix_cache
        # QRACK_SERVE_CKPT_EVERY_JOB: settle order snapshot → WAL
        # remove, so there is NO instant where a completed job is
        # neither on disk nor in the journal (fleet zero-loss contract)
        self.checkpoint_every_job = checkpoint_every_job
        # heartbeat-visible pipeline depth (plain ints, owner-thread
        # writes, racy cross-thread reads are fine for beats)
        self.inflight_jobs = 0
        self.staged_jobs = 0
        self._last_evict = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="qrack-serve-executor")
        self._thread.start()

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(join_timeout)
            self._thread = None

    @property
    def thread_ident(self) -> Optional[int]:
        return self._thread.ident if self._thread else None

    def pressure(self) -> int:
        """Queued + staged + in-flight jobs right now — the worker's
        heartbeat-visible backpressure signal; the fleet autoscaler
        sums it across workers into its backlog sensor
        (fleet/autoscaler.py).  Racy cross-thread read by design, like
        the plain-int fields it sums."""
        n = self.scheduler.depth() + self.inflight_jobs + self.staged_jobs
        if _tele._ENABLED:
            _tele.gauge("serve.pressure", float(n))
        return n

    # -- main loop -----------------------------------------------------

    def _loop(self) -> None:
        if self.pipeline:
            self._loop_pipelined()
        else:
            self._loop_serial()

    def _loop_serial(self) -> None:
        while not self._stop.is_set():
            batch = self.scheduler.next_batch(timeout=self.tick_s)
            if batch is None:
                self.sessions.evict_idle()
                self._last_evict = time.monotonic()
                continue
            try:
                self._run(batch)
            except BaseException as e:  # noqa: BLE001 — never strand handles
                self._fail_batch(batch, e)
            # sustained load must not disable idle eviction: spill
            # checks run every tick_s-ish even when the queue never
            # drains (they used to run only on idle timeouts)
            self._maybe_evict()

    def _loop_pipelined(self) -> None:
        inflight: Optional[_InFlight] = None
        try:
            while not self._stop.is_set():
                # with a dispatch in flight, poll the queue instead of
                # blocking: the co-batch window inside next_batch is
                # the wait worth overlapping with device execution;
                # with nothing in flight, block a full tick as before
                timeout = 0.0 if inflight is not None else self.tick_s
                batch = self.scheduler.next_batch(timeout=timeout)
                if batch is None:
                    if inflight is not None:
                        inflight = self._settle(inflight)
                    else:
                        self.sessions.evict_idle()
                        self._last_evict = time.monotonic()
                    continue
                if inflight is not None:
                    # batch N+1 is staged; batch N's honest sync ran
                    # concurrently with the assembly above
                    if _tele._ENABLED:
                        _tele.inc("serve.overlap.staged")
                        _tele.gauge("serve.pipeline.staged", len(batch))
                    self.staged_jobs = len(batch)
                    inflight = self._settle(inflight)
                    # in-flight joining: same-shape arrivals that
                    # landed during the sync join the staged batch
                    batch = self._join_staged(batch)
                self.staged_jobs = 0
                if _tele._ENABLED:
                    _tele.gauge("serve.pipeline.staged", 0)
                try:
                    inflight = self._run_pipelined(batch)
                except BaseException as e:  # noqa: BLE001
                    self._fail_batch(batch, e)
                self._maybe_evict()
        finally:
            if inflight is not None:
                try:
                    self._settle(inflight)
                except BaseException:  # noqa: BLE001 — exiting anyway
                    pass

    def _maybe_evict(self) -> None:
        now = time.monotonic()
        if now - self._last_evict >= self.tick_s:
            self._last_evict = now
            self.sessions.evict_idle()

    def _fail_batch(self, batch: List[Job], e: BaseException) -> None:
        for job in batch:
            if not job.handle.done():
                job.handle._fail(e)
                self._account(job, ok=False)

    def _join_staged(self, batch: List[Job]) -> List[Job]:
        head = batch[0]
        if not head.batchable:
            return batch
        room = self.scheduler.max_batch - len(batch)
        if room <= 0:
            return batch
        sids = {j.session.sid for j in batch if j.session is not None}
        extra = self.scheduler.take_joiners(head.shape_key, sids, room)
        if extra:
            if _tele._ENABLED:
                _tele.inc("serve.overlap.join.jobs", len(extra))
            batch = batch + extra
        return batch

    # -- per-batch pre-dispatch work (both modes) ----------------------

    def _prepare(self, batch: List[Job]) -> List[Job]:
        """Shed over-budget jobs, then run every pre-dispatch stage:
        start stamps, spill fault-in, routing plan realization, elastic
        re-expansion probes, canary pre-capture.  Returns the live
        jobs.  In pipelined mode this runs only after the previous
        batch fully settled, so everything here sees settled engines —
        identical ordering to the serial path."""
        # pre-dispatch shed: the admission-side expiry only sees jobs
        # still in the heap — a job whose budget ran out while its batch
        # was being assembled (the batch window holds the door open)
        # would otherwise execute stale.  Same accounting as expiry,
        # plus its own counter so the report can tell the two apart.
        budget = self.scheduler.queue_budget_s
        if budget > 0:
            now = time.perf_counter()
            live: List[Job] = []
            for job in batch:
                waited = now - job.handle.t_submit
                if job.kind != "admin" and waited > budget:
                    job.handle._fail(QueueBudgetExceeded(waited, budget))
                    self._account(job, ok=False)
                    if _tele._ENABLED:
                        _tele.inc("serve.shed.pre_dispatch")
                else:
                    live.append(job)
            if not live:
                return live
            batch = live
        for job in batch:
            job.handle._start()
        # fault spilled sessions back in before their jobs touch engines
        # (idle spill can land between queueing and execution)
        for job in batch:
            if job.session is not None and job.session.spilled:
                self.sessions.ensure_resident(job.session)
        # realize routing plans before anything inspects the engine:
        # building the routed stack (or escalating a mis-route) is
        # device traffic and belongs to this thread (route/router.py)
        for job in batch:
            sess = job.session
            if sess is not None and getattr(sess.engine, "_is_routed",
                                            False):
                sess.engine.apply_plan()
                if job.kind == "circuit":
                    sess.engine.note_job()
        # job boundaries are the serve-path recovery probe: a session
        # whose pager shrank under device loss grows back to its
        # construction page count here once the device looks healthy
        from .. import resilience as _res

        if _res._ACTIVE:
            from ..resilience import elastic as _elastic

            for job in batch:
                sess = job.session
                if sess is not None and sess.engine is not None:
                    _elastic.maybe_reexpand(sess.engine)
        # realize prefix splits BEFORE canary pre-capture: the session
        # ket must hold the prefix state so the oracle replays the
        # suffix (job.circuit) from the base it will actually run on
        if self.prefix_cache is not None:
            live = []
            for job in batch:
                try:
                    self._seed_prefix(job)
                except BaseException as e:  # noqa: BLE001
                    job.handle._fail(e)
                    self._account(job, ok=False)
                else:
                    live.append(job)
            if not live:
                return live
            batch = live
        # canary sampling decides BEFORE execution: the oracle replay
        # needs the pre-job ket, and the state reads belong to this
        # thread (the replay itself runs on the canary thread)
        if self.canary is not None:
            for job in batch:
                if (job.kind == "circuit" and job.session is not None
                        and self.canary.should_sample()):
                    self.canary.capture_pre(job)
        return batch

    def _seed_prefix(self, job: Job) -> None:
        """Realize one job's admission-time prefix split on its engine.
        job.circuit is the SUFFIX only; after this the session ket holds
        the prefix state, so running the suffix — batched, singleton, or
        failover-replayed (pre_planes capture the SEEDED state) — is
        exact.  Seeding from a cached entry gives the engine its OWN
        copy of the entry's planes (copy-on-write at seed time): every
        later in-place pass of the tenant writes that copy, never the
        cache entry or a sibling tenant seeded from it."""
        if job.kind != "circuit" or not getattr(job, "prefix_len", 0):
            return
        sess = job.session
        cache = self.prefix_cache
        eng = planes_engine(sess.engine)
        if eng is None:
            # the session failed over to a non-plane stack after
            # admission: no planes to seed — replay the prefix
            # gate-at-a-time so the suffix still lands on the right base
            job.prefix_circuit.Run(sess.engine)
            return
        planes = None
        entry = job.prefix_entry
        if entry is not None:
            # faults spills back in; None on loss/corruption
            planes = cache.acquire(entry, eng.device)
        if planes is None and job.prefix_insert:
            # popular miss — but an earlier job (possibly in this very
            # batch window) may have inserted already; re-probe before
            # paying the materialization
            entry = cache.get(job.prefix_digest, sess.width)
            if entry is not None:
                planes = cache.acquire(entry, eng.device)
        if planes is not None:
            # the engine's own copy, in its dtype and on its device
            eng.device_planes = planes.to(device=eng.device,
                                          dtype=eng.dtype, copy=True)
            if _tele._ENABLED:
                _tele.inc("serve.prefix.cow")
            return
        self._materialize_prefix(job, eng, cache)

    def _materialize_prefix(self, job: Job, eng, cache) -> None:
        """Execute the prefix on the session engine and, for a popular
        miss, insert a COPY of the resulting planes into the cache.  The
        copy is what the ``prefix.materialize`` amp-corrupt fault
        strikes, and what insert() validates on host — a corrupted
        materialization is refused at the door while the engine's own
        planes stay clean, so the job (and every future tenant) is
        unaffected."""
        from ..resilience import faults as _faults

        directive = _faults.check("prefix.materialize")  # may raise
        if directive is not None:
            raise RuntimeError(
                f"prefix.materialize injected fault: {directive}")
        job.prefix_circuit.Run(job.session.engine)
        if not job.prefix_insert:
            return
        cand = _faults.corrupt_output("prefix.materialize",
                                      eng.device_planes.clone())
        cache.insert(job.prefix_digest, job.session.width, "dense",
                     job.prefix_len, cand)

    def _misroute_checks(self, batch: List[Job]) -> None:
        # job-boundary mis-route probe: a stabilizer forced off-tableau
        # or a QBdt past its node budget escalates (once) right here,
        # before the next job lands on the wrong representation
        for job in batch:
            sess = job.session
            if (job.kind == "circuit" and sess is not None
                    and getattr(sess.engine, "_is_routed", False)):
                sess.engine.misroute_check()

    def _run(self, batch: List[Job]) -> None:
        batch = self._prepare(batch)
        if not batch:
            return
        # remap-planner horizon: a session executing several queued
        # circuits plans placement across the WHOLE batch, not just the
        # window in hand (the fuser's lookahead, ops/fusion.py)
        primed = self._prime_lookahead(batch)
        try:
            if batch[0].batchable:
                self._run_batched(batch)
            else:
                self._run_single(batch[0])
        finally:
            for fuser in primed:
                fuser.clear_lookahead()
        self._misroute_checks(batch)

    def _run_pipelined(self, batch: List[Job]) -> Optional[_InFlight]:
        """Prepare + dispatch one batch; batchable dispatches return an
        _InFlight (sync deferred until the NEXT batch is staged),
        everything else runs to completion as in serial mode."""
        t0 = time.perf_counter()
        batch = self._prepare(batch)
        if not batch:
            return None
        primed = self._prime_lookahead(batch)
        try:
            if batch[0].batchable:
                inflight = self._dispatch_async(batch)
            else:
                self._run_single(batch[0])
                inflight = None
        finally:
            for fuser in primed:
                fuser.clear_lookahead()
        if inflight is None:
            # stale/singleton/failed-at-dispatch paths settled in place
            self._misroute_checks(batch)
            return None
        if _tele._ENABLED:
            _tele.record_span("serve.stage.dispatch", t0,
                              time.perf_counter() - t0,
                              trace=inflight.jobs[0].trace)
            _tele.gauge("serve.pipeline.inflight", len(inflight.jobs))
        self.inflight_jobs = len(inflight.jobs)
        return inflight

    def _prime_lookahead(self, batch: List[Job]) -> List[object]:
        """Install a batch-wide lookahead on each session fuser that is
        about to execute more than one circuit job.  Single-circuit
        sessions are left alone — QCircuit.Run primes its own horizon
        (set-if-None), and these entries concatenate in execution order
        so the fuser's cursor stays aligned across job boundaries."""
        groups = {}
        for job in batch:
            if job.kind != "circuit" or job.session is None:
                continue
            groups.setdefault(id(job.session), []).append(job)
        primed = []
        for jobs in groups.values():
            if len(jobs) < 2:
                continue
            fuser = getattr(jobs[0].session.engine, "_fuser", None)
            if fuser is None or fuser.lookahead is not None:
                continue
            entries: List = []
            for job in jobs:
                entries.extend(job.circuit._lookahead_entries())
            fuser.set_lookahead(entries)
            primed.append(fuser)
        return primed

    # -- batched circuit path ------------------------------------------

    def _dispatch_async(self, jobs: List[Job]) -> Optional[_InFlight]:
        """The submit half of a batched dispatch: stale-split, pin the
        pre-batch planes, run_batch (its launches return before the
        kernels run).  Returns the in-flight record, or
        None when everything already settled (all-stale batch, or a
        dispatch-side escalation that failed over in place)."""
        engines = [planes_engine(j.session.engine) for j in jobs]
        # a session may have failed over (to a non-plane engine) after
        # this job was queued as batchable — run those gate-at-a-time
        stale = [j for j, e in zip(jobs, engines) if e is None]
        if stale:
            for job in stale:
                try:
                    job.circuit.Run(job.session.engine)
                except BaseException as e:  # noqa: BLE001
                    job.handle._fail(e)
                    self._account(job, ok=False)
                else:
                    self._complete(job, None)
            jobs = [j for j, e in zip(jobs, engines) if e is not None]
            engines = [e for e in engines if e is not None]
            if not jobs:
                return None
        # keep the pre-batch planes referenced: run_batch binds its
        # output lanes to the engines BEFORE the honest sync, so a
        # sync-side escalation must roll the engines back or the
        # failover replay would apply the circuit twice
        pre_planes = [eng.device_planes for eng in engines]
        # a batch spans tenants; the trace id of its HEAD job labels the
        # span (co-batched jobs still correlate via their own latency
        # observes and the worker-side submit spans)
        span = (_tele.span("serve.execute", trace=jobs[0].trace)
                if _tele._ENABLED else None)
        t0 = time.perf_counter()
        if span:
            span.__enter__()
        try:
            out = _batcher.run_batch(jobs, engines)
        except FAILOVER_ERRORS as e:
            if span:
                span.__exit__(None, None, None)
            for eng, planes in zip(engines, pre_planes):
                eng.device_planes = planes
            self._fail_over_jobs(jobs, e)
            return None
        except BaseException:
            if span:
                span.__exit__(None, None, None)
            raise
        return _InFlight(jobs, engines, pre_planes, out, span, t0)

    def _sync_settle(self, inf: _InFlight) -> None:
        """The sync half: honest completion for a submitted batch, with the same rollback + per-job failover the serial
        path has when the read escalates."""
        from .. import resilience as _res

        t_sync = time.perf_counter()
        try:
            if self.sync:
                if _res._ACTIVE:
                    _res.call_guarded("serve.device_get",
                                      _batcher.sync_scalar, (inf.out,))
                else:
                    _batcher.sync_scalar(inf.out)
        except FAILOVER_ERRORS as e:
            if inf.span:
                inf.span.__exit__(None, None, None)
            for eng, planes in zip(inf.engines, inf.pre_planes):
                eng.device_planes = planes
            self._fail_over_jobs(inf.jobs, e)
            return
        except BaseException as e:  # noqa: BLE001 — never strand handles
            if inf.span:
                inf.span.__exit__(None, None, None)
            self._fail_batch(inf.jobs, e)
            return
        if inf.span:
            inf.span.__exit__(None, None, None)
        if _tele._ENABLED:
            now = time.perf_counter()
            _tele.observe("serve.overlap.sync_wait", now - t_sync)
            _tele.record_span("serve.stage.sync", t_sync, now - t_sync,
                              trace=inf.jobs[0].trace)
            if self.sync:
                # honest wall for the whole dispatch; planned bytes use
                # the naive per-gate model (one plane pass per gate per
                # job, as in the JAX package), so the fraction is a
                # floor
                try:
                    n = int(getattr(inf.engines[0], "qubit_count", 0))
                    gates = sum(len(getattr(j.circuit, "gates", ()) or ())
                                for j in inf.jobs)
                    esize = int(inf.pre_planes[0].dtype.itemsize)
                    if n and gates:
                        _roofline.record(
                            "serve.dispatch",
                            gates * _roofline.plane_pass_bytes(n, esize),
                            now - inf.t0, width=n)
                except Exception:  # bookkeeping must never strand a batch
                    pass
        for job in inf.jobs:
            self._complete(job, None)

    def _settle(self, inf: _InFlight) -> None:
        """Settle an in-flight batch completely (sync + completion +
        job-boundary probes) and clear the depth gauges.  Returns None
        so callers can assign the cleared in-flight slot."""
        self._sync_settle(inf)
        self._misroute_checks(inf.jobs)
        self.inflight_jobs = 0
        if _tele._ENABLED:
            _tele.gauge("serve.pipeline.inflight", 0)
        return None

    def _run_batched(self, jobs: List[Job]) -> None:
        inf = self._dispatch_async(jobs)
        if inf is not None:
            self._sync_settle(inf)

    def _fail_over_jobs(self, jobs: List[Job], cause) -> None:
        """Per-job engine failover + gate-at-a-time replay.  Session
        planes were never written by the failed batch (the fold is a
        fresh buffer) and the dispatch/sync paths re-bound them if the
        batch had already bound its lanes, so each snapshot equals the
        pre-batch state and the replay is exact.  replay_with_failover
        walks the chain (pager shrink → … → cuda, then cpu for a session
        built with failover_cpu=True) when the fault persists across
        replays.

        Where the session's engine has no rung below it (a QEngineCUDA
        without the CPU rung: the chain stays on the card), the job
        replays on that engine itself, which the failed batch left
        intact, as a one-lane batch (:meth:`_replay_in_place`)."""
        from ..resilience.failover import has_fallback, replay_with_failover

        if _tele._ENABLED:
            _tele.inc("serve.batch.failovers")
        for job in jobs:
            sess = job.session

            def commit(eng, sess=sess):
                sess.engine = eng
                sess.failovers += 1

            try:
                target = planes_engine(sess.engine) or sess.engine
                fo = _failover_cpu(sess)
                if has_fallback(target, cause, fo):
                    replay_with_failover(
                        target, cause,
                        lambda eng, job=job: job.circuit.Run(eng),
                        commit=commit, failover_cpu=fo)
                elif planes_engine(sess.engine) is not None:
                    self._replay_in_place(job, planes_engine(sess.engine))
                else:
                    raise cause
            except BaseException as e:  # noqa: BLE001 — chain exhausted
                job.handle._fail(e)
                self._account(job, ok=False)
            else:
                self._complete(job, None)

    def _replay_in_place(self, job: Job, eng) -> None:
        """Replay one job of a failed batch on its own engine as a
        one-lane batch: guarded at ``serve.dispatch`` and synced at
        ``serve.device_get`` like any batch, the engine re-bound to its
        pre-batch planes if either fails again (the job then fails with
        the typed error: an open breaker refuses it, a persistent fault
        exhausts it), so it applies once or not at all."""
        from .. import resilience as _res

        pre = eng.device_planes
        try:
            out = _batcher.run_batch([job], [eng])
            if self.sync:
                if _res._ACTIVE:
                    _res.call_guarded("serve.device_get",
                                      _batcher.sync_scalar, (out,))
                else:
                    _batcher.sync_scalar(out)
        except BaseException:
            eng.device_planes = pre
            raise
        if _tele._ENABLED:
            _tele.inc("serve.batch.replay.in_place")

    # -- singleton path (non-batchable circuits, calls, admin) ---------

    def _run_single(self, job: Job) -> None:
        if job.kind == "admin":
            try:
                job.handle._complete(job.fn())
            except BaseException as e:  # noqa: BLE001
                job.handle._fail(e)
            return
        sess = job.session

        def body():
            if job.kind == "circuit":
                job.circuit.Run(sess.engine)
                return None
            return job.fn(sess.engine)

        try:
            with _tele.span("serve.execute", trace=job.trace):
                result = body()
        except FAILOVER_ERRORS as e:
            # engine-internal guarded sites escalated: walk the session
            # down the elastic chain, replaying the one job after every
            # transition until it lands
            from ..resilience.failover import replay_with_failover

            def commit(eng):
                sess.engine = eng
                sess.failovers += 1

            def replay(eng):
                if job.kind == "circuit":
                    job.circuit.Run(eng)
                    return None
                return job.fn(eng)

            try:
                _, result = replay_with_failover(
                    planes_engine(sess.engine) or sess.engine, e,
                    replay, commit=commit,
                    failover_cpu=_failover_cpu(sess))
            except BaseException as e2:  # noqa: BLE001
                job.handle._fail(e2)
                self._account(job, ok=False)
                return
            self._complete(job, result)
        except BaseException as e:  # noqa: BLE001
            job.handle._fail(e)
            self._account(job, ok=False)
        else:
            self._complete(job, result)

    # -- bookkeeping ---------------------------------------------------

    def _complete(self, job: Job, result) -> None:
        if self.canary is not None and job.kind == "circuit":
            # post-state read happens here (dispatch-owner thread);
            # no-op for unsampled jobs
            self.canary.submit_post(job)
        job.handle._complete(result)
        self._account(job, ok=True)

    def _account(self, job: Job, ok: bool) -> None:
        if not ok and self.canary is not None:
            self.canary.discard(job)
        if job.session is not None:
            job.session.end_job(ok)
            if ok and self.sessions.spill_store is not None:
                # circuits always advance the state; "call" jobs carry
                # an explicit flag (MAll/sampling mutate — collapse or
                # rng draw — Prob/GetQuantumState do not).  A pure read
                # leaves the snapshot valid: neither dirty nor re-saved.
                mutated = (job.kind == "circuit"
                           or (job.kind == "call" and job.mutates))
                if (self.checkpoint_every_job and mutated
                        and job.session.engine is not None):
                    # snapshot BEFORE the WAL entry below is settled,
                    # recording this job's journal seq as the snapshot's
                    # wal_high: kill -9 before the save replays the
                    # pending entry onto the clean pre-job snapshot;
                    # kill -9 after it finds the entry deduped against
                    # wal_high — the job lands exactly once either way.
                    # Mutating calls snapshot too (no WAL entry, so no
                    # wal_high bump): skipping them would leave the
                    # manifest dirty, flip recovery to the stale path,
                    # and silently drop any journaled-but-unexecuted
                    # circuit at adoption despite its acked journaled
                    # frame.  A failed save leaves the dirty path intact.
                    wal_seq = None
                    if job.wal_path is not None:
                        import os as _os
                        try:
                            wal_seq = int(_os.path.basename(job.wal_path)
                                          .partition("-")[0])
                        except ValueError:
                            pass
                    try:
                        self.sessions.spill_store.save(job.session.sid,
                                                       job.session.engine,
                                                       wal_seq=wal_seq)
                    except Exception:  # noqa: BLE001 — fall back to dirty
                        self.sessions.spill_store.mark_dirty(
                            job.session.sid)
                elif mutated:
                    # the session's live state has advanced past whatever
                    # is (or isn't) on disk; recovery keys off this flag
                    # to refuse WAL replay onto a wrong base (no-op when
                    # already dirty, so the steady-state cost is a probe)
                    self.sessions.spill_store.mark_dirty(job.session.sid)
        wal_path = getattr(job, "wal_path", None)
        if wal_path is not None and self.sessions.spill_store is not None:
            if ok and job.tag is not None:
                # durable settled-tag ack BEFORE the entry disappears:
                # the front door's resubmit decision can then prove "this
                # tag landed" even when the worker died in the
                # microseconds between settling and writing its first
                # frame (the residual double-apply window)
                self.sessions.spill_store.ack_tag(job.tag)
            # settled either way: a failed job must not replay at recovery
            self.sessions.spill_store.wal_remove(wal_path)
            job.wal_path = None
        if _tele._ENABLED:
            _tele.inc("serve.jobs.completed" if ok else "serve.jobs.failed")
            h = job.handle
            if h.queue_wait_s is not None:
                _tele.observe("serve.queue_wait", h.queue_wait_s)
            if h.latency_s is not None:
                lat = h.latency_s
                _tele.observe("serve.latency", lat)
                # the same t_submit->t_done interval on the trace ring:
                # one bar per job on the merged fleet timeline, and a
                # raw-duration reference the bucketed serve.latency
                # gauges can be checked against
                _tele.record_span("serve.job", h.t_submit, lat,
                                  trace=job.trace)
                sess = job.session
                if sess is not None:
                    # per-tenant + per-routed-stack SLO labels; the hist
                    # name space is capped (telemetry._HIST_CAP) so a
                    # tenant churn storm cannot grow memory unboundedly
                    _tele.observe(f"serve.latency.tenant.{sess.sid}", lat)
                    _tele.observe(
                        f"serve.latency.stack.{_stack_label(sess)}", lat)


def _failover_cpu(sess) -> bool:
    """Whether the session asked for the failover chain's CPU rung
    (``failover_cpu=True`` at creation, or on its resilient wrapper)."""
    return bool(sess.engine_kwargs.get("failover_cpu", False)
                or getattr(sess.engine, "_failover_cpu", False))


def _stack_label(sess) -> str:
    """The session's routed stack for SLO labeling: the router's live
    decision when the engine is routed, its configured layers spec
    otherwise."""
    cur = getattr(sess.engine, "current_stack", None)
    if callable(cur):
        try:
            return cur() or "pending"
        except Exception:  # noqa: BLE001 — labels must never fail a job
            return "pending"
    layers = getattr(sess, "layers", None)
    if isinstance(layers, (list, tuple)):
        return "+".join(str(l) for l in layers)
    return str(layers)
