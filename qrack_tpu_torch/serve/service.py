"""QrackService: the thin in-process front API over the serving stack
(the port of the JAX package's serve/service.py).

    with QrackService(engine_layers="cuda") as svc:
        sid = svc.create_session(width=16, seed=7)
        svc.apply(sid, circuit)              # submit + wait
        bits = svc.measure_all(sid)
        svc.destroy_session(sid)

Everything that touches a device — session construction included —
runs on the executor's dispatch-owner thread; the caller only ever
blocks on a JobHandle.  Sessions run on the card: ``device=`` goes into
the engine keyword arguments, and without a GPU a service whose layers
end on a device terminal refuses construction unless it is given
``device="cpu"`` (host terminals, ``"cpu"`` and ``"sparse"``, take no
device).  Env knobs (constructor args override), the JAX package's:

* ``QRACK_SERVE_MAX_DEPTH``        queue depth bound (default 64)
* ``QRACK_SERVE_BATCH_WINDOW_MS``  batch collection window (default 2)
* ``QRACK_SERVE_MAX_BATCH``        max jobs per folded batch (default 8)
* ``QRACK_SERVE_QUEUE_BUDGET_MS``  max queued age before a job expires
                                   (default 2000; 0 disables)
* ``QRACK_SERVE_IDLE_EVICT_S``     idle-session eviction (default 0=off)
* ``QRACK_SERVE_PIPELINE``         "0": serial dispatch (pull a batch,
                                   run it to honest completion,
                                   repeat).  Default "1": two-stage
                                   pipeline — batch N+1 is assembled
                                   and staged while batch N executes
                                   on device, and same-shape arrivals
                                   join the staged batch
* ``QRACK_SERVE_AGING_S``          waited-time priority aging: a queued
                                   job gains one priority band per this
                                   many seconds (default 1.0; 0 =
                                   strict priority, which can starve)
* ``QRACK_SERVE_BATCH_PAD``        "0": key batch programs by exact
                                   batch sizes.  Default: bucket each
                                   batch to the next power of two, so
                                   program variety is O(log max_batch);
                                   the fold pads its lanes to a power
                                   of two either way (serve/batcher.py)
* ``QRACK_SERVE_SYNC``             "devget" (default, honest completion:
                                   a one-element read) or "none"
* ``QRACK_SERVE_CHECKPOINT_DIR``   enable the checkpoint subsystem
                                   rooted at this directory (default
                                   off): idle eviction spills instead
                                   of discarding, submissions journal
                                   to a WAL, the kernel libraries build
                                   into <dir>/kernel_cache and batch
                                   shapes are recorded for the warm
                                   start (checkpoint/warmstart.py)
* ``QRACK_SERVE_SPILL_MAX_MB``     spill-store size bound (default 512)
* ``QRACK_SERVE_RECOVER``          "1": replay the live-session
                                   manifest + WAL from a crashed
                                   process at startup
* ``QRACK_SERVE_PREWARM``          "1": rebuild recorded programs at
                                   startup (warm time-to-first-result)
* ``QRACK_SERVE_CANARY_RATE``      fraction of circuit jobs re-verified
                                   against the CPU oracle off the
                                   dispatch-owner thread (default 0 =
                                   off; serve/canary.py)
* ``QRACK_SERVE_HOLD_LEASE``       "0": never park the store's recovery
                                   lease across serving — it is taken
                                   around recover()/adoption only
                                   (fleet workers)
* ``QRACK_SERVE_PREFIX``           "0": disable the prefix-sharing COW
                                   ket cache (byte-for-byte pre-cache
                                   behavior).  Default on: submits
                                   against pristine sessions split at
                                   the longest cached unitary prefix,
                                   the engine is seeded with a copy of
                                   the shared planes, and only the
                                   per-tenant suffix executes
                                   (serve/prefix_cache.py)
* ``QRACK_SERVE_PREFIX_BYTES``     resident prefix-cache budget
                                   (default 256 MiB; evicts by
                                   bytes×recency, spilling to the
                                   checkpoint store when one is
                                   configured)
* ``QRACK_SERVE_PREFIX_MIN_REFS``  recent lookups before a missed
                                   prefix is materialized + inserted
                                   (default 2)
* ``QRACK_SERVE_PREFIX_MIN_GATES`` shortest prefix worth splitting
                                   (default 4)
* ``QRACK_SERVE_CKPT_EVERY_JOB``   "1": snapshot a session's state at
                                   each mutating job's settle — BEFORE
                                   a circuit job's WAL entry is
                                   removed, and after collapsing /
                                   rng-consuming reads (measure_all,
                                   sample) — so a kill -9 at ANY
                                   instant leaves either a clean
                                   snapshot + pending entry (replay
                                   exact) or a snapshot that already
                                   contains the job — never a stale
                                   base

Serving is NOT imported by ``import qrack_tpu_torch``, so the library
path costs nothing when this subsystem is unused — and the checkpoint
package only loads when a checkpoint dir is configured.
"""

from __future__ import annotations

import os
import socket
import uuid
from typing import Callable, Optional, Sequence, Union

from .. import telemetry as _tele
from ..resilience import breaker as _breaker
from .batcher import stats as _batch_stats
from .errors import SessionNotFound
from .executor import Executor
from .scheduler import Job, JobHandle, Scheduler
from .session import HOST_TERMINALS, SessionManager, planes_engine, terminal


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# WAL-entry tag prefix marking a journaled trajectory job; the suffix is
# the JSON spec (B, key, NoiseModel) recover() re-runs deterministically
# (noise/trajectories.py)
TRAJ_TAG = "::traj::"


def _fold_key(sess) -> tuple:
    """The planes' dtype and device: the part of a batch key the JAX
    package, whose plane dtype is global, does not need.  A routed
    session planned dense but not built yet keys on what its dense
    stack will be built with."""
    eng = planes_engine(sess.engine)
    if eng is not None:
        return (str(eng.dtype), str(eng.device))
    from ..config import get_config
    from ..ops import gatekernels as gk

    dtype = sess.engine._kwargs.get("dtype")
    dtype = gk.plane_dtype(get_config().device_real_dtype()
                           if dtype is None else dtype)
    return (str(dtype), str(sess.engine.device))


class QrackService:
    def __init__(self, engine_layers: Union[str, Sequence[str]] = "cuda",
                 *, max_depth: Optional[int] = None,
                 batch_window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 queue_budget_ms: Optional[float] = None,
                 idle_evict_s: Optional[float] = None,
                 tick_s: float = 0.25,
                 checkpoint_dir: Optional[str] = None,
                 spill_max_mb: Optional[float] = None,
                 recover: Optional[bool] = None,
                 prewarm: Optional[bool] = None,
                 hold_lease: Optional[bool] = None,
                 checkpoint_every_job: Optional[bool] = None,
                 pipeline: Optional[bool] = None,
                 aging_s: Optional[float] = None,
                 **engine_kwargs):
        if max_depth is None:
            max_depth = int(_env_float("QRACK_SERVE_MAX_DEPTH", 64))
        if batch_window_ms is None:
            batch_window_ms = _env_float("QRACK_SERVE_BATCH_WINDOW_MS", 2.0)
        if max_batch is None:
            max_batch = int(_env_float("QRACK_SERVE_MAX_BATCH", 8))
        if queue_budget_ms is None:
            queue_budget_ms = _env_float("QRACK_SERVE_QUEUE_BUDGET_MS", 2000.0)
        if idle_evict_s is None:
            idle_evict_s = _env_float("QRACK_SERVE_IDLE_EVICT_S", 0.0)
        if checkpoint_dir is None:
            checkpoint_dir = os.environ.get(
                "QRACK_SERVE_CHECKPOINT_DIR") or None
        if recover is None:
            recover = os.environ.get("QRACK_SERVE_RECOVER", "0") == "1"
        if prewarm is None:
            prewarm = os.environ.get("QRACK_SERVE_PREWARM", "0") == "1"
        if hold_lease is None:
            hold_lease = os.environ.get("QRACK_SERVE_HOLD_LEASE", "1") == "1"
        if checkpoint_every_job is None:
            checkpoint_every_job = os.environ.get(
                "QRACK_SERVE_CKPT_EVERY_JOB", "0") == "1"
        if pipeline is None:
            pipeline = os.environ.get("QRACK_SERVE_PIPELINE", "1") != "0"
        if aging_s is None:
            aging_s = _env_float("QRACK_SERVE_AGING_S", 1.0)
        if terminal(engine_layers) not in HOST_TERMINALS:
            # sessions land on the card unless the caller names the CPU
            from ..utils.device import resolve_device

            resolve_device(engine_kwargs.get("device"))
        # fleet workers run hold_lease=False: the store lease is only
        # taken around recover()/adoption, never parked across serving,
        # so N workers sharing one store never block a peer's adoption
        self._hold_lease = bool(hold_lease)
        self.default_layers = engine_layers
        self.default_engine_kwargs = engine_kwargs
        self.store = None
        self.program_manifest = None
        # recovery-lease identity: host+pid let a peer on the same host
        # detect a dead holder; the suffix disambiguates two services in
        # one process
        self._owner = (f"{socket.gethostname()}:{os.getpid()}:"
                       f"{uuid.uuid4().hex[:6]}")
        self.lease_held = False
        if checkpoint_dir:
            # the only import of the checkpoint package on the serve path —
            # the subsystem costs nothing unless a dir is configured
            from ..checkpoint.store import CheckpointStore
            from ..checkpoint.warmstart import (ProgramManifest,
                                                enable_warm_start)
            from . import batcher as _batcher_mod

            if spill_max_mb is None:
                spill_max_mb = _env_float("QRACK_SERVE_SPILL_MAX_MB", 512.0)
            # with a snapshot at every job, each session's state file is
            # its recovery copy: the spill budget may not evict it
            self.store = CheckpointStore(
                checkpoint_dir, max_bytes=int(spill_max_mb * 1024 * 1024),
                keep_states=bool(checkpoint_every_job))
            enable_warm_start(os.path.join(checkpoint_dir, "kernel_cache"))
            # device-class fingerprint lands next to kernel_cache — the
            # substrate the roofline ledger reads when no live device is
            # probeable
            from ..telemetry import roofline as _roofline
            _roofline.persist_fingerprint(checkpoint_dir)
            self.program_manifest = ProgramManifest(
                os.path.join(checkpoint_dir, "programs"))
            _batcher_mod.set_manifest(self.program_manifest)
        self.sessions = SessionManager(idle_evict_s=idle_evict_s,
                                       spill_store=self.store)
        # prefix-sharing COW ket cache (serve/prefix_cache.py): N
        # tenants submitting circuits with a common state-prep prefix
        # pay its execution once.  QRACK_SERVE_PREFIX=0 restores
        # pre-cache behavior byte-for-byte — no cache object exists and
        # submit never splits.
        self.prefix_cache = None
        if os.environ.get("QRACK_SERVE_PREFIX", "1") != "0":
            from .prefix_cache import PrefixCache

            self.prefix_cache = PrefixCache(store=self.store)
            # the router's HBM budget must see cached planes as
            # already-committed bytes, or admission over-commits the
            # device by exactly the cache's resident set
            from ..route import cost as _cost

            _cost.set_hbm_reservation(self.prefix_cache.resident_bytes)
        self.scheduler = Scheduler(max_depth=max_depth,
                                   queue_budget_s=queue_budget_ms / 1e3,
                                   batch_window_s=batch_window_ms / 1e3,
                                   max_batch=max_batch,
                                   aging_s=aging_s)
        sync = os.environ.get("QRACK_SERVE_SYNC", "devget") != "none"
        self.canary = None
        canary_rate = _env_float("QRACK_SERVE_CANARY_RATE", 0.0)
        if canary_rate > 0:
            # sampled oracle-replay verification (serve/canary.py);
            # off by default — the verifier thread
            # only exists when a rate is configured
            from .canary import CanaryVerifier

            self.canary = CanaryVerifier(canary_rate)
        self.executor = Executor(self.scheduler, self.sessions,
                                 tick_s=tick_s, sync=sync,
                                 canary=self.canary,
                                 checkpoint_every_job=(
                                     checkpoint_every_job
                                     and self.store is not None),
                                 pipeline=pipeline,
                                 prefix_cache=self.prefix_cache)
        self.executor.start()
        self._closed = False
        if self.store is not None and self._hold_lease:
            # best-effort: a second process sharing the store serves its
            # own sessions fine without the lease — only recover/adopt
            # (WAL replay exclusivity) requires holding it
            self.lease_held = self.store.acquire_lease(self._owner)
        if self.store is not None and recover:
            try:
                self.recover()
            except BaseException:
                # don't leak the daemon executor thread when startup
                # recovery is refused (e.g. StoreLeaseHeld)
                self.close()
                raise
        if self.program_manifest is not None and prewarm:
            self.prewarm()

    # -- session lifecycle ---------------------------------------------

    def create_session(self, width: int, layers=None,
                       seed: Optional[int] = None, timeout: float = 60.0,
                       sid: Optional[str] = None, weight: float = 1.0,
                       **engine_kwargs) -> str:
        """Build a tenant session (engine constructed on the dispatch
        owner — construction is device traffic) and return its id.
        `sid` pins an explicit id — the fleet front door passes one so
        sids stay globally unique across N workers sharing a store.
        `weight` is the tenant's weighted-round-robin share (scheduler
        fairness: a weight-2 tenant gets twice the lane of weight-1)."""
        layers = self.default_layers if layers is None else layers
        kwargs = {**self.default_engine_kwargs, **engine_kwargs}
        job = Job(None, "admin",
                  fn=lambda: self.sessions.create(width, layers=layers,
                                                  seed=seed, sid=sid,
                                                  weight=weight,
                                                  **kwargs))
        self.scheduler.submit(job)
        return job.handle.result(timeout).sid

    def destroy_session(self, sid: str, timeout: float = 60.0) -> None:
        self.sessions.get(sid)  # typed SessionNotFound before queueing
        job = Job(None, "admin", fn=lambda: self.sessions.destroy(sid))
        self.scheduler.submit(job)
        job.handle.result(timeout)

    # -- job submission ------------------------------------------------

    def submit(self, sid: str, circuit, priority: int = 0,
               tag: Optional[str] = None) -> JobHandle:
        """Queue `circuit` against session `sid`; returns immediately
        with a JobHandle.  Raises typed admission errors (QueueFull /
        LoadShed / ServiceStopped / MisrouteError) synchronously.

        Routing admission: a session built on the ``"route"`` pseudo-
        layer gets its circuit classified and a stack decision recorded
        HERE (pure host work — route/router.py); the executor realizes
        the plan on the dispatch-owner thread before the job runs.
        ``QRACK_ROUTE=dense`` opts a deployment out (every decision
        pins dense); explicit stacks pin likewise.  A batch key carries
        the planes' dtype and device besides the JAX package's
        ``shape_key``, so only lanes that fold together co-batch."""
        sess = self.sessions.get(sid)
        routed = getattr(sess.engine, "_is_routed", False)
        if routed and circuit.gates:
            from ..route import admit as _route_admit

            _route_admit(sess.engine, circuit)  # may raise MisrouteError
        shape_key = None
        if circuit.gates:
            if planes_engine(sess.engine) is not None:
                shape_key = circuit.shape_key(sess.width) + _fold_key(sess)
            elif routed and sess.engine.plans_dense():
                # dense-routed but not built yet: key the job anyway so
                # routed jobs still bucket+batch by stack+shape
                shape_key = circuit.shape_key(sess.width) + _fold_key(sess)
            elif routed and sess.engine.plans_lightcone():
                # lightcone-routed: key on the SLICED sub-circuit digest
                # at cone width, not the declared width — two w50+
                # tenants running the same local structure at different
                # offsets share a bucket (they never co-batch — no
                # planes engine — but admission telemetry and scheduler
                # affinity see the shape that actually executes)
                from ..lightcone.engine import sliced_shape_key

                shape_key = sliced_shape_key(circuit)
        # prefix-cache admission split: only a PRISTINE session (engine
        # still |0…0⟩) can be seeded from a shared prefix, and only a
        # plane-backed engine can take the seed.  The WAL below always
        # journals the FULL circuit — recovery replays from |0…0⟩ and
        # needs no cache to be exact.
        full_circuit = circuit
        prefix = None
        if (self.prefix_cache is not None and circuit.gates
                and sess.pristine
                and planes_engine(sess.engine) is not None):
            prefix = self.prefix_cache.plan(circuit, sess.width)
        if circuit.gates:
            # the engine is about to leave |0…0⟩; later submits against
            # this session must run their circuits in full
            sess.pristine = False
        if prefix is not None:
            kind, k, ref = prefix
            digest = ref.digest if kind == "hit" else ref
            pre_circ, circuit = circuit.split_at(k)
            if circuit.gates:
                # suffixes co-batch only with same-prefix same-suffix
                # peers: the digest in the key keeps a split job from
                # ever joining an unsplit batch of the same shape
                shape_key = (sess.width, digest,
                             len(circuit.gates).bit_length(),
                             circuit.structure_digest()) + _fold_key(sess)
            else:
                # whole circuit is the prefix: run as a singleton (the
                # seed IS the job; an empty batched program buys nothing)
                shape_key = None
        job = Job(sess, "circuit", circuit=circuit, shape_key=shape_key,
                  priority=priority)
        if prefix is not None:
            job.prefix_len = k
            job.prefix_digest = digest
            job.prefix_circuit = pre_circ
            if kind == "hit":
                job.prefix_entry = ref
            else:
                job.prefix_insert = True
        job.tag = tag
        if self.store is not None:
            # journal BEFORE admission (the executor may settle the job
            # the instant it is queued); the executor deletes the entry
            # at completion, a refusal deletes it below — so entries
            # still on disk at startup are exactly the crash-interrupted
            # jobs recover() re-runs.
            job.wal_path = self.store.wal_append(sid, full_circuit, tag=tag)
        sess.begin_job()
        try:
            return self.scheduler.submit(job)
        except BaseException:
            sess.end_job(ok=False)
            if job.wal_path is not None:
                self.store.wal_remove(job.wal_path)
                job.wal_path = None
            raise

    def call(self, sid: str, fn: Callable, priority: int = 0,
             mutates: bool = True) -> JobHandle:
        """Queue an arbitrary engine call `fn(engine)` — the escape
        hatch every synchronous read routes through, so reads share the
        dispatch owner with circuit traffic.

        `mutates=False` declares `fn` a pure read (no collapse, no rng
        draw): the session's on-disk snapshot stays valid across it, so
        checkpointing neither dirties nor re-snapshots the session.  A
        mutating call under ``checkpoint_every_job`` snapshots at settle
        exactly like a circuit job — otherwise a measure that collapses
        state after the last snapshot would silently flip the session
        to the stale-recovery path and drop any journaled-but-pending
        circuit at adoption.  Default: mutating."""
        sess = self.sessions.get(sid)
        if mutates:
            # collapse or rng draw: the engine leaves |0…0⟩ (or its rng
            # stream moves), so prefix seeding is off for this session
            sess.pristine = False
        job = Job(sess, "call", fn=fn, priority=priority, mutates=mutates)
        sess.begin_job()
        try:
            return self.scheduler.submit(job)
        except BaseException:
            sess.end_job(ok=False)
            raise

    def submit_trajectories(self, sid: str, circuit, model,
                            trajectories: int, *, key: int = 0,
                            priority: int = 0,
                            tag: Optional[str] = None) -> JobHandle:
        """Queue a Monte-Carlo trajectory batch: B noisy unravelings of
        `circuit` under NoiseModel `model`, run as batched (chunked)
        passes on the session's device (noise/trajectories.py).  The
        handle resolves to a
        :class:`~qrack_tpu_torch.noise.TrajectoryResult` — per-trajectory
        samples/expectations plus the channel-averaged aggregate.

        Pricing is per-trajectory-batch, not per-ket: the router
        features carry ``shots=B``, so B·16·2^w is compared against the
        HBM budget and the batch is CHUNKED down to fit rather than
        admitted at full resident size (route.traj.* gauges).  The
        trajectory axis is pre-stacked: the job is structurally
        non-batchable, so the batcher can never join two tenants into
        one trajectory batch.

        Journal + recovery: the WAL entry carries the circuit plus a
        trajectory spec tag (B, key, model).  Because every trajectory's
        randomness is the (key, trajectory_id, app_seq) counters, a
        crash-interrupted job replays bit-identically at recover() —
        the "rng position" IS the counter coordinate, nothing else to
        persist."""
        sess = self.sessions.get(sid)
        B = int(trajectories)
        from ..noise import trajectories as _traj
        from ..route import cost as _cost
        from ..route import features as _feat

        width = sess.width
        device = self._device_of(sess)
        knobs = _cost.RouteKnobs.for_device(device)
        if width > knobs.dense_max_qb:
            from ..route.router import MisrouteError

            raise MisrouteError(
                f"trajectory batch needs dense planes: width {width} > "
                f"dense cap {knobs.dense_max_qb}")
        f = _feat.extract_features(circuit, width, shots=B)
        batch_bytes = _cost.hbm_bytes("dense", f, knobs)
        budget = _cost.hbm_budget_bytes(knobs)
        chunk = _traj.traj_chunk(width, B, device=device)
        if _tele._ENABLED:
            _tele.gauge("route.traj.hbm_bytes", batch_bytes)
            _tele.gauge("route.traj.chunk", chunk)
            if batch_bytes > budget:
                _tele.inc("route.traj.chunked")

        def run(engine):
            return _traj.run_trajectories(circuit, model, B, width=width,
                                          key=key, device=device)

        job = Job(sess, "trajectories", fn=run, priority=priority,
                  mutates=False)
        job.tag = tag
        if self.store is not None:
            import json as _json

            spec = _json.dumps({"B": B, "key": int(key),
                                "model": model.to_dict(), "tag": tag},
                               sort_keys=True)
            job.wal_path = self.store.wal_append(sid, circuit,
                                                 tag=TRAJ_TAG + spec)
        sess.begin_job()
        try:
            return self.scheduler.submit(job)
        except BaseException:
            sess.end_job(ok=False)
            if job.wal_path is not None:
                self.store.wal_remove(job.wal_path)
                job.wal_path = None
            raise

    def _device_of(self, sess):
        """The device a session's batched side work (trajectories) runs
        on: its ``device=``, else the card."""
        from ..utils.device import resolve_device

        return resolve_device(sess.engine_kwargs.get("device"))

    def apply(self, sid: str, circuit, priority: int = 0,
              timeout: Optional[float] = 120.0):
        return self.submit(sid, circuit, priority=priority).result(timeout)

    # -- synchronous reads (all via the dispatch owner) ----------------

    def get_state(self, sid: str, timeout: Optional[float] = 120.0):
        return self.call(sid, lambda eng: eng.GetQuantumState(),
                         mutates=False).result(timeout)

    def measure_all(self, sid: str, timeout: Optional[float] = 120.0) -> int:
        # MAll collapses the state AND advances the rng stream
        return self.call(sid, lambda eng: eng.MAll(),
                         mutates=True).result(timeout)

    def sample(self, sid: str, shots: int, qubits=None,
               timeout: Optional[float] = 120.0):
        def do(eng):
            qs = range(eng.qubit_count) if qubits is None else qubits
            return eng.MultiShotMeasureMask([1 << q for q in qs], shots)

        # non-collapsing, but the categorical draws consume the rng
        # stream — a snapshot from before the sample would replay with
        # a rewound stream, so it counts as mutating
        return self.call(sid, do, mutates=True).result(timeout)

    def prob(self, sid: str, qubit: int,
             timeout: Optional[float] = 120.0) -> float:
        return self.call(sid, lambda eng: eng.Prob(qubit),
                         mutates=False).result(timeout)

    # -- checkpoint / recovery -----------------------------------------

    def checkpoint_session(self, sid: str, timeout: float = 120.0) -> str:
        """Persist `sid`'s full state (rng stream included) without
        evicting it — capture is non-mutating, the session keeps
        serving.  Returns the container path."""
        if self.store is None:
            raise RuntimeError("checkpointing is not enabled "
                               "(QRACK_SERVE_CHECKPOINT_DIR)")
        sess = self.sessions.get(sid)

        def do():
            if sess.spilled:  # already durable
                return self.store._state_path(sid)
            return self.store.save(sid, sess.engine)

        job = Job(None, "admin", fn=do)
        self.scheduler.submit(job)
        return job.handle.result(timeout)

    def checkpoint_all(self, timeout: float = 600.0) -> list:
        """Persist every live session as ONE admin job, so no tenant job
        interleaves between snapshots: the set is a consistent
        point-in-time cut (the executor owns all dispatch)."""
        if self.store is None:
            raise RuntimeError("checkpointing is not enabled "
                               "(QRACK_SERVE_CHECKPOINT_DIR)")

        def do():
            paths = []
            for sid in self.sessions.ids():
                sess = self.sessions.get(sid)
                if sess.spilled:  # already durable
                    paths.append(self.store._state_path(sid))
                else:
                    paths.append(self.store.save(sid, sess.engine))
            return paths

        job = Job(None, "admin", fn=do)
        self.scheduler.submit(job)
        return job.handle.result(timeout)

    def recover(self, timeout: float = 600.0,
                sids: Optional[Sequence[str]] = None) -> dict:
        """Rebuild the previous process's sessions from the store's
        live-session manifest (under their original ids), load any
        persisted state, and re-run crash-interrupted WAL jobs in
        submit order.  Runs as one admin job on the dispatch owner.

        With `sids`, adoption is SCOPED: only the named sessions are
        rebuilt and only THEIR journal entries are replayed and cleared
        — the fleet re-placement path, where N live workers share one
        store and a peer adopts exactly the dead worker's sessions
        without touching anyone else's manifest records or pending WAL
        entries.  When the service was built with
        ``hold_lease=False``, the lease is taken for the adoption and
        released the moment it completes.

        WAL replay is only exact when the rebuilt base provably matches
        the state the job was submitted against: either the on-disk
        snapshot captures everything the session completed (manifest
        ``dirty`` flag clear), or the session never completed a job
        (fresh |0..0> IS the base).  A session whose completed work was
        never persisted is rebuilt cold with its WAL entries dropped and
        its sid reported under ``recovered_stale`` so the caller can
        reset or notify the tenant instead of silently serving a state
        that matches neither pre-crash nor fresh.

        Recovery requires the store's ownership lease: two processes
        sharing a checkpoint dir must never both replay the same WAL.
        Raises :class:`~qrack_tpu_torch.checkpoint.StoreLeaseHeld` while a
        live peer holds it — drain or stop that process first."""
        if self.store is None:
            raise RuntimeError("checkpointing is not enabled "
                               "(QRACK_SERVE_CHECKPOINT_DIR)")
        if not self.lease_held:
            self.lease_held = self.store.acquire_lease(self._owner)
        if not self.lease_held:
            from ..checkpoint.store import StoreLeaseHeld

            lease = self.store.lease_info() or {}
            raise StoreLeaseHeld(
                "recovery refused: store lease held by "
                f"{lease.get('owner', '<unknown>')} — drain or stop that "
                "process before adopting its sessions")

        def do():
            # re-read the shared manifest under the cross-process lock:
            # a draining peer may have handed sessions over since our
            # constructor snapshotted it
            self.store.reload()
            recovered, stale, replayed, skipped, deduped = [], [], 0, 0, 0
            wal_high: dict = {}
            # snapshot the manifest first: re-creating a session below
            # re-registers it, which resets its dirty flag and wal_high
            live = set(self.sessions.ids())
            for sid, rec in sorted(self.store.sessions().items()):
                if sids is not None and sid not in sids:
                    continue
                if sid in live:
                    continue  # already served here — nothing to adopt
                dirty = bool(rec.get("dirty", False))
                # the state container's own wal_high is authoritative:
                # it commits in the same atomic replace as the state,
                # while the manifest copy lags one write behind (a kill
                # between the two used to replay an already-contained
                # WAL entry — the double-apply the kill9 test caught)
                wal_high[sid] = max(int(rec.get("wal_high", -1)),
                                    self.store.state_wal_high(sid))
                kwargs = {**self.default_engine_kwargs,
                          **rec.get("engine_kwargs", {})}
                sess = self.sessions.create(
                    rec["width"], layers=rec["layers"], seed=rec["seed"],
                    sid=sid, **kwargs)
                if self.store.has_state(sid):
                    sess.engine = self.store.load(sid, into=sess.engine)
                    sess.pristine = False  # mid-stream, not |0…0⟩
                    self.store.drop_state(sid)
                    # the disk copy was just consumed; the restored
                    # state now lives only in memory
                    self.store.mark_dirty(sid)
                if dirty:
                    stale.append(sid)
                    self.store.mark_dirty(sid)
                recovered.append(sid)
            stale_set = set(stale)
            scope = None if sids is None else recovered
            trajectories = {}
            for sid, seq, circuit, meta in self.store.wal_entries(
                    sids=scope, with_meta=True):
                try:
                    sess = self.sessions.get(sid)
                except SessionNotFound:
                    continue
                entry_tag = str(meta.get("tag") or "")
                if entry_tag.startswith(TRAJ_TAG):
                    # journaled trajectory job: session state is not its
                    # base (trajectories run on fresh batch kets), so it
                    # replays even for stale sessions, and its rng
                    # positions are the (key, trajectory_id, app_seq)
                    # counters in the spec — bit-identical re-run
                    import json as _json

                    from ..noise import run_trajectories
                    from ..noise.channels import NoiseModel

                    spec = _json.loads(entry_tag[len(TRAJ_TAG):])
                    res = run_trajectories(
                        circuit, NoiseModel.from_dict(spec["model"]),
                        int(spec["B"]), width=sess.width,
                        key=int(spec["key"]),
                        device=self._device_of(sess))
                    trajectories.setdefault(sid, []).append(res)
                    replayed += 1
                    continue
                if sid in stale_set:
                    skipped += 1  # base is wrong — replay would be too
                    continue
                if seq <= wal_high.get(sid, -1):
                    # the snapshot already contains this entry's effect
                    # (crash landed between snapshot and WAL settle) —
                    # replaying would double-apply
                    deduped += 1
                    continue
                circuit.Run(sess.engine)
                sess.pristine = False
                self.store.mark_dirty(sid)
                replayed += 1
            self.store.clear_wal(sids=scope)
            return {"sessions": recovered, "wal_replayed": replayed,
                    "wal_skipped": skipped, "wal_deduped": deduped,
                    "recovered_stale": stale,
                    "trajectories": trajectories}

        job = Job(None, "admin", fn=do)
        try:
            self.scheduler.submit(job)
            return job.handle.result(timeout)
        finally:
            if not self._hold_lease:
                self.release_lease()

    def drain(self, timeout: float = 600.0,
              sids: Optional[Sequence[str]] = None) -> dict:
        """Hand every idle session over to the checkpoint plane: persist
        its state, keep its manifest record on disk, and release it from
        THIS process — a peer sharing the store adopts the set with
        ``recover=True``.  Sessions with jobs still
        in flight are reported ``busy`` and kept.  When nothing stays
        behind, the recovery lease is released so the adopter's
        ``recover()`` is admitted immediately.  Runs as ONE admin job so
        no tenant job interleaves: the handed-over set is a consistent
        point-in-time cut.  With `sids`, only the named sessions are
        drained — the fleet live-migration path."""
        if self.store is None:
            raise RuntimeError("checkpointing is not enabled "
                               "(QRACK_SERVE_CHECKPOINT_DIR)")

        def do():
            drained, busy = [], []
            for sid in self.sessions.ids():
                if sids is not None and sid not in sids:
                    continue
                sess = self.sessions.get(sid)
                if sess.inflight > 0:
                    busy.append(sid)
                    continue
                if not sess.spilled:  # spilled = already durable
                    self.store.save(sid, sess.engine)
                # stop overlaying the record on future manifest writes
                # (the adopter owns it now), then forget it locally
                self.store.disown(sid)
                self.sessions.release(sid)
                drained.append(sid)
            if self.prefix_cache is not None and not busy:
                # warm handoff: spilled prefix entries land in the
                # store's prefix/ tier, so the adopter's cache starts
                # warm (PrefixCache._adopt_spilled)
                self.prefix_cache.evict_all(spill=True)
            if not busy and self.lease_held and not self.sessions.ids():
                self.store.release_lease(self._owner)
                self.lease_held = False
            if _tele._ENABLED:
                _tele.inc("serve.drained", len(drained))
                _tele.event("serve.drain", drained=len(drained),
                            busy=len(busy))
            return {"drained": drained, "busy": busy}

        job = Job(None, "admin", fn=do)
        self.scheduler.submit(job)
        return job.handle.result(timeout)

    def prewarm(self, timeout: float = 600.0) -> int:
        """Rebuild every batch program the manifest recorded (admin job:
        packing operands and the first fold are device traffic).  With
        the kernel libraries already in the store's kernel_cache, a
        recovered process reaches its first result without an nvcc
        build or a cold program."""
        if self.program_manifest is None:
            return 0
        job = Job(None, "admin", fn=self.program_manifest.prewarm)
        self.scheduler.submit(job)
        return job.handle.result(timeout)

    def release_lease(self) -> bool:
        """Drop the store's recovery lease if this service holds it.
        Fleet workers (``hold_lease=False``) call this after any
        adoption so a peer's next recover() is admitted immediately."""
        if self.store is None or not self.lease_held:
            return False
        released = self.store.release_lease(self._owner)
        self.lease_held = False
        return released

    # -- introspection / lifecycle -------------------------------------

    def stats(self) -> dict:
        out = {
            "sessions": self.sessions.stats(),
            "queue_depth": self.scheduler.depth(),
            "breaker": _breaker.get_breaker().snapshot(),
            "batch_programs": _batch_stats(),
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self.store is not None:
            out["checkpoint_store"] = self.store.stats()
            out["lease"] = {"owner": self._owner,
                            "held": self.lease_held,
                            "store": self.store.lease_info()}
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.scheduler.stop()
        self.executor.stop()
        if self.prefix_cache is not None:
            # executor thread is down — this thread owns the device now,
            # so the spill's host copy is safe here
            try:
                self.prefix_cache.evict_all(spill=self.store is not None)
            except Exception:  # noqa: BLE001 — close never raises
                pass
            from ..route import cost as _cost

            _cost.set_hbm_reservation(None)
        if self.canary is not None:
            self.canary.stop()
        if self.store is not None and self.lease_held:
            try:
                self.store.release_lease(self._owner)
            except Exception:  # noqa: BLE001 — close never raises
                pass
            self.lease_held = False

    def __enter__(self) -> "QrackService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


__all__ = ["QrackService", "SessionNotFound"]
