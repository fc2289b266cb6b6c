"""Fleet supervisor: spawn, watch, restart, and migrate N workers (the
port of the JAX package's fleet/supervisor.py).

One supervisor process owns the fleet's control plane.  It never
initializes CUDA and imports no engine: each worker
(``python -m qrack_tpu_torch.fleet.worker``) owns its own context on
the card, and the default ``layers`` is the port's dense terminal
``"cuda"`` (the JAX supervisor's is ``"cpu"``), so a fleet runs on the
card unless the caller names the CPU (``layers="cpu"``, or
``engine_kwargs='{"device": "cpu"}'`` for dense sessions).

* **liveness** — every monitor tick checks each worker twice: pid
  death via its Popen handle (instant; catches kill -9) and heartbeat
  age against ``beat_s * deadline_beats`` (catches live-but-wedged —
  fleet/heartbeat.py).  A missed-beat worker is SIGKILLed first so the
  two paths converge on one death-handling routine.
* **adoption before restart** — a dead worker's sessions are evicted
  from placement, re-placed first-fit-decreasing onto healthy peers,
  and each adopter runs the store's scoped recovery
  (``QrackService.recover(sids=...)``) under the store lease: snapshot
  restore + WAL replay with wal_high dedup = zero loss, exactly once.
  The dead worker's pending WAL tags are recorded BEFORE adoption so
  the front door can answer "was my unacked submit adopted?" without
  guessing.  While a sid is between owners it sits in
  the migrating set and :meth:`route` returns None — the front door's
  signal to wait, not error.
* **restart discipline** — each worker carries its own
  :class:`~qrack_tpu_torch.resilience.breaker.CircuitBreaker` as a restart
  budget: every crash is a recorded failure and restarts back off
  exponentially; ``threshold`` crashes OPEN it and the worker is
  QUARANTINED — placement stops routing to it and no respawn happens
  until the cooldown lets the breaker half-open, at which point
  exactly one probe restart is attempted.  A worker that stays ready
  ``stable_s`` closes its breaker.
* **rolling restart** — drain (sessions handed to peers via the same
  adoption plane), SIGTERM, reap (probe.py's SIGTERM→SIGKILL ladder),
  respawn, wait ready — one worker at a time, so capacity never drops
  by more than one worker and no session is ever lost or paused longer
  than one adoption.

The monitor never holds the placement lock across process waits or
RPC: detection runs under the lock, actions (kill, adopt, respawn)
outside it, so the front door keeps routing unaffected sessions while
a death is being handled.

Fault hooks (resilience/faults.py): ``fleet.worker:kill:after_n``
makes the monitor SIGKILL one healthy worker (the chaos-monkey the
soak uses); ``fleet.heartbeat:hang`` is acted out worker-side;
``fleet.spawn:hang`` / ``fleet.spawn:raise`` wedge or kill a worker
boot (the autoscaler's scale-up failure lanes) — a hung spawn is acted
out by launching a sleeper process in the worker's place, so the boot
times out, the sleeper is reaped, and the crash charges the new
worker's restart budget like any other boot failure.

With an :class:`~qrack_tpu_torch.fleet.autoscaler.AutoscaleConfig` passed as
``autoscale=``, the monitor tick also drives the demand-driven scaler
(fleet/autoscaler.py): :meth:`pressure` is its sensor,
:meth:`boot_worker` / :meth:`scale_down` its actuators, and
:meth:`set_brownout` the graceful-degradation broadcast between
"overloaded" and "scaled".

Beyond the JAX supervisor, the port keeps the times a chip run reads:
each handle's ``spawned_at``/``ready_at`` (boot to ready), a bounded
record of deaths (``stats()["deaths"]``: detection, adoption, reason)
and the parts of each rolling restart (drain, SIGTERM and reap, adopt,
respawn to ready).
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import telemetry as _tele
from ..resilience.breaker import CircuitBreaker
from ..resilience.probe import reap_child
from .heartbeat import (DEFAULT_DEADLINE_BEATS, DEFAULT_INTERVAL_S,
                        read_heartbeat)
from .placement import Placement, session_cost
from .rpc import FleetClient, FleetRemoteError, FleetRPCError

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

DEFAULT_RESTART_THRESHOLD = 3      # crashes before quarantine
DEFAULT_RESTART_COOLDOWN_S = 10.0  # quarantine length before one probe
DEFAULT_BACKOFF_BASE_S = 0.25
DEFAULT_BACKOFF_CAP_S = 5.0
DEFAULT_STABLE_S = 10.0            # ready this long -> breaker closes


class WorkerHandle:
    def __init__(self, name: str, socket_path: str, hb_path: str,
                 log_path: str, threshold: int, cooldown_s: float):
        self.name = name
        self.socket_path = socket_path
        self.hb_path = hb_path
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.client = FleetClient(socket_path)
        # the restart budget IS a circuit breaker: crash = failure,
        # open = quarantined, half-open = one probe restart
        self.breaker = CircuitBreaker(threshold=threshold,
                                      cooldown_s=cooldown_s)
        self.crashes = 0           # lifetime, for stats
        self.restarts = 0
        self.consecutive_crashes = 0
        self.ready_since: Optional[float] = None
        self.next_restart_at = 0.0
        self.restarting = False    # a respawn owns this handle right now
        # monotonic times of the last spawn and the readiness it reached
        self.spawned_at: Optional[float] = None
        self.ready_at: Optional[float] = None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None


class FleetSupervisor:
    def __init__(self, n_workers: int, root: str, *,
                 store_dir: Optional[str] = None,
                 layers="cuda",
                 engine_kwargs=None,
                 beat_s: float = DEFAULT_INTERVAL_S,
                 deadline_beats: float = DEFAULT_DEADLINE_BEATS,
                 restart_threshold: int = DEFAULT_RESTART_THRESHOLD,
                 restart_cooldown_s: float = DEFAULT_RESTART_COOLDOWN_S,
                 backoff_base_s: float = DEFAULT_BACKOFF_BASE_S,
                 stable_s: float = DEFAULT_STABLE_S,
                 tick_s: float = 0.2,
                 ready_timeout_s: float = 180.0,
                 python: Optional[str] = None,
                 extra_env: Optional[dict] = None,
                 autoscale=None):
        self.root = os.path.abspath(root)
        self.store_dir = store_dir or os.path.join(self.root, "store")
        self.layers = layers
        # a JSON string or a dict of the workers' default engine kwargs
        self.engine_kwargs = (engine_kwargs if isinstance(engine_kwargs, str)
                              else json.dumps(engine_kwargs or {}))
        self.beat_s = beat_s
        self.deadline_s = beat_s * deadline_beats
        self.backoff_base_s = backoff_base_s
        self.stable_s = stable_s
        self.tick_s = tick_s
        self.ready_timeout_s = ready_timeout_s
        self.restart_threshold = restart_threshold
        self.restart_cooldown_s = restart_cooldown_s
        self.python = python or sys.executable
        self.extra_env = dict(extra_env or {})
        os.makedirs(self.store_dir, exist_ok=True)
        os.makedirs(os.path.join(self.root, "logs"), exist_ok=True)
        self.placement = Placement()
        self._lock = threading.RLock()
        self._workers: Dict[str, WorkerHandle] = {}
        self._adopted_tags: set = set()
        self._migrating: set = set()               # sids between owners
        # when each sid entered the migrating set — the front door's
        # bounded-wait deadline reads this to tell "adoption in flight,
        # keep waiting" from "owner permanently gone, error out"
        self._migrating_since: Dict[str, float] = {}
        # adoption batches whose adopter RPC failed: (adopter, sids,
        # not_before) — retried from the monitor tick until the sids
        # either adopt or move (their owner died and eviction re-placed
        # them); the sids stay in _migrating meanwhile so routing waits
        self._adopt_pending: List[Tuple[str, List[str], float]] = []
        self._session_meta: Dict[str, tuple] = {}  # sid -> (layers, width)
        self._kill_rr = 0
        # fleet observability plane: latest heartbeat-flushed telemetry
        # snapshot per worker INCARNATION (name, pid) — cumulative
        # snapshots keyed by incarnation merge correctly across
        # restarts with no delta/sequence bookkeeping — plus the
        # postmortem ring filled from dead workers' black boxes
        self._worker_tele: Dict[Tuple[str, int], dict] = {}
        # latest heartbeat record per LIVE worker — the autoscaler's
        # pressure sensor (queue_depth/inflight/staged ride every beat)
        self._last_beat: Dict[str, dict] = {}
        # brownout ladder state, written by the autoscaler and read by
        # the front door on every apply: {"level", "shed_band",
        # "retry_in_s"} or None when the fleet is healthy
        self._brownout: Optional[dict] = None
        self._postmortems: List[dict] = []
        self._postmortem_cap = 32
        # each death's detection and adoption times (monotonic), newest
        # last, bounded like the postmortem ring
        self._deaths: List[dict] = []
        # every incarnation's kernel launches, from its latest beat
        self._worker_kernels: Dict[Tuple[str, int], dict] = {}
        self.blackbox_dir = os.path.join(self.store_dir, "blackbox")
        self.telemetry_path = (os.environ.get("QRACK_FLEET_TELEMETRY_OUT")
                               or os.path.join(self.root,
                                               "fleet_telemetry.jsonl"))
        self._tele_flush_s = float(
            os.environ.get("QRACK_FLEET_TELEMETRY_FLUSH_S", "5.0"))
        self._tele_last_flush = time.monotonic()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # supervisor-side read-only store view (pending-tag scans);
        # built lazily so the checkpoint package only loads on first use
        self._store = None
        self._next_worker_idx = n_workers
        for i in range(n_workers):
            name = f"w{i}"
            self._workers[name] = self._new_handle(name)
            self.placement.add_worker(name)
        # closed-loop capacity: the monitor tick drives the scaler when
        # a config is supplied (fleet/autoscaler.py)
        self._autoscaler = None
        if autoscale is not None:
            from .autoscaler import Autoscaler, AutoscaleConfig

            cfg = (autoscale if isinstance(autoscale, AutoscaleConfig)
                   else AutoscaleConfig(**dict(autoscale)))
            self._autoscaler = Autoscaler(cfg)

    def _new_handle(self, name: str) -> WorkerHandle:
        return WorkerHandle(
            name,
            socket_path=os.path.join(self.root, f"{name}.sock"),
            hb_path=os.path.join(self.root, f"{name}.hb"),
            log_path=os.path.join(self.root, "logs", f"{name}.log"),
            threshold=self.restart_threshold,
            cooldown_s=self.restart_cooldown_s)

    def next_worker_name(self) -> str:
        """Mint a fleet-unique worker name (never reused: heartbeat and
        blackbox files are keyed by name+pid, stats by name)."""
        with self._lock:
            name = f"w{self._next_worker_idx}"
            self._next_worker_idx += 1
            return name

    # -- process plumbing ----------------------------------------------

    def _spawn(self, h: WorkerHandle) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        # fleet-wide warm artifacts: the shared store dir carries the
        # kernel libraries + ProgramManifest, and every worker rebuilds
        # its recorded programs at boot — a restarted worker's TTFR is
        # the warm number
        env.setdefault("QRACK_SERVE_PREWARM", "1")
        # enabling telemetry in the supervisor process lights up the
        # whole fleet plane: workers inherit the gate, flush snapshots
        # through their heartbeats, and keep flight recorders
        if _tele._ENABLED:
            env.setdefault("QRACK_TPU_TELEMETRY", "1")
        env.update(self.extra_env)
        for p in (h.hb_path, h.socket_path):
            try:
                os.unlink(p)
            except OSError:
                pass
        layers = (self.layers if isinstance(self.layers, str)
                  else ",".join(self.layers))
        cmd = [self.python, "-m", "qrack_tpu_torch.fleet.worker",
               "--socket", h.socket_path, "--store", self.store_dir,
               "--heartbeat", h.hb_path, "--name", h.name,
               "--layers", layers, "--beat-s", str(self.beat_s),
               "--engine-kwargs", self.engine_kwargs]
        # boot-failure chaos (resilience/faults.py): "raise" kills the
        # spawn at exec time (the InjectedFault propagates to the
        # caller's boot-failure path); "hang" swaps in a sleeper that
        # never heartbeats, so the boot wedges until wait_ready's
        # deadline reaps it — both charge the restart budget exactly
        # like an organic boot failure
        from ..resilience import faults as _faults

        directive = _faults.check("fleet.spawn")
        if directive == "hang":
            cmd = [self.python, "-c", "import time; time.sleep(3600)"]
        log = open(h.log_path, "ab")
        try:
            h.proc = subprocess.Popen(cmd, stdout=log, stderr=log, env=env)
        finally:
            log.close()
        h.ready_since = None
        h.spawned_at, h.ready_at = time.monotonic(), None
        if _tele._ENABLED:
            _tele.event("fleet.worker.spawn", worker=h.name, pid=h.proc.pid)

    def _is_ready(self, h: WorkerHandle) -> bool:
        rec = read_heartbeat(h.hb_path)
        return bool(rec is not None and rec.get("ready")
                    and not rec.get("draining")
                    and h.proc is not None and rec.get("pid") == h.proc.pid)

    def start(self) -> "FleetSupervisor":
        for h in self._workers.values():
            self._spawn(h)
        self.wait_ready(timeout_s=self.ready_timeout_s)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="fleet-monitor")
        self._monitor.start()
        return self

    def wait_ready(self, names: Optional[Sequence[str]] = None,
                   timeout_s: float = 180.0) -> None:
        deadline = time.monotonic() + timeout_s
        pending = set(names if names is not None else self._workers)
        while pending:
            for name in sorted(pending):
                h = self._workers[name]
                if self._is_ready(h):
                    h.ready_since = h.ready_at = time.monotonic()
                    pending.discard(name)
                elif h.proc is not None and h.proc.poll() is not None:
                    raise RuntimeError(
                        f"worker {name} exited rc={h.proc.returncode} "
                        f"during boot — see {h.log_path}")
            if not pending:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"workers not ready after {timeout_s}s: "
                    f"{sorted(pending)}")
            time.sleep(min(self.beat_s / 2, 0.25))

    # -- monitoring ----------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the monitor must survive
                if _tele._ENABLED:
                    _tele.inc("fleet.monitor.tick_error")

    def _tick(self) -> None:
        self._maybe_inject_kill()
        now = time.monotonic()
        deaths: List[Tuple[WorkerHandle, str]] = []
        restarts: List[WorkerHandle] = []
        probes: List[WorkerHandle] = []
        with self._lock:
            for h in self._workers.values():
                if h.restarting:
                    continue  # a respawn owns it; hands off
                state = self.placement.state(h.name)
                if state == "draining":
                    continue  # rolling restart owns it end-to-end
                if state == "dead":
                    if now >= h.next_restart_at:
                        restarts.append(h)
                    continue
                if state == "quarantined":
                    probes.append(h)
                    continue
                if h.proc is not None and h.proc.poll() is not None:
                    deaths.append((h, "exit"))
                    continue
                age = self._beat_age(h)
                if age is not None and age > self.deadline_s:
                    deaths.append((h, "missed-beats"))
                    continue
                if (h.ready_since is not None
                        and now - h.ready_since > self.stable_s):
                    h.breaker.record_success()
                    h.consecutive_crashes = 0
        # slow actions run OUTSIDE the lock: routing for unaffected
        # sessions must not stall behind a process wait or an RPC
        for h, reason in deaths:
            if reason == "missed-beats":
                # live pid, dead heart: converge on the one death path
                try:
                    h.proc.kill()
                    h.proc.wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            self._on_death(h, reason)
        for h in restarts:
            self._maybe_restart(h)
        for h in probes:
            self._maybe_probe_restart(h)
        self._retry_pending_adoptions()
        if self._autoscaler is not None:
            self._autoscaler.tick(self)
        self._maybe_flush_metrics()

    def _beat_age(self, h: WorkerHandle) -> Optional[float]:
        rec = read_heartbeat(h.hb_path)
        if rec is None or (h.proc is not None
                           and rec.get("pid") != h.proc.pid):
            # no beat from THIS incarnation yet: boot liveness is
            # covered by the pid check + wait_ready, not beat age
            return None
        with self._lock:
            # the liveness read doubles as the metrics ingest: no extra
            # RPC, no extra file — the beat we already parse carries the
            # worker's cumulative snapshot
            self._ingest(h, rec)
            # ... and as the autoscaler's pressure sensor: the latest
            # beat carries queue_depth/inflight/staged
            self._last_beat[h.name] = rec
        return time.time() - float(rec.get("t", 0.0))

    def _ingest(self, h: WorkerHandle, rec: Optional[dict]) -> None:
        """Keep a beat's cumulative telemetry snapshot and kernel
        launches under its incarnation.  Caller holds the lock."""
        if rec is None or rec.get("pid") is None:
            return
        key = (h.name, int(rec["pid"]))
        if rec.get("telemetry") is not None:
            self._worker_tele[key] = rec["telemetry"]
        if rec.get("kernels") is not None:
            self._worker_kernels[key] = rec["kernels"]

    def _maybe_inject_kill(self) -> None:
        try:
            from ..resilience import faults as _faults

            directive = _faults.check("fleet.worker")
        except Exception:  # noqa: BLE001 — raise-kinds meaningless here
            directive = None
        if directive != "kill":
            return
        with self._lock:
            healthy = self.placement.workers("healthy")
            if not healthy:
                return
            victim = self._workers[healthy[self._kill_rr % len(healthy)]]
            self._kill_rr += 1
        if victim.proc is not None:
            try:
                victim.proc.kill()
            except OSError:
                pass
        if _tele._ENABLED:
            _tele.event("fleet.fault.kill", worker=victim.name)

    # -- death / adoption / restart ------------------------------------

    def _mark_migrating(self, sids) -> None:
        """Caller holds the lock.  Stamps entry time so the front door
        can bound its wait (:meth:`migrating_since`)."""
        now = time.monotonic()
        for sid in sids:
            self._migrating.add(sid)
            self._migrating_since.setdefault(sid, now)

    def _unmark_migrating(self, sids) -> None:
        """Caller holds the lock."""
        for sid in sids:
            self._migrating.discard(sid)
            self._migrating_since.pop(sid, None)

    def migrating_since(self, sid: str) -> Optional[float]:
        """``time.monotonic()`` when `sid` entered the migrating set,
        or None when it is not migrating.  Direct ``_migrating``
        mutation (tests) falls back to "just now" so the bounded wait
        still engages."""
        with self._lock:
            if sid not in self._migrating:
                return None
            return self._migrating_since.get(sid, time.monotonic())

    def _record_crash(self, h: WorkerHandle) -> None:
        """Account one crash against `h`'s restart budget and arm the
        exponential respawn backoff.  Caller holds the lock.  Quarantine
        is decided at restart time by the breaker, not here."""
        h.crashes += 1
        h.consecutive_crashes += 1
        h.breaker.record_failure(site=f"fleet.{h.name}")
        delay = min(
            self.backoff_base_s * (2 ** (h.consecutive_crashes - 1)),
            DEFAULT_BACKOFF_CAP_S)
        h.next_restart_at = time.monotonic() + delay

    def _on_death(self, h: WorkerHandle, reason: str) -> None:
        with self._lock:
            if self.placement.state(h.name) == "dead":
                return  # already handled
            self._record_crash(h)
            self.placement.set_state(h.name, "dead")
            evicted = self.placement.evict(h.name)
            self._mark_migrating(sid for sid, _ in evicted)
            death = {"worker": h.name, "pid": h.pid, "reason": reason,
                     "detected_at": time.monotonic(), "adopted_at": None,
                     "sessions": [sid for sid, _ in evicted]}
            self._deaths.append(death)
            del self._deaths[:-self._postmortem_cap]
        if _tele._ENABLED:
            _tele.event("fleet.worker.dead", worker=h.name, reason=reason,
                        crashes=h.crashes)
        if evicted:
            self._adopt_from(h, evicted)
        with self._lock:
            death["adopted_at"] = time.monotonic()
        # autopsy AFTER adoption: tenant-visible migration latency owns
        # the fast path; the black box is durable and can wait
        self._collect_blackbox(h, reason)

    def _adopt_from(self, dead: WorkerHandle,
                    evicted: List[Tuple[str, float]]) -> None:
        """Re-place a dead worker's sessions and have each adopter run
        scoped recovery.  Slow path — takes the lock only for placement
        mutation, never across RPC."""
        sids = [sid for sid, _ in evicted]
        try:
            tags = self._store_view().wal_pending_tags(sids=sids)
        except Exception:  # noqa: BLE001 — tags are advisory
            tags = set()
        with self._lock:
            self._adopted_tags |= tags
            mapping = self.placement.place_all(evicted,
                                               exclude=[dead.name])
        by_adopter: Dict[str, List[str]] = {}
        for sid, name in mapping.items():
            by_adopter.setdefault(name, []).append(sid)
        for name, batch in sorted(by_adopter.items()):
            self._adopt_assigned(name, batch, source=dead.name)

    def _adopt_assigned(self, name: str, batch: List[str],
                        source: Optional[str] = None,
                        timeout_s: float = 60.0) -> bool:
        """Run the adoption RPC for a batch already assigned to `name`
        in placement.  On success the sids leave the migrating set; on
        failure they STAY in it (routing keeps answering "wait", never
        a session-not-found to the tenant) and the batch is queued for
        monitor-tick retry — if the adopter instead dies, eviction
        re-places the sids and the stale retry entry drops itself."""
        out = self._adopt_batch(self._workers[name], batch,
                                timeout_s=timeout_s)
        if out is None:
            with self._lock:
                self._adopt_pending.append(
                    (name, list(batch), time.monotonic() + 1.0))
            if _tele._ENABLED:
                _tele.event("fleet.adopt.failed", adopter=name,
                            sids=batch)
            return False
        with self._lock:
            self._unmark_migrating(batch)
        if _tele._ENABLED:
            _tele.inc("fleet.adopt.sessions", len(batch))
            _tele.event("fleet.adopt", adopter=name, source=source,
                        sessions=len(out.get("sessions", [])),
                        wal_replayed=out.get("wal_replayed", 0),
                        wal_deduped=out.get("wal_deduped", 0),
                        wal_skipped=out.get("wal_skipped", 0))
        return True

    def _retry_pending_adoptions(self) -> None:
        """Monitor-tick half of :meth:`_adopt_assigned`'s failure path.
        Short per-attempt timeout: this runs on the monitor thread, and
        death detection must not stall behind a wedged adopter."""
        now = time.monotonic()
        with self._lock:
            if not self._adopt_pending:
                return
            due = [(n, b) for n, b, t in self._adopt_pending if t <= now]
            self._adopt_pending = [e for e in self._adopt_pending
                                   if e[2] > now]
        for name, batch in due:
            with self._lock:
                # only sids still assigned to this adopter: anything
                # re-placed by an eviction belongs to a newer adoption
                # flow, which owns their migrating-set membership
                live = [sid for sid in batch
                        if self.placement.owner_of(sid) == name]
                healthy = self.placement.state(name) == "healthy"
            if not live:
                continue
            if not healthy:
                with self._lock:
                    self._adopt_pending.append((name, live, now + 1.0))
                continue
            self._adopt_assigned(name, live, timeout_s=5.0)

    def _adopt_batch(self, adopter: WorkerHandle, sids: List[str],
                     timeout_s: float = 60.0) -> Optional[dict]:
        """Scoped recovery RPC with retry: StoreLeaseHeld (a peer mid-
        adoption) and transport blips heal within the window; the
        lease's same-host pid check guarantees a dead holder is
        evicted rather than waited out."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                return adopter.client.adopt(sids)
            except (FleetRPCError, FleetRemoteError):
                if _tele._ENABLED:
                    _tele.inc("fleet.adopt.retry")
                time.sleep(0.1)
        return None

    def _maybe_restart(self, h: WorkerHandle) -> None:
        try:
            h.breaker.allow(site=f"fleet.{h.name}")
        except Exception:  # noqa: BLE001 — BreakerOpen: quarantine
            with self._lock:
                self.placement.set_state(h.name, "quarantined")
            if _tele._ENABLED:
                _tele.inc("fleet.worker.quarantined")
                _tele.event("fleet.worker.quarantine", worker=h.name,
                            crashes=h.crashes)
            return
        self._respawn(h)

    def _maybe_probe_restart(self, h: WorkerHandle) -> None:
        """Quarantined worker: the breaker's half-open transition admits
        exactly one probe restart after the cooldown."""
        try:
            h.breaker.allow(site=f"fleet.{h.name}")
        except Exception:  # noqa: BLE001 — still open
            return
        if _tele._ENABLED:
            _tele.event("fleet.worker.probe_restart", worker=h.name)
        self._respawn(h)

    def _respawn(self, h: WorkerHandle) -> None:
        h.restarting = True
        try:
            h.restarts += 1
            with self._lock:
                # no routing until the new process proves ready
                self.placement.set_state(h.name, "dead")
            try:
                # _spawn inside the boot-failure net: an injected
                # fleet.spawn:raise (or a real exec failure) charges
                # the budget exactly like a boot that never readied
                self._spawn(h)
                self.wait_ready([h.name], timeout_s=self.ready_timeout_s)
            except (TimeoutError, RuntimeError):
                # placement is already "dead" here, so _on_death's
                # already-handled guard would swallow this crash —
                # record it against the breaker budget directly, or a
                # worker that fails every boot respawns each tick
                # forever and is never quarantined.  (No eviction or
                # adoption needed: the sessions left at death time.)
                if h.proc is not None and h.proc.poll() is None:
                    reap_child(h.proc)  # wedged mid-boot: don't leak it
                with self._lock:
                    self._record_crash(h)
                if _tele._ENABLED:
                    _tele.event("fleet.worker.dead", worker=h.name,
                                reason="boot-failure", crashes=h.crashes)
                self._collect_blackbox(h, "boot-failure")
                return
            with self._lock:
                self.placement.set_state(h.name, "healthy")
            if _tele._ENABLED:
                _tele.event("fleet.worker.restarted", worker=h.name,
                            restarts=h.restarts)
        finally:
            h.restarting = False

    # -- rolling restart (live migration) ------------------------------

    def rolling_restart(self) -> dict:
        """Restart every worker one at a time with zero session loss:
        drain (handing sessions to peers through the store), SIGTERM +
        reap, respawn, wait ready.  Returns per-worker migration
        counts."""
        out = {}
        for name in sorted(self._workers):
            out[name] = self._restart_one(name)
        if _tele._ENABLED:
            _tele.event("fleet.rolling_restart",
                        migrated=sum(len(v["migrated"]) for v in
                                     out.values()))
        return out

    def _restart_one(self, name: str) -> dict:
        h = self._workers[name]
        t0 = time.monotonic()
        with self._lock:
            self.placement.set_state(name, "draining")
            moved = self.placement.evict(name)
            self._mark_migrating(sid for sid, _ in moved)
        # worker-side drain persists idle sessions and disowns them;
        # busy ones settle their in-flight jobs under the SIGTERM
        # handler's drain loop, so after reap_child the full set is
        # durably on the store
        try:
            h.client.drain()
        except (FleetRPCError, FleetRemoteError):
            pass  # SIGTERM's graceful drain covers it
        t1 = time.monotonic()
        reaped = reap_child(h.proc)
        t2 = time.monotonic()
        # the graceful exit's final beat holds the incarnation's last
        # snapshot and launches; the respawn unlinks the file
        with self._lock:
            self._ingest(h, read_heartbeat(h.hb_path))
        with self._lock:
            migrated = self.placement.place_all(moved, exclude=[name])
        by_adopter: Dict[str, List[str]] = {}
        for sid, adopter in migrated.items():
            by_adopter.setdefault(adopter, []).append(sid)
        for adopter, batch in sorted(by_adopter.items()):
            self._adopt_assigned(adopter, batch, source=name)
        t3 = time.monotonic()
        self._respawn(h)
        t4 = time.monotonic()
        if _tele._ENABLED:
            _tele.event("fleet.rolling_restart.worker", worker=name,
                        migrated=len(migrated), killed=reaped.killed)
        return {"migrated": migrated, "needed_kill": reaped.killed,
                "parts_s": {"drain": t1 - t0, "reap": t2 - t1,
                            "adopt": t3 - t2, "respawn": t4 - t3}}

    # -- elastic capacity (autoscaler actuators) -----------------------

    def boot_worker(self, name: Optional[str] = None,
                    timeout_s: Optional[float] = None) -> bool:
        """Grow the pool by one worker: register it (state "dead" — no
        routing until the new process proves ready), spawn into the
        warm-artifact path (shared kernel cache + ProgramManifest, same
        as any restart), wait ready.  Returns True on a ready worker.

        A failed boot (exit, wedge, injected ``fleet.spawn`` fault)
        charges the NEW worker's restart budget and leaves the handle
        registered in state "dead" with backoff armed — the monitor's
        ordinary restart/quarantine ladder owns further attempts, so a
        worker that fails every boot quarantines instead of spinning.
        Placement is never stuck either way: a "dead" worker is not
        placeable, and existing workers keep serving throughout."""
        if name is None:
            name = self.next_worker_name()
        with self._lock:
            if name in self._workers:
                raise ValueError(f"worker {name!r} already exists")
            h = self._new_handle(name)
            h.restarting = True   # this boot owns the handle, not _tick
            self._workers[name] = h
            self.placement.add_worker(name)
            self.placement.set_state(name, "dead")
        try:
            try:
                self._spawn(h)
                self.wait_ready([name],
                                timeout_s=timeout_s or self.ready_timeout_s)
            except (TimeoutError, RuntimeError):
                if h.proc is not None and h.proc.poll() is None:
                    reap_child(h.proc)  # wedged mid-boot: don't leak it
                with self._lock:
                    self._record_crash(h)
                if _tele._ENABLED:
                    _tele.event("fleet.worker.dead", worker=name,
                                reason="boot-failure", crashes=h.crashes)
                self._collect_blackbox(h, "boot-failure")
                return False
            with self._lock:
                self.placement.set_state(name, "healthy")
            if _tele._ENABLED:
                _tele.event("fleet.worker.spawned_up", worker=name,
                            pid=h.pid)
            return True
        finally:
            h.restarting = False

    def scale_down(self, name: Optional[str] = None) -> Optional[dict]:
        """Shrink the pool by one worker with zero session loss — the
        rolling-restart migration minus the respawn: drain → evict
        (sids go migrating; the front door waits) → re-place onto peers
        → adopt → retire.  Picks the least-loaded healthy worker when
        `name` is None; refuses (returns None) rather than retire the
        last healthy worker.  Racing a kill -9 is safe: selection and
        the draining transition happen under the monitor lock, so the
        death path either already owns the worker (we re-pick) or finds
        it draining and leaves it to us; a victim that dies mid-drain
        just falls through to adoption, which replays its WAL."""
        with self._lock:
            healthy = self.placement.workers("healthy")
            if name is None:
                if len(healthy) < 2:
                    return None
                name = min(healthy,
                           key=lambda n: (self.placement.load(n),
                                          len(self.placement.sessions_on(n)),
                                          n))
            elif name not in healthy or len(healthy) < 2:
                return None
            h = self._workers[name]
            h.restarting = True   # the retire owns the handle, not _tick
            self.placement.set_state(name, "draining")
            moved = self.placement.evict(name)
            self._mark_migrating(sid for sid, _ in moved)
        try:
            h.client.drain()
        except (FleetRPCError, FleetRemoteError):
            pass  # SIGTERM's graceful drain covers it
        reaped = reap_child(h.proc)
        migrated: Dict[str, str] = {}
        if moved:
            try:
                with self._lock:
                    migrated = self.placement.place_all(moved,
                                                        exclude=[name])
            except Exception:  # noqa: BLE001 — NoHealthyWorkers et al.
                # nowhere to re-place: the sids STAY migrating and the
                # front door's bounded wait surfaces the typed error;
                # the store still holds every session durably
                if _tele._ENABLED:
                    _tele.event("fleet.scale_down.orphaned", worker=name,
                                sids=[sid for sid, _ in moved])
        by_adopter: Dict[str, List[str]] = {}
        for sid, adopter in migrated.items():
            by_adopter.setdefault(adopter, []).append(sid)
        for adopter, batch in sorted(by_adopter.items()):
            self._adopt_assigned(adopter, batch, source=name)
        self._retire_worker(h)
        if _tele._ENABLED:
            _tele.event("fleet.worker.retired", worker=name,
                        migrated=len(migrated), killed=reaped.killed)
        return {"migrated": migrated, "needed_kill": reaped.killed}

    def _retire_worker(self, h: WorkerHandle) -> None:
        """Remove a drained worker from the fleet WITHOUT losing its
        telemetry: counters are cumulative, so a retired incarnation's
        final heartbeat snapshot must stay folded into the fleet-wide
        merge (metrics() keys incarnations ``(name, pid)`` and
        ``_worker_tele`` is never pruned) or every scale-down would
        deflate fleet totals.  The graceful-exit final beat carries the
        post-drain snapshot — read it one last time here, because the
        monitor's periodic ingest may have missed it."""
        rec = read_heartbeat(h.hb_path)
        with self._lock:
            self._ingest(h, rec)
            self.placement.remove_worker(h.name)
            self._workers.pop(h.name, None)
            self._last_beat.pop(h.name, None)
        for p in (h.hb_path, h.socket_path):
            try:
                os.unlink(p)
            except OSError:
                pass

    def pressure(self) -> dict:
        """The autoscaler's sensor bundle, assembled from state the
        monitor already maintains (no extra RPC): per-worker pipeline
        depth from the latest heartbeats, the worst per-incarnation
        ``serve.queue_wait``/``serve.latency`` p99 SLO gauges from the
        telemetry ingest, and the placement cost model's load/capacity
        totals."""
        with self._lock:
            live = [n for n in self.placement.workers("healthy")]
            beats = {n: self._last_beat.get(n) for n in live}
            load = sum(self.placement.load(n) for n in live)
            cap = sum(self.placement._workers[n]["capacity"] for n in live)
            n_total = len(self._workers)
            snaps = list(self._worker_tele.values())
        backlog = 0
        for rec in beats.values():
            if rec is None:
                continue
            backlog += int(rec.get("queue_depth") or 0)
            backlog += int(rec.get("inflight") or 0)
            backlog += int(rec.get("staged") or 0)
        queue_wait_p99 = 0.0
        latency_p99 = 0.0
        for snap in snaps:
            g = snap.get("gauges") or {}
            queue_wait_p99 = max(queue_wait_p99,
                                 float(g.get("serve.queue_wait.p99") or 0.0))
            latency_p99 = max(latency_p99,
                              float(g.get("serve.latency.p99") or 0.0))
        return {"n_live": len(live), "n_total": n_total,
                "backlog": backlog, "load": load, "capacity": cap,
                "queue_wait_p99_s": queue_wait_p99,
                "latency_p99_s": latency_p99}

    # -- brownout (graceful degradation between overloaded and scaled) -

    def set_brownout(self, level: int, shed_band: int = 0,
                     retry_in_s: float = 0.5) -> None:
        """Install brownout ladder state fleet-wide: the front door
        reads it synchronously on every apply (level 1 sheds bands <=
        `shed_band`, level 3 refuses all new work), and every healthy
        worker is told over RPC so scheduler admission and the routing
        rung degrade too (level 2 routes borderline dense jobs onto the
        quantized tier).  Broadcast only on change."""
        state = None if level <= 0 else {
            "level": int(level), "shed_band": int(shed_band),
            "retry_in_s": float(retry_in_s)}
        with self._lock:
            if state == self._brownout:
                return
            self._brownout = state
            names = self.placement.workers("healthy")
        if _tele._ENABLED:
            _tele.gauge("serve.brownout.level", float(level))
            _tele.event("fleet.autoscale.brownout", level=level,
                        shed_band=shed_band)
        for n in names:
            try:
                with self._lock:
                    h = self._workers.get(n)
                if h is not None:
                    h.client.brownout(level, shed_band=shed_band,
                                      retry_in_s=retry_in_s)
            except (FleetRPCError, FleetRemoteError):
                pass  # a dying worker misses the memo; the next
                #       broadcast (or its respawn at level 0) catches up

    def brownout(self) -> Optional[dict]:
        with self._lock:
            return dict(self._brownout) if self._brownout else None

    # -- front-door surface --------------------------------------------

    def place_session(self, sid: str, layers, width: int) -> str:
        with self._lock:
            name = self.placement.place(sid, layers, width)
            self._session_meta[sid] = (layers, width)
            return name

    def owner_of(self, sid: str) -> Optional[str]:
        with self._lock:
            return self.placement.owner_of(sid)

    def route(self, sid: str) -> Optional[FleetClient]:
        """The live client currently serving `sid`, or None while the
        session is between owners (migration/adoption in flight) — the
        front door waits and re-asks instead of erroring."""
        with self._lock:
            if sid in self._migrating:
                return None
            name = self.placement.owner_of(sid)
            if name is None:
                return None
            if self.placement.state(name) not in ("healthy", "draining"):
                return None
            return self._workers[name].client

    def note_destroyed(self, sid: str) -> None:
        with self._lock:
            self.placement.release(sid)
            self._session_meta.pop(sid, None)
            self._unmark_migrating([sid])

    def tag_adopted(self, tag: str) -> bool:
        """True when `tag` was pending in a dead worker's journal at
        adoption time — its effect is (being) applied; never resubmit."""
        with self._lock:
            return tag in self._adopted_tags

    def tag_settled(self, tag: str) -> bool:
        """True when some worker durably ACKED `tag` as settled (the
        store's ack log, written before the WAL entry is removed) — the
        effect already applied; never resubmit.  This is the record
        that closes the journal-settle-die-before-frame window the
        adoption scan cannot see (the entry is already gone)."""
        try:
            return self._store_view().tag_acked(tag)
        except Exception:  # noqa: BLE001 — advisory, like the tag scan
            return False

    def client(self, name: str) -> FleetClient:
        return self._workers[name].client

    def worker_names(self) -> List[str]:
        return sorted(self._workers)

    # -- fleet observability plane -------------------------------------

    def metrics(self, write: bool = False) -> dict:
        """Fleet-wide telemetry: every worker incarnation's heartbeat-
        flushed snapshot (cumulative, keyed (name, pid) so restarts sum
        rather than double-count) merged with the supervisor process's
        own — counters summed, histograms folded cell-wise, SLO gauges
        (p50/p95/p99) recomputed from the MERGED distributions.  With
        ``write=True`` the record is appended to the fleet JSONL
        (``telemetry_path``) for ``telemetry_report.py --fleet``."""
        with self._lock:
            incarnations = {f"{name}:{pid}": snap for (name, pid), snap
                            in self._worker_tele.items()}
            postmortems = list(self._postmortems)
        sources = list(incarnations.values())
        if _tele.enabled():
            sources.append(_tele.snapshot(include_events=False))
        merged = _tele.merge_snapshots(sources)
        per_worker = {}
        for key, snap in incarnations.items():
            c = snap.get("counters") or {}
            lat = (snap.get("hists") or {}).get("serve.latency")
            summ = {"jobs_completed": c.get("serve.jobs.completed", 0)}
            if lat:
                h = _tele.Histogram.from_dict(lat)
                summ["serve.latency"] = {"count": h.count,
                                         "p50": h.percentile(50),
                                         "p99": h.percentile(99)}
            per_worker[key] = summ
        out = {"kind": "fleet", "t_wall": time.time(), **merged,
               "workers": per_worker, "postmortems": postmortems}
        if write:
            self._append_fleet_jsonl(out)
        return out

    def kernel_launches(self) -> Dict[str, dict]:
        """Every worker incarnation's kernel launches as of its latest
        beat (a graceful exit's final beat included), keyed
        ``"<name>:<pid>"``: the window kernel's by plane dtype and entry
        (K1 ``in_tile``, K2 ``pair``) and the TurboQuant kernels'."""
        with self._lock:
            return {f"{name}:{pid}": dict(k) for (name, pid), k
                    in self._worker_kernels.items()}

    def incarnation_counters(self, prefix: str = "") -> Dict[str, dict]:
        """Every worker incarnation's telemetry counters whose names
        start with `prefix`, as of its latest beat (a graceful exit's
        final beat included), keyed ``"<name>:<pid>"``."""
        with self._lock:
            return {f"{name}:{pid}": {
                k: v for k, v in (snap.get("counters") or {}).items()
                if k.startswith(prefix)}
                for (name, pid), snap in self._worker_tele.items()}

    def _maybe_flush_metrics(self) -> None:
        """Monitor-tick half of the fleet JSONL: one merged record per
        flush interval, only while the plane is actually live."""
        if not (_tele._ENABLED or self._worker_tele):
            return
        now = time.monotonic()
        if now - self._tele_last_flush < self._tele_flush_s:
            return
        self._tele_last_flush = now
        try:
            self.metrics(write=True)
        except Exception:  # noqa: BLE001 — metrics must not stop the monitor
            if _tele._ENABLED:
                _tele.inc("fleet.metrics.flush_error")

    def _append_fleet_jsonl(self, record: dict) -> None:
        try:
            with open(self.telemetry_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        except (OSError, TypeError, ValueError):
            pass  # the journal is evidence, never a failure source

    def _collect_blackbox(self, h: WorkerHandle, reason: str,
                          last_n: int = 16) -> None:
        """Autopsy a dead incarnation: recover its flight-recorder box
        (at most one beat stale — the worker flushes per heartbeat) and
        keep what it was doing when it died in the postmortem ring, the
        stats surface, and the fleet journal."""
        pid = h.pid
        if pid is None:
            return
        box = _tele.read_blackbox(
            os.path.join(self.blackbox_dir, f"{h.name}-{pid}.json"))
        if box is None:
            return  # telemetry off, or death before the first flush
        post = {"kind": "postmortem", "worker": h.name, "pid": pid,
                "reason": reason, "t_wall": time.time(),
                "flush_seq": box.get("flush_seq"),
                "epoch_unix_s": box.get("epoch_unix_s"),
                "last_events": (box.get("events") or [])[-last_n:],
                "last_spans": (box.get("spans") or [])[-last_n:]}
        with self._lock:
            self._postmortems.append(post)
            del self._postmortems[:-self._postmortem_cap]
        if _tele._ENABLED:
            _tele.event("fleet.worker.blackbox", worker=h.name, pid=pid,
                        reason=reason,
                        events=len(box.get("events") or []))
        self._append_fleet_jsonl(post)

    def trace_sources(self) -> List[dict]:
        """Merge sources for the fleet timeline: the supervisor/front-
        door process's live rings plus every worker incarnation's black
        box (live workers' boxes are at most one beat stale; dead ones
        are their last moments)."""
        sources = []
        if _tele.enabled():
            sources.append(_tele.local_trace_source("frontdoor"))
        for p in sorted(glob.glob(
                os.path.join(self.blackbox_dir, "*.json"))):
            box = _tele.read_blackbox(p)
            if box is not None:
                sources.append(box)
        return sources

    def write_merged_trace(self, path: str) -> str:
        """One Perfetto-loadable timeline for the whole fleet (one
        track per worker incarnation; submit trace ids in span args)."""
        return _tele.write_merged_chrome_trace(path, self.trace_sources())

    def stats(self) -> dict:
        with self._lock:
            return {
                "placement": self.placement.snapshot(),
                "workers": {name: {
                    "pid": h.pid, "crashes": h.crashes,
                    "restarts": h.restarts,
                    "breaker": h.breaker.snapshot(),
                    "state": self.placement.state(name),
                    "beat": read_heartbeat(h.hb_path),
                    "boot_to_ready_s": (
                        h.ready_at - h.spawned_at
                        if h.ready_at is not None
                        and h.spawned_at is not None else None),
                } for name, h in self._workers.items()},
                "migrating": sorted(self._migrating),
                "adopt_pending": sum(len(b) for _, b, _ in
                                     self._adopt_pending),
                "adopted_tags": len(self._adopted_tags),
                "postmortems": list(self._postmortems),
                "deaths": [dict(d) for d in self._deaths],
                "brownout": dict(self._brownout) if self._brownout
                else None,
                "autoscale": (self._autoscaler.stats()
                              if self._autoscaler is not None else None),
            }

    # -- lifecycle -----------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None and self._monitor.is_alive():
            self._monitor.join(timeout=max(self.tick_s * 10, 5.0))
        if self._autoscaler is not None:
            self._autoscaler.join(timeout_s=10.0)
        with self._lock:
            handles = list(self._workers.values())
        for h in handles:
            if h.proc is not None and h.proc.poll() is None:
                reap_child(h.proc)
        if _tele._ENABLED or self._worker_tele:
            try:
                self.metrics(write=True)  # final fleet journal record
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self) -> "FleetSupervisor":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def _store_view(self):
        if self._store is None:
            from ..checkpoint.store import CheckpointStore

            self._store = CheckpointStore(self.store_dir)
        return self._store


__all__ = ["FleetSupervisor", "WorkerHandle"]
