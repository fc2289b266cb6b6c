"""Demand-driven fleet autoscaler + brownout ladder (the port of the
JAX package's fleet/autoscaler.py; host only, the same decisions on the
same pressure trace).

Closes the loop between the observability plane and the fleet control
plane: every monitor tick the supervisor hands :meth:`Autoscaler.tick`
its :meth:`~qrack_tpu_torch.fleet.supervisor.FleetSupervisor.pressure`
bundle — per-worker pipeline depth from the heartbeats, the worst
``serve.queue_wait``/``serve.latency`` p99 SLO gauges from the
telemetry ingest, and the placement cost model's load/capacity totals
— and the scaler moves the pool between ``n_min`` and ``n_max``:

* **scale-up** spawns one worker at a time into the warm-artifact path
  (shared kernel cache + ProgramManifest — a spawned worker's TTFR is the
  warm number), on a background thread so death detection never stalls
  behind a boot.  ``up_ticks`` consecutive overloaded ticks are needed
  before the first action and ``cooldown_s`` must pass between actions,
  so a p99 blip cannot thrash the pool.  A failed boot (exit, wedge,
  injected ``fleet.spawn`` fault) charges the new worker's restart
  budget (supervisor.boot_worker) and the ladder HOLDS at brownout
  until a retry lands.
* **scale-down** (after ``down_ticks`` consecutive idle ticks) retires
  the least-loaded worker through the drain → evict → re-place → adopt
  migration — the same zero-loss plane a death uses — so shrinking
  never loses a job or session.
* **brownout** degrades gracefully while overloaded-but-not-yet-scaled,
  one rung per ``ladder_ticks`` of sustained overload, strictly in
  order: level 1 sheds priority bands <= ``shed_band`` at the front
  door (typed :class:`~qrack_tpu_torch.serve.errors.Overloaded`, jobs above
  the band untouched), level 2 additionally routes borderline dense
  jobs onto the quantized TurboQuant rung (route/router.py brownout
  override), level 3 refuses all new work with a retry-after hint.
  The ladder steps back down one rung at a time as pressure clears,
  and clears entirely once capacity lands.

Decisions are observable: ``fleet.autoscale.decision.<reason>``
counters, ``fleet.autoscale.scale_up{,_failed}`` / ``.scale_down``,
the ``fleet.autoscale.spawn_s`` boot-latency histogram,
``fleet.autoscale.n_workers`` / ``.n_peak`` gauges, and
``fleet.autoscale.decision`` events on the merged fleet trace
(the JAX package's docs/OBSERVABILITY.md names them).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from .. import telemetry as _tele


@dataclass
class AutoscaleConfig:
    n_min: int = 1
    n_max: int = 4
    # -- overload sensors (any one trips the "overloaded" signal) ------
    up_backlog: float = 4.0        # queued+inflight+staged per live worker
    up_queue_wait_p99_s: float = 1.0   # worst worker's queue-wait p99
    up_load: float = 0.95          # placement load / capacity fraction
    # -- idle sensors (ALL must hold for the "idle" signal) ------------
    down_backlog: float = 0.5      # backlog per live worker below this
    down_load: float = 0.5         # load must fit n-1 workers at this frac
    # -- loop damping --------------------------------------------------
    up_ticks: int = 3              # consecutive overloaded ticks to act
    down_ticks: int = 40           # consecutive idle ticks to act
    cooldown_s: float = 5.0        # between any two scale actions
    boot_timeout_s: float = 120.0
    # -- brownout ladder -----------------------------------------------
    ladder_ticks: int = 5          # overloaded ticks per rung escalation
    shed_band: int = 0             # priority bands <= this shed at level 1
    retry_in_s: float = 0.5        # retry-after hint in typed Overloaded


class Autoscaler:
    """One instance per supervisor; :meth:`tick` runs on the monitor
    thread and must never block — scale actions go to a worker thread.
    State is owned by the monitor thread; ``_lock`` only guards the
    cross-thread stats/timeline surface."""

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._over_ticks = 0
        self._idle_ticks = 0
        self._calm_ticks = 0       # consecutive non-overloaded ticks
        self._ladder_ticks = 0     # overload ticks since last rung move
        self._level = 0
        self._cool_until = 0.0
        self._action: Optional[threading.Thread] = None
        self._scale_up_failures = 0
        self.n_peak = 0
        # timeline for the surge soak's "brownout fired BEFORE capacity
        # arrived" assertion (monotonic timestamps)
        self.first_brownout_t: Optional[float] = None
        self.first_scale_up_done_t: Optional[float] = None
        self._decisions: dict = {}

    # -- the control loop ----------------------------------------------

    def tick(self, sup) -> None:
        cfg = self.cfg
        p = sup.pressure()
        n_live, n_total = p["n_live"], p["n_total"]
        self.n_peak = max(self.n_peak, n_total)
        if _tele._ENABLED:
            _tele.gauge("fleet.autoscale.n_workers", float(n_total))
            _tele.gauge("fleet.autoscale.n_peak", float(self.n_peak))
            _tele.gauge("fleet.autoscale.backlog", float(p["backlog"]))
        overloaded, why = self._overloaded(p)
        idle = self._idle(p)
        self._over_ticks = self._over_ticks + 1 if overloaded else 0
        self._calm_ticks = 0 if overloaded else self._calm_ticks + 1
        self._idle_ticks = self._idle_ticks + 1 if idle else 0

        busy = self._action is not None and self._action.is_alive()
        now = time.monotonic()
        if overloaded:
            self._maybe_escalate_brownout(sup, busy or n_total >= cfg.n_max)
        else:
            self._maybe_deescalate_brownout(sup, n_live)
        if busy or now < self._cool_until:
            return
        if (overloaded and self._over_ticks >= cfg.up_ticks
                and n_total < cfg.n_max):
            self._decide(f"scale_up.{why}", n=n_total)
            self._start(self._run_scale_up, sup)
        elif (idle and self._idle_ticks >= cfg.down_ticks
                and n_live > cfg.n_min and self._level == 0):
            self._decide("scale_down.idle", n=n_total)
            self._start(self._run_scale_down, sup)

    def _overloaded(self, p) -> tuple:
        cfg = self.cfg
        per = p["backlog"] / max(1, p["n_live"])
        if per > cfg.up_backlog:
            return True, "backlog"
        if p["queue_wait_p99_s"] > cfg.up_queue_wait_p99_s:
            return True, "slo"
        if p["capacity"] > 0 and p["load"] / p["capacity"] > cfg.up_load:
            return True, "load"
        return False, ""

    def _idle(self, p) -> bool:
        cfg = self.cfg
        if p["n_live"] <= 1:
            return False
        per_cap = p["capacity"] / max(1, p["n_live"])
        fits_smaller = p["load"] <= cfg.down_load * per_cap * (p["n_live"] - 1)
        return (p["backlog"] / max(1, p["n_live"]) <= cfg.down_backlog
                and fits_smaller)

    # -- scale actions (background thread) -----------------------------

    def _start(self, target, sup) -> None:
        t = threading.Thread(target=target, args=(sup,), daemon=True,
                             name="fleet-autoscale")
        self._action = t
        t.start()

    def _run_scale_up(self, sup) -> None:
        cfg = self.cfg
        t0 = time.monotonic()
        try:
            ok = sup.boot_worker(timeout_s=cfg.boot_timeout_s)
        except Exception:  # noqa: BLE001 — a scaler bug must not leak
            ok = False
        dt = time.monotonic() - t0
        if _tele._ENABLED:
            _tele.observe("fleet.autoscale.spawn_s", dt)
        with self._lock:
            if ok:
                self._scale_up_failures = 0
                if self.first_scale_up_done_t is None:
                    self.first_scale_up_done_t = time.monotonic()
            else:
                self._scale_up_failures += 1
        if _tele._ENABLED:
            if ok:
                _tele.inc("fleet.autoscale.scale_up")
            else:
                _tele.inc("fleet.autoscale.scale_up_failed")
            _tele.event("fleet.autoscale.scale_up", ok=ok,
                        spawn_s=round(dt, 4))
        # cooldown from COMPLETION: a slow boot must not be followed by
        # an instant second spawn off stale pressure; a failed boot
        # backs off the same way while the ladder holds at brownout
        self._cool_until = time.monotonic() + cfg.cooldown_s
        self._over_ticks = 0
        self._idle_ticks = 0

    def _run_scale_down(self, sup) -> None:
        try:
            out = sup.scale_down()
        except Exception:  # noqa: BLE001
            out = None
        if out is not None and _tele._ENABLED:
            _tele.inc("fleet.autoscale.scale_down")
            _tele.event("fleet.autoscale.scale_down",
                        migrated=len(out.get("migrated") or {}))
        self._cool_until = time.monotonic() + self.cfg.cooldown_s
        self._over_ticks = 0
        self._idle_ticks = 0

    # -- brownout ladder -----------------------------------------------

    def _maybe_escalate_brownout(self, sup, at_capacity: bool) -> None:
        """One rung per `ladder_ticks` of sustained overload, and only
        while capacity cannot arrive instantly (a scale-up in flight,
        failed, or the pool at n_max) — strictly ordered, so telemetry
        always shows shed before quantized before refuse."""
        if not at_capacity and self._level == 0:
            # capacity can still arrive through hysteresis alone; the
            # ladder waits for the scaler to commit first
            if self._over_ticks < self.cfg.up_ticks:
                return
        self._ladder_ticks += 1
        if self._level >= 3 or self._ladder_ticks < self.cfg.ladder_ticks:
            return
        self._ladder_ticks = 0
        self._set_level(sup, self._level + 1)

    def _maybe_deescalate_brownout(self, sup, n_live: int) -> None:
        """Step DOWN one rung at a time, each after `ladder_ticks` of
        calm — symmetric hysteresis, so one quiet tick mid-surge cannot
        drop the ladder and re-admit the flood."""
        self._ladder_ticks = 0
        if self._level > 0 and self._calm_ticks >= self.cfg.ladder_ticks:
            self._calm_ticks = 0
            self._set_level(sup, self._level - 1)

    def _set_level(self, sup, level: int) -> None:
        self._level = level
        with self._lock:
            if level > 0 and self.first_brownout_t is None:
                self.first_brownout_t = time.monotonic()
        self._decide(f"brownout.level{level}")
        sup.set_brownout(level, shed_band=self.cfg.shed_band,
                         retry_in_s=self.cfg.retry_in_s)

    # -- bookkeeping ---------------------------------------------------

    def _decide(self, reason: str, **fields) -> None:
        with self._lock:
            self._decisions[reason] = self._decisions.get(reason, 0) + 1
        if _tele._ENABLED:
            _tele.inc(f"fleet.autoscale.decision.{reason}")
            _tele.event("fleet.autoscale.decision", reason=reason,
                        **fields)

    @property
    def level(self) -> int:
        return self._level

    def join(self, timeout_s: float = 10.0) -> None:
        t = self._action
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)

    def stats(self) -> dict:
        with self._lock:
            return {"level": self._level, "n_peak": self.n_peak,
                    "decisions": dict(self._decisions),
                    "scale_up_failures": self._scale_up_failures,
                    "first_brownout_t": self.first_brownout_t,
                    "first_scale_up_done_t": self.first_scale_up_done_t}


__all__ = ["Autoscaler", "AutoscaleConfig"]
