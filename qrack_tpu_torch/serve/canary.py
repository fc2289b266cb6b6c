"""Canary verification: sampled full-fidelity oracle replay of served
jobs (the serve-side arm of the integrity guard plane; the port of the
JAX package's serve/canary.py).

The boundary invariants in resilience/integrity.py are cheap proxies —
norm and finiteness catch the corruption models that move probability
mass, but a unitary-preserving mis-compute (wrong phase, swapped
amplitudes) passes every norm check.  The canary closes that class
statistically: an env-gated fraction of completed circuit jobs is
re-run against the CPU oracle and compared by state fidelity.

Division of labor (the one-dispatch-owner discipline):

* The DISPATCH-OWNER thread captures the session's pre-job and
  post-job kets — state reads are device traffic and belong to it —
  for sampled jobs only, so the steady-state cost at rate 0 is one
  attribute test per batch.
* The CANARY thread (one daemon, spawned lazily) replays the circuit
  on a fresh ``QEngineCPU`` (the port's complex128 oracle) seeded with
  the captured pre-state and compares fidelity against the captured
  post-state.  It never touches the card: both kets are host numpy
  arrays by the time they reach the queue.

A mismatch emits ``integrity.canary.mismatch`` and feeds one
quarantine strike per device the job's engine was paged across
(resilience/integrity.py) — repeated canary failures quarantine the
card exactly like fingerprint attribution does.  A dense engine lists
no devices (``GetDeviceList``, as in the JAX package), so its card is
struck through ``GetDevice`` (a CUDA ordinal; the CPU is -1 and never
struck).  The queue is bounded
and lossy (``integrity.canary.dropped``): verification is sampling,
never backpressure.

Env knobs:

* ``QRACK_SERVE_CANARY_RATE`` — fraction of circuit jobs sampled
  (default 0 = off; the service only constructs a verifier when > 0).
* ``QRACK_SERVE_CANARY_TOL`` — fidelity shortfall treated as a
  mismatch (default 1e-6).
* ``QRACK_SERVE_CANARY_TOL_QUANT`` — the looser shortfall used when
  the session runs on a QUANTIZED (turboquant) engine (default 1e-3):
  requantization error is legitimate fidelity loss, not corruption.
  Quantized sessions wider than the dense cap cannot materialize a
  full ket at all — those samples are skipped and counted
  (``integrity.canary.skipped``) rather than failed.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from .. import telemetry as _tele


def _fidelity(a: np.ndarray, b: np.ndarray) -> float:
    na = float(np.vdot(a, a).real)
    nb = float(np.vdot(b, b).real)
    if na <= 0.0 or nb <= 0.0:
        return 0.0
    return float(abs(np.vdot(a, b)) ** 2 / (na * nb))


class CanaryVerifier:
    """Sampled oracle-replay verifier.  One instance per service; the
    executor calls :meth:`should_sample` / :meth:`capture_pre` /
    :meth:`submit_post` / :meth:`discard` from the dispatch-owner
    thread, everything else happens on the canary thread."""

    def __init__(self, rate: float, tol: Optional[float] = None,
                 max_queue: int = 16):
        self.rate = max(0.0, min(1.0, rate))
        if tol is None:
            try:
                tol = float(os.environ.get("QRACK_SERVE_CANARY_TOL",
                                           "") or 1e-6)
            except ValueError:
                tol = 1e-6
        self.tol = tol
        try:
            self.tol_quant = float(os.environ.get(
                "QRACK_SERVE_CANARY_TOL_QUANT", "") or 1e-3)
        except ValueError:
            self.tol_quant = 1e-3
        # deterministic sampling: every k-th circuit job, not a coin
        # flip — a soak at rate r sees exactly the expected coverage
        self._every = max(1, round(1.0 / self.rate)) if self.rate else 0
        self._seen = 0
        self._pending: Dict[int, tuple] = {}  # id(job) -> (pre, devices)
        self._q: "queue.Queue[tuple]" = queue.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.checked = 0
        self.mismatches = 0

    # -- dispatch-owner side -------------------------------------------

    def should_sample(self) -> bool:
        if not self._every:
            return False
        self._seen += 1
        return self._seen % self._every == 0

    def capture_pre(self, job) -> None:
        """Snapshot the session ket BEFORE the job's circuit runs (the
        oracle's starting point).  Dispatch-owner thread only."""
        sess = job.session
        try:
            from ..resilience import faults as _faults

            with _faults.suspended():
                pre = np.asarray(sess.engine.GetQuantumState())
                devs = self._device_ids(sess.engine)
        except MemoryError:
            # quantized session past the dense cap: a full ket cannot
            # exist, so the oracle replay has nothing to compare — skip
            # the sample, don't fail it (the chunk-mass fingerprint in
            # resilience/integrity.py still guards these widths)
            if _tele._ENABLED:
                _tele.inc("integrity.canary.skipped")
            return
        except Exception:  # noqa: BLE001 — sampling must never fail a job
            if _tele._ENABLED:
                _tele.inc("integrity.canary.capture_failed")
            return
        self._pending[id(job)] = (pre, devs)

    def submit_post(self, job) -> None:
        """Pair the post-job ket with the captured pre-state and hand
        the case to the canary thread.  Dispatch-owner thread only."""
        item = self._pending.pop(id(job), None)
        if item is None:
            return
        pre, devs = item
        sess = job.session
        try:
            from ..resilience import faults as _faults

            with _faults.suspended():
                post = np.asarray(sess.engine.GetQuantumState())
        except MemoryError:
            if _tele._ENABLED:
                _tele.inc("integrity.canary.skipped")
            return
        except Exception:  # noqa: BLE001
            if _tele._ENABLED:
                _tele.inc("integrity.canary.capture_failed")
            return
        # quantized sessions are judged against the looser tolerance:
        # the served state carries requantization error by design
        tol = (self.tol_quant
               if getattr(sess.engine, "_tq_bits", None) is not None
               else self.tol)
        try:
            self._q.put_nowait((sess.sid, sess.width, job.circuit,
                                pre, post, devs, tol))
        except queue.Full:
            if _tele._ENABLED:
                _tele.inc("integrity.canary.dropped")
            return
        self._ensure_thread()

    def discard(self, job) -> None:
        """Forget a sampled job that failed — there is no post-state to
        verify against."""
        self._pending.pop(id(job), None)

    @staticmethod
    def _device_ids(engine) -> List[int]:
        get = getattr(engine, "GetDeviceList", None)
        if get is None:
            return []
        try:
            devs = [int(d) for d in get()]
            if not devs:
                one = int(getattr(engine, "GetDevice", lambda: -1)())
                devs = [one] if one >= 0 else []
            return devs
        except Exception:  # noqa: BLE001
            return []

    # -- canary thread --------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="qrack-serve-canary")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                self._verify(*item)
            except Exception:  # noqa: BLE001 — verification is advisory
                if _tele._ENABLED:
                    _tele.inc("integrity.canary.errors")

    def _verify(self, sid, width, circuit, pre, post, devs,
                tol: Optional[float] = None) -> None:
        from ..engines.cpu import QEngineCPU

        oracle = QEngineCPU(width)
        oracle.SetQuantumState(pre)
        circuit.Run(oracle)
        fid = _fidelity(np.asarray(oracle.GetQuantumState()), post)
        self.checked += 1
        if fid < 1.0 - (self.tol if tol is None else tol):
            self.mismatches += 1
            if _tele._ENABLED:
                _tele.event("integrity.canary.mismatch", sid=sid,
                            fidelity=fid, devices=devs)
            from ..resilience import integrity as _integ

            for dev in devs:
                _integ.record_strike(dev, "serve.canary")
        elif _tele._ENABLED:
            _tele.inc("integrity.canary.ok")
            _tele.observe("integrity.canary.fidelity", fid)

    # -- lifecycle ------------------------------------------------------

    def stop(self, join_timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(join_timeout)
            self._thread = None

    def drain(self, timeout: float = 10.0) -> None:
        """Block until the queue is empty (tests)."""
        import time

        deadline = time.monotonic() + timeout
        self._ensure_thread()
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
