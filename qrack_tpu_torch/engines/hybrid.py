"""QHybrid: transparent CPU <-> CUDA <-> pager switching by width.

Re-design of the reference QHybrid (reference: include/qhybrid.hpp:35,
SwitchGpuMode :105, SwitchPagerMode :127): below `tpu_threshold_qubits`
the numpy engine wins (device dispatch latency dwarfs the math on tiny
kets); at or above it the dense CUDA engine; past
`pager_threshold_qubits` (QRACK_MAX_PAGE_QB, 30) the QPager over
``devices=`` (parallel/pager.py; on one card a list that repeats it).
The wrapper forwards the entire QInterface surface to the active engine
and re-materializes the ket across representations on width changes
(the reference's CopyStateVec hand-off), staged through a host
complex128 vector.

Switching by width is the design, not a fallback.  ``device=`` and
``dtype=`` go to the CUDA engine and the pager; QEngineCPU takes
neither.

With the resilience plane armed (resilience/), a call that escalates
with a FAILOVER_ERRORS exception moves the ket down the failover chain
in place (:meth:`QHybrid._fail_over`): a pager shrinks on the card,
then becomes a QEngineCUDA (width at most 30, breaker closed); the CPU
is a rung only when the caller passed ``failover_cpu=True``, and
without it the cause re-raises with the planes as they were.  A landing
on ``cuda`` or ``cpu`` pins that mode as the ceiling; at a later call
boundary, once the health probe passes, :meth:`QHybrid._maybe_recover`
lifts the pin and carries the ket back up.  A construction that fails
on a guarded site degrades the mode (pager -> cuda; cuda -> cpu only
with ``failover_cpu``) and raises otherwise.  With ``devices=`` the
cluster's page homes every rank runs the stack: the pager's moves agree
across the ranks, its dense rung is a QEngineCUDA replica on each rank
(resilience/failover.py ``BY_DESIGN``), and the un-pin probe is agreed
too.

Each switch and each grow across a mode is a telemetry event,
``hybrid.switch.<from>_to_<to>`` and ``hybrid.grow.<mode>``, with the
modes ``cpu``, ``cuda`` (the JAX package's ``tpu``) and ``pager``; the
failover moves are ``resilience.failover.*`` (construction:
``resilience.failover.init_<mode>_to_<mode>``) and the un-pin
``hybrid.unpin.<from>_to_<to>`` with the counter
``elastic.hybrid.unpinned``.  Checkpoints (checkpoint/registry.py,
kind ``"hybrid"``) carry the JAX package's meta: the thresholds as
``tpu_threshold``/``pager_threshold``, and the failover ceiling with
``"cuda"`` written as the JAX package's ``"tpu"`` and read back.  The
serving plane (serve/, ROADMAP item 16b) reads the same
breaker at admission and sheds card-bound jobs while it is open
(serve/scheduler.py).

``HOST_STAGINGS`` counts the kets that pass through the host, and their
amplitudes: a whole ket when the width crosses the threshold
(``"switch"``), and the other operand of a Compose onto a CUDA engine
(``"compose"``, which QEngineCUDA and QPager pull through
GetQuantumState).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import resilience as _res
from .. import telemetry as _tele
from ..config import get_config
from ..utils.rng import QrackRandom
from ..utils.states import compose_states
from .cpu import QEngineCPU
from .cuda import QEngineCUDA

HOST_STAGINGS = {"switch": 0, "switch_amps": 0, "compose": 0,
                 "compose_amps": 0}


class QHybrid:
    def __init__(self, qubit_count: int, init_state: int = 0,
                 rng: Optional[QrackRandom] = None,
                 tpu_threshold_qubits: Optional[int] = None,
                 pager_threshold_qubits: Optional[int] = None,
                 devices=None, device=None, dtype=None,
                 failover_cpu: bool = False, **kwargs):
        cfg = get_config()
        self._tpu_threshold = (
            tpu_threshold_qubits if tpu_threshold_qubits is not None
            else cfg.hybrid_tpu_threshold_qubits
        )
        self._pager_threshold = (
            pager_threshold_qubits if pager_threshold_qubits is not None
            else cfg.max_page_qubits
        )
        self._cuda_kwargs = {"device": device, "dtype": dtype}
        self._devices = devices
        self._kwargs = dict(kwargs)
        self._kwargs["rng"] = rng if rng is not None else QrackRandom()
        self._failover_cpu = bool(failover_cpu)
        # failover ceiling: None = healthy; "cuda" = the pager failed,
        # never re-promote past one dense engine; "cpu" = the device is
        # unusable, pin to the host (only with failover_cpu)
        self._failed_over: Optional[str] = None
        self._engine = self._make_engine(qubit_count, init_state)

    # ------------------------------------------------------------------

    def _mode_for(self, qubit_count: int) -> str:
        if self._failed_over == "cpu" or qubit_count < self._tpu_threshold:
            return "cpu"
        if qubit_count <= self._pager_threshold or self._failed_over == "cuda":
            return "cuda"
        return "pager"

    def _make_engine(self, qubit_count: int, init_state: int = 0,
                     mode: Optional[str] = None):
        if mode is None:
            mode = self._mode_for(qubit_count)
        try:
            if mode == "cpu":
                return QEngineCPU(qubit_count, init_state=init_state,
                                  **self._kwargs)
            if mode == "cuda":
                return QEngineCUDA(qubit_count, init_state=init_state,
                                   **self._cuda_kwargs, **self._kwargs)
            from ..parallel.pager import QPager

            return QPager(qubit_count, init_state=init_state,
                          devices=self._devices, **self._cuda_kwargs,
                          **self._kwargs)
        except _res.FAILOVER_ERRORS as e:
            # construction-time failover (discover died): degrade the
            # mode and rebuild — onto the CPU only when the caller named it
            from .cuda import MAX_DENSE_QB

            if mode == "pager" and qubit_count <= MAX_DENSE_QB:
                fallback = "cuda"
            elif mode != "cpu" and self._failover_cpu:
                fallback = "cpu"
            else:
                raise
            self._failed_over = fallback
            if _tele._ENABLED:
                _tele.event(f"resilience.failover.init_{mode}_to_{fallback}",
                            width=qubit_count, cause=type(e).__name__)
                _tele.inc("resilience.failovers")
            return self._make_engine(qubit_count, init_state, mode=fallback)

    def _mode_of(self, engine) -> str:
        if isinstance(engine, QEngineCPU):
            return "cpu"
        return "cuda" if isinstance(engine, QEngineCUDA) else "pager"

    def _maybe_switch(self) -> None:
        """Re-materialize the ket when the width crosses a threshold
        (reference: SwitchGpuMode)."""
        n = self._engine.qubit_count
        want, have = self._mode_for(n), self._mode_of(self._engine)
        if want == have:
            return
        if _tele._ENABLED:
            _tele.event(f"hybrid.switch.{have}_to_{want}", width=n)
        HOST_STAGINGS["switch"] += 1
        HOST_STAGINGS["switch_amps"] += 1 << n
        state = self._engine.GetQuantumState()
        rng = self._engine.rng
        new = self._make_engine(n)
        new.rng = rng
        new.SetQuantumState(state)
        self._engine = new

    # ------------------------------------------------------------------
    # full-surface forwarding with structural hooks
    # ------------------------------------------------------------------

    def _fail_over(self, cause) -> None:
        """In-place degradation: move the ket off the failing engine to
        the next engine down the chain (elastic pager shrink → cuda →
        cpu when named).  A cuda/cpu landing pins the ceiling; the un-pin
        probe (:meth:`_maybe_recover`) lifts it at a later call boundary
        once the device looks healthy again."""
        from ..resilience.failover import fail_over_engine

        self._commit_fallback(fail_over_engine(self._engine, cause,
                                               self._failover_cpu))

    def _commit_fallback(self, engine) -> None:
        from ..resilience.failover import _engine_kind

        self._engine = engine
        kind = _engine_kind(engine)
        if kind in ("cuda", "cpu"):
            # a shrunk pager is NOT a ceiling — it re-expands on its own
            # through the elastic probe; only terminal hops pin the mode
            self._failed_over = kind

    @property
    def _on_cluster(self) -> bool:
        """True when the pager half lives on the cluster's page homes:
        every rank runs this stack, and its un-pin probe is agreed across
        the ranks (resilience/elastic.py ``cohort``)."""
        from ..parallel import cluster as _cluster

        return bool(self._devices) and isinstance(
            self._devices[0], _cluster.PageHome) and _cluster.is_initialized()

    def _maybe_recover(self) -> None:
        """Breaker-gated un-pin probe — the inverse of :meth:`_fail_over`.
        At a call boundary: re-expand a degraded pager in place, and when
        a cuda/cpu ceiling is pinned but the health probe passes, rebuild
        the width-appropriate engine and carry state and rng onto it."""
        from ..resilience import elastic as _elastic

        eng = self._engine
        if getattr(eng, "_elastic_target_g", None) is not None:
            _elastic.maybe_reexpand(eng)
        if self._failed_over is None:
            return
        if not _elastic.health_probe(cohort=self._on_cluster):
            return
        prev = self._failed_over
        self._failed_over = None
        n = self._engine.qubit_count
        want, have = self._mode_for(n), self._mode_of(self._engine)
        if want == have:
            return  # ceiling lifted; the current engine already fits
        try:
            state = self._engine.GetQuantumState()
            rng = self._engine.rng
            new = self._make_engine(n)  # re-pins the ceiling on failure
            new.rng = rng
            new.SetQuantumState(state)
            self._engine = new
            if _tele._ENABLED:
                _tele.event(f"hybrid.unpin.{prev}_to_{want}", width=n)
                _tele.inc("elastic.hybrid.unpinned")
        except _res.FAILOVER_ERRORS:
            self._failed_over = prev

    def __getattr__(self, name):
        if name == "_engine":  # not built yet: no forwarding loop
            raise AttributeError(name)
        val = getattr(self._engine, name)
        if not _res._ACTIVE or not callable(val):
            return val

        def call(*args, **kwargs):
            if (self._failed_over is not None
                    or getattr(self._engine, "_elastic_target_g", None)
                    is not None):
                self._maybe_recover()
            try:
                return getattr(self._engine, name)(*args, **kwargs)
            except _res.FAILOVER_ERRORS as e:
                from ..resilience.failover import replay_with_failover

                _, out = replay_with_failover(
                    self._engine, e,
                    lambda fb: getattr(fb, name)(*args, **kwargs),
                    commit=self._commit_fallback,
                    failover_cpu=self._failover_cpu)
                return out

        return call

    def _grow_to(self, n_new: int, mode: str, full_state) -> None:
        """Host-stage into a target-mode engine at the grown width."""
        if _tele._ENABLED:
            _tele.event(f"hybrid.grow.{mode}", width=n_new)
        HOST_STAGINGS["switch"] += 1
        HOST_STAGINGS["switch_amps"] += 1 << n_new
        rng = self._engine.rng
        grown = self._make_engine(n_new, mode=mode)
        grown.rng = rng
        grown.SetQuantumState(full_state)
        self._engine = grown

    def Compose(self, other, start=None) -> int:
        inner = other._engine if isinstance(other, QHybrid) else other
        n_cur = self._engine.qubit_count
        n_new = n_cur + inner.qubit_count
        want = self._mode_for(n_new)
        if want == self._mode_for(n_cur):
            if want != "cpu":
                HOST_STAGINGS["compose"] += 1
                HOST_STAGINGS["compose_amps"] += 1 << inner.qubit_count
            return self._engine.Compose(inner, start)
        if start is None:
            start = n_cur
        self._grow_to(n_new, want, compose_states(
            self._engine.GetQuantumState(), inner.GetQuantumState(),
            n_cur, inner.qubit_count, start))
        return start

    def Decompose(self, start, dest) -> None:
        inner = dest._engine if isinstance(dest, QHybrid) else dest
        self._engine.Decompose(start, inner)
        self._maybe_switch()
        if isinstance(dest, QHybrid):
            dest._maybe_switch()

    def Dispose(self, start, length, disposed_perm=None) -> None:
        self._engine.Dispose(start, length, disposed_perm)
        self._maybe_switch()

    def Allocate(self, start, length=1) -> int:
        n_cur = self._engine.qubit_count
        want = self._mode_for(n_cur + length)
        if want != self._mode_for(n_cur):
            zeros = np.zeros(1 << length, dtype=np.complex128)
            zeros[0] = 1.0
            self._grow_to(n_cur + length, want, compose_states(
                self._engine.GetQuantumState(), zeros, n_cur, length, start))
            return start
        res = self._engine.Allocate(start, length)
        self._maybe_switch()
        return res

    def Clone(self) -> "QHybrid":
        c = QHybrid.__new__(QHybrid)
        c._tpu_threshold = self._tpu_threshold
        c._pager_threshold = self._pager_threshold
        c._cuda_kwargs = dict(self._cuda_kwargs)
        c._devices = self._devices
        c._kwargs = dict(self._kwargs)
        c._failover_cpu = self._failover_cpu
        c._failed_over = self._failed_over
        # fresh stream: the clone must not consume the original's RNG
        c._kwargs["rng"] = self._kwargs["rng"].spawn()
        c._engine = self._engine.Clone()
        return c

    @property
    def qubit_count(self) -> int:
        return self._engine.qubit_count

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py): thresholds +
    # failover ceiling + the live engine (restored INTO this stack's
    # engine when the mode matches, else rebuilt standalone on this
    # stack's device)
    # ------------------------------------------------------------------

    _ckpt_kind = "hybrid"

    def _ckpt_capture(self, capture_child):
        # the ceiling "cuda" is the file's "tpu": the JAX QHybrid compares
        # it with its dense mode's name
        fo = self._failed_over
        return {"kind": "hybrid",
                "meta": {"n": self.qubit_count,
                         "tpu_threshold": int(self._tpu_threshold),
                         "pager_threshold": int(self._pager_threshold),
                         "failed_over": "tpu" if fo == "cuda" else fo},
                "children": {"engine": capture_child(self._engine)}}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self._tpu_threshold = int(meta["tpu_threshold"])
        self._pager_threshold = int(meta["pager_threshold"])
        fo = meta.get("failed_over")
        self._failed_over = "cuda" if fo == "tpu" else fo
        self._engine = restore_child(children["engine"], self._engine)
        rng = getattr(self._engine, "rng", None)
        if rng is not None:
            # future mode switches must carry the restored stream
            self._kwargs["rng"] = rng
