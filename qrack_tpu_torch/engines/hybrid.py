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

Switching by width is the design, not a fallback: no path catches a
device error and carries on on the CPU.  ``device=`` and ``dtype=`` go
to the CUDA engine and the pager; QEngineCPU takes neither.

Each switch and each grow across a mode is a telemetry event,
``hybrid.switch.<from>_to_<to>`` and ``hybrid.grow.<mode>``, with the
modes ``cpu``, ``cuda`` (the JAX package's ``tpu``) and ``pager``.  The
JAX QHybrid's failover and un-pin events come with its failover (ROADMAP
item 14b).

``HOST_STAGINGS`` counts the kets that pass through the host, and their
amplitudes: a whole ket when the width crosses the threshold
(``"switch"``), and the other operand of a Compose onto a CUDA engine
(``"compose"``, which QEngineCUDA and QPager pull through
GetQuantumState).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

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
                 devices=None, device=None, dtype=None, **kwargs):
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
        self._engine = self._make_engine(qubit_count, init_state)

    # ------------------------------------------------------------------

    def _mode_for(self, qubit_count: int) -> str:
        if qubit_count < self._tpu_threshold:
            return "cpu"
        if qubit_count <= self._pager_threshold:
            return "cuda"
        return "pager"

    def _make_engine(self, qubit_count: int, init_state: int = 0,
                     mode: Optional[str] = None):
        if mode is None:
            mode = self._mode_for(qubit_count)
        if mode == "cpu":
            return QEngineCPU(qubit_count, init_state=init_state, **self._kwargs)
        if mode == "cuda":
            return QEngineCUDA(qubit_count, init_state=init_state,
                               **self._cuda_kwargs, **self._kwargs)
        from ..parallel.pager import QPager

        return QPager(qubit_count, init_state=init_state,
                      devices=self._devices, **self._cuda_kwargs,
                      **self._kwargs)

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

    def __getattr__(self, name):
        if name == "_engine":  # not built yet: no forwarding loop
            raise AttributeError(name)
        return getattr(self._engine, name)

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
        # fresh stream: the clone must not consume the original's RNG
        c._kwargs["rng"] = self._kwargs["rng"].spawn()
        c._engine = self._engine.Clone()
        return c

    @property
    def qubit_count(self) -> int:
        return self._engine.qubit_count
