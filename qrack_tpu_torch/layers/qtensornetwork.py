"""QTensorNetwork: circuit buffering with past-light-cone elision.

Re-design of the reference layer (reference:
include/qtensornetwork.hpp:30 — buffers gates into a QCircuit; on any
observable query materializes only the past light cone of the measured
qubits into the stack below; RunAsAmplitudes :73-83, MakeLayerStack
src/qtensornetwork.cpp:115).

Measurement re-buffering (reference: the measurement-layer circuit
history, include/qtensornetwork.hpp:73-83): a collapsing measurement
runs the pending circuit into a *base* stack, collapses there, and then
buffering resumes — the collapsed stack becomes the initial state for
the next circuit segment, so gate streams interleaved with mid-circuit
measurements keep the light-cone elision instead of permanently
materializing.

Port note: a copy of the JAX package's layers/qtensornetwork.py whose
default stack is the port's QUnit; every stack it builds takes the
constructor's keyword arguments (``device``, ``dtype``) and a spawn of
the dedicated construction stream, in the JAX package's order.  A cone
of 13 qubits or more becomes a QUnit unit on the card (QHybrid's CUDA
half, the window kernel)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..interface import QInterface
from .qcircuit import QCircuit


def _default_stack_factory(n, **kw):
    from .qunit import QUnit

    return QUnit(n, **kw)


class QTensorNetwork(QInterface):
    def __init__(self, qubit_count: int, init_state: int = 0,
                 stack_factory: Optional[Callable] = None, **kwargs):
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        self._factory = stack_factory or _default_stack_factory
        self._kw = {k: v for k, v in kwargs.items() if k != "rng"}
        self._init_state = init_state
        self.circuit = QCircuit(qubit_count)
        self.sim = None  # materialized lower stack
        # dedicated stream for stack construction so materialization never
        # consumes from the measurement stream (reproducibility)
        self._stack_rng = self.rng.spawn()

    # ------------------------------------------------------------------

    def _buffering(self) -> bool:
        return bool(self.circuit.gates) or self.sim is None

    def _materialize(self) -> None:
        """Run the pending circuit into the base stack (reference:
        MakeLayerStack); buffering resumes afterwards with the base as
        the new segment's initial state."""
        if self.sim is None:
            self.sim = self._factory(self.qubit_count,
                                     init_state=self._init_state,
                                     rng=self._stack_rng.spawn(), **self._kw)
        if self.circuit.gates:
            self.circuit.RunFused(self.sim)
        self.circuit = QCircuit(self.qubit_count)

    def _light_cone_query(self, qubits, fn):
        """Query an observable through a temporary light-cone stack
        without materializing (reference: RunAsAmplitudes)."""
        if not self.circuit.gates:
            if self.sim is not None:
                return fn(self.sim)
            self._materialize()
            return fn(self.sim)
        circ = self.circuit.PastLightCone(qubits)
        if self.sim is not None:
            tmp = self.sim.Clone()
        else:
            tmp = self._factory(self.qubit_count, init_state=self._init_state,
                                rng=self._stack_rng.spawn(), **self._kw)
        # per-gate path here: light-cone circuits are fresh objects per
        # query, so a fused compile could never be cache-hit — the
        # module-level per-gate kernels are already compiled process-wide.
        # RunFused stays reserved for the one-shot full materialization.
        circ.Run(tmp)
        return fn(tmp)

    # ------------------------------------------------------------------
    # gate primitive: buffer (always — measurement re-buffering keeps
    # post-collapse gates in the IR too)
    # ------------------------------------------------------------------

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        m = np.asarray(mtrx, dtype=np.complex128).reshape(2, 2)
        self.circuit.append_ctrl(tuple(controls), target, m, perm)

    # ------------------------------------------------------------------
    # observables
    # ------------------------------------------------------------------

    def Prob(self, q: int) -> float:
        return self._light_cone_query([q], lambda s: s.Prob(q))

    def GetAmplitude(self, perm: int) -> complex:
        return self._light_cone_query(range(self.qubit_count),
                                      lambda s: s.GetAmplitude(perm))

    def GetQuantumState(self) -> np.ndarray:
        return self._light_cone_query(range(self.qubit_count),
                                      lambda s: np.asarray(s.GetQuantumState()))

    def GetProbs(self) -> np.ndarray:
        return self._light_cone_query(range(self.qubit_count),
                                      lambda s: np.asarray(s.GetProbs()))

    def ForceM(self, q: int, result: bool, do_force: bool = True, do_apply: bool = True) -> bool:
        if do_apply:
            self._materialize()
            # draw the collapse from OUR measurement stream, then restore
            # the base's own stream so later query-path clones never
            # consume from (and desync) the measurement stream
            saved = self.sim.rng
            self.sim.rng = self.rng
            try:
                return self.sim.ForceM(q, result, do_force, do_apply)
            finally:
                self.sim.rng = saved
        return self._light_cone_query([q], lambda s: s.ForceM(q, result, do_force, False))

    def MultiShotMeasureMask(self, q_powers, shots: int) -> dict:
        from ..utils.bits import log2

        bits = [log2(int(p)) for p in q_powers]
        return self._light_cone_query(
            bits, lambda s: s.MultiShotMeasureMask(q_powers, shots))

    def ExpectationBitsAll(self, bits, offset: int = 0) -> float:
        return self._light_cone_query(
            list(bits), lambda s: s.ExpectationBitsAll(bits, offset))

    # ------------------------------------------------------------------
    # structure / state
    # ------------------------------------------------------------------

    def SetPermutation(self, perm: int, phase=None) -> None:
        self.circuit = QCircuit(self.qubit_count)
        self.sim = None
        self._init_state = perm

    def _sync_from_sim(self) -> None:
        self.qubit_count = self.sim.qubit_count
        self.circuit = QCircuit(self.qubit_count)

    def SetQuantumState(self, state) -> None:
        self._materialize()
        self.sim.SetQuantumState(state)

    def Compose(self, other, start: Optional[int] = None) -> int:
        self._materialize()
        inner = other
        if isinstance(other, QTensorNetwork):
            oc = other.Clone()
            oc._materialize()
            inner = oc.sim
        res = self.sim.Compose(inner, start)
        self._sync_from_sim()
        return res

    def Decompose(self, start: int, dest) -> None:
        self._materialize()
        if isinstance(dest, QTensorNetwork):
            dest._materialize()
            self.sim.Decompose(start, dest.sim)
            dest._sync_from_sim()
        else:
            self.sim.Decompose(start, dest)
        self._sync_from_sim()

    def Dispose(self, start: int, length: int, disposed_perm: Optional[int] = None) -> None:
        self._materialize()
        self.sim.Dispose(start, length, disposed_perm)
        self._sync_from_sim()

    def Allocate(self, start: int, length: int = 1) -> int:
        if start == self.qubit_count:
            # append never shifts existing indices: widen the register
            # (new qubits start |0>; init-state bits above the old width
            # are zero by invariant), pending gates stay buffered
            if self.sim is not None:
                self.sim.Allocate(start, length)
            self.qubit_count += length
            self.circuit.qubit_count = self.qubit_count
            return start
        # mid-insertion or pending gates: flush the segment first so
        # buffered gate indices never need shifting
        self._materialize()
        res = self.sim.Allocate(start, length)
        self._sync_from_sim()
        return res

    def Clone(self) -> "QTensorNetwork":
        c = QTensorNetwork(self.qubit_count, init_state=self._init_state,
                           stack_factory=self._factory, rng=self.rng.spawn(),
                           **self._kw)
        c._stack_rng = self._stack_rng.spawn()
        c.circuit = self.circuit.clone()
        c.sim = self.sim.Clone() if self.sim is not None else None
        return c

    def SumSqrDiff(self, other) -> float:
        a = self.GetQuantumState()
        b = np.asarray(other.GetQuantumState(), dtype=np.complex128)
        inner = np.vdot(a, b)
        return float(max(0.0, 1.0 - abs(inner) ** 2))

    def GetDepth(self) -> int:
        return self.circuit.GetDepth()

    def Finish(self) -> None:
        if self.sim is not None:
            self.sim.Finish()

    def isBuffering(self) -> bool:
        return self._buffering()
