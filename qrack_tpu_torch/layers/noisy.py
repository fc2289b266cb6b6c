"""QInterfaceNoisy: stochastic depolarizing-noise wrapper.

Re-design of the reference wrapper (reference:
include/qinterface_noisy.hpp:26-60 — after each gate, a weak 1-qubit
depolarizing channel on every touched qubit; noise level from the ctor
or QRACK_GATE_DEPOLARIZATION; log-fidelity accounting).

Port note: a copy of the JAX package's layers/noisy.py whose default
inner stack is the port's QUnit; the channel is the interface's
DepolarizingChannelWeak1Qb (interface/base.py), drawn from this
wrapper's stream."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..interface import QInterface


class QInterfaceNoisy(QInterface):
    def __init__(self, qubit_count: int, init_state: int = 0,
                 inner_factory=None, noise: Optional[float] = None, **kwargs):
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        if inner_factory is None:
            from .qunit import QUnit

            inner_factory = QUnit
        self._inner_factory = inner_factory
        self.inner = inner_factory(qubit_count, init_state=init_state,
                                   rng=self.rng.spawn(),
                                   **{k: v for k, v in kwargs.items() if k != "rng"})
        self.noise = noise if noise is not None else self.config.gate_depolarization
        self.log_fidelity = 0.0

    def SetNoiseParameter(self, lam: float) -> None:
        self.noise = float(lam)

    def GetUnitaryFidelity(self) -> float:
        return math.exp(self.log_fidelity)

    def ResetUnitaryFidelity(self) -> None:
        self.log_fidelity = 0.0

    def _apply_noise(self, qubits) -> None:
        if self.noise <= 0.0:
            return
        # one canonical channel implementation (QInterfaceBase); draw from
        # the wrapper's stream for reproducibility
        self.inner.rng = self.rng
        for q in set(qubits):
            self.inner.DepolarizingChannelWeak1Qb(q, self.noise)
            self.log_fidelity += math.log(max(1e-300, 1.0 - self.noise))

    # -- gate funnel points --

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        self.inner.MCMtrxPerm(controls, mtrx, target, perm)
        self._apply_noise((target,) + tuple(controls))

    def Apply4x4(self, m, q1, q2) -> None:
        self.inner.Apply4x4(m, q1, q2)
        self._apply_noise((q1, q2))

    def Swap(self, q1: int, q2: int) -> None:
        self.inner.Swap(q1, q2)
        self._apply_noise((q1, q2))

    # -- measurement / structure / state: pass through --

    def Prob(self, q: int) -> float:
        return self.inner.Prob(q)

    def ForceM(self, q, result, do_force=True, do_apply=True) -> bool:
        self.inner.rng = self.rng
        return self.inner.ForceM(q, result, do_force, do_apply)

    def MAll(self) -> int:
        self.inner.rng = self.rng
        return self.inner.MAll()

    def Compose(self, other, start=None) -> int:
        if isinstance(other, QInterfaceNoisy):
            inner = other.inner
            self.log_fidelity += other.log_fidelity
        else:
            inner = other
        res = self.inner.Compose(inner, start)
        self.qubit_count = self.inner.qubit_count
        return res

    def Decompose(self, start, dest) -> None:
        inner = dest.inner if isinstance(dest, QInterfaceNoisy) else dest
        self.inner.Decompose(start, inner)
        if isinstance(dest, QInterfaceNoisy):
            dest.qubit_count = inner.qubit_count
        self.qubit_count = self.inner.qubit_count

    def Dispose(self, start, length, disposed_perm=None) -> None:
        self.inner.Dispose(start, length, disposed_perm)
        self.qubit_count = self.inner.qubit_count

    def Allocate(self, start, length=1) -> int:
        res = self.inner.Allocate(start, length)
        self.qubit_count = self.inner.qubit_count
        return res

    def GetQuantumState(self) -> np.ndarray:
        return np.asarray(self.inner.GetQuantumState())

    def SetQuantumState(self, state) -> None:
        self.inner.SetQuantumState(state)

    def GetAmplitude(self, perm: int) -> complex:
        return self.inner.GetAmplitude(perm)

    def SetPermutation(self, perm: int, phase=None) -> None:
        self.inner.SetPermutation(perm, phase)

    def GetProbs(self) -> np.ndarray:
        return np.asarray(self.inner.GetProbs())

    def Clone(self) -> "QInterfaceNoisy":
        # avoid constructing (then discarding) a throwaway inner stack
        c = QInterfaceNoisy.__new__(QInterfaceNoisy)
        QInterface.__init__(c, self.qubit_count, rng=self.rng.spawn(),
                            do_normalize=self.do_normalize,
                            rand_global_phase=self.rand_global_phase)
        c._inner_factory = self._inner_factory
        c.noise = self.noise
        c.inner = self.inner.Clone()
        c.log_fidelity = self.log_fidelity
        return c

    def SumSqrDiff(self, other) -> float:
        inner = other.inner if isinstance(other, QInterfaceNoisy) else other
        return self.inner.SumSqrDiff(inner)

    def Finish(self) -> None:
        self.inner.Finish()
