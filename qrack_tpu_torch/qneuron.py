"""QNeuron: quantum perceptron with per-control-permutation RY weights.

Re-design of the reference neuron (reference: include/qneuron.hpp:25 —
output prepared to |+>-like RY(pi/2), uniformly-controlled RY by input
permutation, activation functions applied to angles, gradient-free
Learn/LearnPermutation by angle nudging)."""

from __future__ import annotations

import math
from enum import IntEnum
from typing import Optional, Sequence

import numpy as np


class ActivationFn(IntEnum):
    Sigmoid = 0
    ReLU = 1
    GeLU = 2
    Generalized_Logistic = 3
    Leaky_ReLU = 4


class QNeuron:
    def __init__(self, qreg, input_indices: Sequence[int], output_index: int,
                 activation_fn: ActivationFn = ActivationFn.Sigmoid,
                 alpha: float = 1.0, tolerance: float = 1e-6):
        self.qreg = qreg
        self.input_indices = list(input_indices)
        self.output_index = int(output_index)
        self.activation_fn = activation_fn
        self.alpha = float(alpha)
        self.tolerance = float(tolerance)
        self.angles = np.zeros(1 << len(self.input_indices), dtype=np.float64)

    # ------------------------------------------------------------------

    def _activated(self) -> np.ndarray:
        a = self.angles
        fn = self.activation_fn
        if fn == ActivationFn.ReLU:
            return np.maximum(0.0, a)
        if fn == ActivationFn.GeLU:
            return a * (1.0 + np.vectorize(math.erf)(a * math.sqrt(0.5)))
        if fn == ActivationFn.Generalized_Logistic:
            return a / np.power(1.0 + np.exp(-self.alpha * a), 1.0 / self.alpha)
        if fn == ActivationFn.Leaky_ReLU:
            return np.maximum(self.alpha * a, a)
        return a  # Sigmoid default: raw angles

    def Predict(self, expected: bool = True, reset_init: bool = True) -> float:
        """(reference: include/qneuron.hpp:128)."""
        q = self.qreg
        if reset_init:
            q.SetBit(self.output_index, False)
            q.RY(math.pi / 2, self.output_index)
        ang = self._activated()
        if not self.input_indices:
            q.RY(float(ang[0]), self.output_index)
        else:
            q.UniformlyControlledRY(self.input_indices, self.output_index, ang)
        prob = q.Prob(self.output_index)
        return prob if expected else (1.0 - prob)

    def Unpredict(self, expected: bool = True) -> float:
        """Uncompute Predict (reference: include/qneuron.hpp:196)."""
        q = self.qreg
        ang = -self._activated()
        if not self.input_indices:
            q.RY(float(ang[0]), self.output_index)
        else:
            q.UniformlyControlledRY(self.input_indices, self.output_index, ang)
        prob = q.Prob(self.output_index)
        return prob if expected else (1.0 - prob)

    def LearnCycle(self, expected: bool = True) -> float:
        """Predict + Unpredict probe (reference: include/qneuron.hpp:253)."""
        result = self.Predict(expected, reset_init=False)
        self.Unpredict(expected)
        return result

    def Learn(self, eta: float, expected: bool = True, reset_init: bool = True) -> None:
        """Nudge every permutation angle (reference: include/qneuron.hpp:269
        — Predict, Unpredict, then probe each permutation)."""
        start = self.Predict(expected, reset_init)
        self.Unpredict(expected)
        if start >= 1.0 - self.tolerance:
            return
        for perm in range(len(self.angles)):
            start = self._learn_internal(expected, eta, perm, start)
            if start >= 1.0 - self.tolerance:
                break

    def LearnPermutation(self, eta: float, expected: bool = True,
                         reset_init: bool = True) -> None:
        """Nudge only the angle of the measured input permutation
        (reference: include/qneuron.hpp:295 — collapsing M on the
        inputs selects an actually-sampled basis state)."""
        start = self.Predict(expected, reset_init)
        self.Unpredict(expected)
        perm = 0
        for j, idx in enumerate(self.input_indices):
            if self.qreg.M(idx):
                perm |= 1 << j
        self._learn_internal(expected, eta, perm, start)

    def _learn_internal(self, expected: bool, eta: float, perm: int,
                        start_prob: float) -> float:
        orig = self.angles[perm]
        self.angles[perm] = orig + eta * math.pi
        plus = self.LearnCycle(expected)
        if plus > start_prob + self.tolerance:
            return plus
        self.angles[perm] = orig - eta * math.pi
        minus = self.LearnCycle(expected)
        if minus > start_prob + self.tolerance:
            return minus
        self.angles[perm] = orig
        return start_prob
