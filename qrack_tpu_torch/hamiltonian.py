"""Hamiltonian term containers for TimeEvolve trotterization.

Reference: include/hamiltonian.hpp:29-99 — HamiltonianOp (controlled 2x2
generator term, optional anti-control and per-control toggles) and
UniformHamiltonianOp (one 2x2 payload per control permutation). A
Hamiltonian is a plain list of these ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class HamiltonianOp:
    target: int
    matrix: np.ndarray  # 2x2 generator term (or [2^k, 2, 2] when uniform)
    controls: Sequence[int] = ()
    anti: bool = False
    uniform: bool = False
    toggles: Optional[Sequence[bool]] = None

    def __post_init__(self):
        self.matrix = np.asarray(self.matrix, dtype=np.complex128)


def uniform_hamiltonian_op(controls: Sequence[int], target: int, matrices: np.ndarray) -> HamiltonianOp:
    """One generator payload per control permutation (reference:
    UniformHamiltonianOp include/hamiltonian.hpp:69)."""
    m = np.asarray(matrices, dtype=np.complex128).reshape(-1, 2, 2)
    return HamiltonianOp(target=target, matrix=m, controls=tuple(controls), uniform=True)


Hamiltonian = List[HamiltonianOp]
