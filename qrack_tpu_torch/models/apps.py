"""Physics/optimization application drivers over the QInterface API.

Counterparts of the reference's application scripts (reference:
scripts/tfim_* and ising_depth_series.py — transverse-field Ising
magnetization series; scripts/maxcut_* — QAOA max-cut; scripts/qrng.py
— hardware-style random bits).  Each function drives a user-supplied
simulator through the public gate surface only, so any terminal of the
port ("cuda", "cpu", "hybrid", "turboquant") can run them.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ..hamiltonian import HamiltonianOp, uniform_hamiltonian_op
from .. import matrices as mat


def tfim_hamiltonian(n: int, j_coupling: float, h_field: float):
    """Open-chain transverse-field Ising H = -J sum Z_i Z_{i+1}
    - h sum X_i as TimeEvolve terms: each ZZ bond is a uniform
    controlled term (payload -J*Z or +J*Z by the control bit), each
    field term a bare -h*X generator."""
    ham: List[HamiltonianOp] = []
    Z = np.asarray(mat.Z2)
    X = np.asarray(mat.X2)
    for i in range(n - 1):
        ham.append(uniform_hamiltonian_op(
            (i,), i + 1, np.stack([-j_coupling * Z, j_coupling * Z])))
    for i in range(n):
        ham.append(HamiltonianOp(target=i, matrix=-h_field * X))
    return ham


def tfim_magnetization_series(qsim, j_coupling: float, h_field: float,
                              dt: float, steps: int) -> List[float]:
    """Trotterized quench from |0...n>: per step, TimeEvolve by dt and
    record the mean magnetization <Z> = 1 - 2*mean(Prob)."""
    n = qsim.GetQubitCount()
    ham = tfim_hamiltonian(n, j_coupling, h_field)
    out = []
    for _ in range(steps):
        qsim.TimeEvolve(ham, dt)
        # all n marginals from ONE full-state pass (n separate Prob(q)
        # calls would each rescan the 2^n amplitudes)
        p = np.asarray(qsim.GetProbs())
        idx = np.arange(p.size)
        mz = sum(1.0 - 2.0 * float(p[((idx >> q) & 1) == 1].sum())
                 for q in range(n))
        out.append(mz / n)
    return out


def qaoa_maxcut_expectation(qsim_factory, edges: Sequence[Tuple[int, int]],
                            n: int, gammas: Sequence[float],
                            betas: Sequence[float]) -> float:
    """Expected cut value of the depth-p QAOA state: cost unitaries are
    ZZ phase rotations (CNOT - RZ - CNOT), the mixer is RX on every
    qubit; <cut> = sum_edges (1 - <Z_a Z_b>)/2 via two-qubit joint
    probabilities."""
    q = qsim_factory(n)
    for i in range(n):
        q.H(i)
    for g, b in zip(gammas, betas):
        for (a, c) in edges:
            q.CNOT(a, c)
            q.RZ(2.0 * g, c)
            q.CNOT(a, c)
        for i in range(n):
            q.RX(2.0 * b, i)
    # every edge's <Z_a Z_b> from ONE full-state pass (per-edge ProbMask
    # calls would each re-densify and rescan the 2^n amplitudes)
    p = np.asarray(q.GetProbs())
    idx = np.arange(p.size)
    total = 0.0
    for (a, c) in edges:
        differ = ((idx >> a) ^ (idx >> c)) & 1
        total += float(p[differ == 1].sum())
    return total


def qaoa_maxcut_grid(qsim_factory, edges, n: int, p: int = 1,
                     resolution: int = 8) -> Tuple[float, Tuple]:
    """Coarse grid search over (gamma, beta)^p (the reference script
    optimizes classically too); returns (best expected cut, angles)."""
    grid = [math.pi * (k + 0.5) / resolution for k in range(resolution)]
    # greedy layer-by-layer extension keeps the search tiny (p=1 is
    # simply one greedy layer = the exhaustive (gamma, beta) grid);
    # the grid has no ~identity angles, so a deeper layer can only
    # hurt — stop (and keep the shallower answer) when it does
    best, best_angles = -1.0, None
    gs: List[float] = []
    bs: List[float] = []
    for _ in range(p):
        layer_best, pick = -1.0, None
        for g in grid:
            for b in grid:
                v = qaoa_maxcut_expectation(
                    qsim_factory, edges, n, gs + [g], bs + [b])
                if v > layer_best:
                    layer_best, pick = v, (g, b)
        if layer_best <= best:
            break
        gs.append(pick[0])
        bs.append(pick[1])
        best, best_angles = layer_best, (tuple(gs), tuple(bs))
    return best, best_angles


def brute_force_maxcut(edges, n: int) -> int:
    best = 0
    for s in range(1 << n):
        cut = sum(1 for (a, b) in edges if ((s >> a) ^ (s >> b)) & 1)
        best = max(best, cut)
    return best


def qrng_bits(qsim_factory, n_bits: int, width: int = 8) -> List[int]:
    """Measurement-based random bits, `width` at a time (reference:
    scripts/qrng.py)."""
    out: List[int] = []
    while len(out) < n_bits:
        q = qsim_factory(width)
        for i in range(width):
            q.H(i)
        v = q.MAll()
        out.extend(((v >> i) & 1) for i in range(width))
    return out[:n_bits]
