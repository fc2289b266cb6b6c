"""Fused Grover-search program — the loop-structured headline workload.

The reference benchmarks Grover as gate-at-a-time engine calls
(reference: test/benchmarks.cpp test_grover_search; examples/
grovers.cpp drives QInterface H/PhaseFlip per iteration).  Here one
Grover ITERATION is a handful of plain torch passes over (2, 2^n)
planes (oracle phase flip + H-ladder + |0> phase flip + H-ladder), and
the O(sqrt(N)) iterations are a Python loop over the same ops: the JAX
package's `lax.fori_loop`, which eager PyTorch has no need of.  H-ladders
use 2^k-wide cluster contractions (H^(x)k kron blocks), as models.rcs
does.  No hand-written kernel: the engine path of the same search
(algorithms.grover_search) is the one that runs the window kernel.

The sharded program of the JAX package (make_sharded_grover_fn) is a
later part of the pager's port (ROADMAP item 13).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import matrices as mat
from ..ops import gatekernels as gk


def grover_iterations(n: int) -> int:
    """floor(pi/4 * sqrt(N)) — the optimal rotation count."""
    return int(math.floor(math.pi / 4.0 * math.sqrt(float(1 << n))))


# H-ladder cluster width
FUSE_QB = 6


def _h_clusters(n: int, k: int, dtype, device):
    """H^(x)w kron blocks covering [0, n) in spans of width <= k, as
    matrix planes on `device`."""
    out = []
    for c0 in range(0, n, k):
        w = min(k, n - c0)
        acc = np.asarray(mat.H2)
        for _ in range(w - 1):
            acc = np.kron(np.asarray(mat.H2), acc)
        out.append((c0, w, gk.mtrx_planes(acc, dtype, device=device)))
    return out


def make_grover_fn(n: int, target: int, iters: int | None = None,
                   fuse_qb: int = FUSE_QB):
    """Whole-search program over (2, 2^n) planes: prepare the uniform
    superposition, then run the Grover iteration `iters` times.
    Returns (fn, iters)."""
    if iters is None:
        iters = grover_iterations(n)
    target &= (1 << n) - 1
    k = max(1, min(fuse_qb, n))

    def fn(planes):
        clusters = _h_clusters(n, k, planes.dtype, planes.device)
        idx = gk.iota_for(planes)
        oracle = torch.where(idx == target, -1.0, 1.0).to(planes.dtype)
        zflip = torch.where(idx == 0, -1.0, 1.0).to(planes.dtype)

        def h_all(p):
            for (c0, w, mp) in clusters:
                p = gk.apply_kxk(p, mp, n, c0, w)
            return p

        planes = h_all(planes)          # uniform superposition from |0>
        for _ in range(iters):
            planes = planes * oracle    # phase oracle on |target>
            planes = h_all(planes)
            planes = planes * zflip     # diffusion = H ladder . flip|0> . H ladder
            planes = h_all(planes)
        return planes

    return fn, iters


def success_probability(planes, target: int) -> float:
    p = planes[0] ** 2 + planes[1] ** 2
    return float(p[target] / p.sum())
