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

:func:`make_sharded_grover_fn` runs the search over a ket in pages (the
pager's layout, ops/sharded.py), every pass in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import matrices as mat
from ..ops import gatekernels as gk
from ..ops import sharded as shb


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


def make_sharded_grover_fn(pages, n: int, target: int,
                           iters: int | None = None, fuse_qb: int = FUSE_QB,
                           device=None):
    """Grover over a ket in pages: `pages` is a page count (each on
    `device`, ``cuda`` by default) or a device list that may repeat a
    device (the JAX package takes a Mesh).  In-page H clusters run per
    page in place, page-bit H as the pager's pair mix; each phase flip
    negates its one amplitude where it lies (the JAX package multiplies
    the ket by a +-1 vector from split index reads: the same values).
    The JAX package's fori_loop is a Python loop.  Returns (fn, devices,
    iters); fn(page list) prepares the uniform superposition from |0>
    and runs `iters` iterations in place.  Over the cluster's page homes
    every process runs fn on its page list (as make_sharded_qft_fn); a
    flip lands where its amplitude's page lives."""
    devs = shb.page_devices(pages, device)
    L = n - (len(devs).bit_length() - 1)
    if L < 1:
        raise ValueError("at least one in-page qubit a page")
    if iters is None:
        iters = grover_iterations(n)
    target &= (1 << n) - 1
    t_lo, t_hi = target & ((1 << L) - 1), target >> L
    k = max(1, min(fuse_qb, L))

    def fn(pgs):
        dt = pgs[0].dtype
        clusters = _h_clusters(L, k, dt, "cpu")
        hmp = gk.mtrx_planes(np.asarray(mat.H2), dt, device="cpu")

        def h_all():
            for (c0, w, mp) in clusters:
                shb.apply_local_kxk(pgs, mp, L, c0, w)
            for q in range(L, n):
                shb.apply_global_2x2(pgs, hmp, q - L, 0, 0, 0, 0)

        h_all()
        for _ in range(iters):
            if not shb.is_remote(pgs[t_hi]):
                pgs[t_hi][:, t_lo] *= -1     # phase oracle on |target>
            h_all()
            if not shb.is_remote(pgs[0]):
                pgs[0][:, 0] *= -1           # diffusion: H . flip|0> . H
            h_all()
        return pgs

    return fn, devs, iters
