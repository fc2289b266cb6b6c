"""Fused random-circuit-sampling programs — the RCS headline benchmark.

The reference's RCS benchmarks dispatch one kernel per gate (reference:
test/benchmarks.cpp:4141 test_random_circuit_sampling_nn — random
sqrt-root layers + brick-wall ISwap couplers).  Here a whole depth-d
circuit is one plain torch program over (2, 2^n) planes, as it was one
XLA program in the JAX package: the single-qubit roots of a layer fuse
into 2^k-wide cluster contractions (gatekernels.apply_kxk) and each
coupler layer is one gather plus one phase pass.  No hand-written
kernel: the engine path of the same circuit
(algorithms.random_circuit_sampling) is the one that runs the window
kernel.

:func:`make_sharded_rcs_fn` runs the same plan over a ket in pages (the
pager's layout, ops/sharded.py), every pass in place, block by block.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import matrices as mat
from ..ops import gatekernels as gk
from ..ops import sharded as shb
from ..utils.rng import QrackRandom

_ISWAP4 = np.array(
    [[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]],
    dtype=np.complex128,
)
_ROOTS = (mat.SQRTX2, mat.SQRTY2, mat.SQRTW2)
# i^k for k = 0..3, split into real and imaginary parts
_IPOW_RE = (1.0, 0.0, -1.0, 0.0)
_IPOW_IM = (0.0, 1.0, 0.0, -1.0)


def rcs_layers(n: int, depth: int, seed: int):
    """Deterministic gate plan: per layer, a random root per qubit and the
    brick-wall ISwap pairing, drawn in the order of
    models.algorithms.random_circuit_sampling with QrackRandom(seed)."""
    rng = QrackRandom(seed)
    plan = []
    for d in range(depth):
        roots = [rng.randint(0, 3) for _ in range(n)]
        off = d & 1
        pairs = [(q, q + 1) for q in range(off, n - 1, 2)]
        plan.append((roots, pairs))
    return plan


def rcs_qcircuit(n: int, depth: int, seed: int):
    """The RCS gate plan as a ``QCircuit`` gate list.  ``QCircuitGate``
    is a controlled-1q payload model, so the brick-wall couplers are CZ
    instead of ISwap: same entangling topology, payload-representable."""
    from ..layers.qcircuit import QCircuit

    cz = mat.phase_mtrx(1.0, -1.0)
    c = QCircuit(n)
    for roots, pairs in rcs_layers(n, depth, seed):
        for q, g in enumerate(roots):
            c.append_1q(q, _ROOTS[g])
        for a, b in pairs:
            c.append_ctrl((a,), b, cz, 1)
    return c


def _iswap_layer(planes, pairs):
    """A whole brick-wall ISwap layer as ONE gather + ONE phase pass.

    ISwap = SWAP . diag(1, i, i, 1): disjoint pairs make the layer's
    permutation part one index map (each pair's two bits exchanged, which
    changes an index only where they differ) and its phase part i^(number
    of pairs whose bits differ) — one elementwise complex multiply.  The
    JAX package transposes one axis per qubit instead; torch caps a
    tensor at 25 dimensions, which a w30 ket's 31 axes would pass."""
    idx = gk.iota_for(planes)
    src, k = idx, None
    for (a, b) in pairs:
        t = ((idx >> a) ^ (idx >> b)) & 1
        src = src ^ ((t << a) | (t << b))
        k = t if k is None else k + t
    out = gk.gather(planes, src)
    k = k & 3
    re = torch.tensor(_IPOW_RE, dtype=planes.dtype).to(planes.device)[k]
    im = torch.tensor(_IPOW_IM, dtype=planes.dtype).to(planes.device)[k]
    return gk.cmul(re, im, out)


def _cluster_mats(roots, k: int):
    """Kron the layer's single-qubit roots into per-cluster 2^k x 2^k
    matrices over CONTIGUOUS qubit spans (all roots in a layer act on
    disjoint qubits, so grouping is exact).  np.kron(next, acc) keeps
    the earlier qubit least significant, matching the index convention."""
    out = []
    for c0 in range(0, len(roots), k):
        ms = [_ROOTS[g] for g in roots[c0:c0 + k]]
        acc = ms[0]
        for m in ms[1:]:
            acc = np.kron(m, acc)
        out.append((c0, len(ms), acc))
    return out


def resolve_fuse_qb(n: int, fuse_qb: int | None = None) -> int:
    """Single source of truth for the root-cluster width
    (QRACK_RCS_FUSE_QB, default 6)."""
    if fuse_qb is None:
        fuse_qb = int(os.environ.get("QRACK_RCS_FUSE_QB", "6"))
    return max(1, min(fuse_qb, n))


def make_rcs_fn(n: int, depth: int, seed: int, fuse_qb: int | None = None):
    """Whole-RCS program over (2, 2^n) planes, fn(planes) -> planes.

    Root layers fuse into 2^k-wide cluster contractions (one pass over
    the ket per cluster instead of per qubit); k defaults to
    QRACK_RCS_FUSE_QB (6); k=1 recovers the per-gate program.  The
    cluster matrices go to the planes' device once per call."""
    fuse_qb = resolve_fuse_qb(n, fuse_qb)
    plan = rcs_layers(n, depth, seed)
    baked = [(_cluster_mats(roots, fuse_qb), pairs)
             for (roots, pairs) in plan]

    def fn(planes):
        for (clusters, pairs) in baked:
            for (c0, w, m) in clusters:
                mp = gk.mtrx_planes(m, planes.dtype, device=planes.device)
                planes = gk.apply_kxk(planes, mp, n, c0, w)
            if pairs:
                planes = _iswap_layer(planes, pairs)
        return planes

    return fn


def make_sharded_rcs_fn(pages, n: int, depth: int, seed: int,
                        fuse_qb: int | None = None, device=None):
    """The whole-RCS program over a ket in pages: `pages` is a page count
    (each on `device`, ``cuda`` by default) or a device list that may
    repeat a device (the JAX package takes a Mesh).  Returns (fn,
    devices); fn(page list) runs the plan in place.

    Per layer the roots of the in-page qubits run as clusters capped at
    the page width (never straddling the page boundary), those of page
    qubits as the pager's pair mix; the coupler set splits by geometry:
      * pairs below the page boundary: an in-place swap of the two bits
        on every page and one phase pass, i^(pairs whose bits differ);
      * the pair straddling bits L-1 and L: the half of each page with
        the two bits unequal trades places with its partner page's, times
        i, pairwise and block by block (the JAX package's partner
        exchange, flip and select);
      * pairs of page bits: a relabeling of the page list (page_swap) and
        i on the pages whose two bits differ.
    Over the cluster's page homes every process runs fn on its page list
    (as make_sharded_qft_fn)."""
    devs = shb.page_devices(pages, device)
    g = len(devs).bit_length() - 1
    L = n - g
    if L < 1:
        raise ValueError("at least one in-page qubit a page")
    k = min(resolve_fuse_qb(n, fuse_qb), L)
    plan = rcs_layers(n, depth, seed)

    def fn(pgs):
        dt = pgs[0].dtype
        for (roots, pairs) in plan:
            for (c0, w, m) in _cluster_mats(roots[:L], k):
                shb.apply_local_kxk(pgs, gk.mtrx_planes(m, dt, device="cpu"),
                                    L, c0, w)
            for q in range(L, n):
                mp = gk.mtrx_planes(_ROOTS[roots[q]], dt, device="cpu")
                shb.apply_global_2x2(pgs, mp, q - L, 0, 0, 0, 0)
            loc_pairs = [(a, b) for (a, b) in pairs if b < L]
            if loc_pairs:
                for _p, page in shb.local_pages(pgs):
                    for a, b in loc_pairs:
                        shb.swap_bits_(page, L, a, b)

                def phase(xp, pid, lidx, L_, prs=loc_pairs):
                    kk = None
                    for a, b in prs:
                        t = ((lidx >> a) ^ (lidx >> b)) & 1
                        kk = t if kk is None else kk + t
                    kk = (kk & 3).to(torch.int64)
                    re = torch.tensor(_IPOW_RE, dtype=dt, device=lidx.device)
                    im = torch.tensor(_IPOW_IM, dtype=dt, device=lidx.device)
                    return re[kk], im[kk]

                shb.apply_split_factor(pgs, L, phase, ())
            for (a, b) in pairs:
                if a < L <= b:   # a == L-1, b == L by construction
                    shb.mixed_swap(pgs, L, a, b - L, factor=1j)
            for (a, b) in pairs:
                if a >= L:
                    ga, gb = a - L, b - L
                    pgs[:] = shb.page_swap(pgs, ga, gb)
                    for p, page in shb.local_pages(pgs):
                        if ((p >> ga) ^ (p >> gb)) & 1:
                            shb.scale_page_(page, 0.0, 1.0)
        return pgs

    return fn, devs


def reference_rcs_state(n: int, depth: int, seed: int, engine) -> np.ndarray:
    """Same plan through a gate-at-a-time engine (parity checking)."""
    plan = rcs_layers(n, depth, seed)
    for (roots, pairs) in plan:
        for q, g in enumerate(roots):
            engine.Mtrx(_ROOTS[g], q)
        for (a, b) in pairs:
            engine.Apply4x4(_ISWAP4, a, b)
    return np.asarray(engine.GetQuantumState())
