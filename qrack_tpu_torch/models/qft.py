"""Whole-circuit QFT programs: the flagship fused workload.

Gate order matches QInterface::QFT (reference:
src/qinterface/qinterface.cpp:114), so a circuit run, a whole-QFT
program and an engine ``QFT`` call give the same state gate for gate.

* :func:`qft_qcircuit` is the QFT as a QCircuit, the form the window
  kernel and the batched circuit programs take.
* :func:`qft_planes` / :func:`iqft_planes` / :func:`qft_planes_fast`
  apply the whole QFT to (2, 2^n) planes as plain torch passes (the JAX
  package traced them into one XLA program): n H gates, and each stage's
  controlled phases as one elementwise pass.  No hand-written kernel.

* :func:`make_sharded_qft_fn` is the whole QFT over a ket in pages (a
  list of (2, 2^L) tensors, the pager's layout, ops/sharded.py): in-page
  H gates and each stage's phases per page, paged H targets as the
  pager's in-place pair mix; every pass in place, block by block, so it
  needs no page-sized temporary.  :func:`basis_pages` makes the pages of
  a basis state.
"""

from __future__ import annotations

import cmath
import math
import os

import torch

from .. import matrices as mat
from ..layers.qcircuit import QCircuit
from ..ops import gatekernels as gk
from ..ops import sharded as shb
from ..utils.device import resolve_device


def _h_mp(dtype):
    """H as host matrix planes in the planes' dtype."""
    s = 1.0 / math.sqrt(2.0)
    return gk.host_tensor([[[s, s], [s, -s]], [[0.0, 0.0], [0.0, 0.0]]],
                          dtype)


def _stage_phase(planes, pairs):
    """ONE elementwise pass applying a whole stage's controlled phases:
    diagonal gates commute, so their product is a single exp(i theta(idx))
    with theta = sum over (c, t, ang) of ang * bit_c(idx) * bit_t(idx)."""
    acc = gk.compute_dtype(planes.dtype)
    idx = gk.iota_for(planes)
    theta = torch.zeros(planes.shape[-1], dtype=acc, device=planes.device)
    for c, t, ang in pairs:
        on = ((idx >> c) & (idx >> t) & 1).to(acc)
        theta = theta + on * torch.tensor(ang, dtype=acc)
    return gk.cmul(torch.cos(theta).to(planes.dtype),
                   torch.sin(theta).to(planes.dtype), planes)


def qft_planes(planes, n: int):
    """Single-shard QFT over all n qubits; returns new planes."""
    hm = _h_mp(planes.dtype)
    end = n - 1
    for i in range(n):
        h_bit = end - i
        if i:
            planes = _stage_phase(planes, [
                (h_bit, h_bit + 1 + j, math.pi / (1 << (j + 1)))
                for j in range(i)])
        planes = gk.apply_2x2(planes, hm, n, h_bit)
    return planes


def iqft_planes(planes, n: int):
    """The inverse of :func:`qft_planes`; returns new planes."""
    hm = _h_mp(planes.dtype)
    for i in range(n):
        if i:
            planes = _stage_phase(planes, [
                (i - (j + 1), i, -math.pi / (1 << (j + 1)))
                for j in range(i)])
        planes = gk.apply_2x2(planes, hm, n, i)
    return planes


def _carried_phase(planes, frac, h_bit: int, sign: float):
    """One stage's controlled phases from the carried fraction:
    theta(idx) = sign * pi * bit_h(idx) * frac(idx)."""
    acc = frac.dtype
    idx = gk.iota_for(planes)
    on = ((idx >> h_bit) & 1).to(acc)
    theta = torch.tensor(sign * math.pi, dtype=acc) * on * frac
    return gk.cmul(torch.cos(theta).to(planes.dtype),
                   torch.sin(theta).to(planes.dtype), planes)


def qft_planes_fast(planes, n: int, inverse: bool = False):
    """O(n)-pass QFT: stage i's angle sum  sum_j bit_{h+1+j} * pi/2^(j+1)
    obeys the exact recurrence  frac_h = (frac_{h+1} + bit_{h+1}) / 2, so
    one carried (2^n,) fraction replaces the per-stage O(i) term sums of
    :func:`qft_planes` (O(n^2) passes over the ket) at the cost of one
    extra array.  The same gate order as qft_planes/iqft_planes; float32
    carried fractions add <= 2^-24 relative angle error."""
    hm = _h_mp(planes.dtype)
    acc = gk.compute_dtype(planes.dtype)
    idx = gk.iota_for(planes)
    frac = torch.zeros(planes.shape[-1], dtype=acc, device=planes.device)
    half = torch.tensor(0.5, dtype=acc)
    end = n - 1
    for i in range(n):
        h_bit = i if inverse else end - i
        if i:
            prev = h_bit - 1 if inverse else h_bit + 1
            pb = ((idx >> prev) & 1).to(acc)
            frac = (frac + pb) * half
            planes = _carried_phase(planes, frac, h_bit,
                                    -1.0 if inverse else 1.0)
        planes = gk.apply_2x2(planes, hm, n, h_bit)
    return planes


# From this width the carried-fraction form is the default on a CUDA
# device, where the unrolled form's O(n^2) passes over the ket cost more
# than its one extra array (the JAX package chose by compile time; an
# eager torch program has none).
FAST_COMPILE_QB = int(os.environ.get("QRACK_QFT_FAST_QB", "23"))


def default_fast(n: int, device=None) -> bool:
    """Whether make_qft_fn takes the carried-fraction form for planes on
    `device`: from FAST_COMPILE_QB qubits on a CUDA device, the unrolled
    form on the CPU — unless QRACK_QFT_FAST_QB is set, in which case its
    threshold decides on every device.  The variable is re-read here so
    a threshold set after import is honored."""
    env = os.environ.get("QRACK_QFT_FAST_QB")
    threshold = int(env) if env is not None else FAST_COMPILE_QB
    if n < threshold:
        return False
    if env is not None:
        return True
    return device is not None and torch.device(device).type == "cuda"


def make_qft_fn(n: int, inverse: bool = False, fast: bool | None = None):
    """The whole QFT (or IQFT) over (2, 2^n) planes: fn(planes) -> new
    planes.  With ``fast=None`` the form follows :func:`default_fast` on
    the planes' device."""

    def fn(planes):
        use_fast = default_fast(n, planes.device) if fast is None else fast
        if use_fast:
            return qft_planes_fast(planes, n, inverse)
        return (iqft_planes if inverse else qft_planes)(planes, n)

    return fn


def qft_qcircuit(n: int, inverse: bool = False) -> QCircuit:
    """The n-qubit QFT (or its inverse) as a QCircuit: n H gates and
    n(n-1)/2 controlled phases, in QInterface.QFT's order."""
    circ = QCircuit(n)
    end = n - 1
    for i in range(n):
        h_bit = i if inverse else end - i
        if i:
            for j in range(i):
                other = h_bit - 1 - j if inverse else h_bit + 1 + j
                ang = (-1.0 if inverse else 1.0) * math.pi / (1 << (j + 1))
                circ.append_ctrl((other,), h_bit,
                                 mat.phase_mtrx(1.0, cmath.exp(1j * ang)), 1)
        circ.append_1q(h_bit, mat.H2)
    return circ


def basis_planes(n: int, perm: int, dtype=torch.float32, device=None):
    """|perm> as (2, 2^n) planes, on ``cuda`` unless `device` says
    otherwise."""
    st = torch.zeros((2, 1 << n), dtype=dtype, device=resolve_device(device))
    st[0, perm] = 1.0
    return st


# ---------------------------------------------------------------------------
# the whole QFT over pages
# ---------------------------------------------------------------------------

def _gbit(pid: int, lidx, L: int, b: int):
    """Bit b of the global index (pid << L) | lidx."""
    return ((lidx >> b) & 1) if b < L else ((pid >> (b - L)) & 1)


def _sharded_h(pages, hm, L: int, target: int) -> None:
    """H on every page: an in-page target per page, a page-bit target as
    the pager's in-place pair mix of two pages (reference discipline:
    ShuffleBuffers, src/qpager.cpp:400-447)."""
    if target < L:
        shb.apply_local_2x2(pages, hm, L, target, 0, 0, 0, 0)
    else:
        shb.apply_global_2x2(pages, hm, target - L, 0, 0, 0, 0)


def _sharded_stage_phase(pages, L: int, pairs) -> None:
    """A whole stage of controlled phases as one pass over the pages, in
    place: theta = sum of ang * bit_c * bit_t, the bits read from the
    in-page index or the page id (see _stage_phase)."""
    dt = pages[0].dtype
    acc = gk.compute_dtype(dt)

    def body(xp, pid, lidx, L_):
        theta = torch.zeros(lidx.shape, dtype=acc, device=lidx.device)
        for c, t, ang in pairs:
            on = _gbit(pid, lidx, L, c) & _gbit(pid, lidx, L, t)
            on = on.to(acc) if isinstance(on, torch.Tensor) else float(on)
            theta = theta + on * torch.tensor(ang, dtype=acc)
        return torch.cos(theta).to(dt), torch.sin(theta).to(dt)

    shb.apply_split_factor(pages, L, body, ())


# the carried fraction read one byte at a time: bit r of a byte weighs
# 2^-(r+1), so a byte's fraction is its bit reversal over 256 (exact in
# float32)
_REV8_FRAC = [int(f"{v:08b}"[::-1], 2) / 256.0 for v in range(256)]


def _carried_stage_phase(pages, L: int, h_bit: int, i: int,
                         inverse: bool) -> None:
    """Stage i of the carried-fraction QFT, in place: theta = +-pi *
    bit_h * frac, frac the value of the JAX package's carried fraction
    after i stages, the binary fraction 0.b_{h+1} ... b_{h+i} (forward)
    or 0.b_{h-1} ... b_{h-i} (inverse) of the global index, read per
    block: the in-page bits in int32 and float32 lanes, the page bits as
    one constant a page.  The JAX package carries it in a ket-sized
    array (16 GiB of float32 beside w32 pages); both round it to
    float32."""
    dt = pages[0].dtype
    acc = gk.compute_dtype(dt)
    sign = -math.pi if inverse else math.pi
    # the fraction's bits: position -> weight
    weights = ({h_bit - k: 2.0 ** -k for k in range(1, i + 1)} if inverse
               else {h_bit + k: 2.0 ** -k for k in range(1, i + 1)})
    lo_bits = sorted(b for b in weights if b < L)
    lo0 = lo_bits[0] if lo_bits else 0
    cnt = len(lo_bits)   # contiguous in-page bits [lo0, lo0 + cnt)

    def body(xp, pid, lidx, L_):
        const = sum(w for b, w in weights.items()
                    if b >= L and (pid >> (b - L)) & 1)
        on = _gbit(pid, lidx, L, h_bit)
        if isinstance(on, int) and not on:
            return 1.0, 0.0
        frac = None
        if cnt:
            field = (lidx >> lo0) & ((1 << cnt) - 1)
            if inverse:
                # bit m of the field weighs 2^(lo0 + m - h)
                frac = field.to(acc) * (2.0 ** (lo0 - h_bit))
            else:
                rev = torch.tensor(_REV8_FRAC, dtype=acc, device=lidx.device)
                for j in range(0, cnt, 8):
                    part = rev[(field >> j) & 255] * 2.0 ** -j
                    frac = part if frac is None else frac + part
            frac = frac + const
        else:
            frac = torch.full(lidx.shape, const, dtype=acc, device=lidx.device)
        theta = frac * sign
        if not isinstance(on, int):
            theta = theta * on.to(acc)
        return torch.cos(theta).to(dt), torch.sin(theta).to(dt)

    shb.apply_split_factor(pages, L, body, ())


def make_sharded_qft_fn(pages, n: int, inverse: bool = False,
                        fast: bool | None = None, device=None):
    """The whole QFT (or IQFT) over a ket in pages.  `pages` is a page
    count (each page on `device`, ``cuda`` by default) or a device list
    that may repeat a device (the JAX package takes a Mesh).  Returns
    (fn, devices): fn(page list) applies the QFT to the (2, 2^L) pages
    in place and returns them.  `fast` takes the carried-fraction form
    (one elementwise pass a stage, whatever its width); None follows
    :func:`default_fast` on the pages' device.  The gate order is
    QInterface.QFT's, as in :func:`qft_planes`.  Over the cluster's page
    homes (``cluster.global_page_devices``) every process runs fn on its
    page list, whose other pages are placeholders (:func:`basis_pages`),
    with the same calls."""
    devs = shb.page_devices(pages, device)
    L = n - (len(devs).bit_length() - 1)
    if L < 1:
        raise ValueError("at least one in-page qubit a page")
    if fast is None:
        fast = default_fast(n, shb.local_device(devs))

    def fn(pgs):
        hm = _h_mp(pgs[0].dtype)
        end = n - 1
        for i in range(n):
            h_bit = i if inverse else end - i
            if i:
                if fast:
                    _carried_stage_phase(pgs, L, h_bit, i, inverse)
                elif inverse:
                    _sharded_stage_phase(pgs, L, [
                        (i - (j + 1), i, -math.pi / (1 << (j + 1)))
                        for j in range(i)])
                else:
                    _sharded_stage_phase(pgs, L, [
                        (h_bit, h_bit + 1 + j, math.pi / (1 << (j + 1)))
                        for j in range(i)])
            _sharded_h(pgs, hm, L, h_bit)
        return pgs

    return fn, devs


def basis_pages(n: int, perm: int, devices, dtype=torch.float32):
    """|perm> as the (2, 2^L) pages of `devices` (a page count is taken
    on ``cuda``, as :func:`make_sharded_qft_fn` takes it; the cluster's
    page homes give this process's pages and placeholders for the
    others')."""
    devs = shb.page_devices(devices)
    L = n - (len(devs).bit_length() - 1)
    pages = shb.new_pages(devs, L, dtype)
    if not shb.is_remote(pages[perm >> L]):
        pages[perm >> L][0, perm & ((1 << L) - 1)] = 1.0
    return pages
