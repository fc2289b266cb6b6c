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

The sharded program of the JAX package (make_sharded_qft_fn) is a
later part of the pager's port (ROADMAP item 13).
"""

from __future__ import annotations

import cmath
import math
import os

import torch

from .. import matrices as mat
from ..layers.qcircuit import QCircuit
from ..ops import gatekernels as gk
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
