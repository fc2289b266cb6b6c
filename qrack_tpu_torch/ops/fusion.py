"""Lazy gate-stream fusion: windowed op-queues lowered to parametric
windows (dense single-device half of the JAX package's ops/fusion.py).

* :class:`GateStreamFuser` — a bounded pending window of gate
  descriptors (``QRACK_TPU_FUSE_WINDOW``, default 16) attached to an
  engine.  Gate ops append instead of dispatching; every read/boundary
  lands on the engine's ``_state`` property, whose getter flushes the
  window first.  Neighbor gates on the same target+controls merge
  algebraically before lowering (QCircuit.AppendGate's peephole,
  reference src/qcircuit.cpp:101).

* Parametric windows — payload matrices and control masks are runtime
  operands in one fixed layout, and a window is identified by its
  **structure** (per-op kind, target axis, controlled-or-not).  PyTorch
  runs eagerly, so there is no compiled-program cache: the same
  structure simply runs again with other operands.

Operand layout (per op, in window order):

  kind      payload operand                      extra (iff controlled)
  cphase    (2,)  [d1.re, d1.im]                 cmask:int, cval:int
  diag      (2,2) [[d0.re,d0.im],[d1.re,d1.im]]  cmask:int, cval:int
  inv       (2,2) [[tr.re,tr.im],[bl.re,bl.im]]  cmask:int, cval:int
  gen       (2,2,2) mtrx_planes                  cmask:int, cval:int

Payloads are host tensors in the planes' dtype (float32, float64,
float16 or bfloat16, rounded exactly as the JAX package rounds them);
masks are Python ints.  "cphase" is the
controlled phase with d0 == 1 and positive controls (every QFT phase):
its factor select collapses to one combined-mask test.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import matrices as mat
from .. import resilience as _res
from .. import telemetry as _tele
from ..telemetry import roofline as _roofline
from ..utils.bits import control_offset
from . import gatekernels as gk

DEFAULT_WINDOW = 16


def window_len() -> int:
    """Pending-window bound. <=1 disables fusion (exact per-gate path)."""
    try:
        w = int(os.environ.get("QRACK_TPU_FUSE_WINDOW", str(DEFAULT_WINDOW)))
    except ValueError:
        w = DEFAULT_WINDOW
    return max(1, w)


# ---------------------------------------------------------------------------
# lowering: QCircuitGate window -> flat op descriptors
# ---------------------------------------------------------------------------

class FusedOp:
    """One lowered gate: classification + static placement + payload."""

    __slots__ = ("kind", "target", "cmask", "cval", "m")

    def __init__(self, kind: str, target: int, cmask: int, cval: int, m):
        self.kind = kind
        self.target = target
        self.cmask = cmask
        self.cval = cval
        self.m = m


def classify(m, cmask: int, cval: int) -> str:
    if mat.is_phase(m):
        if m[0, 0] == 1.0 and cval == cmask:
            return "cphase"
        return "diag"
    if mat.is_invert(m):
        return "inv"
    return "gen"


def lower_gates(gates) -> List[FusedOp]:
    """Flatten merged QCircuitGates into op descriptors (payload perms in
    sorted order for a deterministic structure)."""
    ops: List[FusedOp] = []
    for g in gates:
        for perm in sorted(g.payloads):
            m = g.payloads[perm]
            cmask = 0
            for c in g.controls:
                cmask |= 1 << c
            cval = control_offset(g.controls, perm)
            ops.append(FusedOp(classify(m, cmask, cval), g.target, cmask, cval, m))
    return ops


def controls_perm(op: FusedOp) -> Tuple[Tuple[int, ...], int]:
    """Reconstruct a (controls, perm) pair from an op's (cmask, cval) —
    the inverse of lower_gates' control_offset, in ascending bit order."""
    controls = tuple(c for c in range(op.cmask.bit_length())
                     if (op.cmask >> c) & 1)
    perm = 0
    for j, c in enumerate(controls):
        if (op.cval >> c) & 1:
            perm |= 1 << j
    return controls, perm


def structure_of(ops: Sequence[FusedOp]) -> Tuple:
    """A window's identity: per-op (kind, target, controlled?).  Payload
    values and control placement are runtime operands."""
    return tuple((op.kind, op.target, op.cmask != 0) for op in ops)


# ---------------------------------------------------------------------------
# dense (single-shard) window chain: one gatekernels call per op
# ---------------------------------------------------------------------------

def window_fn(n: int, structure: Tuple):
    """fn(planes, *operands) applying the window op by op through the
    plain gate functions; returns new planes."""

    def fn(planes, *operands):
        i = 0
        for kind, target, has_ctrl in structure:
            p = operands[i]
            i += 1
            if has_ctrl:
                cm = int(operands[i])
                cv = int(operands[i + 1])
                i += 2
            else:
                cm = 0
                cv = 0
            if kind == "cphase":
                comb = (1 << target) | cm
                hit = (gk.iota_for(planes) & comb) == comb
                planes = gk.cmul(gk._where(hit, float(p[0]), 1.0, planes),
                                 gk._where(hit, float(p[1]), 0.0, planes),
                                 planes)
            elif kind == "diag":
                planes = gk.apply_diag(planes, float(p[0, 0]), float(p[0, 1]),
                                       float(p[1, 0]), float(p[1, 1]), n,
                                       1 << target, cm, cv)
            elif kind == "inv":
                planes = gk.apply_invert(planes, float(p[0, 0]), float(p[0, 1]),
                                         float(p[1, 0]), float(p[1, 1]), n,
                                         target, cm, cv)
            else:
                planes = gk.apply_2x2(planes, p, n, target, cm, cv)
        return planes

    return fn


def dense_operands(ops: Sequence[FusedOp], dtype=torch.float32) -> List:
    """The operand vector of a window in the layout above: payloads as
    host tensors in `dtype`, rounded as the JAX package's dense_operands
    rounds them (gatekernels.host_tensor)."""
    out: List = []
    for op in ops:
        m = np.asarray(op.m)
        if op.kind == "cphase":
            p = [m[1, 1].real, m[1, 1].imag]
        elif op.kind == "diag":
            p = [[m[0, 0].real, m[0, 0].imag], [m[1, 1].real, m[1, 1].imag]]
        elif op.kind == "inv":
            p = [[m[0, 1].real, m[0, 1].imag], [m[1, 0].real, m[1, 0].imag]]
        else:
            p = np.stack([m.real, m.imag])
        out.append(gk.host_tensor(p, dtype))
        if op.cmask:
            out.append(int(op.cmask))
            out.append(int(op.cval))
    return out


# ---------------------------------------------------------------------------
# split-mask ("sharded") operand layout: masks arrive split at a tile,
# chunk or page boundary into int32 halves, so a mask bit above 31 never
# travels as one int32.  The TurboQuant window kernel takes this layout
# (ops/turboquant_kernel.py), and so do the pager's window bodies below
# (parallel/pager.py).
#
#   kind      payload operand                      extra (iff controlled)
#   cphase    (2,)  [d1.re, d1.im]                 comb & (2^L-1), comb >> L
#   diag      (2,2) [[d0.re,d0.im],[d1.re,d1.im]]  lm, lv, hm, hv
#   gen       (2,2,2) mtrx_planes                  lm, lv, hm, hv
#
# with comb = (1 << target) | cmask and (lm, lv, hm, hv) =
# sharded.split_masks(cmask, cval, L).  "inv" folds into "gen".
# ---------------------------------------------------------------------------

def sharded_structure_of(ops: Sequence[FusedOp]) -> Tuple:
    """Per-op (kind, target, controlled?) with 'inv' folded into 'gen':
    the split-mask consumers have no invert specialization."""
    return tuple((("gen" if op.kind == "inv" else op.kind),
                  op.target, op.cmask != 0) for op in ops)


def sharded_operands(ops: Sequence[FusedOp], L: int, dtype=torch.float32,
                     device=None) -> List:
    """The window's operands in the split-mask layout above, on `device`
    (``cuda`` by default): float payload tensors in `dtype` and 0-d int32
    mask tensors, all views of two buffers copied to the device once."""
    from ..utils.device import resolve_device
    from .sharded import split_masks

    floats: List[np.ndarray] = []
    ints: List[int] = []
    slots: List[Tuple] = []   # ("f", index, shape) or ("i", index)
    for op in ops:
        m = np.asarray(op.m)
        kind = "gen" if op.kind == "inv" else op.kind
        if kind == "cphase":
            p = np.asarray([m[1, 1].real, m[1, 1].imag])
            masks = []
            if op.cmask:
                comb = (1 << op.target) | op.cmask
                masks = [comb & ((1 << L) - 1), comb >> L]
        else:
            if kind == "diag":
                p = np.asarray([[m[0, 0].real, m[0, 0].imag],
                                [m[1, 1].real, m[1, 1].imag]])
            else:
                p = np.stack([m.real, m.imag])
            masks = list(split_masks(op.cmask, op.cval, L)) if op.cmask else []
        slots.append(("f", len(floats), p.shape))
        floats.append(p)
        for v in masks:
            slots.append(("i", len(ints)))
            ints.append(int(v))
    dev = resolve_device(device)
    fbuf = gk.host_tensor(np.concatenate(
        [p.reshape(-1) for p in floats] or [np.zeros(0)]), dtype).to(dev)
    ibuf = torch.tensor(ints, dtype=torch.int32).to(dev)
    offs = [0]
    for p in floats:
        offs.append(offs[-1] + p.size)
    out: List = []
    for slot in slots:
        if slot[0] == "f":
            k = slot[1]
            out.append(fbuf[offs[k]:offs[k + 1]].view(slot[2]))
        else:
            out.append(ibuf[slot[1]])
    return out


# ---------------------------------------------------------------------------
# single-sweep window kernel lowering (ops/window_kernel.py), chosen by
# a cost model against the window chain above
# ---------------------------------------------------------------------------

def kernel_backend(device) -> bool:
    """The kernel runs where the planes live on a CUDA device."""
    return torch.device(device).type == "cuda"


def kernel_mode() -> str:
    """``QRACK_TPU_FUSE_KERNEL``: auto (default — kernel where the planes
    live on a CUDA device, window chain elsewhere), on (force the kernel
    lowering everywhere; on the CPU that is the kernel's plain version),
    off (window chain only)."""
    v = os.environ.get("QRACK_TPU_FUSE_KERNEL", "auto").strip().lower()
    return v if v in ("auto", "on", "off") else "auto"


def kernel_lowering(n: int, structure: Tuple, device="cuda"):
    """Cost model: should this window flush through the window kernel?

    Returns ``(plan, fallback_reason)`` — exactly one is non-None.
    ``plan`` is ``{"block_pow": int, "sweeps": int}``.  The window
    kernel's wrappers pick the kernel or its plain version by the planes'
    device.

    * mode off — never (reason ``mode_off``).
    * mode on — always.
    * mode auto — CUDA planes only (reason ``cpu_backend`` elsewhere).
      There the kernel wins when it saves sweeps: windows whose planned
      segment count is not below the op count fall back with reason
      ``no_sweep_gain``; single-op windows with ``single_op``.
    """
    from . import window_kernel as wk

    mode = kernel_mode()
    if mode == "off":
        return None, "mode_off"
    on_cuda = kernel_backend(device)
    bp = min(wk.DEFAULT_BLOCK_POW, n)
    sweeps = wk.plan_sweeps(structure, bp)
    plan = {"block_pow": bp, "sweeps": sweeps}
    if mode == "on":
        return plan, None
    if not on_cuda:
        return None, "cpu_backend"
    if len(structure) <= 1:
        return None, "single_op"
    if sweeps >= len(structure):
        return None, "no_sweep_gain"
    return plan, None


def flush_window(planes, n: int, ops: Sequence[FusedOp],
                 counted: bool = False):
    """Apply a multi-op window to `planes` through the lowering the cost
    model picks; returns the resulting planes (the kernel lowering
    updates `planes` in place and returns it).  An engine's flush is
    `counted` in telemetry under ``fuse.kernel.*`` or ``fuse.xla.*``;
    RunFused's whole-circuit window counts nothing, as in the JAX
    package."""
    from . import window_kernel as wk

    structure = structure_of(ops)
    operands = dense_operands(ops, planes.dtype)
    plan, why = kernel_lowering(n, structure, planes.device)
    esize = planes.element_size()
    if plan is not None:
        fn = wk.make_window_fn(n, structure, block_pow=plan["block_pow"])
        out = fn(planes, *operands)
        if counted:
            record_kernel_flush(len(ops), plan["sweeps"], width=n,
                                esize=esize)
        return out
    out = window_fn(n, structure)(planes, *operands)
    if counted:
        record_kernel_fallback(why)
        record_xla_flush(len(ops), width=n, esize=esize)
    return out


def record_kernel_flush(nops: int, sweeps: int, width=None,
                        esize: int = 4) -> None:
    """A window flushed through the window kernel: count it and the
    sweeps it paid.  Callers that supply the plane width also feed the
    sweeps' planned bytes into the roofline ledger
    (``roofline.cuda.fuse.flush.*``)."""
    if _tele._ENABLED:
        _tele.inc("fuse.kernel.windows")
        _tele.inc("fuse.kernel.ops", nops)
        _tele.inc("fuse.kernel.sweeps", sweeps)
        if width is not None:
            _roofline.note_bytes(
                "cuda.fuse.flush",
                sweeps * _roofline.plane_pass_bytes(width, esize))


def record_xla_flush(nops: int, width=None, esize: int = 4) -> None:
    """A multi-op window flushed through the window chain (one sweep an
    op; the JAX package's XLA chain, whose counter names it keeps)."""
    if _tele._ENABLED:
        _tele.inc("fuse.xla.windows")
        _tele.inc("fuse.xla.ops", nops)
        _tele.inc("fuse.xla.sweeps", nops)
        if width is not None:
            _roofline.note_bytes(
                "cuda.fuse.flush",
                nops * _roofline.plane_pass_bytes(width, esize))


def record_kernel_fallback(reason: str) -> None:
    """A window the cost model kept off the kernel, by kernel_lowering's
    reason."""
    if _tele._ENABLED:
        _tele.inc(f"fuse.kernel.fallback.{reason}")


# ---------------------------------------------------------------------------
# communication-minimizing qubit remapping (mpiQulacs discipline,
# arXiv:2203.16044): the pager keeps a logical->physical placement table
# and the planner below swaps hot page-placed target qubits into the
# page before a window flushes, so runs of high-order gates execute as
# in-page sweeps.  The swaps run as the prologue of the window
# (sharded.apply_remap).  Host code, copied from the JAX package so both
# take the same decisions.
# ---------------------------------------------------------------------------

def remap_mode() -> str:
    """``QRACK_TPU_REMAP``: auto (default — plan remaps on multi-page
    pagers), on (alias of auto), off (identity table)."""
    v = os.environ.get("QRACK_TPU_REMAP", "auto").strip().lower()
    return v if v in ("auto", "on", "off") else "auto"


def collective_mode() -> str:
    """``QRACK_TPU_COLLECTIVE``: auto (default — each remap prologue as
    ONE batched exchange, (1-2^-k) of the state moved), on (alias of
    auto), off (the pair-at-a-time lowering and planner)."""
    v = os.environ.get("QRACK_TPU_COLLECTIVE", "auto").strip().lower()
    return v if v in ("auto", "on", "off") else "auto"


#: exchange cost of one paged-target 2x2, in units of the state's bytes
#: (half a page out + half back, summed over pages)
GEN_GLOBAL_COST = 1.0
#: exchange cost of one remap transposition touching a page bit when it
#: moves alone; also the deferral ceiling of the batched planner
REMAP_PAIR_COST = 0.5


def batched_exchange_cost(gbits, weights=None) -> float:
    """Cost of one k-pair batched mixed exchange over page bits
    ``gbits``, in state-bytes units: sum over the 2^k - 1 non-zero XOR
    offsets of 2^-k, each priced at the most expensive page-bit axis it
    crosses (uniform weights give 1 - 2^-k)."""
    k = len(gbits)
    if not k:
        return 0.0
    tot = 0.0
    for d in range(1, 1 << k):
        w = 1.0
        if weights:
            w = max(weights[gbits[j]] for j in range(k) if (d >> j) & 1)
        tot += w
    return tot / (1 << k)


def plan_remaps(ops: Sequence[FusedOp], L: int, qmap: Sequence[int],
                lookahead=None, weights=None, batched: bool = True):
    """Score the pending window (+ lookahead) and pick placement swaps
    that turn page-placed gen targets into in-page sweeps.  Returns
    ``(swaps, new_qmap)``: PHYSICAL transpositions for the window
    prologue and the table after them.  cphase/diag need no exchange at
    any placement, so only non-diagonal hits score.

    Batched model (default; units of the state's bytes, scaled by the
    per-page-bit ``weights``): all k mixed pairs of one prologue move
    together for ``batched_exchange_cost``, so candidates are ranked
    jointly.  A hot page qubit's benefit is its in-window hits (which
    otherwise pay GEN_GLOBAL_COST each) plus lookahead hits capped at
    REMAP_PAIR_COST; a victim's charge is the same quantity for the hits
    it will pay from the page slot it inherits.  The best hot-desc /
    cold-asc prefix with positive net fires as ONE batch.
    ``batched=False`` keeps the greedy pair-at-a-time rule.  Non-uniform
    ``weights`` add a pass that moves hot qubits onto cheaper page
    bits."""
    n = len(qmap)
    if L >= n:
        return (), list(qmap)
    win = [0.0] * n
    look = [0.0] * n
    for op in ops:
        if op.kind in ("gen", "inv") and op.target < n:
            win[op.target] += 1.0
    if lookahead:
        for kind, target in lookahead:
            if kind in ("gen", "inv") and 0 <= target < n:
                look[target] += 1.0

    def wt(pos):
        if weights is None or pos < L:
            return 1.0
        return weights[pos - L]

    new_qmap = list(qmap)
    swaps = []
    if not batched:
        hits = [win[q] + look[q] for q in range(n)]
        while True:
            glob = [(hits[q], -q) for q in range(n)
                    if new_qmap[q] >= L and hits[q] > 0]
            loc = [(hits[q], q) for q in range(n) if new_qmap[q] < L]
            if not glob or not loc:
                break
            gh, negg = max(glob)
            vh, v = min(loc)
            if gh <= vh + REMAP_PAIR_COST:
                break
            g = -negg
            p_g, p_v = new_qmap[g], new_qmap[v]
            swaps.append((p_v, p_g))
            new_qmap[g], new_qmap[v] = p_v, p_g
        return tuple(swaps), new_qmap

    def worth(q, pos):
        return (win[q] * GEN_GLOBAL_COST
                + min(look[q], REMAP_PAIR_COST)) * wt(pos)

    hot = sorted(((worth(q, new_qmap[q]), q) for q in range(n)
                  if new_qmap[q] >= L and (win[q] or look[q])),
                 key=lambda t: (-t[0], t[1]))
    cold = sorted(((win[q] * GEN_GLOBAL_COST + min(look[q],
                                                   REMAP_PAIR_COST), q)
                   for q in range(n) if new_qmap[q] < L),
                  key=lambda t: (t[0], t[1]))
    best_k, best_net = 0, 0.0
    for k in range(1, min(len(hot), len(cold)) + 1):
        gbits = [new_qmap[q] - L for _, q in hot[:k]]
        net = -batched_exchange_cost(gbits, weights)
        for (ben, hq), (esc, cq) in zip(hot[:k], cold[:k]):
            net += ben - esc * wt(new_qmap[hq])
        if net > best_net + 1e-9:
            best_k, best_net = k, net
    for (_, hq), (_, cq) in zip(hot[:best_k], cold[:best_k]):
        p_g, p_v = new_qmap[hq], new_qmap[cq]
        swaps.append((p_v, p_g))
        new_qmap[hq], new_qmap[cq] = p_v, p_g
    if weights is not None and len(set(weights)) > 1:
        h = [win[q] + look[q] for q in range(n)]
        used = {p - L for pair in swaps for p in pair if p >= L}
        while True:
            best = None
            for q in range(n):
                pq = new_qmap[q]
                if pq < L or (pq - L) in used or h[q] <= 0:
                    continue
                for r in range(n):
                    pr = new_qmap[r]
                    if r == q or pr < L or (pr - L) in used:
                        continue
                    gain = ((h[q] - h[r]) * (wt(pq) - wt(pr))
                            - REMAP_PAIR_COST * max(wt(pq), wt(pr)))
                    if gain > 1e-9 and (best is None or gain > best[0]):
                        best = (gain, q, r)
            if best is None:
                break
            _, q, r = best
            pq, pr = new_qmap[q], new_qmap[r]
            swaps.append((pr, pq))
            new_qmap[q], new_qmap[r] = pr, pq
            used.add(pq - L)
            used.add(pr - L)
    return tuple(swaps), new_qmap


def translate_ops(ops: Sequence[FusedOp], qmap: Sequence[int]):
    """Rewrite ops from logical qubit indices to physical bit positions
    under ``qmap``.  Fresh FusedOps: the caller's window keeps its
    logical form."""
    if all(q == p for q, p in enumerate(qmap)):
        return list(ops)
    out = []
    for op in ops:
        cmask = 0
        cval = 0
        m = op.cmask
        q = 0
        while m:
            if m & 1:
                p = qmap[q]
                cmask |= 1 << p
                if (op.cval >> q) & 1:
                    cval |= 1 << p
            m >>= 1
            q += 1
        out.append(FusedOp(op.kind, qmap[op.target], cmask, cval, op.m))
    return out


# ---------------------------------------------------------------------------
# pager window bodies: fn(pages, *operands) over the split-mask layout
# above, with host operands (sharded_operands(..., device="cpu")).  The
# pages are updated in place and the list (relabeled by page exchanges)
# is returned.
# ---------------------------------------------------------------------------

def _host_floats(p) -> List[float]:
    return [float(x) for x in torch.as_tensor(p).reshape(-1).tolist()]


def sharded_window_body(L: int, npg: int, structure: Tuple, remap=(),
                        batched: bool = True):
    """The window chain on pages (``fusion.py:560`` of the JAX package):
    op by op through the page algebra of ops/sharded.py, after the
    optional remap prologue."""
    from . import sharded as shb

    lbits = (1 << L) - 1

    def fn(pages, *operands):
        if remap:
            pages = shb.apply_remap(pages, L, remap, batched=batched)
        i = 0
        for kind, target, has_ctrl in structure:
            p = operands[i]
            i += 1
            tmask = 1 << target
            if kind == "cphase":
                if has_ctrl:
                    clo, chi = int(operands[i]), int(operands[i + 1])
                    i += 2
                else:
                    clo, chi = tmask & lbits, tmask >> L
                fre, fim = _host_floats(p)
                # the factor lands where every bit of the combined mask
                # is set: the target's bit picks d1, the rest control
                tlo, thi = tmask & lbits, tmask >> L
                pages = shb.apply_diag(pages, 1.0, 0.0, fre, fim, tlo, thi,
                                       clo & ~tlo, clo & ~tlo,
                                       chi & ~thi, chi & ~thi)
                continue
            if has_ctrl:
                lm, lv, gm, gv = (int(x) for x in operands[i:i + 4])
                i += 4
            else:
                lm = lv = gm = gv = 0
            if kind == "diag":
                d = _host_floats(p)
                pages = shb.apply_diag(pages, d[0], d[1], d[2], d[3],
                                       tmask & lbits, tmask >> L,
                                       lm, lv, gm, gv)
            elif target < L:
                pages = shb.apply_local_2x2(pages, p, L, target,
                                            lm, lv, gm, gv)
            else:
                pages = shb.apply_global_2x2(pages, p, target - L,
                                             lm, lv, gm, gv)
        return pages

    return fn


def _sharded_segments(structure: Tuple, L: int):
    """Split a sharded window structure into kernel-lowered in-page runs
    and pass-through paged-target gens."""
    segs: List[Tuple] = []
    cur: List[Tuple] = []
    for idx, (kind, target, has_ctrl) in enumerate(structure):
        if kind == "gen" and target >= L:
            if cur:
                segs.append(("run", cur))
                cur = []
            segs.append(("global", (idx, target, has_ctrl)))
        else:
            cur.append((idx, kind, target, has_ctrl))
    if cur:
        segs.append(("run", cur))
    return segs


def _sharded_run_structure(run, L: int) -> Tuple:
    """Dense-kernel structure of one in-page run.  Page-level mask and
    target bits fold into the payloads against the page id, so every op
    is 'controlled' with the LOCAL mask halves, and a page-bit
    cphase/diag becomes a diag whose two factors are equal."""
    out = []
    for (idx, kind, target, has_ctrl) in run:
        if target >= L:  # cphase/diag on a page bit
            out.append(("diag", 0, True))
        else:
            out.append((kind, target, True))
    return tuple(out)


def _sharded_offs(structure: Tuple) -> List[int]:
    offs: List[int] = []
    o = 0
    for kind, target, has_ctrl in structure:
        offs.append(o)
        o += 1 + ((2 if kind == "cphase" else 4) if has_ctrl else 0)
    return offs


_IDENT_GEN = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0]


def _sharded_run_operands(run, L: int, operands, offs, pid: int):
    """(floats, ints) of one in-page run on page ``pid`` in the window
    kernel's packed layout (window_kernel.pack_operands of the run
    structure): local masks pass through, page-level tests fold into the
    payload (the identity where this page misses the page mask).  The
    ints are the same on every page."""
    lbits = (1 << L) - 1
    fv: List[float] = []
    iv: List[int] = []
    for (idx, kind, target, has_ctrl) in run:
        p = _host_floats(operands[offs[idx]])
        if kind == "cphase":
            if has_ctrl:
                clo = int(operands[offs[idx] + 1])
                chi = int(operands[offs[idx] + 2])
            else:
                comb = 1 << target
                clo, chi = comb & lbits, comb >> L
            page_ok = (pid & chi) == chi
            fre, fim = (p[0], p[1]) if page_ok else (1.0, 0.0)
            if target < L:
                fv += [fre, fim]
                cm = clo & (~(1 << target) & lbits)
            else:
                fv += [fre, fim, fre, fim]
                cm = clo
            iv += [cm, cm]
            continue
        if has_ctrl:
            lm, lv, gm, gv = (int(x) for x in
                              operands[offs[idx] + 1:offs[idx] + 5])
        else:
            lm = lv = gm = gv = 0
        page_ok = (pid & gm) == gv
        if kind == "diag":
            if target < L:
                fv += p if page_ok else [1.0, 0.0, 1.0, 0.0]
            else:
                tb = (pid & ((1 << target) >> L)) != 0
                d = p[2:4] if tb else p[0:2]
                d = d if page_ok else [1.0, 0.0]
                fv += d + d
        else:  # gen, target < L (paged targets were split out)
            fv += p if page_ok else _IDENT_GEN
        iv += [lm, lv]
    return fv, iv


def sharded_kernel_sweeps(structure: Tuple, L: int,
                          block_pow: int = None) -> int:
    """Sweeps over a page the kernel lowering pays: one per planned
    kernel segment inside each in-page run, one per paged-target 2x2
    (the window kernel launches this many times less the paged-target
    count on every page)."""
    from . import window_kernel as wk

    bp = min(wk.DEFAULT_BLOCK_POW, L) if block_pow is None else block_pow
    total = 0
    for seg in _sharded_segments(structure, L):
        if seg[0] == "global":
            total += 1
        else:
            total += wk.plan_sweeps(_sharded_run_structure(seg[1], L), bp)
    return total


def sharded_kernel_lowering(L: int, structure: Tuple, device="cuda"):
    """Pager twin of :func:`kernel_lowering`: the same mode and device
    gates, sweeps counted through the run/exchange split.  A page of one
    amplitude (L = 0) has no tile and takes the window chain."""
    from . import window_kernel as wk

    mode = kernel_mode()
    if mode == "off":
        return None, "mode_off"
    if L < 1:
        return None, "page_too_small"
    bp = min(wk.DEFAULT_BLOCK_POW, L)
    sweeps = sharded_kernel_sweeps(structure, L, bp)
    plan = {"block_pow": bp, "sweeps": sweeps}
    if mode == "on":
        return plan, None
    if not kernel_backend(device):
        return None, "cpu_backend"
    if len(structure) <= 1:
        return None, "single_op"
    if sweeps >= len(structure):
        return None, "no_sweep_gain"
    return plan, None


def sharded_kernel_window_body(L: int, npg: int, structure: Tuple,
                               block_pow: int = None, remap=(),
                               batched: bool = True):
    """The window kernel per page (``fusion.py:787`` of the JAX
    package): fn(pages, *operands) with the SAME operand layout as
    :func:`sharded_window_body`.  Each in-page run launches the window
    kernel (ops/window_kernel.py: K1/K2) on every page, with one op
    table and int vector for the run and only the float payloads per
    page; each paged-target 2x2 runs as sharded.apply_global_2x2.  The
    optional remap prologue comes first.  Pages of other processes
    (sharded.RemotePage) launch there: each rank runs the kernel on its
    own pages only."""
    from . import sharded as shb
    from . import window_kernel as wk

    bp = min(wk.DEFAULT_BLOCK_POW, L) if block_pow is None else block_pow
    segments = _sharded_segments(structure, L)
    offs = _sharded_offs(structure)
    runs = {id(seg): _sharded_run_structure(seg[1], L)
            for seg in segments if seg[0] == "run"}

    def fn(pages, *operands):
        if remap:
            pages = shb.apply_remap(pages, L, remap, batched=batched)
        for seg in segments:
            if seg[0] == "global":
                idx, target, has_ctrl = seg[1]
                p = operands[offs[idx]]
                if has_ctrl:
                    lm, lv, gm, gv = (int(x) for x in
                                      operands[offs[idx] + 1:offs[idx] + 5])
                else:
                    lm = lv = gm = gv = 0
                pages = shb.apply_global_2x2(pages, p, target - L,
                                             lm, lv, gm, gv)
                continue
            rs = runs[id(seg)]
            packed = [_sharded_run_operands(seg[1], L, operands, offs, pid)
                      for pid in range(len(pages))]
            fv_host = gk.host_tensor(np.asarray([f for f, _ in packed]),
                                     pages[0].dtype)
            iv_host = torch.tensor(packed[0][1], dtype=torch.int32)
            on = {}   # device -> (table, iv, fv rows)
            for pid, page in shb.local_pages(pages):
                dev = page.device
                if dev not in on:
                    on[dev] = (wk.op_table(rs, dev), iv_host.to(dev),
                               fv_host.to(dev))
                table, iv, fv = on[dev]
                wk.apply_window(page, L, rs, fv[pid], iv, table, bp)
        return pages

    fn.sweeps = sharded_kernel_sweeps(structure, L, bp)
    fn.block_pow = bp
    return fn


# ---------------------------------------------------------------------------
# the pending window
# ---------------------------------------------------------------------------

class GateStreamFuser:
    """Bounded pending-gate window attached to one engine.

    The engine's gate funnel calls :meth:`queue`; its ``_state`` property
    getter calls :meth:`flush` on every read and :meth:`drop` on every
    blind overwrite.  The engine supplies ``_fuse_admit(m, target,
    controls) -> bool`` (can this op join a window?) and
    ``_fuse_flush(gates) -> int`` (lower + dispatch).  On a flush
    failure the window is kept and the error propagates."""

    __slots__ = ("engine", "window", "gates", "_raw", "_flushing",
                 "lookahead", "lookahead_pos")

    def __init__(self, engine, window: int):
        self.engine = engine
        self.window = window
        self.gates: List = []   # merged QCircuitGate window
        self._raw = 0           # gates queued into it, before merging
        self._flushing = False
        # lookahead for the pager's remap planner: (kind, target) LOGICAL
        # tuples of the gates a circuit runner is about to stream,
        # consumed one entry per queued gate.  A heuristic: a gate merged
        # away drifts the cursor, which costs planning accuracy only.
        self.lookahead = None
        self.lookahead_pos = 0

    @property
    def pending(self) -> bool:
        return bool(self.gates)

    def set_lookahead(self, entries) -> None:
        self.lookahead = tuple(entries)
        self.lookahead_pos = 0

    def clear_lookahead(self) -> None:
        self.lookahead = None
        self.lookahead_pos = 0

    def lookahead_rest(self):
        """Entries beyond the pending window (the window itself is
        scored from its lowered ops)."""
        la = self.lookahead
        if not la:
            return None
        return la[self.lookahead_pos:] or None

    def queue(self, controls, m, target: int, perm: int) -> bool:
        """Admit one gate into the window.  Returns False (after flushing
        any pending window, to preserve order) when the op cannot join —
        the caller then dispatches it eagerly."""
        if (self.lookahead is not None
                and self.lookahead_pos < len(self.lookahead)):
            # the gate is consumed from the runner's stream either way
            # (fused or eager), so the cursor advances unconditionally
            self.lookahead_pos += 1
        eng = self.engine
        if not eng._fuse_admit(m, target, controls):
            self.flush("ineligible")
            return False
        from ..layers.qcircuit import QCircuitGate

        if controls:
            gate = QCircuitGate.controlled(controls, target, m, perm)
        else:
            gate = QCircuitGate.single(target, m)
        # a full window flushes BEFORE the new gate joins, so a window
        # never holds more than `window` gates
        if len(self.gates) >= self.window:
            self.flush("window_full")
        self._append_merge(gate)
        self._raw += 1
        if _tele._ENABLED:
            _tele.inc(f"fuse.{eng._tele_name}.queued")
            _tele.gauge(f"fuse.{eng._tele_name}.queue_depth",
                        float(len(self.gates)))
        eng._fuse_tick()
        return True

    def _append_merge(self, gate) -> None:
        # QCircuit.AppendGate's peephole: walk back past disjoint-qubit
        # gates; compose onto a same-target/controls partner
        i = len(self.gates) - 1
        gset = set(gate.qubits())
        while i >= 0:
            g = self.gates[i]
            if g.can_merge(gate):
                g.merge(gate)
                if g.is_identity():
                    del self.gates[i]
                return
            if set(g.qubits()) & gset:
                break
            i -= 1
        self.gates.append(gate.clone())

    def flush(self, reason: str = "read") -> None:
        """Lower + dispatch the pending window.  No-op when empty or
        re-entered (the engine's state getter fires during the flush's
        own dispatch).  `reason` names the flush in telemetry.

        With the resilience plane armed and its integrity gate on, the
        dispatch runs inside the integrity envelope (snapshot → dispatch
        → verify → replay of the SAME kept window;
        resilience/integrity.py), which relaunches K1/K2 (and K1/K2 per
        page) on a repaired window.  Elastic recovery happens HERE, not
        at the wrapper's failover replay: when the dispatch escalates and
        the engine can shrink (QPager), re-page in place on the card and
        re-dispatch the same kept window.  The re-entry guard keeps the
        shrink's re-page raw (no recursive flush), so the window applies
        exactly once.  A dispatch that failed after writing the planes in
        place without a snapshot (``torn``) is not re-paged: it
        propagates."""
        if not self.gates or self._flushing:
            return
        eng = self.engine
        guard = None
        if _res._ACTIVE:
            from ..resilience import integrity as _integ

            if _integ.enabled():
                guard = _integ
        self._flushing = True
        try:
            while True:
                try:
                    if guard is not None:
                        dispatched = guard.guarded_flush(
                            eng, lambda: eng._fuse_flush(self.gates))
                    else:
                        dispatched = eng._fuse_flush(self.gates)
                    break
                except _res.FAILOVER_ERRORS as e:
                    if getattr(e, "torn", False):
                        raise
                    can_shrink = getattr(eng, "can_shrink", None)
                    if can_shrink is None or not can_shrink():
                        raise  # wrapper-level failover takes over
                    eng.shrink_pages()
        finally:
            self._flushing = False
        raw = self._raw
        self.gates = []
        self._raw = 0
        if _tele._ENABLED:
            name = eng._tele_name
            _tele.inc(f"fuse.{name}.flush.{reason}")
            _tele.inc(f"fuse.{name}.gates", raw)
            _tele.inc(f"fuse.{name}.sweeps_saved",
                      max(0, raw - int(dispatched)))
            _tele.observe(f"fuse.{name}.window_len", float(raw))
            _tele.gauge(f"fuse.{name}.queue_depth", 0.0)

    def drop(self, reason: str = "overwritten") -> None:
        """Discard the pending window — correct only when the caller is
        about to blind-overwrite the state the gates would have acted on
        (SetPermutation/SetQuantumState)."""
        if not self.gates:
            return
        n = len(self.gates)
        self.gates = []
        self._raw = 0
        if _tele._ENABLED:
            _tele.inc(f"fuse.{self.engine._tele_name}.dropped.{reason}", n)
            _tele.gauge(f"fuse.{self.engine._tele_name}.queue_depth", 0.0)


def make_fuser(engine):
    """Install-time factory: None when fusion is off (window <= 1) or the
    engine opted out (``_fuse_capable``).  With the integrity plane armed
    a window-1 fuser is forced even when fusion is off — the flush
    envelope is where snapshot/verify/replay lives, so per-gate dispatch
    still gets corruption repair."""
    if not getattr(engine, "_fuse_capable", False):
        return None
    w = window_len()
    if w <= 1:
        if _res._ACTIVE:
            from ..resilience import integrity as _integ

            if _integ.enabled():
                return GateStreamFuser(engine, 1)
        return None
    return GateStreamFuser(engine, w)
