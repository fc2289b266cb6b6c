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
# (ops/turboquant_kernel.py); the pager's window bodies wait for the
# pager slice.
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


def flush_window(planes, n: int, ops: Sequence[FusedOp]):
    """Apply a multi-op window to `planes` through the lowering the cost
    model picks; returns the resulting planes (the kernel lowering
    updates `planes` in place and returns it)."""
    from . import window_kernel as wk

    structure = structure_of(ops)
    operands = dense_operands(ops, planes.dtype)
    plan, _why = kernel_lowering(n, structure, planes.device)
    if plan is not None:
        fn = wk.make_window_fn(n, structure, block_pow=plan["block_pow"])
        return fn(planes, *operands)
    return window_fn(n, structure)(planes, *operands)


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

    __slots__ = ("engine", "window", "gates", "_flushing")

    def __init__(self, engine, window: int):
        self.engine = engine
        self.window = window
        self.gates: List = []   # merged QCircuitGate window
        self._flushing = False

    @property
    def pending(self) -> bool:
        return bool(self.gates)

    def queue(self, controls, m, target: int, perm: int) -> bool:
        """Admit one gate into the window.  Returns False (after flushing
        any pending window, to preserve order) when the op cannot join —
        the caller then dispatches it eagerly."""
        eng = self.engine
        if not eng._fuse_admit(m, target, controls):
            self.flush()
            return False
        from ..layers.qcircuit import QCircuitGate

        if controls:
            gate = QCircuitGate.controlled(controls, target, m, perm)
        else:
            gate = QCircuitGate.single(target, m)
        # a full window flushes BEFORE the new gate joins, so a window
        # never holds more than `window` gates
        if len(self.gates) >= self.window:
            self.flush()
        self._append_merge(gate)
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

    def flush(self) -> None:
        """Lower + dispatch the pending window.  No-op when empty or
        re-entered (the engine's state getter fires during the flush's
        own dispatch)."""
        if not self.gates or self._flushing:
            return
        self._flushing = True
        try:
            self.engine._fuse_flush(self.gates)
        finally:
            self._flushing = False
        self.gates = []

    def drop(self) -> None:
        """Discard the pending window — correct only when the caller is
        about to blind-overwrite the state the gates would have acted on
        (SetPermutation/SetQuantumState)."""
        self.gates = []


def make_fuser(engine):
    """Install-time factory: None when fusion is off (window <= 1) or the
    engine opted out (``_fuse_capable``)."""
    if not getattr(engine, "_fuse_capable", False):
        return None
    w = window_len()
    if w <= 1:
        return None
    return GateStreamFuser(engine, w)
