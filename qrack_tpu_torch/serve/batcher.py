"""Shape-bucketed batch execution: co-batched tenants as ONE folded ket
through the window kernel (the port of the JAX package's
serve/batcher.py, which vmaps the plain XLA body inside one jit).

N tenants running the same circuit should pay one lowering, one operand
pack and one sweep plan, not N.  Here the B lanes' ``(2, 2^n)`` planes
are stacked into a fresh ``(2, B·2^n)`` buffer (``torch.stack(planes,
dim=1)``): the lane index becomes the high bits of each plane, so the
batch is one ket of ``n + b`` qubits, ``b = log2 B``.  Every op of the
circuit acts below bit n, so each lane sees only its own ket whatever
the tile size, and the window kernel (K1/K2, ops/window_kernel.py) runs
once per planned sweep of the fold, not once per lane.  On a CPU tensor
the window's plain version runs, as everywhere in the port.

* **Identity.**  The cached program — the lowered ops, the packed
  operands and the window's sweep plan — lives in a
  :class:`~qrack_tpu_torch.telemetry.ProgramCache` (``compile.
  serve_batch.*``) under ``(shape_key, B, dtype, device)``: the JAX
  package's ``(shape_key, B)`` plus the planes' dtype and device, since
  the port's engines choose their dtype per construction.
* **Padding.**  Batch sizes are bucketed to the next power of two
  (``QRACK_SERVE_BATCH_PAD=0`` keys exact sizes); the fold itself always
  pads its lane count to a power of two with copies of lane 0 (a real
  normalized ket, so no zero lane can go non-finite under a normalizing
  op).  Only the real lanes are bound back.
* **Width cap.**  A fold is at most ``MAX_DENSE_QB`` (30) qubits wide:
  int32 indices and tile ids.  A batch that would pass it runs in groups
  of ``2^(30 - n)`` lanes, one fold each (a w30 group is one lane).
* **What a batch writes.**  Never a session's planes: the fold is a
  fresh buffer and each engine adopts a fresh contiguous copy of its
  lane (``QEngineCUDA.device_planes``), so a failed dispatch or sync
  leaves every pre-batch ket intact for the executor to re-bind
  (serve/executor.py), and the failover replay is exact.
"""

from __future__ import annotations

import os
from typing import List

import torch

from .. import telemetry as _tele
from ..engines.cuda import MAX_DENSE_QB
from ..ops import fusion as fu
from ..ops import window_kernel as wk

# bounded LRU of fold programs
_PROGRAMS = _tele.ProgramCache("serve_batch",
                               cap_env="QRACK_SERVE_PROGRAM_CACHE_CAP",
                               default_cap=128)

# optional warm-start hook: a checkpoint.warmstart.ProgramManifest that
# records every built shape so the next process can prewarm it
_MANIFEST = None


def set_manifest(manifest) -> None:
    global _MANIFEST
    _MANIFEST = manifest


def _bucket(b: int) -> int:
    """Next power of two >= b — the batch sizes traffic of any occupancy
    maps onto."""
    return 1 << max(b - 1, 0).bit_length()


def group_lanes(n: int, batch: int) -> List[int]:
    """The lane counts of the folds a batch of `batch` kets of `n`
    qubits runs in: groups of at most 2^(MAX_DENSE_QB - n) lanes."""
    cap = 1 << max(MAX_DENSE_QB - n, 0)
    return [min(cap, batch - i) for i in range(0, batch, cap)]


class FoldProgram:
    """One circuit over folds of `n`-qubit lanes in `dtype` on `device`:
    the lowered ops, their packed operands and op table (built once, on
    the device), and the sweep plan of each fold width.  Calling it on
    a list of lane planes returns a tuple of fresh contiguous lanes."""

    def __init__(self, circuit, n: int, dtype, device,
                 block_pow: int = wk.DEFAULT_BLOCK_POW):
        circuit._check_fused_range(n)
        self.n = int(n)
        self.dtype = dtype
        self.device = torch.device(device)
        self.block_pow = block_pow
        self.ops = fu.lower_gates(circuit.gates)
        self.structure = fu.structure_of(self.ops)
        self.fv = self.iv = self.table = None
        if self.ops:
            self.fv, self.iv = wk.pack_operands(
                self.structure, fu.dense_operands(self.ops, dtype), dtype,
                self.device)
            self.table = wk.op_table(self.structure, self.device)

    def fold_width(self, lanes: int) -> int:
        return self.n + (_bucket(lanes).bit_length() - 1)

    def sweeps(self, lanes: int) -> int:
        """Kernel sweeps one fold of `lanes` lanes pays."""
        if not self.ops:
            return 0
        width = self.fold_width(lanes)
        return wk.plan_sweeps(self.structure, self.block_pow, width)

    def planned_sweeps(self, batch: int) -> int:
        """Kernel sweeps a batch of `batch` lanes pays, over its folds."""
        return sum(self.sweeps(g) for g in group_lanes(self.n, batch))

    def run_fold(self, lanes: list):
        """Stack `lanes` (padded with copies of the first to a power of
        two) into one fresh fold, run the window over it, and return the
        fold as (2, L, 2^n)."""
        pad = _bucket(len(lanes))
        src = list(lanes) + [lanes[0]] * (pad - len(lanes))
        fold = torch.stack(src, dim=1)
        if self.ops:
            width = self.fold_width(len(lanes))
            wk.apply_window(fold.view(2, pad << self.n), width,
                            self.structure, self.fv, self.iv, self.table,
                            self.block_pow)
        return fold

    def __call__(self, planes: list) -> tuple:
        out = []
        start = 0
        for g in group_lanes(self.n, len(planes)):
            fold = self.run_fold(planes[start:start + g])
            out.extend(fold[:, i].clone() for i in range(g))
            del fold
            start += g
        return tuple(out)


def device_key(device) -> str:
    """A device's name with its ordinal (``cuda`` reads as the current
    card), so a program built for ``cuda`` serves planes on ``cuda:0``."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def program_key(circuit, n: int, batch: int, dtype, device) -> tuple:
    return (circuit.shape_key(n), batch, str(dtype), device_key(device))


def batch_program(circuit, n: int, batch: int, dtype=torch.float32,
                  device="cuda") -> FoldProgram:
    """The cached fold program applying `circuit` to `batch` kets of `n`
    qubits in `dtype` on `device`."""
    key = program_key(circuit, n, batch, dtype, device)
    prog = _PROGRAMS.get_or_build(
        key, lambda: FoldProgram(circuit, n, dtype, device))
    if _MANIFEST is not None:
        _MANIFEST.record(circuit, n, batch, dtype, device)
    return prog


def run_batch(jobs: List, engines: List):
    """Dispatch one same-shape batch: fold the sessions' resident planes,
    run the window once per planned sweep of each fold, bind each real
    lane's fresh copy to its engine, and return the lanes (the
    executor's sync target).  Raises whatever the dispatch raises — the
    executor owns guarding and failover."""
    from .. import resilience as _res

    job0 = jobs[0]
    n = job0.session.width
    planes = [eng.device_planes for eng in engines]
    padded = (len(jobs)
              if os.environ.get("QRACK_SERVE_BATCH_PAD", "1") == "0"
              else _bucket(len(jobs)))
    prog = batch_program(job0.circuit, n, padded, planes[0].dtype,
                         planes[0].device)
    if padded > len(jobs) and _tele._ENABLED:
        _tele.inc("serve.batch.pad_lanes", padded - len(jobs))
    if _res._ACTIVE:
        out = _res.call_guarded("serve.dispatch", prog, (planes,))
    else:
        out = prog(planes)
    for i, eng in enumerate(engines):
        eng.device_planes = out[i]
    if _tele._ENABLED:
        _tele.inc("serve.batch.dispatches")
        _tele.inc("serve.batch.jobs", len(jobs))
    return out


def sync_scalar(arr) -> None:
    """Honest completion for a batch output: one device-to-host read of
    a single element (``.item()`` on lane 0).  Every lane is a copy out
    of a fold that the same stream wrote, so the read waits for the
    whole batch."""
    if isinstance(arr, (tuple, list)):
        arr = arr[0]
    arr.reshape(-1)[0].item()


def stats() -> dict:
    return _PROGRAMS.stats()


def clear_programs() -> None:
    """Drop cached batch programs (tests)."""
    _PROGRAMS.clear()
