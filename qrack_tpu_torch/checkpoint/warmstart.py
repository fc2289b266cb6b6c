"""Persistent warm start: build once per store, not once per process (the
port of the JAX package's checkpoint/warmstart.py).

Two layers, both rooted in the checkpoint directory:

* :func:`enable_warm_start` points the kernel libraries' build directory
  at ``<dir>/kernel_cache`` (ops/cuda_build.py ``set_build_dir``; the
  JAX package points its persistent XLA cache at ``<dir>/xla_cache``), so
  the nvcc builds of this process land in the store and a later process
  on the same store finds them built (``compile.kernel.<library>.hit``).
* :class:`ProgramManifest` records every circuit shape the serving
  batcher builds (keyed by ``QCircuit.shape_key`` + batch size + the
  planes' dtype and device, the batcher's program-cache identity)
  together with the circuit itself in a container file.  A fresh
  process calls :meth:`prewarm` BEFORE taking traffic: each recorded
  program is rebuilt into the batcher's cache and run once on a
  ``|0…0⟩`` fold (which loads its kernel library), so the first real job
  is a ``compile.serve_batch.hit``.

Both hooks are wired lazily by QrackService when a checkpoint directory
is set.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import torch

from .. import telemetry as _tele
from .container import CheckpointCorrupt, CheckpointError
from .store import load_circuit, save_circuit

_ENABLED_DIR: Optional[str] = None


def enable_warm_start(cache_dir: str) -> str:
    """Build and load the kernel libraries under `cache_dir`.  A library
    this process already loaded stays loaded.  Idempotent; returns the
    directory."""
    global _ENABLED_DIR
    cache_dir = str(cache_dir)
    if _ENABLED_DIR == cache_dir:
        return cache_dir
    os.makedirs(cache_dir, exist_ok=True)
    from ..ops import cuda_build

    cuda_build.set_build_dir(cache_dir)
    _ENABLED_DIR = cache_dir
    if _tele._ENABLED:
        _tele.event("checkpoint.warmstart.enabled", dir=cache_dir)
    return cache_dir


class ProgramManifest:
    """Digest-keyed record of every (circuit, width, batch, dtype,
    device) program the batcher built, durable enough to rebuild them
    next boot."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._index_path = os.path.join(self.root, "programs.json")
        try:
            with open(self._index_path) as f:
                self._index = json.load(f)
        except (OSError, json.JSONDecodeError):
            self._index = {}

    @staticmethod
    def _key(shape_key, batch: int, dtype: str, device: str) -> str:
        # the digest stays the last field, as in the JAX package's key
        n, _bucket, digest = shape_key
        return f"{n}:{batch}:{dtype}:{device}:{digest}"

    def record(self, circuit, n: int, batch: int, dtype=torch.float32,
               device="cuda") -> None:
        """Idempotent: a known (shape, batch, dtype, device) is a no-op,
        so the hot batcher path costs one dict probe.  Best-effort: the
        record is advisory warm-start metadata, so a store that has
        vanished out from under the manifest must never fail the
        dispatch it rides on."""
        shape = circuit.shape_key(n)
        dtype_s = str(dtype).replace("torch.", "")
        dev_s = torch.device(device).type
        key = self._key(shape, batch, dtype_s, dev_s)
        if key in self._index:
            return
        # circuit files are keyed by the structure digest alone: the
        # same circuit served at several widths/batches is stored once
        digest = shape[2]
        path = os.path.join(self.root, f"{digest}.qckpt")
        try:
            if not os.path.exists(path):
                save_circuit(path, circuit)
            self._index[key] = {"width": int(n), "batch": int(batch),
                                "dtype": dtype_s, "device": dev_s,
                                "circuit": os.path.basename(path)}
            self._write_index()
        except OSError:
            return
        if _tele._ENABLED:
            _tele.inc("checkpoint.warmstart.recorded")

    def _write_index(self) -> None:
        fd, tmp = tempfile.mkstemp(prefix=".programs-", suffix=".tmp",
                                   dir=self.root)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._index, f, sort_keys=True)
            os.replace(tmp, self._index_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        return len(self._index)

    def prewarm(self, limit: Optional[int] = None) -> int:
        """Rebuild every recorded program into the batcher's program
        cache and run its first fold once on ``|0…0⟩`` lanes, so packing,
        the sweep plan and the kernel library's load happen HERE, not
        under the first tenant's job, on the kind of device it was
        recorded on (``cuda``: the current card).  Returns how many
        programs were warmed; damaged circuit files are dropped from the
        manifest, not fatal."""
        from ..ops import gatekernels as gk
        from ..serve import batcher as _batcher
        from ..utils.device import resolve_device

        warmed = 0
        dead = []
        for key, rec in list(self._index.items()):
            if limit is not None and warmed >= limit:
                break
            path = os.path.join(self.root, rec["circuit"])
            try:
                circ, _ = load_circuit(path)
            except (CheckpointCorrupt, CheckpointError, OSError):
                dead.append(key)
                continue
            n, batch = int(rec["width"]), int(rec["batch"])
            dtype = gk.plane_dtype(rec.get("dtype", "float32"))
            dev = resolve_device(rec.get("device", "cuda"))
            prog = _batcher.batch_program(circ, n, batch, dtype, dev)
            plane = torch.zeros((2, 1 << n), dtype=dtype, device=dev)
            plane[0, 0] = 1.0
            lanes = _batcher.group_lanes(n, batch)[0]
            _batcher.sync_scalar(prog.run_fold([plane] * lanes))
            del plane
            warmed += 1
        for key in dead:
            self._index.pop(key, None)
        if dead:
            self._write_index()
        if warmed and _tele._ENABLED:
            _tele.inc("checkpoint.warmstart.prewarmed", warmed)
        return warmed
