"""Durable state: snapshots, the session store, crash recovery (the port
of the JAX package's checkpoint/).

* **container** — the versioned, checksummed npz+manifest file format
  with atomic writes and corruption detection (stored members; a file
  of either package loads in the other).
* **registry** — ``save_state(obj, path)`` / ``load_state(path,
  into=None, device=None)`` over every ported representation, rng
  streams included.
* **store** — the bounded on-disk session store: the manifest, the
  session state files, the journal of circuits, the acks log, the
  prefix files, the lease and the byte budget.

* **warmstart** — ``enable_warm_start`` (the kernel libraries build
  into the store's ``kernel_cache``) and ``ProgramManifest`` (the
  serving batcher's recorded shapes, rebuilt by ``prewarm``); loaded on
  first touch, by the serving plane (serve/service.py).

This package is NOT imported by ``import qrack_tpu_torch``; the store
loads on first touch.
"""

from __future__ import annotations

from .container import (FORMAT, VERSION, CheckpointCorrupt, CheckpointError,
                        CheckpointVersionError, load_container,
                        save_container)
from .registry import (build, capture, load_snapshot, load_state,
                       restore_into, save_state)

__all__ = [
    "FORMAT", "VERSION",
    "CheckpointError", "CheckpointCorrupt", "CheckpointVersionError",
    "save_container", "load_container",
    "capture", "restore_into", "build",
    "save_state", "load_state", "load_snapshot",
    "CheckpointStore", "StoreLeaseHeld", "StoreLockTimeout",
    "enable_warm_start", "ProgramManifest",
]


def __getattr__(name):
    # the store and the warm start stay un-imported until first touched
    if name in ("CheckpointStore", "StoreLeaseHeld", "StoreLockTimeout"):
        from . import store

        return getattr(store, name)
    if name in ("enable_warm_start", "ProgramManifest"):
        from . import warmstart

        return getattr(warmstart, name)
    raise AttributeError(name)
