"""The durable container format: checksummed npz + embedded manifest (a
copy of the JAX package's checkpoint/container.py, stdlib and numpy
only, so a file written by one package loads in the other).

A checkpoint file is a VALID npz archive whose last member,
``__qckpt__``, is a uint8-encoded JSON manifest::

    {"format": "qrack-checkpoint", "version": 1, "kind": "<payload kind>",
     "meta": {...},                      # JSON-able payload description
     "payload": {key: {"sha256", "dtype", "shape"}, ...}}

* **Atomic writes** — the archive is written to a same-directory temp
  file, fsync'd, then ``os.replace``d into place.
* **Corruption detection** — every payload array carries a sha256 over
  its dtype/shape/raw bytes; a truncated archive, a bit-flipped member,
  a key-set mismatch or a missing manifest raises
  :class:`CheckpointCorrupt`.
* **Versioning** — files newer than this reader raise
  :class:`CheckpointVersionError`; bare npz files (no manifest) load
  through ``legacy_ok=True``.

With telemetry on, a save counts ``checkpoint.save`` and
``checkpoint.save.bytes`` and observes its wall under
``checkpoint.save``; a load likewise under ``checkpoint.restore``, as in
the JAX package.  With the resilience plane armed, a save consults the
fault site ``checkpoint.save`` and a load ``checkpoint.restore``
(resilience/faults.py): raise-type kinds propagate, and ``torn-write``
truncates the archive mid-payload before it lands, so the load-side
checks must reject it.  The registry, store, warm start and the
failover snapshot file come with ROADMAP item 15.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
import zipfile
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .. import telemetry as _tele

FORMAT = "qrack-checkpoint"
VERSION = 1
MANIFEST_KEY = "__qckpt__"


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class CheckpointCorrupt(CheckpointError):
    """The file is not a well-formed checkpoint (truncation, checksum
    mismatch, damaged archive, missing/garbled manifest)."""


class CheckpointVersionError(CheckpointError):
    """The file was written by a NEWER format version than this reader
    understands."""


def _sha256(arr: np.ndarray) -> str:
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(tuple(a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _fault_directive(site: str) -> Optional[str]:
    """Consult the resilience fault injector at `site` — only when the
    resilience layer is imported and active, so the default save/load
    path never imports it.  Raise-type kinds propagate; directive
    strings other than "torn-write" are meaningless here."""
    import sys

    res = sys.modules.get("qrack_tpu_torch.resilience")
    if res is None or not getattr(res, "_ACTIVE", False):
        return None
    from ..resilience import faults as _faults

    return _faults.check(site)


def save_container(path: str, arrays: Dict[str, np.ndarray],
                   meta: Optional[dict] = None, kind: str = "raw") -> int:
    """Atomically write `arrays` + manifest to `path`; returns the final
    file size in bytes.  Array keys must not collide with the manifest
    member."""
    t0 = time.perf_counter()
    directive = _fault_directive("checkpoint.save")
    host: Dict[str, np.ndarray] = {}
    payload: Dict[str, dict] = {}
    for key, arr in arrays.items():
        if key.startswith("__"):
            raise CheckpointError(f"reserved array key {key!r}")
        a = np.ascontiguousarray(np.asarray(arr))
        host[key] = a
        payload[key] = {"sha256": _sha256(a), "dtype": str(a.dtype),
                        "shape": list(a.shape)}
    manifest = {"format": FORMAT, "version": VERSION, "kind": kind,
                "meta": meta or {}, "payload": payload}
    mbytes = np.frombuffer(
        json.dumps(manifest, sort_keys=True).encode(), dtype=np.uint8)
    path = str(path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".qckpt-", suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **host, **{MANIFEST_KEY: mbytes})
            f.flush()
            os.fsync(f.fileno())
        if directive == "torn-write":
            # a power cut that committed the rename but lost trailing
            # data blocks: truncate mid-payload, then land it
            size = os.path.getsize(tmp)
            with open(tmp, "r+b") as f:
                f.truncate(max(1, (size * 3) // 5))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    nbytes = os.path.getsize(path)
    if _tele._ENABLED:
        _tele.inc("checkpoint.save")
        _tele.inc("checkpoint.save.bytes", nbytes)
        _tele.observe("checkpoint.save", time.perf_counter() - t0)
    return nbytes


def peek_meta(path: str) -> Tuple[Optional[str], dict]:
    """Read ONLY a container's ``(kind, meta)`` — the manifest member is
    decompressed but no array payload is touched or checksummed."""
    path = str(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            if MANIFEST_KEY not in z.files:
                raise CheckpointCorrupt(
                    f"{path}: no {MANIFEST_KEY} member — not a checkpoint "
                    "container")
            try:
                manifest = json.loads(bytes(z[MANIFEST_KEY].tobytes()))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise CheckpointCorrupt(f"{path}: garbled manifest: {e}")
    except (zipfile.BadZipFile, zlib.error, EOFError) as e:
        raise CheckpointCorrupt(f"{path}: damaged archive: {e}") from None
    except ValueError as e:
        raise CheckpointCorrupt(f"{path}: damaged archive member: {e}"
                                ) from None
    if manifest.get("format") != FORMAT:
        raise CheckpointCorrupt(
            f"{path}: wrong format tag {manifest.get('format')!r}")
    return manifest.get("kind"), manifest.get("meta", {})


def load_container(path: str, expect_kind: Optional[str] = None,
                   legacy_ok: bool = False
                   ) -> Tuple[Optional[str], dict, Dict[str, np.ndarray]]:
    """Read and verify a container; returns ``(kind, meta, arrays)``.

    With ``legacy_ok`` a bare npz (no manifest member) loads unverified
    as ``(None, {}, arrays)``.  Everything else malformed raises
    CheckpointCorrupt; a newer format version raises
    CheckpointVersionError."""
    t0 = time.perf_counter()
    # only raise-type kinds are meaningful on the read path
    _fault_directive("checkpoint.restore")
    path = str(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            names = set(z.files)
            if MANIFEST_KEY not in names:
                if legacy_ok:
                    return None, {}, {k: z[k] for k in z.files}
                raise CheckpointCorrupt(
                    f"{path}: no {MANIFEST_KEY} member — not a checkpoint "
                    "container")
            try:
                manifest = json.loads(bytes(z[MANIFEST_KEY].tobytes()))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise CheckpointCorrupt(f"{path}: garbled manifest: {e}")
            if manifest.get("format") != FORMAT:
                raise CheckpointCorrupt(
                    f"{path}: wrong format tag {manifest.get('format')!r}")
            version = int(manifest.get("version", 0))
            if version > VERSION:
                raise CheckpointVersionError(
                    f"{path}: format version {version} is newer than this "
                    f"reader (supports <= {VERSION})")
            payload = manifest.get("payload", {})
            if set(payload) != names - {MANIFEST_KEY}:
                raise CheckpointCorrupt(
                    f"{path}: archive members do not match the manifest "
                    "payload listing")
            arrays: Dict[str, np.ndarray] = {}
            for key, spec in payload.items():
                a = z[key]
                if _sha256(a) != spec["sha256"]:
                    raise CheckpointCorrupt(
                        f"{path}: checksum mismatch on array {key!r}")
                arrays[key] = a
    except (zipfile.BadZipFile, zlib.error, EOFError) as e:
        raise CheckpointCorrupt(f"{path}: damaged archive: {e}") from None
    except ValueError as e:
        # np.load raises ValueError for truncated/garbled .npy members
        raise CheckpointCorrupt(f"{path}: damaged archive member: {e}"
                                ) from None
    kind = manifest.get("kind")
    if expect_kind is not None and kind != expect_kind:
        raise CheckpointError(
            f"{path}: holds {kind!r}, expected {expect_kind!r}")
    if _tele._ENABLED:
        _tele.inc("checkpoint.restore")
        _tele.inc("checkpoint.restore.bytes", os.path.getsize(path))
        _tele.observe("checkpoint.restore", time.perf_counter() - t0)
    return kind, manifest.get("meta", {}), arrays
