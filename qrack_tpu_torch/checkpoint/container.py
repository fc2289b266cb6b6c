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
checks must reject it.

One difference by design: members are written STORED (``np.savez``),
where the JAX package deflates them (``np.savez_compressed``).  The
digests, the manifest and the member layout are the same, and
``np.load`` reads both, so a file written by either package loads in
the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import struct
import tempfile
import threading
import time
import zipfile
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .. import telemetry as _tele

FORMAT = "qrack-checkpoint"
VERSION = 1
MANIFEST_KEY = "__qckpt__"

#: the parts of the last save and load, in seconds, with the file's
#: bytes: the archive's write (fsync included) or its members' read; the
#: payload's digests, which run on threads beside the write and the read
#: (hash_s: the threads' own time, summed; hash_wait_s: the wait for them
#: after the write or the read).  Host clocks; chip_smoke.py prints them.
LAST_SAVE = {"write_s": 0.0, "hash_s": 0.0, "hash_wait_s": 0.0, "bytes": 0}
LAST_LOAD = {"read_s": 0.0, "hash_s": 0.0, "hash_wait_s": 0.0, "bytes": 0}


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class CheckpointCorrupt(CheckpointError):
    """The file is not a well-formed checkpoint (truncation, checksum
    mismatch, damaged archive, missing/garbled manifest)."""


class CheckpointVersionError(CheckpointError):
    """The file was written by a NEWER format version than this reader
    understands."""


def _sha256(arr: np.ndarray) -> str:
    """The JAX package's digest (dtype, shape, raw bytes), read through a
    byte view of the contiguous array: no copy of the payload."""
    a = np.ascontiguousarray(arr)
    h = _hasher(a)
    h.update(a.reshape(-1).view(np.uint8).data)
    return h.hexdigest()


# arrays of this many bytes or more hash on a thread of their own, slice
# by slice beside the archive's write or read (hashlib and zlib release
# the GIL on large buffers, and so does file I/O)
_THREAD_BYTES = 1 << 26
# the slice a member is written or read by, and handed to its hashing
# thread as soon as it has been written or has landed
_CHUNK = 1 << 26


def _hasher(a: np.ndarray):
    """A sha256 primed with `a`'s dtype and shape (the digest _sha256
    computes once the raw bytes follow)."""
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(tuple(a.shape)).encode())
    return h


def _timed_sha256(a: np.ndarray):
    t0 = time.perf_counter()
    return _sha256(a), time.perf_counter() - t0


class _StreamHash:
    """sha256 over slices of an array as they land, on a thread of its
    own, in order."""

    def __init__(self, a: np.ndarray):
        self.h = _hasher(a)
        self.seconds = 0.0   # the thread's own time hashing
        self.q: "queue.Queue" = queue.Queue()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while True:
            mv = self.q.get()
            if mv is None:
                return
            t0 = time.perf_counter()
            self.h.update(mv)
            self.seconds += time.perf_counter() - t0

    def feed(self, mv) -> None:
        self.q.put(mv)

    def finish(self):
        """(hex digest, the thread's seconds hashing), once every slice
        fed has been hashed."""
        self.q.put(None)
        self.t.join()
        return self.h.hexdigest(), self.seconds


def _write_member(zf, name: str, a: np.ndarray):
    """One .npy member as np.savez writes it (a version 1.0 header, then
    the raw C-order bytes), the bytes handed to the zip writer slice by
    slice with no copy.  Returns finish() -> (digest, seconds hashing):
    a large array hashes on a thread as its slices are written."""
    hs = _StreamHash(a) if a.nbytes >= _THREAD_BYTES else None
    try:
        with zf.open(name, "w", force_zip64=True) as w:
            np.lib.format.write_array_header_1_0(
                w, np.lib.format.header_data_from_array_1_0(a))
            flat = a.reshape(-1).view(np.uint8)
            for s0 in range(0, a.nbytes, _CHUNK):
                mv = flat[s0:s0 + _CHUNK].data
                w.write(mv)
                if hs is not None:
                    hs.feed(mv)
    except BaseException:
        if hs is not None:
            hs.finish()
        raise
    return (lambda: _timed_sha256(a)) if hs is None else hs.finish


def _read_stored(f, info, key: str, path: str):
    """A stored .npy member read straight into its array (no zipfile
    read loop, no copy), hashed slice by slice on a thread as it lands.
    Returns (array, seconds reading, finish), where finish() joins the
    hashing and gives (digest, seconds hashing), or None for a header
    version other than 1.0/2.0 (np.load reads those)."""
    f.seek(info.header_offset)
    head = f.read(30)
    if len(head) != 30 or head[:4] != b"PK\x03\x04":
        raise CheckpointCorrupt(f"{path}: bad local header for {key!r}")
    n_name, n_extra = struct.unpack("<HH", head[26:30])
    f.seek(info.header_offset + 30 + n_name + n_extra)
    start = f.tell()
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        return None
    if fortran or dtype.hasobject:
        raise CheckpointCorrupt(f"{path}: unexpected layout of {key!r}")
    a = np.empty(shape, dtype=dtype)
    if f.tell() - start + a.nbytes != info.file_size:
        raise CheckpointCorrupt(f"{path}: member {key!r} has the wrong size")
    flat = a.reshape(-1).view(np.uint8)
    t_read = 0.0
    if a.nbytes < _THREAD_BYTES:
        t1 = time.perf_counter()
        got = f.readinto(flat.data)
        t_read = time.perf_counter() - t1
        if got != a.nbytes:
            raise CheckpointCorrupt(f"{path}: member {key!r} is truncated")
        return a, t_read, lambda: _timed_sha256(a)
    hs = _StreamHash(a)
    try:
        for s0 in range(0, a.nbytes, _CHUNK):
            mv = flat[s0:s0 + _CHUNK].data
            t1 = time.perf_counter()
            got = f.readinto(mv)
            t_read += time.perf_counter() - t1
            if got != len(mv):
                raise CheckpointCorrupt(
                    f"{path}: member {key!r} is truncated")
            hs.feed(mv)
    except BaseException:
        hs.finish()
        raise
    # the digest finishes beside the next members' reads
    return a, t_read, hs.finish


class _Writeback:
    """While a large archive is written, flush what has reached the page
    cache to the disk every quarter second on a thread of its own, so
    the final fsync waits only for the tail (fsync releases the GIL and
    does not touch the writer's buffer)."""

    def __init__(self, f):
        self.fd = f.fileno()
        self.done = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.done.wait(0.25):
            try:
                os.fdatasync(self.fd)
            except OSError:
                return

    def __enter__(self):
        self.t.start()
        return self

    def __exit__(self, *exc):
        self.done.set()
        self.t.join()


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
    for key, arr in arrays.items():
        if key.startswith("__"):
            raise CheckpointError(f"reserved array key {key!r}")
        host[key] = np.ascontiguousarray(np.asarray(arr))
    path = str(path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".qckpt-", suffix=".tmp", dir=d)
    hash_wait = hash_s = 0.0
    try:
        with os.fdopen(fd, "wb") as f, _Writeback(f):
            # np.savez's layout, stored members (zlib gains nothing on
            # ket mantissas and costs ~30x the write time; np.load reads
            # stored and deflated members alike), the manifest last so
            # the digests can run beside the payload's write
            with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                finish = {key: _write_member(zf, key + ".npy", a)
                          for key, a in host.items()}
                t_wait = time.perf_counter()
                payload: Dict[str, dict] = {}
                for key, a in host.items():
                    digest, t_h = finish[key]()
                    hash_s += t_h
                    payload[key] = {"sha256": digest, "dtype": str(a.dtype),
                                    "shape": list(a.shape)}
                hash_wait = time.perf_counter() - t_wait
                manifest = {"format": FORMAT, "version": VERSION,
                            "kind": kind, "meta": meta or {},
                            "payload": payload}
                mbytes = np.frombuffer(json.dumps(
                    manifest, sort_keys=True).encode(), dtype=np.uint8)
                _write_member(zf, MANIFEST_KEY + ".npy", mbytes)
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
    LAST_SAVE.update(hash_s=hash_s, hash_wait_s=hash_wait,
                     write_s=time.perf_counter() - t0 - hash_wait,
                     bytes=nbytes)
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
            read_s = hash_s = 0.0
            t_members = time.perf_counter()
            # stored members (this package's) are read straight into
            # their arrays and hashed as they land; deflated ones (the
            # JAX package's) through np.load.  The sha256 of each array
            # is the check: the zip's CRC adds nothing to it
            zinfo = {i.filename: i for i in z.zip.infolist()}
            pending = []
            try:
                with open(path, "rb") as raw:
                    for key in payload:
                        info = zinfo.get(key + ".npy")
                        got = None
                        if (info is not None and
                                info.compress_type == zipfile.ZIP_STORED):
                            got = _read_stored(raw, info, key, path)
                        if got is None:
                            t1 = time.perf_counter()
                            a = z[key]
                            got = (a, time.perf_counter() - t1,
                                   lambda a=a: _timed_sha256(a))
                        arrays[key], t_r, finish = got
                        read_s += t_r
                        pending.append((key, finish))
            finally:
                digests = [(key, finish()) for key, finish in pending]
            for key, (digest, t_h) in digests:
                hash_s += t_h
                if digest != payload[key]["sha256"]:
                    raise CheckpointCorrupt(
                        f"{path}: checksum mismatch on array {key!r}")
            hash_wait = time.perf_counter() - t_members - read_s
    except (zipfile.BadZipFile, zlib.error, EOFError, struct.error) as e:
        raise CheckpointCorrupt(f"{path}: damaged archive: {e}") from None
    except ValueError as e:
        # np.load raises ValueError for truncated/garbled .npy members
        raise CheckpointCorrupt(f"{path}: damaged archive member: {e}"
                                ) from None
    kind = manifest.get("kind")
    if expect_kind is not None and kind != expect_kind:
        raise CheckpointError(
            f"{path}: holds {kind!r}, expected {expect_kind!r}")
    nbytes = os.path.getsize(path)
    LAST_LOAD.update(read_s=read_s, hash_s=hash_s, hash_wait_s=hash_wait,
                     bytes=nbytes)
    if _tele._ENABLED:
        _tele.inc("checkpoint.restore")
        _tele.inc("checkpoint.restore.bytes", nbytes)
        _tele.inc("checkpoint.restore.read_s", read_s)
        _tele.inc("checkpoint.restore.hash_wait_s", hash_wait)
        _tele.observe("checkpoint.restore", time.perf_counter() - t0)
    return kind, manifest.get("meta", {}), arrays
