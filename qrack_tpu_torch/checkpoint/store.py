"""CheckpointStore: the bounded on-disk session store behind serving.

One directory owns everything a serving process needs to survive an
idle eviction or an outright crash:

    <root>/manifest.json        live-session manifest (atomic rewrite)
    <root>/sessions/<sid>.qckpt spilled / checkpointed session state
    <root>/wal/<seq>-<sid>.qckpt pending-job journal (one circuit each)

* **Spill/restore** — SessionManager's idle evictor hands the engine
  here instead of discarding it; the state container (registry.py)
  lands under ``sessions/`` and the session keeps only its manifest
  entry until the next job faults it back in (restore-INTO a fresh
  factory-built stack, so wiring closures survive).
* **Crash recovery** — the manifest records every live session's
  constructor recipe (width/layers/seed/engine kwargs) the moment it is
  created, not just when it is spilled; QrackService(recover=True)
  replays it into a fresh process and re-runs any journaled jobs.
* **Bounded** — ``max_bytes`` caps the on-disk footprint; oldest
  state files evict first, EXCEPT those of currently-spilled live
  sessions (``protected_sids``, wired by SessionManager): deleting one
  of those would strand a session that can no longer be faulted back
  in.  Checkpoint snapshots of resident sessions are fair game — the
  live engine still holds the state.  The current footprint is
  exported as the ``checkpoint.store.bytes`` gauge.

Within one process, all mutation happens on the serve executor thread
(the same single-owner discipline as every other engine touch).  ACROSS
processes the store is a shared migration plane (docs/ELASTICITY.md):
N services may point at one root, so

* the manifest is **merge-on-write** under an ``flock`` on
  ``<root>/.store.lock`` — each process only overlays the sessions it
  OWNS (created/adopted here, tracked in ``_owned``) onto what is on
  disk, and only deletes sids it explicitly unregistered
  (``_dropped``), so two processes' manifests never clobber each other;
* ``recover=True`` is gated by an **ownership lease** recorded in the
  manifest (:meth:`acquire_lease`): exactly one process may replay the
  WAL.  Liveness is pid-based on the same host (a kill -9'd owner frees
  the lease instantly) with a TTL fallback across hosts
  (``QRACK_CKPT_LEASE_TTL_S``, default 300 s).

Port note: a copy of the JAX package's checkpoint/store.py (stdlib,
numpy and the port's registry), so a store directory written by either
package is read by the other: the manifest, the session state files,
the journal's circuit containers (``circuit_payload`` over the port's
QCircuit), the acks log and the prefix files keep their layout.  Its
caller is the serving plane (serve/, ROADMAP item 16b).  ``load(sid)``
without a live target builds on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import fcntl
import json
import os
import socket
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .. import telemetry as _tele
from .container import (CheckpointCorrupt, CheckpointError, load_container,
                        peek_meta, save_container)
from .registry import load_state, save_state

MANIFEST_VERSION = 1
CIRCUIT_KIND = "qrack-circuit"
PREFIX_KIND = "qrack-prefix"
DEFAULT_LEASE_TTL_S = 300.0
DEFAULT_LOCK_TIMEOUT_S = 30.0
ACKS_MAX_BYTES = 1 << 20  # settled-tag log rotates past this


class StoreLeaseHeld(CheckpointError):
    """Another live process holds this store's recovery lease."""


class StoreLockTimeout(CheckpointError):
    """.store.lock was held past QRACK_CKPT_LOCK_TIMEOUT_S.

    A peer wedged mid-manifest-write (SIGSTOP, a hung device read under
    its flock, a dead NFS client) must not block a healthy worker's
    save/register forever — the caller gets this typed error after the
    timeout and decides (the fleet supervisor treats it like any other
    worker fault; a library caller can retry)."""

    def __init__(self, path: str, waited_s: float):
        self.path = path
        self.waited_s = waited_s
        super().__init__(
            f"{path}: lock not acquired after {waited_s:.1f}s "
            "(QRACK_CKPT_LOCK_TIMEOUT_S) — a peer is wedged holding it")


# -- circuit <-> container (WAL entries + warm-start program manifest) --


def circuit_payload(circuit) -> Tuple[dict, Dict[str, np.ndarray]]:
    """(meta, arrays) capturing a QCircuit exactly: per-gate payload
    stacks keyed ``g<i>`` with targets/controls/perms in meta."""
    meta_gates = []
    arrays: Dict[str, np.ndarray] = {}
    for i, g in enumerate(circuit.gates):
        perms = sorted(g.payloads)
        meta_gates.append({"target": int(g.target),
                           "controls": [int(c) for c in g.controls],
                           "perms": [int(p) for p in perms]})
        arrays[f"g{i}"] = np.stack(
            [np.asarray(g.payloads[p], dtype=np.complex128) for p in perms])
    return {"n": int(circuit.qubit_count), "gates": meta_gates}, arrays


def circuit_from_payload(meta: dict, arrays: Dict[str, np.ndarray]):
    from ..layers.qcircuit import QCircuit, QCircuitGate

    circ = QCircuit(int(meta["n"]))
    for i, gm in enumerate(meta["gates"]):
        stack = np.asarray(arrays[f"g{i}"], dtype=np.complex128)
        payloads = {int(p): stack[j] for j, p in enumerate(gm["perms"])}
        # bypass AppendGate: the journal replays the merged gate list
        # verbatim, it must not re-merge
        circ.gates.append(QCircuitGate(int(gm["target"]), payloads,
                                       tuple(gm["controls"])))
    return circ


def save_circuit(path: str, circuit, extra_meta: Optional[dict] = None) -> int:
    meta, arrays = circuit_payload(circuit)
    if extra_meta:
        meta.update(extra_meta)
    return save_container(path, arrays, meta=meta, kind=CIRCUIT_KIND)


def load_circuit(path: str):
    """Returns (circuit, meta)."""
    _, meta, arrays = load_container(path, expect_kind=CIRCUIT_KIND)
    return circuit_from_payload(meta, arrays), meta


def _json_safe(kwargs: dict) -> dict:
    out = {}
    for k, v in kwargs.items():
        try:
            json.dumps(v)
        except (TypeError, ValueError):
            continue
        out[k] = v
    return out


class CheckpointStore:
    def __init__(self, root: str, max_bytes: int = 512 * 1024 * 1024,
                 keep_states: bool = False):
        self.root = str(root)
        self.max_bytes = int(max_bytes)
        # every session state file is a recovery copy (a service that
        # snapshots every job, as a fleet's workers do): the byte budget
        # evicts spilled prefixes only.  Otherwise a worker's budget
        # deleted a peer's or its own resident session's last snapshot,
        # and adoption rebuilt that session from |0…0>.
        self.keep_states = bool(keep_states)
        # liveness callback: sids whose state files the budget evictor
        # must never touch (live spilled sessions — SessionManager wires
        # this); None means nothing is protected beyond the fresh write
        self.protected_sids: Optional[Callable[[], Iterable[str]]] = None
        self._sessions_dir = os.path.join(self.root, "sessions")
        self._wal_dir = os.path.join(self.root, "wal")
        # spilled prefix-cache planes (serve/prefix_cache.py): evict-
        # first under the byte budget — a prefix is always
        # re-materializable from its circuit, session state is not
        self._prefix_dir = os.path.join(self.root, "prefix")
        os.makedirs(self._sessions_dir, exist_ok=True)
        os.makedirs(self._wal_dir, exist_ok=True)
        os.makedirs(self._prefix_dir, exist_ok=True)
        self._manifest_path = os.path.join(self.root, "manifest.json")
        self._lock_path = os.path.join(self.root, ".store.lock")
        self._acks_path = os.path.join(self.root, "acks.log")
        # cross-process manifest ownership: only sids in _owned are
        # overlaid from memory onto disk at write time; only sids in
        # _dropped are deleted.  Everything else on disk belongs to
        # some other process sharing this root and passes through.
        self._owned: set = set()
        self._dropped: set = set()
        self._manifest = self._read_manifest()
        # WAL appends come from submitter threads (everything else is
        # executor-thread-only); the sequence counter needs the lock
        self._wal_lock = threading.Lock()
        self._wal_seq = self._scan_wal_seq()
        self._update_gauge()

    # -- manifest ------------------------------------------------------

    @contextmanager
    def _file_lock(self):
        """Advisory exclusive lock serializing manifest read-merge-write
        cycles across every process sharing this root (flock works
        between threads of one process too — each entry opens its own
        file description).  Acquisition is BOUNDED: LOCK_NB polled up to
        ``QRACK_CKPT_LOCK_TIMEOUT_S`` (default 30 s, 0 = wait forever),
        then :class:`StoreLockTimeout` — a peer wedged under the flock
        must not wedge every healthy worker's save with it."""
        timeout_s = float(os.environ.get("QRACK_CKPT_LOCK_TIMEOUT_S",
                                         str(DEFAULT_LOCK_TIMEOUT_S)))
        with open(self._lock_path, "a+") as f:
            if timeout_s <= 0:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            else:
                deadline = time.monotonic() + timeout_s
                delay = 0.001
                while True:
                    try:
                        fcntl.flock(f.fileno(),
                                    fcntl.LOCK_EX | fcntl.LOCK_NB)
                        break
                    except OSError:
                        if time.monotonic() >= deadline:
                            if _tele._ENABLED:
                                _tele.inc("checkpoint.lock.timeout")
                            raise StoreLockTimeout(self._lock_path,
                                                   timeout_s)
                        time.sleep(delay)
                        delay = min(delay * 2, 0.05)
            try:
                yield
            finally:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)

    def _read_manifest(self) -> dict:
        try:
            with open(self._manifest_path) as f:
                m = json.load(f)
        except FileNotFoundError:
            return {"version": MANIFEST_VERSION, "sessions": {}}
        except (OSError, json.JSONDecodeError):
            # a torn manifest must not kill recovery of the state files
            return {"version": MANIFEST_VERSION, "sessions": {}}
        if int(m.get("version", 0)) > MANIFEST_VERSION:
            raise CheckpointError(
                f"{self._manifest_path}: manifest version "
                f"{m.get('version')} is newer than this reader")
        m.setdefault("sessions", {})
        return m

    def _write_raw(self, manifest: dict) -> None:
        """Atomic rewrite (tmp + fsync + os.replace) — call under
        :meth:`_file_lock` when other processes may share the root."""
        fd, tmp = tempfile.mkstemp(prefix=".manifest-", suffix=".tmp",
                                   dir=self.root)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._manifest_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _write_manifest(self) -> None:
        """Merge-on-write: overlay only the sessions this process owns
        onto the manifest currently on disk, preserving other processes'
        records and the lease verbatim, then rewrite atomically."""
        with self._file_lock():
            disk = self._read_manifest()
            sessions = disk["sessions"]
            for sid in self._dropped:
                sessions.pop(sid, None)
            for sid in self._owned:
                rec = self._manifest["sessions"].get(sid)
                if rec is not None:
                    sessions[sid] = rec
            self._write_raw(disk)
            self._manifest = disk

    def register(self, sid: str, width: int, layers, seed,
                 engine_kwargs: Optional[dict] = None) -> None:
        """Record a live session's constructor recipe for recovery."""
        self._owned.add(sid)
        self._dropped.discard(sid)
        self._manifest["sessions"][sid] = {
            "width": int(width),
            "layers": layers if isinstance(layers, str) else list(layers),
            "seed": None if seed is None else int(seed),
            "engine_kwargs": _json_safe(engine_kwargs or {}),
            # True once the session's state has advanced beyond what the
            # on-disk snapshot (or a fresh |0..0>) captures — recovery
            # must not replay WAL jobs onto a base that is wrong
            "dirty": False,
        }
        self._write_manifest()

    def mark_dirty(self, sid: str) -> None:
        """Record that `sid`'s live state is no longer captured on disk
        (a job completed, or its snapshot was consumed).  No-op when
        already dirty, so the per-job cost is one dict probe."""
        rec = self._manifest["sessions"].get(sid)
        if rec is not None and not rec.get("dirty", False):
            rec["dirty"] = True
            self._write_manifest()

    def _mark_clean(self, sid: str) -> None:
        rec = self._manifest["sessions"].get(sid)
        if rec is not None and rec.get("dirty", True):
            rec["dirty"] = False
            self._write_manifest()

    def is_dirty(self, sid: str) -> bool:
        rec = self._manifest["sessions"].get(sid)
        return bool(rec.get("dirty", False)) if rec else False

    def unregister(self, sid: str) -> None:
        self._owned.discard(sid)
        self._dropped.add(sid)
        if self._manifest["sessions"].pop(sid, None) is not None:
            self._write_manifest()
        self.drop_state(sid)
        for path, _, wal_sid in self._wal_files():
            if wal_sid == sid:
                self._unlink(path)
        self._update_gauge()

    def disown(self, sid: str) -> None:
        """Stop overlaying `sid` at manifest writes WITHOUT deleting its
        record or state file — the drain handoff: the entry stays on
        disk for whichever process adopts it, and this process's later
        writes can no longer clobber the adopter's updates."""
        self._owned.discard(sid)

    def reload(self) -> None:
        """Re-read shared disk state (manifest + WAL sequence).  An
        adoption pass calls this first: another process may have drained
        sessions into the store since this one last looked."""
        with self._file_lock():
            self._manifest = self._read_manifest()
        with self._wal_lock:
            self._wal_seq = max(self._wal_seq, self._scan_wal_seq())

    def sessions(self) -> Dict[str, dict]:
        return dict(self._manifest["sessions"])

    # -- recovery lease (multi-process WAL-replay exclusivity) ---------

    def _lease_live(self, lease: Optional[dict]) -> bool:
        """Same-host pid liveness is authoritative (kill -9 frees the
        lease the moment the pid is gone); cross-host falls back to the
        recorded TTL."""
        if not lease:
            return False
        if lease.get("host") == socket.gethostname() and lease.get("pid"):
            try:
                os.kill(int(lease["pid"]), 0)
                return True
            except (OSError, ValueError):
                return False
        return time.time() < float(lease.get("expires_at", 0))

    def acquire_lease(self, owner: str, ttl_s: Optional[float] = None) -> bool:
        """Take (or refresh) the store's recovery lease.  False when a
        DIFFERENT live owner holds it — the caller must not replay the
        WAL.  A dead owner's lease (pid gone / TTL expired) is claimed
        over."""
        if ttl_s is None:
            ttl_s = float(os.environ.get("QRACK_CKPT_LEASE_TTL_S",
                                         str(DEFAULT_LEASE_TTL_S)))
        with self._file_lock():
            disk = self._read_manifest()
            cur = disk.get("lease")
            if cur and cur.get("owner") != owner and self._lease_live(cur):
                if _tele._ENABLED:
                    _tele.inc("checkpoint.lease.denied")
                    _tele.event("checkpoint.lease.denied", owner=owner,
                                holder=str(cur.get("owner")))
                return False
            now = time.time()
            disk["lease"] = {"owner": owner, "host": socket.gethostname(),
                             "pid": os.getpid(), "acquired_at": now,
                             "expires_at": now + ttl_s}
            self._write_raw(disk)
            self._manifest = disk
        if _tele._ENABLED:
            _tele.inc("checkpoint.lease.acquired")
            _tele.event("checkpoint.lease.acquired", owner=owner)
        return True

    def release_lease(self, owner: str) -> bool:
        """Drop the lease iff `owner` holds it (drain / clean shutdown
        hand the store to the next process immediately)."""
        with self._file_lock():
            disk = self._read_manifest()
            cur = disk.get("lease")
            if not cur or cur.get("owner") != owner:
                return False
            del disk["lease"]
            self._write_raw(disk)
            self._manifest = disk
        if _tele._ENABLED:
            _tele.inc("checkpoint.lease.released")
        return True

    def lease_info(self) -> Optional[dict]:
        lease = self._manifest.get("lease")
        return dict(lease) if lease else None

    # -- session state (spill / checkpoint / restore) ------------------

    def _state_path(self, sid: str) -> str:
        return os.path.join(self._sessions_dir, f"{sid}.qckpt")

    def has_state(self, sid: str) -> bool:
        return os.path.exists(self._state_path(sid))

    def save(self, sid: str, engine,
             wal_seq: Optional[int] = None) -> str:
        """Persist `engine`'s full state for `sid` (spill or explicit
        checkpoint — the caller decides whether to drop residency).

        `wal_seq` records the highest journal sequence whose effect the
        snapshot already CONTAINS (manifest ``wal_high``): recovery
        skips entries at or below it, so the
        snapshot-then-settle order of QRACK_SERVE_CKPT_EVERY_JOB can
        never double-replay the job a crash interrupted mid-settle.
        The value also rides INSIDE the state container (same atomic
        replace as the state itself): a kill -9 in the window between
        the state write and the manifest rewrite used to leave a
        snapshot that already contained the job next to a manifest
        that said it didn't — recovery replayed the surviving WAL entry
        onto it and the job applied twice (:meth:`state_wal_high` is
        the recovery-side reader)."""
        path = self._state_path(sid)
        extra = None if wal_seq is None else {"wal_high": int(wal_seq)}
        save_state(engine, path, extra_meta=extra)
        rec = self._manifest["sessions"].get(sid)
        if rec is not None:
            changed = rec.get("dirty", True)
            rec["dirty"] = False  # disk now captures the state exactly
            if wal_seq is not None and int(wal_seq) > rec.get("wal_high",
                                                              -1):
                rec["wal_high"] = int(wal_seq)
                changed = True
            if changed:
                self._write_manifest()
        self._enforce_budget(protect=path)
        self._update_gauge()
        return path

    def load(self, sid: str, into=None, device=None):
        """Restore `sid`'s state; raises CheckpointError when absent."""
        path = self._state_path(sid)
        if not os.path.exists(path):
            raise CheckpointError(f"no spilled state for session {sid}")
        return load_state(path, into=into, device=device)

    def state_wal_high(self, sid: str) -> int:
        """The ``wal_high`` recorded inside `sid`'s state container, or
        -1 (no snapshot / no record / unreadable).  Authoritative over
        the manifest copy during recovery: the container's value commits
        atomically with the state, the manifest's lags by one write."""
        path = self._state_path(sid)
        if not os.path.exists(path):
            return -1
        try:
            _, meta = peek_meta(path)
        except (CheckpointCorrupt, CheckpointError):
            return -1
        try:
            return int(meta.get("wal_high", -1))
        except (TypeError, ValueError):
            return -1

    def drop_state(self, sid: str) -> None:
        self._unlink(self._state_path(sid))
        self._update_gauge()

    def _enforce_budget(self, protect: Optional[str] = None) -> List[str]:
        """Evict oldest state files until under max_bytes.  Protected:
        the just-written file (a single oversized session must not evict
        itself into a lost update) and every live spilled session's
        state (the only copy of that session — deleting it would make
        its next restore fail for the life of the process)."""
        if self.max_bytes <= 0:
            return []
        live = set(self.protected_sids()) if self.protected_sids else set()
        evicted = []
        while self.total_bytes() > self.max_bytes:
            # spilled prefixes (rank 0) go before session state (rank 1):
            # a prefix is always re-materializable from its circuit
            states = [] if self.keep_states else self._state_files()
            victims = sorted(
                [(0, os.path.getmtime(p), p) for p in self._prefix_files()
                 if p != protect]
                + [(1, os.path.getmtime(p), p) for p in states
                   if p != protect
                   and os.path.basename(p)[:-len(".qckpt")] not in live])
            if not victims:
                break
            _, _, path = victims[0]
            self._unlink(path)
            evicted.append(path)
        if evicted and _tele._ENABLED:
            _tele.inc("checkpoint.store.evicted", len(evicted))
        return evicted

    # -- spilled prefix-cache planes (serve/prefix_cache.py) -----------

    def _prefix_path(self, digest: str, width: int, stack: str) -> str:
        return os.path.join(self._prefix_dir,
                            f"{digest}-w{int(width)}-{stack}.qckpt")

    def save_prefix(self, digest: str, width: int, stack: str,
                    arrays: Dict[str, np.ndarray],
                    meta: Optional[dict] = None) -> str:
        """Spill a prefix-cache entry's planes; returns the path.  The
        container's per-array sha256 gives disk-level integrity; the
        cache layers its own host fingerprint on top (fault-back-in
        verifies BOTH before any tenant is seeded from the entry)."""
        path = self._prefix_path(digest, width, stack)
        m = dict(meta or {})
        m.update({"digest": digest, "width": int(width), "stack": stack})
        save_container(path, arrays, meta=m, kind=PREFIX_KIND)
        self._enforce_budget(protect=path)
        self._update_gauge()
        return path

    def load_prefix(self, digest: str, width: int, stack: str):
        """(meta, arrays) for a spilled prefix entry; CheckpointError
        when absent, CheckpointCorrupt on a bad container hash."""
        path = self._prefix_path(digest, width, stack)
        if not os.path.exists(path):
            raise CheckpointError(
                f"no spilled prefix {digest[:12]}… w{width} {stack}")
        _, meta, arrays = load_container(path, expect_kind=PREFIX_KIND)
        return meta, arrays

    def has_prefix(self, digest: str, width: int, stack: str) -> bool:
        return os.path.exists(self._prefix_path(digest, width, stack))

    def drop_prefix(self, digest: str, width: int, stack: str) -> None:
        self._unlink(self._prefix_path(digest, width, stack))
        self._update_gauge()

    def prefix_entries(self) -> List[Tuple[str, int, str]]:
        """[(digest, width, stack)] for every spilled prefix on disk —
        a recovered service probes these to rebuild a warm cache."""
        out = []
        try:
            names = os.listdir(self._prefix_dir)
        except OSError:
            return []
        for name in names:
            if not name.endswith(".qckpt"):
                continue
            stem = name[:-len(".qckpt")]
            digest, _, rest = stem.partition("-w")
            width_s, _, stack = rest.partition("-")
            try:
                out.append((digest, int(width_s), stack))
            except ValueError:
                continue
        return out

    def _prefix_files(self) -> List[str]:
        try:
            return [os.path.join(self._prefix_dir, n)
                    for n in os.listdir(self._prefix_dir)
                    if n.endswith(".qckpt")]
        except OSError:
            return []

    # -- pending-job journal (WAL) -------------------------------------

    def _scan_wal_seq(self) -> int:
        seqs = [seq for _, seq, _ in self._wal_files()]
        return max(seqs) + 1 if seqs else 0

    def _wal_files(self) -> List[Tuple[str, int, str]]:
        """[(path, seq, sid)] sorted by seq."""
        out = []
        try:
            names = os.listdir(self._wal_dir)
        except OSError:
            return []
        for name in names:
            if not name.endswith(".qckpt"):
                continue
            stem = name[:-len(".qckpt")]
            seq_s, _, sid = stem.partition("-")
            try:
                seq = int(seq_s)
            except ValueError:
                continue
            out.append((os.path.join(self._wal_dir, name), seq, sid))
        out.sort(key=lambda t: t[1])
        return out

    def wal_append(self, sid: str, circuit,
                   tag: Optional[str] = None) -> str:
        """Journal a submitted circuit; the executor deletes the entry
        at job completion, so entries still present at startup are
        exactly the jobs a crash interrupted.  `tag` is an opaque
        caller token persisted in the entry's meta — the fleet front
        door stamps each RPC submit so a resubmit decision after a
        worker death can check :meth:`wal_pending_tags` instead of
        guessing (docs/FLEET.md exactly-once discussion)."""
        with self._wal_lock:
            seq = self._wal_seq
            self._wal_seq += 1
        path = os.path.join(self._wal_dir, f"{seq:09d}-{sid}.qckpt")
        meta = {"sid": sid, "seq": seq}
        if tag is not None:
            meta["tag"] = str(tag)
        save_circuit(path, circuit, extra_meta=meta)
        self._update_gauge()
        return path

    def wal_pending_tags(self, sids: Optional[Iterable[str]] = None
                         ) -> set:
        """Tags of journal entries still pending (optionally scoped to
        `sids`).  A tag present here is a submit whose effect WILL be
        applied by whichever process adopts the session — the caller
        must not resubmit it.  Damaged entries are left for
        wal_entries() to reap."""
        want = None if sids is None else set(sids)
        tags = set()
        for path, _, sid in self._wal_files():
            if want is not None and sid not in want:
                continue
            try:
                _, meta = load_circuit(path)
            except FileNotFoundError:
                continue  # settled since the listing: no longer pending
            except (CheckpointCorrupt, CheckpointError):
                continue
            tag = meta.get("tag")
            if tag is not None:
                tags.add(tag)
        return tags

    def wal_remove(self, path: str) -> None:
        self._unlink(path)
        self._update_gauge()

    # -- settled-tag acks (fleet exactly-once) -------------------------

    def ack_tag(self, tag: str) -> None:
        """Durably record that the submit carrying `tag` SETTLED —
        appended by the executor after the job's effect is snapshotted
        (or journaled past) but BEFORE its WAL entry is removed.  The
        fleet front door's resubmit decision consults
        :meth:`tag_acked`: without this record, a worker killed in the
        instant between settling a job and writing its result frame
        looks identical to one killed before executing it, and the
        front door's only safe-looking move — resubmit — applies the
        job twice.  Cross-process safe: appends hold the store flock
        and stay under the pipe-atomicity size."""
        line = (str(tag).replace("\n", " ") + "\n").encode()
        with self._file_lock():
            try:
                if (os.path.exists(self._acks_path)
                        and os.path.getsize(self._acks_path)
                        > ACKS_MAX_BYTES):
                    self._rotate_acks()
            except OSError:
                pass
            with open(self._acks_path, "ab") as f:
                f.write(line)
                f.flush()

    def _rotate_acks(self) -> None:
        """Keep the newest half of the ack log (caller holds the store
        flock).  Resubmit decisions happen within seconds of a worker
        death, so dropping months-old tags can't reopen the window."""
        try:
            with open(self._acks_path, "rb") as f:
                data = f.read()
        except OSError:
            return
        keep = data[len(data) // 2:]
        nl = keep.find(b"\n")
        if nl >= 0:
            keep = keep[nl + 1:]
        fd, tmp = tempfile.mkstemp(prefix=".acks-", suffix=".tmp",
                                   dir=self.root)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(keep)
            os.replace(tmp, self._acks_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def tag_acked(self, tag: str) -> bool:
        """True when `tag`'s submit settled on SOME worker sharing this
        store (exact-line match against the ack log)."""
        try:
            with open(self._acks_path, "rb") as f:
                data = f.read()
        except OSError:
            return False
        return str(tag).encode() in data.split(b"\n")

    def wal_entries(self, sids: Optional[Iterable[str]] = None,
                    with_meta: bool = False
                    ) -> List[Tuple]:
        """[(sid, seq, circuit)] in submit order; damaged entries (torn
        writes at crash time) are skipped and removed.  With `sids`,
        only those sessions' entries are returned — scoped adoption
        (fleet re-placement) must not read a live peer's journal.
        With `with_meta`, 4-tuples (sid, seq, circuit, meta) — the
        serve recovery path reads the entry tag to distinguish circuit
        replays from journaled trajectory jobs (docs/NOISE.md)."""
        want = None if sids is None else set(sids)
        out = []
        for path, seq, sid in self._wal_files():
            if want is not None and sid not in want:
                continue
            try:
                circ, meta = load_circuit(path)
            except FileNotFoundError:
                continue  # settled by its worker since the listing
            except (CheckpointCorrupt, CheckpointError):
                self._unlink(path)
                continue
            out.append((sid, seq, circ, meta) if with_meta
                       else (sid, seq, circ))
        return out

    def clear_wal(self, sids: Optional[Iterable[str]] = None) -> None:
        """Drop journal entries — all of them (legacy whole-store
        adoption), or only the named sessions' (scoped adoption: a
        fleet peer adopting a dead worker's sids must leave every other
        worker's pending entries in place)."""
        want = None if sids is None else set(sids)
        for path, _, sid in self._wal_files():
            if want is not None and sid not in want:
                continue
            self._unlink(path)
        self._update_gauge()

    # -- footprint -----------------------------------------------------

    def _state_files(self) -> List[str]:
        try:
            return [os.path.join(self._sessions_dir, n)
                    for n in os.listdir(self._sessions_dir)
                    if n.endswith(".qckpt")]
        except OSError:
            return []

    def total_bytes(self) -> int:
        total = 0
        for d in (self._sessions_dir, self._wal_dir, self._prefix_dir):
            try:
                for name in os.listdir(d):
                    try:
                        total += os.path.getsize(os.path.join(d, name))
                    except OSError:
                        pass
            except OSError:
                pass
        return total

    def stats(self) -> dict:
        return {
            "root": self.root,
            "sessions": len(self._manifest["sessions"]),
            "spilled": len(self._state_files()),
            "spilled_prefixes": len(self._prefix_files()),
            "wal_entries": len(self._wal_files()),
            "bytes": self.total_bytes(),
            "max_bytes": self.max_bytes,
        }

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def _update_gauge(self) -> None:
        if _tele._ENABLED:
            _tele.gauge("checkpoint.store.bytes", self.total_bytes())
