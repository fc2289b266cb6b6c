"""Prefix-sharing copy-on-write ket cache: N tenants pay a shared
state-prep ONCE (the port of the JAX package's serve/prefix_cache.py).

Millions of users means massive redundancy — ansatz tenants share a
state-prep prefix, parameter-sweep jobs differ only in late-layer
angles — yet the plain submit path executes every circuit in full from
|0…0⟩.  This module is the LLM-serving prefix-cache move applied to
kets:

* **Key** — ``(QCircuit.prefix_digest(k), width, stack)``.  The rolling
  digest chain gives every prefix length an O(1) key; only
  measurement-free UNITARY prefixes are shareable (a projector draws
  per-tenant rng), and noisy/trajectory jobs never share.
* **Copy-on-write sharing, by copy at seed** — the port's planes change
  in place (the window kernel, SetAmplitude, every pager pass), so a
  seeded session takes its OWN copy of the entry's planes
  (serve/executor.py ``_seed_prefix``; one ket copy a hit, counted as
  ``serve.prefix.cow``) and no later in-place pass can reach the entry
  or a sibling tenant seeded from it.  The JAX package's pin registry
  (``_PLANE_PINS``, copy at the first donating dispatch) has no
  counterpart and needs none.
* **Admission split** — QrackService.submit finds the LONGEST cached
  prefix, seeds the engine from it at dispatch time, and batches only
  the per-tenant suffix by ``(prefix_digest, suffix_shape_key)``.  A
  miss on a popular prefix (refcounted by recent lookups) materializes
  and inserts it, so the second tenant of any ansatz already shares.
* **Bounded** — entries evict by bytes×recency against
  ``QRACK_SERVE_PREFIX_BYTES`` (default 256 MiB), spilling to the
  checkpoint store's ``prefix/`` tier when one is attached (fault-back-
  in is transparent, and the store's own byte budget evicts prefix
  spills before any session state).
* **Integrity** — every entry carries a host sha256 fingerprint taken
  at insert, after a finiteness + unit-norm validation.  Fault-back-in
  re-verifies container hash AND fingerprint; the ``prefix.materialize``
  fault site lets the soak prove a corrupted prefix is detected and
  evicted, never served twice (amp-corrupt's norm displacement is
  ≥0.06, an order of magnitude past the validation tolerance).

Telemetry: serve.prefix.{hit,miss,insert,evict,spill,bytes,hit_depth}
plus serve.prefix.{cow,corrupt,faultin,lost} (the JAX package's names).

Everything here is OFF unless QrackService wires a cache in
(QRACK_SERVE_PREFIX=0 disables wiring entirely; no engine path changes
behavior).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import telemetry as _tele

# |norm - 1| past this fails insert/fault-in validation.  f32 drift over
# a few hundred shareable-prefix gates is ~1e-5; faults.corrupt_output
# guarantees a displacement whose norm error is >= 0.06.
NORM_TOL = 0.02
DEFAULT_MAX_BYTES = 256 * 1024 * 1024
# popularity window: distinct recent-miss digests tracked at once
REFS_CAP = 1024


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class PrefixEntry:
    __slots__ = ("digest", "width", "stack", "depth", "planes", "nbytes",
                 "fingerprint", "last_used", "hits", "spilled", "dtype",
                 "device")

    def __init__(self, digest: str, width: int, stack: str, depth: int,
                 planes, nbytes: int, fingerprint: str):
        self.digest = digest
        self.width = int(width)
        self.stack = stack
        self.depth = int(depth)     # gate count of the cached prefix
        self.planes = planes        # device planes; None while spilled
        # where and in what dtype the planes live (kept while spilled,
        # so a fault-in lands them back there; None for an adopted spill)
        self.dtype = None if planes is None else planes.dtype
        self.device = None if planes is None else planes.device
        self.nbytes = int(nbytes)
        self.fingerprint = fingerprint
        self.last_used = time.monotonic()
        self.hits = 0
        self.spilled = planes is None

    def key(self) -> Tuple[str, int, str]:
        return (self.digest, self.width, self.stack)


def host_planes(planes) -> np.ndarray:
    """A host copy of device planes for validation, fingerprint and
    spill: their own dtype, except bfloat16, which numpy lacks and which
    widens to float32 exactly."""
    t = planes.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def fingerprint_host(host: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(host).tobytes()).hexdigest()


def validate_host(host: np.ndarray) -> bool:
    """Finite and unit-norm — the invariant every cached ket must hold
    before ANY tenant can be seeded from it."""
    if not np.all(np.isfinite(host)):
        return False
    nrm = float(np.sum(np.asarray(host, dtype=np.float64) ** 2))
    return abs(nrm - 1.0) <= NORM_TOL


class PrefixCache:
    """Bytes-bounded COW ket cache.  Lookups (``plan``) run on submitter
    threads; materialization, seeding, insert, and eviction run on the
    executor thread — the internal lock covers the map mutations that
    cross that boundary."""

    def __init__(self, max_bytes: Optional[int] = None, store=None,
                 min_refs: Optional[int] = None,
                 min_gates: Optional[int] = None):
        self.max_bytes = (_env_int("QRACK_SERVE_PREFIX_BYTES",
                                   DEFAULT_MAX_BYTES)
                          if max_bytes is None else int(max_bytes))
        self.store = store
        # a prefix becomes "popular" (worth materializing) at this many
        # recent lookups that missed it; 1 = insert on first miss
        self.min_refs = (_env_int("QRACK_SERVE_PREFIX_MIN_REFS", 2)
                         if min_refs is None else int(min_refs))
        # prefixes shorter than this never split — seeding bookkeeping
        # would cost more than the skipped gates
        self.min_gates = (_env_int("QRACK_SERVE_PREFIX_MIN_GATES", 4)
                          if min_gates is None else int(min_gates))
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, int, str], PrefixEntry] = {}
        self._refs: Dict[Tuple[str, int, str], int] = {}
        if self.store is not None:
            self._adopt_spilled()

    # -- admission-time planning (submitter threads) -------------------

    def plan(self, circuit, width: int, stack: str = "dense"):
        """Longest-cached-prefix decision for one submitted circuit.

        Returns None (no split), ``("hit", k, entry)`` (seed from the
        cached/spilled entry and run only the suffix), or
        ``("insert", k, digest)`` (popular miss: the executor
        materializes gates[:k], inserts, and runs the suffix)."""
        L = circuit.shareable_prefix_len()
        if L < self.min_gates:
            return None
        with self._lock:
            for k in range(L, self.min_gates - 1, -1):
                key = (circuit.prefix_digest(k), width, stack)
                e = self._entries.get(key)
                if e is not None:
                    e.hits += 1
                    e.last_used = time.monotonic()
                    _tele.inc("serve.prefix.hit")
                    _tele.inc("serve.prefix.hit_depth", k)
                    return ("hit", k, e)
            _tele.inc("serve.prefix.miss")
            # popularity is counted at EVERY prefix length: two tenants
            # sharing a state-prep but differing in their tails only
            # agree on digests up to the shared boundary, and that
            # boundary is unknowable from one circuit.  The insert
            # depth is the LONGEST length whose count crosses the
            # threshold — exactly the deepest provably-shared prefix.
            best = None
            for k in range(L, self.min_gates - 1, -1):
                key = (circuit.prefix_digest(k), width, stack)
                n = self._refs.get(key, 0) + 1
                self._refs[key] = n
                if best is None and n >= self.min_refs:
                    best = (k, key[0])
            if len(self._refs) > REFS_CAP:
                # drop the oldest-inserted half of the popularity window
                for old in list(self._refs)[:REFS_CAP // 2]:
                    del self._refs[old]
            if best is not None:
                return ("insert", best[0], best[1])
        return None

    def get(self, digest: str, width: int, stack: str = "dense"
            ) -> Optional[PrefixEntry]:
        with self._lock:
            return self._entries.get((digest, width, stack))

    # -- executor-thread operations ------------------------------------

    def acquire(self, entry: PrefixEntry, device=None):
        """The entry's device planes, faulting back in from the store
        spill when necessary (onto the device they were inserted from,
        else `device`).  Returns None — and evicts the entry — when the
        spill is gone or fails verification (the caller falls back to
        materializing from the circuit).  Never raises.  The caller
        copies before any write (serve/executor.py)."""
        if entry.planes is not None:
            return entry.planes
        if self.store is None:
            self._drop(entry)
            return None
        # lazy: the checkpoint package only loads when a store is attached
        from ..checkpoint.container import (CheckpointCorrupt,
                                            CheckpointError)

        try:
            meta, arrays = self.store.load_prefix(entry.digest, entry.width,
                                                  entry.stack)
            host = arrays["planes"]
        except (CheckpointCorrupt, CheckpointError, KeyError):
            _tele.inc("serve.prefix.lost")
            self._drop(entry)
            return None
        want = entry.fingerprint or meta.get("fingerprint")
        if (not validate_host(host)
                or (want and fingerprint_host(host) != want)):
            # a spill that no longer matches what was inserted must
            # never seed a tenant — evict it on the spot
            _tele.inc("serve.prefix.corrupt")
            self.store.drop_prefix(entry.digest, entry.width, entry.stack)
            self._drop(entry)
            return None
        planes = self._to_device(host, entry, device)
        entry.planes = planes
        entry.spilled = False
        entry.last_used = time.monotonic()
        _tele.inc("serve.prefix.faultin")
        self._enforce_budget(keep=entry)
        self._gauge()
        return planes

    def insert(self, digest: str, width: int, stack: str, depth: int,
               planes) -> Optional[PrefixEntry]:
        """Validate, fingerprint, and admit freshly materialized planes
        (a copy the caller owns: nothing else may write them).  Returns
        None (and counts serve.prefix.corrupt) when the planes fail the
        finite/unit-norm invariant — a corrupted materialization is never
        admitted, so it can never be served."""
        host = host_planes(planes)
        if not validate_host(host):
            _tele.inc("serve.prefix.corrupt")
            return None
        entry = PrefixEntry(digest, width, stack, depth, planes,
                            host.nbytes, fingerprint_host(host))
        with self._lock:
            self._entries[entry.key()] = entry
            self._refs.pop(entry.key(), None)
        _tele.inc("serve.prefix.insert")
        self._enforce_budget(keep=entry)
        self._gauge()
        return entry

    # -- eviction / spill ----------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.planes is not None)

    def _enforce_budget(self, keep: Optional[PrefixEntry] = None) -> None:
        """Evict by bytes×recency until resident bytes fit the budget.
        The just-touched entry is protected — an oversized single entry
        must not evict itself before its first use."""
        if self.max_bytes <= 0:
            return
        while self.resident_bytes() > self.max_bytes:
            now = time.monotonic()
            with self._lock:
                victims = [e for e in self._entries.values()
                           if e.planes is not None and e is not keep]
                if not victims:
                    return
                victim = max(victims,
                             key=lambda e: e.nbytes * (now - e.last_used))
            self._evict(victim)

    def _evict(self, entry: PrefixEntry) -> None:
        """Spill to the store's prefix tier when one is attached, else
        drop.  The device ref is released either way; no session engine
        aliases it (each took its own copy at seed)."""
        planes = entry.planes
        if planes is None:
            return
        if self.store is not None:
            from ..checkpoint.container import CheckpointError

            host = host_planes(planes)
            try:
                self.store.save_prefix(
                    entry.digest, entry.width, entry.stack,
                    {"planes": host},
                    meta={"fingerprint": entry.fingerprint,
                          "depth": entry.depth})
                entry.planes = None
                entry.spilled = True
                _tele.inc("serve.prefix.spill")
                _tele.inc("serve.prefix.evict")
                self._gauge()
                return
            except (OSError, CheckpointError):
                pass  # spill failed: fall through to a plain drop
        self._drop(entry)
        _tele.inc("serve.prefix.evict")

    def _drop(self, entry: PrefixEntry) -> None:
        with self._lock:
            self._entries.pop(entry.key(), None)
        entry.planes = None
        self._gauge()

    def evict_all(self, spill: bool = True) -> None:
        """Release every resident entry (service close/drain).  With
        `spill` and a store attached, entries land in the prefix tier so
        a recovered service warms straight back up."""
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if e.planes is None:
                continue
            if spill and self.store is not None:
                self._evict(e)
            else:
                self._drop(e)
                _tele.inc("serve.prefix.evict")

    # -- recovery ------------------------------------------------------

    def _adopt_spilled(self) -> None:
        """Register every prefix spill already in the store as a spilled
        entry — a recovered service starts WARM: the first hit on any of
        them faults the planes back in (and verifies them) instead of
        re-materializing.  Fingerprints load lazily from spill meta at
        acquire time."""
        for digest, width, stack in self.store.prefix_entries():
            entry = PrefixEntry(digest, width, stack, 0, None, 0, "")
            with self._lock:
                self._entries.setdefault(entry.key(), entry)

    # -- helpers -------------------------------------------------------

    @staticmethod
    def _to_device(host: np.ndarray, entry: PrefixEntry, device=None):
        from ..config import get_config
        from ..utils.device import resolve_device

        dtype = entry.dtype
        if dtype is None:
            dtype = get_config().device_real_dtype()
        dev = entry.device if entry.device is not None else resolve_device(
            device)
        planes = torch.from_numpy(np.ascontiguousarray(host)).to(
            device=dev, dtype=dtype)
        entry.dtype, entry.device = planes.dtype, planes.device
        entry.nbytes = host.nbytes
        return planes

    def _gauge(self) -> None:
        _tele.gauge("serve.prefix.bytes", self.resident_bytes())

    def stats(self) -> dict:
        with self._lock:
            resident = [e for e in self._entries.values()
                        if e.planes is not None]
            return {
                "entries": len(self._entries),
                "resident": len(resident),
                "spilled": len(self._entries) - len(resident),
                "resident_bytes": sum(e.nbytes for e in resident),
                "max_bytes": self.max_bytes,
                "hits": sum(e.hits for e in self._entries.values()),
            }
