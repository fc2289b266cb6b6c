"""save_state / load_state: one registry over every representation (the
port of the JAX package's checkpoint/registry.py).

Each engine/layer class owns its serialization next to its state
layout — a ``_ckpt_capture(capture_child)`` method returning a
snapshot node and a ``_ckpt_restore(arrays, meta, children,
restore_child)`` method rebuilding in place — and declares its kind
tag as a ``_ckpt_kind`` class attribute.  The registry composes them
into whole-stack snapshot TREES (QUnit recurses into its Schmidt
factors, the hybrids into their live half) and flattens each tree into
one container file (container.py).  The kinds, meta keys and array
names are the JAX package's, so a file saved by either package loads
in the other; the dense engine's kind is ``"tpu"`` in both.

Restore is **restore-INTO**: layered stacks hold unserializable
factory closures (the wiring factory.py builds), so the natural
recovery path builds a fresh stack through the same factory and then
loads the snapshot into it — child engines are constructed by the
LIVE object's own factory and only their state is overwritten.
``load_state(path)`` without a target builds default-wired objects
from the snapshot's recorded constructor metadata.

Devices: capture is host-complete (every tensor comes to the host as
numpy).  ``build(snap, device=None)`` and ``load_state(path, into=None,
device=None)`` construct every object they build, children included,
on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU
and without that argument they raise.  A child that a restore-INTO must
build (its live counterpart is of another kind) lands on the device of
the live object it replaces, else of its parent.

rng stream positions (PCG64 bit-generator state, utils/rng.py) ride in
every node's meta and are restored LAST, after any child-spawning the
restore itself performed — a restored stack continues bit-identically,
measurement streams included.

The kinds ``routed`` (route/router.py) and ``lightcone``
(lightcone/engine.py) are built empty and rebuild their own stacks in
``_ckpt_restore``; a routed file's layer list names the dense terminal
``"tpu"``, as the JAX package writes it, and reads back as ``"cuda"``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .container import (CheckpointError, load_container, save_container)

STATE_KIND_PREFIX = "qrack-state:"

# the device that builds nested in a restore default to
_ctx = threading.local()


# -- rng stream position -----------------------------------------------


def rng_state(rng) -> dict:
    """JSON-able PCG64 position for a utils.rng.QrackRandom."""
    return {"seed": int(rng._seed), "state": rng._gen.bit_generator.state}


def restore_rng(rng, st: dict) -> None:
    rng.seed(int(st["seed"]))
    bg = dict(st["state"])
    inner = dict(bg.get("state", {}))
    # JSON round-trips ints losslessly (arbitrary precision), but
    # normalize key types defensively
    bg["state"] = {k: int(v) for k, v in inner.items()}
    rng._gen.bit_generator.state = bg


def _maybe_rng_meta(obj, meta: dict) -> None:
    if "rng" in meta:
        return
    rng = getattr(obj, "rng", None)
    if rng is not None and hasattr(rng, "_gen"):
        meta["rng"] = rng_state(rng)


# -- devices -------------------------------------------------------------


def _as_device(d) -> Optional[torch.device]:
    if isinstance(d, torch.device):
        return d
    if isinstance(d, str):
        try:
            return torch.device(d)
        except RuntimeError:
            return None
    return None


def device_of(obj) -> Optional[torch.device]:
    """The torch device a live object keeps its state on (None for a
    host object whose constructor names none)."""
    dev = _as_device(getattr(obj, "device", None))
    if dev is not None:
        return dev
    if not hasattr(obj, "__dict__"):
        return None
    dev = _as_device(obj.__dict__.get("_device"))
    if dev is not None:
        return dev
    for attr in ("_cuda_kwargs", "_kwargs", "_kw", "_eng_kwargs",
                 "_unit_kwargs"):
        kw = obj.__dict__.get(attr)
        if isinstance(kw, dict):
            dev = _as_device(kw.get("device"))
            if dev is not None:
                return dev
    return None


def _build_device(into=None) -> torch.device:
    """The device a nested build lands on: the live object's it replaces,
    else the enclosing restore's, else ``cuda``."""
    dev = device_of(into) if into is not None else None
    if dev is None:
        dev = getattr(_ctx, "device", None)
    return resolve_device(dev)


class _on_device:
    """Nested builds inside this block default to `device`."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        self.prev = getattr(_ctx, "device", None)
        if self.device is not None:
            _ctx.device = self.device

    def __exit__(self, *exc):
        _ctx.device = self.prev


# -- capture / restore -------------------------------------------------


def kind_of(obj) -> Optional[str]:
    """The object's snapshot kind tag (forwarded through proxies)."""
    return getattr(obj, "_ckpt_kind", None)


def capture(obj) -> dict:
    """Snapshot `obj` (and its children, recursively) into a tree of
    ``{"kind", "meta", "arrays", "children"}`` nodes.  Host-complete:
    every device tensor is read back as numpy before return."""
    cap = getattr(obj, "_ckpt_capture", None)
    if cap is None:
        raise CheckpointError(
            f"{type(obj).__name__} does not support checkpointing")
    snap = cap(capture)
    snap.setdefault("meta", {})
    snap.setdefault("arrays", {})
    snap.setdefault("children", {})
    _maybe_rng_meta(obj, snap["meta"])
    # base interface flags every stack level shares
    for attr in ("do_normalize", "rand_global_phase"):
        if attr not in snap["meta"] and hasattr(obj, attr):
            snap["meta"][attr] = bool(getattr(obj, attr))
    return snap


def restore_into(obj, snap: dict):
    """Load snapshot tree `snap` into live object `obj` in place (the
    stack keeps its own factories/wiring; only state is overwritten).
    Returns `obj`."""
    if type(obj).__name__ == "ResilientEngine":
        inner = obj.engine
        if kind_of(inner) != snap["kind"]:
            object.__setattr__(obj, "_engine",
                               build(snap, device=_build_device(inner)))
        else:
            restore_into(inner, snap)
        return obj
    if kind_of(obj) != snap["kind"]:
        raise CheckpointError(
            f"snapshot kind {snap['kind']!r} does not match live "
            f"{type(obj).__name__} (kind {kind_of(obj)!r})")
    meta = snap.get("meta", {})
    with _on_device(device_of(obj)):
        obj._ckpt_restore(snap.get("arrays", {}), meta,
                          snap.get("children", {}), restore_child)
    for attr in ("do_normalize", "rand_global_phase"):
        if attr in meta and hasattr(obj, attr):
            setattr(obj, attr, bool(meta[attr]))
    # LAST: pin the rng stream position (restore above may have spawned
    # children off this stream; the snapshot position wins)
    rng = getattr(obj, "rng", None)
    if "rng" in meta and rng is not None and hasattr(rng, "_gen"):
        restore_rng(rng, meta["rng"])
    return obj


def restore_child(snap: dict, into=None):
    """Helper handed to _ckpt_restore implementations: restore a child
    snapshot into `into` when it exists and matches, else build a
    standalone object from the snapshot on `into`'s device (or the
    enclosing restore's)."""
    if into is not None and kind_of(into) == snap["kind"]:
        return restore_into(into, snap)
    return build(snap, device=_build_device(into))


def _construct(kind: str, meta: dict, dev: torch.device):
    n = int(meta["n"])
    if kind == "cpu":
        from ..engines.cpu import QEngineCPU

        return QEngineCPU(n, dtype=np.dtype(meta.get("dtype", "complex128")))
    if kind == "tpu":
        from ..engines.cuda import QEngineCUDA

        return QEngineCUDA(n, dtype=meta.get("dtype"), device=dev)
    if kind == "sparse":
        from ..engines.sparse import QEngineSparse

        return QEngineSparse(n)
    if kind == "pager":
        from ..parallel.pager import QPager

        # honor the recorded page layout: MAll's per-page draw pattern
        # depends on n_pages, and bit-identical continuation needs the
        # same pattern (restore-INTO an existing pager may still remap);
        # on one card the device repeats once a page
        n_pages = int(meta.get("n_pages") or 1)
        return QPager(n, n_pages=n_pages, devices=[dev] * n_pages,
                      dtype=meta.get("dtype"))
    if kind in ("turboquant", "turboquant_pager"):
        # the recorded chunk (and page count) too: they decide which
        # tiles later gates requantize
        tq_kw = {"bits": int(meta["bits"]),
                 "block_pow": int(meta["block_pow"]),
                 "seed_rot": int(meta["seed"]), "device": dev}
        if meta.get("chunk_pow") is not None:
            tq_kw["chunk_qb"] = int(meta["chunk_pow"])
        if kind == "turboquant":
            from ..engines.turboquant import QEngineCUDATurboQuant

            return QEngineCUDATurboQuant(n, **tq_kw)
        from ..parallel.turboquant_pager import QPagerTurboQuant

        n_pages = int(meta.get("n_pages") or 1)
        return QPagerTurboQuant(n, n_pages=n_pages, **tq_kw)
    if kind == "stabilizer":
        from ..layers.stabilizer import QStabilizer

        return QStabilizer(n)
    if kind == "unit":
        from ..layers.qunit import QUnit

        return QUnit(n, device=dev)
    if kind == "unit_multi":
        from ..layers.qunitmulti import QUnitMulti

        return QUnitMulti(n, device=dev)
    if kind == "unit_clifford":
        from ..layers.qunitclifford import QUnitClifford

        return QUnitClifford(n)
    if kind == "stabilizer_hybrid":
        from ..layers.stabilizerhybrid import QStabilizerHybrid

        return QStabilizerHybrid(n, device=dev)
    if kind == "bdt":
        from ..layers.qbdt import QBdt

        return QBdt(n, attached_qubits=int(meta.get("attached_qubits", 0)),
                    device=dev)
    if kind == "bdt_hybrid":
        from ..layers.qbdthybrid import QBdtHybrid

        return QBdtHybrid(
            n, attached_qubits=int(meta.get("attached_qubits", 0)),
            device=dev)
    if kind == "hybrid":
        from ..engines.hybrid import QHybrid

        return QHybrid(n, tpu_threshold_qubits=int(meta["tpu_threshold"]),
                       pager_threshold_qubits=int(meta["pager_threshold"]),
                       device=dev)
    if kind == "routed":
        from ..route.router import QRouted

        # the wrapper's _ckpt_restore rebuilds the recorded stack from
        # the snapshot's layer list; a fresh QRouted carries no engine
        return QRouted(n, device=dev)
    if kind == "lightcone":
        from ..lightcone.engine import QLightCone

        # _ckpt_restore rebuilds the buffered circuit from the gate
        # arrays and the cone and base stacks from the children
        return QLightCone(n, device=dev)
    raise CheckpointError(f"unknown snapshot kind {kind!r}")


def build(snap: dict, device=None):
    """Construct a default-wired object for `snap` from its recorded
    constructor metadata on `device` (``cuda`` unless the caller passes
    ``device="cpu"``; children land there too), then restore the
    snapshot into it."""
    dev = resolve_device(device)
    with _on_device(dev):
        obj = _construct(snap["kind"], snap.get("meta", {}), dev)
        return restore_into(obj, snap)


# -- tree <-> flat container -------------------------------------------


def _flatten(snap: dict, prefix: str, out: Dict[str, np.ndarray]) -> dict:
    node = {"kind": snap["kind"], "meta": snap.get("meta", {}),
            "arrays": {}, "children": {}}
    for name, arr in snap.get("arrays", {}).items():
        key = f"{prefix}{name}"
        out[key] = arr
        node["arrays"][name] = key
    for name, child in snap.get("children", {}).items():
        node["children"][name] = _flatten(child, f"{prefix}{name}/", out)
    return node


def _unflatten(node: dict, arrays: Dict[str, np.ndarray]) -> dict:
    return {
        "kind": node["kind"], "meta": node.get("meta", {}),
        "arrays": {name: arrays[key]
                   for name, key in node.get("arrays", {}).items()},
        "children": {name: _unflatten(child, arrays)
                     for name, child in node.get("children", {}).items()},
    }


# -- public file API ---------------------------------------------------


def save_snapshot(snap: dict, path: str,
                  extra_meta: Optional[dict] = None) -> int:
    """Write a captured snapshot tree into one container file; returns
    bytes written."""
    flat: Dict[str, np.ndarray] = {}
    tree = _flatten(snap, "", flat)
    meta = {"tree": tree}
    if extra_meta:
        meta.update(extra_meta)
    return save_container(path, flat, meta=meta,
                          kind=STATE_KIND_PREFIX + snap["kind"])


def save_state(obj, path: str, extra_meta: Optional[dict] = None) -> int:
    """Snapshot `obj` (any supported engine/layer stack, resilience
    proxy included) into one container file; returns bytes written.
    `extra_meta` rides in the container manifest itself, so bookkeeping
    like the store's ``wal_high`` commits in the SAME atomic replace as
    the state it describes (no torn crash window between them)."""
    return save_snapshot(capture(obj), path, extra_meta)


def load_snapshot(path: str) -> dict:
    """Read a state container back into a snapshot tree (no objects
    constructed yet)."""
    kind, meta, arrays = load_container(path)
    if not (kind or "").startswith(STATE_KIND_PREFIX):
        raise CheckpointError(f"{path}: not a state checkpoint ({kind!r})")
    return _unflatten(meta["tree"], arrays)


def load_state(path: str, into=None, device=None):
    """Restore a saved stack: into a live object when given (the spill/
    recovery path — state loads into the session's own factory-built
    stack), else build default-wired objects from the snapshot on
    `device` (``cuda`` unless ``device="cpu"``)."""
    if into is None:
        resolve_device(device)  # raise before reading the file
    snap = load_snapshot(path)
    if into is not None:
        return restore_into(into, snap)
    return build(snap, device=device)
