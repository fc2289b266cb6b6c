"""Processes joined into one cluster over ``torch.distributed``
(counterpart of the JAX package's parallel/cluster.py).

The JAX package brings the hosts up with ``jax.distributed`` and builds
a global mesh; XLA then moves every page over ICI or DCN inside its
``shard_map`` programs.  Here a ket's pages are a list of tensors, so
the same roles split into:

  * bring-up (:func:`init_cluster`): every process calls it, from the
    environment (``QRACK_COORDINATOR``, ``QRACK_NUM_PROCESSES``,
    ``QRACK_PROCESS_ID``) or explicit arguments, with the JAX function's
    errors.  The wire is ``nccl`` on CUDA and ``gloo`` on the CPU (or the
    ``backend`` argument, or ``QRACK_DIST_BACKEND``), fixed at bring-up.
    NCCL refuses two ranks on one card, so several processes on one card
    take gloo;
  * page homes (:func:`global_page_devices`, the counterpart of
    ``global_page_mesh``): page ``p`` lives in process ``p // per`` on a
    device of that process, contiguous blocks of ids, so the top page
    bits are the ones that cross processes;
  * the planner's prices (:func:`page_bit_kinds`,
    :func:`page_bit_weights`), read from the homes' ranks;
  * the wire: float64 sums and the byte broadcasts the pagers' reads
    and draws use.  Reads of a page list (ops/sharded.py
    ``replicated_window``, the counterpart of ``replicate_program``)
    and block moves between pages (ops/sharded.py's transport, which
    stages through pinned host buffers where gloo carries CUDA blocks)
    are built on them;
  * the agreement (:func:`agree`): a small integer all-reduce on a gloo
    group of its own, with its own bounded timeout, through which the
    resilience plane of a pager over page homes makes every rank take
    the same decision (resilience/dispatch.py, elastic.py).

Every process of a cluster must drive the same calls in the same order
with the same rng seed: each collective and each block move is matched
by position, and measurement draws consume the rng on every rank.
"""

from __future__ import annotations

import datetime
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import telemetry as _tele

#: seconds a rendezvous or a collective may wait before it raises (a
#: wedged peer fails the call instead of hanging it)
TIMEOUT_S = 300.0

#: seconds an agreement may wait for the slowest rank: at least the
#: dispatch watchdog's (a rank whose pass hangs at site entry joins the
#: agreement once its watchdog fires) and no longer than TIMEOUT_S
AGREE_TIMEOUT_S = 120.0

#: agreements run (one small all-reduce each) and the host seconds they
#: took, waiting for the slowest rank included
AGREEMENTS = {"calls": 0, "seconds": 0.0}

_INITIALIZED = False
# effective (coordinator, num_processes, process_id, local_device_ids)
# of the successful bring-up — repeat calls are checked against it
_INIT_ARGS: Optional[tuple] = None
_BACKEND: Optional[str] = None
# the CUDA ordinals of every rank's pages, gathered at bring-up
_RANK_DEVICES: Optional[List[List[int]]] = None
# the agreement's gloo group (AGREE_TIMEOUT_S), made at its first use
_AGREE_GROUP = None


class PageHome(NamedTuple):
    """Where a page lives: the rank of its process and its device there."""

    rank: int
    device: torch.device


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    """True once a process group has been brought up in this process."""
    if _INITIALIZED:
        return True
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> None:
    """Idempotent ``torch.distributed`` bring-up.

    Every argument falls back to an env var (QRACK_COORDINATOR,
    QRACK_NUM_PROCESSES, QRACK_PROCESS_ID), so launchers can export once
    and call with no arguments.  The coordinator is ``host:port`` of
    rank 0's rendezvous (``tcp://`` is added).  ``local_device_ids`` are
    this process's CUDA ordinals (its pages' cards; the first becomes
    the current device); without them a rank takes the card ``process_id
    % device_count()``, one card a rank on a host whose ranks are
    numbered in turn.  NCCL refuses two ranks on one card: ranks that
    share a card take ``backend="gloo"``.  ``backend`` (else ``QRACK_DIST_BACKEND``, else
    ``nccl`` with a GPU and ``gloo`` without) is fixed here and never
    switched afterwards.  The rendezvous and every collective raise
    after :data:`TIMEOUT_S` seconds instead of hanging.

    Repeat calls are idempotent ONLY with the same effective arguments;
    a repeat with different arguments raises RuntimeError.  A PARTIAL
    configuration (some of coordinator/num_processes/process_id set,
    others missing) raises ValueError naming exactly what is missing.
    No-op when no coordinator is configured at all (single process).
    """
    global _INITIALIZED, _INIT_ARGS, _BACKEND, _RANK_DEVICES
    coordinator_address = coordinator_address or os.environ.get("QRACK_COORDINATOR")
    if num_processes is None and "QRACK_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["QRACK_NUM_PROCESSES"])
    if process_id is None and "QRACK_PROCESS_ID" in os.environ:
        process_id = int(os.environ["QRACK_PROCESS_ID"])
    effective = (coordinator_address, num_processes, process_id,
                 tuple(local_device_ids) if local_device_ids is not None
                 else None)
    if is_initialized():
        if _INIT_ARGS is not None and (
                effective != _INIT_ARGS
                or (backend is not None and backend != _BACKEND)):
            raise RuntimeError(
                "init_cluster() called again with different arguments: "
                f"first {_INIT_ARGS}, now {effective}; torch.distributed "
                "cannot be re-initialized in a live process — restart it "
                "to change cluster topology")
        return
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        # single-process: nothing to bring up
        return
    missing = [name for name, val in (
        ("coordinator_address (or QRACK_COORDINATOR)", coordinator_address),
        ("num_processes (or QRACK_NUM_PROCESSES)", num_processes),
        ("process_id (or QRACK_PROCESS_ID)", process_id),
    ) if val is None]
    if missing:
        raise ValueError(
            "partial cluster configuration: missing "
            + ", ".join(missing)
            + " — set all three of coordinator/num_processes/process_id "
            "(or none, for single-process / TPU-pod auto-discovery)")
    backend = (backend or os.environ.get("QRACK_DIST_BACKEND")
               or ("nccl" if torch.cuda.is_available() else "gloo"))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported torch.distributed backend {backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA device")
    if local_device_ids is not None:
        ids = list(local_device_ids)
    elif torch.cuda.is_available():
        # one card a rank: ranks of a host take its cards in turn
        ids = [process_id % torch.cuda.device_count()]
    else:
        ids = [0]
    if ids and torch.cuda.is_available():
        torch.cuda.set_device(ids[0])
    dist = _dist()
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _INITIALIZED = True
    _INIT_ARGS = effective
    _BACKEND = backend
    gathered = [None] * num_processes
    dist.all_gather_object(gathered, [int(i) for i in ids])
    _RANK_DEVICES = [list(g) for g in gathered]
    if _tele._ENABLED:
        _tele.event("cluster.init", num_processes=process_count(),
                    process_id=process_index(), backend=backend)


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def backend() -> Optional[str]:
    """The wire fixed at bring-up, or None without a cluster."""
    if not is_initialized():
        return None
    return _BACKEND or _dist().get_backend()


def local_device_ids() -> Optional[List[int]]:
    """The CUDA ordinals of this process's cards, as given or chosen at
    bring-up (None without a cluster)."""
    if not is_initialized() or _RANK_DEVICES is None:
        return None
    return list(_RANK_DEVICES[process_index()])


def global_page_devices(n_pages: Optional[int] = None,
                        device=None) -> List[PageHome]:
    """Each page id's home: a :class:`PageHome` (rank, device) list over
    every process of the cluster (one process, rank 0, without one).
    Page homes are contiguous blocks of ids, ``n_pages // processes`` a
    process, so the top page bits cross processes (pages 0-3 on process
    0 and 4-7 on process 1 give kinds ``("ici", "ici", "dcn")``).  A
    process's pages cycle over its CUDA ordinals (a card may hold
    several); ``device="cpu"`` puts every page on the CPU.  The default
    page count is the power of two at or below the cluster's card
    count."""
    from ..utils.bits import log2
    from ..utils.device import resolve_device

    world = process_count()
    dev = resolve_device(device)
    if _RANK_DEVICES is not None:
        rank_ids = _RANK_DEVICES
    else:
        ids = (list(range(torch.cuda.device_count())) if dev.type == "cuda"
               else [0])
        rank_ids = [ids] * world
    if n_pages is None:
        n_pages = 1 << log2(sum(len(r) for r in rank_ids))
    if n_pages < world or n_pages % world:
        raise ValueError(
            f"n_pages={n_pages} does not split over {world} processes; "
            "give each process the same power-of-two number of pages")
    per = n_pages // world
    homes = []
    for p in range(n_pages):
        r = p // per
        if dev.type == "cpu":
            d = torch.device("cpu")
        else:
            ids = rank_ids[r]
            d = torch.device("cuda", ids[(p % per) % len(ids)])
        homes.append(PageHome(r, d))
    return homes


def dcn_weight() -> float:
    """Relative exchange cost of a process-crossing page bit against one
    inside a process (``QRACK_TPU_DCN_WEIGHT``, default 4.0 — the JAX
    package's DCN price)."""
    try:
        return float(os.environ.get("QRACK_TPU_DCN_WEIGHT", "4.0"))
    except ValueError:
        return 4.0


def _rank(d) -> int:
    """A page's process: a PageHome's rank; 0 for a plain device."""
    return d.rank if isinstance(d, PageHome) else 0


def page_bit_kinds(devices):
    """('ici'|'dcn') per page bit for a 2^g page list: page bit b is DCN
    when any page pair differing only in b spans two processes — exactly
    the pairs the pair mix and the batched exchange put on the wire for
    that bit."""
    devices = list(devices)
    n = len(devices)
    g = n.bit_length() - 1
    kinds = []
    for b in range(g):
        cross = any(_rank(devices[j]) != _rank(devices[j ^ (1 << b)])
                    for j in range(n))
        kinds.append("dcn" if cross else "ici")
    return tuple(kinds)


def page_bit_weights(devices, dcn_bits: Optional[int] = None):
    """Per-page-bit exchange weights for the remap planner
    (ops/fusion.py plan_remaps), or None when uniform (one process and
    no override).  ``dcn_bits`` / ``QRACK_TPU_DCN_BITS`` forces the top
    N page bits to DCN pricing — the single-process stand-in for a
    cluster in tests and soaks."""
    devices = list(devices)
    g = len(devices).bit_length() - 1
    if g <= 0:
        return None
    if dcn_bits is None:
        env = os.environ.get("QRACK_TPU_DCN_BITS")
        if env:
            try:
                dcn_bits = int(env)
            except ValueError:
                dcn_bits = None
    kinds = list(page_bit_kinds(devices))
    if dcn_bits:
        for b in range(max(0, g - dcn_bits), g):
            kinds[b] = "dcn"
    if "dcn" not in kinds:
        return None
    w = dcn_weight()
    return tuple(w if k == "dcn" else 1.0 for k in kinds)


# ---------------------------------------------------------------------------
# the wire: collectives on host values
# ---------------------------------------------------------------------------

def wire_device() -> torch.device:
    """Where a collective's tensors must lie: the current card under
    nccl, the host under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_f64(values) -> np.ndarray:
    """The elementwise float64 sum of `values` over every rank (each rank
    gives an array of the same length)."""
    t = torch.as_tensor(np.asarray(values, dtype=np.float64)).to(
        wire_device())
    _dist().all_reduce(t)
    return t.to("cpu").numpy()


def broadcast_bytes(arr: Optional[np.ndarray], owner: int, shape,
                    dtype) -> np.ndarray:
    """`owner`'s host array of `shape` and numpy `dtype`, on every rank:
    the owner passes it, the others None.  Sent as raw bytes, so any
    dtype crosses either wire."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if process_index() == owner:
        buf = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=dtype).reshape(-1).view(np.uint8))
    else:
        buf = torch.empty(nbytes, dtype=torch.uint8)
    wire = buf.to(wire_device())
    _dist().broadcast(wire, src=owner)
    return wire.to("cpu").numpy().view(dtype).reshape(shape).copy()


def broadcast_int(value: Optional[int], owner: int) -> int:
    """`owner`'s integer on every rank."""
    arr = None if value is None else np.asarray([value], dtype=np.int64)
    return int(broadcast_bytes(arr, owner, (1,), np.int64)[0])


def agree(values: Sequence[int], op: str = "max") -> List[int]:
    """The elementwise MAX (``op="max"``) or MIN (``"min"``) of small
    integers over every rank, on the agreement's own gloo group: the
    collective through which the ranks of a pager over page homes settle
    one decision (a dispatch's outcome, the breaker's allow, the health
    probe).  It raises after :data:`AGREE_TIMEOUT_S` seconds when a rank
    never joins (a lost process ends the cohort with an error, as every
    other collective does).  Without a cluster the values come back as
    they are."""
    import time

    global _AGREE_GROUP
    vals = [int(v) for v in values]
    if not is_initialized() or process_count() == 1:
        return vals
    dist = _dist()
    t = torch.tensor(vals if op == "max" else [-v for v in vals],
                     dtype=torch.int64)
    t0 = time.perf_counter()
    if _AGREE_GROUP is None:
        # host integers on either wire: a gloo group with its own
        # timeout, made by every rank at its first agreement (every rank
        # runs the same calls)
        _AGREE_GROUP = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=AGREE_TIMEOUT_S))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_AGREE_GROUP)
    AGREEMENTS["calls"] += 1
    AGREEMENTS["seconds"] += time.perf_counter() - t0
    out = t.tolist()
    return out if op == "max" else [-v for v in out]


def agree_all(ok: bool) -> bool:
    """True on every rank when `ok` holds on every rank."""
    return bool(agree([int(bool(ok))], op="min")[0])


def broadcast_tensor(t: Optional[torch.Tensor], owner: int, shape,
                     dtype, device) -> torch.Tensor:
    """`owner`'s tensor of `shape` and torch `dtype`, on every rank on
    `device`, bit for bit (raw bytes: any dtype, bfloat16 too)."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty(
        (), dtype=dtype).element_size()
    arr = (None if t is None else
           t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
           .numpy())
    raw = broadcast_bytes(arr, owner, (nbytes,), np.uint8)
    return torch.from_numpy(raw).view(dtype).reshape(shape).to(device)
