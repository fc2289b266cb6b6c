"""Page algebra of the pager (counterpart of the JAX package's
ops/sharded.py).

The JAX package runs these bodies inside a ``shard_map`` over a mesh
axis ``pages``, one page a device, with ``ppermute`` for every move
between pages.  Here a ket of ``G = 2^g`` pages is a Python list of
``(2, 2^L)`` plane tensors, ``pages[p]`` the page whose id is ``p``
(its amplitudes are ``[p * 2^L, (p + 1) * 2^L)``), each on a device of
its own or several on one.  Every function takes that list and reads a
page's id from its position: there is no traced ``page_id()``.  Masks
arrive split into (local, page) halves, so no index past the page is
ever built and every local index fits int32 (L <= 30).

Memory: at L = 30 a float32 page is 8 GiB, so nothing here builds a
page-sized temporary.  The gate bodies, the exchanges and the collapse
run in place on the page tensors, a block of at most :data:`CHUNK`
amplitudes at a time (the JAX package's bound is half a page of extra
memory, ``apply_global_2x2``).  Pages that sit on one device exchange by
relabeling the list or by an in-place swap of their halves; pages on
different devices copy the block that moves (reference MetaSwap,
src/qpager.cpp:1314-1350: a page-pointer permutation).

``compose_ring`` and ``gather_ring`` build new pages (the result of a
Compose or a basis permutation cannot overwrite its input), one block of
a page at a time.

Pages in several processes (parallel/cluster.py): a list may hold
:class:`RemotePage` placeholders for the pages other ranks own, at the
same ids on every rank.  Every pass acts on this rank's pages only, and
every move of a block between pages of two processes goes through one
transport, :func:`transport` (``batch_isend_irecv``; with gloo and CUDA
pages through pinned host buffers, counted in ``EXCHANGES``).  A pair
mix across ranks swaps the blocks and each rank writes the half it
owns with :func:`_mix_`'s formula, so the arithmetic is the one-process
pager's.  Reductions sum this rank's pages block by block and all-reduce
the partial sums in float64, then add them up in the one-process order,
so every rank reads the one-process value.  Every rank must run the same
passes in the same order: the moves and collectives match by position.
A pager over the cluster's page homes keeps its pages in a
:class:`PageList`, so a rank that holds every page after a re-page onto
a prefix of the slots, or none, still joins every collective.

Re-paging and whole-ket reads across processes: :func:`repage` builds
the pages of a new page count (or of new slots) from the old ones, a
block at a time, through the transport where a new page's old pages
live in another process; :func:`all_gather_pages` puts the whole ket on
every rank (the dense replica of the failover chain, the out-of-place
ALU scatter, the TurboQuant pager's dense plane).  Both are counted in
``EXCHANGES`` (``repage``, ``gather``) and ``TRANSPORT_S``.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from .. import telemetry as _tele
from ..telemetry import roofline as _roofline
from . import gatekernels as gk

#: amplitudes a block of the in-place page passes touches at a time
CHUNK = 1 << 26

#: exchanges run, by kind, and the bytes they must read and write on the
#: card: each element a pass mixes or moves read once and written once
#: (a relabeling of pages on one device moves none); ``wire_bytes`` the
#: bytes this rank sent to other processes, ``staged_bytes`` the bytes
#: its transport copied through host buffers (both ways).  A host-side
#: count.
EXCHANGES = {"global_2x2": 0, "mixed_swap": 0, "batched_swap": 0,
             "local_swap": 0, "page_relabel": 0, "repage": 0, "gather": 0,
             "bytes": 0, "wire_bytes": 0, "staged_bytes": 0}


#: host-clock seconds of the transport: ``staging`` the copies into and
#: out of its wire buffers (the card synchronized first, so no earlier
#: work is counted), ``wire`` from posting the sends and receives until
#: every one has completed (under nccl until the card has finished them)
TRANSPORT_S = {"staging": 0.0, "wire": 0.0}


def reset_exchanges() -> None:
    for k in EXCHANGES:
        EXCHANGES[k] = 0
    for k in TRANSPORT_S:
        TRANSPORT_S[k] = 0.0


def _exchanged(kind: str, nbytes: int) -> None:
    """Count one exchange pass of `kind` and the bytes it read and
    wrote: in EXCHANGES and, with telemetry on, as
    ``exchange.pager.<kind>``, ``exchange.pager.bytes`` and the
    roofline's ``pager.exchange`` bytes (the JAX pager's names; its
    kinds are the collectives it dispatches, these the in-place passes
    that run here)."""
    EXCHANGES[kind] += 1
    EXCHANGES["bytes"] += nbytes
    if _tele._ENABLED:
        _tele.inc(f"exchange.pager.{kind}")
        _tele.inc("exchange.pager.bytes", nbytes)
        _roofline.note_bytes("pager.exchange", nbytes)


def _page_bytes(page) -> int:
    return math.prod(page.shape) * page.dtype.itemsize


# ---------------------------------------------------------------------------
# pages of other processes and the transport between them
# ---------------------------------------------------------------------------

class RemotePage:
    """A page that another process owns: its home rank, shape and dtype.
    Any tensor use raises, so no pass can read or write it by mistake."""

    __slots__ = ("rank", "shape", "dtype")

    def __init__(self, rank: int, shape, dtype):
        self.rank = int(rank)
        self.shape = tuple(shape)
        self.dtype = dtype

    def _refuse(self, what):
        raise RuntimeError(
            f"{what} of a page that lives in process {self.rank}: its "
            "blocks move only through sharded.transport")

    def __getattr__(self, name):
        self._refuse(f"attribute {name!r}")

    def __getitem__(self, key):
        self._refuse("a read")

    def __setitem__(self, key, value):
        self._refuse("a write")

    def __repr__(self) -> str:
        return f"RemotePage(rank={self.rank}, shape={self.shape}, dtype={self.dtype})"


def is_remote(page) -> bool:
    return isinstance(page, RemotePage)


class PageList(list):
    """The page list of a pager over the cluster's page homes: one ket
    of the whole cluster, whose reductions, reads and gathers are
    collectives on every rank, also where this rank holds every page or
    none (after a re-page onto a prefix of the slots)."""


def spread(pages) -> bool:
    """True when the list is one ket over several processes: a
    PageList, or a list with a page of another process."""
    return isinstance(pages, PageList) or any(
        isinstance(p, RemotePage) for p in pages)


def local_pages(pages):
    """(page id, page) of the pages this process owns."""
    return [(p, page) for p, page in enumerate(pages)
            if not isinstance(page, RemotePage)]


def _me() -> int:
    from ..parallel import cluster

    return cluster.process_index()


def transport(sends=(), recvs=()) -> None:
    """The one move of blocks between processes: each (block, rank) of
    `sends` goes to that rank, and each (out block, rank) of `recvs` is
    filled from it, in one ``batch_isend_irecv`` whose requests all
    complete before it returns.  Two ranks list their moves to each
    other in the same order.  A block may be sent and received at once
    (an exchange): what is sent is taken before anything lands.  Under
    gloo a CUDA block is staged through a pinned host buffer both ways,
    under nccl it moves on the card; bytes counted in ``EXCHANGES``,
    seconds in ``TRANSPORT_S``."""
    from ..parallel import cluster

    dist = cluster._dist()
    wire = cluster.wire_device()
    for dev in {b.device for b, _r in (*sends, *recvs)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ops, landed = [], []
    for blk, rank in sends:
        buf = _wire_buffer(blk.shape, blk.dtype, wire, blk.device)
        buf.copy_(blk)
        if buf.is_pinned():
            EXCHANGES["staged_bytes"] += _page_bytes(blk)
        EXCHANGES["wire_bytes"] += _page_bytes(blk)
        ops.append(dist.P2POp(dist.isend, _bytes(buf), rank))
    for out, rank in recvs:
        buf = _wire_buffer(out.shape, out.dtype, wire, out.device)
        ops.append(dist.P2POp(dist.irecv, _bytes(buf), rank))
        landed.append((out, buf))
    if not ops:
        return
    t1 = time.perf_counter()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if wire.type == "cuda":
        torch.cuda.synchronize(wire)
    t2 = time.perf_counter()
    for out, buf in landed:
        if buf.is_pinned():
            EXCHANGES["staged_bytes"] += _page_bytes(out)
        out.copy_(buf)
    TRANSPORT_S["staging"] += (t1 - t0) + (time.perf_counter() - t2)
    TRANSPORT_S["wire"] += t2 - t1


def _bytes(buf):
    """A contiguous buffer as raw bytes: any dtype crosses either wire
    (nccl has no int16)."""
    return buf.reshape(-1).view(torch.uint8)


def _wire_buffer(shape, dtype, wire, home):
    """A contiguous buffer the wire carries: on the wire's device, pinned
    when it stages a CUDA block on the host."""
    pin = wire.type == "cpu" and home.type == "cuda"
    return torch.empty(shape, dtype=dtype, device=wire, pin_memory=pin)


def _exchange_(blk, rank: int) -> None:
    """blk <- the peer's block of the same shape; the peer's <- blk."""
    transport([(blk, rank)], [(blk, rank)])


def _reduce_partials(pages, partials) -> float:
    """The one-process sum of per-page block partial sums: `partials[p]`
    is page p's list of block sums (zeros for another rank's page, which
    it fills); across ranks an all-reduce in float64 first."""
    sums = sum_ranks(pages, np.asarray(partials, dtype=np.float64))
    total = 0.0
    for x in sums.reshape(-1):
        total += float(x)
    return total


def _n_blocks(size: int) -> int:
    return sum(1 for _ in _blocks((size,)))


def split_masks(mask: int, val: int, local_bits: int):
    """(local mask, local value, high mask, high value) of a control
    mask split at ``local_bits``: the low part is tested against an
    index inside a tile, chunk or page, the high part against its id."""
    lmask = mask & ((1 << local_bits) - 1)
    lval = val & ((1 << local_bits) - 1)
    return lmask, lval, mask >> local_bits, val >> local_bits


# ---------------------------------------------------------------------------
# blocks and in-place primitives
# ---------------------------------------------------------------------------

def _blocks(dims: Sequence[int], chunk: int = None):
    """Index tuples (an int or a slice per dim) that tile an array of
    shape ``dims`` (powers of two) in blocks of at most ``chunk``
    elements, the trailing dims whole."""
    chunk = CHUNK if chunk is None else chunk
    inner, j = 1, len(dims)
    while j > 0 and inner * dims[j - 1] <= chunk:
        j -= 1
        inner *= dims[j]
    whole = tuple(slice(None) for _ in dims[j:])
    if j == 0:
        yield whole
        return
    step = max(1, chunk // inner)
    for lead in itertools.product(*(range(d) for d in dims[:j - 1])):
        for s in range(0, dims[j - 1], step):
            yield lead + (slice(s, s + step),) + whole


def _block_index(dims: Sequence[int], strides: Sequence[int], blk, device):
    """The in-page index of every element of block ``blk`` of a view of
    shape ``dims`` whose dim i steps the page index by ``strides[i]``."""
    offset, parts = 0, []
    for d, st, b in zip(dims, strides, blk):
        if isinstance(b, int):      # the view drops this dim
            offset += b * st
        else:
            parts.append(torch.arange(*b.indices(d), dtype=gk.IDX_DTYPE,
                                      device=device) * st)
    idx = None
    for k, part in enumerate(parts):
        shape = [1] * len(parts)
        shape[k] = -1
        part = part.view(shape)
        idx = part if idx is None else idx + part
    return idx + offset


def _swap_(x, y) -> None:
    """Exchange two plane views in place (they may lie on two devices)."""
    tmp = x.clone()
    x.copy_(y)
    y.copy_(tmp)


def _mix_(a, b, m, sel_a=None, sel_b=None, write_a=True,
          write_b=True) -> None:
    """In place on plane views a, b (2, ...): a <- m00 a + m01 b and
    b <- m10 a + m11 b, complex, in the planes' compute type.  Where a
    select is given, only its true elements take the new value."""
    ct = gk.compute_dtype(a.dtype)
    ar, ai = a[0].to(ct), a[1].to(ct)
    br, bi = b[0].to(ct), b[1].to(ct)
    outs = []
    for row, write, sel, keep_r, keep_i in ((0, write_a, sel_a, ar, ai),
                                            (1, write_b, sel_b, br, bi)):
        if not write:
            continue
        m0, m1 = complex(m[row, 0]), complex(m[row, 1])
        re = ar * m0.real
        re.add_(ai, alpha=-m0.imag).add_(br, alpha=m1.real)
        re.add_(bi, alpha=-m1.imag)
        im = ai * m0.real
        im.add_(ar, alpha=m0.imag).add_(bi, alpha=m1.real)
        im.add_(br, alpha=m1.imag)
        if sel is not None:
            re = torch.where(sel, re, keep_r)
            im = torch.where(sel, im, keep_i)
        outs.append((a if row == 0 else b, re, im))
    for dst, re, im in outs:
        dst[0].copy_(re)
        dst[1].copy_(im)


def _cmul_(v, fre, fim) -> None:
    """v (2, ...) *= fre + i fim in place; scalars or tensors."""
    ct = gk.compute_dtype(v.dtype)
    vr, vi = v[0].to(ct), v[1].to(ct)
    nr = vr * fre - vi * fim
    ni = vr * fim + vi * fre
    v[0].copy_(nr)
    v[1].copy_(ni)


def page_devices(pages, device=None) -> List[torch.device]:
    """The page list of a whole-circuit program over pages: a page count
    (each page on `device`, ``cuda`` unless it says otherwise) or a
    device list, which may name a device more than once, or the
    cluster's page homes (``cluster.global_page_devices``; the JAX
    package's programs take a Mesh)."""
    from ..parallel.cluster import PageHome
    from ..utils.device import resolve_device

    if isinstance(pages, int):
        devs = [resolve_device(device)] * pages
    else:
        devs = [d if isinstance(d, PageHome) else resolve_device(d)
                for d in pages]
    n = len(devs)
    if n < 1 or n & (n - 1):
        raise ValueError("page count must be a power of two")
    return devs


def local_device(devs) -> torch.device:
    """This process's first device of a page_devices list."""
    from ..parallel.cluster import PageHome

    me = _me()
    for d in devs:
        if not isinstance(d, PageHome):
            return d
        if d.rank == me:
            return d.device
    raise ValueError("no page of the list lives in this process")


def new_pages(devs, L: int, dtype, fill=None) -> List:
    """Pages of 2^L amplitudes on a page_devices list: for each page of
    this process ``fill(page id, device)`` (zeros by default), a
    RemotePage for the others."""
    from ..parallel.cluster import PageHome

    me = _me()
    out = []
    for p, d in enumerate(devs):
        if isinstance(d, PageHome) and d.rank != me:
            out.append(RemotePage(d.rank, (2, 1 << L), dtype))
            continue
        dev = d.device if isinstance(d, PageHome) else d
        out.append(torch.zeros((2, 1 << L), dtype=dtype, device=dev)
                   if fill is None else fill(p, dev))
    return out


def replicated_window(pages, L: int, offset: int, length: int,
                      shared: bool = False) -> np.ndarray:
    """(2, length) float64 host planes of the ket window [offset, offset
    + length) of a page list: each page's part is read where it lives,
    and with ``shared`` (the list is one ket of the whole cluster, a
    cluster of one too) broadcast by the rank that owns it, so every
    rank returns the same window (the counterpart of
    ``replicate_program``, the only read that is legal when no process
    holds every page)."""
    from ..parallel import cluster

    out = np.empty((2, length), dtype=np.float64)
    pos = offset
    while pos < offset + length:
        p, i = pos >> L, pos & ((1 << L) - 1)
        take = min((1 << L) - i, offset + length - pos)
        page = pages[p]
        part = (None if is_remote(page)
                else page[:, i:i + take].to("cpu", torch.float64).numpy())
        if shared:
            part = cluster.broadcast_bytes(
                part, page.rank if is_remote(page) else _me(), (2, take),
                np.float64)
        out[:, pos - offset:pos - offset + take] = part
        pos += take
    return out


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def _matrix(mp, dtype):
    """(2, 2) complex of (2, 2, 2) matrix planes, each entry rounded to
    the planes' dtype (the JAX package's payloads are in that dtype)."""
    h = gk.host_tensor(gk._host_planes(mp), dtype).to(torch.float64).numpy()
    return h[0] + 1j * h[1]


def _local_pair_(page, L: int, target: int, m, lmask: int, lval: int):
    """2x2 on an in-page target, in place, block by block."""
    low, high = 1 << target, 1 << (L - 1 - target)
    v = page.view(2, high, 2, low)
    for blk in _blocks((high, low)):
        a = v[(slice(None), blk[0], 0, blk[1])]
        b = v[(slice(None), blk[0], 1, blk[1])]
        sel = None
        if lmask:
            idx = _block_index((high, low), (2 * low, 1), blk, page.device)
            sel = (idx & lmask) == lval
        _mix_(a, b, m, sel, sel)


def apply_local_2x2(pages: List, mp, L: int, target: int, lmask, lval,
                    gmask, gval) -> List:
    """Non-diagonal gate on an in-page target, on the pages the page
    mask selects (``ops/sharded.py:30``)."""
    if not pages:
        return pages
    m = _matrix(mp, pages[0].dtype)
    for p, page in local_pages(pages):
        if (p & gmask) == gval:
            _local_pair_(page, L, target, m, int(lmask), int(lval))
    return pages


def apply_local_kxk(pages: List, mp, L: int, start: int, k: int) -> List:
    """A gate on the k contiguous in-page qubits [start, start + k) of
    every page, in place, block by block (gatekernels.apply_kxk's
    contraction on each block); `mp` is (2, 2^k, 2^k) matrix planes."""
    K, low, high = 1 << k, 1 << start, 1 << (L - start - k)
    for _p, page in local_pages(pages):
        mix = gk._mix(gk._dev_planes(mp, page))
        v = page.view(2, high, K, low)
        for blk in _blocks((high, low), max(1, CHUNK // K)):
            h, l = (slice(b, b + 1) if isinstance(b, int) else b for b in blk)
            idx = (slice(None), h, slice(None), l)
            x = v[idx]
            v[idx] = torch.einsum("PApa,phal->PhAl", mix, x)
    return pages


def scale_page_(page, fre: float, fim: float) -> None:
    """A whole page times fre + i fim, in place, block by block."""
    for blk in _blocks((page.shape[-1],)):
        _cmul_(page[:, blk[0]], fre, fim)


def apply_global_2x2(pages: List, mp, gpos: int, lmask, lval, gmask,
                     gval) -> List:
    """Non-diagonal gate on a page bit (``ops/sharded.py:37``): each page
    pair (p0, p1 = p0 | 2^gpos) mixes block by block, in place.  Page
    p0's amplitudes are the |0> halves of the pairs, p1's the |1>
    halves; a block of p1 travels to p0's device and back when the two
    lie apart.  A 1-amplitude page is one block like any other.  Across
    processes each rank sends its block where the other side writes and
    writes its own page only (the JAX package's ppermute of halves)."""
    if not pages:
        return pages
    m = _matrix(mp, pages[0].dtype)
    bit = 1 << gpos
    lmask, lval = int(lmask), int(lval)
    moved = 0
    for p0 in range(len(pages)):
        if p0 & bit:
            continue
        p1 = p0 | bit
        ok0, ok1 = (p0 & gmask) == gval, (p1 & gmask) == gval
        if not (ok0 or ok1):
            continue
        A, B = pages[p0], pages[p1]
        if is_remote(A) or is_remote(B):
            moved += _cross_2x2(A, B, m, lmask, lval, ok0, ok1)
            continue
        moved += (2 + ok0 + ok1) * _page_bytes(pages[p0])
        size = A.shape[-1]
        for blk in _blocks((size,)):
            a = A[:, blk[0]]
            b = B[:, blk[0]]
            apart = b.device != a.device
            if apart:
                b_home, b = b, b.to(a.device)
            sel = None
            if lmask:
                idx = _block_index((size,), (1,), blk, A.device)
                sel = (idx & lmask) == lval
            _mix_(a, b, m, sel, sel, write_a=ok0, write_b=ok1)
            if apart and ok1:
                b_home.copy_(b)
    _exchanged("global_2x2", moved)
    return pages


def _cross_2x2(A, B, m, lmask: int, lval: int, ok0: bool, ok1: bool) -> int:
    """The pair mix of pages A (page bit clear) and B when one of them
    lives in another process (neither, on a rank that owns neither):
    block by block, the owner of A gets B's block where it writes A and
    sends A's where the other side writes B; each rank writes its own
    page with the one-process formula.  Returns the bytes this rank's
    page was read and written."""
    if is_remote(A) and is_remote(B):
        return 0
    mine_a = not is_remote(A)
    page, peer = (A, B.rank) if mine_a else (B, A.rank)
    write = ok0 if mine_a else ok1
    give = ok1 if mine_a else ok0
    size = page.shape[-1]
    for blk in _blocks((size,)):
        own = page[:, blk[0]]
        other = torch.empty_like(own) if write else None
        transport([(own, peer)] if give else (),
                  [(other, peer)] if write else ())
        if not write:
            continue
        sel = None
        if lmask:
            idx = _block_index((size,), (1,), blk, page.device)
            sel = (idx & lmask) == lval
        a, b = (own, other) if mine_a else (other, own)
        _mix_(a, b, m, sel, sel, write_a=mine_a, write_b=not mine_a)
    return (1 + write) * _page_bytes(page)


def apply_diag(pages: List, d0re, d0im, d1re, d1im, tlo, thi, clo, cvlo,
               chi, cvhi) -> List:
    """Diagonal gate with split target and control masks, in place
    (``ops/sharded.py:91``): no page moves."""
    tlo, clo, cvlo = int(tlo), int(clo), int(cvlo)
    for p, page in local_pages(pages):
        if (p & chi) != cvhi:
            continue
        hbit = (p & thi) != 0
        if not tlo and not clo:   # one factor for the whole page
            fre, fim = (d1re, d1im) if hbit else (d0re, d0im)
            if fre == 1.0 and fim == 0.0:
                continue
            for blk in _blocks((page.shape[-1],)):
                _cmul_(page[:, blk[0]], float(fre), float(fim))
            continue
        ct = gk.compute_dtype(page.dtype)
        d0r, d0i, d1r, d1i, one, zero = (
            torch.tensor(float(x), dtype=ct, device=page.device)
            for x in (d0re, d0im, d1re, d1im, 1.0, 0.0))
        size = page.shape[-1]
        for blk in _blocks((size,)):
            idx = _block_index((size,), (1,), blk, page.device)
            if hbit:
                fre, fim = d1r, d1i
            else:
                bit = (idx & tlo) != 0
                fre = torch.where(bit, d1r, d0r)
                fim = torch.where(bit, d1i, d0i)
            if clo:
                ok = (idx & clo) == cvlo
                fre = torch.where(ok, fre, one)
                fim = torch.where(ok, fim, zero)
            _cmul_(page[:, blk[0]], fre, fim)
    return pages


def apply_factor(pages: List, L: int, fn, index_dtype=gk.IDX_DTYPE) -> List:
    """Multiply every amplitude by the complex factor ``fn(idx)`` of its
    global basis index, in place, block by block (the pager's phase
    functions, <= 31 qubits: the global index as ``index_dtype``)."""
    for p, page in local_pages(pages):
        size = page.shape[-1]
        for blk in _blocks((size,)):
            s, e, _ = blk[0].indices(size)
            idx = torch.arange(s, e, dtype=index_dtype, device=page.device)
            idx = idx + (p << L)
            fre, fim = fn(page, idx)
            _cmul_(page[:, blk[0]], fre, fim)
    return pages


def device_targs(targs, device, cache: dict):
    """A split body's operands on `device`: host tables (numpy arrays)
    become int32 tensors there, once per device (kept in `cache`);
    scalars and digit lists pass as they are."""
    if device not in cache:
        cache[device] = tuple(torch.as_tensor(t).to(device, gk.IDX_DTYPE)
                              if isinstance(t, np.ndarray) else t
                              for t in targs)
    return cache[device]


def apply_split_factor(pages: List, L: int, body, targs) -> List:
    """Multiply every amplitude by the complex factor that the split
    body ``body(xp, pid, lidx, L, *targs) -> (re, im)`` gives for its
    (page id, in-page index), in place, block by block: exact at any
    width (``_phase_fn_wide`` of the JAX pager; the page id is a Python
    int)."""
    cache = {}
    for p, page in local_pages(pages):
        args = device_targs(targs, page.device, cache)
        xp = gk.plane_where(page)
        size = page.shape[-1]
        for blk in _blocks((size,)):
            lidx = _block_index((size,), (1,), blk, page.device)
            fre, fim = body(xp, p, lidx, L, *args)
            if (not isinstance(fre, torch.Tensor)
                    and not isinstance(fim, torch.Tensor)
                    and (fre, fim) == (1.0, 0.0)):
                continue   # a block whose factor is 1 stays as it is
            _cmul_(page[:, blk[0]], fre, fim)
    return pages


def prob_parity(pages: List, L: int, mask: int) -> float:
    """Probability of odd parity of (index & mask), page by page and
    block by block on the pages' devices, from split indices; each block
    sums in the planes' dtype, the blocks and pages in float64 on the
    host."""
    lmask, gmask = mask & ((1 << L) - 1), mask >> L
    size = pages[0].shape[-1]
    partials = [[0.0] * _n_blocks(size) for _ in pages]
    for p, page in local_pages(pages):
        for b, blk in enumerate(_blocks((size,))):
            v = page[:, blk[0]]
            pr = v[0] ** 2 + v[1] ** 2
            if lmask:
                idx = _block_index((size,), (1,), blk, page.device)
                w = idx & lmask
                for sh in (16, 8, 4, 2, 1):
                    w = w ^ (w >> sh)
                odd = (w & 1) ^ (bin(p & gmask).count("1") & 1)
                pr = torch.where(odd == 1, pr, 0.0)
            elif not bin(p & gmask).count("1") & 1:
                continue
            partials[p][b] = float(pr.sum())
    return _reduce_partials(pages, partials)


def prob_bits_all(pages: List, L: int, bits) -> np.ndarray:
    """The distribution over the values of `bits` (bit j of a value is
    ket bit bits[j]), page by page and block by block on the pages'
    devices: a float64 histogram of 2^len(bits) entries, each block's
    probabilities binned on its device into its page's histogram; the
    page histograms add up in page order (across processes after a
    float64 all-reduce)."""
    hist = np.zeros((len(pages), 1 << len(bits)), dtype=np.float64)
    for p, page in local_pages(pages):
        _bin_page_(hist[p], p, page, L, bits)
    out = np.zeros(hist.shape[1], dtype=np.float64)
    for h in sum_ranks(pages, hist):
        out += h
    return out


def _bin_page_(out, p: int, page, L: int, bits) -> None:
    """Add page p's probabilities into the histogram `out` of
    prob_bits_all, block by block."""
    k = len(bits)
    base = 0
    for j, b in enumerate(bits):
        if b >= L:
            base |= ((p >> (b - L)) & 1) << j
    local = [(j, b) for j, b in enumerate(bits) if b < L]
    size = page.shape[-1]
    for blk in _blocks((size,)):
        v = page[:, blk[0]]
        pr = (v[0] ** 2 + v[1] ** 2).to(torch.float64)
        if not local:
            out[base] += float(pr.sum())
            continue
        idx = _block_index((size,), (1,), blk, page.device)
        key = torch.full_like(idx, base)
        for j, b in local:
            key |= ((idx >> b) & 1) << j
        out += torch.bincount(key, weights=pr, minlength=1 << k).to(
            "cpu").numpy()


def collapse(pages: List, lmask, lval, gmask, gval, scale: float) -> List:
    """Projective collapse: the selected amplitudes times ``scale``, the
    rest zero, in place."""
    lmask, lval = int(lmask), int(lval)
    for p, page in local_pages(pages):
        if (p & gmask) != gval:
            page.zero_()
            continue
        size = page.shape[-1]
        for blk in _blocks((size,)):
            v = page[:, blk[0]]
            if not lmask:
                v.mul_(scale)
                continue
            idx = _block_index((size,), (1,), blk, page.device)
            keep = (idx & lmask) == lval
            v.copy_(torch.where(keep, v * scale, torch.zeros((), dtype=v.dtype,
                                                           device=v.device)))
    return pages


def prob_mask(pages: List, lmask, lval, gmask, gval) -> float:
    """Sum of |amp|^2 over the selected amplitudes; each block sums in
    the planes' dtype, the blocks and pages in float64 on the host."""
    lmask, lval = int(lmask), int(lval)
    size = pages[0].shape[-1]
    partials = [[0.0] * _n_blocks(size) for _ in pages]
    for p, page in local_pages(pages):
        if (p & gmask) != gval:
            continue
        for b, blk in enumerate(_blocks((size,))):
            v = page[:, blk[0]]
            pr = v[0] ** 2 + v[1] ** 2
            if lmask:
                idx = _block_index((size,), (1,), blk, page.device)
                pr = torch.where((idx & lmask) == lval, pr, 0.0)
            partials[p][b] = float(pr.sum())
    return _reduce_partials(pages, partials)


def page_probs(pages: List) -> List[float]:
    """Each page's total probability (the marginals of the page bits),
    the same list on every rank."""
    got = np.zeros(len(pages), dtype=np.float64)
    for p, page in local_pages(pages):
        got[p] = prob_mask([page], 0, 0, 0, 0)
    return [float(x) for x in sum_ranks(pages, got)]


def sum_ranks(pages, arr: np.ndarray) -> np.ndarray:
    """A float64 array that each rank filled for its own pages (zeros
    elsewhere), summed over the ranks when the list is one ket over
    several processes (:func:`spread`)."""
    if not spread(pages):
        return arr
    from ..parallel import cluster

    return cluster.all_reduce_f64(arr.reshape(-1)).reshape(arr.shape)


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

def _relabel(pages: List, src_of) -> List:
    """new[j] = pages[src_of(j)], moved to slot j's device when it lies
    elsewhere (a pure pointer move on one device).  Slot homes stay: a
    page that moves to a slot of another process travels through the
    transport, block by block, into a new page there."""
    new, moved = list(pages), 0
    for j, slot in enumerate(pages):
        src = pages[src_of(j)]
        if is_remote(slot) and is_remote(src):
            continue
        if is_remote(slot):             # this rank's page leaves
            for blk in _blocks((src.shape[-1],)):
                transport([(src[:, blk[0]], slot.rank)])
            moved += _page_bytes(src)
        elif is_remote(src):            # a page of another rank lands
            page = torch.empty_like(slot)
            for blk in _blocks((page.shape[-1],)):
                transport((), [(page[:, blk[0]], src.rank)])
            new[j] = page
            moved += _page_bytes(page)
        else:
            if src.device != slot.device:
                moved += 2 * _page_bytes(src)
            new[j] = src.to(slot.device)
    _exchanged("page_relabel", moved)
    return new


def page_swap(pages: List, g1: int, g2: int) -> List:
    """Swap two page bits: the pages whose g1 and g2 bits differ trade
    places (reference MetaSwap, src/qpager.cpp:1314)."""
    both = (1 << g1) | (1 << g2)

    def src(j):
        return j if ((j >> g1) & 1) == ((j >> g2) & 1) else j ^ both

    return _relabel(pages, src)


def swap_bits_(page, L: int, q1: int, q2: int):
    """Swap two in-page bits in place, block by block."""
    lo, hi = (q1, q2) if q1 < q2 else (q2, q1)
    h, m, l = 1 << (L - 1 - hi), 1 << (hi - lo - 1), 1 << lo
    v = page.view(2, h, 2, m, 2, l)
    _exchanged("local_swap", _page_bytes(page))  # half, read and written
    for blk in _blocks((h, m, l)):
        x = v[(slice(None), blk[0], 1, blk[1], 0, blk[2])]
        y = v[(slice(None), blk[0], 0, blk[1], 1, blk[2])]
        _swap_(x, y)
    return page


def mixed_swap(pages: List, L: int, lpos: int, gpos: int,
               factor=None) -> List:
    """Swap an in-page bit with a page bit (``ops/sharded.py:207``): page
    p0 (g-bit 0) keeps its l-bit-0 half and page p1 = p0 | 2^gpos its
    l-bit-1 half; p0's l-bit-1 half and p1's l-bit-0 half trade places,
    in place.  With a complex `factor`, the halves that moved are
    multiplied by it (the straddling ISwap of the RCS program: i)."""
    lo, hi = 1 << lpos, 1 << (L - 1 - lpos)
    bit = 1 << gpos
    moved = 0
    for p0 in range(len(pages)):
        if p0 & bit:
            continue
        P0, P1 = pages[p0], pages[p0 | bit]
        if is_remote(P0) and is_remote(P1):
            continue
        moved += (2 - is_remote(P0) - is_remote(P1)) * _page_bytes(P0)
        if is_remote(P0) or is_remote(P1):
            # this rank's half trades places with the peer's
            page, half, peer = ((P0, 1, P1.rank) if is_remote(P1)
                                else (P1, 0, P0.rank))
            v = page.view(2, hi, 2, lo)
            for blk in _blocks((hi, lo)):
                x = v[(slice(None), blk[0], half, blk[1])]
                _exchange_(x, peer)
                if factor is not None:
                    _cmul_(x, factor.real, factor.imag)
            continue
        v0 = P0.view(2, hi, 2, lo)
        v1 = P1.view(2, hi, 2, lo)
        for blk in _blocks((hi, lo)):
            x = v0[(slice(None), blk[0], 1, blk[1])]
            y = v1[(slice(None), blk[0], 0, blk[1])]
            _swap_(x, y)
            if factor is not None:
                _cmul_(x, factor.real, factor.imag)
                _cmul_(y, factor.real, factor.imag)
    _exchanged("mixed_swap", moved)
    return pages


# ---------------------------------------------------------------------------
# batched exchange: ANY sequence of physical bit-position transpositions
# composes into one permutation, which lowers as
#   L_post . page_perm . mixed_batch . L_pre
# (the JAX package's ops/sharded.py, mpiQulacs' fused multi-qubit
# exchange, arXiv:2203.16044).  The planning below is host code, copied.
# ---------------------------------------------------------------------------

class ExchangePlan(NamedTuple):
    """Static decomposition of a composed bit permutation (host-side)."""
    pre: tuple        # local transpositions before the exchange (free)
    k: int            # boundary-crossing pair count
    gpos: tuple       # page bit paired with carrier local bit (L-k+j)
    page_dest: tuple  # page-bit position map i -> page_dest[i], or None
    post: tuple       # local transpositions after the exchange (free)


def compose_swaps(n: int, swaps):
    """``src[p]`` = original position of the content that a sequential
    application of ``swaps`` leaves at position p."""
    src = list(range(n))
    for p1, p2 in swaps:
        src[p1], src[p2] = src[p2], src[p1]
    return src


def _perm_swaps(f):
    """Transpositions realizing position map f (content at x ends at
    f[x]) when applied in order — selection-sort cycle decomposition,
    <= len(f)-1 pairs."""
    n = len(f)
    cur = list(range(n))   # cur[p] = content at position p
    pos = list(range(n))   # pos[c] = position of content c
    g = [0] * n
    for x in range(n):
        g[f[x]] = x
    out = []
    for p in range(n):
        c = g[p]
        q = pos[c]
        if q != p:
            out.append((p, q))
            c2 = cur[p]
            cur[p], cur[q] = c, c2
            pos[c], pos[c2] = p, q
    return tuple(out)


def plan_exchange(L: int, g: int, swaps):
    """Decompose a transposition sequence over L local + g page bits into
    an :class:`ExchangePlan`.  None when the composition is identity."""
    n = L + g
    src = compose_swaps(n, swaps)
    dest = [0] * n
    for p in range(n):
        dest[src[p]] = p
    if all(dest[c] == c for c in range(n)):
        return None
    cross_in = [c for c in range(L) if dest[c] >= L]   # local -> page
    crossers = [t for t in range(L, n) if dest[t] < L]  # page -> local
    k = len(cross_in)
    carriers = list(range(L - k, L))
    # pair each crossing content with the carrier of the page slot it is
    # DESTINED for whenever that slot is itself vacating, so disjoint
    # local<->global batches leave an identity residual page permutation
    by_dest = {dest[c]: c for c in cross_in}
    ordered = [by_dest.pop(t, None) for t in crossers]
    leftovers = iter(c for c in cross_in if c in by_dest.values())
    cross_in = [c if c is not None else next(leftovers) for c in ordered]
    # pre-shuffle: crossing local contents onto the carrier (top-k) bits,
    # everything else staying put where possible
    A = {c: carriers[j] for j, c in enumerate(cross_in)}
    freeset = {p for p in range(L) if p not in set(A.values())}
    later = []
    for c in range(L):
        if c in A:
            continue
        if c in freeset:
            A[c] = c
            freeset.discard(c)
        else:
            later.append(c)
    for c, p in zip(later, sorted(freeset)):
        A[c] = p
    pre = _perm_swaps([A[c] for c in range(L)])
    gpos = tuple(t - L for t in crossers)
    # residual page permutation after the mixed batch
    content_at_page = {t: cross_in[j] for j, t in enumerate(crossers)}
    page_dest = tuple(dest[content_at_page.get(L + i, L + i)] - L
                      for i in range(g))
    if all(page_dest[i] == i for i in range(g)):
        page_dest = None
    # post-shuffle: carriers now hold the crossed-in page contents; send
    # every local content to its final slot
    content_at = {carriers[j]: t for j, t in enumerate(crossers)}
    content_at.update({A[c]: c for c in range(L) if c not in cross_in})
    post = _perm_swaps([dest[content_at[x]] for x in range(L)])
    return ExchangePlan(pre, k, gpos, page_dest, post)


def page_perm_of(page_dest, g: int):
    """[(src_page, dst_page)] total map for a page-bit position map."""
    npg = 1 << g
    perm = []
    for j in range(npg):
        r = 0
        for i in range(g):
            if (j >> i) & 1:
                r |= 1 << page_dest[i]
        perm.append((j, r))
    return perm


def batched_mixed_swap(pages: List, L: int, k: int, gpos,
                       carriers=None) -> List:
    """k disjoint mixed transpositions — carrier local bits (default the
    top k, [L-k, L)) against page bits ``gpos`` — as one batched exchange
    (``ops/sharded.py:352``).  A page's carrier bits split it into 2^k
    sub-blocks (sub-block s: carrier bit j = bit j of s); within each
    group of 2^k pages that differ only in their ``gpos`` bits (group
    index b: bit j = page bit gpos[j]), the page of index b ends with
    sub-block s of the page of index s, sub-block b — a block transpose,
    done as in-place swaps of the off-diagonal sub-blocks, (1 - 2^-k) of
    the state moved."""
    nsub = 1 << k
    if carriers is None:
        carriers = list(range(L - k, L))
    shape, axis_of, rest = gk._bit_view(L, carriers)
    rest_dims = [shape[a] for a in rest]
    mask = 0
    for gp in gpos:
        mask |= 1 << gp

    def member(base, b):
        p = base
        for j, gp in enumerate(gpos):
            if (b >> j) & 1:
                p |= 1 << gp
        return p

    def sub_view(v, s, blk):
        idx = [slice(None)] * len(shape)
        for j, c in enumerate(carriers):
            idx[axis_of[c]] = (s >> j) & 1
        for a, b in zip(rest, blk):
            idx[a] = b
        return v[tuple(idx)]

    moved = 0
    sub_bytes = _page_bytes(pages[0]) // nsub
    for base in range(len(pages)):
        if base & mask:
            continue
        group = [pages[member(base, b)] for b in range(nsub)]
        views = [None if is_remote(pg) else pg.view(shape) for pg in group]
        for b in range(nsub):
            for s in range(b + 1, nsub):
                vb, vs = views[b], views[s]
                if vb is None and vs is None:
                    continue
                if vb is not None and vs is not None:
                    moved += 2 * 2 * sub_bytes
                    for blk in _blocks(rest_dims):
                        _swap_(sub_view(vb, s, blk), sub_view(vs, b, blk))
                    continue
                # one sub-block here, its partner in another process
                mine, other, peer = ((vb, s, group[s].rank) if vs is None
                                     else (vs, b, group[b].rank))
                moved += 2 * sub_bytes
                for blk in _blocks(rest_dims):
                    _exchange_(sub_view(mine, other, blk), peer)
    _exchanged("batched_swap", moved)
    return pages


def _direct_exchange(L: int, g: int, swaps):
    """(carriers, gpos, page_dest) of a composed permutation that moves
    no in-page content but the ones leaving the page, so the batched
    exchange can run on the carriers where they are, with no in-page
    bit swaps before or after (each page content that enters lands where
    a leaving one was); None otherwise or for the identity."""
    n = L + g
    src = compose_swaps(n, swaps)
    dest = [0] * n
    for p in range(n):
        dest[src[p]] = p
    if all(dest[c] == c for c in range(n)):
        return None
    if any(dest[c] < L and dest[c] != c for c in range(L)):
        return None
    crossers = [t for t in range(L, n) if dest[t] < L]
    carriers = [dest[t] for t in crossers]
    landed = {t: c for t, c in zip(crossers, carriers)}
    page_dest = tuple(dest[landed.get(L + i, L + i)] - L for i in range(g))
    if all(page_dest[i] == i for i in range(g)):
        page_dest = None
    return carriers, tuple(t - L for t in crossers), page_dest


def apply_remap(pages: List, L: int, swaps, batched: bool = True) -> List:
    """Apply a sequence of PHYSICAL bit-position transpositions (p1, p2)
    (``ops/sharded.py:380``): the planner's prologue of a window.

    ``batched`` (default) composes the sequence into one permutation and
    lowers it through :func:`plan_exchange` — in-place local bit swaps,
    one (1 - 2^-k)-volume batched exchange and one page relabeling.
    Where the permutation leaves every other in-page content in place
    (the planner's prologues: disjoint in-page/page pairs), the batched
    exchange runs on the carrier bits where they are and the in-page
    swaps, an HBM pass each on one card, are skipped.
    ``batched=False`` is the pair-at-a-time lowering (one half-page
    exchange for each pair that touches a page bit)."""
    if not batched:
        for p1, p2 in swaps:
            if p1 > p2:
                p1, p2 = p2, p1
            if p2 < L:
                for _p, page in local_pages(pages):
                    swap_bits_(page, L, p1, p2)
            elif p1 >= L:
                pages = page_swap(pages, p1 - L, p2 - L)
            else:
                pages = mixed_swap(pages, L, p1, p2 - L)
        return pages
    g = len(pages).bit_length() - 1
    direct = _direct_exchange(L, g, swaps)
    if direct is not None:
        carriers, gpos, page_dest = direct
        if carriers:
            pages = batched_mixed_swap(pages, L, len(carriers), gpos,
                                       carriers)
        if page_dest is not None:
            src = {r: j for j, r in page_perm_of(page_dest, g)}
            pages = _relabel(pages, lambda r: src[r])
        return pages
    plan = plan_exchange(L, g, swaps)
    if plan is None:
        return pages
    for p1, p2 in plan.pre:
        for _p, page in local_pages(pages):
            swap_bits_(page, L, p1, p2)
    if plan.k:
        pages = batched_mixed_swap(pages, L, plan.k, plan.gpos)
    if plan.page_dest is not None:
        src = {r: j for j, r in page_perm_of(plan.page_dest, g)}
        pages = _relabel(pages, lambda r: src[r])
    for p1, p2 in plan.post:
        for _p, page in local_pages(pages):
            swap_bits_(page, L, p1, p2)
    return pages


def exchange_cost(L: int, g: int, swaps, weights=None,
                  batched: bool = True) -> float:
    """Host-side accounting twin of :func:`apply_remap`: the fraction of
    the state's bytes the lowering moves between pages.  ``weights``
    (per page bit) turn bytes into planner cost units; None counts raw
    bytes."""
    def w(bits):
        if not weights:
            return 1.0
        return max(weights[b] for b in bits)

    if not batched:
        tot = 0.0
        for p1, p2 in swaps:
            lo, hi = min(p1, p2), max(p1, p2)
            if hi < L:
                continue
            tot += 0.5 * w([b - L for b in (lo, hi) if b >= L])
        return tot
    plan = plan_exchange(L, g, swaps)
    if plan is None:
        return 0.0
    tot = 0.0
    nsub = 1 << plan.k
    for d in range(1, nsub):
        tot += w([plan.gpos[j] for j in range(plan.k)
                  if (d >> j) & 1]) / nsub
    if plan.page_dest is not None:
        npg = 1 << g
        for j, r in page_perm_of(plan.page_dest, g):
            if r != j:
                tot += w([b for b in range(g) if ((j ^ r) >> b) & 1]) / npg
    return tot


# ---------------------------------------------------------------------------
# ring forms: results that cannot overwrite their input
# ---------------------------------------------------------------------------

def gather_ring(pages: List, L: int, split_body, targs,
                keep_default=None) -> List:
    """Cross-page basis permutation (``ops/sharded.py:104``): new[(pid,
    i)] = old[(sp, sl)] with (sp, sl) the page and in-page halves that
    ``split_body(torch, pid, lidx, L, *targs)`` gives (and an optional
    third result, a keep mask; elements outside it are zero).  Each new
    page is built block by block from the source pages it reads, so the
    old and the new ket live side by side until the last page is done.
    Host tables among ``targs`` go to each page's device once.  Across
    processes every rank works out every new page's sources (the split
    body is deterministic), the owner of a source sends what the owner
    of the new page reads."""
    out = []
    cache = {}
    ref = _local_ref(pages)
    for pid, page in enumerate(pages):
        here = not is_remote(page)
        if not here and ref is None:
            out.append(RemotePage(page.rank, page.shape, page.dtype))
            continue
        dev = page.device if here else ref.device
        new = (torch.zeros_like(page) if here
               else RemotePage(page.rank, page.shape, page.dtype))
        size = page.shape[-1]
        args = device_targs(targs, dev, cache)
        for blk in _blocks((size,)):
            lidx = _block_index((size,), (1,), blk, dev)
            res = split_body(torch, pid, lidx, L, *args)
            # a result read from the page id alone is a scalar
            sp, sl = (torch.broadcast_to(torch.as_tensor(r, device=lidx.device),
                                         lidx.shape) for r in res[:2])
            keep = res[2] if len(res) > 2 else keep_default
            if keep is not None:
                keep = torch.broadcast_to(keep, lidx.shape)
            for holder, src in enumerate(pages):
                if not here and is_remote(src):
                    continue
                take = sp == holder
                if keep is not None:
                    take = take & keep
                if not bool(take.any()):
                    continue
                pos = take.nonzero().squeeze(-1)
                got = _fetch_rows(src, sl[pos], page, dev)
                if got is not None:
                    new[:, blk[0]][:, pos] = got
        out.append(new)
    return out


def _local_ref(pages):
    """This process's first page (its device computes index maps for the
    new pages of other processes), or None when it holds none: it then
    neither sends nor receives."""
    for page in pages:
        if not is_remote(page):
            return page
    return None


def _fetch_rows(src, idx, slot, dev):
    """src[:, idx] on `dev` for the rank that owns `slot` (a new page's
    slot): read in place where the source lives here too, received
    through the transport where it does not.  The owner of `src` sends
    it when `slot` lies in another process, and gets None."""
    if is_remote(slot):
        transport([(src[:, idx.to(src.device, torch.int64)], slot.rank)])
        return None
    if is_remote(src):
        got = torch.empty((2, idx.numel()), dtype=src.dtype, device=dev)
        transport((), [(got, src.rank)])
        return got
    return src[:, idx.to(src.device, torch.int64)].to(dev)


def compose_ring(pages_a: List, b, L_in: int, start: int, n1: int,
                 n2: int) -> List:
    """Compose on pages (``ops/sharded.py:131``): out = A (x) B with B's
    n2 qubits inserted at ``start``, page for page (reference
    CombineEngines, src/qpager.cpp:316-367).  ``b`` is B's (2, 2^n2)
    planes; each output element out[(pid, i)] = A[a_src] * B[j] with
    (a_src, j) decoded from the output's (page, local) index, without a
    global index.  Where B lies below the page bits (start <= L_in)
    every element reads its own page; elsewhere an element of another
    process's page comes through the transport, as in gather_ring."""
    L_out = L_in + n2
    npg = len(pages_a)
    aligned = start <= L_in
    ref = _local_ref(pages_a)
    out = []
    for pid, A in enumerate(pages_a):
        here = not is_remote(A)
        if not here:
            out.append(RemotePage(A.rank, (2, 1 << L_out), A.dtype))
            if aligned or ref is None:
                continue
        dev = A.device if here else ref.device
        bd = b.to(dev, A.dtype)
        new = (torch.empty((2, 1 << L_out), dtype=A.dtype, device=dev)
               if here else None)
        for blk in _blocks((1 << L_out,)):
            s, e, _ = blk[0].indices(1 << L_out)
            i = torch.arange(s, e, dtype=torch.int64, device=dev)

            def field(lo: int, width: int):
                """Bits [lo, lo + width) of the global output index, read
                from (i, pid)."""
                val = torch.zeros_like(i)
                take = 0
                if width <= 0:
                    return val
                if lo < L_out:
                    take = min(width, L_out - lo)
                    val = (i >> lo) & ((1 << take) - 1)
                if lo + width > L_out:
                    plo = max(lo, L_out) - L_out
                    pw = lo + width - max(lo, L_out)
                    val = val | (((pid >> plo) & ((1 << pw) - 1)) << take)
                return val

            l = field(0, start)
            j = field(start, n2)
            h = field(start + n2, n1 - start)
            a_src = (h << start) | l
            sp = a_src >> L_in
            sl = a_src & ((1 << L_in) - 1)
            br, bi = bd[0][j], bd[1][j]
            dst = new[:, blk[0]] if here else None
            holders = [pid] if aligned else range(npg)
            for holder in holders:
                src = pages_a[holder]
                if not here and is_remote(src):
                    continue
                if aligned:
                    pos = None
                    idx = sl
                else:
                    take = sp == holder
                    if not bool(take.any()):
                        continue
                    pos = take.nonzero().squeeze(-1)
                    idx = sl[pos]
                got = _fetch_rows(src, idx, A, dev)
                if got is None:
                    continue
                ar, ai = got[0], got[1]
                bbr = br if pos is None else br[pos]
                bbi = bi if pos is None else bi[pos]
                vr = ar * bbr - ai * bbi
                vi = ar * bbi + ai * bbr
                if pos is None:
                    dst[0].copy_(vr)
                    dst[1].copy_(vi)
                else:
                    dst[0, pos] = vr
                    dst[1, pos] = vi
        if here:
            out.append(new)
    return out


# ---------------------------------------------------------------------------
# re-paging and whole-ket gathers across processes
# ---------------------------------------------------------------------------

def _move_piece(src, so: int, dst, do: int, length: int) -> int:
    """Amplitudes [so, so + length) of page `src` into [do, do + length)
    of page `dst`, a block at a time: a copy where both live here, the
    transport where one lives in another process (the other rank runs
    the same call).  Returns the bytes this rank read and wrote."""
    if is_remote(src) and is_remote(dst):
        return 0
    nb = 0
    for s in range(0, length, CHUNK):
        e = min(length, s + CHUNK)
        if is_remote(dst):
            blk = src[:, so + s:so + e]
            transport([(blk, dst.rank)])
        elif is_remote(src):
            blk = dst[:, do + s:do + e]
            transport((), [(blk, src.rank)])
        else:
            blk = dst[:, do + s:do + e]
            blk.copy_(src[:, so + s:so + e])
            nb += _page_bytes(blk)
        nb += _page_bytes(blk)
    return nb


def repage(pages: List, L_old: int, devs, L_new: int) -> List:
    """The ket of `pages` (2^L_old amplitudes each) re-split into pages
    of 2^L_new amplitudes on the page_devices list `devs` (devices, or
    the cluster's page homes): new page j holds the amplitudes [j 2^L_new,
    (j + 1) 2^L_new), its old pages side by side (fewer pages) or a slice
    of one (more pages).  A new page that is an old page on its device
    moves without a copy; one whose old pages live in another process is
    received through the transport, block by block, while their owner
    sends.  The new pages are built beside the old ones (both layouts at
    once), so a failed re-page leaves the old list as it was."""
    from ..parallel.cluster import PageHome

    me = _me()
    new, moved = [], 0
    dtype = pages[0].dtype
    for j, d in enumerate(devs):
        rank, dev = ((d.rank, d.device) if isinstance(d, PageHome)
                     else (None, d))
        if L_new >= L_old:
            r = 1 << (L_new - L_old)
            pieces = [(j * r + i, 0, i << L_old, 1 << L_old)
                      for i in range(r)]
        else:
            r, size = 1 << (L_old - L_new), 1 << L_new
            pieces = [(j // r, (j % r) * size, 0, size)]
        if rank is not None and rank != me:
            dst = RemotePage(rank, (2, 1 << L_new), dtype)
            for p, so, do, ln in pieces:
                moved += _move_piece(pages[p], so, dst, do, ln)
            new.append(dst)
            continue
        if (len(pieces) == 1 and L_new == L_old
                and not is_remote(pages[pieces[0][0]])
                and pages[pieces[0][0]].device == dev):
            new.append(pages[pieces[0][0]])      # a pointer move
            continue
        dst = torch.empty((2, 1 << L_new), dtype=dtype, device=dev)
        for p, so, do, ln in pieces:
            moved += _move_piece(pages[p], so, dst, do, ln)
        new.append(dst)
    if spread(pages):
        # a one-process re-page moves no page between processes: the
        # exchange counters keep to the collectives, as the JAX pager's
        _exchanged("repage", moved)
    return new


def all_gather_pages(pages: List, device) -> torch.Tensor:
    """The whole ket of a page list as one (2, 2^n) tensor on `device`,
    on every rank: each page's owner sends it, block by block, through
    the transport to every other rank of the cluster (a rank that holds
    no page receives every one).  One process concatenates its pages."""
    from ..parallel import cluster

    size = pages[0].shape[-1]
    out = torch.empty((2, len(pages) * size), dtype=pages[0].dtype,
                      device=device)
    if not spread(pages):
        for p, page in enumerate(pages):
            out[:, p * size:(p + 1) * size].copy_(page)
        return out
    me = _me()
    others = [r for r in range(cluster.process_count()) if r != me]
    moved = 0
    for p, page in enumerate(pages):
        for s in range(0, size, CHUNK):
            e = min(size, s + CHUNK)
            dst = out[:, p * size + s:p * size + e]
            if is_remote(page):
                transport((), [(dst, page.rank)])
            else:
                blk = page[:, s:e]
                transport([(blk, r) for r in others])
                dst.copy_(blk)
            moved += 2 * _page_bytes(dst)
    _exchanged("gather", moved)
    return out
