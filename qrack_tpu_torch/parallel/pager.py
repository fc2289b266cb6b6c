"""QPager: one coherent ket split into pages over a list of devices, in
one process or in several (counterpart of the JAX package's
parallel/pager.py).

Re-design of the reference's QPager (include/qpager.hpp:31;
src/qpager.cpp).  Mapping:

  reference                                   here
  ------------------------------------------  ---------------------------
  page i = amplitudes [i*pageMaxQPower, ...)  ``_pages[i]``, a (2, 2^L)
                                              plane tensor on a device
                                              of the list
  in-page gate broadcast to every page        the window kernel (K1/K2)
    (src/qpager.cpp:369-397)                  or a plain pass per page
  paged-qubit gate: pair pages,               in-place pair mix of the
    ShuffleBuffers (src/qpager.cpp:400-447)   two pages, block by block
  MetaControlled page-subset selection        page-mask tests on the host
    (src/qpager.cpp:453,563)                  (the page id is an int)
  MetaSwap page-pointer permutation           a relabeling of the page
    (src/qpager.cpp:1314-1350)                list (a copy between two
                                              devices)

The JAX package puts one page on each device of a mesh and runs every
body inside ``shard_map``; torch has no mesh, so the pages are separate
tensors and the device list may name one device more than once (the
reference's own QPager is one process over a device list).  On one
H100, ``devices=["cuda:0"] * 4`` (or ``QRACK_QPAGER_DEVICES=0,0,0,0``)
holds a 32-qubit float32 ket in 4 pages of 2^30 amplitudes, past one
dense engine's 30 qubits: every mask splits into (local, page) halves
and no page passes 2^30 amplitudes, so the window kernel runs on each
page unchanged (ops/fusion.py ``sharded_kernel_window_body``).  Pages on
several cards are allowed by the code; only one card has been run.

Gates queue in a GateStreamFuser window; a flush plans placement swaps
(``fusion.plan_remaps``, the logical->physical table ``_qmap``), runs
them as the window's prologue and the window on the pages.  Every pass
over a page works in place, a block of at most ``sharded.CHUNK``
amplitudes at a time, so the pager needs at most half a page of memory
beside its planes on the gate path.

Past 31 qubits (or with ``force_wide_alu`` set) every gate-set and ALU
op that reads the basis index runs through its split-index form
(engines/qengine.py ``split=``): a diagonal as a factor from (page id,
in-page index) pairs on each page, block by block and in place; a
permutation as ``ops/sharded.gather_ring``, which builds new pages
while the old ones live (a second ket beside the first).  Both restore
identity placement first, since the split bodies read logical indices.

Telemetry (the JAX pager's names): ``remap.pager.*``,
``exchange.pager.collective_bytes`` and ``exchange.pager.host_fetch*``
here; ``exchange.pager.<pass>`` and ``exchange.pager.bytes`` where the
passes run (ops/sharded.py, beside ``sharded.EXCHANGES``); the flushed
windows under ``fuse.kernel.*``/``fuse.xla.*``.

Resilience (resilience/, off unless armed): every page pass is a
guarded dispatch at the JAX pager's site of the same program
(``pager.dispatch``, ``pager.exchange``, ``cuda.fuse.flush`` for a
window) and the host reads run at ``pager.device_get``; elastic
re-paging (``can_shrink``, ``shrink_pages``, ``expand_pages``,
``maybe_reexpand``: ``elastic.repage.*``) and the integrity quarantine
(``_device_pool``, ``_quarantine_repage``: ``integrity.quarantine.*``)
re-page on the card, keyed by page slot (``page_slots``: the page's
index in the construction device list, whose entries past ``n_pages``
are spares).  Checkpoints (checkpoint/registry.py, kind ``"pager"``):
the raw physical pages as complex128 ``page_i`` arrays, as the file
format requires (twice the float32 planes' bytes), with the placement
table in the meta; a file saved on one page count loads into another.
Not here yet: the serving executor's call-boundary probe (item 16).

Pages in several processes (parallel/cluster.py): built over the
cluster's page homes, ``QPager(n, devices=cluster.global_page_devices(
G))``, each process keeps only its own pages; the others are
``sharded.RemotePage`` placeholders at the same ids.  Every process
runs the same calls with the same rng seed.  The page passes move blocks
between processes through ``sharded.transport`` and reduce in float64
across them; reads (``GetQuantumState``, ``GetAmplitude``, the
checkpoint capture) go through ``sharded.replicated_window``, so every
rank returns the same value; ``MAll`` draws the page from the
all-reduced page marginals on every rank, and the page's owner draws the
index and broadcasts it.  The remap planner prices a page bit that
crosses processes at ``cluster.dcn_weight()`` (``_exchange_weights``;
``dcn_bits=`` forces the top bits so on one process).  Such a pager
keeps its pages in a ``sharded.PageList``, so every rank joins every
collective, also one that holds every page or none after a re-page.

Re-paging, failover and the resilience plane over page homes: a guarded
pass agrees on its outcome across the ranks (resilience/dispatch.py
``cohort``), so every rank retries, replays, shrinks, fails over,
strikes, quarantines or expands at the same call.  ``_repage`` takes the
surviving slot prefix of ``_device_pool()`` as the JAX pager does (4
pages over 2 ranks shrink to 2 pages on rank 0's slots) and moves
blocks between processes through the transport (``sharded.repage``); a
width that changes the page count fills each rank's own pages from the
replicated host ket; Decompose and Dispose find the dominant remainder
branch over every rank and broadcast it from its owner; Compose and the
out-of-place ALU scatter read the other ket, or the old one, gathered
onto every rank (``sharded.all_gather_pages``).

The pager runs on ``cuda`` unless the caller passes ``device="cpu"`` or
CPU devices (the tests do); without a GPU it raises.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from .. import resilience as _res
from .. import telemetry as _tele
from ..config import get_config
from ..engines.qengine import QEngine
from ..ops import fusion as fu
from ..ops import gatekernels as gk
from ..ops import sharded as shb
from ..ops.sharded import split_masks as _split_masks
from ..resilience import dispatch as _rdispatch
from ..utils.bits import is_pow2, log2
from ..utils.device import resolve_device
from . import cluster as _cluster

#: the widest page: int32 masks and tile ids of the window kernel
MAX_PAGE_QB = 30

#: windows the pager flushed, by lowering, and the window-kernel
#: launches their plans predict (n_pages x the in-page sweeps of
#: fusion.sharded_kernel_sweeps); the chip smoke holds the launches it
#: counts to them
FLUSHES = {"kernel_windows": 0, "chain_windows": 0, "single_ops": 0,
           "predicted_launches": 0}


def reset_flushes() -> None:
    for k in FLUSHES:
        FLUSHES[k] = 0


def _norm_device(dev) -> torch.device:
    """A device of the list, resolved (``cuda`` needs a GPU) and with its
    index, so two names of one card compare equal."""
    d = resolve_device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def pager_devices_from_env():
    """Device list from QRACK_QPAGER_DEVICES (reference: the same env
    selecting pager devices, src/qpager.cpp:170), or None when unset:
    comma-separated CUDA ordinals, or ``cpu``.  An id may repeat (pages
    that share a device); an unknown id raises."""
    spec = get_config().pager_devices.strip()
    if not spec:
        return None
    toks = [t.strip() for t in spec.split(",") if t.strip()]
    if not toks:
        raise ValueError(
            f"QRACK_QPAGER_DEVICES={spec!r} contains no device ids")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ids = [t for t in toks if t != "cpu"]
    missing = [t for t in ids if not t.isdigit() or int(t) >= count]
    if missing:
        raise ValueError(
            f"QRACK_QPAGER_DEVICES names unknown device ids {missing} "
            f"(available: {list(range(count))})")
    return [torch.device("cpu") if t == "cpu" else torch.device("cuda", int(t))
            for t in toks]


def _device_list(devices, device, n_pages) -> List:
    """The construction device list: torch devices, or the cluster's
    page homes (cluster.PageHome) as they are."""
    if devices is not None:
        return [d if isinstance(d, _cluster.PageHome) else _norm_device(d)
                for d in devices]
    env = pager_devices_from_env()
    if env is not None:
        return env
    if device is not None:
        return [_norm_device(device)] * (n_pages or 1)
    resolve_device(None)  # raises without a GPU
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class PageHomes:
    """Where a pager's pages live (QPager, QPagerTurboQuant): a device a
    slot of the construction list (``_slot_devices``), the slot of each
    page in page order (``_slots``) and, over the cluster's page homes
    (parallel/cluster.py), the process of each slot (``_slot_ranks``;
    None when this process holds every page)."""

    def _take_homes(self, devs) -> List:
        """The slots' devices of a construction list, its ranks kept
        when it lists cluster.PageHome entries."""
        self._slot_ranks = None
        self._rank = 0
        if devs and isinstance(devs[0], _cluster.PageHome):
            self._rank = _cluster.process_index()
            self._slot_ranks = [h.rank for h in devs]
            devs = [_norm_device(h.device) if h.rank == self._rank
                    else h.device for h in devs]
        return devs

    @property
    def devices(self) -> List[torch.device]:
        """The device of each page (in its own process)."""
        return [self._slot_devices[s] for s in self._slots]

    @property
    def homes(self):
        """Each page's cluster.PageHome, or None on a one-process pager."""
        if self._slot_ranks is None:
            return None
        return [_cluster.PageHome(self._slot_ranks[s], self._slot_devices[s])
                for s in self._slots]

    def _here(self, slot: int) -> bool:
        """True when the page of `slot` lives in this process."""
        return self._slot_ranks is None or self._slot_ranks[slot] == self._rank

    def _local_devices(self) -> List[torch.device]:
        """The devices of this process's pages, in page order."""
        return [self._slot_devices[s] for s in self._slots if self._here(s)]

    def _home_device(self) -> torch.device:
        """This process's first page's device, else (a rank that holds no
        page after a re-page onto another process's slots) the device of
        its first slot in the construction list."""
        here = self._local_devices() or [
            d for s, d in enumerate(self._slot_devices) if self._here(s)]
        if not here:
            raise ValueError("no page slot of this pager lives in this "
                             "process")
        return here[0]

    def _home_of(self, slot: int):
        """The page_devices entry of `slot`: its cluster.PageHome over
        page homes, else its device."""
        if self._slot_ranks is None:
            return self._slot_devices[slot]
        return _cluster.PageHome(self._slot_ranks[slot],
                                 self._slot_devices[slot])

    @property
    def _on_cluster(self) -> bool:
        """True for a pager over the cluster's page homes (a cluster of
        one too): its reads, reductions and guarded passes are
        collectives, the same on every rank."""
        return self._slot_ranks is not None and _cluster.is_initialized()

    def _page_list(self, pages):
        """A page list as the pager keeps it: a sharded.PageList over the
        cluster's page homes (every rank joins its collectives)."""
        if pages is None or not self._on_cluster \
                or isinstance(pages, shb.PageList):
            return pages
        return shb.PageList(pages)


class QPager(PageHomes, QEngine):
    """Paged dense engine over a list of devices."""

    _xp = torch
    _tele_name = "pager"
    _fuse_capable = True  # the gate stream fuses into page windows

    def __init__(self, qubit_count: int, init_state: Optional[int] = 0,
                 devices=None, n_pages: Optional[int] = None, dtype=None,
                 remap: Optional[str] = None,
                 collective: Optional[str] = None,
                 dcn_bits: Optional[int] = None, device=None, **kwargs):
        super().__init__(qubit_count, init_state=init_state or 0, **kwargs)
        if dtype is None:
            dtype = get_config().device_real_dtype()
        self.dtype = gk.plane_dtype(dtype)
        devs = self._take_homes(_device_list(devices, device, n_pages))
        # power-of-two device prefix (reference: page-count policy,
        # src/qpager.cpp:89-292)
        if n_pages is None:
            n_pages = 1 << log2(len(devs))
        if not is_pow2(n_pages):
            raise ValueError("n_pages must be a power of two")
        if n_pages > len(devs):
            raise ValueError(
                f"n_pages={n_pages} exceeds the device list ({len(devs)}); "
                "name a device once for each page (a device may repeat)")
        self.n_pages = n_pages
        self.g_bits = log2(n_pages)
        self._max_g = self.g_bits
        # the construction list: its first n_pages slots hold the pages,
        # the rest are spares that a re-page off a quarantined slot adopts
        self._slot_devices = list(devs)
        self._slots = list(range(n_pages))
        # planner weights of the page bits (DCN > ICI), for the page
        # layout they were read from
        self._dcn_bits = dcn_bits
        self._xw_key = None
        self._xw = None
        # last integrity-quarantine epoch acted on (the call-boundary
        # probe's healthy-path cost: one module read + int compare)
        self._quarantine_epoch = 0
        # elastic degradation marker: the construction page exponent to
        # grow back to, set by shrink_pages, cleared by expand_pages
        # (None = healthy)
        self._elastic_target_g: Optional[int] = None
        self._check_capacity(qubit_count)
        self._fuser = fu.make_fuser(self)
        self._pages_raw: Optional[List[torch.Tensor]] = None
        # per-instance remap-planner and batched-exchange overrides
        # (None: QRACK_TPU_REMAP, QRACK_TPU_COLLECTIVE)
        self._remap = remap
        self._collective = collective
        self._map_reset()
        if init_state is not None:
            self.SetPermutation(init_state)

    # ------------------------------------------------------------------
    # state access: every read is a fusion boundary
    # ------------------------------------------------------------------

    @property
    def _pages_raw(self):
        """The resident pages as stored (no flush): a PageList over the
        cluster's page homes."""
        return self._page_store

    @_pages_raw.setter
    def _pages_raw(self, pages) -> None:
        self._page_store = self._page_list(pages)

    @property
    def _pages(self) -> List[torch.Tensor]:
        """The resident pages.  A pending gate window flushes before they
        escape, so no reader sees a ket behind the gate stream."""
        self._settle()
        return self._pages_raw

    @_pages.setter
    def _pages(self, pages) -> None:
        # a write while gates are pending is a blind overwrite: drop the
        # queued gates (the flush's own write-back passes through)
        f = self._fuser
        if f is not None and f.gates and not f._flushing:
            f.drop()
        self._pages_raw = list(pages)

    def _settle(self) -> None:
        f = self._fuser
        if f is not None and f.gates and not f._flushing:
            f.flush()

    @property
    def device(self) -> torch.device:
        """The device of this process's first page (of its first slot
        when it holds none)."""
        return self._home_device()

    def _new_pages(self, L: int, fill=None) -> List:
        """Pages of 2^L amplitudes on the current slots (sharded.new_pages:
        ``fill(page id, device)`` or zeros here, placeholders elsewhere)."""
        return shb.new_pages(self.homes or self.devices, L, self.dtype, fill)

    @property
    def page_slots(self) -> List[int]:
        """Each page's slot: its index in the construction device list
        (spares after the first n_pages).  Integrity strikes and
        quarantine are keyed by slot (resilience/integrity.py)."""
        return list(self._slots)

    # ------------------------------------------------------------------
    # guarded dispatch (resilience/): while the plane is armed every page
    # pass is one guarded call at the JAX pager's site of the same
    # program — ``pager.dispatch`` for page-local passes,
    # ``pager.exchange`` for those that move amplitudes between pages,
    # ``cuda.fuse.flush`` for a window — and the reads that return host
    # values run at ``pager.device_get`` with the integrity check of the
    # value read.  While it is off, one attribute test.  Over page homes
    # each guarded call agrees on its outcome across the ranks
    # (``cohort``), so every rank takes the same decision.
    # ------------------------------------------------------------------

    def _pass(self, site: str, fn, *args):
        """fn(*args) as one guarded dispatch at `site`.  The passes write
        the pages in place, so the guard watches their writes (a retry
        runs only a pass that wrote nothing); an in-place pass hands the
        pages back as its output, where an amp-corrupt strike lands."""
        if not _res._ACTIVE:
            return fn(*args)
        pages = self._pages_raw

        def run():
            out = fn(*args)
            return pages if out is None else out

        return _rdispatch.call_guarded(
            site, run, writes=lambda: _rdispatch.write_token(pages),
            cohort=self._on_cluster)

    def _host_read(self, fn, *args):
        """A host read at ``pager.device_get`` (the sync that proves
        completion), its value checked in place by the integrity plane."""
        if not _res._ACTIVE:
            return fn(*args)
        out = _rdispatch.call_guarded("pager.device_get", fn, args,
                                      cohort=self._on_cluster)
        from ..resilience import integrity as _integ

        if _integ.enabled():
            _integ.check_host("pager.device_get", out)
        return out

    @property
    def local_bits(self) -> int:
        return self.qubit_count - self.g_bits

    @property
    def page_planes(self) -> List[torch.Tensor]:
        """The resident pages in physical order (not copies)."""
        return self._pages

    def _check_capacity(self, qubit_count: int) -> None:
        local = qubit_count - self.g_bits
        if local < 0:
            raise ValueError(
                f"QPager width {qubit_count} smaller than page count "
                f"2^{self.g_bits}")
        if local > MAX_PAGE_QB:
            raise MemoryError(
                f"QPager page width {local} exceeds a single page "
                f"({MAX_PAGE_QB} qubits); add pages or stack QUnit above")
        if qubit_count > self.config.max_paging_qubits:
            raise MemoryError(
                f"QPager width {qubit_count} exceeds QRACK_MAX_PAGING_QB="
                f"{self.config.max_paging_qubits}")

    def _rand_phase(self) -> complex:
        if self.rand_global_phase:
            ang = 2.0 * math.pi * self.Rand()
            return complex(math.cos(ang), math.sin(ang))
        return 1.0 + 0.0j

    @staticmethod
    def _cmask_cval(controls, perm):
        from ..utils.bits import control_offset

        cmask = 0
        for c in controls:
            cmask |= 1 << c
        return cmask, control_offset(controls, perm)

    def _mp(self, m2):
        """(2, 2, 2) matrix planes of a host 2x2, on the host in the
        planes' dtype (the payload the JAX package's programs take)."""
        m2 = np.asarray(m2, dtype=np.complex128)
        return gk.host_tensor(np.stack([m2.real, m2.imag]), self.dtype)

    # ------------------------------------------------------------------
    # logical->physical placement table (mpiQulacs-style remapping,
    # arXiv:2203.16044).  ``_qmap[l]`` is the ket bit holding logical
    # qubit ``l``; ``_qinv`` is the inverse.  Every host-visible read and
    # write translates through it.
    # ------------------------------------------------------------------

    def _map_reset(self, n: Optional[int] = None) -> None:
        n = self.qubit_count if n is None else n
        self._qmap = list(range(n))
        self._qinv = list(range(n))

    def _map_assign(self, qmap) -> None:
        self._qmap = list(qmap)
        inv = [0] * len(self._qmap)
        for q, p in enumerate(self._qmap):
            inv[p] = q
        self._qinv = inv

    def _map_nonid(self) -> bool:
        return any(q != p for q, p in enumerate(self._qmap))

    def _map_index(self, idx: int) -> int:
        """Logical basis index -> physical basis index."""
        out, q = 0, 0
        while idx:
            if idx & 1:
                out |= 1 << self._qmap[q]
            idx >>= 1
            q += 1
        return out

    def _unmap_index(self, idx: int) -> int:
        out, p = 0, 0
        while idx:
            if idx & 1:
                out |= 1 << self._qinv[p]
            idx >>= 1
            p += 1
        return out

    def _map_mask(self, mask: int, val: int):
        """Translate a (mask, val) control/selection pair bitwise."""
        pm = pv = 0
        q = 0
        while mask:
            if mask & 1:
                p = self._qmap[q]
                pm |= 1 << p
                if (val >> q) & 1:
                    pv |= 1 << p
            mask >>= 1
            q += 1
        return pm, pv

    def _remap_active(self) -> bool:
        mode = self._remap if self._remap is not None else fu.remap_mode()
        return mode != "off" and self.n_pages > 1

    def _collective_batched(self) -> bool:
        """True when remap prologues lower as ONE batched exchange
        (QRACK_TPU_COLLECTIVE / the per-instance override)."""
        mode = (self._collective if self._collective is not None
                else fu.collective_mode())
        return mode != "off"

    @property
    def _exchange_weights(self):
        """Per-page-bit planner weights (a bit that crosses processes
        prices at cluster.dcn_weight()), or None when uniform — read
        again whenever the page layout changes."""
        key = (tuple(self._slots), self.n_pages)
        if self._xw_key != key:
            pages = self.homes or self.devices
            self._xw = _cluster.page_bit_weights(pages,
                                                 dcn_bits=self._dcn_bits)
            self._xw_key = key
        return self._xw

    def _tele_remap(self, swaps, batched: bool = True) -> None:
        """Count placement transpositions as the JAX pager does:
        ``remap.pager.pairs``, ``remap.pager.batched`` (a batched
        exchange of two or more mixed pairs) and
        ``exchange.pager.collective_bytes``, the state's bytes times the
        fraction ``sharded.exchange_cost`` plans to move (the JAX
        collective model).  The passes that run are counted where they
        run (ops/sharded.py: ``exchange.pager.<pass>`` and ``.bytes``)."""
        if not (_tele._ENABLED and swaps):
            return
        L = self.local_bits
        _tele.inc("remap.pager.pairs", len(swaps))
        frac = shb.exchange_cost(L, self.g_bits, swaps, batched=batched)
        if frac <= 0 or not batched:
            return
        if sum(1 for p1, p2 in swaps if max(p1, p2) >= L) >= 2:
            _tele.inc("remap.pager.batched")
        nb = sum(shb._page_bytes(p) for p in self._pages_raw)
        _tele.inc("exchange.pager.collective_bytes", frac * nb)

    def _apply_swaps(self, swaps) -> None:
        """Physical transpositions through one remap (in place)."""
        self._pages_raw = self._pass(
            "pager.exchange", shb.apply_remap, self._pages_raw,
            self.local_bits, tuple(swaps), self._collective_batched())

    def _unmap(self) -> None:
        """Physically restore logical bit order (identity table) in one
        remap.  Structural reshapes and the ALU assume logical ==
        physical and call this first."""
        self._settle()
        if not self._map_nonid():
            return
        qmap = list(self._qmap)
        qinv = list(self._qinv)
        swaps = []
        for l in range(len(qmap)):
            p = qmap[l]
            if p == l:
                continue
            o = qinv[l]
            swaps.append((l, p))
            qmap[l], qmap[o] = l, p
            qinv[l], qinv[p] = l, o
        if _tele._ENABLED:
            _tele.inc("remap.pager.unmap")
        self._tele_remap(tuple(swaps), batched=self._collective_batched())
        self._apply_swaps(swaps)
        self._map_reset()

    def _split(self, mask, val=None):
        return _split_masks(mask, mask if val is None else val,
                            self.local_bits)

    # ------------------------------------------------------------------
    # gates
    # ------------------------------------------------------------------

    def _k_apply_2x2(self, m2, target, controls, perm) -> None:
        self._settle()
        cmask, cval = self._cmask_cval(controls, perm)
        if self._map_nonid():
            cmask, cval = self._map_mask(cmask, cval)
            target = self._qmap[target]
        self._apply_2x2_phys(m2, target, cmask, cval)

    def _apply_2x2_phys(self, m2, target, cmask, cval) -> None:
        """2x2 on PHYSICAL bit positions — placement already applied."""
        L = self.local_bits
        lmask, lval, gmask, gval = _split_masks(cmask, cval, L)
        mp = self._mp(m2)
        pages = self._pages_raw
        if target < L:
            self._pass("pager.dispatch", shb.apply_local_2x2, pages, mp, L,
                       target, lmask, lval, gmask, gval)
        else:
            self._pass("pager.exchange", shb.apply_global_2x2, pages, mp,
                       target - L, lmask, lval, gmask, gval)

    def _apply_diag_phys(self, d0, d1, target, cmask, cval) -> None:
        L = self.local_bits
        lmask, lval, gmask, gval = _split_masks(cmask, cval, L)
        tmask = 1 << target
        d0, d1 = complex(d0), complex(d1)
        self._pass("pager.dispatch", shb.apply_diag, self._pages_raw,
                   d0.real, d0.imag, d1.real, d1.imag,
                   tmask & ((1 << L) - 1), tmask >> L, lmask, lval, gmask,
                   gval)

    def _k_apply_diag(self, d0, d1, target, controls, perm) -> None:
        self._settle()
        cmask, cval = self._cmask_cval(controls, perm)
        if self._map_nonid():
            cmask, cval = self._map_mask(cmask, cval)
            target = self._qmap[target]
        self._apply_diag_phys(d0, d1, target, cmask, cval)

    # ------------------------------------------------------------------
    # gate-stream fusion hooks (ops/fusion.py GateStreamFuser)
    # ------------------------------------------------------------------

    def _fuse_admit(self, m, target, controls) -> bool:
        # every 2x2 lowers into the page window, paged targets included
        return True

    def _fuse_flush(self, gates) -> int:
        ops = fu.lower_gates(gates)
        la = self._fuser.lookahead_rest() if self._fuser is not None else None
        return self._dispatch_ops(ops, lookahead=la)

    def _run_fused_ops(self, ops) -> None:
        """RunFused entry (layers/qcircuit.py): a whole lowered circuit
        as one page window, remap planning included — the full gate list
        is the planning horizon."""
        if not ops:
            return
        self._settle()
        self._dispatch_ops(ops)

    def _dispatch_ops(self, ops, lookahead=None) -> int:
        """Lower and run one window of LOGICAL ops: plan placement swaps
        against the window and the lookahead, translate the ops onto the
        table after them, run the swaps as the window's prologue and the
        window on the pages, then commit the table."""
        if not ops:
            return 0
        L = self.local_bits
        swaps = ()
        new_qmap = self._qmap
        batched = self._collective_batched()
        if self._remap_active():
            swaps, new_qmap = fu.plan_remaps(ops, L, self._qmap, lookahead,
                                             weights=self._exchange_weights,
                                             batched=batched)
        tops = (fu.translate_ops(ops, new_qmap)
                if (swaps or self._map_nonid()) else ops)
        if len(tops) == 1 and not swaps:
            # merged down to one op on the current placement
            op = tops[0]
            m = np.asarray(op.m)
            if op.kind in ("cphase", "diag"):
                self._apply_diag_phys(m[0, 0], m[1, 1], op.target, op.cmask,
                                      op.cval)
            else:
                self._apply_2x2_phys(m, op.target, op.cmask, op.cval)
            FLUSHES["single_ops"] += 1
            return 1
        structure = fu.sharded_structure_of(tops)
        operands = fu.sharded_operands(tops, L, self.dtype, device="cpu")
        npg = self.n_pages
        if _tele._ENABLED:
            if swaps:
                _tele.inc("remap.pager.windows")
            self._tele_remap(swaps, batched=batched)
        plan, why = fu.sharded_kernel_lowering(L, structure, self.device)
        if plan is not None:
            body = fu.sharded_kernel_window_body(
                L, npg, structure, block_pow=plan["block_pow"], remap=swaps,
                batched=batched)
            n_global = sum(1 for kind, t, _ in structure
                           if kind == "gen" and t >= L)
            FLUSHES["kernel_windows"] += 1
            # the kernel runs on this process's pages
            n_here = len(shb.local_pages(self._pages_raw))
            FLUSHES["predicted_launches"] += n_here * (plan["sweeps"]
                                                       - n_global)
        else:
            body = fu.sharded_window_body(L, npg, structure, remap=swaps,
                                          batched=batched)
            FLUSHES["chain_windows"] += 1
        self._pages_raw = self._pass("cuda.fuse.flush", body,
                                     self._pages_raw, *operands)
        self._map_assign(new_qmap)
        esize = self.dtype.itemsize
        if plan is not None:
            fu.record_kernel_flush(len(ops), plan["sweeps"],
                                   width=self.qubit_count, esize=esize)
        else:
            fu.record_kernel_fallback(why)
            fu.record_xla_flush(len(ops), width=self.qubit_count,
                                esize=esize)
        return 1

    def _k_swap_bits(self, q1, q2) -> None:
        self._settle()
        L = self.local_bits
        # a Swap is a pure relabeling: the PHYSICAL transposition of the
        # two qubits' current positions implements it at any table state
        p1, p2 = self._qmap[q1], self._qmap[q2]
        if p1 > p2:
            p1, p2 = p2, p1
        if p2 < L:
            def lswap(pages):
                for _p, page in shb.local_pages(pages):
                    shb.swap_bits_(page, L, p1, p2)

            self._pass("pager.dispatch", lswap, self._pages_raw)
        elif p1 >= L:
            self._pages_raw = self._pass("pager.exchange", shb.page_swap,
                                         self._pages_raw, p1 - L, p2 - L)
        else:
            if _tele._ENABLED:
                _tele.inc("remap.pager.swap")
            self._apply_swaps(((p1, p2),))

    # ------------------------------------------------------------------
    # ALU: the global index of a page's amplitudes to 31 qubits, the
    # split-index forms past it (or with force_wide_alu)
    # ------------------------------------------------------------------

    # set by tests and callers: take the split-index forms at any width
    force_wide_alu = False

    @property
    def _wide_alu(self) -> bool:
        return self.force_wide_alu or self.qubit_count > 31

    def _index_dtype(self):
        # int32 to 30 qubits, as the dense engine; int64 past it, so no
        # index or bound of an ALU op wraps at 2^31
        return gk.IDX_DTYPE if self.qubit_count <= 30 else torch.int64

    def _k_phase_fn(self, fn, split=None) -> None:
        # the factors read the LOGICAL basis index: identity placement
        self._unmap()
        if split is not None and self._wide_alu:
            self._pass("pager.dispatch", shb.apply_split_factor,
                       self._pages_raw, self.local_bits, *split)
            return
        if self.qubit_count > 31:
            raise NotImplementedError(
                "this diagonal op lacks a split-index form for >31-qubit "
                "pagers (see the `split=` forms in engines/qengine.py)")

        def factor(page, idx):
            return fn(gk.plane_where(page), idx)

        self._pass("pager.dispatch", shb.apply_factor, self._pages_raw,
                   self.local_bits, factor, self._index_dtype())

    def _k_gather(self, src_fn, split=None) -> None:
        # basis permutations are written against logical bit order
        self._unmap()
        if self._wide_alu:
            if split is None:
                raise NotImplementedError(
                    "this basis permutation lacks a split-index form for "
                    ">31-qubit pagers (see ops/alu_kernels.py *_split)")
            self._pages_raw = self._pass("pager.exchange", shb.gather_ring,
                                         self._pages_raw, self.local_bits,
                                         *split)
            return
        L, dt = self.local_bits, self._index_dtype()

        def body(xp, pid, lidx, L_):
            src = src_fn(lidx.to(dt) + (pid << L))
            return src >> L, src & ((1 << L) - 1)

        # the JAX pager's one-program gather below 32 qubits is a
        # pager.dispatch program (its split form, above, pager.exchange)
        self._pages_raw = self._pass("pager.dispatch", shb.gather_ring,
                                     self._pages_raw, L, body, ())

    def _k_out_of_place(self, src_idx, dst_idx, passthrough_cmask) -> None:
        if self.qubit_count > 31:
            # every public op routes through a split-index gather form
            # past 31 qubits (MUL/DIV and *ModNOut included); reaching
            # this scatter wide means a new op needs its own
            raise NotImplementedError("see the `split=` gather forms")
        self._unmap()
        self._pages_raw = self._pass("pager.dispatch", self._out_of_place,
                                     self._pages_raw, src_idx, dst_idx,
                                     passthrough_cmask)

    def _out_of_place(self, old, src_idx, dst_idx, passthrough_cmask):
        """The scatter new[dst] = old[src] into new pages.  Over page homes
        each rank builds its own new pages from the old ket gathered onto
        every rank (sharded.all_gather_pages)."""
        L = self.local_bits
        lbits = (1 << L) - 1
        src = torch.as_tensor(src_idx).to("cpu", torch.int64).reshape(-1)
        dst = torch.as_tensor(dst_idx).to("cpu", torch.int64).reshape(-1)
        whole = (shb.all_gather_pages(old, self.device) if shb.spread(old)
                 else None)

        def src_page(sp):
            if whole is None:
                return old[sp]
            return whole[:, sp << L:(sp + 1) << L]

        if passthrough_cmask is None:
            new = [pg if shb.is_remote(pg) else torch.zeros_like(pg)
                   for pg in old]
        else:
            # amplitudes outside the control subspace keep their values
            cm = int(passthrough_cmask)
            new = [pg if shb.is_remote(pg) else pg.clone() for pg in old]
            shb.apply_factor(new, L, lambda pg, idx: (
                ((idx & cm) != cm).to(gk.compute_dtype(pg.dtype)), 0.0),
                self._index_dtype())
        dpage, spage = dst >> L, src >> L
        for dp in range(len(old)):
            if shb.is_remote(new[dp]):
                continue
            sel = dpage == dp
            if not bool(sel.any()):
                continue
            d_l, s, s_pg = dst[sel] & lbits, src[sel] & lbits, spage[sel]
            dev = new[dp].device
            for sp in range(len(old)):
                take = s_pg == sp
                if not bool(take.any()):
                    continue
                held = src_page(sp)
                vals = held[:, s[take].to(held.device)]
                new[dp][:, d_l[take].to(dev)] = vals.to(dev)
        return new

    def _index_table(self, values):
        return torch.as_tensor(np.asarray(values, dtype=np.int64)).to(
            self.device, self._index_dtype())

    # ------------------------------------------------------------------
    # measurement
    # ------------------------------------------------------------------

    def _k_probs(self) -> np.ndarray:
        self._settle()
        if self._map_nonid() or self._on_cluster:
            planes = self._fetch(0, 1 << self.qubit_count)
            return planes[0] ** 2 + planes[1] ** 2
        return self._pass("pager.dispatch", lambda pages: np.concatenate([
            gk.probs(page).to("cpu", torch.float64).numpy()
            for page in pages]), self._pages_raw)

    def ProbParity(self, mask: int) -> float:
        """P(odd parity) of the masked bits, page by page on the pages'
        devices (the interface's form reads the whole ket to the host:
        128 GiB of float64 at 33 qubits).  Parity is invariant under the
        placement table, so the mask translates bit for bit."""
        self._settle()
        if self._map_nonid():
            mask, _ = self._map_mask(mask, 0)
        p = self._pass("pager.dispatch", shb.prob_parity, self._pages_raw,
                       self.local_bits, mask)
        return min(max(p, 0.0), 1.0)

    def ProbMaskAll(self, mask: int) -> np.ndarray:
        """The distribution over the masked bits' values, binned page by
        page on the pages' devices (the interface's form reads the whole
        ket to the host; IndexedLDA/ADC/SBC return its expectation)."""
        self._settle()
        bits = [self._qmap[q] for q in range(self.qubit_count)
                if (mask >> q) & 1]
        return self._pass("pager.dispatch", shb.prob_bits_all,
                          self._pages_raw, self.local_bits, bits)

    def _k_prob_mask(self, mask, perm) -> float:
        self._settle()
        if self._map_nonid():
            mask, perm = self._map_mask(mask, perm)
        p = self._pass("pager.dispatch", shb.prob_mask, self._pages_raw,
                       *self._split(mask, perm))
        p = self._host_read(float, p)
        return min(max(p, 0.0), 1.0)

    def _k_collapse(self, mask, val, nrm_sq) -> None:
        self._settle()
        if self._map_nonid():
            mask, val = self._map_mask(mask, val)
        self._pass("pager.dispatch", shb.collapse, self._pages_raw,
                   *self._split(mask, val), gk._rsqrt(nrm_sq, self.dtype))

    def _draw_in_page(self, page, u: float) -> int:
        """One categorical draw over a page's |amp|^2 (float64) at the
        uniform `u`, as ``rng.choice_from_probs(p, 1)`` draws, block by
        block on the page's device (on the card, gatekernels.draw_index):
        no page reaches the host."""
        if page.device.type == "cuda":
            # a cumsum on the card does not repeat its rounding: the
            # level-by-level draw of gatekernels.draw_index does
            return gk.draw_index(page, u)
        blocks = list(shb._blocks((page.shape[-1],)))

        def p64(blk):
            v = page[:, blk[0]].to(torch.float64)
            return v[0] ** 2 + v[1] ** 2

        sums = [float(p64(b).sum()) for b in blocks]
        total = float(np.sum(sums))
        if len(blocks) == 1:
            cdf = torch.cumsum(p64(blocks[0]), 0)
            cdf = cdf / cdf[-1]
            got = int(torch.searchsorted(
                cdf, torch.tensor([u], dtype=torch.float64,
                                  device=cdf.device), right=True)[0])
            return min(got, page.shape[-1] - 1)
        target = u * total
        prefix = 0.0
        for b, blk in enumerate(blocks):
            if prefix + sums[b] > target or b == len(blocks) - 1:
                cdf = prefix + torch.cumsum(p64(blk), 0)
                got = int(torch.searchsorted(
                    cdf, torch.tensor([target], dtype=torch.float64,
                                      device=cdf.device), right=True)[0])
                start = blk[0].indices(page.shape[-1])[0]
                return min(start + got, page.shape[-1] - 1)
            prefix += sums[b]
        raise AssertionError("unreachable")

    def MAll(self) -> int:
        """Two-stage sample: the page marginals, then a draw in the
        chosen page.  The draw runs in PHYSICAL order (the marginals are
        physical) and the result translates back through the table.
        Across processes every rank picks the page from the same
        all-reduced marginals and consumes the same uniform; the page's
        owner draws and broadcasts the index, so every rng stays in
        step."""
        self._settle()
        page_probs = np.asarray(
            self._pass("pager.dispatch", shb.page_probs, self._pages_raw),
            dtype=np.float64)
        page = int(self.rng.choice_from_probs(page_probs, 1)[0])
        L = self.local_bits
        u = float(self.rng.uniform(1)[0])
        sub = self._host_read(self._draw_page, page, u)
        result = self._unmap_index((page << L) | sub)
        self.SetPermutation(result)
        return result

    def _draw_page(self, page: int, u: float) -> int:
        """The in-page index of MAll's draw: the page's owner draws it and,
        over page homes, broadcasts it to every rank."""
        held = self._pages_raw[page]
        sub = None if shb.is_remote(held) else self._draw_in_page(held, u)
        if self._on_cluster:
            sub = _cluster.broadcast_int(
                sub, held.rank if shb.is_remote(held) else self._rank)
        return sub

    def _k_normalize(self, nrm_sq) -> None:
        self._settle()
        s = gk._rsqrt(nrm_sq, self.dtype)

        def scale(pages):
            for _p, page in shb.local_pages(pages):
                page.mul_(s)

        self._pass("pager.dispatch", scale, self._pages_raw)

    def _k_sum_sqr_diff(self, other) -> float:
        self._unmap()
        L = self.local_bits
        if (isinstance(other, QPager) and other.n_pages == self.n_pages
                and other.homes == self.homes):
            other._unmap()
            theirs = other._pages_raw
        else:
            st = np.asarray(other.GetQuantumState()).reshape(-1)
            theirs = [st[p << L:(p + 1) << L] for p in range(self.n_pages)]
        nb = shb._n_blocks(1 << L)
        parts = np.zeros((self.n_pages, nb, 2), dtype=np.float64)
        for p, a in shb.local_pages(self._pages_raw):
            b = theirs[p]
            for k, blk in enumerate(shb._blocks((a.shape[-1],))):
                x = a[:, blk[0]]
                if isinstance(b, torch.Tensor):
                    y = b[:, blk[0]].to(x.device, x.dtype)
                else:
                    y = gk.to_planes(b[blk[0]], x.dtype, x.device)
                parts[p, k, 0] = float(torch.sum(x[0] * y[0] + x[1] * y[1]))
                parts[p, k, 1] = float(torch.sum(x[0] * y[1] - x[1] * y[0]))
        parts = shb.sum_ranks(self._pages_raw, parts)
        re = im = 0.0
        for p in range(self.n_pages):
            for k in range(nb):
                re += float(parts[p, k, 0])
                im += float(parts[p, k, 1])
        return max(0.0, 1.0 - (re * re + im * im))

    # ------------------------------------------------------------------
    # structure: the page count shrinks below a width and grows back
    # (reference: SeparateEngines/CombineEngines, src/qpager.cpp:316-367)
    # ------------------------------------------------------------------

    def _desired_g(self, new_width: int) -> int:
        return min(self._max_g, max(new_width, 0))

    def _mesh_would_change(self, new_width: int) -> bool:
        return self._desired_g(new_width) != self.g_bits

    def _pages_for(self, qubit_count: int) -> None:
        """Set the page count for a new width (drop pages when the ket
        gets smaller than the page count, re-grow to the construction
        count when it recovers)."""
        new_g = self._desired_g(qubit_count)
        if new_g != self.g_bits:
            self.n_pages = 1 << new_g
            self.g_bits = new_g
            self._slots = self._device_pool()[:self.n_pages]
        if qubit_count - self.g_bits > MAX_PAGE_QB:
            raise MemoryError(
                f"QPager page width {qubit_count - self.g_bits} exceeds a "
                "single page; add pages or stack QUnit above")

    def _place_host(self, state, qubit_count: int) -> None:
        """Pages from a host complex ket of `qubit_count` qubits (page
        count re-chosen for the width); identity table.  Over page homes
        the host ket is the same on every rank, which fills its own
        pages."""
        self._pages_for(qubit_count)
        st = np.asarray(state).reshape(-1)
        L = qubit_count - self.g_bits
        self._pages_raw = None
        self._pages = self._new_pages(L, lambda p, dev: gk.to_planes(
            st[p << L:(p + 1) << L], self.dtype, dev))
        self._map_reset(qubit_count)

    def _k_compose(self, other, start) -> None:
        from ..utils.states import compose_states

        self._settle()
        n1, n2 = self.qubit_count, other.qubit_count
        if self._mesh_would_change(n1 + n2):
            # a ket below the page count (tiny): host-stage the regrow
            a = self._fetch(0, 1 << n1)
            full = compose_states(a[0] + 1j * a[1],
                                  np.asarray(other.GetQuantumState()),
                                  n1, n2, start)
            self._place_host(full, n1 + n2)
            return
        self._unmap()  # the ring decodes logical indices
        if isinstance(other, QPager):
            # the other ket on every rank (gathered over its page homes)
            other._unmap()
            b = shb.all_gather_pages(other._pages, self.device)
        else:
            b = gk.to_planes(np.asarray(other.GetQuantumState()), self.dtype,
                             "cpu")
        self._pages = self._pass("pager.exchange", shb.compose_ring,
                                 self._pages_raw, b, self.local_bits, start,
                                 n1, n2)
        self._map_reset(n1 + n2)

    def _span_local(self, start: int, length: int) -> int:
        """Bring logical qubits [start, start + length) onto contiguous
        in-page bits (after _unmap), by one remap when they touch a page
        bit; returns the physical position of `start`.  The table is
        left describing the result."""
        L = self.local_bits
        if start + length <= L:
            return start
        qmap = list(self._qmap)
        qinv = list(self._qinv)
        swaps = []
        for i in range(length):
            q, t = start + i, L - length + i
            p = qmap[q]
            if p == t:
                continue
            o = qinv[t]
            swaps.append((t, p))
            qmap[q], qmap[o] = t, p
            qinv[t], qinv[p] = q, o
        self._apply_swaps(swaps)
        self._map_assign(qmap)
        return L - length

    def _rest_map(self, start: int, length: int, s: int) -> List[int]:
        """The table of the remainder when logical [start, start+length)
        leave from physical [s, s + length)."""
        out = []
        for q, p in enumerate(self._qmap):
            if start <= q < start + length:
                continue
            out.append(p if p < s else p - length)
        return out

    def _split_pages(self, start: int, length: int, perm):
        """(remainder pages, dest planes or None, rest table): the span's
        state from the dominant remainder branch (the host oracle's
        convention, gatekernels.split_matrix), the remainder its exact
        projection; with `perm`, the remainder is the span's |perm>
        slice, normalized.  Over page homes each rank splits its own
        pages; the norm and the dominant branch are read over every rank
        (float64 page values in page order), and the branch's owner
        broadcasts the span's state."""
        s = self._span_local(start, length)
        L = self.local_bits
        hi, mid, lo = 1 << (L - s - length), 1 << length, 1 << s
        pages = self._pages_raw
        views = [None if shb.is_remote(pg) else pg.view(2, hi, mid, lo)
                 for pg in pages]
        rest = self._rest_map(start, length, s)

        def left(pg):
            return shb.RemotePage(pg.rank, (2, hi * lo), pg.dtype)

        if perm is not None:
            rem = [left(pg) if v is None
                   else v[:, :, perm, :].reshape(2, -1).contiguous()
                   for pg, v in zip(pages, views)]
            part = np.zeros(len(rem), dtype=np.float64)
            for p, r in shb.local_pages(rem):
                part[p] = float(torch.sum(r[0] ** 2 + r[1] ** 2))
            nrm2 = sum(float(x) for x in shb.sum_ranks(pages, part))
            scale = 1.0 / math.sqrt(max(nrm2, 1e-30))
            for _p, r in shb.local_pages(rem):
                r.mul_(scale)
            return rem, None, rest
        # the dominant branch: the largest remainder probability, ties to
        # the lowest LOGICAL remainder index
        pms = [None if v is None
               else torch.sum(v[0] ** 2 + v[1] ** 2, dim=1).reshape(-1)
               for v in views]
        tops = np.zeros(len(pages), dtype=np.float64)
        for p, pm in enumerate(pms):
            if pm is not None:
                tops[p] = float(pm.max())
        best = max(float(x) for x in shb.sum_ranks(pages, tops))
        # each page's lowest logical index at the best (-1: none), read
        # over every rank
        first = np.zeros(len(pages), dtype=np.float64)
        identity = rest == list(range(len(rest)))
        shift = torch.tensor(rest, dtype=torch.int64)
        weight = torch.tensor([1 << q for q in range(len(rest))],
                              dtype=torch.int64)
        for p, pm in enumerate(pms):
            if pm is None:
                continue
            hits = (pm == best).nonzero().squeeze(-1).to("cpu", torch.int64)
            if not len(hits):
                first[p] = -1.0
                continue
            if identity:
                hits = hits[:1]   # in logical order a page's first hit
            phys = (p << (L - length)) | hits
            logical = (((phys.view(-1, 1) >> shift) & 1) * weight).sum(1)
            first[p] = float(logical.min())
        logical = int(min(x for x in shb.sum_ranks(pages, first) if x >= 0))
        phys = 0
        for q, pos in enumerate(rest):
            if (logical >> q) & 1:
                phys |= 1 << pos
        p0, r0 = phys >> (L - length), phys & ((1 << (L - length)) - 1)
        h0, l0 = divmod(r0, lo)
        dest = None
        if pms[p0] is not None:
            nrm = math.sqrt(max(float(pms[p0][r0]), 1e-30))
            dest = views[p0][:, h0, :, l0] / nrm          # (2, mid)
        if shb.spread(pages):
            owner = (pages[p0].rank if shb.is_remote(pages[p0])
                     else self._rank)
            dest = _cluster.broadcast_tensor(dest, owner, (2, mid),
                                             self.dtype, self.device)
        rem = []
        for pg, v in zip(pages, views):
            if v is None:
                rem.append(left(pg))
                continue
            dv = dest.to(v.device)
            a_r, a_i = v[0], v[1]
            rr = (torch.einsum("hml,m->hl", a_r, dv[0])
                  + torch.einsum("hml,m->hl", a_i, dv[1]))
            ri = (torch.einsum("hml,m->hl", a_i, dv[0])
                  - torch.einsum("hml,m->hl", a_r, dv[1]))
            rem.append(torch.stack([rr, ri]).reshape(2, -1).to(self.dtype))
        return rem, dest, rest

    def _host_split(self, start, length, perm):
        """Host-staged split (the page count shrinks: tiny kets)."""
        n = self.qubit_count
        planes = self._fetch(0, 1 << n)
        hi, mid, lo = 1 << (n - start - length), 1 << length, 1 << start
        a = (planes[0] + 1j * planes[1]).reshape(hi, mid, lo)
        if perm is not None:
            rem = a[:, perm, :].reshape(-1)
            dest = None
        else:
            at = a.transpose(1, 0, 2).reshape(mid, hi * lo)
            pm = (np.abs(at) ** 2).sum(axis=0)
            f0 = int(np.argmax(pm))
            dest = at[:, f0] / math.sqrt(max(pm[f0], 1e-300))
            rem = np.einsum("mr,m->r", at, np.conj(dest))
        nrm = np.linalg.norm(rem)
        if nrm > 0:
            rem = rem / nrm
        self._place_host(rem, n - length)
        return dest

    def _k_decompose(self, start, length) -> np.ndarray:
        self._unmap()
        n = self.qubit_count
        if self._mesh_would_change(n - length):
            return self._host_split(start, length, None)
        rem, dest, rest = self._pass("pager.dispatch", self._split_pages,
                                     start, length, None)
        self._pages = rem
        self._map_assign(rest)
        d = dest.to("cpu", torch.float64).numpy()
        vec = d[0] + 1j * d[1]
        nrm = np.linalg.norm(vec)
        return vec / nrm if nrm > 0 else vec

    def _k_dispose(self, start, length, perm) -> None:
        self._unmap()
        n = self.qubit_count
        if self._mesh_would_change(n - length):
            self._host_split(start, length, perm)
            return
        rem, _dest, rest = self._pass("pager.dispatch", self._split_pages,
                                      start, length, perm)
        self._pages = rem
        self._map_assign(rest)

    def _k_allocate(self, start, length) -> None:
        self._unmap()
        n = self.qubit_count
        if self._mesh_would_change(n + length):
            a = self._fetch(0, 1 << n)
            zeros = np.zeros(1 << length, dtype=np.complex128)
            zeros[0] = 1.0
            from ..utils.states import compose_states

            self._place_host(compose_states(a[0] + 1j * a[1], zeros, n,
                                            length, start), n + length)
            return
        L = self.local_bits
        at = min(start, L)   # new qubits enter at or below the page bits
        hi, lo = 1 << (L - at), 1 << at
        grown = []
        for pg in self._pages_raw:
            if shb.is_remote(pg):
                grown.append(shb.RemotePage(pg.rank, (2, (1 << L) << length),
                                            pg.dtype))
                continue
            new = torch.zeros((2, hi, 1 << length, lo), dtype=pg.dtype,
                              device=pg.device)
            new[:, :, 0, :] = pg.view(2, hi, lo)
            grown.append(new.reshape(2, -1))
        self._pages = grown
        qmap = []
        for q in range(n + length):
            if q < at:
                qmap.append(q)
            elif q < start:           # page qubits below the new ones
                qmap.append(q + length)
            elif q < start + length:  # the new qubits
                qmap.append(at + q - start)
            else:
                qmap.append(q)
        self._map_assign(qmap)

    # ------------------------------------------------------------------
    # elastic re-paging: on a device failure, halve the page count and
    # keep serving on the card; at a later call boundary (health probe),
    # grow back.  Distinct from _pages_for's width-driven rebalance:
    # these moves are fault-driven and move the page-count CEILING
    # (_max_g).  Every re-page runs on the card (the JAX pager gathers
    # the ket to the host and puts it back); over page homes the blocks
    # that change process move through the transport.
    # ------------------------------------------------------------------

    @property
    def elastic_degraded(self) -> bool:
        return self._elastic_target_g is not None

    def _device_pool(self) -> List[int]:
        """Slot preference order for (re-)paging: the construction slots,
        then the spares, with integrity-quarantined slots excluded — so a
        quarantined slot is replaced by a spare at the next re-page.  A
        fully quarantined list still serves (the construction order)."""
        slots = list(range(len(self._slot_devices)))
        if not _res._ACTIVE:
            return slots
        from ..resilience import integrity as _integ

        q = _integ.quarantined()
        if not q:
            return slots
        pool = [sl for sl in slots if sl not in q]
        return pool if pool else slots

    def can_shrink(self) -> bool:
        """True when a 2^g -> 2^(g-1) re-page is possible: more than one
        page left and the doubled page still fits MAX_PAGE_QB."""
        return (self.n_pages > 1
                and (self.qubit_count - (self.g_bits - 1)) <= MAX_PAGE_QB)

    def shrink_pages(self) -> "QPager":
        """Re-page from 2^g to 2^(g-1) pages on the card, in place.  A
        pending window stays pending when a flush is re-dispatching it,
        and runs (raw, under the fault suspension) otherwise."""
        if not self.can_shrink():
            raise MemoryError(
                f"QPager cannot shrink below {self.n_pages} page(s) at "
                f"width {self.qubit_count}")
        new_g = self.g_bits - 1
        if self._elastic_target_g is None:
            self._elastic_target_g = self._max_g
        self._repage(new_g)
        self._max_g = new_g
        if _tele._ENABLED:
            # event() bumps the same-named counter itself
            _tele.event("elastic.repage.shrink", pages=self.n_pages,
                        target_pages=1 << self._elastic_target_g)
            _tele.gauge("elastic.pages", self.n_pages)
        return self

    def _repage(self, new_g: int) -> None:
        """Re-split the ket over 2^new_g pages on the slots of
        _device_pool (its prefix, as the JAX pager takes), on the card:
        identity placement first, then each new page is its old pages
        side by side (fewer pages) or a copy of a slice of one (more
        pages); a page that keeps its size and device moves without a
        copy, and one whose old pages live in another process comes
        through the transport (sharded.repage).  The new pages are built
        in locals and committed last, so a failed re-page leaves the
        current topology untouched (at the cost of both layouts at
        once)."""
        with _res.faults.suspended():
            # the unmap's exchanges must not advance fault-spec counters
            # nor be refused by an open breaker
            self._unmap()
        slots = self._device_pool()[:1 << new_g]
        new = shb.repage(self._pages_raw, self.local_bits,
                         [self._home_of(sl) for sl in slots],
                         self.qubit_count - new_g)
        self.n_pages = 1 << new_g
        self.g_bits = new_g
        self._slots = slots
        self._pages_raw = new
        self._map_reset()

    def expand_pages(self) -> bool:
        """Grow back toward the construction page count.  True on success
        (or when already healthy); on failure the pager STAYS
        degraded-but-serving at its current size and returns False."""
        target = self._elastic_target_g
        if target is None:
            return True
        if _res._ACTIVE:
            # quarantine caps recovery: never expand onto more pages
            # than the healthy pool (spares included) can host
            target = min(target, log2(max(1, len(self._device_pool()))))
        self._max_g = target
        new_g = self._desired_g(self.qubit_count)
        try:
            if new_g != self.g_bits:
                self._repage(new_g)
        except Exception:  # noqa: BLE001 — stay degraded, keep serving
            self._max_g = self.g_bits
            if _tele._ENABLED:
                _tele.inc("elastic.repage.expand_failed")
                _tele.gauge("elastic.pages", self.n_pages)
            return False
        self._elastic_target_g = None
        if _tele._ENABLED:
            _tele.event("elastic.repage.expand", pages=self.n_pages)
            _tele.gauge("elastic.pages", self.n_pages)
        return True

    def _quarantine_repage(self) -> bool:
        """Move the ket OFF freshly quarantined slots at a call boundary:
        re-page at the SAME page count when the healthy pool (spares
        included) still covers it, else shrink a level and keep
        serving."""
        pool = self._device_pool()
        if len(pool) >= self.n_pages:
            try:
                self._repage(self.g_bits)
            except Exception:  # noqa: BLE001 — stay on current topology
                if _tele._ENABLED:
                    _tele.inc("integrity.quarantine.repage_failed")
                return False
            if _tele._ENABLED:
                _tele.event("integrity.quarantine.repage",
                            pages=self.n_pages)
            return True
        if self.can_shrink():
            self.shrink_pages()
            if _tele._ENABLED:
                _tele.event("integrity.quarantine.shrink",
                            pages=self.n_pages)
            return True
        if _tele._ENABLED:
            _tele.inc("integrity.quarantine.repage_failed")
        return False

    def maybe_reexpand(self) -> bool:
        """Call-boundary hook (ResilientEngine / QHybrid): expand when
        degraded AND the health probe passes.  One attribute test when
        healthy.  Also the integrity quarantine consumer: when the
        quarantine epoch moved and a page sits on a quarantined slot,
        re-page off it first (returns False for that alone)."""
        if _res._ACTIVE:
            from ..resilience import integrity as _integ

            ep = _integ._EPOCH
            if ep != self._quarantine_epoch:
                self._quarantine_epoch = ep
                q = _integ.quarantined()
                if q and any(sl in q for sl in self._slots):
                    self._quarantine_repage()
        if self._elastic_target_g is None:
            return False
        from ..resilience import elastic as _elastic

        if not _elastic.health_probe(cohort=self._on_cluster):
            return False
        return self.expand_pages()

    # ------------------------------------------------------------------
    # lossy checkpoints: per-page streams staged through the host one
    # page at a time (reference: src/qpager_turboquant.cpp:24-45)
    # ------------------------------------------------------------------

    def LossySaveStateVector(self, path: str, bits: int = 8,
                             block_pow: int = 12) -> None:
        import json

        from ..checkpoint.container import save_container
        from ..storage.turboquant import _npz_path, quantize_blocks

        L = self.local_bits
        arrays = {}
        for p in range(self.n_pages):
            page = self.GetAmplitudePage(p << L, 1 << L)
            scales, codes, _n = quantize_blocks(page, bits=bits,
                                                block_pow=block_pow)
            arrays[f"scales_{p}"] = scales
            arrays[f"codes_{p}"] = codes
        meta = {"format": "qpager-turboquant-v2", "bits": bits,
                "qubit_count": self.qubit_count, "n_pages": self.n_pages,
                "page_len": 1 << L, "device_ids": self.GetDeviceList()}
        arrays["meta"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
        save_container(_npz_path(path), arrays, meta=meta,
                       kind="qpager-turboquant")

    def LossyLoadStateVector(self, path: str) -> None:
        import json

        from ..checkpoint.container import load_container
        from ..storage.turboquant import (_npz_path, dequantize_blocks,
                                          dequantize_blocks_v1, lossy_load)

        kind, meta, z = load_container(_npz_path(path), legacy_ok=True)
        if kind is None and "meta" in z:
            meta = json.loads(bytes(z["meta"]).decode())
            kind = "qpager-turboquant"
        if kind not in ("qpager-turboquant", None, "turboquant-lossy-ket"):
            raise ValueError(f"unsupported QPager checkpoint kind {kind!r}")
        if kind != "qpager-turboquant":
            self.SetQuantumState(lossy_load(path))  # whole-ket archive
            return
        fmt = meta.get("format")
        if fmt == "qpager-turboquant-v1":
            decode = dequantize_blocks_v1
        elif fmt == "qpager-turboquant-v2":
            decode = dequantize_blocks
        else:
            raise ValueError(f"unsupported QPager checkpoint format {fmt!r}")
        if meta["qubit_count"] != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        plen = meta["page_len"]
        if meta["n_pages"] * plen != (1 << self.qubit_count):
            raise ValueError("checkpoint page layout inconsistent")
        total = 0.0
        for i in range(meta["n_pages"]):
            # raw magnitudes: the stored scales carry each page's weight,
            # so one global renormalization runs; offsets are
            # checkpoint-relative, so another page count loads the ket
            page = decode(z[f"scales_{i}"], z[f"codes_{i}"], plen,
                          meta["bits"], normalize=False)
            total += float(np.sum(np.abs(page) ** 2))
            self.SetAmplitudePage(page, i * plen)
        if total > 0:
            self._k_normalize(total)

    # ------------------------------------------------------------------
    # state access (host boundary)
    # ------------------------------------------------------------------

    def _host_unpermute(self, planes: np.ndarray) -> np.ndarray:
        """Reorder a full-ket host array from physical to logical bit
        order — a pure axis transpose."""
        n = self.qubit_count
        lead = planes.shape[0]
        a = np.asarray(planes).reshape((lead,) + (2,) * n)
        axes = [0] * (n + 1)
        for l in range(n):
            # index bit b lives on axis (n - b); logical bit l reads from
            # physical bit _qmap[l]
            axes[n - l] = n - self._qmap[l]
        return np.ascontiguousarray(np.transpose(a, axes)).reshape(lead, -1)

    def _fetch(self, offset: int, length: int, raw: bool = False) -> np.ndarray:
        """(2, length) host planes window, float64, in LOGICAL bit order
        (``raw=True`` reads the physical layout as stored).  Under a
        non-identity table a full-ket read unpermutes on the host, a
        single amplitude translates its index, and any other window
        restores logical order first."""
        self._settle()
        if not raw and self._map_nonid():
            if offset == 0 and length == (1 << self.qubit_count):
                return self._host_unpermute(self._fetch(0, length, raw=True))
            if length == 1:
                return self._fetch(self._map_index(offset), 1, raw=True)
            self._unmap()
        if _tele._ENABLED:
            _tele.inc("exchange.pager.host_fetch")
            _tele.inc("exchange.pager.host_fetch_bytes",
                      2 * length * self.dtype.itemsize)
        return self._host_read(self._read_window, offset, length)

    def _read_window(self, offset: int, length: int) -> np.ndarray:
        return shb.replicated_window(self._pages_raw, self.local_bits,
                                     offset, length, shared=self._on_cluster)

    def GetQuantumState(self) -> np.ndarray:
        planes = self._fetch(0, 1 << self.qubit_count)
        return planes[0] + 1j * planes[1]

    def SetQuantumState(self, state) -> None:
        st = np.asarray(state).reshape(-1)
        if st.shape[0] != (1 << self.qubit_count):
            raise ValueError("state length mismatch")
        self._place_host(st, self.qubit_count)

    def GetAmplitude(self, perm: int) -> complex:
        amp = self._fetch(perm, 1)
        return complex(amp[0, 0], amp[1, 0])

    def SetAmplitude(self, perm: int, amp: complex) -> None:
        amp = complex(amp)
        self._settle()
        perm = self._map_index(perm) if self._map_nonid() else perm
        L = self.local_bits
        page = self._pages_raw[perm >> L]
        if shb.is_remote(page):
            return   # its owner writes it
        i = perm & ((1 << L) - 1)
        page[0, i] = amp.real
        page[1, i] = amp.imag

    def SetPermutation(self, perm: int, phase=None) -> None:
        ph = self._rand_phase() if phase is None else complex(phase)
        if self._fuser is not None:
            self._fuser.drop()   # blind overwrite
        L = self.local_bits
        old = self._pages_raw
        if (old is not None and len(old) == self.n_pages
                and all(pg.shape[-1] == 1 << L and pg.dtype == self.dtype
                        and (shb.is_remote(pg) or pg.device == dev)
                        for pg, dev in zip(old, self.devices))):
            for _p, pg in shb.local_pages(old):
                pg.zero_()       # reuse the planes: no second ket
        else:
            self._pages_raw = None
            self._pages_raw = self._new_pages(L)
        self._map_reset()
        page = self._pages_raw[perm >> L]
        self.running_norm = 1.0
        if shb.is_remote(page):
            return   # its owner writes the amplitude
        page[0, perm & ((1 << L) - 1)] = ph.real
        page[1, perm & ((1 << L) - 1)] = ph.imag

    def _like(self, init_state=None) -> "QPager":
        return QPager(self.qubit_count, init_state=init_state,
                      n_pages=self.n_pages, devices=self.homes or self.devices,
                      dtype=self.dtype, remap=self._remap,
                      collective=self._collective, dcn_bits=self._dcn_bits,
                      rng=self.rng.spawn(),
                      do_normalize=self.do_normalize,
                      rand_global_phase=self.rand_global_phase)

    def Clone(self) -> "QPager":
        self._settle()
        c = self._like(init_state=None)
        c._pages = [pg if shb.is_remote(pg) else pg.clone()
                    for pg in self._pages_raw]
        c._map_assign(self._qmap)  # the physical copy carries the table
        return c

    def CloneEmpty(self) -> "QPager":
        return self._like(init_state=0)

    def Finish(self) -> None:
        self._settle()   # the pending window runs first
        for _p, pg in shb.local_pages(self._pages_raw):
            if pg.device.type == "cuda":
                torch.cuda.synchronize(pg.device)

    def GetDeviceList(self):
        return [d.index if d.type == "cuda" else -1 for d in self.devices]

    def ZeroAmplitudes(self) -> None:
        self._settle()
        for _p, pg in shb.local_pages(self._pages_raw):
            pg.zero_()
        self._map_reset()

    def IsZeroAmplitude(self) -> bool:
        pages = self._pages
        here = any(bool(torch.any(pg != 0))
                   for _p, pg in shb.local_pages(pages))
        return not shb.sum_ranks(pages, np.asarray([float(here)]))[0]

    def GetAmplitudePage(self, offset: int, length: int) -> np.ndarray:
        planes = self._fetch(offset, length)
        return planes[0] + 1j * planes[1]

    def SetAmplitudePage(self, page, offset: int) -> None:
        self._unmap()  # the window writes at logical offsets
        vals = np.asarray(page).reshape(-1)
        L = self.local_bits
        pos, end = offset, offset + len(vals)
        while pos < end:
            p, i = pos >> L, pos & ((1 << L) - 1)
            take = min((1 << L) - i, end - pos)
            dst = self._pages_raw[p]
            if not shb.is_remote(dst):   # each rank writes its own pages
                dst[:, i:i + take] = gk.to_planes(
                    vals[pos - offset:pos - offset + take], self.dtype,
                    dst.device)
            pos += take

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py): the raw pages, host
    # one page per complex128 array.  Offsets on restore are
    # checkpoint-relative, so a pager with another page count loads the
    # same ket.
    # ------------------------------------------------------------------

    _ckpt_kind = "pager"

    def _ckpt_capture(self, capture_child):
        self._settle()
        L = self.local_bits
        arrays = {}
        for p in range(self.n_pages):
            # RAW (physical-layout) pages: capture must not dispatch an
            # unmap, and the table rides the meta instead
            planes = self._fetch(p << L, 1 << L, raw=True)
            arrays[f"page_{p}"] = planes[0] + 1j * planes[1]
        return {"kind": "pager",
                "meta": {"n": self.qubit_count,
                         "dtype": gk.dtype_name(self.dtype),
                         "n_pages": self.n_pages, "page_len": 1 << L,
                         "running_norm": float(self.running_norm),
                         "qmap": list(self._qmap)},
                "arrays": arrays}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        plen = int(meta["page_len"])
        if int(meta["n_pages"]) * plen != (1 << self.qubit_count):
            raise ValueError("checkpoint page layout inconsistent")
        qm = meta.get("qmap")
        if qm is not None and len(qm) != self.qubit_count:
            raise ValueError("checkpoint placement table inconsistent")
        self._settle()
        self._map_reset()  # pages land raw; the saved table re-attaches
        for i in range(int(meta["n_pages"])):
            self.SetAmplitudePage(np.asarray(arrays[f"page_{i}"],
                                             dtype=np.complex128), i * plen)
        if qm is not None:
            self._map_assign([int(x) for x in qm])
        self.running_norm = float(meta.get("running_norm", 1.0))
