"""QPagerTurboQuant: the block-compressed ket in pages over a list of
devices (counterpart of the JAX package's parallel/turboquant_pager.py).

Composes the two width stories (reference: StateVectorTurboQuant under
any engine consumer, include/statevector_turboquant.hpp:1-120):

* the resident state is the compressed engine's int8/int16 codes and
  float32 scales (engines/turboquant.py), one (codes, scales) pair per
  page: page p holds the chunks [p * C_l, (p + 1) * C_l) of the chunk
  axis, on a device of the list, which may name one card more than once
  (the JAX package shards one (B, 2D) array over a mesh; torch has no
  mesh, as in parallel/pager.py).  An int8 w32 ket is 8 GiB of codes,
  2 GiB a page on 4 pages;
* gates, diagonals, probabilities and the collapse run the compressed
  engine's plain chunk programs on every page, the chunk ids offset by
  the page's first chunk (the JAX package's ``_mk_*`` bodies under
  ``shard_map`` with ``cid0``).  As there, no kernel runs:
  ``_pallas_capable`` and ``_fuse_capable`` are False, so every gate is
  one chunk pass (K3-K5 stay single-engine);
* a gate whose target lies in the page bits mixes partner chunks of two
  pages (``_p_gate_pair_cross``: the pager's pair exchange, here on
  b-bit codes), a block of chunks at a time, in place;
* a chunk-aligned collapse stays a pure per-chunk scale update.

Pages in several processes (parallel/cluster.py): built over the
cluster's page homes (``devices=cluster.global_page_devices(G)``), each
process keeps the codes and scales of its own pages only (the others
are ``sharded.RemotePage`` placeholders).  Chunk passes run on the local
pages; the pair exchange moves the partner page's codes and scales
through ``sharded.transport`` and each rank keeps its own requantized
half; ``Prob``, the chunk masses (``MAll``, the norm) all-reduce in
float64, the chosen chunk's owner draws and broadcasts the index, and
block reads (``GetAmplitude``, the checkpoint's codes) come from the
page's owner to every rank.  The codes and scales lists are
``sharded.PageList`` s there, so every rank joins every collective.  The
dense float32 fallback decodes each rank's pages and gathers the planes
onto every rank (``sharded.all_gather_pages``), so Compose, Decompose,
Dispose, the ALU permutations and the failover to ``QEngineCUDA``
replicas run on every rank; narrowing below one chunk a page keeps a
prefix of the pages (on rank 0's slots first); the resilience plane's
guarded chunk passes agree on their outcome across the ranks
(resilience/dispatch.py ``cohort``).

Everything else (ALU permutations, compose/decompose, amplitude pages)
decodes the whole ket through the inherited ``_state`` property, sound
only up to MAX_DENSE_QB total qubits; past that the chunked op set
(gates, the split-index diagonals, probabilities, collapse, measurement,
SetPermutation, amplitude reads) is the whole surface, and the dense
fallback raises MemoryError saying so.

The pager runs on ``cuda`` unless the caller passes ``device="cpu"`` or
CPU devices (the tests do); without a GPU it raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..engines import turboquant as tqe
from ..ops import sharded as shb
from ..storage import turboquant as tq
from ..utils.bits import is_pow2, log2
from . import cluster as _cluster
from .pager import PageHomes, _device_list


class QPagerTurboQuant(PageHomes, tqe.QEngineCUDATurboQuant):
    """Compressed dense ket, one (codes, scales) pair a page."""

    # the kernels are single-engine; pages run the plain chunk programs
    _pallas_capable = False
    # gate-window fusion likewise: every gate is one chunk pass
    _fuse_capable = False
    _tele_name = "turboquant_pager"

    def __init__(self, qubit_count: int, init_state: int = 0, devices=None,
                 n_pages=None, device=None, **kwargs):
        devs = self._take_homes(_device_list(devices, device, n_pages))
        if n_pages is None:
            n_pages = 1 << log2(len(devs))
        if not is_pow2(n_pages):
            raise ValueError("n_pages must be a power of two")
        if n_pages > len(devs):
            raise ValueError(
                f"n_pages={n_pages} exceeds the device list ({len(devs)}); "
                "name a device once for each page (a device may repeat)")
        if qubit_count <= log2(n_pages):
            raise ValueError(
                f"width {qubit_count} too small for {n_pages} pages")
        self.n_pages = int(n_pages)
        self.g_bits = log2(n_pages)
        self._slot_devices = list(devs[:n_pages])
        super().__init__(qubit_count, init_state=init_state,
                         device=self._local_devices()[0], **kwargs)

    # ------------------------------------------------------------------
    # layout
    # ------------------------------------------------------------------

    @property
    def _slots(self):
        """A page's slot is its id (no spares)."""
        return range(self.n_pages)

    @property
    def _codes_raw(self):
        return self._code_pages

    @_codes_raw.setter
    def _codes_raw(self, pages) -> None:
        self._code_pages = self._page_list(pages)

    @property
    def _scales_raw(self):
        return self._scale_pages

    @_scales_raw.setter
    def _scales_raw(self, pages) -> None:
        self._scale_pages = self._page_list(pages)

    def _max_chunk_pow(self, qubit_count: int) -> int:
        # every page owns at least one chunk
        return max(1, qubit_count - self.g_bits)

    def _local_chunk_bits(self) -> int:
        return self.qubit_count - self._tq_chunk_pow - self.g_bits

    def _check_capacity(self, qubit_count: int) -> None:
        # the compressed cap of one device, times the pages
        cap = self._compressed_cap() + self.g_bits
        if qubit_count > cap:
            raise MemoryError(
                f"QPagerTurboQuant width {qubit_count} exceeds "
                f"{self.n_pages} pages' compressed capacity ({cap} at "
                f"{self._tq_bits}-bit codes); add pages or layer QUnit "
                "above")

    def _maybe_repage(self, width: int) -> None:
        """Dispose/Decompose can narrow the ket below one chunk a page:
        keep a prefix of the device list so every page holds a chunk
        (the pager's page-count policy under narrowing,
        src/qpager.cpp:89-292).  `width` is the NEW width."""
        want = min(self.n_pages, 1 << max(0, width - 1))
        if want == self.n_pages:
            return
        self.n_pages = want
        self.g_bits = log2(want)

    def _page_parts(self):
        """[(codes (C_l, cb, 2D), scales (C_l, cb), first chunk id)] a
        page, None for a page of another process."""
        C_l = self._n_chunks() // self.n_pages
        cb, twoD = self._chunk_blocks, 2 * self._block
        return [None if shb.is_remote(c) else
                (c.view(C_l, cb, twoD), s.view(C_l, cb), p * C_l)
                for p, (c, s) in enumerate(zip(self._codes, self._scales))]

    def _parts(self):
        """This process's pages as chunk-major parts."""
        return [part for part in self._page_parts() if part is not None]

    def _rows_per_page(self) -> int:
        return (1 << self.qubit_count) // self._block // self.n_pages

    def _block_home(self, b: int):
        R = self._rows_per_page()
        return self._codes[b // R], self._scales[b // R], b % R

    def GetDeviceList(self):
        return [d.index if d.type == "cuda" else -1 for d in self.devices]

    def resident_bytes(self) -> int:
        if self._codes_raw is None:
            return 0
        return sum(shb._page_bytes(c) + shb._page_bytes(s)
                   for c, s in zip(self._codes_raw, self._scales_raw))

    def resident_bytes_per_device(self) -> int:
        """Resident bytes of one page (every page holds as many)."""
        return self.resident_bytes() // self.n_pages

    # ------------------------------------------------------------------
    # compressed <-> float32 planes, page by page
    # ------------------------------------------------------------------

    def _compress_planes(self, planes) -> None:
        n_amps = planes.shape[-1]
        self._maybe_repage(int(round(math.log2(n_amps))))
        D, P = self._block, n_amps // self.n_pages
        codes, scales = [], []
        for p, dev in enumerate(self.devices):
            if not self._here(p):
                codes.append(self._remote_codes(p, P // D))
                scales.append(self._remote_scales(p, P // D))
                continue
            rows = tqe._planes_to_rows(
                planes[:, p * P:(p + 1) * P].to(dev, torch.float32), D)
            c, s = tqe._comp_rows(rows, self._rot_on(dev)[0], self._qmax,
                                  self._code_dt)
            codes.append(c)
            scales.append(s)
        self._codes = codes
        self._scales = scales
        self._note_resident()

    def _remote_codes(self, p: int, rows: int):
        return shb.RemotePage(self._slot_ranks[p], (rows, 2 * self._block),
                              self._code_dt)

    def _remote_scales(self, p: int, rows: int):
        return shb.RemotePage(self._slot_ranks[p], (rows,), torch.float32)

    def _decompress_planes(self):
        """The whole ket as float32 planes on this rank's device: each page
        decoded where it lives, the pages gathered onto every rank over
        page homes."""
        D = self._block
        planes = [shb.RemotePage(c.rank, (2, c.shape[0] * D), torch.float32)
                  if shb.is_remote(c) else
                  tqe._rows_to_planes(tqe._dec_rows(
                      c, s, self._rot_on(c.device)[1], self._qmax), D)
                  for c, s in zip(self._codes, self._scales)]
        return shb.all_gather_pages(self._page_list(planes), self._device)

    # ------------------------------------------------------------------
    # a gate whose target lies in the page bits
    # ------------------------------------------------------------------

    def _gate_pair(self, m, tb_pos: int, hm, hv, lm, lv) -> None:
        lcb = self._local_chunk_bits()
        if tb_pos < lcb:
            super()._gate_pair(m, tb_pos, hm, hv, lm, lv)
            return
        # the pair exchange: one guarded dispatch at its own site
        self._tq_call(self._gate_pair_cross, m, tb_pos - lcb, hm, hv, lm, lv,
                      site="turboquant_pager.exchange")

    def _gate_pair_cross(self, m, page_bit: int, hm, hv, lm, lv) -> None:
        """Pages p0 (page bit clear) and p1 = p0 | 2^page_bit mix chunk i
        with chunk i, a group of chunks at a time, in place; p1's group
        visits p0's device and comes back when the two lie apart
        (``_p_gate_pair_cross`` of the JAX package, its ppermute of the
        partner page's codes)."""
        if tqe._tele._ENABLED:
            # every page's codes and scales meet their partner's
            tqe._tele.inc("exchange.turboquant_pager.cross_gate")
            tqe._tele.inc("exchange.turboquant_pager.bytes",
                          self.resident_bytes())
        parts = self._page_parts()
        bit = 1 << page_bit
        g = self._group_size(2)
        for p0, part in enumerate(parts):
            if p0 & bit:
                continue
            if part is None or parts[p0 | bit] is None:
                self._cross_pair(m, parts, p0, p0 | bit, g, hm, hv, lm, lv)
                continue
            c3a, s2a, cid0 = part
            c3b, s2b, _ = parts[p0 | bit]
            dev = c3a.device
            lidx = self._lidx(dev)
            for i0 in range(0, c3a.shape[0], g):
                i1 = min(c3a.shape[0], i0 + g)
                rows_b = (c3b[i0:i1].to(dev), s2b[i0:i1].to(dev))
                (nca, nsa), (ncb, nsb) = self._mix_rows(
                    m, (c3a[i0:i1], s2a[i0:i1]), rows_b,
                    self._cids(cid0 + i0, cid0 + i1, dev), hm, hv, lm, lv,
                    lidx)
                c3a[i0:i1] = nca
                s2a[i0:i1] = nsa
                c3b[i0:i1] = ncb.to(c3b.device)
                s2b[i0:i1] = nsb.to(s2b.device)

    def _cross_pair(self, m, parts, p0: int, p1: int, g: int, hm, hv, lm,
                    lv) -> None:
        """The pair mix of pages p0 and p1 when one lives in another
        process: group by group the two ranks trade codes and scales
        through sharded.transport, both run the same mix and each keeps
        its own page's half (the JAX package's ppermute of the partner
        page and its jnp.where(is_a, ...))."""
        mine = p0 if parts[p0] is not None else p1
        if parts[mine] is None:
            return
        c3, s2, _ = parts[mine]
        peer = self._slot_ranks[p1 if mine == p0 else p0]
        dev = c3.device
        lidx = self._lidx(dev)
        C_l = c3.shape[0]
        for i0 in range(0, C_l, g):
            i1 = min(C_l, i0 + g)
            own = (c3[i0:i1], s2[i0:i1])
            other = (torch.empty_like(own[0]), torch.empty_like(own[1]))
            shb.transport([(own[0], peer), (own[1], peer)],
                          [(other[0], peer), (other[1], peer)])
            rows_a, rows_b = (own, other) if mine == p0 else (other, own)
            new = self._mix_rows(m, rows_a, rows_b,
                                 self._cids(p0 * C_l + i0, p0 * C_l + i1,
                                            dev), hm, hv, lm, lv, lidx)
            nc, ns = new[0] if mine == p0 else new[1]
            c3[i0:i1] = nc
            s2[i0:i1] = ns

    # ------------------------------------------------------------------
    # codes-native construction and block-local reads, per page
    # ------------------------------------------------------------------

    def SetPermutation(self, perm: int, phase=None) -> None:
        ph = self._rand_phase() if phase is None else complex(phase)
        D = self._block
        b, d = perm // D, perm % D
        row = ph.real * self._rot[d] + ph.imag * self._rot[D + d]
        scale = row.abs().max()
        safe = torch.where(scale > 0, scale, 1.0)
        row_codes = torch.round(row / safe * self._qmax).to(self._code_dt)
        # release the old ket before the new one is allocated
        self._codes = None
        self._scales = None
        R = self._rows_per_page()
        self._codes = [torch.zeros((R, 2 * D), dtype=self._code_dt,
                                   device=dev) if self._here(p)
                       else self._remote_codes(p, R)
                       for p, dev in enumerate(self.devices)]
        self._scales = [torch.zeros(R, dtype=torch.float32, device=dev)
                        if self._here(p) else self._remote_scales(p, R)
                        for p, dev in enumerate(self.devices)]
        self.running_norm = 1.0
        codes, scales, i = self._block_home(b)
        if shb.is_remote(codes):
            return   # its owner writes the block
        codes[i] = row_codes.to(codes.device)
        scales[i] = scale.to(scales.device)

    def _fetch_blocks(self, b0: int, nb: int):
        """Host (codes, scales) of blocks [b0, b0 + nb) on every rank: a
        page's rows come from the rank that owns it."""
        R = self._rows_per_page()
        cs, ss = [], []
        b = b0
        while b < b0 + nb:
            p, i = divmod(b, R)
            take = min(R - i, b0 + nb - b)
            cs.append(self._rows_of(self._codes[p], p, i, take))
            ss.append(self._rows_of(self._scales[p], p, i, take))
            b += take
        return (np.concatenate(cs).astype(np.float32),
                np.concatenate(ss).astype(np.float32))

    def _rows_of(self, arr, p: int, i: int, take: int) -> np.ndarray:
        """Rows [i, i + take) of page p's codes or scales on the host, sent
        by the page's owner to every rank of a spread pager."""
        mine = (None if shb.is_remote(arr)
                else arr[i:i + take].to("cpu").numpy())
        if not self._on_cluster:
            return mine
        dtype = {torch.int8: np.int8, torch.int16: np.int16,
                 torch.float32: np.float32}[arr.dtype]
        return _cluster.broadcast_bytes(mine, self._slot_ranks[p],
                                        (take,) + tuple(arr.shape[1:]), dtype)

    def _put_block(self, b: int, row, scale: float) -> None:
        if shb.is_remote(self._block_home(b)[0]):
            return   # its owner writes it
        super()._put_block(b, row, scale)

    def ZeroAmplitudes(self) -> None:
        self._codes = [c if shb.is_remote(c) else torch.zeros_like(c)
                       for c in self._codes_raw]
        self._scales = [s if shb.is_remote(s) else torch.zeros_like(s)
                        for s in self._scales_raw]

    def IsZeroAmplitude(self) -> bool:
        here = any(bool(torch.any(s != 0)) for s in self._scales
                   if not shb.is_remote(s))
        return not shb.sum_ranks(self._scales_raw,
                                 np.asarray([float(here)]))[0]

    # ------------------------------------------------------------------
    # reductions and the draw across processes
    # ------------------------------------------------------------------

    def _sum_parts(self, part_sums) -> float:
        """Page values summed in page order, over every rank."""
        C_l = self._n_chunks() // self.n_pages
        got = np.zeros(self.n_pages, dtype=np.float64)
        for cid0, v in part_sums:
            got[cid0 // C_l] = v
        total = 0.0
        for v in shb.sum_ranks(self._codes_raw, got):
            total += float(v)
        return total

    def _chunk_masses(self) -> np.ndarray:
        return shb.sum_ranks(self._codes_raw, super()._chunk_masses())

    def _draw_in_chunk(self, c: int, u: float) -> int:
        """The chunk's owner draws; every rank of a spread pager gets its
        index."""
        p = c // (self._n_chunks() // self.n_pages)
        got = super()._draw_in_chunk(c, u) if self._here(p) else None
        if not self._on_cluster:
            return got
        return _cluster.broadcast_int(got, self._slot_ranks[p])

    def place_codes(self, codes: np.ndarray, scales: np.ndarray) -> None:
        """Land host (codes, scales) arrays of the whole ket as this
        pager's pages (a copy), in chunk order."""
        codes = np.asarray(codes, dtype=tq.code_dtype(self._tq_bits))
        D = self._block
        if codes.shape != ((1 << self.qubit_count) // D, 2 * D):
            raise ValueError(f"codes of shape {codes.shape} do not hold a "
                             f"w{self.qubit_count} ket in blocks of {D}")
        scales = np.asarray(scales, dtype=np.float32)
        R = self._rows_per_page()
        self._codes = [torch.from_numpy(codes[p * R:(p + 1) * R].copy()).to(dev)
                       if self._here(p) else self._remote_codes(p, R)
                       for p, dev in enumerate(self.devices)]
        self._scales = [torch.from_numpy(scales[p * R:(p + 1) * R].copy())
                        .to(dev) if self._here(p) else self._remote_scales(p, R)
                        for p, dev in enumerate(self.devices)]

    # checkpoint protocol: capture and restore inherit through
    # host_codes/place_codes (the whole ket in chunk order, so a file
    # loads into any page count); the page count rides the meta for the
    # registry's build (the chunk, and so later requantization, depends
    # on it)
    _ckpt_kind = "turboquant_pager"

    def _ckpt_capture(self, capture_child):
        snap = super()._ckpt_capture(capture_child)
        snap["meta"]["n_pages"] = self.n_pages
        return snap

    def host_codes(self):
        """(codes, scales) of the whole ket on the host, in chunk order
        (on every rank of a spread pager)."""
        R = self._rows_per_page()
        return (np.concatenate([self._rows_of(c, p, 0, R)
                                for p, c in enumerate(self._codes)]),
                np.concatenate([self._rows_of(s, p, 0, R)
                                for p, s in enumerate(self._scales)]))

    # ------------------------------------------------------------------
    # copies
    # ------------------------------------------------------------------

    def CloneEmpty(self) -> "QPagerTurboQuant":
        return type(self)(self.qubit_count, bits=self._tq_bits,
                          block_pow=self._tq_block_pow,
                          chunk_qb=self._tq_chunk_pow, seed_rot=self._tq_seed,
                          devices=self.homes or self.devices,
                          n_pages=self.n_pages,
                          rng=self.rng.spawn(), do_normalize=self.do_normalize,
                          rand_global_phase=self.rand_global_phase)

    def Clone(self) -> "QPagerTurboQuant":
        c = self.CloneEmpty()
        c._codes = [x if shb.is_remote(x) else x.clone() for x in self._codes]
        c._scales = [x if shb.is_remote(x) else x.clone()
                     for x in self._scales]
        c.running_norm = self.running_norm
        return c

    def Finish(self) -> None:
        for dev in set(self._local_devices()):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
