"""QEngineCUDATurboQuant: the dense ket resident as rotated b-bit block
codes on one CUDA device (the counterpart of the JAX package's
QEngineTurboQuant, engines/turboquant.py there).

* The state is codes (B, 2D) int8/int16 plus scales (B,) float32: each
  block of D = 2^bp amplitudes is one row [re_0..re_{D-1}, im_0..im_{D-1}]
  rotated by one shared seed-derived (2D, 2D) matrix and quantized
  against its max-abs scale (storage/turboquant.py).  At int8 a w32 ket
  takes 8 GiB of codes and 256 MiB of scales, where float32 planes would
  take 32 GiB.
* Gates, diagonals and fused windows run through the hand-written
  kernels of ops/turboquant_kernel.py — one dequantize, the gate or the
  whole window, one requantize per shared-memory tile — routed as the
  JAX engine routes them under QRACK_USE_PALLAS=1: a diagonal anywhere,
  a 2x2 whose target lies inside the tile (QRACK_PALLAS_TQ_TILE_QB,
  default 12 here), and every multi-op window.
* Everything else that the JAX engine ran as XLA chunk programs (2x2s
  above the tile, probabilities, collapse, diagonal index functions) is
  plain torch over chunks of 2^chunk_qb amplitudes
  (QRACK_TURBOQUANT_CHUNK_QB), batched into groups of chunks so that a
  step decodes about 2^27 amplitudes (1 GiB of float32 planes) at once.
  Index math stays split as (chunk id, in-chunk index) int32 pairs: a
  diagonal op with a split-index form (engines/qengine.py ``split=``)
  runs it over the chunks at every width, exact past 31 qubits, as the
  JAX engine's _mk_phase_split does.  With ``_pallas_capable`` False
  (the TurboQuant pager, parallel/turboquant_pager.py) gates, diagonals
  and windows also take the JAX engine's chunk programs (_mk_gate_low,
  _mk_diag, _mk_fuse_window), as plain torch, and no kernel runs.
* Normalization never touches codes: dequantization is linear in the
  scales.  Chunks and tiles that no gate acts on keep their exact codes.
* Codes and scales update in place; Clone copies them.
* Operations without a chunked form decode the whole ket into float32
  planes through the ``_state`` property (refused past 30 qubits).
  ``peak_transient_amps`` records the largest float32 decode.
* With the resilience plane armed (resilience/), each kernel launch and
  chunk pass (gates, diagonals, windows, phase passes, probabilities,
  collapse) is one guarded dispatch at site ``turboquant.dispatch``,
  whose in-place writes to the codes and scales are watched; the
  failover chain's rung for this engine is QEngineCUDA up to 30 qubits
  (resilience/failover.py), and the integrity envelope fingerprints the
  per-chunk masses off the codes.
* Telemetry (the JAX engine's names): ``tq.sweeps`` (a decode and a
  requantize of the resident codes per gate, diagonal, phase pass or
  window) with its planned bytes (``roofline.tq.sweep``), the
  ``tq.resident.*`` gauges, and ``fuse.tq.*`` for the windows.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); there every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import matrices as mat
from .. import resilience as _res
from .. import telemetry as _tele
from ..ops import fusion as fu
from ..ops import gatekernels as gk
from ..ops import turboquant_kernel as tqk
from ..ops import window_kernel as wk
from ..resilience import dispatch as _rdispatch
from ..storage import turboquant as tq
from ..telemetry import roofline as _roofline
from ..utils.device import resolve_device
from .cuda import MAX_DENSE_QB, QEngineCUDA

# The JAX engine's chunk default is 2^20 amplitudes, a lax.map step.  Here
# a chunk step is a few batched torch calls, so chunks are larger.
DEFAULT_CHUNK_QB = 26


def _dec_rows(codes, scales, rot_t, qmax: float):
    """Codes (..., 2D) and scales (...) -> original-space rows."""
    return (codes.to(torch.float32) * (scales / qmax).unsqueeze(-1)) @ rot_t


def _comp_rows(rows, rot, qmax: float, cdt):
    """Original-space rows (..., 2D) -> (codes, scales)."""
    y = rows @ rot
    scales = y.abs().amax(-1)
    safe = torch.where(scales > 0, scales, 1.0)
    return torch.round(y / safe.unsqueeze(-1) * qmax).to(cdt), scales


def _rows_to_planes(rows, block: int):
    """(..., b, 2D) rows -> (2, ..., b * D) planes."""
    lead, b = rows.shape[:-2], rows.shape[-2]
    v = rows.reshape(lead + (b, 2, block)).movedim(-2, 0)
    return v.reshape((2,) + lead + (b * block,))


def _planes_to_rows(planes, block: int):
    """(2, ..., A) planes -> (..., A / D, 2D) rows."""
    lead, a = planes.shape[1:-1], planes.shape[-1]
    v = planes.reshape((2,) + lead + (a // block, block)).movedim(0, -2)
    return v.reshape(lead + (a // block, 2 * block))


def _pair_mix(a, b, m, lm, lv, lidx):
    """2x2 mix of two decoded chunk groups (the cross-chunk gate pair):
    new_a = m00*a + m01*b, new_b = m10*a + m11*b where the low control
    test passes."""
    def cm(re_f, im_f, v):
        return torch.stack([v[0] * re_f - v[1] * im_f,
                            v[0] * im_f + v[1] * re_f])

    na = cm(m[0][0][0], m[1][0][0], a) + cm(m[0][0][1], m[1][0][1], b)
    nb = cm(m[0][1][0], m[1][1][0], a) + cm(m[0][1][1], m[1][1][1], b)
    keep = (lidx & lm) == lv
    return torch.where(keep, na, a), torch.where(keep, nb, b)


class QEngineCUDATurboQuant(QEngineCUDA):
    """Dense ket resident as rotated b-bit block codes (lossy)."""

    _tele_name = "turboquant"

    # the kernels' tile: 2^12 amplitudes by default (the Pallas kernels'
    # 2^18 is a TPU VMEM size; a CUDA block holds the tile twice and both
    # rotations in at most 227 KB of shared memory)
    _PALLAS_TILE_POW = int(os.environ.get("QRACK_PALLAS_TQ_TILE_QB",
                                          str(tqk.DEFAULT_TILE_POW)))
    # float32 amplitudes one plain chunk step decodes at once (1 GiB)
    _GROUP_AMPS = 1 << 27
    # gates, diagonals and windows through the kernels (K3-K5); with
    # False they run as the JAX engine's XLA chunk programs do without
    # QRACK_USE_PALLAS (_mk_gate_low, _mk_diag, _mk_fuse_window: plain
    # torch over the chunks), as the TurboQuant pager always does
    _pallas_capable = True

    def __init__(self, qubit_count: int, init_state: int = 0,
                 bits: int = None, block_pow: int = None,
                 chunk_qb: int = None, seed_rot: int = tq.DEFAULT_SEED,
                 dtype=None, device=None, **kwargs):
        self._tq_bits = int(bits if bits is not None
                            else os.environ.get("QRACK_TURBO_BITS",
                                                tq.DEFAULT_BITS))
        bp = int(block_pow if block_pow is not None
                 else os.environ.get("QRACK_TURBO_BLOCK_POW",
                                     tq.DEFAULT_BLOCK_POW))
        self._tq_block_pow = min(bp, self._max_chunk_pow(qubit_count))
        cq = int(chunk_qb if chunk_qb is not None
                 else os.environ.get("QRACK_TURBOQUANT_CHUNK_QB",
                                     DEFAULT_CHUNK_QB))
        self._tq_chunk_pow = max(self._tq_block_pow,
                                 min(cq, self._max_chunk_pow(qubit_count)))
        self._tq_seed = seed_rot
        self._qmax = float(tq.qmax(self._tq_bits))
        self._code_dt = torch.int8 if self._tq_bits <= 8 else torch.int16
        self._codes_raw = None
        self._scales_raw = None
        self.peak_transient_amps = 0
        device = resolve_device(device)
        self._set_rotation(device)
        # the codes decode to float32 planes whatever the FPPOW policy
        if dtype is not None and gk.plane_dtype(dtype) != torch.float32:
            raise ValueError("QEngineCUDATurboQuant decodes to float32 "
                             f"planes; dtype {dtype!r} is not offered")
        super().__init__(qubit_count, init_state=init_state,
                         dtype=torch.float32, device=device, **kwargs)

    def _set_rotation(self, device) -> None:
        self._rot_cache = {}   # the rotation on the pages' other devices
        d = 1 << self._tq_block_pow
        self._rot_host = tq.rotation_matrix(2 * d, self._tq_seed)
        self._rot = torch.from_numpy(self._rot_host).to(device)
        self._rot_t = self._rot.T.contiguous()

    # ------------------------------------------------------------------
    # capacity and layout
    # ------------------------------------------------------------------

    def _max_chunk_pow(self, qubit_count: int) -> int:
        """The widest chunk at this width (the pager subtracts its page
        bits, so every page holds at least one chunk)."""
        return qubit_count

    def _compressed_cap(self) -> int:
        """Width ceiling on one device: codes hold 4x (int8) or 2x
        (int16) the amplitudes of float32 planes per byte, so +2 or +1
        qubits over the dense cap.  The chunked and tiled paths index
        with split int32 pairs; only the dense `_state` fallback is
        bound by the dense cap, and its property enforces that."""
        return MAX_DENSE_QB + (2 if self._tq_bits <= 8 else 1)

    def _check_capacity(self, qubit_count: int) -> None:
        cap = self._compressed_cap()
        if qubit_count > cap:
            raise MemoryError(
                f"QEngineCUDATurboQuant width {qubit_count} exceeds the "
                f"compressed single-device cap ({cap} at "
                f"{self._tq_bits}-bit codes)")
        # growth (Compose/Allocate on a live engine) goes through the
        # dense float32 fallback, sound only to MAX_DENSE_QB; a fresh
        # construction is codes-native and may use the full cap
        if qubit_count > MAX_DENSE_QB and self._codes_raw is not None:
            raise MemoryError(
                f"growing a compressed engine past {MAX_DENSE_QB} qubits "
                "requires the dense fallback plane (unsound at that "
                "width); construct at the target width instead")

    @property
    def _block(self) -> int:
        return 1 << self._tq_block_pow

    @property
    def _chunk_amps(self) -> int:
        return 1 << self._tq_chunk_pow

    @property
    def _chunk_blocks(self) -> int:
        return self._chunk_amps // self._block

    def _n_chunks(self) -> int:
        return max(1, (1 << self.qubit_count) // self._chunk_amps)

    def _pallas_tile_pow(self) -> int:
        # a tile covers whole blocks and no more than the ket
        return max(min(self._PALLAS_TILE_POW, self.qubit_count),
                   self._tq_block_pow)

    def resident_bytes(self) -> int:
        """Device bytes of the resident representation."""
        if self._codes_raw is None:
            return 0
        return (self._codes_raw.numel() * self._codes_raw.element_size()
                + self._scales_raw.numel() * 4)

    # resident-form access: every read of codes or scales flushes the
    # pending gate window first and a blind write drops it — the same
    # boundary the dense engine puts on `_state`
    @property
    def _codes(self):
        f = self._fuser
        if f is not None and f.gates and not f._flushing:
            f.flush()
        return self._codes_raw

    @_codes.setter
    def _codes(self, v) -> None:
        f = self._fuser
        if f is not None and f.gates and not f._flushing:
            f.drop()
        self._codes_raw = v

    @property
    def _scales(self):
        f = self._fuser
        if f is not None and f.gates and not f._flushing:
            f.flush()
        return self._scales_raw

    @_scales.setter
    def _scales(self, v) -> None:
        f = self._fuser
        if f is not None and f.gates and not f._flushing:
            f.drop()
        self._scales_raw = v

    # ------------------------------------------------------------------
    # compressed <-> float32 planes (the dense fallback)
    # ------------------------------------------------------------------

    def _row_steps(self, n_rows: int):
        step = max(1, self._GROUP_AMPS // self._block)
        for r0 in range(0, n_rows, step):
            yield r0, min(n_rows, r0 + step)

    def _compress_planes(self, planes) -> None:
        D = self._block
        planes = planes.to(self._device, torch.float32)
        n_rows = planes.shape[-1] // D
        codes = torch.empty((n_rows, 2 * D), dtype=self._code_dt,
                            device=self._device)
        scales = torch.empty(n_rows, dtype=torch.float32, device=self._device)
        for r0, r1 in self._row_steps(n_rows):
            rows = _planes_to_rows(planes[:, r0 * D:r1 * D], D)
            codes[r0:r1], scales[r0:r1] = _comp_rows(rows, self._rot,
                                                     self._qmax, self._code_dt)
        self._codes = codes
        self._scales = scales
        self._note_resident()

    def _note_resident(self) -> None:
        """Resident-footprint gauges: codes + scales bytes against what
        the same ket takes as two float32 planes.  Reads the raw arrays
        (the properties would flush the fuser)."""
        if _tele._ENABLED and self._codes_raw is not None:
            _tele.gauge("tq.resident.bytes", float(self.resident_bytes()))
            _tele.gauge("tq.resident.dense_equiv_bytes",
                        float(8 * (1 << self.qubit_count)))

    def _note_sweeps(self, n: int = 2) -> None:
        """Count the decode and requantize passes over the resident codes
        (one of each per gate, diagonal, phase pass or window); each
        moves the whole compressed residency, whose bytes also enter the
        roofline ledger (``roofline.tq.sweep``)."""
        if _tele._ENABLED:
            _tele.inc("tq.sweeps", n)
            if self._codes_raw is not None:
                _roofline.note_bytes("tq.sweep",
                                     float(n) * self.resident_bytes())
                self._note_resident()

    def _note_window(self, n_ops: int) -> None:
        """A window of `n_ops` in one decode and one requantize, where
        the per-gate path pays a pair an op (``fuse.tq.sweeps_saved``)."""
        self._note_sweeps()
        if _tele._ENABLED:
            _tele.inc("fuse.tq.windows")
            _tele.inc("fuse.tq.ops", n_ops)
            _tele.inc("fuse.tq.sweeps_saved", 2 * (n_ops - 1))

    def _decompress_planes(self):
        D = self._block
        codes, scales = self._codes, self._scales
        out = torch.empty((2, codes.shape[0] * D), dtype=torch.float32,
                          device=self._device)
        for r0, r1 in self._row_steps(codes.shape[0]):
            out[:, r0 * D:r1 * D] = _rows_to_planes(
                _dec_rows(codes[r0:r1], scales[r0:r1], self._rot_t,
                          self._qmax), D)
        return out

    @property
    def _state(self):
        """The whole ket as float32 planes (a new tensor), for the
        operations that have no chunked form."""
        if self._codes is None:
            return None
        if self.qubit_count > MAX_DENSE_QB:
            raise MemoryError(
                f"this operation needs the dense float32 fallback plane, "
                f"which is unsound past {MAX_DENSE_QB} qubits (width "
                f"{self.qubit_count}).  At this width the chunked op set "
                "(gates, prob, collapse, measurement, SetPermutation, "
                "amplitude and page reads) is the supported surface")
        self.peak_transient_amps = max(self.peak_transient_amps,
                                       1 << self.qubit_count)
        return self._decompress_planes()

    @_state.setter
    def _state(self, planes) -> None:
        if planes is None:
            self._codes = None
            self._scales = None
            return
        # compose/decompose/allocate change the width through here; the
        # structure ops adjust qubit_count themselves afterwards
        n_new = int(round(math.log2(planes.shape[-1])))
        if n_new > MAX_DENSE_QB:
            raise MemoryError(
                f"dense fallback write at width {n_new} is unsound past "
                f"{MAX_DENSE_QB} qubits on the compressed engine")
        max_cp = self._max_chunk_pow(n_new)
        if self._tq_block_pow > max_cp:
            self._tq_block_pow = max_cp
            self._set_rotation(self._device)
        self._tq_chunk_pow = max(self._tq_block_pow,
                                 min(self._tq_chunk_pow, max_cp))
        self._compress_planes(planes)

    # ------------------------------------------------------------------
    # chunk groups: the JAX engine's lax.map chunk axis, batched
    # ------------------------------------------------------------------

    def _parts(self):
        """[(codes (C, cb, 2D), scales (C, cb), global id of chunk 0)]:
        the resident arrays as chunk-major views, one part here, one a
        page on the pager."""
        C, cb = self._n_chunks(), self._chunk_blocks
        return [(self._codes.view(C, cb, 2 * self._block),
                 self._scales.view(C, cb), 0)]

    def _chunk_rows(self, c: int):
        """(codes, scales) of global chunk c."""
        for c3, s2, cid0 in self._parts():
            if cid0 <= c < cid0 + c3.shape[0]:
                return c3[c - cid0], s2[c - cid0]
        raise IndexError(f"chunk {c} out of range")

    def _group_size(self, n_live: int) -> int:
        """Units of n_live chunks (one chunk, or a pair) that one step
        decodes, near _GROUP_AMPS float32 amplitudes; records that
        transient."""
        units = max(1, self._n_chunks() // n_live)
        g = max(1, min(units,
                       self._GROUP_AMPS // (n_live * self._chunk_amps)))
        self.peak_transient_amps = max(self.peak_transient_amps,
                                       n_live * g * self._chunk_amps)
        return g

    def _groups(self, C: int):
        """[c0, c1) ranges over C chunks, one step each."""
        g = self._group_size(1)
        for c0 in range(0, C, g):
            yield c0, min(C, c0 + g)

    def _cids(self, c0: int, c1: int, device=None):
        return torch.arange(c0, c1, dtype=gk.IDX_DTYPE,
                            device=device or self._device).view(-1, 1)

    def _lidx(self, device=None):
        return gk._iota(self._chunk_amps, device or self._device)

    def _rot_on(self, device):
        """(rot, rot_t) on `device` (the pager's pages may lie apart)."""
        if device == self._rot.device:
            return self._rot, self._rot_t
        if device not in self._rot_cache:
            self._rot_cache[device] = (self._rot.to(device),
                                       self._rot_t.to(device))
        return self._rot_cache[device]

    def _dec_group(self, cc, ss):
        return _rows_to_planes(_dec_rows(cc, ss, self._rot_on(cc.device)[1],
                                         self._qmax), self._block)

    def _comp_group(self, planes):
        return _comp_rows(_planes_to_rows(planes, self._block),
                          self._rot_on(planes.device)[0], self._qmax,
                          self._code_dt)

    def _map_chunks(self, body, select: bool = False) -> None:
        """Run body(planes (2, g, cs), cids (g, 1), lidx) over every chunk
        group and requantize in place.  With `select`, body returns
        (planes, keep) and chunks where keep is False keep their codes."""
        for c3, s2, cid0 in self._parts():
            dev = c3.device
            lidx = self._lidx(dev)
            for c0, c1 in self._groups(c3.shape[0]):
                cc, ss = c3[c0:c1], s2[c0:c1]
                out = body(self._dec_group(cc, ss),
                           self._cids(cid0 + c0, cid0 + c1, dev), lidx)
                keep = None
                if select:
                    out, keep = out
                nc, ns = self._comp_group(out)
                if keep is None:
                    cc.copy_(nc)
                    ss.copy_(ns)
                else:
                    cc.copy_(torch.where(keep.unsqueeze(-1), nc, cc))
                    ss.copy_(torch.where(keep, ns, ss))

    # ------------------------------------------------------------------
    # gates: the kernels, routed as the JAX engine routes its Pallas ones
    # ------------------------------------------------------------------

    def _kernel_args(self):
        return (self._codes, self._scales, self._rot, self._rot_t,
                self._tq_bits, self._pallas_tile_pow())

    def _tq_call(self, fn, *args, site: str = "turboquant.dispatch"):
        """fn(*args), a kernel launch or a chunk pass, as one guarded
        dispatch at `site` while the resilience plane is armed (a plain
        call while it is off).  The codes and scales update in place, so
        the guard watches their writes; a pass that returns nothing
        hands them back as its output (an amp-corrupt strike lands on
        the scales, as in the JAX package, whose programs return
        (codes, scales)).  The TurboQuant pager over page homes agrees
        on each call's outcome across the ranks (``cohort``)."""
        if not _res._ACTIVE:
            return fn(*args)
        codes, scales = self._codes_raw, self._scales_raw
        held = (list(codes) if isinstance(codes, list) else [codes]) + (
            list(scales) if isinstance(scales, list) else [scales])

        def run():
            out = fn(*args)
            return (codes, scales) if out is None else out

        return _rdispatch.call_guarded(
            site, run, writes=lambda: _rdispatch.write_token(held),
            cohort=_rdispatch.cohort_of(self))

    def _k_apply_2x2(self, m2, target, controls, perm) -> None:
        self._note_sweeps()
        cmask, cval = self._cmask_cval(controls, perm)
        m2 = np.asarray(m2, dtype=np.complex128)
        mp = np.stack([m2.real, m2.imag]).astype(np.float32)
        tp = self._pallas_tile_pow()
        if self._pallas_capable and target < tp:
            T = 1 << tp
            self._tq_call(tqk.tq_gate_low, *self._kernel_args(), mp, target,
                          cmask >> tp, cval >> tp, cmask & (T - 1),
                          cval & (T - 1))
            return
        ca, cs = self._tq_chunk_pow, self._chunk_amps
        hm, hv, lm, lv = cmask >> ca, cval >> ca, cmask & (cs - 1), cval & (cs - 1)
        m = mp.tolist()
        if target < ca:
            self._tq_call(self._map_chunks,
                          lambda pl, cid, lidx: wk.tile_local_2x2(
                              pl, lidx, cid, target, m, lm, lv, hm, hv), True)
        else:
            self._gate_pair(m, target - ca, hm, hv, lm, lv)

    def _gate_pair(self, m, tb_pos: int, hm, hv, lm, lv) -> None:
        """2x2 whose target is a chunk-id bit: chunk a (bit clear) and its
        partner a + 2^tb_pos mix (the cross-chunk pair path), within each
        part: one guarded dispatch."""
        self._tq_call(self._gate_pair_parts, m, tb_pos, hm, hv, lm, lv)

    def _gate_pair_parts(self, m, tb_pos: int, hm, hv, lm, lv) -> None:
        cb, twoD = self._chunk_blocks, 2 * self._block
        lo_n = 1 << tb_pos
        for c3, s2, cid0 in self._parts():
            C, dev = c3.shape[0], c3.device
            hi_n = C // (2 * lo_n)
            self._pair_part(m, c3.view(hi_n, 2, lo_n, cb, twoD),
                            s2.view(hi_n, 2, lo_n, cb), cid0, lo_n, hm, hv,
                            lm, lv, dev)

    def _pair_part(self, m, c5, s4, cid0, lo_n, hm, hv, lm, lv, dev) -> None:
        hi_n, cb, twoD = c5.shape[0], c5.shape[3], c5.shape[4]
        lidx = self._lidx(dev)
        for h0, h1, l0, l1 in _pair_spans(hi_n, lo_n, self._group_size(2)):
            k = (h1 - h0) * (l1 - l0)
            ha = torch.arange(h0, h1, dtype=gk.IDX_DTYPE, device=dev)
            la = torch.arange(l0, l1, dtype=gk.IDX_DTYPE, device=dev)
            cid_a = (cid0 + ha.view(-1, 1) * (2 * lo_n)
                     + la.view(1, -1)).view(k, 1)
            halves = [(c5[h0:h1, half, l0:l1].reshape(k, cb, twoD),
                       s4[h0:h1, half, l0:l1].reshape(k, cb))
                      for half in (0, 1)]
            for half, (nc, ns) in enumerate(self._mix_rows(
                    m, halves[0], halves[1], cid_a, hm, hv, lm, lv, lidx)):
                c5[h0:h1, half, l0:l1] = nc.view(h1 - h0, l1 - l0, cb, twoD)
                s4[h0:h1, half, l0:l1] = ns.view(h1 - h0, l1 - l0, cb)

    def _mix_rows(self, m, rows_a, rows_b, cid_a, hm, hv, lm, lv, lidx):
        """The pair mix of chunks a (target bit clear) and b, given as
        (codes, scales) of k chunks each: [(codes, scales) of a, of b],
        requantized where the high control test of a's chunk id passes
        (controls never sit on the target bit: one test a pair), the
        input codes elsewhere."""
        na, nb = _pair_mix(self._dec_group(*rows_a), self._dec_group(*rows_b),
                           m, lm, lv, lidx)
        sel = (cid_a & hm) == hv
        out = []
        for (cc, ss), new in ((rows_a, na), (rows_b, nb)):
            nc, ns = self._comp_group(new)
            out.append((torch.where(sel.unsqueeze(-1), nc, cc),
                        torch.where(sel, ns, ss)))
        return out

    def _k_apply_diag(self, d0, d1, target, controls, perm) -> None:
        self._note_sweeps()
        cmask, cval = self._cmask_cval(controls, perm)
        d0, d1 = complex(d0), complex(d1)
        if not self._pallas_capable:
            self._tq_call(self._diag_chunks, d0, d1, target, cmask, cval)
            return
        tp = self._pallas_tile_pow()
        T = 1 << tp
        dp = np.zeros((2, 2, 2), np.float32)
        dp[0, 0, 0], dp[0, 0, 1] = d0.real, d1.real
        dp[1, 0, 0], dp[1, 0, 1] = d0.imag, d1.imag
        tm_lo = (1 << target) if target < tp else 0
        tb_hi = 0 if target < tp else (1 << (target - tp))
        self._tq_call(tqk.tq_diag, *self._kernel_args(), dp, tm_lo, tb_hi,
                      cmask & (T - 1), cval & (T - 1), cmask >> tp,
                      cval >> tp)

    def _diag_chunks(self, d0, d1, target, cmask, cval) -> None:
        """A diagonal as the JAX engine's chunk program (_mk_diag): the
        factor per element, a chunk requantized only where a high-control
        test passes and its factor is not identically 1 (a unit diagonal
        above the chunk keeps its codes bit for bit)."""
        ca, cs = self._tq_chunk_pow, self._chunk_amps
        tmask_lo = (1 << target) if target < ca else 0
        tb_hi = 0 if target < ca else (1 << (target - ca))
        lm, lv, hm, hv = cmask & (cs - 1), cval & (cs - 1), cmask >> ca, cval >> ca
        d0re, d0im, d1re, d1im = (np.float32(x) for x in (d0.real, d0.imag,
                                                           d1.real, d1.imag))

        def body(pl, cid, lidx):
            hi_bit = (cid & tb_hi) != 0
            bit = ((lidx & tmask_lo) != 0) | hi_bit
            fre = torch.where(bit, float(d1re), float(d0re))
            fim = torch.where(bit, float(d1im), float(d0im))
            active = (lidx & lm) == lv
            fre = torch.where(active, fre, 1.0)
            fim = torch.where(active, fim, 0.0)
            out = gk.cmul(fre, fim, pl)
            cf_re = torch.where(hi_bit, float(d1re), float(d0re))
            cf_im = torch.where(hi_bit, float(d1im), float(d0im))
            ident = ((tmask_lo == 0) & (lm == 0) & (cf_re == 1.0)
                     & (cf_im == 0.0))
            return out, ((cid & hm) == hv) & ~ident

        self._map_chunks(body, select=True)

    def _window_chunks(self, structure, operands) -> None:
        """A fused window as the JAX engine's chunk program
        (_mk_fuse_window): one decode, every op through the shared tile
        primitives with the chunk as the tile, one requantize of each
        chunk an op acted on."""
        ca = self._tq_chunk_pow
        lbits = (1 << ca) - 1

        def body(pl, cid, lidx):
            dirty = torch.zeros_like(cid, dtype=torch.bool)
            i = 0
            for kind, target, has_ctrl in structure:
                p = operands[i]
                i += 1
                if kind == "cphase":
                    if has_ctrl:
                        clo, chi = operands[i], operands[i + 1]
                        i += 2
                    else:
                        comb = 1 << target
                        clo, chi = comb & lbits, comb >> ca
                    pl, hi_ok = wk.tile_cphase(pl, lidx, cid, clo, chi,
                                               p[0], p[1])
                    dirty = dirty | hi_ok
                    continue
                if has_ctrl:
                    lo_cm, lo_cv, hi_cm, hi_cv = operands[i:i + 4]
                    i += 4
                else:
                    lo_cm = lo_cv = hi_cm = hi_cv = 0
                if kind == "diag":
                    pl, hi_ok = wk.tile_diag(pl, lidx, cid, target, ca,
                                             p[0, 0], p[0, 1], p[1, 0],
                                             p[1, 1], lo_cm, lo_cv, hi_cm,
                                             hi_cv)
                    if target >= ca:
                        # a whole-chunk factor of exactly 1 keeps the codes
                        hi_bit = (cid & (1 << (target - ca))) != 0
                        cf_re = torch.where(hi_bit, p[1, 0], p[0, 0])
                        cf_im = torch.where(hi_bit, p[1, 1], p[0, 1])
                        ident = ((lo_cm == 0) & (cf_re == 1.0)
                                 & (cf_im == 0.0))
                        hi_ok = hi_ok & ~ident
                    dirty = dirty | hi_ok
                else:  # gen: target < ca, as _fuse_admit routes it
                    pl, hi_ok = wk.tile_local_2x2(pl, lidx, cid, target, p,
                                                  lo_cm, lo_cv, hi_cm, hi_cv)
                    dirty = dirty | hi_ok
            return pl, dirty

        self._map_chunks(body, select=True)

    def _k_phase_fn(self, fn, split=None) -> None:
        self._note_sweeps()
        ca, cs = self._tq_chunk_pow, self._chunk_amps
        if split is not None:
            # the (chunk id, in-chunk index) form: exact past 31 qubits
            # (the JAX engine's _mk_phase_split, taken whenever an op has
            # one)
            body_fn, targs = split

            def body(pl, cid, lidx):
                fre, fim = body_fn(gk.plane_where(pl), cid, lidx, ca, *targs)
                return gk.cmul(fre, fim, pl)
        else:
            if self.qubit_count > 31:
                raise NotImplementedError(
                    "this diagonal op lacks a split-index form for "
                    ">31-qubit compressed kets (see the `split=` forms in "
                    "engines/qengine.py)")

            def body(pl, cid, lidx):
                fre, fim = fn(torch, cid * cs + lidx)
                return gk.cmul(fre, fim, pl)

        self._tq_call(self._map_chunks, body)

    # ------------------------------------------------------------------
    # gate-stream fusion hooks (ops/fusion.py GateStreamFuser)
    # ------------------------------------------------------------------

    def _fuse_admit(self, m, target, controls) -> bool:
        # a window runs as one sweep (a kernel's tiles, or the chunk
        # program's chunks); only non-diagonal targets above the tile or
        # chunk stay per-gate (the chunk pair path)
        if self._pallas_capable:
            return mat.is_phase(m) or target < self._pallas_tile_pow()
        return mat.is_phase(m) or target < self._tq_chunk_pow

    # No drift accounting, eager or fused: a norm check would decompress
    # the whole ket, and the codes decode to float32 whatever the norm.
    def _fuse_tick(self) -> None:
        pass

    def _drift_tick(self) -> None:
        pass

    def EscalateToF64(self, observed_norm: float = None) -> None:
        raise NotImplementedError(
            "QEngineCUDATurboQuant holds float32 block codes; it has no "
            "float64 form")

    def _fuse_flush(self, gates) -> int:
        ops = fu.lower_gates(gates)
        if not ops:
            return 0
        if len(ops) == 1:
            # a window merged down to one op takes the per-gate kernels
            op = ops[0]
            controls, perm = fu.controls_perm(op)
            m = np.asarray(op.m)
            if op.kind in ("cphase", "diag"):
                self._k_apply_diag(m[0, 0], m[1, 1], op.target, controls,
                                   perm)
            else:
                self._k_apply_2x2(m, op.target, controls, perm)
            return 1
        structure = fu.sharded_structure_of(ops)
        self._note_window(len(ops))
        if not self._pallas_capable:
            self._tq_call(self._window_chunks, structure,
                          fu.sharded_operands(ops, self._tq_chunk_pow,
                                              torch.float32, self._device))
            return 1
        tp = self._pallas_tile_pow()
        self._tq_call(tqk.tq_window, *self._kernel_args(), structure,
                      fu.sharded_operands(ops, tp, torch.float32,
                                          self._device))
        return 1

    # ------------------------------------------------------------------
    # probabilities, collapse, normalization, sampling
    # ------------------------------------------------------------------

    def _k_prob_mask(self, mask, perm) -> float:
        return self._tq_call(self._prob_mask, mask, perm)

    def _prob_mask(self, mask, perm) -> float:
        ca, cs = self._tq_chunk_pow, self._chunk_amps
        ml, vl, mh, vh = mask & (cs - 1), perm & (cs - 1), mask >> ca, perm >> ca
        part_sums = []
        for c3, s2, cid0 in self._parts():
            dev = c3.device
            lidx = self._lidx(dev)
            sums = []
            for c0, c1 in self._groups(c3.shape[0]):
                pl = self._dec_group(c3[c0:c1], s2[c0:c1])
                ok = (((lidx & ml) == vl)
                      & ((self._cids(cid0 + c0, cid0 + c1, dev) & mh) == vh))
                p = pl[0] ** 2 + pl[1] ** 2
                sums.append(torch.where(ok, p, 0.0).sum(-1))
            part_sums.append((cid0, float(torch.cat(sums).sum())))
        total = self._sum_parts(part_sums)
        return min(max(total, 0.0), 1.0)

    def _sum_parts(self, part_sums) -> float:
        """The sum of per-part values [(first chunk id, value)], in part
        order."""
        total = 0.0
        for _cid0, v in part_sums:
            total += v
        return total

    def _k_collapse(self, mask, val, nrm_sq) -> None:
        self._tq_call(self._collapse, mask, val, nrm_sq)

    def _collapse(self, mask, val, nrm_sq) -> None:
        ca, cs = self._tq_chunk_pow, self._chunk_amps
        scale = 1.0 / math.sqrt(nrm_sq)
        if (mask & (cs - 1)) == 0:
            # chunk-aligned mask: a pure per-chunk scale update (match ->
            # *scale, else -> 0); the codes stay exact and nothing decodes
            for c3, s2, cid0 in self._parts():
                cids = self._cids(cid0, cid0 + c3.shape[0], c3.device)
                sel = (cids & (mask >> ca)) == (val >> ca)
                s2.copy_(torch.where(sel, s2 * scale, 0.0))
            return
        ml, vl, mh, vh = mask & (cs - 1), val & (cs - 1), mask >> ca, val >> ca

        def body(pl, cid, lidx):
            keep = ((lidx & ml) == vl) & ((cid & mh) == vh)
            return torch.where(keep, pl * scale, 0.0)

        self._map_chunks(body)

    def _k_normalize(self, nrm_sq) -> None:
        # dequantization is linear in the scales: nothing decodes
        for _c3, s2, _cid0 in self._parts():
            s2.mul_(1.0 / math.sqrt(nrm_sq))

    def UpdateRunningNorm(self, norm_thresh: float = -1.0) -> None:
        """The squared norm from the chunk masses, without a decode, so
        NormalizeState works at every width (requantization moves the
        norm by a little each sweep)."""
        self.running_norm = float(self._chunk_masses().sum())

    def _chunk_masses(self) -> np.ndarray:
        """Per-chunk probability masses WITHOUT the rotation: it is
        orthogonal, so a row's norm is sum((codes * scale / qmax)^2).
        Each part's chunks land at their global ids."""
        out = np.zeros(self._n_chunks(), dtype=np.float64)
        g = max(1, self._GROUP_AMPS // self._chunk_amps)
        for c3, s2, cid0 in self._parts():
            for c0 in range(0, c3.shape[0], g):
                y = (c3[c0:c0 + g].to(torch.float32)
                     * (s2[c0:c0 + g] / self._qmax).unsqueeze(-1))
                c = cid0 + c0
                out[c:c + y.shape[0]] = torch.sum(y * y, dim=(1, 2)).to(
                    "cpu", torch.float64).numpy()
        return out

    def MAll(self) -> int:
        """Two-stage sampling: a chunk by its mass (no decode), then an
        index inside the one decoded chunk."""
        n_ch = self._n_chunks()
        masses = self._chunk_masses()
        u = self.Rand() * masses.sum()
        acc = 0.0
        chosen = n_ch - 1
        for c in range(n_ch):
            acc += masses[c]
            if u <= acc:
                chosen = c
                break
        self.peak_transient_amps = max(self.peak_transient_amps,
                                       self._chunk_amps)
        local = self._draw_in_chunk(chosen, float(self.Rand()))
        result = chosen * self._chunk_amps + local
        self.SetPermutation(result)
        return result

    def _draw_in_chunk(self, c: int, u: float) -> int:
        """The index inside chunk c that the uniform u draws (one decoded
        chunk)."""
        return int(gk.sample(self._dec_group(*self._chunk_rows(c)), u))

    # ------------------------------------------------------------------
    # codes-native construction and block-local reads
    # ------------------------------------------------------------------

    def SetPermutation(self, perm: int, phase=None) -> None:
        """A basis state occupies one block: write that block's rotated
        one-hot row, no float32 ket."""
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
        n_rows = (1 << self.qubit_count) // D
        codes = torch.zeros((n_rows, 2 * D), dtype=self._code_dt,
                            device=self._device)
        scales = torch.zeros(n_rows, dtype=torch.float32, device=self._device)
        codes[b] = row_codes
        scales[b] = scale
        self._codes = codes
        self._scales = scales
        self.running_norm = 1.0

    def _block_home(self, b: int):
        """(codes, scales, row) of block b in the resident arrays."""
        return self._codes, self._scales, b

    def _fetch_blocks(self, b0: int, nb: int):
        """Host float32 (codes, scales) of blocks [b0, b0 + nb)."""
        return (self._codes[b0:b0 + nb].to("cpu").numpy().astype(np.float32),
                self._scales[b0:b0 + nb].to("cpu").numpy().astype(np.float32))

    def GetAmplitude(self, perm: int) -> complex:
        D = self._block
        b, d = perm // D, perm % D
        codes, scales = self._fetch_blocks(b, 1)
        scale = float(scales[0])
        if scale == 0.0:
            return 0j
        y = codes[0] * (scale / self._qmax)
        # decode just the two coordinates: row @ rot.T at columns d (re)
        # and D + d (im)
        rot = self._rot_host
        return complex(float(y @ rot[d]), float(y @ rot[D + d]))

    def SetAmplitude(self, perm: int, amp: complex) -> None:
        """Block-local write: decode the one covered block, poke the
        amplitude, requantize that block only."""
        amp = complex(amp)
        D = self._block
        b, d = perm // D, perm % D
        codes, scales = self._fetch_blocks(b, 1)
        rot = self._rot_host
        vec = (codes[0] * (float(scales[0]) / self._qmax)) @ rot.T
        vec[d] = amp.real
        vec[D + d] = amp.imag
        y = vec @ rot
        scale = float(np.max(np.abs(y)))
        safe = scale if scale > 0 else 1.0
        row = np.round(y / safe * self._qmax).astype(
            tq.code_dtype(self._tq_bits))
        self._put_block(b, row, scale)

    def _put_block(self, b: int, row: np.ndarray, scale: float) -> None:
        """Write block b's host code row and scale where it lives."""
        codes, scales, i = self._block_home(b)
        codes[i] = torch.from_numpy(row).to(codes.device)
        scales[i] = scale

    def GetAmplitudePage(self, offset: int, length: int) -> np.ndarray:
        """Block-aligned page read: decode only the covered blocks."""
        D = self._block
        b0 = offset // D
        b1 = (offset + length - 1) // D + 1
        codes, scales = self._fetch_blocks(b0, b1 - b0)
        rows = (codes * (scales / self._qmax)[:, None]) @ self._rot_host.T
        flat_re = rows[:, :D].reshape(-1)
        flat_im = rows[:, D:].reshape(-1)
        lo = offset - b0 * D
        return (flat_re[lo:lo + length]
                + 1j * flat_im[lo:lo + length]).astype(np.complex128)

    def SetAmplitudePage(self, page, offset: int) -> None:
        planes = self._state
        planes[:, offset:offset + len(page)] = self._put(page)
        self._state = planes

    def ZeroAmplitudes(self) -> None:
        self._codes = torch.zeros_like(self._codes_raw)
        self._scales = torch.zeros_like(self._scales_raw)

    def IsZeroAmplitude(self) -> bool:
        # a row with a non-zero scale holds a code of magnitude qmax
        return not bool(torch.any(self._scales != 0))

    # ------------------------------------------------------------------
    # copies and files: the rotation seed travels, never the matrix
    # ------------------------------------------------------------------

    def CloneEmpty(self) -> "QEngineCUDATurboQuant":
        c = type(self)(self.qubit_count, bits=self._tq_bits,
                       block_pow=self._tq_block_pow,
                       chunk_qb=self._tq_chunk_pow, seed_rot=self._tq_seed,
                       device=self._device, rng=self.rng.spawn(),
                       do_normalize=self.do_normalize,
                       rand_global_phase=self.rand_global_phase)
        for attr in ("_PALLAS_TILE_POW", "_GROUP_AMPS"):
            if attr in self.__dict__:
                setattr(c, attr, self.__dict__[attr])
        return c

    def Clone(self) -> "QEngineCUDATurboQuant":
        """An exact copy: the same codes and scales (the resident arrays
        update in place, so they are cloned)."""
        c = self.CloneEmpty()
        c._codes = self._codes.clone()
        c._scales = self._scales.clone()
        c.running_norm = self.running_norm
        return c

    def Finish(self) -> None:
        codes = self._codes
        if codes is not None and codes.device.type == "cuda":
            torch.cuda.synchronize(codes.device)

    def SaveTurboQuant(self, path: str) -> None:
        from ..checkpoint.container import save_container

        p = path if str(path).endswith(".npz") else str(path) + ".npz"
        # the same members, meta and kind as the JAX package writes
        codes, scales = self.host_codes()
        save_container(p, {"codes": codes, "scales": scales,
                           "n": np.asarray(self.qubit_count),
                           "bits": np.asarray(self._tq_bits),
                           "block_pow": np.asarray(self._tq_block_pow),
                           "seed": np.asarray(self._tq_seed)},
                       meta={"n": self.qubit_count, "bits": self._tq_bits,
                             "block_pow": self._tq_block_pow,
                             "seed": self._tq_seed},
                       kind="turboquant-codes")

    @classmethod
    def LoadTurboQuant(cls, path: str, **kwargs):
        from ..checkpoint.container import load_container

        p = path if str(path).endswith(".npz") else str(path) + ".npz"
        kind, meta, z = load_container(p, legacy_ok=True)
        if kind is None:  # bare npz without a manifest
            meta = {k: int(z[k]) for k in ("n", "bits", "block_pow", "seed")}
        eng = cls(int(meta["n"]), bits=int(meta["bits"]),
                  block_pow=int(meta["block_pow"]), seed_rot=int(meta["seed"]),
                  **kwargs)
        eng.place_codes(np.asarray(z["codes"]), np.asarray(z["scales"]))
        return eng

    def host_codes(self):
        """(codes, scales) of the whole ket on the host."""
        return self._codes.to("cpu").numpy(), self._scales.to("cpu").numpy()

    def place_codes(self, codes: np.ndarray, scales: np.ndarray) -> None:
        """Land host (codes, scales) arrays as this engine's ket (a copy)."""
        codes = np.asarray(codes, dtype=tq.code_dtype(self._tq_bits))
        D = self._block
        if codes.shape != ((1 << self.qubit_count) // D, 2 * D):
            raise ValueError(f"codes of shape {codes.shape} do not hold a "
                             f"w{self.qubit_count} ket in blocks of {D}")
        self._codes = torch.from_numpy(codes.copy()).to(self._device)
        self._scales = torch.from_numpy(
            np.asarray(scales, dtype=np.float32).copy()).to(self._device)

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py): the codes and scales
    # verbatim, with the layout that decodes them (bits, block pow,
    # rotation seed).  The codes' shape depends on the block only, so a
    # file crosses between the packages whatever their chunk; the chunk
    # and the kernel tile decide which tiles later gates requantize
    # ------------------------------------------------------------------

    _ckpt_kind = "turboquant"

    def _ckpt_place(self, codes: np.ndarray, scales: np.ndarray) -> None:
        """Land host (codes, scales) where this engine keeps them (the
        pager overrides place_codes with its pages)."""
        self.place_codes(codes, scales)

    def _ckpt_capture(self, capture_child):
        codes, scales = self.host_codes()
        return {"kind": self._ckpt_kind,
                "meta": {"n": self.qubit_count, "bits": self._tq_bits,
                         "block_pow": self._tq_block_pow,
                         "chunk_pow": self._tq_chunk_pow,
                         "seed": self._tq_seed,
                         "running_norm": float(self.running_norm)},
                "arrays": {"codes": codes, "scales": scales}}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        if (int(meta["bits"]) != self._tq_bits
                or int(meta["block_pow"]) != self._tq_block_pow
                or int(meta["seed"]) != self._tq_seed):
            raise ValueError(
                "turboquant layout mismatch (bits/block_pow/seed)")
        self._ckpt_place(np.asarray(arrays["codes"]),
                         np.asarray(arrays["scales"], dtype=np.float32))
        self.running_norm = float(meta.get("running_norm", 1.0))


def _pair_spans(hi_n: int, lo_n: int, pairs: int):
    """(h0, h1, l0, l1) boxes over the (hi, lo) pair grid, each at most
    `pairs` pairs and a slice of the chunk-major views."""
    if lo_n >= pairs:
        for h in range(hi_n):
            for l0 in range(0, lo_n, pairs):
                yield h, h + 1, l0, min(lo_n, l0 + pairs)
    else:
        step = max(1, pairs // lo_n)
        for h0 in range(0, hi_n, step):
            yield h0, min(hi_n, h0 + step), 0, lo_n
