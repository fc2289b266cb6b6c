"""QEngineCUDA: dense state vector on one CUDA device as split real/imag
planes (the counterpart of the JAX package's QEngineTPU).

  * Amplitudes are (2, 2^n) planes, plane 0 = Re, plane 1 = Im — the
    layout of the fused window kernel's operands — in float32 by default,
    or float64, bfloat16 or float16 (the FPPOW policy: ``dtype=`` or
    ``QRACK_TPU_FPPOW``, config.py).  Every dtype runs its fused windows
    through the window kernel.
  * Opt-in float32 -> float64 escalation: with
    ``QRACK_TPU_AUTO_F64_DRIFT`` set to a threshold, every
    ``QRACK_TPU_DRIFT_CHECK_GATES`` (64) mixing gates the engine reads the
    total probability, and past the threshold it re-casts its own planes
    to float64 and warns (:meth:`QEngineCUDA.EscalateToF64`).
  * Gates queue into a GateStreamFuser window (ops/fusion.py) and flush
    at every read: a multi-op window goes through the single-sweep
    window kernel (ops/window_kernel.py) when the cost model picks it,
    else through the plain gate functions (ops/gatekernels.py).  With
    telemetry on, each flushed window counts under ``fuse.kernel.*`` or
    ``fuse.xla.*`` with its planned bytes (``roofline.cuda.fuse.flush``),
    and the drift escalation is the event ``engine.cuda.f64_escalation``
    (the JAX engine's ``engine.tpu.x64_flip`` has no counterpart: the
    escalation here casts this engine's planes and nothing else).
  * PyTorch launches asynchronously; only reads that return host values
    (Prob/M/amplitudes) wait for the device.
  * The planes update in place where the window kernel runs; every read
    that hands planes out (Clone, GetQuantumState) copies.
  * With the resilience plane armed (resilience/): each gate-function
    dispatch is the guarded site ``cuda.compile``, each multi-op window
    ``cuda.fuse.flush`` (its in-place writes watched, so a retry runs it
    exactly once), the reads that return host values (GetQuantumState,
    GetAmplitude, GetAmplitudePage, Prob, MAll, Finish)
    ``cuda.device_get`` with the integrity check of the value read, and
    construction ``discover``.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); without a GPU and without that argument, construction
raises.
"""

from __future__ import annotations

import math
import os
import types
import warnings

import numpy as np
import torch

from .. import resilience as _res
from .. import telemetry as _tele
from ..ops import fusion as fu
from ..ops import gatekernels as gk
from ..resilience import dispatch as _rdispatch
from ..utils.device import discover
from .qengine import QEngine
from .. import matrices as mat

# one-device dense width ceiling: int32 flat indices and masks, and the
# window kernel's int32 tile ids (for every plane dtype: float64 planes
# at w30 are 16 GiB)
MAX_DENSE_QB = 30


# the gate functions of ops/gatekernels.py this engine dispatches, each
# call one guarded dispatch at site ``cuda.compile`` while the resilience
# plane is armed (the JAX engine's jitted programs), a plain call after
# one attribute test while it is off.  They return new planes, so a
# retry after any failure runs a gate exactly once.
_gk = types.SimpleNamespace(**{
    name: _rdispatch.instrument_dispatch("cuda.compile", getattr(gk, name))
    for name in ("apply_2x2", "apply_invert", "apply_diag", "apply_4x4",
                 "uc_2x2", "gather", "out_of_place", "phase_factor_apply",
                 "probs", "prob_mask_sum", "collapse", "sample",
                 "multishot_mask_keys", "compose", "split_matrix",
                 "allocate", "normalize", "sum_sqr_diff", "swap_bits",
                 "expectation_bits")})


def _device_get(fn, *args):
    """Host-read boundary (site ``cuda.device_get``): the sync that
    proves completion, and therefore where a hang shows.  With the
    integrity plane on, the value read is checked in place
    (integrity.check_host), with no extra sweep of the planes."""
    if _res._ACTIVE:
        out = _rdispatch.call_guarded("cuda.device_get", fn, args)
        from ..resilience import integrity as _integ

        if _integ.enabled():
            _integ.check_host("cuda.device_get", out)
        return out
    return fn(*args)

class QEngineCUDA(QEngine):
    """Dense ket on one CUDA device (or the CPU, when asked)."""

    _xp = torch
    _fuse_capable = True
    # the JAX engine's label is "tpu" (the namespace's one rename)
    _tele_name = "cuda"

    def __init__(self, qubit_count: int, init_state: int = 0, dtype=None,
                 device=None, **kwargs):
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        self._check_capacity(qubit_count)
        self._device = discover(device)
        if dtype is None:
            from ..config import get_config

            dtype = get_config().device_real_dtype()
        self.dtype = gk.plane_dtype(dtype)
        # the drift escalation's threshold (0: off) and its period in
        # mixing gates
        self._drift_thresh = float(os.environ.get(
            "QRACK_TPU_AUTO_F64_DRIFT", "0"))
        self._drift_check_every = max(1, int(os.environ.get(
            "QRACK_TPU_DRIFT_CHECK_GATES", "64")))
        self._gate_count = 0
        # install the fuser BEFORE the first _state write so the property
        # sees it from the start
        self._fuser = fu.make_fuser(self)
        self._state_raw = None  # (2, 2^n) planes
        self.SetPermutation(init_state)

    # ------------------------------------------------------------------
    # state access: every read is a fusion boundary
    # ------------------------------------------------------------------

    @property
    def _state(self):
        """Resident planes.  A pending gate window flushes before the
        value escapes, so no reader sees a ket behind the gate stream."""
        f = self._fuser
        if f is not None and f.gates and not f._flushing:
            f.flush()
        return self._state_raw

    @_state.setter
    def _state(self, planes) -> None:
        # a direct write while gates are pending is a blind overwrite
        # (SetPermutation/SetQuantumState): drop the queued gates.  The
        # flush's own write-back passes straight through (_flushing).
        f = self._fuser
        if f is not None and f.gates and not f._flushing:
            f.drop()
        self._state_raw = planes

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def device_planes(self):
        """The resident (2, 2^n) split-plane ket (not a copy)."""
        return self._state

    @device_planes.setter
    def device_planes(self, planes) -> None:
        # through the _state setter: pending gates drop, as on any blind
        # write (the serving batcher binds each lane's fresh copy here)
        self._state = planes

    def _check_capacity(self, qubit_count: int) -> None:
        if qubit_count > MAX_DENSE_QB:
            raise MemoryError(
                f"QEngineCUDA width {qubit_count} exceeds a single dense "
                f"shard ({MAX_DENSE_QB} qubits)")

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

    # ------------------------------------------------------------------
    # precision escalation
    # ------------------------------------------------------------------

    def _drift_tick(self) -> None:
        """Opt-in float32 -> float64 escalation (QRACK_TPU_AUTO_F64_DRIFT):
        every K mixing gates read the total probability back; unitary
        circuits keep it at 1, so a sustained drift means the planes are
        losing precision, and they are re-cast to float64.  Ticked from
        every mixing kernel (2x2, invert, diagonal, 4x4, uniformly
        controlled) and per queued gate under fusion; swaps and gathers
        are exact permutations and cannot drift the norm."""
        self._drift_tick_n(1)

    def _drift_tick_n(self, k: int) -> None:
        """Advance the drift accounting by `k` gates at once."""
        if self._drift_thresh <= 0 or self.dtype == torch.float64:
            return
        before = self._gate_count
        self._gate_count += k
        if (before // self._drift_check_every) == (
                self._gate_count // self._drift_check_every):
            return
        nrm = float(_gk.prob_mask_sum(self._state, 0, 0))  # total probability
        if abs(1.0 - nrm) > self._drift_thresh:
            self.EscalateToF64(nrm)

    def EscalateToF64(self, observed_norm: float = None) -> None:
        """Re-cast this engine's planes to float64 (reference analogue:
        rebuilding at a higher FPPOW, qrack_types.hpp:88-138).  A cast of
        the engine's own tensor: nothing else in the process changes."""
        if self.dtype == torch.float64:
            return
        if _tele._ENABLED:
            _tele.event("engine.cuda.f64_escalation",
                        observed_norm=observed_norm,
                        drift_thresh=self._drift_thresh,
                        width=self.qubit_count)
        warnings.warn(
            f"{self.dtype} norm drift {observed_norm!r} exceeded "
            f"QRACK_TPU_AUTO_F64_DRIFT={self._drift_thresh}: escalating "
            "amplitude planes to float64", RuntimeWarning)
        st = self._state  # flushes any pending window in the old dtype
        self.dtype = torch.float64
        if st is not None:
            self._state = st.to(torch.float64)

    # ------------------------------------------------------------------
    # fusion hooks (ops/fusion.py)
    # ------------------------------------------------------------------

    def _fuse_admit(self, m, target, controls) -> bool:
        # every 2x2 gate lowers into a dense parametric window
        return True

    def _fuse_tick(self) -> None:
        # drift accounting advances per logical gate at queue time (the
        # eager kernels tick per dispatch; a fused window would otherwise
        # under-count merged-away gates).  A boundary crossing reads the
        # state norm, which flushes the pending window first.
        self._drift_tick()

    def _fuse_flush(self, gates) -> int:
        """Lower the pending window and apply it.  A window that merged
        down to a single op takes the per-gate path."""
        ops = fu.lower_gates(gates)
        if not ops:
            return 0
        if len(ops) == 1:
            op = ops[0]
            if op.kind in ("cphase", "diag"):
                self._apply_diag(op.m[0, 0], op.m[1, 1], op.target, op.cmask,
                                 op.cval)
            else:
                self._apply_2x2(op.m, op.target, op.cmask, op.cval)
            return 1
        planes = self._state
        if _res._ACTIVE:
            # one guarded dispatch at cuda.fuse.flush; the window kernel
            # writes the planes in place, so the guard watches its writes
            planes = _rdispatch.call_guarded(
                "cuda.fuse.flush", fu.flush_window,
                (planes, self.qubit_count, ops), {"counted": True},
                writes=lambda: _rdispatch.write_token(planes))
        else:
            planes = fu.flush_window(planes, self.qubit_count, ops,
                                     counted=True)
        self._state = planes
        return 1

    # ------------------------------------------------------------------
    # kernel contract
    # ------------------------------------------------------------------

    def _apply_2x2(self, m2, target, cmask, cval) -> None:
        n = self.qubit_count
        if mat.is_invert(m2):
            tr, bl = complex(m2[0, 1]), complex(m2[1, 0])
            self._state = _gk.apply_invert(self._state, tr.real, tr.imag,
                                          bl.real, bl.imag, n, target,
                                          cmask, cval)
        else:
            mp = gk.mtrx_planes(m2, self.dtype, "cpu")
            self._state = _gk.apply_2x2(self._state, mp, n, target, cmask, cval)

    def _apply_diag(self, d0, d1, target, cmask, cval) -> None:
        d0, d1 = complex(d0), complex(d1)
        self._state = _gk.apply_diag(self._state, d0.real, d0.imag, d1.real,
                                    d1.imag, self.qubit_count, 1 << target,
                                    cmask, cval)

    def _k_apply_2x2(self, m2, target, controls, perm) -> None:
        cmask, cval = self._cmask_cval(controls, perm)
        self._apply_2x2(m2, target, cmask, cval)
        self._drift_tick()

    def _k_apply_diag(self, d0, d1, target, controls, perm) -> None:
        cmask, cval = self._cmask_cval(controls, perm)
        self._apply_diag(d0, d1, target, cmask, cval)
        self._drift_tick()

    def _k_apply_4x4(self, m4, q1, q2) -> None:
        m4 = np.asarray(m4, dtype=np.complex128)
        self._state = _gk.apply_4x4(self._state, np.stack([m4.real, m4.imag]),
                                   self.qubit_count, q1, q2)
        self._drift_tick()

    def UCMtrx(self, controls, mtrxs, target, mtrx_skip_powers=(), mtrx_skip_value_mask=0) -> None:
        """Uniformly-controlled gate in one batched product (reference
        kernel uniformlycontrolled, qengine.cl:409)."""
        if mtrx_skip_powers:
            return super().UCMtrx(controls, mtrxs, target, mtrx_skip_powers, mtrx_skip_value_mask)
        stack = np.stack([np.asarray(m, dtype=np.complex128).reshape(2, 2) for m in mtrxs])
        self._state = _gk.uc_2x2(self._state, np.stack([stack.real, stack.imag]),
                                self.qubit_count, target, tuple(controls))
        self._drift_tick()

    def _k_gather(self, src_fn, split=None) -> None:
        st = self._state
        self._state = _gk.gather(st, src_fn(gk.iota_for(st)))

    def _k_out_of_place(self, src_idx, dst_idx, passthrough_cmask) -> None:
        # the index pairs come from the host: int32 on the planes' device
        st = self._state
        src = torch.as_tensor(src_idx).to(gk.IDX_DTYPE).to(st.device)
        dst = torch.as_tensor(dst_idx).to(gk.IDX_DTYPE).to(st.device)
        self._state = _gk.out_of_place(st, src, dst, passthrough_cmask)

    def _index_table(self, values):
        return torch.as_tensor(np.asarray(values, dtype=np.int32)).to(
            self._device)

    def _k_phase_fn(self, fn, split=None) -> None:
        st = self._state
        fre, fim = fn(gk.plane_where(st), gk.iota_for(st))
        self._state = _gk.phase_factor_apply(st, fre, fim)

    def _k_probs(self) -> np.ndarray:
        return _gk.probs(self._state).to("cpu", torch.float64).numpy()

    def _k_prob_mask(self, mask, perm) -> float:
        p = _device_get(lambda st: float(_gk.prob_mask_sum(st, mask, perm)),
                        self._state)
        return min(max(p, 0.0), 1.0)

    def _k_collapse(self, mask, val, nrm_sq) -> None:
        self._state = _gk.collapse(self._state, mask, val, nrm_sq)

    def MAll(self) -> int:
        """Device-side categorical sample; no 2^n host transfer."""
        r = float(self.Rand())
        result = _device_get(lambda st: int(_gk.sample(st, r)), self._state)
        self.SetPermutation(result)
        return result

    def MultiShotMeasureMask(self, q_powers, shots: int) -> dict:
        """Batched sampling; only (shots,) small ints (on the CPU) or the
        row sums of the chosen segments (on the card,
        gatekernels.draw_indices) reach the host.  The card draws from
        the float64 uniforms, the CPU from uniforms in the planes' dtype,
        as the JAX engine does."""
        from ..utils.bits import log2

        st = self._state
        u = torch.as_tensor(self.rng.uniform(shots),
                            dtype=torch.float64 if st.device.type == "cuda"
                            else self.dtype).to(st.device)
        bits = torch.tensor([log2(int(pw)) for pw in q_powers],
                            dtype=torch.int64).to(st.device)
        keys = _gk.multishot_mask_keys(st, u, bits).cpu().numpy()
        vals, counts = np.unique(keys, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}

    def _k_compose(self, other, start) -> None:
        other_planes = self._put(other.GetQuantumState())
        self._state = _gk.compose(self._state, other_planes, self.qubit_count,
                                 other.qubit_count, start)

    def _k_decompose(self, start, length) -> np.ndarray:
        m = _gk.split_matrix(self._state, self.qubit_count, start, length)
        row_norms = torch.sum(m[0] ** 2 + m[1] ** 2, dim=1)
        r0 = int(torch.argmax(row_norms))
        dest = m[:, r0, :] / torch.sqrt(row_norms[r0])  # (2, 2^L)
        # rem = M @ conj(dest): plane algebra
        rem_re = m[0] @ dest[0] + m[1] @ dest[1]
        rem_im = m[1] @ dest[0] - m[0] @ dest[1]
        self._state = self._renormalized(torch.stack([rem_re, rem_im]))
        return gk.from_planes(dest)

    def _k_dispose(self, start, length, perm) -> None:
        m = _gk.split_matrix(self._state, self.qubit_count, start, length)
        if perm is not None:
            rem = m[:, :, perm]
        else:
            row_norms = torch.sum(m[0] ** 2 + m[1] ** 2, dim=1)
            r0 = int(torch.argmax(row_norms))
            dest = m[:, r0, :] / torch.sqrt(row_norms[r0])
            rem_re = m[0] @ dest[0] + m[1] @ dest[1]
            rem_im = m[1] @ dest[0] - m[0] @ dest[1]
            rem = torch.stack([rem_re, rem_im])
        self._state = self._renormalized(rem)

    @staticmethod
    def _renormalized(rem):
        rn = torch.sqrt(torch.sum(rem[0] ** 2 + rem[1] ** 2))
        return torch.where(rn > 0, rem / rn, rem).contiguous()

    def _k_allocate(self, start, length) -> None:
        self._state = _gk.allocate(self._state, self.qubit_count, start, length)

    def _k_normalize(self, nrm_sq) -> None:
        self._state = _gk.normalize(self._state, nrm_sq)

    def _k_sum_sqr_diff(self, other) -> float:
        if isinstance(other, QEngineCUDA):
            b = other._state.to(self._device, self.dtype)
        else:
            b = self._put(other.GetQuantumState())
        return float(_gk.sum_sqr_diff(self._state, b))

    def _k_swap_bits(self, q1, q2) -> None:
        self._state = _gk.swap_bits(self._state, self.qubit_count, q1, q2)

    def ExpectationBitsAll(self, bits, offset: int = 0) -> float:
        """One device reduction; the distribution never reaches the host."""
        return float(_gk.expectation_bits(self._state, tuple(bits), offset))

    # ------------------------------------------------------------------
    # state access (host boundary: complex <-> planes)
    # ------------------------------------------------------------------

    def _put(self, state_complex):
        return gk.to_planes(state_complex, self.dtype, self._device)

    def GetQuantumState(self) -> np.ndarray:
        return _device_get(gk.from_planes, self._state)

    def SetQuantumState(self, state) -> None:
        st = np.asarray(state).reshape(-1)
        if st.shape[0] != (1 << self.qubit_count):
            raise ValueError("state length mismatch")
        self._state = self._put(st)

    def GetAmplitude(self, perm: int) -> complex:
        amp = _device_get(
            lambda st: st[:, perm].to("cpu", torch.float64).numpy(),
            self._state)
        return complex(amp[0], amp[1])

    def SetAmplitude(self, perm: int, amp: complex) -> None:
        amp = complex(amp)
        st = self._state  # the engine owns its planes: write in place
        st[0, perm] = amp.real
        st[1, perm] = amp.imag

    def SetPermutation(self, perm: int, phase=None) -> None:
        ph = self._rand_phase() if phase is None else complex(phase)
        st = torch.zeros((2, 1 << self.qubit_count), dtype=self.dtype,
                         device=self._device)
        st[0, perm] = ph.real
        st[1, perm] = ph.imag
        self._state = st
        self.running_norm = 1.0

    def Clone(self) -> "QEngineCUDA":
        c = self.CloneEmpty()
        c._state = self._state.clone()  # the planes update in place: copy
        return c

    def CloneEmpty(self) -> "QEngineCUDA":
        return QEngineCUDA(
            self.qubit_count, dtype=self.dtype, device=self._device,
            rng=self.rng.spawn(), do_normalize=self.do_normalize,
            rand_global_phase=self.rand_global_phase,
        )

    def Finish(self) -> None:
        st = self._state
        if st is not None and st.device.type == "cuda":
            _device_get(torch.cuda.synchronize, st.device)

    def SetDevice(self, device_id: int) -> None:
        """Move the ket to CUDA ordinal `device_id` (reference: SetDevice,
        opencl.cpp:535).  An engine on the CPU ignores placement."""
        if self._device.type != "cuda":
            return
        dev = torch.device("cuda", device_id)
        if dev == self._device:
            return
        self._device = discover(dev)
        self._state = self._state.to(dev)

    def GetDevice(self) -> int:
        """The card's ordinal (``cuda`` without one reads as the current
        card); -1 on the CPU."""
        if self._device.type != "cuda":
            return -1
        if self._device.index is not None:
            return self._device.index
        return torch.cuda.current_device()

    def ZeroAmplitudes(self) -> None:
        self._state = torch.zeros_like(self._state_raw)

    def IsZeroAmplitude(self) -> bool:
        return not bool(torch.any(self._state != 0))

    def GetAmplitudePage(self, offset: int, length: int) -> np.ndarray:
        return _device_get(
            lambda st: gk.from_planes(st[:, offset:offset + length]),
            self._state)

    def SetAmplitudePage(self, page, offset: int) -> None:
        self._state[:, offset:offset + len(page)] = self._put(page)

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py)
    # ------------------------------------------------------------------

    # the file format's tag for the dense split-plane ket, which the JAX
    # package's reader knows as its QEngineTPU's
    _ckpt_kind = "tpu"

    def _ckpt_capture(self, capture_child):
        # reads through _state (the pending window flushes first) and
        # copies to the host: nothing of the engine changes.  bf16/f16
        # planes upcast losslessly to float32 for the archive; the dtype
        # name restores the resident representation
        st = self._state
        host_dt = torch.float64 if st.dtype == torch.float64 else torch.float32
        planes = st.to("cpu").to(host_dt).numpy()
        return {"kind": "tpu",
                "meta": {"n": self.qubit_count,
                         "dtype": gk.dtype_name(self.dtype),
                         "gate_count": int(self._gate_count),
                         "running_norm": float(self.running_norm)},
                "arrays": {"planes": planes}}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self.dtype = gk.plane_dtype(meta["dtype"])
        host = torch.from_numpy(np.ascontiguousarray(arrays["planes"]))
        if host.shape != (2, 1 << self.qubit_count):
            raise ValueError("checkpoint planes shape mismatch")
        old = self._state_raw
        if (old is not None and old.dtype == self.dtype
                and tuple(old.shape) == tuple(host.shape)):
            # in place: a w30 load holds no second ket on the card
            if self._fuser is not None:
                self._fuser.drop()
            old.copy_(host)
        else:
            self._state = None
            self._state = host.to(self._device).to(self.dtype)
        self._gate_count = int(meta.get("gate_count", 0))
        self.running_norm = float(meta.get("running_norm", 1.0))
