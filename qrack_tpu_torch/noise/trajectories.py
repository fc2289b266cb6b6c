"""Shot-parallel Monte-Carlo trajectories: the batched channel engine.

A (circuit, NoiseModel, B) job lowers into one op stream that runs over
(B, 2, 2^n) planes, a leading trajectory axis on the split-plane ket.
The stochastic part — which Kraus branch fired at each
channel-application slot of each trajectory — is sampled host-side from
the counter-based rng (:func:`channels.traj_uniform`) into
per-trajectory operand tensors (B, ...), exactly like the parametric
gate payloads in :mod:`qrack_tpu_torch.ops.fusion`, whose payloads are
broadcast across the batch.  The whole B-trajectory chunk then runs as
one pass per op over the batch, and only O(B·n) scalars of readout
cross to the host.

Port note: the JAX package runs this stream as ``jax.jit(jax.vmap(body))``
of an XLA window (no Pallas kernel).  Here the body is plain torch over
the batch axis: the batched gate functions below (:func:`apply_2x2`,
:func:`apply_diag`, :func:`apply_invert`, :func:`apply_cphase`, the
"kraus" renormalise-and-weight step) take per-trajectory operands,
where ops/gatekernels.py takes one host matrix and one ket.  Telemetry,
as in the JAX package: ``noise.traj.windows`` a window and its planned
bytes (``roofline.cuda.fuse.flush``, one sweep of the chunk an op), and
per :func:`run_trajectories` call ``noise.traj.batches``,
``.trajectories``, ``.chunks``, ``.chunked``, ``.slots``, the
``noise.traj.chunk_size`` and ``.rate`` gauges and the
``noise.traj.wall_s`` histogram (the wall ends with the readout's copy
to the host, which waits for the device).  The program cache has no
counterpart (torch has no trace to cache).  With the resilience plane
armed (resilience/), each batched window is one guarded dispatch at the
gate fuser's site ``cuda.fuse.flush`` (its in-place writes to the
batch watched), and the host-side branch sampling checks the fault site
``noise.sample``.  The serving entry is serve/service.py
``submit_trajectories``, with its write-ahead replay at ``recover``
(ROADMAP item 16b).

Memory: a chunk of C trajectories of width w holds C · 2^w amplitudes
of planes, and the body allocates its results and temporaries beside
them.  :data:`BYTES_PER_AMP` is the measured peak of device memory a
float32 trajectory amplitude costs while the body runs (the JAX package
prices a dense amplitude at 16 bytes, route/cost.py, without a
measurement of its vmapped body).  ``QRACK_NOISE_TRAJ_CHUNK`` overrides the trajectory
chunk; by default the largest chunk whose peak fits the device's free
memory (``torch.cuda.mem_get_info``; ``QRACK_ROUTE_HBM_BYTES``
overrides it, 16 GiB on the CPU) is used and the batch runs as
ceil(B/chunk) passes.

Windowing: by default the whole lowered stream is one window.
``QRACK_NOISE_TRAJ_WINDOW=k`` splits it into k-op windows (the parity
tests drive this at 1 and 16) with the ket planes and the trajectory
weight threaded between windows.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resilience as _res
from .. import telemetry as _tele
from ..config import get_config
from ..ops import fusion as fu
from ..ops import gatekernels as gk
from ..telemetry import roofline as _roofline
from ..utils.device import resolve_device
from .channels import MEASURE_DOMAIN, KrausChannel, NoiseModel, traj_uniform

#: peak device bytes per amplitude of a float32 trajectory while the
#: batched body runs: the planes (8) and one op's result beside them (8;
#: the readout's squares and sums take 8 too).  Measured with
#: torch.cuda.max_memory_allocated by chip_smoke.py's trajectories phase
#: on an H100 (w24: 16.08 with B = 64 under depolarizing noise; under
#: amplitude damping 16.50 with B = 16, and 16.40 with the chunk of 20
#: that a budget of 20.5 trajectories sized), rounded up; scaled by the
#: element size for other plane dtypes.  The JAX package's 16 is its dense
#: coefficient for one resident ket, not a measured peak of this body.
BYTES_PER_AMP = 17

_I2 = np.eye(2, dtype=np.complex128)

#: the budget where no device reports one (the JAX package's fallback)
DEFAULT_BUDGET_BYTES = 16 << 30


def traj_window_len() -> int:
    """Ops per trajectory window; 0 (default) = whole stream as ONE
    window."""
    try:
        w = int(os.environ.get("QRACK_NOISE_TRAJ_WINDOW", "0"))
    except ValueError:
        w = 0
    return max(0, w)


def budget_bytes(device=None) -> int:
    """Device memory a trajectory chunk may take: the router's budget
    for this device (route/cost.py ``hbm_budget_bytes`` over
    ``RouteKnobs.for_device``: ``QRACK_ROUTE_HBM_BYTES`` when set, else
    a CUDA device's total memory, else DEFAULT_BUDGET_BYTES, less any
    reservation made through ``set_hbm_reservation``), as in the JAX
    package; without ``QRACK_ROUTE_HBM_BYTES``, on a CUDA device no more
    than its free memory less that reservation."""
    from ..route import cost as _cost

    if _cost.RouteKnobs.from_env().hbm_bytes > 0:
        return _cost.hbm_budget_bytes()
    dev = torch.device("cuda" if device is None else device)
    budget = _cost.hbm_budget_bytes(_cost.RouteKnobs.for_device(dev))
    if dev.type == "cuda" and torch.cuda.is_available():
        free, _total = torch.cuda.mem_get_info(dev)
        return min(budget, _cost.less_reservation(int(free)))
    return budget


def traj_chunk(width: int, trajectories: int, device=None,
               dtype=torch.float32) -> int:
    """Trajectory chunk size: ``QRACK_NOISE_TRAJ_CHUNK`` override, else
    the largest chunk whose peak (chunk · BYTES_PER_AMP · 2^w, scaled to
    the plane dtype) fits :func:`budget_bytes`.  Raises MemoryError when
    not even one trajectory fits (the JAX package starts a chunk of one
    all the same), so a chunk that cannot fit never starts."""
    env = os.environ.get("QRACK_NOISE_TRAJ_CHUNK", "")
    if env:
        try:
            return max(1, min(int(trajectories), int(env)))
        except ValueError:
            pass
    esize = torch.empty((), dtype=dtype).element_size()
    per = BYTES_PER_AMP * esize / 4.0 * float(2 ** int(width))
    budget = budget_bytes(device)
    fit = int(budget // per)
    if fit < 1:
        raise MemoryError(
            f"one width-{width} trajectory needs {per:.0f} bytes at its "
            f"peak; the budget is {budget} bytes")
    return min(int(trajectories), fit)


# ---------------------------------------------------------------------------
# lowering: (circuit, NoiseModel) -> flat noisy op stream
# ---------------------------------------------------------------------------

class NoiseSlot:
    """One channel application in the schedule: channel `ch` on `qubit`
    at application counter `seq` (the rng coordinate)."""

    __slots__ = ("qubit", "ch", "seq")

    def __init__(self, qubit: int, ch: KrausChannel, seq: int):
        self.qubit = qubit
        self.ch = ch
        self.seq = seq


def lower_noisy(circuit, model: NoiseModel) -> List[object]:
    """Interleave the circuit's lowered gate ops with the model's
    channel slots: per QCircuitGate, its FusedOps (payload perms in
    sorted order), then one slot per touched qubit per attached channel
    — the same schedule :meth:`channels.QNoisy.run_circuit` walks, with
    `seq` numbering the slots monotonically."""
    ops: List[object] = []
    seq = 0
    for g in circuit.gates:
        ops.extend(fu.lower_gates([g]))
        for q, ch in model.slots_for((g.target,) + tuple(g.controls)):
            ops.append(NoiseSlot(q, ch, seq))
            seq += 1
    return ops


def structure_of(ops: Sequence[object]) -> Tuple:
    """A window's identity.  Mixed-unitary noise slots are structurally
    plain "gen" ops — which branch fired is operand data — while
    general-Kraus slots get their own "kraus" kind (they carry a prior
    operand and touch the weight)."""
    out = []
    for op in ops:
        if isinstance(op, NoiseSlot):
            out.append(("kraus" if not op.ch.unitary else "gen",
                        op.qubit, False))
        else:
            out.append((op.kind, op.target, op.cmask != 0))
    return tuple(out)


# ---------------------------------------------------------------------------
# batched gate functions: planes (B, 2, 2^n), operands (B, ...)
# ---------------------------------------------------------------------------

def _halves(planes, n: int, target: int):
    """(B, 2, high, 2, low) view of batched planes, split at `target`."""
    return planes.view(planes.shape[0], 2, 1 << (n - 1 - target), 2,
                       1 << target)


def _col(x):
    """A (B,) operand as (B, 1, 1), to broadcast over (B, high, low)."""
    return x[:, None, None]


def _ctrl_select(new, old, cmask: int, cval: int):
    """`new` where the control bits of the flat index read `cval`, `old`
    elsewhere, written over `new`; the index mask (2^n,) is shared by the
    batch."""
    keep = (gk.iota_for(new[0]) & cmask) == cval
    return torch.where(keep, new, old, out=new)


def _mix_into(o, terms) -> None:
    """o = sum of c * x over the (c, x) terms, c a (B, 1, 1) factor: one
    pass over o for each term, and no temporary (the batch makes every
    temporary B kets wide)."""
    (c, x), rest = terms[0], terms[1:]
    torch.mul(x, c, out=o)
    for c, x in rest:
        o.addcmul_(x, c)


def apply_2x2(planes, mp, n: int, target: int, cmask: int = 0, cval: int = 0):
    """A (controlled) 2x2 on every trajectory: `mp` is (B, 2, 2, 2)
    matrix planes [trajectory, plane, row, col]; a new tensor."""
    v = _halves(planes, n, target)
    a0r, a1r = v[:, 0, :, 0, :], v[:, 0, :, 1, :]
    a0i, a1i = v[:, 1, :, 0, :], v[:, 1, :, 1, :]
    out = torch.empty_like(planes)
    ov = _halves(out, n, target)
    for r in range(2):
        mr0, mi0 = _col(mp[:, 0, r, 0]), _col(mp[:, 1, r, 0])
        mr1, mi1 = _col(mp[:, 0, r, 1]), _col(mp[:, 1, r, 1])
        _mix_into(ov[:, 0, :, r, :], ((mr0, a0r), (-mi0, a0i), (mr1, a1r),
                                      (-mi1, a1i)))
        _mix_into(ov[:, 1, :, r, :], ((mr0, a0i), (mi0, a0r), (mr1, a1i),
                                      (mi1, a1r)))
    if cmask == 0:
        return out
    return _ctrl_select(out, planes, cmask, cval)


def _cmul_into(ov, v, bit: int, fre, fim, src: int = None) -> None:
    """ov[..., bit, :] = (fre + i fim) * v[..., src, :] on (B, 2, high,
    2, low) views (src = bit unless given); the factor is (B, 1, 1)."""
    src = bit if src is None else src
    xr, xi = v[:, 0, :, src, :], v[:, 1, :, src, :]
    _mix_into(ov[:, 0, :, bit, :], ((fre, xr), (-fim, xi)))
    _mix_into(ov[:, 1, :, bit, :], ((fim, xr), (fre, xi)))


def apply_diag(planes, d, n: int, target: int, cmask: int = 0, cval: int = 0):
    """diag(d0, d1) on `target` per trajectory: `d` is (B, 2, 2)
    [[d0.re, d0.im], [d1.re, d1.im]]; a new tensor."""
    v = _halves(planes, n, target)
    out = torch.empty_like(planes)
    ov = _halves(out, n, target)
    for bit in range(2):
        _cmul_into(ov, v, bit, _col(d[:, bit, 0]), _col(d[:, bit, 1]))
    if cmask == 0:
        return out
    return _ctrl_select(out, planes, cmask, cval)


def apply_invert(planes, p, n: int, target: int, cmask: int = 0,
                 cval: int = 0):
    """Anti-diagonal [[0, tr], [bl, 0]] on `target` per trajectory: `p`
    is (B, 2, 2) [[tr.re, tr.im], [bl.re, bl.im]]; a new tensor."""
    v = _halves(planes, n, target)
    out = torch.empty_like(planes)
    ov = _halves(out, n, target)
    for bit in range(2):
        _cmul_into(ov, v, bit, _col(p[:, bit, 0]), _col(p[:, bit, 1]),
                   src=1 - bit)
    if cmask == 0:
        return out
    return _ctrl_select(out, planes, cmask, cval)


def apply_cphase(planes, p, n: int, target: int, cmask: int = 0):
    """Phase (p.re + i p.im) where `target` and every control bit are 1,
    per trajectory: `p` is (B, 2); a new tensor."""
    v = _halves(planes, n, target)
    out = planes.clone()
    ov = _halves(out, n, target)
    _cmul_into(ov, v, 1, _col(p[:, 0]), _col(p[:, 1]))
    if cmask == 0:
        return out
    return _ctrl_select(out, planes, cmask, cmask)


def apply_kraus(planes, weight, mp, prior, n: int, target: int):
    """The raw Kraus branch on `target`, then renormalise and weigh each
    trajectory by ‖K|ψ⟩‖²/q.  A branch can annihilate the state (e.g.
    amplitude damping's K1 on a qubit with no |1> amplitude): that
    trajectory is dead — weight 0, ket reset to |0...0> so the rest of
    the schedule stays finite; QNoisy mirrors this exactly (the rng
    parity contract).  Returns (planes, weight)."""
    planes = apply_2x2(planes, mp, n, target)
    B = planes.shape[0]
    n2 = torch.linalg.vector_norm(planes.view(B, -1), dim=1).square()
    dead = n2 <= 0
    safe = torch.where(dead, torch.ones_like(n2), n2)
    planes.mul_(torch.rsqrt(safe)[:, None, None])
    reset = torch.zeros(planes.shape[1:], dtype=planes.dtype,
                        device=planes.device)
    reset[0, 0] = 1
    torch.where(dead[:, None, None], reset, planes, out=planes)
    weight = torch.where(dead, torch.zeros_like(weight),
                         weight * (n2.to(weight.dtype) / prior))
    return planes, weight


# ---------------------------------------------------------------------------
# the window bodies
# ---------------------------------------------------------------------------

def _traj_body(n: int, structure: Tuple):
    """fn(box, weight, *operands) -> (planes, weight) over a chunk.  The
    planes come in `box`, a one-slot list that fn empties: a caller that
    held them would keep the input ket alive beside every op's output
    (a call's arguments stay referenced until it returns).  Gate
    dispatch mirrors fusion.window_fn; masks are Python ints."""

    def fn(box, weight, *operands):
        planes = box.pop()
        i = 0
        for kind, target, has_ctrl in structure:
            p = operands[i]
            i += 1
            if p is None:   # a noise slot every trajectory left alone
                continue
            if kind == "kraus":
                prior = operands[i]
                i += 1
                planes, weight = apply_kraus(planes, weight, p, prior, n,
                                             target)
                continue
            if has_ctrl:
                cm, cv = operands[i], operands[i + 1]
                i += 2
            else:
                cm = cv = 0
            if kind == "cphase":
                planes = apply_cphase(planes, p, n, target, cm)
            elif kind == "diag":
                planes = apply_diag(planes, p, n, target, cm, cv)
            elif kind == "inv":
                planes = apply_invert(planes, p, n, target, cm, cv)
            else:
                planes = apply_2x2(planes, p, n, target, cm, cv)
        return planes, weight

    return fn


def readout(planes, u):
    """Per-trajectory P(1) of every qubit and the categorical draw of
    the terminal measurement from uniform `u` (B,), on the planes'
    device: only O(B·n) scalars leave it.  The cumulative sum stays in
    the planes' dtype, as in the JAX package."""
    B, _, N = planes.shape
    n = N.bit_length() - 1
    p = torch.square(planes[:, 0])
    p.addcmul_(planes[:, 1], planes[:, 1])
    norm = p.sum(dim=1)
    p1 = torch.stack([
        p.view(B, 1 << (n - 1 - q), 2, 1 << q)[:, :, 1, :].sum(dim=(1, 2))
        for q in range(n)], dim=1) / norm[:, None]
    cdf = torch.cumsum(p, dim=1)
    s = torch.searchsorted(cdf, (u.to(p.dtype) * cdf[:, -1])[:, None],
                           right=True)[:, 0]
    return p1, torch.clamp(s, max=N - 1)


def _traj_final(n: int, structure: Tuple):
    """The last window: the ops, then :func:`readout`."""
    body = _traj_body(n, structure)

    def fn(box, weight, u, *operands):
        planes, weight = body(box, weight, *operands)
        p1, s = readout(planes, u)
        return planes, weight, p1, s

    return fn


# ---------------------------------------------------------------------------
# host-side branch pre-sampling
# ---------------------------------------------------------------------------

def _is_identity(m, dtype) -> bool:
    """Is the 2x2 `m`, rounded to the planes' dtype, the identity?
    (depolarizing's "I" branch is 1 - 1.1e-16 in float64, exactly 1 in
    float32)"""
    return torch.equal(gk.host_tensor(np.stack([m.real, m.imag]), dtype),
                       gk.host_tensor(np.stack([_I2.real, _I2.imag]), dtype))


def _sample_operands(ops: Sequence[object], key: int,
                     tids: Sequence[int], dtype, device) -> List:
    """The operand vector for one window and one trajectory chunk: gate
    payloads broadcast across the batch (masks stay Python ints), noise
    slots sampled per trajectory from (key, trajectory_id, seq).  A
    mixed-unitary slot whose every trajectory drew an identity branch
    (depolarizing's "I", most draws at a weak rate) gets None: the body
    skips it, which leaves the planes as that matrix, rounded to the
    planes' dtype, would."""
    if _res._ACTIVE:
        directive = _res.faults.check("noise.sample")
        if directive:
            raise RuntimeError(f"noise.sample injected fault: {directive}")
    B = len(tids)
    out: List = []
    for op in ops:
        if isinstance(op, NoiseSlot):
            idxs = [op.ch.sample(traj_uniform(key, t, op.seq))
                    for t in tids]
            if op.ch.unitary and all(_is_identity(op.ch.branch_matrix(i),
                                                  dtype) for i in set(idxs)):
                out.append(None)
                continue
            mats = np.stack([op.ch.branch_matrix(i) for i in idxs])
            out.append(gk.host_tensor(
                np.stack([mats.real, mats.imag], axis=1), dtype).to(device))
            if not op.ch.unitary:
                out.append(torch.tensor(
                    [op.ch.priors[i] for i in idxs], dtype=torch.float32,
                    device=device))
            continue
        for arr in fu.dense_operands([op], dtype):
            if isinstance(arr, torch.Tensor):
                arr = arr.to(device).expand((B,) + tuple(arr.shape))
            out.append(arr)
    return out


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

class TrajectoryResult:
    """Per-trajectory readout + the channel-averaged aggregate.

    `p1` is (B, n) per-qubit P(1), `weights` (B,) importance weights
    (all-ones for mixed-unitary models), `samples` (B,) the terminal
    measurement draw of each trajectory, `aggregate_p1` the
    weight-averaged per-qubit P(1) — the Monte-Carlo estimate of the
    channel-averaged observable.
    """

    __slots__ = ("width", "key", "trajectory_ids", "p1", "weights",
                 "samples", "chunks", "planes")

    def __init__(self, width: int, key: int, trajectory_ids, p1, weights,
                 samples, chunks: int, planes=None):
        self.width = int(width)
        self.key = int(key)
        self.trajectory_ids = np.asarray(trajectory_ids, dtype=np.int64)
        self.p1 = np.asarray(p1, dtype=np.float64)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.samples = np.asarray(samples, dtype=np.int64)
        self.chunks = int(chunks)
        self.planes = planes

    @property
    def trajectories(self) -> int:
        return int(self.p1.shape[0])

    @property
    def aggregate_p1(self) -> np.ndarray:
        w = self.weights
        return (w[:, None] * self.p1).sum(axis=0) / w.sum()

    def expectation_z(self, qubit: int) -> float:
        """Channel-averaged <Z_qubit> = 1 - 2 P(1)."""
        return float(1.0 - 2.0 * self.aggregate_p1[int(qubit)])

    def to_dict(self) -> dict:
        return {
            "width": self.width,
            "key": self.key,
            "trajectory_ids": self.trajectory_ids.tolist(),
            "p1": self.p1.tolist(),
            "weights": self.weights.tolist(),
            "samples": self.samples.tolist(),
            "chunks": self.chunks,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TrajectoryResult":
        return cls(d["width"], d["key"], d["trajectory_ids"], d["p1"],
                   d["weights"], d["samples"], d["chunks"])


# ---------------------------------------------------------------------------
# the job object (chunk loop + mid-batch checkpoint)
# ---------------------------------------------------------------------------

def _host(t, dtype=torch.float64) -> np.ndarray:
    return t.detach().to("cpu", dtype).numpy()


def _window(fn, box, *args):
    """One batched window, fn(box, *args): one guarded dispatch at
    ``cuda.fuse.flush`` while the resilience plane is armed.  The body
    takes the planes out of the one-slot `box` and writes them in place,
    so the guard watches both (a retry runs only a window that touched
    nothing)."""
    if not _res._ACTIVE:
        return fn(box, *args)
    from ..resilience import dispatch as _rdispatch

    held = list(box)
    return _rdispatch.call_guarded(
        "cuda.fuse.flush", fn, (box,) + args,
        writes=lambda: (len(box), _rdispatch.write_token(held)))


class TrajectoryJob:
    """Chunked execution of a trajectory batch with mid-batch
    checkpointing.

    Because every trajectory is a pure function of (key, trajectory_id),
    a snapshot needs only the finished chunks' outputs and the next
    chunk index — resuming re-derives the remaining trajectories'
    randomness from the counters and lands bit-identical to an
    uninterrupted run.  The planes live on `device` (``cuda`` unless
    the caller passes ``device="cpu"``).
    """

    def __init__(self, circuit, model: NoiseModel, trajectories: int, *,
                 width: int, key: int = 0,
                 trajectory_ids: Optional[Sequence[int]] = None,
                 dtype=None, keep_planes: bool = False, device=None):
        self.circuit = circuit
        self.model = model
        self.width = int(width)
        self.key = int(key)
        if trajectory_ids is None:
            trajectory_ids = range(int(trajectories))
        self.tids = [int(t) for t in trajectory_ids]
        if len(self.tids) != int(trajectories):
            raise ValueError("trajectory_ids length != trajectories")
        self.device = resolve_device(device)
        self.dtype = gk.plane_dtype(dtype) if dtype is not None else \
            get_config().device_real_dtype()
        self.keep_planes = bool(keep_planes)
        self.chunk = traj_chunk(self.width, len(self.tids), self.device,
                                self.dtype)
        self._ops = lower_noisy(circuit, model)
        self._next = 0
        self._done: List[dict] = []
        self._planes: List[np.ndarray] = []

    # -- chunk geometry ------------------------------------------------

    @property
    def n_chunks(self) -> int:
        B = len(self.tids)
        return max(1, (B + self.chunk - 1) // self.chunk)

    def _chunk_tids(self, ci: int) -> List[int]:
        return self.tids[ci * self.chunk:(ci + 1) * self.chunk]

    @property
    def finished(self) -> bool:
        return self._next >= self.n_chunks

    # -- execution -----------------------------------------------------

    def _windows(self) -> List[List[object]]:
        w = traj_window_len()
        if w <= 0 or w >= len(self._ops):
            return [list(self._ops)]
        return [list(self._ops[i:i + w])
                for i in range(0, len(self._ops), w)]

    def step(self) -> None:
        """Run the next trajectory chunk, window by window, and read its
        outputs back to the host."""
        if self.finished:
            return
        tids = self._chunk_tids(self._next)
        C = len(tids)
        n = self.width
        esize = torch.empty((), dtype=self.dtype).element_size()
        # the planes ride a one-slot list that each window empties
        box = [torch.zeros((C, 2, 1 << n), dtype=self.dtype,
                           device=self.device)]
        box[0][:, 0, 0] = 1.0
        weight = torch.ones((C,), dtype=torch.float32, device=self.device)
        windows = self._windows()
        u = torch.tensor(
            [traj_uniform(self.key, t, 0, domain=MEASURE_DOMAIN)
             for t in tids], dtype=torch.float32, device=self.device)
        for wi, ops in enumerate(windows):
            struct = structure_of(ops)
            operands = _sample_operands(ops, self.key, tids, self.dtype,
                                        self.device)
            if wi == len(windows) - 1:
                planes, weight, p1, samp = _window(
                    _traj_final(n, struct), box, weight, u, *operands)
            else:
                planes, weight = _window(_traj_body(n, struct), box, weight,
                                         *operands)
                box.append(planes)
                del planes
            if _tele._ENABLED:
                _tele.inc("noise.traj.windows")
                _roofline.note_bytes(
                    "cuda.fuse.flush",
                    len(ops) * C * _roofline.plane_pass_bytes(n, esize))
        self._done.append({
            "tids": tids,
            "p1": _host(p1),
            "weights": _host(weight),
            "samples": _host(samp, torch.int64),
        })
        if self.keep_planes:
            self._planes.append(_host(planes))
        self._next += 1

    def run(self) -> "TrajectoryJob":
        while not self.finished:
            self.step()
        return self

    # -- checkpoint / resume -------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable mid-batch state: finished chunk outputs +
        the resume cursor.  The rng needs no saved position — it is the
        (key, trajectory_id, seq) counters."""
        return {
            "kind": "noise.trajectories",
            "width": self.width,
            "key": self.key,
            "trajectory_ids": list(self.tids),
            "chunk": self.chunk,
            "next": self._next,
            "done": [{
                "tids": list(d["tids"]),
                "p1": d["p1"].tolist(),
                "weights": d["weights"].tolist(),
                "samples": d["samples"].tolist(),
            } for d in self._done],
        }

    @classmethod
    def resume(cls, circuit, model: NoiseModel, snap: dict,
               dtype=None, device=None) -> "TrajectoryJob":
        job = cls(circuit, model, len(snap["trajectory_ids"]),
                  width=snap["width"], key=snap["key"],
                  trajectory_ids=snap["trajectory_ids"], dtype=dtype,
                  device=device)
        job.chunk = int(snap["chunk"])
        job._next = int(snap["next"])
        job._done = [{
            "tids": [int(t) for t in d["tids"]],
            "p1": np.asarray(d["p1"], dtype=np.float64),
            "weights": np.asarray(d["weights"], dtype=np.float64),
            "samples": np.asarray(d["samples"], dtype=np.int64),
        } for d in snap["done"]]
        return job

    # -- assembly ------------------------------------------------------

    def result(self) -> TrajectoryResult:
        if not self.finished:
            raise RuntimeError("trajectory job not finished")
        tids = [t for d in self._done for t in d["tids"]]
        p1 = np.concatenate([d["p1"] for d in self._done]) if self._done \
            else np.zeros((0, self.width))
        weights = np.concatenate([d["weights"] for d in self._done]) \
            if self._done else np.zeros((0,))
        samples = np.concatenate([d["samples"] for d in self._done]) \
            if self._done else np.zeros((0,), dtype=np.int64)
        planes = np.concatenate(self._planes) if self._planes else None
        return TrajectoryResult(self.width, self.key, tids, p1, weights,
                                samples, self.n_chunks, planes=planes)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def run_trajectories(circuit, model: NoiseModel, trajectories: int, *,
                     width: Optional[int] = None, key: int = 0,
                     trajectory_ids: Optional[Sequence[int]] = None,
                     dtype=None, keep_planes: bool = False,
                     device=None) -> TrajectoryResult:
    """Run B noisy Monte-Carlo trajectories of `circuit` under `model`
    as batched passes on `device` (``cuda`` unless the caller passes
    ``device="cpu"``)."""
    if width is None:
        width = max((max((g.target,) + tuple(g.controls))
                     for g in circuit.gates), default=0) + 1
    B = int(trajectories)
    if B <= 0:
        raise ValueError("trajectories must be positive")
    t0 = time.perf_counter()
    job = TrajectoryJob(circuit, model, B, width=width, key=key,
                        trajectory_ids=trajectory_ids, dtype=dtype,
                        keep_planes=keep_planes, device=device)
    job.run()
    wall = time.perf_counter() - t0
    if _tele._ENABLED:
        _tele.inc("noise.traj.batches")
        _tele.inc("noise.traj.trajectories", float(B))
        _tele.inc("noise.traj.chunks", float(job.n_chunks))
        if job.n_chunks > 1:
            _tele.inc("noise.traj.chunked")
        nslots = sum(1 for op in job._ops if isinstance(op, NoiseSlot))
        _tele.inc("noise.traj.slots", float(nslots * B))
        _tele.gauge("noise.traj.chunk_size", job.chunk)
        _tele.observe("noise.traj.wall_s", wall)
        if wall > 0:
            _tele.gauge("noise.traj.rate", B / wall)
    return job.result()
