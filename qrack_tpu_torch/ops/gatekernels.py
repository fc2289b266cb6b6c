"""Plain PyTorch gate functions over a dense split-plane state vector.

Counterpart of the JAX package's XLA gate programs (reference:
src/common/qengine.cl:144-1085 apply2x2*/x/z/phase/invert/compose/
decompose/prob*/nrmlze/applym). None of these is a hand-written
kernel: they are eager torch programs, the role XLA played there.

Representation: **split real/imag planes** — the ket is a real tensor of
shape (2, 2^n), plane 0 = Re, plane 1 = Im, so complex arithmetic is
written out as plane algebra and the layout matches the fused window
kernel's operands (ops/window_kernel.py).

Rules:
  * Every function returns a new tensor and leaves its input alone; the
    engine decides where the result lives.
  * Gate payloads and masks are host scalars (Python floats and ints),
    so no call waits on the device to read them.

Index convention: qubit q is bit q of the flat index; axis split for
target t is (high = 2^(n-1-t), 2, low = 2^t).
"""

from __future__ import annotations

import functools
import math
import types

import numpy as np
import torch

from ..utils.device import resolve_device

# Flat indices are int32: a single dense shard holds at most 2^30
# amplitudes (engines/cuda.py MAX_DENSE_QB), so every mask fits.
IDX_DTYPE = torch.int32

#: the planes' dtypes, by name (the FPPOW policy, config.py)
PLANE_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                "bfloat16": torch.bfloat16, "float16": torch.float16}


def plane_dtype(dtype) -> torch.dtype:
    """A plane dtype from a torch dtype or its name; raises for any
    other."""
    dt = PLANE_DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if dt not in PLANE_DTYPES.values():
        raise ValueError(f"plane dtype must be one of {sorted(PLANE_DTYPES)}, "
                         f"not {dtype!r}")
    return dt


def dtype_name(dtype) -> str:
    """A plane dtype's name, as in PLANE_DTYPES."""
    return str(dtype).removeprefix("torch.")


def compute_dtype(dtype) -> torch.dtype:
    """The dtype arithmetic over planes of `dtype` runs in: float64 for
    float64 planes, float32 for the others (16-bit planes are read into
    float32 and rounded once, at the store)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# plane representation helpers
# ---------------------------------------------------------------------------

def host_tensor(values, dtype=torch.float32) -> torch.Tensor:
    """Host float values as a CPU tensor in `dtype`, rounded as the JAX
    package rounds them: float16 directly from float64 (numpy's rule),
    bfloat16 through float32 (ml_dtypes' rule, which torch's conversion
    follows)."""
    a = np.asarray(values, dtype=np.float64)
    if dtype == torch.float16:
        return torch.from_numpy(a.astype(np.float16))
    return torch.from_numpy(a).to(dtype)


def to_planes(state_complex, dtype=torch.float32, device=None):
    """Host complex vector -> (2, N) real planes on `device`, ``cuda`` by
    default (a copy)."""
    arr = np.asarray(state_complex)
    return host_tensor(np.stack([arr.real, arr.imag]), dtype).to(
        resolve_device(device))


def from_planes(planes) -> np.ndarray:
    """(2, N) real planes -> host complex128 vector."""
    host = planes.detach().to("cpu", torch.float64).numpy()
    return host[0] + 1j * host[1]


def mtrx_planes(m, dtype=torch.float32, device=None):
    """Host complex (d, d) matrix -> (2, d, d) real planes on `device`,
    ``cuda`` by default."""
    m = np.asarray(m)
    return host_tensor(np.stack([m.real, m.imag]), dtype).to(
        resolve_device(device))


def _host_planes(mp) -> np.ndarray:
    """(2, d, d) matrix planes as host floats, whatever form they came in."""
    if isinstance(mp, torch.Tensor):
        return mp.detach().to("cpu", torch.float64).numpy()
    return np.asarray(mp, dtype=np.float64)


def _dev_planes(mp, like):
    """Matrix planes in `like`'s dtype on its device; a tensor already
    there is used as it is (no host round trip, no wait on the device)."""
    if isinstance(mp, torch.Tensor):
        return mp.to(like.device, like.dtype)
    return host_tensor(mp, like.dtype).to(like.device)


def _mix(mp):
    """(2, d, d) matrix planes -> (2, d, 2, d) real mixing tensor M with
    out[P, A] = sum_{p, a} M[P, A, p, a] * v[p, a], implementing complex
    multiply: Re' = Re·re - Im·im ; Im' = Re·im + Im·re."""
    re, im = mp[0], mp[1]
    row0 = torch.stack([re, -im], dim=1)  # [d, 2, d]
    row1 = torch.stack([im, re], dim=1)
    return torch.stack([row0, row1])  # [2, d, 2, d]


@functools.lru_cache(maxsize=4)
def _iota(length: int, device: torch.device):
    return torch.arange(length, dtype=IDX_DTYPE, device=device)


def iota_for(planes):
    """The flat index vector of a (2, N) ket, cached per (N, device):
    callers read it and never write it."""
    return _iota(planes.shape[-1], planes.device)


def cmul(fre, fim, v):
    """Multiply planes v=(2,N) by a complex factor given as (re, im)
    tensors/scalars broadcastable over N."""
    return torch.stack([v[0] * fre - v[1] * fim, v[0] * fim + v[1] * fre])


def _where(cond, a, b, like):
    """torch.where with scalar branches kept in the planes' dtype."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=like.dtype).to(like.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=like.dtype).to(like.device)
    return torch.where(cond, a, b)


def plane_where(like):
    """What a phase function ``fn(xp, idx)`` is given as ``xp`` over
    torch planes: its one call, ``xp.where``, keeps scalar branches in
    the planes' dtype (torch.where makes them float32, and float64 planes
    would lose their precision there)."""
    return types.SimpleNamespace(where=functools.partial(_where, like=like))


# ---------------------------------------------------------------------------
# gate kernels
# ---------------------------------------------------------------------------

def _ctrl_select(new, old, cmask, cval):
    idx = iota_for(new)
    keep = (idx & cmask) == cval
    return torch.where(keep, new, old)


def apply_2x2(planes, mp, n: int, target: int, cmask=0, cval=0):
    """Generic (optionally controlled) single-qubit gate
    (reference kernels apply2x2/apply2x2single/..., qengine.cl:144-244).
    `mp` is (2, 2, 2) matrix planes [plane, row, col]."""
    m = _host_planes(mp)
    high = 1 << (n - 1 - target)
    low = 1 << target
    v = planes.reshape(2, high, 2, low)
    a0r, a1r = v[0, :, 0, :], v[0, :, 1, :]
    a0i, a1i = v[1, :, 0, :], v[1, :, 1, :]
    # each row goes straight into the result: a float64 w30 ket is 16 GiB,
    # so the temporaries of a whole-ket stack would not fit beside it
    out = torch.empty_like(planes)
    ov = out.view(2, high, 2, low)
    for r in range(2):
        mr0, mi0 = float(m[0, r, 0]), float(m[1, r, 0])
        mr1, mi1 = float(m[0, r, 1]), float(m[1, r, 1])
        ov[0, :, r, :] = mr0 * a0r - mi0 * a0i + mr1 * a1r - mi1 * a1i
        ov[1, :, r, :] = mr0 * a0i + mi0 * a0r + mr1 * a1i + mi1 * a1r
    if cmask == 0:
        return out
    return _ctrl_select(out, planes, cmask, cval)


def apply_diag(planes, d0re, d0im, d1re, d1im, n: int, tmask, cmask=0, cval=0):
    """Diagonal (phase) gate with target/control masks (reference kernels
    phasesingle/zsingle/..., qengine.cl:247-340)."""
    idx = iota_for(planes)
    bit = (idx & tmask) != 0
    fre = _where(bit, d1re, d0re, planes)
    fim = _where(bit, d1im, d0im, planes)
    if cmask:
        active = (idx & cmask) == cval
        fre = _where(active, fre, 1.0, planes)
        fim = _where(active, fim, 0.0, planes)
    return cmul(fre, fim, planes)


def apply_invert(planes, tr_re, tr_im, bl_re, bl_im, n: int, target: int, cmask=0, cval=0):
    """Anti-diagonal gate: bit-flip + per-half phases (reference kernels
    xsingle/invertsingle, qengine.cl:247-290)."""
    high = 1 << (n - 1 - target)
    low = 1 << target
    v = planes.reshape(2, high, 2, low)
    out = torch.stack([cmul(tr_re, tr_im, v[:, :, 1, :]),
                       cmul(bl_re, bl_im, v[:, :, 0, :])], dim=2)
    out = out.reshape(2, -1)
    if cmask == 0:
        return out
    return _ctrl_select(out, planes, cmask, cval)


def apply_kxk(planes, mp, n: int, start: int, k: int):
    """Arbitrary gate on k CONTIGUOUS qubits [start, start+k) as one
    plane-mixing contraction; `mp` is (2, 2^k, 2^k) matrix planes."""
    mp = _dev_planes(mp, planes)
    high = 1 << (n - start - k)
    low = 1 << start
    v = planes.reshape(2, high, 1 << k, low)
    out = torch.einsum("PApa,phal->PhAl", _mix(mp), v)
    return out.reshape(2, -1)


def apply_4x4(planes, mp4, n: int, q1: int, q2: int):
    """Arbitrary two-qubit gate as one plane-mixing contraction."""
    mp4 = host_tensor(_host_planes(mp4), planes.dtype).to(planes.device)
    lo, hi = (q1, q2) if q1 < q2 else (q2, q1)
    h = 1 << (n - 1 - hi)
    m = 1 << (hi - lo - 1)
    l = 1 << lo
    v = planes.reshape(2, h, 2, m, 2, l)
    mix = _mix(mp4).reshape(2, 2, 2, 2, 2, 2)  # [P, B2, B1, p, b2, b1]
    if q1 < q2:
        out = torch.einsum("PABpab,phambl->PhAmBl", mix, v)
    else:
        out = torch.einsum("PBApba,phambl->PhAmBl", mix, v)
    return out.reshape(2, -1)


# torch refuses a CUDA tensor of more dimensions than this (the CPU
# does not check it): every view a function here builds stays within it
MAX_DIMS = 25


def _bit_view(n: int, bits):
    """(shape, axis_of, rest): a view of (2, 2^n) planes with one axis of
    size 2 for each bit of `bits` and one axis for each run of the other
    bits, high bits first (`rest` lists those axes in order).  It has at
    most 2 len(bits) + 2 axes: callers take it only when that is within
    MAX_DIMS."""
    shape, axis_of, rest = [2], {}, []
    hi = n
    for b in sorted(bits, reverse=True):
        if hi - b - 1:
            rest.append(len(shape))
            shape.append(1 << (hi - b - 1))
        axis_of[b] = len(shape)
        shape.append(2)
        hi = b
    if hi:
        rest.append(len(shape))
        shape.append(1 << hi)
    return shape, axis_of, rest


def _runs(bits):
    """Ascending bits as (first, length) runs of consecutive bits."""
    runs = []
    for b in sorted(bits):
        if runs and runs[-1][0] + runs[-1][1] == b:
            runs[-1][1] += 1
        else:
            runs.append([b, 1])
    return runs


def _key_order_index(n: int, target: int, controls, device):
    """The flat index of every amplitude in key order: position p =
    (key << (n - k)) | (target bit << (n - k - 1)) | rest, where the
    key's bit j is controls[j] and rest holds the other bits in order —
    the order uc_2x2's view puts them in, as one index vector."""
    k = len(controls)
    p = _iota(1 << n, device)
    src = ((p >> (n - k - 1)) & 1) << target
    for j, c in enumerate(controls):
        src |= ((p >> (n - k + j)) & 1) << c
    other = sorted(set(range(n)) - set(controls) - {target})
    pos = 0
    for first, length in _runs(other):
        src |= ((p >> pos) & ((1 << length) - 1)) << first
        pos += length
    return src


def uc_2x2(planes, mps, n: int, target: int, controls):
    """Uniformly-controlled gate: per-control-permutation payloads
    (reference kernel uniformlycontrolled, qengine.cl:409).
    mps: (2, 2^k, 2, 2) matrix planes, as a batched 2x2 product over the
    control-key axis.  The amplitudes reach key order through a
    permuted view while it has at most MAX_DIMS axes (up to 10 scattered
    controls), and past that through one gather and one scatter."""
    mps = host_tensor(_host_planes(mps), planes.dtype).to(planes.device)
    controls = tuple(controls)
    k = len(controls)
    re, im = mps[0], mps[1]  # [2^k, 2, 2]

    def mix(v):
        vr, vi = v[0], v[1]
        return torch.stack([torch.bmm(re, vr) - torch.bmm(im, vi),
                            torch.bmm(re, vi) + torch.bmm(im, vr)])

    shape, axis_of, rest = _bit_view(n, list(controls) + [target])
    if len(shape) > MAX_DIMS:
        src = _key_order_index(n, target, controls, planes.device)
        out = mix(planes.index_select(1, src).view(2, 1 << k, 2, -1))
        new = torch.empty_like(planes)
        new[:, src] = out.reshape(2, -1)
        return new
    # the key's bit j is controls[j]: the last control is its top bit
    perm = ([0] + [axis_of[c] for c in controls[::-1]]
            + [axis_of[target]] + rest)
    v = planes.reshape(shape).permute(perm).reshape(2, 1 << k, 2, -1)
    out = mix(v).reshape([shape[a] for a in perm])
    inv = np.argsort(np.asarray(perm))
    return out.permute(list(inv)).reshape(2, -1)


def phase_factor_apply(planes, fre, fim):
    """Multiply by an arbitrary per-index complex factor (diagonal ops:
    parity rz, phase flips)."""
    return cmul(fre, fim, planes)


def swap_bits(planes, n: int, q1: int, q2: int):
    """Swap two qubits as a pure axis transpose — zero-FLOP relabel."""
    lo, hi = (q1, q2) if q1 < q2 else (q2, q1)
    h = 1 << (n - 1 - hi)
    m = 1 << (hi - lo - 1)
    l = 1 << lo
    v = planes.reshape(2, h, 2, m, 2, l)
    return v.transpose(2, 4).reshape(2, -1)


def gather(planes, src_idx):
    """Basis permutation (ALU family, reference qheader_alu.cl)."""
    return torch.index_select(planes, 1, src_idx)


def out_of_place(planes, src_idx, dst_idx, passthrough_cmask=None):
    """new[:, dst] = planes[:, src] over zeros (the MUL/DIV/*ModNOut
    scatter, reference qheader_alu.cl); with a control mask, indices
    outside the control subspace keep their amplitudes."""
    if passthrough_cmask is None:
        new = torch.zeros_like(planes)
    else:
        idx = iota_for(planes)
        keep = (idx & passthrough_cmask) != passthrough_cmask
        new = torch.where(keep, planes, 0.0)
    new[:, dst_idx] = torch.index_select(planes, 1, src_idx)
    return new


def prob_mask_sum(planes, mask, val):
    """Masked probability reduction (reference kernels probmask/probreg,
    qengine.cl:704-948); a 0-d tensor."""
    p = planes[0] ** 2 + planes[1] ** 2
    if mask == 0:
        return p.sum() if val == 0 else p.new_zeros(())
    idx = iota_for(planes)
    return torch.where((idx & mask) == val, p, 0.0).sum()


def _rsqrt(nrm_sq: float, dtype) -> float:
    """1/sqrt(nrm_sq) as the JAX program computes it: in float64 at
    float64 planes, else in float32, then rounded to the planes' dtype."""
    if dtype == torch.float64:
        return 1.0 / math.sqrt(nrm_sq)
    s = np.float32(1.0) / np.sqrt(np.float32(nrm_sq))
    return float(host_tensor(s, dtype))


def collapse(planes, mask, val, nrm_sq):
    """Projective collapse + renorm (reference kernels applym/applymreg,
    qengine.cl:1013-1045)."""
    idx = iota_for(planes)
    keep = (idx & mask) == val
    return torch.where(keep, planes * _rsqrt(nrm_sq, planes.dtype), 0.0)


def normalize(planes, nrm_sq):
    return planes * _rsqrt(nrm_sq, planes.dtype)


def probs(planes):
    return planes[0] ** 2 + planes[1] ** 2


def sum_sqr_diff(a, b):
    """1 - |<a|b>|^2 from planes (reference: approxcompare kernel)."""
    re = torch.sum(a[0] * b[0] + a[1] * b[1])
    im = torch.sum(a[0] * b[1] - a[1] * b[0])
    return torch.clamp(1.0 - (re * re + im * im), min=0.0)


def expectation_bits(planes, bits, offset: int = 0):
    """<integer value of bits> via per-bit marginal reductions (reference:
    expperm kernel, qengine.cl:930); summing 2^j * P(bit_j) keeps each
    accumulation O(1)-magnitude at float32."""
    idx = iota_for(planes)
    p = planes[0] ** 2 + planes[1] ** 2
    total = torch.tensor(float(offset), dtype=p.dtype, device=p.device)
    for j, b in enumerate(bits):
        bit_set = ((idx >> b) & 1) == 1
        total = total + float(1 << j) * torch.where(bit_set, p, 0.0).sum()
    return total


def sample(planes, u: float):
    """Device-side categorical draw for MAll (no 2^n host transfer).  On
    the card, the draw of draw_index (a cumsum there does not repeat
    its rounding from call to call); on the CPU the JAX package's
    cumsum."""
    if planes.device.type == "cuda":
        return draw_index(planes, u)
    p = planes[0] ** 2 + planes[1] ** 2
    cdf = torch.cumsum(p, 0)
    idx = torch.searchsorted(cdf, cdf[-1:] * u, right=True)
    return torch.clamp(idx, max=p.shape[0] - 1)[0]


# rows of one level of draw_indices, and the rows of 2^20 amplitudes a
# float64 pass reads at once (64 x 2^20 amplitudes: 512 MiB of float64)
_DRAW_ROWS = 1024
_DRAW_STEP = 64


def draw_index(planes, u: float) -> int:
    """The first index whose float64 cumulative |amp|^2 passes u times
    the total (:func:`draw_indices` for one uniform).  The same planes
    and u give the same index on every call (torch.cumsum on a CUDA
    tensor does not: on an H100 the bfloat16 and float16 draws of one
    w20 ket took two values over 30 calls)."""
    return int(draw_indices(planes, [u])[0])


def _level_pick(sums, inv, target):
    """One level of :func:`draw_indices`: `sums` (U, R) float64 row sums
    of U segments, each shot in segment ``inv[s]`` with its remaining
    target; returns (the row each shot picks, the target left in it).
    The segments' cumulative sums are one float64 cumsum on the host,
    so a shot's pick is a searchsorted offset by its segment's start."""
    U, R = sums.shape
    flat = np.cumsum(sums.reshape(-1))
    base = np.concatenate([[0.0], flat[R - 1::R][:-1]])
    pos = np.searchsorted(flat, base[inv] + target, side="right")
    k = np.clip(pos - inv * R, 0, R - 1)
    before = np.where(k > 0, flat[inv * R + k - 1] - base[inv], 0.0)
    return k, target - before


def draw_indices(planes, us) -> np.ndarray:
    """:func:`draw_index` for every uniform of `us` (host float64), the
    levels batched over the shots: a level sums the 1024 rows of each
    distinct segment the shots chose one level up (float64 reductions
    on the planes' device, which repeat bit for bit; a segment chosen by
    many shots is read once), the picks are made on the host, and the
    last level's rows are single amplitudes.  The same planes and
    uniforms give the same indices on every call."""
    us = np.asarray(us, dtype=np.float64).reshape(-1)
    re, im = planes[0], planes[1]
    n = re.shape[0]
    seg = np.zeros(us.shape[0], dtype=np.int64)
    target = None
    while True:
        R = min(n, _DRAW_ROWS)
        C = n // R
        rows, inv = np.unique(seg, return_inverse=True)
        rid = (torch.as_tensor(rows, device=re.device)[:, None] * R
               + torch.arange(R, device=re.device)).reshape(-1)
        r2, i2 = re.reshape(-1, C), im.reshape(-1, C)
        step = max(1, (_DRAW_STEP << 20) // C)
        sums = torch.cat([
            (r2[rid[a:a + step]].double() ** 2
             + i2[rid[a:a + step]].double() ** 2).sum(1)
            for a in range(0, rid.numel(), step)]).cpu().numpy()
        sums = sums.reshape(rows.shape[0], R)
        if target is None:
            target = us * float(np.cumsum(sums[0])[-1])
        k, target = _level_pick(sums, inv.reshape(-1), target)
        seg = seg * R + k
        if C == 1:
            return seg
        n = C


def multishot_mask_keys(planes, u, bits):
    """Batched categorical draws + masked-bit compaction (reference: the
    bulk MultiShotMeasureMask op, src/qinterface/qinterface.cpp:807).
    `u` is (shots,) uniforms, `bits` a (k,) int tensor of qubit indices;
    returns (shots,) ints whose bit j is drawn-index bit bits[j].  On the
    card the draws of :func:`draw_indices` (a cumsum there need not
    repeat its rounding from call to call; ROADMAP §C has the reading),
    the keys packed on the host; on the CPU the JAX package's cumsum,
    :func:`cumsum_mask_keys`, all in the planes' dtype."""
    if planes.device.type == "cuda":
        draws = draw_indices(planes, u.double().cpu().numpy())
        keys = np.zeros_like(draws)
        for j, b in enumerate(bits.cpu().tolist()):
            keys |= ((draws >> b) & 1) << j
        return torch.from_numpy(keys)
    return cumsum_mask_keys(planes, u, bits)


def cumsum_mask_keys(planes, u, bits):
    """The JAX package's form of :func:`multishot_mask_keys`: one cumsum
    of |amp|^2 in the planes' dtype, a searchsorted per shot and the key
    packing, on the planes' device (the CPU path; on a CUDA tensor it
    runs too, which is how its rounding there is measured)."""
    p = planes[0] ** 2 + planes[1] ** 2
    cdf = torch.cumsum(p, 0)
    draws = torch.searchsorted(cdf, u * cdf[-1], right=True)
    draws = torch.clamp(draws, max=p.shape[0] - 1)
    hit = (draws[:, None] >> bits[None, :]) & 1
    weights = torch.arange(bits.shape[0], device=draws.device)
    return torch.sum(hit << weights, dim=1)


def allocate(planes, n: int, start: int, length: int):
    """Insert |0> qubits at `start` as zero-pad + reshape."""
    high = 1 << (n - start)
    low = 1 << start
    v = planes.reshape(2, high, 1, low)
    z = planes.new_zeros((2, high, (1 << length) - 1, low))
    return torch.cat([v, z], dim=2).reshape(2, -1)


def compose(planes_self, planes_other, n: int, m: int, start: int):
    """Tensor product with other's qubits inserted at `start`
    (reference kernel compose, qengine.cl:521): the result's bits are
    self's high bits, then other's, then self's low `start` bits."""
    re = (torch.outer(planes_other[0], planes_self[0])
          - torch.outer(planes_other[1], planes_self[1]))
    im = (torch.outer(planes_other[0], planes_self[1])
          + torch.outer(planes_other[1], planes_self[0]))
    t = torch.stack([re, im]).reshape(2, 1 << m, 1 << (n - start), 1 << start)
    return t.permute(0, 2, 1, 3).reshape(2, -1)


def split_matrix(planes, n: int, start: int, length: int):
    """Reshape ket planes to (2, remainder, dest) for dest = [start,
    start+length) (reference kernels decomposeprob/decomposeamp,
    qengine.cl:569-702); the remainder index is the other bits in
    order."""
    t = planes.reshape(2, 1 << (n - start - length), 1 << length, 1 << start)
    return t.permute(0, 1, 3, 2).reshape(2, 1 << (n - length), 1 << length)
