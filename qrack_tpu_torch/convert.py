"""Carrying state and circuits across from the JAX package.

Plain numpy in, torch out: the tests use these to feed both packages the
same ket and the same circuit.  The JAX package's arrays are immutable,
while this package updates planes in place, so every function here
copies.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch

from .layers.qcircuit import QCircuit, QCircuitGate
from .ops import gatekernels as gk
from .utils.device import resolve_device


def planes_from_numpy(planes, device=None, dtype=None):
    """A (2, 2^n) real planes array (the JAX engine's layout, in any of its
    plane dtypes: float32, float64, float16 or bfloat16) or a complex ket,
    as this package's planes on `device`, ``cuda`` by default (always a
    copy).  ``dtype=None`` keeps a planes array's dtype and gives float32
    planes for a complex ket; a given dtype rounds as the JAX package
    rounds (gatekernels.host_tensor)."""
    arr = np.asarray(planes)
    own = gk.PLANE_DTYPES.get(arr.dtype.name, torch.float32)
    if np.iscomplexobj(arr) or arr.ndim == 1:
        arr = arr.reshape(-1)
        arr = np.stack([arr.real, arr.imag])
        own = torch.float32
    if arr.ndim != 2 or arr.shape[0] != 2:
        raise ValueError(f"expected (2, N) planes or a complex ket, got "
                         f"shape {arr.shape}")
    if arr.dtype.name == "bfloat16":  # no numpy dtype: float32 is exact
        arr = arr.astype(np.float32)
    return gk.host_tensor(arr, own if dtype is None else dtype).to(
        resolve_device(device))


def planes_to_numpy(planes) -> np.ndarray:
    """This package's planes as a (2, 2^n) numpy array on the host (a
    copy), in their dtype; bfloat16 planes, which numpy cannot hold, come
    as float32, exactly."""
    host = planes.detach().to("cpu")
    if host.dtype == torch.bfloat16:
        host = host.to(torch.float32)
    return host.numpy().copy()


def turboquant_from_numpy(codes, scales, n: int, bits: int, block_pow: int,
                          seed: int, device=None, **kwargs):
    """A TurboQuant engine holding a JAX engine's compressed ket: its
    (codes, scales) numpy arrays and its width, bits, block pow and
    rotation seed, on `device`, ``cuda`` by default (a copy)."""
    from .engines.turboquant import QEngineCUDATurboQuant

    eng = QEngineCUDATurboQuant(int(n), bits=int(bits),
                                block_pow=int(block_pow), seed_rot=int(seed),
                                device=device, **kwargs)
    eng.place_codes(codes, scales)
    return eng


def circuit_from_gates(gates: Iterable[Tuple[int, Sequence[int],
                                             Mapping[int, np.ndarray]]],
                       qubit_count: int = 0) -> QCircuit:
    """A QCircuit from ``(target, controls, {perm: 2x2 complex})`` tuples
    (as read off a JAX-package ``QCircuit.gates``), gate for gate: no
    merging, so the lowered window is the same op list."""
    circ = QCircuit(qubit_count)
    for target, controls, payloads in gates:
        g = QCircuitGate(int(target),
                         {int(p): np.array(m, dtype=np.complex128)
                          for p, m in payloads.items()},
                         tuple(int(c) for c in controls))
        circ.qubit_count = max(circ.qubit_count, max(g.qubits()) + 1)
        circ.gates.append(g)
    return circ


def bdt_from_numpy(meta: Mapping, arrays: Mapping[str, np.ndarray],
                   device=None, **kwargs):
    """The port's QBdt holding a JAX QBdt's decision diagram, from the
    ``meta``/``arrays`` of its checkpoint capture (the JAX package's
    ``QBdt._ckpt_capture``), node for node; device leaf planes land on
    `device`, ``cuda`` by default (``QBdt._from_capture``)."""
    from .layers.qbdt import QBdt

    return QBdt._from_capture(meta, arrays, device=device, **kwargs)


def turboquant_pager_from_numpy(codes, scales, n: int, bits: int,
                                block_pow: int, seed: int, n_pages: int,
                                device=None, devices=None, **kwargs):
    """The port's QPagerTurboQuant holding a JAX ``QPagerTurboQuant``'s
    compressed ket: its whole (codes, scales) numpy arrays (chunk order),
    width, bits, block pow, rotation seed and page count, split into
    ``n_pages`` pages on ``devices``, or on ``device`` repeated, ``cuda``
    by default (a copy).  Other keywords go to the pager (chunk_qb, rng,
    ...)."""
    from .parallel.turboquant_pager import QPagerTurboQuant

    eng = QPagerTurboQuant(int(n), bits=int(bits), block_pow=int(block_pow),
                           seed_rot=int(seed), n_pages=int(n_pages),
                           devices=devices, device=device, **kwargs)
    eng.place_codes(codes, scales)
    return eng


def pager_from_numpy(planes, qmap=None, device=None, devices=None, **kwargs):
    """The port's QPager holding a JAX pager's ket: its physical planes
    (``QPager._state_raw`` as a (2, 2^n) numpy array, in any plane dtype)
    and its placement table ``_qmap`` (None: identity), split into
    ``n_pages`` pages (a keyword, default the device list's power-of-two
    prefix) on ``devices``, or on ``device`` repeated, ``cuda`` by
    default (a copy).  Other keywords go to the QPager (rng, ...)."""
    from .parallel.pager import QPager

    arr = np.asarray(planes)
    n = int(arr.shape[-1]).bit_length() - 1
    host = planes_from_numpy(arr, device="cpu")
    kwargs.setdefault("dtype", host.dtype)
    q = QPager(n, init_state=None, devices=devices, device=device, **kwargs)
    L = q.local_bits
    q._pages = [host[:, p << L:(p + 1) << L].to(dev).contiguous()
                for p, dev in enumerate(q.devices)]
    if qmap is not None:
        q._map_assign([int(x) for x in qmap])
    return q
