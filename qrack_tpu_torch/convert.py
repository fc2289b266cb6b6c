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
from .utils.device import resolve_device


def planes_from_numpy(planes, device=None, dtype=torch.float32):
    """A (2, 2^n) real planes array (the JAX engine's layout) or a complex
    ket, as this package's planes on `device`, ``cuda`` by default (always
    a copy)."""
    arr = np.asarray(planes)
    if np.iscomplexobj(arr) or arr.ndim == 1:
        arr = arr.reshape(-1)
        arr = np.stack([arr.real, arr.imag])
    if arr.ndim != 2 or arr.shape[0] != 2:
        raise ValueError(f"expected (2, N) planes or a complex ket, got "
                         f"shape {arr.shape}")
    return torch.tensor(arr, dtype=dtype, device=resolve_device(device))


def planes_to_numpy(planes) -> np.ndarray:
    """This package's planes as a (2, 2^n) numpy array on the host (a
    copy)."""
    return planes.detach().to("cpu").numpy().copy()


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
