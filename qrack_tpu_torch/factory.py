"""Stack factory (reference: include/qfactory.hpp:49
CreateQuantumInterface).  The ported terminals:

  "cuda"        QEngineCUDA single-device dense engine (the JAX package's
                "tpu" terminal)
  "cpu"         QEngineCPU host oracle (numpy, complex128 by default;
                takes no device)
  "hybrid"      QHybrid: QEngineCPU below hybrid_tpu_threshold_qubits
                (QRACK_TPU_THRESHOLD_QB, 13), QEngineCUDA from there to
                max_page_qubits; ``device``/``dtype`` reach the CUDA half
  "sparse"      QEngineSparse: sorted int64 indices and complex128
                amplitudes on the host, up to 62 qubits (numpy; takes no
                device; env QRACK_SPARSE_TRUNCATION_THRESHOLD,
                QRACK_SPARSE_MAX_ALLOC_MB)
  "turboquant"  QEngineCUDATurboQuant block-compressed resident ket
                (options bits, block_pow, chunk_qb, seed_rot; env
                QRACK_TURBO_BITS, QRACK_TURBO_BLOCK_POW,
                QRACK_TURBOQUANT_CHUNK_QB, QRACK_PALLAS_TQ_TILE_QB)

The CUDA engines run on ``cuda`` unless ``device="cpu"``.  The other
layers of the JAX package's factory are not ported yet (ROADMAP.md)."""

from __future__ import annotations

from typing import Callable, Sequence, Union

_TERMINAL = {"cuda", "cpu", "hybrid", "sparse", "turboquant"}


def _terminal_factory(name: str, **opts) -> Callable:
    if name == "cuda":
        from .engines.cuda import QEngineCUDA

        return lambda n, **kw: QEngineCUDA(n, **{**opts, **kw})
    if name == "cpu":
        from .engines.cpu import QEngineCPU

        return lambda n, **kw: QEngineCPU(n, **{**opts, **kw})
    if name == "hybrid":
        from .engines.hybrid import QHybrid

        return lambda n, **kw: QHybrid(n, **{**opts, **kw})
    if name == "sparse":
        from .engines.sparse import QEngineSparse

        return lambda n, **kw: QEngineSparse(n, **{**opts, **kw})
    if name == "turboquant":
        from .engines.turboquant import QEngineCUDATurboQuant

        return lambda n, **kw: QEngineCUDATurboQuant(n, **{**opts, **kw})
    raise ValueError(f"unknown terminal layer {name!r}")


def build_factory(layers: Sequence[str], **opts) -> Callable:
    """Compose a constructor fn(n, **kw) from a top-down layer list."""
    if not layers:
        raise ValueError("empty layer list")
    head, rest = layers[0], layers[1:]
    if head not in _TERMINAL:
        raise ValueError(f"layer {head!r} is not ported yet")
    if rest:
        raise ValueError(f"terminal layer {head!r} must be last")
    return _terminal_factory(head, **opts)


def create_quantum_interface(layers: Union[str, Sequence[str]], qubit_count: int,
                             init_state: int = 0, **kwargs):
    """Build a simulator stack, e.g. ``create_quantum_interface("cuda", 30)``,
    ``create_quantum_interface("turboquant", 32)``,
    ``create_quantum_interface("hybrid", 10)`` or, on the CPU,
    ``create_quantum_interface("cuda", 10, device="cpu")``."""
    if isinstance(layers, str):
        layers = (layers,)
    opts = {k: kwargs.pop(k) for k in ("dtype", "device") if k in kwargs}
    factory = build_factory(tuple(layers), **opts)
    return factory(qubit_count, init_state=init_state, **kwargs)
