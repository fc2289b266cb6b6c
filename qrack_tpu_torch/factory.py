"""Stack factory (reference: include/qfactory.hpp:49
CreateQuantumInterface).  The ported terminals:

  "cuda"        QEngineCUDA single-device dense engine (the JAX package's
                "tpu" terminal)
  "turboquant"  QEngineCUDATurboQuant block-compressed resident ket
                (options bits, block_pow, chunk_qb, seed_rot; env
                QRACK_TURBO_BITS, QRACK_TURBO_BLOCK_POW,
                QRACK_TURBOQUANT_CHUNK_QB, QRACK_PALLAS_TQ_TILE_QB)

Both run on ``cuda`` unless ``device="cpu"``.  The other layers of the
JAX package's factory are not ported yet (ROADMAP.md)."""

from __future__ import annotations

from typing import Callable, Sequence, Union

_TERMINAL = {"cuda", "turboquant"}


def _terminal_factory(name: str, **opts) -> Callable:
    if name == "cuda":
        from .engines.cuda import QEngineCUDA

        return lambda n, **kw: QEngineCUDA(n, **{**opts, **kw})
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
    ``create_quantum_interface("turboquant", 32)`` or, on the CPU,
    ``create_quantum_interface("cuda", 10, device="cpu")``."""
    if isinstance(layers, str):
        layers = (layers,)
    opts = {k: kwargs.pop(k) for k in ("dtype", "device") if k in kwargs}
    factory = build_factory(tuple(layers), **opts)
    return factory(qubit_count, init_state=init_state, **kwargs)
