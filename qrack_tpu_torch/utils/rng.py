"""Deterministic RNG wrapper and hardware entropy source.

Replaces the reference's mt19937_64 and hardware RDRAND stack
(reference: include/common/qrack_types.hpp:157 qrack_rand_gen;
include/common/rdrandwrapper.hpp). The stream is numpy PCG64, the same
generator the JAX package draws from, so two engines seeded alike draw
the same measurement outcomes draw for draw. An unseeded stream takes
its seed from the RDRAND instruction through a small native wrapper
(native/hwrng.c, built at first use), or from ``os.urandom`` where the
CPU or the toolchain lacks it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np


def _hwrng():
    """The RDRAND wrapper library (native/__init__.py), or None."""
    from ..native import get_hwrng_lib

    return get_hwrng_lib()


def hw_rdrand_supported() -> bool:
    """True when the RDRAND instruction path is live (reference:
    RdRandom::SupportsRDRAND, rdrandwrapper.hpp)."""
    return _hwrng() is not None


def hw_entropy_bytes(n: int) -> bytes:
    """n bytes of entropy: the RDRAND instruction when available, else
    os.urandom (the reference's non-RDRAND fallback)."""
    lib = _hwrng()
    if lib is not None:
        buf = ctypes.create_string_buffer(n)
        if lib.qrack_rdrand_fill(buf, n):
            return buf.raw[:n]
    return os.urandom(n)


def hw_rand64() -> Optional[int]:
    """One raw RDRAND draw (None when unsupported) — the reference's
    RdRandom::NextRaw."""
    lib = _hwrng()
    if lib is None:
        return None
    v = ctypes.c_uint64()
    if lib.qrack_rdrand64(ctypes.byref(v)):
        return int(v.value)
    return None


class QrackRandom:
    def __init__(self, seed: Optional[int] = None):
        self.seed(seed)

    def seed(self, seed: Optional[int] = None) -> None:
        if seed is None:
            seed = int.from_bytes(hw_entropy_bytes(8), "little")
        self._seed = seed
        self._gen = np.random.Generator(np.random.PCG64(seed))

    def rand(self) -> float:
        """Uniform in [0, 1)."""
        return float(self._gen.random())

    def uniform(self, size=None):
        return self._gen.random(size)

    def randint(self, low: int, high: int) -> int:
        return int(self._gen.integers(low, high))

    def choice_from_probs(self, probs: np.ndarray, shots: int) -> np.ndarray:
        """Multinomial sampling used by MultiShotMeasureMask."""
        cdf = np.cumsum(probs)
        cdf = cdf / cdf[-1]
        u = self._gen.random(shots)
        return np.searchsorted(cdf, u, side="right")

    def spawn(self) -> "QrackRandom":
        """Independent child stream (for per-subsystem engines)."""
        return QrackRandom(self.randint(0, 2 ** 62))
