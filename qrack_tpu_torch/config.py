"""Global numeric/config policy for qrack_tpu_torch.

Analogue of the reference's build-time numeric knobs
(reference: include/common/qrack_types.hpp:40-138 — FPPOW float width,
QBCAPPOW index width) and its run-time `QRACK_*` environment controls
(reference: README.md:62-118, src/common/oclengine.cpp:362-388).

Differences by design:
  * Index math ("bitCapInt") is a plain Python int — arbitrary precision,
    so >64-qubit indexing needs no big_integer.hpp equivalent on the host.
    Device-side indices are int32/int64 lanes, valid for any dense shard
    that fits in HBM (a shard never exceeds 2^40 amplitudes in practice).
  * Float width is a runtime policy (fp16/bf16/fp32/fp64), not a compile
    flag; complex arithmetic is written out as pairs of real ops over
    split real/imag planes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# Float-width policy (reference FPPOW analogue)
# ---------------------------------------------------------------------------

_REAL_DTYPES = {
    "float16": np.float16,
    "bfloat16": None,  # no numpy dtype; see QrackConfig.real_dtype
    "float32": np.float32,
    "float64": np.float64,
}

_COMPLEX_FOR_REAL = {
    "float32": np.complex64,
    "float64": np.complex128,
    # fp16/bf16 have no numpy complex; engines store split planes and
    # up-cast to complex64 at the host boundary.
    "float16": np.complex64,
    "bfloat16": np.complex64,
}


@dataclass
class QrackConfig:
    """Runtime configuration, seeded from QRACK_TPU_* environment variables.

    Mirrors the reference env-var tier (SURVEY.md §5 "Config / flag system").
    """

    # FPPOW analogue: default fp32 amplitudes (complex64).
    real_dtype_name: str = field(
        default_factory=lambda: (
            os.environ.get("QRACK_TPU_FPPOW", "").strip() or "float32")
    )
    # Qubit-count threshold below which QHybrid prefers the CPU engine
    # (reference: QHybrid gpuThresholdQubits, include/qhybrid.hpp:74).
    hybrid_tpu_threshold_qubits: int = field(
        default_factory=lambda: int(os.environ.get("QRACK_TPU_THRESHOLD_QB", "13"))
    )
    # Largest qubit count a single dense page/engine may hold
    # (reference: QRACK_MAX_PAGE_QB, src/qpager.cpp:170-222).
    max_page_qubits: int = field(
        default_factory=lambda: int(os.environ.get("QRACK_MAX_PAGE_QB", "30"))
    )
    # Largest coherent dense width before paging must engage
    # (reference: QRACK_MAX_PAGING_QB).
    max_paging_qubits: int = field(
        default_factory=lambda: int(os.environ.get("QRACK_MAX_PAGING_QB", "36"))
    )
    # Largest width the CPU engine will allocate
    # (reference: QRACK_MAX_CPU_QB).
    max_cpu_qubits: int = field(
        default_factory=lambda: int(os.environ.get("QRACK_MAX_CPU_QB", "28"))
    )
    # HBM allocation guard, MB (reference: QRACK_MAX_ALLOC_MB,
    # src/common/oclengine.cpp:388).
    max_alloc_mb: int = field(
        default_factory=lambda: int(os.environ.get("QRACK_MAX_ALLOC_MB", "0"))
    )
    # QUnit separability rounding threshold (reference:
    # QRACK_QUNIT_SEPARABILITY_THRESHOLD, README.md:108).
    separability_threshold: float = field(
        default_factory=lambda: float(
            os.environ.get("QRACK_QUNIT_SEPARABILITY_THRESHOLD", "0.0")
        )
    )
    # Near-Clifford RZ rounding (reference:
    # QRACK_NONCLIFFORD_ROUNDING_THRESHOLD, README.md:112).
    nonclifford_rounding_threshold: float = field(
        default_factory=lambda: float(
            os.environ.get("QRACK_NONCLIFFORD_ROUNDING_THRESHOLD", "0.0")
        )
    )
    # Depolarizing noise applied by QInterfaceNoisy when set (reference:
    # QRACK_GATE_DEPOLARIZATION, include/qinterface_noisy.hpp:~35).
    gate_depolarization: float = field(
        default_factory=lambda: float(os.environ.get("QRACK_GATE_DEPOLARIZATION", "0.0"))
    )
    # Disable the QUnit fidelity guard (reference:
    # QRACK_DISABLE_QUNIT_FIDELITY_GUARD, include/qunit.hpp:109).
    disable_fidelity_guard: bool = field(
        default_factory=lambda: bool(
            int(os.environ.get("QRACK_DISABLE_QUNIT_FIDELITY_GUARD", "0"))
        )
    )
    # Comma-separated device list for the pager (reference:
    # QRACK_QPAGER_DEVICES, src/qpager.cpp:170).
    pager_devices: str = field(
        default_factory=lambda: os.environ.get("QRACK_QPAGER_DEVICES", "")
    )

    @property
    def real_dtype(self):
        """Host (numpy) dtype of the FPPOW policy; bfloat16 has no numpy
        dtype and reports float32, the width it is read back at."""
        name = self.real_dtype_name
        if name == "bfloat16":
            return np.dtype(np.float32)
        return np.dtype(_REAL_DTYPES[name])

    @property
    def complex_dtype(self):
        return np.dtype(_COMPLEX_FOR_REAL[self.real_dtype_name])

    def device_real_dtype(self):
        """torch plane dtype honoring the FPPOW policy on the device path
        (engines/cuda.py defaults to this)."""
        from .ops.gatekernels import plane_dtype

        return plane_dtype(self.real_dtype_name)


_config = QrackConfig()


def get_config() -> QrackConfig:
    return _config


def set_config(**kwargs) -> QrackConfig:
    global _config
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(_config, k, v)
    return _config


# ---------------------------------------------------------------------------
# Numeric tolerances (reference: include/common/qrack_types.hpp:250-267)
# ---------------------------------------------------------------------------

# Amplitude treated as zero (reference REAL1_EPSILON-class clamps).
FP_NORM_EPSILON = 1.1920929e-07  # fp32 machine eps
# Probability clamp used by separation decisions
# (reference TRYDECOMPOSE_EPSILON, include/common/qrack_types.hpp:265).
TRYDECOMPOSE_EPSILON = 2.0 * FP_NORM_EPSILON ** 0.5
# Minimum log-fidelity before QUnit's ACE guard trips
# (reference FIDELITY_MIN via CheckFidelity, include/qunit.hpp:107-118).
FIDELITY_MIN = -23.025850929940457  # ln(1e-10)

PI = float(np.pi)
