"""Host helpers in C and C++: the CHP tableau loops and the RDRAND seed
source, bound with ctypes.

Each source builds at first use with the host compiler into
``qrack_tpu_torch/_build/`` (listed in .gitignore), named by a hash of
the source and the flags, so a library is rebuilt only when its source
or flags change.  A build writes a per-process temp file and renames it
into place, so two interpreters that start together never load a
half-written library.  No ``-march=native``: a cached library may
outlive the host it was built on.

Every entry point has a fallback: the stabilizer's pure-Python loops
and ``os.urandom``.  It is taken when no compiler is found, when the
build fails, or when ``QRACK_TPU_NO_NATIVE`` is set (reference
analogue: the OpenCL JIT and binary cache,
src/common/oclengine.cpp:150-202).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
TABLEAU_SRC = _HERE / "tableau.cpp"
HWRNG_SRC = _HERE / "hwrng.c"
_FLAGS = ("-O3", "-shared", "-fPIC")

#: seconds the compiler took for each library built in this process, by
#: source file name; a library that was already built has no entry
BUILD_SECONDS: Dict[str, float] = {}

_lock = threading.Lock()
_lib = None
_tried = False
_hw_lib = None
_hw_tried = False


def library_path(src: Path, compiler: str, extra: Sequence[str] = ()) -> Path:
    flags = " ".join((compiler, *_FLAGS, *extra)).encode()
    key = hashlib.sha256(Path(src).read_bytes() + flags).hexdigest()[:16]
    return BUILD_DIR / f"{Path(src).stem}_{key}.so"


def _build_so(src: Path, compiler: str, extra: Sequence[str] = ()) -> Optional[Path]:
    """The library built from `src`, building it if it is missing; None
    when the compiler is absent or fails."""
    so = library_path(src, compiler, extra)
    if so.exists():
        return so
    cc = shutil.which(compiler)
    if cc is None:
        return None
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([cc, *_FLAGS, *extra, str(src), "-o", str(tmp)],
                             capture_output=True, timeout=120)
        if res.returncode != 0:
            return None
        os.replace(tmp, so)
        BUILD_SECONDS[Path(src).name] = time.perf_counter() - t0
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def get_tableau_lib():
    """The bound tableau library, or None (use the Python fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("QRACK_TPU_NO_NATIVE"):
            return None
        so = _build_so(TABLEAU_SRC, "g++")
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.tb_force_m.restype = ctypes.c_int
            lib.tb_force_m.argtypes = [u8p, u8p, u8p, ctypes.c_long, ctypes.c_long,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
            lib.tb_is_separable_z.restype = ctypes.c_int
            lib.tb_is_separable_z.argtypes = [u8p, ctypes.c_long, ctypes.c_long]
            lib.tb_canonical.restype = ctypes.c_long
            lib.tb_canonical.argtypes = [u8p, u8p, u8p, ctypes.c_long]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


# -- RDRAND/RDSEED hardware entropy (reference: rdrandwrapper.hpp) ------


def _hw_extra_flags():
    if platform.machine() in ("x86_64", "i686", "AMD64"):
        return ("-mrdrnd", "-mrdseed")
    return ()


def get_hwrng_lib():
    """The bound RDRAND wrapper library, or None (os.urandom fallback)."""
    global _hw_lib, _hw_tried
    if _hw_lib is not None or _hw_tried:
        return _hw_lib
    with _lock:
        if _hw_lib is not None or _hw_tried:
            return _hw_lib
        _hw_tried = True
        if os.environ.get("QRACK_TPU_NO_NATIVE"):
            return None
        so = _build_so(HWRNG_SRC, "gcc", _hw_extra_flags())
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
            lib.qrack_hw_rdrand_supported.restype = ctypes.c_int
            lib.qrack_hw_rdseed_supported.restype = ctypes.c_int
            lib.qrack_rdrand64.restype = ctypes.c_int
            lib.qrack_rdrand64.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
            lib.qrack_rdseed64.restype = ctypes.c_int
            lib.qrack_rdseed64.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
            lib.qrack_rdrand_fill.restype = ctypes.c_int
            lib.qrack_rdrand_fill.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            _hw_lib = lib if lib.qrack_hw_rdrand_supported() else None
        except OSError:
            _hw_lib = None
        return _hw_lib
