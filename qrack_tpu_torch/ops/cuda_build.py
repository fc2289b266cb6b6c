"""Building and loading the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into a shared library with a plain C
interface under ``qrack_tpu_torch/_build/`` (listed in .gitignore), named
by a hash of the source and the flags, so a library is rebuilt only when
its source changes.  :func:`build` starts one nvcc for each missing
library, all at once, and waits for them; :func:`load` loads a library
with ctypes, building it first if needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: compiler output (``-Xptxas -v``: registers, shared memory, spills) of
#: the libraries built in this process, by source file name; a library
#: that was already built has no entry
BUILD_LOGS: Dict[str, str] = {}

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(source: Path) -> Path:
    key = hashlib.sha256(Path(source).read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{key}.so"


def build(sources: Sequence[Path]) -> None:
    """Compile every source whose library is missing, one nvcc process
    each, all started together; raises if any of them fails."""
    todo = [Path(s) for s in sources if not library_path(s).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, p in procs:
        _stdout, stderr = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name} ({p.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
        BUILD_LOGS[src.name] = stderr
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def load(source: Path) -> ctypes.CDLL:
    """The library built from `source`, loaded once per process."""
    source = Path(source)
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _loaded[source] = lib
    return lib
