"""Building and loading the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into a shared library with a plain C
interface under ``qrack_tpu_torch/_build/`` (listed in .gitignore), named
by a hash of the source and the flags, so a library is rebuilt only when
its source changes.  :func:`build` starts one nvcc for each missing
library, all at once, and waits for them; :func:`load` loads a library
with ctypes, building it first if needed.  nvcc's ptxas report
(``-Xptxas -v``: registers, shared memory, spills) is kept beside each
library; :func:`build_log` reads it back and :func:`ptxas_report` parses
registers and spills per kernel from it.  With telemetry on, each
library a build asks for counts ``compile.kernel.<library>.hit`` when it
is found built in ``_build/`` and ``.miss`` when nvcc compiles it.

:func:`set_build_dir` moves the build directory (the serving plane's warm
start points it into its checkpoint store, checkpoint/warmstart.py);
``QRACK_TPU_KERNEL_CACHE`` does the same for a process and the processes
it starts, where nothing set one.  :func:`build_dir` is read at every
build and load, so a move applies to every library this process has not
loaded yet.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .. import telemetry as _tele

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}
_BUILD_OVERRIDE: Optional[Path] = None


def set_build_dir(path) -> None:
    """Build and load the kernel libraries under `path` from now on
    (``None``: back to ``BUILD_DIR``)."""
    global _BUILD_OVERRIDE
    _BUILD_OVERRIDE = None if path is None else Path(path)


def build_dir() -> Path:
    """Where the kernel libraries are built and looked for."""
    if _BUILD_OVERRIDE is not None:
        return _BUILD_OVERRIDE
    env = os.environ.get("QRACK_TPU_KERNEL_CACHE", "")
    return Path(env) if env else BUILD_DIR


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
    return build_dir() / f"{Path(source).stem}_{key}.so"


def log_path(source: Path) -> Path:
    """Where nvcc's output of the library's build is kept."""
    return library_path(source).with_suffix(".log")


def build(sources: Sequence[Path]) -> None:
    """Compile every source whose library or build log is missing, one
    nvcc process each, all started together; raises if any of them
    fails."""
    todo = []
    for s in map(Path, sources):
        built = library_path(s).exists() and log_path(s).exists()
        if _tele._ENABLED:
            _tele.inc(f"compile.kernel.{s.stem}.{'hit' if built else 'miss'}")
        if not built:
            todo.append(s)
    if not todo:
        return
    build_dir().mkdir(parents=True, exist_ok=True)
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
        log = log_path(src)
        log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
        log_tmp.write_text(stderr)
        os.replace(tmp, out)
        os.replace(log_tmp, log)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build_log(source: Path) -> str:
    """nvcc's output of the build of `source`'s library, building it
    first if needed."""
    build([source])
    return log_path(source).read_text()


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


def _demangle(names: Sequence[str]) -> List[str]:
    """C++ names through c++filt where the toolchain has it, each cut to
    its unqualified name and template arguments."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    if len(out) != len(names):
        return list(names)
    short = []
    for full in out:
        full = full.replace("(anonymous namespace)::", "")
        if full.startswith("void "):   # a template's return type
            full = full[len("void "):]
        short.append(full.split("(", 1)[0])
    return short


def ptxas_report(log: str) -> List[dict]:
    """Per kernel of a build log (``-Xptxas -v``): its name, registers,
    and spill stores and loads in bytes."""
    rows: List[dict] = []
    name = None
    spills = (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append({"kernel": name, "registers": int(m.group(1)),
                         "spill_stores": spills[0], "spill_loads": spills[1]})
            name = None
    for row, short in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = short
    return rows
