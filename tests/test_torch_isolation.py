"""The port stands alone: importing and running qrack_tpu_torch loads no
JAX and nothing of the JAX package, its sources import neither, and its
entry points run on a CUDA device unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import qrack_tpu_torch as qt

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "qrack_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "qrack_tpu")


def _forbidden(module: str) -> bool:
    # mind the prefix: qrack_tpu_torch starts with qrack_tpu
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


_PROBE = r"""
import sys
import qrack_tpu_torch as qt
from qrack_tpu_torch.models.qft import qft_qcircuit
q = qt.create_quantum_interface("cuda", 6, device="cpu")
q.H(0)
q.CNOT(0, 1)
q.QFT(0, 6)
qft_qcircuit(6).RunFused(q)
assert 0.0 <= q.Prob(1) <= 1.0
t = qt.create_quantum_interface("turboquant", 8, device="cpu")
t.H(0)
t.QFT(0, 8)
t.H(7)
assert 0.0 <= t.Prob(7) <= 1.0
t.LossySaveStateVector(sys.argv[1])
o = qt.create_quantum_interface("optimal", 8, device="cpu",
                                tpu_threshold_qubits=3)
for i in range(8):
    o.RY(0.3 + i, i)
o.T(0)
for i in range(7):
    o.CNOT(i, i + 1)
o.QFT(0, 8)
assert 0.0 <= o.Prob(7) <= 1.0 and o.GetMaxUnitSize() == 8
c = qt.create_quantum_interface("unit_clifford", 40)
c.H(0)
for i in range(39):
    c.CNOT(i, i + 1)
assert c.MAll() in (0, (1 << 40) - 1)
print(sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "qrack_tpu")
             or m.startswith(("jax.", "jaxlib.", "qrack_tpu."))))
"""


def test_running_the_port_loads_no_jax_module(tmp_path):
    env = dict(os.environ, QRACK_TPU_FUSE_KERNEL="on")
    r = subprocess.run([sys.executable, "-c", _PROBE,
                        str(tmp_path / "ket.npz")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [m for m in names if _forbidden(m)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.create_quantum_interface("cuda", 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.QEngineCUDA(3)
    q = qt.create_quantum_interface("cuda", 3, device="cpu")
    assert q.device.type == "cpu"


def test_turboquant_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.create_quantum_interface("turboquant", 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.QEngineCUDATurboQuant(3)
    q = qt.create_quantum_interface("turboquant", 3, device="cpu")
    assert q.device.type == "cpu" and q._codes.device.type == "cpu"


def _tensor_builders():
    """The public functions that build a ket or a kernel operand, each
    taking an optional ``device=``."""
    from qrack_tpu_torch.convert import planes_from_numpy
    from qrack_tpu_torch.models.qft import basis_planes
    from qrack_tpu_torch.ops import gatekernels as gk
    from qrack_tpu_torch.convert import turboquant_from_numpy
    from qrack_tpu_torch.ops import fusion as fu
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.ops import window_kernel as wk

    structure = (("gen", 1, False),)
    op = fu.FusedOp("gen", 1, 0b100, 0b100, np.eye(2, dtype=complex))
    codes = np.zeros((4, 4), np.int8)
    return {
        "basis_planes": lambda **kw: basis_planes(3, 5, **kw),
        "planes_from_numpy":
            lambda **kw: planes_from_numpy(np.eye(2, 8), **kw),
        "to_planes": lambda **kw: gk.to_planes(np.ones(8) + 0j, **kw),
        "mtrx_planes": lambda **kw: gk.mtrx_planes(np.eye(2), **kw),
        "pack_operands": lambda **kw: wk.pack_operands(
            structure, [np.zeros((2, 2, 2), np.float32)], **kw)[0],
        "op_table": lambda **kw: wk.op_table(structure, **kw),
        "sharded_operands":
            lambda **kw: fu.sharded_operands([op], 2, **kw)[0],
        "pack_window": lambda **kw: tqk.pack_window(
            (("gen", 1, True),), fu.sharded_operands([op], 2, **kw),
            **kw)[1],
        "turboquant_from_numpy": lambda **kw: turboquant_from_numpy(
            codes, np.zeros(4, np.float32), 3, 8, 1, 5, **kw)._codes,
    }


@pytest.mark.parametrize("entry", sorted(_tensor_builders()))
def test_tensor_builders_default_to_cuda(entry, monkeypatch):
    """Without ``device=`` a ket or operand builder puts its tensor on
    cuda, and raises where there is none; it never quietly lands on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _tensor_builders()[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    out = call(device="cpu")
    assert out.device.type == "cpu"


def test_chip_smoke_refuses_without_gpu():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
