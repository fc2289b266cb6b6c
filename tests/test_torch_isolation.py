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
import numpy as np
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
pg = qt.create_quantum_interface("pager", 7, n_pages=2, device="cpu")
pg.H(6)
pg.CNOT(6, 0)
pg.QFT(0, 7)
qft_qcircuit(7).RunFused(pg)
assert 0.0 <= pg.Prob(0) <= 1.0 and pg.n_pages == 2
c = qt.create_quantum_interface("unit_clifford", 40)
c.H(0)
for i in range(39):
    c.CNOT(i, i + 1)
assert c.MAll() in (0, (1 << 40) - 1)
from qrack_tpu_torch.layers.qcircuit import QCircuit
from qrack_tpu_torch.noise import NoiseModel, depolarizing, run_trajectories
stacks = [qt.create_quantum_interface(layers, 6, device="cpu",
                                      tpu_threshold_qubits=3, noise=0.01)
          for layers in (["bdt_hybrid", "hybrid"], "bdt_attached",
                         ["tensor_network", "unit", "stabilizer_hybrid",
                          "hybrid"], ["noisy", "unit", "hybrid"])]
stacks.append(qt.create_quantum_interface("bdt", 6, device="cpu"))
for s in stacks:
    s.H(0)
    s.CNOT(0, 5)
    s.T(5)
    assert abs(s.Prob(5) - 0.5) < 1e-6
circ = QCircuit(4)
circ.append_1q(0, np.eye(2) * 1j)
circ.append_ctrl((0,), 3, np.array([[0, 1], [1, 0]]), 0)
res = run_trajectories(circ, NoiseModel(default=depolarizing(0.1)), 3,
                       device="cpu")
assert res.p1.shape == (3, 4)
pw = qt.create_quantum_interface("pager", 7, n_pages=4, device="cpu")
pw.force_wide_alu = True
pw.H(6)
pw.INC(3, 2, 5)
pw.ZMask(0b1000011)
pw.MUL(3, 0, 4, 3)
assert 0.0 <= pw.Prob(6) <= 1.0
from qrack_tpu_torch.models.qft import basis_pages, make_sharded_qft_fn
from qrack_tpu_torch.models.rcs import make_sharded_rcs_fn
from qrack_tpu_torch.models.grover import make_sharded_grover_fn
qfn, devs = make_sharded_qft_fn(["cpu"] * 4, 7)
pages = qfn(basis_pages(7, 5, devs))
rfn, devs = make_sharded_rcs_fn(["cpu"] * 4, 7, 3, 1)
rfn(basis_pages(7, 0, devs))
gfn, devs, _ = make_sharded_grover_fn(["cpu"] * 2, 6, 9, iters=2)
gfn(basis_pages(6, 0, devs))
cfn, devs = qft_qcircuit(7).compile_sharded_fn(["cpu"] * 2, 7)
cfn(basis_pages(7, 1, devs))
tp = qt.create_quantum_interface("turboquant_pager", 7, n_pages=4,
                                 device="cpu", bits=16, chunk_qb=3,
                                 block_pow=2)
tp.H(6)
tp.CNOT(6, 0)
tp.UniformParityRZ(0b1000001, 0.3)
assert abs(tp.Prob(0) - 0.5) < 1e-3
um = qt.create_quantum_interface("optimal_multi", 8, device="cpu",
                                 device_ids=[0, 0])
um.H(0)
um.CNOT(0, 1)
um.H(5)
um.CNOT(5, 6)
assert abs(um.Prob(6) - 0.5) < 1e-6
from qrack_tpu_torch.checkpoint import load_state, save_state
from qrack_tpu_torch.checkpoint.store import CheckpointStore
for s in (o, pg, t, um):
    save_state(s, sys.argv[1] + ".qckpt")
    back = load_state(sys.argv[1] + ".qckpt", device="cpu")
    assert abs(back.Prob(0) - s.Prob(0)) < 1e-6
store = CheckpointStore(sys.argv[1] + ".store")
store.register("s", 7, "pager", 1)
store.save("s", pg)
assert np.array_equal(store.load("s", device="cpu").GetQuantumState(),
                      pg.GetQuantumState())
store.wal_append("s", circ)
assert len(store.wal_entries()) == 1
from qrack_tpu_torch.models.algorithms import brickwork_qcircuit
rt = qt.create_quantum_interface("route", 50, device="cpu")
brickwork_qcircuit(50).Run(rt)
assert rt.current_stack() == "lightcone" and 0.0 <= rt.Prob(25) <= 1.0
lc = qt.create_quantum_interface("lightcone", 12, device="cpu")
lc.H(0)
lc.CNOT(0, 11)
assert abs(lc.Prob(11) - 0.5) < 1e-6
from qrack_tpu_torch.serve import QrackService
with QrackService(engine_layers="cuda", device="cpu", batch_window_ms=50.0,
                  tick_s=0.02, checkpoint_dir=sys.argv[1] + ".serve") as svc:
    sids = [svc.create_session(5, seed=k) for k in range(2)]
    for h in [svc.submit(s, qft_qcircuit(5)) for s in sids]:
        h.result(60)
    assert 0.0 <= svc.prob(sids[0], 0) <= 1.0
    assert svc.prewarm() >= 1
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


def test_service_default_device_needs_a_gpu(monkeypatch):
    """A service whose sessions would land on the card refuses to start
    without one unless given device="cpu"; host layers need no device."""
    from qrack_tpu_torch.serve import QrackService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QrackService(engine_layers="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        QrackService(engine_layers="route")
    for kw in ({"engine_layers": "cuda", "device": "cpu"},
               {"engine_layers": "cpu"}):
        QrackService(tick_s=0.02, **kw).close()


def test_pager_default_device_needs_a_gpu(monkeypatch):
    """The "pager" terminal and QHybrid past its pager threshold build on
    cuda, and raise where there is none; the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.create_quantum_interface("pager", 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.QPager(3, n_pages=2, devices=["cuda"] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.create_quantum_interface("hybrid", 5, tpu_threshold_qubits=2,
                                    pager_threshold_qubits=3)
    q = qt.create_quantum_interface("pager", 3, n_pages=2, device="cpu")
    assert q.devices == [torch.device("cpu")] * 2
    h = qt.create_quantum_interface("hybrid", 5, tpu_threshold_qubits=2,
                                    pager_threshold_qubits=3, device="cpu",
                                    devices=["cpu"] * 4)
    assert isinstance(h._engine, qt.QPager) and h._engine.n_pages == 4


def test_turboquant_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.create_quantum_interface("turboquant", 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.QEngineCUDATurboQuant(3)
    q = qt.create_quantum_interface("turboquant", 3, device="cpu")
    assert q.device.type == "cpu" and q._codes.device.type == "cpu"


def test_pager_slice_entry_points_need_a_gpu(monkeypatch):
    """The TurboQuant pager, QUnitMulti's units over the "cuda" engine
    and the page programs build on cuda, and raise where there is
    none."""
    from qrack_tpu_torch.models.grover import make_sharded_grover_fn
    from qrack_tpu_torch.models.qft import basis_pages, make_sharded_qft_fn
    from qrack_tpu_torch.models.rcs import make_sharded_rcs_fn
    from qrack_tpu_torch.models.qft import qft_qcircuit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
            lambda: qt.create_quantum_interface("turboquant_pager", 6,
                                                n_pages=2),
            lambda: qt.create_quantum_interface(
                ["unit_multi", "cuda"], 4).FSim(0.3, 0.2, 0, 1),
            lambda: make_sharded_qft_fn(4, 8),
            lambda: make_sharded_rcs_fn(2, 8, 2, 1),
            lambda: make_sharded_grover_fn(2, 8, 3),
            lambda: qft_qcircuit(6).compile_sharded_fn(2, 6),
            lambda: basis_pages(6, 1, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    q = qt.create_quantum_interface("turboquant_pager", 6, n_pages=2,
                                    device="cpu")
    assert q.devices == [torch.device("cpu")] * 2
    assert all(c.device.type == "cpu" for c in q._codes)


def test_route_and_lightcone_need_a_gpu(monkeypatch):
    """"route" and "lightcone" build no stack when they are constructed,
    but resolve their device then: without a GPU and without
    ``device="cpu"`` construction raises, not the first gate; with it
    every stack they build lies on the CPU."""
    from qrack_tpu_torch.lightcone import QLightCone
    from qrack_tpu_torch.route import QRouted

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: qt.create_quantum_interface("route", 3),
                  lambda: qt.create_quantum_interface("lightcone", 3),
                  lambda: QRouted(3), lambda: QLightCone(3),
                  lambda: QRouted(3, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    r = qt.create_quantum_interface("route", 3, device="cpu")
    assert r.current_stack() is None and r.device.type == "cpu"
    r.H(0)
    r.RY(0.3, 1)
    r.CNOT(0, 1)
    assert 0.0 <= r.Prob(1) <= 1.0      # the read relabels the escape
    assert r.current_stack() == "dense"
    assert r._engine.engine.device.type == "cpu"
    lc = qt.create_quantum_interface("lightcone", 3, device="cpu")
    lc.H(0)
    lc.RY(0.3, 1)
    lc.CNOT(0, 1)
    assert 0.0 <= lc.Prob(1) <= 1.0
    (cone,) = lc._cones.values()
    assert cone.device.type == "cpu"


def _device_leaf(**kw):
    """The planes of a QBdt's device leaf (device leaves from 2 attached
    qubits)."""
    from qrack_tpu_torch.layers.qbdt import QBdt

    q = QBdt(4, attached_qubits=2, **kw)
    q._leaf_device_qb = 2
    q.SetPermutation(0b0110)
    node = q.root
    while isinstance(node, tuple):
        node = node[1] if node[1] is not None else node[3]
    return node.planes


def _trajectory_job(**kw):
    """A trajectory job, whose planes live on its device."""
    from qrack_tpu_torch.layers.qcircuit import QCircuit
    from qrack_tpu_torch.noise import NoiseModel, TrajectoryJob

    circ = QCircuit(2)
    circ.append_1q(1, np.eye(2))
    return TrajectoryJob(circ, NoiseModel(), 2, width=2, **kw)


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
        "qbdt_device_leaf": _device_leaf,
        "trajectory_job": _trajectory_job,
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


def test_noisy_terminal_defaults_to_cuda(monkeypatch):
    """The factory's "noisy" terminal builds its one-trajectory engine
    over the card's dense engine, and raises where there is none; the
    complex128 host oracle only with ``device="cpu"``, and never for
    another device."""
    from qrack_tpu_torch.engines.cpu import QEngineCPU
    from qrack_tpu_torch.engines.cuda import QEngineCUDA
    from qrack_tpu_torch.noise import QNoisy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            qt.create_quantum_interface("noisy", 3, noise=0.1, **kw)
    with pytest.raises(ValueError, match="host"):
        QNoisy(3, inner_layers="cpu", device="cuda")
    q = qt.create_quantum_interface("noisy", 3, noise=0.1, device="cpu")
    assert isinstance(q.inner, QEngineCPU)
    q = QNoisy(3, noise=0.1, inner_layers="cuda", device="cpu")
    assert isinstance(q.inner, QEngineCUDA) and q.inner.device.type == "cpu"


def test_chip_smoke_refuses_without_gpu():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_FLEET_PROBE = r"""
import runpy
import sys
sys.argv = ["worker", "--help"]
try:
    runpy.run_module("qrack_tpu_torch.fleet.worker", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
import qrack_tpu_torch.fleet
print(sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "qrack_tpu")
             or m.startswith(("jax.", "jaxlib.", "qrack_tpu."))))
"""


def test_fleet_worker_help_and_import_load_no_jax():
    r = subprocess.run([sys.executable, "-c", _FLEET_PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--engine-kwargs" in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "[]"
    r = subprocess.run([sys.executable, "-m", "qrack_tpu_torch.fleet.worker",
                        "--help"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "--store" in r.stdout, r.stderr


def test_fleet_control_plane_loads_no_engine():
    """The supervisor and the front door route; they load no engine
    module and no kernel wrapper, and initialize no CUDA."""
    code = (
        "import sys, torch\n"
        "import qrack_tpu_torch.fleet.supervisor\n"
        "import qrack_tpu_torch.fleet.frontdoor\n"
        "print(sorted(m for m in sys.modules if m.startswith("
        "('qrack_tpu_torch.engines', 'qrack_tpu_torch.ops.window_kernel',"
        " 'qrack_tpu_torch.ops.turboquant_kernel'))))\n"
        "print(torch.cuda.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["[]", "False"]
