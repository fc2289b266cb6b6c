"""The port's checkpoint plane (qrack_tpu_torch/checkpoint/: container,
registry, the capture/restore hooks of every ported engine and layer,
and the failover snapshot file) on the CPU, held against the JAX
package's.

Each round trip runs a first phase, a file, then a continuation:

* port to port: the JAX engine matrix of tests/test_checkpoint.py on the
  port's stacks, restore-INTO and the build path, the four plane dtypes;
  amplitudes ``np.array_equal`` and ``MAll`` equal;
* across the packages, both ways, for every kind of the registry's table
  (``routed``/``lightcone`` in tests/test_torch_route.py and
  tests/test_torch_lightcone.py): the loaded object, captured again, equals
  the file's arrays exactly (dtype too) with the saver's rng position in
  its meta, and the continuation stays within the float32 bars of the
  parity tests (fidelity > 1 - 1e-6; bfloat16/float16 planes 1e-3/1e-5,
  as tests/test_torch_fppow.py);
* the container writes stored members whose digests equal the JAX
  container's, and reads the JAX package's deflated files.
"""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import qrack_tpu_torch as qt
from qrack_tpu_torch import telemetry as ttele
from qrack_tpu_torch import resilience as tres
from qrack_tpu_torch.checkpoint import (VERSION, CheckpointCorrupt,
                                        CheckpointError,
                                        CheckpointVersionError, build,
                                        capture, load_container, load_state,
                                        save_container, save_state)
from qrack_tpu_torch.checkpoint import container as tc
from qrack_tpu_torch.checkpoint import registry as treg
from qrack_tpu_torch.checkpoint.container import MANIFEST_KEY
from qrack_tpu_torch.resilience import faults as tfaults
from qrack_tpu_torch.utils.rng import QrackRandom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FID_BAR = {"float32": 1e-6, "bfloat16": 1e-3, "float16": 1e-5}


@pytest.fixture(autouse=True)
def _clean():
    import qrack_tpu.resilience as jres
    from qrack_tpu import telemetry as jtele
    from qrack_tpu.resilience import faults as jfaults

    tfaults.clear()
    jfaults.clear()
    yield
    for faults, res, tele in ((tfaults, tres, ttele),
                              (jfaults, jres, jtele)):
        faults.clear()
        res.disable()
        tele.disable()
        tele.reset()
    tres.reset_breaker()
    tres.configure()


def _fidelity(a, b):
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)


# ---------------------------------------------------------------------------
# container: stored members, the JAX package's digests, both file forms
# ---------------------------------------------------------------------------

def _arrays():
    return {"ket": (np.arange(8) + 1j * np.arange(8)).astype(np.complex128),
            "codes": np.arange(32, dtype=np.int8).reshape(4, 8)}


def _manifest(path):
    with np.load(path) as z:
        return json.loads(bytes(z[MANIFEST_KEY].tobytes()))


def test_container_round_trip(tmp_path):
    path = str(tmp_path / "c.qckpt")
    n = save_container(path, _arrays(), meta={"n": 3, "tag": "x"},
                       kind="test-kind")
    assert n == os.path.getsize(path)
    kind, meta, arrays = load_container(path)
    assert kind == "test-kind"
    assert meta == {"n": 3, "tag": "x"}
    for k, v in _arrays().items():
        assert np.array_equal(arrays[k], v)
        assert arrays[k].dtype == v.dtype


def test_container_writes_stored_members(tmp_path):
    path = str(tmp_path / "c.qckpt")
    save_container(path, {"ket": np.zeros(1 << 12, dtype=np.complex128)})
    with zipfile.ZipFile(path) as z:
        infos = z.infolist()
    assert infos and all(i.compress_type == zipfile.ZIP_STORED
                         for i in infos)
    # stored: the file holds every payload byte
    assert os.path.getsize(path) > 16 << 12


DIGEST_CASES = {
    "complex128": np.exp(1j * np.linspace(0, 3, 33)),
    "float32": np.linspace(-1, 1, 40, dtype=np.float32).reshape(2, 20),
    "int8": np.arange(-64, 64, dtype=np.int8).reshape(4, 32),
    "uint8": np.arange(7, dtype=np.uint8),
    "int64_0d": np.asarray(12345, dtype=np.int64),
    "empty": np.zeros((0, 3), dtype=np.float32),
    "strided": np.arange(24, dtype=np.float64).reshape(4, 6)[:, ::2],
}


@pytest.mark.parametrize("name", sorted(DIGEST_CASES))
def test_container_digests_equal_jax(name, tmp_path):
    from qrack_tpu.checkpoint import container as jc

    arr = DIGEST_CASES[name]
    assert tc._sha256(arr) == jc._sha256(arr)
    pt, pj = str(tmp_path / "t.qckpt"), str(tmp_path / "j.qckpt")
    tc.save_container(pt, {"a": arr}, meta={"m": 1}, kind="k")
    jc.save_container(pj, {"a": arr}, meta={"m": 1}, kind="k")
    assert _manifest(pt) == _manifest(pj)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_container_crosses_packages(direction, tmp_path):
    """A deflated JAX file loads in the port; a stored port file loads in
    the JAX package."""
    from qrack_tpu.checkpoint import container as jc

    writer, reader = (jc, tc) if direction == "jax_to_port" else (tc, jc)
    path = str(tmp_path / "x.qckpt")
    writer.save_container(path, _arrays(), meta={"n": 3}, kind="k")
    kind, meta, arrays = reader.load_container(path)
    assert kind == "k" and meta == {"n": 3}
    for k, v in _arrays().items():
        assert np.array_equal(arrays[k], v) and arrays[k].dtype == v.dtype


def test_container_expect_kind_mismatch(tmp_path):
    path = str(tmp_path / "c.qckpt")
    save_container(path, _arrays(), kind="a")
    with pytest.raises(CheckpointError):
        load_container(path, expect_kind="b")


def test_container_rejects_truncation(tmp_path):
    path = str(tmp_path / "c.qckpt")
    save_container(path, _arrays())
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate((size * 3) // 5)
    with pytest.raises(CheckpointCorrupt):
        load_container(path)


def test_container_rejects_bitflip(tmp_path):
    path = str(tmp_path / "c.qckpt")
    save_container(path, {"ket": np.zeros(1 << 12, dtype=np.complex128)})
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorrupt):
        load_container(path)


def test_container_rejects_bare_npz_without_legacy(tmp_path):
    path = str(tmp_path / "bare.npz")
    np.savez_compressed(path, a=np.arange(4))
    with pytest.raises(CheckpointCorrupt):
        load_container(path)
    kind, meta, arrays = load_container(path, legacy_ok=True)
    assert kind is None and meta == {}
    assert np.array_equal(arrays["a"], np.arange(4))


def test_container_rejects_newer_version(tmp_path):
    path = str(tmp_path / "future.qckpt")
    manifest = {"format": "qrack-checkpoint", "version": VERSION + 1,
                "kind": "raw", "meta": {}, "payload": {}}
    with open(path, "wb") as f:
        np.savez(f, **{MANIFEST_KEY: np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)})
    with pytest.raises(CheckpointVersionError):
        load_container(path)


def test_container_atomic_write_preserves_previous(tmp_path):
    path = str(tmp_path / "c.qckpt")
    save_container(path, {"v": np.asarray([1])})
    with pytest.raises(CheckpointError):
        save_container(path, {"__bad__": np.asarray([2])})
    _, _, arrays = load_container(path)
    assert int(arrays["v"][0]) == 1  # old file untouched
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoint_telemetry_counters(tmp_path):
    ttele.enable()
    path = str(tmp_path / "c.qckpt")
    nbytes = save_container(path, _arrays())
    load_container(path)
    snap = ttele.snapshot()
    assert snap["counters"]["checkpoint.save"] == 1
    assert snap["counters"]["checkpoint.save.bytes"] == nbytes
    assert snap["counters"]["checkpoint.restore"] == 1
    assert "checkpoint.save" in snap["spans"]


def _phase1(q, n, clifford=False):
    for t in range(n):
        q.H(t)
    for t in range(n - 1):
        q.CNOT(t, t + 1)
    if not clifford:
        for t in range(0, n, 2):
            q.T(t)
    q.S(0)
    q.X(n - 1)


def _phase2(q, n, clifford=False):
    q.CNOT(1, 2)  # crosses factor groups formed post-restore
    q.H(0)
    if not clifford:
        q.T(1)
    q.CNOT(0, n - 1)
    q.S(2)
    q.H(n - 1)


def _lossy_cpu(tmp_path):
    eng = qt.create_quantum_interface("cpu", 4, rng=QrackRandom(3))
    _phase1(eng, 4)
    path = str(tmp_path / "ket.npz")
    eng.LossySaveStateVector(path)
    back = qt.create_quantum_interface("cpu", 4, rng=QrackRandom(9))
    back.LossyLoadStateVector(path)
    return path, "turboquant-lossy-ket", "seed", eng, back


def _lossy_pager(tmp_path):
    eng = qt.create_quantum_interface("pager", 6, n_pages=4, device="cpu",
                                      rng=QrackRandom(3))
    _phase1(eng, 6)
    path = str(tmp_path / "pager.npz")
    eng.LossySaveStateVector(path)
    back = qt.create_quantum_interface("pager", 6, n_pages=2, device="cpu",
                                       rng=QrackRandom(9))
    back.LossyLoadStateVector(path)
    return path, "qpager-turboquant", "codes_0", eng, back


def _lossy_qunit(tmp_path):
    eng = qt.create_quantum_interface("optimal", 6, device="cpu",
                                      tpu_threshold_qubits=3,
                                      rng=QrackRandom(3))
    _phase1(eng, 6)
    path = str(tmp_path / "unit.npz")
    eng.LossySaveStateVector(path)
    back = qt.create_quantum_interface("optimal", 6, device="cpu",
                                       tpu_threshold_qubits=3,
                                       rng=QrackRandom(9))
    back.LossyLoadStateVector(path)
    return path, None, None, eng, back


def _lossy_turboquant(tmp_path):
    from qrack_tpu_torch.engines.turboquant import QEngineCUDATurboQuant

    eng = qt.create_quantum_interface("turboquant", 6, device="cpu",
                                      rng=QrackRandom(3))
    _phase1(eng, 6)
    path = str(tmp_path / "tq.npz")
    eng.SaveTurboQuant(path)
    back = QEngineCUDATurboQuant.LoadTurboQuant(path, device="cpu")
    assert np.array_equal(back.host_codes()[0], eng.host_codes()[0])
    return path, "turboquant-codes", "seed", eng, back


LOSSY = {"cpu": _lossy_cpu, "pager": _lossy_pager, "qunit": _lossy_qunit,
         "turboquant": _lossy_turboquant}


@pytest.mark.parametrize("name", sorted(LOSSY))
def test_lossy_serializers_round_trip_stored(name, tmp_path):
    """The lossy serializers that ride the container keep their member
    layout, write stored members, round-trip, and reject a torn file."""
    path, kind, member, eng, back = LOSSY[name](tmp_path)
    with zipfile.ZipFile(path) as z:
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in z.infolist())
    got_kind, _, arrays = load_container(path)
    if kind is not None:
        assert got_kind == kind
    if member is not None:
        assert member in arrays  # the legacy member layout
    if hasattr(back, "NormalizeState"):
        back.NormalizeState()
    assert _fidelity(back.GetQuantumState(), eng.GetQuantumState()) > 0.99
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CheckpointCorrupt):
        load_container(path)


# ---------------------------------------------------------------------------
# port to port: the engine matrix, the build path, the plane dtypes
# ---------------------------------------------------------------------------

def _pager(n, **kw):
    return qt.create_quantum_interface("pager", n, n_pages=4, device="cpu",
                                       **kw)


PORT_FACTORIES = {
    "cuda": lambda n, **kw: qt.QEngineCUDA(n, device="cpu", **kw),
    "pager": _pager,
    "hybrid": lambda n, **kw: qt.create_quantum_interface(
        "hybrid", n, device="cpu", tpu_threshold_qubits=4,
        pager_threshold_qubits=7, devices=["cpu"] * 4, **kw),
    "stabhybrid": lambda n, **kw: qt.create_quantum_interface(
        ["stabilizer_hybrid", "cpu"], n, **kw),
    "qunit": lambda n, **kw: qt.create_quantum_interface(
        ["unit", "cpu"], n, **kw),
    "full_stack": lambda n, **kw: qt.create_quantum_interface(
        "optimal", n, device="cpu", tpu_threshold_qubits=3, **kw),
    "optimal_multi": lambda n, **kw: qt.create_quantum_interface(
        "optimal_multi", n, device="cpu", tpu_threshold_qubits=3,
        device_ids=[0, 0], **kw),
    "sparse": lambda n, **kw: qt.create_quantum_interface("sparse", n, **kw),
    "bdt_hybrid": lambda n, **kw: qt.create_quantum_interface(
        ["bdt_hybrid", "hybrid"], n, device="cpu", tpu_threshold_qubits=3,
        **kw),
    "bdt_attached": lambda n, **kw: qt.create_quantum_interface(
        "bdt_attached", n, device="cpu", **kw),
    "bdt": lambda n, **kw: qt.create_quantum_interface("bdt", n,
                                                       device="cpu", **kw),
    "cpu": lambda n, **kw: qt.create_quantum_interface("cpu", n, **kw),
    "turboquant": lambda n, **kw: qt.create_quantum_interface(
        "turboquant", n, device="cpu", bits=16, **kw),
    "turboquant_pager": lambda n, **kw: qt.create_quantum_interface(
        "turboquant_pager", n, n_pages=2, device="cpu", bits=16, **kw),
    "tensor_hybrid": lambda n, **kw: qt.create_quantum_interface(
        ["stabilizer_hybrid", "hybrid"], n, device="cpu",
        tpu_threshold_qubits=3, **kw),
}

PORT_CLIFFORD = {
    "stabilizer": lambda n, **kw: qt.create_quantum_interface(
        "stabilizer", n, **{k: v for k, v in kw.items()
                            if k != "rand_global_phase"}),
    "unit_clifford": lambda n, **kw: qt.create_quantum_interface(
        "unit_clifford", n, **kw),
}


def _port_round_trip(factory, n, tmp_path, clifford=False, into=True):
    a = factory(n, rng=QrackRandom(7))
    _phase1(a, n, clifford)
    path = str(tmp_path / "state.qckpt")
    save_state(a, path)
    if into:
        c = load_state(path, into=factory(n, rng=QrackRandom(991)))
    else:
        c = load_state(path, device="cpu")
    for q in (a, c):
        _phase2(q, n, clifford)
    sa = np.asarray(a.GetQuantumState(), dtype=np.complex128)
    sc = np.asarray(c.GetQuantumState(), dtype=np.complex128)
    # capture is non-mutating: `a` continued from live state, `c` from
    # the file — bit-identical amplitudes AND measurement stream
    assert np.array_equal(sa, sc)
    assert a.MAll() == c.MAll()
    return c


@pytest.mark.parametrize("name", sorted(PORT_FACTORIES))
def test_round_trip_engine_matrix(name, tmp_path):
    _port_round_trip(PORT_FACTORIES[name], 6, tmp_path)


@pytest.mark.parametrize("name", sorted(PORT_CLIFFORD))
def test_round_trip_clifford_matrix(name, tmp_path):
    _port_round_trip(PORT_CLIFFORD[name], 6, tmp_path, clifford=True)


BUILD_NAMES = ["cuda", "pager", "sparse", "cpu", "turboquant", "bdt",
               "turboquant_pager", "hybrid"]


@pytest.mark.parametrize("name", BUILD_NAMES)
def test_round_trip_build_path(name, tmp_path):
    """load_state without a target rebuilds through the registry's
    default wiring, on the device the caller names."""
    c = _port_round_trip(PORT_FACTORIES[name], 6, tmp_path, into=False)
    assert treg.device_of(c) in (None, torch.device("cpu"))


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16",
                                   "float16"])
@pytest.mark.parametrize("terminal", ["cuda", "pager", "optimal"])
def test_round_trip_plane_dtypes(terminal, dtype, tmp_path):
    kw = {"device": "cpu", "dtype": dtype}
    if terminal == "pager":
        kw["n_pages"] = 2
    if terminal == "optimal":
        kw["tpu_threshold_qubits"] = 3

    def factory(n, **k):
        return qt.create_quantum_interface(terminal, n, **kw, **k)

    c = _port_round_trip(factory, 7, tmp_path)
    if terminal != "optimal":
        assert c.dtype == getattr(torch, dtype)
    snap = capture(c)
    if terminal == "cuda":
        assert snap["meta"]["dtype"] == dtype
        assert snap["arrays"]["planes"].dtype == (
            np.float64 if dtype == "float64" else np.float32)


def test_capture_does_not_mutate(tmp_path):
    """Capture flushes the fuser and reads the pager raw: no unmap
    dispatch, no rng draw, the same physical pages and table after."""
    q = qt.create_quantum_interface("pager", 7, n_pages=4, device="cpu",
                                    remap="on", rng=QrackRandom(5),
                                    rand_global_phase=False)
    for t in range(7):
        q.H(t)
    q.CNOT(6, 0)
    q.T(5)
    q.H(6)  # pending window with a page-bit gate
    q._settle()
    before = [p.clone() for p in q._pages_raw]
    qmap = list(q._qmap)
    rng = q.rng._gen.bit_generator.state
    snap = capture(q)
    assert q._qmap == qmap and q.rng._gen.bit_generator.state == rng
    assert all(torch.equal(a, b) for a, b in zip(before, q._pages_raw))
    assert snap["meta"]["qmap"] == qmap


def test_pager_file_loads_into_other_page_count(tmp_path):
    a = qt.create_quantum_interface("pager", 8, n_pages=4, device="cpu",
                                    remap="on", rng=QrackRandom(2),
                                    rand_global_phase=False)
    for t in range(8):
        a.H(t)
    a.CNOT(7, 1)
    a.T(6)
    a.CNOT(6, 2)
    _ = a.Prob(0)
    path = str(tmp_path / "p.qckpt")
    save_state(a, path)
    b = load_state(path, into=qt.create_quantum_interface(
        "pager", 8, n_pages=2, device="cpu", rand_global_phase=False))
    assert b.n_pages == 2
    assert _fidelity(a.GetQuantumState(), b.GetQuantumState()) > 1 - 1e-12


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _jax_factories():
    from qrack_tpu import create_quantum_interface as jcreate
    from qrack_tpu import QEngineCPU as JCPU
    from qrack_tpu.engines.hybrid import QHybrid as JHybrid
    from qrack_tpu.engines.sparse import QEngineSparse as JSparse
    from qrack_tpu.engines.tpu import QEngineTPU
    from qrack_tpu.layers.qbdt import QBdt as JBdt
    from qrack_tpu.layers.qunitclifford import QUnitClifford as JUC
    from qrack_tpu.layers.stabilizer import QStabilizer as JStab
    from qrack_tpu.parallel.pager import QPager as JPager

    return {
        "tpu": lambda n, **kw: QEngineTPU(n, dtype="float32", **kw),
        "tpu_bfloat16": lambda n, **kw: QEngineTPU(n, dtype="bfloat16", **kw),
        "tpu_float16": lambda n, **kw: QEngineTPU(n, dtype="float16", **kw),
        "cpu": lambda n, **kw: JCPU(n, **kw),
        "sparse": lambda n, **kw: JSparse(n, **kw),
        "pager": lambda n, **kw: JPager(n, n_pages=4, **kw),
        "stabilizer": lambda n, **kw: JStab(n, rng=kw.get("rng")),
        "unit_clifford": lambda n, **kw: JUC(n, **kw),
        "unit": lambda n, **kw: jcreate(["unit", "stabilizer_hybrid",
                                         "hybrid"], n,
                                        tpu_threshold_qubits=3, **kw),
        "unit_multi": lambda n, **kw: jcreate(
            ["unit_multi", "stabilizer_hybrid", "hybrid"], n,
            tpu_threshold_qubits=3, **kw),
        "stabilizer_hybrid": lambda n, **kw: jcreate(
            ["stabilizer_hybrid", "hybrid"], n, tpu_threshold_qubits=3, **kw),
        "bdt": lambda n, **kw: JBdt(n, attached_qubits=2, **kw),
        "bdt_hybrid": lambda n, **kw: jcreate(["bdt_hybrid", "hybrid"], n,
                                              tpu_threshold_qubits=3, **kw),
        "hybrid": lambda n, **kw: JHybrid(n, tpu_threshold_qubits=4,
                                          pager_threshold_qubits=7, **kw),
    }


# the kind each cross case writes at its root
CROSS_KIND = {"tpu": "tpu", "tpu_bfloat16": "tpu", "tpu_float16": "tpu",
              "cpu": "cpu", "sparse": "sparse", "pager": "pager",
              "stabilizer": "stabilizer", "unit_clifford": "unit_clifford",
              "unit": "unit", "unit_multi": "unit_multi",
              "stabilizer_hybrid": "stabilizer_hybrid", "bdt": "bdt",
              "bdt_hybrid": "bdt_hybrid", "hybrid": "hybrid"}
CLIFFORD_CASES = {"stabilizer", "unit_clifford"}
TQ_CASES = {"turboquant": False, "turboquant_pager": True}
TILE = 4


def _port_cross_factory(name):
    """The port's counterpart of a JAX cross case (stacks built the way
    the JAX case is wired)."""
    if name.startswith("tpu"):
        dt = name.partition("_")[2] or "float32"
        return lambda n, **kw: qt.QEngineCUDA(n, device="cpu", dtype=dt, **kw)
    return {
        "cpu": PORT_FACTORIES["cpu"],
        "sparse": PORT_FACTORIES["sparse"],
        "pager": PORT_FACTORIES["pager"],
        "stabilizer": PORT_CLIFFORD["stabilizer"],
        "unit_clifford": PORT_CLIFFORD["unit_clifford"],
        "unit": PORT_FACTORIES["full_stack"],
        "unit_multi": PORT_FACTORIES["optimal_multi"],
        "stabilizer_hybrid": PORT_FACTORIES["tensor_hybrid"],
        "bdt": lambda n, **kw: qt.create_quantum_interface(
            "bdt", n, device="cpu", attached_qubits=2, **kw),
        "bdt_hybrid": PORT_FACTORIES["bdt_hybrid"],
        "hybrid": PORT_FACTORIES["hybrid"],
    }[name]


def _assert_tree_equal(got, want, path="root"):
    """A snapshot tree against another: kinds, meta (the rng position
    included) and arrays (values and dtypes) exactly."""
    assert got["kind"] == want["kind"], path
    assert got.get("meta", {}) == want.get("meta", {}), path
    ga, wa = got.get("arrays", {}), want.get("arrays", {})
    assert sorted(ga) == sorted(wa), path
    for k in wa:
        g, w = np.asarray(ga[k]), np.asarray(wa[k])
        assert g.dtype == w.dtype, f"{path}/{k}"
        assert np.array_equal(g, w), f"{path}/{k}"
    gc, wc = got.get("children", {}), want.get("children", {})
    assert sorted(gc) == sorted(wc), path
    for k in wc:
        _assert_tree_equal(gc[k], wc[k], f"{path}/{k}")


def _cross_bar(name):
    dt = name.partition("_")[2] if name.startswith("tpu_") else "float32"
    return FID_BAR[dt]


@pytest.mark.parametrize("name", sorted(CROSS_KIND))
def test_jax_file_loads_into_port(name, tmp_path):
    from qrack_tpu.checkpoint import load_snapshot as jload_snapshot
    from qrack_tpu.checkpoint import save_state as jsave
    from qrack_tpu.utils.rng import QrackRandom as JRandom

    n, cl = 6, name in CLIFFORD_CASES
    a = _jax_factories()[name](n, rng=JRandom(7), rand_global_phase=False) \
        if name != "stabilizer" else _jax_factories()[name](n, rng=JRandom(7))
    _phase1(a, n, cl)
    path = str(tmp_path / "jax.qckpt")
    jsave(a, path)
    file_snap = jload_snapshot(path)
    assert file_snap["kind"] == CROSS_KIND[name]
    c = load_state(path, device="cpu")
    _assert_tree_equal(capture(c), file_snap)
    for q in (a, c):
        _phase2(q, n, cl)
    assert _fidelity(a.GetQuantumState(), c.GetQuantumState()) > \
        1 - _cross_bar(name)


@pytest.mark.parametrize("name", sorted(CROSS_KIND))
def test_port_file_loads_into_jax(name, tmp_path):
    from qrack_tpu.checkpoint import capture as jcapture
    from qrack_tpu.checkpoint import load_state as jload

    n, cl = 6, name in CLIFFORD_CASES
    kw = {} if name == "stabilizer" else {"rand_global_phase": False}
    a = _port_cross_factory(name)(n, rng=QrackRandom(7), **kw)
    _phase1(a, n, cl)
    path = str(tmp_path / "port.qckpt")
    save_state(a, path)
    file_snap = treg.load_snapshot(path)
    assert file_snap["kind"] == CROSS_KIND[name]
    c = jload(path)
    _assert_tree_equal(jcapture(c), file_snap)
    for q in (a, c):
        _phase2(q, n, cl)
    assert _fidelity(a.GetQuantumState(), c.GetQuantumState()) > \
        1 - _cross_bar(name)


def _tq_pair(kind, seed):
    from qrack_tpu.engines.turboquant import QEngineTurboQuant
    from qrack_tpu.parallel.turboquant_pager import QPagerTurboQuant
    from qrack_tpu.utils.rng import QrackRandom as JRandom

    kw = dict(bits=16, chunk_qb=5, block_pow=2, rand_global_phase=False)
    if kind == "turboquant_pager":
        port = qt.create_quantum_interface("turboquant_pager", 8, n_pages=2,
                                           device="cpu",
                                           rng=QrackRandom(seed), **kw)
        ref = QPagerTurboQuant(8, n_pages=2, rng=JRandom(seed), **kw)
    else:
        port = qt.create_quantum_interface("turboquant", 8, device="cpu",
                                           rng=QrackRandom(seed), **kw)
        ref = QEngineTurboQuant(8, rng=JRandom(seed), **kw)
    port._PALLAS_TILE_POW = TILE
    ref._PALLAS_TILE_POW = TILE
    return port, ref


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", sorted(TQ_CASES))
def test_turboquant_file_crosses_packages(kind, direction, tmp_path,
                                          monkeypatch):
    """The codes and scales cross verbatim; the chunk and the tile are
    pinned alike on both sides (they decide which tiles later gates
    requantize), as in tests/test_torch_turboquant_engine.py."""
    from qrack_tpu.checkpoint import capture as jcapture
    from qrack_tpu.checkpoint import load_state as jload
    from qrack_tpu.checkpoint import save_state as jsave

    monkeypatch.setenv("QRACK_USE_PALLAS", "1")
    src_port, src_ref = _tq_pair(kind, 7)
    dst_port, dst_ref = _tq_pair(kind, 991)
    path = str(tmp_path / "tq.qckpt")
    if direction == "jax_to_port":
        a, save, load, cap, into = src_ref, jsave, load_state, capture, \
            dst_port
    else:
        a, save, load, cap, into = src_port, save_state, jload, jcapture, \
            dst_ref
    _phase1(a, 8)
    save(a, path)
    file_snap = treg.load_snapshot(path)
    assert file_snap["kind"] == kind
    c = load(path, into=into)
    got = cap(c)
    # the engines' chunk is recorded as each side holds it, and the
    # port's pager records its page count
    for snap in (got, file_snap):
        snap["meta"].pop("chunk_pow")
        snap["meta"].pop("n_pages", None)
    _assert_tree_equal(got, file_snap)
    for q in (a, c):
        _phase2(q, 8)
    assert _fidelity(a.GetQuantumState(), c.GetQuantumState()) > 1 - 1e-6


def test_jax_bdt_file_same_nodes_through_convert_and_registry(tmp_path):
    """A JAX QBdt capture read by convert.bdt_from_numpy and by the
    registry gives the same nodes: both run QBdt._ckpt_restore."""
    from qrack_tpu.checkpoint import save_state as jsave
    from qrack_tpu.layers.qbdt import QBdt as JBdt
    from qrack_tpu.utils.rng import QrackRandom as JRandom
    from qrack_tpu_torch.convert import bdt_from_numpy

    j = JBdt(7, attached_qubits=3, rng=JRandom(4), rand_global_phase=False)
    _phase1(j, 7)
    path = str(tmp_path / "bdt.qckpt")
    jsave(j, path)
    snap = treg.load_snapshot(path)
    via_convert = bdt_from_numpy(snap["meta"], snap["arrays"], device="cpu",
                                 rand_global_phase=False)
    via_registry = load_state(path, device="cpu")
    a, b = capture(via_convert), capture(via_registry)
    a["meta"].pop("rng")
    b["meta"].pop("rng")
    _assert_tree_equal(a, b)
    assert len(via_convert._t.table) == len(via_registry._t.table)
    assert np.array_equal(via_convert.GetQuantumState(),
                          via_registry.GetQuantumState())


def test_hybrid_failed_over_crosses_as_tpu(tmp_path):
    """The port's failover ceiling "cuda" is the JAX QHybrid's "tpu" in
    the file, and reads back as "cuda"."""
    from qrack_tpu.checkpoint import load_state as jload

    h = PORT_FACTORIES["hybrid"](6, rng=QrackRandom(1))
    h._failed_over = "cuda"
    path = str(tmp_path / "h.qckpt")
    save_state(h, path)
    assert treg.load_snapshot(path)["meta"]["failed_over"] == "tpu"
    assert jload(path)._failed_over == "tpu"
    back = load_state(path, into=PORT_FACTORIES["hybrid"](6))
    assert back._failed_over == "cuda"


# ---------------------------------------------------------------------------
# faults, a fresh process, the errors
# ---------------------------------------------------------------------------

def test_torn_write_rejected_and_atomic_failure_keeps_previous(tmp_path):
    """A torn save lands a file the loader rejects; the next save heals
    it, and a save that fails before landing keeps the previous file."""
    q = qt.QEngineCUDA(5, device="cpu", rng=QrackRandom(2))
    _phase1(q, 5)
    path = str(tmp_path / "s.qckpt")
    tres.enable()
    tfaults.inject("checkpoint.save", "torn-write")
    save_state(q, path)
    with pytest.raises(CheckpointCorrupt):
        load_state(path, device="cpu")
    save_state(q, path)
    good = load_state(path, device="cpu").GetQuantumState()
    assert np.array_equal(good, q.GetQuantumState())
    tfaults.inject("checkpoint.save", "raise")
    with pytest.raises(Exception):
        save_state(q, path)
    assert np.array_equal(load_state(path, device="cpu").GetQuantumState(),
                          good)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_restore_site_fault_propagates(tmp_path):
    from qrack_tpu_torch.resilience.errors import InjectedFault

    q = qt.QEngineCUDA(4, device="cpu")
    path = str(tmp_path / "s.qckpt")
    save_state(q, path)
    tres.enable()
    tfaults.inject("checkpoint.restore", "raise", times=None)
    with pytest.raises(InjectedFault):
        load_state(path, device="cpu")
    with pytest.raises(InjectedFault):
        load_state(path, into=qt.QEngineCUDA(4, device="cpu"))


def test_load_in_fresh_process(tmp_path):
    """The file is the interface: a port file loads in a process that
    imports only qrack_tpu_torch (no JAX module loads)."""
    n = 6
    a = PORT_FACTORIES["pager"](n, rng=QrackRandom(7))
    _phase1(a, n)
    path = str(tmp_path / "x.qckpt")
    save_state(a, path)
    expect = np.asarray(a.GetQuantumState(), dtype=np.complex128)
    out = str(tmp_path / "loaded.npy")
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from qrack_tpu_torch.checkpoint import load_state\n"
        f"eng = load_state({path!r}, device='cpu')\n"
        "st = np.asarray(eng.GetQuantumState(), dtype=np.complex128)\n"
        f"np.save({out!r}, st)\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'qrack_tpu.'))))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
    assert np.array_equal(np.load(out), expect)


@pytest.mark.parametrize("kind", ["routed", "lightcone"])
def test_unported_kinds_raise_naming_item_16(kind, tmp_path):
    """The kinds of ROADMAP item 16a are real: an empty snapshot of
    either builds the port's class with no stack (as the JAX registry
    does), and loading it into an object of another kind is refused."""
    snap = {"kind": kind, "meta": {"n": 3, "init_state": 0}, "arrays": {},
            "children": {}}
    want = {"routed": "QRouted", "lightcone": "QLightCone"}[kind]
    assert type(build(snap, device="cpu")).__name__ == want
    path = str(tmp_path / "r.qckpt")
    treg.save_snapshot(snap, path)
    back = load_state(path, device="cpu")
    assert type(back).__name__ == want and back.qubit_count == 3
    assert (back.current_stack() is None if kind == "routed"
            else back.sim is None and not back.circuit.gates)
    with pytest.raises(CheckpointError, match="does not match"):
        load_state(path, into=qt.QEngineCUDA(3, device="cpu"))


@pytest.mark.parametrize("name", ["enable_warm_start", "ProgramManifest"])
def test_warm_start_names_item_16(name):
    """The warm start of ROADMAP item 16 (its 16b, the serving plane)
    loads on first touch, as the store does."""
    import qrack_tpu_torch.checkpoint as ck
    from qrack_tpu_torch.checkpoint import warmstart

    assert getattr(ck, name) is getattr(warmstart, name)
    assert name in ck.__all__


@pytest.mark.parametrize("name", ["cuda", "cpu", "pager", "optimal"])
def test_load_without_gpu_needs_device_cpu(name, tmp_path, monkeypatch):
    """Without a GPU, load_state and build raise unless the caller
    passes device="cpu"; a restore INTO a live object needs no device."""
    q = (PORT_FACTORIES["full_stack"] if name == "optimal"
         else PORT_FACTORIES[name])(5, rng=QrackRandom(1))
    _phase1(q, 5)
    path = str(tmp_path / "s.qckpt")
    save_state(q, path)
    snap = treg.load_snapshot(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_state(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(snap)
    # the default wiring may read the ket through other engines than
    # the saver's stack: the state itself is what loads exactly
    _assert_tree_equal(capture(load_state(path, device="cpu")), snap)


def test_resilient_proxy_restore_builds_on_its_device(tmp_path):
    """restore_into a ResilientEngine: the same kind restores into the
    wrapped engine; another kind is built on the proxy's device."""
    tres.enable()
    r = qt.create_quantum_interface("cuda", 5, device="cpu",
                                    rng=QrackRandom(3))
    assert type(r).__name__ == "ResilientEngine"
    p = PORT_FACTORIES["pager"](5, rng=QrackRandom(4))
    _phase1(p, 5)
    path = str(tmp_path / "p.qckpt")
    save_state(p, path)
    load_state(path, into=r)
    assert type(r.engine).__name__ == "QPager"
    assert r.engine.devices == [torch.device("cpu")] * 4
    assert np.array_equal(r.GetQuantumState(), p.GetQuantumState())
    d = qt.QEngineCUDA(5, device="cpu", rng=QrackRandom(5))
    _phase1(d, 5)
    save_state(d, path)
    inner = r.engine
    load_state(path, into=r)
    assert type(r.engine).__name__ == "QEngineCUDA" and r.engine is not inner
    assert np.array_equal(r.GetQuantumState(), d.GetQuantumState())


# ---------------------------------------------------------------------------
# the failover snapshot file
# ---------------------------------------------------------------------------

def test_failover_persist_writes_one_file_per_move(tmp_path, monkeypatch):
    """A persistent pager-site fault walks a 2-page pager down the chain
    (shrink, then QEngineCUDA; no CPU rung): one file per move, each
    the ket before the failed call.  No retries, so the breaker stays
    closed and the dense rung is open."""
    monkeypatch.setenv("QRACK_TPU_FAILOVER_PERSIST", str(tmp_path))
    ttele.enable()
    tres.enable()
    tres.configure(max_retries=0)
    q = qt.create_quantum_interface("pager", 6, n_pages=2, device="cpu",
                                    rng=QrackRandom(8),
                                    rand_global_phase=False)
    for t in range(6):
        q.H(t)
    q.T(2)
    q.CNOT(0, 3)
    q.CNOT(5, 1)
    before = np.asarray(q.GetQuantumState())
    tfaults.inject("pager.device_get", "raise", after_n=0, times=None)
    amp = q.GetAmplitude(3)
    tfaults.clear()
    assert type(q.engine).__name__ == "QEngineCUDA"
    assert amp == before[3]
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".qckpt"))
    c = ttele.snapshot()["counters"]
    assert len(files) == c["resilience.failovers"] == 2
    assert c.get("resilience.failover.persisted", 0) >= 2
    kinds = []
    for f in files:
        assert f.startswith("failover-")
        back = load_state(str(tmp_path / f), device="cpu")
        kinds.append(back.n_pages)
        assert np.array_equal(back.GetQuantumState(), before)
    assert kinds == [2, 1]


def test_failover_persist_rejects_poisoned_snapshot(tmp_path, monkeypatch):
    """A nan-poisoned ket must NOT overwrite the newest good snapshot:
    the capture is verified and rejected before any file is written."""
    from qrack_tpu_torch.resilience.failover import _persist_snapshot

    monkeypatch.setenv("QRACK_TPU_FAILOVER_PERSIST", str(tmp_path))
    ttele.enable()
    tres.enable()
    q = qt.create_quantum_interface("cuda", 4, device="cpu",
                                    rng=QrackRandom(1),
                                    rand_global_phase=False)
    q.H(0)
    _ = q.Prob(0)
    eng = q.engine
    path = _persist_snapshot(eng, RuntimeError("evidence"))
    assert path is not None and os.path.exists(path)
    n_files = len(os.listdir(tmp_path))
    eng._state_raw[0, 0] = float("nan")
    assert _persist_snapshot(eng, RuntimeError("poison")) is None
    assert len(os.listdir(tmp_path)) == n_files
    c = ttele.snapshot()["counters"]
    assert c.get("resilience.failover.persist_rejected", 0) == 1
    assert c.get("resilience.failover.persisted", 0) >= 1


def test_failover_persist_failure_is_counted(tmp_path, monkeypatch):
    """A persist that cannot write is counted and does not block."""
    from qrack_tpu_torch.resilience.failover import _persist_snapshot

    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("QRACK_TPU_FAILOVER_PERSIST", str(blocker / "sub"))
    ttele.enable()
    q = qt.QEngineCUDA(3, device="cpu")
    assert _persist_snapshot(q, None) is None
    assert ttele.snapshot()["counters"].get(
        "resilience.failover.persist_failed", 0) == 1


def test_plane_arms_with_persist_set(tmp_path, monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FAILOVER_PERSIST", str(tmp_path))
    tres.enable()
    assert tres.active()


@pytest.mark.parametrize("n", [4, 10, 11, 21])
def test_draw_index_matches_the_cumsum_draw(n):
    """The card's MAll draw (gatekernels.draw_index: row sums level by
    level, float64) picks the index the JAX package's cumsum draw picks,
    on seeded kets and uniforms (held here on CPU tensors)."""
    from qrack_tpu_torch.ops import gatekernels as gk

    rng = np.random.default_rng(n)
    for _ in range(20):
        ket = rng.standard_normal((2, 1 << n)).astype(np.float32)
        ket[:, rng.random(1 << n) < 0.5] = 0.0
        planes = torch.from_numpy(ket)
        u = float(rng.random())
        p = (ket[0].astype(np.float64) ** 2 + ket[1].astype(np.float64) ** 2)
        want = min(int(np.searchsorted(np.cumsum(p), u * p.sum(),
                                       side="right")), (1 << n) - 1)
        got = gk.draw_index(planes, u)
        assert got == want and p[got] > 0
        assert gk.draw_index(planes, u) == got
