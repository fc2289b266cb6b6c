"""The port's QBdt and QBdtHybrid against the JAX package's, after
tests/test_qbdt.py: the same seeded gate streams build trees of the same
node count and kets within 1e-12 (host nodes and host leaves, complex128
on both sides); device leaves (float32 planes, forced at small k with
QRACK_QBDT_LEAF_DEVICE_QB) within 1e-6; the hybrid switches at the same
gate; measurements agree draw for draw; Compose/Decompose/Dispose take
the same tree paths; and a JAX tree carried across with
convert.bdt_from_numpy keeps its node count, sharing and amplitudes.
"""

import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu.layers.qbdt import QBdt as JaxQBdt
from qrack_tpu.layers.qbdthybrid import QBdtHybrid as JaxQBdtHybrid
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.convert import bdt_from_numpy
from qrack_tpu_torch.engines.cpu import QEngineCPU
from qrack_tpu_torch.engines.cuda import QEngineCUDA
from qrack_tpu_torch.layers.qbdt import QBdt, _EngLeaf
from qrack_tpu_torch.layers.qbdthybrid import QBdtHybrid
from qrack_tpu_torch.utils.rng import QrackRandom

from test_torch_qunit import run, universal_stream


def pair(n, seed, **kw):
    port = QBdt(n, rng=QrackRandom(seed), rand_global_phase=False,
                device="cpu", **kw)
    ref = JaxQBdt(n, rng=JaxRandom(seed), rand_global_phase=False, **kw)
    return port, ref


def assert_twins(port, ref, atol=1e-12):
    assert port.qubit_count == ref.qubit_count
    assert port.node_count() == ref.node_count()
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=atol, rtol=0)


def leaves(q):
    """The distinct dense leaves of a tree of either package."""
    out, seen, todo = [], set(), [q.root]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if type(node).__name__ == _EngLeaf.__name__:
            out.append(node)
        elif isinstance(node, tuple) and len(node) == 4:
            todo += [node[1], node[3]]
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("attached", [0, 3])
def test_streams_match_jax(seed, attached):
    n = 6
    port, ref = pair(n, seed, attached_qubits=attached)
    run((port, ref), universal_stream(seed, n, 40))
    assert_twins(port, ref)
    assert port.footprint_amps() == ref.footprint_amps()
    assert [port.M(q) for q in range(n)] == [ref.M(q) for q in range(n)]
    assert_twins(port, ref)


@pytest.mark.parametrize("seed", [7, 8])
def test_device_leaves_match_jax(seed, monkeypatch):
    """Leaves as float32 planes on the QBdt's device (here the CPU), both
    packages forced to device leaves at k = 3."""
    monkeypatch.setenv("QRACK_QBDT_LEAF_DEVICE_QB", "1")
    n = 6
    port, ref = pair(n, seed, attached_qubits=3)
    assert port._leaf_on_device() and ref._leaf_on_device()
    run((port, ref), universal_stream(seed, n, 30))
    assert port.node_count() == ref.node_count()
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6, rtol=0)
    for q in range(n):
        assert abs(port.Prob(q) - ref.Prob(q)) <= 1e-6
    found = leaves(port)
    assert found and all(isinstance(lf.planes, torch.Tensor)
                         and lf.planes.device.type == "cpu"
                         and lf.planes.dtype == torch.float32 for lf in found)
    assert [port.M(q) for q in range(n)] == [ref.M(q) for q in range(n)]


def test_ghz_wide_stays_a_tree_like_jax():
    n = 40
    port, ref = pair(n, 3)
    for q in (port, ref):
        q.H(0)
        for i in range(n - 1):
            q.CNOT(i, i + 1)
        q.T(0)
    assert port.node_count() == ref.node_count() <= 2 * n + 4
    assert [port.Prob(q) for q in (0, 17, 39)] == \
        pytest.approx([ref.Prob(q) for q in (0, 17, 39)], abs=1e-12)
    port.rng.seed(5)
    ref.rng.seed(5)
    assert port.M(20) == ref.M(20)
    assert port.GetAmplitude((1 << n) - 1) == pytest.approx(
        ref.GetAmplitude((1 << n) - 1), abs=1e-12)


def cpu_factories():
    def port_f(n, **kw):
        return QEngineCPU(n, **{**kw, "rand_global_phase": False})

    def ref_f(n, **kw):
        return JaxCPU(n, **{**kw, "rand_global_phase": False})

    return port_f, ref_f


def switch_index(q, stream):
    for i, (name, args) in enumerate(stream):
        getattr(q, name)(*args)
        if not q.isBinaryDecisionTree():
            return i
    return None


@pytest.mark.parametrize("seed", [1, 2])
def test_hybrid_switch_point_matches_jax(seed):
    n = 6
    port_f, ref_f = cpu_factories()
    port = QBdtHybrid(n, engine_factory=port_f, ratio_threshold=0.2,
                      rng=QrackRandom(seed), rand_global_phase=False,
                      device="cpu")
    ref = JaxQBdtHybrid(n, engine_factory=ref_f, ratio_threshold=0.2,
                        rng=JaxRandom(seed), rand_global_phase=False)
    stream = universal_stream(seed + 20, n, 80)
    a, b = switch_index(port, stream), switch_index(ref, stream)
    assert a == b and a is not None
    rest = stream[a + 1:]
    run((port, ref), rest)
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-12, rtol=0)
    assert [port.M(q) for q in range(n)] == [ref.M(q) for q in range(n)]


def test_hybrid_adaptive_attach_matches_jax():
    """Bottom-half entanglement: both packages escalate tree -> attached
    form, not to the engine (tests/test_qbdt.py's case)."""
    n = 8
    port_f, ref_f = cpu_factories()
    port = QBdtHybrid(n, engine_factory=port_f, ratio_threshold=0.02,
                      rng=QrackRandom(106), rand_global_phase=False,
                      device="cpu")
    ref = JaxQBdtHybrid(n, engine_factory=ref_f, ratio_threshold=0.02,
                        rng=JaxRandom(106), rand_global_phase=False)
    for eng in (port, ref):
        for i in range(n // 2, n):
            eng.H(i)
        eng.CZ(4, 5); eng.CNOT(5, 6); eng.T(6); eng.CZ(6, 7)
        eng.RY(0.8, 7); eng.CNOT(4, 7); eng.RZ(0.3, 5); eng.CNOT(6, 4)
        eng.U(5, 0.2, 0.4, 0.6); eng.CZ(7, 5)
    assert port.isBinaryDecisionTree() and ref.isBinaryDecisionTree()
    assert port.bdt.attached_qubits == ref.bdt.attached_qubits > 0
    assert_twins(port.bdt, ref.bdt)


def test_hybrid_default_engine_is_the_port_qhybrid():
    """Through the factory, a switched register lands on QHybrid's CUDA
    half (here on the CPU device, threshold 3), as the JAX stack lands
    on its dense engine; the kets agree to float32."""
    n = 5
    port = qt.create_quantum_interface(["bdt_hybrid", "hybrid"], n,
                                       rng=QrackRandom(4), device="cpu",
                                       tpu_threshold_qubits=3,
                                       rand_global_phase=False)
    ref = jax_create(["bdt_hybrid", "cpu"], n, rng=JaxRandom(4),
                     rand_global_phase=False)
    stream = universal_stream(24, n, 120)
    assert switch_index(port, stream) == switch_index(ref, stream)
    assert not port.isBinaryDecisionTree()
    assert isinstance(port.engine._engine, QEngineCUDA)
    assert port.engine._engine.device.type == "cpu"
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("start", [0, 2, 4])
def test_mid_insertion_compose_matches_jax(start):
    n, m = 4, 2
    port, ref = pair(n, 101)
    po, ro = pair(m, 102)
    for eng in (port, ref):
        eng.H(0); eng.CNOT(0, 1); eng.T(2); eng.RY(0.4, 3)
    for eng in (po, ro):
        eng.H(0); eng.CNOT(0, 1); eng.T(1)
    port.Compose(po, start)
    ref.Compose(ro, start)
    assert_twins(port, ref)


def test_decompose_dispose_match_jax():
    n, start, length = 9, 3, 3
    port, ref = pair(n, 41)
    for eng in (port, ref):
        eng.H(0); eng.CNOT(0, 1); eng.T(1)
        eng.H(start); eng.CNOT(start, start + 1)
        eng.RY(0.4, start + 2)
        eng.H(6); eng.CNOT(6, 7); eng.CNOT(7, 8)
    pd, rd = pair(length, 42)
    port.Decompose(start, pd)
    ref.Decompose(start, rd)
    assert_twins(port, ref)
    assert_twins(pd, rd)
    port.Dispose(3, 3)
    ref.Dispose(3, 3)
    assert_twins(port, ref)
    port, ref = pair(6, 61)
    for eng in (port, ref):
        eng.SetPermutation(0b101 << 2)
        eng.H(0); eng.CNOT(0, 1); eng.T(0)
        eng.RY(0.9, 5)
        eng.Dispose(2, 3, 0b101)
    assert_twins(port, ref)
    with pytest.raises(RuntimeError):
        pair(4, 62)[0].Dispose(1, 2, 0b11)


def test_leaf_region_and_dense_fallback_match_jax():
    n, att = 7, 3
    tq = n - att
    port, ref = pair(n, 81, attached_qubits=att)
    for eng in (port, ref):
        eng.H(0); eng.CNOT(0, 1); eng.T(2)
        eng.H(tq); eng.CNOT(tq, tq + 1); eng.RY(0.5, tq + 2)
    pd, rd = pair(att, 82)
    port.Decompose(tq, pd)
    ref.Decompose(tq, rd)
    assert port.attached_qubits == ref.attached_qubits == 0
    assert_twins(port, ref)
    assert_twins(pd, rd)
    # an entangled cut: the dense fallback draws from the stream as the
    # JAX package does
    port, ref = pair(6, 71)
    for eng in (port, ref):
        eng.H(0)
        for i in range(5):
            eng.CNOT(i, i + 1)
    assert port.M(2) == ref.M(2)
    for eng in (port, ref):
        eng.H(3); eng.CNOT(3, 4)
        eng.Dispose(0, 2)
        eng.Allocate(1, 2)
    assert_twins(port, ref)
    assert [port.M(q) for q in range(6)] == [ref.M(q) for q in range(6)]


def test_to_engine_builds_the_cuda_engine_on_the_tree_device():
    n = 6
    port, ref = pair(n, 13, attached_qubits=2)
    run((port, ref), universal_stream(14, n, 25))
    eng = port.ToEngine()
    assert isinstance(eng, QEngineCUDA) and eng.device.type == "cpu"
    np.testing.assert_allclose(eng.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6, rtol=0)
    back = QBdt.FromEngine(eng, attached_qubits=2, rng=QrackRandom(15),
                           rand_global_phase=False, device="cpu")
    np.testing.assert_allclose(back.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("device_leaves", [False, True])
def test_carry_tree_across(device_leaves, monkeypatch):
    """A JAX QBdt's checkpoint capture becomes the port's tree with the
    same node count, the same sharing (every distinct node once) and the
    same amplitudes; further gates then act alike."""
    if device_leaves:
        monkeypatch.setenv("QRACK_QBDT_LEAF_DEVICE_QB", "1")
    n = 7
    ref = JaxQBdt(n, attached_qubits=3, rng=JaxRandom(5),
                  rand_global_phase=False)
    run((ref,), universal_stream(5, n, 30))
    for q in (0, 1, 2):   # shared subtrees
        ref.H(q)
    snap = ref._ckpt_capture(None)
    port = bdt_from_numpy(snap["meta"], snap["arrays"], device="cpu",
                          rng=QrackRandom(5), rand_global_phase=False)
    assert port.node_count() == ref.node_count() == \
        snap["arrays"]["node_w"].shape[0]
    assert len(leaves(port)) == len(leaves(ref)) > 1
    assert all(lf.on_device == device_leaves for lf in leaves(port))
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-7 if device_leaves else 1e-15, rtol=0)
    stream = universal_stream(6, n, 20)
    run((port, ref), stream)
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6 if device_leaves else 1e-12, rtol=0)


def test_leaf_sum_memo_outlives_a_freed_device_leaf():
    """Device leaves are in no table, so a sum's memo keyed by a leaf's
    id must keep that leaf alive: a new leaf could otherwise take a
    freed one's id and read the freed leaf's sum.  Each leaf here is
    dropped before the next is made, as in a gate's walk."""
    q = QBdt(3, attached_qubits=2, device="cpu", rng=QrackRandom(1))
    rng = np.random.default_rng(11)
    b = _EngLeaf(planes=torch.tensor(rng.normal(size=(2, 4)),
                                     dtype=torch.float32))
    memo = {}
    for _ in range(8):
        a = _EngLeaf(planes=torch.tensor(rng.normal(size=(2, 4)),
                                         dtype=torch.float32))
        want = a.vec + 0.5 * b.vec
        _, out = q._add(a, 1.0 + 0j, b, 0.5 + 0j, memo)
        np.testing.assert_allclose(out.vec, want, atol=1e-6, rtol=0)
        del a, out


def test_factory_bdt_terminals(monkeypatch):
    q = qt.create_quantum_interface("bdt", 5, device="cpu",
                                    rng=QrackRandom(96))
    assert isinstance(q, QBdt) and q.attached_qubits == 0
    q = qt.create_quantum_interface("bdt_attached", 6, device="cpu",
                                    rng=QrackRandom(96))
    assert q.attached_qubits == 3
    monkeypatch.setenv("QRACK_QBDT_ATTACH_QB", "2")
    assert qt.create_quantum_interface("bdt_attached", 6, device="cpu"
                                       ).attached_qubits == 2
    assert qt.create_quantum_interface("bdt_attached", 6, device="cpu",
                                       attached_qubits=4).attached_qubits == 4


def test_tree_needs_a_device_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QBdt(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.create_quantum_interface(["bdt_hybrid", "cpu"], 4)
    assert QBdt(4, device="cpu").device.type == "cpu"
