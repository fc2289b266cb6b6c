"""The port's layer composition against the JAX package's factory, after
the composable cases of tests/test_layers_and_factory.py: ``"optimal"``,
explicit layer lists and ``create_arranged_layers_full`` toggles build
the same stacks, run the same circuits to the same kets (1e-10 over
complex128 terminals, 1e-6 where the port's float32 CUDA engine takes
part) and draw the same measurements; unported layers raise with their
ROADMAP item; ``device="cpu"`` reaches every engine a stack builds.
"""

import numpy as np
import pytest
import torch

from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu.factory import create_arranged_layers_full as jax_arranged
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.engines.cpu import QEngineCPU
from qrack_tpu_torch.engines.cuda import QEngineCUDA
from qrack_tpu_torch.engines.hybrid import QHybrid
from qrack_tpu_torch.factory import OPTIMAL
from qrack_tpu_torch.utils.rng import QrackRandom

from test_torch_qunit import universal_stream, run

# port layers -> (JAX layers, port kwargs, bar)
STACKS = {
    "optimal": ("optimal", ["unit", "stabilizer_hybrid", "cpu"],
                {"device": "cpu", "tpu_threshold_qubits": 3}, 1e-6),
    "unit_sh_cpu": (["unit", "stabilizer_hybrid", "cpu"],
                    ["unit", "stabilizer_hybrid", "cpu"], {}, 1e-10),
    "unit_cpu": (["unit", "cpu"], ["unit", "cpu"], {}, 1e-10),
    "sh_cpu": (["stabilizer_hybrid", "cpu"], ["stabilizer_hybrid", "cpu"],
               {}, 1e-10),
    "unit_cuda": (["unit", "cuda"], ["unit", "cpu"], {"device": "cpu"}, 1e-6),
    "sh_hybrid": (["stabilizer_hybrid", "hybrid"], ["stabilizer_hybrid", "cpu"],
                  {"device": "cpu", "tpu_threshold_qubits": 2}, 1e-6),
}


def teleport(q, seed):
    q.U(0, 0.8, 0.3, -0.5)
    want = q.Prob(0)
    q.H(1)
    q.CNOT(1, 2)
    q.CNOT(0, 1)
    q.H(0)
    m0, m1 = q.M(0), q.M(1)
    if m1:
        q.X(2)
    if m0:
        q.Z(2)
    return want, q.Prob(2), (m0, m1)


@pytest.mark.parametrize("name", sorted(STACKS))
@pytest.mark.parametrize("seed", [1, 2])
def test_stacks_match_jax(name, seed):
    layers, jax_layers, kw, bar = STACKS[name]
    n = 6
    port = qt.create_quantum_interface(layers, n, rng=QrackRandom(seed),
                                       rand_global_phase=False, **kw)
    ref = jax_create(jax_layers, n, rng=JaxRandom(seed),
                     rand_global_phase=False)
    assert type(port).__name__ == type(ref).__name__
    run((port, ref), universal_stream(seed, n, 30))
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=bar, rtol=0)
    assert [port.M(q) for q in range(n)] == [ref.M(q) for q in range(n)]


@pytest.mark.parametrize("name", sorted(STACKS))
def test_stacks_teleport_like_jax(name):
    layers, jax_layers, kw, bar = STACKS[name]
    for t in range(3):
        port = qt.create_quantum_interface(layers, 3, rng=QrackRandom(40 + t),
                                           rand_global_phase=False, **kw)
        ref = jax_create(jax_layers, 3, rng=JaxRandom(40 + t),
                         rand_global_phase=False)
        a, b = teleport(port, t), teleport(ref, t)
        assert abs(a[0] - a[1]) < 1e-6
        assert a[2] == b[2]


def test_optimal_is_unit_over_stabilizer_hybrid_over_hybrid():
    assert OPTIMAL == ("unit", "stabilizer_hybrid", "hybrid")
    q = qt.create_quantum_interface("optimal", 5, device="cpu",
                                    rng=QrackRandom(3), rand_global_phase=False)
    assert isinstance(q, qt.QUnit)
    q.H(0)
    q.RY(0.2, 0)
    q.CNOT(0, 1)
    q.Prob(1)
    unit = q.shards[0].unit
    assert isinstance(unit, qt.QStabilizerHybrid)
    assert isinstance(unit.engine, QHybrid)


@pytest.mark.parametrize("toggles", [
    {},
    {"sh": False},
    {"sd": False},
    {"sd": False, "sh": False},
    {"hy": False, "pg": False},
    {"hy": False, "pg": False, "oc": False},
    {"sd": False, "hy": False, "pg": False, "oc": False},
    {"nw": True},
    {"tn": True},
    {"bdt": True},
    {"nw": True, "tn": True, "bdt": True},
    {"bdt": True, "sd": False, "sh": False},
])
def test_arranged_layers_full_matches_jax(toggles):
    n = 4
    kw = {} if toggles.get("oc", True) is False else {"device": "cpu"}
    port = qt.create_arranged_layers_full(qubit_count=n, rng=QrackRandom(7),
                                          rand_global_phase=False,
                                          **toggles, **kw)
    jax_toggles = dict(toggles)
    if not toggles.get("hy", True) and toggles.get("oc", True):
        jax_toggles["oc"] = False  # compare a bare "cuda" with the oracle
    ref = jax_arranged(qubit_count=n, rng=JaxRandom(7), rand_global_phase=False,
                       **jax_toggles)
    expect = {"QEngineTPU": "QEngineCPU"}.get(type(ref).__name__,
                                             type(ref).__name__)
    got = type(port).__name__
    if got == "QEngineCUDA":
        assert expect == "QEngineCPU" and toggles.get("oc", True)
    else:
        assert got == expect
    run((port, ref), universal_stream(8, n, 20))
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("layers", [
    "tpu", ["unit", "tpu"], ["stabilizer_hybrid", "tpu"],
    ["tensor_network", "unit", "tpu"],
])
def test_unported_layers_raise_with_their_roadmap_item(layers):
    """The JAX package's "tpu" terminal, anywhere in a stack, is refused
    naming the port's "cuda" ("route" and "lightcone" are ported since
    ROADMAP item 16a)."""
    with pytest.raises(ValueError, match="not ported yet.*'cuda'"):
        qt.create_quantum_interface(layers, 3, device="cpu")


@pytest.mark.parametrize("layers,kind", [
    (["unit_multi", "stabilizer_hybrid", "hybrid"], "QUnitMulti"),
    ("optimal_multi", "QUnitMulti"),
    (["unit_multi", "cpu"], "QUnitMulti"),
    ("turboquant_pager", "QPagerTurboQuant"),
])
def test_pager_slice_layers_build_like_jax(layers, kind):
    """The layers of the pager slice build the JAX package's classes and
    run a Bell pair to its probabilities (the TurboQuant pager over 2
    pages, its codes at 16 bits)."""
    kw = ({"n_pages": 2, "bits": 16, "block_pow": 1}
          if layers == "turboquant_pager" else {"device_ids": [0, 0]})
    port = qt.create_quantum_interface(layers, 3, rng=QrackRandom(5),
                                       rand_global_phase=False, device="cpu",
                                       **kw)
    ref = jax_create(layers, 3, rng=JaxRandom(5), rand_global_phase=False,
                     **kw)
    assert type(port).__name__ == type(ref).__name__ == kind
    for q in (port, ref):
        q.H(0)
        q.CNOT(0, 1)
        q.CNOT(1, 2)
    for k in range(3):
        assert port.Prob(k) == pytest.approx(ref.Prob(k), abs=1e-4)


def test_arranged_multi_device_builds_qunitmulti():
    port = qt.create_arranged_layers_full(md=True, qubit_count=3,
                                          device="cpu", device_ids=[0])
    ref = jax_arranged(md=True, qubit_count=3, device_ids=[0])
    assert type(port).__name__ == type(ref).__name__ == "QUnitMulti"


@pytest.mark.parametrize("layers", ["lightcone", "route"])
def test_lightcone_and_route_name_item_16(layers):
    """The terminals of ROADMAP item 16a build the JAX package's classes,
    lazily: no stack until the first read or circuit; a Bell pair then
    reads as the JAX stack's."""
    port = qt.create_quantum_interface(layers, 3, rng=QrackRandom(5),
                                       rand_global_phase=False, device="cpu")
    ref = jax_create(layers, 3, rng=JaxRandom(5), rand_global_phase=False)
    assert type(port).__name__ == type(ref).__name__
    assert type(port).__name__ in ("QRouted", "QLightCone")
    assert (port.current_stack() is None if layers == "route"
            else port.sim is None and not port._cones)
    for q in (port, ref):
        q.H(0)
        q.CNOT(0, 1)
    for k in range(3):
        assert port.Prob(k) == pytest.approx(ref.Prob(k), abs=1e-6)


@pytest.mark.parametrize("layers,kind", [
    (["tensor_network", "unit", "cpu"], "QTensorNetwork"),
    (["unit", "bdt_hybrid", "cpu"], "QUnit"),
    (["noisy", "cpu"], "QInterfaceNoisy"),
    ("noisy", "QNoisy"),
    ("bdt", "QBdt"),
    ("bdt_attached", "QBdt"),
    (["bdt_hybrid", "hybrid"], "QBdtHybrid"),
])
def test_layers_of_this_slice_build_like_jax(layers, kind):
    """The layers that once raised here build the JAX package's classes
    and run a Bell pair to its probabilities."""
    # a "cpu" terminal under a layer leaves the device to the layers
    port = qt.create_quantum_interface(layers, 3, rng=QrackRandom(5),
                                       rand_global_phase=False, device="cpu")
    ref = jax_create(layers, 3, rng=JaxRandom(5), rand_global_phase=False)
    assert type(port).__name__ == type(ref).__name__ == kind
    for q in (port, ref):
        q.H(0)
        q.CNOT(0, 1)
    assert port.Prob(1) == pytest.approx(ref.Prob(1), abs=1e-6)


def test_unknown_and_misplaced_layers_raise():
    with pytest.raises(ValueError, match="unknown layer"):
        qt.create_quantum_interface(["spam", "cpu"], 3)
    with pytest.raises(ValueError, match="must be last"):
        qt.create_quantum_interface(["cpu", "unit"], 3)


def _cuda_engines(q):
    """Every QEngineCUDA reachable from a stack."""
    seen, out, todo = set(), [], [q]
    while todo:
        o = todo.pop()
        if o is None or id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, QEngineCUDA):
            out.append(o)
            continue
        if isinstance(o, QHybrid):
            todo.append(o._engine)
        for attr in ("engine", "stab"):
            todo.append(getattr(o, attr, None))
        for s in getattr(o, "shards", None) or []:
            todo.append(getattr(s, "unit", None))
    return out


def test_device_reaches_every_engine_of_the_stack(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        q = qt.create_quantum_interface("optimal", 6, rng=QrackRandom(1),
                                        tpu_threshold_qubits=2)
        for i in range(6):
            q.RY(0.3 + i, i)
        for i in range(5):
            q.CNOT(i, i + 1)
        q.Prob(5)
    q = qt.create_quantum_interface("optimal", 8, device="cpu",
                                    rng=QrackRandom(1), tpu_threshold_qubits=2)
    for i in range(8):
        q.RY(0.3 + i, i)
    for i in range(0, 7, 2):
        q.CNOT(i, i + 1)
    q.GetQuantumState()  # flushes the buffered CNOTs into 2-qubit units
    c = q.Clone()
    engines = _cuda_engines(q) + _cuda_engines(c)
    assert len(engines) == 2 * q.GetUnitCount() == 8
    assert all(e.device.type == "cpu" for e in engines)
    assert not isinstance(q, QEngineCPU)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_quantum_volume_through_optimal_matches_jax(seed):
    """quantum_volume_ops draws what quantum_volume draws: the JAX
    package's quantum_volume and the port's, each on an OPTIMAL-shaped
    stack, measure the same outcome; replayed gate by gate the kets
    agree before the measurement."""
    from qrack_tpu.models import algorithms as jax_al

    from qrack_tpu_torch.models import algorithms as al

    n, depth = 6, 4
    port, ref = (qt.create_quantum_interface(
        "optimal", n, rng=QrackRandom(seed), device="cpu",
        tpu_threshold_qubits=3, rand_global_phase=False),
        jax_create(["unit", "stabilizer_hybrid", "cpu"], n,
                   rng=JaxRandom(seed), rand_global_phase=False))
    assert al.quantum_volume(port, depth, QrackRandom(seed + 9)) == \
        jax_al.quantum_volume(ref, depth, JaxRandom(seed + 9))
    port, ref = (qt.create_quantum_interface(
        "optimal", n, rng=QrackRandom(seed), device="cpu",
        tpu_threshold_qubits=3, rand_global_phase=False),
        jax_create(["unit", "stabilizer_hybrid", "cpu"], n,
                   rng=JaxRandom(seed), rand_global_phase=False))
    for _layer, name, args in al.quantum_volume_ops(n, depth,
                                                    QrackRandom(seed + 9)):
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6, rtol=0)
    assert port.GetUnitCount() == ref.GetUnitCount()
