"""The port's QUnitMulti (qrack_tpu_torch/layers/qunitmulti.py) against the
JAX package's: the counterparts of tests/test_layers_and_factory.py:224
and :396-545 (placement, device accounting, best fit, the no-fit guard,
capability weights, unguarded rows and the environment's device table).

Both sides run QUnitMulti over host units (the complex128 oracle, or the
oracle with a SetDevice recorder standing in for a movable engine) with
the same seeds and rand_global_phase=False.  Bars: kets within 1e-8
(fidelity), placements and byte accounting equal, row for row.  A row
may name a device twice ([0, 0]): each row keeps its own accounting.
"""

import warnings

import numpy as np
import pytest

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu.layers.qunitmulti import DeviceInfo as JaxInfo
from qrack_tpu.layers.qunitmulti import QUnitMulti as JaxMulti
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.engines.cpu import QEngineCPU
from qrack_tpu_torch.layers import qunitmulti as qm
from qrack_tpu_torch.layers.qunitmulti import DeviceInfo, QUnitMulti
from qrack_tpu_torch.utils.rng import QrackRandom


def fid(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)


class _Recorder(QEngineCPU):
    """The port's oracle plus a SetDevice recorder (a movable engine's
    stand-in on the CPU)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.device_id = None

    def SetDevice(self, device_id):
        self.device_id = device_id


class _JaxRecorder(JaxCPU):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.device_id = None

    def SetDevice(self, device_id):
        self.device_id = device_id


def _factories():
    def port(n, **kw):
        kw.setdefault("rand_global_phase", False)
        return _Recorder(n, **kw)

    def ref(n, **kw):
        kw.setdefault("rand_global_phase", False)
        return _JaxRecorder(n, **kw)

    return port, ref


def make_pair(n, seed, table=None, **kw):
    pf, rf = _factories()
    port = QUnitMulti(n, unit_factory=pf, rng=QrackRandom(seed),
                      rand_global_phase=False,
                      device_table=None if table is None
                      else [DeviceInfo(**t) for t in table], **kw)
    ref = JaxMulti(n, unit_factory=rf, rng=JaxRandom(seed),
                   rand_global_phase=False,
                   device_table=None if table is None
                   else [JaxInfo(**t) for t in table], **kw)
    return port, ref


def units(q):
    return list({id(s.unit): s.unit for s in q.shards
                 if s.unit is not None}.values())


def placement(q):
    return sorted((u.qubit_count, u.device_id) for u in units(q))


def accounting(q):
    return [(d.device_id, d.used_bytes) for d in q.devices]


@pytest.mark.parametrize("ids", ([0, 1], [0, 0]))
def test_qunit_multi_placement(ids):
    port, ref = make_pair(6, 13, device_ids=ids)
    o = JaxCPU(6, rng=JaxRandom(13), rand_global_phase=False)
    for q in (port, ref, o):
        q.H(0)
        q.CNOT(0, 1)
        q.H(3)
        q.CNOT(3, 4)
    assert port.GetDeviceList() == ref.GetDeviceList() == ids
    assert fid(port.GetQuantumState(), o.GetQuantumState()) == pytest.approx(
        1.0, abs=1e-8)
    assert fid(port.GetQuantumState(), ref.GetQuantumState()) == pytest.approx(
        1.0, abs=1e-8)


@pytest.mark.parametrize("ids", ((0, 1), (0, 0)))
def test_qunitmulti_packs_large_units_apart(ids):
    """Two large subsystems land on different rows when one row cannot
    hold both, also when both rows name one card."""
    table = [dict(device_id=i, capacity_bytes=128) for i in ids]
    port, ref = make_pair(6, 5, table=table)
    for q in (port, ref):
        q.H(0)
        q.CNOT(0, 1)
        q.CNOT(1, 2)
        q.H(3)
        q.CNOT(3, 4)
        q.CNOT(4, 5)
    assert len(units(port)) == 2
    assert placement(port) == placement(ref)
    assert sorted(u.device_id for u in units(port)) == sorted(ids)
    assert accounting(port) == accounting(ref)
    assert sorted(b for _, b in accounting(port)) == [128, 128]


def test_qunitmulti_over_allocation_rejected():
    """A subsystem no row can hold trips the alloc guard: with the
    fidelity guard on, QUnit fails fast; with ACE on, it elides."""
    table = [dict(device_id=0, capacity_bytes=128),
             dict(device_id=1, capacity_bytes=128)]

    def build():
        port, ref = make_pair(6, 6, table=table)
        for q in (port, ref):
            q.H(0)
            q.CNOT(0, 1)
            q.CNOT(1, 2)
        return port, ref

    port, ref = build()
    for q in (port, ref):
        with pytest.raises(RuntimeError, match="ACE"):
            q.CNOT(2, 3)
    port, ref = build()
    for q in (port, ref):
        q.is_ace = True
        q.CNOT(2, 3)
    assert port.GetUnitaryFidelity() < 1.0
    assert port.GetUnitaryFidelity() == pytest.approx(
        ref.GetUnitaryFidelity(), abs=1e-9)
    with pytest.raises(MemoryError, match="no device can hold"):
        port._best_device(1 << 20)


def test_qunitmulti_weighted_preference():
    """The heavier row takes the bigger subsystem when both fit."""
    table = [dict(device_id=0, capacity_bytes=1 << 20, weight=1.0),
             dict(device_id=1, capacity_bytes=1 << 20, weight=4.0)]
    port, ref = make_pair(5, 7, table=table)
    for q in (port, ref):
        q.FSim(0.3, 0.2, 0, 1)
        q.FSim(0.3, 0.2, 1, 2)    # a 3-qubit clump
        q.FSim(0.3, 0.2, 3, 4)    # a 2-qubit clump
    sizes = {u.qubit_count: u.device_id for u in units(port)}
    assert sizes[3] == 1 and sizes[2] == 0
    assert placement(port) == placement(ref)
    assert accounting(port) == accounting(ref)


@pytest.mark.parametrize("ids", ((0, 1), (0, 0)))
def test_qunitmulti_unguarded_spread_and_warning(ids, monkeypatch):
    """Unguarded rows (capacity 0) warn and still spread fresh units by
    accounted bytes, one row each."""
    for var in ("QRACK_QUNITMULTI_MAX_QB", "QRACK_MAX_ALLOC_MB"):
        monkeypatch.delenv(var, raising=False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        table = QUnitMulti._build_device_table(list(ids))
    if not qm._cuda_ids():
        assert any("allocation guard is DISABLED" in str(r.message)
                   for r in rec)
        assert [d.capacity_bytes for d in table] == [0, 0]
    port, ref = make_pair(4, 8, table=[dict(device_id=i, capacity_bytes=0)
                                       for i in ids])
    for q in (port, ref):
        q.FSim(0.3, 0.2, 0, 1)
        q.FSim(0.3, 0.2, 2, 3)    # the second unit takes the other row
    assert sorted(u.device_id for u in units(port)) == sorted(ids)
    assert accounting(port) == accounting(ref)
    assert all(b > 0 for _, b in accounting(port))


def test_qunitmulti_measured_weights():
    """MeasureDeviceWeights times each row's card with CUDA events; rows
    that name no card (here, without a GPU) keep their weights."""
    port, _ = make_pair(3, 9, table=[dict(device_id=0,
                                          capacity_bytes=1 << 20)])
    port.MeasureDeviceWeights(size=128, reps=2)
    assert port.devices[0].weight == 1.0


def test_qunitmulti_weights_env_forms(monkeypatch):
    for wenv in ("1.0,4.0", "0=1.0,3=4.0", ""):
        assert QUnitMulti._parse_weights(wenv) == JaxMulti._parse_weights(wenv)
    with pytest.raises(ValueError, match="mixes positional"):
        QUnitMulti._parse_weights("1.0,3=4.0")
    monkeypatch.setenv("QRACK_QUNITMULTI_DEVICES", "")
    monkeypatch.setenv("QRACK_QUNITMULTI_MAX_QB", "20")
    for wenv, want in (("2=8.0,0=2.0", [8.0, 2.0, 1.0]),
                       ("8.0,2.0", [8.0, 2.0, 1.0])):
        monkeypatch.setenv("QRACK_QUNITMULTI_WEIGHTS", wenv)
        table = QUnitMulti._build_device_table([2, 0, 1])
        assert [d.weight for d in table] == want
        assert [(d.device_id, d.weight) for d in table] == [
            (d.device_id, d.weight)
            for d in JaxMulti._build_device_table([2, 0, 1])]
    if not qm._cuda_ids():
        # the budget from QRACK_QUNITMULTI_MAX_QB: float32 planes of 2^20
        assert {d.capacity_bytes for d in table} == {2 * (1 << 20) * 4}


def test_qunitmulti_env_device_list(monkeypatch):
    monkeypatch.setenv("QRACK_QUNITMULTI_DEVICES", "0,0,1")
    monkeypatch.setenv("QRACK_QUNITMULTI_MAX_QB", "12")
    table = QUnitMulti._build_device_table(None)
    assert [d.device_id for d in table] == [0, 0, 1]
    port, _ = make_pair(3, 3)
    port.SetDeviceList([0, 0])
    assert port.GetDeviceList() == port.device_ids == [0, 0]
    assert len(port.devices) == 2


def test_optimal_multi_matches_jax_on_the_cpu():
    """The factory's OPTIMAL_MULTI stack over a [0, 0] device list on the
    CPU: two separable registers run like the JAX stack's."""
    n = 8
    port = qt.create_quantum_interface("optimal_multi", n, device="cpu",
                                       device_ids=[0, 0],
                                       rng=QrackRandom(4),
                                       rand_global_phase=False)
    ref = __import__("qrack_tpu").create_quantum_interface(
        "optimal_multi", n, device_ids=[0, 0], rng=JaxRandom(4),
        rand_global_phase=False)
    for q in (port, ref):
        for half in (0, 4):
            q.H(half)
            q.CNOT(half, half + 1)
            q.T(half + 1)
            q.RY(0.4, half + 2)
            q.CNOT(half + 1, half + 2)
            q.CCNOT(half, half + 2, half + 3)
    assert fid(port.GetQuantumState(), ref.GetQuantumState()) > 1 - 1e-8
    for q_ in range(n):
        assert port.Prob(q_) == pytest.approx(ref.Prob(q_), abs=1e-6)
    assert accounting(port) == accounting(ref)
