"""Trajectory jobs through the port's serving plane against the JAX
package's: the counterparts of the 5 tests of tests/test_noise_serve.py
(submit_trajectories parity, route-aware chunking, structural
non-batchability, the dense-cap misroute guard, and the journal's
bit-identical recovery).  Each side's served result equals its own
direct run bit for bit; the port's equals the JAX package's at the bars
of tests/test_torch_noise.py (samples equal, p1 within 1e-5, weights
within 1e-5 relative).  The port's sessions run with ``device="cpu"``.
"""

import json

import numpy as np
import pytest

from qrack_tpu.layers.qcircuit import QCircuit as JCircuit
from qrack_tpu.noise import NoiseModel as JModel
from qrack_tpu.noise import amplitude_damping as j_ad
from qrack_tpu.noise import depolarizing as j_dep
from qrack_tpu.noise.trajectories import run_trajectories as j_run
from qrack_tpu.route.router import MisrouteError as JMisroute
from qrack_tpu.serve.scheduler import Job as JJob
from qrack_tpu.serve.service import TRAJ_TAG as J_TAG

from qrack_tpu_torch.layers.qcircuit import QCircuit as TCircuit
from qrack_tpu_torch.noise import NoiseModel as TModel
from qrack_tpu_torch.noise import amplitude_damping as t_ad
from qrack_tpu_torch.noise import depolarizing as t_dep
from qrack_tpu_torch.noise.trajectories import run_trajectories as t_run
from qrack_tpu_torch.route.router import MisrouteError as TMisroute
from qrack_tpu_torch.serve.scheduler import Job as TJob
from qrack_tpu_torch.serve.service import TRAJ_TAG as T_TAG

from test_torch_serve import (JAX, _clean_serve,  # noqa: F401
                              both, svc)

W = 5  # session width — every trajectory ket is (2, 2^W)

_H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=complex)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("QRACK_NOISE_TRAJ_WINDOW", "QRACK_NOISE_TRAJ_CHUNK",
              "QRACK_ROUTE_HBM_BYTES", "QRACK_ROUTE_DENSE_MAX_QB"):
        monkeypatch.delenv(k, raising=False)


def _circ(side):
    c = (JCircuit if side is JAX else TCircuit)(W)
    c.append_1q(0, _H)
    c.append_ctrl((0,), 1, _X, 1)
    c.append_1q(2, _H)
    return c


def _model(side):
    if side is JAX:
        return JModel(default=j_dep(0.1), per_qubit={1: [j_ad(0.2)]})
    return TModel(default=t_dep(0.1), per_qubit={1: [t_ad(0.2)]})


def _direct(side, B, key):
    if side is JAX:
        return j_run(_circ(side), _model(side), B, width=W, key=key)
    return t_run(_circ(side), _model(side), B, width=W, key=key,
                 device="cpu")


def _same(a, b) -> None:
    assert np.array_equal(a.samples, b.samples)
    np.testing.assert_allclose(a.p1, b.p1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.weights, b.weights, rtol=1e-5, atol=1e-6)


def test_submit_trajectories_matches_direct():
    def run(side):
        direct = _direct(side, 6, 7)
        with svc(side, "dense") as s:
            sid = s.create_session(W)
            got = s.submit_trajectories(sid, _circ(side), _model(side), 6,
                                        key=7).result(timeout=60)
        assert np.array_equal(got.samples, direct.samples)
        assert np.array_equal(got.p1, direct.p1)
        assert np.array_equal(got.weights, direct.weights)
        return got

    j, p = both(run)
    _same(j, p)


def test_trajectory_jobs_are_not_batchable():
    for Job in (JJob, TJob):
        tj = Job(None, "trajectories", fn=lambda eng: None)
        assert not tj.batchable
        cj = Job(None, "circuit", circuit=object(), shape_key=("w", W))
        assert cj.batchable


def test_routed_hbm_chunking_parity(monkeypatch):
    """A batch priced over the budget is chunked down to fit and lands
    bit for bit.  The JAX test's 1024 bytes admit 2 trajectories of
    16 B/amp · 32 amps there and 1 of the port's measured 17 B/amp
    (noise/trajectories.py BYTES_PER_AMP); 1100 bytes admit 2 on both."""
    def run(side):
        whole = _direct(side, 6, 13)
        monkeypatch.setenv("QRACK_ROUTE_HBM_BYTES", "1100")
        side.tele.enable()
        try:
            with svc(side, "dense") as s:
                sid = s.create_session(W)
                got = s.submit_trajectories(sid, _circ(side), _model(side),
                                            6, key=13).result(timeout=60)
        finally:
            monkeypatch.delenv("QRACK_ROUTE_HBM_BYTES")
        assert np.array_equal(got.samples, whole.samples)
        assert np.allclose(got.p1, whole.p1, atol=1e-6)
        snap = side.tele.snapshot(include_events=False)
        return got, got.chunks, (
            snap["counters"].get("route.traj.chunked", 0) >= 1,
            snap["counters"].get("noise.traj.chunked", 0) >= 1,
            snap["gauges"].get("route.traj.chunk"))

    (j, jc, jt), (p, pc, pt) = both(run)
    assert jc == pc == 3
    assert jt == pt == (True, True, 2)
    _same(j, p)


def test_trajectory_misroute_past_dense_cap(monkeypatch):
    monkeypatch.setenv("QRACK_ROUTE_DENSE_MAX_QB", str(W - 1))

    def run(side):
        with svc(side, "dense") as s:
            sid = s.create_session(W)
            with pytest.raises(JMisroute if side is JAX else TMisroute) \
                    as ei:
                s.submit_trajectories(sid, _circ(side), _model(side), 4)
        return str(ei.value)

    j, p = both(run)
    assert j == p


def test_trajectory_wal_recovery_bit_identical(tmp_path):
    def run(side):
        ck = str(tmp_path / side.name / "ck")
        tag = J_TAG if side is JAX else T_TAG
        spec = json.dumps({"B": 4, "key": 7,
                           "model": _model(side).to_dict(), "tag": None},
                          sort_keys=True)
        a = svc(side, "dense", checkpoint_dir=ck)
        try:
            sid = a.create_session(W)
            a.store.wal_append(sid, _circ(side), tag=tag + spec)
            assert a.drain() == {"drained": [sid], "busy": []}
        finally:
            a.close()
        with svc(side, "dense", checkpoint_dir=ck) as b:
            summary = b.recover()
        assert summary["sessions"] == [sid]
        assert summary["wal_replayed"] == 1
        got = summary["trajectories"][sid]
        assert len(got) == 1
        want = _direct(side, 4, 7)
        assert np.array_equal(got[0].samples, want.samples)
        assert np.array_equal(got[0].p1, want.p1)
        assert np.array_equal(got[0].weights, want.weights)
        return got[0], spec

    (j, js), (p, ps) = both(run)
    assert js == ps   # the journal's spec crosses packages
    _same(j, p)
