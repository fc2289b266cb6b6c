"""Real port fleets on the CPU, the elastic half: the counterparts of
tests/test_fleet.py's spawn-fault, scale-down, orphaned-session and
closed-loop autoscaler cases, and a session store written by a JAX
``QrackService`` that a port fleet's worker adopts.

Workers are ``python -m qrack_tpu_torch.fleet.worker`` processes over
one shared store, on the host terminal ``"cpu"`` or the dense terminal
``"cuda"`` with ``engine_kwargs='{"device": "cpu"}'``; kets are held to
an in-process JAX ``QEngineCPU`` oracle on the same seed (fidelity >
1 - 1e-12; the store that crosses packages bit for bit).  The cadence
is the JAX tests' (``_mini_fleet``), and every wait is bounded.
"""

import time

import numpy as np
import pytest

from qrack_tpu import QEngineCPU
from qrack_tpu import matrices as jmat
from qrack_tpu.checkpoint.store import CheckpointStore as JStore
from qrack_tpu.layers.qcircuit import QCircuit as JCircuit
from qrack_tpu.serve import QrackService as JService
from qrack_tpu.utils.rng import QrackRandom

from qrack_tpu_torch import matrices as tmat
from qrack_tpu_torch import telemetry as tele
from qrack_tpu_torch.checkpoint.store import CheckpointStore as TStore
from qrack_tpu_torch.fleet import (AdoptionStalled, AutoscaleConfig,
                                   FleetFrontDoor, NoHealthyWorkers)
from qrack_tpu_torch.layers.qcircuit import QCircuit as TCircuit
from qrack_tpu_torch.resilience import faults

from test_torch_fleet_workers import (FID, _fidelity, _mini_fleet,
                                      _wait_states, bell, jbell)


@pytest.fixture(autouse=True)
def _clean_fleet():
    faults.clear()
    yield
    faults.clear()
    tele.disable()
    tele.reset()


def test_spawn_faults_charge_budget_placement_unstuck(tmp_path):
    sup = _mini_fleet(tmp_path, n=1, restart_threshold=2,
                      ready_timeout_s=1.0)
    faults.inject("fleet.spawn", "hang", times=2)
    t0 = time.monotonic()
    assert sup.boot_worker("wx", timeout_s=1.0) is False
    h = sup._workers["wx"]
    assert h.crashes == 1 and h.next_restart_at > t0
    assert h.breaker.snapshot()["consecutive_failures"] == 1
    assert h.proc is not None and h.proc.poll() is not None
    assert sup.placement.state("wx") == "dead"
    assert sup.placement.place("s1", "cpu", 4) == "w0"
    sup._respawn(h)
    assert h.crashes == 2
    sup._maybe_restart(h)
    assert sup.placement.state("wx") == "quarantined"
    faults.clear()
    faults.inject("fleet.spawn", "raise")
    assert sup.boot_worker("wy", timeout_s=1.0) is False
    hy = sup._workers["wy"]
    assert hy.crashes == 1 and hy.proc is None
    assert sup.placement.place("s2", "cpu", 4) == "w0"


def test_boot_without_a_gpu_fails_the_boot(tmp_path):
    """A worker of dense sessions on the card finds no GPU here and no
    device="cpu": it raises at boot, and the supervisor counts the boot
    as failed (no silent CPU fallback)."""
    sup = _mini_fleet(tmp_path, n=1, layers="cpu", ready_timeout_s=60.0)
    sup.layers, sup.engine_kwargs = "cuda", "{}"
    assert sup.boot_worker("wg", timeout_s=60.0) is False
    h = sup._workers["wg"]
    assert h.crashes == 1 and h.proc.poll() not in (None, 0)
    with open(h.log_path) as f:
        assert "CUDA" in f.read()


@pytest.mark.parametrize("layers", ["cpu", "cuda"])
def test_scale_down_zero_loss_and_metrics_retention(layers, tmp_path):
    tele.enable()
    tele.reset()
    with _mini_fleet(tmp_path, n=2, layers=layers) as sup:
        sup.start()
        front = FleetFrontDoor(sup)
        sids, oracles = [], []
        for k in range(2):
            sids.append(front.create_session(2, seed=20 + k,
                                             rand_global_phase=False))
            oracles.append(QEngineCPU(2, rng=QrackRandom(20 + k),
                                      rand_global_phase=False))
        assert {sup.owner_of(s) for s in sids} == {"w0", "w1"}
        for sid, oracle in zip(sids, oracles):
            for _ in range(2):
                front.apply(sid, bell())
                jbell().Run(oracle)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            before = sup.metrics()["counters"].get("serve.jobs.completed", 0)
            if before >= 4:
                break
            time.sleep(0.05)
        assert before >= 4, sup.metrics()["counters"]
        victim = sup.worker_names()[0]
        vpid = sup.stats()["workers"][victim]["pid"]
        moved_sid = [s for s in sids if sup.owner_of(s) == victim][0]
        out = sup.scale_down()
        assert out is not None and out["migrated"] == {moved_sid: "w1"}
        assert sup.worker_names() == ["w1"]
        m = sup.metrics()
        assert m["counters"].get("serve.jobs.completed", 0) >= before
        assert f"{victim}:{vpid}" in m["workers"]
        # the retired incarnation's launches stay on record too
        assert f"{victim}:{vpid}" in sup.kernel_launches()
        k = sids.index(moved_sid)
        front.apply(moved_sid, bell())
        jbell().Run(oracles[k])
        assert _fidelity(oracles[k].GetQuantumState(),
                         front.get_state(moved_sid)) > FID
        assert sup.scale_down() is None
        assert sup.stats()["deaths"] == []
        for sid in sids:
            front.destroy_session(sid)
    # the fleet JSONL keeps the retired worker's metrics
    import json

    recs = [json.loads(x) for x in open(sup.telemetry_path)]
    assert any(f"{victim}:{vpid}" in r.get("workers", {}) for r in recs
               if r.get("kind") == "fleet")


def test_scale_down_orphan_hits_bounded_wait_typed_error(tmp_path,
                                                         monkeypatch):
    tele.enable()
    tele.reset()
    with _mini_fleet(tmp_path, n=2) as sup:
        sup.start()
        front = FleetFrontDoor(sup, route_timeout_s=60.0,
                               migrate_timeout_s=0.3)
        sid = front.create_session(2, seed=7, rand_global_phase=False)
        front.apply(sid, bell())
        owner = sup.owner_of(sid)

        def no_room(moved, exclude=None):
            raise NoHealthyWorkers("injected: nowhere to re-place")

        monkeypatch.setattr(sup.placement, "place_all", no_room)
        out = sup.scale_down(owner)
        assert out is not None and out["migrated"] == {}
        assert owner not in sup.worker_names()
        assert sup.owner_of(sid) is None
        assert sid in sup.stats()["migrating"]
        t0 = time.monotonic()
        with pytest.raises(AdoptionStalled):
            front.prob(sid, 0)
        assert time.monotonic() - t0 < 10.0
        assert tele.snapshot()["counters"].get(
            "fleet.frontdoor.not_adopted_yet", 0) >= 1
        # the state stays durable on the store
        assert sid in TStore(sup.store_dir).sessions()


def test_autoscaler_closed_loop_scale_up_then_down(tmp_path, monkeypatch):
    box = {"backlog": 0.0}
    with _mini_fleet(tmp_path, n=1, autoscale=AutoscaleConfig(
            n_min=1, n_max=2, up_ticks=2, down_ticks=3,
            cooldown_s=0.1, ladder_ticks=10_000,
            boot_timeout_s=120.0)) as sup:
        real_pressure = sup.pressure

        def fake_pressure():
            p = real_pressure()
            p["backlog"] = box["backlog"]
            p["queue_wait_p99_s"] = 0.0
            return p

        monkeypatch.setattr(sup, "pressure", fake_pressure)
        sup.start()
        assert sup.worker_names() == ["w0"]
        box["backlog"] = 50.0
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            if sup.worker_names() == ["w0", "w1"]:
                break
            time.sleep(0.1)
        assert sup.worker_names() == ["w0", "w1"], sup.stats()
        _wait_states(sup, {"healthy"}, timeout_s=60.0)
        box["backlog"] = 0.0
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            if len(sup.worker_names()) == 1:
                break
            time.sleep(0.1)
        assert len(sup.worker_names()) == 1, sup.stats()
        auto = sup.stats()["autoscale"]
        assert auto["n_peak"] == 2
        assert auto["decisions"].get("scale_up.backlog", 0) >= 1
        assert auto["decisions"].get("scale_down.idle", 0) >= 1


def _circuits(Circuit, mat, n=6):
    t_gate = np.diag([1.0, np.exp(1j * np.pi / 4)])
    c1 = Circuit(n)
    for q in range(n):
        c1.append_1q(q, mat.H2)
    for q in range(n - 1):
        c1.append_ctrl([q], q + 1, mat.X2, 1)
    c1.append_1q(2, t_gate)
    c2 = Circuit(n)
    for q in range(0, n, 2):
        c2.append_1q(q, mat.u3_mtrx(0.3 + q, 0.7, 1.1))
    c2.append_ctrl([n - 1], 0, mat.Z2, 1)
    c3 = Circuit(n)
    c3.append_ctrl([0], n - 1, mat.X2, 1)
    c3.append_1q(1, t_gate)
    return c1, c2, c3


def test_jax_store_adopted_by_port_fleet_worker(tmp_path, monkeypatch):
    """A session store written by a JAX QrackService (hold_lease=False,
    checkpoint_every_job=True), then abandoned with a journaled job,
    is adopted by a port fleet's worker through recover(sids=...): the
    kets equal the JAX oracle's bit for bit and the journaled job lands
    once."""
    monkeypatch.setenv("QRACK_SERVE_PREFIX", "0")
    store_dir = str(tmp_path / "store")
    n, sid, tag = 6, "fjax0001", "tag-c2"
    jc1, jc2, jc3 = _circuits(JCircuit, jmat, n)
    a = JService(engine_layers="cpu", checkpoint_dir=store_dir,
                 hold_lease=False, checkpoint_every_job=True,
                 batch_window_ms=2.0, tick_s=0.02)
    try:
        assert a.create_session(n, seed=7, sid=sid,
                                rand_global_phase=False) == sid
        a.apply(sid, jc1, timeout=120)
        # journal c2 the way submit() would, then abandon: no drain, its
        # every-job snapshot and the journal are all a successor gets
        a.store.wal_append(sid, jc2, tag=tag)
    finally:
        a.close()
    assert JStore(store_dir).wal_pending_tags(sids=[sid]) == {tag}
    oracle = QEngineCPU(n, rng=QrackRandom(7), rand_global_phase=False)
    for c in (jc1, jc2):
        c.Run(oracle)
    tc1, tc2, tc3 = _circuits(TCircuit, tmat, n)
    with _mini_fleet(tmp_path, n=1, store_dir=store_dir) as sup:
        sup.start()
        front = FleetFrontDoor(sup)
        assert not sup.tag_settled(tag)
        rep = sup.client("w0").adopt([sid])
        assert rep["sessions"] == [sid], rep
        assert rep["wal_replayed"] == 1 and rep["wal_deduped"] == 0, rep
        assert rep.get("recovered_stale", []) == []
        assert sup.place_session(sid, "cpu", n) == "w0"
        got = front.get_state(sid)
        assert np.array_equal(got, np.asarray(oracle.GetQuantumState()))
        assert TStore(store_dir).wal_entries(sids=[sid]) == []
        front.apply(sid, tc3)
        jc3.Run(oracle)
        assert _fidelity(oracle.GetQuantumState(),
                         front.get_state(sid)) > FID
        assert np.array_equal(front.get_state(sid),
                              np.asarray(oracle.GetQuantumState()))
        front.destroy_session(sid)


def test_spill_budget_never_evicts_a_snapshot_the_fleet_needs(tmp_path):
    """Every job's snapshot is a session's recovery copy: with a spill
    budget smaller than the sessions' snapshots, no worker's budget
    evicts a peer's (or its own resident session's) state file, so the
    killed owner's sessions are adopted with their state."""
    n = 8
    with _mini_fleet(tmp_path, n=2, layers="cuda", extra_env={
            "QRACK_SERVE_SPILL_MAX_MB": "0.001"}) as sup:
        sup.start()
        front = FleetFrontDoor(sup)
        sids, oracles = [], []
        for k in range(2):
            sids.append(front.create_session(n, seed=30 + k,
                                             rand_global_phase=False))
            oracles.append(QEngineCPU(n, rng=QrackRandom(30 + k),
                                      rand_global_phase=False))
        for sid, oracle in zip(sids, oracles):
            front.apply(sid, bell())
            jbell().Run(oracle)
        store = TStore(sup.store_dir)
        deadline = time.monotonic() + 30
        while store.wal_pending_tags(sids=sids):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert all(store.has_state(s) for s in sids)
        import os
        import signal

        owner = sup.owner_of(sids[0])
        os.kill(sup.stats()["workers"][owner]["pid"], signal.SIGKILL)
        front.apply(sids[0], bell())
        jbell().Run(oracles[0])
        for sid, oracle in zip(sids, oracles):
            assert _fidelity(oracle.GetQuantumState(),
                             front.get_state(sid)) > FID
