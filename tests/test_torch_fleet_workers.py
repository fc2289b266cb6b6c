"""Real port fleets on the CPU: the counterparts of tests/test_fleet.py's
supervised end-to-end cases (kill -9 then adoption and restart, the
rolling restart, the flapping worker's quarantine and probe, the
worker's ``info`` op), plus a kill landed while a job is in flight.

Workers are ``python -m qrack_tpu_torch.fleet.worker`` processes over
one shared store, serving the host terminal ``"cpu"`` or the dense
terminal ``"cuda"`` with ``engine_kwargs='{"device": "cpu"}'``.  Every
ket is held to an in-process JAX ``QEngineCPU`` oracle on the same seed
at fidelity > 1 - 1e-12, as the JAX tests hold theirs.  The cadence is
the JAX tests' (``_mini_fleet``), and every wait is bounded.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

from qrack_tpu import QEngineCPU
from qrack_tpu import matrices as jmat
from qrack_tpu.layers.qcircuit import QCircuit as JCircuit
from qrack_tpu.utils.rng import QrackRandom

from qrack_tpu_torch import matrices as tmat
from qrack_tpu_torch import telemetry as tele
from qrack_tpu_torch.checkpoint.store import CheckpointStore
from qrack_tpu_torch.fleet import FleetFrontDoor, FleetSupervisor
from qrack_tpu_torch.layers.qcircuit import QCircuit as TCircuit
from qrack_tpu_torch.resilience import faults

FID = 1 - 1e-12
#: the fleets these cases stand up: the host terminal, and the port's
#: dense terminal kept off the card
LAYERS = {"cpu": ("cpu", None), "cuda": ("cuda", {"device": "cpu"})}


@pytest.fixture(autouse=True)
def _clean_fleet():
    faults.clear()
    yield
    faults.clear()
    tele.disable()
    tele.reset()


def _bell(Circuit, mat, n=2):
    c = Circuit(n)
    c.append_1q(0, mat.H2)
    c.append_ctrl([0], 1, mat.X2, 1)
    return c


def bell():
    return _bell(TCircuit, tmat)


def jbell():
    return _bell(JCircuit, jmat)


def _heavy(Circuit, mat, n, seed, gates):
    rng = np.random.Generator(np.random.PCG64(seed))
    c = Circuit(n)
    for _ in range(gates):
        t = int(rng.integers(0, n))
        if rng.random() < 0.6:
            th, ph, la = (float(x) for x in rng.uniform(0, 2 * np.pi, 3))
            c.append_1q(t, mat.u3_mtrx(th, ph, la))
        else:
            ctl = (t + 1 + int(rng.integers(0, n - 1))) % n
            c.append_ctrl([ctl], t, mat.X2, 1)
    return c


def _fidelity(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real
                                            * np.vdot(b, b).real))


def _mini_fleet(tmp_path, n=2, layers="cpu", **kw):
    kw.setdefault("beat_s", 0.2)
    kw.setdefault("deadline_beats", 4)
    kw.setdefault("tick_s", 0.05)
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("restart_cooldown_s", 1.0)
    kw.setdefault("stable_s", 0.3)
    kw.setdefault("ready_timeout_s", 120.0)
    terminal, ek = LAYERS[layers]
    return FleetSupervisor(n, str(tmp_path / "fleet"), layers=terminal,
                           engine_kwargs=ek, **kw)


def _wait_states(sup, want, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        states = {w["state"] for w in sup.stats()["workers"].values()}
        if states == want:
            return
        time.sleep(0.05)
    raise AssertionError(f"fleet never reached {want}: {sup.stats()}")


@pytest.mark.parametrize("layers", sorted(LAYERS))
def test_fleet_kill9_adopt_restart_zero_loss(layers, tmp_path):
    with _mini_fleet(tmp_path, layers=layers) as sup:
        sup.start()
        front = FleetFrontDoor(sup)
        sid = front.create_session(2, seed=11, rand_global_phase=False)
        oracle = QEngineCPU(2, rng=QrackRandom(11), rand_global_phase=False)
        front.apply(sid, bell())
        jbell().Run(oracle)
        owner = sup.owner_of(sid)
        pid = sup.stats()["workers"][owner]["pid"]
        os.kill(pid, signal.SIGKILL)
        front.apply(sid, bell())
        jbell().Run(oracle)
        assert sup.owner_of(sid) != owner
        assert _fidelity(oracle.GetQuantumState(),
                         front.get_state(sid)) > FID
        _wait_states(sup, {"healthy"})
        st = sup.stats()
        assert st["workers"][owner]["crashes"] == 1
        assert st["workers"][owner]["restarts"] >= 1
        # the only death is the injected kill, detected as an exit
        assert [(d["worker"], d["pid"], d["reason"]) for d in st["deaths"]] \
            == [(owner, pid, "exit")]
        d = st["deaths"][0]
        assert d["sessions"] == [sid]
        assert d["detected_at"] <= d["adopted_at"]
        assert st["workers"][owner]["boot_to_ready_s"] > 0
        front.destroy_session(sid)


@pytest.mark.parametrize("layers", sorted(LAYERS))
def test_fleet_rolling_restart_migrates_live_session(layers, tmp_path):
    with _mini_fleet(tmp_path, layers=layers) as sup:
        sup.start()
        front = FleetFrontDoor(sup)
        sid = front.create_session(2, seed=5, rand_global_phase=False)
        oracle = QEngineCPU(2, rng=QrackRandom(5), rand_global_phase=False)
        front.apply(sid, bell())
        jbell().Run(oracle)
        pids = {n: w["pid"] for n, w in sup.stats()["workers"].items()}
        out = sup.rolling_restart()
        assert set(out) == set(sup.worker_names())
        assert sum(len(v["migrated"]) for v in out.values()) >= 1
        for v in out.values():
            assert not v["needed_kill"]       # SIGTERM's drain sufficed
            assert set(v["parts_s"]) == {"drain", "reap", "adopt",
                                         "respawn"}
        st = sup.stats()
        assert all(st["workers"][n]["pid"] != p for n, p in pids.items())
        assert st["deaths"] == []
        front.apply(sid, bell())
        jbell().Run(oracle)
        assert _fidelity(oracle.GetQuantumState(),
                         front.get_state(sid)) > FID
        _wait_states(sup, {"healthy"})


def test_fleet_flapping_worker_quarantined_then_probed(tmp_path):
    with _mini_fleet(tmp_path, restart_threshold=2,
                     restart_cooldown_s=1.5, stable_s=30.0) as sup:
        sup.start()
        victim = sup.worker_names()[0]
        seen_quarantine = False
        kills = 0
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            st = sup.stats()["workers"][victim]
            if st["state"] == "quarantined":
                seen_quarantine = True
                break
            if st["state"] == "healthy" and kills < 2:
                os.kill(st["pid"], signal.SIGKILL)
                kills += 1
                time.sleep(0.3)
            time.sleep(0.05)
        assert seen_quarantine, sup.stats()
        _wait_states(sup, {"healthy"}, timeout_s=90)
        assert sup.stats()["workers"][victim]["crashes"] >= 2


@pytest.mark.parametrize("layers", sorted(LAYERS))
def test_worker_info_op_returns_telemetry_snapshot(layers, tmp_path):
    tele.enable()
    tele.reset()
    with _mini_fleet(tmp_path, n=1, layers=layers) as sup:
        sup.start()
        front = FleetFrontDoor(sup)
        sid = front.create_session(2, seed=3, rand_global_phase=False)
        front.apply(sid, bell())
        front.apply(sid, bell())
        deadline = time.monotonic() + 10.0
        while True:
            info = sup.route(sid).info()
            done = (info["telemetry"]["counters"]
                    .get("serve.jobs.completed", 0))
            if done >= 2 or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        assert info["name"] == "w0"
        assert info["pid"] == sup.stats()["workers"]["w0"]["pid"]
        assert info["ready"] is True and info["draining"] is False
        assert info["sessions"] == 1
        snap = info["telemetry"]
        assert snap["enabled"] is True and snap["pid"] == info["pid"]
        assert snap["counters"]["serve.jobs.completed"] >= 2
        assert snap["hists"]["serve.latency"]["count"] >= 2
        assert snap["gauges"]["serve.latency.p50"] > 0
        # no card: no device bytes; the dense terminal ran its window
        # through the kernel wrappers' plain versions, which count no
        # launch (a launch is a kernel's)
        assert info["device_bytes"] is None
        window = info["kernels"].get("window", {})
        assert all(v == 0 for c in window.values() for v in c.values())
        # the beats carry the same record to the supervisor
        deadline = time.monotonic() + 10.0
        while f"w0:{info['pid']}" not in sup.kernel_launches():
            assert time.monotonic() < deadline, sup.kernel_launches()
            time.sleep(0.05)
        front.destroy_session(sid)


def test_kill_with_job_in_flight_lands_exactly_once(tmp_path):
    """SIGKILL the owner while its job is journaled but not settled
    (queued or running): the adopter's WAL replay, deduplicated by
    wal_high against the every-job snapshot, lands it once; the front
    door's apply returns without resubmitting, and the next apply lands
    once on the peer."""
    n, gates = 16, 400
    with _mini_fleet(tmp_path) as sup:
        sup.start()
        front = FleetFrontDoor(sup)
        store = CheckpointStore(sup.store_dir)
        sid = front.create_session(n, seed=21, rand_global_phase=False)
        oracle = QEngineCPU(n, rng=QrackRandom(21), rand_global_phase=False)
        front.apply(sid, _heavy(TCircuit, tmat, n, 1, 20))
        _heavy(JCircuit, jmat, n, 1, 20).Run(oracle)
        # the result frame precedes the snapshot and the WAL removal:
        # let the first job settle, so the kill lands on the second
        deadline = time.monotonic() + 30.0
        while store.wal_pending_tags(sids=[sid]):
            assert time.monotonic() < deadline, "the first job never settled"
            time.sleep(0.01)
        owner = sup.owner_of(sid)
        pid = sup.stats()["workers"][owner]["pid"]
        box = {}

        def submit():
            box["out"] = front.apply(sid, _heavy(TCircuit, tmat, n, 2, gates))

        t = threading.Thread(target=submit, daemon=True)
        t.start()
        deadline = time.monotonic() + 30.0
        while not store.wal_pending_tags(sids=[sid]):
            assert time.monotonic() < deadline, "the job never journaled"
            time.sleep(0.002)
        os.kill(pid, signal.SIGKILL)
        t.join(120)
        assert not t.is_alive()
        _heavy(JCircuit, jmat, n, 2, gates).Run(oracle)
        assert box["out"] == {"resubmits": 0, "adopted": True}
        front.apply(sid, _heavy(TCircuit, tmat, n, 3, 20))
        _heavy(JCircuit, jmat, n, 3, 20).Run(oracle)
        adopter = sup.owner_of(sid)
        assert adopter != owner
        got = sup.client(adopter).info()["last_adopt"]
        assert got["sids"] == [sid]
        assert got["wal_replayed"] + got["wal_deduped"] == 1
        assert _fidelity(oracle.GetQuantumState(),
                         front.get_state(sid)) > FID
        assert store.wal_entries(sids=[sid]) == []
        front.destroy_session(sid)


def test_fleet_trace_and_postmortem_across_a_kill(tmp_path):
    """The observability plane of test_fleet.py's acceptance flow,
    without its p99 timing bars: one merged trace in which a submit's
    spans cross the front door and a worker, the killed incarnation's
    black box as a postmortem, and both record kinds in the fleet
    JSONL."""
    import json

    tele.enable()
    tele.reset()
    with _mini_fleet(tmp_path, n=2) as sup:
        sup.start()
        front = FleetFrontDoor(sup)
        sids = [front.create_session(4, seed=k, rand_global_phase=False)
                for k in range(2)]
        for _ in range(3):
            for sid in sids:
                front.apply(sid, bell())
        victim = sup.owner_of(sids[0])
        vpid = sup.stats()["workers"][victim]["pid"]
        time.sleep(0.6)           # two beats: the black box is flushed
        os.kill(vpid, signal.SIGKILL)
        for sid in sids:
            front.apply(sid, bell())
        deadline = time.monotonic() + 30
        while not [p for p in sup.stats()["postmortems"]
                   if p["pid"] == vpid]:
            assert time.monotonic() < deadline, sup.stats()["postmortems"]
            time.sleep(0.05)
        path = tmp_path / "trace.json"
        sup.write_merged_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        by_trace = {}
        for e in events:
            if e.get("ph") == "X" and (e.get("args") or {}).get("trace"):
                by_trace.setdefault(e["args"]["trace"], []).append(e)
        worker_side = {"serve.execute", "worker.submit.journal",
                       "worker.submit.result"}
        assert [t for t, evs in by_trace.items()
                if "frontdoor.apply" in {e["name"] for e in evs}
                and worker_side & {e["name"] for e in evs}
                and len({e["pid"] for e in evs}) >= 2]
        post = [p for p in sup.stats()["postmortems"] if p["pid"] == vpid][-1]
        assert post["worker"] == victim and post["reason"] == "exit"
        assert post["last_events"]
        sup.metrics(write=True)
        kinds = {json.loads(x).get("kind") for x in open(sup.telemetry_path)}
        assert {"fleet", "postmortem"} <= kinds
