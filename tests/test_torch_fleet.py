"""The port's fleet control plane (qrack_tpu_torch/fleet) against the JAX
package's, in one process: the counterparts of tests/test_fleet.py's unit
tests.  Placement's costs, orders and first-fit-decreasing decisions on
the same seeded sequences; heartbeat files written by one package and
read by the other; circuits and arrays encoded by one package's rpc and
decoded by the other's; the reap ladder and the ``fleet.*`` fault specs;
the front door's retries and brownout ladder against a stub supervisor;
the autoscaler's ladder on the same pressure traces; the router's
brownout rung on the same circuit; and the supervisor's restart budget
and adoption retry with no worker spawned.

The cases that start real worker processes are in
tests/test_torch_fleet_workers.py and tests/test_torch_fleet_scale.py.
"""

import os
import signal
import socket as socketlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from qrack_tpu import QEngineCPU as JCPU
from qrack_tpu import fleet as jfleet
from qrack_tpu import matrices as jmat
from qrack_tpu import telemetry as jtele
from qrack_tpu.fleet import heartbeat as jhb
from qrack_tpu.fleet import rpc as jrpc
from qrack_tpu.layers.qcircuit import QCircuit as JCircuit
from qrack_tpu.models.algorithms import quantum_volume_qcircuit as j_qv
from qrack_tpu.resilience import faults as jfaults
from qrack_tpu.route import router as jrouter
from qrack_tpu.utils.rng import QrackRandom as JR

from qrack_tpu_torch import QEngineCPU as TCPU
from qrack_tpu_torch import fleet as tfleet
from qrack_tpu_torch import matrices as tmat
from qrack_tpu_torch import telemetry as ttele
from qrack_tpu_torch.fleet import heartbeat as thb
from qrack_tpu_torch.fleet import placement as tplacement
from qrack_tpu_torch.fleet import rpc as trpc
from qrack_tpu_torch.layers.qcircuit import QCircuit as TCircuit
from qrack_tpu_torch.models.algorithms import quantum_volume_qcircuit as t_qv
from qrack_tpu_torch.resilience import faults as tfaults
from qrack_tpu_torch.resilience.probe import reap_child
from qrack_tpu_torch.route import router as trouter
from qrack_tpu_torch.utils.rng import QrackRandom as TR


class _Side:
    def __init__(self, name, fleet, hb, rpc, faults, tele, router, CPU, R,
                 Circuit, mat, qv):
        self.name, self.fleet, self.hb, self.rpc = name, fleet, hb, rpc
        self.faults, self.tele, self.router = faults, tele, router
        self.CPU, self.R, self.Circuit, self.mat, self.qv = (
            CPU, R, Circuit, mat, qv)


JAX = _Side("jax", jfleet, jhb, jrpc, jfaults, jtele, jrouter, JCPU, JR,
            JCircuit, jmat, j_qv)
PORT = _Side("port", tfleet, thb, trpc, tfaults, ttele, trouter, TCPU, TR,
             TCircuit, tmat, t_qv)
SIDES = (JAX, PORT)

#: where the port's fleet differs from the JAX package's by design;
#: every other decision, counter and event is the JAX package's
BY_DESIGN = {
    "default_layers": "FleetSupervisor's default layers is the port's "
                      "dense terminal 'cuda' (the JAX supervisor's is "
                      "'cpu'): a fleet runs on the card unless the caller "
                      "names the CPU",
    "worker_module": "workers run 'python -m qrack_tpu_torch.fleet.worker' "
                     "(the JAX package's 'qrack_tpu.fleet.worker')",
    "cuda_context": "each worker owns its CUDA context; the supervisor "
                    "and the front door import no engine and never "
                    "initialize CUDA",
    "array_codec": "rpc.encode_array takes host numpy only: a worker "
                   "moves a ket off the card before it encodes it",
    "accept_wakes": "the worker's accept loop wakes every beat, so a "
                    "SIGTERM handed to another thread (or a shutdown op's "
                    "close) ends it; the JAX worker blocks in accept",
    "chip_times": "the supervisor keeps boot-to-ready times, a record of "
                  "deaths, each rolling restart's parts and every "
                  "incarnation's kernel launches and counters (from "
                  "its beats); a "
                  "worker's info adds its kernel launches, device bytes "
                  "and last adoption",
    "final_beat": "a rolling restart reads the reaped worker's final "
                  "beat before the respawn, as a scale-down does",
    "wal_scan": "the store's pending-tag and WAL scans skip an entry its "
                "worker settled since the listing (the JAX store's scan "
                "raises FileNotFoundError there)",
}


@pytest.fixture(autouse=True)
def _clean_fleet():
    for s in SIDES:
        s.faults.clear()
    yield
    for s in SIDES:
        s.faults.clear()
        s.tele.disable()
        s.tele.reset()
        s.router.set_brownout(False)


def _bell(side, n=2):
    c = side.Circuit(n)
    c.append_1q(0, side.mat.H2)
    c.append_ctrl([0], 1, side.mat.X2, 1)
    return c


def _random_circuit(side, n, seed, gates=24):
    """A seeded circuit of U3 singles and controlled X/Z on `n` qubits."""
    rng = np.random.Generator(np.random.PCG64(seed))
    c = side.Circuit(n)
    for _ in range(gates):
        t = int(rng.integers(0, n))
        if rng.random() < 0.6:
            th, ph, la = (float(x) for x in rng.uniform(0, 2 * np.pi, 3))
            c.append_1q(t, side.mat.u3_mtrx(th, ph, la))
        else:
            ctl = (t + 1 + int(rng.integers(0, n - 1))) % n
            m = side.mat.X2 if rng.random() < 0.5 else side.mat.Z2
            c.append_ctrl([ctl], t, m, 1)
    return c


def _fidelity(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real
                                            * np.vdot(b, b).real))


# ---------------------------------------------------------------------------
# placement: the same costs and decisions on the same sequences
# ---------------------------------------------------------------------------

COST_CASES = [("stabilizer", 100, None), (["unit", "stabilizer_hybrid"], 60,
                                          None),
              ("cpu", 22, None), ("cpu", 30, None), ("cpu", 21, None),
              ("cpu", 12, None), ("bdt", 40, None), ("unit_clifford", 80,
                                                     None),
              ("route", 24, None), ("hybrid", 18, None), ("pager", 33, 20)]


@pytest.mark.parametrize("layers,width,budget", COST_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in COST_CASES])
def test_session_cost_matches_jax(layers, width, budget):
    assert tfleet.session_cost(layers, width, budget_w=budget) == \
        jfleet.session_cost(layers, width, budget_w=budget)


def test_session_cost_stabilizer_nearly_free_dense_budgeted():
    # the JAX test's values, with the port's dense terminal beside "tpu"
    sc = tfleet.session_cost
    assert sc("stabilizer", 100) == pytest.approx(0.01)
    assert sc(["unit", "stabilizer_hybrid"], 60) == pytest.approx(0.01)
    assert sc("cpu", 22) == 1.0 and sc("cpu", 30) == 1.0
    assert sc("cpu", 21) == 0.5 and sc("cpu", 12) == 2.0 ** -10
    assert sc("cuda", 20, budget_w=20) == 1.0
    for name in tplacement.DENSE_TERMINALS:
        assert sc(name, 22) == jfleet.session_cost("tpu", 22) == 1.0
        assert sc(name, 26) == 1.0


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_session_cost_env_budget(side, monkeypatch):
    monkeypatch.setenv("QRACK_FLEET_DENSE_BUDGET_W", "10")
    assert side.fleet.session_cost("cpu", 10) == 1.0
    monkeypatch.setenv("QRACK_FLEET_DENSE_BUDGET_W", "bogus")
    assert side.fleet.session_cost("cpu", 22) == 1.0


def _placement_trace(side, seed: int) -> list:
    """A seeded sequence of place / set_state / evict / place_all /
    release on one Placement of the side; returns every decision and the
    final snapshot."""
    rng = np.random.Generator(np.random.PCG64(seed))
    P = side.fleet.Placement
    NoHealthy = side.fleet.NoHealthyWorkers
    p = P()
    names = [f"w{i}" for i in range(int(rng.integers(2, 5)))]
    for n in names:
        p.add_worker(n)
    stacks = ["cpu", "stabilizer", ["unit", "stabilizer_hybrid"], "bdt",
              "cpu"]
    log, sids = [], []
    for step in range(60):
        r = float(rng.random())
        if r < 0.5:
            sid = f"s{step}"
            layers = stacks[int(rng.integers(0, len(stacks)))]
            width = int(rng.integers(4, 27))
            try:
                log.append(("place", sid, p.place(sid, layers, width)))
                sids.append(sid)
            except NoHealthy:
                log.append(("place", sid, None))
        elif r < 0.65:
            n = names[int(rng.integers(0, len(names)))]
            st = ("healthy", "draining", "quarantined",
                  "dead")[int(rng.integers(0, 4))]
            p.set_state(n, st)
            log.append(("state", n, st))
        elif r < 0.85:
            n = names[int(rng.integers(0, len(names)))]
            ev = p.evict(n)
            try:
                mapping = p.place_all(ev, exclude=[n])
            except NoHealthy:
                mapping = None
                for sid, _ in ev:
                    sids.remove(sid)
            log.append(("evict", n, [(s, round(c, 9)) for s, c in ev],
                        mapping))
        elif sids:
            sid = sids.pop(int(rng.integers(0, len(sids))))
            p.release(sid)
            log.append(("release", sid))
    return log + [("snapshot", p.snapshot())]


@pytest.mark.parametrize("seed", [3, 11, 29, 47, 101, 257])
def test_placement_decisions_match_jax(seed):
    assert _placement_trace(PORT, seed) == _placement_trace(JAX, seed)


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_placement_least_loaded_then_overflow(side):
    side.tele.enable()
    side.tele.reset()
    p = side.fleet.Placement()
    p.add_worker("a")
    p.add_worker("b")
    first = p.place("s1", "cpu", 22)
    other = "b" if first == "a" else "a"
    assert p.place("s2", "cpu", 22) == other
    assert p.place("s3", "cpu", 22) in ("a", "b")
    assert p.load(p.owner_of("s3")) >= 1.0
    c = side.tele.snapshot()["counters"]
    assert c.get("fleet.placement.overflow") == 1
    assert c.get("fleet.placement.placed") == 3


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_placement_state_gating_and_exclude(side):
    p = side.fleet.Placement()
    for n in ("a", "b", "c"):
        p.add_worker(n)
    p.set_state("a", "draining")
    p.set_state("b", "quarantined")
    assert p.place("s1", "cpu", 4) == "c"
    p.set_state("c", "dead")
    with pytest.raises(side.fleet.NoHealthyWorkers):
        p.place("s2", "cpu", 4)
    p.set_state("c", "healthy")
    with pytest.raises(side.fleet.NoHealthyWorkers):
        p.place("s2", "cpu", 4, exclude=["c"])
    with pytest.raises(ValueError):
        p.set_state("c", "zombie")
    with pytest.raises(RuntimeError):
        p.remove_worker("c")          # still owns s1


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_placement_evict_and_first_fit_decreasing(side):
    p = side.fleet.Placement()
    for n in ("a", "b"):
        p.add_worker(n)
    p.assign("big", "a", 0.9)
    p.assign("t1", "a", 0.01)
    p.assign("t2", "a", 0.01)
    p.assign("peer", "b", 0.5)
    evicted = p.evict("a")
    assert sorted(sid for sid, _ in evicted) == ["big", "t1", "t2"]
    p.set_state("a", "dead")
    assert p.place_all(evicted, exclude=["a"]) == {
        "big": "b", "t1": "b", "t2": "b"}
    assert p.load("b") == pytest.approx(0.5 + 0.9 + 0.02)


# ---------------------------------------------------------------------------
# heartbeats: files that cross packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_heartbeat_files_cross_packages(writer, reader, tmp_path):
    path = str(tmp_path / "w.hb")
    assert reader.hb.read_heartbeat(path) is None
    w = writer.hb.HeartbeatWriter(path, interval_s=60,
                                  info_fn=lambda: {"ready": True,
                                                   "sessions": 3})
    assert w.beat() is True
    rec = reader.hb.read_heartbeat(path)
    assert rec["pid"] == os.getpid() and rec["seq"] == 1
    assert rec["ready"] is True and rec["sessions"] == 3
    assert reader.hb.beat_age_s(path) < 5.0
    with open(path, "w") as f:
        f.write('{"pid": 1, "t"')
    assert reader.hb.read_heartbeat(path) is None
    assert reader.hb.beat_age_s(path) is None


def test_heartbeat_writer_thread_and_hang_fault(tmp_path):
    path = str(tmp_path / "w.hb")
    w = thb.HeartbeatWriter(path, interval_s=60,
                            info_fn=lambda: {"ready": True})
    assert w.beat() is True
    assert thb.read_heartbeat(path)["seq"] == 1
    tfaults.inject("fleet.heartbeat", "hang")
    assert w.beat() is False
    assert thb.read_heartbeat(path)["seq"] == 1
    tfaults.clear()
    assert w.beat() is True and thb.read_heartbeat(path)["seq"] == 2
    fast = thb.HeartbeatWriter(str(tmp_path / "f.hb"), interval_s=0.02)
    fast.start()
    time.sleep(0.3)
    fast.stop(final_beat=True)
    assert thb.read_heartbeat(str(tmp_path / "f.hb"))["seq"] >= 3


def test_pid_alive():
    assert thb.pid_alive(os.getpid())
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    assert not thb.pid_alive(p.pid)
    assert thb.pid_alive(p.pid) == jhb.pid_alive(p.pid)


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------

SPECS = ["fleet.worker:kill:0", "fleet.heartbeat:hang:3",
         "fleet.spawn:hang:0", "fleet.spawn:raise:1", "fleet.spawn:kill:2+"]


@pytest.mark.parametrize("text", SPECS)
def test_fleet_fault_specs_parse_as_jax(text):
    t, j = tfaults.parse_spec(text), jfaults.parse_spec(text)
    assert (t.site, t.kind, t.after_n, t.times) == \
        (j.site, j.kind, j.after_n, j.times)


@pytest.mark.parametrize("bad", ["fleet.bogus:kill:0", "fleet.spawner:hang:0",
                                 "fleet.spawn:explode:0"])
def test_fleet_fault_specs_refused_as_jax(bad):
    for side in SIDES:
        with pytest.raises(ValueError):
            side.faults.load_env(bad)


def test_fleet_kill_directive():
    tfaults.inject("fleet.worker", "kill", after_n=1, times=1)
    assert tfaults.check("fleet.worker") is None
    assert tfaults.check("fleet.worker") == "kill"
    assert tfaults.check("fleet.worker") is None


# ---------------------------------------------------------------------------
# rpc: codecs that cross packages, framing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enc,dec", [(JAX, PORT), (PORT, JAX), (PORT, PORT)],
                         ids=["jax-to-port", "port-to-jax", "port"])
@pytest.mark.parametrize("seed", [5, 17])
def test_rpc_circuit_codec_crosses(enc, dec, seed):
    circ = _random_circuit(enc, 4, seed)
    payload = enc.rpc.encode_circuit(circ)
    back = dec.rpc.decode_circuit(payload)
    assert len(back.gates) == len(circ.gates)
    a = JCPU(4, rng=JR(3), rand_global_phase=False)
    _random_circuit(JAX, 4, seed).Run(a)
    b = dec.CPU(4, rng=dec.R(3), rand_global_phase=False)
    back.Run(b)
    assert np.array_equal(np.asarray(a.GetQuantumState()),
                          np.asarray(b.GetQuantumState()))


@pytest.mark.parametrize("enc,dec", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("dtype", [np.complex128, np.float32, np.int64])
def test_rpc_array_codec_crosses(enc, dec, dtype):
    x = (np.arange(12) - 4).astype(dtype).reshape(3, 4)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * np.arange(12).reshape(3, 4)
    y = dec.rpc.decode_array(enc.rpc.encode_array(x))
    assert y.dtype == x.dtype and y.shape == x.shape and np.array_equal(x, y)


def test_rpc_array_codec_takes_host_numpy_only():
    import torch

    with pytest.raises(TypeError, match="host numpy"):
        trpc.encode_array(torch.zeros(4, dtype=torch.complex128))


@pytest.mark.parametrize("sender,receiver", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_rpc_frames_over_socketpair(sender, receiver):
    a, b = socketlib.socketpair()
    fa, fb = a.makefile("rwb"), b.makefile("rwb")
    sender.rpc.send_frame(fa, {"op": "ping", "n": 3})
    assert receiver.rpc.recv_frame(fb) == {"op": "ping", "n": 3}
    fa.close()
    a.close()
    with pytest.raises(receiver.rpc.FleetRPCError):
        receiver.rpc.recv_frame(fb)
    fb.close()
    b.close()


def test_submit_result_frame_not_bounded_by_transport_timeout(tmp_path):
    path = str(tmp_path / "w.sock")
    server = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    server.bind(path)
    server.listen(1)
    got = {}

    def serve():
        conn, _ = server.accept()
        f = conn.makefile("rwb")
        req = trpc.recv_frame(f)
        got["circuit"] = jrpc.decode_circuit(req["circuit"])
        trpc.send_frame(f, {"ok": True, "journaled": True})
        time.sleep(0.8)
        trpc.send_frame(f, {"ok": True, "value": 7})
        f.close()
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        client = trpc.FleetClient(path, timeout_s=0.3, result_timeout_s=30.0)
        journaled, rep = client.submit("s1", _bell(PORT), tag="t")
        assert journaled and rep["value"] == 7
    finally:
        t.join(5)
        server.close()
    # the port's submit decodes in the JAX package: the same gates
    assert len(got["circuit"].gates) == len(_bell(PORT).gates)


# ---------------------------------------------------------------------------
# the reap ladder (resilience/probe.py)
# ---------------------------------------------------------------------------

def test_reap_child_sigterm_suffices():
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(60)"])
    r = reap_child(p, term_grace_s=10.0)
    assert not r.killed and not r.abandoned
    assert p.poll() is not None


def test_reap_child_escalates_to_sigkill():
    p = subprocess.Popen(
        [sys.executable, "-c",
         "import signal, sys, time\n"
         "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
         "print('R', flush=True)\n"
         "time.sleep(60)"], stdout=subprocess.PIPE)
    assert p.stdout.read(1) == b"R"
    r = reap_child(p, term_grace_s=0.3)
    assert r.killed and not r.abandoned
    assert p.returncode == -signal.SIGKILL


# ---------------------------------------------------------------------------
# the front door against a stub supervisor
# ---------------------------------------------------------------------------

class _StubSup:
    def __init__(self, client):
        self._client = client
        self.layers = "cpu"

    def route(self, sid):
        return self._client

    def tag_adopted(self, tag):
        return False


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_frontdoor_retries_session_not_found_until_adoption(side):
    calls = {"n": 0}

    class _Adopting:
        def prob(self, sid, qubit):
            calls["n"] += 1
            if calls["n"] < 3:
                raise side.rpc.FleetRemoteError("SessionNotFound", sid)
            return 0.5

    side.tele.enable()
    side.tele.reset()
    front = side.fleet.FleetFrontDoor(_StubSup(_Adopting()),
                                      route_timeout_s=10.0)
    assert front.prob("s1", 0) == 0.5
    assert calls["n"] == 3
    assert side.tele.snapshot()["counters"][
        "fleet.frontdoor.not_adopted_yet"] == 2


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_frontdoor_apply_retries_session_not_found(side):
    calls = {"n": 0}

    class _Adopting:
        def submit(self, sid, circuit, tag=None, priority=0):
            calls["n"] += 1
            if calls["n"] < 2:
                raise side.rpc.FleetRemoteError("SessionNotFound", sid)
            return True, {"ok": True}

    front = side.fleet.FleetFrontDoor(_StubSup(_Adopting()),
                                      route_timeout_s=10.0)
    assert front.apply("s1", _bell(side)) == {"resubmits": 0,
                                              "adopted": False}
    assert calls["n"] == 2


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_frontdoor_other_remote_errors_still_raise(side):
    class _Typed:
        def prob(self, sid, qubit):
            raise side.rpc.FleetRemoteError("ValueError", "qubit out of range")

    front = side.fleet.FleetFrontDoor(_StubSup(_Typed()), route_timeout_s=2.0)
    with pytest.raises(side.rpc.FleetRemoteError):
        front.prob("s1", 0)


def _transport_death_run(side, journaled: bool, seen: bool):
    """One apply whose first submit dies on the wire (before or after the
    journaled frame); returns the front door's answer and the submits."""
    submits = []

    class _Dying:
        def submit(self, sid, circuit, tag=None, priority=0):
            submits.append(tag)
            if len(submits) == 1:
                e = side.rpc.FleetRPCError("connection closed mid-exchange")
                e.journaled = journaled
                raise e
            return True, {"ok": True}

        def request(self, obj):
            assert obj["op"] == "tag_seen"
            return {"ok": True, "seen": seen}

    class _Sup(_StubSup):
        def tag_settled(self, tag):
            return False

    front = side.fleet.FleetFrontDoor(_Sup(_Dying()), route_timeout_s=5.0)
    out = front.apply("s1", _bell(side))
    return out, len(submits)


@pytest.mark.parametrize("journaled,seen", [(True, False), (False, True),
                                            (False, False)])
def test_frontdoor_exactly_once_after_transport_death(journaled, seen):
    got = {s.name: _transport_death_run(s, journaled, seen) for s in SIDES}
    assert got["port"] == got["jax"]
    out, n = got["port"]
    if journaled or seen:
        assert out == {"resubmits": 0, "adopted": True} and n == 1
    else:
        assert out == {"resubmits": 1, "adopted": False} and n == 2


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_frontdoor_brownout_ladder_order(side):
    from importlib import import_module

    Overloaded = import_module(
        "qrack_tpu.serve.errors" if side is JAX
        else "qrack_tpu_torch.serve.errors").Overloaded
    submitted = []

    class _Client:
        def submit(self, sid, circuit, tag=None, priority=0):
            submitted.append(priority)
            return True, {"ok": True}

    class _BrownoutSup(_StubSup):
        state = None

        def brownout(self):
            return self.state

    sup = _BrownoutSup(_Client())
    front = side.fleet.FleetFrontDoor(sup, route_timeout_s=5.0)
    sup.state = {"level": 1, "shed_band": 0, "retry_in_s": 0.5}
    with pytest.raises(Overloaded) as ei:
        front.apply("s1", _bell(side), priority=0)
    assert ei.value.level == 1 and ei.value.band == 0
    front.apply("s1", _bell(side), priority=1)
    sup.state = {"level": 2, "shed_band": 0, "retry_in_s": 0.5}
    front.apply("s1", _bell(side), priority=1)
    sup.state = {"level": 3, "shed_band": 0, "retry_in_s": 1.0}
    with pytest.raises(Overloaded) as ei:
        front.apply("s1", _bell(side), priority=1)
    assert ei.value.level == 3 and ei.value.retry_in_s == 1.0
    sup.state = None
    front.apply("s1", _bell(side), priority=0)
    assert submitted == [1, 1, 0]


def test_frontdoor_stranded_session_typed_error():
    class _Sup(_StubSup):
        def route(self, sid):
            return None

        def migrating_since(self, sid):
            return time.monotonic() - 10.0

        def owner_of(self, sid):
            return None

    for side in SIDES:
        front = side.fleet.FleetFrontDoor(_Sup(None), route_timeout_s=30.0,
                                          migrate_timeout_s=0.3)
        t0 = time.monotonic()
        with pytest.raises(side.fleet.AdoptionStalled):
            front.prob("s1", 0)
        assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# the autoscaler: the same decisions on the same pressure trace
# ---------------------------------------------------------------------------

class _FakeScaleSup:
    """Synthetic pressure at n_max: capacity never arrives, so only the
    brownout ladder moves."""

    def __init__(self, n=2):
        self.n = n
        self.backlog = 0.0
        self.wait = 0.0
        self.load = 0.0
        self.levels = []

    def pressure(self):
        return {"n_live": self.n, "n_total": self.n,
                "backlog": self.backlog, "load": self.load,
                "capacity": float(self.n),
                "queue_wait_p99_s": self.wait, "latency_p99_s": 0.0}

    def set_brownout(self, level, shed_band=0, retry_in_s=0.5):
        self.levels.append(level)

    def boot_worker(self, timeout_s=None):  # pragma: no cover — n_max
        raise AssertionError("scale-up attempted at n_max")


def _ladder(side, trace):
    cfg = side.fleet.AutoscaleConfig(n_min=1, n_max=2, up_ticks=2,
                                     ladder_ticks=2, cooldown_s=0.0,
                                     down_ticks=10_000)
    a = side.fleet.Autoscaler(cfg)
    sup = _FakeScaleSup(n=2)
    levels = []
    for backlog, wait, load in trace:
        sup.backlog, sup.wait, sup.load = backlog, wait, load
        a.tick(sup)
        levels.append(a.level)
    st = a.stats()
    return levels, sup.levels, st["decisions"], st["n_peak"]


def test_autoscaler_ladder_escalates_and_calms_one_rung_at_a_time():
    trace = [(100.0, 0.0, 0.0)] * 10 + [(0.0, 0.0, 0.0)] * 10
    for side in SIDES:
        levels, broadcast, decisions, _ = _ladder(side, trace)
        assert levels[9] == 3 and levels[-1] == 0
        assert broadcast == [1, 2, 3, 2, 1, 0]
        for lv in (1, 2, 3):
            assert decisions.get(f"brownout.level{lv}", 0) >= 1
    assert _ladder(PORT, trace) == _ladder(JAX, trace)


@pytest.mark.parametrize("seed", [1, 7, 42, 99])
def test_autoscaler_decisions_match_jax_on_seeded_trace(seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    trace = []
    for _ in range(120):
        r = float(rng.random())
        trace.append((float(rng.uniform(0, 20)) if r < 0.5 else 0.0,
                      float(rng.uniform(0, 2)) if r > 0.8 else 0.0,
                      float(rng.uniform(0, 2.2))))
    assert _ladder(PORT, trace) == _ladder(JAX, trace)


# ---------------------------------------------------------------------------
# the router's brownout rung and the scheduler's shed bands
# ---------------------------------------------------------------------------

def test_router_brownout_quantizes_borderline_dense(monkeypatch):
    monkeypatch.delenv("QRACK_ROUTE", raising=False)
    monkeypatch.setenv("QRACK_ROUTE_HBM_BYTES", str(16 << 30))
    got = {}
    for side in SIDES:
        side.tele.enable()
        side.tele.reset()
        circ = side.qv(12, rng=side.R(11))
        base = side.router.decide(circ, 12)
        side.router.set_brownout(True)
        try:
            d = side.router.decide(circ, 12)
            monkeypatch.setenv("QRACK_ROUTE", "dense")
            pinned = side.router.decide(circ, 12)
            monkeypatch.delenv("QRACK_ROUTE")
        finally:
            side.router.set_brownout(False)
        assert side.router.brownout_active() is False
        got[side.name] = (base.stack, base.reason, d.stack, d.reason,
                          pinned.stack, side.tele.snapshot()["counters"].get(
                              "serve.brownout.quantized"))
    assert got["port"] == got["jax"]
    assert got["port"] == ("dense", "cost", "turboquant", "brownout",
                           "dense", 1)


def test_scheduler_brownout_sheds_by_band():
    from qrack_tpu_torch.serve import Overloaded
    from qrack_tpu_torch.serve.scheduler import Job, Scheduler

    s = Scheduler(max_depth=8, queue_budget_s=10.0, batch_window_s=0.0,
                  max_batch=1)
    s.set_brownout(1, shed_band=0, retry_in_s=0.25)
    assert s.brownout_level() == 1
    with pytest.raises(Overloaded) as ei:
        s.submit(Job(None, "admin", priority=0))
    assert ei.value.retry_in_s == 0.25
    assert ei.value.level == 1 and ei.value.band == 0
    s.submit(Job(None, "admin", priority=1))
    s.set_brownout(3)
    with pytest.raises(Overloaded) as ei:
        s.submit(Job(None, "admin", priority=5))
    assert ei.value.level == 3 and ei.value.band is None
    s.set_brownout(0)
    s.submit(Job(None, "admin", priority=0))
    assert s.depth() == 2


# ---------------------------------------------------------------------------
# the supervisor's control plane with no worker spawned
# ---------------------------------------------------------------------------

def _idle_sup(side, tmp_path, n=2, **kw):
    kw.setdefault("beat_s", 0.2)
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("ready_timeout_s", 5.0)
    return side.fleet.FleetSupervisor(n, str(tmp_path / side.name),
                                      layers="cpu", **kw)


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_boot_failure_counts_against_restart_budget(side, tmp_path,
                                                    monkeypatch):
    sup = _idle_sup(side, tmp_path, n=1, restart_threshold=2)
    h = sup._workers["w0"]
    monkeypatch.setattr(sup, "_spawn", lambda h: None)

    def never_ready(names=None, timeout_s=0.0):
        raise RuntimeError("worker w0 exited rc=1 during boot")

    monkeypatch.setattr(sup, "wait_ready", never_ready)
    sup.placement.set_state("w0", "dead")
    t0 = time.monotonic()
    sup._respawn(h)
    assert h.crashes == 1 and h.next_restart_at > t0
    assert h.breaker.snapshot()["consecutive_failures"] == 1
    sup._respawn(h)
    assert h.crashes == 2
    sup._maybe_restart(h)
    assert sup.placement.state("w0") == "quarantined"


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_failed_adoption_keeps_sid_migrating_then_retries(side, tmp_path,
                                                          monkeypatch):
    sup = _idle_sup(side, tmp_path, n=2)
    sup.placement.assign("s1", "w0", 0.5)
    sup._migrating.add("s1")
    attempts = {"n": 0}

    def flaky(h, sids, timeout_s=60.0):
        attempts["n"] += 1
        if attempts["n"] == 1:
            return None
        return {"sessions": list(sids), "wal_replayed": 0,
                "wal_deduped": 0, "wal_skipped": 0}

    monkeypatch.setattr(sup, "_adopt_batch", flaky)
    assert sup._adopt_assigned("w0", ["s1"]) is False
    assert "s1" in sup._migrating and sup.route("s1") is None
    assert sup.stats()["adopt_pending"] == 1
    sup._adopt_pending = [(n, b, 0.0) for n, b, _ in sup._adopt_pending]
    sup._retry_pending_adoptions()
    assert attempts["n"] == 2
    assert "s1" not in sup._migrating and sup.route("s1") is not None


def test_supervisor_defaults_and_worker_command(tmp_path, monkeypatch):
    """The port's supervisor runs its workers on the card by default,
    through the port's worker module; the JAX one on the CPU."""
    cmds = {}
    for side in SIDES:
        sup = side.fleet.FleetSupervisor(1, str(tmp_path / side.name))
        seen = {}

        class _Popen:
            def __init__(self, cmd, **kw):
                seen["cmd"], seen["env"] = cmd, kw["env"]
                self.pid = 0

        monkeypatch.setattr(subprocess, "Popen", _Popen)
        sup._spawn(sup._workers["w0"])
        monkeypatch.undo()
        cmds[side.name] = seen
    port, jax = cmds["port"], cmds["jax"]
    assert port["cmd"][1:3] == ["-m", "qrack_tpu_torch.fleet.worker"]
    assert jax["cmd"][1:3] == ["-m", "qrack_tpu.fleet.worker"]
    layers = lambda c: c["cmd"][c["cmd"].index("--layers") + 1]  # noqa: E731
    assert layers(port) == "cuda" and layers(jax) == "cpu"
    assert port["env"]["QRACK_SERVE_PREWARM"] == "1"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert port["env"]["PYTHONPATH"].split(os.pathsep)[0] == root
    sup = tfleet.FleetSupervisor(1, str(tmp_path / "kw"),
                                 layers=["unit", "cuda"],
                                 engine_kwargs={"device": "cpu"})
    assert sup.engine_kwargs == '{"device": "cpu"}'


def test_fleet_imports_no_engine_and_no_cuda():
    """The supervisor and the front door load no engine module and no
    kernel wrapper, and leave CUDA uninitialized (a fresh process)."""
    code = (
        "import sys, torch\n"
        "import qrack_tpu_torch.fleet.supervisor, "
        "qrack_tpu_torch.fleet.frontdoor\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'qrack_tpu_torch.engines', 'qrack_tpu_torch.ops.window_kernel',"
        " 'jax', 'qrack_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_store_wal_scans_skip_entries_settled_meanwhile(tmp_path,
                                                       monkeypatch):
    """A peer scanning the shared journal (the supervisor's pending-tag
    record, the front door's settle wait) while a worker settles and
    removes an entry skips that entry instead of failing the scan."""
    from qrack_tpu_torch.checkpoint.store import CheckpointStore

    store = CheckpointStore(str(tmp_path / "store"))
    store.wal_append("s1", _bell(PORT), tag="kept")
    gone = store.wal_append("s1", _bell(PORT), tag="settled")
    listed = store._wal_files()
    os.unlink(gone)
    monkeypatch.setattr(store, "_wal_files", lambda: listed)
    assert store.wal_pending_tags(sids=["s1"]) == {"kept"}
    assert [seq for _, seq, _ in store.wal_entries(sids=["s1"])] == [0]
