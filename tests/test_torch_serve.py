"""The port's serving plane (qrack_tpu_torch/serve) against the JAX
package's, on the CPU: the counterparts of the 17 tier-1 tests of
tests/test_serve.py, plus the port's own: the fold's lane groups under
the width cap, its launches, and the batch key's dtype and device (the
refusal without a GPU is tests/test_torch_isolation.py's).

Parity: each case runs the same seeded sessions and circuits through
the JAX package's ``QrackService`` (dense terminal ``"tpu"``) and the
port's (``"cuda"`` with ``device="cpu"``, whose batch runs the window
kernel's plain version over the fold); the served kets agree with each
other and with the JAX complex128 oracle at fidelity > 1 - 1e-6 (the
JAX tests' bar), and the serve.* / compile.serve_batch.* counters, the
scheduling decisions and the typed errors are the same, but for
BY_DESIGN.  Where a JAX session fails over onto QEngineCPU, the port's
session passes ``failover_cpu=True`` (the failover rule: the chain
stays on the card otherwise).

The batching cases set ``QRACK_SERVE_PREFIX=0`` on both sides: with the
prefix cache on, both services split a popular circuit on a pristine
session and run the whole-prefix job as a singleton.  That is why
``test_same_shape_jobs_from_different_tenants_cobatch`` and
``test_program_cache_reused_across_sessions`` fail in tests/
test_serve.py on the seed; their counterparts here pin the cache off
and pass on both packages (the cache has its own cases in
tests/test_torch_prefix_cache.py).  The two slow-marked soaks
(``test_serve_soak_smoke``, ``test_elastic_soak_smoke``) drive the JAX
scripts/ and are not ported.

Every service is closed in a ``with`` block or ``finally``, and every
wait is bounded.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU as JCPU
from qrack_tpu import matrices as jmat
from qrack_tpu import resilience as jres
from qrack_tpu import telemetry as jtele
import qrack_tpu.serve as jserve
from qrack_tpu.layers.qcircuit import QCircuit as JCircuit
from qrack_tpu.layers.qcircuit import QCircuitGate as JGate
from qrack_tpu.models.qft import qft_qcircuit as j_qft
from qrack_tpu.resilience import faults as jfaults
from qrack_tpu.resilience.breaker import CircuitBreaker as JBreaker
from qrack_tpu.serve import batcher as jbatcher
from qrack_tpu.utils.rng import QrackRandom as JR

import qrack_tpu_torch.serve as tserve
from qrack_tpu_torch import matrices as tmat
from qrack_tpu_torch import resilience as tres
from qrack_tpu_torch import telemetry as ttele
from qrack_tpu_torch.checkpoint import warmstart as twarm
from qrack_tpu_torch.engines.cpu import QEngineCPU as TCPU
from qrack_tpu_torch.layers.qcircuit import QCircuit as TCircuit
from qrack_tpu_torch.layers.qcircuit import QCircuitGate as TGate
from qrack_tpu_torch.models.qft import qft_qcircuit as t_qft
from qrack_tpu_torch.ops import cuda_build
from qrack_tpu_torch.resilience import faults as tfaults
from qrack_tpu_torch.resilience import integrity as tinteg
from qrack_tpu_torch.resilience.breaker import CircuitBreaker as TBreaker
from qrack_tpu_torch.route import cost as tcost
from qrack_tpu_torch.serve import batcher as tbatcher
from qrack_tpu_torch.utils.rng import QrackRandom as TR

W = 6  # test width: big enough to batch, small enough to stay fast
FID_BAR = 1e-6

#: where the port's serving plane differs from the JAX package's by
#: design; every other counter and event is the JAX package's
BY_DESIGN = {
    "cuda_terminal": "the dense terminal is 'cuda' (the JAX package's "
                     "'tpu'); a store record naming 'tpu' is read as "
                     "'cuda' (session.port_layers)",
    "folded_batch": "a batch is ONE folded ket through the window kernel "
                    "(K1/K2): the lanes stacked as its high bits, in "
                    "lane groups at most MAX_DENSE_QB (30) qubits wide; "
                    "the JAX package vmaps the plain XLA body in one jit",
    "key_dtype_device": "a batch key and a cached program carry the "
                        "planes' dtype and device (the port's engines "
                        "choose their dtype per construction; the JAX "
                        "package's dtype is global)",
    "cow_at_seed": "a prefix-cache hit gives the engine its own copy of "
                   "the entry (one ket copy a hit, serve.prefix.cow); "
                   "the JAX package pins the shared buffer and copies "
                   "at its first donating dispatch",
    "kernel_cache": "the warm start builds the kernel libraries into "
                    "<checkpoint_dir>/kernel_cache (compile.kernel.*); "
                    "the JAX package points its persistent XLA cache at "
                    "<checkpoint_dir>/xla_cache",
    "item_sync": "the honest sync reads one element with .item() on "
                 "lane 0; the JAX package's device_get of one element",
    "batch_pad_0": "QRACK_SERVE_BATCH_PAD=0 keys programs by exact batch "
                   "sizes, as in the JAX package, but the fold still "
                   "pads its lanes to a power of two",
    "canary_card_strike": "a canary mismatch on a dense engine strikes "
                          "its card (GetDevice) where the JAX engine "
                          "lists no device; on the CPU neither strikes",
    "replay_in_place": "a failed batch's job whose session has no rung "
                       "below its QEngineCUDA (no failover_cpu: the chain "
                       "stays on the card) replays on that engine as a "
                       "one-lane batch (serve.batch.replay.in_place); the "
                       "JAX chain always ends on QEngineCPU",
}


def _side(pkg: str):
    if pkg == "jax":
        return types.SimpleNamespace(
            name="jax", Service=jserve.QrackService, errors=jserve,
            qft=j_qft, faults=jfaults, res=jres, tele=jtele,
            batcher=jbatcher, Breaker=JBreaker, CPU=JCPU, R=JR,
            Circuit=JCircuit, Gate=JGate, mat=jmat, dense="tpu", kw={})
    return types.SimpleNamespace(
        name="port", Service=tserve.QrackService, errors=tserve,
        qft=t_qft, faults=tfaults, res=tres, tele=ttele,
        batcher=tbatcher, Breaker=TBreaker, CPU=TCPU, R=TR,
        Circuit=TCircuit, Gate=TGate, mat=tmat, dense="cuda",
        kw={"device": "cpu"})


JAX, PORT = _side("jax"), _side("port")
SIDES = (JAX, PORT)


def _reset_sides() -> None:
    for s in SIDES:
        s.faults.clear()
        s.res.reset_breaker()
        s.res.configure()
        s.res.disable()
        s.tele.disable()
        s.tele.reset()
        s.batcher.clear_programs()
        s.batcher.set_manifest(None)
    tinteg.reset()
    tcost.set_hbm_reservation(None)
    cuda_build.set_build_dir(None)
    twarm._ENABLED_DIR = None


@pytest.fixture(autouse=True)
def _clean_serve():
    _reset_sides()
    for s in SIDES:
        s.res.configure(max_retries=2, backoff_s=0.0, timeout_s=0.0)
    yield
    _reset_sides()


@pytest.fixture
def no_prefix(monkeypatch):
    """The batching cases: no prefix split on either side."""
    monkeypatch.setenv("QRACK_SERVE_PREFIX", "0")


def fidelity(a, b) -> float:
    a = np.asarray(a, dtype=np.complex128).ravel()
    b = np.asarray(b, dtype=np.complex128).ravel()
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real
                                      * np.vdot(b, b).real)


def svc(side, layers="dense", **kw):
    """A service of `side` with the JAX tests' defaults; ``"dense"`` is
    the side's dense terminal, which on the port runs with
    ``device="cpu"``."""
    kw.setdefault("batch_window_ms", 5.0)
    kw.setdefault("queue_budget_ms", 60_000.0)
    kw.setdefault("tick_s", 0.02)
    if layers in ("dense", "pager"):
        kw = {**side.kw, **kw}
        layers = side.dense if layers == "dense" else layers
    return side.Service(engine_layers=layers, **kw)


def oracle(side, seed: int, *circuits, width: int = W, pre=None):
    """The side's host oracle after `pre(eng)` and `circuits`."""
    eng = side.CPU(width, rng=side.R(seed), rand_global_phase=False)
    if pre is not None:
        pre(eng)
    for c in circuits:
        c.Run(eng)
    return np.asarray(eng.GetQuantumState())


def counters(side, *prefixes) -> dict:
    snap = side.tele.snapshot()["counters"]
    return {k: v for k, v in snap.items() if k.startswith(prefixes)}


def both(scenario):
    """Run `scenario(side)` on the JAX side, then on the port's (each
    with a fresh plane), and return both results."""
    out = {}
    for s in SIDES:
        _reset_sides()
        s.res.configure(max_retries=2, backoff_s=0.0, timeout_s=0.0)
        out[s.name] = scenario(s)
    return out["jax"], out["port"]


def assert_kets(jax_states, port_states, want=None):
    for j, p in zip(jax_states, port_states):
        assert fidelity(j, p) > 1 - FID_BAR
    for w, p in zip(want or (), port_states):
        assert fidelity(w, p) > 1 - FID_BAR


def _h_wall(side):
    """A circuit whose shape_key differs from qft_qcircuit(W)."""
    c = side.Circuit(W)
    for q in range(W):
        c.AppendGate(side.Gate.single(q, side.mat.H2))
    return c


# ---------------------------------------------------------------------------
# tier-1 smoke: 8 concurrent CPU-engine sessions, full scheduler path
# ---------------------------------------------------------------------------

def test_eight_concurrent_cpu_sessions_match_oracles():
    def run(side):
        with svc(side, "cpu") as s:
            sids = [s.create_session(W, seed=k, rand_global_phase=False)
                    for k in range(8)]
            errors, states = [], {}

            def tenant(k: int, sid: str):
                try:
                    s.call(sid, lambda eng, k=k: eng.X(k % W)).result(30)
                    s.apply(sid, side.qft(W), timeout=60)
                    states[k] = s.get_state(sid, timeout=60)
                except BaseException as e:  # noqa: BLE001
                    errors.append((k, e))

            threads = [threading.Thread(target=tenant, args=(k, sid))
                       for k, sid in enumerate(sids)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(90)
            assert not errors, errors
        return [states[k] for k in range(8)]

    j, p = both(run)
    want = [oracle(JAX, k, j_qft(W), pre=lambda e, k=k: e.X(k % W))
            for k in range(8)]
    assert_kets(j, p, want)


# ---------------------------------------------------------------------------
# batching (QRACK_SERVE_PREFIX=0 on both sides: module docstring)
# ---------------------------------------------------------------------------

def test_same_shape_jobs_from_different_tenants_cobatch(no_prefix):
    def run(side):
        side.tele.enable()
        with svc(side, batch_window_ms=500.0, max_batch=4) as s:
            sids = [s.create_session(W, seed=k, rand_global_phase=False)
                    for k in range(4)]
            handles = [s.submit(sid, side.qft(W)) for sid in sids]
            for h in handles:
                h.result(60)
            states = [s.get_state(sid, timeout=60) for sid in sids]
        return states, counters(side, "serve.batch.", "compile.serve_batch")

    (js, jc), (ps, pc) = both(run)
    # all four landed in ONE dispatch of one program, on both packages
    assert jc["serve.batch.dispatches"] == pc["serve.batch.dispatches"] == 1
    assert jc["serve.batch.jobs"] == pc["serve.batch.jobs"] == 4
    assert jc["compile.serve_batch.miss"] == pc["compile.serve_batch.miss"] \
        == 1
    assert jc == pc
    assert_kets(js, ps, [oracle(JAX, 0, j_qft(W))] * 4)


def test_program_cache_reused_across_sessions(no_prefix):
    """Two sessions, identical circuit shape -> one program built (miss)
    and one cache hit, even submitted sequentially."""
    def run(side):
        side.tele.enable()
        with svc(side) as s:
            s1 = s.create_session(W, seed=1)
            s2 = s.create_session(W, seed=2)
            s.apply(s1, side.qft(W), timeout=60)
            s.apply(s2, side.qft(W), timeout=60)
        return counters(side, "compile.serve_batch")

    jc, pc = both(run)
    assert pc["compile.serve_batch.miss"] == 1
    assert pc["compile.serve_batch.hit"] == 1
    assert jc == pc


def test_cobatching_never_reorders_a_tenants_stream():
    """The batcher must not steal a session's LATER circuit into a batch
    while an EARLIER job of the same session is still queued."""
    def run(side):
        gate = threading.Event()
        with svc(side, batch_window_ms=50.0, max_batch=2) as s:
            blocker = s.create_session(W, seed=9)
            s1 = s.create_session(W, seed=1, rand_global_phase=False)
            s2 = s.create_session(W, seed=2, rand_global_phase=False)
            hold = s.call(blocker, lambda eng: gate.wait(10))
            time.sleep(0.1)
            h1 = s.submit(s1, side.qft(W))
            h2a = s.call(s2, lambda eng: eng.X(0))
            h2b = s.submit(s2, side.qft(W))
            gate.set()
            for h in (hold, h1, h2a, h2b):
                h.result(60)
            return [s.get_state(s2, timeout=60)]

    j, p = both(run)
    assert_kets(j, p, [oracle(JAX, 2, j_qft(W), pre=lambda e: e.X(0))])


# ---------------------------------------------------------------------------
# admission control / backpressure
# ---------------------------------------------------------------------------

def test_queue_full_is_typed_and_synchronous():
    def run(side):
        gate = threading.Event()
        with svc(side, "cpu", max_depth=2) as s:
            sid = s.create_session(W, seed=0)
            hold = s.call(sid, lambda eng: gate.wait(10))
            time.sleep(0.1)
            keep = [s.call(sid, lambda eng: None) for _ in range(2)]
            with pytest.raises(side.errors.QueueFull) as ei:
                s.call(sid, lambda eng: None)
            gate.set()
            for h in [hold] + keep:
                h.result(30)
        return (ei.value.depth, ei.value.max_depth)

    j, p = both(run)
    assert j == p == (2, 2)


def test_priority_orders_dispatch():
    def run(side):
        gate = threading.Event()
        order = []
        with svc(side, "cpu", max_depth=16) as s:
            s1 = s.create_session(W, seed=1)
            s2 = s.create_session(W, seed=2)
            blocker = s.create_session(W, seed=3)
            hold = s.call(blocker, lambda eng: gate.wait(10))
            time.sleep(0.1)
            lo = s.call(s1, lambda eng: order.append("lo"), priority=0)
            hi = s.call(s2, lambda eng: order.append("hi"), priority=5)
            gate.set()
            for h in (hold, lo, hi):
                h.result(30)
        return order

    j, p = both(run)
    assert j == p == ["hi", "lo"]


def test_queue_budget_expires_stale_jobs():
    def run(side):
        gate = threading.Event()
        with svc(side, "cpu", queue_budget_ms=50.0) as s:
            sid = s.create_session(W, seed=0)
            hold = s.call(sid, lambda eng: gate.wait(10))
            time.sleep(0.1)
            stale = s.call(sid, lambda eng: None)
            time.sleep(0.2)
            gate.set()
            hold.result(30)
            with pytest.raises(side.errors.QueueBudgetExceeded) as ei:
                stale.result(30)
        return ei.value.budget_s

    j, p = both(run)
    assert j == p == pytest.approx(0.05)


def test_session_lifecycle_errors():
    def run(side):
        with svc(side, "cpu") as s:
            with pytest.raises(side.errors.SessionNotFound):
                s.submit("s999999", side.qft(W))
            sid = s.create_session(W, seed=0)
            s.destroy_session(sid)
            with pytest.raises(side.errors.SessionNotFound) as ei:
                s.submit(sid, side.qft(W))
        return ei.value.session_id

    j, p = both(run)
    assert j == p == "s000001"


def test_stop_drains_queued_jobs_typed():
    def run(side):
        gate = threading.Event()
        s = svc(side, "cpu")
        try:
            sid = s.create_session(W, seed=0)
            hold = s.call(sid, lambda eng: gate.wait(10))
            time.sleep(0.1)
            queued = s.call(sid, lambda eng: None)
        finally:
            # close() drains the queue at once, then joins the executor,
            # which the hold releases shortly after (bounding the join)
            threading.Timer(0.3, gate.set).start()
            s.close()
        gate.set()
        with pytest.raises(side.errors.ServiceStopped):
            queued.result(30)
        with pytest.raises(side.errors.ServiceStopped):
            s.call(sid, lambda eng: None)
        hold.result(30)
        return True

    assert both(run) == (True, True)


def test_idle_sessions_evicted():
    def run(side):
        with svc(side, "cpu", idle_evict_s=0.05, tick_s=0.02) as s:
            sid = s.create_session(W, seed=0)
            assert sid in s.sessions.ids()
            deadline = time.monotonic() + 5.0
            while sid in s.sessions.ids() and time.monotonic() < deadline:
                time.sleep(0.02)
            return sid in s.sessions.ids()

    assert both(run) == (False, False)


# ---------------------------------------------------------------------------
# load shedding + failover
# ---------------------------------------------------------------------------

def test_breaker_open_sheds_tunnel_jobs_and_failover_recovers():
    def run(side):
        side.res.reset_breaker(side.Breaker(threshold=2, cooldown_s=60.0))
        fo = {"failover_cpu": True} if side is PORT else {}
        with svc(side) as s:
            hurt = s.create_session(W, seed=1, rand_global_phase=False, **fo)
            bystander = s.create_session(W, seed=2,
                                         rand_global_phase=False)
            side.faults.inject("serve.dispatch", "raise", times=None)
            s.submit(hurt, side.qft(W)).result(60)
            assert side.res.get_breaker().snapshot()["state"] == "open"
            stats = {x["sid"]: x for x in s.sessions.stats()}
            with pytest.raises(side.errors.LoadShed) as exc:
                s.submit(bystander, side.qft(W))
            assert exc.value.retry_in_s > 0
            s.apply(hurt, side.qft(W), timeout=60)
            state = s.get_state(hurt, timeout=60)
        return state, stats[hurt]["failovers"], stats[hurt]["engine"]

    (js, jf, je), (ps, pf, pe) = both(run)
    assert jf == pf == 1
    assert je == pe == "QEngineCPU"
    assert_kets([js], [ps], [oracle(JAX, 1, j_qft(W), j_qft(W))])


def test_breaker_open_without_cpu_rung_fails_the_job_typed():
    """The port's failover rule: without ``failover_cpu`` the chain of a
    dense session ends on the card, so the job fails with the cause and
    the session keeps its pre-batch ket on its QEngineCUDA."""
    tres.reset_breaker(TBreaker(threshold=2, cooldown_s=60.0))
    with svc(PORT) as s:
        sid = s.create_session(W, seed=1, rand_global_phase=False)
        s.call(sid, lambda e: e.H(0)).result(60)
        tfaults.inject("serve.dispatch", "raise", times=None)
        with pytest.raises(tres.FAILOVER_ERRORS):
            s.apply(sid, t_qft(W), timeout=60)
        tfaults.clear()
        tres.reset_breaker()
        stats = {x["sid"]: x for x in s.sessions.stats()}
        state = s.get_state(sid, timeout=60)
    assert stats[sid]["engine"] == "QEngineCUDA"
    assert stats[sid]["jobs_failed"] == 1
    assert fidelity(state, oracle(JAX, 1, pre=lambda e: e.H(0))) > 1 - FID_BAR


def test_sync_failure_failover_does_not_double_apply():
    """When the batch dispatch lands but the honest sync escalates, the
    engines roll back to the pre-batch planes before the replay, so the
    circuit applies once."""
    def run(side):
        side.res.reset_breaker(side.Breaker(threshold=100, cooldown_s=0.0))
        fo = {"failover_cpu": True} if side is PORT else {}
        with svc(side) as s:
            sid = s.create_session(W, seed=4, rand_global_phase=False, **fo)
            side.faults.inject("serve.device_get", "device-loss",
                               times=None)
            s.apply(sid, side.qft(W), timeout=60)
            side.faults.clear()
            return [s.get_state(sid, timeout=60)]

    j, p = both(run)
    assert_kets(j, p, [oracle(JAX, 4, j_qft(W))])


# ---------------------------------------------------------------------------
# elastic capacity: degraded serving + drain/adopt
# ---------------------------------------------------------------------------

def test_elastic_pager_serves_degraded_then_reexpands(monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", "1")
    Wp = 5

    def run(side):
        side.tele.enable()
        with svc(side, "pager", n_pages=4) as s:
            sid = s.create_session(Wp, seed=3, rand_global_phase=False)
            s.call(sid, lambda e: e.H(0)).result(60)
            side.faults.inject("pager.exchange", "device-loss", times=None)
            s.call(sid, lambda e: e.H(4)).result(60)
            info1 = s.call(sid, lambda e: (e.n_pages, bool(
                e.elastic_degraded))).result(60)
            s.call(sid, lambda e: e.CNOT(0, 1)).result(60)
            s.call(sid, lambda e: e.T(1)).result(60)
            side.faults.clear()
            info2 = s.call(sid, lambda e: (e.n_pages, bool(
                e.elastic_degraded))).result(60)
            state = s.get_state(sid, timeout=60)
        snap = side.tele.snapshot()
        return (state, info1, info2,
                {k: snap["counters"][k] for k in ("elastic.repage.shrink",
                                                  "elastic.repage.expand")},
                snap["gauges"]["elastic.pages"])

    j, p = both(run)
    assert j[1:] == p[1:] == ((1, True), (4, False),
                              {"elastic.repage.shrink": 2,
                               "elastic.repage.expand": 1}, 4)

    def pre(e):
        e.H(0)
        e.H(4)
        e.CNOT(0, 1)
        e.T(1)
    assert_kets([j[0]], [p[0]], [oracle(JAX, 3, width=Wp, pre=pre)])


def test_drain_handoff_adopted_by_second_service(tmp_path):
    def run(side):
        ck = str(tmp_path / side.name / "ck")
        a = svc(side, "cpu", checkpoint_dir=ck)
        try:
            sid = a.create_session(W, seed=5, rand_global_phase=False)
            a.apply(sid, side.qft(W), timeout=60)
            assert a.stats()["lease"]["held"]
            out = a.drain()
            assert out == {"drained": [sid], "busy": []}
            assert sid not in a.sessions.ids()
            assert not a.lease_held
            with pytest.raises(side.errors.SessionNotFound):
                a.get_state(sid, timeout=60)
            with svc(side, "cpu", checkpoint_dir=ck, recover=True) as b:
                assert b.lease_held
                adopted = [x["sid"] for x in b.stats()["sessions"]]
                state = b.get_state(sid, timeout=60)
        finally:
            a.close()
        return state, adopted == [sid]

    (js, ja), (ps, pa) = both(run)
    assert ja and pa
    assert_kets([js], [ps], [oracle(JAX, 5, j_qft(W))])


def test_recover_refused_while_peer_holds_lease(tmp_path):
    from qrack_tpu.checkpoint import StoreLeaseHeld as JHeld
    from qrack_tpu_torch.checkpoint import StoreLeaseHeld as THeld

    def run(side):
        held = JHeld if side is JAX else THeld
        ck = str(tmp_path / side.name / "ck")
        threads = threading.active_count()
        with svc(side, "cpu", checkpoint_dir=ck) as a:
            sid = a.create_session(W, seed=1)
            with pytest.raises(held) as exc:
                svc(side, "cpu", checkpoint_dir=ck, recover=True)
            assert "drain or stop" in str(exc.value)
            assert a.drain() == {"drained": [sid], "busy": []}
            with svc(side, "cpu", checkpoint_dir=ck, recover=True) as b:
                adopted = sid in b.sessions.ids()
        # the refused service leaked no executor thread
        deadline = time.monotonic() + 5.0
        while (threading.active_count() > threads
               and time.monotonic() < deadline):
            time.sleep(0.02)
        return adopted, threading.active_count() <= threads

    assert both(run) == ((True, True), (True, True))


# ---------------------------------------------------------------------------
# fault-spec parse-time validation
# ---------------------------------------------------------------------------

def test_fault_spec_unknown_site_rejected_listing_valid():
    for side, engine_site in ((JAX, "tpu.compile"), (PORT, "cuda.compile")):
        f = side.faults
        with pytest.raises(ValueError) as exc:
            f.parse_spec("sreve.dispatch:raise:0")
        msg = str(exc.value)
        assert "serve.dispatch" in msg and engine_site in msg
        with pytest.raises(ValueError):
            f.load_env("serve.dispatch:raise:0,bogus.site:raise:0")
        assert f.parse_spec("serve.dispatch:raise:0").site == \
            "serve.dispatch"
        assert f.parse_spec("serve.device_get:timeout:1+").times is None
        assert f.parse_spec("prefix.materialize:amp-corrupt:0").site == \
            "prefix.materialize"
        f.clear()


def test_fault_spec_bad_counts_rejected_with_grammar():
    for side in SIDES:
        with pytest.raises(ValueError) as exc:
            side.faults.parse_spec("serve.dispatch:raise:soon")
        assert "after_n" in str(exc.value)
        with pytest.raises(ValueError):
            side.faults.parse_spec("serve.dispatch:raise:0:notaseed")


# ---------------------------------------------------------------------------
# the port's own: the fold, its key, its lane groups, the device rule
# ---------------------------------------------------------------------------

def test_by_design_lists_every_difference():
    assert set(BY_DESIGN) == {
        "cuda_terminal", "folded_batch", "key_dtype_device", "cow_at_seed",
        "kernel_cache", "item_sync", "batch_pad_0", "canary_card_strike",
        "replay_in_place"}


@pytest.mark.parametrize("cap", [30, W + 1, W])
def test_fold_lane_groups_under_the_width_cap(cap, monkeypatch):
    """A batch whose fold would pass MAX_DENSE_QB runs in groups of
    2^(cap - n) lanes, one fold each; every lane equals its solo run,
    and no session's planes are written by the batch."""
    monkeypatch.setattr(tbatcher, "MAX_DENSE_QB", cap)
    circ = t_qft(W)
    gen = np.random.Generator(np.random.PCG64(11))
    lanes, before = [], []
    for _ in range(5):
        v = gen.normal(size=(2, 1 << W)).astype(np.float32)
        v /= np.sqrt((v.astype(np.float64) ** 2).sum())
        t = torch.from_numpy(v)
        lanes.append(t)
        before.append(t.clone())
    prog = tbatcher.FoldProgram(circ, W, torch.float32, "cpu")
    groups = tbatcher.group_lanes(W, 5)
    assert groups == {30: [5], W + 1: [2, 2, 1], W: [1] * 5}[cap]
    out = prog(lanes)
    assert len(out) == 5
    for i in range(5):
        assert torch.equal(lanes[i], before[i])
        assert out[i].is_contiguous() and out[i].shape == (2, 1 << W)
        solo = before[i].clone()
        circ.compile_fn_pallas(W)(solo)
        assert torch.allclose(out[i], solo, atol=1e-6)
    assert prog.planned_sweeps(5) == sum(prog.sweeps(g) for g in groups)


def test_fold_runs_the_window_kernel_once_per_planned_sweep(monkeypatch):
    """The fold's launches: one sweep call per planned sweep of the fold
    (counted at the plain version here), not one per lane."""
    from qrack_tpu_torch.ops import window_kernel as wk

    calls = []
    for name in ("in_tile_sweep_plain", "pair_sweep_plain"):
        orig = getattr(wk, name)
        monkeypatch.setattr(wk, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    monkeypatch.setattr(wk, "DEFAULT_BLOCK_POW", 4)
    circ = t_qft(W)
    prog = tbatcher.FoldProgram(circ, W, torch.float32, "cpu", block_pow=4)
    planes = [torch.zeros(2, 1 << W) for _ in range(4)]
    for p in planes:
        p[0, 0] = 1.0
    prog(planes)
    assert len(calls) == prog.sweeps(4) == prog.planned_sweeps(4)
    assert "pair_sweep_plain" in calls   # qubits above the tile


def test_batch_key_carries_dtype_and_device(no_prefix):
    """Sessions of one circuit in float32 and float64 never co-batch:
    the key carries the planes' dtype; each group is one dispatch."""
    ttele.enable()
    with svc(PORT, batch_window_ms=300.0, max_batch=4) as s:
        a = [s.create_session(W, seed=k, rand_global_phase=False)
             for k in range(2)]
        b = [s.create_session(W, seed=k, rand_global_phase=False,
                              dtype=torch.float64) for k in range(2)]
        hs = [s.submit(sid, t_qft(W)) for sid in a + b]
        for h in hs:
            h.result(60)
        keys = {s.sessions.get(sid).engine.dtype for sid in a + b}
        states = [s.get_state(sid, timeout=60) for sid in a + b]
    c = counters(PORT, "serve.batch.", "compile.serve_batch")
    assert keys == {torch.float32, torch.float64}
    assert c["serve.batch.dispatches"] == 2
    assert c["compile.serve_batch.miss"] == 2
    want = oracle(JAX, 0, j_qft(W))
    for st in states:
        assert fidelity(want, st) > 1 - FID_BAR
    progs = tbatcher._PROGRAMS._od
    assert {k[2] for k in progs} == {"torch.float32", "torch.float64"}
    assert {k[3] for k in progs} == {"cpu"}


def test_batch_pad_off_keys_exact_sizes(no_prefix, monkeypatch):
    """QRACK_SERVE_BATCH_PAD=0: three jobs key a 3-lane program on both
    packages (the default buckets it to 4; the fold pads either way)."""
    monkeypatch.setenv("QRACK_SERVE_BATCH_PAD", "0")

    def run(side):
        side.tele.enable()
        with svc(side, batch_window_ms=300.0, max_batch=3) as s:
            sids = [s.create_session(W, seed=k, rand_global_phase=False)
                    for k in range(3)]
            for h in [s.submit(sid, side.qft(W)) for sid in sids]:
                h.result(60)
            states = [s.get_state(sid, timeout=60) for sid in sids]
        return states, sorted(k[1] for k in side.batcher._PROGRAMS._od)

    (js, jk), (ps, pk) = both(run)
    assert jk == pk == [3]
    assert_kets(js, ps)
