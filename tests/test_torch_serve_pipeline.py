"""The port's continuous-batching pipeline against the JAX package's: the
counterparts of the 7 tests of tests/test_serve_pipeline.py, with their
parameters (submit-then-sync double buffering, in-flight batch joining,
aged-priority fairness, the exactly-once envelope with one batch in
flight and one staged, the canary under an amp-corrupt dispatch, and the
serial mode).  Parity as in tests/test_torch_serve.py: the same seeded
scenario on both services, the kets at fidelity > 1 - 1e-6 to each
other and to the JAX complex128 oracle, the same counters and decisions.

``test_inflight_join_matches_solo_submit`` and the four cases of
``test_pipelined_sync_fault_exactly_once`` fail in
tests/test_serve_pipeline.py on the seed: the prefix cache splits the
popular QFT and runs it as a singleton, so nothing is in flight to sync
or join.  Their counterparts set ``QRACK_SERVE_PREFIX=0`` on both sides
and pass on both packages.  The port's sessions of the faulted cases
pass ``failover_cpu=True``, as the JAX chain ends on QEngineCPU; the
port's own case without it replays the failed batch's jobs in place.
"""

import threading
import time
from collections import deque

import numpy as np
import pytest

from test_torch_serve import (JAX, PORT, W, _clean_serve,  # noqa: F401
                              _h_wall, assert_kets, both, counters,
                              fidelity, no_prefix, oracle, svc)


def _park(s, gate: threading.Event):
    """Park the executor on a blocker session so later submits queue up
    together; returns the hold handle."""
    blocker = s.create_session(W, seed=99)
    hold = s.call(blocker, lambda eng: gate.wait(10))
    time.sleep(0.1)
    return hold


def _fo(side) -> dict:
    return {"failover_cpu": True} if side is PORT else {}


# ---------------------------------------------------------------------------
# fairness: waited-time aging beats strict-priority starvation
# ---------------------------------------------------------------------------

def test_aging_prevents_priority_starvation():
    def run(side):
        stop = threading.Event()
        flood_err = []
        with svc(side, "cpu", max_depth=64, aging_s=0.1) as s:
            lo_s = s.create_session(W, seed=0)
            hi_s = s.create_session(W, seed=1)

            def flood():
                pending = deque()
                try:
                    while not stop.is_set():
                        while len(pending) < 6:
                            pending.append(s.call(
                                hi_s, lambda eng: time.sleep(0.002),
                                priority=1))
                        pending.popleft().result(30)
                    while pending:
                        pending.popleft().result(30)
                except BaseException as e:  # noqa: BLE001
                    flood_err.append(e)

            t = threading.Thread(target=flood, daemon=True)
            t.start()
            time.sleep(0.2)
            h = s.call(lo_s, lambda eng: None, priority=0)
            try:
                h.result(10)
            finally:
                stop.set()
                t.join(30)
            assert not flood_err, flood_err
            return h.latency_s < 10

    assert both(run) == (True, True)


def test_weighted_round_robin_within_band():
    def run(side):
        gate = threading.Event()
        order = []
        with svc(side, "cpu", max_depth=64, aging_s=0.0) as s:
            heavy = s.create_session(W, seed=1, weight=3.0)
            light = s.create_session(W, seed=2, weight=1.0)
            hold = _park(s, gate)
            hs = []
            for _ in range(8):
                hs.append(s.call(heavy, lambda eng: order.append("h")))
                hs.append(s.call(light, lambda eng: order.append("l")))
            gate.set()
            for h in [hold] + hs:
                h.result(30)
        return order

    j, p = both(run)
    assert j == p
    assert p[:8].count("h") == 6, p


def test_idle_eviction_under_sustained_load():
    def run(side):
        with svc(side, "cpu", idle_evict_s=0.05, tick_s=0.02) as s:
            idle = s.create_session(W, seed=0)
            busy = s.create_session(W, seed=1)
            pending = deque()
            deadline = time.monotonic() + 10.0
            evicted = False
            while time.monotonic() < deadline:
                while len(pending) < 4:
                    pending.append(s.call(busy, lambda eng: None))
                pending.popleft().result(30)
                if idle not in s.sessions.ids():
                    evicted = True
                    break
            while pending:
                pending.popleft().result(30)
            return evicted, busy in s.sessions.ids()

    assert both(run) == ((True, True), (True, True))


# ---------------------------------------------------------------------------
# in-flight batch joining
# ---------------------------------------------------------------------------

def test_inflight_join_matches_solo_submit(no_prefix, monkeypatch):
    def run(side):
        side.tele.enable()
        entered, release = threading.Event(), threading.Event()
        orig = side.batcher.sync_scalar
        calls = []

        def slow_sync(arr):
            calls.append(1)
            if len(calls) == 1:
                entered.set()
                release.wait(10)
            return orig(arr)

        monkeypatch.setattr(side.batcher, "sync_scalar", slow_sync)
        gate = threading.Event()
        wall = _h_wall(side)
        try:
            with svc(side, max_batch=8) as s:
                a, b, c, d = [s.create_session(W, seed=k,
                                               rand_global_phase=False)
                              for k in (1, 2, 3, 4)]
                hold = _park(s, gate)
                ha = s.submit(a, side.qft(W))
                hb = s.submit(b, wall)
                gate.set()
                assert entered.wait(30)
                hc = s.submit(c, wall)
                hd = s.submit(d, wall)
                release.set()
                for h in (hold, ha, hb, hc, hd):
                    h.result(60)
                states = [s.get_state(x, timeout=60) for x in (a, b, c, d)]
        finally:
            release.set()
            monkeypatch.setattr(side.batcher, "sync_scalar", orig)
        return states, counters(side, "serve.overlap.", "serve.batch.")

    (js, jc), (ps, pc) = both(run)
    for c in (jc, pc):
        assert c.get("serve.overlap.staged", 0) >= 1
        assert c.get("serve.overlap.join.jobs", 0) == 2
        assert c["serve.batch.dispatches"] == 2
        assert c["serve.batch.jobs"] == 4
    want = [oracle(JAX, 1, JAX.qft(W))] + [oracle(JAX, k, _h_wall(JAX))
                                           for k in (2, 3, 4)]
    assert_kets(js, ps, want)


# ---------------------------------------------------------------------------
# exactly-once with one batch in flight and one staged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 16])
@pytest.mark.parametrize("kind", ["timeout", "raise"])
def test_pipelined_sync_fault_exactly_once(kind, window, no_prefix,
                                           monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", str(window))

    def run(side):
        side.tele.enable()
        side.res.reset_breaker(side.Breaker(threshold=100, cooldown_s=0.0))
        gate = threading.Event()
        wall = _h_wall(side)
        with svc(side, max_batch=8) as s:
            a, b, c, d = [s.create_session(W, seed=k,
                                           rand_global_phase=False,
                                           **_fo(side))
                          for k in (1, 2, 3, 4)]
            hold = _park(s, gate)
            side.faults.inject("serve.device_get", kind, times=None)
            handles = [s.submit(a, side.qft(W)), s.submit(b, side.qft(W)),
                       s.submit(c, wall), s.submit(d, wall)]
            gate.set()
            for h in [hold] + handles:
                h.result(60)
            side.faults.clear()
            stats = {x["sid"]: x for x in s.sessions.stats()}
            states = [s.get_state(x, timeout=60) for x in (a, b, c, d)]
        per = [(stats[x]["failovers"] >= 1, stats[x]["jobs_completed"],
                stats[x]["jobs_failed"]) for x in (a, b, c, d)]
        return states, per, counters(side, "serve.overlap.",
                                     "serve.batch.failovers")

    (js, jp, jc), (ps, pp, pc) = both(run)
    assert jp == pp == [(True, 1, 0)] * 4
    for c in (jc, pc):
        assert c.get("serve.overlap.staged", 0) >= 1
        assert c.get("serve.batch.failovers", 0) >= 1
    assert jc == pc
    want = [oracle(JAX, k, JAX.qft(W)) for k in (1, 2)] + \
        [oracle(JAX, k, _h_wall(JAX)) for k in (3, 4)]
    assert_kets(js, ps, want)


@pytest.mark.parametrize("window", [1, 16])
def test_pipelined_amp_corrupt_detected_by_canary(window, monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", str(window))
    monkeypatch.setenv("QRACK_SERVE_CANARY_RATE", "1.0")

    def run(side):
        side.tele.enable()
        gate = threading.Event()
        wall = _h_wall(side)
        with svc(side, max_batch=8) as s:
            a, b, c = [s.create_session(W, seed=k, rand_global_phase=False)
                       for k in (1, 2, 3)]
            hold = _park(s, gate)
            side.faults.inject("serve.dispatch", "amp-corrupt", after_n=0,
                               times=1)
            handles = [s.submit(a, side.qft(W)), s.submit(b, side.qft(W)),
                       s.submit(c, wall)]
            gate.set()
            for h in [hold] + handles:
                h.result(60)
            s.canary.drain()
            state_c = s.get_state(c, timeout=60)
            fired = sum(sp.fired for sp in side.faults.specs())
        cnt = counters(side, "serve.overlap.", "integrity.canary.")
        return state_c, fired, cnt.get("serve.overlap.staged", 0) >= 1, \
            cnt.get("integrity.canary.mismatch", 0) >= 1

    (js, *jr), (ps, *pr) = both(run)
    assert jr == pr == [1, True, True]
    assert_kets([js], [ps], [oracle(JAX, 3, _h_wall(JAX))])


# ---------------------------------------------------------------------------
# mode equivalence: the serial loop is preserved under PIPELINE=0
# ---------------------------------------------------------------------------

def test_serial_mode_matches_pipelined_results():
    def run(side):
        results = {}
        for pipeline in (False, True):
            with svc(side, pipeline=pipeline) as s:
                sids = [s.create_session(W, seed=k,
                                         rand_global_phase=False)
                        for k in range(4)]
                for h in [s.submit(sid, side.qft(W)) for sid in sids]:
                    h.result(60)
                results[pipeline] = [np.asarray(s.get_state(sid,
                                                            timeout=60))
                                     for sid in sids]
            side.batcher.clear_programs()
        return results

    j, p = both(run)
    for r in (j, p):
        for st_serial, st_piped in zip(r[False], r[True]):
            assert fidelity(st_serial, st_piped) > 1 - 1e-9
    assert_kets(j[True], p[True], [oracle(JAX, 0, JAX.qft(W))] * 4)


@pytest.mark.parametrize("window", [1, 16])
def test_pipelined_sync_fault_replays_in_place_without_cpu_rung(
        window, no_prefix, monkeypatch):
    """The port's own chain end: dense sessions without the CPU rung
    whose in-flight batch's sync escalates once replay each job on its
    own engine as a one-lane batch (tests/test_torch_serve.py BY_DESIGN
    ``replay_in_place``), while the staged batch waits: every ket lands
    exactly once, on its QEngineCUDA."""
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", str(window))
    PORT.tele.enable()
    PORT.res.configure(max_retries=0, backoff_s=0.0, timeout_s=0.0)
    gate = threading.Event()
    wall = _h_wall(PORT)
    with svc(PORT, max_batch=8) as s:
        a, b, c, d = [s.create_session(W, seed=k, rand_global_phase=False)
                      for k in (1, 2, 3, 4)]
        hold = _park(s, gate)
        PORT.faults.inject("serve.device_get", "raise", after_n=0, times=1)
        handles = [s.submit(a, PORT.qft(W)), s.submit(b, PORT.qft(W)),
                   s.submit(c, wall), s.submit(d, wall)]
        gate.set()
        for h in [hold] + handles:
            h.result(60)
        stats = {x["sid"]: x for x in s.sessions.stats()}
        states = [s.get_state(x, timeout=60) for x in (a, b, c, d)]
    cnt = counters(PORT, "serve.")
    assert cnt["serve.batch.failovers"] == 1
    assert cnt["serve.batch.replay.in_place"] == 2
    assert cnt.get("serve.overlap.staged", 0) >= 1
    assert "serve.jobs.failed" not in cnt
    for x in (a, b, c, d):
        assert stats[x]["engine"] == "QEngineCUDA"
        assert stats[x]["jobs_completed"] == 1 and stats[x]["jobs_failed"] == 0
        assert stats[x]["failovers"] == 0
    want = [oracle(JAX, k, JAX.qft(W)) for k in (1, 2)] + \
        [oracle(JAX, k, _h_wall(JAX)) for k in (3, 4)]
    for w, p in zip(want, states):
        assert fidelity(w, p) > 1 - 1e-6
