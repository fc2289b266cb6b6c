"""The port's prefix-sharing ket cache (qrack_tpu_torch/serve/
prefix_cache.py) against the JAX package's: the counterparts of the 11
tests of tests/test_prefix_cache.py, plus the port's copy-on-write case.

Parity: the same tenants (a shared state-prep and per-tenant tails, the
JAX tests' circuits) through both caches and services; the served kets
agree with each other and with the complex128 oracle at fidelity > 1 -
1e-6, the serve.prefix.* counters are equal, and cache entries hold
the same prefix state.  Copy-on-write differs by design
(tests/test_torch_serve.py BY_DESIGN ``cow_at_seed``): the port's
engine takes its own copy of the entry at seed time, so the JAX tests'
``planes_pinned`` checks become checks that no engine shares the
entry's storage and that the entry's fingerprint never moves.

``test_corrupted_spill_is_evicted_never_served`` fails in
tests/test_prefix_cache.py on the seed: its last step expects no plan
at all for the next tenant, but with ``min_refs=1`` the evicted prefix
is a popular miss again, and ``plan`` answers ``("insert", 39, ...)``.
The counterpart here holds what the step is for, on both packages: the
corrupted entry is never served again (no ``"hit"``).
"""

import glob
import importlib.util
import os
import pathlib

import numpy as np
import pytest

from qrack_tpu.checkpoint.store import CheckpointStore as JStore
from qrack_tpu.factory import create_quantum_interface as j_create
from qrack_tpu.serve import prefix_cache as jpc

from qrack_tpu_torch.checkpoint.store import CheckpointStore as TStore
from qrack_tpu_torch.factory import create_quantum_interface as t_create
from qrack_tpu_torch.serve import prefix_cache as tpc

from test_torch_serve import (JAX, PORT, W, _clean_serve,  # noqa: F401
                              counters, fidelity, svc)
from test_torch_serve import both as _both


@pytest.fixture(autouse=True)
def _telemetry(_clean_serve):
    PORT.tele.enable()
    yield


def both(run):
    """tests/test_torch_serve.py ``both``, with telemetry on each side."""
    return _both(lambda side: (side.tele.enable(), run(side))[1])


def _ry(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2.0), np.sin(theta / 2.0)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def _ring(side, circ, width: int = W) -> None:
    for q in range(width - 1):
        circ.append_ctrl((q,), q + 1, side.mat.X2, 1)


def _prep(side, width: int = W, seed: int = 7):
    circ = side.Circuit()
    rng = np.random.default_rng(seed)
    for q in range(width):
        circ.append_1q(q, side.mat.H2)
    for _ in range(2):
        _ring(side, circ, width)
        for q in range(width):
            circ.append_1q(q, _ry(rng.uniform(0.0, 2.0 * np.pi)))
    return circ


def _tenant(side, tail_seed: int, width: int = W, prep_seed: int = 7):
    circ = _prep(side, width, prep_seed)
    _ring(side, circ, width)
    rng = np.random.default_rng(tail_seed)
    for q in range(width):
        circ.append_1q(q, _ry(rng.uniform(0.0, 2.0 * np.pi)))
    return circ


def _shared_k(width: int = W) -> int:
    return len(_prep(JAX, width).gates) + (width - 1)


def _oracle_state(circ, width: int = W, seed: int = 0):
    eng = JAX.CPU(width, rng=JAX.R(seed), rand_global_phase=False)
    circ.Run(eng)
    return eng.GetQuantumState()


def _ket(side, planes) -> np.ndarray:
    if side is JAX:
        import jax

        host = np.asarray(jax.device_get(planes), dtype=np.float64)
    else:
        host = planes.detach().cpu().double().numpy()
    return host[0] + 1j * host[1]


def _pc(side):
    return jpc if side is JAX else tpc


def _engine_with(side, circ):
    """A planes engine after `circ`, and a copy of its planes for an
    insert (the JAX package's planes are immutable; the port hands the
    cache a copy it owns, as the executor does)."""
    if side is JAX:
        eng = j_create("tpu", W)
        circ.Run(eng)
        return eng, eng.device_planes
    eng = t_create("cuda", W, device="cpu")
    circ.Run(eng)
    return eng, eng.device_planes.clone()


def _host(side, planes):
    if side is JAX:
        import jax

        return np.asarray(jax.device_get(planes))
    return tpc.host_planes(planes)


# ---------------------------------------------------------------------------
# cache unit level: plan / insert / hit / acquire
# ---------------------------------------------------------------------------

def test_plan_miss_then_popular_insert_then_hit():
    def run(side):
        cache = _pc(side).PrefixCache(min_refs=2, min_gates=4)
        k = _shared_k()
        assert cache.plan(_tenant(side, 1), W) is None
        kind, depth, digest = cache.plan(_tenant(side, 2), W)
        assert (kind, depth) == ("insert", k)
        assert digest == _tenant(side, 3).prefix_digest(k)
        pre, _suf = _tenant(side, 2).split_at(k)
        eng, planes = _engine_with(side, pre)
        entry = cache.insert(digest, W, "dense", k, planes)
        assert entry is not None
        if side is PORT:
            # the cache owns its copy: no engine shares its storage
            assert entry.planes.data_ptr() != \
                eng.device_planes.data_ptr()
        kind2, depth2, got = cache.plan(_tenant(side, 3), W)
        assert (kind2, depth2) == ("hit", k) and got is entry
        assert cache.stats()["entries"] == 1
        return (_ket(side, cache.acquire(entry)), digest,
                counters(side, "serve.prefix."))

    (jk, jd, jc), (pk, pd, pc) = both(run)
    assert jd == pd
    assert jc == pc
    assert pc["serve.prefix.hit"] == 1
    assert pc["serve.prefix.hit_depth"] == _shared_k()
    assert pc["serve.prefix.miss"] == 2
    want = _oracle_state(_tenant(JAX, 2).split_at(_shared_k())[0])
    assert fidelity(jk, pk) > 1 - 1e-6 and fidelity(want, pk) > 1 - 1e-6


def test_insert_rejects_invalid_norm():
    def run(side):
        cache = _pc(side).PrefixCache(min_refs=1, min_gates=4)
        _eng, planes = _engine_with(side, _prep(side))
        bad = 1.5 * planes
        assert cache.insert("d" * 40, W, "dense", 8, bad) is None
        assert cache.stats()["entries"] == 0
        return counters(side, "serve.prefix.")

    j, p = both(run)
    assert j == p == {"serve.prefix.corrupt": 1}


def test_evict_spills_and_faults_back_in_verified(tmp_path):
    def run(side):
        store = (JStore if side is JAX else TStore)(
            str(tmp_path / side.name))
        plane_bytes = 2 * (2 ** W) * 4
        cache = _pc(side).PrefixCache(max_bytes=plane_bytes + 8,
                                      store=store, min_refs=1, min_gates=4)
        pre_a, _ = _tenant(side, 1).split_at(_shared_k())
        pre_b, _ = _tenant(side, 1, prep_seed=8).split_at(_shared_k())
        planes = [_engine_with(side, pre)[1] for pre in (pre_a, pre_b)]
        e_a = cache.insert(pre_a.structure_digest(), W, "dense",
                           len(pre_a.gates), planes[0])
        e_b = cache.insert(pre_b.structure_digest(), W, "dense",
                           len(pre_b.gates), planes[1])
        assert e_b.planes is not None
        assert e_a.planes is None and e_a.spilled
        got = cache.acquire(e_a)
        assert got is not None
        cnt = counters(side, "serve.prefix.")
        return _ket(side, got), cnt["serve.prefix.spill"] >= 1, \
            cnt["serve.prefix.faultin"]

    (jk, *jr), (pk, *pr) = both(run)
    assert jr == pr == [True, 1]
    want = _oracle_state(_tenant(JAX, 1).split_at(_shared_k())[0])
    assert fidelity(jk, pk) > 1 - 1e-6 and fidelity(want, pk) > 1 - 1e-6


def test_corrupted_spill_is_evicted_never_served(tmp_path):
    def run(side):
        root = tmp_path / side.name
        store = (JStore if side is JAX else TStore)(str(root))
        cache = _pc(side).PrefixCache(store=store, min_refs=1, min_gates=4)
        pre, _ = _tenant(side, 1).split_at(_shared_k())
        _eng, planes = _engine_with(side, pre)
        entry = cache.insert(pre.structure_digest(), W, "dense",
                             len(pre.gates), planes)
        cache.evict_all(spill=True)
        assert entry.planes is None
        files = glob.glob(str(root / "**" / "*"), recursive=True)
        target = [f for f in files
                  if os.path.isfile(f) and "prefix" in f.lower()]
        assert target, files
        with open(target[0], "r+b") as fh:
            fh.seek(os.path.getsize(target[0]) // 2)
            fh.write(b"\xff" * 16)
        assert cache.acquire(entry) is None      # detected, not served
        assert cache.stats()["entries"] == 0     # evicted on the spot
        plan = cache.plan(_tenant(side, 2), W)   # never served twice
        cnt = counters(side, "serve.prefix.")
        return (plan is None or plan[0] != "hit",
                cnt.get("serve.prefix.corrupt", 0)
                + cnt.get("serve.prefix.lost", 0) >= 1)

    assert both(run) == ((True, True), (True, True))


# ---------------------------------------------------------------------------
# service level: admission split end-to-end on the real executor
# ---------------------------------------------------------------------------

def test_service_share_miss_insert_hit_oracle_exact():
    def run(side):
        with svc(side) as s:
            assert s.prefix_cache is not None
            states = []
            for t in range(4):
                sid = s.create_session(W, seed=t, rand_global_phase=False)
                s.submit(sid, _tenant(side, t)).result(60)
                states.append(s.get_state(sid, timeout=60))
            pstats = s.stats()["prefix_cache"]
        return states, pstats, counters(side, "serve.prefix.")

    (js, jst, jc), (ps, pst, pc) = both(run)
    assert pst["entries"] == 1 and pst["hits"] >= 2
    assert {k: jst[k] for k in ("entries", "resident", "hits")} == \
        {k: pst[k] for k in ("entries", "resident", "hits")}
    assert pc["serve.prefix.miss"] == 2
    assert pc["serve.prefix.insert"] == 1
    assert pc["serve.prefix.hit"] == 2
    assert pc["serve.prefix.hit_depth"] == 2 * _shared_k()
    assert pc.pop("serve.prefix.cow") == 2     # one copy a hit
    jc.pop("serve.prefix.cow", None)
    assert jc == pc
    for t in range(4):
        want = _oracle_state(_tenant(JAX, t))
        assert fidelity(want, ps[t]) > 1 - 1e-6
        assert fidelity(js[t], ps[t]) > 1 - 1e-6


def test_nonpristine_session_never_splits():
    def run(side):
        with svc(side) as s:
            for t in range(2):
                sid = s.create_session(W, seed=t, rand_global_phase=False)
                s.submit(sid, _tenant(side, t)).result(60)
            sid = s.create_session(W, seed=9, rand_global_phase=False)
            s.submit(sid, _tenant(side, 9)).result(60)
            hits = side.tele.snapshot()["counters"]["serve.prefix.hit"]
            s.submit(sid, _tenant(side, 10)).result(60)
            state = s.get_state(sid, timeout=60)
            again = side.tele.snapshot()["counters"]["serve.prefix.hit"]
        return state, hits == again

    (js, jr), (ps, pr) = both(run)
    assert jr and pr
    eng = JAX.CPU(W, rng=JAX.R(9), rand_global_phase=False)
    _tenant(JAX, 9).Run(eng)
    _tenant(JAX, 10).Run(eng)
    assert fidelity(eng.GetQuantumState(), ps) > 1 - 1e-6
    assert fidelity(js, ps) > 1 - 1e-6


def test_cache_hit_failover_rollback_keeps_entry_bit_identical():
    def run(side):
        side.res.reset_breaker(side.Breaker(threshold=100, cooldown_s=0.0))
        fo = {"failover_cpu": True} if side is PORT else {}
        with svc(side) as s:
            for t in range(2):
                sid = s.create_session(W, seed=t, rand_global_phase=False)
                s.submit(sid, _tenant(side, t)).result(60)
            entry = next(iter(s.prefix_cache._entries.values()))
            want = entry.fingerprint
            side.faults.inject("serve.device_get", "device-loss", times=1)
            sid = s.create_session(W, seed=5, rand_global_phase=False, **fo)
            s.submit(sid, _tenant(side, 5)).result(60)
            state = s.get_state(sid, timeout=60)
            assert entry.planes is not None
            same = _pc(side).fingerprint_host(
                _host(side, entry.planes)) == want
        return state, same

    (js, jr), (ps, pr) = both(run)
    assert jr and pr
    want = _oracle_state(_tenant(JAX, 5))
    assert fidelity(want, ps) > 1 - 1e-6 and fidelity(js, ps) > 1 - 1e-6


def test_materialize_amp_corrupt_detected_never_admitted():
    def run(side):
        side.faults.inject("prefix.materialize", "amp-corrupt", times=None)
        with svc(side) as s:
            states = []
            for t in range(3):
                sid = s.create_session(W, seed=t, rand_global_phase=False)
                s.submit(sid, _tenant(side, t)).result(60)
                states.append(s.get_state(sid, timeout=60))
            entries = s.stats()["prefix_cache"]["entries"]
        cnt = counters(side, "serve.prefix.")
        return states, entries, cnt["serve.prefix.corrupt"] >= 1, \
            cnt.get("serve.prefix.hit", 0)

    (js, *jr), (ps, *pr) = both(run)
    assert jr == pr == [0, True, 0]
    for t in range(3):
        want = _oracle_state(_tenant(JAX, t))
        assert fidelity(want, ps[t]) > 1 - 1e-6
        assert fidelity(js[t], ps[t]) > 1 - 1e-6


def test_prefix_kill_switch_restores_pre_cache_behavior(monkeypatch):
    monkeypatch.setenv("QRACK_SERVE_PREFIX", "0")

    def run(side):
        with svc(side) as s:
            assert s.prefix_cache is None
            assert "prefix_cache" not in s.stats()
            states = []
            for t in range(3):
                sid = s.create_session(W, seed=t, rand_global_phase=False)
                s.submit(sid, _tenant(side, t)).result(60)
                states.append(s.get_state(sid, timeout=60))
        return states, counters(side, "serve.prefix.")

    (js, jc), (ps, pc) = both(run)
    assert jc == pc == {}
    for t in range(3):
        want = _oracle_state(_tenant(JAX, t))
        assert fidelity(want, ps[t]) > 1 - 1e-6
        assert fidelity(js[t], ps[t]) > 1 - 1e-6


def test_recover_rebuilds_service_with_warm_prefix_cache(tmp_path):
    def run(side):
        ck = str(tmp_path / side.name / "ck")
        with svc(side, checkpoint_dir=ck) as s:
            for t in range(3):
                sid = s.create_session(W, seed=t, rand_global_phase=False)
                s.submit(sid, _tenant(side, t)).result(60)
            assert s.stats()["prefix_cache"]["entries"] == 1
        side.tele.reset()
        with svc(side, checkpoint_dir=ck, recover=True) as s2:
            pstats = s2.stats()["prefix_cache"]
            spilled = (pstats["entries"], pstats["spilled"])
            sid = s2.create_session(W, seed=7, rand_global_phase=False)
            s2.submit(sid, _tenant(side, 7)).result(60)
            state = s2.get_state(sid, timeout=60)
            resident = s2.stats()["prefix_cache"]["resident"]
        cnt = counters(side, "serve.prefix.")
        return state, spilled, resident, cnt["serve.prefix.faultin"], \
            cnt["serve.prefix.hit"]

    (js, *jr), (ps, *pr) = both(run)
    assert jr == pr == [(1, 1), 1, 1, 1]
    want = _oracle_state(_tenant(JAX, 7))
    assert fidelity(want, ps) > 1 - 1e-6 and fidelity(js, ps) > 1 - 1e-6


# ---------------------------------------------------------------------------
# telemetry report: the == prefix == section, from the port's telemetry
# ---------------------------------------------------------------------------

def test_telemetry_report_prefix_section(tmp_path, capsys):
    """The JAX package's report tool reads the port's telemetry file: the
    same names, the same == prefix == section."""
    tele = PORT.tele
    tele.inc("serve.prefix.hit", 6)
    tele.inc("serve.prefix.miss", 2)
    tele.inc("serve.prefix.hit_depth", 60)
    tele.inc("serve.prefix.insert", 1)
    tele.inc("serve.prefix.evict", 1)
    tele.inc("serve.prefix.spill", 1)
    tele.gauge("serve.prefix.bytes", 4096)
    tele.inc("serve.batch.dispatches", 3)
    out = tmp_path / "t.jsonl"
    tele.write_jsonl(str(out))
    tele.reset()

    path = (pathlib.Path(__file__).resolve().parent.parent
            / "scripts" / "telemetry_report.py")
    spec = importlib.util.spec_from_file_location("telemetry_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rep = mod.report(mod.load(str(out), aggregate=False), top=5)
    pf = rep["prefix"]
    assert pf["serve.prefix.hit"] == 6
    assert pf["hit_rate"] == 0.75
    assert pf["mean_hit_depth"] == 10.0
    assert pf["serve.prefix.bytes"] == 4096
    assert not any(k.startswith("serve.prefix.") for k in rep["serve"])
    assert mod.main([str(out)]) == 0
    assert "== prefix ==" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the port's own: copy-on-write by copy at seed
# ---------------------------------------------------------------------------

def test_seeded_tenant_in_place_suffix_leaves_entry_and_sibling():
    """Two tenants seeded from one entry run their suffixes in place on
    their own copies: the entry's fingerprint never moves, no engine
    shares its storage, and each tenant (the sibling included) lands on
    its oracle ket."""
    with svc(PORT, max_batch=1) as s:
        for t in range(2):                       # miss, then insert
            sid = s.create_session(W, seed=t, rand_global_phase=False)
            s.submit(sid, _tenant(PORT, t)).result(60)
        entry = next(iter(s.prefix_cache._entries.values()))
        want = entry.fingerprint
        ptr = entry.planes.data_ptr()
        seeded = {}
        for t in (5, 6):
            sid = s.create_session(W, seed=t, rand_global_phase=False)
            s.submit(sid, _tenant(PORT, t)).result(60)
            seeded[t] = sid
        engines = [s.sessions.get(sid).engine for sid in seeded.values()]
        ptrs = {e.device_planes.data_ptr() for e in engines}
        # a third in-place pass on one tenant after the other was seeded
        s.call(seeded[5], lambda e: e.H(0)).result(60)
        states = {t: s.get_state(sid, timeout=60)
                  for t, sid in seeded.items()}
        assert entry.planes.data_ptr() == ptr
        assert tpc.fingerprint_host(tpc.host_planes(entry.planes)) == want
    assert ptr not in ptrs and len(ptrs) == 2
    cnt = counters(PORT, "serve.prefix.")
    assert cnt["serve.prefix.cow"] == cnt["serve.prefix.hit"] == 2
    eng5 = JAX.CPU(W, rng=JAX.R(5), rand_global_phase=False)
    _tenant(JAX, 5).Run(eng5)
    eng5.H(0)
    assert fidelity(eng5.GetQuantumState(), states[5]) > 1 - 1e-6
    assert fidelity(_oracle_state(_tenant(JAX, 6)), states[6]) > 1 - 1e-6
