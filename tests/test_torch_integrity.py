"""The port's integrity guard plane (qrack_tpu_torch/resilience/
integrity.py) against the JAX package's: the counterparts of
tests/test_integrity.py's detector units, its detect-and-repair matrix
(``tpu`` -> ``cuda``, the port's pager on 4 CPU pages), its page-pinned
attribution and quarantine-feeds-elastic cases, and a short seeded soak
in the manner of its soak (scripts/integrity_soak.py).  Parity as in
tests/test_torch_resilience.py: the same seeded ops and fault spec on
both packages, the final kets at fidelity > 1 - 1e-6 to each other and
to the CPU oracle, the resilience-family counters and events name for
name after the ``tpu`` -> ``cuda`` rename, but for BY_DESIGN.

The serving plane's pre-dispatch shed and canary tests run one service
of each package (the port's dense sessions on the CPU).
``test_persist_rejects_poisoned_snapshot`` is held with the rest of the
failover snapshot file in tests/test_torch_checkpoint.py.

Engines are built AFTER the plane is armed: the forced window-1 fuser
(the repair envelope for eager dispatch) only builds when the layer is
up at construction time.  Fuser drains happen OUTSIDE
``faults.suspended()``, so an armed spec still fires inside the flush.
"""

import os
import types

import numpy as np
import pytest
import torch

from qrack_tpu.resilience import integrity as jinteg

import qrack_tpu_torch as qt
from qrack_tpu_torch import resilience as res
from qrack_tpu_torch.resilience import faults
from qrack_tpu_torch.resilience import integrity as integ
from qrack_tpu_torch.utils.rng import QrackRandom

from test_torch_resilience import (BY_DESIGN, SIDES, _both,  # noqa: F401
                                   _clean_resilience, _fidelity)

N = 5

# fusable-only circuit; H(4)/H(3) are PAGE qubits at n_pages=4, so the
# window-1 pager rows dispatch at pager.exchange
_OPS = [("H", (0,)), ("H", (4,)), ("CNOT", (0, 1)), ("T", (1,)),
        ("RY", (0.7, 2)), ("CZ", (1, 2)), ("X", (3,)), ("H", (3,)),
        ("RZ", (0.3, 4)), ("S", (2,))]


@pytest.fixture(autouse=True)
def _clean_integrity():
    jinteg.reset()
    integ.reset()
    yield
    for mod in (jinteg, integ):
        mod.reset()
        mod.set_enabled(os.environ.get("QRACK_TPU_INTEGRITY", "") != "0")


def _integ_of(side):
    return jinteg if side.name == "jax" else integ


# ---------------------------------------------------------------------------
# detector units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [jinteg, integ], ids=["jax", "torch"])
def test_drift_budget_schedule(mod, monkeypatch):
    assert mod.drift_budget(0) == pytest.approx(1e-3)
    monkeypatch.setenv("QRACK_TPU_INTEGRITY_TOL", "0.5")
    monkeypatch.setenv("QRACK_TPU_INTEGRITY_TOL_PER_GATE", "0.01")
    assert mod.drift_budget(10) == pytest.approx(0.6)
    assert mod.drift_budget(-3) == pytest.approx(0.5)


@pytest.mark.parametrize("mod", [jinteg, integ], ids=["jax", "torch"])
def test_host_fingerprint_pages(mod):
    planes = np.zeros((2, 8))
    planes[0, 0] = 1.0
    assert mod.host_fingerprint(planes, n_pages=4) == pytest.approx(
        [1.0, 0.0, 0.0, 0.0])
    planes[1, 5] = 2.0
    assert mod.host_fingerprint(planes, n_pages=4) == pytest.approx(
        [1.0, 0.0, 4.0, 0.0])
    assert mod.host_fingerprint(planes, n_pages=1) == pytest.approx([5.0])


def test_device_fingerprints_match_host_fingerprint():
    """The on-card reductions (a norm a row of 4096 entries, squares
    summed in float64) give the host fingerprint of the same planes, per
    page for the pager, within the float32 row norms' rounding."""
    res.enable()
    q = qt.create_quantum_interface("pager", N, n_pages=4, device="cpu",
                                    remap="off", rng=QrackRandom(2),
                                    rand_global_phase=False)
    for name, args in _OPS:
        getattr(q, name)(*args)
    q.Finish()
    eng = q.engine
    pages = torch.cat(eng.page_planes, dim=1).double().numpy()
    assert integ.fingerprint(eng) == pytest.approx(
        integ.host_fingerprint(pages, 4), rel=1e-6)


def test_verify_passes_and_detects_on_live_engine():
    for side in SIDES:
        side.arm()
        mod = _integ_of(side)
        q = side.make("dense", 4, rng=side.R(1), rand_global_phase=False)
        q.H(0)
        q.CNOT(0, 1)
        _ = q.Prob(0)
        eng = q.engine
        fp = mod.verify(eng, "t")
        assert fp.sum() == pytest.approx(1.0, abs=1e-6)
        good = np.asarray(eng._state_raw)
        if side.name == "jax":
            import jax.numpy as jnp

            put = jnp.asarray
        else:
            put = torch.from_numpy
        eng._state_raw = put(good * 1.5)
        with pytest.raises(side.res.CorruptionDetected, match="norm drift"):
            mod.verify(eng, "t")
        bad = good.copy()
        bad[0, 0] = np.nan
        eng._state_raw = put(bad)
        with pytest.raises(side.res.CorruptionDetected, match="non-finite"):
            mod.verify(eng, "t")
        side.res.disable()


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_check_host_invariants(side):
    mod = _integ_of(side)
    mod.check_host("x.read", np.array([0.5, 0.5]))
    with pytest.raises(side.res.CorruptionDetected):
        mod.check_host("x.read", np.array([0.5, np.nan]))
    with pytest.raises(side.res.CorruptionDetected):
        mod.check_host("x.read", np.array([0.9, 0.9]), norm_expected=1.0)
    mod.check_host("x.read", np.array([1.0, 0.0]), norm_expected=1.0)
    with side.faults.suspended():
        mod.check_host("x.read", np.array([np.nan]))
    mod.check_host("x.read", np.array([3], dtype=np.int64))


@pytest.mark.parametrize("mod", [jinteg, integ], ids=["jax", "torch"])
def test_quarantine_strikes_and_reset(mod, monkeypatch):
    monkeypatch.setenv("QRACK_TPU_QUARANTINE_STRIKES", "2")
    epoch0 = mod._EPOCH
    mod.record_strike(7, "t")
    assert mod.strikes() == {7: 1} and not mod.quarantined()
    mod.record_strike(7, "t")
    assert mod.quarantined() == {7}
    assert mod._EPOCH == epoch0 + 1
    devs = [types.SimpleNamespace(id=i) for i in range(4)]
    assert [d.id for d in mod.healthy_devices(devs)] == [0, 1, 2, 3]
    mod.record_strike(2, "t")
    mod.record_strike(2, "t")
    assert [d.id for d in mod.healthy_devices(devs)] == [0, 1, 3]
    for i in (0, 1, 3):
        mod.record_strike(i, "t")
        mod.record_strike(i, "t")
    assert [d.id for d in mod.healthy_devices(devs)] == [0, 1, 2, 3]
    mod.reset()
    assert not mod.strikes() and not mod.quarantined()


def test_healthy_devices_takes_page_slots(monkeypatch):
    monkeypatch.setenv("QRACK_TPU_QUARANTINE_STRIKES", "1")
    integ.record_strike(2, "t")
    assert integ.healthy_devices([0, 1, 2, 3, 4]) == [0, 1, 3, 4]


# ---------------------------------------------------------------------------
# detect-and-repair matrix: every flush envelope site, windows 1 and 16
# ---------------------------------------------------------------------------

_MATRIX = [
    ("dense", 1, "tpu.compile", {}),
    ("dense", 16, "tpu.fuse.flush", {}),
    # remap off: the placement planner would turn the lone page-qubit op
    # into a remapped window (the flush site)
    ("pager", 1, "pager.exchange", {"n_pages": 4, "remap": "off"}),
    ("pager", 16, "tpu.fuse.flush", {"n_pages": 4}),
]


@pytest.mark.parametrize("stack,window,site,kw", _MATRIX,
                         ids=[f"{s}-w{w}-{t}" for s, w, t, _ in _MATRIX])
def test_detect_and_repair_matches_oracle(stack, window, site, kw):
    def case(side):
        o = side.CPU(N, rng=side.R(3), rand_global_phase=False)
        s = side.make(stack, rng=side.R(3), rand_global_phase=False, **kw)
        side.faults.inject(side.site(site), "amp-corrupt", after_n=0,
                           times=1)
        for name, args in _OPS:
            getattr(o, name)(*args)
            getattr(s, name)(*args)
        _ = s.Prob(0)
        c = side.tele.snapshot()["counters"]
        assert sum(sp.fired for sp in side.faults.specs()) == 1
        assert c.get("integrity.violation", 0) >= 1
        assert c.get("integrity.replay.repaired", 0) >= 1
        got = side.state(s)
        assert _fidelity(o.GetQuantumState(), got) > 1 - 1e-6
        return {"state": got}

    _both(case, env={"QRACK_TPU_FUSE_WINDOW": str(window)})


def test_page_pinned_strike_attribution():
    def case(side):
        s = side.make("pager", n_pages=4, remap="off", rng=side.R(3),
                      rand_global_phase=False)
        s.H(4)
        _ = s.Prob(0)
        side.faults.inject("pager.exchange", "amp-corrupt", after_n=0,
                           times=1, page=2, n_pages=4)
        s.H(3)
        _ = s.Prob(0)
        assert sum(sp.fired for sp in side.faults.specs()) == 1
        # the JAX package strikes device GetDeviceList()[2], the port
        # page slot 2 (BY_DESIGN "slot_strikes"): both the number 2 here
        key = (s.engine.GetDeviceList()[2] if side.name == "jax"
               else s.engine.page_slots[2])
        assert key == 2
        return {"state": side.state(s),
                "strikes": dict(_integ_of(side).strikes())}

    got = _both(case)
    assert got["jax"]["strikes"] == got["torch"]["strikes"] == {2: 1}


def test_quarantine_feeds_elastic_repage(monkeypatch):
    """Three attributed strikes quarantine page slot 2; the pager's next
    call-boundary probe re-pages onto a spare slot and serving goes on
    oracle-equivalent on pages that exclude the struck slot."""
    monkeypatch.setenv("QRACK_TPU_QUARANTINE_STRIKES", "3")

    def case(side):
        o = side.CPU(N, rng=side.R(3), rand_global_phase=False)
        # the port names its 8 slots (4 pages + 4 spares); the JAX
        # pager's spares are the rest of jax.devices()
        kw = {} if side.name == "jax" else {"devices": ["cpu"] * 8}
        s = side.make("pager", n_pages=4, remap="off", rng=side.R(3),
                      rand_global_phase=False, **kw)
        pager = s.engine
        slots = (lambda: list(pager.GetDeviceList())) \
            if side.name == "jax" else (lambda: pager.page_slots)
        bad = slots()[2]
        for k in range(3):
            side.faults.inject("pager.exchange", "amp-corrupt", after_n=0,
                               times=1, page=2, n_pages=4)
            o.H(4 if k % 2 else 3)
            s.H(4 if k % 2 else 3)
            _ = s.Prob(0)
            side.faults.clear()
        mod = _integ_of(side)
        assert mod.strikes().get(bad) == 3
        assert bad in mod.quarantined()
        pager.maybe_reexpand()
        after = slots()
        assert bad not in after and len(after) == 4
        o.CNOT(0, 1)
        s.CNOT(0, 1)
        o.H(4)
        s.H(4)
        _ = s.Prob(0)
        got = side.state(s)
        assert _fidelity(o.GetQuantumState(), got) > 1 - 1e-6
        c = side.tele.snapshot()["counters"]
        assert c.get("integrity.quarantine.device", 0) >= 1
        assert c.get("integrity.quarantine.repage", 0) >= 1
        return {"state": got, "after": after}

    got = _both(case, skip=("host_fetch",))
    assert got["jax"]["after"] == got["torch"]["after"] == [0, 1, 3, 4]


# ---------------------------------------------------------------------------
# the port's snapshot: on the card, or on the host when the card is full
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["device", "host"])
def test_replay_restores_bit_for_bit(placement, monkeypatch):
    """A corrupted window is replayed from the snapshot wherever it lies
    (a clone beside the planes, or a host copy when the card cannot hold
    one): the final planes equal an unfaulted run's bit for bit."""
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "on")
    if placement == "host":
        monkeypatch.setattr(integ, "_on_card", lambda ts: False)
    kets = []
    for corrupt in (False, True):
        faults.clear()
        res.enable()
        q = qt.create_quantum_interface("cuda", 8, device="cpu",
                                        rng=QrackRandom(4),
                                        rand_global_phase=False)
        if corrupt:
            faults.inject("cuda.fuse.flush", "amp-corrupt", after_n=1,
                          times=1)
        q.QFT(0, 8)
        q.Finish()
        kets.append(q.engine._state_raw.clone())
        assert sum(sp.fired for sp in faults.specs()) == int(corrupt)
    assert torch.equal(kets[0], kets[1])


def test_snapshot_placement_on_the_cpu_is_a_device_copy():
    res.enable()
    q = qt.create_quantum_interface("cuda", 6, device="cpu")
    assert integ.snapshot_placement(q.engine) == "device"
    keep = integ._snapshot(q.engine)
    assert keep[0] is not q.engine._state_raw
    assert torch.equal(keep[0], q.engine._state_raw)


def test_repeated_corruption_gives_up_with_good_planes():
    """A persistent corruption exhausts the replays: the window gives up
    with the pre-flush planes restored (the failover chain sees no
    poison), and without a CPU rung the cause re-raises."""
    res.enable()
    q = qt.create_quantum_interface("cuda", N, device="cpu",
                                    rng=QrackRandom(3),
                                    rand_global_phase=False)
    q.H(0)
    q.CNOT(0, 1)
    q.Finish()
    before = q.engine._state_raw.clone()
    faults.inject("cuda.fuse.flush", "amp-corrupt", after_n=0, times=None)
    q.H(2)
    q.H(3)
    with pytest.raises(res.DispatchGiveUp):
        q.Prob(0)
    assert torch.equal(q.engine._state_raw, before)


def test_turboquant_window_corruption_repaired():
    """The TurboQuant engine's envelope: per-chunk masses off the codes,
    a (codes, scales) snapshot, and a corrupted scale repaired by the
    replay to the codes an unfaulted run leaves."""
    kept = []
    for corrupt in (False, True):
        faults.clear()
        res.enable()
        q = qt.create_quantum_interface("turboquant", 10, device="cpu",
                                        rng=QrackRandom(5),
                                        rand_global_phase=False,
                                        block_pow=4, chunk_qb=6)
        for t in range(10):
            q.H(t)
            q.RZ(0.37 * (t + 1), t)
        _ = q.Prob(0)
        if corrupt:
            faults.inject("turboquant.dispatch", "amp-corrupt", after_n=0,
                          times=1)
        q.H(1)
        q.T(2)
        q.RX(0.3, 0)
        _ = q.Prob(0)
        e = q.engine
        kept.append((e._codes_raw.clone(), e._scales_raw.clone()))
        assert sum(sp.fired for sp in faults.specs()) == int(corrupt)
    assert torch.equal(kept[0][0], kept[1][0])
    assert torch.equal(kept[0][1], kept[1][1])


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_turboquant_collapse_then_clean_window_passes(side, monkeypatch):
    """A chunk-aligned collapse zeroes the losing chunks' scales and keeps
    their codes; a later window that leaves those chunks clean verifies
    on a healthy state (no violation, no replay) on both packages.  The
    kernel tile is pinned to one chunk so the window's clean tiles keep
    their codes."""
    from qrack_tpu.engines.turboquant import QEngineTurboQuant
    from qrack_tpu_torch.engines.turboquant import QEngineCUDATurboQuant

    for cls in (QEngineTurboQuant, QEngineCUDATurboQuant):
        monkeypatch.setattr(cls, "_PALLAS_TILE_POW", 3)
    side.arm()
    _integ_of(side).set_enabled(True)
    q = side.make("turboquant", 4, rng=side.R(3), rand_global_phase=False,
                  bits=16, chunk_qb=3, block_pow=2)
    for t in range(4):
        q.H(t)
    q.RZ(0.4, 0)
    _ = q.Prob(0)
    assert q.ForceM(3, True) is True
    q.CZ(3, 0)
    q.CNOT(3, 1)
    _ = q.Prob(0)
    got = side.state(q)
    events = side.tele.snapshot()["events"]
    assert not [e for e in events if e.get("name") == "integrity.violation"]
    c = side.tele.snapshot()["counters"]
    assert c.get("integrity.replay.repaired", 0) == 0
    assert c.get("integrity.replay.giveup", 0) == 0
    o = qt.QEngineCPU(4, rng=QrackRandom(3), rand_global_phase=False)
    for t in range(4):
        o.H(t)
    o.RZ(0.4, 0)
    o.ForceM(3, True)
    o.CZ(3, 0)
    o.CNOT(3, 1)
    assert _fidelity(o.GetQuantumState(), got) > 1 - 1e-6


# ---------------------------------------------------------------------------
# randomized soak (a short slice of scripts/integrity_soak.py's lanes)
# ---------------------------------------------------------------------------

_GATES1 = ("H", "X", "Y", "Z", "S", "T")
_DIAG1 = ("Z", "S", "T")
_ROTS = ("RX", "RY", "RZ")
_STACKS = [("dense", {}), ("pager", {"n_pages": 4, "remap": "off"}),
           ("pager", {"n_pages": 4, "remap": "on"})]


def _fusable_op(rng):
    q = lambda: int(rng.integers(0, N))  # noqa: E731
    r = float(rng.random())
    if r < 0.5:
        g = _GATES1[int(rng.integers(0, len(_GATES1)))]
        return g, (q(),)
    if r < 0.75:
        g = _ROTS[int(rng.integers(0, len(_ROTS)))]
        return g, (float(rng.uniform(0, 2 * np.pi)), q())
    if r < 0.95:
        if rng.integers(0, 2):
            t = q()
            return "CNOT", ((t + 1 + int(rng.integers(0, N - 1))) % N, t)
        a = q()
        return "CZ", (a, (a + 1 + int(rng.integers(0, N - 1))) % N)
    return "CCNOT", (0, 1, 2 + int(rng.integers(0, N - 2)))


def _site_for(stack, kw, window):
    if stack == "dense":
        return "tpu.compile" if window == 1 else "tpu.fuse.flush"
    if window == 1 and kw.get("remap") == "off":
        return "pager.exchange"
    return "tpu.fuse.flush"


@pytest.mark.parametrize("trial", range(6))
def test_integrity_soak_parity(trial):
    """Seeded amp-corrupt trials (transient or persistent, page-pinned or
    not) on each stack and window: zero silent mis-computes on both
    packages (a fired corruption is detected), oracle-equivalent kets,
    and the same resilience counters and events."""
    rng = np.random.Generator(np.random.PCG64((7 << 20) + trial))
    stack, kw = _STACKS[trial % len(_STACKS)]
    window = 1 if (trial // len(_STACKS)) % 2 else 16
    site = _site_for(stack, kw, window)
    after_n = 0 if window == 16 else int(rng.integers(0, 8))
    times = None if rng.integers(0, 2) else int(rng.integers(1, 3))
    page = int(rng.integers(0, 4)) if stack == "pager" and \
        rng.integers(0, 2) else None
    ops = [_fusable_op(rng) for _ in range(24)]

    def case(side):
        o = side.CPU(N, rng=side.R(trial), rand_global_phase=False)
        s = side.make(stack, rng=side.R(trial), rand_global_phase=False,
                      cpu=True, **kw)
        side.faults.inject(side.site(site), "amp-corrupt", after_n=after_n,
                           times=times, page=page,
                           n_pages=4 if page is not None else None)
        for name, args in ops:
            getattr(o, name)(*args)
            getattr(s, name)(*args)
        _ = s.Prob(0)
        got = side.state(s)
        assert _fidelity(o.GetQuantumState(), got) > 1 - 1e-6
        fired = sum(sp.fired for sp in side.faults.specs())
        c = side.tele.snapshot()["counters"]
        assert fired == 0 or c.get("integrity.violation", 0) >= 1
        return {"state": got, "fired": fired}

    got = _both(case, env={"QRACK_TPU_FUSE_WINDOW": str(window)},
                skip=("host_fetch",))
    assert got["jax"]["fired"] == got["torch"]["fired"]


# ---------------------------------------------------------------------------
# serve: pre-dispatch shed + canary verification (ROADMAP item 16b)
# ---------------------------------------------------------------------------

def _services():
    from qrack_tpu.models.qft import qft_qcircuit as j_qft
    from qrack_tpu.serve import QrackService as JService
    from qrack_tpu_torch.models.qft import qft_qcircuit as t_qft
    from qrack_tpu_torch.serve import QrackService as TService

    return (("jax", JService, j_qft, {"layers": "tpu"}),
            ("port", lambda **kw: TService(device="cpu", **kw), t_qft,
             {"layers": "cuda"}))


def test_pre_dispatch_shed_of_budget_expired_jobs():
    """A batchable job popped young and held by the batch window past
    its budget is shed at dispatch, not executed stale, on both."""
    from qrack_tpu import telemetry as jtele
    from qrack_tpu.serve.errors import QueueBudgetExceeded as JExpired
    from qrack_tpu_torch import telemetry as ttele
    from qrack_tpu_torch.serve.errors import QueueBudgetExceeded as TExpired

    for (name, Service, qft, dense), t, expired in zip(
            _services(), (jtele, ttele), (JExpired, TExpired)):
        t.enable()
        t.reset()
        svc = Service(max_batch=2, batch_window_ms=150.0,
                      queue_budget_ms=30.0, tick_s=30.0)
        try:
            sid = svc.create_session(4, seed=1, **dense)
            h = svc.submit(sid, qft(4))
            with pytest.raises(expired):
                h.result(timeout=30)
            assert t.snapshot()["counters"].get(
                "serve.shed.pre_dispatch", 0) >= 1, name
        finally:
            svc.close()
            t.disable()
            t.reset()


def test_canary_off_by_default():
    assert os.environ.get("QRACK_SERVE_CANARY_RATE") in (None, "", "0")
    for _name, Service, _qft, _dense in _services():
        svc = Service(tick_s=30.0)
        try:
            assert svc.canary is None
        finally:
            svc.close()


def test_canary_samples_and_verifies_clean_jobs(monkeypatch):
    """At rate 1, host and dense sessions both verify clean against the
    oracle replay (the port's dense session on the CPU)."""
    monkeypatch.setenv("QRACK_SERVE_CANARY_RATE", "1.0")
    for _name, Service, qft, dense in _services():
        svc = Service(batch_window_ms=5.0, tick_s=30.0)
        try:
            for layers in ("cpu", dense["layers"]):
                sid = svc.create_session(4, layers=layers, seed=1)
                for _ in range(3):
                    svc.submit(sid, qft(4)).result(timeout=60)
            svc.canary.drain()
            assert svc.canary.checked >= 2
            assert svc.canary.mismatches == 0
        finally:
            svc.close()


def test_canary_mismatch_strikes_devices():
    """A served result that disagrees with the oracle replay feeds one
    quarantine strike per listed device, on both packages; a clean
    post-state verifies without a strike."""
    from qrack_tpu import QEngineCPU as JCPU
    from qrack_tpu.models.qft import qft_qcircuit as j_qft
    from qrack_tpu.serve.canary import CanaryVerifier as JCanary
    from qrack_tpu_torch.models.qft import qft_qcircuit as t_qft
    from qrack_tpu_torch.serve.canary import CanaryVerifier as TCanary

    width = 3
    gen = np.random.Generator(np.random.PCG64(5))
    pre = gen.normal(size=1 << width) + 1j * gen.normal(size=1 << width)
    pre /= np.linalg.norm(pre)
    oracle = JCPU(width)
    oracle.SetQuantumState(pre)
    j_qft(width).Run(oracle)
    doctored = gen.normal(size=1 << width) \
        + 1j * gen.normal(size=1 << width)
    post = doctored / np.linalg.norm(doctored)
    for Canary, qft, mod in ((JCanary, j_qft, jinteg),
                             (TCanary, t_qft, integ)):
        cv = Canary(rate=1.0)
        cv._verify(0, width, qft(width), pre, post, devs=[5, 6])
        assert cv.checked == 1 and cv.mismatches == 1
        assert mod.strikes().get(5) == 1 and mod.strikes().get(6) == 1
        cv._verify(0, width, qft(width), pre,
                   np.asarray(oracle.GetQuantumState()), devs=[5])
        assert cv.checked == 2 and cv.mismatches == 1
        assert mod.strikes().get(5) == 1


def test_canary_strikes_a_dense_engines_card():
    """The port strikes a dense engine's card (GetDevice) where its
    device list is empty (tests/test_torch_serve.py BY_DESIGN
    ``canary_card_strike``); the CPU is never struck."""
    import types

    from qrack_tpu_torch.serve.canary import CanaryVerifier

    eng = qt.create_quantum_interface("cuda", 3, device="cpu")
    assert CanaryVerifier._device_ids(eng) == []
    card = types.SimpleNamespace(GetDeviceList=lambda: [],
                                 GetDevice=lambda: 0)
    assert CanaryVerifier._device_ids(card) == [0]
    paged = types.SimpleNamespace(GetDeviceList=lambda: [0, 0, 1],
                                  GetDevice=lambda: 0)
    assert CanaryVerifier._device_ids(paged) == [0, 0, 1]
