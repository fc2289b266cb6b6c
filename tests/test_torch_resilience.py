"""The port's resilience plane (qrack_tpu_torch/resilience) against the
JAX package's: the counterparts of tests/test_resilience.py (the fault
grammar, guarded dispatch, the breaker, failover with oracle-matching
state, elastic re-paging, the probe), less its cluster tests (ROADMAP
item 13.4), plus the port's own rules: the CPU rung only when the caller
names it, unported sites refused at parse time, retries only where a
dispatch runs exactly once, and a build error that no guard catches.

Parity: each case runs the same seeded ops and the same fault spec on a
JAX stack on the CPU and on the port's matching stack with
``device="cpu"``, both planes armed and both telemetry planes enabled.
The final kets must agree at fidelity > 1 - 1e-6 (the JAX tests' bar),
and the counters and events of the resilience families
(``resilience.*``, ``integrity.*``, ``elastic.*``, ``hybrid.unpin.*``)
name for name after the namespace's one rename (``tpu`` -> ``cuda``),
but for the BY_DESIGN differences below.  Where a JAX case lands on
QEngineCPU, the port's case passes ``failover_cpu=True``; a twin without
it asserts the refusal (``DispatchGiveUp`` or ``BreakerOpen``, the ket
unchanged, no CPU engine built).

Every test leaves both planes disarmed, both breakers fresh, both
telemetry planes disabled and empty.
"""

import os
import re
import sys
import time

import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU as JCPU
from qrack_tpu import create_quantum_interface as j_create
from qrack_tpu import resilience as jres
from qrack_tpu import telemetry as jtele
from qrack_tpu.engines.hybrid import QHybrid as JHybrid
from qrack_tpu.resilience import faults as jfaults
from qrack_tpu.utils.rng import QrackRandom as JR

import qrack_tpu_torch as qt
from qrack_tpu_torch import resilience as res
from qrack_tpu_torch import telemetry as tele
from qrack_tpu_torch.engines.hybrid import QHybrid
from qrack_tpu_torch.engines import cpu as tcpu
from qrack_tpu_torch.resilience import dispatch as rdispatch
from qrack_tpu_torch.resilience import faults
from qrack_tpu_torch.resilience import integrity as integ
from qrack_tpu_torch.utils.rng import QrackRandom

#: where the port differs from the JAX package by design; the parity
#: cases leave these names out of the comparison
BY_DESIGN = {
    "cpu_rung": "the JAX chain ends on QEngineCPU; the port's only with "
                "failover_cpu=True, and otherwise re-raises the cause",
    "on_card_shrink": "shrink_pages re-pages on the card: no "
                      "exchange.pager.host_fetch[_bytes] (the JAX shrink "
                      "takes a host snapshot), and its unmap counts "
                      "remap.pager.* and exchange.pager.* passes",
    "slot_strikes": "strikes and quarantine are keyed by page slot (the "
                    "page's index in the construction device list), the "
                    "JAX package's by device id; equal wherever the JAX "
                    "mesh is jax.devices()[:P], as in its tests",
    "unported_sites": "serve.*, prefix.materialize, "
                      "fleet.* and tpu.* are refused at parse time "
                      "(faults.NOT_PORTED names the ROADMAP item)",
    "tq_chunk": "TurboQuant's plain chunk is 2^26 amplitudes "
                "(DEFAULT_CHUNK_QB), the JAX engine's 2^20; its kernel "
                "tile 2^12, the JAX engine's 2^18",
}

N = 5
FAMILIES = ("resilience.", "integrity.", "elastic.", "hybrid.unpin")


def _ren(name: str) -> str:
    """The namespace's one rename: the dense engine's label."""
    return re.sub(r"(?<![a-z])tpu(?![a-z])", "cuda", name)


def _counters(mod) -> dict:
    return {_ren(k): v for k, v in mod.snapshot()["counters"].items()
            if k.startswith(FAMILIES)}


def _events(mod) -> list:
    return [_ren(e["name"]) for e in mod.snapshot()["events"]
            if e["name"].startswith(FAMILIES)]


def _fidelity(a, b) -> float:
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    return float(abs(np.vdot(a, b)) ** 2
                 / (np.vdot(a, a).real * np.vdot(b, b).real))


def _reset_both():
    for r, f, t in ((jres, jfaults, jtele), (res, faults, tele)):
        f.clear()
        r.reset_breaker()
        r.configure(max_retries=2, backoff_s=0.0, timeout_s=0.0)
        r.disable()
        t.disable()
        t.reset()
    integ.reset()
    integ.set_enabled(os.environ.get("QRACK_TPU_INTEGRITY", "") != "0")
    CPU_BUILT[0] = 0


#: the port's QEngineCPU constructions since the last _reset_both,
#: counted at the class (the refusals build none)
CPU_BUILT = [0]


@pytest.fixture(autouse=True)
def _clean_resilience(monkeypatch):
    real = tcpu.QEngineCPU.__init__

    def counting(self, *a, **k):
        CPU_BUILT[0] += 1
        real(self, *a, **k)

    monkeypatch.setattr(tcpu.QEngineCPU, "__init__", counting)
    _reset_both()
    yield
    _reset_both()
    res.configure()  # re-read env (defaults)
    jres.configure()


class Side:
    """One package's handles: the factory, the plane, the rng, the dense
    terminal's name and the kwargs that put the port on the CPU."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            self.create, self.res, self.faults, self.tele = (
                j_create, jres, jfaults, jtele)
            self.CPU, self.R, self.Hybrid = JCPU, JR, JHybrid
            self.dense = "tpu"
        else:
            self.create, self.res, self.faults, self.tele = (
                qt.create_quantum_interface, res, faults, tele)
            self.CPU, self.R, self.Hybrid = qt.QEngineCPU, QrackRandom, QHybrid
            self.dense = "cuda"

    def site(self, s: str) -> str:
        return s if self.name == "jax" else _ren(s)

    def make(self, layers: str, n: int = N, cpu: bool = False, **kw):
        """create_quantum_interface on this side; `cpu` names the CPU
        rung on the port (the JAX chain always has it)."""
        layers = self.dense if layers == "dense" else layers
        if self.name == "torch":
            if "devices" not in kw:
                kw.setdefault("device", "cpu")
            if cpu:
                kw["failover_cpu"] = True
        return self.create(layers, n, **kw)

    def hybrid(self, n: int = N, cpu: bool = False, **kw):
        if self.name == "torch":
            kw["device"] = "cpu"
            if cpu:
                kw["failover_cpu"] = True
        return self.Hybrid(n, **kw)

    def arm(self):
        self.tele.enable()
        self.res.enable()

    def state(self, q) -> np.ndarray:
        with self.faults.suspended():
            return np.asarray(q.GetQuantumState())


SIDES = (Side("jax"), Side("torch"))


def _kind(engine) -> str:
    return {"QEngineTPU": "dense", "QEngineCUDA": "dense",
            "QEngineCPU": "cpu", "QPager": "pager"}.get(
                type(engine).__name__, type(engine).__name__)


def _both(case, env=None, skip=()):
    """Run case(side) on both sides (each from a clean plane); assert the
    kets agree, and the resilience counters and events name for name but
    for the names matching a pattern in `skip` (BY_DESIGN).  Returns
    {side name: case result}."""
    got = {}
    for side in SIDES:
        _reset_both()
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            side.arm()
            out = case(side)
            out["counters"] = _counters(side.tele)
            out["events"] = _events(side.tele)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        got[side.name] = out
    j, t = got["jax"], got["torch"]
    keep = (lambda k: not any(re.search(p, k) for p in skip))
    assert {k: v for k, v in j["counters"].items() if keep(k)} == \
        {k: v for k, v in t["counters"].items() if keep(k)}
    assert [e for e in j["events"] if keep(e)] == \
        [e for e in t["events"] if keep(e)]
    if "state" in j:
        assert _fidelity(j["state"], t["state"]) > 1 - 1e-6
    return got


def _oracle_state(side) -> np.ndarray:
    o = side.CPU(N, rng=side.R(3), rand_global_phase=False)
    _apply_prefix(o)
    _apply_suffix(o)
    return np.asarray(o.GetQuantumState())


def _assert_oracle_match(side, engine):
    assert _fidelity(_oracle_state(side), side.state(engine)) > 1 - 1e-6


def _apply_prefix(e):
    e.H(0)
    e.CNOT(0, 1)
    e.T(1)
    e.RY(0.7, 2)


def _apply_suffix(e):
    e.CZ(1, 2)
    e.H(3)
    e.INC(3, 0, 3)


def _prefix_state(side) -> np.ndarray:
    o = side.CPU(N, rng=side.R(3), rand_global_phase=False)
    _apply_prefix(o)
    return np.asarray(o.GetQuantumState())


# ---------------------------------------------------------------------------
# fault grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_fault_spec_grammar(side):
    f = side.faults
    s = f.parse_spec(f"{side.site('tpu.compile')}:raise:3")
    assert (s.site, s.kind, s.after_n, s.times) == (
        side.site("tpu.compile"), "raise", 3, 1)
    s = f.parse_spec("pager.exchange:timeout:0+4")
    assert (s.after_n, s.times) == (0, 4)
    s = f.parse_spec("*:device-loss:2+")
    assert s.times is None  # persistent
    s = f.parse_spec("device_get:nan-poison:1:42")
    assert s.seed == 42
    with pytest.raises(ValueError):
        f.parse_spec("just-a-site")
    with pytest.raises(ValueError):
        f.parse_spec("site:unknown-kind:0")


@pytest.mark.parametrize("site", sorted(faults.NOT_PORTED))
def test_unported_site_refused_naming_its_item(site):
    with pytest.raises(ValueError, match="not ported yet") as ei:
        faults.parse_spec(f"{site}:raise:0")
    assert faults.NOT_PORTED[site] in str(ei.value)
    # the JAX package accepts the same spec: the refusal is the port's
    jfaults.parse_spec(f"{site}:raise:0")


def test_unported_site_in_env_refused_at_load():
    faults.load_env("pager.exchange:raise:0")
    with pytest.raises(ValueError, match="ROADMAP item 16"):
        faults.load_env("cuda.compile:raise:0,serve.dispatch:hang:2+")
    assert [s.site for s in faults.specs()] == ["pager.exchange"]


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_fault_spec_matching_and_firing(side):
    s = side.faults.FaultSpec(site="compile", kind="raise", after_n=2,
                              times=2)
    assert s.matches(side.site("tpu.compile")) and s.matches("compile")
    assert not s.matches(side.site("tpu.device_get"))
    fires = [s.should_fire() for _ in range(6)]
    assert fires == [False, False, True, True, False, False]
    wild = side.faults.FaultSpec(site="*", kind="raise")
    assert wild.matches("anything.at.all")


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_fault_env_grammar_loads(side):
    n = side.faults.load_env(
        f"{side.site('tpu.compile')}:raise:0,pager.exchange:hang:2+")
    assert n == 2
    assert [s.kind for s in side.faults.specs()] == ["raise", "hang"]
    side.faults.load_env("")
    assert not side.faults.specs()


def test_seeded_fault_is_deterministic_and_matches_jax():
    seqs = []
    for side in SIDES:
        s1 = side.faults.FaultSpec(site="*", kind="raise", times=None, seed=7)
        s2 = side.faults.FaultSpec(site="*", kind="raise", times=None, seed=7)
        seq1 = [s1.should_fire() for _ in range(20)]
        assert seq1 == [s2.should_fire() for _ in range(20)]
        assert 0 < sum(seq1) < 20
        seqs.append(seq1)
    assert seqs[0] == seqs[1]  # the same PCG64 stream on both sides


# ---------------------------------------------------------------------------
# guarded dispatch: retry, backoff, give-up
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_transient_fault_recovers_via_retry(side):
    side.res.enable()
    side.faults.inject("x.dispatch", "raise", after_n=0, times=1)
    calls = []
    out = side.res.call_guarded("x.dispatch", lambda: calls.append(1) or 42)
    assert out == 42 and len(calls) == 1


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_persistent_fault_gives_up_with_cause(side):
    side.res.enable()
    side.res.configure(max_retries=2)
    side.faults.inject("x.dispatch", "device-loss", after_n=0, times=None)
    with pytest.raises(side.res.DispatchGiveUp) as ei:
        side.res.call_guarded("x.dispatch", lambda: 42)
    assert isinstance(ei.value.cause, side.res.DeviceLost)
    assert side.faults.specs()[0].fired == 1


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_retry_count_matches_max_retries(side):
    side.res.enable()
    side.res.configure(max_retries=3)
    side.faults.inject("x.dispatch", "raise", after_n=0, times=None)
    with pytest.raises(side.res.DispatchGiveUp):
        side.res.call_guarded("x.dispatch", lambda: 42)
    assert side.faults.specs()[0].fired == 4


def test_retry_telemetry_counters():
    def case(side):
        side.res.configure(max_retries=2)
        side.faults.inject("x.dispatch", "raise", after_n=0, times=2)
        assert side.res.call_guarded("x.dispatch", lambda: 7) == 7
        return {}

    got = _both(case)
    c = got["torch"]["counters"]
    assert c.get("resilience.failure.x.dispatch") == 2
    assert c.get("resilience.fault.x.dispatch.raise") == 2


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_injected_hang_is_caught_by_watchdog(side):
    side.res.enable()
    side.res.configure(max_retries=0, timeout_s=0.1)
    side.faults.inject("x.dispatch", "hang", after_n=0, times=None)
    t0 = time.perf_counter()
    with pytest.raises(side.res.DispatchGiveUp) as ei:
        side.res.call_guarded("x.dispatch", lambda: 42)
    assert isinstance(ei.value.cause, side.res.DispatchTimeout)
    assert time.perf_counter() - t0 < 5.0


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_watchdog_times_out_real_slow_fn(side):
    side.res.enable()
    side.res.configure(max_retries=0, timeout_s=0.05)

    def slow():
        time.sleep(2.0)
        return "too late"

    with pytest.raises(side.res.DispatchGiveUp) as ei:
        side.res.call_guarded("x.dispatch", slow)
    assert isinstance(ei.value.cause, side.res.DispatchTimeout)


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_validate_finite_catches_nan_output(side):
    side.res.enable()
    side.res.configure(max_retries=0, validate=True)
    bad = np.array([1.0, np.nan])
    with pytest.raises(side.res.DispatchGiveUp) as ei:
        side.res.call_guarded("x.dispatch", lambda: bad)
    assert isinstance(ei.value.cause, side.res.NaNPoisoned)
    side.res.configure(validate=False)
    assert side.res.call_guarded("x.dispatch", lambda: bad) is bad


def test_validate_finite_reads_tensors_and_pages():
    res.enable()
    res.configure(max_retries=0, validate=True)
    bad = torch.tensor([[1.0, float("nan")], [0.0, 0.0]])
    good = torch.zeros((2, 2))
    with pytest.raises(res.DispatchGiveUp) as ei:
        res.call_guarded("x.dispatch", lambda: [good, bad])
    assert isinstance(ei.value.cause, res.NaNPoisoned)
    assert res.call_guarded("x.dispatch", lambda: (good, 3)) == (good, 3)


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_guarded_program_disabled_is_passthrough(side):
    prog = side.res.instrument_dispatch("x.dispatch", lambda a: a * 2)
    side.res.disable()
    side.faults.inject("x.dispatch", "raise", after_n=0, times=None)
    side.res.disable()
    assert prog(21) == 42


# ---------------------------------------------------------------------------
# exactly once: the port's kernels write in place
# ---------------------------------------------------------------------------

def test_fault_after_write_gives_up_without_retry():
    """A device error after the callable wrote its operand in place
    gives up at once, torn: a retry would apply the dispatch twice."""
    res.enable()
    planes = torch.zeros(4)
    calls = []

    def write_then_fail():
        calls.append(1)
        planes.add_(1.0)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    with pytest.raises(res.DispatchGiveUp) as ei:
        res.call_guarded("x.dispatch", write_then_fail,
                         writes=lambda: rdispatch.write_token(planes))
    assert ei.value.torn and len(calls) == 1
    assert torch.equal(planes, torch.ones(4))  # applied once, not three times
    assert res.DispatchGiveUp in res.FAILOVER_ERRORS


def test_launch_error_before_any_write_is_retried():
    """A launch that reports its own failure wrote nothing: retried in
    place, and the dispatch lands exactly once."""
    res.enable()
    planes = torch.zeros(4)
    calls = []

    def launch():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("window kernel pair launch failed: CUDA "
                               "error 701")
        planes.add_(1.0)
        return planes

    out = res.call_guarded("x.dispatch", launch,
                           writes=lambda: rdispatch.write_token(planes))
    assert out is planes and len(calls) == 2
    assert torch.equal(planes, torch.ones(4))


def test_sticky_cuda_error_is_device_lost_without_retry():
    res.enable()
    calls = []

    def fail():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    with pytest.raises(res.DispatchGiveUp) as ei:
        res.call_guarded("x.dispatch", fail)
    assert isinstance(ei.value.cause, res.DeviceLost) and len(calls) == 1
    assert rdispatch.is_sticky(RuntimeError("window kernel in_tile launch "
                                            "failed: CUDA error 700"))
    assert not rdispatch.is_device_error(ValueError("CUDA error: x"))


def test_build_error_is_not_caught():
    """A failed nvcc build is no device error: it propagates untouched,
    no retry, no failover, no plain version in its place."""
    res.enable()
    calls = []

    def build():
        calls.append(1)
        raise RuntimeError("nvcc failed to build window_kernel.cu")

    with pytest.raises(RuntimeError, match="nvcc failed") as ei:
        res.call_guarded("cuda.fuse.flush", build)
    assert not isinstance(ei.value, res.ResilienceError) and len(calls) == 1


def test_build_error_in_engine_flush_propagates(monkeypatch):
    from qrack_tpu_torch.ops import fusion as fu

    res.enable()
    tele.enable()
    q = qt.create_quantum_interface("cuda", N, device="cpu",
                                    failover_cpu=True)

    def broken(*a, **k):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")

    monkeypatch.setattr(fu, "flush_window", broken)
    q.H(0)
    q.H(1)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        q.Prob(0)
    assert type(q.engine).__name__ == "QEngineCUDA"
    assert not any(e.startswith("resilience.failover")
                   for e in _events(tele))
    assert CPU_BUILT[0] == 0


@pytest.mark.parametrize("integrity", [False, True])
def test_torn_window_refused_or_replayed_from_snapshot(integrity,
                                                       monkeypatch):
    """A window that writes the planes and then fails: with integrity
    off no rung takes the torn planes (not even a named CPU rung); with
    it on the snapshot replays the window exactly once."""
    from qrack_tpu_torch.ops import fusion as fu

    # the kernel lowering (its plain version on the CPU) writes the
    # planes in place, as the window kernel does on the card
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "on")
    integ.set_enabled(integrity)
    res.enable()
    q = qt.create_quantum_interface("cuda", N, device="cpu",
                                    rng=QrackRandom(3),
                                    rand_global_phase=False,
                                    failover_cpu=True)
    _apply_prefix(q)
    q.Finish()
    real = fu.flush_window
    fired = []

    def tear(planes, *a, **k):
        out = real(planes, *a, **k)
        if not fired:
            fired.append(1)
            out.mul_(0.5)   # a partial write
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return out

    monkeypatch.setattr(fu, "flush_window", tear)
    q.CZ(1, 2)
    q.H(3)
    if not integrity:
        with pytest.raises(res.DispatchGiveUp) as ei:
            q.Prob(0)
        assert ei.value.torn
        assert type(q.engine).__name__ == "QEngineCUDA"
        assert CPU_BUILT[0] == 0
        return
    q.Prob(0)
    o = qt.QEngineCPU(N, rng=QrackRandom(3), rand_global_phase=False)
    _apply_prefix(o)
    o.CZ(1, 2)
    o.H(3)
    with faults.suspended():
        got = q.GetQuantumState()
    assert _fidelity(o.GetQuantumState(), got) > 1 - 1e-6


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def _fake_clock():
    t = [0.0]
    return t, (lambda: t[0])


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_breaker_full_state_machine(side):
    t, clock = _fake_clock()
    br = side.res.CircuitBreaker(threshold=3, cooldown_s=10.0, clock=clock)
    for _ in range(2):
        br.record_failure("s")
    assert br.state == "closed"
    br.record_failure("s")
    assert br.state == "open" and br.trips == 1
    with pytest.raises(side.res.BreakerOpen):
        br.allow("s")
    t[0] = 10.1
    br.allow("s")
    assert br.state == "half_open"
    br.record_failure("s")
    assert br.state == "open" and br.trips == 2
    t[0] = 20.2
    br.allow("s")
    br.record_success()
    assert br.state == "closed" and br.consecutive_failures == 0


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_breaker_success_resets_consecutive_count(side):
    br = side.res.CircuitBreaker(threshold=2, cooldown_s=10.0)
    br.record_failure("s")
    br.record_success()
    br.record_failure("s")
    assert br.state == "closed"


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_breaker_trip_stops_dispatch_until_half_open(side):
    t, clock = _fake_clock()
    side.res.reset_breaker(side.res.CircuitBreaker(threshold=2,
                                                   cooldown_s=30.0,
                                                   clock=clock))
    side.res.enable()
    side.res.configure(max_retries=0)
    side.faults.inject("x.dispatch", "raise", after_n=0, times=2)
    calls = []
    for _ in range(2):
        with pytest.raises(side.res.DispatchGiveUp):
            side.res.call_guarded("x.dispatch", lambda: calls.append(1))
    assert side.res.get_breaker().state == "open" and not calls
    with pytest.raises(side.res.BreakerOpen):
        side.res.call_guarded("x.dispatch", lambda: calls.append(1))
    assert not calls
    t[0] = 30.1
    assert side.res.call_guarded("x.dispatch",
                                 lambda: calls.append(1) or 9) == 9
    assert calls and side.res.get_breaker().state == "closed"


def test_breaker_events_in_telemetry():
    def case(side):
        t, clock = _fake_clock()
        br = side.res.reset_breaker(side.res.CircuitBreaker(
            threshold=1, cooldown_s=5.0, clock=clock))
        br.record_failure("s")
        with pytest.raises(side.res.BreakerOpen):
            br.allow("s")
        t[0] = 5.1
        br.allow("s")
        br.record_success()
        return {}

    got = _both(case)
    names = got["torch"]["events"]
    for name in ("resilience.breaker.trip", "resilience.breaker.half_open",
                 "resilience.breaker.close"):
        assert name in names
    assert got["torch"]["counters"]["resilience.breaker.rejected"] == 1


# ---------------------------------------------------------------------------
# failover: the circuit completes with oracle-matching state
# ---------------------------------------------------------------------------

_MATRIX = [
    ("tpu.compile", "raise"),
    ("tpu.compile", "device-loss"),
    ("tpu.compile", "timeout"),
    ("tpu.device_get", "raise"),
    ("tpu.device_get", "nan-poison"),
    ("compile", "device-loss"),  # bare category
]


@pytest.mark.parametrize("site,kind", _MATRIX,
                         ids=[f"{s}-{k}" for s, k in _MATRIX])
def test_dense_failover_matrix_matches_oracle(site, kind):
    def case(side):
        q = side.make("dense", rng=side.R(3), rand_global_phase=False,
                      cpu=True)
        _apply_prefix(q)
        side.faults.inject(side.site(site), kind, after_n=0, times=None)
        _apply_suffix(q)
        q.GetAmplitude(0)
        assert type(q.engine).__name__ == "QEngineCPU"
        _assert_oracle_match(side, q)
        return {"state": side.state(q)}

    _both(case)


@pytest.mark.parametrize("site,kind", _MATRIX,
                         ids=[f"{s}-{k}" for s, k in _MATRIX])
def test_dense_failover_without_cpu_rung_refuses(site, kind):
    """The twin: no failover_cpu, so the chain of a dense engine is
    empty; the cause re-raises with the ket as it was before the failed
    call, and no CPU engine is built."""
    res.enable()
    q = qt.create_quantum_interface("cuda", N, rng=QrackRandom(3),
                                    rand_global_phase=False, device="cpu")
    _apply_prefix(q)
    faults.inject(_ren(site), kind, after_n=0, times=None)
    side = SIDES[1]
    with pytest.raises(res.DispatchGiveUp):
        _apply_suffix(q)
        q.GetAmplitude(0)
    assert type(q.engine).__name__ == "QEngineCUDA"
    assert CPU_BUILT[0] == 0
    got = side.state(q)
    # every gate before the failed call stands, none twice: the ket is
    # the oracle's at the prefix, or at prefix + CZ + H (the window the
    # failed INC flushed), or the whole circuit (a device_get failure)
    o = qt.QEngineCPU(N, rng=QrackRandom(3), rand_global_phase=False)
    _apply_prefix(o)
    cands = [o.GetQuantumState()]
    o.CZ(1, 2)
    o.H(3)
    cands.append(o.GetQuantumState())
    o.INC(3, 0, 3)
    cands.append(o.GetQuantumState())
    assert max(_fidelity(c, got) for c in cands) > 1 - 1e-6


@pytest.mark.parametrize("site,kind", [("pager.exchange", "raise"),
                                       ("pager.dispatch", "device-loss"),
                                       ("pager.device_get", "raise")])
def test_pager_failover_matrix_matches_oracle(site, kind):
    def case(side):
        q = side.make("pager", n_pages=4, rng=side.R(3),
                      rand_global_phase=False, cpu=True)
        _apply_prefix(q)
        side.faults.inject(site, kind, after_n=0, times=None)
        _apply_suffix(q)
        q.GetAmplitude(0)
        name = type(q.engine).__name__
        if site == "pager.exchange":
            assert name == "QPager"
            assert q.engine.n_pages == 4 and not q.engine.elastic_degraded
        else:
            assert name in ("QEngineTPU", "QEngineCUDA", "QEngineCPU")
        _assert_oracle_match(side, q)
        return {"state": side.state(q), "engine": _kind(q.engine)}

    got = _both(case, env={"QRACK_TPU_FUSE_WINDOW": "1"},
                skip=("host_fetch",))
    assert got["jax"]["engine"] == got["torch"]["engine"]


def test_pager_device_get_failover_without_cpu_rung_refuses(monkeypatch):
    """The JAX pager lands on QEngineCPU under a persistent
    pager.device_get fault (the breaker opens on the way down); without
    failover_cpu the port raises, the ket intact on the pages."""
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", "1")
    res.enable()
    q = qt.create_quantum_interface("pager", N, n_pages=4, device="cpu",
                                    rng=QrackRandom(3),
                                    rand_global_phase=False)
    _apply_prefix(q)
    _apply_suffix(q)
    q.Finish()
    faults.inject("pager.device_get", "raise", after_n=0, times=None)
    with pytest.raises(res.FAILOVER_ERRORS):
        q.GetAmplitude(0)
    assert type(q.engine).__name__ in ("QPager", "QEngineCUDA")
    assert CPU_BUILT[0] == 0
    _assert_oracle_match(SIDES[1], q)


def test_transient_fault_is_invisible_midcircuit():
    def case(side):
        q = side.make("dense", rng=side.R(3), rand_global_phase=False)
        _apply_prefix(q)
        side.faults.inject(side.site("tpu.compile"), "raise", after_n=0,
                           times=1)
        _apply_suffix(q)
        assert _kind(q.engine) == "dense"
        _assert_oracle_match(side, q)
        return {"state": side.state(q)}

    _both(case)


def test_hybrid_fails_over_in_place_and_stays_pinned():
    def case(side):
        h = side.hybrid(tpu_threshold_qubits=2, rng=side.R(3),
                        rand_global_phase=False, cpu=True)
        _apply_prefix(h)
        side.faults.inject(side.site("tpu.compile"), "raise", after_n=0,
                           times=None)
        _apply_suffix(h)
        assert h._failed_over == "cpu"
        assert type(h._engine).__name__ == "QEngineCPU"
        _assert_oracle_match(side, h)
        h.X(4)
        h.X(4)
        _assert_oracle_match(side, h)
        return {"state": side.state(h)}

    _both(case)


def test_hybrid_failover_without_cpu_rung_refuses():
    res.enable()
    h = QHybrid(N, tpu_threshold_qubits=2, rng=QrackRandom(3),
                rand_global_phase=False, device="cpu")
    _apply_prefix(h)
    faults.inject("cuda.compile", "raise", after_n=0, times=None)
    with pytest.raises(res.DispatchGiveUp):
        _apply_suffix(h)
    assert h._failed_over is None
    assert type(h._engine).__name__ == "QEngineCUDA"
    assert CPU_BUILT[0] == 0


def test_hybrid_construction_failover():
    def case(side):
        side.faults.inject("discover", "device-loss", after_n=0, times=None)
        kw = {"device_id": 0} if side.name == "jax" else {}
        h = side.hybrid(tpu_threshold_qubits=2, cpu=True, **kw)
        assert h._failed_over == "cpu"
        assert type(h._engine).__name__ == "QEngineCPU"
        return {}

    _both(case)


def test_hybrid_construction_failover_without_cpu_rung_raises():
    res.enable()
    faults.inject("discover", "device-loss", after_n=0, times=None)
    with pytest.raises(res.DispatchGiveUp):
        QHybrid(N, tpu_threshold_qubits=2, device="cpu")
    assert CPU_BUILT[0] == 0


def test_resilient_engine_build_construction_failover():
    def case(side):
        side.faults.inject("discover", "device-loss", after_n=0, times=None)
        kw = {"device_id": 0} if side.name == "jax" else {}
        q = side.make("dense", cpu=True, **kw)
        assert type(q.engine).__name__ == "QEngineCPU"
        q.H(0)
        assert abs(q.Prob(0) - 0.5) < 1e-6
        return {}

    _both(case)


def test_resilient_engine_build_without_cpu_rung_raises():
    res.enable()
    faults.inject("discover", "device-loss", after_n=0, times=None)
    with pytest.raises(res.DispatchGiveUp):
        qt.create_quantum_interface("cuda", N, device="cpu")
    assert CPU_BUILT[0] == 0


def test_failover_emits_telemetry():
    def case(side):
        q = side.make("dense", cpu=True)
        side.faults.inject(side.site("tpu.compile"), "raise", after_n=0,
                           times=None)
        q.H(0)
        q.Prob(0)
        snap = side.tele.snapshot()
        assert snap["counters"].get("resilience.failovers", 0) >= 1
        return {}

    got = _both(case)
    assert "resilience.failover.cuda_to_cpu" in got["torch"]["events"]


def test_wide_pager_failover_exhausts_chain_loudly():
    """With the breaker open (no dense rung) and the CPU cap below the
    width, the named CPU rung's MemoryError is raised on both sides;
    without the rung the port raises the breaker's refusal."""
    from qrack_tpu.config import get_config as jget, set_config as jset
    from qrack_tpu_torch.config import get_config as tget, set_config as tset

    def case(side):
        q = side.make("pager", 6, n_pages=4, cpu=True)
        br = side.res.get_breaker()
        for _ in range(br.threshold):
            br.record_failure("pager.dispatch")
        with pytest.raises(MemoryError):
            q.H(0)
            q.Prob(0)
        return {}

    old = (jget().max_cpu_qubits, tget().max_cpu_qubits)
    jset(max_cpu_qubits=4)
    tset(max_cpu_qubits=4)
    try:
        _both(case, skip=("host_fetch",))
        _reset_both()
        res.enable()
        q = qt.create_quantum_interface("pager", 6, n_pages=4, device="cpu")
        br = res.get_breaker()
        for _ in range(br.threshold):
            br.record_failure("pager.dispatch")
        with pytest.raises(res.BreakerOpen):
            q.H(0)
            q.Prob(0)
        assert CPU_BUILT[0] == 0
    finally:
        jset(max_cpu_qubits=old[0])
        tset(max_cpu_qubits=old[1])


# ---------------------------------------------------------------------------
# elastic re-paging: shrink on loss, serve degraded, grow on recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_flap_spec_grammar_and_device_down(side):
    f = side.faults
    s = f.parse_spec("pager.dispatch:flap:2+3")
    assert (s.site, s.kind, s.after_n, s.times) == ("pager.dispatch",
                                                    "flap", 2, 3)
    with pytest.raises(ValueError):
        f.parse_spec("pager.dispatch:flapp:0")
    f.inject("pager.dispatch", "flap", after_n=1, times=2)
    assert not f.device_down("pager.dispatch")
    f.check("pager.dispatch")
    assert f.device_down("pager.dispatch")
    assert not f.device_down(side.site("tpu.compile"))
    for _ in range(2):
        with pytest.raises(side.res.DeviceLost):
            f.check("pager.dispatch")
    assert not f.device_down("pager.dispatch")
    f.inject(side.site("tpu.dispatch"), "device-loss", after_n=0, times=None)
    assert f.device_down()
    with f.suspended():
        assert not f.device_down()


def test_pager_shrink_expand_roundtrip():
    def case(side):
        q = side.make("pager", n_pages=4, rng=side.R(3),
                      rand_global_phase=False)
        _apply_prefix(q)
        pager = q.engine
        side.faults.inject("pager.dispatch", "flap", after_n=0, times=2)
        assert side.faults.device_down("pager.dispatch")
        pager.shrink_pages()
        assert pager.n_pages == 2 and pager.elastic_degraded
        assert not pager.maybe_reexpand()
        assert pager.n_pages == 2
        for _ in range(2):
            with pytest.raises(side.res.DeviceLost):
                side.faults.check("pager.dispatch")
        assert pager.maybe_reexpand()
        assert pager.n_pages == 4 and not pager.elastic_degraded
        _apply_suffix(q)
        _assert_oracle_match(side, q)
        c = side.tele.snapshot()["counters"]
        assert c.get("elastic.repage.shrink") == 1
        assert c.get("elastic.repage.expand") == 1
        return {"state": side.state(q)}

    _both(case, skip=("host_fetch",))


def _rcs_ops():
    gen = np.random.Generator(np.random.PCG64(7))
    ops = []
    for _ in range(4):
        for qb in range(N):
            ops.append((("T", "H", "S")[int(gen.integers(0, 3))], (qb,)))
        a = int(gen.integers(0, N))
        ops.append(("CZ", (a, (a + 1) % N)))
    return ops


def _fuzz_ops():
    gen = np.random.Generator(np.random.PCG64(11))
    q = lambda: int(gen.integers(0, N))  # noqa: E731
    ops = []
    for _ in range(16):
        kind = int(gen.integers(0, 6))
        if kind == 0:
            ops.append((("X", "Y", "Z", "H", "S", "T")[q()], (q(),)))
        elif kind == 1:
            ops.append((("RX", "RY", "RZ")[kind % 3],
                        (float(gen.uniform(0, 6.28)), q())))
        elif kind == 2:
            a = q()
            ops.append((("CNOT", "CZ", "Swap", "ISwap")[a % 4],
                        (a, (a + 1 + q() % (N - 1)) % N)))
        elif kind == 3:
            s = int(gen.integers(0, N - 1))
            ops.append(("INC", (int(gen.integers(0, 8)), s,
                                int(gen.integers(1, N - s + 1)))))
        elif kind == 4:
            ops.append(("XMask", (int(gen.integers(1, 1 << N)),)))
        else:
            ops.append(("ZMask", (int(gen.integers(1, 1 << N)),)))
    return ops


_ELASTIC_CIRCUITS = {
    "qft": lambda: ([("H", (0,)), ("CNOT", (0, 1)), ("RY", (0.7, 2))]
                    + [("QFT", (0, N))]),
    "rcs": _rcs_ops,
    "fuzz": _fuzz_ops,
}


@pytest.mark.parametrize("window", [1, 16])
@pytest.mark.parametrize("circ", sorted(_ELASTIC_CIRCUITS))
def test_pager_shrink_midcircuit_matrix(circ, window):
    ops = _ELASTIC_CIRCUITS[circ]()
    cut = len(ops) // 2

    def case(side):
        q = side.make("pager", n_pages=4, rng=side.R(3),
                      rand_global_phase=False)
        for name, args in ops[:cut]:
            getattr(q, name)(*args)
        side.faults.inject("*", "flap", after_n=0, times=1)
        for name, args in ops[cut:]:
            getattr(q, name)(*args)
        q.GetAmplitude(0)
        q.Prob(0)
        c = side.tele.snapshot()["counters"]
        assert c.get("elastic.repage.shrink", 0) >= 1
        assert type(q.engine).__name__ == "QPager"
        assert q.engine.n_pages == 4 and not q.engine.elastic_degraded
        o = side.CPU(N, rng=side.R(3), rand_global_phase=False)
        for name, args in ops:
            getattr(o, name)(*args)
        got = side.state(q)
        assert _fidelity(o.GetQuantumState(), got) > 1 - 1e-6
        return {"state": got}

    _both(case, env={"QRACK_TPU_FUSE_WINDOW": str(window)},
          skip=("host_fetch",))


@pytest.mark.parametrize("cpu", [True, False])
def test_pager_staircase_descends_through_shrink(cpu):
    """A persistent device loss re-fires on the shrunk pager: 4 -> 2 -> 1
    pages, then the dense engine — on the card, with or without a CPU
    rung named."""
    def case(side):
        q = side.make("pager", n_pages=4, rng=side.R(3),
                      rand_global_phase=False, cpu=cpu)
        _apply_prefix(q)
        side.faults.inject("pager.dispatch", "device-loss", after_n=0,
                           times=None)
        _apply_suffix(q)
        q.GetAmplitude(0)
        built = CPU_BUILT[0]       # before the oracle below
        c = side.tele.snapshot()["counters"]
        assert c.get("elastic.repage.shrink", 0) >= 2
        assert _kind(q.engine) == "dense"
        _assert_oracle_match(side, q)
        return {"state": side.state(q), "cpu_built": built}

    got = _both(case, skip=("host_fetch",))
    assert got["torch"]["events"][-1] == "resilience.failover.pager_to_cuda"
    assert got["torch"]["cpu_built"] == 0


def test_hybrid_unpins_after_device_recovery():
    def case(side):
        h = side.hybrid(tpu_threshold_qubits=2, rng=side.R(3),
                        rand_global_phase=False, cpu=True)
        _apply_prefix(h)
        side.faults.inject(side.site("tpu.compile"), "device-loss",
                           after_n=0, times=None)
        _apply_suffix(h)
        assert h._failed_over == "cpu"
        assert type(h._engine).__name__ == "QEngineCPU"
        side.faults.clear()
        h.X(4)
        assert h._failed_over is None
        assert _kind(h._engine) == "dense"
        h.X(4)
        _assert_oracle_match(side, h)
        return {"state": side.state(h)}

    got = _both(case)
    assert "hybrid.unpin.cpu_to_cuda" in got["torch"]["events"]


# ---------------------------------------------------------------------------
# the persist variable, the fault sites of the other planes
# ---------------------------------------------------------------------------

def test_failover_persist_raises_at_arming(monkeypatch, tmp_path):
    """The failover snapshot file has come with the checkpoint registry:
    arming with QRACK_TPU_FAILOVER_PERSIST set no longer raises, and the
    variable names where the moves write (tests/test_torch_checkpoint.py
    holds the files)."""
    monkeypatch.setenv("QRACK_TPU_FAILOVER_PERSIST", str(tmp_path))
    res.enable()
    assert res.active()


def test_checkpoint_torn_write_is_rejected_on_load(tmp_path):
    from qrack_tpu.checkpoint import container as jc
    from qrack_tpu_torch.checkpoint import container as tc

    arrays = {"a": np.arange(4096, dtype=np.float64)}
    for side, mod in zip(SIDES, (jc, tc)):
        _reset_both()
        side.arm()
        side.faults.inject("checkpoint.save", "torn-write", after_n=0,
                           times=1)
        path = tmp_path / f"{side.name}.qckpt"
        mod.save_container(str(path), arrays, kind="raw")
        with pytest.raises(mod.CheckpointCorrupt):
            mod.load_container(str(path))
        side.faults.inject("checkpoint.restore", "raise", after_n=0,
                           times=1)
        with pytest.raises(side.res.InjectedFault):
            mod.load_container(str(path))


def test_noise_sample_fault_raises_like_jax():
    from qrack_tpu.models.qft import qft_qcircuit as j_qft
    from qrack_tpu.noise import NoiseModel as JNM
    from qrack_tpu.noise import depolarizing as j_dep
    from qrack_tpu.noise import run_trajectories as j_run
    from qrack_tpu_torch.models.qft import qft_qcircuit as t_qft
    from qrack_tpu_torch.noise import NoiseModel as TNM
    from qrack_tpu_torch.noise import depolarizing as t_dep
    from qrack_tpu_torch.noise import run_trajectories as t_run

    for side, (qft, NM, dep, run, kw) in zip(SIDES, (
            (j_qft, JNM, j_dep, j_run, {}),
            (t_qft, TNM, t_dep, t_run, {"device": "cpu"}))):
        _reset_both()
        side.arm()
        side.faults.inject("noise.sample", "hang", after_n=0, times=1)
        with pytest.raises(RuntimeError, match="noise.sample"):
            run(qft(3), NM(default=dep(1e-3)), 4, key=1, **kw)


# ---------------------------------------------------------------------------
# probe library
# ---------------------------------------------------------------------------

def test_probe_roundtrip_ok():
    r = res.run_probe(timeout_s=120.0, device="cpu")
    assert r.ok and not r.timed_out and "PROBE_OK" in r.output
    assert r.command[1:3] == ["-m", "qrack_tpu_torch.resilience.probe"]


def test_probe_timeout_sigterm_first():
    r = res.run_probe(timeout_s=0.3, term_grace_s=10.0,
                      python=sys.executable, device="cpu")
    assert r.duration_s < 60.0
    if r.timed_out:
        assert not r.ok and not r.killed
