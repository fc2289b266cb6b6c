"""The port's telemetry plane (qrack_tpu_torch/telemetry) against the JAX
package's: the counterparts of tests/test_telemetry.py and
tests/test_observability.py that need no serve, fleet or resilience
plane, and counter parity on the same seeded circuits.

Parity: each case runs the same gates through a JAX stack on the CPU and
the port's matching stack with ``device="cpu"``, both packages' telemetry
enabled, and compares the two snapshots' counters name for name after
the namespace's one rename (the dense engine's label ``tpu`` is ``cuda``
in the port).  Counts must be equal; the counters that differ by design
are listed in BY_DESIGN with their reason.  Gauges that are not walls
must be equal too.

The JAX package is imported inside a fixture, so on a machine without
it (the card's: ``python3 -m pytest --noconftest -m cuda
tests/test_torch_telemetry.py``) the parity cases skip and the
``cuda``-marked test runs.  Every test leaves both packages' telemetry
disabled and empty, so a JAX test later in the same worker sees the
inert state it asserts.
"""

import json
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

import qrack_tpu_torch as qt
from qrack_tpu_torch import telemetry as tele
from qrack_tpu_torch.models.qft import qft_qcircuit
from qrack_tpu_torch.ops import cuda_build
from qrack_tpu_torch.telemetry import Histogram, export
from qrack_tpu_torch.utils import timing
from qrack_tpu_torch.utils.rng import QrackRandom

_X = np.array([[0, 1], [1, 0]], complex)


def _quiet(mod):
    mod.disable()
    mod.reset()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Both packages start disabled and empty and are left so."""
    jt = sys.modules.get("qrack_tpu.telemetry")
    for mod in (tele, jt):
        if mod is not None:
            _quiet(mod)
    yield
    jt = sys.modules.get("qrack_tpu.telemetry")
    for mod in (tele, jt):
        if mod is not None:
            _quiet(mod)


@pytest.fixture
def jx():
    """The JAX package's pieces the parity cases drive."""
    pytest.importorskip("jax")
    from qrack_tpu import telemetry as jtele
    from qrack_tpu.factory import create_quantum_interface
    from qrack_tpu.utils.rng import QrackRandom as JaxRandom

    _quiet(jtele)
    return {"tele": jtele, "create": create_quantum_interface,
            "rng": JaxRandom}


def _cpu(layers, n, **kw):
    return qt.create_quantum_interface(layers, n, device="cpu", **kw)


# ---------------------------------------------------------------------------
# disabled path
# ---------------------------------------------------------------------------

def test_disabled_is_inert():
    assert not tele.enabled()
    tele.inc("gate.cpu.2x2.w4")
    tele.gauge("g", 1.0)
    tele.observe("o", 0.1)
    tele.event("stabilizer.to_dense", width=4)
    tele.record_span("r", 0.0, 1.0)
    s = tele.span("anything", sync=torch.zeros(2))
    assert s is tele._NULL_SPAN  # singleton: no per-call allocation
    with s:
        pass
    snap = tele.snapshot()
    assert snap["enabled"] is False
    assert snap["counters"] == {} and snap["gauges"] == {}
    assert snap["spans"] == {} and snap["hists"] == {}
    assert snap["events"] == []


def _whole_stack_run():
    """Every hooked plane of the port once: engines, fuser, pager,
    TurboQuant, the layers, QHybrid's grow and switch, trajectories,
    checkpoint and the factory."""
    from qrack_tpu_torch.checkpoint import container
    from qrack_tpu_torch.noise import NoiseModel, depolarizing
    from qrack_tpu_torch.noise import run_trajectories

    q = _cpu("cuda", 8, rng=QrackRandom(1))
    q.QFT(0, 8)
    q.Swap(0, 7)
    q.XMask(5)
    q.ZMask(6)
    q.Apply4x4(np.eye(4, dtype=complex), 0, 1)
    q.Prob(0)
    o = _cpu("optimal", 10, rng=QrackRandom(2), tpu_threshold_qubits=4)
    for i in range(10):
        o.H(i)
    for i in range(9):
        o.CNOT(i, i + 1)
    o.T(0)
    o.H(0)
    o.T(3)          # non-Clifford on the tableau: the switch to the engine
    o.CNOT(0, 9)
    o.Prob(2)
    o.M(3)
    p = _cpu("pager", 7, n_pages=4, rng=QrackRandom(3))
    p.H(6)
    p.CNOT(6, 0)
    p.Swap(0, 6)
    p.QFT(0, 7)
    p.GetAmplitude(5)
    p2 = _cpu("pager", 6, n_pages=4, remap="off")
    p2.H(5)           # a page-bit target with the planner off
    p2.Prob(5)
    t = _cpu("turboquant", 8, rng=QrackRandom(4))
    t.H(0)
    t.QFT(0, 8)
    t.Prob(7)
    b = _cpu(["bdt_hybrid", "hybrid"], 8, tpu_threshold_qubits=3,
             ratio_threshold=0.1)
    _bdt_switch(b)
    h = _cpu("hybrid", 3, tpu_threshold_qubits=4)
    h.Allocate(3, 2)
    h.Dispose(3, 2, 0)
    circ = qft_qcircuit(4)
    run_trajectories(circ, NoiseModel(default=depolarizing(0.1)), 4,
                     device="cpu")
    return container


def test_disabled_whole_stack_run_records_nothing(tmp_path):
    container = _whole_stack_run()
    path = tmp_path / "c.qckpt"
    container.save_container(str(path), {"a": np.arange(4)})
    container.load_container(str(path))
    snap = tele.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {}
    assert snap["spans"] == {} and snap["hists"] == {}
    assert snap["events"] == []


def test_enabled_whole_stack_run_reaches_every_hook_family(tmp_path):
    tele.enable()
    container = _whole_stack_run()
    path = tmp_path / "c.qckpt"
    container.save_container(str(path), {"a": np.arange(4)})
    container.load_container(str(path))
    c = tele.snapshot()["counters"]
    for name in ("gate.cuda.2x2.w8", "gate.cuda.diag.w8", "gate.cuda.swap.w8",
                 "gate.cuda.permute.w8", "gate.cuda.phase_mask.w8",
                 "gate.cuda.4x4.w8", "fuse.cuda.queued", "fuse.cuda.gates",
                 "fuse.xla.windows", "fuse.kernel.fallback.cpu_backend",
                 "roofline.cuda.fuse.flush.planned_bytes",
                 "qunit.gate.dispatch", "qunit.compose", "qunit.unit_fresh",
                 "qunit.separate", "stabilizer.to_dense", "hybrid.grow.cuda",
                 "hybrid.switch.cuda_to_cpu", "qbdt.to_dense",
                 "exchange.pager.global_2x2", "exchange.pager.bytes",
                 "exchange.pager.host_fetch", "remap.pager.windows",
                 "roofline.pager.exchange.planned_bytes", "tq.sweeps",
                 "fuse.tq.windows", "roofline.tq.sweep.planned_bytes",
                 "noise.traj.batches", "noise.traj.windows",
                 "factory.create_interface", "factory.create.unit",
                 "checkpoint.save", "checkpoint.restore"):
        assert c.get(name, 0) > 0, (name, sorted(c))


def test_enabling_telemetry_changes_no_result():
    def run():
        q = _cpu("cuda", 10, rng=QrackRandom(5), rand_global_phase=False)
        q.SetPermutation(0x1A5)
        q.QFT(0, 10)
        q.H(9)
        q.CNOT(9, 0)
        return q.device_planes.clone()

    off = run()
    tele.enable()
    on = run()
    assert torch.equal(off, on)
    assert tele.snapshot()["counters"]["fuse.cuda.queued"] > 0


# ---------------------------------------------------------------------------
# counters across stacks (test_telemetry.py's counterparts)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stack", ["cpu", "optimal", "turboquant"])
def test_gate_counters_per_stack(stack):
    tele.enable()
    n = 12 if stack == "turboquant" else 6
    q = qt.create_quantum_interface(stack, n, **(
        {} if stack == "cpu" else {"device": "cpu"}))
    q.H(0)
    q.MCMtrxPerm((0,), _X, 1, 1)
    if stack == "optimal":
        q.QFT(0, n)   # non-Clifford phases force the engines underneath
    q.GetQuantumState()
    counters = tele.snapshot()["counters"]
    assert any(k.startswith("gate.") for k in counters), counters
    assert counters.get("factory.create_interface") == 1


@pytest.mark.parametrize("remap", [None, "off"])
def test_exchange_counters_on_pager(remap):
    from qrack_tpu_torch.ops import sharded as shb

    tele.enable()
    kw = {} if remap is None else {"remap": remap}
    q = _cpu("pager", 6, n_pages=4, **kw)
    shb.reset_exchanges()
    q.H(5)   # a page-bit target: the pair exchange, or a remap
    q.GetQuantumState()
    c = tele.snapshot()["counters"]
    moved = [k for k in ("global_2x2", "mixed_swap", "batched_swap")
             if c.get(f"exchange.pager.{k}", 0) >= 1]
    assert moved if remap is None else "global_2x2" in moved
    # fed where sharded.EXCHANGES is bumped: the same numbers
    for k, v in shb.EXCHANGES.items():
        assert c.get(f"exchange.pager.{k}", 0) == v, k
    assert c["roofline.pager.exchange.planned_bytes"] == \
        c["exchange.pager.bytes"] > 0


def test_escalation_events():
    from qrack_tpu_torch.layers.stabilizerhybrid import QStabilizerHybrid

    tele.enable()
    q = QStabilizerHybrid(3, device="cpu")
    q.H(0)
    q.SwitchToEngine()
    snap = tele.snapshot()
    assert snap["counters"].get("stabilizer.to_dense") == 1
    assert "stabilizer.to_dense" in [e["name"] for e in snap["events"]]


def test_f64_escalation_event():
    tele.enable()
    q = _cpu("cuda", 4)
    q.H(0)
    q.EscalateToF64(0.5)
    q.EscalateToF64(0.5)   # already float64: no second event
    ev = [e for e in tele.snapshot()["events"]
          if e["name"] == "engine.cuda.f64_escalation"]
    assert len(ev) == 1 and ev[0]["width"] == 4
    assert ev[0]["observed_norm"] == 0.5




def _fake_nvcc(tmp_path):
    """A stand-in compiler that writes its -o file, so a build runs here."""
    path = tmp_path / "nvcc"
    path.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n'
                    '  shift\ndone\n')
    path.chmod(0o755)
    return str(path)


def test_kernel_library_builds_count_miss_then_hit(tmp_path, monkeypatch):
    src = tmp_path / "probe_kernel.cu"
    src.write_text("// a source\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "nvcc", lambda: _fake_nvcc(tmp_path))
    tele.enable()
    cuda_build.build([src])   # nvcc runs
    cuda_build.build([src])   # found by its source hash
    c = tele.snapshot()["counters"]
    assert c["compile.kernel.probe_kernel.miss"] == 1
    assert c["compile.kernel.probe_kernel.hit"] == 1


def test_fuser_flush_and_drop_reasons():
    tele.enable()
    q = _cpu("cuda", 6)
    for i in range(20):          # a full window flushes before gate 17
        if i % 2:
            q.CNOT(i % 6, (i + 1) % 6)
        else:
            q.RY(0.1 * (i + 1), i % 6)
    q.Prob(0)                    # a read flushes the rest
    q.H(1)
    q.SetPermutation(3)          # a blind overwrite drops the pending H
    c = tele.snapshot()["counters"]
    assert c["fuse.cuda.flush.window_full"] >= 1
    assert c["fuse.cuda.flush.read"] >= 1
    assert c["fuse.cuda.dropped.overwritten"] == 1
    assert c["fuse.cuda.queued"] == 21
    assert c["fuse.cuda.gates"] == 20


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_spans_nest_and_aggregate():
    tele.enable()
    with tele.span("outer"):
        with tele.span("inner"):
            pass
        with tele.span("inner"):
            pass
    spans = tele.snapshot()["spans"]
    assert spans["inner"]["count"] == 2
    assert spans["outer"]["count"] == 1
    assert spans["outer"]["total_s"] >= spans["inner"]["total_s"]
    trace = tele.chrome_trace()["traceEvents"]
    depths = {e["name"]: e["args"]["depth"] for e in trace if e["ph"] == "X"}
    assert depths["outer"] == 0 and depths["inner"] == 1


class _OnCard:
    """A stand-in for a tensor on a CUDA device (only ``.device`` is
    read)."""

    def __init__(self, i):
        self.device = torch.device("cuda", i)


def test_synced_span_synchronises_every_cuda_device(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    tele.enable()
    with tele.span("synced.cpu", sync=torch.zeros(2, 8)):
        pass
    assert calls == []           # a CPU tensor needs no sync
    with tele.span("synced.pages",
                   sync=[_OnCard(0), _OnCard(0), _OnCard(1), torch.zeros(1)]):
        pass
    assert calls == [torch.device("cuda", 0), torch.device("cuda", 1)]
    trace = [e for e in tele.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert all(e["args"]["synced"] for e in trace)
    rec = tele.snapshot()["spans"]["synced.pages"]
    assert rec["count"] == 1 and rec["total_s"] >= 0.0


def test_event_ms_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        timing.event_ms(lambda: None)


# ---------------------------------------------------------------------------
# export round trips
# ---------------------------------------------------------------------------

def test_snapshot_jsonl_round_trip(tmp_path):
    tele.enable()
    tele.inc("gate.cpu.2x2.w4", 3)
    tele.event("stabilizer.to_dense", width=4)
    with tele.span("s"):
        pass
    out = tmp_path / "tele.jsonl"
    tele.write_jsonl(str(out))
    tele.write_jsonl(str(out))  # appends, one object per line
    lines = out.read_text().splitlines()
    assert len(lines) == 2
    snap = json.loads(lines[-1])
    assert snap["counters"]["gate.cpu.2x2.w4"] == 3
    assert snap["spans"]["s"]["count"] == 1
    assert snap["events"][0]["name"] == "stabilizer.to_dense"
    assert snap["events"][0]["width"] == 4


def test_chrome_trace_round_trip(tmp_path):
    tele.enable()
    with tele.span("phase.qft"):
        tele.event("marker")
    tele.inc("gate.cpu.2x2.w4")
    out = tmp_path / "trace.json"
    tele.write_chrome_trace(str(out))
    doc = json.loads(out.read_text())
    evs = doc["traceEvents"]
    assert {"X", "i", "C", "M"} <= {e["ph"] for e in evs}
    x = next(e for e in evs if e["ph"] == "X")
    assert x["name"] == "phase.qft"
    assert x["dur"] >= 0 and isinstance(x["ts"], (int, float))
    c = next(e for e in evs if e["ph"] == "C")
    assert c["args"] == {"value": 1.0}


def test_atexit_env_path(tmp_path, monkeypatch):
    out = tmp_path / "exitdump.jsonl"
    monkeypatch.setenv("QRACK_TPU_TELEMETRY_OUT", str(out))
    tele.enable()
    tele.inc("x")
    export._dump()  # what atexit runs
    assert json.loads(out.read_text().splitlines()[-1])["counters"]["x"] == 1


def test_profiler_bracket_passthrough_when_disabled(tmp_path):
    with tele.profiler_bracket(str(tmp_path)) as path:
        torch.ones(4).add_(1)
    assert path is None
    assert list(tmp_path.iterdir()) == []


def test_profiler_bracket_writes_a_loadable_trace(tmp_path):
    tele.enable()
    with tele.profiler_bracket(str(tmp_path / "prof"), name="qft") as path:
        q = _cpu("cuda", 6)
        q.QFT(0, 6)
        q.Prob(0)
    doc = json.loads(open(path).read())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    ev = [e for e in tele.snapshot()["events"]
          if e["name"] == "telemetry.profiler.dump"]
    assert ev and ev[0]["path"] == path and ev[0]["region"] == "qft"


def test_reset_clears_everything():
    tele.enable()
    tele.inc("a")
    with tele.span("b"):
        pass
    tele.event("c")
    tele.reset()
    snap = tele.snapshot()
    assert snap["counters"] == {} and snap["spans"] == {}
    assert snap["events"] == []
    assert tele.enabled()  # reset clears data, not the enable switch


# ---------------------------------------------------------------------------
# histograms, events, gauges (test_observability.py's counterparts)
# ---------------------------------------------------------------------------

def test_histogram_percentiles_within_slo_bar():
    rng = np.random.default_rng(7)
    vals = np.exp(rng.normal(-5.0, 1.5, size=2000))
    h = Histogram.of(vals.tolist())
    assert h.count == 2000
    for q in (50, 90, 95, 99):
        exact = float(np.percentile(vals, q))
        assert abs(h.percentile(q) - exact) / exact < 0.10, q


def test_histogram_single_sample_merge_and_round_trip():
    h = Histogram.of([0.0123])
    assert h.percentile(50) == pytest.approx(0.0123)
    assert h.mean == pytest.approx(0.0123)
    a = [0.001 * (i + 1) for i in range(100)]
    b = [0.5] * 50
    ha, hb, hall = Histogram.of(a), Histogram.of(b), Histogram.of(a + b)
    ha.merge(hb.to_dict())
    assert ha.count == hall.count and ha.sum == pytest.approx(hall.sum)
    for q in (50, 95, 99):
        assert ha.percentile(q) == pytest.approx(hall.percentile(q))
    d = json.loads(json.dumps(Histogram.of([0.01, 0.1, 1.0]).to_dict()))
    m = Histogram.merge_all([d, d])
    assert m.count == 6
    empty = Histogram()
    assert empty.percentile(50) is None
    for v in (0.0, -1.0, 1e30):
        empty.record(v)
    assert empty.count == 3 and empty.percentile(99) >= 2.0 ** 30


def test_histogram_is_the_jax_packages(jx):
    from qrack_tpu.telemetry import Histogram as JaxHistogram

    vals = np.exp(np.random.default_rng(3).normal(-4.0, 1.0, 500))
    mine, theirs = Histogram.of(vals.tolist()), JaxHistogram.of(vals.tolist())
    assert mine.to_dict() == theirs.to_dict()
    mine.merge(theirs.to_dict())
    theirs.merge(Histogram.of(vals.tolist()).to_dict())
    assert mine.to_dict() == theirs.to_dict()


def test_event_ring_drops_oldest_not_newest(monkeypatch):
    monkeypatch.setattr(tele, "_EVENT_CAP", 8)
    tele.reset()  # rebind the ring at the patched cap
    tele.enable()
    for i in range(11):
        tele.event("ring.probe", i=i)
    snap = tele.snapshot()
    got = [e["i"] for e in snap["events"] if e["name"] == "ring.probe"]
    assert got == list(range(3, 11))
    assert snap["counters"]["telemetry.events.dropped"] == 3
    assert snap["counters"]["ring.probe"] == 11
    monkeypatch.undo()
    tele.reset()


def test_observe_feeds_histogram_and_publishes_slo_gauges():
    tele.enable()
    for v in [0.01] * 50 + [0.1] * 45 + [1.0] * 5:
        tele.observe("x.latency", v)
    assert tele.percentile("x.latency", 50) == pytest.approx(0.01, rel=0.05)
    snap = tele.snapshot()
    assert snap["hists"]["x.latency"]["count"] == 100
    g = snap["gauges"]
    assert g["x.latency.p50"] == pytest.approx(0.01, rel=0.05)
    assert g["x.latency.p95"] == pytest.approx(0.1, rel=0.05)
    assert g["x.latency.p99"] == pytest.approx(1.0, rel=0.05)
    assert snap["spans"]["x.latency"]["count"] == 100


def test_histogram_name_cap_overflow_counted(monkeypatch):
    monkeypatch.setattr(tele, "_HIST_CAP", 2)
    tele.enable()
    tele.observe("cap.a", 0.1)
    tele.observe("cap.b", 0.1)
    tele.observe("cap.c", 0.1)  # beyond the cap: span aggregate only
    snap = tele.snapshot()
    assert set(snap["hists"]) == {"cap.a", "cap.b"}
    assert tele.percentile("cap.c", 50) is None
    assert snap["spans"]["cap.c"]["count"] == 1
    assert snap["counters"]["telemetry.hists.dropped"] == 1


def test_trace_context_spans_events_and_threads():
    tele.enable()
    assert tele.current_trace() is None
    assert tele.set_trace("tag-123") is None
    with tele.span("traced.work"):
        pass
    tele.event("traced.mark")
    with tele.span("pinned.work", trace="job-tag"):
        pass
    seen = {}

    def other():
        seen["before"] = tele.current_trace()
        tele.set_trace("other-tag")

    t = threading.Thread(target=other)
    t.start()
    t.join(30)
    assert not t.is_alive()
    assert tele.set_trace(None) == "tag-123"
    with tele.span("untraced.work"):
        pass
    src = tele.local_trace_source("me")
    by_name = {s["name"]: s for s in src["spans"]}
    assert by_name["traced.work"]["trace"] == "tag-123"
    assert by_name["pinned.work"]["trace"] == "job-tag"
    assert "trace" not in by_name["untraced.work"]
    assert [e for e in src["events"]
            if e["name"] == "traced.mark"][0]["trace"] == "tag-123"
    assert seen["before"] is None     # not inherited by another thread
    assert src["pid"] == os.getpid()


def test_record_span_emits_exact_interval():
    import time

    tele.enable()
    t0 = time.perf_counter() - 0.5
    tele.record_span("recorded.work", t0, 0.125, trace="job-9")
    tele.record_span("recorded.work", t0, 0.25)
    spans = [s for s in tele.local_trace_source()["spans"]
             if s["name"] == "recorded.work"]
    assert spans[0]["dur_s"] == 0.125 and spans[0]["trace"] == "job-9"
    assert spans[1]["dur_s"] == 0.25 and "trace" not in spans[1]
    agg = tele.snapshot()["spans"]["recorded.work"]
    assert agg["count"] == 2 and agg["max_s"] == 0.25


def test_concurrent_inc_observe_span_no_lost_updates():
    tele.enable()
    n, n_threads = 1000, 12
    barrier = threading.Barrier(n_threads)

    def work(k):
        barrier.wait()
        for i in range(n):
            tele.inc("stress.count")
            tele.observe("stress.lat", 0.001 * ((i % 10) + 1))
            with tele.span(f"stress.span.{k}"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = tele.snapshot(include_events=False)
    assert snap["counters"]["stress.count"] == n * n_threads
    assert snap["hists"]["stress.lat"]["count"] == n * n_threads
    assert snap["spans"]["stress.lat"]["count"] == n * n_threads
    for k in range(n_threads):
        assert snap["spans"][f"stress.span.{k}"]["count"] == n


def _src(name, pid, epoch, spans, events=()):
    return {"name": name, "pid": pid, "epoch_unix_s": epoch,
            "spans": list(spans), "events": list(events)}


def test_merged_trace_one_track_per_source_in_wall_order(tmp_path):
    sp = {"dur_s": 0.5, "tid": 1, "depth": 0, "synced": False,
          "trace": "tag1"}
    s1 = _src("a", 500, 1000.0, [{"name": "a.work", "ts_s": 1.0, **sp}],
              [{"name": "a.mark", "t_s": 1.2, "trace": "tag1"}])
    s2 = _src("b", 500, 1000.6, [{"name": "b.work", "ts_s": 0.5,
                                  "dur_s": 0.2, "tid": 9, "depth": 0,
                                  "synced": True, "trace": "tag1"}])
    evs = tele.merged_chrome_trace([s1, s2])["traceEvents"]
    xs = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert xs["a.work"]["pid"] != xs["b.work"]["pid"]
    assert xs["a.work"]["ts"] == pytest.approx(0.0, abs=1e-6)
    assert xs["b.work"]["ts"] == pytest.approx(0.1e6, rel=1e-6)
    assert xs["a.work"]["args"]["trace"] == "tag1"
    assert [e for e in evs if e["ph"] == "i"][0]["args"]["trace"] == "tag1"
    tele.enable()
    with tele.span("merged.local"):
        pass
    path = tmp_path / "merged.json"
    tele.write_merged_chrome_trace(str(path), [tele.local_trace_source("me")])
    assert any(e.get("name") == "merged.local"
               for e in json.loads(path.read_text())["traceEvents"])


def test_flight_recorder_round_trip_and_tail(tmp_path):
    path = tmp_path / "blackbox" / "p0-123.json"
    rec = tele.FlightRecorder(str(path), name="p0", last_n=4)
    assert rec.flush() == {}        # disabled: no box, no I/O
    assert not path.exists()
    tele.enable()
    for i in range(10):
        tele.event("box.mark", i=i)
    with tele.span("box.work"):
        pass
    rec.flush()
    tele.event("second.flush")
    rec.flush()
    box = tele.read_blackbox(str(path))
    assert box["name"] == "p0" and box["pid"] == os.getpid()
    assert box["flush_seq"] == 2
    marks = [e["i"] for e in box["events"] if e["name"] == "box.mark"]
    assert marks == [7, 8, 9]       # the tail, bounded by last_n
    assert any(s["name"] == "box.work" for s in box["spans"])
    assert box["counters"]["box.mark"] == 10
    assert tele.read_blackbox(str(tmp_path / "nope.json")) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tele.read_blackbox(str(bad)) is None


def test_merge_snapshots_recomputes_percentiles():
    fast, slow = Histogram.of([0.01] * 100), Histogram.of([1.0] * 100)
    snaps = [{"counters": {"jobs": 100},
              "gauges": {f"lat.{k}": v for k, v in h.percentiles().items()},
              "hists": {"lat": h.to_dict()},
              "spans": {"lat": {"count": h.count, "total_s": h.sum,
                                "min_s": h.min, "max_s": h.max}}}
             for h in (fast, slow)]
    m = tele.merge_snapshots(snaps)
    assert m["counters"]["jobs"] == 200
    assert m["hists"]["lat"]["count"] == 200
    assert m["gauges"]["lat.p99"] == pytest.approx(1.0, rel=0.05)
    assert m["gauges"]["lat.p50"] == pytest.approx(0.01, rel=0.05)
    assert m["spans"]["lat"]["count"] == 200


# ---------------------------------------------------------------------------
# counter parity with the JAX package
# ---------------------------------------------------------------------------

#: counters that differ between the packages by design, by name pattern
BY_DESIGN = {
    r"compile\..*": "torch traces nothing: the JAX package's jit and "
                    "program-cache counters have no counterpart, and the "
                    "port's kernel-library builds (compile.kernel.*) none "
                    "there",
    r"exchange\.pager\.(remap|meta_swap)": "the JAX pager names the "
                    "collective it dispatches; the port's pager runs its "
                    "exchanges in place and names the pass "
                    "(sharded.EXCHANGES): checked by PASS_OF below",
    r"exchange\.pager\.(batched_swap|mixed_swap|local_swap|page_relabel)":
                    "the port's in-place passes (sharded.EXCHANGES); an "
                    "in-page bit swap is no collective in the JAX pager",
    r"exchange\.pager\.bytes|roofline\.pager\.exchange\..*":
                    "the JAX pager counts each collective's payload; the "
                    "port's passes count the bytes they read and write on "
                    "the card, with no in-page bit swaps around the "
                    "carrier bits (ROADMAP C)",
}
#: a JAX pager collective and the port passes that run it, on the cases
#: below: equal counts
PASS_OF = {"remap": ("batched_swap", "mixed_swap"),
           "meta_swap": ("page_relabel",)}
_WALLS = re.compile(r".*(wall_s|\.rate)(\.p\d+)?$")


def _renamed(name):
    """The one rename: the dense engine's label tpu is cuda here."""
    return re.sub(r"(?<![a-z])tpu(?![a-z])", "cuda", name)


def _by_design(name):
    return any(re.fullmatch(p, name) for p in BY_DESIGN)


def _qft10(q):
    q.SetPermutation(0x2A5)
    q.QFT(0, 10)
    q.H(3)
    q.Prob(3)
    q.GetQuantumState()


def _optimal20(q):
    q.H(0)
    q.MCMtrxPerm((0,), _X, 1, 1)
    q.QFT(0, 20)
    q.Prob(5)
    q.Prob(5)
    q.M(5)


def _pager_gates(q):
    n = q.qubit_count
    rng = np.random.default_rng(5)
    for _ in range(3):
        for t in range(n):
            q.H(t)
            q.RZ(float(rng.uniform(0, 3)), t)
        q.CNOT(n - 1, 0)
        q.CNOT(0, n - 1)
        q.Swap(0, n - 1)
        q.Swap(n - 1, n - 2)
        q.Swap(1, 2)
    q.QFT(0, n)
    q.Prob(n - 1)
    q.GetQuantumState()
    q.GetAmplitude(3)


def _tq_mix(q):
    for i in range(8):
        q.H(i)
    q.CNOT(0, 3)
    q.T(2)
    q.CZ(1, 6)
    q.CNOT(6, 1)
    q.RZ(0.37, 7)
    q.CNOT(0, 7)      # above the tile: the chunk pair path
    q.RY(0.8, 2)
    q.Prob(0)
    q.T(7)
    q.Prob(0)
    q.H(1)
    q.Prob(0)


def _stab_switch(q):
    for i in range(6):
        q.H(i)
    for i in range(5):
        q.CNOT(i, i + 1)
    q.T(0)
    q.H(0)
    q.T(3)
    q.CNOT(0, 5)
    q.Prob(2)
    q.GetQuantumState()


def _hybrid_switch(q):
    q.H(0)
    q.CNOT(0, 1)
    q.Allocate(3, 2)       # past the threshold: grows into the engine
    q.T(4)
    q.RY(0.4, 2)
    q.Prob(2)
    q.Dispose(3, 2, 0)     # back below it: switches to the host engine
    q.Prob(1)


def _unit_multi(q):
    q.H(0)
    q.CNOT(0, 1)
    q.T(1)
    q.H(3)
    q.CNOT(3, 4)
    q.T(4)
    q.CNOT(1, 4)
    q.RedistributeQEngines()
    q.Prob(4)


def _bdt_switch(q):
    rng = np.random.default_rng(9)
    for i in range(8):
        q.H(i)
    for _ in range(3):
        for i in range(7):
            q.MCPhase([i], 1.0, np.exp(1j * rng.uniform(0, 3)), i + 1)
        for i in range(8):
            q.RY(float(rng.uniform(0, 3)), i)
    q.Prob(3)
    q.GetQuantumState()


#: case -> (layers, width, extra kwargs for both, env, gates)
CASES = {
    "qft10_tpu_cuda": ("tpu", 10, {}, {}, _qft10),
    "qft10_kernel_on": ("tpu", 10, {}, {"QRACK_TPU_FUSE_KERNEL": "on"},
                        _qft10),
    "optimal_qft20": ("optimal", 20, {}, {}, _optimal20),
    "pager_4_pages": ("pager", 8, {"n_pages": 4}, {}, _pager_gates),
    "pager_4_pages_remap_off": ("pager", 8, {"n_pages": 4, "remap": "off"},
                                {"QRACK_TPU_FUSE_WINDOW": "1"},
                                _pager_gates),
    "turboquant": ("turboquant", 8, {"bits": 8, "chunk_qb": 5,
                                     "block_pow": 2},
                   {"QRACK_USE_PALLAS": "1"}, _tq_mix),
    "stabilizer_hybrid_switch": (["stabilizer_hybrid", "hybrid"], 6,
                                 {"tpu_threshold_qubits": 3}, {},
                                 _stab_switch),
    "hybrid_switch": ("hybrid", 3, {"tpu_threshold_qubits": 5}, {},
                      _hybrid_switch),
    "optimal_multi_redistribute": ("optimal_multi", 6,
                                   {"device_ids": [0, 0]}, {}, _unit_multi),
    "bdt_hybrid_switch": (["bdt_hybrid", "hybrid"], 8,
                          {"tpu_threshold_qubits": 3,
                           "ratio_threshold": 0.1}, {}, _bdt_switch),
}


def _compare(jsnap, psnap):
    jc = {_renamed(k): v for k, v in jsnap["counters"].items()}
    pc = dict(psnap["counters"])
    diff = {k: (jc.get(k), pc.get(k)) for k in set(jc) | set(pc)
            if not _by_design(k) and jc.get(k) != pc.get(k)}
    assert diff == {}, diff
    for jname, passes in PASS_OF.items():
        assert jc.get(f"exchange.pager.{jname}", 0) == sum(
            pc.get(f"exchange.pager.{p}", 0) for p in passes), jname
    jg = {_renamed(k): v for k, v in jsnap["gauges"].items()
          if not _WALLS.fullmatch(k)}
    pg = {k: v for k, v in psnap["gauges"].items() if not _WALLS.fullmatch(k)}
    assert jg == pg
    return pc


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_match_jax(case, jx, monkeypatch):
    layers, n, kw, env, gates = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jtele = jx["tele"]
    port_layers = "cuda" if layers == "tpu" else layers
    jtele.enable()
    tele.enable()
    j = jx["create"](layers, n, rng=jx["rng"](n), rand_global_phase=False,
                     **kw)
    p = _cpu(port_layers, n, rng=QrackRandom(n), rand_global_phase=False,
             **kw)
    if case == "turboquant":   # the tile decides which tiles requantize
        j._PALLAS_TILE_POW = p._PALLAS_TILE_POW = 4
    gates(j)
    gates(p)
    pc = _compare(jtele.snapshot(), tele.snapshot())
    assert sum(v for k, v in pc.items() if k.startswith("gate.")) > 0


def test_trajectory_counters_match_jax(jx, monkeypatch):
    from qrack_tpu.noise import channels as jch
    from qrack_tpu.noise import trajectories as jtraj
    from qrack_tpu_torch.noise import channels as ch
    from qrack_tpu_torch.noise import trajectories as traj
    from test_torch_noise import circuits, models

    monkeypatch.setenv("QRACK_NOISE_TRAJ_CHUNK", "3")   # 3 chunks of 8
    monkeypatch.setenv("QRACK_NOISE_TRAJ_WINDOW", "5")
    port_c, ref_c = circuits(4, 5, 16)
    jtele = jx["tele"]
    jtele.enable()
    jtraj.run_trajectories(ref_c, models(jch)["mixed"], 8, key=11)
    tele.enable()
    traj.run_trajectories(port_c, models(ch)["mixed"], 8, key=11,
                          device="cpu")
    pc = _compare(jtele.snapshot(), tele.snapshot())
    assert pc["noise.traj.chunks"] == 3 and pc["noise.traj.chunked"] == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_fuse_counters_match_kernel_launches(cuda_device):
    """A w20 QFT on the card with telemetry on: fuse.kernel.sweeps equals
    the window kernel's own launch count over the run, and
    fuse.kernel.windows the windows flushed through it."""
    from qrack_tpu_torch.ops import fusion as fu
    from qrack_tpu_torch.ops import window_kernel as wk

    n = 20
    q = qt.create_quantum_interface("cuda", n)
    q.SetPermutation(0x5A5A5)
    q.device_planes
    windows = []
    real = wk.make_window_fn

    def counting(*a, **k):
        windows.append(a[1])
        return real(*a, **k)

    tele.enable()
    before = tele.snapshot()["counters"]
    l0 = sum(wk.launches().values())
    wk.make_window_fn = counting
    try:
        with tele.span("qft.w20", sync=q.device_planes):
            q.QFT(0, n)
            q.device_planes
    finally:
        wk.make_window_fn = real
    launches = sum(wk.launches().values()) - l0
    after = tele.snapshot()["counters"]

    def d(k):
        return after.get(k, 0) - before.get(k, 0)

    assert launches > 0
    assert d("fuse.kernel.sweeps") == launches
    assert d("fuse.kernel.windows") == len(windows)
    assert d("fuse.kernel.sweeps") == sum(
        fu.kernel_lowering(n, s, cuda_device)[0]["sweeps"] for s in windows)
    assert d("gate.cuda.2x2.w20") + d("gate.cuda.diag.w20") == \
        n * (n + 1) // 2
    assert tele.snapshot()["spans"]["qft.w20"]["count"] == 1
