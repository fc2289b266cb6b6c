"""The port's roofline ledger and perf sentinel (qrack_tpu_torch/telemetry
roofline.py and sentinel.py): the counterparts of tests/test_roofline.py,
with the NVIDIA peak table; its two serving tests run the port's service
alone (this file imports nothing of JAX).

The JAX package's sentinel is stdlib-only, so it is loaded here by file
path (no JAX import) and the shared formulas and verdicts are held to it
line for line.  Byte pins: every planned byte the port's hooks put in
the ledger is the byte math of the counters beside it.
"""

import builtins
import importlib.util
import inspect
import json
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import qrack_tpu_torch as qt
from qrack_tpu_torch import telemetry as tele
from qrack_tpu_torch.telemetry import export, roofline, sentinel

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


def _jax_sentinel():
    spec = importlib.util.spec_from_file_location(
        "jax_package_sentinel", ROOT / "qrack_tpu" / "telemetry" / "sentinel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean_tele(monkeypatch):
    for k in ("QRACK_TPU_PEAK_GBPS", "QRACK_TPU_DEVICE_KIND",
              "QRACK_SERVE_CHECKPOINT_DIR"):
        monkeypatch.delenv(k, raising=False)
    roofline._reset_fingerprint_cache()
    tele.disable()
    tele.reset()
    yield
    tele.disable()
    tele.reset()
    roofline._reset_fingerprint_cache()


# ---------------------------------------------------------------------------
# one formula, one peak table
# ---------------------------------------------------------------------------

def test_shared_formula_and_peak_table(monkeypatch):
    assert sentinel.implied_gbps(1e9, 1.0) == 1.0
    assert sentinel.implied_gbps(2e9, 0.5) == 4.0
    assert sentinel.plane_pass_bytes(20) == 2 * (1 << 20) * 4 * 2
    assert sentinel.plane_pass_bytes(20, esize=2) == 2 * (1 << 20) * 2 * 2
    assert sentinel.peak_gbps(H100) == 3350.0
    assert sentinel.peak_gbps("NVIDIA H100 PCIe") == 2000.0
    assert sentinel.peak_gbps("NVIDIA H200") == 4800.0
    assert sentinel.peak_gbps("NVIDIA A100-SXM4-80GB") == 2039.0
    # cpu/unknown quote their fraction of the H100's roofline
    assert sentinel.peak_gbps("cpu") == 3350.0
    assert sentinel.peak_gbps(None) == 3350.0
    monkeypatch.setenv("QRACK_TPU_PEAK_GBPS", "100")
    assert sentinel.peak_gbps(H100) == 100.0


def test_formulas_and_verdicts_are_the_jax_packages():
    j = _jax_sentinel()
    for nb, wall in ((1e9, 1.0), (3.3e12, 0.9), (5, 0.0)):
        assert sentinel.implied_gbps(nb, wall) == j.implied_gbps(nb, wall)
    for w, e in ((20, 4), (30, 4), (30, 8), (24, 2)):
        assert sentinel.plane_pass_bytes(w, e) == j.plane_pass_bytes(w, e)
    lines = [{"metric": "qft_w30_wall", "value": 0.34},
             {"metric": "qft_w30_wall_committed_evidence", "value": 0.3},
             {"gate": "h", "width": 28, "bits": 8, "wall_s": 0.002},
             {"metric": "x", "avg_wall_s": "bad"}, {"nothing": 1}]
    traj = {"qft_w30_wall": [0.35, 0.4], "gate_h_w28_b8": [0.0021]}
    for line in lines:
        assert sentinel.line_key(line) == j.line_key(line)
        assert sentinel.line_value(line) == j.line_value(line)
        a, b = dict(line), dict(line)
        assert sentinel.stamp(a, traj) == j.stamp(b, traj)
        assert a == b
    for v in (0.2, 0.34, 0.5):
        assert sentinel.verdict("qft_w30_wall", v, traj) == \
            j.verdict("qft_w30_wall", v, traj)


def test_honest_sample_enters_hist_and_gauges():
    tele.enable()
    sample = roofline.record("unit.ok", 1000e9, 1.0, width=30, stack="cuda")
    assert not sample["clamped"]
    assert sample["implied_hbm_gbps"] == 1000.0
    assert sample["hbm_peak_gbps"] == 3350.0
    assert abs(sample["hbm_roofline_frac"] - 1000 / 3350.0) < 1e-3
    snap = tele.snapshot(include_events=False)
    assert snap["counters"]["roofline.unit.ok.dispatches"] == 1
    assert snap["counters"]["roofline.unit.ok.planned_bytes"] == 1000e9
    assert "roofline.unit.ok.implied_hbm_gbps" in snap["hists"]
    assert abs(snap["gauges"]["roofline.unit.ok.peak_frac"]
               - 1000 / 3350.0) < 1e-3
    assert "roofline.unit.ok.cuda.w30.peak_frac" in snap["gauges"]


def test_wall_shorter_than_the_work_is_clamped_and_kept_out():
    tele.enable()
    # 5 TB in 1 s: past the H100's 3350 GB/s, so the clock stopped early
    sample = roofline.record("unit.clamp", 5000e9, 1.0, width=20)
    assert sample["clamped"]
    snap = tele.snapshot(include_events=False)
    assert snap["counters"]["roofline.honesty.clamped"] == 1
    assert snap["counters"]["roofline.unit.clamp.clamped"] == 1
    assert "roofline.unit.clamp.implied_hbm_gbps" not in snap["hists"]
    assert "roofline.unit.clamp.peak_frac" not in snap["gauges"]
    assert "roofline.unit.clamp.w20.peak_frac" not in snap["gauges"]


def test_clamp_threshold_tracks_env_peak(monkeypatch):
    monkeypatch.setenv("QRACK_TPU_PEAK_GBPS", "10")
    roofline._reset_fingerprint_cache()
    tele.enable()
    sample = roofline.record("unit.envpeak", 50e9, 1.0)
    assert sample["hbm_peak_gbps"] == 10.0
    assert sample["clamped"]


def test_record_computes_sample_even_when_disabled():
    sample = roofline.record("unit.off", 100e9, 1.0)
    assert sample["implied_hbm_gbps"] == 100.0
    assert tele.snapshot(include_events=False)["counters"] == {}


def test_note_verdict_counts():
    tele.enable()
    for v in ("better", "worse", "worse", ""):
        roofline.note_verdict(v)
    c = tele.snapshot(include_events=False)["counters"]
    assert c == {"roofline.sentinel.better": 1, "roofline.sentinel.worse": 2}


# ---------------------------------------------------------------------------
# byte pins against the counters beside them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "on"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fuse_flush_bytes_pin(mode, dtype, monkeypatch):
    """Dense-engine window flushes note sweeps * plane_pass_bytes at the
    planes' element size (the window chain pays a sweep an op)."""
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", mode)
    tele.enable()
    eng = qt.create_quantum_interface("cuda", 8, device="cpu", dtype=dtype)
    for q in range(8):
        eng.H(q)
        eng.RZ(0.4, q)
    eng.GetQuantumState()
    c = tele.snapshot(include_events=False)["counters"]
    sweeps = c.get("fuse.kernel.sweeps", 0) + c.get("fuse.xla.sweeps", 0)
    assert sweeps > 0
    assert (c.get("fuse.kernel.sweeps", 0) > 0) == (mode == "on")
    esize = torch.empty((), dtype=dtype).element_size()
    assert c["roofline.cuda.fuse.flush.planned_bytes"] == \
        sweeps * sentinel.plane_pass_bytes(8, esize)


def test_tq_sweep_bytes_pin():
    tele.enable()
    eng = qt.create_quantum_interface("turboquant", 8, device="cpu", bits=8)
    for q in range(8):
        eng.H(q)
        eng.RZ(0.3, q)
    eng.GetQuantumState()
    snap = tele.snapshot(include_events=False)
    c = snap["counters"]
    assert c["tq.sweeps"] > 0
    assert c["roofline.tq.sweep.planned_bytes"] == \
        c["tq.sweeps"] * eng.resident_bytes()
    assert snap["gauges"]["tq.resident.bytes"] == eng.resident_bytes()
    assert snap["gauges"]["tq.resident.dense_equiv_bytes"] == 8 * 2 ** 8


def test_pager_exchange_bytes_pin():
    tele.enable()
    p = qt.create_quantum_interface("pager", 10, n_pages=4, device="cpu")
    for q in range(10):
        p.H(q)
        for j in range(q):
            p.MCPhase([j], 1.0, np.exp(1j * 0.1), q)
    p.GetQuantumState()
    c = tele.snapshot(include_events=False)["counters"]
    assert c["exchange.pager.bytes"] > 0
    assert c["roofline.pager.exchange.planned_bytes"] == \
        c["exchange.pager.bytes"]
    assert c["exchange.pager.host_fetch_bytes"] == 2 * 2 ** 10 * 4


# ---------------------------------------------------------------------------
# sentinel verdicts and evidence files
# ---------------------------------------------------------------------------

def test_sentinel_verdicts_with_noise_band():
    traj = {"qft_w30_wall": [1.0, 1.2]}
    assert sentinel.verdict("qft_w30_wall", 0.85, traj) == "better"
    assert sentinel.verdict("qft_w30_wall", 0.95, traj) == "same"
    assert sentinel.verdict("qft_w30_wall", 1.25, traj) == "worse"
    assert sentinel.verdict("unseen", 1.0, traj) == "new"
    assert sentinel.verdict(None, 1.0, traj) == "new"
    assert sentinel.verdict("qft_w30_wall", 1.05, traj, band=0.01) == "worse"
    fresh = {"metric": "qft_w30_wall", "value": 0.5}
    assert sentinel.stamp(fresh, traj) == "better"
    assert fresh["fresh"] is True and fresh["sentinel_ref_wall_s"] == 1.0
    replay = {"metric": "qft_w30_wall_committed_evidence", "value": 1.0}
    assert sentinel.stamp(replay, traj) == "replay"
    assert replay["fresh"] is False
    line = sentinel.stamp_evidence_line({"metric": "m", "value": 1.0}, {},
                                        stage="s")
    assert line["stage"] == "s" and line["device_class"]["peak_gbps"] == 3350.0


def test_trajectory_reads_only_the_files_it_is_given(tmp_path, monkeypatch):
    """load_trajectory takes its evidence from the caller: the JAX
    package's evidence (docs/tpu_results.jsonl, BENCH_*.json) beside the
    given file is never opened."""
    os.makedirs(tmp_path / "docs")
    (tmp_path / "docs" / "tpu_results.jsonl").write_text(
        json.dumps({"metric": "jax_only", "value": 9.0}) + "\n")
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(
        {"tail": json.dumps({"metric": "jax_only", "value": 9.0})}))
    mine = tmp_path / "port.jsonl"
    mine.write_text("\n".join([
        "warm-up noise",
        json.dumps({"metric": "qft_w30_wall", "value": 0.34}),
        json.dumps({"metric": "qft_w30_wall", "value": 0.001,
                    "suspect_timing": True}),
        json.dumps({"metric": "qft_w30_wall", "value": 0.35}),
    ]) + "\n")
    tail = tmp_path / "run.json"
    tail.write_text(json.dumps({"rc": 0, "tail": 'x\n{"metric": "rcs", '
                                                 '"value": 2.25}\n'}))
    opened = []
    real_open = builtins.open

    def spy(path, *a, **k):
        opened.append(str(path))
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", spy)
    monkeypatch.chdir(tmp_path)
    traj = sentinel.load_trajectory([str(mine), str(tail),
                                     str(tmp_path / "missing.jsonl")])
    monkeypatch.undo()
    assert traj == {"qft_w30_wall": [0.34, 0.35], "rcs": [2.25]}
    assert all("tpu_results" not in p and "BENCH_" not in p for p in opened)
    assert sentinel.load_trajectory([]) == {}
    src = inspect.getsource(sentinel)
    assert "tpu_results" not in src and "glob" not in src


def test_is_clamped_reads_device_class():
    assert sentinel.is_clamped({"implied_hbm_gbps": 5000.0})
    assert not sentinel.is_clamped({"implied_hbm_gbps": 2000.0})
    assert not sentinel.is_clamped({"metric": "x"})
    assert sentinel.is_clamped({"implied_codes_gbps": 3400.0})
    # a line measured on a faster device class keeps its own peak
    assert not sentinel.is_clamped(
        {"implied_hbm_gbps": 4000.0,
         "device_class": {"kind": "NVIDIA H200", "peak_gbps": 4800.0}})


# ---------------------------------------------------------------------------
# device-class fingerprint
# ---------------------------------------------------------------------------

def test_probe_never_initialises_a_device():
    assert not torch.cuda.is_initialized()
    assert roofline._probe_backend() == {}
    fp = roofline.device_class(refresh=True)
    assert fp["kind"] == "unknown" and fp["peak_gbps"] == 3350.0
    assert not torch.cuda.is_initialized()


def test_probe_reads_the_card_from_torch(monkeypatch):
    props = SimpleNamespace(total_memory=85520809984)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: H100)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    fp = roofline.device_class(refresh=True)
    assert fp == {"kind": H100, "platform": "cuda",
                  "hbm_bytes": 85520809984, "n_devices": 1,
                  "peak_gbps": 3350.0}


def test_fingerprint_persist_and_load(tmp_path, monkeypatch):
    monkeypatch.setenv("QRACK_TPU_DEVICE_KIND", H100)
    fp = roofline.device_class(refresh=True)
    assert fp["kind"] == H100 and fp["peak_gbps"] == 3350.0
    path = roofline.persist_fingerprint(str(tmp_path))
    assert path == str(tmp_path / "device_class.json")
    assert roofline.load_fingerprint(str(tmp_path))["kind"] == H100
    # a later process finds it through the checkpoint directory
    monkeypatch.delenv("QRACK_TPU_DEVICE_KIND")
    monkeypatch.setenv("QRACK_SERVE_CHECKPOINT_DIR", str(tmp_path))
    assert roofline.device_class(refresh=True)["kind"] == H100
    # an unknown restart never clobbers a known persisted kind
    monkeypatch.setattr(roofline, "device_class",
                        lambda *a, **k: {"kind": "unknown", "platform": "",
                                         "hbm_bytes": None,
                                         "peak_gbps": 3350.0})
    roofline.persist_fingerprint(str(tmp_path))
    assert roofline.load_fingerprint(str(tmp_path))["kind"] == H100
    assert roofline.load_fingerprint("") is None
    assert roofline.load_fingerprint(str(tmp_path / "none")) is None


def test_roofline_gauges_export_as_counter_tracks():
    tele.enable()
    roofline.record("unit.trace", 1000e9, 1.0, width=20)
    trace = export.chrome_trace()
    cs = [e for e in trace["traceEvents"]
          if e["ph"] == "C" and e["name"] == "roofline.unit.trace.peak_frac"]
    assert cs and abs(cs[0]["args"]["value"] - 1000 / 3350.0) < 1e-3
    src = export.local_trace_source("p0")
    assert "roofline.unit.trace.peak_frac" in src["gauges"]
    merged = export.merged_chrome_trace([src])
    cs = [e for e in merged["traceEvents"]
          if e["ph"] == "C" and e["name"] == "roofline.unit.trace.peak_frac"]
    assert len(cs) == 1 and cs[0]["pid"] == 1


# ---------------------------------------------------------------------------
# the serving plane (ROADMAP item 16b): its dispatch in the ledger, its
# store's fingerprint
# ---------------------------------------------------------------------------

def test_serve_dispatch_records_roofline():
    """A batched job's honest sync records the serve.dispatch sample:
    planned bytes by the JAX package's per-gate model (one plane pass a
    gate a job), beside the wall."""
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.serve import QrackService

    tele.enable()
    with QrackService(engine_layers="cuda", device="cpu",
                      batch_window_ms=2.0, tick_s=0.02) as svc:
        sid = svc.create_session(6, seed=7)
        svc.apply(sid, qft_qcircuit(6), timeout=60)
    snap = tele.snapshot(include_events=False)
    c = snap["counters"]
    assert c["roofline.serve.dispatch.dispatches"] >= 1
    gates = len(qft_qcircuit(6).gates)
    assert c["roofline.serve.dispatch.planned_bytes"] == \
        gates * sentinel.plane_pass_bytes(6) * \
        c["roofline.serve.dispatch.dispatches"]
    assert "roofline.serve.dispatch.implied_hbm_gbps" in snap["hists"]


def test_service_persists_fingerprint(tmp_path, monkeypatch):
    monkeypatch.setenv("QRACK_TPU_DEVICE_KIND", H100)
    roofline._reset_fingerprint_cache()
    from qrack_tpu_torch.serve import QrackService

    with QrackService(engine_layers="cpu",
                      checkpoint_dir=str(tmp_path)) as svc:
        sid = svc.create_session(4, seed=1)
        svc.destroy_session(sid)
    fp = roofline.load_fingerprint(str(tmp_path))
    assert fp is not None and fp["kind"] == H100
    assert os.path.isdir(tmp_path / "kernel_cache")
