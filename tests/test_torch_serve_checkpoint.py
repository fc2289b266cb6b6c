"""The port's serving plane over the checkpoint store against the JAX
package's: the counterparts of tests/test_checkpoint.py's serve, lease,
drain and warm-start tests (the manifest's multi-shape prewarm, spill
and restore, kill and recover, the refusal to replay onto an
unpersisted base, the two-process adoption gated by the lease and the
drain handoff, the cross-host lease takeover, and the every-job
snapshot), plus a serving store written by the JAX package and
recovered by the port's service, the first job after ``prewarm`` as a
program-cache hit, and the kernel libraries found built by a second
process on the same store.

The two-process cases run tests/test_torch_serve_worker.py (dense
``"cuda"`` sessions on the CPU); the parent holds each saved ket
against the JAX package's complex128 oracle at fidelity > 1 - 1e-6
(float32 planes; the JAX child's ``"cpu"`` sessions are held to the
oracle bit for bit).  The store tests that need no serving plane are in
tests/test_torch_checkpoint_store.py.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from qrack_tpu import QEngineCPU as JCPU
from qrack_tpu import create_quantum_interface as j_create
from qrack_tpu.checkpoint.store import CheckpointStore as JStore
from qrack_tpu.serve import QrackService as JService
from qrack_tpu.utils.rng import QrackRandom as JR

from qrack_tpu_torch.checkpoint.store import CheckpointStore as TStore
from qrack_tpu_torch.checkpoint.store import load_circuit as t_load_circuit
from qrack_tpu_torch.checkpoint.warmstart import ProgramManifest
from qrack_tpu_torch.ops import cuda_build
from qrack_tpu_torch.serve import QrackService as TService

from test_torch_serve import (JAX, PORT, _clean_serve,  # noqa: F401
                              both, counters, fidelity, svc)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "test_torch_serve_worker.py")
FID_BAR = 1e-6


def _jax_circuits(width):
    sys.path.insert(0, HERE)
    from _ckpt_serve_child import circuits

    return circuits(width)


def _oracle(width=6, seed=7, n=2):
    """The JAX package's complex128 oracle after the children's c1 (and
    c2 with n=2)."""
    eng = j_create("cpu", width, rng=JR(seed), rand_global_phase=False)
    for c in _jax_circuits(width)[:n]:
        c.Run(eng)
    return np.asarray(eng.GetQuantumState())


def _phase(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, WORKER, *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def _hold(args):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen([sys.executable, WORKER, *args], env=env,
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    line = p.stdout.readline().strip()
    if not line:
        p.wait(30)
        raise AssertionError(p.stderr.read()[-2000:])
    return p, line


# ---------------------------------------------------------------------------
# warm start: ProgramManifest round-trips every recorded shape
# ---------------------------------------------------------------------------

def _manifest_circuit(side, n):
    c = side.Circuit(n)
    for q in range(n):
        c.AppendGate(side.Gate.single(q, side.mat.H2))
    c.AppendGate(side.Gate.controlled([0], n - 1, side.mat.X2, 1))
    return c


def test_program_manifest_multi_shape_prewarm(tmp_path):
    """Every recorded (width, batch) maps to ITS circuit, one file per
    distinct circuit, and a fresh view rebuilds every shape (on the
    CPU, where the records were made)."""
    root = str(tmp_path / "programs")
    m = ProgramManifest(root)
    shapes = [(4, 2), (4, 3), (5, 2), (6, 2)]
    for n, batch in shapes:
        m.record(_manifest_circuit(PORT, n), n, batch, device="cpu")
        m.record(_manifest_circuit(PORT, n), n, batch, device="cpu")
    assert len(m) == len(shapes)
    for key, rec in m._index.items():
        digest = key.rsplit(":", 1)[1]
        assert rec["circuit"] == f"{digest}.qckpt"
        circ, _ = t_load_circuit(os.path.join(root, rec["circuit"]))
        assert circ.shape_key(rec["width"])[2] == digest
        # the JAX package's digest of the same circuit
        assert digest == _manifest_circuit(JAX, rec["width"]).shape_key(
            rec["width"])[2]
    stored = [f for f in os.listdir(root) if f.endswith(".qckpt")]
    assert len(stored) == 3
    m2 = ProgramManifest(root)
    assert m2.prewarm() == len(shapes)


def test_prewarm_makes_the_first_job_a_program_cache_hit(tmp_path,
                                                          monkeypatch):
    """A recovered service that prewarms its store's manifest serves
    its first job from the program cache, on both packages."""
    monkeypatch.setenv("QRACK_SERVE_PREFIX", "0")

    def run(side):
        ck = str(tmp_path / side.name / "ck")
        with svc(side, checkpoint_dir=ck) as a:
            sid = a.create_session(6, seed=1, rand_global_phase=False)
            a.apply(sid, side.qft(6), timeout=60)
            a.drain()
        side.batcher.clear_programs()
        side.tele.enable()
        side.tele.reset()
        with svc(side, checkpoint_dir=ck, recover=True, prewarm=True) as b:
            before = counters(side, "compile.serve_batch")
            b.apply(sid, side.qft(6), timeout=60)
            after = counters(side, "compile.serve_batch")
            state = b.get_state(sid, timeout=60)
        return state, before, after

    (js, jb, ja), (ps, pb, pa) = both(run)
    assert jb == pb == {"compile.serve_batch.miss": 1}
    assert ja == pa == {"compile.serve_batch.miss": 1,
                        "compile.serve_batch.hit": 1}
    want = np.asarray(_oracle_qft2())
    assert fidelity(want, ps) > 1 - FID_BAR and fidelity(js, ps) > 1 - FID_BAR


def _oracle_qft2():
    eng = JCPU(6, rng=JR(1), rand_global_phase=False)
    JAX.qft(6).Run(eng)
    JAX.qft(6).Run(eng)
    return eng.GetQuantumState()


def test_kernel_libraries_found_built_by_a_second_process(tmp_path):
    """The warm start points the kernel builds into the store: the first
    process builds both libraries there (misses), a second process on
    the same store finds them (hits)."""
    from test_torch_telemetry import _fake_nvcc

    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = _fake_nvcc(tmp_path)
    os.symlink(fake, bindir / "nvcc")
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=REPO,
               PATH=f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    got = []
    for _ in range(2):
        r = subprocess.run([sys.executable, WORKER, "warm", ck], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
        line = [x for x in r.stdout.splitlines()
                if x.startswith("KERNELS ")][-1]
        got.append(json.loads(line[len("KERNELS "):]))
    cache = os.path.join(ck, "kernel_cache")
    assert all(d == cache for g in got for d in g["dirs"])
    assert got[0]["counters"] == {"compile.kernel.window_kernel.miss": 1,
                                  "compile.kernel.turboquant_kernel.miss": 1}
    assert got[1]["counters"] == {"compile.kernel.window_kernel.hit": 1,
                                  "compile.kernel.turboquant_kernel.hit": 1}
    assert sorted(f for f in os.listdir(cache) if f.endswith(".so"))
    # this process's own build directory is untouched
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR


# ---------------------------------------------------------------------------
# serve integration: spill/restore continuity + kill-and-recover
# ---------------------------------------------------------------------------

def test_serve_spill_restore_continuity(tmp_path):
    out = str(tmp_path / "state.npy")
    _phase(["spill", str(tmp_path / "ck"), out])
    assert fidelity(np.load(out), _oracle()) > 1 - FID_BAR


def test_serve_kill_and_recover(tmp_path):
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "state.npy")
    _phase(["crash", ck])
    with open(os.path.join(ck, "manifest.json")) as f:
        assert "s000001" in json.load(f)["sessions"]
    assert os.listdir(os.path.join(ck, "wal"))
    _phase(["recover", ck, out])
    assert fidelity(np.load(out), _oracle()) > 1 - FID_BAR


def test_recover_refuses_wal_on_unpersisted_base(tmp_path):
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "state.npy")
    _phase(["stale", ck])
    res = json.loads(_phase(["recover-stale", ck, out])
                     .strip().splitlines()[-1])
    assert res["sessions"] == ["s000001"]
    assert res["recovered_stale"] == ["s000001"]
    assert res["wal_replayed"] == 0 and res["wal_skipped"] == 1
    fresh = np.zeros(1 << 6, dtype=np.complex128)
    fresh[0] = 1.0
    assert np.array_equal(np.load(out), fresh)


def test_two_process_adopt_gated_by_lease_until_kill(tmp_path):
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "state.npy")
    p, line = _hold(["hold", ck])
    try:
        assert line == "READY s000001", line
        _phase(["adopt-denied", ck])
        assert p.poll() is None
    finally:
        p.kill()
    p.wait(30)
    res = json.loads(_phase(["adopt", ck, out]).strip().splitlines()[-1])
    assert res["sessions"] == ["s000001"], res
    assert res["wal_replayed"] == 1 and res["wal_skipped"] == 0, res
    assert fidelity(np.load(out), _oracle()) > 1 - FID_BAR


def test_two_process_drain_handoff(tmp_path):
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "state.npy")
    p, line = _hold(["drain-hold", ck])
    try:
        assert line.startswith("DRAINED "), line
        assert json.loads(line[len("DRAINED "):]) == {
            "drained": ["s000001"], "busy": []}
        res = json.loads(_phase(["adopt", ck, out, "--apply-c2"])
                         .strip().splitlines()[-1])
        assert res["sessions"] == ["s000001"], res
        assert res["wal_replayed"] == 0 and res["wal_skipped"] == 0, res
        p.stdin.write("\n")
        p.stdin.flush()
        assert p.wait(30) == 0, p.stderr.read()[-2000:]
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(30)
    assert fidelity(np.load(out), _oracle()) > 1 - FID_BAR


# ---------------------------------------------------------------------------
# fleet-era store semantics: skew-proof lease takeover, every-job snapshot
# ---------------------------------------------------------------------------

def _skew_circuits(side):
    c1 = side.Circuit(3)
    c1.append_1q(0, side.mat.H2)
    c1.append_ctrl([0], 1, side.mat.X2, 1)
    c2 = side.Circuit(3)
    c2.append_1q(2, side.mat.H2)
    c2.append_ctrl([2], 0, side.mat.X2, 1)
    return c1, c2


def test_cross_host_lease_takeover_clock_skew_zero_double_replay(tmp_path):
    def run(side):
        ck = str(tmp_path / side.name / "ck")
        store = (JStore if side is JAX else TStore)(ck)
        c1, c2 = _skew_circuits(side)
        store.register("s1", 3, "cpu", 9,
                       engine_kwargs={"rand_global_phase": False})
        p1 = store.wal_append("s1", c1)
        seq1 = int(os.path.basename(p1).partition("-")[0])
        store.wal_append("s1", c2)
        eng = side.CPU(3, rng=side.R(9), rand_global_phase=False)
        c1.Run(eng)
        store.save("s1", eng, wal_seq=seq1)
        assert store.sessions()["s1"]["wal_high"] == seq1

        def plant_lease(expires_in_s):
            path = os.path.join(store.root, "manifest.json")
            with open(path) as f:
                m = json.load(f)
            m["lease"] = {"owner": "far", "host": "elsewhere", "pid": 1,
                          "acquired_at": time.time() + 3600,
                          "expires_at": time.time() + expires_in_s}
            with open(path, "w") as f:
                json.dump(m, f)

        held = (__import__("qrack_tpu.checkpoint", fromlist=["x"])
                if side is JAX else
                __import__("qrack_tpu_torch.checkpoint", fromlist=["x"])
                ).StoreLeaseHeld
        s = side.Service(engine_layers="cpu", checkpoint_dir=ck,
                         hold_lease=False, recover=False)
        try:
            plant_lease(60)
            with pytest.raises(held):
                s.recover()
            plant_lease(-1)
            out = s.recover()
            got = s.call("s1", lambda e: e.GetQuantumState()).result(60)
            assert store.wal_entries() == []
        finally:
            s.close()
        return out, np.asarray(got)

    (jo, jg), (po, pg) = both(run)
    for o in (jo, po):
        assert o["sessions"] == ["s1"], o
        assert o["wal_deduped"] == 1 and o["wal_replayed"] == 1, o
        assert o["recovered_stale"] == [], o
    eng = JCPU(3, rng=JR(9), rand_global_phase=False)
    for c in _skew_circuits(JAX):
        c.Run(eng)
    want = np.asarray(eng.GetQuantumState())
    assert np.array_equal(jg, want)
    assert np.allclose(pg, want, atol=1e-12)


def test_ckpt_every_job_mutating_read_keeps_journal_replayable(tmp_path):
    def run(side):
        ck = str(tmp_path / side.name / "ck")
        c1, c2 = _skew_circuits(side)
        s = side.Service(engine_layers="cpu", checkpoint_dir=ck,
                         hold_lease=False, recover=False,
                         checkpoint_every_job=True)
        try:
            sid = s.create_session(3, seed=9, rand_global_phase=False)
            s.apply(sid, c1)
            m = s.measure_all(sid)
            s.prob(sid, 0)
            s.get_state(sid)
            assert s.store.is_dirty(sid) is False
            s.store.wal_append(sid, c2, tag="t-c2")
            s.scheduler.stop()
            s.executor.stop()
            adopter = side.Service(engine_layers="cpu", checkpoint_dir=ck,
                                   hold_lease=False, recover=False)
            try:
                out = adopter.recover(sids=[sid])
                got = adopter.call(sid, lambda e: e.GetQuantumState(),
                                   mutates=False).result(60)
            finally:
                adopter.close()
        finally:
            s.close()
        return m, out, np.asarray(got)

    (jm, jo, jg), (pm, po, pg) = both(run)
    assert jm == pm
    for o in (jo, po):
        assert o["wal_replayed"] == 1 and o["wal_skipped"] == 0, o
        assert o["recovered_stale"] == [], o
    oracle = JCPU(3, rng=JR(9), rand_global_phase=False)
    c1, c2 = _skew_circuits(JAX)
    c1.Run(oracle)
    assert oracle.MAll() == pm
    c2.Run(oracle)
    assert np.allclose(pg, oracle.GetQuantumState(), atol=1e-12)
    assert np.allclose(jg, pg, atol=1e-12)


# ---------------------------------------------------------------------------
# a serving store the JAX package wrote, recovered by the port
# ---------------------------------------------------------------------------

def test_jax_serving_store_recovers_into_the_port(tmp_path):
    """A JAX ``QrackService`` snapshots every job (dense ``"tpu"`` and
    host sessions), journals one more circuit a session and closes
    without ``drain``; the port's service recovers the directory — the
    manifest, the state files (kind ``"tpu"`` into ``QEngineCUDA``) and
    the journal — and every session's ket equals the JAX service's after
    the same journaled circuit."""
    ck = str(tmp_path / "ck")
    c1, c2 = _jax_circuits(6)
    layers = ["tpu", "tpu", "cpu"]
    with JService(engine_layers="tpu", checkpoint_dir=ck, tick_s=0.02,
                  batch_window_ms=2.0, checkpoint_every_job=True) as a:
        sids = [a.create_session(6, layers=lay, seed=k,
                                 rand_global_phase=False)
                for k, lay in enumerate(layers)]
        for k, sid in enumerate(sids):
            a.call(sid, lambda e, k=k: e.X(k)).result(60)
            a.apply(sid, c1, timeout=60)
        for sid in sids:
            a.store.wal_append(sid, c2)
        jstates = []
        for k in range(3):
            eng = JCPU(6, rng=JR(k), rand_global_phase=False)
            eng.X(k)
            c1.Run(eng)
            c2.Run(eng)
            jstates.append(eng.GetQuantumState())
    with TService(engine_layers="cuda", device="cpu", checkpoint_dir=ck,
                  tick_s=0.02, batch_window_ms=2.0) as b:
        out = b.recover()
        engines = {x["sid"]: x["engine"] for x in b.stats()["sessions"]}
        pstates = [b.get_state(sid, timeout=60) for sid in sids]
    assert out["sessions"] == sids
    assert out["wal_replayed"] == 3 and out["recovered_stale"] == []
    assert [engines[s] for s in sids] == ["QEngineCUDA", "QEngineCUDA",
                                          "QEngineCPU"]
    for j, p in zip(jstates, pstates):
        assert fidelity(j, p) > 1 - FID_BAR
