"""The port's CheckpointStore (qrack_tpu_torch/checkpoint/store.py) on the
CPU: the store tests of tests/test_checkpoint.py that need no serving
plane, on the port's store, and a store directory that each package
writes and the other reads — the manifest, the session state files,
the journal's circuits, the acks log and the prefix files.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import qrack_tpu_torch as qt
from qrack_tpu_torch import matrices as mat
from qrack_tpu_torch import telemetry as ttele
from qrack_tpu_torch.checkpoint import CheckpointError
from qrack_tpu_torch.checkpoint.store import MANIFEST_VERSION, CheckpointStore
from qrack_tpu_torch.layers.qcircuit import QCircuit, QCircuitGate
from qrack_tpu_torch.utils.rng import QrackRandom


@pytest.fixture(autouse=True)
def _clean():
    yield
    ttele.disable()
    ttele.reset()


def _cpu(n, seed):
    return qt.QEngineCPU(n, rng=QrackRandom(seed))


def test_store_manifest_version_rejection(tmp_path):
    root = str(tmp_path / "store")
    CheckpointStore(root)  # creates manifest
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump({"version": MANIFEST_VERSION + 1, "sessions": {}}, f)
    with pytest.raises(CheckpointError):
        CheckpointStore(root)


def test_store_spill_budget_evicts_oldest(tmp_path):
    store = CheckpointStore(str(tmp_path / "store"), max_bytes=1)
    store.save("s1", _cpu(4, 1))
    time.sleep(0.05)  # distinct mtimes for the age ordering
    store.save("s2", _cpu(4, 2))
    # over budget: the oldest state evicted, the just-written protected
    assert not store.has_state("s1")
    assert store.has_state("s2")


def test_store_budget_never_evicts_live_spilled(tmp_path):
    store = CheckpointStore(str(tmp_path / "store"), max_bytes=1)
    store.protected_sids = lambda: ["s1"]  # s1 is live and spilled
    store.save("s1", _cpu(4, 1))
    time.sleep(0.05)
    store.save("s2", _cpu(4, 2))
    assert store.has_state("s1") and store.has_state("s2")
    time.sleep(0.05)
    store.save("s3", _cpu(4, 3))
    # the oldest UNPROTECTED file (s2) is the victim
    assert store.has_state("s1") and store.has_state("s3")
    assert not store.has_state("s2")


def test_store_dirty_flag_lifecycle(tmp_path):
    store = CheckpointStore(str(tmp_path / "store"))
    store.register("s1", 4, "cpu", 1)
    assert not store.is_dirty("s1")
    store.mark_dirty("s1")
    assert store.is_dirty("s1")
    store.mark_dirty("unknown")  # unregistered sid: no-op, no crash
    store.save("s1", _cpu(4, 1))
    assert not store.is_dirty("s1")  # disk captures the state again
    store.mark_dirty("s1")
    assert CheckpointStore(store.root).is_dirty("s1")


def _circuit():
    circ = QCircuit(3)
    circ.AppendGate(QCircuitGate.single(0, mat.H2))
    circ.AppendGate(QCircuitGate.controlled([0], 2, mat.X2, 1))
    return circ


def test_store_wal_round_trip_and_damage_skip(tmp_path):
    store = CheckpointStore(str(tmp_path / "store"))
    circ = _circuit()
    p1 = store.wal_append("s1", circ)
    p2 = store.wal_append("s2", circ)
    with open(p2, "r+b") as f:  # torn at crash time
        f.truncate(os.path.getsize(p2) // 3)
    entries = store.wal_entries()
    assert [(sid, seq) for sid, seq, _ in entries] == [("s1", 0)]
    got = entries[0][2]
    eng_a = qt.QEngineCPU(3, rng=QrackRandom(5), rand_global_phase=False)
    eng_b = qt.QEngineCPU(3, rng=QrackRandom(5), rand_global_phase=False)
    circ.Run(eng_a)
    got.Run(eng_b)
    assert np.array_equal(eng_a.GetQuantumState(), eng_b.GetQuantumState())
    store.wal_remove(p1)
    assert store.wal_entries() == []


def test_store_lease_acquire_refresh_deny_release(tmp_path):
    ttele.enable()
    store = CheckpointStore(str(tmp_path / "store"))
    assert store.acquire_lease("a")
    assert store.lease_info()["owner"] == "a"
    assert store.acquire_lease("a")  # the holder may refresh
    peer = CheckpointStore(store.root)
    assert not peer.acquire_lease("b")
    assert not peer.release_lease("b")
    assert store.release_lease("a")
    assert store.lease_info() is None
    assert peer.acquire_lease("b")  # free now
    c = ttele.snapshot()["counters"]
    assert c["checkpoint.lease.acquired"] >= 3
    assert c["checkpoint.lease.denied"] >= 1
    assert c["checkpoint.lease.released"] >= 1


def test_store_lease_dead_pid_claimed_over(tmp_path):
    store = CheckpointStore(str(tmp_path / "store"))
    assert store.acquire_lease("dead")
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    path = os.path.join(store.root, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    m["lease"]["pid"] = p.pid  # a pid that no longer exists
    m["lease"]["expires_at"] = time.time() + 9999
    with open(path, "w") as f:
        json.dump(m, f)
    assert CheckpointStore(store.root).acquire_lease("me")


def test_store_lease_cross_host_ttl_fallback(tmp_path):
    store = CheckpointStore(str(tmp_path / "store"))
    path = os.path.join(store.root, "manifest.json")
    lease = {"owner": "far", "host": "elsewhere", "pid": 1,
             "acquired_at": time.time(), "expires_at": time.time() + 60}
    with open(path, "w") as f:
        json.dump({"version": 1, "sessions": {}, "lease": lease}, f)
    assert not store.acquire_lease("me")
    lease["expires_at"] = time.time() - 1
    with open(path, "w") as f:
        json.dump({"version": 1, "sessions": {}, "lease": lease}, f)
    assert store.acquire_lease("me")


def test_store_lock_timeout_bounded(tmp_path, monkeypatch):
    import fcntl

    from qrack_tpu_torch.checkpoint import StoreLockTimeout

    store = CheckpointStore(str(tmp_path / "store"))
    monkeypatch.setenv("QRACK_CKPT_LOCK_TIMEOUT_S", "0.2")
    holder = open(os.path.join(store.root, ".store.lock"), "a+")
    fcntl.flock(holder.fileno(), fcntl.LOCK_EX)
    try:
        t0 = time.monotonic()
        with pytest.raises(StoreLockTimeout):
            store.acquire_lease("me")
        assert time.monotonic() - t0 < 5.0  # bounded, not forever
    finally:
        fcntl.flock(holder.fileno(), fcntl.LOCK_UN)
        holder.close()
    assert store.acquire_lease("me")  # heals the moment the flock frees


def _skew_circuits():
    c1 = QCircuit(3)
    c1.append_1q(0, mat.H2)
    c1.append_ctrl([0], 1, mat.X2, 1)
    c2 = QCircuit(3)
    c2.append_1q(2, mat.H2)
    c2.append_ctrl([2], 0, mat.X2, 1)
    return c1, c2


def test_wal_pending_tags_scoped(tmp_path):
    store = CheckpointStore(str(tmp_path / "store"))
    c1, c2 = _skew_circuits()
    store.wal_append("s1", c1, tag="t-alpha")
    store.wal_append("s2", c2, tag="t-beta")
    store.wal_append("s2", c1)  # untagged
    assert store.wal_pending_tags() == {"t-alpha", "t-beta"}
    assert store.wal_pending_tags(sids=["s2"]) == {"t-beta"}
    assert store.wal_pending_tags(sids=["nope"]) == set()
    store.clear_wal(sids=["s2"])
    assert store.wal_pending_tags() == {"t-alpha"}


def test_store_wal_high_commits_with_state(tmp_path):
    """save(wal_seq=) writes the high-water mark into the state file
    itself and the manifest; state_wal_high reads the file's."""
    store = CheckpointStore(str(tmp_path / "store"))
    store.register("s1", 3, "cpu", 9)
    c1, _ = _skew_circuits()
    p = store.wal_append("s1", c1)
    seq = int(os.path.basename(p).partition("-")[0])
    eng = _cpu(3, 9)
    c1.Run(eng)
    store.save("s1", eng, wal_seq=seq)
    assert store.state_wal_high("s1") == seq
    assert store.sessions()["s1"]["wal_high"] == seq
    back = store.load("s1", device="cpu")
    assert np.array_equal(back.GetQuantumState(), eng.GetQuantumState())


def test_store_acks_and_prefix_round_trip(tmp_path):
    ttele.enable()
    store = CheckpointStore(str(tmp_path / "store"))
    store.ack_tag("t-1")
    assert store.tag_acked("t-1") and not store.tag_acked("t-2")
    arrays = {"planes": np.arange(16, dtype=np.float32).reshape(2, 8)}
    store.save_prefix("ab" * 32, 3, "cuda", arrays, meta={"k": 1})
    assert store.prefix_entries() == [("ab" * 32, 3, "cuda")]
    meta, got = store.load_prefix("ab" * 32, 3, "cuda")
    assert meta["k"] == 1 and np.array_equal(got["planes"], arrays["planes"])
    st = store.stats()
    assert st["spilled_prefixes"] == 1
    assert ttele.snapshot()["gauges"]["checkpoint.store.bytes"] > 0
    store.drop_prefix("ab" * 32, 3, "cuda")
    assert not store.has_prefix("ab" * 32, 3, "cuda")


# ---------------------------------------------------------------------------
# one directory, both packages
# ---------------------------------------------------------------------------

def _fill(store, engine, circuits, seed):
    """Register a session, save its state, journal two circuits (one
    tagged), ack a tag, spill a prefix."""
    store.register("s1", 4, "cpu", seed,
                   engine_kwargs={"rand_global_phase": False})
    store.save("s1", engine, wal_seq=0)
    for i, c in enumerate(circuits):
        store.wal_append("s1", c, tag=f"t-{i}" if i == 0 else None)
    store.ack_tag("t-acked")
    store.save_prefix("cd" * 32, 4, "cpu",
                      {"planes": np.linspace(0, 1, 32, dtype=np.float32)})


def _gates(circ):
    return [(int(g.target), tuple(int(c) for c in g.controls),
             {int(p): np.asarray(m) for p, m in g.payloads.items()})
            for g in circ.gates]


def _same_gates(a, b):
    ga, gb = _gates(a), _gates(b)
    assert len(ga) == len(gb)
    for (ta, ca, pa), (tb, cb, pb) in zip(ga, gb):
        assert ta == tb and ca == cb and sorted(pa) == sorted(pb)
        for k in pa:
            assert np.array_equal(pa[k], pb[k])


def _circuits(circuit_cls):
    """The same two circuits, built with either package's QCircuit."""
    h = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
    x = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    u = np.array([[np.cos(0.3), -np.exp(0.2j) * np.sin(0.3)],
                  [np.exp(0.1j) * np.sin(0.3),
                   np.exp(0.3j) * np.cos(0.3)]])
    c1 = circuit_cls(3)
    c1.append_1q(0, h)
    c1.append_ctrl([0], 1, x, 1)
    c2 = circuit_cls(3)
    c2.append_1q(2, h)
    c2.append_ctrl([2], 0, x, 1)
    c2.append_1q(1, u)
    return [c1, c2]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_store_directory_crosses_packages(direction, tmp_path):
    from qrack_tpu import QEngineCPU as JCPU
    from qrack_tpu.checkpoint.store import CheckpointStore as JStore
    from qrack_tpu.layers.qcircuit import QCircuit as JCircuit
    from qrack_tpu.utils.rng import QrackRandom as JRandom

    root = str(tmp_path / "store")
    if direction == "jax_to_port":
        eng = JCPU(4, rng=JRandom(11), rand_global_phase=False)
        writer, reader_cls = JStore(root), CheckpointStore
        circs = _circuits(JCircuit)
    else:
        eng = qt.QEngineCPU(4, rng=QrackRandom(11), rand_global_phase=False)
        writer, reader_cls = CheckpointStore(root), JStore
        circs = _circuits(QCircuit)
    eng.H(0)
    eng.CNOT(0, 3)
    eng.T(3)
    _fill(writer, eng, circs, 11)
    reader = reader_cls(root)
    rec = reader.sessions()["s1"]
    assert rec["width"] == 4 and rec["seed"] == 11 and rec["wal_high"] == 0
    assert rec["engine_kwargs"] == {"rand_global_phase": False}
    assert reader.state_wal_high("s1") == 0
    loaded = (reader.load("s1", device="cpu") if direction == "jax_to_port"
              else reader.load("s1"))
    assert np.array_equal(np.asarray(loaded.GetQuantumState()),
                          np.asarray(eng.GetQuantumState()))
    assert loaded.rng._gen.bit_generator.state == \
        eng.rng._gen.bit_generator.state
    entries = reader.wal_entries(with_meta=True)
    assert [(sid, seq) for sid, seq, _, _ in entries] == [("s1", 0),
                                                          ("s1", 1)]
    assert entries[0][3]["tag"] == "t-0" and "tag" not in entries[1][3]
    for (_, _, got, _), want in zip(entries, circs):
        _same_gates(got, want)
    assert reader.wal_pending_tags() == {"t-0"}
    assert reader.tag_acked("t-acked")
    assert reader.prefix_entries() == [("cd" * 32, 4, "cpu")]
    meta, arrays = reader.load_prefix("cd" * 32, 4, "cpu")
    assert meta["width"] == 4
    assert np.array_equal(arrays["planes"],
                          np.linspace(0, 1, 32, dtype=np.float32))
    # the reader's writes merge into the writer's manifest
    reader.register("s2", 2, "cpu", 3)
    assert set(reader_cls(root).sessions()) == {"s1", "s2"}
