"""The port's noise plane against the JAX package's on the same seeded
inputs: traj_uniform bit for bit; the channels (Kraus sets, priors,
branch sampling, serialisation) equal; QNoisy's branch draws, weights
and kets equal (1e-12 over the complex128 oracle); run_trajectories'
p1 (1e-5), weights (1e-5 relative) and samples (equal) at w <= 8 with
windows 1 and 16, chunked against unchunked, snapshot and resume, and
the dead-trajectory case, all on the CPU device (float32 planes on both
sides); traj_chunk from the measured peak bytes per amplitude.
"""

import json

import numpy as np
import pytest
import torch

from qrack_tpu.layers.qcircuit import QCircuit as JaxCircuit
from qrack_tpu.noise import channels as jch
from qrack_tpu.noise import trajectories as jtraj

from qrack_tpu_torch.layers.qcircuit import QCircuit
from qrack_tpu_torch.noise import channels as ch
from qrack_tpu_torch.noise import trajectories as traj

_H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Z = np.array([[1, 0], [0, -1]], dtype=complex)
_S = np.array([[1, 0], [0, 1j]], dtype=complex)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("QRACK_NOISE_TRAJ_WINDOW", "QRACK_NOISE_TRAJ_CHUNK",
              "QRACK_ROUTE_HBM_BYTES"):
        monkeypatch.delenv(k, raising=False)


def models(pkg):
    """(name, NoiseModel) pairs of a package: mixed-unitary, general and
    per-qubit extras."""
    return {
        "depol": pkg.NoiseModel(default=pkg.depolarizing(0.15)),
        "mixed": pkg.NoiseModel(default=pkg.depolarizing(0.15),
                                per_qubit={0: [pkg.dephasing(0.2)],
                                           2: [pkg.amplitude_damping(0.25)]}),
        "damping": pkg.NoiseModel(default=pkg.amplitude_damping(0.3)),
    }


def circuits(seed, n, depth):
    """The same seeded gates in a circuit of each package: 1-qubit
    payloads of every fusion kind, controlled gates of both control
    values, and a controlled phase (the cphase kind)."""
    port, ref = QCircuit(n), JaxCircuit(n)
    rng = np.random.default_rng(seed)
    for _ in range(depth):
        t = int(rng.integers(n))
        kind = int(rng.integers(5))
        m = [_H, _S, _X,
             np.linalg.qr(rng.standard_normal((2, 2))
                          + 1j * rng.standard_normal((2, 2)))[0],
             np.diag([1.0, np.exp(1j * rng.uniform(-3, 3))])][kind]
        c = int(rng.integers(n))
        if c != t and rng.integers(2):
            perm = 1 if kind == 4 else int(rng.integers(2))
            port.append_ctrl((c,), t, m, perm)
            ref.append_ctrl((c,), t, m, perm)
        else:
            port.append_1q(t, m)
            ref.append_1q(t, m)
    return port, ref


def test_traj_uniform_bit_for_bit():
    for key, tid, seq, dom in [(0, 0, 0, ch.BRANCH_DOMAIN),
                               (7, 3, 11, ch.BRANCH_DOMAIN),
                               (2 ** 40 + 5, 2 ** 40, 12345,
                                ch.MEASURE_DOMAIN),
                               (123456789, 9, 0, ch.MEASURE_DOMAIN)]:
        assert ch.traj_uniform(key, tid, seq, dom) == \
            jch.traj_uniform(key, tid, seq, dom)
    assert (ch.BRANCH_DOMAIN, ch.MEASURE_DOMAIN) == \
        (jch.BRANCH_DOMAIN, jch.MEASURE_DOMAIN)


@pytest.mark.parametrize("name", ["depolarizing", "dephasing",
                                  "amplitude_damping"])
def test_channels_match_jax(name):
    a, b = getattr(ch, name)(0.3), getattr(jch, name)(0.3)
    assert a.name == b.name and a.unitary == b.unitary
    assert np.array_equal(a.priors, b.priors)
    for i in range(len(a)):
        assert np.array_equal(a.kraus[i], b.kraus[i])
        assert np.array_equal(a.branch_matrix(i), b.branch_matrix(i))
    us = np.random.default_rng(3).random(200)
    assert [a.sample(u) for u in us] == [b.sample(u) for u in us]
    assert a.to_dict() == b.to_dict()
    assert ch.KrausChannel.from_dict(b.to_dict()).to_dict() == a.to_dict()
    with pytest.raises(ch.ChannelError):
        ch.kraus_channel("bad", [np.eye(2), np.eye(2)])


def test_noise_model_slots_match_jax():
    a, b = models(ch)["mixed"], models(jch)["mixed"]
    assert [(q, c.name) for q, c in a.slots_for((2, 0, 1))] == \
        [(q, c.name) for q, c in b.slots_for((2, 0, 1))]
    assert a.to_dict() == b.to_dict()
    assert ch.NoiseModel.from_dict(b.to_dict()).to_dict() == a.to_dict()


@pytest.mark.parametrize("name", ["depol", "mixed", "damping"])
def test_qnoisy_draws_match_jax(name):
    n = 3
    port_c, ref_c = circuits(4, n, 12)
    for tid in range(4):
        a = ch.QNoisy(n, model=models(ch)[name], key=5, trajectory_id=tid,
                      rand_global_phase=False, device="cpu")
        b = jch.QNoisy(n, model=models(jch)[name], key=5, trajectory_id=tid,
                       rand_global_phase=False)
        a.run_circuit(port_c)
        b.run_circuit(ref_c)
        assert a.app_seq == b.app_seq
        assert a.weight == pytest.approx(b.weight, rel=1e-12)
        np.testing.assert_allclose(a.GetQuantumState(), b.GetQuantumState(),
                                   atol=1e-12, rtol=0)
        assert a.measure_uniform() == b.measure_uniform()


def test_qnoisy_over_the_dense_engine_matches_the_oracle():
    """QNoisy over the dense "cuda" engine (here on CPU planes) takes the
    branches the complex128 oracle takes, Kraus steps included."""
    n = 3
    port_c, _ = circuits(6, n, 14)
    for tid in range(3):
        a = ch.QNoisy(n, model=models(ch)["mixed"], key=8, trajectory_id=tid,
                      rand_global_phase=False, device="cpu")
        b = ch.QNoisy(n, model=models(ch)["mixed"], key=8, trajectory_id=tid,
                      rand_global_phase=False, device="cpu",
                      inner_layers="cuda")
        a.run_circuit(port_c)
        b.run_circuit(port_c)
        assert b.inner.device.type == "cpu"
        assert a.app_seq == b.app_seq
        assert a.weight == pytest.approx(b.weight, rel=1e-5)
        assert abs(np.vdot(a.GetQuantumState(), b.GetQuantumState())) == \
            pytest.approx(1.0, abs=1e-6)


def assert_runs_match(a, b):
    assert np.array_equal(a.trajectory_ids, b.trajectory_ids)
    assert a.chunks == b.chunks
    np.testing.assert_allclose(a.p1, b.p1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.weights, b.weights, rtol=1e-5, atol=1e-6)
    assert np.array_equal(a.samples, b.samples)


@pytest.mark.parametrize("window", ["0", "1", "16"])
@pytest.mark.parametrize("name", ["depol", "mixed", "damping"])
def test_run_trajectories_match_jax(monkeypatch, window, name):
    monkeypatch.setenv("QRACK_NOISE_TRAJ_WINDOW", window)
    n = 4
    port_c, ref_c = circuits(7, n, 14)
    a = traj.run_trajectories(port_c, models(ch)[name], 6, key=11,
                              keep_planes=True, device="cpu")
    b = jtraj.run_trajectories(ref_c, models(jch)[name], 6, key=11,
                               keep_planes=True)
    assert_runs_match(a, b)
    np.testing.assert_allclose(a.planes, b.planes, atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.aggregate_p1, b.aggregate_p1, atol=1e-5)


def test_run_trajectories_w8_match_jax():
    n = 8
    port_c, ref_c = circuits(8, n, 24)
    a = traj.run_trajectories(port_c, models(ch)["mixed"], 5, key=3,
                              device="cpu")
    b = jtraj.run_trajectories(ref_c, models(jch)["mixed"], 5, key=3)
    assert_runs_match(a, b)
    # the id list, not its order in the batch, decides the randomness
    c = traj.run_trajectories(port_c, models(ch)["mixed"], 2, key=3,
                              trajectory_ids=[3, 1], device="cpu")
    np.testing.assert_allclose(c.p1, a.p1[[3, 1]], atol=1e-6)


def test_batch_matches_the_sequential_oracle():
    """Each trajectory of a batch is the port's QNoisy with its id, on
    the complex128 oracle: the same branches, weight and ket."""
    n = 3
    port_c, _ = circuits(9, n, 10)
    model = models(ch)["mixed"]
    res = traj.run_trajectories(port_c, model, 5, key=21, keep_planes=True,
                                device="cpu")
    for t in range(5):
        eng = ch.QNoisy(n, model=model, key=21, trajectory_id=t,
                        rand_global_phase=False, device="cpu")
        eng.run_circuit(port_c)
        assert eng.weight == pytest.approx(res.weights[t], rel=1e-5)
        got = res.planes[t][0] + 1j * res.planes[t][1]
        assert abs(np.vdot(eng.GetQuantumState(), got)) == \
            pytest.approx(1.0, abs=1e-6)


def test_chunked_matches_unchunked(monkeypatch):
    port_c, ref_c = circuits(13, 3, 10)
    model = models(ch)["mixed"]
    whole = traj.run_trajectories(port_c, model, 6, key=13, keep_planes=True,
                                  device="cpu")
    assert whole.chunks == 1
    monkeypatch.setenv("QRACK_NOISE_TRAJ_CHUNK", "2")
    chunked = traj.run_trajectories(port_c, model, 6, key=13,
                                    keep_planes=True, device="cpu")
    assert chunked.chunks == 3
    assert np.array_equal(chunked.samples, whole.samples)
    np.testing.assert_allclose(chunked.weights, whole.weights, atol=1e-6)
    np.testing.assert_allclose(chunked.planes, whole.planes, atol=1e-5)
    ref = jtraj.run_trajectories(ref_c, models(jch)["mixed"], 6, key=13)
    assert np.array_equal(chunked.samples, ref.samples)


def test_snapshot_resume_round_trip(monkeypatch):
    monkeypatch.setenv("QRACK_NOISE_TRAJ_CHUNK", "2")
    port_c, ref_c = circuits(9, 3, 8)
    model = models(ch)["depol"]
    full = traj.TrajectoryJob(port_c, model, 6, width=3, key=9,
                              device="cpu").run().result()
    assert full.chunks == 3
    job = traj.TrajectoryJob(port_c, model, 6, width=3, key=9, device="cpu")
    job.step()
    assert not job.finished
    snap = json.loads(json.dumps(job.snapshot()))
    assert snap["kind"] == "noise.trajectories" and snap["next"] == 1
    resumed = traj.TrajectoryJob.resume(port_c, model, snap,
                                        device="cpu").run().result()
    assert list(resumed.trajectory_ids) == list(full.trajectory_ids)
    assert np.array_equal(resumed.samples, full.samples)
    assert np.array_equal(resumed.p1, full.p1)
    assert np.array_equal(resumed.weights, full.weights)
    # a JAX snapshot resumes in the port to the JAX package's result
    jjob = jtraj.TrajectoryJob(ref_c, models(jch)["depol"], 6, width=3,
                               key=9)
    jjob.step()
    jsnap = json.loads(json.dumps(jjob.snapshot()))
    jfull = jjob.run().result()
    cross = traj.TrajectoryJob.resume(port_c, model, jsnap,
                                      device="cpu").run().result()
    assert_runs_match(cross, jfull)


def test_dead_trajectory_matches_jax_and_the_oracle():
    """Amplitude damping's K1 on a qubit with no |1> amplitude
    annihilates the state: weight 0 and a |0...0> reset, as in the JAX
    package and QNoisy."""
    pc, rc = QCircuit(1), JaxCircuit(1)
    pc.append_1q(0, _Z)
    rc.append_1q(0, _Z)
    B = 64
    a = traj.run_trajectories(pc, ch.NoiseModel(
        default=ch.amplitude_damping(0.5)), B, key=3, keep_planes=True,
        device="cpu")
    b = jtraj.run_trajectories(rc, jch.NoiseModel(
        default=jch.amplitude_damping(0.5)), B, key=3, keep_planes=True)
    dead = a.weights == 0.0
    assert dead.any() and not dead.all()
    assert np.array_equal(dead, b.weights == 0.0)
    assert_runs_match(a, b)
    np.testing.assert_allclose(a.planes[dead][:, 0, 0], 1.0)
    for i in np.flatnonzero(dead)[:4]:
        eng = ch.QNoisy(1, model=ch.NoiseModel(
            default=ch.amplitude_damping(0.5)), key=3, trajectory_id=int(i),
            device="cpu")
        eng.run_circuit(pc)
        assert eng.weight == 0.0


def test_traj_chunk_from_the_peak_bytes(monkeypatch):
    per = traj.BYTES_PER_AMP * 8   # width 3, float32 planes
    monkeypatch.setenv("QRACK_ROUTE_HBM_BYTES", str(2 * per))
    assert traj.traj_chunk(3, 100, "cpu") == 2
    assert traj.traj_chunk(3, 100, "cpu", torch.float64) == 1
    monkeypatch.setenv("QRACK_ROUTE_HBM_BYTES", str(per - 1))
    with pytest.raises(MemoryError):                  # not even one fits
        traj.traj_chunk(3, 100, "cpu")
    monkeypatch.delenv("QRACK_ROUTE_HBM_BYTES")
    assert traj.budget_bytes("cpu") == traj.DEFAULT_BUDGET_BYTES
    monkeypatch.setenv("QRACK_NOISE_TRAJ_CHUNK", "7")
    assert traj.traj_chunk(3, 100, "cpu") == 7        # explicit override
    assert traj.traj_chunk(3, 4, "cpu") == 4          # clamped to the batch


def test_a_trajectory_over_the_budget_never_starts(monkeypatch):
    """Below one trajectory's peak bytes the job refuses at construction,
    before it allocates any planes; an explicit chunk still runs."""
    port_c, _ = circuits(4, 3, 6)
    model = models(ch)["damping"]
    monkeypatch.setenv("QRACK_ROUTE_HBM_BYTES",
                       str(traj.BYTES_PER_AMP * 8 - 1))
    with pytest.raises(MemoryError, match="width-3"):
        traj.TrajectoryJob(port_c, model, 4, width=3, device="cpu")
    with pytest.raises(MemoryError):
        traj.run_trajectories(port_c, model, 4, width=3, device="cpu")
    monkeypatch.setenv("QRACK_NOISE_TRAJ_CHUNK", "2")
    assert traj.run_trajectories(port_c, model, 4, width=3,
                                 device="cpu").chunks == 2


def test_batched_gate_functions_match_the_single_ket_ones():
    """Each batched function on a batch of distinct kets and payloads
    equals ops/gatekernels.py's on each ket alone."""
    from qrack_tpu_torch.ops import gatekernels as gk

    n, B = 4, 3
    rng = np.random.default_rng(1)
    planes = torch.tensor(rng.standard_normal((B, 2, 1 << n)),
                          dtype=torch.float64)
    mats = [np.linalg.qr(rng.standard_normal((2, 2))
                         + 1j * rng.standard_normal((2, 2)))[0]
            for _ in range(B)]
    mp = torch.tensor(np.stack([np.stack([m.real, m.imag]) for m in mats]))
    d = torch.tensor([[[m[0, 0].real, m[0, 0].imag],
                       [m[1, 1].real, m[1, 1].imag]] for m in mats])
    inv = torch.tensor([[[m[0, 1].real, m[0, 1].imag],
                         [m[1, 0].real, m[1, 0].imag]] for m in mats])
    for t, cm, cv in ((0, 0, 0), (2, 0b1000, 0b1000), (3, 0b0011, 0b0001)):
        got = [traj.apply_2x2(planes, mp, n, t, cm, cv),
               traj.apply_diag(planes, d, n, t, cm, cv),
               traj.apply_invert(planes, inv, n, t, cm, cv)]
        for b in range(B):
            want = [gk.apply_2x2(planes[b], mp[b], n, t, cm, cv),
                    gk.apply_diag(planes[b], *d[b].reshape(-1).tolist(), n,
                                  1 << t, cm, cv),
                    gk.apply_invert(planes[b], *inv[b].reshape(-1).tolist(),
                                    n, t, cm, cv)]
            for g, w in zip(got, want):
                torch.testing.assert_close(g[b], w, atol=1e-14, rtol=0)
        ph = d[:, 1]
        got = traj.apply_cphase(planes, ph, n, t, cm)
        for b in range(B):
            want = gk.apply_diag(planes[b], 1.0, 0.0, *ph[b].tolist(), n,
                                 1 << t, cm, cm)
            torch.testing.assert_close(got[b], want, atol=1e-14, rtol=0)
