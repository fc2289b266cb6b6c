"""The port's QStabilizer against the JAX package's on the same seeded
streams, after tests/test_stabilizer.py, and the port's native host
helpers (tableau.cpp, hwrng.c).

Bars: kets within 1e-12 (both packages run the same complex128 host
math); the tableaux (x, z, r) and their canonical forms equal bit for
bit; equal measurement outcomes from equal seeds; the text file format
equal byte for byte and loadable across the packages.  Every parity
case runs once over the native tableau library and once over the
Python fallback, on the port's side.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from qrack_tpu.layers.stabilizer import QStabilizer as JaxStabilizer
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch import matrices as mat
from qrack_tpu_torch import native
from qrack_tpu_torch.layers import stabilizer as stab_mod
from qrack_tpu_torch.layers.stabilizer import (CliffordError, QStabilizer,
                                               clifford_sequence)
from qrack_tpu_torch.utils import rng as rng_mod
from qrack_tpu_torch.utils.rng import QrackRandom

ROOT = Path(__file__).resolve().parent.parent
CLIFFORD_1Q = ["H", "X", "Y", "Z", "S", "IS", "SqrtX", "ISqrtX", "SqrtY",
               "ISqrtY"]


def clifford_stream(seed, n, depth):
    """Seeded Clifford calls: the 1-qubit Cliffords, CNOT, CZ, Swap, CY,
    AntiCNOT and a Clifford MCMtrxPerm payload."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(depth):
        kind = int(rng.integers(16))
        t = int(rng.integers(n))
        c = int(rng.integers(n))
        if kind < 10:
            out.append((CLIFFORD_1Q[kind], (t,)))
        elif c != t:
            out.append([("CNOT", (c, t)), ("CZ", (c, t)), ("Swap", (c, t)),
                        ("CY", (c, t)), ("AntiCNOT", (c, t)),
                        ("MCMtrxPerm", ((c,), mat.Z2 * 1j, t, 1))][kind - 10])
    return out


def run(engines, stream):
    for name, args in stream:
        for e in engines:
            getattr(e, name)(*args)


@pytest.fixture(params=["native", "python"])
def tableau_path(request, monkeypatch):
    """The port's tableau loops: the native library or the fallback."""
    if request.param == "native":
        assert native.get_tableau_lib() is not None, "g++ build failed"
    else:
        monkeypatch.setattr(stab_mod, "get_tableau_lib", lambda: None)
    return request.param


def pair(n, seed, rgp=False, init=0):
    return (QStabilizer(n, init_state=init, rng=QrackRandom(seed),
                        rand_global_phase=rgp),
            JaxStabilizer(n, init_state=init, rng=JaxRandom(seed),
                          rand_global_phase=rgp))


def assert_same(port, ref, atol=1e-12):
    for a in ("x", "z", "r"):
        np.testing.assert_array_equal(getattr(port, a), getattr(ref, a))
    for a, b in zip(port._canonical_stab(), ref._canonical_stab()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_random_clifford_streams_match_jax(seed, tableau_path):
    n = 6
    port, ref = pair(n, seed, init=seed)
    run((port, ref), clifford_stream(seed, n, 80))
    assert_same(port, ref)
    for q in range(n):
        assert port.Prob(q) == ref.Prob(q)
        assert port.IsSeparableZ(q) == ref.IsSeparableZ(q)
        assert port.IsSeparableX(q) == ref.IsSeparableX(q)
    assert port.phase_offset == pytest.approx(ref.phase_offset, abs=1e-12)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_measurements_match_jax(seed, tableau_path):
    n = 7
    port, ref = pair(n, seed)
    run((port, ref), clifford_stream(seed, n, 60))
    outs = [(port.M(q), ref.M(q)) for q in (0, 3, 6)]
    assert all(a == b for a, b in outs), outs
    assert_same(port, ref)
    assert port.ForceM(1, False, do_force=False) == ref.ForceM(
        1, False, do_force=False)
    run((port, ref), clifford_stream(seed + 100, n, 30))
    assert port.MAll() == ref.MAll()
    assert_same(port, ref)


def test_force_m_on_zero_branch_raises():
    s = QStabilizer(2, rng=QrackRandom(1))
    with pytest.raises(RuntimeError):
        s.ForceM(0, True)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_compose_decompose_dispose_match_jax(seed, tableau_path):
    n = 6
    port, ref = pair(n, seed)
    run((port, ref), clifford_stream(seed, n, 40))
    other_p, other_r = pair(3, seed + 1)
    run((other_p, other_r), clifford_stream(seed + 1, 3, 20))
    assert port.Compose(other_p) == ref.Compose(other_r) == n
    assert_same(port, ref)
    with pytest.raises(NotImplementedError):
        port.Compose(pair(1, 1)[0], 2)
    # a separable span decomposes out; entangled spans go through the
    # symplectic path
    run((port, ref), [("H", (8,)), ("S", (8,))])
    dp = QStabilizer(2, rng=QrackRandom(seed + 2), rand_global_phase=False)
    dr = JaxStabilizer(2, rng=JaxRandom(seed + 2), rand_global_phase=False)
    port.Decompose(7, dp)
    ref.Decompose(7, dr)
    assert_same(port, ref)
    assert_same(dp, dr)
    port.ForceM(0, False, do_force=False)
    ref.ForceM(0, False, do_force=False)
    port.Dispose(0, 1)
    ref.Dispose(0, 1)
    assert_same(port, ref)
    w = port.qubit_count
    assert port.Allocate(w, 2) == ref.Allocate(w, 2) == w
    run((port, ref), clifford_stream(seed + 3, port.qubit_count, 30))
    assert_same(port, ref)


def test_clifford_recognition_matches_jax():
    from qrack_tpu.layers.stabilizer import clifford_sequence as jax_seq

    for m in (mat.H2, mat.S2, mat.IS2, mat.SQRTX2, mat.ISQRTY2, mat.T2,
              mat.u3_mtrx(0.3, 0.1, 0.2), mat.u3_mtrx(np.pi / 2, 0, np.pi)):
        assert clifford_sequence(m) == jax_seq(m)
    s = QStabilizer(2, rng=QrackRandom(1))
    with pytest.raises(CliffordError):
        s.T(0)
    with pytest.raises(CliffordError):
        s.MCMtrxPerm((0,), mat.T2, 1, 1)


@pytest.mark.parametrize("seed", [31, 32])
def test_set_quantum_state_synthesis_matches_jax(seed):
    n = 4
    donor = QStabilizer(n, rng=QrackRandom(seed), rand_global_phase=False)
    run((donor,), clifford_stream(seed, n, 40))
    ket = donor.GetQuantumState()
    port, ref = pair(n, seed + 1)
    port.SetQuantumState(ket)
    ref.SetQuantumState(ket)
    assert_same(port, ref)
    np.testing.assert_allclose(port.GetQuantumState(), ket, atol=1e-12)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_file_format_round_trip_across_packages(direction, tmp_path):
    n = 5
    port, ref = pair(n, 41)
    run((port, ref), clifford_stream(41, n, 50))
    fp, fr = tmp_path / "port.stab", tmp_path / "jax.stab"
    port.SaveToFile(str(fp))
    ref.SaveToFile(str(fr))
    assert fp.read_bytes() == fr.read_bytes()
    if direction == "jax_to_port":
        loaded = QStabilizer.LoadFromFile(str(fr), rng=QrackRandom(1))
        assert isinstance(loaded, QStabilizer)
        expect = ref
    else:
        loaded = JaxStabilizer.LoadFromFile(str(fp), rng=JaxRandom(1))
        assert isinstance(loaded, JaxStabilizer)
        expect = port
    for a in ("x", "z", "r"):
        np.testing.assert_array_equal(getattr(loaded, a), getattr(expect, a))
    fid = abs(np.vdot(loaded.GetQuantumState(),
                      expect.GetQuantumState())) ** 2
    assert fid == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("seed", [51, 52, 53])
def test_native_and_python_loops_agree(seed, monkeypatch):
    """The port's native library against its own Python fallback:
    ForceM cascades, separability and the canonical form."""
    n = 8
    stream = clifford_stream(seed, n, 90)
    a = QStabilizer(n, rng=QrackRandom(seed), rand_global_phase=False)
    run((a,), stream)
    monkeypatch.setattr(stab_mod, "get_tableau_lib", lambda: None)
    b = QStabilizer(n, rng=QrackRandom(seed), rand_global_phase=False)
    run((b,), stream)
    monkeypatch.undo()
    assert native.get_tableau_lib() is not None
    ca = a._canonical_stab()
    monkeypatch.setattr(stab_mod, "get_tableau_lib", lambda: None)
    cb = b._canonical_stab()
    sep_b = [b.IsSeparableZ(q) for q in range(n)]
    out_b = [b.M(q) for q in range(n)]
    monkeypatch.undo()
    for u, v in zip(ca, cb):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert [a.IsSeparableZ(q) for q in range(n)] == sep_b
    assert [a.M(q) for q in range(n)] == out_b
    for attr in ("x", "z", "r"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))


def test_native_library_builds_into_the_build_dir():
    lib = native.get_tableau_lib()
    assert lib is not None
    path = native.library_path(native.TABLEAU_SRC, "g++")
    assert path.parent == ROOT / "qrack_tpu_torch" / "_build"
    assert path.exists() and path.stat().st_size > 0


_NO_NATIVE_PROBE = r"""
import qrack_tpu_torch as qt
from qrack_tpu_torch import native
from qrack_tpu_torch.utils import rng
q = qt.create_quantum_interface("stabilizer", 4)
q.H(0); q.CNOT(0, 1)
print(native.get_tableau_lib() is None, native.get_hwrng_lib() is None,
      rng.hw_rand64() is None, len(rng.hw_entropy_bytes(8)), q.Prob(1))
"""


def test_no_native_env_takes_the_fallbacks():
    env = dict(os.environ, QRACK_TPU_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", _NO_NATIVE_PROBE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", "True", "True", "8", "0.5"]


def test_unseeded_streams_draw_hardware_entropy():
    a, b = QrackRandom(), QrackRandom()
    assert a._seed != b._seed
    assert len(rng_mod.hw_entropy_bytes(13)) == 13
    if rng_mod.hw_rdrand_supported():
        assert rng_mod.hw_rand64() is not None
    # seeded streams stay PCG64, draw for draw with the JAX package
    p, j = QrackRandom(7), JaxRandom(7)
    assert [p.rand() for _ in range(5)] == [j.rand() for _ in range(5)]
    assert p.spawn()._seed == j.spawn()._seed


def test_stabilizer_terminal_through_the_factory():
    q = qt.create_quantum_interface("stabilizer", 40, rng=QrackRandom(3))
    assert isinstance(q, QStabilizer)
    q.H(0)
    for i in range(39):
        q.CNOT(i, i + 1)
    assert all(abs(q.Prob(i) - 0.5) < 1e-12 for i in range(40))
    r = q.MAll()
    assert r in (0, (1 << 40) - 1)
