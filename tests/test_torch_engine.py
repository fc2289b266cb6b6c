"""The port's dense engine (qrack_tpu_torch QEngineCUDA on the CPU)
against the JAX package's "tpu" terminal, on the same gate streams and
the same measurement seeds.

Fusion windows 1 and 16 and QRACK_TPU_FUSE_KERNEL on/off on both sides.
With the kernel on, the port runs its window kernel's plain version and
the JAX side runs its Pallas kernel under the interpreter (seconds per
window), so the JAX side takes the kernel only for the _VOCAB stream;
the random streams hold the port against the JAX window chain, which
computes the same function.  Bars: fidelity >= 1 - 1e-6 (float32 over
a few dozen gates), Prob to 1e-6, equal measurement outcomes.
"""

import numpy as np
import pytest

from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.ops import window_kernel as wk
from qrack_tpu_torch.utils.rng import QrackRandom

N = 6

# the fuser vocabulary with low and high targets and controls
_VOCAB = [
    ("H", (0,)), ("H", (5,)),
    ("RZ", (0.3, 2)), ("T", (4,)), ("S", (1,)),
    ("CZ", (1, 3)), ("CZ", (5, 0)),
    ("CNOT", (0, 1)), ("CNOT", (5, 2)),
    ("X", (3,)), ("RY", (0.7, 3)),
    ("RZ", (1.1, 5)), ("CNOT", (2, 4)),
]


def _fidelity(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)


def _pair(n, seed):
    port = qt.create_quantum_interface("cuda", n, device="cpu",
                                       rng=QrackRandom(seed),
                                       rand_global_phase=False)
    ref = jax_create("tpu", n, rng=JaxRandom(seed), rand_global_phase=False)
    return port, ref


def _random_stream(seed, n, length):
    """Seeded stream of MCMtrxPerm/H/CNOT/RZ/CZ/X/RY calls."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(length):
        kind = int(rng.integers(7))
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        ang = float(rng.uniform(-np.pi, np.pi))
        if kind == 0:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            m, _ = np.linalg.qr(z)
            c = int(rng.choice([q for q in range(n) if q not in (a, b)]))
            out.append(("MCMtrxPerm", ((b, c), m, a, int(rng.integers(4)))))
        else:
            out.append([("H", (a,)), ("CNOT", (a, b)), ("RZ", (ang, a)),
                        ("CZ", (a, b)), ("X", (a,)), ("RY", (ang, a))][kind - 1])
    return out


def _run(port, ref, stream):
    for name, args in stream:
        getattr(port, name)(*args)
        getattr(ref, name)(*args)


def _check_reads(port, ref, n):
    assert _fidelity(port.GetQuantumState(), ref.GetQuantumState()) >= 1 - 1e-6
    for q in range(n):
        assert abs(port.Prob(q) - ref.Prob(q)) <= 1e-6
    # same seeds, same draws: same outcomes
    for q in (0, n - 1):
        assert port.M(q) == ref.M(q)
    assert port.MAll() == ref.MAll()


@pytest.mark.parametrize("window", [1, 16])
@pytest.mark.parametrize("kernel", ["on", "off"])
def test_vocab_stream_matches_jax(window, kernel, monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", str(window))
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", kernel)
    port, ref = _pair(N, 3)
    _run(port, ref, _VOCAB)
    _check_reads(port, ref, N)


@pytest.mark.parametrize("window", [1, 16])
@pytest.mark.parametrize("port_kernel", ["on", "off"])
@pytest.mark.parametrize("seed", [11, 12])
def test_random_stream_matches_jax(window, port_kernel, seed, monkeypatch):
    n = 8
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", str(window))
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "off")
    port, ref = _pair(n, seed)
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", port_kernel)
    stream = _random_stream(seed, n, 60)

    def ref_call(name, *args):
        # the JAX side always flushes through its window chain
        monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "off")
        try:
            return getattr(ref, name)(*args)
        finally:
            monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", port_kernel)

    for k, (name, args) in enumerate(stream):
        getattr(port, name)(*args)
        ref_call(name, *args)
        if k % 20 == 19:  # mid-stream reads flush the windows
            assert abs(port.Prob(k % n) - ref_call("Prob", k % n)) <= 1e-6
    ref_call("Prob", 0)
    _check_reads(port, ref, n)


def test_small_tiles_route_windows_through_pair_sweeps(monkeypatch):
    """With 8-amplitude tiles the engine's windows plan cross-tile
    segments, so the fused flush exercises the pair sweep's plain
    version end to end."""
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "on")
    monkeypatch.setattr(wk, "DEFAULT_BLOCK_POW", 3)
    calls = {"pair": 0}
    real = wk.pair_sweep

    def counting(*a, **kw):
        calls["pair"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(wk, "pair_sweep", counting)
    n = 8
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "off")
    port, ref = _pair(n, 5)
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "on")
    stream = _random_stream(5, n, 40)
    for name, args in stream:
        getattr(port, name)(*args)
    port.Prob(0)
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "off")
    for name, args in stream:
        getattr(ref, name)(*args)
    assert calls["pair"] > 0
    assert _fidelity(port.GetQuantumState(), ref.GetQuantumState()) >= 1 - 1e-6


def test_clone_is_independent(monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "on")
    port, _ = _pair(N, 4)
    for name, args in _VOCAB[:6]:
        getattr(port, name)(*args)
    before = port.GetQuantumState()
    c = port.Clone()
    for name, args in _VOCAB[6:]:
        getattr(port, name)(*args)
    port.Prob(0)
    assert np.array_equal(c.GetQuantumState(), before)
    assert _fidelity(c.GetQuantumState(), port.GetQuantumState()) < 1 - 1e-3
    # and a read hands out a copy, never the resident planes
    st = port.GetQuantumState()
    st[:] = 0
    assert abs(sum(port.Prob(q) for q in range(N))) > 0


def test_blind_overwrite_drops_pending_gates():
    port, ref = _pair(N, 6)
    port.H(0)
    port.CNOT(0, 1)          # pending in the window
    port.SetPermutation(5)   # blind overwrite: the window is dropped
    ref.SetPermutation(5)
    assert _fidelity(port.GetQuantumState(), ref.GetQuantumState()) >= 1 - 1e-12
    assert port.ProbAll(5) == pytest.approx(1.0)


def test_non_f32_planes_are_refused():
    """Planes of a dtype outside the FPPOW set are refused (float64,
    bfloat16 and float16 planes build: test_fppow_planes_build), and so
    is a width past one dense shard."""
    import torch

    for dt in (torch.int32, torch.complex64, "float8"):
        with pytest.raises(ValueError):
            qt.QEngineCUDA(3, dtype=dt, device="cpu")
    with pytest.raises(MemoryError):
        qt.QEngineCUDA(31, device="cpu")


@pytest.mark.parametrize("name", ["float32", "float64", "bfloat16", "float16"])
def test_fppow_planes_build(name):
    """Each FPPOW dtype builds, by argument and through the config's
    FPPOW name (QRACK_TPU_FPPOW), and a Bell pair in it reads back as
    one."""
    import torch

    from qrack_tpu_torch import config

    dt = getattr(torch, name)
    before = config.get_config().real_dtype_name
    config.set_config(real_dtype_name=name)
    try:
        engines = (qt.QEngineCUDA(3, dtype=dt, device="cpu"),
                   qt.QEngineCUDA(3, device="cpu"))
    finally:
        config.set_config(real_dtype_name=before)
    for q in engines:
        assert q.dtype == dt and q.device_planes.dtype == dt
        q.H(0)
        q.CNOT(0, 1)
        assert q.ProbAll(3) == pytest.approx(0.5, abs=1e-2)


def test_alu_without_index_kernels():
    """The ALU ops that once raised here for want of index kernels (MUL)
    now run, as INC does, through the engine's index kernels
    (ops/alu_kernels.py; tests/test_torch_alu.py holds every op)."""
    port, ref = _pair(N, 7)
    for e in (port, ref):
        e.SetPermutation(3)
        e.INC(5, 0, 4)
    assert port.ProbAll(8) == pytest.approx(1.0, abs=1e-6)
    assert _fidelity(port.GetQuantumState(), ref.GetQuantumState()) >= 1 - 1e-6
    for e in (port, ref):
        e.SetPermutation(3)
        e.MUL(3, 0, 3, 3)
    assert port.ProbAll(9) == pytest.approx(1.0, abs=1e-6)
    assert _fidelity(port.GetQuantumState(), ref.GetQuantumState()) >= 1 - 1e-6
