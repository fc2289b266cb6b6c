"""The port's TurboQuant engine (qrack_tpu_torch QEngineCUDATurboQuant on
the CPU, where its kernels run their plain versions) against the JAX
package's QEngineTurboQuant under QRACK_USE_PALLAS=1 (interpret mode),
the path the port follows, with the same tile pinned on both sides (the
tile decides which tiles are requantized), the same seeds and
rand_global_phase=False.

Bars: fidelity > 1 - 1e-9 between the packages at int16 (the tests of
the JAX package hold its own Pallas and XLA paths to the same);
> 0.99 against an exact oracle at int8; codes equal bit for bit where
no arithmetic differs (SetPermutation, untouched tiles, files);
probabilities within 1e-5 at int16, where a code unit is 3e-5 of a row
scale and the two packages' float32 rounding moves about 1e-3 of the
codes by one.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU
from qrack_tpu.engines.turboquant import QEngineTurboQuant
from qrack_tpu.storage import turboquant as jtq
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.convert import turboquant_from_numpy
from qrack_tpu_torch.engines.turboquant import QEngineCUDATurboQuant
from qrack_tpu_torch.ops import turboquant_kernel as tqk
from qrack_tpu_torch.storage import turboquant as tq
from qrack_tpu_torch.utils.rng import QrackRandom

TILE = 4


def _fidelity(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("QRACK_USE_PALLAS", "1")


def _pair(n, seed, **kw):
    port = qt.create_quantum_interface("turboquant", n, device="cpu",
                                       rng=QrackRandom(seed),
                                       rand_global_phase=False, **kw)
    ref = QEngineTurboQuant(n, rng=JaxRandom(seed), rand_global_phase=False,
                            **kw)
    port._PALLAS_TILE_POW = TILE
    ref._PALLAS_TILE_POW = TILE
    return port, ref


def _gate_mix(q):
    """tests/test_pallas_kernels.py's mix: generic, diagonal, controlled
    and above-tile gates."""
    for i in range(8):
        q.H(i)
    q.CNOT(0, 3)        # generic inside the tile
    q.T(2)              # diagonal inside the tile
    q.CZ(1, 6)          # diagonal: control low, target above the tile
    q.CNOT(6, 1)        # control above the tile, target low
    q.RZ(0.37, 7)       # diagonal above the tile
    q.CNOT(0, 7)        # generic above the tile: the chunk pair path
    q.RY(0.8, 2)


@pytest.mark.parametrize("window", [1, 16])
def test_gate_mix_matches_jax(window, pallas, monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", str(window))
    port, ref = _pair(8, 70, bits=16, chunk_qb=5, block_pow=2)
    _gate_mix(port)
    _gate_mix(ref)
    assert _fidelity(port.GetQuantumState(), ref.GetQuantumState()) > 1 - 1e-9


def test_kernel_paths_are_taken(monkeypatch):
    """On the CPU every kernel wrapper runs its plain version: the gate
    mix reaches all three entry points (windows, a lone diagonal, a
    lone low 2x2) without a kernel launch."""
    calls = {"gate_low": 0, "diag": 0, "window": 0}
    for name in calls:
        real = getattr(tqk, f"tq_{name}")

        def counting(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tqk, f"tq_{name}", counting)
    tqk.reset_launches()
    port, _ = _pair(8, 3, bits=8, chunk_qb=5, block_pow=2)
    _gate_mix(port)
    port.Prob(0)
    port.T(7)
    port.Prob(0)          # a one-op window: the diagonal entry
    port.H(1)
    port.Prob(0)          # a one-op window: the low 2x2 entry
    assert all(v > 0 for v in calls.values()), calls
    assert sum(tqk.LAUNCHES.values()) == 0


def test_qft_int8_against_oracle():
    n = 9
    port = qt.create_quantum_interface("turboquant", n, device="cpu", bits=8,
                                       chunk_qb=6, block_pow=3,
                                       rand_global_phase=False)
    port._PALLAS_TILE_POW = TILE
    oracle = QEngineCPU(n, rng=JaxRandom(8), rand_global_phase=False)
    for e in (port, oracle):
        e.SetPermutation(0b10110011)
        e.QFT(0, n)
    assert _fidelity(port.GetQuantumState(), oracle.GetQuantumState()) > 0.99
    port.IQFT(0, n)
    assert port.ProbAll(0b10110011) > 0.98


def test_untouched_tiles_keep_codes(pallas):
    """Tiles that fail the high control test keep their codes bit for
    bit (test_pallas_kernels.py's exactness check)."""
    q = qt.create_quantum_interface("turboquant", 7, device="cpu", bits=8,
                                    chunk_qb=4, block_pow=2,
                                    rng=QrackRandom(71),
                                    rand_global_phase=False)
    q._PALLAS_TILE_POW = TILE
    for i in range(7):
        q.H(i)
    before = q._codes.clone().numpy()
    q.CNOT(6, 1)     # control above the 16-amplitude tile
    after = q._codes.numpy()
    rows = (1 << TILE) // 4
    tiles = before.shape[0] // rows
    untouched = 0
    for t in range(tiles):
        sl = slice(t * rows, (t + 1) * rows)
        if ((t << TILE) >> 6) & 1 == 0:
            assert np.array_equal(before[sl], after[sl]), t
            untouched += 1
        else:
            assert not np.array_equal(before[sl], after[sl]), t
    assert untouched == tiles // 2


@pytest.mark.parametrize("bits", [8, 16])
def test_set_permutation_codes_equal(bits, pallas):
    port, ref = _pair(9, 40, bits=bits, chunk_qb=4, block_pow=3)
    for perm, phase in ((0b1_0110_0101, None), (3, 1j),
                        (511, np.exp(0.3j))):
        port.SetPermutation(perm, phase=phase)
        ref.SetPermutation(perm, phase=phase)
        assert np.array_equal(port._codes.numpy(), np.asarray(ref._codes))
        assert np.array_equal(port._scales.numpy(), np.asarray(ref._scales))
    assert port.GetAmplitude(511) == pytest.approx(np.exp(0.3j), abs=2e-2)


def test_measurement_matches_jax(pallas):
    n = 8
    port, ref = _pair(n, 9, bits=16, chunk_qb=4, block_pow=2)
    for e in (port, ref):
        e.H(0)
        e.CNOT(0, 5)
        e.RY(0.9, 7)
        e.H(3)
        e.RZ(0.4, 3)
    for q in range(n):
        assert port.Prob(q) == pytest.approx(ref.Prob(q), abs=1e-5)
    for perm in (0, 0b100001, 0b10100001):
        assert port.ProbAll(perm) == pytest.approx(ref.ProbAll(perm), abs=1e-5)
    assert port.ForceM(0, True) is ref.ForceM(0, True) is True
    assert port.Prob(5) == pytest.approx(ref.Prob(5), abs=1e-5)
    assert port.M(3) == ref.M(3)          # a chunk-local collapse
    assert port.M(7) == ref.M(7)          # a chunk-aligned collapse
    assert port.Prob(7) == pytest.approx(ref.Prob(7), abs=1e-5)
    for e in (port, ref):
        e.H(1)
        e.H(6)
    port.peak_transient_amps = 0
    assert port.MAll() == ref.MAll()
    # two-stage sampling decodes one chunk, never the ket
    assert port.peak_transient_amps <= 1 << 4


def test_amplitude_reads_and_writes_match_jax(pallas):
    port, ref = _pair(7, 50, bits=16, chunk_qb=4, block_pow=2)
    for e in (port, ref):
        for i in range(7):
            e.RY(0.3 + 0.1 * i, i)
        e.CNOT(0, 6)
        e.T(3)
    full = ref.GetQuantumState()
    for perm in (0, 3, 17, 63, 127):
        assert port.GetAmplitude(perm) == pytest.approx(full[perm], abs=1e-5)
    np.testing.assert_allclose(port.GetAmplitudePage(5, 9), full[5:14],
                               atol=1e-5)
    before = port._codes.clone().numpy()
    for e in (port, ref):
        e.SetAmplitude(5, 0.25 - 0.1j)
    assert port.GetAmplitude(5) == pytest.approx(ref.GetAmplitude(5),
                                                 abs=1e-5)
    changed = np.any(port._codes.numpy() != before, axis=1)
    assert list(np.nonzero(changed)[0]) == [5 // 4]
    assert _fidelity(port.GetQuantumState(), ref.GetQuantumState()) > 1 - 1e-9


def test_storage_core_is_bit_identical():
    for d in (2, 8, 128):
        assert np.array_equal(tq.rotation_matrix(d), jtq.rotation_matrix(d))
    assert np.array_equal(tq.rotation_matrix(16, 5), jtq.rotation_matrix(16, 5))
    rng = np.random.default_rng(1)
    st = rng.normal(size=1 << 10) + 1j * rng.normal(size=1 << 10)
    for bits in (8, 16):
        a = tq.quantize_blocks(st, bits=bits, block_pow=4)
        b = jtq.quantize_blocks(st, bits=bits, block_pow=4)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[1].dtype == b[1].dtype and a[2] == b[2]
        np.testing.assert_array_equal(
            tq.dequantize_blocks(*a, bits=bits),
            jtq.dequantize_blocks(*b, bits=bits))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_files_cross_packages(direction, tmp_path, pallas):
    """SaveTurboQuant in one package, LoadTurboQuant in the other, and
    lossy_save/lossy_load the same: the .npz container is shared."""
    from qrack_tpu.checkpoint.container import load_container

    port, ref = _pair(7, 17, bits=8, chunk_qb=4, block_pow=2)
    for e in (port, ref):
        e.H(0)
        e.CNOT(0, 4)
        e.RY(0.7, 6)
    src, Dst = ((ref, QEngineCUDATurboQuant) if direction == "jax_to_port"
                else (port, QEngineTurboQuant))
    path = str(tmp_path / "ket.npz")
    src.SaveTurboQuant(path)
    kind, meta, z = load_container(path)
    assert kind == "turboquant-codes" and z["codes"].dtype == np.int8
    kw = {"device": "cpu"} if Dst is QEngineCUDATurboQuant else {}
    loaded = Dst.LoadTurboQuant(path, rng=QrackRandom(1)
                                if kw else JaxRandom(1), **kw)
    assert np.array_equal(np.asarray(loaded._codes), np.asarray(src._codes))
    assert _fidelity(loaded.GetQuantumState(), src.GetQuantumState()) > 1 - 1e-12

    lossy = str(tmp_path / "lossy")
    src.LossySaveStateVector(lossy, bits=16, block_pow=3)
    (jtq if direction == "port_to_jax" else tq).lossy_load(lossy)
    dst = (qt.create_quantum_interface("cuda", 7, device="cpu")
           if direction == "jax_to_port" else QEngineCPU(7))
    dst.LossyLoadStateVector(lossy)
    assert _fidelity(dst.GetQuantumState(), src.GetQuantumState()) > 1 - 1e-8


def test_convert_carries_a_jax_ket(pallas):
    ref = QEngineTurboQuant(8, bits=8, block_pow=3, rng=JaxRandom(2),
                            rand_global_phase=False)
    for i in range(8):
        ref.RY(0.2 * (i + 1), i)
    port = turboquant_from_numpy(np.asarray(ref._codes),
                                 np.asarray(ref._scales), 8, 8, 3,
                                 ref._tq_seed, device="cpu",
                                 rand_global_phase=False)
    assert np.array_equal(port._codes.numpy(), np.asarray(ref._codes))
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6)


def test_width_caps():
    with pytest.raises(MemoryError):
        QEngineCUDATurboQuant(33, bits=8, device="cpu")
    with pytest.raises(MemoryError):
        QEngineCUDATurboQuant(32, bits=16, device="cpu")
    q = QEngineCUDATurboQuant(4, bits=16, device="cpu")
    with pytest.raises(MemoryError):   # growth past the dense cap
        q._check_capacity(31)


def test_chunk_paths_and_bounded_transients(pallas):
    """Targets above the tile run the plain chunk bodies (low chunks and
    chunk pairs), and a QFT never decodes more than a chunk pair when the
    group is pinned to one chunk."""
    n, chunk_qb = 11, 7
    port, ref = _pair(n, 13, bits=16, chunk_qb=chunk_qb, block_pow=2)
    port._GROUP_AMPS = 1 << chunk_qb
    for e in (port, ref):
        for i in range(n):
            e.H(i)
        e.CNOT(0, 9)          # target above the chunk: pair path
        e.CNOT(9, 5)          # target inside the chunk, above the tile
        e.CZ(6, 10)
        e.RY(0.4, 8)
    assert _fidelity(port.GetQuantumState(), ref.GetQuantumState()) > 1 - 1e-9
    port.SetPermutation(0)
    port.peak_transient_amps = 0
    port.QFT(0, n)
    port.Prob(0)
    assert port.peak_transient_amps <= 2 * (1 << chunk_qb)
    # int16 re+im codes and one float32 scale per 4-amplitude block
    assert port.resident_bytes() == 2 * 2 * (1 << n) + 4 * ((1 << n) // 4)


def test_structure_ops_and_clone(pallas):
    """Compose/Dispose through the dense fallback, normalization as a
    scale update, and Clone as an exact copy."""
    q = qt.create_quantum_interface("turboquant", 4, device="cpu", bits=16,
                                    rng=QrackRandom(21),
                                    rand_global_phase=False)
    o = QEngineCPU(4, rng=JaxRandom(21), rand_global_phase=False)
    for e in (q, o):
        e.H(0)
        e.CNOT(0, 1)
        e.H(3)
    other = qt.create_quantum_interface("turboquant", 2, device="cpu",
                                        bits=16, rand_global_phase=False)
    other.H(0)
    oo = QEngineCPU(2, rand_global_phase=False)
    oo.H(0)
    q.Compose(other)
    o.Compose(oo)
    assert q.qubit_count == 6
    assert _fidelity(q.GetQuantumState(), o.GetQuantumState()) > 1 - 1e-6
    q.Dispose(4, 2)
    o.Dispose(4, 2)
    assert _fidelity(q.GetQuantumState(), o.GetQuantumState()) > 1 - 1e-6
    codes = q._codes.clone()
    dense = q.GetQuantumState()
    q._k_normalize(4.0)
    assert torch.equal(q._codes, codes)
    np.testing.assert_allclose(q.GetQuantumState(), dense / 2, atol=1e-7)
    c = q.Clone()
    assert torch.equal(c._codes, q._codes) and c._codes is not q._codes
    q.H(2)
    q.Prob(2)
    assert torch.equal(c._codes, codes)


def test_kernel_rejects_tiles_beyond_shared_memory():
    q = QEngineCUDATurboQuant(16, bits=8, block_pow=6, device="cpu")
    assert tqk.smem_bytes(q._tq_block_pow, q._pallas_tile_pow()) \
        <= tqk.SMEM_LIMIT
    assert os.environ.get("QRACK_PALLAS_TQ_TILE_QB") or \
        q._pallas_tile_pow() == tqk.DEFAULT_TILE_POW


@pytest.mark.parametrize("window", [1, 16])
def test_drift_escalation_leaves_the_codes_alone(window, pallas,
                                                  monkeypatch):
    """With QRACK_TPU_AUTO_F64_DRIFT set, 150 gates (the check period is
    64) decode nothing, escalate nothing and warn nothing: the compressed
    engine keeps no drift accounting, as in the JAX package, since a norm
    check would decode the whole ket.  The codes equal, bit for bit,
    those of a twin built without the variable."""
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", str(window))
    twin = _pair(8, 72, bits=16, chunk_qb=5, block_pow=2)[0]
    monkeypatch.setenv("QRACK_TPU_AUTO_F64_DRIFT", "1e-12")
    port = _pair(8, 72, bits=16, chunk_qb=5, block_pow=2)[0]
    assert port._drift_thresh == 1e-12 and twin._drift_thresh == 0
    for _ in range(10):
        _gate_mix(twin)
    twin.Finish()

    def decode(self):
        raise AssertionError("the whole ket was decoded")

    real_decode = QEngineCUDATurboQuant._decompress_planes
    monkeypatch.setattr(QEngineCUDATurboQuant, "_decompress_planes", decode)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(10):
            _gate_mix(port)
        port.Finish()
    assert port.dtype == torch.float32
    assert torch.equal(port._codes, twin._codes)
    assert torch.equal(port._scales, twin._scales)
    monkeypatch.setattr(QEngineCUDATurboQuant, "_decompress_planes",
                        real_decode)
    # the ops that decode by design (4x4, uniformly controlled) do not tick
    m4 = np.linalg.qr(np.random.default_rng(72).normal(size=(4, 4)))[0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(70):
            port.Apply4x4(m4, 0, 5)
            port.UniformlyControlledRY((1, 2), 3, [0.1, 0.2, 0.3, 0.4])
    assert port.dtype == torch.float32


def test_plane_dtype_is_float32_only():
    """The codes decode to float32 planes: another dtype is refused, the
    FPPOW policy does not reach the compressed engine, and it has no
    float64 escalation."""
    from qrack_tpu_torch import config

    for dt in (torch.float64, "bfloat16", torch.float16):
        with pytest.raises(ValueError):
            QEngineCUDATurboQuant(4, bits=16, device="cpu", dtype=dt)
    before = config.get_config().real_dtype_name
    config.set_config(real_dtype_name="float64")
    try:
        q = QEngineCUDATurboQuant(4, bits=16, device="cpu")
    finally:
        config.set_config(real_dtype_name=before)
    assert q.dtype == torch.float32
    with pytest.raises(NotImplementedError):
        q.EscalateToF64(0.5)
    assert q.dtype == torch.float32
