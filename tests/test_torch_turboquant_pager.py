"""The port's TurboQuant pager (qrack_tpu_torch/parallel/turboquant_pager.py,
pages on the CPU) against the JAX package's QPagerTurboQuant on the 8
virtual CPU devices of tests/conftest.py: the counterparts of
tests/test_turboquant_engine.py:179-510, plus the chunk programs the
pager runs (engines/turboquant.py with ``_pallas_capable`` False: the
JAX engine's _mk_gate_low, _mk_diag and _mk_fuse_window) and the carry
of a JAX pager's codes through ``convert``.

Both sides get the same seeds and rand_global_phase=False; gates run one
at a time (QRACK_TPU_FUSE_WINDOW=1) where the single engine is compared,
as the JAX tests pin it.  Bars, those of
tests/test_torch_turboquant_engine.py: fidelity > 1 - 1e-9 between the
packages at int16; > 1 - 1e-6 against the exact oracle at int16; codes
bit for bit where no arithmetic differs (SetPermutation, untouched
chunks, files); probabilities within 1e-5 at int16.
"""

import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU
from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu.engines.turboquant import QEngineTurboQuant
from qrack_tpu.models.rcs import reference_rcs_state
from qrack_tpu.parallel.turboquant_pager import QPagerTurboQuant as JaxTQP
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.convert import turboquant_pager_from_numpy
from qrack_tpu_torch.engines.turboquant import QEngineCUDATurboQuant
from qrack_tpu_torch.ops import turboquant_kernel as tqk
from qrack_tpu_torch.parallel.turboquant_pager import QPagerTurboQuant
from qrack_tpu_torch.utils.rng import QrackRandom

from test_engine_matrix import random_circuit


def fidelity(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)


def make_pair(n, seed, n_pages=4, **kw):
    ref = JaxTQP(n, n_pages=n_pages, rng=JaxRandom(seed),
                 rand_global_phase=False, **kw)
    port = QPagerTurboQuant(n, n_pages=n_pages, device="cpu",
                            rng=QrackRandom(seed), rand_global_phase=False,
                            **kw)
    return ref, port


def port_codes(q):
    return q.host_codes()


@pytest.fixture
def per_gate(monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", "1")


@pytest.mark.parametrize("seed", (3, 4))
def test_sharded_turboquant_conformance(seed, per_gate):
    """Pages against the dense oracle, against the JAX pager and against
    the single compressed engine on its chunk programs (the same blocks,
    the same quantization: the paging is numerically invisible)."""
    n = 8
    o = QEngineCPU(n, rng=JaxRandom(seed), rand_global_phase=False)
    ref, s = make_pair(n, seed, bits=16, chunk_qb=4, block_pow=3)
    u = QEngineCUDATurboQuant(n, bits=16, chunk_qb=4, block_pow=3,
                              device="cpu", rng=QrackRandom(seed),
                              rand_global_phase=False)
    u._pallas_capable = False
    for e in (o, ref, s, u):
        random_circuit(e, JaxRandom(300 + seed), 40, n)
    assert fidelity(s.GetQuantumState(), o.GetQuantumState()) > 1 - 1e-6
    assert fidelity(s.GetQuantumState(), ref.GetQuantumState()) > 1 - 1e-9
    assert fidelity(s.GetQuantumState(), u.GetQuantumState()) > 1 - 1e-9


def test_sharded_turboquant_cross_page_targets():
    """Gates whose target lies in the page bits mix partner chunks of two
    pages; controls in all three regions (in-chunk, local chunk bits,
    page bits)."""
    n = 7   # chunk_qb=3: chunk bits [3, 7), 2 local and 2 page bits
    o = QEngineCPU(n, rng=JaxRandom(5), rand_global_phase=False)
    ref, s = make_pair(n, 5, bits=16, chunk_qb=3, block_pow=2)
    for e in (o, ref, s):
        for i in range(n):
            e.H(i)
        e.CNOT(0, n - 1)        # target in the top page bit, control local
        e.CNOT(n - 1, 0)        # control in a page bit, target in-chunk
        e.T(n - 2)
        e.CZ(n - 1, n - 2)      # both in page bits (diagonal)
        e.CNOT(4, 5)            # the local chunk-bit pair path
        e.RY(0.6, n - 1)
        e.CCNOT(4, 6, 5)        # page control, page target
        e.QFT(0, n)
    assert fidelity(s.GetQuantumState(), o.GetQuantumState()) > 1 - 1e-6
    assert fidelity(s.GetQuantumState(), ref.GetQuantumState()) > 1 - 1e-9


def test_sharded_turboquant_measurement_and_collapse():
    n = 6
    ref, s = make_pair(n, 6, bits=16, chunk_qb=3, block_pow=2)
    for e in (ref, s):
        for i in range(n):
            e.H(i)
    # a page-bit measurement: the chunk-aligned collapse, a pure scale
    # update, exact
    r = s.M(n - 1)
    assert r == ref.M(n - 1)
    assert s.Prob(n - 1) == pytest.approx(1.0 if r else 0.0, abs=1e-6)
    # an in-chunk collapse requantizes the touched chunks
    r2 = s.M(0)
    assert r2 == ref.M(0)
    assert s.Prob(0) == pytest.approx(1.0 if r2 else 0.0, abs=1e-4)
    for q in range(n):
        assert s.Prob(q) == pytest.approx(ref.Prob(q), abs=1e-5)
    v = s.MAll()
    assert v == ref.MAll()
    assert ((v >> (n - 1)) & 1) == (1 if r else 0)
    assert (v & 1) == (1 if r2 else 0)


def test_sharded_turboquant_width_and_bytes():
    """The int8 ket divides over the pages; the factory builds it."""
    s = qt.create_quantum_interface("turboquant_pager", 8, bits=8,
                                    chunk_qb=4, n_pages=4, device="cpu",
                                    rng=QrackRandom(7),
                                    rand_global_phase=False)
    ref = jax_create("turboquant_pager", 8, bits=8, chunk_qb=4, n_pages=4,
                     rng=JaxRandom(7), rand_global_phase=False)
    assert isinstance(s, QPagerTurboQuant)
    total = s.resident_bytes()
    assert total < 2 * (1 << 8) * 1.5
    assert s.resident_bytes_per_device() * s.n_pages == total
    assert total == ref.resident_bytes()
    assert s.GetDeviceList() == [-1] * 4
    assert s._pallas_capable is False and s._fuser is None


def test_sharded_turboquant_two_device_lists():
    """Two pagers on different device lists run alike (the JAX package's
    test of two meshes: its program cache keys on the mesh)."""
    a = QPagerTurboQuant(6, bits=16, chunk_qb=3, block_pow=2,
                         devices=["cpu"] * 2, rng=QrackRandom(8),
                         rand_global_phase=False)
    b = QPagerTurboQuant(6, bits=16, chunk_qb=3, block_pow=2,
                         devices=[torch.device("cpu")] * 4, n_pages=2,
                         rng=QrackRandom(8), rand_global_phase=False)
    assert a.n_pages == b.n_pages == 2
    for e in (a, b):
        e.H(0)
        e.CNOT(0, 5)
        e.T(5)
    assert fidelity(a.GetQuantumState(), b.GetQuantumState()) > 1 - 1e-9


def test_sharded_turboquant_dispose_below_page_count():
    """Narrowing below one chunk a page keeps a prefix of the device list
    (_maybe_repage) and stays operable."""
    ref, s = make_pair(4, 9, bits=16, chunk_qb=2, block_pow=1)
    o = QEngineCPU(4, rng=JaxRandom(9), rand_global_phase=False)
    for e in (s, o, ref):
        e.H(0)
        e.CNOT(0, 1)
        e.H(2)
        e.H(3)
    for e in (s, o, ref):
        e.Dispose(2, 2)
    assert s.qubit_count == 2 and s.n_pages == ref.n_pages <= 2
    assert fidelity(s.GetQuantumState(), o.GetQuantumState()) > 1 - 1e-6
    s.H(0)
    assert 0.0 <= s.Prob(0) <= 1.0


def test_structure_ops_width_accounting():
    """Compose, Dispose and Allocate through the dense fallback keep the
    width, on the pager as on the JAX pager."""
    ref, q = make_pair(4, 21, n_pages=2, bits=16)
    o = QEngineCPU(4, rng=JaxRandom(21), rand_global_phase=False)
    for e in (q, o, ref):
        e.H(0)
        e.CNOT(0, 1)
        e.H(3)
    other = QEngineCPU(2, rng=JaxRandom(22), rand_global_phase=False)
    other.H(0)
    for e in (q, o, ref):
        e.Compose(other.Clone())
    assert q.qubit_count == 6
    assert fidelity(q.GetQuantumState(), o.GetQuantumState()) > 1 - 1e-6
    for e in (q, o):
        e.Dispose(4, 2)
        e.Allocate(4, 1)
    assert q.qubit_count == 5
    assert fidelity(q.GetQuantumState(), o.GetQuantumState()) > 1 - 1e-6


def test_gate_is_one_chunk_pass_and_runs_no_kernel(monkeypatch):
    """Every gate is one pass of the chunk programs: no window, no
    kernel (the JAX pager's _pallas_capable = False)."""
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", "16")
    tqk.reset_launches()
    calls = []
    real = QPagerTurboQuant._map_chunks

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(QPagerTurboQuant, "_map_chunks", spy)
    for name in ("tq_gate_low", "tq_diag", "tq_window"):
        monkeypatch.setattr(tqk, name, lambda *a, **k: pytest.fail(name))
    q = QPagerTurboQuant(10, bits=8, chunk_qb=4, block_pow=2, n_pages=4,
                         device="cpu", rng=QrackRandom(30),
                         rand_global_phase=False)
    assert q._n_chunks() == 64 and q._local_chunk_bits() == 4
    q.H(0)                  # in-chunk
    q.T(9)                  # diagonal above the chunk
    q.ZMask(0b1000000011)   # split phase program
    assert len(calls) == 3
    q.CNOT(0, 9)            # page-bit target: the cross-page pair
    q.CNOT(0, 5)            # local chunk-bit target: the in-page pair
    assert len(calls) == 3
    assert sum(tqk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bits", (8, 16))
def test_set_permutation_codes_equal(bits):
    ref, s = make_pair(9, 40, bits=bits, chunk_qb=4, block_pow=3)
    for perm, phase in ((0b1_0110_0101, None), (3, 1j), (511, np.exp(0.3j))):
        s.SetPermutation(perm, phase=phase)
        ref.SetPermutation(perm, phase=phase)
        codes, scales = port_codes(s)
        assert np.array_equal(codes, np.asarray(ref._codes))
        assert np.array_equal(scales, np.asarray(ref._scales))
    assert s.GetAmplitude(511) == pytest.approx(np.exp(0.3j), abs=2e-2)


def test_width_caps_scale_with_bits_and_pages():
    with pytest.raises(MemoryError):
        QPagerTurboQuant(36, bits=8, n_pages=2, device="cpu",
                         rng=QrackRandom(43))
    with pytest.raises(MemoryError):
        QPagerTurboQuant(35, bits=16, n_pages=4, device="cpu",
                         rng=QrackRandom(43))
    with pytest.raises(ValueError, match="too small"):
        QPagerTurboQuant(2, n_pages=4, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        QPagerTurboQuant(6, n_pages=3, devices=["cpu"] * 4)


def test_xeb_quantization_fidelity_sweep():
    """The pager's XEB fidelity equals the single engine's at equal bits
    and the JAX pager's."""
    n, depth, seed = 6, 4, 13
    ideal = reference_rcs_state(
        n, depth, seed, QEngineCPU(n, rng=JaxRandom(1),
                                   rand_global_phase=False))

    def xeb(engine):
        return fidelity(ideal, reference_rcs_state(n, depth, seed, engine))

    u = QEngineCUDATurboQuant(n, bits=16, chunk_qb=3, block_pow=2,
                              device="cpu", rng=QrackRandom(2),
                              rand_global_phase=False)
    u._pallas_capable = False
    f16 = xeb(u)
    ref, s = make_pair(n, 4, bits=16, chunk_qb=3, block_pow=2)
    fs16 = xeb(s)
    assert f16 > 1 - 1e-5
    assert abs(fs16 - f16) < 1e-6
    assert abs(fs16 - xeb(ref)) < 1e-6
    ref8, s8 = make_pair(n, 3, bits=8, chunk_qb=3, block_pow=2)
    f8, jf8 = xeb(s8), xeb(ref8)
    assert f8 > 0.98 and abs(f8 - jf8) < 1e-4


def test_block_local_amplitude_reads():
    ref, s = make_pair(7, 50, bits=16, chunk_qb=3, block_pow=2)
    random_circuit(s, JaxRandom(51), 25, 7)
    random_circuit(ref, JaxRandom(51), 25, 7)
    full = s.GetQuantumState()
    jfull = ref.GetQuantumState()
    for perm in (0, 3, 17, 63, 127):
        assert s.GetAmplitude(perm) == pytest.approx(full[perm], abs=1e-6)
        assert s.GetAmplitude(perm) == pytest.approx(jfull[perm], abs=1e-5)
    page = s.GetAmplitudePage(5, 40)   # straddles blocks and pages
    np.testing.assert_allclose(page, full[5:45], atol=1e-6)


def test_block_local_set_amplitude_sharded():
    ref, s = make_pair(6, 61, bits=16, chunk_qb=3, block_pow=2)
    for e in (ref, s):
        e.H(0)
    before, _ = port_codes(s)
    for e in (ref, s):
        e.SetAmplitude(33, 0.5 + 0.25j)
    assert s.GetAmplitude(33) == pytest.approx(0.5 + 0.25j, abs=1e-3)
    after, _ = port_codes(s)
    changed = np.any(after != before, axis=1)
    assert changed[33 // s._block] and changed.sum() == 1
    codes, scales = port_codes(s)
    assert np.array_equal(codes, np.asarray(ref._codes))
    for e in (ref, s):
        e.H(1)
    assert s.Prob(1) == pytest.approx(ref.Prob(1), abs=1e-5)


def test_convert_carries_a_jax_pager(per_gate):
    """A running JAX pager's codes, scales and page count land in the
    port's pager: the same ket, and the same gates after."""
    ref = JaxTQP(8, bits=16, chunk_qb=4, block_pow=3, n_pages=4,
                 rng=JaxRandom(12), rand_global_phase=False)
    random_circuit(ref, JaxRandom(13), 30, 8)
    port = turboquant_pager_from_numpy(
        np.asarray(ref._codes), np.asarray(ref._scales), 8, 16, 3,
        ref._tq_seed, ref.n_pages, device="cpu", chunk_qb=4,
        rng=QrackRandom(12), rand_global_phase=False)
    assert port.n_pages == 4 and port._tq_chunk_pow == ref._tq_chunk_pow
    codes, scales = port_codes(port)
    assert np.array_equal(codes, np.asarray(ref._codes))
    assert np.array_equal(scales, np.asarray(ref._scales))
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6)
    for e in (ref, port):
        random_circuit(e, JaxRandom(14), 20, 8)
    # 20 requantizations apart: codes a unit apart at rounding-boundary
    # ties (about 2e-5 of an amplitude at int16), so this seed lands at
    # an infidelity of 2.2e-9: the bar is 1e-8, and Prob's 1e-5
    f = fidelity(port.GetQuantumState(), ref.GetQuantumState())
    assert f > 1 - 1e-8
    for q in range(8):
        assert port.Prob(q) == pytest.approx(ref.Prob(q), abs=1e-5)


def test_files_cross_packages(tmp_path):
    """A pager's SaveTurboQuant file loads into a single JAX engine (the
    codes are the whole ket in chunk order)."""
    s = QPagerTurboQuant(7, bits=16, chunk_qb=3, block_pow=2, n_pages=4,
                         device="cpu", rng=QrackRandom(70),
                         rand_global_phase=False)
    random_circuit(s, JaxRandom(71), 20, 7)
    path = str(tmp_path / "tqp")
    s.SaveTurboQuant(path)
    j = QEngineTurboQuant.LoadTurboQuant(path)
    codes, _ = port_codes(s)
    assert np.array_equal(np.asarray(j._codes), codes)
    back = QPagerTurboQuant.LoadTurboQuant(path, n_pages=2, device="cpu")
    assert back.n_pages == 2
    assert fidelity(back.GetQuantumState(), s.GetQuantumState()) > 1 - 1e-12


@pytest.mark.parametrize("window", (1, 16))
def test_chunk_programs_of_the_single_engine_match_jax(window, monkeypatch):
    """With _pallas_capable False the single engine runs the JAX engine's
    XLA chunk programs (its path without QRACK_USE_PALLAS): _mk_gate_low,
    _mk_gate_pair, _mk_diag and, with a window, _mk_fuse_window."""
    monkeypatch.delenv("QRACK_USE_PALLAS", raising=False)
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", str(window))
    n = 8
    ref = QEngineTurboQuant(n, bits=16, chunk_qb=5, block_pow=2,
                            rng=JaxRandom(70), rand_global_phase=False)
    port = QEngineCUDATurboQuant(n, bits=16, chunk_qb=5, block_pow=2,
                                 device="cpu", rng=QrackRandom(70),
                                 rand_global_phase=False)
    port._pallas_capable = False
    for q in (ref, port):
        for i in range(n):
            q.H(i)
        q.CNOT(0, 3)
        q.T(2)
        q.CZ(1, 6)
        q.CNOT(6, 1)
        q.RZ(0.37, 7)
        q.S(6)              # a unit-free diagonal above the chunk
        q.CNOT(0, 7)        # above the chunk: the pair path
        q.RY(0.8, 2)
    assert fidelity(port.GetQuantumState(), ref.GetQuantumState()) > 1 - 1e-9
    for q_ in range(n):
        assert port.Prob(q_) == pytest.approx(ref.Prob(q_), abs=1e-5)


def test_unit_diagonal_above_the_chunk_keeps_codes():
    """_mk_diag's exact keep: a diagonal above the chunk whose factor is
    1 on a chunk leaves that chunk's codes bit for bit."""
    s = QPagerTurboQuant(8, bits=16, chunk_qb=4, block_pow=2, n_pages=2,
                         device="cpu", rng=QrackRandom(3),
                         rand_global_phase=False)
    for i in range(8):
        s.H(i)
    before, _ = port_codes(s)
    s.S(6)                   # factor 1 where bit 6 is 0
    after, _ = port_codes(s)
    rows = 1 << (4 - 2)      # code rows a chunk
    for c in range(16):
        same = np.array_equal(before[c * rows:(c + 1) * rows],
                              after[c * rows:(c + 1) * rows])
        assert same == (((c << 4) >> 6) & 1 == 0), c
