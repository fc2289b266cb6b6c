"""The port's QEngineSparse (the "sparse" terminal) against the JAX
package's, after tests/test_sparse.py: the same seeded op streams on
both, numpy complex128 amplitudes and int64 indices on both sides.

Bars: amplitudes to 1e-12 (the same numpy arithmetic in the same order;
no float32 anywhere), index arrays and measurement outcomes exactly.
The ALU's index maps (ops/alu_kernels.py) keep int64 when given numpy
int64 indices, past bit 31, as the JAX package's do.
"""

import numpy as np
import pytest

from qrack_tpu.engines.sparse import QEngineSparse as JaxSparse
from qrack_tpu.ops import alu_kernels as jalu
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.engines.sparse import QEngineSparse
from qrack_tpu_torch.ops import alu_kernels as alu
from qrack_tpu_torch.utils.rng import QrackRandom

from test_engine_matrix import random_circuit


def make_pair(n, seed=1, **kw):
    p = QEngineSparse(n, rng=QrackRandom(seed), rand_global_phase=False, **kw)
    j = JaxSparse(n, rng=JaxRandom(seed), rand_global_phase=False, **kw)
    return p, j


def assert_same(p, j, atol=1e-12):
    assert p.qubit_count == j.qubit_count
    assert np.array_equal(p._idx, j._idx)
    assert p._idx.dtype == np.int64
    assert np.abs(p._amp - j._amp).max(initial=0.0) <= atol


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_circuits_match_jax(seed):
    n = 5
    p, j = make_pair(n, seed)
    random_circuit(p, QrackRandom(3000 + seed), 40, n)
    random_circuit(j, JaxRandom(3000 + seed), 40, n)
    assert_same(p, j)
    assert np.abs(p.GetQuantumState() - j.GetQuantumState()).max() <= 1e-12


def test_wide_sparse_register_matches_jax():
    """50 qubits: impossible densely, a few entries sparsely."""
    p, j = make_pair(50, 5)
    for e in (p, j):
        e.X(45)
        e.H(0)
        e.CNOT(0, 49)
        e.INC(100, 10, 20)   # wide ALU on sparse support
        e.ROL(3, 30, 18)
        e.CINC(7, 33, 12, (0,))
    assert p.nnz() == j.nnz() == 2
    assert_same(p, j)
    assert p.Prob(49) == pytest.approx(j.Prob(49))
    assert int(p._idx.max()) >= 1 << 45   # indices past int32 stay exact
    p.rng.seed(7)
    j.rng.seed(7)
    assert p.MAll() == j.MAll()


def test_measurement_and_multishot_match_jax():
    p, j = make_pair(4, seed=9)
    for e in (p, j):
        e.H(0)
        e.CNOT(0, 1)
        e.CNOT(1, 2)
        e.rng.seed(11)
    assert p.MultiShotMeasureMask([1, 2, 4], 400) == \
        j.MultiShotMeasureMask([1, 2, 4], 400)
    assert p.M(1) == j.M(1)
    assert p.ForceM(3, False) == j.ForceM(3, False)
    assert_same(p, j)


def test_alu_forward_maps_match_jax():
    p, j = make_pair(7, seed=13)
    for e in (p, j):
        e.HReg(0, 3)
        e.INC(5, 0, 5)
        e.CINC(2, 0, 3, (6,))
        e.INCDECC(3, 0, 3, 5)
        e.ROL(2, 0, 5)
        e.ROR(1, 0, 5)
        e.Hash(0, 2, [2, 0, 3, 1])
        e.PhaseFlipIfLess(3, 0, 3)
        e.XMask(0b1010)
    assert_same(p, j)


def test_out_of_place_alu_matches_jax_past_bit_31():
    """MUL/DIV and the *ModNOut ops on registers above bit 31 of a
    44-qubit sparse ket."""
    p, j = make_pair(44, seed=19)
    for e in (p, j):
        e.HReg(32, 3)
        e.MUL(3, 32, 38, 4)
        e.DIV(3, 32, 38, 4)
        e.CMUL(5, 32, 38, 4, (0,))
        e.MULModNOut(7, 13, 32, 20, 4)
        e.POWModNOut(2, 13, 32, 24, 4)
        e.CPOWModNOut(3, 11, 32, 28, 4, (35,))
        e.IMULModNOut(7, 13, 32, 20, 4)
    assert_same(p, j)


def test_indexed_loads_match_jax():
    """IndexedLDA/ADC/SBC, whose expectation read densifies (28 qubits
    at most, on both sides)."""
    p, j = make_pair(16, seed=23)
    table = [int(v) for v in np.random.default_rng(3).integers(0, 16, 16)]
    for e in (p, j):
        e.HReg(0, 4)
        assert e.IndexedLDA(0, 4, 8, 4, table) is not None
        e.IndexedADC(0, 4, 8, 3, 15, table)
        e.IndexedSBC(0, 4, 8, 3, 15, table)
    assert_same(p, j)


@pytest.mark.parametrize("name", ["inc_src", "incdecc_src", "rol_src",
                                  "incs_src", "indexed_adc_src", "hash_src"])
def test_alu_index_maps_keep_int64_on_numpy(name):
    """Given numpy int64 indices, the port's ALU index maps compute in
    int64 and give the JAX package's values, on bits up to 61."""
    rng = np.random.default_rng(41)
    idx = rng.integers(0, 1 << 62, 4096, dtype=np.int64)
    table = rng.permutation(1 << 6).astype(np.int64)
    args = {"inc_src": (-(1 << 33) - 5, 30, 31),
            "incdecc_src": (123456789, 35, 20, 61),
            "rol_src": (7, 40, 20),
            "incs_src": (9, 44, 10, 60),
            "indexed_adc_src": (40, 6, 50, 8, 59, table),
            "hash_src": (52, 6, table)}[name]
    got = getattr(alu, name)(np, idx, *args)
    want = getattr(jalu, name)(np, idx, *args)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


def test_truncation_controls():
    p, j = make_pair(8, seed=15, max_entries=16)
    for e in (p, j):
        for i in range(8):
            e.H(i)    # would be 256 entries; truncated to 16
    assert p.nnz() <= 16
    assert float(np.sum(np.abs(p._amp) ** 2)) == pytest.approx(1.0, abs=1e-9)
    assert_same(p, j)


def test_compose_dispose_decompose_allocate_match_jax():
    p, j = make_pair(3, seed=17)
    for e, other in ((p, QEngineSparse(2, rng=QrackRandom(18),
                                       rand_global_phase=False)),
                     (j, JaxSparse(2, rng=JaxRandom(18),
                                   rand_global_phase=False))):
        e.H(0)
        e.CNOT(0, 1)
        other.X(0)
        e.Compose(other)
        assert e.qubit_count == 5
    assert_same(p, j)
    for e in (p, j):
        e.Dispose(3, 2, 0b01)
        e.Allocate(1, 2)
        e.H(4)
    assert_same(p, j)
    dp = QEngineSparse(1, rng=QrackRandom(2), rand_global_phase=False)
    dj = JaxSparse(1, rng=JaxRandom(2), rand_global_phase=False)
    p.Decompose(4, dp)
    j.Decompose(4, dj)
    assert_same(p, j)
    assert_same(dp, dj)


def test_sparse_terminal_and_guards():
    q = qt.create_quantum_interface("sparse", 60, rng=QrackRandom(21),
                                    rand_global_phase=False)
    assert isinstance(q, QEngineSparse)
    q.H(59)
    assert q.Prob(59) == pytest.approx(0.5)
    with pytest.raises(ValueError):        # a host engine: no device
        qt.create_quantum_interface("sparse", 4, device="cpu")
    with pytest.raises(MemoryError):
        QEngineSparse(63)
    a = QEngineSparse(40, rng=QrackRandom(1), rand_global_phase=False)
    with pytest.raises(MemoryError):
        a.Compose(QEngineSparse(40, rng=QrackRandom(2),
                                rand_global_phase=False))
    # a dense engine composes onto the sparse one
    d = qt.create_quantum_interface("cpu", 2, rand_global_phase=False)
    d.X(1)
    b = QEngineSparse(2, rng=QrackRandom(3), rand_global_phase=False)
    b.Compose(d)
    assert b.ProbAll(0b1000) == pytest.approx(1.0)
    assert b.SumSqrDiff(b.Clone()) == pytest.approx(0.0, abs=1e-12)
