"""The port's split-index ALU (ops/alu_kernels.py ``*_split``, the
``split=`` forms of engines/qengine.py, parallel/pager.py's wide path and
the compressed engine's split phase program) against the JAX package's.

The counterparts of every test of tests/test_wide_alu.py and of
tests/test_alu.py:367: the port's pager (pages on the CPU) with
``force_wide_alu`` set runs the ring-gather and split-index programs of
a >31-qubit pager at 7-10 qubits, against the JAX pager with
``force_wide_alu`` on the 8 virtual CPU devices of tests/conftest.py.
Both get the same seeded streams and rand_global_phase=False.  Bars:
float32 amplitudes within 3e-5 (those tests' bar); the int64-lane limb
arithmetic equal to the JAX package's uint32 results bit for bit; the
compressed engines' split phase program at int16 to fidelity
> 1 - 1e-9 and probabilities within 1e-5, the bars of
tests/test_torch_turboquant_engine.py.
"""

import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu.engines.turboquant import QEngineTurboQuant
from qrack_tpu.ops import alu_kernels as jalu
from qrack_tpu.parallel.pager import QPager as JaxPager
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

from qrack_tpu_torch.convert import turboquant_from_numpy
from qrack_tpu_torch.ops import alu_kernels as alu
from qrack_tpu_torch.ops import sharded as shb
from qrack_tpu_torch.parallel.pager import QPager
from qrack_tpu_torch.utils.rng import QrackRandom

from helpers import rand_state

ATOL = 3e-5


def make_pair(n, seed=3, n_pages=4, **kw):
    ref = JaxPager(n, rng=JaxRandom(seed), rand_global_phase=False,
                   n_pages=n_pages)
    port = QPager(n, rng=QrackRandom(seed), rand_global_phase=False,
                  n_pages=n_pages, device="cpu", **kw)
    ref.force_wide_alu = True
    port.force_wide_alu = True
    return ref, port


def prep(eng, n, seed=9):
    rng = JaxRandom(seed)
    for i in range(n):
        if rng.randint(0, 2):
            eng.H(i)
        if rng.randint(0, 2):
            eng.X(i)


def assert_match(ref, port, atol=ATOL):
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=atol)


@pytest.fixture(params=["whole", "blocks"])
def blocks(request, monkeypatch):
    """Page passes in one block, or in blocks of 4 amplitudes."""
    if request.param == "blocks":
        monkeypatch.setattr(shb, "CHUNK", 4)
    return request.param


@pytest.mark.parametrize("start,length", ((0, 7), (3, 4), (4, 3), (5, 2)))
def test_inc_across_pages(start, length, blocks):
    n = 7  # registers spanning the 5-local/2-page boundary (4 pages)
    ref, port = make_pair(n)
    for eng in (ref, port):
        prep(eng, n)
        eng.INC(5, start, length)
        eng.INC((1 << length) - 2, start, length)
    assert_match(ref, port)


def test_cinc_and_incdecc():
    n = 7
    ref, port = make_pair(n)
    for eng in (ref, port):
        prep(eng, n)
        eng.CINC(3, 1, 4, (6,))     # paged control bit
        eng.INCDECC(9, 0, 5, 6)     # carry on a paged bit
        eng.INCDECC(1, 2, 3, 5)
    assert_match(ref, port)


def test_incs_and_incdecsc():
    n = 7
    ref, port = make_pair(n)
    for eng in (ref, port):
        prep(eng, n)
        eng.INCS(5, 0, 4, 6)        # overflow flag on a paged bit
        eng.INCDECSC(3, 0, 4, 5, 6)
        eng.INCDECSC(6, 1, 4, 6)    # carry only
    assert_match(ref, port)


def test_rol_xmask_hash(blocks):
    n = 7
    ref, port = make_pair(n)
    table = list(np.random.RandomState(5).permutation(1 << 4))
    for eng in (ref, port):
        prep(eng, n)
        eng.ROL(3, 1, 6)            # rotation across the page boundary
        eng.XMask(0b1100101)
        eng.Hash(2, 4, table)
        eng.ROR(2, 3, 4)
    assert_match(ref, port)


def test_mulmodnout_family_across_pages():
    n = 8
    ref, port = make_pair(n, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        eng.H(1)
        eng.H(2)
        eng.MULModNOut(5, 13, 0, 4, 3)     # out register spans pages
    assert_match(ref, port)
    for eng in (ref, port):
        eng.IMULModNOut(5, 13, 0, 4, 3)    # and undo
    assert_match(ref, port)


def test_powmodnout_and_controlled():
    n = 8
    ref, port = make_pair(n, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        eng.H(1)
        eng.X(3)
        eng.POWModNOut(7, 15, 0, 4, 3)
    assert_match(ref, port)
    ref2, port2 = make_pair(n, n_pages=4)
    for eng in (ref2, port2):
        eng.H(0)
        eng.H(1)
        eng.H(3)
        eng.CMULModNOut(4, 9, 0, 4, 2, (3,))
        eng.CIMULModNOut(4, 9, 0, 4, 2, (3,))
        eng.CPOWModNOut(2, 5, 0, 4, 2, (3,))
    assert_match(ref2, port2)


def test_indexed_lda_adc():
    n = 8
    values = [3, 1, 2, 0]
    ref, port = make_pair(n, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        eng.H(1)
        assert eng.IndexedLDA(0, 2, 4, 2, values) >= 0  # paged value register
    assert_match(ref, port)
    ref2, port2 = make_pair(n, n_pages=4)
    for eng in (ref2, port2):
        eng.H(0)
        eng.X(4)
        eng.IndexedADC(0, 2, 3, 2, 7, [1, 2, 3, 0])
        eng.IndexedSBC(0, 2, 3, 2, 7, [3, 0, 1, 2])
    assert_match(ref2, port2)


def test_shor_order_finding_slice_wide_path():
    # the Shor-critical sequence (H ladder, POWModNOut, IQFT) through the
    # forced wide path
    n = 9
    ref, port = make_pair(n, n_pages=4)
    for eng in (ref, port):
        for i in range(4):
            eng.H(i)
        eng.POWModNOut(2, 15, 0, 4, 4)
        eng.IQFT(0, 4)
    assert_match(ref, port)


@pytest.mark.parametrize("to_mul", (3, 6, 5))
def test_mul_div_across_pages(to_mul):
    # non-modular MUL/DIV through the split-index gather (the carry
    # register spans the page boundary: 6 local bits and 4 pages at n=8)
    ref, port = make_pair(8, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        eng.H(1)
        eng.H(2)
        eng.H(7)
        eng.MUL(to_mul, 0, 4, 3)
    assert_match(ref, port)
    for eng in (ref, port):
        eng.DIV(to_mul, 0, 4, 3)
    assert_match(ref, port)


def test_cmul_cdiv_paged_control():
    ref, port = make_pair(8, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        eng.H(1)
        eng.H(7)                      # paged control in superposition
        eng.CMUL(3, 0, 4, 3, (7,))
    assert_match(ref, port)
    for eng in (ref, port):
        eng.CDIV(3, 0, 4, 3, (7,))
    assert_match(ref, port)


def test_generic_diagonals_wide(blocks):
    # every _k_phase_fn caller through the split-index wide path
    n = 7
    ref, port = make_pair(n)
    for eng in (ref, port):
        prep(eng, n)
        eng.ZMask(0b1100101)               # parity spans pages
        eng.PhaseParity(0.7, 0b0110011)
        eng.UniformParityRZ(0b1010110, 0.3)
        eng.CUniformParityRZ((6,), 0b0010011, 0.4)
        eng.CUniformParityRZ((1, 5), 0b1000001, 1.1)
        eng.PhaseFlipIfLess(5, 3, 4)       # register spans the boundary
        eng.CPhaseFlipIfLess(3, 0, 4, 6)   # flag on a paged bit
        eng.PhaseFlipIfLess(2, 5, 2)       # register on page bits alone
        eng.PhaseFlip()
    assert_match(ref, port)


@pytest.mark.parametrize("mask,result", ((0b1100011, True), (0b1100000, False),
                                         (0b0000110, True)))
def test_forcemparity_wide(mask, result):
    n = 7
    ref, port = make_pair(n)
    for eng in (ref, port):
        prep(eng, n)
    assert port.ProbParity(mask) == pytest.approx(ref.ProbParity(mask),
                                                  abs=1e-6)
    for eng in (ref, port):
        eng.ForceMParity(mask, result)
    assert_match(ref, port)


@pytest.mark.parametrize("to_mul", (3, 6, 5, 7))
def test_mul_div_table_free(to_mul, monkeypatch):
    # the table-free limb form must match the oracle exactly: it is the
    # path with no host-RAM ceiling past QRACK_WIDE_MUL_TABLE_QB
    monkeypatch.setenv("QRACK_WIDE_MUL_TABLE_FREE", "1")
    ref, port = make_pair(8, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        eng.H(1)
        eng.H(2)
        eng.H(7)
        eng.MUL(to_mul, 0, 4, 3)
    assert_match(ref, port)
    for eng in (ref, port):
        eng.DIV(to_mul, 0, 4, 3)
    assert_match(ref, port)
    ref, port = make_pair(8, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        eng.H(7)
        eng.CMUL(to_mul, 0, 4, 3, (7,))
        eng.CDIV(to_mul, 0, 4, 3, (7,))
    assert_match(ref, port)


def test_product_split_limbs_exact():
    # int64-lane limbs vs the JAX package's uint32 limbs, bit for bit, and
    # both vs exact Python ints, at the widths the tables no longer reach
    rs = np.random.RandomState(7)
    for length in (5, 16, 24, 29, 30, 31):
        mask = (1 << length) - 1
        xs = rs.randint(0, 1 << length, size=256, dtype=np.int64)
        xt = torch.from_numpy(xs.astype(np.int32))
        for to_mul in (3, (1 << (length - 1)) + 5, (3 << length) | 9,
                       int(rs.randint(1, 1 << 30))):
            t_lo, t_hi = to_mul & mask, (to_mul >> length) & mask
            jl = jalu._mul64_limbs(np, xs, t_lo)
            pl = alu._mul64_limbs(torch, xt, t_lo)
            for a, b in zip(jl, pl):
                np.testing.assert_array_equal(a.astype(np.int64), b.numpy())
            jlo, jhi = jalu._product_split(np, xs, t_lo, t_hi, length)
            for t_ops in ((t_lo, t_hi), (torch.tensor(t_lo), torch.tensor(t_hi))):
                lo, hi = alu._product_split(torch, xt, *t_ops, length)
                np.testing.assert_array_equal(lo.numpy(), jlo.astype(np.int64))
                np.testing.assert_array_equal(hi.numpy(), jhi.astype(np.int64))
            exact = xs.astype(object) * to_mul
            np.testing.assert_array_equal(
                lo.numpy(), np.asarray([p & mask for p in exact], np.int64))
            np.testing.assert_array_equal(
                hi.numpy(), np.asarray([(p >> length) & mask for p in exact],
                                       np.int64))


def test_mul_consts_inverse():
    for to_mul, length in ((3, 8), (12, 10), (5, 30), (6, 29)):
        k, consts = alu.mul_consts(to_mul, length)
        jk, jconsts = jalu.mul_consts(to_mul, length)
        assert k == jk
        np.testing.assert_array_equal(consts, jconsts.astype(np.int64))
        odd = to_mul >> k
        assert (odd * int(consts[2])) % (1 << length) == 1
        assert int(consts[0]) == to_mul & ((1 << length) - 1)
    with pytest.raises(ValueError):
        alu.mul_consts(16, 3)   # v2 > length
    with pytest.raises(ValueError):
        alu.mul_consts(0, 4)
    for to_mul, length in ((3, 6), (10, 7)):
        for a, b in zip(alu.mul_tables(to_mul, length),
                        jalu.mul_tables(to_mul, length)):
            np.testing.assert_array_equal(a, b)


def test_mul_wide_rejects_overwide_pow2_factor():
    # v2(to_mul) > length: the truncated product map is not a bijection,
    # so the wide path refuses instead of corrupting the ket (both)
    ref, port = make_pair(8, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        with pytest.raises(ValueError):
            eng.MUL(16, 0, 4, 3)


def test_bcd_on_wide_pager_split_path():
    n = 7
    ref, port = make_pair(n, seed=7, n_pages=8)
    o = JaxCPU(n, rng=JaxRandom(7), rand_global_phase=False)
    st = rand_state(n, 79)
    for eng in (ref, port, o):
        eng.SetQuantumState(st)
        eng.INCBCD(5, 0, 4)
        eng.INCDECBCDC(3, 0, 4, 5)
    assert_match(ref, port)
    np.testing.assert_allclose(port.GetQuantumState(), o.GetQuantumState(),
                               atol=ATOL)


def test_split_ops_read_logical_order_under_a_remap():
    """A pager whose placement table is not the identity (a window that
    moved page qubits in) restores logical order before a split body
    reads its index: ALU results must not depend on the table."""
    n = 8
    ref, port = make_pair(n, n_pages=4)
    for eng in (ref, port):
        prep(eng, n)
        eng.QFT(0, n)      # its windows move page qubits into the pages
    port._settle()
    assert port._map_nonid(), "the window left the identity table"
    for eng in (ref, port):
        eng.INC(11, 3, 5)
        eng.ZMask(0b11000011)
        eng.ROL(1, 2, 6)
    assert_match(ref, port)


def test_wide_path_is_taken_past_31_qubits():
    """The dense ALU (index vectors and host index pairs) never runs on a
    wide pager: every op reaches its split form, the scatter raises."""
    _, port = make_pair(7, n_pages=4)
    calls = []
    real_gather, real_factor = shb.gather_ring, shb.apply_split_factor

    def gather(*a, **k):
        calls.append("gather")
        return real_gather(*a, **k)

    def factor(*a, **k):
        calls.append("factor")
        return real_factor(*a, **k)

    shb.gather_ring, shb.apply_split_factor = gather, factor
    try:
        port.INC(3, 0, 7)
        port.MUL(3, 0, 4, 3)
        port.ZMask(0b11)
        port.PhaseFlipIfLess(4, 1, 3)
    finally:
        shb.gather_ring, shb.apply_split_factor = real_gather, real_factor
    assert calls == ["gather", "gather", "factor", "factor"]
    # past 31 qubits the scatter and a phase function without a split
    # form refuse (the width alone decides; nothing is allocated)
    port.qubit_count = 32
    with pytest.raises(NotImplementedError):
        port._k_out_of_place([0], [0], None)
    with pytest.raises(NotImplementedError):
        port._k_phase_fn(lambda xp, idx: (1.0, 0.0))


@pytest.mark.parametrize("bits", [16, 8])
def test_turboquant_split_phase_program_matches_jax(bits):
    """The compressed engine's split phase program (the JAX engine's
    _mk_phase_split: every diagonal op with a split form takes it) on the
    same codes in both packages."""
    n = 8
    ref = QEngineTurboQuant(n, bits=bits, chunk_qb=4, block_pow=2,
                            rng=JaxRandom(11), rand_global_phase=False)
    for i in range(n):
        ref.H(i)
    ref.CNOT(0, 5)
    ref.T(3)
    port = turboquant_from_numpy(np.asarray(ref._codes),
                                 np.asarray(ref._scales), n, bits, 2,
                                 ref._tq_seed, device="cpu", chunk_qb=4,
                                 rng=QrackRandom(11), rand_global_phase=False)
    for eng in (ref, port):
        eng.ZMask(0b10010011)
        eng.UniformParityRZ(0b01100110, 0.3)
        eng.CUniformParityRZ((7,), 0b00010011, 0.4)
        eng.PhaseParity(0.9, 0b11000001)
        eng.PhaseFlipIfLess(5, 3, 4)
        eng.CPhaseFlipIfLess(3, 0, 4, 6)
    a, b = port.GetQuantumState(), ref.GetQuantumState()
    fid = abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)
    assert fid > (1 - 1e-9 if bits == 16 else 1 - 1e-6)
    for q in range(n):
        assert port.Prob(q) == pytest.approx(ref.Prob(q), abs=1e-5)
    # every chunk was requantized once an op: the codes agree but for
    # rounding-boundary ties (a code unit apart, on few entries)
    diff = np.abs(port._codes.numpy().astype(np.int64)
                  - np.asarray(ref._codes).astype(np.int64))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-2


@pytest.mark.parametrize("mask", (0b10000011, 0b11000000, 0b00000110, 0))
def test_pager_reads_distributions_on_its_pages(mask, blocks):
    """ProbParity and ProbMaskAll read page by page on the pages'
    devices (the interface's forms stage the whole ket on the host) and
    equal the JAX pager's, under a placement table that a window moved
    (the QFT's)."""
    ref, port = make_pair(8, n_pages=4)
    for eng in (ref, port):
        prep(eng, 8)
        eng.QFT(0, 8)
    port._settle()
    assert port._map_nonid()
    np.testing.assert_allclose(port.ProbMaskAll(mask), ref.ProbMaskAll(mask),
                               atol=1e-6)
    assert port.ProbParity(mask) == pytest.approx(ref.ProbParity(mask),
                                                  abs=1e-6)
    assert port.ExpectationBitsAll([1, 6, 7]) == pytest.approx(
        ref.ExpectationBitsAll([1, 6, 7]), abs=1e-5)
