"""The split-TF32 arithmetic of the TurboQuant kernel (csrc/
turboquant_kernel.cu), emulated on the CPU (ops/turboquant_kernel.py
tf32_rna, split_tf32_matmul), and the plain sweeps with their products
taken through that emulation against the JAX package's Pallas kernels in
interpret mode.

The inputs are those of tests/test_torch_turboquant_kernel.py (the same
seeded codes, rotation and operands), int8 and int16, and so are the
bars: codes differ by at most 1, on at most 1e-3 (int8) or 1e-2 (int16)
of the entries; scales within 1e-6 relative; tiles no op acts on keep
their codes and scales bit for bit.  This shows on the CPU that three
TF32 passes keep the float32 bars.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qrack_tpu.ops import fusion as jfu
from qrack_tpu.ops import pallas_turboquant as ptq

from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import turboquant_kernel as tqk

from test_torch_turboquant_kernel import (_hold, _ket, _run_both, _tiles,
                                          _unitary, _window_ops)


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits, ties away from zero, in float64
    (exact for normal float32 inputs)."""
    x = x.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(x))) - 10)
    return np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    tie = one + 2.0 ** -11           # halfway between two TF32 values
    x = torch.tensor([tie, -tie, tie - 2.0 ** -23, 3.0, -0.0, 1.5 * 2 ** -10],
                     dtype=torch.float32)
    got = tqk.tf32_rna(x).tolist()
    assert got == [one + 2.0 ** -10, -(one + 2.0 ** -10), one, 3.0, -0.0,
                   1.5 * 2 ** -10]
    r = np.random.default_rng(1).normal(size=50_000).astype(np.float32)
    got = tqk.tf32_rna(torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), _rna_reference(r))
    assert not np.any(got.view(np.int32) & 0x1FFF)


def test_split_product_keeps_float32_accuracy():
    """3xTF32 against float64 at the kernel's width (2D = 128): within
    2e-6 of each row's largest value, as a float32 matmul is (both about
    1e-6 here); int8 codes are exact in TF32, so only the rotation
    splits."""
    rng = np.random.default_rng(5)
    _codes, _scales, rot = _ket(rng, 12, 8, 6)
    a = rng.normal(size=(512, 128)).astype(np.float32)
    codes = rng.integers(-127, 128, size=(512, 128)).astype(np.float32)
    for lhs in (a, codes):
        want = lhs.astype(np.float64) @ rot.astype(np.float64)
        got = tqk.split_tf32_matmul(torch.from_numpy(lhs),
                                    torch.from_numpy(rot)).numpy()
        err = np.abs(got - want).max(1) / np.abs(want).max(1)
        assert err.max() <= 2e-6
    c = torch.from_numpy(codes)
    assert torch.equal(tqk.tf32_rna(c), c)


def _split(fn):
    return functools.partial(fn, split_tf32=True)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("case", ["plain", "lo_ctrl", "hi_ctrl", "mixed"])
def test_split_gate_low_matches_pallas(bits, case):
    rng = np.random.default_rng(100 + bits + len(case))
    n, bp, tp = 8, 2, 4
    codes, scales, rot = _ket(rng, n, bits, bp)
    m = _unitary(rng)
    mp = np.stack([m.real, m.imag]).astype(np.float32)
    target = 2
    cmask = {"plain": 0, "lo_ctrl": 0b1, "hi_ctrl": 1 << 6,
             "mixed": 0b1001 | (1 << 5) | (1 << 7)}[case]
    cval = cmask & 0b1010_0001
    T = 1 << tp
    args = (cmask >> tp, cval >> tp, cmask & (T - 1), cval & (T - 1))
    jfn = ptq.make_tq_gate_low(n, bp, bits, target, tile_pow=tp,
                               interpret=True)
    out = _run_both(jfn, (mp,) + args, _split(tqk.tq_gate_low_plain),
                    (bits, tp, mp, target) + args, codes, scales, rot)
    blk, tb = _tiles(n, bp, tp)
    dirty = tqk.gate_low_dirty(blk, args[0], args[1]).view(-1).numpy()
    _hold(*out, codes, scales, dirty, tb)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("case", ["low", "high_ctrl", "unit_high"])
def test_split_diag_matches_pallas(bits, case):
    rng = np.random.default_rng(200 + bits + len(case))
    n, bp, tp = 9, 3, 5
    codes, scales, rot = _ket(rng, n, bits, bp)
    d0, d1 = np.exp(1j * rng.uniform(0, 2 * np.pi, 2))
    target = {"low": 3, "high_ctrl": 6, "unit_high": 8}[case]
    cmask = {"high_ctrl": 0b10 | (1 << 8)}.get(case, 0)
    cval = cmask & 0b1_0000_0000
    if case == "unit_high":
        d0 = 1.0
    T = 1 << tp
    dp = np.zeros((2, 2, 2), np.float32)
    dp[0, 0, 0], dp[0, 0, 1] = np.real(d0), np.real(d1)
    dp[1, 0, 0], dp[1, 0, 1] = np.imag(d0), np.imag(d1)
    tm_lo = (1 << target) if target < tp else 0
    tb_hi = 0 if target < tp else 1 << (target - tp)
    args = (tm_lo, tb_hi, cmask & (T - 1), cval & (T - 1), cmask >> tp,
            cval >> tp)
    jfn = ptq.make_tq_diag(n, bp, bits, tile_pow=tp, interpret=True)
    out = _run_both(jfn, (dp,) + args, _split(tqk.tq_diag_plain),
                    (bits, tp, dp) + args, codes, scales, rot)
    blk, tb = _tiles(n, bp, tp)
    dirty = tqk.diag_dirty(blk, dp, tm_lo, tb_hi, args[2], args[4],
                           args[5]).view(-1).numpy()
    _hold(*out, codes, scales, dirty, tb)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("hi_only", [False, True])
def test_split_window_matches_pallas(bits, hi_only):
    rng = np.random.default_rng(300 + bits + hi_only)
    n, bp, tp = 8, 2, 4
    codes, scales, rot = _ket(rng, n, bits, bp)
    pops = _window_ops(np.random.default_rng(7), n, tp, fu)
    jops = _window_ops(np.random.default_rng(7), n, tp, jfu)
    if hi_only:
        pops, jops = pops[3:5], jops[3:5]
    structure = fu.sharded_structure_of(pops)
    operands = fu.sharded_operands(pops, tp, torch.float32, device="cpu")
    jfn = ptq.make_tq_window(n, bp, bits, structure, tile_pow=tp,
                             interpret=True)
    out = _run_both(jfn, tuple(jfu.sharded_operands(jops, tp, jnp.float32)),
                    _split(tqk.tq_window_plain),
                    (bits, tp, structure, operands), codes, scales, rot)
    table, fv, iv = tqk.pack_window(structure, operands, "cpu")
    blk, tb = _tiles(n, bp, tp)
    dirty = tqk.window_dirty(blk, tp, table.tolist(), fv, iv).view(-1).numpy()
    _hold(*out, codes, scales, dirty, tb)


@pytest.mark.parametrize("bits", [8, 16])
def test_split_qft_window_matches_pallas(bits):
    """Controlled phases of a QFT at the main path's block size (2D =
    128), where the products are as wide as the kernel's."""
    from qrack_tpu.models.qft import qft_qcircuit

    rng = np.random.default_rng(11)
    n, bp, tp = 10, 6, 8
    codes, scales, rot = _ket(rng, n, bits, bp)
    jops = jfu.lower_gates(qft_qcircuit(n).gates)
    jops = [op for op in jops if op.kind == "cphase"][:16]
    pops = [fu.FusedOp(op.kind, op.target, op.cmask, op.cval,
                       np.asarray(op.m)) for op in jops]
    structure = fu.sharded_structure_of(pops)
    operands = fu.sharded_operands(pops, tp, torch.float32, device="cpu")
    jfn = ptq.make_tq_window(n, bp, bits, structure, tile_pow=tp,
                             interpret=True)
    out = _run_both(jfn, tuple(jfu.sharded_operands(jops, tp, jnp.float32)),
                    _split(tqk.tq_window_plain),
                    (bits, tp, structure, operands), codes, scales, rot)
    table, fv, iv = tqk.pack_window(structure, operands, "cpu")
    blk, tb = _tiles(n, bp, tp)
    dirty = tqk.window_dirty(blk, tp, table.tolist(), fv, iv).view(-1).numpy()
    _hold(*out, codes, scales, dirty, tb)
