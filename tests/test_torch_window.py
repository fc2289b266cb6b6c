"""The port's single-sweep window kernel (qrack_tpu_torch/ops/
window_kernel.py) against the JAX package's Pallas window kernel.

On the CPU the port's sweeps run their plain PyTorch version, which
repeats the CUDA kernel's decomposition (tiles, lo/hi mask split, pair
mapping); the JAX side runs its Pallas kernel under the interpreter.
Host-side planning and operand packing must agree exactly; the numbers
to atol 1e-6 (both sides are float32 over <= ~20 ops with the same
arithmetic: only op order and FMA contraction differ, at ~1e-7).  The
CUDA kernel itself is held against the plain version on the card
(marker ``cuda``; chip_smoke.py does the same at full width).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qrack_tpu.ops import fusion as jfu
from qrack_tpu.ops import pallas_kernels as pk

from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import window_kernel as wk

KINDS = ("cphase", "diag", "inv", "gen")


def random_ops(rng, n, k):
    """k random window ops over the whole vocabulary: targets anywhere,
    0-2 controls, mixed control values for diag/inv/gen, as
    (kind, target, cmask, cval, m) with m a complex128 2x2."""
    out = []
    for _ in range(k):
        kind = KINDS[int(rng.integers(4))]
        t = int(rng.integers(n))
        others = [q for q in range(n) if q != t]
        nc = int(rng.integers(0, 3))
        cmask = 0
        for c in rng.choice(others, nc, replace=False) if nc else ():
            cmask |= 1 << int(c)
        cval = cmask
        if kind != "cphase" and cmask and rng.integers(2):
            cval = cmask & int(rng.integers(1 << n))
        a, b = np.exp(1j * rng.uniform(0.0, 2 * np.pi, 2))
        if kind == "cphase":
            m = np.diag([1.0 + 0j, b])
        elif kind == "diag":
            m = np.diag([a, b])
        elif kind == "inv":
            m = np.array([[0, a], [b, 0]])
        else:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            m, _ = np.linalg.qr(z)
        out.append((t, cmask, cval, np.asarray(m, dtype=np.complex128)))
    jops = [jfu.FusedOp(jfu.classify(m, cm, cv), t, cm, cv, m)
            for t, cm, cv, m in out]
    ops = [fu.FusedOp(fu.classify(m, cm, cv), t, cm, cv, m)
           for t, cm, cv, m in out]
    return jops, ops


def random_planes(rng, n):
    psi = rng.normal(size=(2, 1 << n)).astype(np.float32)
    return psi / np.float32(np.sqrt(float((psi.astype(np.float64) ** 2).sum())))


# ---------------------------------------------------------------------------
# host-side planning and packing: exact equality, many cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(24))
def test_plan_and_pack_match_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(4, 13))
    bp = int(rng.integers(1, n + 1))
    jops, ops = random_ops(rng, n, int(rng.integers(1, 40)))
    structure = fu.structure_of(ops)
    assert structure == jfu.structure_of(jops)
    assert wk.plan_window(structure, bp) == pk.plan_window(structure, bp)
    assert (wk.plan_sweeps(structure, bp, n)
            == pk.plan_sweeps(structure, bp, n))
    assert wk._operand_slots(structure) == pk._operand_slots(structure)
    fv_j, iv_j = pk.pack_operands(structure,
                                  jfu.dense_operands(jops, jnp.float32))
    fv, iv = wk.pack_operands(structure, fu.dense_operands(ops),
                              device="cpu")
    assert np.array_equal(np.asarray(fv_j).reshape(-1), fv.numpy())
    assert np.array_equal(np.asarray(iv_j).reshape(-1), iv.numpy())
    # every op lands in exactly one sweep, in order
    covered = []
    for xop, first, count in wk.segment_launches(structure, bp):
        covered += ([xop] if xop is not None else []) + list(
            range(first, first + count))
    assert covered == list(range(len(structure)))


# ---------------------------------------------------------------------------
# plain window function vs the interpret-mode Pallas kernel
# ---------------------------------------------------------------------------

# (n, bp, ops): in-tile only, cross-tile inv/gen, high and low controls
_INTERPRET_CASES = [(8, 3, 16), (9, 4, 18), (10, 5, 14), (10, 6, 12),
                    (8, 5, 20), (10, 3, 10)]


@pytest.mark.parametrize("n,bp,k", _INTERPRET_CASES)
def test_plain_window_matches_pallas_interpret(n, bp, k):
    rng = np.random.default_rng(n * 100 + bp * 10 + k)
    jops, ops = random_ops(rng, n, k)
    structure = fu.structure_of(ops)
    psi = random_planes(rng, n)
    want = np.asarray(pk.make_window_fn(n, structure, block_pow=bp,
                                        interpret=True)(
        jnp.asarray(psi), *jfu.dense_operands(jops, jnp.float32)))
    wk.reset_launches()
    fn = wk.make_window_fn(n, structure, block_pow=bp)
    got = fn(torch.tensor(psi), *fu.dense_operands(ops)).numpy()
    assert fn.sweeps == pk.plan_sweeps(structure, bp)
    assert np.abs(want - got).max() <= 1e-6
    # the CPU runs the plain version: no kernel launch is counted
    assert wk.launches() == {"in_tile": 0, "pair": 0}


def test_interpret_cases_reach_pair_sweeps_and_controls():
    """The interpret cases above really cover cross-tile segments and
    controls split on both sides of bp."""
    pair = high_ctrl = low_ctrl = 0
    for n, bp, k in _INTERPRET_CASES:
        rng = np.random.default_rng(n * 100 + bp * 10 + k)
        _jops, ops = random_ops(rng, n, k)
        for op in ops:
            pair += op.kind in ("inv", "gen") and op.target >= bp
            high_ctrl += (op.cmask >> bp) != 0
            low_ctrl += (op.cmask & ((1 << bp) - 1)) != 0
    assert pair >= 3 and high_ctrl >= 3 and low_ctrl >= 3


# ---------------------------------------------------------------------------
# plain window function vs the port's own window chain (cheap, many cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_plain_window_matches_window_chain(seed):
    rng = np.random.default_rng(2000 + seed)
    n = int(rng.integers(3, 12))
    bp = int(rng.integers(1, 8))
    _jops, ops = random_ops(rng, n, int(rng.integers(2, 48)))
    structure = fu.structure_of(ops)
    psi = random_planes(rng, n)
    want = fu.window_fn(n, structure)(torch.tensor(psi),
                                      *fu.dense_operands(ops)).numpy()
    got = wk.make_window_fn(n, structure, block_pow=bp)(
        torch.tensor(psi), *fu.dense_operands(ops)).numpy()
    assert np.abs(want - got).max() <= 1e-6


def test_segment_fn_bakes_matrices():
    rng = np.random.default_rng(7)
    n, bp = 7, 3
    _jops, ops = random_ops(rng, n, 12)
    raw = [(op.kind, op.target, op.cmask, op.cval, op.m) for op in ops]
    psi = random_planes(rng, n)
    fn = wk.make_segment_fn(raw, n, block_pow=bp)
    got = fn(torch.tensor(psi)).numpy()
    want = fu.window_fn(n, fu.structure_of(ops))(
        torch.tensor(psi), *fu.dense_operands(ops)).numpy()
    assert fn.sweeps == wk.plan_sweeps(fu.structure_of(ops), bp)
    assert np.abs(want - got).max() <= 1e-6


def test_kernel_lowering_cost_model(monkeypatch):
    structure = (("cphase", 0, True), ("gen", 1, False), ("diag", 20, True))
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "auto")
    assert fu.kernel_lowering(22, structure, "cpu") == (None, "cpu_backend")
    plan, why = fu.kernel_lowering(22, structure, "cuda")
    assert why is None and plan == {"block_pow": 12, "sweeps": 1}
    assert fu.kernel_lowering(22, structure[:1], "cuda") == (None, "single_op")
    xgens = (("gen", 20, False), ("gen", 21, False))
    assert fu.kernel_lowering(22, xgens, "cuda") == (None, "no_sweep_gain")
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "on")
    plan, why = fu.kernel_lowering(10, structure, "cpu")
    assert why is None and plan == {"block_pow": 10, "sweeps": 1}
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "off")
    assert fu.kernel_lowering(22, structure, "cuda") == (None, "mode_off")


def test_wrapper_rejects_other_devices_and_bad_operands():
    planes = torch.zeros((2, 1 << 6), dtype=torch.float32, device="meta")
    table = wk.op_table((("gen", 1, False),), device="cpu")
    fv = torch.zeros(8)
    iv = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        wk.in_tile_sweep(planes, 6, 3, table, fv, iv, 0, 1)
    with pytest.raises(ValueError):
        wk._check_launch(torch.zeros((2, 64)), 6, 3, table.double(), fv, iv,
                         [0, 1])
    # planes outside the four plane dtypes, fv in another dtype than the
    # planes, and a float64 tile pair past the shared memory of a block
    with pytest.raises(ValueError):
        wk._check_launch(torch.zeros((2, 64), dtype=torch.int32), 6, 3,
                         table, fv, iv, [0, 1])
    with pytest.raises(ValueError):
        wk._check_launch(torch.zeros((2, 64), dtype=torch.float64), 6, 3,
                         table, fv, iv, [0, 1])
    with pytest.raises(ValueError):
        wk._check_launch(torch.zeros((2, 1 << 14), dtype=torch.float64), 14,
                         13, table, fv.double(), iv, [0, 1])
    wk._check_launch(torch.zeros((2, 1 << 14), dtype=torch.float64), 14, 12,
                     table, fv.double(), iv, [0, 1])
    with pytest.raises(ValueError):
        wk._check_launch(torch.zeros((2, 64)), 6, 14, table, fv, iv, [0, 1])


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_cuda_kernel_matches_plain(cuda_device, seed):
    rng = np.random.default_rng(3000 + seed)
    n, bp = 16, 12
    _jops, ops = random_ops(rng, n, 40)
    structure = fu.structure_of(ops)
    psi = torch.tensor(random_planes(rng, n), device=cuda_device)
    operands = fu.dense_operands(ops)
    wk.reset_launches()
    got = wk.make_window_fn(n, structure, block_pow=bp)(psi.clone(), *operands)
    torch.cuda.synchronize()
    want = wk.make_window_fn(n, structure, block_pow=bp, plain=True)(
        psi.clone(), *operands)
    assert sum(wk.launches().values()) == wk.plan_sweeps(structure, bp)
    assert float((got - want).abs().max()) <= 1e-5
