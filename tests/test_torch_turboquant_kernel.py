"""The TurboQuant kernels' plain versions (qrack_tpu_torch
ops/turboquant_kernel.py, run on the CPU) against the JAX package's
Pallas kernels (ops/pallas_turboquant.py, interpret mode) on the same
codes, scales, rotation and operands, and the shared tile primitives
against pallas_kernels.tile_*.

Bars:
* codes differ by at most 1, on at most 1e-3 of the entries at int8 and
  1e-2 at int16.  Both sides compute in float32, but not in the same
  order: XLA contracts the gate's multiply-adds into FMAs where torch
  rounds each product, and the products' sums may run in another order.
  That moves a code only where its exact value sits at a rounding
  boundary.  An int16 code unit is 1/32767 of the row scale, so
  differences of a few 1e-7 relative move about 1e-3 of the int16 codes
  (0.6e-3 to 2e-3 measured on 8192-code kets), against about 1e-5 of
  the int8 codes;
* scales within 1e-6 relative (the row max of the same products);
* tiles that no op acts on keep their codes and scales bit for bit, on
  both sides.
The CUDA kernel itself is held against the plain versions on the card
(marker ``cuda``; chip_smoke.py does the same at full width).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qrack_tpu.ops import fusion as jfu
from qrack_tpu.ops import pallas_kernels as pk
from qrack_tpu.ops import pallas_turboquant as ptq

from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import turboquant_kernel as tqk
from qrack_tpu_torch.ops import window_kernel as wk
from qrack_tpu_torch.storage import turboquant as tq

CODE_FRAC = {8: 1e-3, 16: 1e-2}
SCALE_REL = 1e-6


def _ket(rng, n, bits, bp):
    st = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    st /= np.linalg.norm(st)
    scales, codes, _ = tq.quantize_blocks(st, bits=bits, block_pow=bp)
    rot = tq.rotation_matrix(2 << bp)
    return codes, scales, rot


def _unitary(rng):
    z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    return np.linalg.qr(z)[0]


def _run_both(jax_fn, jax_args, port_fn, port_args, codes, scales, rot):
    jc, js = jax_fn(jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(rot),
                    jnp.asarray(rot.T), *jax_args)
    pc, ps = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    got = port_fn(pc, ps, torch.from_numpy(rot),
                  torch.from_numpy(np.ascontiguousarray(rot.T)), *port_args)
    assert got[0] is pc and got[1] is ps  # in place
    return np.asarray(jc), np.asarray(js), pc.numpy(), ps.numpy()


def _hold(jc, js, pc, ps, codes, scales, dirty, tb):
    d = np.abs(jc.astype(np.int32) - pc.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= CODE_FRAC[8 if codes.dtype == np.int8 else 16]
    safe = np.where(js == 0, 1.0, js)
    assert np.all(np.abs(ps - js) <= SCALE_REL * np.abs(safe))
    clean = np.repeat(~dirty, tb)
    for c, s in ((jc, js), (pc, ps)):
        assert np.array_equal(c[clean], codes[clean])
        assert np.array_equal(s[clean], scales[clean])


def _tiles(n, bp, tp):
    nblk = 1 << (n - tp)
    return torch.arange(nblk, dtype=torch.int32).view(nblk, 1), 1 << (tp - bp)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("case", ["plain", "lo_ctrl", "hi_ctrl", "mixed"])
def test_gate_low_matches_pallas(bits, case):
    rng = np.random.default_rng(100 + bits + len(case))
    n, bp, tp = 8, 2, 4
    codes, scales, rot = _ket(rng, n, bits, bp)
    m = _unitary(rng)
    mp = np.stack([m.real, m.imag]).astype(np.float32)
    target = 2
    cmask = {"plain": 0, "lo_ctrl": 0b1, "hi_ctrl": 1 << 6,
             "mixed": 0b1001 | (1 << 5) | (1 << 7)}[case]
    cval = cmask & 0b1010_0001  # mixed control values
    T = 1 << tp
    args = (cmask >> tp, cval >> tp, cmask & (T - 1), cval & (T - 1))
    jfn = ptq.make_tq_gate_low(n, bp, bits, target, tile_pow=tp,
                               interpret=True)
    out = _run_both(jfn, (mp,) + args, tqk.tq_gate_low,
                    (bits, tp, mp, target) + args, codes, scales, rot)
    blk, tb = _tiles(n, bp, tp)
    dirty = tqk.gate_low_dirty(blk, args[0], args[1]).view(-1).numpy()
    _hold(*out, codes, scales, dirty, tb)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("case", ["low", "high", "high_ctrl", "unit_high"])
def test_diag_matches_pallas(bits, case):
    rng = np.random.default_rng(200 + bits + len(case))
    n, bp, tp = 9, 3, 5
    codes, scales, rot = _ket(rng, n, bits, bp)
    d0, d1 = np.exp(1j * rng.uniform(0, 2 * np.pi, 2))
    target = {"low": 3, "high": 7, "high_ctrl": 6, "unit_high": 8}[case]
    cmask = {"high_ctrl": 0b10 | (1 << 8)}.get(case, 0)
    cval = cmask & 0b1_0000_0000
    if case == "unit_high":
        d0 = 1.0  # tiles with the target bit clear keep their codes exactly
    T = 1 << tp
    dp = np.zeros((2, 2, 2), np.float32)
    dp[0, 0, 0], dp[0, 0, 1] = np.real(d0), np.real(d1)
    dp[1, 0, 0], dp[1, 0, 1] = np.imag(d0), np.imag(d1)
    tm_lo = (1 << target) if target < tp else 0
    tb_hi = 0 if target < tp else 1 << (target - tp)
    args = (tm_lo, tb_hi, cmask & (T - 1), cval & (T - 1), cmask >> tp,
            cval >> tp)
    jfn = ptq.make_tq_diag(n, bp, bits, tile_pow=tp, interpret=True)
    out = _run_both(jfn, (dp,) + args, tqk.tq_diag, (bits, tp, dp) + args,
                    codes, scales, rot)
    blk, tb = _tiles(n, bp, tp)
    dirty = tqk.diag_dirty(blk, dp, tm_lo, tb_hi, args[2], args[4],
                           args[5]).view(-1).numpy()
    if case == "unit_high":
        assert dirty.sum() == len(dirty) // 2
    _hold(*out, codes, scales, dirty, tb)


def _window_ops(rng, n, tp, mod):
    """Ops over the fuser vocabulary, as FusedOps of `mod` (either
    package's fusion module): cphase with and without controls,
    diagonals below and above the tile (the one above has a unit factor
    on the half of the tiles with its bit clear, which stay clean), gen
    and inv inside the tile."""
    out = []
    phase = np.exp(1j * rng.uniform(0, 2 * np.pi, 4))
    top = 1 << (n - 1)
    for kind, target, cmask, cval, m in (
            ("cphase", n - 1, 0, 0, np.diag([1.0, phase[0]])),
            ("cphase", 2, 1 << (n - 2), 1 << (n - 2), np.diag([1.0, phase[1]])),
            ("gen", 1, 0b1000 | top, top, _unitary(rng)),
            ("diag", tp + 1, top, 0, np.diag([1.0, phase[2]])),
            ("diag", 0, top, top, np.diag([phase[3], phase[0]])),
            ("inv", 3, 0, 0, np.array([[0, phase[1]], [phase[2], 0]])),
            ("gen", tp - 1, 0, 0, _unitary(rng))):
        m = np.asarray(m, dtype=np.complex128)
        out.append(mod.FusedOp(mod.classify(m, cmask, cval), target, cmask,
                               cval, m))
    return out


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("hi_only", [False, True])
def test_window_matches_pallas(bits, hi_only):
    """A fused window in one sweep.  hi_only keeps just the ops whose
    high test leaves some tiles clean (so the dirty rule shows)."""
    rng = np.random.default_rng(300 + bits + hi_only)
    n, bp, tp = 8, 2, 4
    codes, scales, rot = _ket(rng, n, bits, bp)
    pops = _window_ops(np.random.default_rng(7), n, tp, fu)
    jops = _window_ops(np.random.default_rng(7), n, tp, jfu)
    if hi_only:
        pops, jops = pops[3:5], jops[3:5]
    structure = fu.sharded_structure_of(pops)
    assert structure == jfu.sharded_structure_of(jops)
    operands = fu.sharded_operands(pops, tp, torch.float32, device="cpu")
    joperands = jfu.sharded_operands(jops, tp, jnp.float32)
    assert len(operands) == len(joperands)
    for a, b in zip(operands, joperands):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jfn = ptq.make_tq_window(n, bp, bits, structure, tile_pow=tp,
                             interpret=True)
    out = _run_both(jfn, tuple(joperands), tqk.tq_window,
                    (bits, tp, structure, operands), codes, scales, rot)
    table, fv, iv = tqk.pack_window(structure, operands, "cpu")
    blk, tb = _tiles(n, bp, tp)
    dirty = tqk.window_dirty(blk, tp, table.tolist(), fv, iv).view(-1).numpy()
    assert dirty.any() and (hi_only != dirty.all())
    _hold(*out, codes, scales, dirty, tb)


def test_qft_window_matches_pallas():
    """The windows a QFT flushes: controlled phases only."""
    from qrack_tpu.models.qft import qft_qcircuit

    rng = np.random.default_rng(11)
    n, bp, tp, bits = 9, 3, 5, 8
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
                    tqk.tq_window, (bits, tp, structure, operands),
                    codes, scales, rot)
    table, fv, iv = tqk.pack_window(structure, operands, "cpu")
    blk, tb = _tiles(n, bp, tp)
    dirty = tqk.window_dirty(blk, tp, table.tolist(), fv, iv).view(-1).numpy()
    _hold(*out, codes, scales, dirty, tb)


@pytest.mark.parametrize("prim", ["cphase", "diag_low", "diag_high", "local"])
def test_tile_primitives_match_jax(prim):
    """The shared tile primitives, batched over tiles, against the JAX
    package's per-tile pallas_kernels.tile_* (planes exact to 1e-6)."""
    rng = np.random.default_rng(400 + len(prim))
    L, tiles = 5, 4
    v = rng.normal(size=(2, tiles, 1 << L)).astype(np.float32)
    lidx = torch.arange(1 << L, dtype=torch.int32)
    blk = torch.arange(tiles, dtype=torch.int32).view(tiles, 1)
    jl = jnp.arange(1 << L, dtype=jnp.int32)
    f = rng.normal(size=8).astype(np.float32)
    for t in range(tiles):
        vt = torch.from_numpy(v)
        if prim == "cphase":
            got, ok = wk.tile_cphase(vt, lidx, blk, 0b100, 0b1,
                                     float(f[0]), float(f[1]))
            want, jok = pk.tile_cphase(jnp.asarray(v[:, t]), jl, t, 0b100,
                                       0b1, f[0], f[1])
        elif prim.startswith("diag"):
            target = 2 if prim == "diag_low" else L + 1
            args = (target, L, float(f[0]), float(f[1]), float(f[2]),
                    float(f[3]), 0b1, 0b1, 0b1, 0)
            got, ok = wk.tile_diag(vt, lidx, blk, *args)
            want, jok = pk.tile_diag(jnp.asarray(v[:, t]), jl, t, *args)
        else:
            mp = f.reshape(2, 2, 2)
            got, ok = wk.tile_local_2x2(vt, lidx, blk, 3, mp.tolist(),
                                        0b1, 0b1, 0b10, 0b10)
            want, jok = pk.tile_local_2x2(jnp.asarray(v[:, t]), jl, t, 3, mp,
                                          0b1, 0b1, 0b10, 0b10)
        np.testing.assert_allclose(got[:, t].numpy(), np.asarray(want),
                                   atol=1e-6)
        assert bool(ok[t, 0]) == bool(jok)


def test_pack_window_layout():
    """The op table's offsets walk the split-mask operand layout."""
    pops = _window_ops(np.random.default_rng(7), 8, 4, fu)
    structure = fu.sharded_structure_of(pops)
    operands = fu.sharded_operands(pops, 4, torch.float32, device="cpu")
    table, fv, iv = tqk.pack_window(structure, operands, "cpu")
    rows = table.tolist()
    assert [r[0] for r in rows] == [wk.KIND_CODE[k] for k, _t, _c in structure]
    assert rows[-1][3] + 8 == fv.numel()
    assert iv.numel() == sum(4 if k != "cphase" else 2
                             for k, _t, c in structure if c)
    assert rows[2][3] == 4 and rows[2][4] == 2  # after cphase, cphase(ctrl)


def test_kernel_refuses_what_it_does_not_take():
    codes = torch.zeros((64, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="whole blocks"):
        tqk.layout(codes, 1)
    assert tqk.smem_bytes(6, 13) <= tqk.SMEM_LIMIT < tqk.smem_bytes(6, 14)
    with pytest.raises(ValueError, match="inside"):
        tqk.tq_window_plain(codes, torch.zeros(64), torch.eye(8),
                            torch.eye(8), 8, 4, (("gen", 4, False),),
                            [np.zeros((2, 2, 2), np.float32)])
    with pytest.raises(ValueError, match="device"):
        tqk._launch("diag", codes.to("meta"), None, None, None, 8, 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the TurboQuant kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_cuda_kernel_matches_plain(cuda_device, bits):
    rng = np.random.default_rng(500 + bits)
    n, bp, tp = 16, 6, 12
    codes, scales, rot = _ket(rng, n, bits, bp)
    pops = _window_ops(np.random.default_rng(9), n, tp, fu)
    structure = fu.sharded_structure_of(pops)
    operands = fu.sharded_operands(pops, tp, torch.float32, cuda_device)
    r = torch.from_numpy(rot).to(cuda_device)
    rt = r.T.contiguous()
    outs = []
    for fn in (tqk.tq_window, tqk.tq_window_plain):
        c = torch.from_numpy(codes.copy()).to(cuda_device)
        s = torch.from_numpy(scales.copy()).to(cuda_device)
        fn(c, s, r, rt, bits, tp, structure, operands)
        torch.cuda.synchronize()
        outs.append((c.cpu().numpy(), s.cpu().numpy()))
    (kc, ks), (pc, ps) = outs
    d = np.abs(kc.astype(np.int32) - pc.astype(np.int32))
    assert d.max() <= 1
    np.testing.assert_allclose(ks, ps, rtol=1e-5)
