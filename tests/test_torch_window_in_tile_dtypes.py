"""The in-tile sweep's emulation (window_kernel.in_tile_sweep_emulated)
in float64, bfloat16 and float16 planes against the plain in-tile sweep
and the JAX package's Pallas window kernel under the interpreter, at
every tile size the planner makes (bp 1 to window_kernel.max_block_pow:
13, 12 for float64).  Each segment's inv/gen targets cycle through the
register, lane and warp bits of the dtype's tile layout, and its
controls and diagonal targets reach above the tile.  The float32 form
and the layout itself are in test_torch_window_in_tile.py.

Tolerances, those of tests/test_torch_fppow.py.  float64: 1e-12 on
amplitudes against Pallas (both float64 over a few dozen ops).  16-bit
planes: the emulation, like the kernel, computes the segment in float32
and rounds once; the Pallas kernel rounds after every op.  So the two
are held within 8 units in the last place of the dtype at the largest
|amp|, and the emulation is never further from the exact (float64)
result than Pallas is by more than one unit.  The emulation against the
plain sweep: 4 units at 16 bits (both round once; op order differs),
1e-13 of the largest |amp| in float64.

Every float64 run of the JAX package is a subprocess: jax_enable_x64 is
process-wide, and the other tests of the worker must keep float32.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from qrack_tpu.ops import fusion as jfu
    from qrack_tpu.ops import pallas_kernels as pk
except ImportError:  # without JAX these tests skip
    jnp = jfu = pk = None

from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import window_kernel as wk

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_window_in_tile import (  # noqa: E402
    fused, plain_bar, tile_segment, tile_sweeps, ulp)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = 16


@pytest.fixture
def jax_pkg():
    if pk is None:
        pytest.skip("needs the JAX package")


def case(name, bp):
    """(n, raw ops, float64 unit planes) of the dtype and tile size."""
    n = bp + 2
    rng = np.random.default_rng(7500 + 16 * bp + len(name))
    raw = tile_segment(rng, n, bp, OPS, getattr(torch, name))
    psi = rng.normal(size=(2, 1 << n))
    return n, raw, psi / np.sqrt((psi ** 2).sum())


@pytest.mark.parametrize("bp", range(1, wk.MAX_BLOCK_POW + 1))
@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_16_bit_tiles_match_pallas(jax_pkg, name, bp):
    dt = getattr(torch, name)
    n, raw, psi = case(name, bp)
    # both sides start from the same 16-bit planes
    psi = torch.tensor(psi).to(dt).double().numpy()
    plain, emulated = tile_sweeps(n, bp, fused(raw, fu), psi, dt)
    exact, _ = tile_sweeps(n, bp, fused(raw, fu), psi, torch.float64)
    jops = fused(raw, jfu)
    jdt = getattr(jnp, name)
    fn = pk.make_window_fn(n, jfu.structure_of(jops), block_pow=bp,
                           interpret=True)
    want = np.asarray(fn(jnp.asarray(psi.astype(np.float32)).astype(jdt),
                         *jfu.dense_operands(jops, jdt))).astype(np.float64)
    scale = np.abs(exact).max()
    assert np.abs(emulated - plain).max() <= plain_bar(name, scale)
    assert np.abs(emulated - want).max() <= 8 * ulp(scale, name)
    assert (np.abs(emulated - exact).max()
            <= np.abs(want - exact).max() + ulp(scale, name))


def test_float64_tiles_match_pallas(jax_pkg, tmp_path):
    top = wk.max_block_pow(torch.float64)
    cases = [case("float64", bp) for bp in range(1, top + 1)]
    with open(tmp_path / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    script = f"""
import sys
sys.path.insert(0, {REPO!r})
import pickle
import jax
jax.config.update('jax_enable_x64', True)
import numpy as np
import jax.numpy as jnp
from qrack_tpu.ops import fusion as jfu
from qrack_tpu.ops import pallas_kernels as pk
TMP = {str(tmp_path)!r}
out = []
for bp, (n, raw, psi) in enumerate(pickle.load(open(TMP + '/cases.pkl', 'rb')), 1):
    ops = [jfu.FusedOp(jfu.classify(m, cm, cv), t, cm, cv, m)
           for t, cm, cv, m in raw]
    fn = pk.make_window_fn(n, jfu.structure_of(ops), block_pow=bp,
                           interpret=True)
    r = fn(jnp.asarray(psi, jnp.float64), *jfu.dense_operands(ops, jnp.float64))
    assert r.dtype == jnp.float64
    out.append(np.asarray(r))
pickle.dump(out, open(TMP + '/out.pkl', 'wb'))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"JAX_PLATFORMS": "cpu"})
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    with open(tmp_path / "out.pkl", "rb") as f:
        want = pickle.load(f)
    assert len(want) == top
    for bp, ((n, raw, psi), w) in enumerate(zip(cases, want), 1):
        plain, emulated = tile_sweeps(n, bp, fused(raw, fu), psi,
                                      torch.float64)
        assert np.abs(emulated - plain).max() <= plain_bar(
            "float64", np.abs(plain).max())
        assert np.abs(emulated - w).max() <= 1e-12
