"""The port's FPPOW planes (float64, bfloat16, float16) and its
float32 -> float64 drift escalation against the JAX package.

* The dense engine at each dtype against QEngineTPU at the same dtype,
  on the engine tests' vocabulary stream, with the fused window going
  through the window kernel's plain version (QRACK_TPU_FUSE_KERNEL=on)
  and through the plain gate functions (off).
* The window kernel's plain sweeps (in_tile_sweep_plain,
  pair_sweep_plain) at each dtype against the Pallas window kernel under
  the interpreter.
* The drift escalation, as tests/test_fp64.py drives the JAX engine.
* Operand rounding: the port's payloads and packed vectors in bfloat16
  and float16 are bit for bit the JAX package's.

Every float64 run of the JAX package is a subprocess: jax_enable_x64 is
process-wide, and the other tests of the worker must keep float32.

Tolerances.  float64: 1e-12 on amplitudes (both sides are float64 over
a few dozen ops).  16-bit planes: the JAX package rounds after every op
and the port's window kernel rounds once per sweep, in float32 between
(window_kernel module docstring), so the two differ by a few roundings
of the dtype: fidelity against the JAX engine and against the
complex128 oracle >= 1 - 1e-3 at bfloat16 (8-bit significand) and
>= 1 - 1e-5 at float16 (11 bits); Prob within 4 ulps of the dtype at
1.0 (1.6e-2 and 2e-3); window results within 8 ulps of the dtype at the
largest |amp|.  The kernel against its plain version on the card: 1e-13
of the largest |amp| at float64, 4 ulps at 16 bits (both compute in
float32 and round once; FMA contraction moves a value across a rounding
boundary now and then).
"""

import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from qrack_tpu.engines.cpu import QEngineCPU as JaxCPU
    from qrack_tpu.engines.tpu import QEngineTPU
    from qrack_tpu.ops import fusion as jfu
    from qrack_tpu.ops import gatekernels as jgk
    from qrack_tpu.ops import pallas_kernels as pk
    from qrack_tpu.utils.rng import QrackRandom as JaxRandom
except ImportError:  # without JAX only the tests against the kernel run
    jnp = None

import qrack_tpu_torch as qt
from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import gatekernels as gk
from qrack_tpu_torch.ops import window_kernel as wk
from qrack_tpu_torch.utils.rng import QrackRandom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 6
HALF = {"bfloat16": 7, "float16": 10}          # significand bits after the 1
FID_BAR = {"bfloat16": 1e-3, "float16": 1e-5}
KINDS = ("cphase", "diag", "inv", "gen")


@pytest.fixture
def jax_pkg():
    if jnp is None:
        pytest.skip("needs the JAX package")


def ulp(x: float, name: str) -> float:
    """One unit in the last place of the 16-bit dtype `name` at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - HALF[name])


def fidelity(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)


def vocab_stream():
    """The engine tests' fuser vocabulary, then a seeded random stream
    of MCMtrxPerm/H/CNOT/RZ/CZ/X/RY (tests/test_torch_engine.py)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_engine import _VOCAB, _random_stream

    return list(_VOCAB) + _random_stream(3, N, 40)


def random_ops(rng, n, k):
    """k random window ops as (target, cmask, cval, m) over the whole
    vocabulary: targets anywhere, 0-2 controls, mixed control values."""
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
    return out


def port_ops(raw):
    return [fu.FusedOp(fu.classify(m, cm, cv), t, cm, cv, m)
            for t, cm, cv, m in raw]


def unit_planes(rng, n):
    psi = rng.normal(size=(2, 1 << n))
    return psi / np.sqrt((psi ** 2).sum())


def run_jax64(script: str, tmp_path, **env_extra) -> None:
    """Run `script` in a subprocess with jax_enable_x64 on; it reads and
    writes files under tmp_path (TMP in its namespace)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"JAX_PLATFORMS": "cpu", "QRACK_TPU_FPPOW": "float64"},
               **env_extra)
    head = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "import jax\njax.config.update('jax_enable_x64', True)\n"
            f"TMP = {str(tmp_path)!r}\n")
    res = subprocess.run([sys.executable, "-c", head + script],
                         capture_output=True, text=True, timeout=420, env=env)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])


# ---------------------------------------------------------------------------
# the engine at each dtype against the JAX engine
# ---------------------------------------------------------------------------

def port_engine(dtype, stream, mode, monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", mode)
    p = qt.QEngineCUDA(N, dtype=dtype, device="cpu", rng=QrackRandom(1),
                       rand_global_phase=False)
    for name, args in stream:
        getattr(p, name)(*args)
    p.Finish()
    monkeypatch.delenv("QRACK_TPU_FUSE_KERNEL")
    return p


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_engine_matches_jax_at_16_bits(jax_pkg, name, mode, monkeypatch):
    stream = vocab_stream()
    p = port_engine(getattr(torch, name), stream, mode, monkeypatch)
    assert p.device_planes.dtype == getattr(torch, name)
    j = QEngineTPU(N, dtype=getattr(jnp, name), rng=JaxRandom(1),
                   rand_global_phase=False)
    o = JaxCPU(N, rng=JaxRandom(1), rand_global_phase=False)
    for op, args in stream:
        getattr(j, op)(*args)
        getattr(o, op)(*args)
    got = p.GetQuantumState()
    assert fidelity(got, np.asarray(j.GetQuantumState())) >= 1 - FID_BAR[name]
    assert fidelity(got, o.GetQuantumState()) >= 1 - FID_BAR[name]
    for q in range(N):
        assert abs(p.Prob(q) - j.Prob(q)) <= 4 * ulp(1.0, name)


@pytest.mark.parametrize("mode", ["on", "off"])
def test_engine_matches_jax_at_float64(jax_pkg, mode, monkeypatch, tmp_path):
    stream = vocab_stream()
    with open(tmp_path / "stream.pkl", "wb") as f:
        pickle.dump(stream, f)
    run_jax64("""
import pickle
import numpy as np
import jax.numpy as jnp
from qrack_tpu.engines.tpu import QEngineTPU
from qrack_tpu.utils.rng import QrackRandom
stream = pickle.load(open(TMP + '/stream.pkl', 'rb'))
j = QEngineTPU(6, rng=QrackRandom(1), rand_global_phase=False)
assert j.dtype == jnp.float64
for name, args in stream:
    getattr(j, name)(*args)
np.save(TMP + '/ket.npy', np.asarray(j.GetQuantumState()))
np.save(TMP + '/probs.npy', np.asarray([j.Prob(q) for q in range(6)]))
""", tmp_path)
    p = port_engine(torch.float64, stream, mode, monkeypatch)
    assert p.device_planes.dtype == torch.float64
    want = np.load(tmp_path / "ket.npy")
    assert np.abs(p.GetQuantumState() - want).max() <= 1e-12
    probs = np.load(tmp_path / "probs.npy")
    assert max(abs(p.Prob(q) - probs[q]) for q in range(N)) <= 1e-12


# ---------------------------------------------------------------------------
# the window kernel's plain sweeps against interpret-mode Pallas
# ---------------------------------------------------------------------------

def port_window(raw, n, bp, psi, dtype):
    ops = port_ops(raw)
    structure = fu.structure_of(ops)
    planes = gk.host_tensor(psi, dtype)
    wk.reset_launches()
    out = wk.make_window_fn(n, structure, block_pow=bp)(
        planes, *fu.dense_operands(ops, dtype))
    assert wk.launches() == {"in_tile": 0, "pair": 0}  # the plain version ran
    return out.to(torch.float64).numpy(), wk.plan_sweeps(structure, bp, n)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_plain_sweeps_match_pallas_at_16_bits(jax_pkg, name, seed):
    rng = np.random.default_rng(700 + seed)
    n, bp = 8, 3
    raw = random_ops(rng, n, 14)
    psi = unit_planes(rng, n)
    got, sweeps = port_window(raw, n, bp, psi, getattr(torch, name))
    assert sweeps >= 2   # both entry points: pair-led segments and in-tile
    jops = [jfu.FusedOp(jfu.classify(m, cm, cv), t, cm, cv, m)
            for t, cm, cv, m in raw]
    jdt = getattr(jnp, name)
    fn = pk.make_window_fn(n, jfu.structure_of(jops), block_pow=bp,
                           interpret=True)
    want = np.asarray(fn(jnp.asarray(psi, jdt),
                         *jfu.dense_operands(jops, jdt))).astype(np.float64)
    exact, _ = port_window(raw, n, bp, psi, torch.float64)
    bar = 8 * ulp(np.abs(exact).max(), name)
    assert np.abs(got - want).max() <= bar
    # one rounding a sweep: never further from the exact result than the
    # JAX kernel, which rounds after every op, by more than a rounding
    assert (np.abs(got - exact).max()
            <= np.abs(want - exact).max() + ulp(np.abs(exact).max(), name))


def test_plain_sweeps_match_pallas_at_float64(jax_pkg, tmp_path):
    cases = []
    for seed in range(3):
        rng = np.random.default_rng(800 + seed)
        cases.append((random_ops(rng, 8, 14), unit_planes(rng, 8)))
    with open(tmp_path / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    run_jax64("""
import pickle
import numpy as np
import jax.numpy as jnp
from qrack_tpu.ops import fusion as jfu
from qrack_tpu.ops import pallas_kernels as pk
out = []
for raw, psi in pickle.load(open(TMP + '/cases.pkl', 'rb')):
    ops = [jfu.FusedOp(jfu.classify(m, cm, cv), t, cm, cv, m)
           for t, cm, cv, m in raw]
    fn = pk.make_window_fn(8, jfu.structure_of(ops), block_pow=3,
                           interpret=True)
    r = fn(jnp.asarray(psi, jnp.float64), *jfu.dense_operands(ops, jnp.float64))
    assert r.dtype == jnp.float64
    out.append(np.asarray(r))
np.save(TMP + '/out.npy', np.stack(out))
""", tmp_path)
    want = np.load(tmp_path / "out.npy")
    for (raw, psi), w in zip(cases, want):
        got, _ = port_window(raw, 8, 3, psi, torch.float64)
        assert np.abs(got - w).max() <= 1e-12


def test_plain_sweeps_round_once_at_16_bits():
    """The plain sweep at 16 bits is the float32 sweep rounded once."""
    rng = np.random.default_rng(17)
    n, bp = 8, 3
    raw = random_ops(rng, n, 20)
    psi = unit_planes(rng, n)
    for name in HALF:
        dt = getattr(torch, name)
        got, _ = port_window(raw, n, bp, psi, dt)
        ops = port_ops(raw)
        structure = fu.structure_of(ops)
        x = gk.host_tensor(psi, dt).to(torch.float32)
        fv, iv = wk.pack_operands(structure, fu.dense_operands(ops, dt),
                                  torch.float32, "cpu")
        table = wk.op_table(structure, "cpu")
        for xop, first, count in wk.segment_launches(structure, bp):
            if xop is None:
                wk.in_tile_sweep_plain(x, n, bp, table, fv, iv, first, count)
            else:
                wk.pair_sweep_plain(x, n, bp, table, fv, iv, xop, first, count)
            x = x.to(dt).to(torch.float32)
        assert np.array_equal(got, x.to(torch.float64).numpy())


# ---------------------------------------------------------------------------
# the float32 -> float64 drift escalation
# ---------------------------------------------------------------------------

def test_drift_escalation_matches_jax(jax_pkg, monkeypatch, tmp_path):
    """As tests/test_fp64.py drives the JAX engine: 2% of norm drift
    injected, QRACK_TPU_AUTO_F64_DRIFT=1e-3 checked every 4 gates.  The
    port's engine re-casts its own planes to float64 and warns once;
    nothing else in the process changes (the default dtype, another
    engine's planes)."""
    env = {"QRACK_TPU_AUTO_F64_DRIFT": "1e-3",
           "QRACK_TPU_DRIFT_CHECK_GATES": "4"}
    run_jax64("""
import numpy as np
import jax.numpy as jnp
from qrack_tpu.engines.tpu import QEngineTPU
from qrack_tpu.utils.rng import QrackRandom
e = QEngineTPU(3, dtype=jnp.float32, rng=QrackRandom(3),
               rand_global_phase=False)
e._state = e._state * np.float32(1.01)
for i in range(8):
    e.H(i % 3)
assert e.dtype == jnp.float64
e.CNOT(0, 1)
np.save(TMP + '/ket.npy', np.asarray(e.GetQuantumState()))
""", tmp_path, **env)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bystander = qt.QEngineCUDA(3, device="cpu")
    default = torch.get_default_dtype()
    e = qt.QEngineCUDA(3, device="cpu", rng=QrackRandom(3),
                       rand_global_phase=False)
    assert e.dtype == torch.float32
    e._state = e._state * 1.01   # inject 2% norm drift
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for i in range(8):
            e.H(i % 3)
        assert e.dtype == torch.float64
        assert e.device_planes.dtype == torch.float64
        for i in range(40):   # no second escalation, no second warning
            e.H(i % 3)
        for i in range(40):
            e.H(i % 3)
    assert sum("escalating" in str(r.message) for r in rec) == 1
    e.CNOT(0, 1)
    assert fidelity(e.GetQuantumState(), np.load(tmp_path / "ket.npy")) \
        >= 1 - 1e-6
    assert torch.get_default_dtype() == default
    assert bystander.dtype == torch.float32
    assert bystander.device_planes.dtype == torch.float32


def test_no_escalation_without_drift(monkeypatch):
    """A unitary float32 circuit keeps its norm: no escalation, and none
    when the variable is unset."""
    monkeypatch.setenv("QRACK_TPU_AUTO_F64_DRIFT", "1e-3")
    monkeypatch.setenv("QRACK_TPU_DRIFT_CHECK_GATES", "4")
    e = qt.QEngineCUDA(3, device="cpu")
    for i in range(32):
        e.H(i % 3)
        e.T(i % 3)
    assert e.dtype == torch.float32
    monkeypatch.delenv("QRACK_TPU_AUTO_F64_DRIFT")
    f = qt.QEngineCUDA(3, device="cpu")
    f._state = f._state * 1.01
    for i in range(32):
        f.H(i % 3)
    assert f.dtype == torch.float32


# ---------------------------------------------------------------------------
# operand rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bfloat16", "float16", "float32"])
def test_operand_rounding_matches_jax(jax_pkg, name):
    """dense_operands, pack_operands, to_planes and mtrx_planes round as
    the JAX package does, value for value: bfloat16 through float32,
    float16 straight from float64 (torch's own float16 conversion would
    round twice, and differs)."""
    rng = np.random.default_rng(23)
    raw = random_ops(rng, 10, 300)
    dt, jdt = getattr(torch, name), getattr(jnp, name)
    ops = port_ops(raw)
    jops = [jfu.FusedOp(jfu.classify(m, cm, cv), t, cm, cv, m)
            for t, cm, cv, m in raw]
    mine = fu.dense_operands(ops, dt)
    theirs = jfu.dense_operands(jops, jdt)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        if isinstance(a, int):
            assert a == int(b)
        else:
            assert a.dtype == dt
            assert np.array_equal(a.to(torch.float64).numpy(),
                                  np.asarray(b).astype(np.float64))
    structure = fu.structure_of(ops)
    fv, iv = wk.pack_operands(structure, mine, dt, "cpu")
    jfv, jiv = pk.pack_operands(structure, theirs, jdt)
    assert fv.dtype == dt
    assert np.array_equal(fv.to(torch.float64).numpy(),
                          np.asarray(jfv).reshape(-1).astype(np.float64))
    assert np.array_equal(iv.numpy(), np.asarray(jiv).reshape(-1))
    ket = rng.normal(size=64) + 1j * rng.normal(size=64)
    assert np.array_equal(
        gk.to_planes(ket, dt, "cpu").to(torch.float64).numpy(),
        np.asarray(jgk.to_planes(ket, jdt)).astype(np.float64))
    m = raw[0][3]
    assert np.array_equal(
        gk.mtrx_planes(m, dt, "cpu").to(torch.float64).numpy(),
        np.asarray(jgk.mtrx_planes(m, jdt)).astype(np.float64))


@pytest.mark.parametrize("name", ["bfloat16", "float16", "float32"])
def test_planes_carry_across_at_each_dtype(jax_pkg, name):
    """convert.planes_from_numpy takes a JAX engine's planes in their own
    dtype and planes_to_numpy gives them back value for value, so both
    packages go on from the same state."""
    from qrack_tpu_torch.convert import planes_from_numpy, planes_to_numpy

    stream = vocab_stream()
    j = QEngineTPU(N, dtype=getattr(jnp, name), rng=JaxRandom(1),
                   rand_global_phase=False)
    for op, args in stream[:20]:
        getattr(j, op)(*args)
    jplanes = np.asarray(j._state)
    planes = planes_from_numpy(jplanes, device="cpu")
    assert planes.dtype == getattr(torch, name)
    assert np.array_equal(planes_to_numpy(planes).astype(np.float64),
                          jplanes.astype(np.float64))
    p = qt.QEngineCUDA(N, dtype=planes.dtype, device="cpu",
                       rng=QrackRandom(1), rand_global_phase=False)
    p._state = planes
    for op, args in stream[20:]:
        getattr(p, op)(*args)
        getattr(j, op)(*args)
    assert fidelity(p.GetQuantumState(), np.asarray(j.GetQuantumState())) \
        >= 1 - FID_BAR.get(name, 1e-6)


# ---------------------------------------------------------------------------
# the CUDA kernel's dtype forms against their plain versions (the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["float64", "bfloat16", "float16"])
@pytest.mark.parametrize("entry", ["in_tile", "pair"])
def test_cuda_dtype_forms_match_plain(cuda_device, name, entry):
    dt = getattr(torch, name)
    rng = np.random.default_rng(900)
    n, bp = 16, 12
    raw = random_ops(rng, n, 40)
    if entry == "in_tile":   # no cross-tile inv/gen: one in-tile sweep
        raw = [(t % bp if fu.classify(m, cm, cv) in ("inv", "gen") else t,
                cm, cv, m) for t, cm, cv, m in raw]
    else:                    # led by a cross-tile op: one pair sweep
        raw = [(bp + 2, 0, 0, raw[0][3] if fu.classify(
            raw[0][3], 0, 0) == "gen" else np.eye(2)[::-1].copy())] + [
            (t % bp if fu.classify(m, cm, cv) in ("inv", "gen") else t,
             cm, cv, m) for t, cm, cv, m in raw]
    ops = port_ops(raw)
    structure = fu.structure_of(ops)
    assert len(wk.segment_launches(structure, bp)) == 1
    operands = fu.dense_operands(ops, dt)
    x = gk.host_tensor(unit_planes(rng, n), dt).to(cuda_device)
    wk.reset_launches()
    got = wk.make_window_fn(n, structure, block_pow=bp)(x.clone(), *operands)
    torch.cuda.synchronize()
    assert wk.launches()[entry] == 1 and sum(wk.launches().values()) == 1
    want = wk.make_window_fn(n, structure, block_pow=bp, plain=True)(
        x.clone(), *operands)
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    bar = 1e-13 * scale if dt == torch.float64 else 4 * ulp(scale, name)
    assert err <= bar
