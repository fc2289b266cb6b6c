"""The port's whole-circuit programs against the JAX package's: the QFT
programs of models/qft.py (qft_planes, iqft_planes, qft_planes_fast,
make_qft_fn) and QCircuit's compile_fn, compile_fn_pallas and
compile_batched_fn, plus the circuit digests the serving layer keys on.

Same seeded inputs on both sides, float32 planes.  Bars: 2e-6 on
amplitudes for a whole QFT against the JAX program (both float32, the
same passes; the JAX side fuses them under jit), 1e-6 for circuits of a
few dozen gates; compile_fn_pallas against the JAX Pallas form under
the interpreter, 1e-6; digests and the other host-side values exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qrack_tpu.layers.qcircuit import QCircuit as JaxCircuit
from qrack_tpu.models import qft as jqft
from qrack_tpu.ops import gatekernels as jgk

from qrack_tpu_torch import matrices as mat
from qrack_tpu_torch.convert import circuit_from_gates
from qrack_tpu_torch.layers.qcircuit import QCircuit
from qrack_tpu_torch.models import qft as qftm
from qrack_tpu_torch.ops import window_kernel as wk


def planes_of(rng, n):
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi /= np.linalg.norm(psi)
    return np.stack([psi.real, psi.imag]).astype(np.float32)


def random_circuit(rng, n, k):
    """A JAX-package QCircuit of k seeded gates (H, RZ, general 2x2,
    controlled and anti-controlled gates, CNOT, multi-payload gates),
    and the same gates, gate for gate, as a port QCircuit."""
    jc = JaxCircuit(n)
    for _ in range(k):
        kind = int(rng.integers(6))
        t = int(rng.integers(n))
        others = [q for q in range(n) if q != t]
        if kind == 0:
            jc.append_1q(t, np.asarray(mat.H2))
        elif kind == 1:
            a = float(rng.uniform(0, 2 * np.pi))
            jc.append_1q(t, np.diag([np.exp(-0.5j * a), np.exp(0.5j * a)]))
        elif kind == 2:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            jc.append_1q(t, np.linalg.qr(z)[0])
        elif kind == 3:
            c = int(rng.choice(others))
            jc.append_ctrl((c,), t, np.asarray(mat.X2), int(rng.integers(2)))
        elif kind == 4:
            c = int(rng.choice(others))
            ph = np.exp(1j * rng.uniform(0, 2 * np.pi))
            jc.append_ctrl((c,), t, np.diag([1.0, ph]), 1)
        else:
            cs = tuple(int(x) for x in rng.choice(others, 2, replace=False))
            for perm in range(4):
                z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
                jc.append_ctrl(cs, t, np.linalg.qr(z)[0], perm)
    port = circuit_from_gates([(g.target, g.controls, g.payloads)
                               for g in jc.gates], n)
    return jc, port


# ---------------------------------------------------------------------------
# models/qft.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_make_qft_fn_matches_jax(inverse, fast):
    n = 9
    psi = planes_of(np.random.default_rng(31 + inverse + 2 * fast), n)
    got = qftm.make_qft_fn(n, inverse=inverse, fast=fast)(torch.tensor(psi))
    want = np.asarray(jax.jit(jqft.make_qft_fn(n, inverse=inverse, fast=fast))(
        jnp.asarray(psi)))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-6


def test_qft_planes_iqft_planes_and_fast_form_match_jax():
    n = 8
    psi = planes_of(np.random.default_rng(5), n)
    x, jx = torch.tensor(psi), jnp.asarray(psi)
    pairs = [(qftm.qft_planes(x, n), jqft.qft_planes(jx, n)),
             (qftm.iqft_planes(x, n), jqft.iqft_planes(jx, n)),
             (qftm.qft_planes_fast(x, n), jqft.qft_planes_fast(jx, n)),
             (qftm.qft_planes_fast(x, n, inverse=True),
              jqft.qft_planes_fast(jx, n, inverse=True))]
    for got, want in pairs:
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-6
    # the input is left alone, and the IQFT undoes the QFT
    assert np.array_equal(x.numpy(), psi)
    back = qftm.iqft_planes(qftm.qft_planes(x, n), n)
    assert np.abs(back.numpy() - psi).max() <= 3e-6


def test_qft_programs_follow_the_engine_gate_order():
    """make_qft_fn, qft_qcircuit through RunFused and the engine's QFT
    give the same state (QInterface.QFT's order, no bit reversal)."""
    import qrack_tpu_torch as qt

    n = 7
    q = qt.create_quantum_interface("cuda", n, device="cpu",
                                    rand_global_phase=False)
    q.SetPermutation(37)
    q.QFT(0, n)
    got = qftm.make_qft_fn(n)(qftm.basis_planes(n, 37, device="cpu"))
    assert np.abs(got.numpy() - q.device_planes.numpy()).max() <= 2e-6
    r = qt.create_quantum_interface("cuda", n, device="cpu",
                                    rand_global_phase=False)
    r.SetPermutation(37)
    qftm.qft_qcircuit(n).RunFused(r)
    assert np.abs(r.device_planes.numpy() - got.numpy()).max() <= 2e-6


def test_qft_at_float64_and_16_bits():
    """The programs follow the planes' dtype: the float64 QFT agrees with
    the complex128 oracle (QEngineCPU) to float64 precision, and bf16
    planes stay bf16 at their own precision."""
    import qrack_tpu_torch as qt

    n = 8
    psi = planes_of(np.random.default_rng(9), n).astype(np.float64)
    o = qt.create_quantum_interface("cpu", n, rand_global_phase=False)
    o.SetQuantumState(psi[0] + 1j * psi[1])
    o.QFT(0, n)
    want = o.GetQuantumState()
    for fast in (False, True):
        got = qftm.make_qft_fn(n, fast=fast)(torch.tensor(psi,
                                                          dtype=torch.float64))
        assert got.dtype == torch.float64
        g = got.numpy()
        assert np.abs(g[0] + 1j * g[1] - want).max() <= 1e-12
    b16 = qftm.make_qft_fn(n)(torch.tensor(psi, dtype=torch.bfloat16))
    assert b16.dtype == torch.bfloat16
    b = b16.to(torch.float64).numpy()
    b = b[0] + 1j * b[1]
    f = abs(np.vdot(b, want)) ** 2 / np.vdot(b, b).real
    assert f >= 1 - 1e-3


def test_default_fast_rule(monkeypatch):
    """The carried-fraction form is the default on a CUDA device from
    FAST_COMPILE_QB qubits, the unrolled form on the CPU; an explicit
    QRACK_QFT_FAST_QB wins on every device."""
    monkeypatch.delenv("QRACK_QFT_FAST_QB", raising=False)
    top = qftm.FAST_COMPILE_QB
    assert not qftm.default_fast(top, "cpu")
    assert qftm.default_fast(top, "cuda")
    assert not qftm.default_fast(top - 1, "cuda")
    monkeypatch.setenv("QRACK_QFT_FAST_QB", "5")
    assert qftm.default_fast(5, "cpu") and qftm.default_fast(5, "cuda")
    assert not qftm.default_fast(4, "cuda")
    # the same rule as the JAX package's on its CPU backend
    assert jqft.default_fast(5) == qftm.default_fast(5, "cpu")
    monkeypatch.delenv("QRACK_QFT_FAST_QB")
    assert jqft.default_fast(top) == qftm.default_fast(top, "cpu")


# ---------------------------------------------------------------------------
# QCircuit's whole-circuit programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_compile_fn_matches_jax(seed):
    rng = np.random.default_rng(400 + seed)
    n = 7
    jc, pc = random_circuit(rng, n, 30)
    psi = planes_of(rng, n)
    x = torch.tensor(psi)
    got = pc.compile_fn(n)(x)
    want = np.asarray(jax.jit(jc.compile_fn(n))(jnp.asarray(psi)))
    assert np.abs(got.numpy() - want).max() <= 1e-6
    assert np.array_equal(x.numpy(), psi)   # a new ket; the input stays


@pytest.mark.parametrize("seed", range(3))
def test_compile_fn_pallas_matches_jax(seed):
    """The window kernel over the circuit's planned segments (its plain
    version here) against the Pallas form under the interpreter, at the
    same tile, with the same sweep count."""
    rng = np.random.default_rng(500 + seed)
    n, bp = 8, 4
    jc, pc = random_circuit(rng, n, 24)
    psi = planes_of(rng, n)
    fn = pc.compile_fn_pallas(n, block_pow=bp)
    jfn = jc.compile_fn_pallas(n, block_pow=bp, interpret=True)
    assert fn.sweeps == jfn.sweeps and fn.sweeps >= 2
    wk.reset_launches()
    got = fn(torch.tensor(psi))
    assert wk.launches() == {"in_tile": 0, "pair": 0}  # no card: plain
    want = np.asarray(jfn(jnp.asarray(psi)))
    assert np.abs(got.numpy() - want).max() <= 1e-6
    # the same function as compile_fn
    ref = pc.compile_fn(n)(torch.tensor(psi))
    assert np.abs(got.numpy() - ref.numpy()).max() <= 1e-6


def test_compile_fn_pallas_on_the_qft_circuit():
    """The whole-circuit kernel form of qft_qcircuit at the default tile:
    the same sweeps as the JAX form at that tile, the engine's QFT."""
    n = 14
    circ = qftm.qft_qcircuit(n)
    fn = circ.compile_fn_pallas(n)
    assert fn.sweeps == jqft.qft_qcircuit(n).compile_fn_pallas(
        n, block_pow=wk.DEFAULT_BLOCK_POW, interpret=True).sweeps
    got = fn(qftm.basis_planes(n, 1234, device="cpu"))
    want = qftm.make_qft_fn(n)(qftm.basis_planes(n, 1234, device="cpu"))
    assert np.abs(got.numpy() - want.numpy()).max() <= 2e-6


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_compile_batched_fn_matches_jax(batch):
    rng = np.random.default_rng(600 + batch)
    n = 6
    jc, pc = random_circuit(rng, n, 25)
    stacked = np.stack([planes_of(rng, n) for _ in range(batch)])
    got = pc.compile_batched_fn(n)(torch.tensor(stacked))
    assert tuple(got.shape) == (batch, 2, 1 << n)
    want = np.asarray(jax.jit(jc.compile_batched_fn(n))(jnp.asarray(stacked)))
    assert np.abs(got.numpy() - want).max() <= 1e-6
    # each ket as it would run alone
    for b in range(batch):
        alone = pc.compile_fn(n)(torch.tensor(stacked[b]))
        assert np.abs(got[b].numpy() - alone.numpy()).max() <= 1e-6


def test_compile_forms_reject_out_of_range_qubits():
    c = QCircuit(4)
    c.append_1q(3, np.asarray(mat.H2))
    with pytest.raises(ValueError):
        c.compile_fn_pallas(3)
    with pytest.raises(ValueError):
        c.compile_batched_fn(3)


# ---------------------------------------------------------------------------
# digests and the other host-side helpers
# ---------------------------------------------------------------------------

def test_digests_and_helpers_match_jax():
    rng = np.random.default_rng(77)
    jc, pc = random_circuit(rng, 6, 20)
    assert pc.structure_digest() == jc.structure_digest()
    for k in range(len(jc.gates) + 1):
        assert pc.prefix_digest(k) == jc.prefix_digest(k)
    with pytest.raises(IndexError):
        pc.prefix_digest(len(pc.gates) + 1)
    assert pc.prefix_digest(len(pc.gates)) == pc.structure_digest()
    assert pc.shape_key(6) == jc.shape_key(6)
    assert pc._lookahead_entries() == jc._lookahead_entries()
    assert pc.shareable_prefix_len() == jc.shareable_prefix_len() == len(
        pc.gates)
    for k in (0, 7, len(pc.gates)):
        pre, suf = pc.split_at(k)
        jpre, jsuf = jc.split_at(k)
        assert pre.structure_digest() == jpre.structure_digest()
        assert suf.structure_digest() == jsuf.structure_digest()
        assert len(pre.gates) + len(suf.gates) == len(pc.gates)
    # a recorded projector ends the shareable prefix; an append
    # invalidates the memoized chain
    proj = np.diag([1.0, 0.0]).astype(np.complex128)
    pc.append_1q(5, proj)
    jc.append_1q(5, proj)
    assert pc.shareable_prefix_len() == jc.shareable_prefix_len()
    assert pc.shareable_prefix_len() < len(pc.gates)
    assert pc.prefix_digest(len(pc.gates)) == jc.prefix_digest(len(jc.gates))


def test_qft_circuit_digest_matches_jax():
    for n in (3, 8):
        for inverse in (False, True):
            assert (qftm.qft_qcircuit(n, inverse).structure_digest()
                    == jqft.qft_qcircuit(n, inverse).structure_digest())
            assert (qftm.qft_qcircuit(n, inverse).shape_key(n)
                    == jqft.qft_qcircuit(n, inverse).shape_key(n))


def test_planes_helpers_agree_with_jax_basis():
    assert np.array_equal(qftm.basis_planes(5, 9, device="cpu").numpy(),
                          np.asarray(jqft.basis_planes(5, 9)))
    assert np.array_equal(
        qftm._h_mp(torch.float32).numpy(), np.asarray(jqft._h_mp(jnp.float32)))
    assert np.array_equal(np.asarray(jgk.from_planes(jqft.basis_planes(3, 2))),
                          np.eye(8)[2])
