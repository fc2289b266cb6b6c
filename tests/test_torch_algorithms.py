"""The port's algorithm programs (qrack_tpu_torch.models) against the JAX
package's, on the same seeds.

* Shor's order finding at n = 8 (N = 15, base 7, width 4): the
  input-register marginal after POWModNOut and IQFT on the port's CUDA
  engine (on the CPU) equals the JAX engine's and the host class-average
  construction (algorithms.order_finding_marginal) that chip_smoke.py
  holds the w30 run to; shor_order_find returns what the JAX one does.
* The eager programs (grover_search, teleport, ghz, quantum_volume and
  the table/neuron demos) on the port's engines against the JAX
  functions on the JAX engines, seeded alike.
* The fused programs (make_rcs_fn, make_grover_fn) against the JAX
  ones, and random_circuit_sampling against make_rcs_fn.
* apps.py (TFIM, QAOA) and the QCircuit builders' structure_digest.

Bars: 1e-6 absolute on float32 planes, 1e-12 between complex128
engines.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu.models import algorithms as jal
from qrack_tpu.models import apps as japps
from qrack_tpu.models import grover as jgrover
from qrack_tpu.models import rcs as jrcs
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.models import algorithms as al
from qrack_tpu_torch.models import apps
from qrack_tpu_torch.models import grover
from qrack_tpu_torch.models import rcs
from qrack_tpu_torch.models.qft import basis_planes
from qrack_tpu_torch.utils.rng import QrackRandom


def _port(n, seed, terminal="cuda"):
    kw = {"device": "cpu"} if terminal == "cuda" else {}
    return qt.create_quantum_interface(terminal, n, rng=QrackRandom(seed),
                                       rand_global_phase=False, **kw)


def _jax(n, seed, terminal="tpu"):
    if terminal == "cpu":
        return JaxCPU(n, rng=JaxRandom(seed), rand_global_phase=False)
    return jax_create("tpu", n, rng=JaxRandom(seed), rand_global_phase=False)


_PAIRS = [("cuda", "tpu", 1e-6), ("cpu", "cpu", 1e-12)]


# ---------------------------------------------------------------------------
# Shor
# ---------------------------------------------------------------------------

def _order_finding_body(q, base, mod_n, width):
    q.SetPermutation(0)
    for i in range(width):
        q.H(i)
    q.POWModNOut(base, mod_n, 0, width, width)
    q.IQFT(0, width)


def test_shor_marginal_matches_jax_and_the_class_construction():
    base, mod_n, width = 7, 15, 4
    port, ref = _port(2 * width, 1), _jax(2 * width, 1)
    for q in (port, ref):
        _order_finding_body(q, base, mod_n, width)
    p = port.device_planes
    got = (p[0] ** 2 + p[1] ** 2).reshape(1 << width, 1 << width).sum(0)
    want_jax = (np.abs(np.asarray(ref.GetQuantumState())) ** 2).reshape(
        1 << width, 1 << width).sum(0)
    host = al.order_finding_marginal(
        lambda w: qt.create_quantum_interface("cpu", w,
                                              rand_global_phase=False),
        base, mod_n, width)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), host, atol=1e-6)
    # this package's IQFT has no bit reversal: no four textbook peaks
    np.testing.assert_allclose(host[:4], [0.25, 0.2053, 0.1067, 0.0253],
                               atol=1e-4)
    assert abs(port.ProbReg(width, width, 1) - 0.25) <= 1e-6


@pytest.mark.parametrize("seed", [3, 8, 21])
@pytest.mark.parametrize("pterm,jterm,tol", _PAIRS)
def test_shor_order_find_matches_jax(seed, pterm, jterm, tol):
    port, ref = _port(8, seed, pterm), _jax(8, seed, jterm)
    assert al.shor_order_find(port, 7, 15, 4) == jal.shor_order_find(ref, 7, 15, 4)
    np.testing.assert_allclose(port.GetQuantumState(),
                               np.asarray(ref.GetQuantumState()), atol=tol)


# ---------------------------------------------------------------------------
# the eager programs
# ---------------------------------------------------------------------------

def _prep_teleport(q):
    q.RY(0.9, 0)
    q.RZ(0.4, 0)


_EAGER = {
    "ghz": lambda m, q: m.ghz(q),
    "grover_search": lambda m, q: m.grover_search(q, 45),
    "teleport": lambda m, q: m.teleport(q, _prep_teleport),
    "quantum_volume": lambda m, q: m.quantum_volume(q, 4),
    "rcs": lambda m, q: m.random_circuit_sampling(
        q, 4, q.rng.__class__(17)),
    "grover_lookup": lambda m, q: m.grover_lookup_search(
        q, [5, 1, 7, 2, 6, 0, 3, 4], 6, 3, 3),
    "ordered_list": lambda m, q: m.ordered_list_search(
        q, [1, 2, 4, 5, 9, 11, 12, 14], 9, 3, 4),
    "pearson_hash": lambda m, q: m.pearson_hash_demo(
        q, [int(v) for v in np.random.default_rng(2).permutation(64)], 6),
    "perceptron": lambda m, q: m.quantum_perceptron(q, 0, 1),
    "associative_memory": lambda m, q: m.quantum_associative_memory(
        q, [(0, True), (1, False), (2, False), (3, True)], 2, 2),
}


@pytest.mark.parametrize("name", sorted(_EAGER))
@pytest.mark.parametrize("pterm,jterm,tol", _PAIRS)
def test_eager_programs_match_jax(name, pterm, jterm, tol):
    n, seed = 7, 5
    port, ref = _port(n, seed, pterm), _jax(n, seed, jterm)
    got = _EAGER[name](al, port)
    want = _EAGER[name](jal, ref)
    if isinstance(want, tuple):
        np.testing.assert_allclose(got, want, atol=tol)
    else:
        assert got == want
    np.testing.assert_allclose(port.GetQuantumState(),
                               np.asarray(ref.GetQuantumState()), atol=tol)


def test_grover_search_finds_its_target():
    q = _port(8, 2)
    assert al.grover_search(q, 171) == 171


def test_cosmology_inflation_matches_jax():
    got = al.cosmology_inflation(
        lambda n: qt.create_quantum_interface("cpu", n, rng=QrackRandom(3)),
        5, QrackRandom(4))
    want = jal.cosmology_inflation(
        lambda n: JaxCPU(n, rng=JaxRandom(3)), 5, JaxRandom(4))
    assert got == want == [1, 2, 3, 4, 5, 6]


def test_xeb_fidelity_matches_jax():
    probs = np.random.default_rng(1).dirichlet(np.ones(16))
    samples = [3, 7, 7, 1, 15]
    assert al.xeb_fidelity(probs, samples) == jal.xeb_fidelity(probs, samples)


# ---------------------------------------------------------------------------
# the fused programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,depth,seed,fuse_qb", [(7, 5, 3, None), (9, 4, 11, 4),
                                                  (6, 3, 2, 1)])
def test_make_rcs_fn_matches_jax(n, depth, seed, fuse_qb):
    x = basis_planes(n, 0, device="cpu")
    got = rcs.make_rcs_fn(n, depth, seed, fuse_qb)(x)
    want = jrcs.make_rcs_fn(n, depth, seed, fuse_qb)(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert rcs.rcs_layers(n, depth, seed) == jrcs.rcs_layers(n, depth, seed)
    assert rcs.resolve_fuse_qb(n, fuse_qb) == jrcs.resolve_fuse_qb(n, fuse_qb)


def test_random_circuit_sampling_matches_make_rcs_fn():
    """The gate-by-gate engine path (fuser windows) and the fused program
    draw the same plan from the same seed."""
    n, depth, seed = 8, 6, 7
    q = _port(n, 1)
    al.random_circuit_sampling(q, depth, QrackRandom(seed))
    fused = rcs.make_rcs_fn(n, depth, seed)(basis_planes(n, 0, device="cpu"))
    np.testing.assert_allclose(q.device_planes.numpy(), fused.numpy(),
                               atol=1e-6)
    ref = rcs.reference_rcs_state(n, depth, seed, _port(n, 1, "cpu"))
    np.testing.assert_allclose(ref, q.GetQuantumState(), atol=1e-6)


def test_rcs_qcircuit_digest_matches_jax():
    assert (rcs.rcs_qcircuit(6, 4, 9).structure_digest()
            == jrcs.rcs_qcircuit(6, 4, 9).structure_digest())


@pytest.mark.parametrize("n,target,iters", [(6, 45, None), (8, 200, None),
                                            (5, 3, 2)])
def test_make_grover_fn_matches_jax(n, target, iters):
    fn, it = grover.make_grover_fn(n, target, iters)
    jfn, jit_ = jgrover.make_grover_fn(n, target, iters)
    assert it == jit_ == (iters or grover.grover_iterations(n))
    x = basis_planes(n, 0, device="cpu")
    got, want = fn(x), jfn(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert abs(grover.success_probability(got, target)
               - jgrover.success_probability(want, target)) <= 1e-6
    if iters is None:
        assert grover.success_probability(got, target) >= 0.99


def test_make_grover_fn_matches_grover_search_body():
    n, target = 7, 100
    q = _port(n, 1)
    al.grover_amplify(q, target)
    fn, _ = grover.make_grover_fn(n, target)
    p = grover.success_probability(fn(basis_planes(n, 0, device="cpu")), target)
    assert abs(q.ProbAll(target) - p) <= 1e-5


# ---------------------------------------------------------------------------
# apps.py and the QCircuit builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pterm,jterm,tol", _PAIRS)
def test_tfim_series_matches_jax(pterm, jterm, tol):
    got = apps.tfim_magnetization_series(_port(5, 1, pterm), 1.0, 0.7, 0.1, 4)
    want = japps.tfim_magnetization_series(_jax(5, 1, jterm), 1.0, 0.7, 0.1, 4)
    np.testing.assert_allclose(got, want, atol=max(tol, 1e-6))
    for a, b in zip(apps.tfim_hamiltonian(4, 1.0, 0.5),
                    japps.tfim_hamiltonian(4, 1.0, 0.5)):
        assert (a.target, tuple(a.controls), a.uniform) == \
            (b.target, tuple(b.controls), b.uniform)
        np.testing.assert_array_equal(a.matrix, b.matrix)


@pytest.mark.parametrize("pterm,jterm,tol", _PAIRS)
def test_qaoa_matches_jax(pterm, jterm, tol):
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]
    got = apps.qaoa_maxcut_grid(lambda n: _port(n, 1, pterm), edges, 4, p=1,
                                resolution=3)
    want = japps.qaoa_maxcut_grid(lambda n: _jax(n, 1, jterm), edges, 4, p=1,
                                  resolution=3)
    assert abs(got[0] - want[0]) <= max(tol, 1e-6)
    assert got[1] == want[1]
    assert apps.brute_force_maxcut(edges, 4) == japps.brute_force_maxcut(edges, 4)


def test_qrng_bits_match_jax():
    got = apps.qrng_bits(lambda n: _port(n, 6, "cpu"), 20, 5)
    want = japps.qrng_bits(lambda n: _jax(n, 6, "cpu"), 20, 5)
    assert got == want


@pytest.mark.parametrize("name,args", [
    ("ghz_qcircuit", (9,)),
    ("qaoa_qcircuit", (6,)),
    ("quantum_volume_qcircuit", (6, 3)),
    ("brickwork_qcircuit", (8, 3)),
    ("trotter_qcircuit", (5, 2)),
])
def test_qcircuit_builders_digest_matches_jax(name, args):
    if name in ("qaoa_qcircuit", "quantum_volume_qcircuit"):
        got = getattr(al, name)(*args, rng=QrackRandom(4))
        want = getattr(jal, name)(*args, rng=JaxRandom(4))
    else:
        got, want = getattr(al, name)(*args), getattr(jal, name)(*args)
    assert got.structure_digest() == want.structure_digest()
    assert got.GetGateCount() == want.GetGateCount() > 0
    assert got.qubit_count == want.qubit_count


def test_brickwork_marginals_are_analytic():
    n = 6
    q = _port(n, 1)
    al.brickwork_qcircuit(n).Run(q)
    for i in range(n):
        assert abs(q.Prob(i) - math.sin(al.brickwork_theta(i) / 2) ** 2) <= 1e-6
    assert torch.isfinite(q.device_planes).all()
