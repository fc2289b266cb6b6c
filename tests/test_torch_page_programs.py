"""The port's whole-circuit programs over pages (models/qft.py
make_sharded_qft_fn, models/rcs.py make_sharded_rcs_fn, models/grover.py
make_sharded_grover_fn, layers/qcircuit.py QCircuit.compile_sharded_fn)
against the JAX package's shard_map programs on the 8 virtual CPU
devices that tests/conftest.py pins: the counterparts of
tests/test_qft_program.py:76-213.

Both sides start from the same seeded numpy ket; the port's pages lie on
the CPU (a device list that repeats "cpu").  Bar: float32 amplitudes
within 3e-5 (the counterparts' own bars are 2e-6 to 5e-5); a few cases
set ops/sharded.CHUNK small, so that every in-place pass runs in several
blocks.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu.layers.qcircuit import QCircuit as JaxCircuit
from qrack_tpu.models import grover as jgrm
from qrack_tpu.models import qft as jqftm
from qrack_tpu.models import rcs as jrcsm
from qrack_tpu.ops import gatekernels as jgk
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

from qrack_tpu_torch import matrices as mat
from qrack_tpu_torch.layers.qcircuit import QCircuit
from qrack_tpu_torch.models import grover as grm
from qrack_tpu_torch.models import qft as qftm
from qrack_tpu_torch.models import rcs as rcsm
from qrack_tpu_torch.ops import sharded as shb

from helpers import rand_state

ATOL = 3e-5


def mesh(npg):
    return Mesh(np.array(jax.devices("cpu")[:npg]), ("pages",))


def to_pages(psi, npg):
    """A complex ket as `npg` float32 CPU pages."""
    st = np.asarray(psi).reshape(npg, -1)
    return [torch.from_numpy(np.stack([p.real, p.imag]).astype(np.float32))
            for p in st]


def from_pages(pages):
    a = torch.cat([p for p in pages], dim=1).to(torch.float64).numpy()
    return a[0] + 1j * a[1]


def jax_run(fn, sharding, psi):
    out = fn(jax.device_put(jgk.to_planes(psi), sharding))
    return jgk.from_planes(jax.device_get(out))


@pytest.fixture(params=["whole", "blocks"])
def blocks(request, monkeypatch):
    """Every page pass in one block, or in blocks of 4 amplitudes."""
    if request.param == "blocks":
        monkeypatch.setattr(shb, "CHUNK", 4)
    return request.param


@pytest.mark.parametrize("npg", (2, 8))
@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("fast", (False, True))
def test_sharded_qft_matches_jax(npg, inverse, fast, blocks):
    n = 8
    psi = rand_state(n, 17)
    fn, sharding = jqftm.make_sharded_qft_fn(mesh(npg), n, inverse=inverse,
                                             fast=fast)
    ref = jax_run(fn, sharding, psi)
    pfn, devs = qftm.make_sharded_qft_fn(["cpu"] * npg, n, inverse=inverse,
                                         fast=fast)
    assert len(devs) == npg
    pages = to_pages(psi, npg)
    out = pfn(pages)
    assert out is pages
    np.testing.assert_allclose(from_pages(out), ref, atol=ATOL)


def test_sharded_qft_matches_oracle_and_round_trips():
    n = 7
    psi = rand_state(n, 3)
    o = JaxCPU(n, rng=JaxRandom(1), rand_global_phase=False)
    o.SetQuantumState(psi)
    o.QFT(0, n)
    fn, _ = qftm.make_sharded_qft_fn(["cpu"] * 4, n)
    out = fn(to_pages(psi, 4))
    np.testing.assert_allclose(from_pages(out), o.GetQuantumState(),
                               atol=ATOL)
    ifn, _ = qftm.make_sharded_qft_fn(["cpu"] * 4, n, inverse=True)
    np.testing.assert_allclose(from_pages(ifn(out)), psi, atol=5e-5)


def test_basis_pages_and_page_devices():
    pages = qftm.basis_pages(6, 45, ["cpu"] * 4)
    assert [tuple(p.shape) for p in pages] == [(2, 16)] * 4
    ket = from_pages(pages)
    assert ket[45] == 1 and np.count_nonzero(ket) == 1
    with pytest.raises(ValueError, match="power of two"):
        shb.page_devices(["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            qftm.make_sharded_qft_fn(4, 6)   # a page count means cuda


@pytest.mark.parametrize("npg,depth,seed", ((8, 5, 13), (4, 4, 7), (2, 6, 3)))
def test_sharded_rcs_matches_jax(npg, depth, seed, blocks):
    """Local-pair swaps, the straddling coupler, page-pair relabels and
    paged roots against the JAX shard_map program (n = 8: both brick
    offsets reach the straddle at 8 pages)."""
    n = 8
    fn, sharding = jrcsm.make_sharded_rcs_fn(mesh(npg), n, depth, seed=seed)
    ref = jax_run(fn, sharding, np.eye(1, 1 << n, 0).ravel())
    pfn, _ = rcsm.make_sharded_rcs_fn(["cpu"] * npg, n, depth, seed=seed)
    out = from_pages(pfn(qftm.basis_pages(n, 0, ["cpu"] * npg)))
    np.testing.assert_allclose(out, ref, atol=ATOL)
    # and the single-chip program of the port
    single = rcsm.make_rcs_fn(n, depth, seed)(
        qftm.basis_planes(n, 0, device="cpu")).to(torch.float64).numpy()
    np.testing.assert_allclose(out, single[0] + 1j * single[1], atol=ATOL)


@pytest.mark.parametrize("npg,target,iters", ((8, 137, None), (4, 200, 3)))
def test_sharded_grover_matches_jax(npg, target, iters, blocks):
    n = 8
    sfn, sharding, siters = jgrm.make_sharded_grover_fn(mesh(npg), n, target,
                                                        iters=iters)
    ref = jax_run(sfn, sharding, np.eye(1, 1 << n, 0).ravel())
    pfn, _, piters = grm.make_sharded_grover_fn(["cpu"] * npg, n, target,
                                                iters=iters)
    assert piters == siters
    out = from_pages(pfn(qftm.basis_pages(n, 0, ["cpu"] * npg)))
    np.testing.assert_allclose(out, ref, atol=ATOL)
    if iters is None:
        assert abs(out[target]) ** 2 > 0.99


def _random_circuit(cls, n, seed):
    rng = JaxRandom(seed)
    c = cls(n)
    for _ in range(30):
        t = rng.randint(0, n)
        k = rng.randint(0, 4)
        if k == 0:
            c.append_1q(t, mat.H2)
        elif k == 1:
            c.append_1q(t, mat.u3_mtrx(rng.rand(), rng.rand(), rng.rand()))
        elif k == 2:
            ctl = rng.randint(0, n)
            if ctl != t:
                c.append_ctrl((ctl,), t, mat.X2, 1)
        else:
            ctl = rng.randint(0, n)
            if ctl != t:
                c.append_ctrl((ctl,), t, mat.phase_mtrx(1, np.exp(0.4j)), 1)
    return c


@pytest.mark.parametrize("npg", (2, 8))
def test_compiled_sharded_circuit_matches_jax(npg, blocks):
    n = 7
    psi = rand_state(n, 5)
    jc = _random_circuit(JaxCircuit, n, 9)
    pc = _random_circuit(QCircuit, n, 9)
    assert len(jc.gates) == len(pc.gates)
    fn, sharding = jc.compile_sharded_fn(mesh(npg), n)
    ref = jax_run(fn, sharding, psi)
    pfn, _ = pc.compile_sharded_fn(["cpu"] * npg, n)
    np.testing.assert_allclose(from_pages(pfn(to_pages(psi, npg))), ref,
                               atol=ATOL)
    o = JaxCPU(n, rng=JaxRandom(1), rand_global_phase=False)
    o.SetQuantumState(psi)
    jc.Run(o)
    np.testing.assert_allclose(ref, o.GetQuantumState(), atol=ATOL)


def test_compiled_sharded_qft_circuit_matches_dense_qft():
    n = 8
    psi = rand_state(n, 21)
    pfn, _ = qftm.qft_qcircuit(n).compile_sharded_fn(["cpu"] * 4, n)
    out = from_pages(pfn(to_pages(psi, 4)))
    dense = qftm.make_qft_fn(n)(torch.from_numpy(
        np.stack([psi.real, psi.imag]).astype(np.float32)))
    d = dense.to(torch.float64).numpy()
    np.testing.assert_allclose(out, d[0] + 1j * d[1], atol=ATOL)
