"""The port's QPager (qrack_tpu_torch/parallel/pager.py, pages on the
CPU) against the JAX package's QPager on the 8 virtual CPU devices that
tests/conftest.py pins: the counterparts of tests/test_pager.py, and
the pager's structure, host I/O, QHybrid's pager mode, RunFused, the
carry across from a running JAX pager, and the per-page window kernel.

Both engines get the same seeded streams, ``rand_global_phase=False``
and the same rng seeds.  Bars: float32 amplitudes within 1e-5 (3e-5
after a few dozen gates, as tests/test_pager.py), Prob within 1e-6,
seeded draws equal.  Widths stay at or under 12 qubits.
"""


import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu.ops import fusion as jfu
from qrack_tpu.parallel.pager import QPager as JaxPager
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch import convert
from qrack_tpu_torch.engines.cpu import QEngineCPU
from qrack_tpu_torch.engines.cuda import QEngineCUDA
from qrack_tpu_torch.engines.hybrid import QHybrid
from qrack_tpu_torch.layers.qcircuit import QCircuit
from qrack_tpu_torch.models.qft import qft_qcircuit
from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.parallel import pager as pg
from qrack_tpu_torch.parallel.pager import QPager
from qrack_tpu_torch.utils.rng import QrackRandom

from helpers import rand_state
from test_engine_matrix import random_circuit

ATOL = 3e-5


def make_pair(n, seed=3, n_pages=8, **kw):
    ref = JaxPager(n, rng=JaxRandom(seed), rand_global_phase=False,
                   n_pages=n_pages)
    port = QPager(n, rng=QrackRandom(seed), rand_global_phase=False,
                  n_pages=n_pages, device="cpu", **kw)
    return ref, port


def assert_match(ref, port, atol=ATOL):
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=atol)


@pytest.fixture(params=["chain", "kernel"])
def lowering(request, monkeypatch):
    """The port's windows through the window chain, or through the
    per-page window kernel (its plain version on the CPU)."""
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL",
                       "off" if request.param == "chain" else "on")
    # the JAX pager keeps its XLA window chain (its kernel would run
    # under the Pallas interpreter, seconds a window)
    monkeypatch.setattr(jfu, "kernel_mode", lambda: "auto")
    return request.param


def test_local_and_global_gates(lowering):
    n = 6  # 3 local bits, 3 page bits on 8 pages
    ref, port = make_pair(n)
    for eng in (ref, port):
        eng.H(0)        # local
        eng.H(4)        # paged
        eng.CNOT(0, 5)  # local control, paged target
        eng.CNOT(5, 1)  # paged control, local target
        eng.CZ(3, 4)    # paged-paged diagonal
        eng.T(5)        # paged diagonal
    assert_match(ref, port)


@pytest.mark.parametrize("seed", (1, 2))
def test_random_circuits_match(seed, lowering):
    n = 7
    ref, port = make_pair(n, seed)
    random_circuit(ref, JaxRandom(200 + seed), 50, n)
    random_circuit(port, JaxRandom(200 + seed), 50, n)
    assert_match(ref, port)
    assert port._qmap == ref._qmap


def test_qft_across_pages(lowering):
    n = 8
    ref, port = make_pair(n)
    for eng in (ref, port):
        eng.SetPermutation(0b10110101)
        eng.QFT(0, n)
    assert_match(ref, port)
    for eng in (ref, port):
        eng.IQFT(0, n)
    assert_match(ref, port)
    assert abs(port.GetAmplitude(0b10110101)) == pytest.approx(1.0, abs=1e-4)


def test_meta_swap_and_mixed_swap():
    n = 7
    ref, port = make_pair(n, seed=9)
    psi = rand_state(n, 77)
    for eng in (ref, port):
        eng.SetQuantumState(psi)
        eng.Swap(4, 6)  # page-page: a relabeling of the page list
        eng.Swap(0, 2)  # local-local
        eng.Swap(1, 5)  # mixed
    assert_match(ref, port, 1e-6)


def test_measurement_and_prob():
    n = 6
    ref, port = make_pair(n, seed=11)
    for eng in (ref, port):
        eng.H(0)
        eng.CNOT(0, 5)  # entangle across the page boundary
    assert port.Prob(5) == pytest.approx(ref.Prob(5), abs=1e-6)
    assert port.ProbMask(0b100001, 0b100001) == pytest.approx(
        ref.ProbMask(0b100001, 0b100001), abs=1e-6)
    for eng in (ref, port):
        eng.rng.seed(5)
    assert port.M(5) == ref.M(5)
    assert_match(ref, port)


@pytest.mark.parametrize("blocks", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_mall_draws_equal(seed, blocks, monkeypatch):
    """MAll's two-stage draw (page marginals, then the page) takes the
    same outcome from the same seed, under an identity table and after
    the planner moved qubits; also when the in-page draw walks a page in
    several blocks, as it does on the card."""
    from qrack_tpu_torch.ops import sharded as shb

    if blocks:
        monkeypatch.setattr(shb, "CHUNK", 8)
    n = 8
    ref, port = make_pair(n, seed=seed, n_pages=4)
    psi = rand_state(n, 400 + seed)
    for eng in (ref, port):
        eng.SetQuantumState(psi)
        if seed % 2:
            eng.H(7)
            eng.H(6)
            eng.RY(0.4, 1)
        eng.rng.seed(seed)
    assert port._qmap == ref._qmap
    got, want = port.MAll(), ref.MAll()
    assert got == want
    assert_match(ref, port, 1e-6)


def test_alu_and_diag_through_pager():
    n = 7
    ref, port = make_pair(n, seed=15)
    for eng in (ref, port):
        eng.HReg(0, 4)
        eng.INC(11, 0, 6)          # register crosses the page boundary
        eng.PhaseFlipIfLess(9, 0, 4)
        eng.UniformParityRZ(0b1010001, 0.4)
        eng.ROL(2, 0, 6)
        eng.CNOT(6, 0)
        eng.MUL(3, 0, 4, 2)
        eng.CMUL(3, 0, 4, 2, (6,))
    assert_match(ref, port)


def test_expectation_clone_and_sum_sqr_diff():
    n = 6
    ref, port = make_pair(n, seed=17)
    random_circuit(ref, JaxRandom(31), 30, n)
    random_circuit(port, JaxRandom(31), 30, n)
    assert port.ExpectationBitsAll(list(range(n))) == pytest.approx(
        ref.ExpectationBitsAll(list(range(n))), abs=1e-4)
    c = port.Clone()
    assert c._qmap == port._qmap
    assert port.ApproxCompare(c, 1e-6)
    o = QEngineCPU(n, rng=QrackRandom(1), rand_global_phase=False)
    o.SetQuantumState(ref.GetQuantumState())
    assert port.SumSqrDiff(o) < 1e-6
    assert port.SumSqrDiff(c) < 1e-6
    c.H(0)
    assert port.SumSqrDiff(c) == pytest.approx(ref.SumSqrDiff(
        _jax_after_h0(ref)), abs=1e-5)


def _jax_after_h0(ref):
    c = ref.Clone()
    c.H(0)
    return c


def test_amplitude_pages_and_amplitudes():
    n = 7
    ref, port = make_pair(n, seed=19, n_pages=4)
    for eng in (ref, port):
        eng.H(6)
        eng.H(5)
        eng.CNOT(6, 2)
        eng.RY(0.7, 1)
    blk = rand_state(5, 3) * 0.1
    for eng in (ref, port):
        eng.SetAmplitudePage(blk, 40)     # crosses a page boundary
        eng.SetAmplitude(3, 0.25 - 0.5j)
    np.testing.assert_allclose(port.GetAmplitudePage(24, 60),
                               ref.GetAmplitudePage(24, 60), atol=1e-6)
    for k in (3, 40, 71, 127):
        assert port.GetAmplitude(k) == pytest.approx(ref.GetAmplitude(k),
                                                     abs=1e-6)
    assert not port.IsZeroAmplitude()
    port.ZeroAmplitudes()
    assert port.IsZeroAmplitude()


def test_lossy_save_and_load(tmp_path):
    n = 8
    ref, port = make_pair(n, seed=21, n_pages=4)
    random_circuit(ref, JaxRandom(41), 30, n)
    random_circuit(port, JaxRandom(41), 30, n)
    for eng, name in ((ref, "ref"), (port, "port")):
        eng.LossySaveStateVector(str(tmp_path / name), bits=8, block_pow=4)
    back = QPager(n, n_pages=2, device="cpu", rng=QrackRandom(1),
                  rand_global_phase=False)
    back.LossyLoadStateVector(str(tmp_path / "port"))
    jback = JaxPager(n, n_pages=2, rng=JaxRandom(1), rand_global_phase=False)
    jback.LossyLoadStateVector(str(tmp_path / "ref"))
    np.testing.assert_allclose(back.GetQuantumState(),
                               jback.GetQuantumState(), atol=1e-5)
    # the port reads the JAX package's per-page archive, and back
    cross = QPager(n, n_pages=8, device="cpu", rng=QrackRandom(1),
                   rand_global_phase=False)
    cross.LossyLoadStateVector(str(tmp_path / "ref"))
    np.testing.assert_allclose(cross.GetQuantumState(),
                               jback.GetQuantumState(), atol=1e-5)


def test_fewer_pages_than_devices():
    ref = JaxPager(5, rng=JaxRandom(1), rand_global_phase=False, n_pages=4)
    port = QPager(5, rng=QrackRandom(1), rand_global_phase=False,
                  devices=["cpu"] * 8, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        eng.CNOT(0, 4)
        eng.T(4)
    assert_match(ref, port)
    assert port.n_pages == 4 and len(port.devices) == 4


def test_compose_decompose_through_pager():
    ref, port = make_pair(4, seed=19, n_pages=4)
    for eng in (ref, port):
        eng.H(0)
        eng.CNOT(0, 1)
    other_r = JaxCPU(2, rng=JaxRandom(7), rand_global_phase=False)
    other_p = QEngineCPU(2, rng=QrackRandom(7), rand_global_phase=False)
    for other in (other_r, other_p):
        other.X(0)
    ref.Compose(other_r)
    port.Compose(other_p)
    assert port.GetQubitCount() == 6
    assert_match(ref, port)


@pytest.mark.parametrize("start", [0, 3, 6, 8])
def test_compose_pager_onto_pager(start):
    """Compose of two pagers runs the ring on the pages (no host
    staging), at every insertion point, above and below the page bits."""
    ref, port = make_pair(8, seed=23, n_pages=4)
    rr, rp = make_pair(3, seed=24, n_pages=4)
    random_circuit(ref, JaxRandom(51), 20, 8)
    random_circuit(port, JaxRandom(51), 20, 8)
    for eng in (rr, rp):
        eng.H(0)
        eng.CNOT(0, 2)
        eng.T(2)
    port.GetQuantumState = lambda: pytest.fail("host staging")
    ref.Compose(rr, start)
    port.Compose(rp, start)
    del port.__dict__["GetQuantumState"]
    assert port.GetQubitCount() == 11
    assert_match(ref, port)


def test_structural_ops_stay_on_device():
    n = 7
    ref, port = make_pair(n, seed=9, n_pages=4)
    for eng in (ref, port):
        random_circuit(eng, JaxRandom(321), 25, n)

    def boom():
        raise AssertionError("full-ket host staging in structural op")

    port.GetQuantumState = boom
    port._host_split = lambda *a: boom()
    o2 = JaxCPU(2, rng=JaxRandom(5), rand_global_phase=False)
    p2 = QEngineCPU(2, rng=QrackRandom(5), rand_global_phase=False)
    for eng in (o2, p2):
        eng.H(0)
        eng.T(0)
        eng.CNOT(0, 1)
    ref.Compose(o2)
    port.Compose(p2)
    for eng in (ref, port):
        eng.Allocate(3, 1)
        eng.Allocate(8, 2)        # among the page bits
        eng.CNOT(9, 3)
        eng.CNOT(9, 3)
    for eng in (ref, port):
        eng.Dispose(8, 2, 0)
        eng.Dispose(3, 1, 0)
    del port.__dict__["GetQuantumState"]
    del port.__dict__["_host_split"]
    assert_match(ref, port)


@pytest.mark.parametrize("start", [3, 5])
def test_decompose_separable_span(start):
    """A span inside the page and one that reaches the page bits: the
    remainder and the span's state match the JAX pager's."""
    n = 8
    ref, port = make_pair(n, seed=11, n_pages=4)
    for eng in (ref, port):
        eng.H(0); eng.CNOT(0, 1); eng.T(1); eng.CNOT(1, 2)
        eng.H(start); eng.CNOT(start, start + 1); eng.S(start + 1)
        eng.RY(0.3, 7 if start == 3 else 3)
    rd = JaxCPU(2, rng=JaxRandom(1), rand_global_phase=False)
    pd = QEngineCPU(2, rng=QrackRandom(1), rand_global_phase=False)
    port.GetQuantumState = (lambda: (_ for _ in ()).throw(
        AssertionError("host staging")))
    ref.Decompose(start, rd)
    port.Decompose(start, pd)
    del port.__dict__["GetQuantumState"]
    assert_match(ref, port)
    np.testing.assert_allclose(pd.GetQuantumState(), rd.GetQuantumState(),
                               atol=ATOL)


def test_pager_dispose_below_page_count():
    ref, port = make_pair(8, seed=3, n_pages=8)
    for eng in (ref, port):
        eng.H(0)
        eng.Dispose(2, 6)
    assert port.GetQubitCount() == 2 and port.n_pages <= 4
    assert port.Prob(0) == pytest.approx(0.5, abs=1e-5)
    assert_match(ref, port)


def test_pages_shrink_and_regrow():
    n = 5
    ref, port = make_pair(n, seed=13, n_pages=4)
    for eng in (ref, port):
        random_circuit(eng, JaxRandom(77), 15, n)
        eng.Dispose(1, 4)   # width 1 < page count: fewer pages
    assert port.g_bits < 2
    assert_match(ref, port)
    o2 = JaxCPU(5, rng=JaxRandom(2), rand_global_phase=False)
    p2 = QEngineCPU(5, rng=QrackRandom(2), rand_global_phase=False)
    for eng in (o2, p2):
        random_circuit(eng, JaxRandom(88), 10, 5)
    ref.Compose(o2)
    port.Compose(p2)
    assert port.g_bits == 2  # back to the construction page count
    assert_match(ref, port)


def test_runfused_lowers_onto_pager(lowering):
    """A circuit on a pager runs as ONE window (no per-gate dispatch),
    directly and through QHybrid's pager mode."""
    n = 7
    ref, port = make_pair(n, seed=21, n_pages=4)
    c = QCircuit(n)
    c.append_1q(0, np.array([[1, 1], [1, -1]]) / np.sqrt(2))
    c.append_ctrl((0,), n - 1, np.array([[0, 1], [1, 0]]), 1)
    c.append_ctrl((n - 1,), 2, np.array([[0, 1], [1, 0]]), 1)
    c.append_1q(n - 1, np.diag([1, np.exp(0.25j * np.pi)]))
    calls = []
    orig = QPager._k_apply_2x2
    QPager._k_apply_2x2 = lambda self, *a: calls.append(1) or orig(self, *a)
    try:
        c.RunFused(port)
    finally:
        QPager._k_apply_2x2 = orig
    assert not calls, "pager RunFused fell back to per-gate dispatch"
    for g in c.gates:
        for perm, m in g.payloads.items():
            ref.MCMtrxPerm(g.controls, m, g.target, perm)
    assert_match(ref, port)
    h = QHybrid(n, rng=QrackRandom(21), rand_global_phase=False,
                tpu_threshold_qubits=3, pager_threshold_qubits=5,
                devices=["cpu"] * 4)
    assert isinstance(h._engine, QPager)
    c.RunFused(h)
    np.testing.assert_allclose(h.GetQuantumState(), ref.GetQuantumState(),
                               atol=ATOL)


def test_runfused_qft_plans_over_the_whole_circuit():
    n = 10
    ref, port = make_pair(n, seed=5, n_pages=8)
    for eng in (ref, port):
        eng.SetPermutation(0b1011001110)
    from qrack_tpu.models.qft import qft_qcircuit as jax_qft

    jax_qft(n).RunFused(ref)
    qft_qcircuit(n).RunFused(port)
    assert port._qmap == ref._qmap
    assert_match(ref, port, 1e-5)


def test_circuit_run_primes_the_lookahead():
    """QCircuit.Run hands the planner the rest of the circuit (the same
    lookahead as the JAX package's Run), so the tables agree after it."""
    n = 9
    ref, port = make_pair(n, seed=7, n_pages=8)
    from qrack_tpu.models.qft import qft_qcircuit as jax_qft

    for eng in (ref, port):
        eng.SetPermutation(0b110010101)
    jax_qft(n, inverse=True).Run(ref)
    qft_qcircuit(n, inverse=True).Run(port)
    assert port._fuser.lookahead is None
    assert port._qmap == ref._qmap
    assert_match(ref, port, 1e-5)


def test_hybrid_switching_into_pager_mode():
    q = QHybrid(3, rng=QrackRandom(5), rand_global_phase=False,
                tpu_threshold_qubits=5, pager_threshold_qubits=6,
                devices=["cpu"] * 4, device="cpu")
    assert isinstance(q._engine, QEngineCPU)
    q.H(0)
    q.CNOT(0, 1)
    before = q.GetQuantumState()
    q.Allocate(3, 3)              # 6 qubits: the CUDA engine (on the CPU)
    assert isinstance(q._engine, QEngineCUDA)
    q.Allocate(6, 2)              # 8 qubits: past the threshold, the pager
    assert isinstance(q._engine, QPager) and q._engine.n_pages == 4
    np.testing.assert_allclose(q.GetQuantumState()[:8], before, atol=1e-6)
    q.CNOT(0, 7)
    assert q.Prob(7) == pytest.approx(0.5, abs=1e-5)
    q.CNOT(0, 7)
    q.Dispose(3, 5, 0)
    assert isinstance(q._engine, QEngineCPU) and q.qubit_count == 3
    np.testing.assert_allclose(q.GetQuantumState(), before, atol=1e-6)


def test_hybrid_compose_into_pager_mode():
    q = QHybrid(2, rng=QrackRandom(1), rand_global_phase=False,
                tpu_threshold_qubits=4, pager_threshold_qubits=7,
                devices=["cpu"] * 4)
    q.H(0)
    other = QEngineCPU(7, rng=QrackRandom(2), rand_global_phase=False)
    other.X(0)
    start = q.Compose(other)
    assert start == 2 and q.qubit_count == 9
    assert isinstance(q._engine, QPager)
    assert q.Prob(0) == pytest.approx(0.5, abs=1e-5)
    assert q.Prob(2) == pytest.approx(1.0, abs=1e-5)


def test_factory_pager_terminal_and_arranged_layers():
    q = qt.create_quantum_interface("pager", 6, devices=["cpu"] * 4,
                                    rng=QrackRandom(1),
                                    rand_global_phase=False)
    assert isinstance(q, QPager) and q.n_pages == 4
    a = qt.create_arranged_layers_full(sd=False, sh=False, hy=False,
                                       pg=True, oc=True, qubit_count=5,
                                       devices=["cpu"] * 2)
    assert isinstance(a, QPager) and a.n_pages == 2
    u = qt.create_quantum_interface(["unit", "pager"], 6, device="cpu",
                                    n_pages=2)
    u.H(0)
    for i in range(5):
        u.CNOT(i, i + 1)
    assert u.Prob(5) == pytest.approx(0.5, abs=1e-6)


def test_more_pages_than_devices_and_the_device_list(monkeypatch):
    with pytest.raises(ValueError):
        QPager(10, n_pages=16, devices=["cpu"] * 8)
    q = QPager(4, n_pages=4, devices=["cpu"] * 4, rng=QrackRandom(1))
    assert q.devices == [torch.device("cpu")] * 4   # a device may repeat
    qt.set_config(pager_devices="cpu,cpu")
    try:
        q = QPager(4, rng=QrackRandom(9), rand_global_phase=False)
        assert q.n_pages == 2
        qt.set_config(pager_devices="99")
        with pytest.raises(ValueError, match="unknown device ids"):
            QPager(4, rng=QrackRandom(9), n_pages=1)
    finally:
        qt.set_config(pager_devices="")


def test_carry_a_running_jax_pager_across():
    """convert.pager_from_numpy takes a JAX pager's physical planes and
    its placement table mid-circuit; both go on and stay together."""
    n = 9
    ref = JaxPager(n, rng=JaxRandom(4), rand_global_phase=False, n_pages=8)
    random_circuit(ref, JaxRandom(61), 30, n)
    for q in (8, 7, 6):
        ref.H(q)
    ref.RY(0.2, 0)
    ref.GetAmplitude(0)          # flush: the planner moved qubits
    assert ref._map_nonid()
    port = convert.pager_from_numpy(np.asarray(ref._state_raw), ref._qmap,
                                    device="cpu", n_pages=8,
                                    rng=QrackRandom(4),
                                    rand_global_phase=False)
    assert port._qmap == ref._qmap
    assert_match(ref, port, 1e-6)
    random_circuit(ref, JaxRandom(62), 30, n)
    random_circuit(port, JaxRandom(62), 30, n)
    assert_match(ref, port)
    assert port._qmap == ref._qmap


# ---------------------------------------------------------------------------
# the per-page window kernel against interpret-mode Pallas
# ---------------------------------------------------------------------------

def _window(rng, n, L, mod):
    """Ops over the vocabulary with page-bit controls, page-bit cphase
    and diag targets, in-page gens with page controls and paged gens."""
    specs = []
    for _ in range(10):
        kind = ("gen", "cphase", "diag", "inv")[int(rng.integers(0, 4))]
        t = int(rng.integers(0, n if kind in ("cphase", "diag") else L))
        if kind == "gen" and rng.integers(0, 4) == 0:
            t = int(rng.integers(L, n))
        others = [q for q in range(n) if q != t]
        cm = 0
        for c in rng.choice(others, int(rng.integers(0, 3)), replace=False):
            cm |= 1 << int(c)
        cv = cm if kind == "cphase" else cm & int(rng.integers(0, 1 << n))
        a, b = np.exp(1j * rng.uniform(0, 2 * np.pi, 2))
        if kind == "cphase":
            m = np.diag([1.0 + 0j, b])
        elif kind == "diag":
            m = np.diag([a, b])
        elif kind == "inv":
            m = np.array([[0, a], [b, 0]])
        else:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            m, _ = np.linalg.qr(z)
        specs.append((mod.classify(m, cm, cv), t, cm, cv, m))
    return specs


@pytest.mark.parametrize("seed,remap", [(0, ()), (1, ((2, 6), (0, 7))),
                                        (2, ((5, 8),))])
def test_per_page_kernel_body_against_interpret_pallas(seed, remap):
    n, G, bp = 9, 8, 3
    L = n - 3
    rng = np.random.default_rng(800 + seed)
    specs = _window(rng, n, L, fu)
    ops = [fu.FusedOp(*s) for s in specs]
    jops = [jfu.FusedOp(*s) for s in specs]
    structure = fu.sharded_structure_of(ops)
    assert structure == jfu.sharded_structure_of(jops)
    assert fu.sharded_kernel_sweeps(structure, L, bp) == \
        jfu.sharded_kernel_sweeps(structure, L, bp)
    psi = rand_state(n, 500 + seed)
    ref = JaxPager(n, rng=JaxRandom(1), rand_global_phase=False, n_pages=G)
    ref.SetQuantumState(psi)
    joper = jfu.sharded_operands(jops, L, ref.dtype)
    prog = ref._p_fuse_window(structure, len(joper),
                              kernel_plan={"interpret": True,
                                           "block_pow": bp},
                              remap=remap, batched=True)
    want = np.asarray(prog(ref._state, *joper))
    port = QPager(n, rng=QrackRandom(1), rand_global_phase=False,
                  n_pages=G, device="cpu")
    port.SetQuantumState(psi)
    body = fu.sharded_kernel_window_body(L, G, structure, block_pow=bp,
                                         remap=remap)
    assert body.sweeps == fu.sharded_kernel_sweeps(structure, L, bp)
    oper = fu.sharded_operands(ops, L, torch.float32, device="cpu")
    got = torch.cat(body(port._pages, *oper), dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the window chain computes the same function
    port.SetQuantumState(psi)
    chain = fu.sharded_window_body(L, G, structure, remap=remap)
    got2 = torch.cat(chain(port._pages, *oper), dim=1).numpy()
    np.testing.assert_allclose(got2, want, atol=1e-5)


def test_kernel_lowering_plans_like_the_jax_package(monkeypatch):
    rng = np.random.default_rng(77)
    for mode in ("auto", "on", "off"):
        monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", mode)
        for _ in range(10):
            n = 12
            L = int(rng.integers(6, 11))
            specs = _window(rng, n, L, fu)
            structure = fu.sharded_structure_of([fu.FusedOp(*s)
                                                 for s in specs])
            plan, why = fu.sharded_kernel_lowering(L, structure, "cuda")
            jplan, jwhy = jfu.sharded_kernel_lowering(L, structure, "tpu")
            assert why == jwhy
            if plan is not None:
                assert plan["sweeps"] == jfu.sharded_kernel_sweeps(
                    structure, L, min(12, L))
            # on the CPU the auto mode takes the window chain
            assert fu.sharded_kernel_lowering(L, structure, "cpu")[1] == (
                "cpu_backend" if mode == "auto" else why)


def test_kernel_windows_are_counted_and_predicted(monkeypatch):
    """The pager predicts its window-kernel launches from the plans
    (n_pages x in-page sweeps) — the count chip_smoke.py holds the
    launches on the card to."""
    monkeypatch.setenv("QRACK_TPU_FUSE_KERNEL", "on")
    pg.reset_flushes()
    q = QPager(8, n_pages=4, device="cpu", rng=QrackRandom(3),
               rand_global_phase=False)
    q.QFT(0, 8)
    q.Finish()
    q.GetAmplitude(0)
    assert pg.FLUSHES["kernel_windows"] > 0
    assert pg.FLUSHES["predicted_launches"] % 4 == 0
    assert pg.FLUSHES["predicted_launches"] >= 4 * pg.FLUSHES[
        "kernel_windows"]
