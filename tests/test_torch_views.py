"""Every tensor view the port builds stays within torch's limit of 25
dimensions, which torch enforces on CUDA tensors only: the CPU runs a
26-dimensional permute without a word, so a plain CPU run of the gate
functions cannot show a view past the limit.  These tests record the
largest dimension count of every tensor that the gate functions, the
window kernel's plain version and the RCS ISwap layer produce, on meta
tensors (shapes only, no memory) at widths up to 30 qubits and with up
to 14 scattered controls; uc_2x2 past 10 controls is the case that once
passed it (it takes a gather there).  On the card (marker ``cuda``), a
12-control UniformlyControlledRY at 27 qubits against the same payloads
applied one controlled gate at a time.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import qrack_tpu_torch as qt
from qrack_tpu_torch.layers.qcircuit import QCircuit, QCircuitGate
from qrack_tpu_torch.models import rcs
from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import gatekernels as gk
from qrack_tpu_torch.ops import window_kernel as wk

META = torch.device("meta")


class MaxDims(TorchFunctionMode):
    """The largest ndim of any tensor a torch call returns inside."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.dim())
        return out


def dims_of(fn, *args) -> int:
    with MaxDims() as rec:
        fn(*args)
    return rec.most


def meta_planes(n, dtype=torch.float32):
    return torch.empty((2, 1 << n), dtype=dtype, device=META)


def scattered(n, k):
    """k control bits and a target with a free bit between each two and
    free bits at both ends: the most runs a view of them can have."""
    bits = [2 * i + 1 for i in range(k + 1)]
    assert bits[-1] < n - 1
    return tuple(bits[:-1]), bits[-1]


@pytest.mark.parametrize("k", [0, 1, 5, 10, 11, 12, 13])
def test_uc_2x2_views_stay_within_the_limit(k):
    n = 30
    controls, target = scattered(n, k)
    mps = np.zeros((2, 1 << k, 2, 2))
    most = dims_of(gk.uc_2x2, meta_planes(n), mps, n, target, controls)
    assert most <= gk.MAX_DIMS
    # the view a single permute would need: past the limit from 11 on
    shape, _axis_of, _rest = gk._bit_view(n, list(controls) + [target])
    assert (len(shape) > gk.MAX_DIMS) == (k >= 11)


def test_uc_2x2_gather_path_matches_the_view_path():
    """Past the limit uc_2x2 reaches key order through a gather: the same
    function, checked on the CPU by forcing the gather at a small width."""
    rng = np.random.default_rng(3)
    n, controls, target = 10, (8, 1, 5, 3), 6
    x = torch.tensor(rng.normal(size=(2, 1 << n)))
    mps = rng.normal(size=(2, 1 << len(controls), 2, 2))
    want = gk.uc_2x2(x, mps, n, target, controls)
    limit = gk.MAX_DIMS
    try:
        gk.MAX_DIMS = 3
        got = gk.uc_2x2(x, mps, n, target, controls)
    finally:
        gk.MAX_DIMS = limit
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["gather", "view"])
@pytest.mark.parametrize("k", [11, 12])
def test_uniformly_controlled_matches_jax(k, route, monkeypatch):
    """UniformlyControlledRY and UniformlyControlledSingleBit with 11 and
    12 controls in a seeded random order (key bit j is controls[j])
    against the JAX package's QEngineCPU on the same seeded ket and
    payloads.  The gather path is forced at this small width by lowering
    MAX_DIMS; the view path runs as it comes.  Bar: 1e-6 on every
    amplitude (float32 planes)."""
    from qrack_tpu import QEngineCPU as JaxCPU

    if route == "gather":
        monkeypatch.setattr(gk, "MAX_DIMS", 3)
    n = k + 3
    rng = np.random.default_rng(40 + k)
    order = rng.permutation(n)
    controls, target = tuple(int(b) for b in order[:k]), int(order[k])
    ket = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    ket /= np.linalg.norm(ket)
    angles = rng.uniform(0, 2 * np.pi, 1 << k)
    z = rng.normal(size=(1 << k, 2, 2)) + 1j * rng.normal(size=(1 << k, 2, 2))
    mtrxs = [np.linalg.qr(m)[0] for m in z]
    port = qt.create_quantum_interface("cuda", n, device="cpu",
                                       rand_global_phase=False)
    ref = JaxCPU(n, rand_global_phase=False)
    for e in (port, ref):
        e.SetQuantumState(ket)
        e.UniformlyControlledRY(controls, target, angles)
        e.UniformlyControlledSingleBit(controls, target, mtrxs)
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               rtol=0, atol=1e-6)


def test_structure_and_gate_views_stay_within_the_limit():
    n = 30
    p = meta_planes(n)
    mp2 = np.zeros((2, 2, 2))
    mp4 = np.zeros((2, 4, 4))
    calls = [
        (gk.apply_2x2, p, mp2, n, 17, 0b1010, 0b10),
        (gk.apply_invert, p, 0.0, 1.0, 1.0, 0.0, n, 3),
        (gk.apply_4x4, p, mp4, n, 29, 0),
        (gk.apply_kxk, p, np.zeros((2, 8, 8)), n, 11, 3),
        (gk.swap_bits, p, n, 2, 27),
        (gk.allocate, meta_planes(26), 26, 13, 4),
        (gk.compose, meta_planes(20), meta_planes(10), 20, 10, 7),
        (gk.split_matrix, p, n, 9, 12),
        (rcs._iswap_layer, p, [(2 * i, 2 * i + 1) for i in range(15)]),
    ]
    for fn, *args in calls:
        assert dims_of(fn, *args) <= gk.MAX_DIMS, fn.__name__


def test_window_kernel_plain_views_stay_within_the_limit():
    n, bp = 30, 12
    rng = np.random.default_rng(5)
    ops = []
    for t in (bp + 5, 3, 25, 0, 11, 29):
        z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        m = np.linalg.qr(z)[0]
        ops.append(fu.FusedOp(fu.classify(m, 0b1001 << 4, 1 << 4), t,
                              0b1001 << 4, 1 << 4, m))
    structure = fu.structure_of(ops)
    fv, iv = wk.pack_operands(structure, fu.dense_operands(ops), device="cpu")
    fv, iv = fv.to(META), iv.to(META)
    table = wk.op_table(structure, device="cpu")
    for dt in (torch.float32, torch.bfloat16):
        most = dims_of(wk.apply_window, meta_planes(n, dt), n, structure,
                       fv.to(dt), iv, table, bp, True)
        assert most <= gk.MAX_DIMS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch checks the limit there only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_uc_ry_with_12_scattered_controls(cuda_device):
    n = 27
    controls, target = scattered(n, 12)
    rng = np.random.default_rng(12)
    angles = rng.uniform(0, 2 * np.pi, 1 << 12)
    engines = []
    for _ in range(2):
        q = qt.create_quantum_interface("cuda", n, rand_global_phase=False)
        for b in range(0, n, 2):
            q.H(b)
        q.H(target)
        engines.append(q)
    engines[0].UniformlyControlledRY(controls, target, angles)
    ms = []
    for a in angles:
        c, s = np.cos(a / 2), np.sin(a / 2)
        ms.append(np.array([[c, -s], [s, c]], dtype=np.complex128))
    # the same payloads as single controlled gates (one circuit gate,
    # one pair sweep each through the window kernel)
    circ = QCircuit(n)
    circ.gates = [QCircuitGate(target, dict(enumerate(ms)), controls)]
    circ.RunFused(engines[1])
    a, b = (e.device_planes.double() for e in engines)
    inner = (a[0] * b[0] + a[1] * b[1]).sum() ** 2 + (
        a[0] * b[1] - a[1] * b[0]).sum() ** 2
    assert float(inner) >= 1 - 1e-5
