"""The port's host oracle (QEngineCPU) and width switch (QHybrid) against
the JAX package's, and the "cpu" and "hybrid" factory terminals.

Bars: 1e-12 absolute between the two complex128 oracles; 1e-6 where a
float32 CUDA-engine half (on the CPU here) takes part; equal
measurement outcomes from equal seeds.
"""

import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu.engines.hybrid import QHybrid as JaxHybrid
from qrack_tpu.engines.tpu import QEngineTPU
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.engines.cpu import QEngineCPU
from qrack_tpu_torch.engines.cuda import QEngineCUDA
from qrack_tpu_torch.engines.hybrid import QHybrid
from qrack_tpu_torch.utils.rng import QrackRandom


def _stream(seed, n, length):
    """Seeded gate calls: H, CNOT, RZ, CZ, U, MCMtrxPerm, ISwap."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(length):
        kind = int(rng.integers(7))
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        ang = [float(x) for x in rng.uniform(-np.pi, np.pi, 3)]
        if kind == 5:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            out.append(("MCMtrxPerm", ((b,), np.linalg.qr(z)[0], a,
                                       int(rng.integers(2)))))
        else:
            out.append([("H", (a,)), ("CNOT", (a, b)), ("RZ", (ang[0], a)),
                        ("CZ", (a, b)), ("U", (a, *ang)),
                        None, ("ISwap", (a, b))][kind])
    return out


def _run(engines, stream):
    for name, args in stream:
        for e in engines:
            getattr(e, name)(*args)


def _state(e):
    return np.asarray(e.GetQuantumState())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cpu_oracle_matches_jax_with_structure_ops(seed):
    n = 6
    port = qt.create_quantum_interface("cpu", n, rng=QrackRandom(seed),
                                       rand_global_phase=False)
    ref = JaxCPU(n, rng=JaxRandom(seed), rand_global_phase=False)
    assert isinstance(port, QEngineCPU) and port._state.dtype == np.complex128
    engines = (port, ref)
    _run(engines, _stream(seed, n, 40))
    np.testing.assert_allclose(_state(port), _state(ref), atol=1e-12)
    # Compose a prepared 2-qubit register in the middle
    extra = []
    for cls, rng_cls in ((QEngineCPU, QrackRandom), (JaxCPU, JaxRandom)):
        x = cls(2, rng=rng_cls(seed + 10), rand_global_phase=False)
        x.H(0)
        x.CNOT(0, 1)
        x.RY(0.3, 1)
        extra.append(x)
    assert port.Compose(extra[0], 2) == ref.Compose(extra[1], 2) == 2
    _run(engines, _stream(seed + 1, n + 2, 20))
    np.testing.assert_allclose(_state(port), _state(ref), atol=1e-12)
    # measurements draw from equal seeds
    assert [port.M(q) for q in (0, 5)] == [ref.M(q) for q in (0, 5)]
    # Allocate, then Dispose a separable register, then Decompose one
    assert port.Allocate(3, 2) == ref.Allocate(3, 2)
    _run(engines, [("H", (3,)), ("RZ", (0.7, 3)), ("X", (4,))])
    port.Dispose(3, 2, None)
    ref.Dispose(3, 2, None)
    for e in engines:
        e.X(0)
        e.CNOT(0, 5)
    np.testing.assert_allclose(_state(port), _state(ref), atol=1e-12)
    pd, rd = QEngineCPU(1, rand_global_phase=False), JaxCPU(1, rand_global_phase=False)
    port.Decompose(0, pd)
    ref.Decompose(0, rd)
    np.testing.assert_allclose(_state(pd), _state(rd), atol=1e-12)
    np.testing.assert_allclose(_state(port), _state(ref), atol=1e-12)
    assert port.qubit_count == ref.qubit_count == n + 1
    for q in range(port.qubit_count):
        assert abs(port.Prob(q) - ref.Prob(q)) <= 1e-12
    assert port.MAll() == ref.MAll()


def _hybrids(n, seed, threshold=4, pager=None):
    port = QHybrid(n, rng=QrackRandom(seed), tpu_threshold_qubits=threshold,
                   pager_threshold_qubits=pager, device="cpu",
                   rand_global_phase=False)
    ref = JaxHybrid(n, rng=JaxRandom(seed), tpu_threshold_qubits=threshold,
                    pager_threshold_qubits=pager, rand_global_phase=False)
    return port, ref


def _modes(port, ref):
    p = "cpu" if isinstance(port._engine, QEngineCPU) else (
        "cuda" if isinstance(port._engine, QEngineCUDA) else "?")
    r = "cpu" if isinstance(ref._engine, JaxCPU) else (
        "tpu" if isinstance(ref._engine, QEngineTPU) else "?")
    return p, r


def test_hybrid_crosses_the_threshold_both_ways_like_jax():
    """Threshold 5: Compose crosses up, Dispose down, Allocate up,
    Decompose down, Allocate up again; the composed and allocated
    registers stay separable from the rest until they leave."""
    seed = 4
    port, ref = _hybrids(3, seed, threshold=5)
    engines = (port, ref)
    assert _modes(port, ref) == ("cpu", "cpu")
    _run(engines, _stream(seed, 3, 12))
    regs = [QHybrid(2, rng=QrackRandom(9), device="cpu",
                    rand_global_phase=False),
            JaxHybrid(2, rng=JaxRandom(9), rand_global_phase=False)]
    for r in regs:
        r.H(1)
        r.CNOT(1, 0)
    assert port.Compose(regs[0]) == ref.Compose(regs[1]) == 3
    assert _modes(port, ref) == ("cuda", "tpu")
    assert port._engine.device.type == "cpu"
    _run(engines, _stream(seed + 1, 3, 10) + [("RY", (0.3, 3)),
                                              ("CZ", (3, 4))])
    np.testing.assert_allclose(_state(port), _state(ref), atol=1e-6)
    port.Dispose(3, 2, None)
    ref.Dispose(3, 2, None)
    assert port.qubit_count == ref.qubit_count == 3
    assert _modes(port, ref) == ("cpu", "cpu")
    np.testing.assert_allclose(_state(port), _state(ref), atol=1e-6)
    assert port.Allocate(3, 2) == ref.Allocate(3, 2) == 3
    assert _modes(port, ref) == ("cuda", "tpu")
    _run(engines, [("H", (3,)), ("CNOT", (3, 4)), ("RY", (0.4, 4)),
                   ("T", (1,))])
    pd = QHybrid(2, device="cpu", rand_global_phase=False)
    rd = JaxHybrid(2, rand_global_phase=False)
    port.Decompose(3, pd)
    ref.Decompose(3, rd)
    assert _modes(port, ref) == ("cpu", "cpu")
    np.testing.assert_allclose(_state(pd), _state(rd), atol=1e-6)
    np.testing.assert_allclose(_state(port), _state(ref), atol=1e-6)
    assert port.Allocate(0, 2) == ref.Allocate(0, 2) == 0
    assert _modes(port, ref) == ("cuda", "tpu")
    _run(engines, _stream(seed + 2, 5, 10))
    np.testing.assert_allclose(_state(port), _state(ref), atol=1e-6)
    # forwarding: the ALU and reads reach the engine; equal seeds, equal draws
    for e in engines:
        e.INC(3, 0, 3)
    np.testing.assert_allclose(_state(port), _state(ref), atol=1e-6)
    assert port.MAll() == ref.MAll()
    c = port.Clone()
    assert isinstance(c, QHybrid) and c.qubit_count == port.qubit_count
    np.testing.assert_allclose(_state(c), _state(port), atol=1e-7)


def test_hybrid_past_one_device_raises_naming_the_pager():
    """Past its pager threshold QHybrid holds the ket in QPager's pages,
    as the JAX package's does; where one page would pass 2^30 amplitudes
    (no device list to page over) the pager raises, naming itself."""
    from qrack_tpu_torch.parallel.pager import QPager

    port, ref = _hybrids(5, 1, threshold=4, pager=6)
    for q in (port, ref):
        q.H(0)
        q.CNOT(0, 4)
        q.Allocate(0, 1)
        q.Allocate(0, 1)
        q.CNOT(2, 6)
    assert isinstance(port._engine, QPager) and port.qubit_count == 7
    np.testing.assert_allclose(port.GetQuantumState(), ref.GetQuantumState(),
                               atol=1e-6)
    with pytest.raises(MemoryError, match="QPager page width"):
        QHybrid(31, tpu_threshold_qubits=4, pager_threshold_qubits=30,
                device="cpu")


def test_factory_cpu_and_hybrid_terminals(monkeypatch):
    q = qt.create_quantum_interface("cpu", 5, rng=QrackRandom(1),
                                    rand_global_phase=False)
    assert isinstance(q, QEngineCPU)
    with pytest.raises(ValueError, match="no device"):
        qt.create_quantum_interface("cpu", 5, device="cpu")
    h = qt.create_quantum_interface("hybrid", 5)
    assert isinstance(h, QHybrid) and isinstance(h._engine, QEngineCPU)
    assert qt.QEngineCPU is QEngineCPU and qt.QHybrid is QHybrid
    big = qt.create_quantum_interface("hybrid", 13, device="cpu")
    assert isinstance(big._engine, QEngineCUDA)
    assert big._engine.device.type == "cpu"
    # without a GPU: below the threshold the host engine needs none;
    # at or above it the CUDA half raises unless device="cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = qt.create_quantum_interface("hybrid", 12)
    assert isinstance(small._engine, QEngineCPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.create_quantum_interface("hybrid", 13)
    with pytest.raises(RuntimeError, match="CUDA"):
        small.Allocate(0, 1)
    assert isinstance(small._engine, QEngineCPU) and small.qubit_count == 12


def test_structure_ops_past_25_qubits():
    """Compose, Dispose, UCMtrx and the RCS ISwap layer at 25 qubits:
    one tensor axis per qubit would pass torch's limit of 25 dimensions
    (these raised before the views merged the untouched bits)."""
    from qrack_tpu_torch import matrices as mat
    from qrack_tpu_torch.models import rcs

    q = qt.create_quantum_interface("cuda", 24, device="cpu",
                                    rand_global_phase=False)
    q.X(0)
    q.H(3)
    one = qt.create_quantum_interface("cpu", 1, rand_global_phase=False)
    one.X(0)
    assert q.Compose(one, 2) == 2 and q.qubit_count == 25
    assert q.Prob(2) == pytest.approx(1.0, abs=1e-6)
    assert q.Prob(4) == pytest.approx(0.5, abs=1e-6)
    q.UCMtrx((0,), [mat.I2, mat.X2], 20)
    assert q.Prob(20) == pytest.approx(1.0, abs=1e-6)
    q.Dispose(2, 1, 1)
    assert q.qubit_count == 24
    assert q.Prob(3) == pytest.approx(0.5, abs=1e-6)
    assert q.Prob(19) == pytest.approx(1.0, abs=1e-6)
    planes = qt.create_quantum_interface(
        "cuda", 25, init_state=0b01, device="cpu",
        rand_global_phase=False).device_planes
    out = rcs._iswap_layer(planes, [(0, 1), (4, 5)])
    amp = out[:, 0b10]
    assert float(amp[0]) == pytest.approx(0.0) and float(amp[1]) == pytest.approx(1.0)
