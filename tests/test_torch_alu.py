"""The port's ALU (qrack_tpu_torch ops/alu_kernels.py and the QEngine
overrides) against the JAX package's on the same inputs.

* Every dense index-map function, numpy in the JAX package against torch
  int32 lanes in the port: index for index equal.
* Every ALU override on the port's QEngineCUDA (on the CPU) and
  QEngineCPU against the JAX package's QEngineTPU and QEngineCPU, from
  the same seeded random state.  Bars: 1e-6 absolute on float32
  planes, 1e-12 on complex128.
* The exact round trips that chip_smoke.py runs at w30, here at n = 12:
  the planes come back bit for bit.
* The TurboQuant engine runs an ALU permutation through its dense
  fallback as the JAX engine does: INC matches the JAX engine at n = 10
  with the same kernel tile, and past the dense cap both raise.
"""

import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu.ops import alu_kernels as jalu
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.ops import alu_kernels as alu
from qrack_tpu_torch.ops import gatekernels as gk
from qrack_tpu_torch.utils.rng import QrackRandom

from helpers import rand_state

N_IDX = 10
_PERM8 = [int(v) for v in np.random.default_rng(11).permutation(256)]
_PERM16 = [int(v) for v in np.random.default_rng(12).permutation(16)]
_TABLE16 = [int(v) for v in np.random.default_rng(13).integers(0, 64, 16)]


def _inverse(table):
    inv = np.empty(len(table), dtype=np.int64)
    inv[np.asarray(table)] = np.arange(len(table))
    return inv


# (label, function name, args after (xp, idx))
_SRC_CASES = [
    ("inc", "inc_src", (37, 2, 6)),
    ("cinc", "inc_src", (37, 2, 6, (8, 9), 2)),
    ("incdecc", "incdecc_src", (45, 1, 5, 9)),
    ("incs_zero", "incs_src", (0, 0, 6, 8)),
    ("incs_low", "incs_src", (5, 0, 6, 8)),
    ("incs_high", "incs_src", (40, 0, 6, 8)),
    ("incdecsc_carry", "incdecsc_src", (21, 1, 6, 9)),
    ("incdecsc_ovf", "incdecsc_src", (21, 1, 6, 9, 8)),
    ("incdecsc_ovf_high", "incdecsc_src", (50, 1, 6, 9, 8)),
    ("rol", "rol_src", (3, 1, 7)),
    ("rol_wide", "rol_src", (1, 0, 10)),
    ("incbcd", "incbcd_src", (37, 1, 8)),
    ("incdecbcdc", "incdecbcdc_src", (58, 0, 8, 9)),
]


@pytest.mark.parametrize("label,name,args", _SRC_CASES,
                         ids=[c[0] for c in _SRC_CASES])
def test_src_maps_match_jax(label, name, args):
    want = getattr(jalu, name)(np, np.arange(1 << N_IDX), *args)
    got = getattr(alu, name)(torch, torch.arange(1 << N_IDX, dtype=gk.IDX_DTYPE),
                             *args)
    assert got.dtype == gk.IDX_DTYPE
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_maps_match_jax():
    idx_np = np.arange(1 << N_IDX)
    idx_t = torch.arange(1 << N_IDX, dtype=gk.IDX_DTYPE)
    inv = _inverse(_PERM8)
    tab = np.asarray(_TABLE16)

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32))

    pairs = [
        (jalu.hash_src(np, idx_np, 1, 8, inv),
         alu.hash_src(torch, idx_t, 1, 8, t32(inv))),
        (jalu.indexed_lda_src(np, idx_np, 0, 4, 4, 6, tab),
         alu.indexed_lda_src(torch, idx_t, 0, 4, 4, 6, t32(tab))),
    ]
    for sign in (1, -1):
        pairs.append((
            jalu.indexed_adc_src(np, idx_np, 0, 4, 4, 5, 9, tab, sign=sign),
            alu.indexed_adc_src(torch, idx_t, 0, 4, 4, 5, 9, t32(tab),
                                sign=sign)))
    for want, got in pairs:
        assert got.dtype == gk.IDX_DTYPE
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gp,flag", [(100, None), (37, 9), (1000, None),
                                     (0, None), (1 << 33, 9)])
def test_phase_flip_factor_matches_jax(gp, flag):
    want = jalu.phase_flip_less_factor(np, np.arange(1 << N_IDX), gp, 2, 7, flag)
    got = alu.phase_flip_less_factor(
        torch, torch.arange(1 << N_IDX, dtype=gk.IDX_DTYPE), gp, 2, 7, flag)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,args", [
    ("mul_pair", (5, 0, 5, 5)),
    ("mul_pair", (6, 2, 6, 4)),
    ("mulmodnout_pair", (7, 13, 0, 5, 4, 4)),
    ("powmodnout_pair", (7, 15, 0, 6, 4, 4)),
])
def test_pair_maps_match_jax(name, args):
    jsrc, jdst = getattr(jalu, name)(np, N_IDX, *args)
    src, dst = getattr(alu, name)(torch, N_IDX, *args)
    np.testing.assert_array_equal(np.asarray(src), jsrc)
    np.testing.assert_array_equal(np.asarray(dst), jdst)


def test_bcd_digits_match_jax():
    for v in (0, 7, 58, 4096, 99999):
        assert alu.bcd_digits(v, 5) == jalu.bcd_digits(v, 5)


# ---------------------------------------------------------------------------
# the engine overrides
# ---------------------------------------------------------------------------

# (label, n, method, args); registers chosen so that every op sees
# nonzero amplitudes in and out of its subspaces
_OPS = [
    ("INC", 8, "INC", (37, 1, 6)),
    ("DEC", 8, "DEC", (11, 2, 5)),
    ("CINC", 9, "CINC", (5, 0, 5, (7, 8))),
    ("INCDECC", 8, "INCDECC", (19, 0, 5, 7)),
    ("INCC", 8, "INCC", (9, 1, 5, 7)),
    ("INCS", 9, "INCS", (13, 1, 6, 8)),
    ("INCDECSC_carry", 9, "INCDECSC", (27, 0, 6, 8)),
    ("INCDECSC_ovf", 10, "INCDECSC", (27, 0, 6, 9, 8)),
    ("INCBCD", 10, "INCBCD", (37, 1, 8)),
    ("INCDECBCDC", 10, "INCDECBCDC", (58, 0, 8, 9)),
    ("ROL", 10, "ROL", (3, 2, 7)),
    ("ROR", 10, "ROR", (3, 2, 7)),
    ("MUL", 10, "MUL", (5, 0, 4, 4)),
    ("DIV", 10, "DIV", (5, 0, 4, 4)),
    ("CMUL", 11, "CMUL", (3, 0, 4, 4, (9, 10))),
    ("CDIV", 11, "CDIV", (3, 0, 4, 4, (10,))),
    ("MULModNOut", 10, "MULModNOut", (5, 13, 0, 5, 4)),
    ("IMULModNOut", 10, "IMULModNOut", (5, 13, 0, 5, 4)),
    ("CMULModNOut", 11, "CMULModNOut", (5, 11, 0, 4, 4, (9,))),
    ("CIMULModNOut", 11, "CIMULModNOut", (5, 11, 0, 4, 4, (10,))),
    ("POWModNOut", 12, "POWModNOut", (7, 15, 0, 6, 6)),
    ("CPOWModNOut", 12, "CPOWModNOut", (2, 13, 0, 5, 5, (11,))),
    ("IndexedLDA", 11, "IndexedLDA", (0, 4, 4, 6, _TABLE16, False)),
    ("IndexedLDA_reset", 11, "IndexedLDA", (0, 4, 4, 6, _TABLE16)),
    ("IndexedADC", 11, "IndexedADC", (0, 4, 4, 6, 10, _TABLE16)),
    ("IndexedSBC", 11, "IndexedSBC", (0, 4, 4, 6, 10, _TABLE16)),
    ("Hash", 10, "Hash", (1, 8, _PERM8)),
    ("PhaseFlipIfLess", 9, "PhaseFlipIfLess", (100, 1, 7)),
    ("PhaseFlipIfLess_all", 9, "PhaseFlipIfLess", (1000, 1, 7)),
    ("CPhaseFlipIfLess", 9, "CPhaseFlipIfLess", (9, 2, 4, 8)),
]


def _engines(n, seed):
    psi = rand_state(n, seed)
    engines = {
        "port_cuda": qt.create_quantum_interface(
            "cuda", n, device="cpu", rng=QrackRandom(seed),
            rand_global_phase=False),
        "port_cpu": qt.create_quantum_interface(
            "cpu", n, rng=QrackRandom(seed), rand_global_phase=False),
        "jax_tpu": jax_create("tpu", n, rng=JaxRandom(seed),
                              rand_global_phase=False),
        "jax_cpu": JaxCPU(n, rng=JaxRandom(seed), rand_global_phase=False),
    }
    for e in engines.values():
        e.SetQuantumState(psi)
    return engines


@pytest.mark.parametrize("label,n,method,args", _OPS, ids=[o[0] for o in _OPS])
def test_alu_override_matches_jax(label, n, method, args):
    eng = _engines(n, 100 + len(label))
    out = {k: getattr(e, method)(*args) for k, e in eng.items()}
    st = {k: np.asarray(e.GetQuantumState()) for k, e in eng.items()}
    # the op really acts: the state moved
    assert not np.allclose(st["jax_cpu"], rand_state(n, 100 + len(label)),
                           atol=1e-3)
    np.testing.assert_allclose(st["port_cpu"], st["jax_cpu"], atol=1e-12)
    np.testing.assert_allclose(st["port_cuda"], st["jax_tpu"], atol=1e-6)
    np.testing.assert_allclose(st["port_cuda"], st["jax_cpu"], atol=1e-6)
    assert out["port_cpu"] == out["jax_cpu"]
    assert out["port_cuda"] == out["jax_tpu"]


def test_alu_overrides_run_as_one_index_pass(monkeypatch):
    """INC, ROL and PhaseFlipIfLess each take one gather or one phase
    pass on the dense engine, never the gate-level synthesis."""
    from qrack_tpu_torch.engines.cuda import QEngineCUDA

    calls = []
    for name in ("_k_gather", "_k_phase_fn", "_k_apply_2x2", "_k_apply_diag"):
        real = getattr(QEngineCUDA, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(QEngineCUDA, name, spy)
    q = qt.create_quantum_interface("cuda", 8, device="cpu")
    q.INC(5, 0, 6)
    q.ROL(2, 1, 6)
    q.PhaseFlipIfLess(9, 0, 6)
    q.MUL(3, 0, 4, 4)
    assert calls == ["_k_gather", "_k_gather", "_k_phase_fn"]


# ---------------------------------------------------------------------------
# exact round trips (chip_smoke.py's alu_w30 phase at n = 12)
# ---------------------------------------------------------------------------

RT_N = 12
RT_CARRY = (4, 4)  # MUL/DIV carry register [4, 8): kept at |0>


def _round_trip_engine():
    """A seeded superposition with the carry register at |0>: H on every
    other qubit, seeded T and CNOT among them."""
    rng = np.random.default_rng(5)
    q = qt.create_quantum_interface("cuda", RT_N, device="cpu",
                                    rng=QrackRandom(5), rand_global_phase=False)
    free = [b for b in range(RT_N) if not 4 <= b < 8]
    for b in free:
        q.H(b)
    for _ in range(8):
        a, b = (int(x) for x in rng.choice(free, 2, replace=False))
        q.T(a)
        q.CNOT(a, b)
    return q


_ROUND_TRIPS = [
    ("INC", [("INC", (45, 0, 9)), ("INC", (-45, 0, 9))]),
    ("ROL_ROR", [("ROL", (3, 1, 10)), ("ROR", (3, 1, 10))]),
    ("MUL_DIV", [("MUL", (7, 0, 4, 4)), ("DIV", (7, 0, 4, 4))]),
    ("CMUL_CDIV", [("CMUL", (5, 0, 4, 4, (11,))),
                   ("CDIV", (5, 0, 4, 4, (11,)))]),
    ("Hash", [("Hash", (2, 8, _PERM8)),
              ("Hash", (2, 8, [int(v) for v in _inverse(_PERM8)]))]),
    ("IndexedLDA", [("IndexedLDA", (0, 4, 8, 4, _PERM16, False)),
                    ("IndexedLDA", (0, 4, 8, 4, _PERM16, False))]),
]


@pytest.mark.parametrize("label,ops", _ROUND_TRIPS,
                         ids=[r[0] for r in _ROUND_TRIPS])
def test_round_trips_are_exact(label, ops):
    q = _round_trip_engine()
    before = q.device_planes.clone()
    (m1, a1), (m2, a2) = ops
    getattr(q, m1)(*a1)
    moved = q.device_planes.clone()
    getattr(q, m2)(*a2)
    assert not torch.equal(moved, before)
    assert torch.equal(q.device_planes, before)


# ---------------------------------------------------------------------------
# the TurboQuant engine
# ---------------------------------------------------------------------------

def test_turboquant_inc_matches_jax(monkeypatch):
    from qrack_tpu.engines.turboquant import QEngineTurboQuant

    monkeypatch.setenv("QRACK_USE_PALLAS", "1")
    n, seed = 10, 31
    port = qt.create_quantum_interface("turboquant", n, device="cpu", bits=16,
                                       rng=QrackRandom(seed),
                                       rand_global_phase=False)
    ref = QEngineTurboQuant(n, bits=16, rng=JaxRandom(seed),
                            rand_global_phase=False)
    port._PALLAS_TILE_POW = ref._PALLAS_TILE_POW = 4
    psi = rand_state(n, seed)
    for e in (port, ref):
        e.SetQuantumState(psi)
        e.H(3)
        e.INC(37, 1, 7)
        e.CINC(3, 0, 4, (9,))
        e.PhaseFlipIfLess(20, 2, 6)
    a, b = port.GetQuantumState(), np.asarray(ref.GetQuantumState())
    fid = abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)
    assert fid > 1 - 1e-9
    assert port.peak_transient_amps == 1 << n


def test_turboquant_alu_past_the_dense_cap_raises_as_jax(monkeypatch):
    """An ALU permutation needs the dense float32 fallback, which both
    engines refuse past the dense cap (set to 8 here so that the test
    builds a small ket); INC is no longer synthesized from gates."""
    import qrack_tpu.engines.tpu as jtpu
    from qrack_tpu.engines.turboquant import QEngineTurboQuant
    import qrack_tpu_torch.engines.turboquant as ptq

    monkeypatch.setattr(jtpu, "MAX_DENSE_QB", 8)
    monkeypatch.setattr(ptq, "MAX_DENSE_QB", 8)
    port = qt.create_quantum_interface("turboquant", 10, device="cpu")
    ref = QEngineTurboQuant(10)
    for e in (port, ref):
        e.H(0)
        with pytest.raises(MemoryError, match="dense"):
            e.INC(3, 0, 5)
        with pytest.raises(MemoryError, match="dense"):
            e.MUL(3, 0, 4, 4)
