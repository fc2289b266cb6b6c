"""The port's light-cone engine (qrack_tpu_torch/lightcone) against the
JAX package's, on the CPU: the counterparts of the 15 tests of
tests/test_lightcone.py that need no serving plane.

* ``compact_over`` and ``sliced_shape_key`` give the same cone orders,
  gate lists and digests as the JAX functions on the same circuits.
* The observable surface of the port's ``"lightcone"`` stack
  (``device="cpu"``) matches the JAX QLightCone's on the same seeds at
  the float32 bars of tests/test_torch_fuzz.py (Prob, parities, masks
  and amplitude moduli within 3e-5; fidelity > 1 - 1e-6), and
  ``MultiShotMeasureMask`` draws the same counts: the cone stacks, their
  rng streams (``_stack_rng``) and the cone-cache keys are the JAX
  engine's.
* Recorded projectors, their closure over entangled reads, the
  materialization past the cap, the w50 auto-route and the typed
  ``lightcone.slice`` fault behave as in the JAX engine.
* Lightcone checkpoint files cross the two packages both ways, their
  warm cones cache hits on the other side.

Left for the serving plane (ROADMAP item 16b):
``test_lightcone_session_checkpoint_roundtrip_serve_recover`` and
``test_service_w50_shallow_next_to_dense`` (they need serve/);
``test_telemetry_report_lightcone_section`` reads the JAX tool
scripts/telemetry_report.py.
"""

import math

import numpy as np
import pytest

import qrack_tpu_torch as qt
from qrack_tpu_torch import matrices as tmat
from qrack_tpu_torch import resilience as tres
from qrack_tpu_torch import telemetry as ttele
from qrack_tpu_torch.layers.qcircuit import QCircuit as TCircuit
from qrack_tpu_torch.lightcone.engine import compact_over, sliced_shape_key
from qrack_tpu_torch.models import algorithms as talg
from qrack_tpu_torch.resilience import faults as tfaults
from qrack_tpu_torch.resilience.errors import InjectedFault
from qrack_tpu_torch.route import MisrouteError, decide, extract_features
from qrack_tpu_torch.utils.rng import QrackRandom

import qrack_tpu.resilience as jres
from qrack_tpu import QEngineCPU
from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu import matrices as jmat
from qrack_tpu import telemetry as jtele
from qrack_tpu.layers.qcircuit import QCircuit as JCircuit
from qrack_tpu.lightcone import engine as jlc
from qrack_tpu.models import algorithms as jalg
from qrack_tpu.resilience import faults as jfaults
from qrack_tpu.route import decide as jdecide
from qrack_tpu.route import extract_features as jfeatures
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

FID_BAR = 1e-6      # float32 planes (tests/test_torch_fuzz.py F32)
PROB_BAR = 3e-5


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("QRACK_ROUTE_HBM_BYTES", str(16 << 30))
    monkeypatch.delenv("QRACK_ROUTE", raising=False)
    yield
    # an injected fault arms the resilience plane: disarm both packages'
    for tele, faults, res in ((ttele, tfaults, tres), (jtele, jfaults, jres)):
        faults.clear()
        res.disable()
        tele.disable()
        tele.reset()
    tres.reset_breaker()
    tres.configure()


@pytest.fixture
def telemetry():
    for tele in (ttele, jtele):
        tele.enable()
        tele.reset()
    yield
    for tele in (ttele, jtele):
        tele.disable()
        tele.reset()


def _fidelity(a, b) -> float:
    a = np.asarray(a, dtype=np.complex128).ravel()
    b = np.asarray(b, dtype=np.complex128).ravel()
    return float(abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real
                                            * np.vdot(b, b).real))


def _lc_counters():
    def pick(snap):
        return {k: v for k, v in snap["counters"].items()
                if k.startswith("lightcone.")}
    return pick(ttele.snapshot()), pick(jtele.snapshot())


def _pair(n, rng_seed, **kw):
    """(port, JAX) lightcone stacks on the same seeded rng."""
    port = qt.create_quantum_interface("lightcone", n, device="cpu",
                                       rng=QrackRandom(rng_seed), **kw)
    ref = jax_create("lightcone", n, rng=JaxRandom(rng_seed), **kw)
    return port, ref


def _same_compact(tc, jc, qubits):
    (a, oa), (b, ob) = compact_over(tc, qubits), jlc.compact_over(jc, qubits)
    assert oa == ob
    assert a.qubit_count == b.qubit_count
    assert a.structure_digest() == b.structure_digest()
    return a, oa


# ---------------------------------------------------------------------------
# cone extraction / relabeling units
# ---------------------------------------------------------------------------


def test_compact_over_brickwork_cone_widths():
    tc, jc = talg.brickwork_qcircuit(50), jalg.brickwork_qcircuit(50)
    compact, order = _same_compact(tc, jc, (25,))
    assert order == list(range(22, 28))
    assert compact.qubit_count == 6
    for g in compact.gates:
        assert all(0 <= q < compact.qubit_count for q in g.qubits())
    _, order0 = _same_compact(tc, jc, (0,))
    assert order0 == [0, 1, 2, 3]


def test_compact_over_elides_trailing_gates_and_digest_disambiguates():
    cs = []
    for C, m in ((TCircuit, tmat), (JCircuit, jmat)):
        c = C(4)
        c.append_1q(0, m.H2)
        c.append_ctrl((0,), 1, m.X2, 1)
        c.append_1q(1, m.Y2)
        cs.append(c)
    ca, oa = _same_compact(*cs, (0,))
    cb, ob = _same_compact(*cs, (0, 1))
    assert len(ca.gates) == 2
    assert len(cb.gates) == 3
    assert oa == ob == [0, 1]
    assert ca.structure_digest() != cb.structure_digest()


def test_compact_over_preserves_payloads_and_control_order():
    cs = []
    for C, m in ((TCircuit, tmat), (JCircuit, jmat)):
        c = C(9)
        c.append_1q(2, m.H2)
        c.append_1q(5, m.H2)
        c.append_ctrl((5, 2), 7, m.u3_mtrx(0.7, 0.4, 0.5), 2)
        cs.append(c)
    compact, order = _same_compact(*cs, (7,))
    assert order == [2, 5, 7]
    qmap = {q: i for i, q in enumerate(order)}
    g = compact.gates[-1]
    assert g.controls == (qmap[5], qmap[2])
    assert g.target == qmap[7]
    assert np.allclose(g.payloads[2], tmat.u3_mtrx(0.7, 0.4, 0.5))


def test_sliced_shape_key_is_offset_invariant():
    keys = []
    for C, m, key in ((TCircuit, tmat, sliced_shape_key),
                      (JCircuit, jmat, jlc.sliced_shape_key)):
        a = C(50)
        a.append_1q(3, m.H2)
        a.append_ctrl((3,), 4, m.X2, 1)
        b = C(50)
        b.append_1q(20, m.H2)
        b.append_ctrl((20,), 21, m.X2, 1)
        d = C(50)
        d.append_1q(20, m.H2)
        assert key(a) == key(b)
        assert key(a) != key(d)
        keys.append((key(a), key(d)))
    assert keys[0] == keys[1]
    assert sliced_shape_key(talg.brickwork_qcircuit(50)) == \
        jlc.sliced_shape_key(jalg.brickwork_qcircuit(50))
    assert sliced_shape_key(talg.brickwork_qcircuit(50))[0] == 50


# ---------------------------------------------------------------------------
# cone-width features on the algorithm-model IR builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder,width,max_cone,by_depth", [
    (lambda a, R: a.brickwork_qcircuit(50), 50, 6, (1, 2, 4, 6)),
    (lambda a, R: a.ghz_qcircuit(12), 12, 12, tuple(range(1, 13))),
    (lambda a, R: a.qaoa_qcircuit(8, p=1), 8, 8,
     (1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7,
      8, 8, 8, 8, 8, 8, 8)),
    (lambda a, R: a.quantum_volume_qcircuit(6, rng=R(17)), 6, 6,
     (1, 2, 2, 4, 4, 6, 6, 6, 6, 6, 6, 6, 6)),
    (lambda a, R: a.trotter_qcircuit(10, steps=1), 10, 10,
     (2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 8,
      9, 9, 9, 10, 10, 10, 10)),
], ids=["brickwork50", "ghz12", "qaoa8", "qv6", "trotter10"])
def test_cone_width_features(builder, width, max_cone, by_depth):
    f = extract_features(builder(talg, QrackRandom), width)
    jf = jfeatures(builder(jalg, JaxRandom), width)
    assert f.as_dict() == jf.as_dict()
    assert f.max_cone_width == max_cone
    assert f.cone_width_by_depth == by_depth


# ---------------------------------------------------------------------------
# parity against the JAX QLightCone across the observable surface
# ---------------------------------------------------------------------------


def _random_shallow(C, m, n: int, n_gates: int, seed: int):
    rng = np.random.Generator(np.random.PCG64(seed))
    c = C(n)
    for _ in range(n_gates):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            q = int(rng.integers(0, n))
            th, ph, lm = (float(x) for x in rng.uniform(0.0, 2.0, 3))
            c.append_1q(q, m.u3_mtrx(th, ph, lm))
        else:
            qs = rng.choice(n, size=3, replace=False)
            a, b, t = (int(q) for q in qs)
            if kind == 1:
                c.append_ctrl((a,), b, m.X2, 1)
            elif kind == 2:
                c.append_ctrl((a,), b, m.Z2, 1)
            else:
                c.append_ctrl((a, b), t, m.X2, 3)
    return c


@pytest.mark.parametrize("window", ["1", "16"])
@pytest.mark.parametrize("trial", [0, 1])
def test_observable_surface_parity_vs_dense_oracle(window, trial,
                                                   monkeypatch, telemetry):
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", window)
    n = 12
    lc, jl = _pair(n, rng_seed=trial, rand_global_phase=False)
    o = QEngineCPU(n, rng=JaxRandom(trial), rand_global_phase=False)
    _random_shallow(TCircuit, tmat, n, 30, 7100 + trial).Run(lc)
    for e in (jl, o):
        _random_shallow(JCircuit, jmat, n, 30, 7100 + trial).Run(e)

    for q in range(n):
        p = lc.Prob(q)
        assert abs(p - jl.Prob(q)) < PROB_BAR
        assert abs(p - o.Prob(q)) < PROB_BAR
    for mask in (0b1, 0b101, 0b110011, (1 << n) - 1):
        assert abs(lc.ProbParity(mask) - jl.ProbParity(mask)) < PROB_BAR
        assert abs(lc.ProbMask(mask, mask & 0b10101)
                   - jl.ProbMask(mask, mask & 0b10101)) < PROB_BAR
        np.testing.assert_allclose(lc.ProbMaskAll(mask),
                                   jl.ProbMaskAll(mask), atol=PROB_BAR)
    bits = [0, 3, 7, 11]
    np.testing.assert_allclose(lc.ProbBitsAll(bits), jl.ProbBitsAll(bits),
                               atol=PROB_BAR)
    assert abs(lc.ExpectationBitsAll(bits)
               - jl.ExpectationBitsAll(bits)) < 1e-4
    for perm in (0, 1, 42, (1 << n) - 1):
        assert abs(abs(lc.GetAmplitude(perm))
                   - abs(jl.GetAmplitude(perm))) < PROB_BAR
    np.testing.assert_allclose(np.asarray(lc.GetProbs()),
                               np.asarray(jl.GetProbs()), atol=PROB_BAR)
    a = lc.GetQuantumState()
    assert _fidelity(a, jl.GetQuantumState()) > 1 - FID_BAR
    assert _fidelity(a, o.GetQuantumState()) > 1 - FID_BAR

    powers = [1 << b for b in bits]
    shots = lc.MultiShotMeasureMask(powers, 64)
    assert shots == jl.MultiShotMeasureMask(powers, 64)
    assert sum(shots.values()) == 64
    marg = np.asarray(o.ProbBitsAll(bits))
    for key in shots:
        assert marg[key] > 1e-9
    # the same cone-cache keys, and the same reads/hits/misses
    assert sorted(lc._cones) == sorted(jl._cones)
    port, ref = _lc_counters()
    assert port == ref and port["lightcone.cache.hit"] > 0


# ---------------------------------------------------------------------------
# mid-circuit measurement: buffer projector while the cone is narrow
# ---------------------------------------------------------------------------


def test_m_records_projector_and_closure_reaches_entangled_reads(
        telemetry):
    lc, jl = _pair(12, rng_seed=7)
    ms = []
    for e, m in ((lc, tmat), (jl, jmat)):
        e.H(0)
        e.MCMtrxPerm((0,), m.X2, 1, 1)
        e.MCMtrxPerm((1,), m.X2, 2, 1)
        ms.append(float(e.M(0)))
    m = ms[0]
    assert ms[1] == m
    assert lc.sim is None
    assert len(lc.circuit.gates) == len(jl.circuit.gates) == 4
    for q in range(3):
        assert abs(lc.Prob(q) - m) < 1e-6
    clone = lc.Clone()
    assert abs(clone.Prob(2) - m) < 1e-6
    port, ref = _lc_counters()
    assert port["lightcone.m.projector"] == ref["lightcone.m.projector"] == 1
    assert port.get("lightcone.materialize.full", 0) == 0


def test_projector_across_product_cut_stays_elided():
    lc, jl = _pair(12, rng_seed=3)
    for e in (lc, jl):
        e.H(0)
        e.H(5)
        e.M(5)
    _, order = lc._slice((0,))
    assert order == jl._slice((0,))[1] == [0]
    assert abs(lc.Prob(0) - 0.5) < 1e-6


def test_force_m_zero_probability_raises():
    lc = qt.create_quantum_interface("lightcone", 3, seed=1, device="cpu")
    lc.X(0)
    with pytest.raises(RuntimeError, match="zero probability"):
        lc.ForceM(0, False, do_force=True)


def test_m_past_cap_materializes(telemetry, monkeypatch):
    monkeypatch.setenv("QRACK_LIGHTCONE_M_MAX_QB", "2")
    lc, jl = _pair(6, rng_seed=3)
    ms = []
    for e, m in ((lc, tmat), (jl, jmat)):
        e.H(0)
        for q in range(5):
            e.MCMtrxPerm((q,), m.X2, q + 1, 1)
        ms.append(float(e.M(5)))
    assert ms[0] == ms[1]
    assert lc.sim is not None
    assert not lc.circuit.gates
    for q in range(6):
        for e in (lc, jl):
            assert abs(e.Prob(q) - ms[0]) < 1e-6
    port, ref = _lc_counters()
    assert port["lightcone.materialize.full"] == 1
    assert port.get("lightcone.m.projector", 0) == 0
    assert port == ref


def test_force_m_matches_oracle_state():
    n = 8
    lc, jl = _pair(n, rng_seed=2, rand_global_phase=False)
    o = QEngineCPU(n, rng=JaxRandom(2), rand_global_phase=False)
    for e, m in ((lc, tmat), (jl, jmat), (o, jmat)):
        e.H(0)
        e.MCMtrxPerm((0,), m.X2, 1, 1)
        e.H(2)
        e.MCMtrxPerm((2,), m.X2, 3, 1)
        e.ForceM(1, True)
    a = lc.GetQuantumState()
    assert _fidelity(a, o.GetQuantumState()) > 1 - FID_BAR
    assert _fidelity(a, jl.GetQuantumState()) > 1 - FID_BAR


# ---------------------------------------------------------------------------
# checkpoint round trips, within the port and across the packages
# ---------------------------------------------------------------------------


def test_lightcone_checkpoint_roundtrip_direct(tmp_path, telemetry):
    from qrack_tpu.checkpoint import load_state as jload
    from qrack_tpu.checkpoint import save_state as jsave
    from qrack_tpu_torch.checkpoint import load_state, save_state

    n = 10
    lc, jl = _pair(n, rng_seed=5, rand_global_phase=False)
    talg.brickwork_qcircuit(n).Run(lc)
    jalg.brickwork_qcircuit(n).Run(jl)
    for e in (lc, jl):
        _ = e.Prob(4)
        e.M(0)                 # a recorded projector (the cache empties)
        _ = e.Prob(4)          # two warm cones ride in the file
        _ = e.GetQuantumState()
    before = np.asarray(lc.GetQuantumState())
    want = lc.Prob(4)
    tpath, jpath = str(tmp_path / "t.qckpt"), str(tmp_path / "j.qckpt")
    save_state(lc, tpath)
    jsave(jl, jpath)
    backs = (load_state(tpath, device="cpu"), jload(tpath),
             load_state(jpath, device="cpu"))
    for back in backs:
        assert back.sim is None
        assert len(back.circuit.gates) == len(lc.circuit.gates)
        assert sorted(back._cones) == sorted(lc._cones)
    ttele.reset()
    jtele.reset()
    # the restored cones are cache hits: the same digests on both sides
    for back in backs:
        assert abs(back.Prob(4) - want) < PROB_BAR
        f = _fidelity(before, back.GetQuantumState())
        assert f > 1 - FID_BAR, f
    port, ref = _lc_counters()
    assert port["lightcone.cache.hit"] == 4
    assert ref["lightcone.cache.hit"] == 2
    assert "lightcone.cache.miss" not in port
    assert "lightcone.cache.miss" not in ref


# ---------------------------------------------------------------------------
# w50 acceptance: auto-routed, analytically exact, forced dense refused
# ---------------------------------------------------------------------------


def test_w50_brickwork_auto_routes_lightcone_and_is_exact(telemetry):
    d = decide(talg.brickwork_qcircuit(50), 50)
    jd = jdecide(jalg.brickwork_qcircuit(50), 50)
    assert d.stack == jd.stack == "lightcone"
    assert d.reason == "cost"
    assert d.scores == jd.scores
    r = qt.create_quantum_interface("route", 50, rng=QrackRandom(9),
                                    device="cpu")
    jr = jax_create("route", 50, rng=JaxRandom(9))
    talg.brickwork_qcircuit(50).Run(r)
    jalg.brickwork_qcircuit(50).Run(jr)
    assert r.current_stack() == jr.current_stack() == "lightcone"
    for q in (0, 1, 25, 49):
        want = math.sin(talg.brickwork_theta(q) / 2.0) ** 2
        p = r.Prob(q)
        assert abs(p - want) < 1e-6
        assert abs(p - jr.Prob(q)) < 1e-6
    port, ref = _lc_counters()
    assert port == ref
    assert port["lightcone.reads"] >= 4
    assert port["lightcone.cache.miss"] >= 1
    assert port["lightcone.gates.elided"] >= 1


def test_w50_forced_dense_refused(monkeypatch):
    monkeypatch.setenv("QRACK_ROUTE", "dense")
    r = qt.create_quantum_interface("route", 50, rng=QrackRandom(9),
                                    device="cpu")
    with pytest.raises(MisrouteError, match="exceeds the dense ladder"):
        talg.brickwork_qcircuit(50).Run(r)
    assert r.current_stack() is None


# ---------------------------------------------------------------------------
# lightcone.slice fault site: injected faults surface typed, never silent
# ---------------------------------------------------------------------------


def test_lightcone_slice_fault_surfaces_typed():
    lc = qt.create_quantum_interface("lightcone", 6, seed=1, device="cpu")
    lc.H(0)
    tfaults.parse_spec("lightcone.slice:raise:0")   # a ported site now
    try:
        tfaults.inject("lightcone.slice", "raise", after_n=0, times=1)
        with pytest.raises(InjectedFault):
            lc.Prob(0)
        tfaults.inject("lightcone.slice", "hang", after_n=0, times=1)
        with pytest.raises(RuntimeError,
                           match="lightcone.slice injected fault"):
            lc.Prob(0)
    finally:
        tfaults.clear()
    assert abs(lc.Prob(0) - 0.5) < 1e-6
