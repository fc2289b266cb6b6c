"""The port's router (qrack_tpu_torch/route: features, cost model,
QRouted) against the JAX package's, on the CPU: the counterparts of the
19 tests of tests/test_route.py that need no serving plane.

* Features and scores equal the JAX package's exactly (``as_dict`` and
  every score, INFEASIBLE included); decisions are exact, the dense
  terminal's name (``"cuda"`` for the JAX ``"tpu"``) the only allowed
  difference (BY_DESIGN).
* Routed execution runs the same ops on the port's ``"route"`` stack
  (``device="cpu"``), the JAX ``"route"`` stack and the JAX complex128
  oracle: the same stack is chosen, and the port's ket matches the JAX
  routed ket at the float32 bars of tests/test_torch_fuzz.py (fidelity
  > 1 - 1e-6, Prob within 3e-5).
* The route.* counters, and factory.create.* with ``tpu`` read as
  ``cuda``, equal the JAX package's on the same scenario.
* Both packages fall back to a 16 GiB budget on the CPU; every test pins
  QRACK_ROUTE_HBM_BYTES to it so no probe can move a decision.

Left for the serving plane (ROADMAP item 16b):
``test_service_w100_clifford_next_to_dense_w22`` and
``test_service_route_opt_out_pins_dense`` (they need serve/);
``test_telemetry_report_routing_section`` reads the JAX tool
scripts/telemetry_report.py.  The JAX soak (slow-marked, 40 trials) is
ported as three unmarked trials.
"""

import numpy as np
import pytest

import qrack_tpu_torch as qt
from qrack_tpu_torch import matrices as tmat
from qrack_tpu_torch import telemetry as ttele
from qrack_tpu_torch.layers.qcircuit import QCircuit as TCircuit
from qrack_tpu_torch.models import algorithms as talg
from qrack_tpu_torch.models.qft import qft_qcircuit as t_qft
from qrack_tpu_torch.route import (INFEASIBLE, MisrouteError, RouteKnobs,
                                   choose_stack, decide, extract_features,
                                   layers_for, score_stacks)
from qrack_tpu_torch.route import cost as tcost
from qrack_tpu_torch.utils.rng import QrackRandom

from qrack_tpu import QEngineCPU
from qrack_tpu import create_quantum_interface as jax_create
from qrack_tpu import matrices as jmat
from qrack_tpu import telemetry as jtele
from qrack_tpu.layers.qcircuit import QCircuit as JCircuit
from qrack_tpu.models import algorithms as jalg
from qrack_tpu.models.qft import qft_qcircuit as j_qft
from qrack_tpu.route import cost as jcost
from qrack_tpu.route import decide as jdecide
from qrack_tpu.route import extract_features as jfeatures
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

from test_fuzz_api import N as FUZZ_N
from test_fuzz_api import _ops

FID_BAR = 1e-6      # float32 planes (tests/test_torch_fuzz.py F32)
PROB_BAR = 3e-5
FALLBACK = 16 << 30

#: where the port's router differs from the JAX package's by design
BY_DESIGN = {
    "cuda_terminal": "layers_for names the dense terminal 'cuda' where "
                     "the JAX package says 'tpu'; a checkpoint file "
                     "writes 'tpu' and reads it back as 'cuda'",
    "card_budget": "a routed wrapper on the card prices the memory axis "
                   "against the card's total memory (80 GB on an H100), "
                   "where both packages fall back to 16 GiB on the CPU: "
                   "a decision the budget binds may differ, e.g. the w32 "
                   "QFT is int8 TurboQuant (17.7 GB) on the H100 and the "
                   "tree under the fallback",
}


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("QRACK_ROUTE_HBM_BYTES", str(FALLBACK))
    monkeypatch.delenv("QRACK_ROUTE", raising=False)
    yield
    for tele in (ttele, jtele):
        tele.disable()
        tele.reset()


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
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real
                                      * np.vdot(b, b).real)


def _jax_layers(layers):
    return tuple("tpu" if x == "cuda" else x for x in layers)


def _route_counters():
    """(port, JAX) route.* and factory.create.* counters, the JAX
    package's ``tpu`` read as ``cuda``."""
    def pick(snap):
        return {k.replace(".tpu", ".cuda"): v
                for k, v in snap["counters"].items()
                if k.startswith(("route.", "factory.create."))}
    return pick(ttele.snapshot()), pick(jtele.snapshot())


def _pair(n, seed, **kw):
    port = qt.create_quantum_interface("route", n, rng=QrackRandom(seed),
                                       rand_global_phase=False,
                                       device="cpu", **kw)
    ref = jax_create("route", n, rng=JaxRandom(seed),
                     rand_global_phase=False, **kw)
    return port, ref


# ---------------------------------------------------------------------------
# feature extraction
# ---------------------------------------------------------------------------


def _same_features(tc, jc, width):
    tf, jf = extract_features(tc, width), jfeatures(jc, width)
    assert tf.as_dict() == jf.as_dict()
    assert tf.is_clifford == jf.is_clifford
    assert tf.stabilizer_ok == jf.stabilizer_ok
    return tf


def test_features_ghz_fully_clifford():
    n = 12
    f = _same_features(talg.ghz_qcircuit(n), jalg.ghz_qcircuit(n), n)
    assert f.is_clifford and f.stabilizer_ok
    assert f.clifford_fraction == 1.0
    assert f.magic_count == 0 and f.general_count == 0
    assert f.entangling_count == n - 1
    assert f.max_component == n
    assert f.nn_fraction == 1.0
    assert f.distinct_pairs == n - 1


def test_features_qft_controlled_phases_are_general():
    f = _same_features(t_qft(8), j_qft(8), 8)
    assert f.general_count > 0
    assert not f.stabilizer_ok
    assert not f.is_clifford


def test_features_t_gates_are_magic_not_general():
    cs = []
    for C, m in ((TCircuit, tmat), (JCircuit, jmat)):
        c = C()
        c.append_1q(0, m.H2)
        c.append_1q(1, m.T2)
        cs.append(c)
    f = _same_features(*cs, 4)
    assert f.magic_count == 1
    assert f.general_count == 0
    assert f.stabilizer_ok and not f.is_clifford


def test_features_multi_control_is_general():
    cs = []
    for C, m in ((TCircuit, tmat), (JCircuit, jmat)):
        c = C()
        c.append_ctrl((0, 1), 2, m.X2, 3)
        cs.append(c)
    f = _same_features(*cs, 4)
    assert f.multi_ctrl_count == 1
    assert f.general_count == 1


def test_features_empty_circuit():
    f = _same_features(TCircuit(), JCircuit(), 5)
    assert f.gate_count == 0
    assert f.clifford_fraction == 1.0 and f.is_clifford
    assert f.max_component == 1


def test_features_components_track_entangled_blocks():
    cs = []
    for C, m in ((TCircuit, tmat), (JCircuit, jmat)):
        c = C()
        c.append_ctrl((0,), 1, m.X2, 1)
        c.append_ctrl((2,), 3, m.X2, 1)
        cs.append(c)
    f = _same_features(*cs, 6)
    assert f.max_component == 2
    assert f.distinct_pairs == 2


# ---------------------------------------------------------------------------
# cost model / decision matrix
# ---------------------------------------------------------------------------


def _builders(name):
    """(port builder, JAX builder) of a decide-matrix case."""
    table = {
        "ghz": lambda a: a.ghz_qcircuit,
        "qv": lambda a: (lambda n: a.quantum_volume_qcircuit(
            n, rng=(QrackRandom if a is talg else JaxRandom)(11))),
        "qaoa": lambda a: (lambda n: a.qaoa_qcircuit(n, p=1)),
        "trotter2": lambda a: (lambda n: a.trotter_qcircuit(n, steps=2)),
        "trotter1": lambda a: (lambda n: a.trotter_qcircuit(n, steps=1)),
    }
    if name == "qft":
        return t_qft, j_qft
    return table[name](talg), table[name](jalg)


@pytest.mark.parametrize("make,width,stack", [
    ("ghz", 100, "stabilizer"),
    ("ghz", 20, "stabilizer"),
    ("qft", 22, "dense"),
    ("qv", 12, "dense"),
    ("qaoa", 12, "dense"),
    ("trotter2", 16, "dense"),
    ("trotter1", 24, "bdt"),
    ("qft", 30, "turboquant"),
], ids=["ghz100", "ghz20", "qft22", "qv12", "qaoa12", "trotter16",
        "trotter24", "qft30"])
def test_decide_matrix(make, width, stack):
    tb, jb = _builders(make)
    tc, jc = tb(width), jb(width)
    assert tc.structure_digest() == jc.structure_digest()
    d, jd = decide(tc, width), jdecide(jc, width)
    assert d.stack == jd.stack == stack, d.scores
    assert d.scores == jd.scores
    assert d.features == jd.features
    assert d.layers == layers_for(stack, width, RouteKnobs.from_env())
    assert _jax_layers(d.layers) == jd.layers
    assert d.reason == jd.reason == "cost"


def test_clifford_guard_rail_beats_heuristics(monkeypatch):
    monkeypatch.setenv("QRACK_ROUTE_STAB_WEIGHT", "1e9")
    f = extract_features(talg.ghz_qcircuit(10), 10)
    stack, scores = choose_stack(f, RouteKnobs.from_env(), mode="auto")
    jstack, jscores = jcost.choose_stack(
        jfeatures(jalg.ghz_qcircuit(10), 10), jcost.RouteKnobs.from_env(),
        mode="auto")
    assert stack == jstack == "stabilizer"
    assert scores == jscores
    assert scores["stabilizer"] != INFEASIBLE


def test_scores_wide_general_circuit_falls_to_turboquant():
    f = extract_features(t_qft(30), 30)
    scores = score_stacks(f, RouteKnobs())
    assert scores == jcost.score_stacks(jfeatures(j_qft(30), 30),
                                        jcost.RouteKnobs())
    assert scores["dense"] == INFEASIBLE
    assert scores["stabilizer"] == INFEASIBLE
    assert scores["qunit"] == INFEASIBLE
    assert scores["turboquant"] != INFEASIBLE
    assert scores["turboquant"] < scores["bdt"]
    assert choose_stack(f, RouteKnobs(), mode="auto")[0] == "turboquant"
    f40, j40 = extract_features(t_qft(8), 40), jfeatures(j_qft(8), 40)
    for x in (f40, j40):
        x.width = 40
        x.max_component = 40
        x.max_cone_width = 40
    scores40 = score_stacks(f40, RouteKnobs())
    assert scores40 == jcost.score_stacks(j40, jcost.RouteKnobs())
    assert scores40["turboquant"] == INFEASIBLE
    assert choose_stack(f40, RouteKnobs(), mode="auto")[0] == "bdt"
    # BY_DESIGN card_budget: the same w32 QFT under the H100's 80 GB
    # and under the 16 GiB fallback, both packages alike
    f32, j32 = extract_features(t_qft(32), 32), jfeatures(j_qft(32), 32)
    for budget, want in ((80 * 10 ** 9, "turboquant"), (FALLBACK, "bdt")):
        k = RouteKnobs(hbm_bytes=budget)
        jk = jcost.RouteKnobs(hbm_bytes=budget)
        assert choose_stack(f32, k, mode="auto")[0] == want
        assert jcost.choose_stack(j32, jk, mode="auto")[0] == want
        assert tcost.hbm_bytes("turboquant", f32, k) == \
            jcost.hbm_bytes("turboquant", j32, jk)


def test_a_host_stack_is_never_priced_against_the_card(monkeypatch):
    """With the probe reading a card (a process that has started CUDA),
    a wrapper and a trajectory job on ``device="cpu"`` still price
    against the 16 GiB fallback, less a reservation; a caller that names
    no device gets the probe, as the JAX package's decide does."""
    from qrack_tpu_torch.noise import trajectories as traj

    monkeypatch.delenv("QRACK_ROUTE_HBM_BYTES")
    monkeypatch.setattr(tcost, "_PROBED_HBM", 80 * 10 ** 9)
    circ = t_qft(32)
    q = qt.create_quantum_interface("route", 32, device="cpu")
    assert q.plan(circ).stack == "bdt"
    assert decide(circ, 32).stack == "turboquant"
    assert RouteKnobs.for_device("cpu").hbm_bytes == FALLBACK
    assert traj.budget_bytes("cpu") == traj.DEFAULT_BUDGET_BYTES == FALLBACK
    tcost.set_hbm_reservation(lambda: 1 << 30)
    try:
        assert traj.budget_bytes("cpu") == FALLBACK - (1 << 30)
        assert tcost.hbm_budget_bytes(RouteKnobs.for_device("cpu")) == \
            FALLBACK - (1 << 30)
    finally:
        tcost.set_hbm_reservation(None)
    monkeypatch.setenv("QRACK_ROUTE_HBM_BYTES", str(80 * 10 ** 9))
    assert q.plan(circ).stack == "turboquant"   # the knob wins
    assert traj.budget_bytes("cpu") == 80 * 10 ** 9


def test_route_env_pins_every_decision(monkeypatch):
    for mode, want in (("dense", "dense"), ("bdt", "bdt"),
                       ("not-a-stack", "stabilizer")):
        monkeypatch.setenv("QRACK_ROUTE", mode)
        d = decide(talg.ghz_qcircuit(8), 8)
        jd = jdecide(jalg.ghz_qcircuit(8), 8)
        assert d.stack == jd.stack == want
        assert d.reason == jd.reason
        assert _jax_layers(d.layers) == jd.layers
    assert decide(talg.ghz_qcircuit(8), 8, mode="dense").reason == "pinned"


def test_knobs_from_env(monkeypatch):
    monkeypatch.setenv("QRACK_ROUTE_DENSE_MAX_QB", "12")
    monkeypatch.setenv("QRACK_ROUTE_MAX_MAGIC", "2")
    monkeypatch.setenv("QRACK_ROUTE_BDT_MAX_NODES", "4096")
    k = RouteKnobs.from_env()
    assert (k.dense_max_qb, k.max_magic, k.bdt_max_nodes) == (12, 2, 4096)
    jk = jcost.RouteKnobs.from_env()
    assert {f: getattr(k, f) for f in k.__dataclass_fields__} == \
        {f: getattr(jk, f) for f in jk.__dataclass_fields__}
    f = extract_features(t_qft(4), 14)
    f.width = 14
    assert score_stacks(f, k)["dense"] == INFEASIBLE


# ---------------------------------------------------------------------------
# routed execution: port route, JAX route and the JAX oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", ["1", "16"])
@pytest.mark.parametrize("trial", range(3))
def test_routed_fuzz_vs_oracle(trial, window, monkeypatch):
    monkeypatch.setenv("QRACK_TPU_FUSE_WINDOW", window)
    rng = np.random.Generator(np.random.PCG64(7000 + trial))
    o = QEngineCPU(FUZZ_N, rng=JaxRandom(trial), rand_global_phase=False)
    r, jr = _pair(FUZZ_N, trial)
    assert r.current_stack() is None     # construction builds nothing
    for step in range(30):
        name, args = _ops(rng)
        while name == "SetBit":
            name, args = _ops(rng)
        for e in (o, r, jr):
            getattr(e, name)(*args)
        if rng.integers(0, 10) == 0:
            qb = int(rng.integers(0, FUZZ_N))
            assert abs(jr.Prob(qb) - r.Prob(qb)) < PROB_BAR, (step, name)
    a = r.GetQuantumState()
    assert _fidelity(jr.GetQuantumState(), a) > 1 - FID_BAR
    assert _fidelity(o.GetQuantumState(), a) > 1 - FID_BAR
    assert r.current_stack() == jr.current_stack()
    assert r.current_stack() in ("stabilizer", "dense")


def test_routed_library_circuit_path(telemetry):
    from qrack_tpu_torch.layers.stabilizerhybrid import QStabilizerHybrid

    r, jr = _pair(60, 3)
    talg.ghz_qcircuit(60).Run(r)
    jalg.ghz_qcircuit(60).Run(jr)
    assert r.current_stack() == jr.current_stack() == "stabilizer"
    assert isinstance(r._engine, QStabilizerHybrid)
    assert r._engine.engine is None
    amp = complex(r.GetAmplitude(0))
    assert abs(amp - 1 / np.sqrt(2)) < 1e-9
    assert amp == complex(jr.GetAmplitude(0))
    port, ref = _route_counters()
    assert port == ref
    assert port["route.decisions"] == 1
    assert port["route.built.stabilizer"] == 1


# ---------------------------------------------------------------------------
# mis-route escalation: exactly once, state carried
# ---------------------------------------------------------------------------


def _hard(C, m, *gates):
    c = C()
    for g in gates:
        if len(g) == 2:
            c.append_1q(g[0], m.u3_mtrx(*g[1]))
        else:
            c.append_ctrl(g[0], g[1], m.u3_mtrx(*g[2]), 1)
    return c


def test_misroute_escalates_to_dense_exactly_once(telemetry):
    n = 6
    r, jr = _pair(n, 7)
    talg.ghz_qcircuit(n).Run(r)
    jalg.ghz_qcircuit(n).Run(jr)
    assert r.current_stack() == jr.current_stack() == "stabilizer"
    gates = ((0, (0.3, 0.1, 0.2)), ((1,), 2, (0.7, 0.4, 0.5)))
    _hard(TCircuit, tmat, *gates).Run(r)
    _hard(JCircuit, jmat, *gates).Run(jr)
    assert r.current_stack() == jr.current_stack() == "dense"
    assert r._escalated and jr._escalated
    again = ((3, (0.9, 0.2, 0.8)),)
    _hard(TCircuit, tmat, *again).Run(r)
    _hard(JCircuit, jmat, *again).Run(jr)
    assert _fidelity(jr.GetQuantumState(), r.GetQuantumState()) > 1 - FID_BAR
    port, ref = _route_counters()
    assert port == ref
    assert port["route.misroutes"] == 1
    assert port["route.misroute.escalated"] == 1
    gauges = ttele.snapshot()["gauges"]
    assert gauges["route.residency.dense"] == 1
    assert gauges.get("route.residency.stabilizer", 0) == 0


def test_misroute_past_dense_cap_plans_compressed_rung(telemetry):
    n = 30
    r, jr = _pair(n, 1)
    talg.ghz_qcircuit(n).Run(r)
    jalg.ghz_qcircuit(n).Run(jr)
    assert r.current_stack() == "stabilizer"
    gates = ((0, (0.3, 0.1, 0.2)),)
    d = r.plan(_hard(TCircuit, tmat, *gates))
    jd = jr.plan(_hard(JCircuit, jmat, *gates))
    assert d.stack == jd.stack == "turboquant"
    assert d.reason == jd.reason == "misroute:planned"
    assert d.layers == jd.layers == ("turboquant",)
    assert r.current_stack() == "stabilizer"
    amp = complex(r.GetAmplitude(0))
    assert abs(abs(amp) - 1 / np.sqrt(2)) < 1e-9


def test_misroute_past_every_rung_is_refused(telemetry):
    n = 40
    r, jr = _pair(n, 1)
    talg.ghz_qcircuit(n).Run(r)
    assert r.current_stack() == "stabilizer"
    with pytest.raises(MisrouteError):
        r.plan(_hard(TCircuit, tmat, (0, (0.3, 0.1, 0.2))))
    jalg.ghz_qcircuit(n).Run(jr)
    from qrack_tpu.route import MisrouteError as JMisroute

    with pytest.raises(JMisroute):
        jr.plan(_hard(JCircuit, jmat, (0, (0.3, 0.1, 0.2))))
    assert r.current_stack() == "stabilizer"
    amp = complex(r.GetAmplitude(0))
    assert abs(abs(amp) - 1 / np.sqrt(2)) < 1e-9


def test_stabilizer_forced_off_tableau_relabels(telemetry):
    n = 5
    r, jr = _pair(n, 2)
    o = QEngineCPU(n, rng=JaxRandom(2), rand_global_phase=False)
    for e in (r, jr, o):
        e.H(0)
        e.CNOT(0, 1)
    assert r.current_stack() == "stabilizer"
    for e in (r, jr, o):
        e.RX(0.3, 0)
        e.CNOT(0, 2)
    a = r.GetQuantumState()
    assert _fidelity(o.GetQuantumState(), a) > 1 - FID_BAR
    assert _fidelity(jr.GetQuantumState(), a) > 1 - FID_BAR
    assert r.current_stack() == jr.current_stack() == "dense"
    port, ref = _route_counters()
    assert port == ref
    assert port["route.misroutes"] == 1
    assert port["route.misroute.escalated"] == 1


def test_can_run_cheaply_matches_jax():
    """QStabilizerHybrid.can_run_cheaply, the router's feasibility
    probe: the same answer as the JAX layer's on Clifford, magic,
    general and over-budget circuits, and False once off the tableau."""
    def circuits(C, m):
        cliff, magic, gen, many = C(), C(), C(), C()
        cliff.append_1q(0, m.H2)
        cliff.append_ctrl((0,), 1, m.X2, 1)
        magic.append_1q(1, m.T2)
        gen.append_1q(2, m.u3_mtrx(0.3, 0.2, 0.1))
        for q in range(6):
            many.append_1q(q, m.T2)
            many.append_1q(q, m.H2)
            many.append_1q(q, m.T2)
        return cliff, magic, gen, many
    t = qt.create_quantum_interface(["stabilizer_hybrid", "cuda"], 6,
                                    device="cpu")
    j = jax_create(["stabilizer_hybrid", "tpu"], 6)
    for s in (t, j):
        s.max_ancilla = 4
    got = [t.can_run_cheaply(c) for c in circuits(TCircuit, tmat)]
    assert got == [j.can_run_cheaply(c) for c in circuits(JCircuit, jmat)]
    assert got == [True, True, False, False]
    for s in (t, j):
        s.SwitchToEngine()
    assert not t.can_run_cheaply(circuits(TCircuit, tmat)[0])
    assert not j.can_run_cheaply(circuits(JCircuit, jmat)[0])


# ---------------------------------------------------------------------------
# checkpoint round trips, within the port and across the packages
# ---------------------------------------------------------------------------


def test_routed_checkpoint_roundtrip(tmp_path):
    from qrack_tpu.checkpoint import load_state as jload
    from qrack_tpu.checkpoint import save_state as jsave
    from qrack_tpu_torch.checkpoint import capture, load_state, save_state

    n = 8
    r, jr = _pair(n, 5)
    talg.ghz_qcircuit(n).Run(r)
    jalg.ghz_qcircuit(n).Run(jr)
    before = np.asarray(r.GetQuantumState())
    path = str(tmp_path / "routed.qckpt")
    save_state(r, path)
    assert capture(r)["meta"]["layers"] == ["stabilizer_hybrid", "tpu"]
    for back in (load_state(path, device="cpu"), jload(path)):
        assert back.current_stack() == "stabilizer"
        assert _fidelity(before, back.GetQuantumState()) > 1 - 1e-9
    # a dense routed file crosses both ways and continues alike
    d, jd = _pair(6, 11)
    t_qft(6).Run(d)
    j_qft(6).Run(jd)
    assert d.current_stack() == jd.current_stack() == "dense"
    tpath, jpath = str(tmp_path / "t.qckpt"), str(tmp_path / "j.qckpt")
    save_state(d, tpath)
    jsave(jd, jpath)
    jt = jload(tpath)
    tj = load_state(jpath, device="cpu")
    assert jt._decision.layers == ("tpu",)
    assert tj._decision.layers == ("cuda",)
    assert type(tj._engine).__name__ == "QEngineCUDA"
    for e in (d, jd, jt, tj):
        e.H(4)
        e.CNOT(4, 5)
    want = jd.GetQuantumState()
    for e in (d, jt, tj):
        assert _fidelity(want, e.GetQuantumState()) > 1 - FID_BAR


# ---------------------------------------------------------------------------
# the soak: routed against a dense twin over the fuzz vocabulary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trial", range(3))
def test_routed_vs_dense_fuzz_soak(trial):
    rng = np.random.Generator(np.random.PCG64(90_000 + trial))
    r = qt.create_quantum_interface("route", FUZZ_N, rng=QrackRandom(trial),
                                    rand_global_phase=False, device="cpu")
    d = qt.create_quantum_interface("cuda", FUZZ_N, rng=QrackRandom(trial),
                                    rand_global_phase=False, device="cpu")
    jd = jax_create("tpu", FUZZ_N, rng=JaxRandom(trial),
                    rand_global_phase=False)
    for step in range(30):
        name, args = _ops(rng)
        while name == "SetBit":
            name, args = _ops(rng)
        for e in (r, d, jd):
            getattr(e, name)(*args)
    a = r.GetQuantumState()
    assert _fidelity(d.GetQuantumState(), a) > 1 - FID_BAR
    assert _fidelity(jd.GetQuantumState(), a) > 1 - FID_BAR, \
        (trial, r.current_stack())
