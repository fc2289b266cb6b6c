"""Re-paging, failover and the resilience plane on a pager whose pages
live in several processes (ROADMAP item 13.5): the port's pager over the
cluster's page homes, in gloo cohorts of 2 and 4 processes on the CPU
(tests/test_torch_cluster_worker.py ``resilience``), against the JAX
package's one-process pager with the same fault spec, run here in the
parent, and against the port's one-process pager with the same seed and
spec, run beside it in each worker.

Bars: against the JAX package, the kets within 3e-5 and the resilience,
integrity and elastic counters and events name for name (after the one
rename, ``tpu`` -> ``cuda``), but for the BY_DESIGN entries below;
against the port's one-process pager, this rank's pages torch.equal, the
table, the ket, the reads, the draws and the families equal (the worker
reports ``twin_equal``).  Every rank takes the same decision: the
families of every rank are equal, but for the records of the rank where
a fault fired alone (``LOCAL``).

The mirrored one-process cases are tests/test_torch_resilience.py's
``test_pager_shrink_midcircuit_matrix`` (windows 1 and 16) and
``test_pager_staircase_descends_through_shrink`` and
tests/test_torch_integrity.py's ``test_quarantine_feeds_elastic_repage``
(here with its spare slot in another process), at w12 on 4 pages.  The
cases with no one-process twin: a fault on one rank only (``raise``,
``hang`` under a 0.5 s watchdog, ``device-loss``, an ``amp-corrupt``
pinned to a page of the last rank; the last rank's process loads its own
``QRACK_TPU_FAULTS``), Compose/Decompose/Dispose/Allocate across a page
count change, the out-of-place ALU scatter, and the TurboQuant pager
armed, on its dense plane, narrowed and failed over.
"""

import os

import numpy as np
import pytest

import test_torch_cluster_worker as W
from qrack_tpu import QEngineCPU as JCPU
from qrack_tpu.resilience import integrity as jinteg
from qrack_tpu.utils.rng import QrackRandom as JR
from test_torch_cluster import ATOL, _run_cohort
from test_torch_resilience import (SIDES, _clean_resilience,  # noqa: F401
                                   _counters, _events, _reset_both)

from qrack_tpu_torch.resilience import failover as tfailover

#: where a pager over several processes differs from the JAX package's
#: one-process pager on purpose (and from the port's one-process pager,
#: where a rank counts what it alone did)
BY_DESIGN = {
    "dense replica on each rank": tfailover.BY_DESIGN[
        "dense replica on each rank"],
    "agreed breaker": "each rank's breaker records the outcome the ranks "
        "agreed on (resilience/dispatch.py cohort), and its gate is part "
        "of the entry agreement: every rank refuses while any rank's "
        "breaker is open and cooling down (CircuitBreaker.reject), also "
        "one that a replica's dispatch tripped alone; the JAX package's "
        "breaker is one process's, fed by its one program",
    "agreed probe": "the elastic health probe is agreed (every rank "
        "healthy before any rank expands): a fault spec or a breaker read "
        "on one rank must not split the cohort's topology",
    "per-rank exchange counters": "each rank counts the passes, re-pages "
        "and gathers of its own pages and the bytes it sent "
        "(sharded.EXCHANGES, exchange.pager.*), as the one-process "
        "pager counts its passes; a one-process re-page or gather moves "
        "nothing between processes and counts nothing, as in the JAX "
        "pager",
    "persist file from rank 0": tfailover.BY_DESIGN[
        "persist file from rank 0"],
    "fault records of the faulting rank": "resilience.fault.*, "
        "resilience.timeout.* and resilience.abandoned_threads are "
        "recorded by the rank where the fault fired (worker LOCAL); the "
        "decision that follows is every rank's",
    "host_fetch": "as tests/test_torch_resilience.py's on_card_shrink: "
        "the re-page runs on the card, with no host snapshot",
}

SKIP = ("host_fetch",)


def _keep(name: str) -> bool:
    return not any(s in name for s in SKIP)


def _no_local(fam) -> dict:
    """The families without what only a faulting rank records."""
    return {"counters": {k: v for k, v in fam["counters"].items()
                         if not k.startswith(W.LOCAL)},
            "events": [e for e in fam["events"]
                       if not e.startswith(W.LOCAL)]}


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """The resilience case over 2 and 4 processes, run once: {processes:
    (RESULT dicts in rank order, the directory of their kets)}."""
    out = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"resilience{n}")
        out[n] = (_run_cohort("resilience", n, timeout=240,
                              extra_env={"QRACK_RESULT_DIR": str(d)}), d)
    return out


def _ket(cohorts, n_procs, name, rank):
    return np.load(cohorts[n_procs][1] / f"{name}.p{rank}.npy")


def _jax_side(run, env=None):
    """run(side) on the JAX package's plane, armed from clean: (ket,
    families renamed)."""
    side = SIDES[0]
    _reset_both()
    jinteg.reset()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        side.arm()
        ket = run(side)
        fam = {"counters": {k: v for k, v in _counters(side.tele).items()
                            if _keep(k)},
               "events": [e for e in _events(side.tele) if _keep(e)]}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _reset_both()
        jinteg.reset()
    return ket, fam


def _filtered(fam) -> dict:
    return {"counters": {k: v for k, v in fam["counters"].items()
                         if _keep(k)},
            "events": [e for e in fam["events"] if _keep(e)]}


def _hold(cohorts, n_procs, name, ref_ket, ref_fam=None, local=False):
    """Every rank of `name`: twin_equal, the ket within ATOL of the JAX
    one, and the families the JAX package's (without the faulting
    rank's own records where `local`); every rank's families equal."""
    results = cohorts[n_procs][0]
    fams = []
    for r in results:
        got = r[name]
        assert got["twin_equal"], (name, r["proc"])
        ket = _ket(cohorts, n_procs, name, r["proc"])
        np.testing.assert_allclose(ket, ref_ket, atol=ATOL)
        fam = _filtered(got["fam"])
        if ref_fam is not None:
            want = _no_local(ref_fam) if local else ref_fam
            assert (_no_local(fam) if local else fam) == want, (name,
                                                               r["proc"])
        fams.append(_no_local(fam))
    assert all(f == fams[0] for f in fams), name
    return [r[name] for r in results]


@pytest.mark.parametrize("n_procs", [2, 4])
@pytest.mark.parametrize("window", [1, 16])
@pytest.mark.parametrize("circ", ["fuzz", "qft", "rcs"])
def test_cluster_pager_shrink_midcircuit_matrix(cohorts, n_procs, circ,
                                                window):
    """test_pager_shrink_midcircuit_matrix over page homes: a flap at
    every site mid-circuit shrinks every rank's pager 4 -> 2 pages (onto
    rank 0's slots) and the next call boundary grows it back over the
    ranks."""
    ops = W.res_circuits(W.RW)[circ]
    cut = len(ops) // 2

    def run(side):
        q = side.make("pager", n=W.RW, n_pages=W.RG, rng=side.R(3),
                      rand_global_phase=False)
        W._apply(q, ops[:cut])
        side.faults.inject("*", "flap", after_n=0, times=1)
        W._apply(q, ops[cut:])
        q.GetAmplitude(0)
        q.Prob(0)
        o = side.CPU(W.RW, rng=side.R(3), rand_global_phase=False)
        W._apply(o, ops)
        ket = side.state(q)
        assert abs(np.vdot(o.GetQuantumState(), ket)) ** 2 > 1 - 1e-6
        return ket

    ket, fam = _jax_side(run, env={"QRACK_TPU_FUSE_WINDOW": str(window)})
    assert fam["counters"].get("elastic.repage.shrink", 0) >= 1
    for got in _hold(cohorts, n_procs, f"matrix_{circ}_{window}", ket, fam):
        assert got["kind"] == "QPager" and got["pages_now"] == W.RG
        assert not got["degraded"]


@pytest.mark.parametrize("n_procs", [2, 4])
@pytest.mark.parametrize("cpu", [False, True])
def test_cluster_pager_staircase_to_dense_replicas(cohorts, n_procs, cpu):
    """test_pager_staircase_descends_through_shrink over page homes: a
    persistent device loss takes every rank 4 -> 2 -> 1 pages, then to a
    QEngineCUDA replica of the whole ket on each rank (no CPU engine
    built, with or without the CPU rung named), whose draws agree."""
    def run(side):
        q = side.make("pager", n=W.RW, n_pages=W.RG, rng=side.R(3),
                      rand_global_phase=False, cpu=cpu)
        W._apply(q, W.PREFIX)
        side.faults.inject("pager.dispatch", "device-loss", after_n=0,
                           times=None)
        W._apply(q, W.SUFFIX)
        q.GetAmplitude(0)
        return side.state(q)

    ket, fam = _jax_side(run)
    assert fam["events"][-1] == "resilience.failover.pager_to_cuda"
    assert fam["counters"].get("elastic.repage.shrink", 0) >= 2
    got = _hold(cohorts, n_procs, f"staircase_{int(cpu)}", ket, fam)
    for g in got:
        assert g["kind"] == "QEngineCUDA" and g["cpu_built"] == 0
    assert len({tuple(g["draws"]) for g in got}) == 1


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_pager_cpu_rung_behind_an_agreed_open_breaker(cohorts,
                                                              n_procs):
    """With the breaker tripping at the first failure, every rank's
    agreed breaker refuses the shrunk pagers' replays and the dense rung
    (the breaker is open), and with failover_cpu=True every rank lands
    on a QEngineCPU of the replicated ket, as the JAX package's pager
    does with the same spec and threshold."""
    def run(side):
        side.res.reset_breaker()
        q = side.make("pager", n=W.RW, n_pages=W.RG, rng=side.R(3),
                      rand_global_phase=False, cpu=True)
        W._apply(q, W.PREFIX)
        side.faults.inject("pager.dispatch", "device-loss", after_n=0,
                           times=None)
        W._apply(q, W.SUFFIX)
        assert type(q.engine).__name__ == "QEngineCPU"
        return side.state(q)

    ket, fam = _jax_side(run, env={"QRACK_TPU_BREAKER_THRESHOLD": "1"})
    got = _hold(cohorts, n_procs, "cpu_rung", ket, fam)
    for g in got:
        assert g["kind"] == "QEngineCPU" and g["breaker"] == "open"
    assert len({tuple(g["draws"]) for g in got}) == 1


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_hybrid_fails_over_and_unpins(cohorts, n_procs):
    """QHybrid over page homes: the pager fails over in place to a dense
    replica on each rank (ceiling "cuda"), and the agreed un-pin probe
    rebuilds a pager over the homes once the faults clear; the ket at
    3e-5 of the JAX QEngineCPU's."""
    o = JCPU(W.RW, rng=JR(3), rand_global_phase=False)
    W._apply(o, W.PREFIX + W.SUFFIX + [("X", (4,)), ("X", (4,))])
    ref = np.asarray(o.GetQuantumState())
    got = _hold(cohorts, n_procs, "hybrid", ref)
    for g in got:
        assert (g["first"], g["pinned"], g["kind"], g["back"]) == (
            "QPager", "cuda", "QEngineCUDA", "QPager")


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_failover_persist_writes_one_file_a_move(cohorts, n_procs):
    """QRACK_TPU_FAILOVER_PERSIST over page homes: one file a failover
    move for the whole cohort, written by rank 0 from the replicated
    capture, each loading to the ket the one-process pager's file of the
    same move holds."""
    from qrack_tpu_torch.checkpoint import load_state

    def files(d):
        # failover-<time>-<pid>-<seq>.qckpt, in the order written
        names = [f for f in os.listdir(d) if f.endswith(".qckpt")]
        return [os.path.join(d, f) for f in sorted(
            names, key=lambda f: int(f.rsplit("-", 1)[1].split(".")[0]))]

    results = cohorts[n_procs][0]
    assert all(r["persist"]["kind"] == "QEngineCUDA" for r in results)
    spread = files(results[0]["persist"]["dirs"]["spread"])
    assert len({r["persist"]["dirs"]["spread"] for r in results}) == 1
    for r in results:
        twin = files(r["persist"]["dirs"]["twin"])
        # the moves 4 -> 2 -> 1 page -> the dense engine
        assert len(twin) == len(spread) == 3
        for a, b in zip(spread, twin):
            ka = load_state(a, device="cpu").GetQuantumState()
            kb = load_state(b, device="cpu").GetQuantumState()
            np.testing.assert_array_equal(ka, kb)


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_quarantine_repages_onto_another_rank(cohorts, n_procs,
                                                      monkeypatch):
    """test_quarantine_feeds_elastic_repage over page homes: three
    strikes on slot 2 (every rank attributes the same slot) quarantine
    it, and the call-boundary probe re-pages onto spare slot 4, which
    lives in another process."""
    monkeypatch.setenv("QRACK_TPU_QUARANTINE_STRIKES", "3")

    def run(side):
        q = side.make("pager", n=W.RW, n_pages=W.RG, remap="off",
                      rng=side.R(3), rand_global_phase=False)
        for k in range(3):
            side.faults.inject("pager.exchange", "amp-corrupt", after_n=0,
                               times=1, page=2, n_pages=W.RG)
            q.H(W.RW - 1 if k % 2 else W.RW - 2)
            q.Prob(0)
            side.faults.clear()
        q.engine.maybe_reexpand()
        assert list(q.engine.GetDeviceList()) == [0, 1, 3, 4]
        q.CNOT(0, 1)
        q.H(W.RW - 1)
        q.Prob(0)
        return side.state(q)

    ket, fam = _jax_side(run)
    for g in _hold(cohorts, n_procs, "quarantine", ket, fam):
        assert g["strikes"] == {"2": 3} and g["quarantined"] == [2]
        assert g["before"] == [0, 1, 2, 3] and g["after"] == [0, 1, 3, 4]
        # slot 4, the spare that took slot 2's page, is another rank's
        per = 2 * W.RG // n_procs
        assert g["after_ranks"] == [s // per for s in (0, 1, 3, 4)]
        assert g["after_ranks"][-1] != 0


@pytest.mark.parametrize("n_procs", [2, 4])
@pytest.mark.parametrize("kind", sorted(W.ONE_RANK))
def test_cluster_fault_on_one_rank_one_decision(cohorts, n_procs, kind):
    """A fault armed on the last rank only: every rank takes the JAX
    one-process pager's decision with the same spec (a retry for raise
    and hang, a shrink and re-expand for device-loss, a replay and a
    strike on the struck page's slot for amp-corrupt), with no deadlock:
    a hang costs the other ranks the watchdog's 0.5 s in the
    agreement, no more."""
    def run(side):
        if kind == "hang":
            side.res.configure(timeout_s=0.5)
        q = side.make("pager", n=W.RW, n_pages=W.RG, remap="off",
                      rng=side.R(3), rand_global_phase=False)
        W._apply(q, W.PREFIX)
        q.Prob(0)
        if W.ONE_RANK[kind] is None:
            side.faults.inject("pager.exchange", "amp-corrupt", after_n=0,
                               times=1, page=W.RG - 1, n_pages=W.RG)
        else:
            side.faults.load_env(W.ONE_RANK[kind])
        q.H(W.RW - 1)
        q.Prob(0)
        side.faults.clear()
        W._apply(q, W.SUFFIX)
        q.Prob(0)
        return side.state(q)

    ket, fam = _jax_side(run, env={"QRACK_TPU_FUSE_WINDOW": "1"})
    got = _hold(cohorts, n_procs, f"one_rank_{kind}", ket, fam, local=True)
    last = cohorts[n_procs][0][-1][f"one_rank_{kind}"]["fam"]
    # the faulting rank recorded the injection itself
    assert any(e.startswith("resilience.fault.")
               for e in last["counters"]) or kind == "amp-corrupt"
    for g in got:
        assert g["kind"] == "QPager" and g["pages_now"] == W.RG
        if kind == "amp-corrupt":
            assert g["strikes"] == {str(W.RG - 1): 1}
        if kind == "hang":
            assert g["fault_wall_s"] < 10.0


def _jax_structure():
    """The worker's structural sequence on the JAX package's QEngineCPU."""
    o = JCPU(W.SW, rng=JR(5), rand_global_phase=False)
    sides = []
    for k, (w, ops) in enumerate(W.STRUCT_SIDES):
        s = JCPU(w, rng=JR(6 + k), rand_global_phase=False)
        W._apply(s, ops)
        sides.append(s)
    for name, args in W.structure_ops():
        args = tuple(sides[int(a[1:])] if isinstance(a, str) else a
                     for a in args)
        getattr(o, name)(*args)
    return np.asarray(o.GetQuantumState()), sides[0].GetQuantumState()


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_structure_across_page_count_changes(cohorts, n_procs):
    """Compose, Decompose, Dispose and Allocate over page homes, down to
    one qubit (4 -> 2 pages) and back (2 -> 4), composing a pager over
    the page homes and one of one process: equal to the one-process
    pager, and to the JAX package's QEngineCPU within 3e-5."""
    ket, b0 = _jax_structure()
    for r in cohorts[n_procs][0]:
        got = r["structure"]
        assert got["twin_equal"]
        assert 2 in got["widths_pages"] and got["widths_pages"][-1] == 4
        np.testing.assert_allclose(_ket(cohorts, n_procs, "structure",
                                        r["proc"]), ket, atol=ATOL)
        b = np.asarray(got["b0"]) @ np.array([1.0, 1j])
        assert abs(np.vdot(b0, b)) ** 2 > 1 - 1e-6
    assert len({r["structure"]["draw"] for r in cohorts[n_procs][0]}) == 1


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_out_of_place_alu_scatter(cohorts, n_procs):
    """MUL, MULModNOut, DIV and CMUL below 32 qubits scatter out of place
    over page homes from the old ket gathered onto every rank: equal to
    the one-process pager, and to the JAX QEngineCPU within 3e-5."""
    o = JCPU(W.RW, rng=JR(8), rand_global_phase=False)
    W._apply(o, W.alu_ops())
    ref = np.asarray(o.GetQuantumState())
    for r in cohorts[n_procs][0]:
        assert r["alu"]["twin_equal"]
        np.testing.assert_allclose(_ket(cohorts, n_procs, "alu", r["proc"]),
                                   ref, atol=ATOL)
    assert all(r["exchanges"]["gather"] > 0 for r in cohorts[n_procs][0])


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_turboquant_pager_armed_narrowed_dense(cohorts, n_procs):
    """The TurboQuant pager over page homes: a pair exchange that raises
    on the last rank only is retried on every rank, the dense float32
    plane (an INC, a Compose) and a narrowing below one chunk a page run
    over the ranks with the codes equal to the one-process pager's, and
    a persistent device loss fails every rank over to a QEngineCUDA
    replica whose draws agree."""
    results = cohorts[n_procs][0]
    fams = []
    for r in results:
        got = r["tq"]
        assert got["twin_equal"]
        assert got["kind"] == "QEngineCUDA" and got["narrowed_pages"] == 2
        fam = _no_local(got["fam"])
        assert fam["counters"]["resilience.retry.turboquant_pager."
                               "exchange"] == 1
        assert fam["events"][-1] == \
            "resilience.failover.turboquant_pager_to_cuda"
        fams.append(fam)
        ket = _ket(cohorts, n_procs, "tq", r["proc"])
        assert abs(float(np.vdot(ket, ket).real) - 1.0) < 1e-2
    assert all(f == fams[0] for f in fams)
    assert len({tuple(r["tq"]["draws"]) for r in results}) == 1
    kets = [_ket(cohorts, n_procs, "tq", r["proc"]) for r in results]
    assert all(np.array_equal(k, kets[0]) for k in kets)


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_agreements_and_moves_are_counted(cohorts, n_procs):
    """Every rank ran the same number of agreements, and the re-pages
    and gathers moved blocks between processes through the transport."""
    results = cohorts[n_procs][0]
    assert len({r["agreements"]["calls"] for r in results}) == 1
    assert results[0]["agreements"]["calls"] > 0
    for r in results:
        assert r["world"] == n_procs
        assert r["exchanges"]["repage"] > 0 and r["exchanges"]["gather"] > 0
        assert r["exchanges"]["wire_bytes"] > 0


@pytest.mark.parametrize("n_procs", [2, 4])
def test_a_fault_after_entry_on_one_rank_gives_up_torn_everywhere(
        cohorts, n_procs):
    """A device error on the last rank only, raised inside the pass
    before it writes, while every other rank's pass wrote in place:
    every rank gives up torn after one attempt (no rank applies the
    pass twice)."""
    for r in cohorts[n_procs][0]:
        got = r["late_fault"]
        assert got["outcome"] == "give_up torn=True"
        assert got["calls"] == 1
        assert got["value"] == (0.0 if r["proc"] == n_procs - 1 else 1.0)


@pytest.mark.parametrize("n_procs", [2, 4])
def test_one_rank_s_open_breaker_refuses_on_every_rank(cohorts, n_procs):
    """The last rank's breaker alone tripped outside the cohort: the
    cohort's dispatch is refused on every rank while it cools down (no
    rank enters the pass), then runs on every rank, which closes it."""
    for r in cohorts[n_procs][0]:
        got = r["breaker_split"]
        assert got["got"] == ["open", 7]
        assert got["states"] == (["open", "open", "closed"]
                                 if r["proc"] == n_procs - 1 else
                                 ["closed"] * 3)


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_pager_on_a_prefix_of_the_slots(cohorts, n_procs):
    """A pager whose pages fill a prefix of the page homes (with 2
    processes every page on rank 0, the other rank none): the fault
    ROADMAP §C records for the pager over page homes as first ported,
    where the rank holding no page raised ValueError at its first
    window (QPager.device) and the rank holding every page skipped the
    all-reduces of its reads (sharded.spread was False there).  Now
    every rank joins (sharded.PageList): reads, draws and pages equal
    the one-process pager's, the ket the JAX QEngineCPU's within
    3e-5."""
    o = JCPU(W.RW, rng=JR(12), rand_global_phase=False)
    W._apply(o, W.res_circuits(W.RW)["rcs"])
    ref = np.asarray(o.GetQuantumState())
    results = cohorts[n_procs][0]
    for r in results:
        assert r["prefix"]["twin_equal"]
        np.testing.assert_allclose(_ket(cohorts, n_procs, "prefix",
                                        r["proc"]), ref, atol=ATOL)
    assert len({_reads_key(r["prefix"]) for r in results}) == 1


def _reads_key(got) -> str:
    import json

    return json.dumps([got["reads"], got["draw"]])


# ---------------------------------------------------------------------------
# the agreement's pieces in one process
# ---------------------------------------------------------------------------

def test_agree_without_a_cluster_returns_the_values():
    from qrack_tpu_torch.parallel import cluster

    assert cluster.agree([3, 0, 7]) == [3, 0, 7]
    assert cluster.agree([3, 0, 7], op="min") == [3, 0, 7]
    assert cluster.agree_all(True) and not cluster.agree_all(False)


def test_cohort_dispatch_refuses_a_watchdog_past_the_agreement():
    """A cohort's agreement must outlast the watchdog: a rank whose pass
    hangs joins it only once its watchdog fired."""
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch.parallel import cluster
    from qrack_tpu_torch.resilience import dispatch as rdispatch

    res.configure(timeout_s=cluster.AGREE_TIMEOUT_S + 1.0)
    with pytest.raises(ValueError, match="agreement timeout"):
        rdispatch.call_guarded("pager.dispatch", lambda: 1, cohort=True)
    res.configure(timeout_s=0.0)
    assert rdispatch.call_guarded("pager.dispatch", lambda: 1,
                                  cohort=True) == 1


def test_breaker_reject_refuses_without_a_transition():
    """CircuitBreaker.reject refuses as an open breaker does and leaves
    its state: the ranks refuse together while any rank cools down."""
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.resilience.breaker import CircuitBreaker

    now = [0.0]
    br = res.reset_breaker(CircuitBreaker(threshold=1, cooldown_s=5.0,
                                          clock=lambda: now[0]))
    tele.enable()
    try:
        br.record_failure("pager.exchange")
        assert br.state == "open"
        now[0] = 10.0            # cooled down here, but not on a peer
        with pytest.raises(res.BreakerOpen):
            br.reject("pager.exchange")
        assert br.state == "open"
        assert tele.snapshot()["counters"]["resilience.breaker.rejected"] == 1
        br.allow("pager.exchange")
        assert br.state == "half_open"
    finally:
        tele.disable()
        tele.reset()
