"""Pages in several processes: the port's parallel/cluster.py against
the JAX package's, and the port's pagers, page programs and TurboQuant
pager spread over 2 and 4 processes (gloo on the CPU) against the JAX
package's one-process oracles.

The unit cases call both clusters' functions on the same arguments.
The multi-process cases spawn port workers
(tests/test_torch_cluster_worker.py, torch and the port only) the way
tests/test_multihost.py spawns the JAX ones: a free port, the
``QRACK_*`` environment, a timeout that kills the whole cohort and
fails, and a skip only on the same rendezvous markers.  The JAX oracles
run here, in the parent.  Bars: the JAX multi-host test's (amplitudes
within 3e-5, Prob within 3e-5, fidelity above 1 - 1e-6); against the
port's one-process pager on the same seed, equal (the same arithmetic
runs, so the pages are torch.equal and the reads and draws equal).
"""

import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from qrack_tpu import QEngineCPU as JaxCPU
from qrack_tpu.ops import fusion as jfu
from qrack_tpu.parallel import cluster as jcl
from qrack_tpu.parallel.pager import QPager as JaxPager
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

from qrack_tpu_torch.layers.qunitmulti import QUnitMulti
from qrack_tpu_torch.ops import fusion as fu
from qrack_tpu_torch.ops import sharded as shb
from qrack_tpu_torch.parallel import cluster as tcl
from qrack_tpu_torch.parallel.pager import QPager
from qrack_tpu_torch.utils.rng import QrackRandom

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "test_torch_cluster_worker.py")
ATOL = 3e-5

#: where the port differs from the JAX package on purpose
BY_DESIGN = {
    "QUnitMulti device table": "under a cluster the port lists this "
        "process's cards only (cluster.local_device_ids) and raises on an "
        "id of another process; the JAX package's table is the global "
        "jax.devices(), but a unit cannot be placed on a device its "
        "process cannot address: a unit's ket lives in one process",
    "init_cluster message": "the repeat error names torch.distributed "
        "where the JAX package names jax.distributed",
    "init_cluster backend": "the port takes a backend (nccl on CUDA, gloo "
        "on the CPU, QRACK_DIST_BACKEND); the JAX package selects gloo for "
        "its CPU collectives itself",
}

# the JAX multi-host test's markers of a rendezvous that could not start
_INIT_FAIL_MARKERS = (
    "Address already in use",
    "address already in use",
    "Connection refused",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "failed to connect",
)


def _jax_message(e) -> str:
    return str(e).replace("jax.distributed", "torch.distributed")


# ---------------------------------------------------------------------------
# cluster.py unit cases: both packages on the same arguments
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_clusters(monkeypatch):
    for env in ("QRACK_COORDINATOR", "QRACK_NUM_PROCESSES",
                "QRACK_PROCESS_ID", "QRACK_TPU_DCN_BITS",
                "QRACK_TPU_DCN_WEIGHT"):
        monkeypatch.delenv(env, raising=False)
    for mod in (jcl, tcl):
        monkeypatch.setattr(mod, "_INITIALIZED", False)
        monkeypatch.setattr(mod, "_INIT_ARGS", None)


@pytest.mark.parametrize("kwargs,env,missing", [
    ({"coordinator_address": "127.0.0.1:9999"}, {}, "num_processes"),
    ({"num_processes": 2, "process_id": 0}, {}, "coordinator"),
    ({"coordinator_address": "127.0.0.1:9999"},
     {"QRACK_NUM_PROCESSES": "2"}, "process_id"),
    ({"process_id": 1}, {}, "coordinator_address"),
])
def test_init_cluster_rejects_partial_config(fresh_clusters, monkeypatch,
                                             kwargs, env, missing):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    errors = []
    for mod in (jcl, tcl):
        with pytest.raises(ValueError, match=missing) as e:
            mod.init_cluster(**kwargs)
        errors.append(e.value)
    assert str(errors[1]) == _jax_message(errors[0])
    assert not tcl.is_initialized()


def test_init_cluster_repeat_semantics(fresh_clusters, monkeypatch):
    args = ("127.0.0.1:9999", 2, 0, None)
    for mod in (jcl, tcl):
        monkeypatch.setattr(mod, "_INITIALIZED", True)
        monkeypatch.setattr(mod, "_INIT_ARGS", args)
    monkeypatch.setattr(tcl, "_BACKEND", "gloo")
    errors = []
    for mod in (jcl, tcl):
        # identical repeat: idempotent no-op
        mod.init_cluster(coordinator_address="127.0.0.1:9999",
                         num_processes=2, process_id=0)
        # different args: explicit error, not silent ignore
        with pytest.raises(RuntimeError, match="different arguments") as e:
            mod.init_cluster(coordinator_address="10.0.0.1:1234",
                             num_processes=4, process_id=1)
        errors.append(e.value)
    assert str(errors[1]) == _jax_message(errors[0])
    # a backend other than the one fixed at bring-up is a different
    # configuration too: the wire is never switched
    with pytest.raises(RuntimeError, match="different arguments"):
        tcl.init_cluster(coordinator_address="127.0.0.1:9999",
                         num_processes=2, process_id=0, backend="nccl")


def test_init_cluster_without_configuration_is_a_no_op(fresh_clusters):
    jcl.init_cluster()
    tcl.init_cluster()
    assert not tcl.is_initialized()
    assert tcl.process_count() == 1 and tcl.process_index() == 0
    assert tcl.backend() is None


@pytest.mark.parametrize("pid,ids,card", [(0, None, 0), (5, None, 1),
                                          (3, [2, 3], 2)])
def test_init_cluster_gives_each_rank_its_card(fresh_clusters, monkeypatch,
                                               pid, ids, card):
    """Without local_device_ids a rank takes card process_id %
    device_count() (NCCL refuses two ranks on one card), with them the
    first; the choice is the rank's entry in local_device_ids()."""
    seen, up = {}, []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: seen.setdefault("card", i))
    fake = types.SimpleNamespace(
        is_available=lambda: True, is_initialized=lambda: bool(up),
        init_process_group=lambda **kw: up.append(kw),
        all_gather_object=lambda out, obj: out.__setitem__(
            slice(None), [obj] * len(out)),
        get_rank=lambda: pid, get_world_size=lambda: 8)
    monkeypatch.setattr(tcl, "_dist", lambda: fake)
    monkeypatch.setattr(tcl, "_RANK_DEVICES", None)
    monkeypatch.setattr(tcl, "_BACKEND", None)
    tcl.init_cluster("127.0.0.1:1", 8, pid, ids)
    assert seen["card"] == card and up[0]["backend"] == "nccl"
    assert up[0]["rank"] == pid and up[0]["world_size"] == 8
    assert tcl.local_device_ids() == (ids or [card])


def _layouts():
    """8-page layouts: (ranks of the pages) for 1, 2, 4 and 8 processes,
    contiguous, and one interleaved."""
    out = [tuple(p // (8 // k) for p in range(8)) for k in (1, 2, 4, 8)]
    return out + [tuple(p % 2 for p in range(8))]


@pytest.mark.parametrize("ranks", _layouts())
@pytest.mark.parametrize("dcn_bits", [None, 1, 2])
@pytest.mark.parametrize("weight", [None, "6.5"])
def test_page_bit_kinds_and_weights_match_jax(fresh_clusters, monkeypatch,
                                              ranks, dcn_bits, weight):
    if weight is not None:
        monkeypatch.setenv("QRACK_TPU_DCN_WEIGHT", weight)
    jdevs = [types.SimpleNamespace(process_index=r) for r in ranks]
    homes = [tcl.PageHome(r, torch.device("cpu")) for r in ranks]
    assert tcl.page_bit_kinds(homes) == jcl.page_bit_kinds(jdevs)
    assert tcl.page_bit_weights(homes, dcn_bits) == \
        jcl.page_bit_weights(jdevs, dcn_bits)
    assert tcl.dcn_weight() == jcl.dcn_weight()


def test_page_bit_weights_standin(fresh_clusters, monkeypatch):
    """tests/test_remap.py's case: one process is uniform (None) unless
    the stand-in forces the top bits to DCN pricing, by argument or by
    QRACK_TPU_DCN_BITS; a plain device list is one process."""
    import jax

    jdevs = jax.devices()[:8]
    devs = [torch.device("cpu")] * 8
    assert tcl.page_bit_weights(devs) is None is jcl.page_bit_weights(jdevs)
    w = tcl.page_bit_weights(devs, dcn_bits=1)
    assert w == jcl.page_bit_weights(jdevs, dcn_bits=1)
    assert w[2] == tcl.dcn_weight() and w[0] == w[1] == 1.0
    assert tcl.page_bit_kinds(devs) == ("ici",) * 3
    monkeypatch.setenv("QRACK_TPU_DCN_BITS", "2")
    assert tcl.page_bit_weights(devs) == jcl.page_bit_weights(jdevs)


def test_global_page_devices_without_a_cluster(fresh_clusters):
    homes = tcl.global_page_devices(8, device="cpu")
    assert [h.rank for h in homes] == [0] * 8
    assert tcl.page_bit_kinds(homes) == ("ici",) * 3
    q = QPager(6, devices=homes, rand_global_phase=False)
    assert q.n_pages == 8 and not shb.spread(q._pages_raw)
    assert not q._on_cluster
    q.H(5)
    assert abs(q.Prob(5) - 0.5) < 1e-6


def test_pager_dcn_bits_plans_like_jax():
    """tests/test_remap.py::test_plan_remaps_dcn_weights_prefer_ici
    through both pagers' _exchange_weights: the same weights, the same
    planned swaps, and a remap-on circuit that lands on the same table
    and ket."""
    n, L = 6, 4
    jp = JaxPager(n, rng=JaxRandom(5), rand_global_phase=False, n_pages=4,
                  remap="on", dcn_bits=1)
    tp = QPager(n, rng=QrackRandom(5), rand_global_phase=False, n_pages=4,
                remap="on", dcn_bits=1, device="cpu")
    assert tp._exchange_weights == jp._exchange_weights == (1.0, 4.0)
    eye = np.eye(2, dtype=np.complex128)
    look = [("gen", q) for q in range(L)]
    got = fu.plan_remaps([fu.FusedOp("gen", 5, 0, 0, eye)], L,
                         list(range(n)), look,
                         weights=tp._exchange_weights, batched=True)
    want = jfu.plan_remaps([jfu.FusedOp("gen", 5, 0, 0, eye)], L,
                           list(range(n)), look,
                           weights=jp._exchange_weights, batched=True)
    assert got == want and got[0] == ((4, 5),)
    rng = np.random.default_rng(17)
    for _ in range(40):
        t = int(rng.integers(0, n))
        c = int(rng.integers(0, n))
        for q in (jp, tp):
            q.RY(0.3 + t, t)
            if c != t:
                q.CNOT(c, t)
            q.H(n - 1 - t)
    assert tp.GetQuantumState().shape == (1 << n,)
    np.testing.assert_allclose(tp.GetQuantumState(), jp.GetQuantumState(),
                               atol=ATOL)
    assert list(tp._qmap) == list(jp._qmap)


def test_pager_passes_exchange_weights(monkeypatch):
    """Every flush hands the planner the pager's _exchange_weights (a
    one-process pager prices its bits uniformly unless dcn_bits says
    otherwise)."""
    seen = []
    real = fu.plan_remaps

    def spy(*args, **kwargs):
        seen.append(kwargs.get("weights"))
        return real(*args, **kwargs)

    monkeypatch.setattr(fu, "plan_remaps", spy)
    for dcn_bits, want in ((None, None), (2, (1.0, 4.0, 4.0))):
        seen.clear()
        q = QPager(7, rand_global_phase=False, n_pages=8, remap="on",
                   dcn_bits=dcn_bits, device="cpu")
        q.H(6)
        q.CNOT(6, 0)
        q.H(5)
        q.Prob(0)
        assert seen and all(w == want for w in seen), (seen, want)


def test_remote_page_refuses_tensor_use():
    page = shb.RemotePage(1, (2, 8), torch.float32)
    assert page.shape == (2, 8) and page.dtype == torch.float32
    assert shb.is_remote(page) and shb._page_bytes(page) == 64
    with pytest.raises(RuntimeError, match="process 1"):
        page.view(2, 2, 4)
    with pytest.raises(RuntimeError, match="process 1"):
        page[0, 1]
    with pytest.raises(RuntimeError, match="process 1"):
        page[0, 1] = 1.0
    with pytest.raises(RuntimeError, match="process 1"):
        page.device
    with pytest.raises(TypeError):
        torch.zeros_like(page)


def test_qunitmulti_without_a_cluster_takes_any_id(fresh_clusters):
    u = QUnitMulti(3, device="cpu", device_ids=[5, 7])
    assert u.GetDeviceList() == [5, 7]


# ---------------------------------------------------------------------------
# multi-process cohorts
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_cohort(case, n_procs, timeout=120, extra_env=None):
    """Launch n_procs port workers of `case` wired to one coordinator and
    return their parsed RESULT dicts (rank order).  A worker crash that
    smells of a rendezvous failure skips; a timeout kills the whole
    cohort and fails."""
    import json

    port = _free_port()
    procs = []
    for pid in range(n_procs):
        env = dict(
            os.environ,
            QRACK_COORDINATOR=f"localhost:{port}",
            QRACK_NUM_PROCESSES=str(n_procs),
            QRACK_PROCESS_ID=str(pid),
            # this rank's (nominal) cards: QUnitMulti's table
            QRACK_WORKER_LOCAL_IDS=f"{2 * pid},{2 * pid + 1}",
        )
        env.pop("QRACK_TPU_RESILIENCE", None)
        env.pop("QRACK_TPU_FAULTS", None)
        if extra_env:
            env.update(extra_env)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, case], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                pytest.fail(f"cluster worker timed out after {timeout}s "
                            "(rendezvous or a collective wedged?)")
            if p.returncode != 0:
                if any(m in err for m in _INIT_FAIL_MARKERS):
                    pytest.skip("cluster bring-up unavailable here: "
                                + err.strip().splitlines()[-1][:200])
                assert False, f"worker failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line in worker output:\n{out[-2000:]}"
        results.append(json.loads(lines[0][len("RESULT "):]))
    return results


@pytest.fixture(scope="module")
def circuit_cohorts():
    """The circuit case over 2 and 4 processes, run once for the tests
    that read it."""
    return {n: _run_cohort("circuit", n) for n in (2, 4)}


def _oracle_state_and_prob():
    """tests/test_multihost.py's oracle: the same circuit on the JAX
    package's QEngineCPU."""
    q = JaxCPU(7, rng=JaxRandom(777), rand_global_phase=False)
    q.SetPermutation(0)
    for i in range(7):
        q.H(i)
    for i in range(6):
        q.CNOT(i, i + 1)
    q.CZ(4, 6)
    q.Swap(0, 5)
    q.T(6)
    q.H(6)
    return q.GetQuantumState(), q.Prob(3)


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_matches_jax(circuit_cohorts, n_procs):
    import jax

    from qrack_tpu.models import qft as jqft
    from qrack_tpu.ops import gatekernels as jgk

    results = circuit_cohorts[n_procs]
    ref_state, ref_p3 = _oracle_state_and_prob()
    ref_qft = jgk.from_planes(
        jax.jit(jqft.make_qft_fn(7))(jqft.basis_planes(7, 5)))
    assert [r["proc"] for r in results] == list(range(n_procs))
    for r in results:
        assert r["procs"] == n_procs and r["backend"] == "gloo"
        got = np.asarray(r["re"]) + 1j * np.asarray(r["im"])
        np.testing.assert_allclose(got, ref_state, atol=ATOL)
        assert abs(r["prob3"] - ref_p3) < ATOL
        got_qft = np.asarray(r["qft_re"]) + 1j * np.asarray(r["qft_im"])
        np.testing.assert_allclose(got_qft, ref_qft, atol=ATOL)
        assert abs(r["rcs_norm"] - 1.0) < 1e-3
        assert r["grover_p_target"] > 0.9
        assert abs(r["tq_prob3"] - 0.5) < 1e-3
        assert abs(r["tq_prob6"] - 0.5) < 1e-3
        assert abs(r["tq_amp0_abs"] - 2 ** -3.5) < 1e-3
        # blocks crossed processes
        assert r["wire_bytes"] > 0
    # the draws agree across processes
    assert len({r["mall"] for r in results}) == 1
    assert len({r["tq_mall"] for r in results}) == 1


@pytest.mark.parametrize("n_procs", [2, 4])
def test_cluster_equals_one_process(circuit_cohorts, n_procs):
    """The same arithmetic as the port's one-process pager on the same
    seed (its planner priced alike): pages torch.equal, the table, the
    reads, the programs, the TurboQuant codes and the draws equal; so
    are the ring gathers, compose_ring, the reductions and a collapse
    (the worker's _extras)."""
    for r in circuit_cohorts[n_procs]:
        assert r["pages_equal_one_process"], r["pages_max_diff"]
        assert r["qmap_equal_one_process"]
        assert r["state_equal_one_process"]
        assert r["mall"] == r["mall_one_process"]
        assert r["programs_equal_one_process"]
        assert r["tq_equal_one_process"]
        assert r["tq_mall"] == r["tq_mall_one_process"]
        extras = r["extras_equal_one_process"]
        assert all(extras.values()), extras


def test_cluster_refusals_and_qunitmulti(circuit_cohorts):
    """The five paths that refused on a pager over several processes
    until ROADMAP item 13.5 now run, each equal to the one-process
    pager's; QUnitMulti's table under a cluster as before."""
    for r in circuit_cohorts[2]:
        ref = r["five_paths"]
        for what in ("compose", "decompose", "dispose", "shrink",
                     "resilience"):
            assert ref[what] is True, (what, ref[what])
        rank = r["proc"]
        assert ref["unit_multi_devices"] == [2 * rank, 2 * rank + 1]
        assert "a unit's ket lives in one process" in \
            ref["unit_multi_foreign"]


def _jax_qft_circuit(n):
    from qrack_tpu.layers.qcircuit import QCircuit as JaxCircuit

    h = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
    c = JaxCircuit(n)
    for i in range(n):
        hq = n - 1 - i
        for j in range(i):
            ph = np.exp(1j * np.pi / 2.0 ** (i - j))
            c.append_ctrl([hq + 1 + j], hq,
                          np.diag([1.0, ph]).astype(np.complex128), 1)
        c.append_1q(hq, h)
    return c


def test_cluster_pager_w20_qft(tmp_path):
    """tests/test_multihost.py::test_multihost_pager_w20_qft on the port:
    a remap-on w20 QFT over 8 pages in 2 processes (the top page bit
    crosses them), the per-page window kernel's lowering, batched
    prologues over the wire, and a checkpoint that round-trips bit for
    bit on every process and loads into a one-process pager."""
    results = _run_cohort(
        "pager_w20", 2, timeout=180,
        extra_env={"QRACK_CKPT_DIR": str(tmp_path),
                   "QRACK_TPU_FUSE_WINDOW": "16",
                   "QRACK_TPU_FUSE_KERNEL": "on"})
    n = 20
    o = JaxCPU(n, rng=JaxRandom(99), rand_global_phase=False)
    o.SetPermutation(0b1011)
    _jax_qft_circuit(n).Run(o)
    ref = np.asarray(o.GetQuantumState())
    ref_p3 = o.Prob(3)
    for r in results:
        assert r["procs"] == 2
        assert r["kinds"] == ["ici", "ici", "dcn"]
        got = np.load(tmp_path / f"state.p{r['proc']}.npy")
        fid = float(abs(np.vdot(ref, got)) ** 2
                    / (np.vdot(ref, ref).real * np.vdot(got, got).real))
        assert fid > 1 - 1e-6, fid
        assert abs(r["prob3"] - ref_p3) < ATOL
        assert r["remap_batched"] >= 1 and r["remap_pairs"] >= 2
        assert r["exchange_bytes"] > 0 and r["collective_bytes"] > 0
        assert r["wire_bytes"] > 0
        # the windows took the per-page kernel lowering on this rank's
        # pages (the CPU runs its plain version)
        assert r["flushes"]["kernel_windows"] >= 1
        assert r["flushes"]["predicted_launches"] > 0
        assert r["pages_equal_one_process"], r["pages_max_diff"]
        assert r["restore_identical"] and r["restore_pages_identical"]
        assert r["restore_qmap_ok"]
        assert r["one_process_load_identical"]
    assert results[0]["prob3"] == results[1]["prob3"]
