"""One process of a multi-process run of the port's pagers (see
tests/test_torch_cluster.py).  No test functions: run as

    QRACK_COORDINATOR=localhost:<port> QRACK_NUM_PROCESSES=<n> \\
    QRACK_PROCESS_ID=<rank> python tests/test_torch_cluster_worker.py <case>

with ``<case>`` ``circuit`` (a w7 QPager of 8 pages, the page-list
programs, the TurboQuant pager and the five paths that re-page or
change the page count), ``pager_w20`` (the remap-on w20 QFT and its
checkpoint) or ``resilience`` (the resilience plane, re-paging,
failover and the structural ops over page homes, each case against its
one-process twin in the same process; kets saved under
``QRACK_RESULT_DIR``).  Brings the process group up on
gloo through qrack_tpu_torch.parallel.cluster, runs the case on pages
spread over every process, and prints one ``RESULT {json}`` line for the
parent, which holds it against the JAX package.  Imports torch and the
port only.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qrack_tpu_torch.parallel import cluster  # noqa: E402

H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)


def _circuit(q, n: int) -> None:
    """The JAX multi-host worker's circuit (tests/multihost_worker.py)."""
    q.SetPermutation(0)
    for i in range(n):
        q.H(i)
    for i in range(n - 1):
        q.CNOT(i, i + 1)        # crosses local->paged at the boundary
    q.CZ(4, 6)                  # paged-paged diagonal
    q.Swap(0, 5)                # mixed local/paged swap
    q.T(6)                      # paged diagonal
    q.H(6)                      # paged target: the pair exchange


def _local_equal(spread_pages, whole_pages):
    """(every page of this rank torch.equal to the one-process pager's,
    their max abs difference)."""
    from qrack_tpu_torch.ops import sharded as shb

    equal, diff = True, 0.0
    for p, page in shb.local_pages(spread_pages):
        equal = equal and torch.equal(page, whole_pages[p])
        diff = max(diff, float((page - whole_pages[p]).abs().max()))
    return equal, diff


def _same(a, b) -> bool:
    """A pager over page homes and the one-process pager: the same ket,
    table, page count and pages (this rank's, torch.equal)."""
    return (np.array_equal(a.GetQuantumState(), b.GetQuantumState())
            and list(a._qmap) == list(b._qmap) and a.n_pages == b.n_pages
            and _local_equal(a.page_planes, b.page_planes)[0])


def _five_paths(q, whole, homes, n: int) -> dict:
    """The five paths a pager over several processes refused until
    ROADMAP item 13.5 (compose, decompose, dispose, shrink and the armed
    resilience plane), each run on `q` and on the one-process pager
    `whole` (the same ket, seed and calls): True where they agree; and
    QUnitMulti's device table under a cluster."""
    from qrack_tpu_torch import resilience
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.layers.qunitmulti import QUnitMulti
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.resilience import faults
    from qrack_tpu_torch.utils.rng import QrackRandom

    pair = (q, whole)
    out = {}
    for p in pair:
        b = QPager(2, device="cpu", n_pages=1, rng=QrackRandom(4),
                   rand_global_phase=False)
        b.H(0)
        b.CNOT(0, 1)
        p.Compose(b, 3)
    out["compose"] = _same(*pair)
    dests = [QPager(1, device="cpu", n_pages=1) for _ in pair]
    for p, d in zip(pair, dests):
        p.H(0)
        p.Decompose(0, d)
    out["decompose"] = _same(*pair) and np.array_equal(
        dests[0].GetQuantumState(), dests[1].GetQuantumState())
    for p in pair:
        p.Dispose(0, 1, 0)
    out["dispose"] = _same(*pair)
    for p in pair:
        p.shrink_pages()
        p.H(n - 1)
    out["shrink"] = _same(*pair) and q.n_pages == len(homes) // 2
    got = []
    for devs in (homes, ["cpu"] * len(homes)):
        resilience.enable()
        tele.enable()
        import qrack_tpu_torch as qt

        r = qt.create_quantum_interface(
            "pager", n, devices=devs, n_pages=len(homes), rng=QrackRandom(5),
            rand_global_phase=False)
        # the mixed Swap of the circuit runs at pager.exchange
        faults.inject("pager.exchange", "raise", after_n=0, times=1)
        _circuit(r, n)
        ket = r.GetQuantumState()
        c = {k: v for k, v in tele.snapshot()["counters"].items()
             if k.startswith("resilience.")}
        got.append((ket, c))
        faults.clear()
        resilience.reset_breaker()
        resilience.disable()
        tele.disable()
        tele.reset()
    out["resilience"] = (np.array_equal(got[0][0], got[1][0])
                         and got[0][1] == got[1][1]
                         and got[0][1].get("resilience.failure."
                                           "pager.exchange") == 1)
    local = cluster.local_device_ids()
    u = QUnitMulti(4, device="cpu")
    out["unit_multi_devices"] = u.GetDeviceList()
    foreign = [i for i in range(8) if i not in local][0]
    try:
        QUnitMulti(4, device="cpu", device_ids=[foreign])
        out["unit_multi_foreign"] = "ran"
    except ValueError as e:
        out["unit_multi_foreign"] = str(e)
    return out


def _extras(homes, world: int) -> dict:
    """The rest of the page algebra over processes against the
    one-process pager, each read or page list equal: the ring gather
    (an ALU permutation, plain and split-index), the reductions
    (ProbParity, ProbMaskAll, GetProbs, SumSqrDiff, IsZeroAmplitude),
    a measurement's collapse, and compose_ring with B aligned and
    straddling the page bits."""
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = 7, 8
    pair = []
    for devs in (homes, ["cpu"] * G):
        q = QPager(n, rng=QrackRandom(31), rand_global_phase=False,
                   devices=devs, n_pages=G, dcn_bits=world.bit_length() - 1)
        _circuit(q, n)
        q.RY(0.4, 2)
        q.RX(1.1, 6)
        pair.append(q)
    out = {}
    reads = [{"parity": q.ProbParity(0b1000101),
              "mask_all": q.ProbMaskAll(0b1100010).tolist(),
              "probs": q.GetProbs().tolist(),
              "zero": q.IsZeroAmplitude()} for q in pair]
    out["reads"] = reads[0] == reads[1]
    for q in pair:
        q.INC(5, 0, 7)          # a permutation: the ring gather
        q.force_wide_alu = True
        q.INC(3, 2, 4)          # its split-index form
        q.force_wide_alu = False
        q.M(3)                  # the collapse
    out["alu_and_collapse"] = _local_equal(pair[0].page_planes,
                                           pair[1].page_planes)[0]
    twins = []
    for devs in (homes, ["cpu"] * G):
        t = QPager(n, rng=QrackRandom(32), rand_global_phase=False,
                   devices=devs, n_pages=G)
        t.H(0)
        t.CNOT(0, 6)
        twins.append(t)
    out["sum_sqr_diff"] = (pair[0].SumSqrDiff(twins[0])
                           == pair[1].SumSqrDiff(twins[1]))
    b = torch.tensor([[0.6, 0.0, 0.0, 0.8], [0.0, 0.0, 0.0, 0.0]])
    for start in (1, 6):        # B below the page bits; straddling them
        got = [shb.compose_ring(q._pages_raw, b, n - 3, start, n, 2)
               for q in pair]
        out[f"compose_ring_{start}"] = _local_equal(got[0], got[1])[0]
    return out


def circuit() -> dict:
    from qrack_tpu_torch.models import grover as grm
    from qrack_tpu_torch.models import qft as qftm
    from qrack_tpu_torch.models import rcs as rcsm
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.parallel.turboquant_pager import QPagerTurboQuant
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = 7, 8
    world = cluster.process_count()
    homes = cluster.global_page_devices(G, device="cpu")
    # the same seed on every process: measurement draws agree
    q = QPager(n, rng=QrackRandom(777), rand_global_phase=False,
               devices=homes, n_pages=G)
    _circuit(q, n)
    state = q.GetQuantumState()
    p3 = q.Prob(3)
    # the one-process pager on the same seed, its planner priced alike
    # (the top log2(world) page bits cross processes)
    whole = QPager(n, rng=QrackRandom(777), rand_global_phase=False,
                   devices=["cpu"] * G, dcn_bits=world.bit_length() - 1)
    _circuit(whole, n)
    whole_state = whole.GetQuantumState()
    equal, diff = _local_equal(q.page_planes, whole.page_planes)
    qmap_equal = list(q._qmap) == list(whole._qmap)
    m = q.MAll()
    m_whole = whole.MAll()

    L = n - 3
    qfn, _ = qftm.make_sharded_qft_fn(homes, n)
    qamps = shb.replicated_window(qfn(qftm.basis_pages(n, 5, homes)),
                                  L, 0, 1 << n, shared=True)
    rfn, _ = rcsm.make_sharded_rcs_fn(homes, n, depth=4, seed=11)
    ramps = shb.replicated_window(rfn(qftm.basis_pages(n, 0, homes)),
                                  L, 0, 1 << n, shared=True)
    gfn, _, _ = grm.make_sharded_grover_fn(homes, n, target=3)
    gamps = shb.replicated_window(gfn(qftm.basis_pages(n, 0, homes)),
                                  L, 0, 1 << n, shared=True)
    # the one-process programs on the same pages, the same functions
    whole_progs = {}
    for name, fn, perm in (("qft", qftm.make_sharded_qft_fn(G, n,
                                                            device="cpu")[0],
                            5),
                           ("rcs", rcsm.make_sharded_rcs_fn(
                               G, n, depth=4, seed=11, device="cpu")[0], 0),
                           ("grover", grm.make_sharded_grover_fn(
                               G, n, target=3, device="cpu")[0], 0)):
        pages = fn(qftm.basis_pages(n, perm, ["cpu"] * G))
        whole_progs[name] = np.concatenate(
            [pg.to(torch.float64).numpy() for pg in pages], axis=1)
    progs_equal = all(np.array_equal(a, whole_progs[k]) for k, a in
                      (("qft", qamps), ("rcs", ramps), ("grover", gamps)))

    tq_kw = dict(bits=16, chunk_qb=3, block_pow=2, n_pages=G,
                 rand_global_phase=False)
    tq = QPagerTurboQuant(n, devices=homes, rng=QrackRandom(777), **tq_kw)
    tqw = QPagerTurboQuant(n, devices=["cpu"] * G, rng=QrackRandom(777),
                           **tq_kw)
    for t in (tq, tqw):
        for i in range(n):
            t.H(i)
        t.CNOT(0, 6)       # page-bit target: the codes cross processes
        t.T(6)
        t.CZ(5, 6)
    tq_p3, tq_p6 = tq.Prob(3), tq.Prob(6)
    tq_amp0 = tq.GetAmplitude(0)
    codes, scales = tq.host_codes()
    wcodes, wscales = tqw.host_codes()
    tq_equal = (np.array_equal(codes, wcodes)
                and np.array_equal(scales, wscales)
                and tq_p3 == tqw.Prob(3) and tq_amp0 == tqw.GetAmplitude(0))
    tq_m = tq.MAll()
    tq_m_whole = tqw.MAll()

    return {
        "re": [float(x) for x in state.real],
        "im": [float(x) for x in state.imag],
        "prob3": float(p3),
        "state_equal_one_process": bool(np.array_equal(state, whole_state)),
        "pages_equal_one_process": bool(equal),
        "pages_max_diff": diff,
        "qmap_equal_one_process": qmap_equal,
        "mall": int(m),
        "mall_one_process": int(m_whole),
        "qft_re": [float(x) for x in qamps[0]],
        "qft_im": [float(x) for x in qamps[1]],
        "programs_equal_one_process": bool(progs_equal),
        "rcs_norm": float((ramps[0] ** 2 + ramps[1] ** 2).sum()),
        "grover_p_target": grm.success_probability(torch.from_numpy(gamps),
                                                   3),
        "tq_prob3": float(tq_p3),
        "tq_prob6": float(tq_p6),
        "tq_amp0_abs": abs(tq_amp0),
        "tq_equal_one_process": bool(tq_equal),
        "tq_mall": int(tq_m),
        "tq_mall_one_process": int(tq_m_whole),
        "wire_bytes": int(shb.EXCHANGES["wire_bytes"]),
        "extras_equal_one_process": _extras(homes, world),
        "five_paths": _five_paths(q, whole, homes, n),
    }


def _qft_circuit(n: int):
    """Descending-gen QFT (tests/multihost_pager_worker.py)."""
    from qrack_tpu_torch.layers.qcircuit import QCircuit

    c = QCircuit(n)
    for i in range(n):
        hq = n - 1 - i
        for j in range(i):
            ph = np.exp(1j * np.pi / 2.0 ** (i - j))
            c.append_ctrl([hq + 1 + j], hq,
                          np.diag([1.0, ph]).astype(np.complex128), 1)
        c.append_1q(hq, H)
    return c


def pager_w20() -> dict:
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.checkpoint import load_state, save_state
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.parallel import pager as pg
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = 20, 8
    out_dir = os.environ["QRACK_CKPT_DIR"]
    rank = cluster.process_index()
    homes = cluster.global_page_devices(G, device="cpu")
    circ = _qft_circuit(n)
    tele.enable()
    pg.reset_flushes()
    q = QPager(n, rng=QrackRandom(99), rand_global_phase=False,
               devices=homes, n_pages=G, remap="on")
    q.SetPermutation(0b1011)
    circ.Run(q)
    q.Finish()
    # the CPU runs the kernels' plain versions: no launch is counted,
    # the plans' per-page sweeps are
    flushes = dict(pg.FLUSHES)
    got = np.asarray(q.GetQuantumState())
    p3 = q.Prob(3)
    c = tele.snapshot()["counters"]
    tele.disable()
    tele.reset()
    np.save(os.path.join(out_dir, f"state.p{rank}.npy"), got)

    whole = QPager(n, rng=QrackRandom(99), rand_global_phase=False,
                   devices=["cpu"] * G, remap="on", dcn_bits=1)
    whole.SetPermutation(0b1011)
    circ.Run(whole)
    whole.Finish()
    equal, diff = _local_equal(q.page_planes, whole.page_planes)

    # every rank saves its own file of the whole ket (the capture reads
    # through the replicated window) and loads it into a fresh pager
    path = os.path.join(out_dir, f"pager_w20.p{rank}.qckpt")
    save_state(q, path)
    r = QPager(n, rng=QrackRandom(99), rand_global_phase=False,
               devices=homes, n_pages=G, remap="on")
    load_state(path, into=r)
    restore_identical = bool(np.array_equal(got, r.GetQuantumState()))
    pages_identical = all(torch.equal(a, b) for (_p, a), (_q, b) in zip(
        shb.local_pages(q.page_planes), shb.local_pages(r.page_planes)))
    one = load_state(path, device="cpu")
    one_process_identical = bool(np.array_equal(got, one.GetQuantumState()))

    return {
        "kinds": list(cluster.page_bit_kinds(homes)),
        "prob3": float(p3),
        "remap_pairs": int(c.get("remap.pager.pairs", 0)),
        "remap_batched": int(c.get("remap.pager.batched", 0)),
        "exchange_bytes": float(c.get("exchange.pager.bytes", 0.0)),
        "collective_bytes": float(
            c.get("exchange.pager.collective_bytes", 0.0)),
        "wire_bytes": int(shb.EXCHANGES["wire_bytes"]),
        "flushes": flushes,
        "pages_equal_one_process": bool(equal),
        "pages_max_diff": diff,
        "restore_identical": restore_identical,
        "restore_pages_identical": bool(pages_identical),
        "restore_qmap_ok": list(r._qmap) == list(q._qmap),
        "one_process_load_identical": one_process_identical,
    }


# ---------------------------------------------------------------------------
# the resilience plane over page homes (ROADMAP item 13.5)
# ---------------------------------------------------------------------------

#: the width and page count of the resilience cases
RW, RG = 12, 4
#: the families the parent compares, as tests/test_torch_resilience.py
FAMILIES = ("resilience.", "integrity.", "elastic.", "hybrid.unpin")


def res_circuits(n: int) -> dict:
    """tests/test_torch_resilience.py's elastic circuits at width n."""
    gen = np.random.Generator(np.random.PCG64(7))
    rcs = []
    for _ in range(4):
        for qb in range(n):
            rcs.append((("T", "H", "S")[int(gen.integers(0, 3))], (qb,)))
        a = int(gen.integers(0, n))
        rcs.append(("CZ", (a, (a + 1) % n)))
    gen = np.random.Generator(np.random.PCG64(11))

    def q():
        return int(gen.integers(0, n))

    fuzz = []
    for _ in range(16):
        kind = int(gen.integers(0, 6))
        if kind == 0:
            fuzz.append((("X", "Y", "Z", "H", "S", "T")[q() % 6], (q(),)))
        elif kind == 1:
            fuzz.append((("RX", "RY", "RZ")[kind % 3],
                         (float(gen.uniform(0, 6.28)), q())))
        elif kind == 2:
            a = q()
            fuzz.append((("CNOT", "CZ", "Swap", "ISwap")[a % 4],
                         (a, (a + 1 + q() % (n - 1)) % n)))
        elif kind == 3:
            s = int(gen.integers(0, n - 1))
            fuzz.append(("INC", (int(gen.integers(0, 8)), s,
                                 int(gen.integers(1, n - s + 1)))))
        elif kind == 4:
            fuzz.append(("XMask", (int(gen.integers(1, 1 << n)),)))
        else:
            fuzz.append(("ZMask", (int(gen.integers(1, 1 << n)),)))
    return {"qft": [("H", (0,)), ("CNOT", (0, 1)), ("RY", (0.7, 2)),
                    ("QFT", (0, n))],
            "rcs": rcs, "fuzz": fuzz}


PREFIX = [("H", (0,)), ("CNOT", (0, 1)), ("T", (1,)), ("RY", (0.7, 2))]
SUFFIX = [("CZ", (1, 2)), ("H", (3,)), ("INC", (3, 0, 3))]


def _apply(q, ops) -> None:
    for name, args in ops:
        getattr(q, name)(*args)


def _reset_plane() -> None:
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.resilience import faults
    from qrack_tpu_torch.resilience import integrity as integ

    faults.clear()
    res.reset_breaker()
    res.configure(max_retries=2, backoff_s=0.0, timeout_s=0.0)
    res.disable()
    tele.disable()
    tele.reset()
    integ.reset()
    os.environ.pop("QRACK_TPU_FUSE_WINDOW", None)


def _arm(window=None) -> None:
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch import telemetry as tele

    _reset_plane()
    if window is not None:
        os.environ["QRACK_TPU_FUSE_WINDOW"] = str(window)
    tele.enable()
    res.enable()


def _families() -> dict:
    from qrack_tpu_torch import telemetry as tele

    snap = tele.snapshot()
    return {"counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith(FAMILIES)},
            "events": [e["name"] for e in snap["events"]
                       if e["name"].startswith(FAMILIES)]}


def _state(q) -> np.ndarray:
    from qrack_tpu_torch.resilience import faults

    with faults.suspended():
        return np.asarray(q.GetQuantumState())


def _pages_of(q):
    """(local pages, table) of the pager under a stack, None for another
    engine."""
    eng = getattr(q, "engine", q)
    if type(eng).__name__ != "QPager":
        return None
    from qrack_tpu_torch.ops import sharded as shb

    return ([(p, pg.clone()) for p, pg in shb.local_pages(eng._pages_raw)],
            list(eng._qmap))


#: results of a run that are its own: the twin has no ranks, and the
#: wall clock is the run's
OWN = ("ket", "pages", "fam", "after_ranks", "fault_wall_s", "codes")


#: what only the rank where a fault fired records: the injection, the
#: watchdog's timeout of a hang and the thread it abandoned
LOCAL = ("resilience.fault.", "resilience.timeout.",
         "resilience.abandoned_threads")


def _fam_no_fault(fam) -> dict:
    """The families without the names only a faulting rank records
    (LOCAL): a fault armed on one rank only is recorded there alone."""
    return {"counters": {k: v for k, v in fam["counters"].items()
                         if not k.startswith(LOCAL)},
            "events": [e for e in fam["events"]
                       if not e.startswith(LOCAL)]}


def _twin_equal(a, b) -> bool:
    """A run over page homes against its one-process twin: the same
    pages (torch.equal, this rank's), table, ket, families and every
    other result."""
    if not np.array_equal(a["ket"], b["ket"]):
        return False
    if any(a[k] != b[k] for k in a if k not in OWN):
        return False
    for x, y in zip(a.get("codes", ()), b.get("codes", ())):
        # the TurboQuant pager's (codes, scales) at a stage
        if not all(np.array_equal(u, v) for u, v in zip(x, y)):
            return False
    if (a["pages"] is None) != (b["pages"] is None):
        return False
    if a["pages"] is not None:
        (pa, ma), (pb, mb) = a["pages"], b["pages"]
        whole = dict(pb)
        if ma != mb or not all(torch.equal(pg, whole[p]) for p, pg in pa):
            return False
    return _fam_no_fault(a["fam"]) == _fam_no_fault(b["fam"])


def _pair(run, homes, twin_devs, save_as=None):
    """run(devices) over the page homes and over one process; the
    result of the former, with ``twin_equal`` (and the ket saved for the
    parent when `save_as` is given)."""
    got = []
    for devs in (homes, twin_devs):
        out = run(devs)
        out["fam"] = _families()
        got.append(out)
        _reset_plane()
    a, b = got
    res = {k: v for k, v in a.items() if k not in ("ket", "pages", "codes")}
    res["twin_equal"] = _twin_equal(a, b)
    if save_as:
        np.save(os.path.join(os.environ["QRACK_RESULT_DIR"],
                             f"{save_as}.p{cluster.process_index()}.npy"),
                a["ket"])
    return res


def _make(devs, n=RW, **kw):
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.utils.rng import QrackRandom

    return qt.create_quantum_interface(
        "pager", n, devices=devs, n_pages=kw.pop("n_pages", RG),
        rng=QrackRandom(3), rand_global_phase=False, **kw)


def _matrix(circ: str, window: int, homes, twin):
    ops = res_circuits(RW)[circ]
    cut = len(ops) // 2

    def run(devs):
        from qrack_tpu_torch.resilience import faults

        _arm(window)
        q = _make(devs)
        _apply(q, ops[:cut])
        faults.inject("*", "flap", after_n=0, times=1)
        _apply(q, ops[cut:])
        q.GetAmplitude(0)
        q.Prob(0)
        return {"kind": type(q.engine).__name__, "pages_now": q.engine.n_pages,
                "degraded": q.engine.elastic_degraded, "ket": _state(q),
                "pages": _pages_of(q)}

    return _pair(run, homes, twin, save_as=f"matrix_{circ}_{window}")


def _staircase(cpu: bool, homes, twin):
    def run(devs):
        from qrack_tpu_torch.engines import cpu as tcpu
        from qrack_tpu_torch.resilience import faults

        _arm()
        built = [0]
        real = tcpu.QEngineCPU.__init__

        def counting(self, *a, **k):
            built[0] += 1
            real(self, *a, **k)

        tcpu.QEngineCPU.__init__ = counting
        try:
            q = _make(devs, failover_cpu=cpu)
            _apply(q, PREFIX)
            faults.inject("pager.dispatch", "device-loss", after_n=0,
                          times=None)
            _apply(q, SUFFIX)
            q.GetAmplitude(0)
            kind = type(q.engine).__name__
            ket = _state(q)
            draws = [q.MAll() for _ in range(3)]
        finally:
            tcpu.QEngineCPU.__init__ = real
        return {"kind": kind, "cpu_built": built[0], "draws": draws,
                "ket": ket, "pages": None}

    return _pair(run, homes, twin, save_as=f"staircase_{int(cpu)}")


def _quarantine(homes8, twin8):
    def run(devs):
        from qrack_tpu_torch.resilience import faults
        from qrack_tpu_torch.resilience import integrity as integ

        _arm()
        q = _make(devs, remap="off")
        pager = q.engine
        before = list(pager.page_slots)
        for k in range(3):
            faults.inject("pager.exchange", "amp-corrupt", after_n=0,
                          times=1, page=2, n_pages=RG)
            q.H(RW - 1 if k % 2 else RW - 2)
            q.Prob(0)
            faults.clear()
        strikes = {str(k): v for k, v in integ.strikes().items()}
        quarantined = sorted(integ.quarantined())
        pager.maybe_reexpand()
        after = list(pager.page_slots)
        q.CNOT(0, 1)
        q.H(RW - 1)
        q.Prob(0)
        ranks = (None if pager._slot_ranks is None else
                 [pager._slot_ranks[s] for s in after])
        return {"before": before, "after": after, "after_ranks": ranks,
                "strikes": strikes, "quarantined": quarantined,
                "ket": _state(q), "pages": _pages_of(q)}

    return _pair(run, homes8, twin8, save_as="quarantine")


def _prefix_layout(homes8, twin8):
    """A pager whose pages fill a prefix of the slots (all on rank 0 of
    two processes): every rank still joins the reductions, reads and
    draws."""
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.utils.rng import QrackRandom

    def run(devs):
        _reset_plane()
        q = QPager(RW, devices=devs, n_pages=RG, rng=QrackRandom(12),
                   rand_global_phase=False)
        _apply(q, res_circuits(RW)["rcs"])
        reads = [q.Prob(3), q.ProbParity(0b1011), q.IsZeroAmplitude(),
                 q.ProbMaskAll(0b11).tolist()]
        ket, pages = _state(q), _pages_of(q)
        return {"reads": reads, "draw": int(q.MAll()), "ket": ket,
                "pages": pages}

    return _pair(run, homes8, twin8, save_as="prefix")


def _cpu_rung(homes, twin):
    """A persistent device loss with the breaker tripping at the first
    failure: every rank shrinks 4 -> 2 -> 1 page while the agreed breaker
    refuses, skips the dense rung (the breaker is open) and lands on a
    QEngineCPU of the replicated ket, the rung named by
    failover_cpu=True."""
    def run(devs):
        from qrack_tpu_torch import resilience as res
        from qrack_tpu_torch.resilience import faults

        _arm()
        os.environ["QRACK_TPU_BREAKER_THRESHOLD"] = "1"
        try:
            res.reset_breaker()
            q = _make(devs, failover_cpu=True)
            _apply(q, PREFIX)
            faults.inject("pager.dispatch", "device-loss", after_n=0,
                          times=None)
            _apply(q, SUFFIX)
            kind = type(q.engine).__name__
            breaker = res.get_breaker().state
            ket = _state(q)
            draws = [int(q.MAll()) for _ in range(2)]
        finally:
            os.environ.pop("QRACK_TPU_BREAKER_THRESHOLD", None)
        return {"kind": kind, "breaker": breaker, "draws": draws,
                "ket": ket, "pages": None}

    return _pair(run, homes, twin, save_as="cpu_rung")


def _persist(homes, twin):
    """The staircase with QRACK_TPU_FAILOVER_PERSIST set: over the page
    homes every rank captures the replicated ket before each move and
    rank 0 alone writes it (one directory for the cohort); the
    one-process twin writes its own (a directory a rank)."""
    from qrack_tpu_torch.resilience import faults

    rank = cluster.process_index()
    root = os.environ["QRACK_RESULT_DIR"]
    dirs = {}
    for name, devs in (("spread", homes), ("twin", twin)):
        d = os.path.join(root, "persist_spread" if name == "spread"
                         else f"persist_twin_{rank}")
        dirs[name] = d
        _arm()
        os.environ["QRACK_TPU_FAILOVER_PERSIST"] = d
        try:
            q = _make(devs)
            _apply(q, PREFIX)
            faults.inject("pager.dispatch", "device-loss", after_n=0,
                          times=None)
            _apply(q, SUFFIX)
            kind = type(q.engine).__name__
        finally:
            os.environ.pop("QRACK_TPU_FAILOVER_PERSIST", None)
        _reset_plane()
    return {"kind": kind, "dirs": dirs}


def _hybrid(homes, twin):
    """QHybrid over the page homes: its pager fails over in place down to
    a QEngineCUDA replica on each rank (the ceiling pinned), and once the
    faults clear its agreed un-pin probe carries the ket back onto a
    pager over the homes."""
    def run(devs):
        from qrack_tpu_torch.engines.hybrid import QHybrid
        from qrack_tpu_torch.resilience import faults
        from qrack_tpu_torch.utils.rng import QrackRandom

        _arm()
        h = QHybrid(RW, devices=devs, device="cpu", tpu_threshold_qubits=2,
                    pager_threshold_qubits=RW - 1, rng=QrackRandom(3),
                    rand_global_phase=False)
        first = type(h._engine).__name__
        _apply(h, PREFIX)
        faults.inject("pager.dispatch", "device-loss", after_n=0,
                      times=None)
        _apply(h, SUFFIX)
        pinned, kind = h._failed_over, type(h._engine).__name__
        faults.clear()
        h.X(4)                  # the un-pin probe at this call boundary
        back = type(h._engine).__name__
        h.X(4)
        return {"first": first, "pinned": pinned, "kind": kind,
                "back": back, "ket": _state(h), "pages": None}

    return _pair(run, homes, twin, save_as="hybrid")


#: faults on one rank only: the spec the last rank's process loads into
#: its own QRACK_TPU_FAULTS (amp-corrupt, which the grammar cannot pin to
#: a page, through faults.inject); every twin loads it on its own
ONE_RANK = {
    "raise": "pager.exchange:raise:0",
    "hang": "pager.exchange:hang:0",
    "device-loss": "pager.exchange:device-loss:0",
    "amp-corrupt": None,
}


def _one_rank(kind: str, homes, twin):
    def run(devs):
        from qrack_tpu_torch import resilience as res
        from qrack_tpu_torch.resilience import faults

        _arm(window=1)
        if kind == "hang":
            res.configure(timeout_s=0.5)
        q = _make(devs, remap="off")
        _apply(q, PREFIX)
        q.Prob(0)
        mine = (devs is twin
                or cluster.process_index() == cluster.process_count() - 1)
        if mine:
            if ONE_RANK[kind] is None:
                faults.inject("pager.exchange", "amp-corrupt", after_n=0,
                              times=1, page=RG - 1, n_pages=RG)
            else:
                os.environ["QRACK_TPU_FAULTS"] = ONE_RANK[kind]
                faults.load_env()
        t0 = time.perf_counter()
        q.H(RW - 1)          # a page-bit target: pager.exchange
        q.Prob(0)
        wall = time.perf_counter() - t0
        os.environ.pop("QRACK_TPU_FAULTS", None)
        faults.clear()
        _apply(q, SUFFIX)
        q.Prob(0)
        from qrack_tpu_torch.resilience import integrity as integ

        return {"kind": type(q.engine).__name__,
                "pages_now": q.engine.n_pages,
                "strikes": {str(k): v for k, v in integ.strikes().items()},
                "fault_wall_s": wall, "ket": _state(q),
                "pages": _pages_of(q)}

    out = _pair(run, homes, twin, save_as=f"one_rank_{kind}")
    return out


def _late_fault() -> dict:
    """One cohort dispatch whose callable fails on the last rank only,
    after entry and before it writes, while every other rank's callable
    writes its operand in place: a retry in place would run the others'
    pass twice, so every rank gives up torn."""
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch.resilience import dispatch as rdispatch

    _reset_plane()
    t = torch.zeros(4)
    last = cluster.process_index() == cluster.process_count() - 1
    calls = [0]

    def fn():
        calls[0] += 1
        if last:
            raise RuntimeError("CUDA error: out of memory")
        t.add_(1.0)
        return t

    try:
        rdispatch.call_guarded("pager.window", fn, cohort=True,
                               writes=lambda: rdispatch.write_token(t))
        outcome = "ok"
    except res.DispatchGiveUp as e:
        outcome = f"give_up torn={e.torn}"
    _reset_plane()
    return {"outcome": outcome, "calls": calls[0], "value": float(t[0])}


def _breaker_split() -> dict:
    """The last rank's breaker alone tripped by a dispatch outside the
    cohort (a replica's), then a cohort dispatch while it cools down and
    one after: every rank refuses the first and runs the second."""
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch.resilience import dispatch as rdispatch
    from qrack_tpu_torch.resilience.breaker import CircuitBreaker

    _reset_plane()
    res.configure(max_retries=0)
    now = [0.0]
    br = res.reset_breaker(CircuitBreaker(threshold=1, cooldown_s=5.0,
                                          clock=lambda: now[0]))
    if cluster.process_index() == cluster.process_count() - 1:
        def boom():
            raise RuntimeError("CUDA error: out of memory")

        try:
            rdispatch.call_guarded("cuda.dispatch", boom)
        except res.DispatchGiveUp:
            pass
    states, got = [br.state], []
    for tick in (1.0, 10.0):
        now[0] = tick
        try:
            got.append(rdispatch.call_guarded("pager.window", lambda: 7,
                                              cohort=True))
        except res.BreakerOpen:
            got.append("open")
        states.append(br.state)
    _reset_plane()
    return {"got": got, "states": states}


SW = 6   # the structural case's width: 4 pages of 2^4


def structure_ops():
    """The structural sequence (the parent replays it on the JAX
    package's QEngineCPU): (name, args) with ``"B<k>"`` naming the k-th
    side engine of ``STRUCT_SIDES``."""
    prep = [("RY", (0.3 + 0.2 * i, i)) for i in range(SW)]
    return prep + [
        ("CNOT", (0, 1)), ("CNOT", (2, 3)),
        ("Decompose", (2, "B0")),     # w4, the page count kept
        ("Dispose", (3, 1, 0)),       # w3, by a |0> slice
        ("Dispose", (1, 2, 1)),       # w1: 4 pages -> 2
        ("Allocate", (1, 3)),         # w4: 2 pages -> 4
        ("H", (3,)), ("CNOT", (3, 0)), ("RX", (0.9, 2)),
        ("Compose", ("B1",)),         # w6: B straddles the page bits
        ("Compose", ("B2", 1)),       # w8: B below them
        ("Allocate", (2, 1)),         # w8: in place
        ("CNOT", (7, 2)), ("H", (5,)),
    ]


#: the side engines: (width, ops on it); B0 receives a Decompose
STRUCT_SIDES = [(2, []), (2, [("H", (0,)), ("CNOT", (0, 1)), ("T", (1,))]),
                (1, [("RY", (1.1, 0))])]


def _structure(homes, twin):
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.utils.rng import QrackRandom

    def run(devs):
        _reset_plane()
        q = QPager(SW, devices=devs, n_pages=RG, rng=QrackRandom(5),
                   rand_global_phase=False)
        sides = []
        for k, (w, ops) in enumerate(STRUCT_SIDES):
            # B1 lives on the page homes too: its ket is gathered
            s = QPager(w, devices=devs if k == 1 else ["cpu"],
                       n_pages=RG if k == 1 else 1, rng=QrackRandom(6 + k),
                       rand_global_phase=False)
            _apply(s, ops)
            sides.append(s)
        pages_seen = []
        for name, args in structure_ops():
            args = tuple(sides[int(a[1:])] if isinstance(a, str) else a
                         for a in args)
            getattr(q, name)(*args)
            pages_seen.append(q.n_pages)
        ket, pages = _state(q), _pages_of(q)
        return {"widths_pages": pages_seen, "width": q.qubit_count,
                "b0": [[float(x.real), float(x.imag)]
                       for x in sides[0].GetQuantumState()],
                "draw": int(q.MAll()), "ket": ket, "pages": pages}

    return _pair(run, homes, twin, save_as="structure")


def alu_ops():
    """Out-of-place ALU scatters on a w12 pager (below 32 qubits, so the
    pair-scatter forms): registers in 0-2, carries and outputs zero."""
    return [("H", (i,)) for i in range(3)] + [
        ("RY", (0.4, 9)), ("CNOT", (9, 11)),
        ("MUL", (3, 0, 3, 3)),
        ("MULModNOut", (5, 7, 0, 6, 3)),
        ("DIV", (3, 0, 3, 3)),
        ("CMUL", (3, 0, 3, 3, (11,)))]   # the passthrough form


def _alu(homes, twin):
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.utils.rng import QrackRandom

    def run(devs):
        _reset_plane()
        q = QPager(RW, devices=devs, n_pages=RG, rng=QrackRandom(8),
                   rand_global_phase=False)
        _apply(q, alu_ops())
        return {"ket": _state(q), "pages": _pages_of(q)}

    return _pair(run, homes, twin, save_as="alu")


TQ_KW = dict(bits=16, chunk_qb=3, block_pow=2, rand_global_phase=False)


def tq_ops():
    return ([("H", (i,)) for i in range(RW)]
            + [("CNOT", (0, RW - 1)), ("T", (RW - 1,)), ("CZ", (RW - 2, RW - 1)),
               ("RY", (0.8, 3))])


def _tq(homes, twin):
    """The TurboQuant pager armed (a pair exchange that raises on the
    last rank only, retried on every rank), on its dense float32 plane
    (an ALU permutation and a Compose), narrowed below one chunk a page
    (Dispose to two qubits), then failed over to QEngineCUDA replicas (a
    persistent device loss)."""
    from qrack_tpu_torch.parallel.turboquant_pager import QPagerTurboQuant

    def run(devs):
        import qrack_tpu_torch as qt
        from qrack_tpu_torch.resilience import faults
        from qrack_tpu_torch.utils.rng import QrackRandom

        _arm()
        t = qt.create_quantum_interface(
            "turboquant_pager", RW, devices=devs, n_pages=RG,
            rng=QrackRandom(9), **TQ_KW)
        _apply(t, tq_ops()[:RW])
        if devs is twin or cluster.process_index() == \
                cluster.process_count() - 1:
            os.environ["QRACK_TPU_FAULTS"] = \
                "turboquant_pager.exchange:raise:0"
            faults.load_env()
        _apply(t, tq_ops()[RW:])
        os.environ.pop("QRACK_TPU_FAULTS", None)
        faults.clear()
        armed = t.engine.host_codes()
        t.INC(5, 0, RW)                     # the dense plane, gathered
        b = QPagerTurboQuant(2, devices=["cpu"], n_pages=1,
                             rng=QrackRandom(10), **TQ_KW)
        b.H(1)
        t.Compose(b)                        # the dense plane again
        dense = t.engine.host_codes()
        t.Dispose(2, RW, 0)                 # narrowed: 4 pages -> 2
        narrowed_pages = t.engine.n_pages
        narrowed = t.engine.host_codes()
        t.Compose(QPagerTurboQuant(RW - 2, devices=["cpu"], n_pages=1,
                                   rng=QrackRandom(11), **TQ_KW))
        faults.inject("turboquant.dispatch", "device-loss", after_n=0,
                      times=None)
        faults.inject("turboquant_pager.exchange", "device-loss",
                      after_n=0, times=None)
        t.H(RW - 1)
        t.CNOT(RW - 1, 0)
        kind = type(t.engine).__name__
        faults.clear()
        draws = [t.MAll() for _ in range(3)]
        return {"kind": kind, "narrowed_pages": narrowed_pages,
                "draws": draws, "codes": [armed, dense, narrowed],
                "ket": _state(t), "pages": None}

    return _pair(run, homes, twin, save_as="tq")


def resilience() -> dict:
    """Every resilience, re-paging and structural case over page homes
    (2 or 4 processes, RG pages), each against its one-process twin in
    this process."""
    from qrack_tpu_torch.ops import sharded as shb

    world = cluster.process_count()
    homes = cluster.global_page_devices(RG, device="cpu")
    twin = ["cpu"] * RG
    homes8 = cluster.global_page_devices(2 * RG, device="cpu")
    twin8 = ["cpu"] * (2 * RG)
    out = {}
    for circ in ("qft", "rcs", "fuzz"):
        for window in (1, 16):
            out[f"matrix_{circ}_{window}"] = _matrix(circ, window, homes,
                                                     twin)
    for cpu in (False, True):
        out[f"staircase_{int(cpu)}"] = _staircase(cpu, homes, twin)
    out["cpu_rung"] = _cpu_rung(homes, twin)
    out["hybrid"] = _hybrid(homes, twin)
    out["persist"] = _persist(homes, twin)
    out["quarantine"] = _quarantine(homes8, twin8)
    out["prefix"] = _prefix_layout(homes8, twin8)
    for kind in ONE_RANK:
        out[f"one_rank_{kind}"] = _one_rank(kind, homes, twin)
    out["late_fault"] = _late_fault()
    out["breaker_split"] = _breaker_split()
    out["structure"] = _structure(homes, twin)
    out["alu"] = _alu(homes, twin)
    out["tq"] = _tq(homes, twin)
    out["agreements"] = dict(cluster.AGREEMENTS)
    out["exchanges"] = {k: shb.EXCHANGES[k] for k in ("repage", "gather",
                                                       "wire_bytes")}
    out["world"] = world
    return out


CASES = {"circuit": circuit, "pager_w20": pager_w20,
         "resilience": resilience}


def main() -> None:
    # one intra-op thread a rank: the ranks share the host's cores, and
    # oversubscribed OpenMP pools spin against each other
    torch.set_num_threads(1)
    ids = os.environ.get("QRACK_WORKER_LOCAL_IDS")
    cluster.init_cluster(
        local_device_ids=[int(t) for t in ids.split(",")] if ids else None)
    result = CASES[sys.argv[1]]()
    result.update({"proc": cluster.process_index(),
                   "procs": cluster.process_count(),
                   "backend": cluster.backend()})
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
