"""One process of a multi-process run of the port's pagers (see
tests/test_torch_cluster.py).  No test functions: run as

    QRACK_COORDINATOR=localhost:<port> QRACK_NUM_PROCESSES=<n> \\
    QRACK_PROCESS_ID=<rank> python tests/test_torch_cluster_worker.py <case>

with ``<case>`` ``circuit`` (a w7 QPager of 8 pages, the page-list
programs, the TurboQuant pager and the refusals) or ``pager_w20`` (the
remap-on w20 QFT and its checkpoint).  Brings the process group up on
gloo through qrack_tpu_torch.parallel.cluster, runs the case on pages
spread over every process, and prints one ``RESULT {json}`` line for the
parent, which holds it against the JAX package.  Imports torch and the
port only.
"""

import json
import os
import sys

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


def _refusals(q, n: int) -> dict:
    """What a pager over several processes refuses, each naming the
    ROADMAP item that ports it."""
    from qrack_tpu_torch import resilience
    from qrack_tpu_torch.layers.qunitmulti import QUnitMulti
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.utils.rng import QrackRandom

    out = {}
    for name, call in (
            ("compose", lambda: q.Compose(QPager(2, device="cpu",
                                                 n_pages=1))),
            ("decompose", lambda: q.Decompose(0, QPager(1, device="cpu",
                                                     n_pages=1))),
            ("dispose", lambda: q.Dispose(0, 1)),
            ("shrink", q.shrink_pages)):
        try:
            call()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = str(e)
    resilience.enable()
    try:
        QPager(n, rng=QrackRandom(1), devices=cluster.global_page_devices(
            8, device="cpu"))
        out["resilience"] = "ran"
    except NotImplementedError as e:
        out["resilience"] = str(e)
    finally:
        resilience.disable()
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
        "refusals": _refusals(q, n),
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


CASES = {"circuit": circuit, "pager_w20": pager_w20}


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
