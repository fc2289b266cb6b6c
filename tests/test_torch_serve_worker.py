"""One process of the port's serving plane for the two-process cases of
tests/test_torch_serve_checkpoint.py (the counterpart of the JAX
package's tests/_ckpt_serve_child.py).  No test functions: run as

    python tests/test_torch_serve_worker.py <phase> <ckdir> [<out.npy>]

with ``<phase>`` one of

* ``spill`` — run c1, wait for idle eviction to spill the session, run
  c2 (transparent restore), save the final ket to ``out``;
* ``crash`` — run c1, checkpoint, journal c2 the way submit() would,
  then die with os._exit (no close, no atexit);
* ``recover`` — start with recover=True and prewarm=True, check the
  session came back under its id, save its ket;
* ``stale`` — run c1 (completed, never checkpointed), journal c2, die;
* ``recover-stale`` — recover, print the result dict as JSON on the
  last line, save the (cold) ket;
* ``hold`` — checkpoint c1, journal c2, print ``READY <sid>`` and block
  on stdin holding the recovery lease (the parent kills it);
* ``adopt-denied`` — assert recover=True raises StoreLeaseHeld;
* ``drain-hold`` — run c1, drain, print ``DRAINED <json>``, block on
  stdin without exiting;
* ``adopt`` — recover explicitly, print the result dict as JSON,
  optionally apply c2 (``--apply-c2``), save the ket;
* ``warm`` — open a service on the store (the warm start points the
  kernel libraries at ``<ckdir>/kernel_cache``), ask the build for both
  kernel sources, and print ``KERNELS <json>`` with the
  ``compile.kernel.*`` counters (the parent puts a stand-in nvcc first
  on PATH; the CPU has no toolkit).

Sessions are the dense terminal ``"cuda"`` on the CPU
(``device="cpu"``).  Imports torch and the port only; the parent holds
the kets against the JAX package's oracle.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from qrack_tpu_torch import matrices as mat  # noqa: E402
from qrack_tpu_torch.layers.qcircuit import (QCircuit,  # noqa: E402
                                             QCircuitGate)
from qrack_tpu_torch.serve import QrackService  # noqa: E402

W = 6
SEED = 7
KW = {"engine_layers": "cuda", "device": "cpu", "tick_s": 0.02,
      "batch_window_ms": 2.0}


def circuits(width):
    """The JAX child's circuits (tests/_ckpt_serve_child.py)."""
    t_gate = np.diag([1.0, np.exp(1j * np.pi / 4)])
    s_gate = np.diag([1.0, 1j])
    c1 = QCircuit(width)
    for q in range(width):
        c1.AppendGate(QCircuitGate.single(q, mat.H2))
    for q in range(width - 1):
        c1.AppendGate(QCircuitGate.controlled([q], q + 1, mat.X2, 1))
    c1.AppendGate(QCircuitGate.single(0, t_gate))
    c2 = QCircuit(width)
    c2.AppendGate(QCircuitGate.single(1, s_gate))
    c2.AppendGate(QCircuitGate.single(2, mat.H2))
    c2.AppendGate(QCircuitGate.controlled([0], width - 1, mat.X2, 1))
    c2.AppendGate(QCircuitGate.single(3, t_gate))
    return c1, c2


def phase_spill(ckdir: str, out: str) -> None:
    c1, c2 = circuits(W)
    with QrackService(checkpoint_dir=ckdir, idle_evict_s=0.2,
                      **KW) as svc:
        sid = svc.create_session(W, seed=SEED, rand_global_phase=False)
        svc.apply(sid, c1)
        deadline = time.time() + 30
        while time.time() < deadline:
            st = [s for s in svc.stats()["sessions"] if s["sid"] == sid][0]
            if st["spilled"]:
                break
            time.sleep(0.05)
        else:
            sys.exit("session never spilled")
        assert svc.stats()["checkpoint_store"]["spilled"] == 1
        svc.apply(sid, c2)
        st = [s for s in svc.stats()["sessions"] if s["sid"] == sid][0]
        assert st["restores"] == 1, st
        assert st["engine"] == "QEngineCUDA", st
        np.save(out, np.asarray(svc.get_state(sid)))


def phase_crash(ckdir: str) -> None:
    c1, c2 = circuits(W)
    svc = QrackService(checkpoint_dir=ckdir, **KW)
    sid = svc.create_session(W, seed=SEED, rand_global_phase=False)
    assert sid == "s000001", sid
    svc.apply(sid, c1)
    svc.checkpoint_session(sid)
    svc.store.wal_append(sid, c2)
    os._exit(0)


def phase_stale(ckdir: str) -> None:
    c1, c2 = circuits(W)
    svc = QrackService(checkpoint_dir=ckdir, **KW)
    sid = svc.create_session(W, seed=SEED, rand_global_phase=False)
    svc.apply(sid, c1)
    svc.get_state(sid)   # orders past c1's completion accounting
    svc.store.wal_append(sid, c2)
    os._exit(0)


def phase_recover_stale(ckdir: str, out: str) -> None:
    with QrackService(checkpoint_dir=ckdir, **KW) as svc:
        res = svc.recover()
        np.save(out, np.asarray(svc.get_state("s000001")))
        print(json.dumps(res))


def phase_recover(ckdir: str, out: str) -> None:
    with QrackService(checkpoint_dir=ckdir, recover=True, prewarm=True,
                      **KW) as svc:
        sids = [s["sid"] for s in svc.stats()["sessions"]]
        assert sids == ["s000001"], sids
        np.save(out, np.asarray(svc.get_state("s000001")))
        sid2 = svc.create_session(W, seed=1)
        assert sid2 == "s000002", sid2
        svc.destroy_session(sid2)


def phase_hold(ckdir: str) -> None:
    c1, c2 = circuits(W)
    svc = QrackService(checkpoint_dir=ckdir, **KW)
    sid = svc.create_session(W, seed=SEED, rand_global_phase=False)
    svc.apply(sid, c1)
    svc.checkpoint_session(sid)
    svc.store.wal_append(sid, c2)
    assert svc.lease_held
    print(f"READY {sid}", flush=True)
    sys.stdin.readline()
    os._exit(0)


def phase_adopt_denied(ckdir: str) -> None:
    from qrack_tpu_torch.checkpoint import StoreLeaseHeld

    try:
        QrackService(checkpoint_dir=ckdir, recover=True, **KW)
    except StoreLeaseHeld as e:
        assert "drain or stop" in str(e), e
        return
    sys.exit("recover was admitted while a live peer held the lease")


def phase_drain_hold(ckdir: str) -> None:
    c1, _ = circuits(W)
    svc = QrackService(checkpoint_dir=ckdir, **KW)
    sid = svc.create_session(W, seed=SEED, rand_global_phase=False)
    svc.apply(sid, c1)
    out = svc.drain()
    assert out == {"drained": [sid], "busy": []}, out
    assert not svc.lease_held
    assert sid not in svc.sessions.ids()
    print(f"DRAINED {json.dumps(out)}", flush=True)
    sys.stdin.readline()
    svc.close()


def phase_adopt(ckdir: str, out: str, apply_c2: bool) -> None:
    _, c2 = circuits(W)
    with QrackService(checkpoint_dir=ckdir, **KW) as svc:
        res = svc.recover()
        assert svc.lease_held
        if apply_c2:
            svc.apply("s000001", c2)
        np.save(out, np.asarray(svc.get_state("s000001")))
        print(json.dumps(res))


def phase_warm(ckdir: str) -> None:
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.ops import cuda_build
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.ops import window_kernel as wk

    with QrackService(checkpoint_dir=ckdir, **KW):
        tele.enable()
        cuda_build.build([wk.SOURCE, tqk.SOURCE])
        where = [str(cuda_build.library_path(s).parent)
                 for s in (wk.SOURCE, tqk.SOURCE)]
    c = {k: v for k, v in tele.snapshot()["counters"].items()
         if k.startswith("compile.kernel.")}
    print("KERNELS " + json.dumps({"counters": c, "dirs": where}),
          flush=True)


if __name__ == "__main__":
    phase, ck = sys.argv[1], sys.argv[2]
    if phase == "spill":
        phase_spill(ck, sys.argv[3])
    elif phase == "crash":
        phase_crash(ck)
    elif phase == "recover":
        phase_recover(ck, sys.argv[3])
    elif phase == "stale":
        phase_stale(ck)
    elif phase == "recover-stale":
        phase_recover_stale(ck, sys.argv[3])
    elif phase == "hold":
        phase_hold(ck)
    elif phase == "adopt-denied":
        phase_adopt_denied(ck)
    elif phase == "drain-hold":
        phase_drain_hold(ck)
    elif phase == "adopt":
        phase_adopt(ck, sys.argv[3], apply_c2="--apply-c2" in sys.argv[4:])
    elif phase == "warm":
        phase_warm(ck)
    else:
        sys.exit(f"unknown phase {phase!r}")
