"""Fleet worker: one QrackService behind a unix-socket RPC front.

The port of the JAX package's fleet/worker.py.  ``python -m
qrack_tpu_torch.fleet.worker --socket S --store DIR ...`` runs one
supervised serving process:

* the service is built ``hold_lease=False`` (the shared store's lease
  is only taken around adoption, never parked — N workers share one
  checkpoint dir) and ``checkpoint_every_job=True`` (every completed
  mutating job — circuit, or a collapsing/rng-consuming read like
  measure_all — lands a snapshot at settle, circuits before their WAL
  entry is removed, so a kill -9 at ANY instant is recoverable with
  zero loss — the wal_high high-water mark dedups the
  snapshot-then-settle window);
* the sessions run on the card unless ``--engine-kwargs`` names
  ``"device": "cpu"`` (or the layers are host ones): the service
  resolves the device at construction, so a worker without a GPU and
  without that argument raises at boot, and the supervisor counts the
  boot as failed.  The worker owns its own CUDA context; the supervisor
  and the front door never initialize one;
* warm artifacts are fleet-wide: the service points the kernel build
  at ``<store>/kernel_cache`` (checkpoint/warmstart.py,
  ``cuda_build.set_build_dir``), so a respawned worker loads the
  libraries the first build wrote instead of running nvcc, and
  ``QRACK_SERVE_PREWARM=1`` (set by the supervisor) rebuilds the
  recorded fold programs at boot, so a restarted worker's
  time-to-first-result is the warm number.  The measured ``ttfr_s``
  rides in every heartbeat for the soak to assert on;
* SIGTERM is the graceful half of the restart ladder
  (resilience/probe.py reap_child): finish in-flight jobs, drain every
  session to the store for a peer to adopt, final heartbeat, exit 0.

The RPC loop is deliberately thread-per-connection over a stateless
connection-per-request protocol (fleet/rpc.py): all device traffic
already serializes through the service's dispatch owner, so connection
concurrency costs nothing and a worker restart needs no client-side
session re-handshake.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
import time
from typing import Optional

import numpy as np

from .. import telemetry as _tele
from .rpc import (decode_circuit, encode_array, recv_frame, send_frame,
                  FleetRPCError)
from .heartbeat import DEFAULT_INTERVAL_S, HeartbeatWriter

_T0 = time.perf_counter()


class _WorkerState:
    def __init__(self):
        self.name = None
        self.ready = False
        self.ttfr_s: Optional[float] = None
        self.boot_s: Optional[float] = None
        self.draining = False
        # every tag this incarnation journaled (memory-bounded only by
        # process lifetime — a worker restart clears it, which is
        # exactly when the supervisor's WAL-scan record takes over);
        # answers the front door's "did my unacked submit land?"
        self.seen_tags = set()
        # the last adoption's wall and its container load (info op)
        self.last_adopt: Optional[dict] = None


def _handle(svc, state: _WorkerState, conn) -> bool:
    """Serve one connection (one request).  Returns False when the
    request was a shutdown."""
    f = conn.makefile("rwb")
    try:
        req = recv_frame(f)
    except FleetRPCError:
        return True  # client connected and vanished; nothing owed
    op = req.get("op")
    # adopt the caller's distributed-trace context for this request:
    # every span/event this connection thread records (and every job it
    # submits — scheduler.Job captures the submitting thread's trace)
    # correlates back to the front door's id
    prev_trace = _tele.set_trace(req.get("trace")) if _tele._ENABLED \
        else None
    try:
        try:
            if op == "submit":
                return _handle_submit(svc, state, f, req)
            rep = _dispatch(svc, state, op, req)
        except Exception as e:  # noqa: BLE001 — typed errors cross as frames
            _send_err(f, e)
            return True
        send_frame(f, {"ok": True, **rep})
        return op != "shutdown"
    finally:
        if _tele._ENABLED:
            _tele.set_trace(prev_trace)


def _handle_submit(svc, state: _WorkerState, f, req) -> bool:
    sid = req["sid"]
    circuit = decode_circuit(req["circuit"])
    tag = req.get("tag")
    t0 = time.perf_counter()
    try:
        # span 1 of the submit's worker-side trace: WAL append +
        # admission (ends the instant the entry is durable)
        with _tele.span("worker.submit.journal"):
            handle = svc.submit(sid, circuit, tag=tag,
                                priority=int(req.get("priority") or 0))
    except Exception as e:  # noqa: BLE001
        _send_err(f, e)
        return True
    if tag is not None:
        state.seen_tags.add(tag)
    # frame 1 the moment the WAL entry is durable: the client's
    # exactly-once pivot (rpc.py) — after this frame, never resubmit
    send_frame(f, {"ok": True, "journaled": True})
    try:
        # span 2: queue wait + execution + honest devget (the executor
        # nests its own serve.execute span inside this window)
        with _tele.span("worker.submit.result"):
            handle.result(None)
    except Exception as e:  # noqa: BLE001
        _send_err(f, e)
        return True
    if state.ttfr_s is None:
        # SERVICE latency of this incarnation's first result — the
        # number that exposes a cold recompile (a prewarmed restart
        # stays near steady-state apply latency)
        state.ttfr_s = time.perf_counter() - t0
    send_frame(f, {"ok": True})
    return True


def _dispatch(svc, state: _WorkerState, op: str, req: dict) -> dict:
    if op == "ping":
        return {"pid": os.getpid(), "ready": state.ready,
                "draining": state.draining}
    if op == "create":
        if state.draining:
            raise RuntimeError("worker is draining; closed to new sessions")
        sid = svc.create_session(req["width"], layers=req.get("layers"),
                                 seed=req.get("seed"), sid=req.get("sid"),
                                 **(req.get("engine_kwargs") or {}))
        return {"sid": sid}
    if op == "destroy":
        svc.destroy_session(req["sid"])
        return {}
    if op == "measure_all":
        return {"value": int(svc.measure_all(req["sid"]))}
    if op == "prob":
        return {"value": float(svc.prob(req["sid"], req["qubit"]))}
    if op == "sample":
        shots = svc.sample(req["sid"], req["shots"],
                           qubits=req.get("qubits"))
        return {"value": [int(s) for s in shots]}
    if op == "get_state":
        # the ket comes off the card as host complex128 (GetQuantumState)
        return {"state": encode_array(np.asarray(
            svc.get_state(req["sid"]), dtype=np.complex128))}
    if op == "drain":
        return svc.drain(sids=req.get("sids"))
    if op == "brownout":
        # fleet-wide graceful degradation (supervisor broadcast):
        # level >= 1 sheds jobs at/below the band in scheduler
        # admission; level >= 2 points the routing ladder's borderline
        # dense decisions at the quantized rung; level 0 clears both
        level = int(req.get("level") or 0)
        svc.scheduler.set_brownout(level,
                                   shed_band=int(req.get("shed_band") or 0),
                                   retry_in_s=float(
                                       req.get("retry_in_s") or 0.5))
        from ..route import router as _router

        _router.set_brownout(level >= 2)
        if _tele._ENABLED:
            _tele.gauge("serve.brownout.level", float(level))
        return {"level": level}
    if op == "adopt":
        loads0 = _restore_counters()
        t0 = time.perf_counter()
        out = svc.recover(sids=req["sids"])
        dt = time.perf_counter() - t0
        if state.ttfr_s is None and out.get("wal_replayed"):
            state.ttfr_s = dt
        state.last_adopt = {
            "sids": list(req["sids"]), "recover_s": dt,
            # the adoption's snapshot reads (one file a session; counted
            # while telemetry is enabled, else None)
            "load": ({k: v - loads0[k]
                      for k, v in _restore_counters().items()}
                     if _tele._ENABLED else None),
            **{k: out.get(k) for k in ("wal_replayed", "wal_deduped",
                                       "wal_skipped", "recovered_stale")}}
        return out
    if op == "tag_seen":
        return {"seen": req.get("tag") in state.seen_tags}
    if op == "stats":
        return {"stats": json.loads(json.dumps(
            svc.stats(), default=str))}
    if op == "info":
        return {"info": {
            "name": state.name, "pid": os.getpid(),
            "ready": state.ready, "draining": state.draining,
            "sessions": len(svc.sessions.ids()),
            "queue_depth": svc.scheduler.depth(),
            "inflight": svc.executor.inflight_jobs,
            "staged": svc.executor.staged_jobs,
            "pressure": svc.executor.pressure(),
            "ttfr_s": state.ttfr_s, "boot_s": state.boot_s,
            "kernels": _kernel_launches(),
            "device_bytes": _device_bytes(),
            "last_adopt": state.last_adopt,
            "telemetry": _tele.snapshot(include_events=False)}}
    if op == "shutdown":
        return {}
    raise ValueError(f"unknown op {op!r}")


def _restore_counters() -> dict:
    """The checkpoint loads of this process so far, from its telemetry
    counters: files, bytes, and the read and hash-wait seconds."""
    c = _tele.snapshot(include_events=False)["counters"]
    return {"loads": c.get("checkpoint.restore", 0),
            "bytes": c.get("checkpoint.restore.bytes", 0),
            "read_s": c.get("checkpoint.restore.read_s", 0.0),
            "hash_wait_s": c.get("checkpoint.restore.hash_wait_s", 0.0)}


def _kernel_launches() -> dict:
    """This process's kernel launches so far: the window kernel's (K1
    in-tile, K2 pair) by plane dtype and the TurboQuant kernels' —
    only for the wrappers this worker has imported."""
    out = {}
    wk = sys.modules.get("qrack_tpu_torch.ops.window_kernel")
    if wk is not None:
        out["window"] = {d: dict(c) for d, c in wk.DTYPE_LAUNCHES.items()}
    tqk = sys.modules.get("qrack_tpu_torch.ops.turboquant_kernel")
    if tqk is not None:
        out["turboquant"] = dict(tqk.LAUNCHES)
    return out


def _device_bytes() -> Optional[int]:
    """Bytes the caching allocator holds on this worker's card, or None
    where the worker never initialized CUDA."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.memory_allocated())


def _send_err(f, e: BaseException) -> None:
    try:
        send_frame(f, {"ok": False, "etype": type(e).__name__,
                       "error": str(e)})
    except FleetRPCError:
        pass  # client gone; the error had nowhere to land


def _graceful_drain(svc, grace_s: float = 30.0) -> None:
    """Drain everything to the store for a peer to adopt; in-flight
    jobs get `grace_s` to settle before we give up on their sessions
    (the WAL still covers them — adoption replays)."""
    deadline = time.monotonic() + grace_s
    while True:
        out = svc.drain()
        if not out["busy"] or time.monotonic() >= deadline:
            return
        time.sleep(0.05)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--socket", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--heartbeat", required=True)
    ap.add_argument("--name", default=f"worker-{os.getpid()}")
    ap.add_argument("--layers", default="cuda",
                    help="default engine stack (comma-separated for "
                         "multi-layer; sessions may override per-create)")
    ap.add_argument("--beat-s", type=float, default=DEFAULT_INTERVAL_S)
    ap.add_argument("--engine-kwargs", default="{}",
                    help="JSON dict of default engine kwargs "
                         '(\'{"device": "cpu"}\' keeps dense sessions '
                         "off the card)")
    ap.add_argument("--blackbox-dir", default=None,
                    help="flight-recorder dir (default <store>/blackbox; "
                         "written only while telemetry is enabled)")
    args = ap.parse_args(argv)

    state = _WorkerState()
    state.name = args.name
    from ..serve.service import QrackService

    layers = args.layers.split(",") if "," in args.layers else args.layers
    svc = QrackService(engine_layers=layers,
                       checkpoint_dir=args.store,
                       hold_lease=False, checkpoint_every_job=True,
                       recover=False,
                       **json.loads(args.engine_kwargs))

    # flight recorder: one black box per worker INCARNATION (pid in the
    # filename — a restart must not overwrite the corpse the supervisor
    # autopsies); flushed on every heartbeat so it is at most one beat
    # stale at kill -9
    recorder = None
    if _tele.enabled():
        bb_dir = args.blackbox_dir or os.path.join(args.store, "blackbox")
        recorder = _tele.FlightRecorder(
            os.path.join(bb_dir, f"{args.name}-{os.getpid()}.json"),
            name=args.name)

    def info():
        rec = {"name": args.name, "ready": state.ready,
               "draining": state.draining,
               "sessions": len(svc.sessions.ids()),
               # pipeline depth in every beat: the supervisor's stats
               # (and a capacity-aware placement later) can see how
               # loaded each worker is without an extra RPC
               "queue_depth": svc.scheduler.depth(),
               "inflight": svc.executor.inflight_jobs,
               "staged": svc.executor.staged_jobs,
               "pressure": svc.executor.pressure(),
               "ttfr_s": state.ttfr_s,
               "boot_s": state.boot_s,
               # this incarnation's launches so far: the supervisor keeps
               # the latest per incarnation (kernel_launches)
               "kernels": _kernel_launches()}
        if _tele._ENABLED:
            # cumulative snapshot (not deltas): the supervisor keys the
            # latest record per (worker, pid) incarnation, so merges
            # stay correct across restarts without sequence bookkeeping
            rec["telemetry"] = _tele.snapshot(include_events=False)
            if recorder is not None:
                try:
                    recorder.flush()
                except OSError:
                    pass  # a full disk must not kill the beat thread
        return rec

    hb = HeartbeatWriter(args.heartbeat, interval_s=args.beat_s,
                         info_fn=info).start()

    try:
        os.unlink(args.socket)
    except OSError:
        pass
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(args.socket)
    server.listen(16)
    # accept wakes every beat: a SIGTERM that the kernel hands to another
    # thread (heartbeat, executor, a connection), or a shutdown op's
    # close from a connection thread, does not interrupt a blocked
    # accept, and the handler only runs on the main thread between calls
    server.settimeout(args.beat_s)
    stop = threading.Event()

    def on_sigterm(signum, frame):
        state.draining = True
        stop.set()
        # break the accept loop; in-flight connection threads finish
        try:
            server.close()
        except OSError:
            pass

    signal.signal(signal.SIGTERM, on_sigterm)
    state.ready = True
    state.boot_s = time.perf_counter() - _T0
    if _tele._ENABLED:
        # seed the flight recorder: even a worker killed before serving
        # anything leaves a non-empty event tail for the postmortem
        _tele.event("worker.ready", worker=args.name, pid=os.getpid(),
                    boot_s=round(state.boot_s, 3))
    hb.beat()

    try:
        while not stop.is_set():
            try:
                conn, _ = server.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # closed by on_sigterm
            conn.settimeout(None)
            def run(c=conn):
                try:
                    if not _handle(svc, state, c):
                        on_sigterm(signal.SIGTERM, None)
                finally:
                    try:
                        c.close()
                    except OSError:
                        pass
            threading.Thread(target=run, daemon=True).start()
    finally:
        _graceful_drain(svc)
        svc.close()
        hb.stop(final_beat=True)
        if recorder is not None:
            try:
                recorder.flush()  # graceful exits leave a fresh box too
            except OSError:
                pass
        try:
            os.unlink(args.socket)
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
