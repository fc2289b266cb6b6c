"""Fleet wire protocol: ndjson frames over unix domain sockets (the
port of the JAX package's fleet/rpc.py; host only).

One request dict per line, one (or, for submits, two) response dicts
per line — newline-delimited JSON keeps the framing trivially
debuggable (``socat - UNIX:path`` works) and the worker loop free of
length-prefix bookkeeping.  Binary payloads (gate matrices, state
vectors) ride as base64-encoded raw complex128 bytes inside the JSON;
circuits reuse the checkpoint plane's exact payload codec
(:func:`~qrack_tpu_torch.checkpoint.store.circuit_payload`) so a circuit
that round-trips the WAL and one that round-trips an RPC submit are
byte-identical by construction.  That payload is the JAX package's
format, so a circuit encoded by either package decodes in the other.
The array codec takes host numpy only: a worker moves a ket off the
card (complex128) before it encodes it.

The two-frame submit is the fleet's exactly-once hinge: the worker
sends ``{"journaled": true}`` the moment ``QrackService.submit``
returns (the WAL entry is on shared disk), then the final result
frame after the job settles.  A client whose connection dies AFTER
the journaled frame must NOT resubmit — adoption replays the entry;
one whose connection dies BEFORE it consults the dead worker's
pending-tag set (:meth:`CheckpointStore.wal_pending_tags`) through
the supervisor before deciding.

Every frame carries the caller thread's distributed-trace context
(``"trace": <id>``) when telemetry is enabled and a trace is set: the
front door mints one id per submit, the worker adopts it for the
request's spans/events, and the merged fleet exporter
(telemetry/export.py merged_chrome_trace) correlates them back onto
one timeline.  The field costs nothing when telemetry is off (one
module-bool read) and is ignored by workers that never look.

Deliberately stdlib+numpy only at import: the client side must be
importable from a front door that never builds an engine and never
touches the card (telemetry is pure stdlib).
"""

from __future__ import annotations

import base64
import json
import socket
from typing import Optional, Tuple

import numpy as np

from .. import telemetry as _tele

# bound a single frame: a w26 complex128 state is ~1 GiB — anything
# bigger than this is a protocol bug, not a payload
MAX_FRAME_BYTES = 1 << 31


class FleetRPCError(RuntimeError):
    """Transport-level failure (connection died, garbled frame)."""


class FleetRemoteError(RuntimeError):
    """The worker executed the request and reported a typed failure."""

    def __init__(self, etype: str, message: str):
        super().__init__(f"{etype}: {message}")
        self.etype = etype


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _unb64(s: str, dtype, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype=dtype).reshape(shape)


def encode_circuit(circuit) -> dict:
    """JSON-able circuit payload, via the checkpoint codec."""
    from ..checkpoint.store import circuit_payload

    meta, arrays = circuit_payload(circuit)
    return {"meta": meta,
            "arrays": {k: {"b64": _b64(v), "shape": list(v.shape)}
                       for k, v in arrays.items()}}


def decode_circuit(obj: dict):
    from ..checkpoint.store import circuit_from_payload

    arrays = {k: _unb64(v["b64"], np.complex128, tuple(v["shape"]))
              for k, v in obj["arrays"].items()}
    return circuit_from_payload(obj["meta"], arrays)


def encode_array(a) -> dict:
    if not isinstance(a, np.ndarray):
        raise TypeError(f"encode_array takes a host numpy array, not "
                        f"{type(a).__name__}: move it off the card first")
    a = np.ascontiguousarray(a)
    return {"b64": _b64(a), "shape": list(a.shape), "dtype": str(a.dtype)}


def decode_array(obj: dict) -> np.ndarray:
    return _unb64(obj["b64"], np.dtype(obj["dtype"]), tuple(obj["shape"]))


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def send_frame(f, obj: dict) -> None:
    data = (json.dumps(obj, separators=(",", ":")) + "\n").encode()
    if len(data) > MAX_FRAME_BYTES:
        raise FleetRPCError(f"frame of {len(data)} bytes exceeds protocol "
                            f"bound {MAX_FRAME_BYTES}")
    try:
        f.write(data)
        f.flush()
    except (OSError, ValueError) as e:
        raise FleetRPCError(f"send failed: {e}") from None


def recv_frame(f) -> dict:
    try:
        line = f.readline(MAX_FRAME_BYTES)
    except OSError as e:
        raise FleetRPCError(f"recv failed: {e}") from None
    if not line:
        raise FleetRPCError("connection closed mid-exchange")
    try:
        return json.loads(line)
    except json.JSONDecodeError as e:
        raise FleetRPCError(f"garbled frame: {e}") from None


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class FleetClient:
    """One worker's front: a fresh connection per request (unix-socket
    connects are ~µs; statelessness means a worker restart needs no
    client-side reconnect dance).  Raises :class:`FleetRPCError` on
    transport death — the front door's signal to consult placement —
    and :class:`FleetRemoteError` for typed worker-side refusals."""

    def __init__(self, socket_path: str, timeout_s: float = 120.0,
                 result_timeout_s: float = 3600.0):
        self.socket_path = socket_path
        self.timeout_s = timeout_s
        # the wait for a submit's RESULT frame is bounded separately:
        # after the journaled frame, the socket is waiting on job
        # EXECUTION, not transport — a legitimate long-running job must
        # not surface as FleetRPCError(journaled=True), which the front
        # door would report "adopted" while the job is still in flight
        self.result_timeout_s = result_timeout_s

    def _connect(self):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout_s)
        try:
            s.connect(self.socket_path)
        except OSError as e:
            s.close()
            raise FleetRPCError(
                f"connect {self.socket_path}: {e}") from None
        return s

    def request(self, obj: dict) -> dict:
        """Single-frame exchange; unwraps the ok/error envelope."""
        if _tele._ENABLED and "trace" not in obj:
            tid = _tele.current_trace()
            if tid is not None:
                obj["trace"] = tid
        s = self._connect()
        try:
            f = s.makefile("rwb")
            send_frame(f, obj)
            return _unwrap(recv_frame(f))
        finally:
            s.close()

    def submit(self, sid: str, circuit, tag: Optional[str] = None,
               priority: int = 0) -> Tuple[bool, dict]:
        """Two-frame submit.  Returns ``(journaled, result_frame)``;
        raises FleetRPCError with ``journaled`` recoverable from the
        exception's ``.journaled`` attribute when the connection dies
        between the frames.  The result frame waits under
        ``result_timeout_s`` (execution time), not ``timeout_s``
        (transport time) — see ``__init__``.  ``priority`` rides the
        frame into scheduler admission: it is the job's dispatch band
        AND its brownout shed band (serve/scheduler.py)."""
        s = self._connect()
        journaled = False
        req = {"op": "submit", "sid": sid, "tag": tag,
               "priority": int(priority),
               "circuit": encode_circuit(circuit)}
        if _tele._ENABLED:
            tid = _tele.current_trace()
            if tid is not None:
                req["trace"] = tid
        try:
            f = s.makefile("rwb")
            send_frame(f, req)
            first = _unwrap(recv_frame(f))
            journaled = bool(first.get("journaled"))
            s.settimeout(self.result_timeout_s)
            return journaled, _unwrap(recv_frame(f))
        except FleetRPCError as e:
            e.journaled = journaled
            raise
        finally:
            s.close()

    # -- op sugar ------------------------------------------------------

    def ping(self) -> dict:
        return self.request({"op": "ping"})

    def create(self, width: int, sid: str, layers=None,
               seed: Optional[int] = None, **engine_kwargs) -> str:
        rep = self.request({"op": "create", "width": int(width),
                            "sid": sid, "layers": layers, "seed": seed,
                            "engine_kwargs": engine_kwargs})
        return rep["sid"]

    def destroy(self, sid: str) -> None:
        self.request({"op": "destroy", "sid": sid})

    def measure_all(self, sid: str) -> int:
        return int(self.request({"op": "measure_all", "sid": sid})["value"])

    def prob(self, sid: str, qubit: int) -> float:
        return float(self.request({"op": "prob", "sid": sid,
                                   "qubit": int(qubit)})["value"])

    def sample(self, sid: str, shots: int, qubits=None):
        rep = self.request({"op": "sample", "sid": sid,
                            "shots": int(shots), "qubits": qubits})
        return rep["value"]

    def get_state(self, sid: str) -> np.ndarray:
        return decode_array(self.request({"op": "get_state",
                                          "sid": sid})["state"])

    def drain(self, sids=None) -> dict:
        return self.request({"op": "drain", "sids": sids})

    def brownout(self, level: int, shed_band: int = 0,
                 retry_in_s: float = 0.5) -> dict:
        """Install (or clear, level 0) brownout state worker-side:
        scheduler admission sheds at/below the band and the routing
        ladder prefers the quantized rung while level >= 2."""
        return self.request({"op": "brownout", "level": int(level),
                             "shed_band": int(shed_band),
                             "retry_in_s": float(retry_in_s)})

    def adopt(self, sids) -> dict:
        return self.request({"op": "adopt", "sids": list(sids)})

    def stats(self) -> dict:
        return self.request({"op": "stats"})["stats"]

    def info(self) -> dict:
        """Live worker introspection: identity + a telemetry snapshot
        (counters, gauges, histogram summaries) without waiting for a
        heartbeat flush."""
        return self.request({"op": "info"})["info"]

    def shutdown(self) -> None:
        self.request({"op": "shutdown"})


def _unwrap(frame: dict) -> dict:
    if frame.get("ok"):
        return frame
    raise FleetRemoteError(frame.get("etype", "RuntimeError"),
                           frame.get("error", "<no detail>"))


__all__ = ["FleetClient", "FleetRPCError", "FleetRemoteError",
           "encode_circuit", "decode_circuit", "encode_array",
           "decode_array", "send_frame", "recv_frame"]
