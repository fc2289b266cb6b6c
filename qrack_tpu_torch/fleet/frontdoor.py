"""Fleet front door: one service surface over N supervised workers (the
port of the JAX package's fleet/frontdoor.py).

The front door mirrors :class:`~qrack_tpu_torch.serve.QrackService`'s API
(create/apply/measure/sample/state/destroy) and hides worker death
behind it:

* **routing** — every call asks the supervisor for the sid's live
  client.  ``None`` means the session is between owners (its worker
  died and adoption is in flight); the front door WAITS instead of
  erroring, so a tenant's only observable symptom of a kill -9 is a
  latency blip bounded by detection + adoption time.
* **exactly-once submits** — each submit carries a fresh tag and uses
  the two-frame protocol (fleet/rpc.py).  A transport death AFTER the
  journaled frame never resubmits: the WAL entry is durable and
  adoption replays it (or the wal_high dedup proves the snapshot
  already holds it).  A transport death BEFORE the frame consults, in
  order: the supervisor's adopted-tag record (the dead worker's
  pending journal, scanned before adoption), the store's durable
  settled-tag ack log (a worker that journaled, executed AND settled
  the submit in the microseconds before writing its first frame — the
  entry is gone from the journal, but the executor acked the tag
  before removing it), and the current owner's in-memory ``tag_seen``
  set (the live-worker case) — only a tag NONE of them has seen is
  resubmitted.
* **retryable reads** — reads that lose their connection re-route and
  re-ask; a read that lands after an adoption executes against the
  restored snapshot (rng stream included), so retried measurements
  stay deterministic.  A typed SessionNotFound from a routed worker
  retries the same way: it means "not adopted HERE yet" (a migration
  race), not "gone" — placement owns sid existence.

The front door holds no engine, no store and no CUDA context — it is
pure routing, importable anywhere (its import loads no engine module;
the submit's circuit codec loads the checkpoint store's on first use).
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

from .. import telemetry as _tele
from ..serve.errors import Overloaded
from .rpc import FleetClient, FleetRemoteError, FleetRPCError

DEFAULT_ROUTE_TIMEOUT_S = 120.0
# a sid migrating longer than this with NO owner in placement is
# stranded (its owner was permanently removed and re-placement failed),
# not mid-adoption — surface the typed error instead of waiting out the
# full routing timeout
DEFAULT_MIGRATE_TIMEOUT_S = 30.0


class SessionUnroutable(RuntimeError):
    """No live owner for the session within the routing timeout."""

    def __init__(self, sid: str, waited_s: float):
        super().__init__(
            f"session {sid!r}: no live owner after {waited_s:.1f}s "
            "(worker dead and adoption did not complete in time)")
        self.sid = sid


class AdoptionStalled(SessionUnroutable):
    """The session has been in the migrating set past the migrate
    deadline with no owner in placement — its worker was permanently
    removed (scale-down, quarantine) and re-placement never landed, so
    no amount of waiting routes it.  The session state is still durable
    on the store; re-adoption (a worker coming back healthy) or an
    operator decision resolves it, not this caller's patience."""

    def __init__(self, sid: str, waited_s: float):
        RuntimeError.__init__(
            self,
            f"session {sid!r}: migrating with no owner for "
            f"{waited_s:.1f}s — owner permanently removed and "
            "re-placement did not land (state remains durable on the "
            "store)")
        self.sid = sid


def _session_not_found(e: FleetRemoteError) -> bool:
    """A worker-side typed refusal that means "not adopted HERE yet",
    not "gone": the fleet owns sid existence (placement), so a routed
    worker lacking the session is a migration race, retryable."""
    return e.etype == "SessionNotFound"


class FleetFrontDoor:
    def __init__(self, supervisor,
                 route_timeout_s: float = DEFAULT_ROUTE_TIMEOUT_S,
                 migrate_timeout_s: float = DEFAULT_MIGRATE_TIMEOUT_S):
        self.sup = supervisor
        self.route_timeout_s = route_timeout_s
        self.migrate_timeout_s = migrate_timeout_s

    # -- routing core --------------------------------------------------

    def _client(self, sid: str, deadline: float) -> FleetClient:
        while True:
            c = self.sup.route(sid)
            if c is not None:
                return c
            self._check_stranded(sid)
            if time.monotonic() >= deadline:
                raise SessionUnroutable(
                    sid, self.route_timeout_s)
            time.sleep(0.05)

    def _check_stranded(self, sid: str) -> None:
        """Bound the migrating wait: a sid migrating past the deadline
        with NO owner in placement lost its worker permanently (scale-
        down/quarantine emptied the fleet's re-placement options) — no
        adoption is coming, so waiting out the full routing timeout
        only delays the typed answer.  A migrating sid that HAS an
        owner is mid-adoption; keep waiting."""
        since = getattr(self.sup, "migrating_since", None)
        if since is None:
            return  # stub supervisors (tests) keep the legacy wait
        t0 = since(sid)
        if t0 is None:
            return
        waited = time.monotonic() - t0
        if waited < self.migrate_timeout_s:
            return
        if self.sup.owner_of(sid) is not None:
            return
        if _tele._ENABLED:
            _tele.inc("fleet.frontdoor.not_adopted_yet")
        raise AdoptionStalled(sid, waited)

    def _retrying(self, sid: str, fn, timeout_s: Optional[float] = None):
        """Run `fn(client)` against the sid's live owner, re-routing on
        transport death — the idempotent-call path (reads, destroys).

        A typed SessionNotFound retries too: routing can point at an
        adopter whose scoped recovery has not landed yet (adoption
        retry in flight, or a read racing evict→adopt during a rolling
        restart).  The session exists fleet-wide — the worker just
        does not hold it THIS instant — so the front door re-asks
        until the deadline instead of leaking the remote error to the
        tenant.  Unknown sids never reach here: routing has no owner
        for them, so :meth:`_client` times out first."""
        deadline = time.monotonic() + (timeout_s or self.route_timeout_s)
        while True:
            client = self._client(sid, deadline)
            try:
                return fn(client)
            except FleetRPCError:
                if _tele._ENABLED:
                    _tele.inc("fleet.frontdoor.reroute")
            except FleetRemoteError as e:
                if not _session_not_found(e):
                    raise
                if _tele._ENABLED:
                    _tele.inc("fleet.frontdoor.not_adopted_yet")
            if time.monotonic() >= deadline:
                raise SessionUnroutable(sid, timeout_s
                                        or self.route_timeout_s)
            time.sleep(0.05)

    # -- sessions ------------------------------------------------------

    def create_session(self, width: int, layers=None,
                       seed: Optional[int] = None,
                       timeout_s: Optional[float] = None,
                       **engine_kwargs) -> str:
        """Place and build a session; sids are front-door-issued so
        they stay globally unique across every worker sharing the
        store."""
        layers = self.sup.layers if layers is None else layers
        sid = f"f{uuid.uuid4().hex[:12]}"
        deadline = time.monotonic() + (timeout_s or self.route_timeout_s)
        while True:
            self.sup.place_session(sid, layers, width)
            client = self._client(sid, deadline)
            try:
                client.create(width, sid=sid, layers=layers, seed=seed,
                              **engine_kwargs)
                return sid
            except FleetRPCError:
                # worker died before (or while) building the engine; no
                # store record exists yet, so just re-place and rebuild
                if _tele._ENABLED:
                    _tele.inc("fleet.frontdoor.create_retry")
                if time.monotonic() >= deadline:
                    self.sup.note_destroyed(sid)
                    raise SessionUnroutable(sid, timeout_s
                                            or self.route_timeout_s)
                time.sleep(0.05)
            except FleetRemoteError as e:
                if e.etype == "RuntimeError" and "draining" in str(e):
                    # raced a rolling restart: place elsewhere
                    time.sleep(0.05)
                    continue
                self.sup.note_destroyed(sid)
                raise

    def destroy_session(self, sid: str) -> None:
        try:
            self._retrying(sid, lambda c: c.destroy(sid))
        finally:
            self.sup.note_destroyed(sid)

    # -- circuit submission (exactly-once) -----------------------------

    def apply(self, sid: str, circuit,
              timeout_s: Optional[float] = None,
              priority: int = 0) -> dict:
        """Apply `circuit` to `sid` exactly once, riding out worker
        death mid-submit.  Returns ``{"resubmits": n, "adopted": bool}``
        describing how the effect landed.  ``priority`` is the job's
        dispatch band AND its brownout shed band: under fleet overload
        the ladder sheds low bands first (`_check_brownout`).

        The submit's fresh tag doubles as its distributed-trace id: it
        is already minted per submit, already rides the WAL entry, and
        rpc.py forwards it in every frame — so the front door's
        ``frontdoor.apply`` span, the worker's journal/result spans and
        the executor's ``serve.execute`` span all correlate on one id
        in the merged fleet trace."""
        self._check_brownout(priority)
        tag = uuid.uuid4().hex
        if not _tele._ENABLED:
            return self._apply_loop(sid, circuit, tag, timeout_s,
                                    priority)
        prev_trace = _tele.set_trace(tag)
        t0 = time.perf_counter()
        try:
            with _tele.span("frontdoor.apply"):
                out = self._apply_loop(sid, circuit, tag, timeout_s,
                                       priority)
            # the tenant-observed submit wall (routing + RPC + queue +
            # execution + any mid-submit adoption) — the fleet-level
            # SLO distribution, vs the worker-local serve.latency
            _tele.observe("fleet.frontdoor.apply",
                          time.perf_counter() - t0)
            return out
        finally:
            _tele.set_trace(prev_trace)

    def _check_brownout(self, priority: int) -> None:
        """The brownout ladder's front-door rungs, checked BEFORE any
        routing or journaling so a refused job provably never executed
        (retry-after is always safe): level 3 refuses all new work;
        level 1+ sheds jobs at/below the shed band.  Jobs above the
        band pass untouched — their only brownout effect is level 2's
        quantized routing, applied worker-side."""
        state = None
        get = getattr(self.sup, "brownout", None)
        if callable(get):
            state = get()
        if not state:
            return
        level = int(state.get("level") or 0)
        retry_in_s = float(state.get("retry_in_s") or 0.5)
        if level >= 3:
            if _tele._ENABLED:
                _tele.inc("serve.brownout.overloaded")
            raise Overloaded(retry_in_s, level=level)
        if level >= 1 and priority <= int(state.get("shed_band") or 0):
            if _tele._ENABLED:
                _tele.inc("serve.brownout.shed")
            raise Overloaded(retry_in_s, level=level,
                             band=int(state.get("shed_band") or 0))

    def _apply_loop(self, sid: str, circuit, tag: str,
                    timeout_s: Optional[float],
                    priority: int = 0) -> dict:
        deadline = time.monotonic() + (timeout_s or self.route_timeout_s)
        resubmits = 0
        while True:
            client = self._client(sid, deadline)
            try:
                client.submit(sid, circuit, tag=tag, priority=priority)
                return {"resubmits": resubmits, "adopted": False}
            except FleetRemoteError as e:
                if not _session_not_found(e):
                    raise
                # routed to an adopter that has not recovered the
                # session yet; nothing journaled (the refusal precedes
                # the WAL append) — wait for adoption, same tag
                if _tele._ENABLED:
                    _tele.inc("fleet.frontdoor.not_adopted_yet")
                if time.monotonic() >= deadline:
                    raise SessionUnroutable(sid, timeout_s
                                            or self.route_timeout_s)
                time.sleep(0.05)
            except FleetRPCError as e:
                landed = self._submit_landed(
                    sid, tag, bool(getattr(e, "journaled", False)),
                    deadline)
                if landed:
                    return {"resubmits": resubmits, "adopted": True}
                resubmits += 1
                if _tele._ENABLED:
                    _tele.inc("fleet.frontdoor.resubmit")
                if time.monotonic() >= deadline:
                    raise SessionUnroutable(sid, timeout_s
                                            or self.route_timeout_s)
                # the owner may be dead-but-undetected for up to one
                # monitor tick; don't spin the connect loop hot
                time.sleep(0.02)

    def _submit_landed(self, sid: str, tag: str, journaled: bool,
                       deadline: float) -> bool:
        """The transport died mid-submit: decide whether the effect is
        (or will be) applied.  Wait for the session to be routable
        first — only after adoption settles can the answer be final."""
        client = self._client(sid, deadline)
        if journaled:
            # frame 1 arrived: the WAL entry was durable when the
            # worker died — adoption replays or wal_high-dedups it
            return True
        if self.sup.tag_adopted(tag):
            # the dead worker's pending journal held our tag at scan
            # time; the adopter replays it
            return True
        if self.sup.tag_settled(tag):
            # the worker journaled, executed AND settled the submit,
            # then died before writing the first frame: the entry is
            # gone from the journal (the adoption scan can't see it)
            # but the settle-time durable ack proves it landed
            return True
        try:
            rep = client.request({"op": "tag_seen", "tag": tag})
            return bool(rep.get("seen"))
        except (FleetRPCError, FleetRemoteError):
            # owner changed again mid-question; the next apply() loop
            # iteration re-decides from scratch
            return False

    # -- reads ---------------------------------------------------------

    def measure_all(self, sid: str,
                    timeout_s: Optional[float] = None) -> int:
        return self._retrying(sid, lambda c: c.measure_all(sid),
                              timeout_s)

    def prob(self, sid: str, qubit: int,
             timeout_s: Optional[float] = None) -> float:
        return self._retrying(sid, lambda c: c.prob(sid, qubit),
                              timeout_s)

    def sample(self, sid: str, shots: int, qubits=None,
               timeout_s: Optional[float] = None):
        return self._retrying(sid, lambda c: c.sample(sid, shots,
                                                      qubits=qubits),
                              timeout_s)

    def get_state(self, sid: str, timeout_s: Optional[float] = None):
        return self._retrying(sid, lambda c: c.get_state(sid), timeout_s)

    def stats(self) -> dict:
        return self.sup.stats()


__all__ = ["FleetFrontDoor", "SessionUnroutable", "AdoptionStalled",
           "DEFAULT_ROUTE_TIMEOUT_S", "DEFAULT_MIGRATE_TIMEOUT_S"]
