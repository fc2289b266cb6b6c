"""qrack_tpu_torch.serve — multi-tenant serving over a single dispatch
owner (the port of the JAX package's serve/).

Sessions are tenants; ALL device traffic is serialized through one
executor thread; same-shape circuit jobs from different tenants run as
ONE folded ket through the window kernel (K1/K2): the B lanes' planes
stacked so the lane index is the fold's high bits; and admission
control sheds card-bound load while the resilience breaker is open.

Layout:

* errors.py       — typed admission / lifecycle errors
* session.py      — Session + SessionManager (per-tenant rng, idle evict)
* scheduler.py    — priority queue, admission control, batch windowing
* batcher.py      — shape-keyed fold programs (telemetry.ProgramCache)
* executor.py     — the dispatch-owner thread (call_guarded + failover)
* service.py      — QrackService, the in-process front API
* prefix_cache.py — shared state-prep kets, copied at seed
* canary.py       — sampled oracle replay of served jobs

Deliberately NOT imported from the package root: a library user who
never serves pays no import or dispatch cost.
"""

from .errors import (AdmissionRejected, LoadShed, Overloaded,
                     QueueBudgetExceeded, QueueFull, ServeError,
                     ServiceStopped, SessionNotFound)


def __getattr__(name):
    # the service and its scheduler load on first use: the fleet's front
    # door takes the typed errors and no engine
    if name == "QrackService":
        from .service import QrackService as value
    elif name == "JobHandle":
        from .scheduler import JobHandle as value
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


__all__ = [
    "QrackService", "JobHandle",
    "ServeError", "AdmissionRejected", "QueueFull", "LoadShed",
    "Overloaded", "QueueBudgetExceeded", "ServiceStopped",
    "SessionNotFound",
]
