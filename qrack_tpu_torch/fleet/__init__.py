"""qrack_tpu_torch.fleet — supervised multi-worker serving with live
migration and zero-loss rolling restarts (the port of the JAX
package's fleet/).

One QrackService per worker PROCESS, N workers behind one front door,
all sharing one checkpoint store:

* rpc.py        — ndjson-over-unix-socket wire protocol + client
* heartbeat.py  — atomic beat files; pid + missed-beat liveness
* placement.py  — cost-model bin packing (Clifford ~free, dense w22+
                  owns a device budget), quarantine-aware
* worker.py     — ``python -m qrack_tpu_torch.fleet.worker``: the supervised
                  serving process (hold_lease=False,
                  checkpoint_every_job=True, SIGTERM-graceful)
* supervisor.py — spawn/watch/restart with per-worker breaker restart
                  budgets, adoption-before-restart, rolling restarts
* frontdoor.py  — the QrackService-shaped routing surface with
                  exactly-once submits across worker death
* autoscaler.py — demand-driven scale up/down and the brownout ladder

Each worker is a port QrackService on the card (one CUDA context a
process) unless the supervisor is told ``layers="cpu"`` or
``engine_kwargs='{"device": "cpu"}'``; the supervisor and the front
door import no engine and never initialize CUDA.

Like serve/, NOT imported from the package root: a library user who
never runs a fleet pays zero import cost — and the worker subprocess
only imports what it serves with.
"""

from .autoscaler import Autoscaler, AutoscaleConfig
from .frontdoor import AdoptionStalled, FleetFrontDoor, SessionUnroutable
from .placement import NoHealthyWorkers, Placement, session_cost
from .rpc import FleetClient, FleetRemoteError, FleetRPCError
from .supervisor import FleetSupervisor

__all__ = [
    "FleetSupervisor", "FleetFrontDoor", "FleetClient",
    "Placement", "session_cost",
    "FleetRPCError", "FleetRemoteError", "SessionUnroutable",
    "AdoptionStalled", "NoHealthyWorkers",
    "Autoscaler", "AutoscaleConfig",
]
