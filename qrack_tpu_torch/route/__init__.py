"""Per-job representation routing (the port of the JAX package's
route/, docs/ROUTING.md).

Classify a submitted QCircuit into cheap static features, score the
candidate stacks (stabilizer hybrid / QBdt / QUnit-factored / dense
CUDA / compressed TurboQuant / light cone) against a tunable cost
model, and instantiate the winner per session, so one process serves a
w100 Clifford circuit next to a dense w22 one.  Imported lazily (the
factory's "route" pseudo-terminal); ``import qrack_tpu_torch`` alone
never pays for it.

Port notes: every weight, constant and knob is the JAX package's, so a
decision on the same features and budget is the same; ``layers_for``
names the dense terminal ``"cuda"`` where the JAX package says
``"tpu"``; the memory axis probes the card's total memory only once
CUDA is initialized (cost.py ``_probed_hbm_bytes``).
"""

from .cost import (INFEASIBLE, STACKS, RouteKnobs, choose_stack,
                   default_stack, layers_for, route_mode, score_stacks)
from .features import CircuitFeatures, extract_features
from .router import (MisrouteError, QRouted, RouteDecision, decide,
                     update_residency)


__all__ = [
    "CircuitFeatures", "extract_features",
    "RouteKnobs", "route_mode", "score_stacks", "choose_stack",
    "layers_for", "default_stack", "STACKS", "INFEASIBLE",
    "QRouted", "RouteDecision", "MisrouteError", "decide",
    "update_residency",
]
