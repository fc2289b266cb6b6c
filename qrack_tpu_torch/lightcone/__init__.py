"""Light-cone circuit engine: shallow observables never build a ket.

``QLightCone`` (engine.py; the port of the JAX package's
lightcone/) is the repo's rendition of the reference
stack's top simulation layer semantics (reference:
include/qtensornetwork.hpp — buffer the circuit, elide everything
outside the past light cone of the thing being measured): gates buffer
into a :class:`~qrack_tpu_torch.layers.qcircuit.QCircuit` instead of
dispatching, and every observable read slices the buffer to the
requested qubits' past light cone, relabels the cone onto a compact
register of cone width, and executes that sub-circuit through the
routed ladder (``"route"`` — stabilizer/bdt/turboquant/dense), so a
w80 depth-4 local observable costs ~2^(depth*locality), never 2^w
(arXiv:2304.14969; docs/LIGHTCONE.md).

Wired as a first-class ladder rung: ``route/cost.py`` prices it by the
circuit's maximum single-qubit cone width (``features.py``
``max_cone_width``), the factory exposes terminal ``"lightcone"``,
:func:`sliced_shape_key` is the serving plane's shape key for lightcone
jobs (the serving plane is ROADMAP item 16b), and checkpoint kind
``"lightcone"`` round-trips the buffered circuit plus any materialized
cone kets bit-identically, across both packages.
"""

from .engine import QLightCone, sliced_shape_key

__all__ = ["QLightCone", "sliced_shape_key"]
