"""Tunable cost model scoring candidate stacks for a feature vector.

Five candidate representations (docs/ROUTING.md):

* ``stabilizer`` — QStabilizerHybrid over the CHP tableau with a dense
  escape hatch below it.  Feasible when no payload is "general" and the
  magic (gadgetable T-like) count fits the ancilla budget; cost scales
  as gates * width^2 (tableau column ops), plus a per-gadget surcharge.
* ``bdt``        — QBdt hash-consed decision tree.  Always *runnable*,
  but only cheap while the tree stays small; the estimate bounds stored
  amplitudes by the worst cut's entangling-gate crossings (a bond-
  dimension heuristic, deliberately conservative and env-tunable).
* ``qunit``      — the OPTIMAL Schmidt-factoring stack; cost scales
  with the largest *entangled block* the circuit ever fuses, not the
  full width.
* ``dense``      — QEngineCUDA split planes (the only batchable stack);
  cost gates * 2^width, infeasible past the dense width cap or the
  device HBM budget.
* ``turboquant`` — the block-compressed dense-equivalent ket (int8/
  int16 codes + per-block scales).  Same O(2^w) sweep structure as
  dense with a per-gate dequant/requant tax, but 4x (int8) fewer HBM
  bytes — the tier an over-width dense job lands on instead of being
  refused.

Scores are abstract work units — only their ratios matter.  Feasibility
has TWO axes: a per-stack width/shape rule and a memory axis —
:func:`hbm_bytes` estimates each stack's resident HBM footprint and a
stack whose footprint exceeds :func:`hbm_budget_bytes` is INFEASIBLE
regardless of its work score.  Every knob is an env var so deployments
can re-weight without code changes:

  QRACK_ROUTE                auto | dense | stabilizer | bdt | qunit
                             | turboquant | lightcone
  QRACK_ROUTE_DENSE_MAX_QB   dense-representable width cap (default 26)
  QRACK_ROUTE_HBM_BYTES      device memory budget for the memory axis
                             (default: the card's total memory once
                             CUDA is initialized, else 16 GiB, the JAX
                             package's fallback)
  QRACK_ROUTE_MAX_MAGIC      stabilizer gadget budget (default 8)
  QRACK_ROUTE_BDT_MAX_NODES  QBdt escalation node budget (default 2^20)
  QRACK_ROUTE_STAB_WEIGHT    per-op weight multipliers ...
  QRACK_ROUTE_BDT_WEIGHT
  QRACK_ROUTE_QUNIT_WEIGHT
  QRACK_ROUTE_DENSE_WEIGHT
  QRACK_ROUTE_TQ_WEIGHT
  QRACK_ROUTE_LC_WEIGHT      lightcone per-cone-gate weight (default 4)
  QRACK_ROUTE_TQ_PAGES       device count for the turboquant-on-pager
                             rung of the ladder (default 1: single chip)

One guard rail sits above the scores: a fully-Clifford circuit always
routes to the stabilizer stack when feasible — its polynomial bound is
exact, while the QBdt/QUnit numbers are heuristics, and a heuristic
should never outbid a guarantee.

Port notes (the JAX package's route/cost.py otherwise): ``layers_for``
names the dense terminal ``"cuda"``; a routed wrapper or trajectory
job prices against its own device (``RouteKnobs.for_device``: a CUDA
device's total memory through ``torch.cuda.mem_get_info``, which
starts CUDA there, and 16 GiB for the host); a caller that names no
device gets ``_probed_hbm_bytes``, which reads the card only when CUDA
is already initialized, as the JAX probe reads only a live backend;
``_tq_geometry``
reads the knobs of the port's TurboQuant engine.  Every weight and
constant keeps its JAX value, so the same features and budget give the
same decision in both packages.  On the card the budget is the card's
(80 GB on an H100), so a decision where the 16 GiB fallback binds may
differ from the CPU's by design: a w32 int8 TurboQuant ket prices at
16.5 GiB, which fits the H100 and not the fallback.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from .features import CircuitFeatures

INFEASIBLE = float("inf")

STACKS = ("stabilizer", "bdt", "qunit", "dense", "turboquant")

# the lightcone rung scores alongside STACKS but is not a ket
# representation: it buffers the circuit and builds cone-width kets at
# read time (lightcone/engine.py), so it lives outside the STACKS tuple
# that sizes residency/HBM tables yet is a first-class routing outcome
_ORDER = STACKS + ("lightcone",)

_MODES = ("auto",) + _ORDER

# dense resident bytes per amplitude: two f32 planes (re/im) times the
# donation double-buffer every jitted kernel needs in flight
DENSE_BYTES_PER_AMP = 16

# the chunked turboquant kernels split (chunk, local) indices, so they
# are not int32-bound past the dense limit; the single-device width
# ceiling is the dense cap plus the compression win (engines/
# turboquant.py _compressed_cap)
_TQ_BASE_CAP = 30  # engines/cuda.py MAX_DENSE_QB, kept import-free here


def route_mode() -> str:
    """Current QRACK_ROUTE value (re-read per call: tests and operators
    flip it at runtime).  Unknown values fall back to "auto" loudly at
    decision time rather than silently pinning."""
    mode = os.environ.get("QRACK_ROUTE", "auto").strip().lower() or "auto"
    return mode if mode in _MODES else "auto"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class RouteKnobs:
    dense_max_qb: int = 26
    max_magic: int = 8
    bdt_max_nodes: int = 1 << 20
    stab_weight: float = 1.0
    # the tree's per-node constant is host-side python, ~2^10 of a
    # vectorized dense lane (measured: qaoa12 tree 590ms vs dense 11ms
    # warm; trotter16 13s vs 32ms) — so the tree only wins when its
    # bond bound beats the full width by >10 qubits, i.e. wide weakly-
    # entangled circuits, and it stays the only runnable stack past the
    # dense cap when stabilizer/qunit are infeasible
    bdt_weight: float = 1024.0
    qunit_weight: float = 2.0
    dense_weight: float = 1.0
    # per-gate the compressed ket pays a full dequant-matmul ->
    # requant-matmul round trip on top of the gate contraction
    # (scripts/turboquant_bench.py walls vs the dense per-gate floor),
    # so at dense-feasible widths dense always outbids it; past the
    # dense cap it is ~2^7 cheaper per gate than the tree's host-side
    # node constant, which is the whole point of the tier
    tq_weight: float = 8.0
    # lightcone reads re-slice + re-run the cone sub-circuit per
    # distinct observable (no shared full ket), so its per-gate unit is
    # a few dense sweeps of the CONE width — cheap when the cone is
    # narrow, never competitive when dense can hold the full width
    lc_weight: float = 4.0
    # 0 = probe the card (falling back to the JAX package's 16 GiB)
    hbm_bytes: int = 0
    # devices available to the turboquant-on-pager ladder rung
    tq_pages: int = 1

    @classmethod
    def from_env(cls) -> "RouteKnobs":
        return cls(
            dense_max_qb=_env_int("QRACK_ROUTE_DENSE_MAX_QB", 26),
            max_magic=_env_int("QRACK_ROUTE_MAX_MAGIC", 8),
            bdt_max_nodes=_env_int("QRACK_ROUTE_BDT_MAX_NODES", 1 << 20),
            stab_weight=_env_float("QRACK_ROUTE_STAB_WEIGHT", 1.0),
            bdt_weight=_env_float("QRACK_ROUTE_BDT_WEIGHT", 1024.0),
            qunit_weight=_env_float("QRACK_ROUTE_QUNIT_WEIGHT", 2.0),
            dense_weight=_env_float("QRACK_ROUTE_DENSE_WEIGHT", 1.0),
            tq_weight=_env_float("QRACK_ROUTE_TQ_WEIGHT", 8.0),
            lc_weight=_env_float("QRACK_ROUTE_LC_WEIGHT", 4.0),
            hbm_bytes=_env_int("QRACK_ROUTE_HBM_BYTES", 0),
            tq_pages=_env_int("QRACK_ROUTE_TQ_PAGES", 1),
        )

    @classmethod
    def for_device(cls, device) -> "RouteKnobs":
        """The env knobs with the budget of a stack on `device` filled
        in where QRACK_ROUTE_HBM_BYTES leaves it unset
        (:func:`device_hbm_bytes`); `device=None` keeps the probe."""
        k = cls.from_env()
        if k.hbm_bytes <= 0 and device is not None:
            k = replace(k, hbm_bytes=device_hbm_bytes(device))
        return k


# ---------------------------------------------------------------------------
# the memory axis: resident HBM bytes per stack vs the device budget
# ---------------------------------------------------------------------------

_PROBED_HBM: Optional[int] = None
_FALLBACK_HBM = 16 << 30
_DEVICE_HBM: Dict[int, int] = {}


def device_hbm_bytes(device) -> int:
    """The raw budget of a stack on `device`: a CUDA device's total
    memory, read through ``torch.cuda.mem_get_info`` (which starts CUDA
    there, as the stack itself will), else the 16 GiB fallback -- a
    stack on the host is never priced against the card."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return _FALLBACK_HBM
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _DEVICE_HBM:
        _free, total = torch.cuda.mem_get_info(idx)
        _DEVICE_HBM[idx] = int(total)
    return _DEVICE_HBM[idx]


def _probed_hbm_bytes() -> int:
    """Device memory budget when QRACK_ROUTE_HBM_BYTES is unset: the
    current card's total memory, read only when CUDA is ALREADY
    initialized -- cost scoring is pure host work on the submit thread
    and never starts a CUDA context.  Falls back to 16 GiB (the JAX
    package's fallback); the fallback is not remembered, so the first
    decision after CUDA starts reads the card.  A routed wrapper prices
    against its own device instead (:meth:`RouteKnobs.for_device`)."""
    global _PROBED_HBM
    if _PROBED_HBM is not None:
        return _PROBED_HBM
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        try:
            if torch_mod.cuda.is_initialized():
                _free, total = torch_mod.cuda.mem_get_info()
                if int(total) > 0:
                    _PROBED_HBM = int(total)
                    return _PROBED_HBM
        except Exception:  # noqa: BLE001 -- the probe is best-effort
            pass
    return _FALLBACK_HBM


_HBM_RESERVATION: Optional[object] = None


def set_hbm_reservation(fn) -> None:
    """Install (``fn`` = zero-arg callable returning bytes) or clear
    (``fn=None``) a standing HBM reservation the budget subtracts —
    the serving plane wires the prefix cache's ``resident_bytes`` here
    so admission prices circuits against the headroom that actually
    remains, not the raw device size.  The effective budget is floored
    at 1/16 of the raw budget: a runaway reservation can degrade
    routing, never starve it."""
    global _HBM_RESERVATION
    _HBM_RESERVATION = fn


def less_reservation(budget: int) -> int:
    """`budget` less the standing reservation (set_hbm_reservation),
    floored at 1/16 of `budget`; noise/trajectories.py applies it to
    the card's free memory too."""
    if _HBM_RESERVATION is not None:
        try:
            reserved = int(_HBM_RESERVATION())
        except Exception:  # noqa: BLE001 — reservation is best-effort
            reserved = 0
        if reserved > 0:
            budget = max(budget - reserved, budget // 16)
    return budget


def hbm_budget_bytes(knobs: Optional["RouteKnobs"] = None) -> int:
    """The device HBM budget the memory axis scores against."""
    k = knobs or RouteKnobs.from_env()
    return less_reservation(k.hbm_bytes if k.hbm_bytes > 0
                            else _probed_hbm_bytes())


def _tq_geometry() -> Tuple[int, int, int]:
    """(bits, block_pow, itemsize) the turboquant tier would be built
    with — read from the same env knobs the engine ctor honors, so the
    cost model prices the stack the factory would actually build."""
    from ..storage import turboquant as _tq

    bits = _env_int("QRACK_TURBO_BITS", _tq.DEFAULT_BITS)
    block_pow = _env_int("QRACK_TURBO_BLOCK_POW", _tq.DEFAULT_BLOCK_POW)
    return bits, block_pow, (1 if bits <= 8 else 2)


def hbm_bytes(stack: str, f: CircuitFeatures,
              knobs: Optional["RouteKnobs"] = None) -> float:
    """Estimated resident HBM footprint of `stack` for `f`, in bytes.
    Host-side representations (tableau, tree) cost ~0 HBM.  Pager
    variants divide the same footprint over their pages; this returns
    the PER-DEVICE number the budget is compared against."""
    k = knobs or RouteKnobs.from_env()
    w = max(f.width, 1)
    # trajectory batches keep `shots` dense kets resident at once
    # (noise/trajectories.py): the memory axis prices the BATCH, not
    # one ket — B·16·2^w against the budget decides chunking
    shots = max(int(getattr(f, "shots", 1)), 1)
    if stack == "dense":
        return float(shots) * float(DENSE_BYTES_PER_AMP) * float(2 ** w)
    if stack == "qunit":
        blk = min(f.max_component, w)
        return float(DENSE_BYTES_PER_AMP) * float(2 ** blk)
    if stack == "turboquant":
        bits, block_pow, itemsize = _tq_geometry()
        # codes are (B, 2D) = 2^(w+1) entries; scales one f32 per block;
        # double-buffered like the dense planes (donated kernel I/O)
        codes = 2.0 * float(2 ** w) * itemsize
        scales = 4.0 * float(2 ** max(w - block_pow, 0))
        per_device = 2.0 * (codes + scales)
        return per_device / max(k.tq_pages, 1)
    if stack == "lightcone":
        # resident footprint is the widest cone ket a single-qubit read
        # can build, never the declared width
        cone = min(max(int(getattr(f, "max_cone_width", w)), 1), w)
        return float(DENSE_BYTES_PER_AMP) * float(2 ** cone)
    return 0.0  # stabilizer / bdt: host-side state


def _tq_width_cap(k: "RouteKnobs") -> int:
    """Width ceiling of the turboquant rung: the single-device
    compressed cap plus the pager's page bits when a mesh is declared."""
    bits, _, _ = _tq_geometry()
    cap = _TQ_BASE_CAP + (2 if bits <= 8 else 1)
    pages = max(k.tq_pages, 1)
    return cap + max(pages - 1, 0).bit_length()


def score_stacks(f: CircuitFeatures,
                 knobs: Optional[RouteKnobs] = None) -> Dict[str, float]:
    """Abstract work-unit score per candidate stack; INFEASIBLE marks a
    representation that cannot (or must not) take this circuit."""
    k = knobs or RouteKnobs.from_env()
    w = max(f.width, 1)
    g = max(f.gate_count, 1)
    budget = hbm_budget_bytes(k)
    scores: Dict[str, float] = {}

    # dense split planes: every gate sweeps the whole 2^w ket.  Two
    # feasibility axes: the representable-width knob AND the memory
    # axis — a width under the cap is still infeasible on a device
    # whose HBM cannot hold the ket plus donation headroom
    if w <= k.dense_max_qb and hbm_bytes("dense", f, k) <= budget:
        scores["dense"] = g * float(2 ** w) * k.dense_weight
    else:
        scores["dense"] = INFEASIBLE

    # stabilizer tableau: O(w^2) per Clifford op; each gadgetable magic
    # payload costs an ancilla column + a forced-measurement cascade
    if f.general_count == 0 and f.magic_count <= k.max_magic:
        scores["stabilizer"] = (g * float(w * w)
                                + f.magic_count * float(w * w) * 16.0
                                ) * k.stab_weight
    else:
        scores["stabilizer"] = INFEASIBLE

    # QBdt: stored amplitudes bounded by the worst cut's bond growth —
    # each entangling gate crossing a cut can at most double the bond
    bdt_pow = min(w, 2 * f.max_cut_crossings + 1)
    scores["bdt"] = g * float(2 ** bdt_pow) * k.bdt_weight

    # QUnit: dense work confined to the largest entangled block
    blk = min(f.max_component, w)
    scores["qunit"] = (g * float(2 ** blk) * k.qunit_weight
                       if blk <= k.dense_max_qb
                       and hbm_bytes("qunit", f, k) <= budget
                       else INFEASIBLE)

    # turboquant: dense-equivalent sweeps on the compressed ket — same
    # O(2^w) scaling, a constant dequant/requant tax, and a 4x (int8)
    # smaller HBM footprint, so it stays feasible past the dense rung
    if w <= _tq_width_cap(k) and hbm_bytes("turboquant", f, k) <= budget:
        scores["turboquant"] = g * float(2 ** w) * k.tq_weight
    else:
        scores["turboquant"] = INFEASIBLE

    # lightcone: buffer the circuit, build cone-width kets at read time
    # (lightcone/engine.py).  Deliberately a LAST-RESORT rung: feasible
    # only when no full-width dense-equivalent ket fits (dense
    # infeasible) AND the cone genuinely beats the width AND the cone
    # itself clears a dense/turboquant rung — it replaces refusals, it
    # does not steal jobs a resident ket would serve better (repeated
    # reads amortize on a ket; cones re-run per observable)
    cone = min(max(int(getattr(f, "max_cone_width", w)), 1), w)
    if (scores["dense"] == INFEASIBLE and cone < w
            and ladder_stack(cone, k) is not None):
        scores["lightcone"] = g * float(2 ** cone) * k.lc_weight
    else:
        scores["lightcone"] = INFEASIBLE
    return scores


def choose_stack(f: CircuitFeatures,
                 knobs: Optional[RouteKnobs] = None,
                 mode: Optional[str] = None) -> Tuple[str, Dict[str, float]]:
    """(stack, scores) for `f` under `mode` (default: QRACK_ROUTE)."""
    k = knobs or RouteKnobs.from_env()
    mode = mode or route_mode()
    scores = score_stacks(f, k)
    if mode != "auto":
        return mode, scores
    # guard rail: exact polynomial representation beats any heuristic
    if f.is_clifford and scores["stabilizer"] != INFEASIBLE:
        return "stabilizer", scores
    # the QBdt estimate is never infeasible (the tree always represents
    # the state; the node-budget probe escalates it if it blows up), so
    # min() always lands on a runnable stack
    best = min(scores, key=lambda s: (scores[s], _ORDER.index(s)))
    return best, scores


def layers_for(stack: str, width: int,
               knobs: Optional[RouteKnobs] = None) -> Tuple[str, ...]:
    """Factory layer spec realizing `stack` at `width`.  The stabilizer
    route keeps a dense escape below it sized to the width: within the
    dense cap the escape is the batch-capable CUDA engine, past it the
    width-switching hybrid (which would only be exercised by a
    mis-route the admission probes failed to catch)."""
    k = knobs or RouteKnobs.from_env()
    if stack == "dense":
        return ("cuda",) if width <= k.dense_max_qb else ("hybrid",)
    if stack == "stabilizer":
        return (("stabilizer_hybrid", "cuda") if width <= k.dense_max_qb
                else ("stabilizer_hybrid", "hybrid"))
    if stack == "bdt":
        return ("bdt",)
    if stack == "qunit":
        return ("unit", "stabilizer_hybrid", "hybrid")
    if stack == "turboquant":
        # single-device compressed cap first; past it (or when only the
        # page-divided footprint fits the budget) the sharded variant
        bits, _, _ = _tq_geometry()
        single_cap = _TQ_BASE_CAP + (2 if bits <= 8 else 1)
        if width <= single_cap and k.tq_pages <= 1:
            return ("turboquant",)
        f = _WidthOnly(width)
        if (width <= single_cap
                and hbm_bytes("turboquant", f, _single_page(k))
                <= hbm_budget_bytes(k)):
            return ("turboquant",)
        return ("turboquant_pager",)
    if stack == "lightcone":
        return ("lightcone",)
    raise ValueError(f"unknown route stack {stack!r}")


class _WidthOnly:
    """Minimal feature stand-in for width-driven hbm_bytes queries."""

    def __init__(self, width: int):
        self.width = width
        self.max_component = width


def _single_page(k: RouteKnobs) -> RouteKnobs:
    from dataclasses import replace

    return replace(k, tq_pages=1) if k.tq_pages != 1 else k


def ladder_stack(width: int,
                 knobs: Optional[RouteKnobs] = None,
                 features: Optional[CircuitFeatures] = None) -> Optional[str]:
    """The escalation ladder, bottom-up: the cheapest dense-equivalent
    stack that can HOLD `width` on this device budget.  "dense" when
    both the width knob and the memory axis allow it, else the
    compressed rung, else — only when the caller passes `features`
    carrying a cone bound — the lightcone rung, else None (nothing on
    the ladder fits — the caller refuses rather than serving garbage).
    Used both by plan() when a stabilizer-resident circuit goes general
    past the dense cap and by escalation paths deciding where a
    quantized session lands.  plan()'s mid-flight escalation does NOT
    pass features (a half-executed eager session cannot be re-sliced),
    so the lightcone rung is only offered at circuit admission time."""
    k = knobs or RouteKnobs.from_env()
    f = _WidthOnly(width)
    budget = hbm_budget_bytes(k)
    if width <= k.dense_max_qb and hbm_bytes("dense", f, k) <= budget:
        return "dense"
    if width <= _tq_width_cap(k) and hbm_bytes("turboquant", f, k) <= budget:
        return "turboquant"
    if features is not None:
        cone = min(max(int(getattr(features, "max_cone_width", width)), 1),
                   width)
        if cone < width and ladder_stack(cone, k) is not None:
            return "lightcone"
    return None


def default_stack(width: int, knobs: Optional[RouteKnobs] = None,
                  mode: Optional[str] = None) -> str:
    """Stack for an eager-gate caller (no circuit to inspect): start on
    the stabilizer hybrid — Clifford prefixes stay polynomial and the
    first general gate escapes to dense on its own — unless pinned."""
    k = knobs or RouteKnobs.from_env()
    mode = mode or route_mode()
    if mode != "auto":
        return mode
    return "stabilizer"


__all__ = ["INFEASIBLE", "STACKS", "DENSE_BYTES_PER_AMP", "RouteKnobs",
           "route_mode", "score_stacks", "choose_stack", "layers_for",
           "default_stack", "hbm_bytes", "hbm_budget_bytes",
           "less_reservation", "set_hbm_reservation", "ladder_stack"]
