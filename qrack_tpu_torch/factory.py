"""Stack factory (reference: include/qfactory.hpp:49
CreateQuantumInterface — recursive layer construction from a type
vector; :265 CreateArrangedLayersFull — boolean layer toggles).  The
ported layers, top-down:

  "noisy"              QInterfaceNoisy: a weak depolarizing channel after
                       every gate on every touched qubit (``noise`` opt,
                       else QRACK_GATE_DEPOLARIZATION); as a terminal,
                       QNoisy, the one-trajectory engine of noise/
                       (``model``/``noise`` opts) over the "cuda"
                       engine, or the "cpu" oracle when device="cpu"
  "tensor_network"     QTensorNetwork: circuit buffering, past-light-cone
                       reads
  "unit"               QUnit Schmidt factoring over lower-layer units
  "unit_multi"         QUnitMulti: QUnit that places each unit on a row
                       of a device table (``device_ids``, CUDA ordinals;
                       a card may repeat; env QRACK_QUNITMULTI_DEVICES)
  "stabilizer_hybrid"  Clifford tableau until a non-Clifford op forces a
                       dense engine
  "bdt_hybrid"         QBdtHybrid: decision tree until it stops
                       compressing, then the layers below

and the ported terminals:

  "cuda"          QEngineCUDA single-device dense engine (the JAX
                  package's "tpu" terminal)
  "cpu"           QEngineCPU host oracle (numpy, complex128 by default;
                  takes no device)
  "hybrid"        QHybrid: QEngineCPU below hybrid_tpu_threshold_qubits
                  (QRACK_TPU_THRESHOLD_QB, 13), QEngineCUDA from there to
                  max_page_qubits (30), QPager past it over ``devices``;
                  ``device``/``dtype`` reach the CUDA engine and the pager
  "pager"         QPager: the ket in pages over a device list that may
                  repeat a device (``devices``, ``n_pages``, ``remap``,
                  ``collective``; env QRACK_QPAGER_DEVICES), e.g.
                  ``devices=["cuda:0"] * 4`` for 32 qubits on one card
  "sparse"        QEngineSparse: sorted int64 indices and complex128
                  amplitudes on the host, up to 62 qubits (numpy; takes no
                  device; env QRACK_SPARSE_TRUNCATION_THRESHOLD,
                  QRACK_SPARSE_MAX_ALLOC_MB)
  "turboquant"    QEngineCUDATurboQuant block-compressed resident ket
                  (options bits, block_pow, chunk_qb, seed_rot; env
                  QRACK_TURBO_BITS, QRACK_TURBO_BLOCK_POW,
                  QRACK_TURBOQUANT_CHUNK_QB, QRACK_PALLAS_TQ_TILE_QB)
  "turboquant_pager"  QPagerTurboQuant: the compressed ket in pages over a
                  device list that may repeat a device (``devices``,
                  ``n_pages``; the "turboquant" options), plain chunk
                  programs, no kernel
  "route"         QRouted: builds nothing until the first QCircuit (or
                  eager gate) arrives, then the stack the cost model
                  picks for it (route/; QRACK_ROUTE pins one), through
                  this factory
  "lightcone"     QLightCone: gates buffer on the host; each read runs
                  its past light cone, relabeled onto a cone-width
                  register, through "route" (lightcone/)
  "stabilizer"    QStabilizer bare CHP tableau (Clifford only; host)
  "unit_clifford" QUnitClifford: QUnit over per-subsystem tableaus
  "bdt"           QBdt decision tree (host nodes; device leaves)
  "bdt_attached"  QBdt with dense leaf kets under the tree
                  (attached_qubits kwarg; default n // 2 or
                  QRACK_QBDT_ATTACH_QB), on the card from
                  QRACK_QBDT_LEAF_DEVICE_QB (14) attached qubits

``"optimal"`` is OPTIMAL = ["unit", "stabilizer_hybrid", "hybrid"], the
reference's production stack shape over the CUDA dense bottom;
``"optimal_multi"`` is OPTIMAL_MULTI, the same with "unit_multi" on top.
``device``/``dtype`` go to the terminal, and to "bdt_hybrid" for its
tree, so every engine a stack builds lies on ``cuda`` unless
``device="cpu"``; "route" and "lightcone" hand them (and
``failover_cpu``) to every stack they build.  The JAX package's other
layer, "tpu", raises ValueError naming the port's "cuda".

With the resilience plane armed (resilience/), the accelerator
terminals "cuda", "pager", "turboquant" and "turboquant_pager" are
wrapped in ResilientEngine, whose failover chain stays on the card;
``failover_cpu=True`` names the CPU as its last rung (and QHybrid's),
which it never is otherwise."""

from __future__ import annotations

import os
from typing import Callable, List, Sequence, Union

from . import resilience as _res
from . import telemetry as _tele

OPTIMAL = ("unit", "stabilizer_hybrid", "hybrid")
OPTIMAL_MULTI = ("unit_multi", "stabilizer_hybrid", "hybrid")

_TERMINAL = {"cuda", "cpu", "hybrid", "pager", "sparse", "turboquant",
             "turboquant_pager", "stabilizer", "unit_clifford", "bdt",
             "bdt_attached", "route", "lightcone"}

#: terminals that run on the host and refuse a device
_HOST_TERMINALS = {"cpu", "sparse"}

#: terminals that ResilientEngine wraps while the resilience plane is
#: armed (the JAX package's accelerator terminals, "tpu" renamed)
_ACCEL_TERMINALS = {"cuda", "pager", "turboquant", "turboquant_pager"}


def touches_accelerator(layers: Union[str, Sequence[str]]) -> bool:
    """True when a layer spec's terminal dispatches on the card (directly,
    or through QHybrid's width switch).  The serving plane classifies
    sessions with it for breaker-aware load shedding before an engine
    exists; a live session is classified by its actual engine
    (serve/session.py ``engine_touches_tunnel``)."""
    if isinstance(layers, str):
        if layers in ("optimal", "optimal_multi"):
            return True  # OPTIMAL terminates in "hybrid"
        layers = (layers,)
    term = layers[-1] if layers else ""
    return term in _ACCEL_TERMINALS or term == "hybrid"


#: layers of the JAX package's factory that the port lacks, with the
#: ROADMAP item that brings each
_NOT_PORTED = {
    "tpu": "the port's dense terminal is 'cuda'",
}


def _not_ported(name: str) -> ValueError:
    return ValueError(f"layer {name!r} is not ported yet: "
                      f"{_NOT_PORTED[name]}")


def _counted(name: str, fn: Callable) -> Callable:
    """Count stack constructions per layer (telemetry:
    ``factory.create.<name>``); runs at construction only."""
    def make(n, **kw):
        if _tele._ENABLED:
            _tele.inc(f"factory.create.{name}")
        return fn(n, **kw)
    return make


def _maybe_resilient(name: str, fn: Callable,
                     failover_cpu: bool = False) -> Callable:
    """Wrap a bare accelerator terminal in ResilientEngine when the
    resilience layer is active, so a factory-built stack gets the
    failover chain QHybrid has (construction-time failures included).
    _ACTIVE is re-read per construction: enabling resilience after
    import still takes effect."""
    if name not in _ACCEL_TERMINALS:
        return fn

    def make(n, **kw):
        if not _res._ACTIVE:
            return fn(n, **kw)
        from .resilience.failover import ResilientEngine

        return ResilientEngine.build(fn, n, failover_cpu=failover_cpu, **kw)

    return make


def _terminal_factory(name: str, **opts) -> Callable:
    if name == "cuda":
        from .engines.cuda import QEngineCUDA

        return lambda n, **kw: QEngineCUDA(n, **{**opts, **kw})
    if name == "cpu":
        from .engines.cpu import QEngineCPU

        return lambda n, **kw: QEngineCPU(n, **{**opts, **kw})
    if name == "hybrid":
        from .engines.hybrid import QHybrid

        return lambda n, **kw: QHybrid(n, **{**opts, **kw})
    if name == "pager":
        from .parallel.pager import QPager

        return lambda n, **kw: QPager(n, **{**opts, **kw})
    if name == "sparse":
        from .engines.sparse import QEngineSparse

        return lambda n, **kw: QEngineSparse(n, **{**opts, **kw})
    if name == "turboquant":
        from .engines.turboquant import QEngineCUDATurboQuant

        return lambda n, **kw: QEngineCUDATurboQuant(n, **{**opts, **kw})
    if name == "turboquant_pager":
        from .parallel.turboquant_pager import QPagerTurboQuant

        return lambda n, **kw: QPagerTurboQuant(n, **{**opts, **kw})
    if name == "stabilizer":
        from .layers.stabilizer import QStabilizer

        return lambda n, **kw: QStabilizer(n, **{**opts, **kw})
    if name == "unit_clifford":
        from .layers.qunitclifford import QUnitClifford

        return lambda n, **kw: QUnitClifford(n, **{**opts, **kw})
    if name == "bdt":
        from .layers.qbdt import QBdt

        return lambda n, **kw: QBdt(n, **{**opts, **kw})
    if name == "bdt_attached":
        from .layers.qbdt import QBdt

        def mk_attached(n, **kw):
            kw = {**opts, **kw}
            if "attached_qubits" not in kw:
                kw["attached_qubits"] = int(os.environ.get(
                    "QRACK_QBDT_ATTACH_QB", str(n // 2)))
            return QBdt(n, **kw)

        return mk_attached
    if name == "route":
        # pseudo-terminal: construction builds no stack; the chosen one
        # is built through this factory, so resilience wrapping and the
        # per-layer creation counters apply to it
        from .route.router import QRouted

        return lambda n, **kw: QRouted(n, **{**opts, **kw})
    if name == "lightcone":
        # pseudo-terminal like "route": the cone-width stacks each read
        # builds come back through this factory (via "route")
        from .lightcone.engine import QLightCone

        return lambda n, **kw: QLightCone(n, **{**opts, **kw})
    raise ValueError(f"unknown terminal layer {name!r}")


def build_factory(layers: Sequence[str], **opts) -> Callable:
    """Compose a constructor fn(n, **kw) from a top-down layer list
    (reference: CreateQuantumInterface recursion, qfactory.hpp:189-258)."""
    if not layers:
        raise ValueError("empty layer list")
    head, rest = layers[0], layers[1:]
    if head in _NOT_PORTED:
        raise _not_ported(head)
    dev = {k: v for k, v in opts.items() if k in ("device", "dtype")}
    if head in _TERMINAL:
        if rest:
            raise ValueError(f"terminal layer {head!r} must be last")
        fo = bool(opts.get("failover_cpu", False))
        if head in ("route", "lightcone", "hybrid"):
            # their stacks come back through this factory, with these
            return _counted(head, _terminal_factory(
                head, **dev, **({"failover_cpu": True} if fo else {})))
        return _counted(head, _maybe_resilient(
            head, _terminal_factory(head, **dev), fo))
    below = None
    if rest:
        # a host terminal ("cpu", "sparse") under a layer takes no device
        # or plane dtype: those are the layers' (a tree's device leaves)
        host = len(rest) == 1 and rest[0] in _HOST_TERMINALS
        below = build_factory(rest, **({k: v for k, v in opts.items()
                                        if k not in dev} if host else opts))
    if head == "unit":
        from .layers.qunit import QUnit

        return _counted(head, lambda n, **kw: QUnit(n, unit_factory=below,
                                                    **kw))
    if head == "unit_multi":
        from .layers.qunitmulti import QUnitMulti

        return _counted(head, lambda n, **kw: QUnitMulti(
            n, unit_factory=below, **kw))
    if head == "stabilizer_hybrid":
        from .layers.stabilizerhybrid import QStabilizerHybrid

        return _counted(head, lambda n, **kw: QStabilizerHybrid(
            n, engine_factory=below, **kw))
    if head == "tensor_network":
        from .layers.qtensornetwork import QTensorNetwork

        return _counted(head, lambda n, **kw: QTensorNetwork(
            n, stack_factory=below, **kw))
    if head == "bdt_hybrid":
        from .layers.qbdthybrid import QBdtHybrid

        return _counted(head, lambda n, **kw: QBdtHybrid(
            n, engine_factory=below, **{**dev, **kw}))
    if head == "noisy":
        noise = opts.get("noise")
        if below is None:
            # terminal form: the trajectory-rng QNoisy engine over the
            # dense engine (the host oracle with device="cpu") — branch
            # choices come from (key, trajectory_id, app_seq) counters,
            # not the engine's sequential rng stream (noise/channels.py)
            from .noise.channels import QNoisy

            model = opts.get("model")
            return _counted(head, lambda n, **kw: QNoisy(
                n, model=model, noise=noise, **{**dev, **kw}))
        from .layers.noisy import QInterfaceNoisy

        return _counted(head, lambda n, **kw: QInterfaceNoisy(
            n, inner_factory=below, noise=noise, **kw))
    raise ValueError(f"unknown layer {head!r}")


def create_quantum_interface(layers: Union[str, Sequence[str]], qubit_count: int,
                             init_state: int = 0, **kwargs):
    """Build a simulator stack, e.g. ``create_quantum_interface("optimal",
    40)``, ``create_quantum_interface("cuda", 30)``,
    ``create_quantum_interface(["stabilizer_hybrid", "hybrid"], 18)`` or,
    on the CPU, ``create_quantum_interface("optimal", 10, device="cpu")``.
    ``failover_cpu=True`` lets the resilience plane's failover chain end
    on the CPU (resilience/__init__.py)."""
    if isinstance(layers, str):
        layers = {"optimal": OPTIMAL,
                  "optimal_multi": OPTIMAL_MULTI}.get(layers, (layers,))
    opts = {k: kwargs.pop(k) for k in ("dtype", "device", "noise", "model",
                                       "failover_cpu") if k in kwargs}
    if _tele._ENABLED:
        _tele.inc("factory.create_interface")
    factory = build_factory(tuple(layers), **opts)
    return factory(qubit_count, init_state=init_state, **kwargs)


def create_arranged_layers_full(nw: bool = False, md: bool = False, sd: bool = True,
                                sh: bool = True, bdt: bool = False, pg: bool = True,
                                tn: bool = False, hy: bool = True, oc: bool = True,
                                qubit_count: int = 1, **kwargs):
    """Boolean layer toggles matching the reference's pinvoke `init`
    signature (reference: include/qfactory.hpp:265
    CreateArrangedLayersFull): nw=noisy wrapper, md=multi-device QUnit,
    sd=Schmidt decomposition (QUnit), sh=stabilizer hybrid, bdt=binary
    decision tree hybrid, pg=paging, tn=tensor network, hy=hybrid,
    oc="OpenCL", the accelerator ("cuda" here)."""
    layers: List[str] = []
    if nw:
        layers.append("noisy")
    if tn:
        layers.append("tensor_network")
    if sd:
        layers.append("unit_multi" if md else "unit")
    if sh:
        layers.append("stabilizer_hybrid")
    if bdt:
        layers.append("bdt_hybrid")
    if hy:
        layers.append("hybrid")
    elif pg and oc:
        layers.append("pager")
    elif oc:
        layers.append("cuda")
    else:
        layers.append("cpu")
    return create_quantum_interface(layers, qubit_count, **kwargs)
