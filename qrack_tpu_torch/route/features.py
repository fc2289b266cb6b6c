"""Static circuit features for representation routing.

One pass over a ``QCircuit``'s gate list yields everything the cost
model (cost.py) needs to score candidate stacks: Clifford / magic /
general gate counts, entangling topology (distinct pairs, connected
components, max cut crossings for a tree-width-ish QBdt bound), width
and depth.  Everything here is host-side numpy on 2x2 payloads — no
device traffic, no engine construction — so feature extraction is safe
on the submit (caller) thread.

Payload classification mirrors what the cheap layers actually accept:

* uncontrolled 1q gate: Clifford iff layers/stabilizer.py can emit a
  tableau sequence for it (``clifford_sequence``); a non-Clifford
  *monomial* (phase or invert matrix) is "magic" — the stabilizer
  hybrid can buffer it as a shard and inject it via the reverse
  T-gadget; anything else is "general" and forces a dense engine.
* controlled gate: Clifford only for a SINGLE control whose payload is
  monomial with entries in {±1, ±i} and even entry-ratio parity (the
  exact test layers/stabilizer.py:MCMtrxPerm applies — CX/CZ/CY and
  phased variants).  A non-Clifford controlled gate is NOT gadgetable:
  it lands as "general".

Port note: a copy of the JAX package's route/features.py over the
port's ``matrices`` and ``layers/stabilizer.clifford_sequence``; the
same circuit gives the same features in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from .. import matrices as mat
from ..layers.stabilizer import clifford_sequence

_I_POWERS = (1.0 + 0.0j, 1.0j, -1.0 + 0.0j, -1.0j)


def _i_power(v: complex, tol: float = 1e-9):
    for k, w in enumerate(_I_POWERS):
        if abs(v - w) <= tol:
            return k
    return None


def _is_unitary(m: np.ndarray, tol: float = 1e-9) -> bool:
    return bool(np.allclose(m @ m.conj().T, np.eye(2), atol=tol))


def _ctrl_clifford(m: np.ndarray) -> bool:
    """Single-control Clifford test (layers/stabilizer.py:MCMtrxPerm):
    monomial payload, entries i^k, entry-ratio parity even."""
    if mat.is_phase(m):
        p0, p1 = _i_power(m[0, 0]), _i_power(m[1, 1])
    elif mat.is_invert(m):
        p0, p1 = _i_power(m[0, 1]), _i_power(m[1, 0])
    else:
        return False
    if p0 is None or p1 is None:
        return False
    return (p1 - p0) % 2 == 0


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))
        self.size = [1] * n

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]

    def max_component(self) -> int:
        return max((self.size[self.find(i)]
                    for i in range(len(self.parent))), default=1)


@dataclass
class CircuitFeatures:
    width: int
    gate_count: int = 0
    depth: int = 0
    clifford_count: int = 0
    magic_count: int = 0       # gadgetable non-Clifford monomials (T-like)
    general_count: int = 0     # forces a dense engine
    entangling_count: int = 0  # gates with >= 1 control
    multi_ctrl_count: int = 0
    distinct_pairs: int = 0
    max_degree: int = 0
    nn_fraction: float = 1.0   # |t - c| == 1 fraction of entangling gates
    max_component: int = 1     # largest entangled qubit block (QUnit bound)
    max_cut_crossings: int = 0  # QBdt bond-growth heuristic
    shots: int = 1             # trajectory batch size: resident kets the
    #                            job holds AT ONCE (noise/trajectories.py);
    #                            dense HBM pricing scales by this
    max_cone_width: int = 1    # widest past light cone over single-qubit
    #                            observables at circuit end (lightcone rung)
    cone_width_by_depth: tuple = ()  # max cone width among gates at each
    #                                  depth level (1-indexed levels)

    @property
    def clifford_fraction(self) -> float:
        return self.clifford_count / self.gate_count if self.gate_count else 1.0

    @property
    def is_clifford(self) -> bool:
        return self.magic_count == 0 and self.general_count == 0

    @property
    def stabilizer_ok(self) -> bool:
        """Gadget-feasible on the stabilizer hybrid: no general payloads
        (magic budget is enforced by the cost model, not here)."""
        return self.general_count == 0

    def as_dict(self) -> Dict[str, float]:
        return {
            "width": self.width, "gate_count": self.gate_count,
            "depth": self.depth, "clifford_count": self.clifford_count,
            "magic_count": self.magic_count,
            "general_count": self.general_count,
            "entangling_count": self.entangling_count,
            "distinct_pairs": self.distinct_pairs,
            "max_degree": self.max_degree,
            "nn_fraction": round(self.nn_fraction, 4),
            "max_component": self.max_component,
            "max_cut_crossings": self.max_cut_crossings,
            "clifford_fraction": round(self.clifford_fraction, 4),
            "shots": self.shots,
            "max_cone_width": self.max_cone_width,
            "cone_width_by_depth": tuple(self.cone_width_by_depth),
        }


def extract_features(circuit, width: int,
                     shots: int = 1) -> CircuitFeatures:
    """One host-side pass over ``circuit.gates`` (layers/qcircuit.py).
    `shots` > 1 marks a trajectory batch: the job keeps that many dense
    kets resident at once, so memory-axis scoring multiplies by it."""
    f = CircuitFeatures(width=int(width), shots=max(1, int(shots)))
    uf = _UnionFind(max(int(width), 1))
    pairs = set()
    degree: Dict[int, int] = {}
    nn = 0
    crossings = [0] * max(int(width), 1)  # cut between q and q+1
    # forward-influence sets: fc[q] = original qubits whose state can
    # influence q so far == the past light cone of a Prob(q) read here
    fc: Dict[int, frozenset] = {}
    lvl: Dict[int, int] = {}
    cone_by_depth: list = []
    for gate in circuit.gates:
        ctrls = tuple(gate.controls)
        # Run dispatches one MCMtrxPerm per payload (merged gates hold
        # several): count each the way the executing layer will see it
        for m in gate.payloads.values():
            f.gate_count += 1
            m = np.asarray(m, dtype=np.complex128)
            if not ctrls:
                if not _is_unitary(m):
                    # recorded measurement projectors (lightcone
                    # engine) are phase-shaped but NOT tableau-safe
                    f.general_count += 1
                elif clifford_sequence(m) is not None:
                    f.clifford_count += 1
                elif mat.is_phase(m) or mat.is_invert(m):
                    f.magic_count += 1
                else:
                    f.general_count += 1
                continue
            f.entangling_count += 1
            if len(ctrls) > 1:
                f.multi_ctrl_count += 1
                f.general_count += 1
            elif _ctrl_clifford(m):
                f.clifford_count += 1
            else:
                f.general_count += 1
        span = set(ctrls) | {gate.target}
        cone = set(span)
        for q in span:
            cone |= fc.get(q, frozenset((q,)))
        frozen = frozenset(cone)
        level = 1 + max((lvl.get(q, 0) for q in span), default=0)
        for q in span:
            fc[q] = frozen
            lvl[q] = level
        while len(cone_by_depth) < level:
            cone_by_depth.append(0)
        cone_by_depth[level - 1] = max(cone_by_depth[level - 1], len(frozen))
        if not ctrls:
            continue
        qubits = sorted(span)
        for c in ctrls:
            pair = (min(c, gate.target), max(c, gate.target))
            pairs.add(pair)
            if pair[1] - pair[0] == 1:
                nn += 1
            for q in pair:
                degree[q] = degree.get(q, 0) + 1
        for q in qubits[1:]:
            if qubits[0] < width and q < width:
                uf.union(qubits[0], q)
        lo, hi = qubits[0], qubits[-1]
        for cut in range(lo, min(hi, len(crossings))):
            crossings[cut] += 1
    f.depth = int(circuit.GetDepth()) if hasattr(circuit, "GetDepth") else 0
    f.distinct_pairs = len(pairs)
    f.max_degree = max(degree.values(), default=0)
    f.nn_fraction = (nn / f.entangling_count) if f.entangling_count else 1.0
    f.max_component = uf.max_component() if f.entangling_count else 1
    f.max_cut_crossings = max(crossings, default=0)
    f.max_cone_width = max(
        (len(fc.get(q, frozenset((q,)))) for q in range(max(int(width), 1))),
        default=1)
    f.cone_width_by_depth = tuple(cone_by_depth)
    return f


__all__ = ["CircuitFeatures", "extract_features"]
