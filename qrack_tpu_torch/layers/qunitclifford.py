"""QUnitClifford: Schmidt factoring over per-subsystem CHP tableaus.

Re-design of the reference layer (reference: include/qunitclifford.hpp:42
— QUnit-style CliffordShard map :27-40 over per-subsystem QStabilizers):
separable clumps each own a small tableau, so wide mostly-separable
Clifford circuits cost O(clump^2) instead of O(n^2) per gate, and
measurement never touches unrelated subsystems.

Implementation: specializes QUnit with QStabilizer units. Cached
single-qubit shards remain exact for any 1q Clifford (2-vector host
math); re-materialization into a tableau goes through the exact
stabilizer-ket synthesis. Non-Clifford operations raise CliffordError —
QStabilizerHybrid-style triage belongs a layer up.  (A copy of the JAX
package's layers/qunitclifford.py over the port's QUnit and
QStabilizer.)"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .qunit import QUnit
from .stabilizer import QStabilizer, CliffordError, clifford_sequence, _iphase


def _stab_factory(n, **kw):
    # rand_global_phase passes through: tableaus track per-gate global
    # phase now, so shard kets stay exact under QUnit recombination
    return QStabilizer(n, **kw)


class QUnitClifford(QUnit):
    def __init__(self, qubit_count: int, init_state: int = 0, **kwargs):
        kwargs.pop("unit_factory", None)
        super().__init__(qubit_count, init_state=init_state,
                         unit_factory=_stab_factory, **kwargs)

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        # reject non-Clifford operations up front — including controlled
        # payloads whose controls trim away onto cached shards — so a
        # CliffordError always fires at the offending gate
        from .. import matrices as mat

        m = np.asarray(mtrx, dtype=np.complex128).reshape(2, 2)
        trimmed = self._trim_controls(tuple(controls), perm)
        if trimmed is None:
            return  # definite controls: gate cannot fire
        live, live_perm = trimmed
        if not live:
            if clifford_sequence(m) is None:
                raise CliffordError(f"non-Clifford 1q gate on {target}")
        else:
            # Clifford controlled monomials: entries in {±1, ±i} with
            # ratio ±1 (matches QStabilizer._ctrl_diag acceptance)
            if mat.is_phase(m):
                d0, d1 = m[0, 0], m[1, 1]
            elif mat.is_invert(m):
                d0, d1 = m[1, 0], m[0, 1]
            else:
                d0 = d1 = None
            p0 = None if d0 is None else _iphase(d0)
            p1 = None if d1 is None else _iphase(d1)
            if (len(live) > 1 or p0 is None or p1 is None
                    or (p1 - p0) % 2):
                raise CliffordError("non-Clifford controlled gate")
        super().MCMtrxPerm(controls, m, target, perm)

    def isClifford(self, q: Optional[int] = None) -> bool:
        return True

    # checkpoint protocol: QUnit's structured capture/restore recurses
    # into the per-clump tableaus through QStabilizer's protocol
    _ckpt_kind = "unit_clifford"
