"""QBdt: binary-decision-diagram compressed state vector, with optional
attached dense-engine leaves.

Re-design of the reference's QBdt layer (reference: include/qbdt.hpp:37
— DDSIM-inspired shared-subtree ket, nodes with scale + 2 branches,
include/qbdt_node_interface.hpp:19-60; traversal GetTraversal/
SetTraversal include/qbdt.hpp:52-70; attached dense-engine leaves under
the tree, include/qbdt.hpp:52-70 Attach machinery; branch rounding
QRACK_QBDT_SEPARABILITY_THRESHOLD README.md:110).

Implementation: immutable hash-consed nodes (w0, c0, w1, c1) with
largest-magnitude weight normalization, so identical subtrees share
storage and equality is pointer equality. The reference's lock-based
parallel node mutation (_par_for_qbdt) is replaced by pure-functional
rebuild with per-operation memo tables — idiomatic for a host-side
combinatorial structure in this framework (the dense math lives on the
TPU; QBdt is the low-entanglement escape hatch).

Attached leaves (`attached_qubits=k`): the tree covers qubits
[0, n-k) (index LSBs) and terminates in DENSE 2^k-amplitude leaf
vectors covering qubits [n-k, n) — the reference's tree-top/ket-bottom
hybridization inside ONE representation, where QBdtHybrid can only
switch the whole state between forms.  Leaf vectors are canonicalized
(divided by their largest-magnitude element) and interned exactly like
tree nodes, so branches over a shared dense factor store it once.
`ToEngine`/`FromEngine` traverse to/from a dense engine (reference:
GetTraversal/SetTraversal).

Depth d of the tree branches on qubit d (root = qubit 0, the index LSB).

Port note: a copy of the JAX package's layers/qbdt.py.  The tree is host
code and stays as it is; device leaves keep their kets as float32
(2, 2^k) planes on the QBdt's ``device`` (``cuda`` unless the caller
passes ``device="cpu"``) and run through ops/gatekernels.py, the plain
torch gate functions (the JAX package runs them in XLA, not Pallas).
``ToEngine`` builds the port's QEngineCUDA on that device, in the
QBdt's ``dtype``.  Checkpoints: the JAX package's exact DAG capture
(kind ``"bdt"``); ``QBdt._from_capture`` (``convert.bdt_from_numpy``)
restores through the same ``_ckpt_restore`` as the registry.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..interface import QInterface
from ..ops import gatekernels as gk
from ..utils.device import resolve_device

_ROUND = 12  # weight rounding for canonical interning


class _EngLeaf:
    """Dense leaf covering the attached qubits, in one of two backings:

    * host: a canonical 2^k complex vector (largest-magnitude element
      exactly 1), interned in the unique table so shared factors store
      once — the default for small leaves.
    * device: the ket lives as split real/imag float32 planes in
      accelerator HBM and gates run through the XLA kernels — the
      reference's Attach(QEngine) tree-top/ket-bottom composition
      (include/qbdt.hpp:37-70, QBdtQEngineNode) with an engine-grade
      ket under each branch.  Device leaves are not canonicalized or
      interned (the reference's attached engines are per-node objects
      too); `.vec` materializes a cached host copy only on read paths.
      A host leaf reaches a device through :meth:`planes_on`.
    """

    __slots__ = ("_vec", "_planes")

    def __init__(self, vec: np.ndarray = None, planes=None):
        self._vec = vec
        self._planes = planes

    @property
    def on_device(self) -> bool:
        return self._planes is not None

    @property
    def n_amps(self) -> int:
        if self._vec is not None:
            return self._vec.shape[0]
        return self._planes.shape[-1]

    @property
    def vec(self) -> np.ndarray:
        if self._vec is None:
            self._vec = gk.from_planes(self._planes)
        return self._vec

    @property
    def planes(self):
        """A device leaf's planes (a host leaf has none: planes_on)."""
        return self._planes

    def planes_on(self, device):
        """The leaf as float32 planes: its own for a device leaf, a cached
        upload to `device` for a host leaf."""
        if self._planes is None:
            self._planes = gk.to_planes(self._vec, torch.float32, device)
        return self._planes


def _dense_2x2(vec: np.ndarray, m: np.ndarray, t: int,
               cmask: int, cval: int) -> np.ndarray:
    """2x2 gate on local qubit t of a dense little-endian vector, with
    an optional local control mask."""
    L = vec.shape[0]
    low = 1 << t
    v = vec.reshape(-1, 2, low)
    n0 = m[0, 0] * v[:, 0, :] + m[0, 1] * v[:, 1, :]
    n1 = m[1, 0] * v[:, 0, :] + m[1, 1] * v[:, 1, :]
    out = np.stack([n0, n1], axis=1).reshape(L)
    if cmask:
        idx = np.arange(L)
        keep = (idx & cmask) == cval
        out = np.where(keep, out, vec)
    return out


def _device_2x2(planes, m: np.ndarray, k: int, t: int,
                cmask: int, cval: int):
    """Device-leaf counterpart of _dense_2x2: the plain gate function the
    dense engines use (ops/gatekernels.py), with the matrix rounded to
    the planes' float32 on the host (no wait on the device)."""
    mp = gk.host_tensor(np.stack([m.real, m.imag]), torch.float32)
    return gk.apply_2x2(planes, mp, k, t, cmask, cval)


def _device_axpy(wa: complex, pa, wb: complex, pb):
    """wa*a + wb*b on split planes (device-leaf weighted sum)."""
    return (gk.cmul(float(wa.real), float(wa.imag), pa)
            + gk.cmul(float(wb.real), float(wb.imag), pb))


def _device_select(planes, keep):
    """The planes where `keep` holds, zero elsewhere."""
    return torch.where(keep, planes, torch.zeros((), dtype=planes.dtype,
                                                 device=planes.device))


class _Tree:
    """Unique-table context for one QBdt instance family."""

    __slots__ = ("table", "leaves")

    LEAF = ("leaf",)

    def __init__(self):
        self.table: Dict[tuple, tuple] = {}
        self.leaves: Dict[tuple, _EngLeaf] = {}

    def node(self, w0: complex, c0, w1: complex, c1) -> Tuple[complex, tuple]:
        """Make a canonical node; returns (norm_weight, node). The
        returned node's outgoing weights are normalized so the larger has
        magnitude 1; `norm_weight` carries the factor upward."""
        if c0 is None:
            w0 = 0j
        if c1 is None:
            w1 = 0j
        a0, a1 = abs(w0), abs(w1)
        if a0 <= 1e-14 and a1 <= 1e-14:
            return 0j, None
        c = w0 if a0 >= a1 else w1
        return c, self.intern(w0 / c, c0, w1 / c, c1)

    def intern(self, w0: complex, c0, w1: complex, c1) -> tuple:
        """The one node of the table with these normalized weights and
        children (the unique-table key: rounded weights, child ids)."""
        key = (round(w0.real, _ROUND), round(w0.imag, _ROUND), id(c0) if c0 is not None else 0,
               round(w1.real, _ROUND), round(w1.imag, _ROUND), id(c1) if c1 is not None else 0)
        node = self.table.get(key)
        if node is None:
            node = (w0, c0, w1, c1)
            self.table[key] = node
        return node

    def eng_leaf(self, vec: np.ndarray) -> Tuple[complex, Optional[_EngLeaf]]:
        """Canonicalize + intern a dense host leaf vector; returns
        (norm_weight, leaf)."""
        vec = np.asarray(vec, dtype=np.complex128).reshape(-1)
        k = int(np.argmax(np.abs(vec)))
        c = vec[k]
        if abs(c) <= 1e-14:
            return 0j, None
        return c, self.intern_leaf(vec / c)

    def intern_leaf(self, canon: np.ndarray) -> _EngLeaf:
        """The one host leaf of the table with this canonical vector
        (the leaf key: length, amplitudes rounded to _ROUND)."""
        key = (canon.shape[0], np.round(canon, _ROUND).tobytes())
        leaf = self.leaves.get(key)
        if leaf is None:
            leaf = _EngLeaf(vec=canon)
            self.leaves[key] = leaf
        return leaf

    @staticmethod
    def eng_leaf_planes(planes) -> Tuple[complex, _EngLeaf]:
        """Wrap device planes as a leaf — identity-unique, weight 1
        (no canonicalization: reading the max element back would
        synchronize the dispatch queue on every leaf creation)."""
        return 1.0 + 0j, _EngLeaf(planes=planes)


def _is_term(node) -> bool:
    return node is _Tree.LEAF or isinstance(node, _EngLeaf)


def _leaf_norm_sq(leaf: _EngLeaf) -> float:
    if leaf.on_device:
        pl = leaf.planes
        return float(torch.sum(pl.to(torch.float32) ** 2))
    return float(np.sum(np.abs(leaf.vec) ** 2))


def _leaf_bit_probs(leaf: _EngLeaf, lt: int) -> Tuple[float, float]:
    """(P(bit lt = 0), P(bit lt = 1)) mass of a leaf, un-normalized."""
    if leaf.on_device:
        pl = leaf.planes.to(torch.float32)
        p = pl[0] ** 2 + pl[1] ** 2
        p1 = float(torch.sum(p.view(-1, 2, 1 << lt)[:, 1, :]))
        return float(torch.sum(p)) - p1, p1
    idx = np.arange(leaf.vec.shape[0])
    p = np.abs(leaf.vec) ** 2
    bit = (idx >> lt) & 1
    return float(p[bit == 0].sum()), float(p[bit == 1].sum())


class QBdt(QInterface):
    def __init__(self, qubit_count: int, init_state: int = 0,
                 attached_qubits: int = 0, device=None, dtype=None,
                 **kwargs):
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        # device leaves and ToEngine's engine live here; dtype is the
        # engine's (leaf planes stay float32, as in the JAX package)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.attached_qubits = min(int(attached_qubits), qubit_count)
        # attached regions at/above this width keep their kets on the
        # accelerator (engine-backed leaves); below it, interned host
        # vectors win (dedup beats dispatch for tiny factors)
        self._leaf_device_qb = int(os.environ.get(
            "QRACK_QBDT_LEAF_DEVICE_QB", "14"))
        self._t = _Tree()
        self.scale: complex = 1.0 + 0j
        self.root = self._basis_node(init_state, 0)

    def _leaf_on_device(self) -> bool:
        return self.attached_qubits >= self._leaf_device_qb

    def _mk_leaf(self, vec: np.ndarray) -> Tuple[complex, Optional[_EngLeaf]]:
        """Build a leaf from a host vector in the configured backing."""
        if self._leaf_on_device():
            vec = np.asarray(vec, dtype=np.complex128).reshape(-1)
            if not np.any(vec):
                return 0j, None
            return self._t.eng_leaf_planes(
                gk.to_planes(vec, torch.float32, self.device))
        return self._t.eng_leaf(vec)

    @property
    def tree_qubits(self) -> int:
        return self.qubit_count - self.attached_qubits

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _basis_node(self, perm: int, depth: int):
        if depth == self.tree_qubits:
            if not self.attached_qubits:
                return _Tree.LEAF
            vec = np.zeros(1 << self.attached_qubits, dtype=np.complex128)
            vec[perm >> self.tree_qubits] = 1.0
            _, leaf = self._mk_leaf(vec)
            return leaf
        child = self._basis_node(perm, depth + 1)
        if (perm >> depth) & 1:
            _, node = self._t.node(0j, None, 1.0 + 0j, child)
        else:
            _, node = self._t.node(1.0 + 0j, child, 0j, None)
        return node

    def node_count(self) -> int:
        seen = set()

        def walk(n):
            if n is None or _is_term(n) or id(n) in seen:
                return
            seen.add(id(n))
            walk(n[1])
            walk(n[3])

        walk(self.root)
        return len(seen)

    def within_node_budget(self, budget: int) -> bool:
        """Cheap-representation probe (route/): True while the
        hash-consed tree holds at most `budget` distinct nodes.  The
        router escalates to dense at the first job/read boundary where
        this goes False (QRACK_ROUTE_BDT_MAX_NODES)."""
        return self.node_count() <= int(budget)

    def footprint_amps(self) -> int:
        """Stored-amplitude estimate: 2 weights per distinct tree node
        plus each distinct dense leaf's length — the memory-compression
        figure of merit for picking a representation."""
        nodes = set()
        leaf_sizes: Dict[int, int] = {}

        def walk(n):
            if n is None or n is _Tree.LEAF:
                return
            if isinstance(n, _EngLeaf):
                leaf_sizes[id(n)] = n.n_amps
                return
            if id(n) in nodes:
                return
            nodes.add(id(n))
            walk(n[1])
            walk(n[3])

        walk(self.root)
        return 2 * len(nodes) + sum(leaf_sizes.values())

    # ------------------------------------------------------------------
    # core tree algebra
    # ------------------------------------------------------------------

    def _add(self, a, wa: complex, b, wb: complex, memo) -> Tuple[complex, tuple]:
        """Weighted sum of two same-depth subtrees."""
        if a is None or abs(wa) <= 1e-14:
            return (wb, b) if b is not None else (0j, None)
        if b is None or abs(wb) <= 1e-14:
            return wa, a
        if a is _Tree.LEAF or b is _Tree.LEAF:
            if a is not b:
                raise ValueError(
                    "QBdt depth mismatch: LEAF summed with a non-LEAF "
                    "(trees with inconsistent attached_qubits?)")
            return wa + wb, _Tree.LEAF
        if isinstance(a, _EngLeaf) or isinstance(b, _EngLeaf):
            if not (isinstance(a, _EngLeaf) and isinstance(b, _EngLeaf)):
                raise ValueError(
                    "QBdt depth mismatch: dense leaf summed with a tree "
                    "node (trees with inconsistent attached_qubits?)")
            key = (id(a), round(wa.real, _ROUND), round(wa.imag, _ROUND),
                   id(b), round(wb.real, _ROUND), round(wb.imag, _ROUND))
            hit = memo.get(key)
            if hit is not None:
                return hit[0]
            if a.on_device or b.on_device:
                out = self._t.eng_leaf_planes(
                    _device_axpy(complex(wa), a.planes_on(self.device),
                                 complex(wb), b.planes_on(self.device)))
            else:
                out = self._t.eng_leaf(wa * a.vec + wb * b.vec)
            # the entry keeps a and b alive: a device leaf is in no table,
            # and a freed one's id, taken by a new leaf, would hit here
            memo[key] = (out, a, b)
            return out
        key = (id(a), round(wa.real, _ROUND), round(wa.imag, _ROUND),
               id(b), round(wb.real, _ROUND), round(wb.imag, _ROUND))
        hit = memo.get(key)
        if hit is not None:
            return hit
        w0, c0 = self._add(a[1], wa * a[0], b[1], wb * b[0], memo)
        w1, c1 = self._add(a[3], wa * a[2], b[3], wb * b[2], memo)
        out = self._t.node(w0, c0, w1, c1)
        memo[key] = out
        return out

    def _leaf_mask(self, constraints: dict) -> Tuple[int, int]:
        """Split {depth -> bit} constraints into a leaf-local mask for
        depths in the attached region."""
        tq = self.tree_qubits
        cmask = cval = 0
        for d, b in constraints.items():
            if d >= tq:
                cmask |= 1 << (d - tq)
                cval |= b << (d - tq)
        return cmask, cval

    def _project_set(self, node, depth: int, constraints: dict, memo) -> Tuple[complex, tuple]:
        """Project a subtree onto {depth d -> required bit} constraints
        (constraints may include attached-region depths, applied as a
        leaf mask)."""
        if node is None:
            return 0j, None
        if node is _Tree.LEAF:
            return 1.0 + 0j, _Tree.LEAF
        if isinstance(node, _EngLeaf):
            cmask, cval = self._leaf_mask(constraints)
            if not cmask:
                return 1.0 + 0j, node
            if node.on_device:
                pl = node.planes
                keep = (gk.iota_for(pl) & cmask) == cval
                return self._t.eng_leaf_planes(_device_select(pl, keep))
            idx = np.arange(node.vec.shape[0])
            keep = (idx & cmask) == cval
            return self._t.eng_leaf(np.where(keep, node.vec, 0.0))
        if not any(d >= depth for d in constraints):
            return 1.0 + 0j, node
        key = (id(node), depth)
        hit = memo.get(key)
        if hit is not None:
            return hit
        w0, c0, w1, c1 = node
        if depth in constraints:
            want = constraints[depth]
            if want == 0:
                nw, nn = self._project_set(c0, depth + 1, constraints, memo)
                out = self._t.node(w0 * nw, nn, 0j, None)
            else:
                nw, nn = self._project_set(c1, depth + 1, constraints, memo)
                out = self._t.node(0j, None, w1 * nw, nn)
        else:
            nw0, nn0 = self._project_set(c0, depth + 1, constraints, memo)
            nw1, nn1 = self._project_set(c1, depth + 1, constraints, memo)
            out = self._t.node(w0 * nw0, nn0, w1 * nw1, nn1)
        memo[key] = out
        return out

    def _apply(self, node, depth: int, target: int, m: np.ndarray,
               ctrl_above: dict, ctrl_below: dict, memo) -> Tuple[complex, tuple]:
        """Apply a 2x2 at tree-region `target`; ctrl_above maps control
        depth (< target) -> required bit; ctrl_below maps control depth
        (> target, possibly attached-region) -> required bit (handled by
        restricted subtree mixing)."""
        if node is None:
            return 0j, None
        if _is_term(node):
            return 1.0 + 0j, node
        key = (id(node), depth)
        hit = memo.get(key)
        if hit is not None:
            return hit
        w0, c0, w1, c1 = node
        add_memo = memo.setdefault("add", {})
        if depth == target:
            if not ctrl_below:
                n0w, n0 = self._add(c0, m[0, 0] * w0, c1, m[0, 1] * w1, add_memo)
                n1w, n1 = self._add(c0, m[1, 0] * w0, c1, m[1, 1] * w1, add_memo)
            else:
                # restrict the mixing to the deeper-control subspace:
                # new_b = b + P[(m_bb - 1) b + m_b,1-b (1-b)]
                pmemo = memo.setdefault("proj", {})
                pw0, p0 = self._project_set(c0, depth + 1, ctrl_below, pmemo)
                pw1, p1 = self._project_set(c1, depth + 1, ctrl_below, pmemo)
                d0w, d0 = self._add(p0, (m[0, 0] - 1.0) * w0 * pw0,
                                    p1, m[0, 1] * w1 * pw1, add_memo)
                n0w, n0 = self._add(c0, w0, d0, d0w, add_memo)
                d1w, d1 = self._add(p1, (m[1, 1] - 1.0) * w1 * pw1,
                                    p0, m[1, 0] * w0 * pw0, add_memo)
                n1w, n1 = self._add(c1, w1, d1, d1w, add_memo)
            out = self._t.node(n0w, n0, n1w, n1)
        elif depth in ctrl_above:
            want = ctrl_above[depth]
            if want == 1:
                nw1, nn1 = self._apply(c1, depth + 1, target, m, ctrl_above, ctrl_below, memo)
                out = self._t.node(w0, c0, w1 * nw1, nn1)
            else:
                nw0, nn0 = self._apply(c0, depth + 1, target, m, ctrl_above, ctrl_below, memo)
                out = self._t.node(w0 * nw0, nn0, w1, c1)
        else:
            nw0, nn0 = self._apply(c0, depth + 1, target, m, ctrl_above, ctrl_below, memo)
            nw1, nn1 = self._apply(c1, depth + 1, target, m, ctrl_above, ctrl_below, memo)
            out = self._t.node(w0 * nw0, nn0, w1 * nw1, nn1)
        memo[key] = out
        return out

    def _apply_leafgate(self, node, depth: int, m: np.ndarray, leaf_target: int,
                        tree_ctrl: dict, leaf_cmask: int, leaf_cval: int,
                        memo) -> Tuple[complex, tuple]:
        """Apply a 2x2 whose target lives in the attached region: walk
        the tree (respecting tree-region controls), then run the dense
        kernel inside each reached leaf."""
        if node is None:
            return 0j, None
        if isinstance(node, _EngLeaf):
            key = (id(node), "leaf")
            hit = memo.get(key)
            if hit is None:
                if node.on_device:
                    hit = self._t.eng_leaf_planes(_device_2x2(
                        node.planes, m, self.attached_qubits, leaf_target,
                        leaf_cmask, leaf_cval))
                else:
                    hit = self._t.eng_leaf(_dense_2x2(
                        node.vec, m, leaf_target, leaf_cmask, leaf_cval))
                memo[key] = hit
            return hit
        key = (id(node), depth)
        hit = memo.get(key)
        if hit is not None:
            return hit
        w0, c0, w1, c1 = node
        if depth in tree_ctrl:
            want = tree_ctrl[depth]
            if want == 1:
                nw1, nn1 = self._apply_leafgate(c1, depth + 1, m, leaf_target,
                                                tree_ctrl, leaf_cmask, leaf_cval, memo)
                out = self._t.node(w0, c0, w1 * nw1, nn1)
            else:
                nw0, nn0 = self._apply_leafgate(c0, depth + 1, m, leaf_target,
                                                tree_ctrl, leaf_cmask, leaf_cval, memo)
                out = self._t.node(w0 * nw0, nn0, w1, c1)
        else:
            nw0, nn0 = self._apply_leafgate(c0, depth + 1, m, leaf_target,
                                            tree_ctrl, leaf_cmask, leaf_cval, memo)
            nw1, nn1 = self._apply_leafgate(c1, depth + 1, m, leaf_target,
                                            tree_ctrl, leaf_cmask, leaf_cval, memo)
            out = self._t.node(w0 * nw0, nn0, w1 * nw1, nn1)
        memo[key] = out
        return out

    def _prob_node(self, node, memo) -> float:
        """Squared norm of a subtree (children assumed canonical)."""
        if node is None:
            return 0.0
        if node is _Tree.LEAF:
            return 1.0
        if isinstance(node, _EngLeaf):
            hit = memo.get(id(node))
            if hit is None:
                hit = _leaf_norm_sq(node)
                memo[id(node)] = hit
            return hit
        hit = memo.get(id(node))
        if hit is not None:
            return hit
        w0, c0, w1, c1 = node
        p = (abs(w0) ** 2) * self._prob_node(c0, memo) + \
            (abs(w1) ** 2) * self._prob_node(c1, memo)
        memo[id(node)] = p
        return p

    def _prob_target(self, node, depth: int, target: int, memo_p, memo) -> Tuple[float, float]:
        """(weight of target=0 branch, weight of target=1 branch), un-normalized."""
        if node is None:
            return 0.0, 0.0
        if node is _Tree.LEAF:
            return 1.0, 0.0  # unreachable for valid target
        if isinstance(node, _EngLeaf):
            return _leaf_bit_probs(node, target - self.tree_qubits)
        key = (id(node), depth)
        hit = memo.get(key)
        if hit is not None:
            return hit
        w0, c0, w1, c1 = node
        if depth == target:
            out = ((abs(w0) ** 2) * self._prob_node(c0, memo_p),
                   (abs(w1) ** 2) * self._prob_node(c1, memo_p))
        else:
            p00, p01 = self._prob_target(c0, depth + 1, target, memo_p, memo)
            p10, p11 = self._prob_target(c1, depth + 1, target, memo_p, memo)
            out = ((abs(w0) ** 2) * p00 + (abs(w1) ** 2) * p10,
                   (abs(w0) ** 2) * p01 + (abs(w1) ** 2) * p11)
        memo[key] = out
        return out

    def _project(self, node, depth: int, target: int, keep: int, memo) -> Tuple[complex, tuple]:
        if node is None:
            return 0j, None
        if node is _Tree.LEAF:
            return 1.0 + 0j, _Tree.LEAF
        if isinstance(node, _EngLeaf):
            lt = target - self.tree_qubits
            if node.on_device:
                pl = node.planes
                match = ((gk.iota_for(pl) >> lt) & 1) == keep
                return self._t.eng_leaf_planes(_device_select(pl, match))
            idx = np.arange(node.vec.shape[0])
            match = ((idx >> lt) & 1) == keep
            return self._t.eng_leaf(np.where(match, node.vec, 0.0))
        key = (id(node), depth)
        hit = memo.get(key)
        if hit is not None:
            return hit
        w0, c0, w1, c1 = node
        if depth == target:
            if keep == 0:
                out = self._t.node(w0, c0, 0j, None)
            else:
                out = self._t.node(0j, None, w1, c1)
        else:
            nw0, nn0 = self._project(c0, depth + 1, target, keep, memo)
            nw1, nn1 = self._project(c1, depth + 1, target, keep, memo)
            out = self._t.node(w0 * nw0, nn0, w1 * nw1, nn1)
        memo[key] = out
        return out

    # ------------------------------------------------------------------
    # QInterface contract
    # ------------------------------------------------------------------

    def MCMtrxPerm(self, controls, mtrx, target, perm) -> None:
        self._check_qubit(target)
        m = np.asarray(mtrx, dtype=np.complex128).reshape(2, 2)
        tq = self.tree_qubits
        tree_ctrl = {}
        leaf_cmask = leaf_cval = 0
        for j, c in enumerate(controls):
            self._check_qubit(c)
            bit = (perm >> j) & 1
            if c < tq:
                tree_ctrl[c] = bit
            else:
                leaf_cmask |= 1 << (c - tq)
                leaf_cval |= bit << (c - tq)
        if target >= tq:
            w, root = self._apply_leafgate(self.root, 0, m, target - tq,
                                           tree_ctrl, leaf_cmask, leaf_cval, {})
        else:
            ctrl_above = {d: b for d, b in tree_ctrl.items() if d < target}
            ctrl_below = {d: b for d, b in tree_ctrl.items() if d > target}
            # attached-region controls are always "below" any tree target
            for lb in range(self.attached_qubits):
                if (leaf_cmask >> lb) & 1:
                    ctrl_below[tq + lb] = (leaf_cval >> lb) & 1
            w, root = self._apply(self.root, 0, target, m, ctrl_above,
                                  ctrl_below, {})
        self.scale *= w
        self.root = root
        self._maybe_gc()

    def Swap(self, q1: int, q2: int) -> None:
        if q1 == q2:
            return
        from .. import matrices as mat

        lo, hi = (q1, q2) if q1 < q2 else (q2, q1)
        self.MCMtrxPerm((lo,), mat.X2, hi, 1)
        self.MCMtrxPerm((hi,), mat.X2, lo, 1)
        self.MCMtrxPerm((lo,), mat.X2, hi, 1)

    def Prob(self, q: int) -> float:
        self._check_qubit(q)
        tq = self.tree_qubits
        if q >= tq:
            # weight-average the per-leaf marginals over tree paths
            return self._prob_leaf_qubit(q)
        p0, p1 = self._prob_target(self.root, 0, q, {}, {})
        tot = p0 + p1
        return p1 / tot if tot > 0 else 0.0

    def _prob_leaf_qubit(self, q: int) -> float:
        lt = q - self.tree_qubits
        memo_w: Dict[int, Tuple[float, float]] = {}

        def split(node) -> Tuple[float, float]:
            """(P(bit=0), P(bit=1)) contribution of a canonical subtree."""
            if node is None:
                return 0.0, 0.0
            if isinstance(node, _EngLeaf):
                hit = memo_w.get(id(node))
                if hit is None:
                    hit = _leaf_bit_probs(node, lt)
                    memo_w[id(node)] = hit
                return hit
            hit = memo_w.get(id(node))
            if hit is not None:
                return hit
            w0, c0, w1, c1 = node
            a = split(c0)
            b = split(c1)
            out = ((abs(w0) ** 2) * a[0] + (abs(w1) ** 2) * b[0],
                   (abs(w0) ** 2) * a[1] + (abs(w1) ** 2) * b[1])
            memo_w[id(node)] = out
            return out

        p0, p1 = split(self.root)
        tot = p0 + p1
        return p1 / tot if tot > 0 else 0.0

    def ForceM(self, q: int, result: bool, do_force: bool = True, do_apply: bool = True) -> bool:
        p1 = self.Prob(q)
        from ..config import FP_NORM_EPSILON

        if do_force:
            res = bool(result)
        elif p1 >= 1.0 - FP_NORM_EPSILON:
            res = True
        elif p1 <= FP_NORM_EPSILON:
            res = False
        else:
            res = self.Rand() <= p1
        nrm_sq = p1 if res else 1.0 - p1
        if nrm_sq <= 0.0:
            raise RuntimeError("ForceM: forced result has zero probability")
        if do_apply:
            w, root = self._project(self.root, 0, q, 1 if res else 0, {})
            self.scale *= w / math.sqrt(nrm_sq)
            self.root = root
            self._maybe_gc()
        return res

    def GetAmplitude(self, perm: int) -> complex:
        amp = self.scale
        node = self.root
        depth = 0
        while not _is_term(node):
            if node is None:
                return 0j
            bit = (perm >> depth) & 1
            amp *= node[2] if bit else node[0]
            node = node[3] if bit else node[1]
            depth += 1
        if node is None:
            return 0j
        if isinstance(node, _EngLeaf):
            amp *= node.vec[perm >> self.tree_qubits]
        return complex(amp)

    def GetQuantumState(self) -> np.ndarray:
        n = self.qubit_count
        tq = self.tree_qubits
        out = np.zeros(1 << n, dtype=np.complex128)

        def walk(node, depth, idx, amp):
            if node is None or abs(amp) <= 1e-16:
                return
            if node is _Tree.LEAF:
                out[idx] = amp
                return
            if isinstance(node, _EngLeaf):
                L = node.vec.shape[0]
                out[idx + (np.arange(L) << tq)] += amp * node.vec
                return
            walk(node[1], depth + 1, idx, amp * node[0])
            walk(node[3], depth + 1, idx | (1 << depth), amp * node[2])

        walk(self.root, 0, 0, self.scale)
        return out

    def SetQuantumState(self, state) -> None:
        state = np.asarray(state, dtype=np.complex128).reshape(-1)
        if state.shape[0] != (1 << self.qubit_count):
            raise ValueError("state length mismatch")
        self._t = _Tree()
        tq = self.tree_qubits

        def build(vec, depth):
            """Top-down split on the qubit at `depth` (index LSB of the
            remaining strided view); dense leaf once the attached region
            is reached."""
            if depth == tq:
                if not self.attached_qubits:
                    a = complex(vec[0])
                    return (a, _Tree.LEAF) if abs(a) > 1e-14 else (0j, None)
                return self._mk_leaf(vec)
            w0, c0 = build(vec[0::2], depth + 1)
            w1, c1 = build(vec[1::2], depth + 1)
            return self._t.node(w0, c0, w1, c1)

        w, root = build(state, 0)
        self.scale = w
        self.root = root

    def SetPermutation(self, perm: int, phase=None) -> None:
        self._t = _Tree()
        ph = 1.0 + 0j
        if phase is not None:
            ph = complex(phase)
        elif self.rand_global_phase:
            ang = 2.0 * math.pi * self.Rand()
            ph = complex(math.cos(ang), math.sin(ang))
        self.scale = ph
        self.root = self._basis_node(perm, 0)

    # ------------------------------------------------------------------
    # traversal to/from dense engines (reference: GetTraversal/
    # SetTraversal, include/qbdt.hpp:52-70)
    # ------------------------------------------------------------------

    def ToEngine(self, engine_factory=None):
        """Materialize the tree(+leaves) into a dense engine; defaults
        to the CUDA engine on this QBdt's device, in its dtype."""
        if engine_factory is None:
            from ..engines.cuda import QEngineCUDA

            def engine_factory(n, **kw):
                return QEngineCUDA(n, device=self.device, dtype=self.dtype,
                                   **kw)

        eng = engine_factory(self.qubit_count, rng=self.rng.spawn(),
                             rand_global_phase=False)
        eng.SetQuantumState(self.GetQuantumState())
        return eng

    @classmethod
    def FromEngine(cls, eng, attached_qubits: int = 0, **kwargs):
        """Build a (tree-top, dense-bottom) representation from any
        engine's ket."""
        q = cls(eng.GetQubitCount(), attached_qubits=attached_qubits,
                **kwargs)
        q.SetQuantumState(np.asarray(eng.GetQuantumState()))
        return q

    def Compose(self, other: "QBdt", start=None) -> int:
        """Insert `other`'s qubits at index `start` (reference: Compose
        with arbitrary start, include/qinterface.hpp Compose(toCopy,
        start)).  Tree-native for any start in the tree region: the new
        index layout [low | other | high] is a SPLICE — at depth
        `start`, each subtree N (the high factor continuation) is
        replaced by other's tree with every LEAF terminal redirected to
        N.  Peak cost O(self nodes * other nodes), never 2^n."""
        if start is None:
            start = self.qubit_count
        if not (0 <= start <= self.qubit_count):
            raise ValueError(
                f"Compose start {start} out of range [0, {self.qubit_count}]")
        o = other if isinstance(other, QBdt) else None
        tq = self.tree_qubits
        if (o is not None and not o.attached_qubits and start <= tq):
            graft_scale, graft_root = self._graft_import(o)
            tail_memo: Dict[tuple, tuple] = {}

            def with_tail(g, tail):
                """Copy graft subtree g, LEAF terminals -> unit-weight
                tail (the memo key assumes unit weight — keep it so)."""
                if g is None:
                    return 0j, None
                if g is _Tree.LEAF:
                    return 1.0 + 0j, tail
                key = (id(g), id(tail))
                hit = tail_memo.get(key)
                if hit is not None:
                    return hit
                w0, c0, w1, c1 = g
                nw0, n0 = with_tail(c0, tail)
                nw1, n1 = with_tail(c1, tail)
                out = self._t.node(w0 * nw0, n0, w1 * nw1, n1)
                tail_memo[key] = out
                return out

            memo: Dict[tuple, tuple] = {}

            def splice(node, d):
                if d == start:
                    # node may be None (zero branch), a terminal (when
                    # start == tq), or an interior subtree: all become
                    # the tail under other's grafted levels
                    if node is None:
                        return 0j, None
                    return with_tail(graft_root, node)
                if node is None:
                    return 0j, None
                key = (id(node), d)  # shared nodes may recur at depths
                hit = memo.get(key)
                if hit is not None:
                    return hit
                w0, c0, w1, c1 = node
                nw0, n0 = splice(c0, d + 1)
                nw1, n1 = splice(c1, d + 1)
                out = self._t.node(w0 * nw0, n0, w1 * nw1, n1)
                memo[key] = out
                return out

            w, root = splice(self.root, 0)
            self.scale *= w * graft_scale
            self.root = root
            self.qubit_count += other.qubit_count
            self._maybe_gc()
            return start
        # attached-region insertion / non-QBdt operand: dense fallback
        other_state = np.asarray(other.GetQuantumState())
        m = int(np.log2(len(other_state)))
        mine = self.GetQuantumState()
        if start == self.qubit_count:
            combined = np.kron(other_state, mine)
        else:
            from ..utils.states import compose_states

            combined = compose_states(mine, other_state,
                                      self.qubit_count, m, start)
        self.qubit_count += m
        self.SetQuantumState(combined)
        return start

    def _graft_import(self, other: "QBdt"):
        """Copy other's tree into this unique table."""
        memo = {}

        def imp(node):
            if node is None or node is _Tree.LEAF:
                return node
            if isinstance(node, _EngLeaf):
                if node.on_device:
                    return node  # identity-unique; no table to move into
                _, out = self._t.eng_leaf(node.vec)
                return out
            hit = memo.get(id(node))
            if hit is not None:
                return hit
            w0, c0, w1, c1 = node
            _, out = self._t.node(w0, imp(c0), w1, imp(c1))
            memo[id(node)] = out
            return out

        return other.scale, imp(other.root)

    # ------------------------------------------------------------------
    # tree-native separation (reference: Decompose/Dispose operate on the
    # tree without dense materialization, include/qbdt.hpp:37-70,
    # src/qbdt/tree.cpp).  Hash-consing makes separability CHECKABLE by
    # pointer equality: a factor over tree qubits [start, start+L) exists
    # iff every depth-(start) node has exactly one distinct descendant at
    # relative depth L (the rest factor) and the L-level "cap" structures
    # between them intern to one shared node (the separated factor).  On
    # success, peak transient memory is O(tree nodes + 2^L), never 2^n.
    # ------------------------------------------------------------------

    def _nodes_at_depth(self, depth: int):
        """Distinct non-None nodes at `depth` below the root."""
        seen, out = set(), []

        def walk(n, d):
            if n is None:
                return
            if d == depth:
                if id(n) not in seen:
                    seen.add(id(n))
                    out.append(n)
                return
            if _is_term(n):
                return
            walk(n[1], d + 1)
            walk(n[3], d + 1)

        walk(self.root, 0)
        return out

    def _cut_top(self, node, L: int, memo):
        """If `node` == cap([0,L)) ⊗ bottom, return (cap_w, cap_root,
        bottom) with cap terminating in LEAF at relative depth L; else
        None.  `memo` is shared across nodes of one separation pass."""
        bots, seen = [], set()

        def bottoms(n, d):
            if n is None:
                return
            if d == L:
                if id(n) not in seen:
                    seen.add(id(n))
                    bots.append(n)
                return
            if _is_term(n):
                bots.append(("short", n))  # malformed for this cut
                return
            bottoms(n[1], d + 1)
            bottoms(n[3], d + 1)

        bottoms(node, 0)
        if len(bots) != 1 or isinstance(bots[0], tuple) and bots[0] and bots[0][0] == "short":
            return None

        def cap(n, d):
            if n is None:
                return 0j, None
            if d == L:
                return 1.0 + 0j, _Tree.LEAF
            key = (id(n), d)
            hit = memo.get(key)
            if hit is not None:
                return hit
            w0, c0, w1, c1 = n
            nw0, n0 = cap(c0, d + 1)
            nw1, n1 = cap(c1, d + 1)
            out = self._t.node(w0 * nw0, n0, w1 * nw1, n1)
            memo[key] = out
            return out

        cw, croot = cap(node, 0)
        return cw, croot, bots[0]

    def _subtree_ket(self, w: complex, root, L: int) -> np.ndarray:
        """Materialize an L-qubit cap (LEAF-terminated) as a 2^L ket."""
        out = np.zeros(1 << L, dtype=np.complex128)

        def walk(n, d, idx, amp):
            if n is None or abs(amp) <= 1e-16:
                return
            if n is _Tree.LEAF:
                out[idx] += amp
                return
            walk(n[1], d + 1, idx, amp * n[0])
            walk(n[3], d + 1, idx | (1 << d), amp * n[2])

        walk(root, 0, 0, w)
        return out

    def _try_tree_separate(self, start: int, L: int):
        """Attempt the tree-level cut of qubits [start, start+L).
        Returns (cap_w, cap_root, rewrite_fn) or None; rewrite_fn()
        commits the rest-state (splices bottoms in place of caps)."""
        tops = ([self.root] if start == 0
                else self._nodes_at_depth(start))
        if not tops or any(t is None for t in tops):
            return None
        cut_memo: dict = {}
        cuts = {}
        cap_id = None
        for t in tops:
            cut = self._cut_top(t, L, cut_memo)
            if cut is None:
                return None
            if cut[1] is None:
                return None
            if cap_id is None:
                cap_id = id(cut[1])
            elif id(cut[1]) != cap_id:
                return None  # caps differ -> not a product across the cut
            cuts[id(t)] = cut

        def rewrite():
            if start == 0:
                cw, _croot, bot = cuts[id(self.root)]
                self.root = bot
                return
            memo = {}

            def walk(n, d):
                if n is None:
                    return 0j, None
                if d == start:
                    cw, _croot, bot = cuts[id(n)]
                    return cw, bot
                key = (id(n), d)
                hit = memo.get(key)
                if hit is not None:
                    return hit
                w0, c0, w1, c1 = n
                nw0, n0 = walk(c0, d + 1)
                nw1, n1 = walk(c1, d + 1)
                out = self._t.node(w0 * nw0, n0, w1 * nw1, n1)
                memo[key] = out
                return out

            w, root = walk(self.root, 0)
            self.scale *= w
            self.root = root

        first = cuts[id(tops[0])]
        return first[0], first[1], rewrite

    def _try_leaf_separate(self):
        """Cut of the ENTIRE attached region: legal iff every tree path
        ends in the same leaf.  Returns (leaf, rewrite_fn) or None."""
        leaves, seen = [], set()

        def walk(n):
            if n is None:
                return
            if isinstance(n, _EngLeaf):
                if id(n) not in seen:
                    seen.add(id(n))
                    leaves.append(n)
                return
            if n is _Tree.LEAF:
                return
            walk(n[1])
            walk(n[3])

        walk(self.root)
        if len(leaves) != 1:
            return None
        leaf = leaves[0]

        def rewrite():
            memo = {}

            def strip(n):
                if n is None:
                    return None
                if isinstance(n, _EngLeaf):
                    return _Tree.LEAF
                hit = memo.get(id(n))
                if hit is not None:
                    return hit
                _, out = self._t.node(n[0], strip(n[1]), n[2], strip(n[3]))
                memo[id(n)] = out
                return out

            self.root = strip(self.root)
            self.attached_qubits = 0

        return leaf, rewrite

    def Decompose(self, start: int, dest) -> None:
        length = dest.qubit_count
        tq = self.tree_qubits
        if start + length <= tq:
            sep = self._try_tree_separate(start, length)
            if sep is not None:
                cw, croot, rewrite = sep
                phi = self._subtree_ket(cw, croot, length)
                nrm = float(np.linalg.norm(phi))
                if nrm > 1e-12:
                    rewrite()
                    self.scale *= nrm
                    dest.SetQuantumState(phi / nrm)
                    self.qubit_count -= length
                    self._maybe_gc()
                    return
        elif (start == tq and length == self.attached_qubits
              and length > 0):
            sep = self._try_leaf_separate()
            if sep is not None:
                leaf, rewrite = sep
                phi = leaf.vec.copy()
                nrm = float(np.linalg.norm(phi))
                if nrm > 1e-12:
                    rewrite()
                    self.scale *= nrm
                    dest.SetQuantumState(phi / nrm)
                    self.qubit_count -= length
                    return
        self._dense_split(start, length, dest)

    def _dense_split(self, start: int, length: int, dest=None,
                     disposed_perm=None) -> None:
        """Host-staged fallback for non-separable/boundary-crossing cuts
        (the reference asserts separability instead; we degrade to the
        Schmidt-exact dense path)."""
        from ..engines.cpu import QEngineCPU

        n = self.qubit_count
        tmp = QEngineCPU(n, rng=self.rng.spawn(), rand_global_phase=False)
        tmp.SetQuantumState(self.GetQuantumState())
        if dest is not None:
            tmp_dest = QEngineCPU(length, rng=self.rng.spawn(),
                                  rand_global_phase=False)
            tmp.Decompose(start, tmp_dest)
        else:
            tmp.Dispose(start, length, disposed_perm)
        self.qubit_count = n - length
        self.attached_qubits = min(self.attached_qubits, self.qubit_count)
        self.SetQuantumState(tmp.GetQuantumState())
        if dest is not None:
            dest.SetQuantumState(tmp_dest.GetQuantumState())

    def Dispose(self, start: int, length: int, disposed_perm=None) -> None:
        tq = self.tree_qubits
        if start + length <= tq:
            if disposed_perm is not None:
                self._dispose_perm(start, length, disposed_perm)
                return
            sep = self._try_tree_separate(start, length)
            if sep is not None:
                cw, croot, rewrite = sep
                # norm of the dropped factor re-scales the remainder
                nrm_sq = (abs(cw) ** 2) * self._prob_node(croot, {})
                if nrm_sq > 1e-24:
                    rewrite()
                    self.scale *= math.sqrt(nrm_sq)
                    self.qubit_count -= length
                    self._maybe_gc()
                    return
        elif (start == tq and length == self.attached_qubits
              and length > 0 and disposed_perm is None):
            sep = self._try_leaf_separate()
            if sep is not None:
                leaf, rewrite = sep
                nrm_sq = _leaf_norm_sq(leaf)
                if nrm_sq > 1e-24:
                    rewrite()
                    self.scale *= math.sqrt(nrm_sq)
                    self.qubit_count -= length
                    return
        self._dense_split(start, length, disposed_perm=disposed_perm)

    def _dispose_perm(self, start: int, length: int, perm: int) -> None:
        """Dispose with a known disposed value: follow the perm path
        through levels [start, start+L) of every branch (an exact
        projection + level strip; no separability requirement)."""
        memo = {}

        def follow(n, d):
            """Walk the perm path from relative depth 0 to L."""
            if n is None:
                return 0j, None
            rel = d - start
            if rel == length:
                return 1.0 + 0j, n
            if _is_term(n):
                return 0j, None
            key = (id(n), d)
            hit = memo.get(key)
            if hit is not None:
                return hit
            bit = (perm >> rel) & 1
            w = n[2] if bit else n[0]
            child = n[3] if bit else n[1]
            cw, cn = follow(child, d + 1)
            out = (w * cw, cn)
            memo[key] = out
            return out

        def walk(n, d):
            if n is None:
                return 0j, None
            if d == start:
                return follow(n, d)
            key = (id(n), "w", d)
            hit = memo.get(key)
            if hit is not None:
                return hit
            w0, c0, w1, c1 = n
            nw0, n0 = walk(c0, d + 1)
            nw1, n1 = walk(c1, d + 1)
            out = self._t.node(w0 * nw0, n0, w1 * nw1, n1)
            memo[key] = out
            return out

        w, root = walk(self.root, 0)
        if root is None:
            raise RuntimeError(
                "Dispose: disposed qubits have zero amplitude at "
                f"permutation {perm}")
        self.scale *= w
        self.root = root
        self.qubit_count -= length
        # renormalize: the projection drops any weight off the perm path
        nrm_sq = (abs(self.scale) ** 2) * self._prob_node(self.root, {})
        if nrm_sq > 1e-24:
            self.scale /= math.sqrt(nrm_sq)
        self._maybe_gc()

    def Allocate(self, start: int, length: int = 1) -> int:
        fresh = QBdt(length, rng=self.rng.spawn(), rand_global_phase=False,
                     device=self.device, dtype=self.dtype)
        return self.Compose(fresh, start)

    def Clone(self) -> "QBdt":
        c = QBdt(self.qubit_count, attached_qubits=self.attached_qubits,
                 rng=self.rng.spawn(),
                 rand_global_phase=self.rand_global_phase,
                 device=self.device, dtype=self.dtype)
        c._t = self._t  # shared unique table: trees are immutable
        c.scale = self.scale
        c.root = self.root
        return c

    @classmethod
    def _from_capture(cls, meta, arrays, device=None, **kwargs) -> "QBdt":
        """A QBdt holding the decision diagram of a checkpoint capture of
        either package (``QBdt._ckpt_capture``'s meta/arrays), restored
        through :meth:`_ckpt_restore`, the registry's path.  Device leaf
        planes land on `device`."""
        q = cls(int(meta["n"]),
                attached_qubits=int(meta.get("attached_qubits", 0)),
                device=device, **kwargs)
        q._ckpt_restore(arrays, meta, {}, None)
        return q

    # ------------------------------------------------------------------
    # checkpoint protocol (checkpoint/registry.py): EXACT DAG capture —
    # node weights, sharing structure, and leaf payloads verbatim.  A
    # dense-ket round-trip would rebuild the tree with different node
    # normalization round-off than the incrementally-grown original,
    # and later gates would amplify that into non-identical amplitudes.
    # ------------------------------------------------------------------

    _ckpt_kind = "bdt"

    def _ckpt_capture(self, capture_child):
        arrays = {}
        node_w: list = []  # (w0, w1) per interior node
        node_c: list = []  # child refs per interior node
        ids: dict = {}
        n_leaves = [0]

        # child ref encoding: >=0 node index (children precede parents),
        # -1 absent branch, -2 the shared terminal, <=-3 leaf -(ref+3)
        def ref(ch):
            if ch is None:
                return -1
            if ch is _Tree.LEAF:
                return -2
            r = ids.get(id(ch))
            if r is not None:
                return r
            if isinstance(ch, _EngLeaf):
                i = n_leaves[0]
                n_leaves[0] += 1
                if ch.on_device:
                    arrays[f"leafpl_{i}"] = ch.planes.to("cpu").numpy()
                else:
                    arrays[f"leafvec_{i}"] = np.asarray(
                        ch.vec, dtype=np.complex128)
                r = -(3 + i)
            else:
                c0 = ref(ch[1])
                c1 = ref(ch[3])
                node_w.append([ch[0], ch[2]])
                node_c.append([c0, c1])
                r = len(node_w) - 1
            ids[id(ch)] = r
            return r

        root = ref(self.root)
        if node_w:
            arrays["node_w"] = np.asarray(node_w, dtype=np.complex128)
            arrays["node_c"] = np.asarray(node_c, dtype=np.int64)
        return {"kind": "bdt",
                "meta": {"n": self.qubit_count,
                         "attached_qubits": int(self.attached_qubits),
                         "root": int(root),
                         "scale": [self.scale.real, self.scale.imag]},
                "arrays": arrays}

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        """Child refs: >= 0 a node (children precede parents), -1 an
        absent branch, -2 the shared terminal, <= -3 leaf -(ref + 3);
        nodes and host leaves are interned, so later node() calls
        deduplicate against the restored structure."""
        if int(meta["n"]) != self.qubit_count:
            raise ValueError("checkpoint width mismatch")
        self.attached_qubits = min(int(meta.get("attached_qubits", 0)),
                                   self.qubit_count)
        sc = meta.get("scale", [1.0, 0.0])
        self.scale = complex(sc[0], sc[1])
        self._t = _Tree()
        built: dict = {}

        def resolve(r):
            r = int(r)
            if r == -1:
                return None
            if r == -2:
                return _Tree.LEAF
            hit = built.get(r)
            if hit is not None:
                return hit
            # only leaves land here: node refs point at built lower indices
            i = -3 - r
            if f"leafpl_{i}" in arrays:
                leaf = _EngLeaf(planes=torch.from_numpy(np.ascontiguousarray(
                    arrays[f"leafpl_{i}"])).to(self.device))
            else:
                leaf = self._t.intern_leaf(np.ascontiguousarray(
                    arrays[f"leafvec_{i}"], dtype=np.complex128))
            built[r] = leaf
            return leaf

        node_w = arrays.get("node_w")
        node_c = arrays.get("node_c")
        for i in range(0 if node_w is None else node_w.shape[0]):
            built[i] = self._t.intern(complex(node_w[i][0]),
                                      resolve(node_c[i][0]),
                                      complex(node_w[i][1]),
                                      resolve(node_c[i][1]))
        self.root = resolve(meta["root"])

    def SumSqrDiff(self, other) -> float:
        a = self.GetQuantumState()
        b = np.asarray(other.GetQuantumState(), dtype=np.complex128)
        inner = np.vdot(a, b)
        return float(max(0.0, 1.0 - abs(inner) ** 2))

    def GetProbs(self) -> np.ndarray:
        s = self.GetQuantumState()
        return s.real ** 2 + s.imag ** 2

    def isBinaryDecisionTree(self) -> bool:
        return True

    def _maybe_gc(self) -> None:
        # periodically rebuild the unique table to drop unreachable nodes
        if len(self._t.table) + len(self._t.leaves) > 1 << 18:
            fresh = _Tree()
            memo = {}

            def rebuild(node):
                if node is None or node is _Tree.LEAF:
                    return node
                if isinstance(node, _EngLeaf):
                    if node.on_device:
                        return node
                    _, out = fresh.eng_leaf(node.vec)
                    return out
                hit = memo.get(id(node))
                if hit is not None:
                    return hit
                _, out = fresh.node(node[0], rebuild(node[1]), node[2], rebuild(node[3]))
                memo[id(node)] = out
                return out

            self.root = rebuild(self.root)
            self._t = fresh
