"""QCircuit: gate intermediate representation with algebraic merging.

Re-design of the reference's circuit IR (reference:
include/qcircuit.hpp:52 QCircuitGate — {target, payloads: map<control
permutation -> 2x2>, controls}; AppendGate merging src/qcircuit.cpp:101;
Run :173).  `RunFused` applies the whole circuit
as one fused window on the dense engine (ops/fusion.py): the window
kernel pays one sweep over the ket per planned segment instead of one
per gate.  The whole-circuit programs over planes:

* :meth:`QCircuit.compile_fn` — plain torch, one gate function per
  payload;
* :meth:`QCircuit.compile_fn_pallas` — the window kernel (K1/K2) over the
  circuit's planned segments (the JAX package's Pallas form);
* :meth:`QCircuit.compile_batched_fn` — compile_fn over a leading batch
  axis of kets.

:meth:`QCircuit.PastLightCone` cuts the sub-circuit a set of qubits
depends on (QTensorNetwork's reads).
:meth:`QCircuit.compile_sharded_fn` applies the circuit to a ket in pages
(the pager's layout, ops/sharded.py), gate by gate and in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import matrices as mat


def _is_unitary_2x2(m: np.ndarray, tol: float = 1e-9) -> bool:
    m = np.asarray(m, dtype=np.complex128).reshape(2, 2)
    return bool(np.allclose(m.conj().T @ m, np.eye(2), atol=tol))


class QCircuitGate:
    __slots__ = ("target", "controls", "payloads")

    def __init__(self, target: int, payloads: Dict[int, np.ndarray],
                 controls: Tuple[int, ...] = ()):
        self.target = target
        self.controls = tuple(controls)
        self.payloads = {p: np.asarray(m, dtype=np.complex128).reshape(2, 2)
                         for p, m in payloads.items()}

    @classmethod
    def single(cls, target: int, m: np.ndarray) -> "QCircuitGate":
        return cls(target, {0: m})

    @classmethod
    def controlled(cls, controls, target: int, m: np.ndarray, perm: int) -> "QCircuitGate":
        return cls(target, {perm: m}, tuple(controls))

    def qubits(self) -> Tuple[int, ...]:
        return (self.target,) + self.controls

    def can_merge(self, other: "QCircuitGate") -> bool:
        return (self.target == other.target and self.controls == other.controls)

    def merge(self, later: "QCircuitGate") -> None:
        """Compose `later`'s payloads after self's (matrix product)."""
        for perm in set(self.payloads) | set(later.payloads):
            a = self.payloads.get(perm, mat.I2)
            b = later.payloads.get(perm, mat.I2)
            self.payloads[perm] = b @ a
        # drop only removable payloads: exact identity always; identity up
        # to global phase only when uncontrolled (a controlled e^{i0}I is a
        # physical phase on the control subspace and must be kept)
        def removable(m):
            return mat.is_identity(m) and (not self.controls or abs(m[0, 0] - 1.0) <= 1e-12)

        for perm in [p for p, m in self.payloads.items() if removable(m)]:
            del self.payloads[perm]

    def is_identity(self) -> bool:
        return not self.payloads

    def is_phase(self) -> bool:
        return all(mat.is_phase(m) for m in self.payloads.values())

    def clone(self) -> "QCircuitGate":
        return QCircuitGate(self.target, {p: m.copy() for p, m in self.payloads.items()},
                            self.controls)


class QCircuit:
    def __init__(self, qubit_count: int = 0):
        self.qubit_count = qubit_count
        self.gates: List[QCircuitGate] = []
        # memoized structure_digest — the serving plane hashes a
        # circuit once per submit AND once per dispatch, and sha1 over
        # every payload's bytes is milliseconds on ~100-gate circuits
        self._digest_cache: Optional[str] = None
        # memoized rolling prefix-digest chain (prefix_digest): entry k
        # hashes gates[:k+1].  AppendGate's merging can change earlier
        # gates, so any append invalidates it, like _digest_cache.
        self._prefix_chain: Optional[List[str]] = None

    # ------------------------------------------------------------------

    def AppendGate(self, gate: QCircuitGate) -> None:
        """Append with peephole merging (reference: src/qcircuit.cpp:101 —
        algebraic combining of same-target/controls neighbors and
        commuting past disjoint gates)."""
        self.qubit_count = max(self.qubit_count, max(gate.qubits()) + 1)
        self._digest_cache = None
        self._prefix_chain = None
        # walk back past gates on disjoint qubits to find a merge partner
        i = len(self.gates) - 1
        gset = set(gate.qubits())
        while i >= 0:
            g = self.gates[i]
            if g.can_merge(gate):
                g.merge(gate)
                if g.is_identity():
                    del self.gates[i]
                return
            if set(g.qubits()) & gset:
                break  # overlapping, cannot commute further back
            i -= 1
        self.gates.append(gate.clone())

    def append_1q(self, target: int, m: np.ndarray) -> None:
        self.AppendGate(QCircuitGate.single(target, m))

    def append_ctrl(self, controls, target: int, m: np.ndarray, perm: int) -> None:
        self.AppendGate(QCircuitGate.controlled(controls, target, m, perm))

    def GetDepth(self) -> int:
        depth: Dict[int, int] = {}
        d = 0
        for g in self.gates:
            lvl = 1 + max((depth.get(q, 0) for q in g.qubits()), default=0)
            for q in g.qubits():
                depth[q] = lvl
            d = max(d, lvl)
        return d

    def GetGateCount(self) -> int:
        return len(self.gates)

    # ------------------------------------------------------------------

    def _lookahead_entries(self) -> List[Tuple[str, int]]:
        """(kind, target) stream in :meth:`Run`'s dispatch order, for a
        fuser that plans past its pending window (the pager's remap
        planner, ops/fusion.py plan_remaps)."""
        out: List[Tuple[str, int]] = []
        for g in self.gates:
            for _perm, m in g.payloads.items():
                out.append(("diag" if mat.is_phase(m) else "gen", g.target))
        return out

    def Run(self, qsim) -> None:
        """Execute on any QInterface (reference: src/qcircuit.cpp:173)."""
        if getattr(qsim, "_is_routed", False):
            # routing admission on the library path: plan and realize on
            # the calling thread, then dispatch into the chosen stack
            # (route/router.py route_for)
            qsim = qsim.route_for(self)
        # prime the engine fuser's lookahead with the full gate list so
        # the remap planner sees past the pending window; never clobber
        # a horizon an outer caller already installed
        fuser = getattr(qsim, "_fuser", None)
        primed = False
        if fuser is not None and fuser.lookahead is None:
            fuser.set_lookahead(self._lookahead_entries())
            primed = True
        try:
            for g in self.gates:
                for perm, m in g.payloads.items():
                    qsim.MCMtrxPerm(g.controls, m, g.target, perm)
        finally:
            if primed:
                fuser.clear_lookahead()

    def _check_fused_range(self, n: int) -> None:
        # the per-gate path validates through _check_qubit; the fused
        # path must reject out-of-range qubits just as loudly
        for g in self.gates:
            for q in g.qubits():
                if q < 0 or q >= n:
                    raise ValueError(f"qubit index {q} out of range (n={n})")

    def RunFused(self, qsim) -> None:
        """Execute the whole circuit as ONE fused window when the target
        is the dense plane engine or the pager (through QHybrid too): the
        gates lower to the parametric operand layout (ops/fusion.py) and
        the cost model picks the single-sweep window kernel (one sweep
        per planned segment) or the per-op window chain; on the pager the
        whole op list is also the remap planner's horizon
        (QPager._run_fused_ops).  A routed wrapper first picks its stack
        (route_for); the compressed engine takes the gates one by one
        through its own window funnel, as in the JAX package (its full
        float32 planes would defeat it, and past 30 qubits cannot be
        built).  Per-gate dispatch otherwise (which on a fuse-capable
        engine still windows through its fuser)."""
        from ..engines.cuda import QEngineCUDA
        from ..engines.hybrid import QHybrid
        from ..engines.turboquant import QEngineCUDATurboQuant
        from ..ops import fusion as fu
        from ..parallel.pager import QPager

        if getattr(qsim, "_is_routed", False):
            return self.RunFused(qsim.route_for(self))
        if isinstance(qsim, QHybrid):
            # fuse onto whatever engine the width switch currently holds
            inner = qsim._engine
            if isinstance(inner, (QEngineCUDA, QPager)):
                return self.RunFused(inner)
        if isinstance(qsim, QEngineCUDATurboQuant):
            return self.Run(qsim)
        if isinstance(qsim, QPager) and self.gates:
            self._check_fused_range(qsim.qubit_count)
            qsim._run_fused_ops(fu.lower_gates(self.gates))
            return
        if isinstance(qsim, QEngineCUDA) and self.gates:
            n = qsim.qubit_count
            self._check_fused_range(n)
            ops = fu.lower_gates(self.gates)
            if not ops:
                return
            qsim._state = fu.flush_window(qsim._state, n, ops)
            return
        self.Run(qsim)

    def PastLightCone(self, qubits) -> "QCircuit":
        """Sub-circuit causally relevant to `qubits` (reference:
        include/qcircuit.hpp:824; used by QTensorNetwork): a reverse walk
        that grows the cone by every gate it meets, the kept gates cloned
        in circuit order."""
        cone = set(qubits)
        keep: List[QCircuitGate] = []
        for g in reversed(self.gates):
            if set(g.qubits()) & cone:
                cone |= set(g.qubits())
                keep.append(g)
        out = QCircuit(self.qubit_count)
        out.gates = [g.clone() for g in reversed(keep)]
        return out

    def Inverse(self) -> "QCircuit":
        out = QCircuit(self.qubit_count)
        for g in reversed(self.gates):
            out.gates.append(QCircuitGate(
                g.target,
                {p: np.conj(m.T) for p, m in g.payloads.items()},
                g.controls,
            ))
        return out

    def clone(self) -> "QCircuit":
        out = QCircuit(self.qubit_count)
        out.gates = [g.clone() for g in self.gates]
        return out

    @staticmethod
    def _hash_gate(h, g: QCircuitGate) -> None:
        h.update(f"t{g.target};c{g.controls};".encode())
        for perm in sorted(g.payloads):
            h.update(f"p{perm}:".encode())
            h.update(np.ascontiguousarray(g.payloads[perm]).tobytes())

    def structure_digest(self) -> str:
        """Stable content hash of the gate sequence — targets, controls,
        AND payload values; byte for byte the JAX package's digest of the
        same gates.  Memoized per instance (invalidated by AppendGate)."""
        if self._digest_cache is not None:
            return self._digest_cache
        import hashlib

        h = hashlib.sha1()
        for g in self.gates:
            self._hash_gate(h, g)
        self._digest_cache = h.hexdigest()
        return self._digest_cache

    def _prefix_digests(self) -> List[str]:
        """Rolling digest chain: entry k is the digest of gates[:k+1],
        built in one pass (a hashlib digest is readable mid-stream).
        Entry -1 equals structure_digest()."""
        if self._prefix_chain is None:
            import hashlib

            chain: List[str] = []
            h = hashlib.sha1()
            for g in self.gates:
                self._hash_gate(h, g)
                chain.append(h.hexdigest())
            self._prefix_chain = chain
        return self._prefix_chain

    def prefix_digest(self, k: int) -> str:
        """Digest of the first `k` gates: two circuits share it iff their
        first k gates are equal (targets, controls, payload bytes).  k = 0
        is the empty prefix's digest; k = len(gates) equals
        structure_digest()."""
        if k <= 0:
            import hashlib

            return hashlib.sha1().hexdigest()
        chain = self._prefix_digests()
        if k > len(chain):
            raise IndexError(f"prefix length {k} > gate count {len(chain)}")
        return chain[k - 1]

    def shareable_prefix_len(self) -> int:
        """Longest gate prefix whose payloads are all unitary: a
        non-unitary payload (a recorded measurement or projection) ends
        the prefix a cached ket may be shared over."""
        for i, g in enumerate(self.gates):
            for m in g.payloads.values():
                if not _is_unitary_2x2(m):
                    return i
        return len(self.gates)

    def split_at(self, k: int) -> Tuple["QCircuit", "QCircuit"]:
        """(prefix, suffix) copies split before gate index `k`, gate for
        gate (not through AppendGate, whose merging could reshape the
        sequence the prefix digest hashed)."""
        pre = QCircuit(self.qubit_count)
        pre.gates = [g.clone() for g in self.gates[:k]]
        suf = QCircuit(self.qubit_count)
        suf.gates = [g.clone() for g in self.gates[k:]]
        return pre, suf

    def shape_key(self, n: int) -> Tuple[int, int, str]:
        """Batch-bucket key at engine width `n`: (width, gate-count
        bucket, structure digest)."""
        return (n, len(self.gates).bit_length(), self.structure_digest())

    # ------------------------------------------------------------------
    # the whole circuit as one program over planes
    # ------------------------------------------------------------------

    def _plain_body(self):
        """fn(planes, width) applying every payload through the plain gate
        functions (gatekernels); gates act below bit n of a ket of any
        width >= n."""
        from ..ops import gatekernels as gk

        gates = [(g.target, g.controls, dict(g.payloads)) for g in self.gates]

        def body(planes, width: int):
            for (target, controls, payloads) in gates:
                for perm, m in payloads.items():
                    cmask = 0
                    cval = 0
                    for j, c in enumerate(controls):
                        cmask |= 1 << c
                        if (perm >> j) & 1:
                            cval |= 1 << c
                    if mat.is_phase(m):
                        planes = gk.apply_diag(
                            planes, m[0, 0].real, m[0, 0].imag,
                            m[1, 1].real, m[1, 1].imag,
                            width, 1 << target, cmask, cval)
                    elif mat.is_invert(m):
                        planes = gk.apply_invert(
                            planes, m[0, 1].real, m[0, 1].imag,
                            m[1, 0].real, m[1, 0].imag,
                            width, target, cmask, cval)
                    else:
                        mp = gk.mtrx_planes(m, planes.dtype, "cpu")
                        planes = gk.apply_2x2(planes, mp, width, target,
                                              cmask, cval)
            return planes

        return body

    def compile_fn(self, n: int):
        """fn(planes) applying the whole circuit to (2, 2^n) split planes
        through the plain gate functions, gate by gate; returns new planes
        (the input is left alone)."""
        body = self._plain_body()

        def fn(planes):
            return body(planes, n)

        return fn

    def compile_sharded_fn(self, pages, n: int, device=None):
        """The whole circuit over a ket in pages: `pages` is a page count
        (each on `device`, ``cuda`` by default) or a device list that may
        repeat a device (the JAX package takes a Mesh).  In-page gates
        run per page, paged targets as the pager's pair mix, diagonals
        with split (local, page) masks: every pass in place, block by
        block.  Returns (fn, devices); fn(page list) applies the circuit
        in place, as models.qft.make_sharded_qft_fn does."""
        from ..ops import sharded as sh
        from ..utils.bits import control_offset

        devs = sh.page_devices(pages, device)
        L = n - (len(devs).bit_length() - 1)
        if L < 1:
            raise ValueError("at least one in-page qubit a page")
        gates = [(g.target, g.controls, dict(g.payloads)) for g in self.gates]

        def fn(pgs):
            for (target, controls, payloads) in gates:
                cmask = 0
                for c in controls:
                    cmask |= 1 << c
                for perm, m in payloads.items():
                    cval = control_offset(controls, perm)
                    lm, lv, gm, gv = sh.split_masks(cmask, cval, L)
                    if mat.is_phase(m):
                        tmask = 1 << target
                        sh.apply_diag(pgs, m[0, 0].real, m[0, 0].imag,
                                      m[1, 1].real, m[1, 1].imag,
                                      tmask & ((1 << L) - 1), tmask >> L,
                                      lm, lv, gm, gv)
                    else:
                        mp = np.stack([m.real, m.imag])
                        if target < L:
                            sh.apply_local_2x2(pgs, mp, L, target, lm, lv,
                                               gm, gv)
                        else:
                            sh.apply_global_2x2(pgs, mp, target - L, lm, lv,
                                                gm, gv)
            return pgs

        return fn, devs

    def compile_fn_pallas(self, n: int, block_pow: Optional[int] = None):
        """fn(planes) applying the circuit through the window kernel
        (K1/K2, ops/window_kernel.py): one sweep over the ket per planned
        segment, matrices and masks as runtime operands in the planes'
        dtype.  Updates the planes in place and returns them.
        ``fn.sweeps`` is the planned sweep count.  The name keeps the JAX
        package's, whose form is its Pallas kernel; on a CPU tensor the
        kernel's plain version runs."""
        from ..ops import fusion as fu
        from ..ops import window_kernel as wk

        self._check_fused_range(n)
        ops = fu.lower_gates(self.gates)
        structure = fu.structure_of(ops)
        wfn = wk.make_window_fn(
            n, structure,
            block_pow=wk.DEFAULT_BLOCK_POW if block_pow is None else block_pow)

        def fn(planes):
            if not ops:
                return planes
            return wfn(planes, *fu.dense_operands(ops, planes.dtype))

        fn.sweeps = wfn.sweeps if ops else 0
        return fn

    def compile_batched_fn(self, n: int):
        """fn(stacked) applying the circuit to each ket of a (B, 2, 2^n)
        batch; returns a new (B, 2, 2^n) batch.  The batch axis becomes
        the high bits of one ket of n + ceil(log2 B) qubits (padded with
        zero kets to a power of two): every gate acts below bit n, so
        each plain gate pass covers the whole batch and its masks see each
        ket alone (the JAX package vmaps compile_fn)."""
        self._check_fused_range(n)
        body = self._plain_body()

        def fn(stacked):
            B = stacked.shape[0]
            b = (B - 1).bit_length()
            flat = stacked.transpose(0, 1)
            if B != 1 << b:
                pad = flat.new_zeros((2, (1 << b) - B, 1 << n))
                flat = torch.cat([flat, pad], dim=1)
            out = body(flat.reshape(2, -1), n + b)
            return out.reshape(2, 1 << b, 1 << n)[:, :B].transpose(0, 1) \
                .contiguous()

        return fn
