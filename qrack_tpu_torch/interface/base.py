"""QInterface base: the universal gate-level simulator API.

TPU-native re-design of the reference's `QInterface` abstract class
(reference: include/qinterface.hpp:141 — ~400 virtual methods;
src/qinterface/qinterface.cpp — default syntheses). Everything a layer
or engine must implement is reduced to a small primitive contract:

  * ``MCMtrxPerm(controls, mtrx, target, perm)`` — the one gate primitive
  * ``Prob(q)`` / ``ForceM(q, ...)``           — measurement
  * ``Compose / Decompose / Dispose / Allocate`` — structure changes
  * ``GetQuantumState / SetQuantumState / GetAmplitude / SetPermutation``
  * ``Clone`` / ``SumSqrDiff``

Every other method (named gates, rotations, register ops, ALU,
expectation/variance, sampling) is synthesized here, exactly mirroring
how the reference keeps its engines small (reference:
src/qinterface/gates.cpp, rotational.cpp, arithmetic.cpp, logic.cpp).

Index convention matches the reference: qubit 0 is the least-significant
bit of a basis-state permutation index.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..config import FP_NORM_EPSILON, get_config
from ..utils.bits import bit_reg_mask, popcount, pow2
from ..utils.rng import QrackRandom
from .. import matrices as mat


class QInterfaceBase:
    """Core state, primitive contract, measurement, and structure ops."""

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    def __init__(
        self,
        qubit_count: int,
        init_state: int = 0,
        rng: Optional[QrackRandom] = None,
        do_normalize: bool = True,
        rand_global_phase: bool = True,
        amplitude_floor: float = 0.0,
        **kwargs,
    ):
        self.qubit_count = int(qubit_count)
        self.do_normalize = do_normalize
        self.rand_global_phase = rand_global_phase
        self.amplitude_floor = amplitude_floor
        self.rng = rng if rng is not None else QrackRandom()
        self.running_norm = 1.0
        self.config = get_config()

    # -- capacity accessors (reference: include/qinterface.hpp:330-380) --

    def GetQubitCount(self) -> int:
        return self.qubit_count

    def GetMaxQPower(self) -> int:
        return pow2(self.qubit_count)

    def SetRandomSeed(self, seed: int) -> None:
        self.rng.seed(seed)

    def Rand(self) -> float:
        return self.rng.rand()

    # ------------------------------------------------------------------
    # Primitive contract (abstract)
    # ------------------------------------------------------------------

    def MCMtrxPerm(
        self,
        controls: Sequence[int],
        mtrx: np.ndarray,
        target: int,
        perm: int,
    ) -> None:
        """Apply `mtrx` to `target` when controls[j] == bit j of `perm`.

        The single gate primitive; subsumes Mtrx/MCMtrx/MACMtrx/UCMtrx
        (reference: Apply2x2 offset computation, src/qengine/qengine.cpp).
        """
        raise NotImplementedError

    def Prob(self, q: int) -> float:
        """P(qubit q == 1) (reference: include/qinterface.hpp:2483)."""
        raise NotImplementedError

    def ForceM(self, q: int, result: bool, do_force: bool = True, do_apply: bool = True) -> bool:
        """Measure q, optionally forcing the outcome
        (reference: include/qinterface.hpp:1031)."""
        raise NotImplementedError

    def Compose(self, other: "QInterfaceBase", start: Optional[int] = None) -> int:
        """Tensor `other` into self at `start` (default: append); returns
        the mapped start index (reference: include/qinterface.hpp:382)."""
        raise NotImplementedError

    def Decompose(self, start: int, dest: "QInterfaceBase") -> None:
        """Split `dest.qubit_count` qubits out of self into dest
        (must be separable) (reference: include/qinterface.hpp:443)."""
        raise NotImplementedError

    def Dispose(self, start: int, length: int, disposed_perm: Optional[int] = None) -> None:
        """Drop `length` separable qubits (reference: include/qinterface.hpp:468)."""
        raise NotImplementedError

    def Allocate(self, start: int, length: int = 1) -> int:
        """Add `length` |0> qubits at `start` (reference: include/qinterface.hpp:485)."""
        raise NotImplementedError

    def GetQuantumState(self) -> np.ndarray:
        raise NotImplementedError

    def SetQuantumState(self, state: np.ndarray) -> None:
        raise NotImplementedError

    def GetAmplitude(self, perm: int) -> complex:
        raise NotImplementedError

    def SetAmplitude(self, perm: int, amp: complex) -> None:
        raise NotImplementedError

    def SetPermutation(self, perm: int, phase: complex = 1.0) -> None:
        raise NotImplementedError

    def Clone(self) -> "QInterfaceBase":
        raise NotImplementedError

    def SumSqrDiff(self, other: "QInterfaceBase") -> float:
        """1 - |<self|other>|^2 distance proxy
        (reference: include/qinterface.hpp:2844)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Gate-primitive conveniences (reference: include/qinterface.hpp:503-650)
    # ------------------------------------------------------------------

    def Mtrx(self, mtrx: np.ndarray, target: int) -> None:
        self.MCMtrxPerm((), mtrx, target, 0)

    def MCMtrx(self, controls: Sequence[int], mtrx: np.ndarray, target: int) -> None:
        self.MCMtrxPerm(controls, mtrx, target, (1 << len(controls)) - 1)

    def MACMtrx(self, controls: Sequence[int], mtrx: np.ndarray, target: int) -> None:
        self.MCMtrxPerm(controls, mtrx, target, 0)

    def UCMtrx(
        self,
        controls: Sequence[int],
        mtrxs: Sequence[np.ndarray],
        target: int,
        mtrx_skip_powers: Sequence[int] = (),
        mtrx_skip_value_mask: int = 0,
    ) -> None:
        """Uniformly-controlled gate: one 2x2 payload per control permutation
        (reference: src/qinterface/gates.cpp:23)."""
        n = len(controls)
        for perm in range(1 << n):
            m_index = perm
            if mtrx_skip_powers:
                # splice skip bits into the matrix index (reference semantics)
                for j, p in enumerate(sorted(mtrx_skip_powers)):
                    low = m_index & (p - 1)
                    m_index = ((m_index & ~(p - 1)) << 1) | low
                m_index |= mtrx_skip_value_mask
            self.MCMtrxPerm(controls, np.asarray(mtrxs[m_index]), target, perm)

    # Phase/Invert specializations — engines override with diagonal fast
    # paths (reference: Phase/Invert include/qinterface.hpp:512-540).

    def Phase(self, top_left: complex, bottom_right: complex, target: int) -> None:
        self.Mtrx(mat.phase_mtrx(top_left, bottom_right), target)

    def Invert(self, top_right: complex, bottom_left: complex, target: int) -> None:
        self.Mtrx(mat.invert_mtrx(top_right, bottom_left), target)

    def MCPhase(self, controls, top_left: complex, bottom_right: complex, target: int) -> None:
        self.MCMtrx(controls, mat.phase_mtrx(top_left, bottom_right), target)

    def MCInvert(self, controls, top_right: complex, bottom_left: complex, target: int) -> None:
        self.MCMtrx(controls, mat.invert_mtrx(top_right, bottom_left), target)

    def MACPhase(self, controls, top_left: complex, bottom_right: complex, target: int) -> None:
        self.MACMtrx(controls, mat.phase_mtrx(top_left, bottom_right), target)

    def MACInvert(self, controls, top_right: complex, bottom_left: complex, target: int) -> None:
        self.MACMtrx(controls, mat.invert_mtrx(top_right, bottom_left), target)

    def UCPhase(self, controls, top_left, bottom_right, target, perm) -> None:
        self.MCMtrxPerm(controls, mat.phase_mtrx(top_left, bottom_right), target, perm)

    def UCInvert(self, controls, top_right, bottom_left, target, perm) -> None:
        self.MCMtrxPerm(controls, mat.invert_mtrx(top_right, bottom_left), target, perm)

    # ------------------------------------------------------------------
    # Measurement & sampling defaults
    # (reference: include/qinterface.hpp:1031-1038, 2379-2396, 2802-2818;
    #  src/qinterface/qinterface.cpp:228, :807)
    # ------------------------------------------------------------------

    def M(self, q: int) -> bool:
        return self.ForceM(q, False, do_force=False)

    def ForceMReg(
        self, start: int, length: int, result: int, do_force: bool = True, do_apply: bool = True
    ) -> int:
        """Measure a register; returns the measured integer
        (reference: src/qinterface/qinterface.cpp:228 ForceM-many)."""
        res = 0
        for i in range(length):
            bit = bool((result >> i) & 1)
            if self.ForceM(start + i, bit, do_force=do_force, do_apply=do_apply):
                res |= 1 << i
        return res

    def MReg(self, start: int, length: int) -> int:
        return self.ForceMReg(start, length, 0, do_force=False)

    def MAll(self) -> int:
        return self.MReg(0, self.qubit_count)

    def ForceMBits(self, bits: Sequence[int], values: int, do_apply: bool = True) -> int:
        res = 0
        for j, q in enumerate(bits):
            bit = bool((values >> j) & 1)
            if self.ForceM(q, bit, do_force=True, do_apply=do_apply):
                res |= 1 << j
        return res

    def MultiShotMeasureMask(self, q_powers: Sequence[int], shots: int) -> dict:
        """Repeated non-collapsing sampling of the qubits in `q_powers`
        (reference: src/qinterface/qinterface.cpp:807 — clone-based default;
        dense engines override with a vectorized categorical draw)."""
        results: dict = {}
        for _ in range(shots):
            clone = self.Clone()
            all_bits = clone.MAll()
            key = 0
            for j, p in enumerate(q_powers):
                if all_bits & p:
                    key |= 1 << j
            results[key] = results.get(key, 0) + 1
        return results

    def SampleClone(self, q_powers: Sequence[int]) -> int:
        clone = self.Clone()
        all_bits = clone.MAll()
        key = 0
        for j, p in enumerate(q_powers):
            if all_bits & p:
                key |= 1 << j
        return key

    # ------------------------------------------------------------------
    # Probability / expectation / variance defaults
    # (reference: include/qinterface.hpp:2483-2798;
    #  src/qinterface/qinterface.cpp:423-850)
    # ------------------------------------------------------------------

    def ProbAll(self, perm: int) -> float:
        return abs(self.GetAmplitude(perm)) ** 2

    def CProb(self, control: int, target: int) -> float:
        """P(target==1 | control==1) (reference: include/qinterface.hpp:2495)."""
        return self._prob_cond(control, target, True)

    def ACProb(self, control: int, target: int) -> float:
        return self._prob_cond(control, target, False)

    def _prob_cond(self, control: int, target: int, control_on: bool) -> float:
        probs = self.GetProbs()
        idx = np.arange(probs.shape[0])
        cmask = (idx >> control) & 1
        sel = cmask == (1 if control_on else 0)
        denom = float(probs[sel].sum())
        if denom <= FP_NORM_EPSILON:
            return 0.0
        tsel = sel & (((idx >> target) & 1) == 1)
        return float(probs[tsel].sum()) / denom

    def GetProbs(self) -> np.ndarray:
        state = self.GetQuantumState()
        return (state.real ** 2 + state.imag ** 2).astype(np.float64)

    def ProbReg(self, start: int, length: int, perm: int) -> float:
        """P(register [start,start+length) == perm)
        (reference: include/qinterface.hpp:2520)."""
        return self.ProbMask(bit_reg_mask(start, length), perm << start)

    def ProbMask(self, mask: int, perm: int) -> float:
        """P(masked bits == perm) (reference: src/qinterface/qinterface.cpp:423)."""
        probs = self.GetProbs()
        idx = np.arange(probs.shape[0], dtype=np.int64)
        return float(probs[(idx & mask) == perm].sum())

    def ProbMaskAll(self, mask: int) -> np.ndarray:
        """Distribution over all permutations of the masked bits
        (reference: src/qinterface/qinterface.cpp:423 ProbMaskAll)."""
        bits = [i for i in range(self.qubit_count) if (mask >> i) & 1]
        probs = self.GetProbs()
        idx = np.arange(probs.shape[0], dtype=np.int64)
        key = np.zeros_like(idx)
        for j, b in enumerate(bits):
            key |= ((idx >> b) & 1) << j
        out = np.zeros(1 << len(bits), dtype=np.float64)
        np.add.at(out, key, probs)
        return out

    def ProbBitsAll(self, bits: Sequence[int]) -> np.ndarray:
        mask = 0
        for b in bits:
            mask |= 1 << b
        return self.ProbMaskAll(mask)

    def ExpectationBitsAll(self, bits: Sequence[int], offset: int = 0) -> float:
        """<integer value of bits> (reference: src/qinterface/qinterface.cpp:478)."""
        dist = self.ProbBitsAll(bits)
        vals = np.arange(dist.shape[0], dtype=np.float64) + offset
        return float((dist * vals).sum())

    def ExpectationBitsFactorized(
        self, bits: Sequence[int], perms: Sequence[int], offset: int = 0
    ) -> float:
        """Expectation with per-bit integer weights: value of outcome is
        sum_j perms[2*j + bit_j] (reference: ExpectationBitsFactorized)."""
        dist = self.ProbBitsAll(bits)
        vals = np.zeros(dist.shape[0], dtype=np.float64)
        for k in range(dist.shape[0]):
            v = offset
            for j in range(len(bits)):
                v += perms[2 * j + ((k >> j) & 1)]
            vals[k] = v
        return float((dist * vals).sum())

    def ExpectationFloatsFactorized(self, bits: Sequence[int], weights: Sequence[float]) -> float:
        dist = self.ProbBitsAll(bits)
        vals = np.zeros(dist.shape[0], dtype=np.float64)
        for k in range(dist.shape[0]):
            v = 0.0
            for j in range(len(bits)):
                v += weights[2 * j + ((k >> j) & 1)]
            vals[k] = v
        return float((dist * vals).sum())

    def _variance_from(self, dist: np.ndarray, vals: np.ndarray) -> float:
        mean = float((dist * vals).sum())
        return float((dist * (vals - mean) ** 2).sum())

    def VarianceBitsAll(self, bits: Sequence[int], offset: int = 0) -> float:
        dist = self.ProbBitsAll(bits)
        vals = np.arange(dist.shape[0], dtype=np.float64) + offset
        return self._variance_from(dist, vals)

    def VarianceBitsFactorized(
        self, bits: Sequence[int], perms: Sequence[int], offset: int = 0
    ) -> float:
        dist = self.ProbBitsAll(bits)
        vals = np.zeros(dist.shape[0], dtype=np.float64)
        for k in range(dist.shape[0]):
            v = offset
            for j in range(len(bits)):
                v += perms[2 * j + ((k >> j) & 1)]
            vals[k] = v
        return self._variance_from(dist, vals)

    def VarianceFloatsFactorized(self, bits: Sequence[int], weights: Sequence[float]) -> float:
        dist = self.ProbBitsAll(bits)
        vals = np.zeros(dist.shape[0], dtype=np.float64)
        for k in range(dist.shape[0]):
            v = 0.0
            for j in range(len(bits)):
                v += weights[2 * j + ((k >> j) & 1)]
            vals[k] = v
        return self._variance_from(dist, vals)

    # -- Pauli / single-qubit-unitary tensor observables, overridable at
    #    the layer level (reference: ExpectationPauliAll /
    #    VariancePauliAll / ExpectationUnitaryAll,
    #    include/qinterface.hpp:2688-2712; ExpVarUnitaryAll,
    #    src/qinterface/qinterface.cpp:478) --

    def _transform_pauli_basis(self, paulis, bits) -> int:
        """Rotate X/Y observables into Z; returns the joint Z mask
        (reference: TransformPauliBasis, src/pinvoke_api.cpp)."""
        from ..pauli import Pauli

        mask = 0
        for b, qi in zip(paulis, bits):
            p = Pauli(b)
            if p == Pauli.PauliX:
                self.H(qi)
            elif p == Pauli.PauliY:
                self.IS(qi)
                self.H(qi)
            if p != Pauli.PauliI:
                mask |= 1 << qi
        return mask

    def _revert_pauli_basis(self, paulis, bits) -> None:
        from ..pauli import Pauli

        for b, qi in zip(paulis, bits):
            p = Pauli(b)
            if p == Pauli.PauliX:
                self.H(qi)
            elif p == Pauli.PauliY:
                self.H(qi)
                self.S(qi)

    def ExpectationPauliAll(self, bits: Sequence[int], paulis: Sequence[int]) -> float:
        """<P_1 (x) P_2 (x) ...> by basis conjugation: +-1 eigenvalues
        weighted by joint parity."""
        mask = self._transform_pauli_basis(paulis, bits)
        try:
            p_odd = self.ProbParity(mask) if mask else 0.0
        finally:
            self._revert_pauli_basis(paulis, bits)
        return 1.0 - 2.0 * p_odd

    def VariancePauliAll(self, bits: Sequence[int], paulis: Sequence[int]) -> float:
        e = self.ExpectationPauliAll(bits, paulis)
        return max(0.0, 1.0 - e * e)  # P^2 == I for any Pauli string

    def _unitary_stat(self, bits, basis_ops, eigen_vals, variance: bool) -> float:
        """Expectation/variance of per-qubit observables diagonalized by
        the given 2x2 unitaries; conjugation is applied and undone."""
        ms = [np.asarray(m, dtype=np.complex128).reshape(2, 2)
              for m in basis_ops]
        for qi, m in zip(bits, ms):
            self.Mtrx(np.conj(m.T), qi)
        try:
            w = ([1.0, -1.0] * len(list(bits)) if eigen_vals is None
                 else [float(v) for v in eigen_vals])
            stat = (self.VarianceFloatsFactorized(list(bits), w) if variance
                    else self.ExpectationFloatsFactorized(list(bits), w))
        finally:
            for qi, m in zip(bits, ms):
                self.Mtrx(m, qi)
        return float(stat)

    def ExpectationUnitaryAll(self, bits: Sequence[int], basis_ops,
                              eigen_vals=None) -> float:
        return self._unitary_stat(bits, basis_ops, eigen_vals, False)

    def VarianceUnitaryAll(self, bits: Sequence[int], basis_ops,
                           eigen_vals=None) -> float:
        return self._unitary_stat(bits, basis_ops, eigen_vals, True)

    # Reduced-density-matrix ("Rdm") variants: for exact simulation these
    # coincide with the plain versions; approximate layers override
    # (reference: include/qinterface.hpp:2483-2798 *Rdm family).

    def ProbRdm(self, q: int) -> float:
        return self.Prob(q)

    def ProbAllRdm(self, round_rz: bool, perm: int) -> float:
        return self.ProbAll(perm)

    def ProbMaskRdm(self, round_rz: bool, mask: int, perm: int) -> float:
        return self.ProbMask(mask, perm)

    def ExpectationBitsAllRdm(self, round_rz: bool, bits: Sequence[int], offset: int = 0) -> float:
        return self.ExpectationBitsAll(bits, offset)

    def VarianceBitsAllRdm(self, round_rz: bool, bits: Sequence[int], offset: int = 0) -> float:
        return self.VarianceBitsAll(bits, offset)

    def GetReducedDensityMatrix(self, bits: Sequence[int]) -> np.ndarray:
        """Dense RDM over `bits` by partial trace
        (reference: src/qinterface/qinterface.cpp:886)."""
        n = self.qubit_count
        state = np.asarray(self.GetQuantumState(), dtype=np.complex128)
        tensor = state.reshape((2,) * n)
        # numpy axis k corresponds to qubit n-1-k
        keep_axes = [n - 1 - b for b in bits]
        other = [a for a in range(n) if a not in keep_axes]
        perm = keep_axes + other
        t = np.transpose(tensor, perm).reshape(1 << len(bits), -1)
        return t @ t.conj().T

    # ------------------------------------------------------------------
    # Comparison / normalization
    # (reference: include/qinterface.hpp:2834-2906)
    # ------------------------------------------------------------------

    def ApproxCompare(self, other: "QInterfaceBase", error_tol: float = 1e-4) -> bool:
        return self.SumSqrDiff(other) <= error_tol

    def UpdateRunningNorm(self, norm_thresh: float = -1.0) -> None:
        pass

    def NormalizeState(self, nrm: float = -1.0, norm_thresh: float = -1.0, phase_arg: float = 0.0) -> None:
        pass

    def Finish(self) -> None:
        """Block until queued work completes (reference:
        include/qinterface.hpp:2873; JAX analogue: block_until_ready)."""
        pass

    def isFinished(self) -> bool:
        return True

    def Dump(self) -> None:
        pass

    # ------------------------------------------------------------------
    # Fidelity / approximation controls
    # (reference: include/qinterface.hpp:2925-3104)
    # ------------------------------------------------------------------

    def TrySeparate(self, qubits, error_tol: Optional[float] = None) -> bool:
        """Attempt Schmidt separation (no-op outside QUnit)."""
        return False

    def GetUnitaryFidelity(self) -> float:
        return 1.0

    def ResetUnitaryFidelity(self) -> None:
        pass

    def SetSdrp(self, sdrp: float) -> None:
        pass

    def SetNcrp(self, ncrp: float) -> None:
        pass

    def SetReactiveSeparate(self, flag: bool) -> None:
        pass

    def GetReactiveSeparate(self) -> bool:
        return False

    def SetTInjection(self, flag: bool) -> None:
        pass

    def GetTInjection(self) -> bool:
        return False

    def SetNoiseParameter(self, lam: float) -> None:
        pass

    def isClifford(self, q: Optional[int] = None) -> bool:
        return False

    def isBinaryDecisionTree(self) -> bool:
        return False

    def isOpenCL(self) -> bool:  # legacy name kept for API parity
        return False

    def SetDevice(self, device_id: int) -> None:
        pass

    def SetDeviceList(self, device_ids: Sequence[int]) -> None:
        pass

    def GetDevice(self) -> int:
        return -1

    def GetDeviceList(self) -> List[int]:
        return []

    # ------------------------------------------------------------------
    # Noise (reference: include/qinterface.hpp:3104)
    # ------------------------------------------------------------------

    def DepolarizingChannelWeak1Qb(self, q: int, lam: float) -> None:
        """Weak (stochastic-unraveling) single-qubit depolarizing channel:
        with probability 3λ/4 apply a uniformly random non-identity Pauli."""
        if lam <= 0.0:
            return
        if self.Rand() < 0.75 * lam:
            which = self.rng.randint(0, 3)
            if which == 0:
                self.X(q)
            elif which == 1:
                self.Y(q)
            else:
                self.Z(q)

    # ------------------------------------------------------------------
    # Lossy save/load (reference: include/qinterface.hpp:302-307;
    # src/qinterface/qinterface.cpp:855-884)
    # ------------------------------------------------------------------

    def LossySaveStateVector(self, path: str, bits: int = 8, block_pow: int = 12) -> None:
        from ..storage.turboquant import lossy_save

        lossy_save(self.GetQuantumState(), path, bits=bits, block_pow=block_pow)

    def LossyLoadStateVector(self, path: str) -> None:
        from ..storage.turboquant import lossy_load

        self.SetQuantumState(lossy_load(path))

    # ------------------------------------------------------------------
    # misc helpers shared by mixins
    # ------------------------------------------------------------------

    def _check_qubit(self, q: int) -> None:
        if q < 0 or q >= self.qubit_count:
            raise ValueError(f"qubit index {q} out of range (n={self.qubit_count})")

    def _check_range(self, start: int, length: int) -> None:
        if start < 0 or length < 0 or start + length > self.qubit_count:
            raise ValueError(
                f"register [{start}, {start + length}) out of range (n={self.qubit_count})"
            )
