"""Single-qubit Kraus channel algebra + the sequential trajectory oracle.

Channel semantics follow the reference's noisy wrapper
(include/qinterface_noisy.hpp:26, `DepolarizingChannelWeak1Qb`
interface/base.py:576): a channel is attached after every gate on every
touched qubit, and ONE Kraus branch is sampled per application — the
Monte-Carlo unraveling, not the density-matrix evolution.

Branch sampling is **counter-based**: every channel application in a
circuit has a monotone application counter `app_seq`, and the uniform
that decides its branch is a pure function of
``(key, trajectory_id, app_seq)`` (numpy Philox, no sequential stream
state).  Both the batched trajectory engine (trajectories.py) and the
sequential :class:`QNoisy` oracle below derive branches from the same
function, which is what makes single-trajectory reproducibility — and
hence parity testing and mid-batch checkpoint resume — exact rather
than statistical.

Branch application has two regimes (docs/NOISE.md):

* **mixed-unitary** channels (depolarizing, dephasing): every Kraus
  operator is sqrt(q_i)·U_i.  Sampling branch i with probability q_i
  and applying the *unitary* U_i is an exact unraveling — trajectory
  weight stays 1.
* **general** channels (amplitude damping, arbitrary Kraus): branches
  are sampled from the state-independent prior q_i = tr(K_i†K_i)/2, the
  *raw* K_i is applied, the ket renormalized, and the trajectory weight
  multiplied by ‖K_i|ψ⟩‖²/q_i — an importance-weighted unraveling with
  E[w·|ψ̃⟩⟨ψ̃|] = Σ_i K_i ρ K_i† (unbiased without state-dependent
  branch probabilities, which would force a device→host sync per gate).

Port note: a copy of the JAX package's noise/channels.py (numpy, so the
Philox draws are the same numbers); QNoisy builds its inner stack with
the port's factory.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

_I2 = np.eye(2, dtype=np.complex128)

PAULI = {
    "I": _I2,
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
}


class ChannelError(ValueError):
    """Raised for non-CPTP Kraus sets or malformed channel specs."""


# ---------------------------------------------------------------------------
# counter-based per-trajectory rng
# ---------------------------------------------------------------------------

# Domain constants keep the channel-branch stream and the terminal
# measurement draw on disjoint Philox keys even at equal counters.
BRANCH_DOMAIN = 0x6E6F6973  # "nois"
MEASURE_DOMAIN = 0x6D656173  # "meas"

_U64 = (1 << 64) - 1


def traj_uniform(key: int, trajectory_id: int, app_seq: int,
                 domain: int = BRANCH_DOMAIN) -> float:
    """The one uniform that decides channel application `app_seq` of
    trajectory `trajectory_id` under batch seed `key`.

    Counter-based (Philox keyed on the full coordinate, zero stream
    state): any single draw is computable in isolation, so a resumed
    chunk, a sequential oracle, and the full batch all see identical
    randomness without replaying a stream prefix.
    """
    gen = np.random.Generator(np.random.Philox(
        key=[int(key) & _U64, int(domain) & _U64],
        counter=[int(trajectory_id) & _U64, int(app_seq) & _U64, 0, 0]))
    return float(gen.random())


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------

class KrausChannel:
    """A single-qubit channel as an explicit Kraus set {K_i}.

    `priors` are the state-independent branch probabilities
    q_i = tr(K_i†K_i)/2 (they sum to 1 by CPTP); `unitary` is True when
    every branch is a scaled unitary, i.e. the channel is mixed-unitary
    and the unraveling is exact with unit trajectory weight.
    `branch_matrix(i)` is what a trajectory actually applies: U_i for
    mixed-unitary channels, raw K_i (renormalize + weight) otherwise.
    """

    __slots__ = ("name", "kraus", "priors", "unitary", "_cum", "_branch")

    def __init__(self, name: str, kraus: Sequence[np.ndarray],
                 atol: float = 1e-8):
        mats = [np.asarray(k, dtype=np.complex128).reshape(2, 2)
                for k in kraus]
        if not mats:
            raise ChannelError(f"channel {name!r}: empty Kraus set")
        total = np.zeros((2, 2), dtype=np.complex128)
        for k in mats:
            total += k.conj().T @ k
        if not np.allclose(total, _I2, atol=max(atol, 1e-8)):
            raise ChannelError(
                f"channel {name!r}: Kraus completeness violated, "
                f"sum K^dag K = {total.tolist()!r}")
        self.name = str(name)
        self.kraus = mats
        self.priors = np.array(
            [float(np.trace(k.conj().T @ k).real) / 2.0 for k in mats])
        self.unitary = True
        self._branch: List[np.ndarray] = []
        for k, q in zip(mats, self.priors):
            if q <= atol:
                self._branch.append(k)
                continue
            u = k / np.sqrt(q)
            if np.allclose(u @ u.conj().T, _I2, atol=1e-6):
                self._branch.append(u)
            else:
                self.unitary = False
        if not self.unitary:
            self._branch = list(mats)
        self._cum = np.cumsum(self.priors)

    def __len__(self) -> int:
        return len(self.kraus)

    def __repr__(self) -> str:
        kind = "mixed-unitary" if self.unitary else "general"
        return f"KrausChannel({self.name!r}, {len(self.kraus)} branches, {kind})"

    def sample(self, u: float) -> int:
        """Branch index for uniform u in [0, 1): inverse-CDF over the
        priors in listed order.  For :func:`depolarizing` the listed
        order (X, Y, Z, I) reproduces the reference weak-channel rule —
        u < 0.75·lam picks a uniform Pauli, else identity."""
        i = int(np.searchsorted(self._cum, u, side="right"))
        return min(i, len(self.kraus) - 1)

    def branch_matrix(self, i: int) -> np.ndarray:
        return self._branch[i]

    # -- serialization (WAL journaling of trajectory jobs) -------------

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kraus": [[[z.real, z.imag] for z in k.ravel()]
                      for k in self.kraus],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "KrausChannel":
        mats = [np.array([complex(re, im) for re, im in k],
                         dtype=np.complex128).reshape(2, 2)
                for k in d["kraus"]]
        return cls(d.get("name", "kraus"), mats)


def depolarizing(lam: float) -> KrausChannel:
    """Weak depolarizing channel matching the reference
    `DepolarizingChannelWeak1Qb` (interface/base.py:576): with
    probability 0.75·lam apply a uniformly random Pauli, else identity.
    Branch order (X, Y, Z, I) so inverse-CDF sampling reproduces the
    reference's `Rand() < 0.75*lam` threshold rule exactly."""
    lam = float(lam)
    if not 0.0 <= lam <= 1.0:
        raise ChannelError(f"depolarizing lam {lam} outside [0, 1]")
    p = lam / 4.0
    return KrausChannel(f"depolarizing({lam})", [
        np.sqrt(p) * PAULI["X"],
        np.sqrt(p) * PAULI["Y"],
        np.sqrt(p) * PAULI["Z"],
        np.sqrt(1.0 - 3.0 * p) * PAULI["I"],
    ])


def dephasing(p: float) -> KrausChannel:
    """Phase-flip channel: Z with probability p, identity otherwise."""
    p = float(p)
    if not 0.0 <= p <= 1.0:
        raise ChannelError(f"dephasing p {p} outside [0, 1]")
    return KrausChannel(f"dephasing({p})", [
        np.sqrt(p) * PAULI["Z"],
        np.sqrt(1.0 - p) * PAULI["I"],
    ])


def amplitude_damping(gamma: float) -> KrausChannel:
    """T1 decay: K0 = diag(1, sqrt(1-gamma)), K1 = sqrt(gamma)|0><1|.
    Non-unitary branches — trajectories renormalize and carry an
    importance weight."""
    g = float(gamma)
    if not 0.0 <= g <= 1.0:
        raise ChannelError(f"amplitude_damping gamma {g} outside [0, 1]")
    k0 = np.array([[1.0, 0.0], [0.0, np.sqrt(1.0 - g)]],
                  dtype=np.complex128)
    k1 = np.array([[0.0, np.sqrt(g)], [0.0, 0.0]], dtype=np.complex128)
    return KrausChannel(f"amplitude_damping({g})", [k0, k1])


def kraus_channel(name: str, kraus: Sequence[np.ndarray]) -> KrausChannel:
    """General single-qubit channel from explicit Kraus matrices
    (CPTP-validated)."""
    return KrausChannel(name, kraus)


# ---------------------------------------------------------------------------
# noise model
# ---------------------------------------------------------------------------

class NoiseModel:
    """Per-gate/per-qubit channel attachment, the way the reference's
    `QInterfaceNoisy` does it: after every gate, every touched qubit
    (target ∪ controls) receives the attached channels in deterministic
    order — `default` first, then any per-qubit extras.

    The attachment order plus the sorted-qubit iteration defines the
    channel-application schedule (one `app_seq` per slot) shared by the
    batch pre-sampler and the sequential oracle.
    """

    def __init__(self, default: Optional[KrausChannel] = None,
                 per_qubit: Optional[Dict[int, Sequence[KrausChannel]]] = None):
        self.default = default
        self.per_qubit: Dict[int, List[KrausChannel]] = {
            int(q): list(chs) for q, chs in (per_qubit or {}).items()}

    @property
    def trivial(self) -> bool:
        return self.default is None and not any(self.per_qubit.values())

    def channels_for(self, qubit: int) -> List[KrausChannel]:
        out: List[KrausChannel] = []
        if self.default is not None:
            out.append(self.default)
        out.extend(self.per_qubit.get(int(qubit), ()))
        return out

    def slots_for(self, qubits: Iterable[int]) -> List[Tuple[int, KrausChannel]]:
        """The channel-application slots one gate on `qubits` produces,
        in schedule order."""
        out: List[Tuple[int, KrausChannel]] = []
        for q in sorted(set(int(q) for q in qubits)):
            for ch in self.channels_for(q):
                out.append((q, ch))
        return out

    def to_dict(self) -> dict:
        return {
            "default": self.default.to_dict() if self.default else None,
            "per_qubit": {str(q): [c.to_dict() for c in chs]
                          for q, chs in self.per_qubit.items() if chs},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NoiseModel":
        default = (KrausChannel.from_dict(d["default"])
                   if d.get("default") else None)
        per_qubit = {int(q): [KrausChannel.from_dict(c) for c in chs]
                     for q, chs in (d.get("per_qubit") or {}).items()}
        return cls(default=default, per_qubit=per_qubit)


# ---------------------------------------------------------------------------
# sequential oracle engine (factory terminal "noisy")
# ---------------------------------------------------------------------------

class QNoisy:
    """One-trajectory noisy engine over an inner simulator — the
    sequential CPU oracle the batch engine is tested against, and the
    library-path terminal ``"noisy"`` in the factory.

    Unlike the `QInterfaceNoisy` *wrapper layer* (which draws from the
    engine's sequential rng stream), branches here come from
    :func:`traj_uniform` at this engine's ``(key, trajectory_id)`` and a
    monotone application counter, so this engine IS trajectory
    `trajectory_id` of the equivalent batched job — bit-for-bit in its
    branch choices.

    The inner stack is ``inner_layers``: by default the dense ``"cuda"``
    engine on the card, and the complex128 ``"cpu"`` oracle (the JAX
    package's default, draw for draw) when the caller passes
    ``device="cpu"``.  A ``"cpu"`` inner with another device raises.  A
    general Kraus branch reads the ket back to the host and writes it
    again, as the JAX package does.
    """

    _is_noisy_trajectory = True

    def __init__(self, qubit_count: int, model: Optional[NoiseModel] = None,
                 noise: Optional[float] = None, key: int = 0,
                 trajectory_id: int = 0, inner=None,
                 inner_layers=None, init_state: int = 0, device=None,
                 dtype=None, **kw):
        if model is None:
            model = (NoiseModel(default=depolarizing(noise))
                     if noise else NoiseModel())
        self.model = model
        self.key = int(key)
        self.trajectory_id = int(trajectory_id)
        self.app_seq = 0
        self.weight = 1.0
        self.qubit_count = int(qubit_count)
        if inner is None:
            from ..factory import create_quantum_interface

            host = device is not None and torch.device(device).type == "cpu"
            if inner_layers is None:
                inner_layers = "cpu" if host else "cuda"
            # the host oracle ("cpu") takes no device; any other inner
            # stack gets the caller's device and dtype
            if inner_layers == "cpu":
                if not host and device is not None:
                    raise ValueError(
                        f"the 'cpu' inner stack runs on the host, not on "
                        f"{device}")
            else:
                kw.update({k: v for k, v in (("device", device),
                                             ("dtype", dtype))
                           if v is not None})
            inner = create_quantum_interface(
                inner_layers, qubit_count, init_state=init_state, **kw)
        self.inner = inner

    # -- gate primitives: inner op, then the channel schedule ----------

    def MCMtrxPerm(self, controls, mtrx, target, perm):
        self.inner.MCMtrxPerm(controls, mtrx, target, perm)
        self._apply_noise((target,) + tuple(controls))

    def Mtrx(self, mtrx, target):
        self.inner.MCMtrxPerm((), mtrx, target, 0)
        self._apply_noise((target,))

    def MCMtrx(self, controls, mtrx, target):
        self.inner.MCMtrxPerm(controls, mtrx, target,
                              (1 << len(controls)) - 1)
        self._apply_noise((target,) + tuple(controls))

    def Swap(self, q1, q2):
        self.inner.Swap(q1, q2)
        self._apply_noise((q1, q2))

    def run_circuit(self, circuit) -> None:
        """Run a QCircuit gate list under the SAME schedule the batch
        engine lowers: per gate, payload perms in sorted order, then
        the gate's channel slots."""
        for g in circuit.gates:
            for perm in sorted(g.payloads):
                self.inner.MCMtrxPerm(g.controls, g.payloads[perm],
                                      g.target, perm)
            self._apply_noise((g.target,) + tuple(g.controls))

    def _apply_noise(self, qubits) -> None:
        for q, ch in self.model.slots_for(qubits):
            u = traj_uniform(self.key, self.trajectory_id, self.app_seq)
            self.app_seq += 1
            i = ch.sample(u)
            m = ch.branch_matrix(i)
            if ch.unitary:
                self.inner.Mtrx(m, q)
                continue
            # general Kraus branch: apply raw K on the host state,
            # renormalize, accumulate the importance weight n2/q_i
            psi = np.asarray(self.inner.GetQuantumState(),
                             dtype=np.complex128)
            n = self.qubit_count
            v = psi.reshape(1 << (n - 1 - q), 2, 1 << q)
            v = np.einsum("ab,hbl->hal", m, v).reshape(-1)
            n2 = float(np.vdot(v, v).real)
            if n2 <= 0.0:
                # branch annihilated the state: dead trajectory —
                # importance weight 0, ket reset to |0...0> so the
                # remaining schedule stays well-defined.  The batch
                # body (trajectories.py) does the identical thing, so
                # bit parity survives the edge.
                v = np.zeros_like(psi)
                v[0] = 1.0
                self.inner.SetQuantumState(v)
                self.weight = 0.0
                continue
            self.inner.SetQuantumState(v / np.sqrt(n2))
            self.weight *= n2 / float(ch.priors[i])

    def measure_uniform(self) -> float:
        """The terminal measurement uniform for this trajectory —
        shared with the batch engine's per-trajectory sample draw."""
        return traj_uniform(self.key, self.trajectory_id, 0,
                            domain=MEASURE_DOMAIN)

    def __getattr__(self, attr):
        return getattr(self.inner, attr)
