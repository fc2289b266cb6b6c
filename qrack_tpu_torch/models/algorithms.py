"""Algorithm workloads over any QInterface stack.

Counterparts of the reference teaching programs (reference:
examples/grovers.cpp, teleport.cpp, shors_factoring.cpp,
quantum_volume.cpp, test/benchmarks.cpp GHZ/RCS cases).  They drive an
engine through its public gate and ALU surface only, so every one runs
unchanged on the "cuda", "cpu" and "hybrid" terminals."""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np


def ghz(qsim, n: Optional[int] = None) -> None:
    """GHZ preparation (reference: test/benchmarks.cpp:531)."""
    n = n if n is not None else qsim.GetQubitCount()
    qsim.H(0)
    for i in range(n - 1):
        qsim.CNOT(i, i + 1)


def grover_search(qsim, target: int, n: Optional[int] = None) -> int:
    """Grover search for |target> via phase-flip oracle (reference:
    examples/grovers.cpp:1-68 — same oracle construction from
    PhaseFlipIfLess pairs). Returns the measured index."""
    grover_amplify(qsim, target, n)
    return qsim.MAll()


def grover_amplify(qsim, target: int, n: Optional[int] = None,
                   iters: Optional[int] = None) -> None:
    """The body of :func:`grover_search` without its final measurement:
    the uniform superposition, then `iters` Grover iterations (default
    pi/4 sqrt(N))."""
    n = n if n is not None else qsim.GetQubitCount()
    for i in range(n):
        qsim.H(i)
    if iters is None:
        iters = int(math.floor(math.pi / 4 * math.sqrt(1 << n)))
    for _ in range(iters):
        qsim.PhaseFlipIfLess(target + 1, 0, n)
        qsim.PhaseFlipIfLess(target, 0, n)
        for i in range(n):
            qsim.H(i)
        qsim.PhaseFlipIfLess(1, 0, n)
        for i in range(n):
            qsim.H(i)


def teleport(qsim, prepare=None) -> Tuple[float, float]:
    """Teleport qubit 0 onto qubit 2 (reference: examples/teleport.cpp).
    Returns (payload P(1) before, target P(1) after)."""
    if prepare is not None:
        prepare(qsim)
    before = qsim.Prob(0)
    qsim.H(1)
    qsim.CNOT(1, 2)
    qsim.CNOT(0, 1)
    qsim.H(0)
    m0 = qsim.M(0)
    m1 = qsim.M(1)
    if m1:
        qsim.X(2)
    if m0:
        qsim.Z(2)
    return before, qsim.Prob(2)


def shor_order_find(qsim, base: int, to_factor: int, width: int) -> Optional[int]:
    """One period-finding round of Shor's algorithm (reference:
    examples/shors_factoring.cpp:98-160). Needs 2*width qubits.
    Returns a nontrivial factor or None."""
    qsim.SetPermutation(0)
    for i in range(width):
        qsim.H(i)
    qsim.POWModNOut(base, to_factor, 0, width, width)
    qsim.IQFT(0, width)
    y = qsim.MReg(0, width)
    if y == 0:
        return None
    # continued-fraction reconstruction of the order
    frac = Fraction(y, 1 << width).limit_denominator(to_factor)
    r = frac.denominator
    if r % 2:
        r *= 2
    apow = pow(base, r // 2, to_factor)
    f1 = math.gcd(apow + 1, to_factor)
    f2 = math.gcd(apow - 1, to_factor)
    for f in (f1, f2):
        if 1 < f < to_factor and to_factor % f == 0:
            return f
    return None


def order_finding_marginal(qsim_factory, base: int, to_factor: int,
                           width: int) -> np.ndarray:
    """The exact input-register distribution of one order-finding round
    (H on [0, width), POWModNOut into a zeroed out register, IQFT(0,
    width): the body of :func:`shor_order_find` before its measurement),
    computed without the ALU.  The state is sum_v |u_v>|v> over the
    distinct residues v = base^x mod to_factor, and the out states are
    orthogonal, so the marginal is sum_v (|C_v| / 2^width) |IQFT(u_v)|^2
    with u_v the uniform superposition of the class C_v = {x : base^x =
    v}.  `qsim_factory(width)` builds the engine that runs each IQFT."""
    classes: dict = {}
    for x in range(1 << width):
        classes.setdefault(pow(base, x, to_factor), []).append(x)
    q = qsim_factory(width)
    dist = np.zeros(1 << width)
    for xs in classes.values():
        u = np.zeros(1 << width, dtype=np.complex128)
        u[xs] = 1.0 / math.sqrt(len(xs))
        q.SetQuantumState(u)
        q.IQFT(0, width)
        dist += len(xs) / float(1 << width) * np.asarray(q.GetProbs())
    return dist


def random_circuit_sampling(qsim, depth: int, rng, n: Optional[int] = None) -> None:
    """Nearest-neighbor RCS layer structure (reference:
    test/benchmarks.cpp:4141 test_random_circuit_sampling_nn): random
    single-qubit roots + brick-wall couplers."""
    n = n if n is not None else qsim.GetQubitCount()
    for d in range(depth):
        for q in range(n):
            g = rng.randint(0, 3)
            if g == 0:
                qsim.SqrtX(q)
            elif g == 1:
                qsim.SqrtY(q)
            else:
                qsim.SqrtW(q)
        off = d & 1
        for q in range(off, n - 1, 2):
            qsim.ISwap(q, q + 1)


def quantum_volume_ops(n: int, depth: int, rng):
    """The gate calls of :func:`quantum_volume` as ``(layer, name, args)``,
    each drawn from `rng` just before it is yielded, so a caller that
    applies them one by one draws in quantum_volume's order."""
    for layer in range(depth):
        perm = list(range(n))
        for i in range(n - 1, 0, -1):
            j = rng.randint(0, i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        for k in range(0, n - 1, 2):
            a, b = perm[k], perm[k + 1]
            for q in (a, b):
                yield layer, "U", (q, rng.rand() * math.pi,
                                   rng.rand() * 2 * math.pi,
                                   rng.rand() * 2 * math.pi)
            yield layer, "CNOT", (a, b)
            for q in (a, b):
                yield layer, "U", (q, rng.rand() * math.pi,
                                   rng.rand() * 2 * math.pi,
                                   rng.rand() * 2 * math.pi)


def quantum_volume(qsim, depth: Optional[int] = None, rng=None) -> int:
    """QV-style circuit: `depth` rounds of random SU(4)-ish blocks on a
    random qubit pairing (reference: examples/quantum_volume.cpp:1-110).
    Returns the heavy-output count proxy (measured value)."""
    if rng is None:
        rng = qsim.rng
    n = qsim.GetQubitCount()
    depth = depth if depth is not None else n
    for _layer, name, args in quantum_volume_ops(n, depth, rng):
        getattr(qsim, name)(*args)
    return qsim.MAll()


def xeb_fidelity(probs_ideal: np.ndarray, samples) -> float:
    """Linear cross-entropy benchmark fidelity (reference:
    test_universal_circuit_digital_cross_entropy, test/benchmarks.cpp:4560)."""
    d = probs_ideal.shape[0]
    mean_p = float(np.mean([probs_ideal[int(s)] for s in samples]))
    return d * mean_p - 1.0


def grover_lookup_search(qsim, values: Sequence[int], target_value: int,
                         index_length: int, value_length: int) -> int:
    """Grover search over a loaded lookup table (reference:
    examples/grovers_lookup.cpp): superpose the index register, load
    values with the XOR-load oracle, flip the phase of entries equal to
    target_value, unload, amplify."""
    import math

    n_items = 1 << index_length
    iters = max(1, int(round(math.pi / 4 * math.sqrt(n_items))))
    for q in range(index_length):
        qsim.H(q)
    for _ in range(iters):
        # oracle: load value, phase-flip where value == target, unload
        qsim.IndexedLDA(0, index_length, index_length, value_length, values,
                        reset_value=False)
        qsim.PhaseFlipIfLess(target_value + 1, index_length, value_length)
        qsim.PhaseFlipIfLess(target_value, index_length, value_length)
        qsim.IndexedLDA(0, index_length, index_length, value_length, values,
                        reset_value=False)  # XOR-load is self-inverse
        # diffusion on the index register
        for q in range(index_length):
            qsim.H(q)
        qsim.PhaseFlipIfLess(1, 0, index_length)
        for q in range(index_length):
            qsim.H(q)
    return qsim.MReg(0, index_length)


def ordered_list_search(qsim, values: Sequence[int], key_value: int,
                        index_length: int, value_length: int) -> int:
    """Quadrant-narrowing search of an ORDERED list (reference:
    examples/ordered_list_search.cpp): each round superposes the two
    candidate halves' selector qubit, loads the quantum table, and
    compares against the key to decide the half — log2(N) rounds."""
    lo, hi = 0, (1 << index_length) - 1
    for bit in range(index_length - 1, -1, -1):
        mid = lo + (1 << bit)
        if mid > hi:
            continue
        # classical controller queries the quantum-loaded value at `mid`
        qsim.SetReg(0, index_length + value_length, 0)
        qsim.SetReg(0, index_length, mid)
        qsim.IndexedLDA(0, index_length, index_length, value_length, values)
        v = int(round(qsim.ExpectationBitsAll(
            list(range(index_length, index_length + value_length)))))
        if v <= key_value:
            lo = mid
    qsim.SetReg(0, index_length + value_length, 0)
    qsim.SetReg(0, index_length, lo)
    qsim.IndexedLDA(0, index_length, index_length, value_length, values)
    return lo


def pearson_hash_demo(qsim, perm_table: Sequence[int], key_length: int) -> dict:
    """Superposed Pearson-style hashing (reference: examples/pearson32.cpp):
    every possible key is hashed at once through the unitary Hash op;
    sampling the register yields (key-bijective) hash outputs."""
    for q in range(key_length):
        qsim.H(q)
    qsim.Hash(0, key_length, perm_table)
    shots = qsim.MultiShotMeasureMask([1 << q for q in range(key_length)], 64)
    return shots


def quantum_perceptron(qsim, input_qubit: int, output_qubit: int,
                       eta: float = 0.5, epochs: int = 4) -> float:
    """Train a QNeuron to learn NOT(input) (reference:
    examples/quantum_perceptron.cpp); returns the post-training
    prediction accuracy."""
    from ..qneuron import QNeuron

    neuron = QNeuron(qsim, (input_qubit,), output_qubit)
    for _ in range(epochs):
        for x in (0, 1):
            qsim.SetPermutation(x << input_qubit)
            neuron.Learn(eta, expected=(x == 0))
    correct = 0
    for x in (0, 1):
        qsim.SetPermutation(x << input_qubit)
        p = neuron.Predict()
        guess = p >= 0.5
        correct += int(guess == (x == 0))
    return correct / 2.0


def quantum_associative_memory(qsim, patterns: Sequence[Tuple[int, bool]],
                               input_length: int, output_qubit: int,
                               eta: float = 0.5) -> float:
    """Store input->bit associations in QNeuron angles and recall them
    (reference: examples/quantum_associative_memory.cpp); returns the
    recall accuracy over the stored patterns."""
    from ..qneuron import QNeuron

    neuron = QNeuron(qsim, tuple(range(input_length)), output_qubit)
    for key, bit in patterns:
        qsim.SetPermutation(key)
        neuron.LearnPermutation(eta, expected=bit)
    hits = 0
    for key, bit in patterns:
        qsim.SetPermutation(key)
        p = neuron.Predict()
        hits += int((p >= 0.5) == bit)
    return hits / len(patterns)


def cosmology_inflation(qsim_factory, steps: int, rng) -> List[int]:
    """Toy 'inflating universe' (reference: examples/cosmology.cpp): each
    step composes a randomly-prepared qubit onto the register and
    entangles it with a random neighbor; returns the register width per
    step (the reference watches how structure grows under composition)."""
    import math

    reg = qsim_factory(1)
    reg.U(0, 2 * math.pi * rng.rand(), 2 * math.pi * rng.rand(),
          2 * math.pi * rng.rand())
    widths = [reg.qubit_count]
    for _ in range(steps):
        nbit = qsim_factory(1)
        nbit.U(0, 2 * math.pi * rng.rand(), 2 * math.pi * rng.rand(),
               2 * math.pi * rng.rand())
        reg.Compose(nbit)
        partner = rng.randint(0, reg.qubit_count - 1)
        reg.CNOT(partner, reg.qubit_count - 1)
        widths.append(reg.qubit_count)
    return widths


# ----------------------------------------------------------------------
# QCircuit-emitting builders: workloads as submittable IR.
#
# Unlike the eager helpers above (which drive a live engine gate by
# gate), these return layers.qcircuit.QCircuit objects: the same
# workload runs gate by gate (Run) or as one fused window (RunFused),
# and its structure_digest is byte for byte the JAX package's.
# ----------------------------------------------------------------------


def _rz_mtrx(theta: float) -> np.ndarray:
    from .. import matrices as mat

    return mat.phase_mtrx(np.exp(-0.5j * theta), np.exp(0.5j * theta))


def ghz_qcircuit(n: int) -> "QCircuit":
    """GHZ chain as IR: H + CNOT ladder — fully Clifford, so the router
    keeps it tableau-resident at any width (w100+ costs O(n^2))."""
    from .. import matrices as mat
    from ..layers.qcircuit import QCircuit

    circ = QCircuit(n)
    circ.append_1q(0, mat.H2)
    for i in range(n - 1):
        circ.append_ctrl((i,), i + 1, mat.X2, 1)
    return circ


def qaoa_qcircuit(n: int, edges: Optional[Sequence[Tuple[int, int]]] = None,
                  p: int = 1, gammas: Optional[Sequence[float]] = None,
                  betas: Optional[Sequence[float]] = None,
                  rng=None) -> "QCircuit":
    """Depth-p QAOA for MaxCut on `edges` (default: the n-cycle).  Cost
    layers are RZZ(2*gamma) via the CNOT.RZ.CNOT identity; mixers are
    RX(2*beta).  Angles default to rng draws (or fixed values without
    an rng) so the emitted circuit is deterministic under a seed."""
    from .. import matrices as mat
    from ..layers.qcircuit import QCircuit

    if edges is None:
        edges = [(i, (i + 1) % n) for i in range(n)]
    if gammas is None:
        gammas = [(rng.rand() * math.pi if rng is not None
                   else 0.4 + 0.1 * k) for k in range(p)]
    if betas is None:
        betas = [(rng.rand() * math.pi / 2 if rng is not None
                  else 0.7 + 0.05 * k) for k in range(p)]
    circ = QCircuit(n)
    for q in range(n):
        circ.append_1q(q, mat.H2)
    for gamma, beta in zip(gammas, betas):
        for a, b in edges:
            circ.append_ctrl((a,), b, mat.X2, 1)
            circ.append_1q(b, _rz_mtrx(2.0 * gamma))
            circ.append_ctrl((a,), b, mat.X2, 1)
        for q in range(n):
            circ.append_1q(q, mat.u3_mtrx(2.0 * beta, -math.pi / 2,
                                          math.pi / 2))
    return circ


def quantum_volume_qcircuit(n: int, depth: Optional[int] = None,
                            rng=None) -> "QCircuit":
    """QV-style circuit as IR (the dense tenant's workload): `depth`
    rounds of random U3 pairs around CNOTs on a shuffled pairing —
    matches :func:`quantum_volume`'s structure without touching an
    engine.  Requires an rng (utils.rng.QrackRandom or compatible)."""
    from .. import matrices as mat
    from ..layers.qcircuit import QCircuit

    if rng is None:
        from ..utils.rng import QrackRandom

        rng = QrackRandom()
    depth = depth if depth is not None else n
    circ = QCircuit(n)
    for _ in range(depth):
        perm = list(range(n))
        for i in range(n - 1, 0, -1):
            j = rng.randint(0, i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        for k in range(0, n - 1, 2):
            a, b = perm[k], perm[k + 1]
            for q in (a, b):
                circ.append_1q(q, mat.u3_mtrx(
                    rng.rand() * math.pi, rng.rand() * 2 * math.pi,
                    rng.rand() * 2 * math.pi))
            circ.append_ctrl((a,), b, mat.X2, 1)
            for q in (a, b):
                circ.append_1q(q, mat.u3_mtrx(
                    rng.rand() * math.pi, rng.rand() * 2 * math.pi,
                    rng.rand() * 2 * math.pi))
    return circ


def brickwork_theta(q: int) -> float:
    """The per-qubit RY angle :func:`brickwork_qcircuit` uses — exposed
    so callers can check the analytic marginal Prob(q) = sin^2(theta/2)
    (CZ bricks are diagonal, so computational marginals are untouched)."""
    return 0.3 + 0.04 * q


def brickwork_qcircuit(n: int, layers: int = 3) -> "QCircuit":
    """Shallow local brickwork as IR (the lightcone tenant's workload,
    docs/LIGHTCONE.md): one RY(theta_q) root per qubit, then `layers`
    alternating nearest-neighbor CZ brick layers.  Depth is layers+1
    regardless of width, so any local observable's past cone is O(layers)
    qubits — at the default depth the router prices a w50+ circuit at
    max_cone_width 6 and takes the lightcone rung instead of refusing.
    Deterministic: fixed (n, layers) always emits the same circuit."""
    from .. import matrices as mat
    from ..layers.qcircuit import QCircuit

    circ = QCircuit(n)
    for q in range(n):
        circ.append_1q(q, mat.u3_mtrx(brickwork_theta(q), 0.0, 0.0))
    for d in range(layers):
        for a in range(d & 1, n - 1, 2):
            circ.append_ctrl((a,), a + 1, mat.Z2, 1)
    return circ


def trotter_qcircuit(n: int, steps: int = 1, dt: float = 0.1,
                     j: float = 1.0, h: float = 1.0) -> "QCircuit":
    """First-order Trotterized transverse-field Ising evolution as IR:
    exp(-i dt H) per step with H = -j * sum Z_i Z_{i+1} - h * sum X_i —
    RZZ(2*j*dt) on each bond (CNOT.RZ.CNOT) then RX(2*h*dt) mixers.
    Deterministic: a fixed (n, steps, dt, j, h) tuple always emits the
    same circuit, so repeated submissions share one compiled program."""
    from .. import matrices as mat
    from ..layers.qcircuit import QCircuit

    circ = QCircuit(n)
    for _ in range(steps):
        for i in range(n - 1):
            circ.append_ctrl((i,), i + 1, mat.X2, 1)
            circ.append_1q(i + 1, _rz_mtrx(2.0 * j * dt))
            circ.append_ctrl((i,), i + 1, mat.X2, 1)
        for q in range(n):
            circ.append_1q(q, mat.u3_mtrx(2.0 * h * dt, -math.pi / 2,
                                          math.pi / 2))
    return circ


def separability_demo(qsim) -> dict:
    """Entangle, then watch Schmidt separation recover the product
    structure (reference: examples/qunit_separability.cpp /
    separability.cpp)."""
    out = {}
    n = qsim.qubit_count
    qsim.H(0)
    for i in range(n - 1):
        qsim.CNOT(i, i + 1)
    out["entangled_units"] = getattr(qsim, "GetUnitCount", lambda: 1)()
    # un-compute: the state returns to a product and TrySeparate confirms
    for i in range(n - 2, -1, -1):
        qsim.CNOT(i, i + 1)
    qsim.H(0)
    out["separable"] = all(qsim.TrySeparate(q) for q in range(n))
    out["final_units"] = getattr(qsim, "GetUnitCount", lambda: n)()
    return out
