"""The in-tree API fuzz vocabulary (tests/test_fuzz_api.py ``_ops``:
gates, rotations, swaps, registers, ALU, masks, parity) on the port's
terminals against the JAX package's complex128 oracle, QEngineCPU:

* "cuda" with fusion windows 1 and 16 (the window's plain kernel version
  at 16), and with float64 planes;
* "cpu", the port's own complex128 oracle;
* "hybrid" with a low threshold, so its CUDA half runs;
* "turboquant" with 16-bit codes;
* "sparse";
* "optimal" (QUnit over QStabilizerHybrid over QHybrid) with QHybrid's
  threshold at 3 qubits, so its CUDA half runs;
* "unit_clifford" on the Clifford part of the vocabulary;
* "bdt" (the decision tree, host nodes), ("bdt_hybrid", "hybrid") and
  ("tensor_network", "unit", "stabilizer_hybrid", "hybrid"), the last two
  with QHybrid's threshold at 3 qubits;
* "pager" on 2 and on 8 CPU pages with window 16 (the per-page window
  kernel's plain version), and on 4 pages with ``force_wide_alu`` set,
  so every ALU and parity op runs its split-index form;
* "route" (eager gates: the stabilizer hybrid, escaping to the dense
  engine) and "lightcone" (every read a routed cone).

SetBit, the one measuring op of the vocabulary, is left out: its draws
diverge across stacks by design.  Bars: fidelity >= 1 - 1e-6 and Prob
within 3e-5 for float32 planes, 1 - 1e-12 and 1e-10 for the float64 and
complex128 stacks, 1 - 1e-5 and 5e-4 for 16-bit codes (as the JAX fuzz
holds its compressed stacks).
"""

import numpy as np
import pytest

from qrack_tpu import QEngineCPU
from qrack_tpu.utils.rng import QrackRandom as JaxRandom

import qrack_tpu_torch as qt
from qrack_tpu_torch.utils.rng import QrackRandom

from test_fuzz_api import N, _ops

F32 = (1e-6, 3e-5)
EXACT = (1e-12, 1e-10)
STACKS = {
    "cuda_w1": ("cuda", {"device": "cpu"},
                {"QRACK_TPU_FUSE_WINDOW": "1"}, F32),
    "cuda_w16": ("cuda", {"device": "cpu"},
                 {"QRACK_TPU_FUSE_WINDOW": "16",
                  "QRACK_TPU_FUSE_KERNEL": "on"}, F32),
    "cuda_f64": ("cuda", {"device": "cpu", "dtype": "float64"},
                 {"QRACK_TPU_FUSE_KERNEL": "on"}, EXACT),
    "cpu": ("cpu", {}, {}, EXACT),
    "hybrid": ("hybrid", {"device": "cpu", "tpu_threshold_qubits": 3},
               {}, F32),
    "turboquant16": ("turboquant", {"device": "cpu", "bits": 16,
                                    "chunk_qb": 3, "block_pow": 2},
                     {}, (1e-5, 5e-4)),
    "sparse": ("sparse", {}, {}, EXACT),
    "optimal": ("optimal", {"device": "cpu", "tpu_threshold_qubits": 3},
                {}, F32),
    "unit_clifford": ("unit_clifford", {}, {}, EXACT),
    "bdt": ("bdt", {"device": "cpu"}, {}, EXACT),
    "bdt_hybrid": (("bdt_hybrid", "hybrid"),
                   {"device": "cpu", "tpu_threshold_qubits": 3}, {}, F32),
    "tensor_network": (("tensor_network", "unit", "stabilizer_hybrid",
                        "hybrid"),
                       {"device": "cpu", "tpu_threshold_qubits": 3}, {}, F32),
    "pager2_w16": ("pager", {"device": "cpu", "n_pages": 2},
                   {"QRACK_TPU_FUSE_WINDOW": "16",
                    "QRACK_TPU_FUSE_KERNEL": "on"}, F32),
    "pager8_w16": ("pager", {"device": "cpu", "n_pages": 8},
                   {"QRACK_TPU_FUSE_WINDOW": "16",
                    "QRACK_TPU_FUSE_KERNEL": "on"}, F32),
    "pager_wide": ("pager", {"device": "cpu", "n_pages": 4},
                   {"QRACK_TPU_FUSE_WINDOW": "16"}, F32),
    "route": ("route", {"device": "cpu"}, {}, F32),
    "lightcone": ("lightcone", {"device": "cpu"}, {}, F32),
}
# attributes set on a stack once it is built
ATTRS = {"pager_wide": {"force_wide_alu": True}}
# stacks that take only the Clifford part of the vocabulary
CLIFFORD_ONLY = {"unit_clifford"}
CLIFFORD_OPS = {"H", "X", "Y", "Z", "S", "CNOT", "CZ", "Swap", "ISwap",
                "XMask", "ZMask"}


def unmeasured_op(rng, clifford=False):
    while True:
        name, args = _ops(rng)
        if name != "SetBit" and (not clifford or name in CLIFFORD_OPS):
            return name, args


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("trial", range(4))
def test_fuzz_port_stacks_match_jax_oracle(stack, trial, monkeypatch):
    layer, kw, env, (fid_bar, prob_bar) = STACKS[stack]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.Generator(np.random.PCG64(3000 + trial))
    o = QEngineCPU(N, rng=JaxRandom(trial), rand_global_phase=False)
    s = qt.create_quantum_interface(layer, N, rng=QrackRandom(trial),
                                    rand_global_phase=False, **kw)
    for k, v in ATTRS.get(stack, {}).items():
        setattr(s, k, v)
    for step in range(30):
        name, args = unmeasured_op(rng, stack in CLIFFORD_ONLY)
        getattr(o, name)(*args)
        getattr(s, name)(*args)
        if rng.integers(0, 8) == 0:     # occasional mid-stream reads
            qb = int(rng.integers(0, N))
            assert abs(o.Prob(qb) - s.Prob(qb)) < prob_bar, (step, name)
    a = np.asarray(o.GetQuantumState())
    b = np.asarray(s.GetQuantumState())
    f = abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)
    assert f > 1 - fid_bar, (stack, trial, f)
