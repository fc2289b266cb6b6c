"""The router and the light-cone engine on the card.  These need a CUDA
device (the dense stacks they build launch the window kernel, which has
no CPU mode) and skip without one; this file imports no JAX, so on a
machine without it run
``python3 -m pytest --noconftest -m cuda tests/test_torch_route_cuda.py``.

* A w20 QFT routed to the dense rung (QRACK_ROUTE_DENSE_MAX_QB=20)
  launches the same K1/K2 sweeps as a direct "cuda" engine on the same
  circuit, and ends on the same planes bit for bit.
* MultiShotMeasureMask through a light-cone read repeats on the card:
  30 calls from one rng position draw the same keys.
* The budget probe reads the card's own memory once CUDA is up, and a
  routed wrapper or a trajectory job on the card reads it before its
  first decision or chunk, in a fresh process where nothing has started
  CUDA yet.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import qrack_tpu_torch as qt
from qrack_tpu_torch.models.algorithms import brickwork_qcircuit
from qrack_tpu_torch.models.qft import qft_qcircuit
from qrack_tpu_torch.ops import window_kernel as wk
from qrack_tpu_torch.utils.rng import QrackRandom

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def test_routed_dense_w20_matches_direct_engine(cuda_device, monkeypatch):
    monkeypatch.setenv("QRACK_ROUTE_DENSE_MAX_QB", "20")
    monkeypatch.delenv("QRACK_ROUTE", raising=False)
    n = 20
    circ = qft_qcircuit(n)
    planes = []
    deltas = []
    for layers in ("route", "cuda"):
        q = qt.create_quantum_interface(layers, n, init_state=0x5A3C1,
                                        rng=QrackRandom(3),
                                        rand_global_phase=False)
        before = dict(wk.launches())
        circ.RunFused(q)
        eng = q._engine if layers == "route" else q
        if layers == "route":
            assert q.current_stack() == "dense"
            assert q._decision.layers == ("cuda",)
        planes.append(eng.device_planes.clone())
        deltas.append({k: v - before[k] for k, v in wk.launches().items()})
    assert deltas[0] == deltas[1] and sum(deltas[0].values()) > 0
    assert torch.equal(planes[0], planes[1])


def test_lightcone_multishot_repeats_on_the_card(cuda_device):
    lc = qt.create_quantum_interface("lightcone", 24, rng=QrackRandom(5))
    brickwork_qcircuit(24).Run(lc)
    powers = [1 << b for b in (10, 11, 12, 13)]
    lc.MultiShotMeasureMask(powers, 512)      # builds the cone
    (cone,) = lc._cones.values()
    seen = set()
    for _ in range(30):
        cone.rng.seed(3)          # the draw is the cone engine's own
        seen.add(tuple(sorted(lc.MultiShotMeasureMask(powers, 512).items())))
    assert len(seen) == 1
    assert cone.current_stack() == "dense"
    assert cone._engine.device_planes.device.type == "cuda"


def test_budget_probe_reads_the_card(cuda_device, monkeypatch):
    from qrack_tpu_torch.route import cost

    monkeypatch.delenv("QRACK_ROUTE_HBM_BYTES", raising=False)
    torch.zeros(1, device=cuda_device)
    monkeypatch.setattr(cost, "_PROBED_HBM", None)
    _free, total = torch.cuda.mem_get_info()
    assert cost.hbm_budget_bytes() == total


_FRESH = {
    # the first decision of a fresh process: the w32 QFT prices int8
    # TurboQuant (16.5 GiB) against the card, not the 16 GiB fallback
    "decision": """
q = qt.create_quantum_interface("route", 32)
out = {"stack": q.plan(qft_qcircuit(32)).stack}
""",
    # the first chunk: the card's free memory, not min(16 GiB, free)
    "chunk": """
from qrack_tpu_torch.noise import trajectories as traj
out = {"budget": traj.budget_bytes("cuda"),
       "chunk": traj.traj_chunk(24, 1 << 20, "cuda"),
       "free": torch.cuda.mem_get_info()[0]}
""",
}


@pytest.mark.parametrize("case", sorted(_FRESH))
def test_first_pricing_in_a_fresh_process_reads_the_card(cuda_device, case):
    code = ("import json, torch\n"
            "import qrack_tpu_torch as qt\n"
            "from qrack_tpu_torch.models.qft import qft_qcircuit\n"
            "assert not torch.cuda.is_initialized()\n"
            + _FRESH[case] +
            "out['initialized'] = torch.cuda.is_initialized()\n"
            "print(json.dumps(out))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("QRACK_ROUTE", "QRACK_NOISE_TRAJ"))}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    print(json.dumps({case: out}))
    assert out["initialized"]
    if case == "decision":
        assert out["stack"] == "turboquant"
        return
    fallback = 16 << 30
    assert out["budget"] > fallback
    assert abs(out["budget"] - out["free"]) <= 1 << 26
    from qrack_tpu_torch.noise import trajectories as traj

    per = traj.BYTES_PER_AMP << 24
    assert out["chunk"] > fallback // per
    assert abs(out["chunk"] - out["budget"] // per) <= 1
