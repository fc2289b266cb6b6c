"""qrack_tpu_torch: the PyTorch and CUDA port of qrack_tpu.

The same universal gate-level QInterface API over a dense split-plane
state vector that lives on an NVIDIA GPU (Hopper, sm_90a), with the
fused gate window as a hand-written CUDA kernel (csrc/); the numpy
complex128 oracle (QEngineCPU) and QHybrid's width switch between the
two; the layers above them (QUnit, QStabilizerHybrid, QStabilizer,
QUnitClifford, QBdt, QBdtHybrid, QTensorNetwork, QInterfaceNoisy),
which the factory stacks into the OPTIMAL stack and the others; the
pager (QPager: one ket in pages over a device list, past one dense
engine's 30 qubits); the noise plane (noise/: Kraus channels and shot-parallel trajectories);
and the algorithm programs (models/).  The JAX
package beside it is the reference the port is tested against; this
package imports neither it nor JAX.
"""

import torch as _torch

# Float32 products run in full float32: a TF32 gate contraction keeps
# about three decimal digits and decays the norm of deep circuits.
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

# The public names load on first use, so a process that only routes
# (the fleet's supervisor and front door) imports no engine.
_LAZY = {
    "QInterface": ".interface",
    "QEngine": ".engines", "QEngineCPU": ".engines",
    "QEngineCUDA": ".engines", "QEngineCUDATurboQuant": ".engines",
    "QEngineSparse": ".engines", "QHybrid": ".engines",
    "QPager": ".parallel",
    "Pauli": ".pauli",
    "get_config": ".config", "set_config": ".config",
    "HamiltonianOp": ".hamiltonian", "uniform_hamiltonian_op": ".hamiltonian",
    "QBdt": ".layers", "QBdtHybrid": ".layers", "QInterfaceNoisy": ".layers",
    "QStabilizer": ".layers", "QStabilizerHybrid": ".layers",
    "QTensorNetwork": ".layers", "QUnit": ".layers", "QUnitClifford": ".layers",
    "build_factory": ".factory", "create_arranged_layers_full": ".factory",
    "create_quantum_interface": ".factory",
    "QNeuron": ".qneuron", "ActivationFn": ".qneuron",
}
_SUBMODULES = ("noise",)

__all__ = sorted(_LAZY) + list(_SUBMODULES)

__version__ = "0.1.0"


def __getattr__(name):
    import importlib

    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    elif name in _SUBMODULES:
        value = importlib.import_module("." + name, __name__)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
