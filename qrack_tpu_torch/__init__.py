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

from .interface import QInterface  # noqa: E402,F401
from .engines import (QEngine, QEngineCPU, QEngineCUDA,  # noqa: E402,F401
                      QEngineCUDATurboQuant, QEngineSparse, QHybrid)
from .parallel import QPager  # noqa: E402,F401
from .pauli import Pauli  # noqa: E402,F401
from .config import get_config, set_config  # noqa: E402,F401
from .hamiltonian import HamiltonianOp, uniform_hamiltonian_op  # noqa: E402,F401
from .layers import (QBdt, QBdtHybrid, QInterfaceNoisy,  # noqa: E402,F401
                     QStabilizer, QStabilizerHybrid, QTensorNetwork, QUnit,
                     QUnitClifford)
from . import noise  # noqa: E402,F401
from .factory import (build_factory, create_arranged_layers_full,  # noqa: E402,F401
                      create_quantum_interface)
from .qneuron import QNeuron, ActivationFn  # noqa: E402,F401

__version__ = "0.1.0"
