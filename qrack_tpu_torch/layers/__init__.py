from .qcircuit import QCircuit, QCircuitGate  # noqa: F401
from .qtensornetwork import QTensorNetwork  # noqa: F401
from .noisy import QInterfaceNoisy  # noqa: F401
from .qbdt import QBdt  # noqa: F401
from .qbdthybrid import QBdtHybrid  # noqa: F401
from .stabilizer import QStabilizer, CliffordError  # noqa: F401
from .stabilizerhybrid import QStabilizerHybrid  # noqa: F401
from .qunit import QUnit  # noqa: F401
from .qunitclifford import QUnitClifford  # noqa: F401
