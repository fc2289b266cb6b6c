from .qcircuit import QCircuit, QCircuitGate  # noqa: F401
from .stabilizer import QStabilizer, CliffordError  # noqa: F401
from .stabilizerhybrid import QStabilizerHybrid  # noqa: F401
from .qunit import QUnit  # noqa: F401
from .qunitclifford import QUnitClifford  # noqa: F401
