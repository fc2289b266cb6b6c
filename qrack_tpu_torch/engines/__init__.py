from .qengine import QEngine  # noqa: F401
from .cpu import QEngineCPU  # noqa: F401
from .cuda import QEngineCUDA  # noqa: F401
from .hybrid import QHybrid  # noqa: F401
from .turboquant import QEngineCUDATurboQuant  # noqa: F401
from .sparse import QEngineSparse  # noqa: F401
