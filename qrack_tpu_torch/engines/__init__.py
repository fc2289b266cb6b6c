from .qengine import QEngine  # noqa: F401
from .cuda import QEngineCUDA  # noqa: F401
from .turboquant import QEngineCUDATurboQuant  # noqa: F401
