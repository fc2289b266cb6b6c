from . import qft  # noqa: F401
from . import algorithms  # noqa: F401
from . import apps  # noqa: F401
from . import grover  # noqa: F401
from . import rcs  # noqa: F401
