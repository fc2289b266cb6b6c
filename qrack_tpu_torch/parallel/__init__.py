from .pager import QPager, pager_devices_from_env  # noqa: F401
