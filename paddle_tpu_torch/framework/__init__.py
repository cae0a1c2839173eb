"""Framework core of the port: flag registry and device resolution."""
from .device import resolve_device
from .flags import flag, get_flags, set_flags

__all__ = ["flag", "get_flags", "set_flags", "resolve_device"]
