"""Framework core of the port: flag registry, device resolution and the
global RNG."""
from .device import resolve_device
from .flags import flag, get_flags, set_flags
from .random import get_rng_state, seed, set_rng_state

__all__ = ["flag", "get_flags", "set_flags", "resolve_device", "seed",
           "get_rng_state", "set_rng_state"]
