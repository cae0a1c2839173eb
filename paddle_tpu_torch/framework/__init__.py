"""Framework core of the port: dtypes, places, grad mode, the Tensor,
autograd, the flag registry, device resolution and the global RNG."""
from .device import resolve_device
from .dtype import convert_dtype, get_default_dtype, set_default_dtype
from .flags import flag, get_flags, set_flags
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace, Place,
                    TPUPlace, XPUPlace, get_device, get_place, set_device)
from .random import get_rng_state, seed, set_rng_state
from .state import (in_dygraph_mode, is_grad_enabled, no_grad,
                    set_grad_enabled)
from .tensor import Parameter, Tensor, to_tensor

__all__ = ["flag", "get_flags", "set_flags", "resolve_device", "seed",
           "get_rng_state", "set_rng_state", "convert_dtype",
           "get_default_dtype", "set_default_dtype", "Place", "CPUPlace",
           "CUDAPlace", "CUDAPinnedPlace", "TPUPlace", "XPUPlace",
           "NPUPlace", "get_place", "set_device", "get_device", "no_grad",
           "in_dygraph_mode", "is_grad_enabled", "set_grad_enabled",
           "Tensor", "Parameter", "to_tensor"]
