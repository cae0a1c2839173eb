"""Framework core of the port: dtypes, places, grad mode, the Tensor,
autograd, the flag registry, device resolution, the global RNG and the
row-sparse gradient (selected_rows)."""
import torch

from .device import resolve_device
from .dtype import convert_dtype, get_default_dtype, set_default_dtype
from .flags import flag, get_flags, set_flags
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace, Place,
                    TPUPlace, XPUPlace, get_device, get_place, set_device)
from .random import get_rng_state, seed, set_rng_state
from . import selected_rows
from .state import (in_dygraph_mode, in_static_mode, is_grad_enabled,
                    no_grad, set_grad_enabled)
from .tensor import Parameter, Tensor, to_tensor

# the dtype class: the port's dtypes are torch's
DType = torch.dtype

__all__ = ["flag", "get_flags", "set_flags", "resolve_device", "seed",
           "get_rng_state", "set_rng_state", "convert_dtype",
           "get_default_dtype", "set_default_dtype", "Place", "CPUPlace",
           "CUDAPlace", "CUDAPinnedPlace", "TPUPlace", "XPUPlace",
           "NPUPlace", "get_place", "set_device", "get_device", "no_grad",
           "in_dygraph_mode", "is_grad_enabled", "set_grad_enabled",
           "Tensor", "Parameter", "to_tensor", "in_static_mode", "DType",
           "selected_rows"]
