"""paddle.incubate surface of the port (counterpart of
paddle_tpu/incubate/): the fused transformer functionals."""
from . import nn

__all__ = ["nn"]
