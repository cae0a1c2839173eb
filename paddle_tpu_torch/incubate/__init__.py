"""paddle.incubate surface of the port (counterpart of
paddle_tpu/incubate/): the fused transformer functionals and the
auto-checkpoint epoch range."""
from . import checkpoint, nn

__all__ = ["checkpoint", "nn"]
