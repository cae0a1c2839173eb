"""paddle.incubate surface of the port (counterpart of
paddle_tpu/incubate/): the fused transformer functionals, the
auto-checkpoint epoch range and the MoE layer."""
from . import checkpoint, moe, nn
from .moe import MoELayer

__all__ = ["checkpoint", "moe", "nn", "MoELayer"]
