"""paddle.incubate surface of the port (counterpart of
paddle_tpu/incubate/): the fused transformer functionals, the
auto-checkpoint epoch range, the MoE layer, the segment pools over
`segment_pool_op` and the masked softmaxes. `incubate.optimizer`
(LookAhead, ModelAverage, GradientMergeOptimizer) and `asp` are not
ported yet (ROADMAP.md)."""
import torch

from . import checkpoint, moe, nn
from .moe import MoELayer
from ..ops.misc_ops import segment_pool

__all__ = ["checkpoint", "moe", "nn", "MoELayer", "segment_sum",
           "segment_mean", "segment_max", "segment_min",
           "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]


def segment_sum(data, segment_ids, name=None):
    """Rows of data summed by sorted segment id (op segment_pool_op)."""
    return segment_pool(data, segment_ids, pooltype="SUM")


def segment_mean(data, segment_ids, name=None):
    return segment_pool(data, segment_ids, pooltype="MEAN")


def segment_max(data, segment_ids, name=None):
    return segment_pool(data, segment_ids, pooltype="MAX")


def segment_min(data, segment_ids, name=None):
    return segment_pool(data, segment_ids, pooltype="MIN")


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis."""
    from ..nn import functional as F
    return F.softmax(x + mask, axis=-1)


def softmax_mask_fuse_upper_triangle(x):
    """The causal softmax over the last two axes: keys after the query get
    -1e30 added (the reference's mask), built on x's device."""
    from ..nn import functional as F
    T = x.shape[-1]
    neg = torch.triu(torch.full((T, T), -1e30, dtype=torch.float32,
                                device=x.device), diagonal=1)
    return F.softmax(x + neg, axis=-1)
