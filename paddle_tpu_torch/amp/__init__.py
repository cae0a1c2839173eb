"""Automatic mixed precision (counterpart of paddle_tpu/amp/__init__.py:
`decorate`, `auto_cast`, `AmpState`, the white and black lists, and
`amp_cast_inputs`).

`decorate` (O2) casts every floating parameter and buffer of the models to
the compute dtype, layer norms included, as the reference's
Layer.to(dtype) does; the optimizers' moments stay float32 and no master
weights are kept, as in the reference. At O0 and O1 it returns the models
(and optimizers) as they are.

`auto_cast` is the reference's per-op input casting, by the reference's op
names, not torch.autocast (whose lists and output rules differ): inside
it an op on the white list gets its floating inputs in the amp dtype, an
op on the black list gets bfloat16/float16 inputs as float32, and every
other op is untouched, so ordinary type promotion applies (a bfloat16
matmul plus a float32 bias is float32). The level (O1 or O2) does not
change the casting, as in the reference. The port's functions that call
`amp_cast_inputs`, under these names: `nn.functional.linear` and `matmul`
(matmul_v2; linear's bias add is on neither list), `layer_norm`
(layer_norm_op), `softmax` / `log_softmax` (softmax_op / log_softmax_op),
`cross_entropy` / `softmax_with_cross_entropy`
(softmax_with_cross_entropy) and the flash-attention gate
(flash_attention). Not hooked yet (ROADMAP.md): the other listed ops.

Not ported yet: `GradScaler` (bfloat16 needs no loss scaling).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["decorate", "auto_cast", "AmpState", "amp_cast_inputs",
           "WHITE_LIST", "BLACK_LIST"]

# the reference's lists (paddle_tpu/amp/__init__.py:29-39)
WHITE_LIST = {
    "matmul_v2", "mul", "conv2d_op", "conv2d_transpose_op", "bmm", "mv",
    "addmm", "einsum_op", "dot", "fused_attention", "flash_attention",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "reduce_mean", "reduce_sum",
    "softmax_op", "log_softmax_op", "softmax_with_cross_entropy",
    "bce_loss_op", "bce_with_logits_op", "layer_norm_op", "p_norm",
    "frobenius_norm", "cumsum", "logsumexp", "reduce_prod", "kldiv_loss_op",
    "nll_loss_op", "square_error_cost_op",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_LOW = (torch.bfloat16, torch.float16)


class AmpState:
    """The active auto_cast: its level, dtype and the lists with the
    caller's additions."""

    def __init__(self, enable=True, level="O1", dtype="bfloat16",
                 custom_white_list=None, custom_black_list=None):
        if dtype not in _DTYPES:
            raise ValueError("amp dtype %r: the port's kernels take "
                             "bfloat16 or float32" % (dtype,))
        self.enable = enable
        self.level = level
        self.dtype = _DTYPES[dtype]
        self.white = set(WHITE_LIST)
        self.black = set(BLACK_LIST)
        if custom_white_list:
            self.white |= set(custom_white_list)
            self.black -= set(custom_white_list)
        if custom_black_list:
            self.black |= set(custom_black_list)
            self.white -= set(custom_black_list)


# the innermost active auto_cast, or None
_STATE = [None]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast: per-op input casting inside the block."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError("level must be O0/O1/O2, got %s" % (level,))
    prev = _STATE[0]
    _STATE[0] = AmpState(enable and level != "O0", level, dtype,
                         custom_white_list, custom_black_list) \
        if enable else None
    try:
        yield
    finally:
        _STATE[0] = prev


def amp_cast_inputs(op_name, tensors):
    """The inputs of op `op_name` as the active auto_cast casts them (a
    list; non-tensors and None pass through): white-listed ops get their
    floating inputs in the amp dtype, black-listed ops get bfloat16 and
    float16 inputs as float32."""
    amp = _STATE[0]
    if amp is None or not amp.enable:
        return list(tensors)
    if op_name in amp.white:
        return [t.to(amp.dtype) if isinstance(t, torch.Tensor)
                and t.is_floating_point() and t.dtype != amp.dtype else t
                for t in tensors]
    if op_name in amp.black:
        return [t.float() if isinstance(t, torch.Tensor)
                and t.dtype in _LOW else t for t in tensors]
    return list(tensors)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Cast the models' floating parameters and buffers to `dtype` in place
    at level O2; O0 and O1 leave them as they are (at O1 the casting is
    auto_cast's, per op). Returns the models, or (models, optimizers) when
    optimizers are given, as the reference does."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError("level must be O0/O1/O2, got %s" % (level,))
    if dtype not in _DTYPES:
        raise ValueError("amp dtype %r: the port's kernels take bfloat16 "
                         "or float32" % (dtype,))
    if master_weight:
        raise NotImplementedError("master weights are not kept, as in the "
                                  "reference")
    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        target = _DTYPES[dtype]
        for m in model_list:
            with torch.no_grad():
                for t in list(m.parameters()) + list(m.buffers()):
                    if t.is_floating_point():
                        t.data = t.data.to(target)
    models = models if single else model_list
    if optimizers is None:
        return models
    return models, optimizers
