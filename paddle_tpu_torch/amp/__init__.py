"""Automatic mixed precision, level O2 (counterpart of
paddle_tpu/amp/__init__.py `decorate`).

O2 casts every floating parameter and buffer of the models to the compute
dtype, layer norms included, as the reference's Layer.to(dtype) does; the
optimizers' moments stay float32 and no master weights are kept, as in
the reference. The port computes layer norm and log-softmax in the input
dtype, as the reference does: nothing is upcast behind the caller's back.

Not ported yet: `auto_cast` (level O1), `GradScaler` (bfloat16 needs no
loss scaling).
"""
from __future__ import annotations

import torch

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Cast the models' floating parameters and buffers to `dtype` in place
    (level O2; O0 leaves them as they are). Returns the models, or
    (models, optimizers) when optimizers are given, as the reference
    does."""
    if level not in ("O0", "O2"):
        raise NotImplementedError("amp level %r is not ported: O1 needs "
                                  "auto_cast (see ROADMAP.md)" % (level,))
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
