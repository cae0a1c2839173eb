"""Automatic mixed precision (counterpart of paddle_tpu/amp/__init__.py:
`decorate`, `auto_cast`, `AmpState`, the white and black lists, and
`amp_cast_inputs`).

`decorate` (O2) casts every floating parameter and buffer of the models to
the compute dtype (bfloat16 or float16), layer norms included, as the
reference's Layer.to(dtype) does; the optimizers' moments stay float32 and
no master weights are kept, as in the reference. At O0 and O1 it returns
the models (and optimizers) as they are. The kernels take either 16-bit
type (each has a float16 instance beside its bfloat16 one).

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
(softmax_with_cross_entropy, hard or soft labels; with use_softmax=False
log and reduce_sum), `label_smooth` (label_smooth_op), `conv1d` /
`conv2d` / `conv3d` (conv2d_op: a bfloat16 conv returns float32, as the
reference's) and the
flash-attention gate (flash_attention). Not hooked yet (ROADMAP.md): the other listed ops.

`GradScaler` is the reference's loss-scaling state machine (dygraph:
scale, unscale_, step, minimize, update, the getters and the state dict):
`unscale_` tests every gradient for NaN and inf in one multi-tensor pass
on the device (`jit.engine.all_finite`) and multiplies each by 1 / scale
rounded to the gradient's dtype, as the reference's weak python float
rounds it; `step` reads the answer on the host once a step (the
reference reads it once a parameter) and skips `optimizer.step()` on an
inf or NaN, so a skipped step does not advance the optimizer's step
count, as in the reference's control flow.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["decorate", "auto_cast", "GradScaler", "AmpState",
           "amp_cast_inputs", "WHITE_LIST", "BLACK_LIST"]

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

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_DTYPE_WORDS = "bfloat16, float16 or float32"
_LOW = (torch.bfloat16, torch.float16)


class AmpState:
    """The active auto_cast: its level, dtype and the lists with the
    caller's additions."""

    def __init__(self, enable=True, level="O1", dtype="bfloat16",
                 custom_white_list=None, custom_black_list=None):
        if dtype not in _DTYPES:
            raise ValueError("amp dtype %r: the port's kernels take %s"
                             % (dtype, _DTYPE_WORDS))
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
        raise ValueError("amp dtype %r: the port's kernels take %s"
                         % (dtype, _DTYPE_WORDS))
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


class GradScaler:
    """Loss scaling (reference: paddle_tpu/amp GradScaler :92-180, over the
    reference's check_finite_and_unscale / update_loss_scaling kernels).

    Dygraph use, as the reference's recipe:

        scaled = scaler.scale(loss)
        scaled.backward()
        scaler.step(opt)          # or scaler.minimize(opt, scaled)
        opt.clear_grad()

    `scale` multiplies the loss by the scale (a python float; in the
    loss's dtype, so a float16 loss may overflow to inf, as the
    reference's does). `unscale_` decides found_inf on the device, in one
    multi-tensor pass over the gradients before they are touched, and
    multiplies every gradient in place by 1 / scale rounded to its dtype.
    `step` unscales, reads found_inf once, runs `optimizer.step()` unless
    it is set, and updates the scale: after `decr_every_n_nan_or_inf`
    consecutive bad steps the scale times decr_ratio (at least 1.0), after
    `incr_every_n_steps` consecutive good ones times incr_ratio (with
    use_dynamic_loss_scaling; else the scale stays)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        # False, or a 0-d bool tensor on the device until step reads it
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """found_inf over every gradient of the optimizer's parameters (on
        the device, not read here), then each gradient times 1 / scale in
        its own dtype."""
        if not self._enable:
            return
        from ..jit.engine import all_finite
        from ..optimizer import _weak
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        ok = all_finite(torch.zeros((), device=grads[0].device), grads)
        inv = 1.0 / self._scale
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for dtype, group in by_dtype.items():
            # the weak python float meets each gradient in its own dtype
            torch._foreach_mul_(group, _weak(inv, dtype))
        self._found_inf = torch.logical_not(ok)

    def _read_found_inf(self):
        found = self._found_inf
        if isinstance(found, torch.Tensor):
            found = bool(found)
            self._found_inf = found
        return found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._read_found_inf():
            optimizer.step()
        self.update()

    def minimize(self, optimizer, loss):
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._read_found_inf():
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)

