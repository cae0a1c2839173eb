"""Optimizers (counterpart of paddle_tpu/optimizer/__init__.py: Optimizer,
Adam, AdamW, the gradient clips and the regularizers, with the
reference's semantics; the LR schedulers are in `lr`).

The reference's update is a pure function (param, grad, lr, t, *accs) ->
(new param, *new accs); the port's `_update_rule` updates the parameter
and its accumulators IN PLACE under torch.no_grad() and returns them. The
accumulators `moment1` / `moment2` are float32 whatever the parameter's
dtype, and there are no master weights: a bfloat16 parameter is updated
in float32 arithmetic and stored back in bfloat16, as in the reference.

Adam and AdamW go through `fused_adamw_or_none` (the hand-written update
kernel, csrc/adamw.cu) and, with `use_fused_optimizer` off, through the
plain rule `adamw_plain_scalars`, the reference's jnp rule line for line.
Both read the step's lr and bias corrections from a float32 device buffer
(`_scalars`: lr, 1 - beta1^t, 1 - beta2^t, go), as the reference's kernel
reads `lr_ref` and `c_ref`: `apply_gradients` is `stage_step` (count the
step, fill the buffer with one non-blocking copy) then `apply_updates`
(the updates, which read the buffer). A captured train step replays only
the updates, after the host has staged each step's values. `go`, staged
1, is the word a train step's non-finite guard sets to 0 on the device to
skip the update (`gate_update`; jit/engine.py).

`learning_rate` is a number or an `lr.LRScheduler`, whose current value
`stage_step` stages, so a captured step follows the schedule with no
rebuild; the scheduler's state rides in the state dict under
"LR_Scheduler", as in the reference. `apply_updates` takes the
reference's order: the regularizer on every gradient, then `grad_clip`
over the whole list, then the rule. `ClipGradByGlobalNorm` gives the
reference's float32 product g * scale with no pass of its own over the
gradients: for Adam and AdamW it computes the scale on the device (one
multi-tensor norm pass) and writes it into the scalar buffer's fifth word,
which the update multiplies each gradient by as it reads it (staged 1.0,
so an unclipped step is unchanged). `ClipGradByNorm` and
`ClipGradByValue` are composed PyTorch ops in the gradient's dtype, as
the reference's are.

Not ported yet (raise NotImplementedError when asked for): lazy_mode
(row-sparse gradients), lr_ratio, a callable weight_decay.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..framework.device import resolve_device, write_values
from ..ops.cuda_kernels import (GO, SCALE, adam_step_scalars,
                                adamw_plain_scalars, fused_adamw_or_none)
from . import lr  # noqa: F401
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW", "L1Decay", "L2Decay", "lr",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


# ---------------------------------------------------------------------------
# grad clip (reference: optimizer ClipGradByValue / ByNorm / ByGlobalNorm)


def _need_clip(p):
    return getattr(p, "need_clip", True)


def _true_div(num, den):
    """num / den as one rounded division (a python number over a tensor
    would become den's reciprocal times num)."""
    return torch.full_like(den, num).div_(den)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient clamped to [min, max], in its own dtype."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient times min(clip_norm / max(||g||, 1e-12), 1), its norm
    and the product in the gradient's dtype, as the reference's weak
    python floats keep them."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            norm = g.square().sum().sqrt()
            scale = torch.clamp_max(
                _true_div(self.clip_norm, torch.clamp_min(norm, 1e-12)), 1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient of a parameter with `need_clip` (default True) times
    clip_norm / max(global norm, clip_norm), the global norm summed in
    float32 over those gradients; the product is float32, as the
    reference's non-weak float32 scale makes it."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def scale(self, params_grads) -> torch.Tensor:
        """The 0-d float32 scale on the gradients' device, with no read on
        the host: one multi-tensor pass a gradient dtype
        (`torch._foreach_norm` with float32 norms: without dtype= it
        returns a bfloat16 gradient's norm in bfloat16)."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p, g in params_grads:
            if _need_clip(p):
                by_dtype.setdefault(g.dtype, []).append(g)
        if not by_dtype:
            return torch.ones((), dtype=torch.float32,
                              device=params_grads[0][1].device
                              if params_grads else None)
        norms = [n for group in by_dtype.values()
                 for n in torch._foreach_norm(group, 2,
                                              dtype=torch.float32)]
        total = torch.linalg.vector_norm(torch.stack(norms))
        return _true_div(self.clip_norm,
                         torch.clamp_min(total, self.clip_norm))

    def __call__(self, params_grads):
        scale = self.scale(params_grads)
        return [(p, g.float() * scale if _need_clip(p) else g)
                for p, g in params_grads]


# regularizers (reference: optimizer L1Decay / L2Decay)
class L2Decay:
    """g + coeff * p."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + self.coeff * p


class L1Decay:
    """g + coeff * sign(p)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + self.coeff * torch.sign(p)


def _name(p):
    """A parameter's name for apply_decay_param_fun and the state dict:
    its `qualname` (the model factories set it to the module path), or
    None."""
    return getattr(p, "qualname", None)


def _not_ported(what):
    raise NotImplementedError(
        "%s is not ported to paddle_tpu_torch yet (see ROADMAP.md)" % what)


class Optimizer:
    """Base optimizer: lr, per-parameter accumulators, the step count, and
    the state dict keys of the reference (`@acc_{i}_{name}`,
    `{qualname}_{name}`, `@step_count`). Parameters must lie on
    `device` (default "cuda", which raises without CUDA). `_scalars` is
    the device buffer of the per-step values the rule reads
    (`_step_scalars`), made once: a captured step holds its address.
    `_clip_word`: the rule multiplies each gradient by the buffer's SCALE
    word, which ClipGradByGlobalNorm writes."""

    _accumulator_names: List[str] = []
    _n_scalars = 0
    _clip_word = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 device="cuda"):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError("learning_rate must be a number or an "
                            "LRScheduler (got %s)"
                            % type(learning_rate).__name__)
        if grad_clip is not None and not callable(grad_clip):
            raise TypeError("grad_clip must be a clip (a callable over "
                            "(parameter, gradient) pairs), got %s"
                            % type(grad_clip).__name__)
        self._device = resolve_device(device)
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
        self._grad_clip = grad_clip
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        for p in self._parameter_list or []:
            if p.device.type != self._device.type:
                raise ValueError("parameter on %s, optimizer on %s"
                                 % (p.device, self._device))
        if weight_decay is None:
            self._regularization = None
        elif isinstance(weight_decay, (int, float)):
            self._regularization = L2Decay(float(weight_decay))
        else:
            self._regularization = weight_decay
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        self._scalars = torch.zeros(self._n_scalars, dtype=torch.float32,
                                    device=self._device)

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    # -- accumulators ------------------------------------------------------
    def _get_accumulators(self, p):
        acc = self._accumulators.get(id(p))
        if acc is None:
            acc = self._create_accumulators(p)
            self._accumulators[id(p)] = acc
        return acc

    def _create_accumulators(self, p):
        return {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                for n in self._accumulator_names}

    # -- the update --------------------------------------------------------
    def _static_args(self, p):
        """The rule's hyper-parameters for parameter p."""
        return ()

    def _step_scalars(self, lr, t):
        """The values of `_scalars` for a step at lr and step count t."""
        return []

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, *accs):
        raise NotImplementedError

    def _regularized(self, p, g):
        """The parameter's own `regularizer`, else the optimizer's."""
        reg = getattr(p, "regularizer", None) or self._regularization
        return g if reg is None else reg(p, g)

    def _clipped(self, params_grads):
        """`grad_clip` over the whole list. ClipGradByGlobalNorm with a
        scale word writes its scale there, on the device, and leaves the
        gradients to the rule."""
        clip = self._grad_clip
        if clip is None:
            return params_grads
        if self._clip_word and isinstance(clip, ClipGradByGlobalNorm):
            self._scalars[SCALE].copy_(clip.scale(params_grads))
            return params_grads
        return clip(params_grads)

    def stage_step(self):
        """Count the step and fill `_scalars` with its values (lr and t), in
        stream order and without waiting for the device."""
        self._step_count += 1
        if self._n_scalars:
            write_values(self._scalars,
                         self._step_scalars(self.get_lr(), self._step_count))

    def gate_update(self, ok):
        """Make the staged step's updates apply only where the 0-d bool
        tensor `ok` holds, decided on the device (the non-finite guard)."""
        raise NotImplementedError(
            "%s has no guard word: skip_nonfinite_steps takes Adam or AdamW"
            % type(self).__name__)

    @torch.no_grad()
    def apply_updates(self, params_grads):
        """The reference's order over (parameter, gradient) pairs: the
        regularizer on every gradient, then the clip over the whole list,
        then the rule on each pair, in place, at the values `stage_step`
        staged."""
        pairs = self._clipped([(p, self._regularized(p, g))
                               for p, g in params_grads])
        for p, g in pairs:
            accs = self._get_accumulators(p)
            self._update_rule(self._static_args(p), p, g, self._scalars,
                              *[accs[n] for n in self._accumulator_names])

    def apply_gradients(self, params_grads):
        """One step over (parameter, gradient) pairs: counts the step,
        stages the lr and t, and applies the regularizer, the clip and the
        rule, in place."""
        self.stage_step()
        self.apply_updates(params_grads)

    def step(self):
        params = self._parameter_list
        if params is None:
            raise ValueError("optimizer constructed without parameters")
        self.apply_gradients([(p, p.grad) for p in params
                              if p.requires_grad and p.grad is not None])

    # -- bookkeeping -------------------------------------------------------
    def clear_grad(self, set_to_zero=True):
        """Zero every parameter's gradient in place (set_to_zero), or drop
        it (None), which frees its memory."""
        for p in self._parameter_list or []:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    def state_dict(self):
        """Snapshot (copies) of the accumulators keyed by parameter order
        and, where the parameter has a name, by name (one tensor under
        both keys); the scheduler's state under "LR_Scheduler"; the step
        count."""
        sd = {}
        for i, p in enumerate(self._parameter_list or []):
            for name, t in self._accumulators.get(id(p), {}).items():
                snap = t.detach().clone()
                sd["@acc_%d_%s" % (i, name)] = snap
                if _name(p):
                    sd["%s_%s" % (_name(p), name)] = snap
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        sd["@step_count"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        """Load a state dict (this package's or the reference's) IN PLACE:
        the accumulators are copied into, never rebound, so a captured
        step that holds them replays on from the loaded values. The next
        step stages t = the loaded step count + 1."""
        sched = state_dict.get("LR_Scheduler")
        if sched and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(dict(sched))
        if "@step_count" in state_dict:
            self._step_count = int(np.asarray(state_dict["@step_count"]))
        for i, p in enumerate(self._parameter_list or []):
            accs = self._get_accumulators(p)
            for name in list(accs):
                v = state_dict.get("@acc_%d_%s" % (i, name))
                if v is None and _name(p):
                    v = state_dict.get("%s_%s" % (_name(p), name))
                if v is not None:
                    with torch.no_grad():
                        accs[name].copy_(torch.as_tensor(np.asarray(v)
                                                         if not isinstance(
                                                             v, torch.Tensor)
                                                         else v))


class Adam(Optimizer):
    _accumulator_names = ["moment1", "moment2"]
    _n_scalars = 5                      # lr, c1, c2, go, scale
    _clip_word = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, device="cuda"):
        if lazy_mode:
            _not_ported("lazy_mode (row-sparse gradients)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _coeff(self, p):
        """Decoupled weight decay of parameter p: none for Adam."""
        return 0.0

    def _static_args(self, p):
        """(beta1, beta2, epsilon, coeff, scaled): `scaled`, the gradient
        takes the buffer's clip scale (ClipGradByGlobalNorm and the
        parameter's need_clip)."""
        scaled = (isinstance(self._grad_clip, ClipGradByGlobalNorm)
                  and _need_clip(p))
        return (self._beta1, self._beta2, self._epsilon, self._coeff(p),
                scaled)

    def _step_scalars(self, lr, t):
        return adam_step_scalars(lr, t, self._beta1, self._beta2)

    def gate_update(self, ok):
        """Write `ok` into the scalar buffer's guard word: at 0 the kernel
        and the plain rule write nothing."""
        self._scalars[GO].copy_(ok)

    def _create_accumulators(self, p):
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n in self._accumulator_names}

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, m1, m2):
        """Adam (coeff 0) and AdamW in one rule; static_args is (beta1,
        beta2, epsilon, coeff, scaled), scalars the step's (lr, c1, c2, go,
        scale)."""
        b1, b2, eps, coeff, scaled = static_args
        kw = dict(beta1=b1, beta2=b2, epsilon=eps, coeff=coeff,
                  scaled=scaled)
        if fused_adamw_or_none(param, grad, scalars, m1, m2, **kw) is None:
            adamw_plain_scalars(param, grad, m1, m2, scalars, **kw)
        return param, m1, m2


class AdamW(Adam):
    """Decoupled weight decay (reference: optimizer/adamw.py): the
    parameter shrinks by (1 - lr * weight_decay) before the Adam step,
    for every parameter for which apply_decay_param_fun(qualname) holds
    (all of them when it is None); the others take coeff 0, Adam's
    rule."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 device="cuda"):
        if lr_ratio is not None:
            _not_ported("lr_ratio")
        if callable(weight_decay):
            _not_ported("a callable weight_decay")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name,
                         device)
        self._weight_decay = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _coeff(self, p):
        if (self._apply_decay_param_fun is None
                or self._apply_decay_param_fun(_name(p))):
            return self._weight_decay
        return 0.0
