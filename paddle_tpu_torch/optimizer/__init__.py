"""Optimizers (counterpart of paddle_tpu/optimizer/__init__.py: Optimizer,
Adam, AdamW, with the reference's semantics).

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

Not ported yet (raise NotImplementedError when asked for): LR schedulers,
grad_clip, lazy_mode (row-sparse gradients), lr_ratio, a callable
weight_decay.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..framework.device import resolve_device, write_values
from ..ops.cuda_kernels import (GO, adam_step_scalars, adamw_plain_scalars,
                                fused_adamw_or_none)

__all__ = ["Optimizer", "Adam", "AdamW", "L2Decay"]


class L2Decay:
    """g + coeff * p (reference: optimizer L2Decay)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + self.coeff * p


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
    (`_step_scalars`), made once: a captured step holds its address."""

    _accumulator_names: List[str] = []
    _n_scalars = 0

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 device="cuda"):
        if not isinstance(learning_rate, (int, float)):
            _not_ported("an LR scheduler")
        if grad_clip is not None:
            _not_ported("grad_clip")
        self._device = resolve_device(device)
        self._lr = float(learning_rate)
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
        return float(self._lr)

    def set_lr(self, value):
        self._lr = float(value)

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
        return g if self._regularization is None else \
            self._regularization(p, g)

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
        """The regularizer and then the rule on each (parameter, gradient)
        pair, in place, at the values `stage_step` staged."""
        for p, g in params_grads:
            accs = self._get_accumulators(p)
            self._update_rule(self._static_args(p), p,
                              self._regularized(p, g), self._scalars,
                              *[accs[n] for n in self._accumulator_names])

    def apply_gradients(self, params_grads):
        """One step over (parameter, gradient) pairs: counts the step,
        stages the lr and t, and applies the regularizer and then the rule
        to each parameter, in place."""
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
        and, where the parameter has a name, by name; plus the step
        count."""
        sd = {}
        for i, p in enumerate(self._parameter_list or []):
            for name, t in self._accumulators.get(id(p), {}).items():
                snap = t.detach().clone()
                sd["@acc_%d_%s" % (i, name)] = snap
                if _name(p):
                    sd["%s_%s" % (_name(p), name)] = snap
        sd["@step_count"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
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
    _n_scalars = 4                      # lr, c1, c2, go

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
        return (self._beta1, self._beta2, self._epsilon, self._coeff(p))

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
        beta2, epsilon, coeff), scalars the step's (lr, c1, c2, go)."""
        b1, b2, eps, coeff = static_args
        kw = dict(beta1=b1, beta2=b2, epsilon=eps, coeff=coeff)
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
