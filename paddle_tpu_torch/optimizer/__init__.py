"""Optimizers (counterpart of paddle_tpu/optimizer/__init__.py: Optimizer,
the reference's fifteen update rules, the gradient clips and the
regularizers, with the reference's semantics; the LR schedulers are in
`lr`).

The reference's update is a pure function (param, grad, lr, t, *accs) ->
(new param, *new accs); the port's `_update_rule` updates the parameter
and its accumulators IN PLACE under torch.no_grad() and returns them.
There are no master weights: a bfloat16 or float16 parameter is updated
in float32 arithmetic and stored back in its own dtype, as in the
reference. The rules: SGD, Momentum, Lars, Adam, AdamW, Adamax, Adagrad,
Adadelta, RMSProp, Lamb, Ftrl, DecayedAdagrad, ProximalGD,
ProximalAdagrad and Dpsgd, each the reference's `_update_rule` line for
line in PyTorch ops (Adam and AdamW also through the hand-written kernel,
one launch a step for each (parameter dtype, gradient dtype) group, below).

Every rule reads the step's values from a float32 device buffer
(`_scalars`: lr, c1, c2, go, scale), as the reference's kernel reads
`lr_ref` and `c_ref`: `apply_gradients` is `stage_step` (count the step,
fill the buffer with one non-blocking copy) then `apply_updates` (the
updates, which read the buffer). A captured train step replays only the
updates, after the host has staged each step's values, so a scheduler's
lr and the step count t (Adam's, Adamax's and Lamb's bias corrections
c1 = 1 - beta1^t, c2 = 1 - beta2^t, computed on the host in float32) reach
the replay with no rebuild. `go`, staged 1, is the word a train step's
non-finite guard sets to 0 on the device to skip the update
(`gate_update`; jit/engine.py): every rule selects its old values where
it is 0 (torch.where, as the reference's jnp.where; a multiply would keep
a NaN), and the AdamW kernel writes nothing. A parameter's
`optimize_attr["learning_rate"]` multiplies lr on the device for that
parameter (the reference's compiled `lr * param_lr` in float32).

Dtypes. The reference multiplies by lr as a float32 (a strong
np.float32, traced float32 in its compiled step), so a bfloat16 or
float16 operand times lr is float32; in PyTorch a 0-d float32 tensor
times a bfloat16 tensor is bfloat16, so every rule widens its operand
first. Its python-float hyper-parameters are weak: against a bfloat16
accumulator they round to bfloat16 (`_weak`). XLA computes the jitted
rule's bfloat16 arithmetic in float32, rounding each product to
bfloat16 but keeping sums in float32 until they are returned (excess
precision); the port does the same (`_low_mul`), and rounds each output
once, where it is stored. Each accumulator is made in the dtype the
reference's rule RETURNS for it (a captured step cannot rebind a tensor):
float32 where the rule returns float32 (Adam, Lars, Adagrad, Adadelta,
RMSProp's, Lamb, Ftrl, DecayedAdagrad, ProximalAdagrad), the parameter's
dtype where it keeps it (Momentum's velocity, Adamax's moment and
inf_norm, RMSProp's mean_grad when not centered). SGD, Momentum and
Adamax return a float32 parameter from a bfloat16 one in the reference
(ROADMAP.md section 3); the port keeps the parameter's dtype, rounding
the float32 result once.

`learning_rate` is a number or an `lr.LRScheduler`, whose current value
`stage_step` stages; the scheduler's state rides in the state dict under
"LR_Scheduler", as in the reference. `apply_updates` takes the
reference's order: the regularizer on every gradient, then `grad_clip`
over the whole list, then the rule. `ClipGradByGlobalNorm` gives the
reference's float32 product g * scale with no pass of its own over the
gradients: for Adam and AdamW it computes the scale on the device (one
multi-tensor norm pass) and writes it into the scalar buffer's fifth word,
which the update multiplies each gradient by as it reads it (staged 1.0,
so an unclipped step is unchanged); for the other rules it is the
composed float32 product. `ClipGradByNorm` and `ClipGradByValue` are
composed PyTorch ops in the gradient's dtype, as the reference's are.

Dpsgd draws its noise on the host (numpy, the reference's stream) and so
runs only eagerly: make_train_step refuses it, as the reference's does.

Row-sparse gradients (a SelectedRows from `nn.Embedding(sparse=True)`,
reference :144-184): a sparse gradient stays factored only where no
regularizer and no clip apply, else it is densified first. SGD's sparse
update is a scatter-add of -lr * values (`index_add_`: duplicate rows
fold, no merge); Adam and AdamW with `lazy_mode=True` merge the rows and
update the parameter and both moments on the touched rows only (AdamW's
decay too); every other rule, and Adam without lazy_mode, takes the
densified gradient. The sparse updates read lr and t from `_scalars` as
the dense rules do, and run eagerly only (a captured step's gradients are
dense: framework/selected_rows.py). Adam's dense pairs still go to the
kernel in one launch a group; the sparse pairs stay out of the group.

Not ported yet (raises NotImplementedError when asked for): a callable
weight_decay.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from ..framework.device import resolve_device, write_values
from ..framework.selected_rows import SelectedRows
from ..ops.cuda_kernels import (GO, SCALE, adam_step_scalars,
                                adamw_plain_scalars,
                                fused_adamw_multi_or_none)
from . import lr  # noqa: F401
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Lars", "Adam", "AdamW",
           "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb", "Ftrl",
           "DecayedAdagrad", "ProximalGD", "ProximalAdagrad", "Dpsgd",
           "L1Decay", "L2Decay", "lr", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


# ---------------------------------------------------------------------------
# grad clip (reference: optimizer ClipGradByValue / ByNorm / ByGlobalNorm)


def _need_clip(p):
    return getattr(p, "need_clip", True)


def _lr_factor(p):
    """The parameter's optimize_attr learning rate, a factor of lr."""
    return getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)


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


@functools.lru_cache(maxsize=None)
def _weak(x, dtype):
    """The python float `x` as a weak-typed constant meets an array of
    `dtype` in the reference: rounded to that dtype (then taken into the
    float32 arithmetic as it is)."""
    return float(torch.tensor(float(x), dtype=dtype))


def _wide(t):
    """`t` in float32, or as it is where it is float64: the reference's
    rules that compute in the parameter's dtype keep float64 there."""
    return t if t.dtype == torch.float64 else t.float()


def _low_mul(x, c, dtype):
    """x * c for float32 x holding a `dtype` operand: rounded to `dtype`
    (and widened back), as XLA rounds a bfloat16 or float16 product in the
    reference's jitted rule. Its sums it keeps in float32 (excess
    precision) until they are stored; so does the port."""
    prod = x * c
    return (prod.to(dtype).float() if dtype in (torch.bfloat16, torch.float16)
            else prod)


def _commit(go, pairs):
    """Write each (destination, new value) pair in place where the 0-d
    bool `go` holds, else keep the destination's value: the reference's
    jnp.where(ok, new, old), rounded once to the destination's dtype."""
    for dst, new in pairs:
        dst.copy_(torch.where(go, new, dst))


def _proximal_shrink(prox, lr, l1, l2):
    """Closed-form proximal operator of lr*(l1|w|_1 + l2/2 |w|_2^2)."""
    return (torch.sign(prox) * torch.clamp_min(prox.abs() - lr * l1, 0.0)
            / (1.0 + lr * l2))


class Optimizer:
    """Base optimizer: lr, per-parameter accumulators, the step count, and
    the state dict keys of the reference (`@acc_{i}_{name}`,
    `{qualname}_{name}`, `@step_count`). Parameters must lie on
    `device` (default the current place: the card unless
    set_device("cpu"); raises without CUDA). `_scalars` is the float32
    device buffer of the per-step values every rule reads ([lr, c1, c2,
    go, scale], `_step_scalars`), made once: a captured step holds its
    address. `_clip_word`: the rule multiplies each gradient by
    the buffer's SCALE word, which ClipGradByGlobalNorm writes (Adam and
    AdamW). `_acc_dtypes`: an accumulator's dtype, "param" (the
    parameter's) or a torch dtype, by name. `_dygraph_only`: the rule
    runs eagerly only (make_train_step refuses it)."""

    _accumulator_names: List[str] = []
    _acc_dtypes: Dict[str, object] = {}
    _n_scalars = 5                      # lr, c1, c2, go, scale
    _clip_word = False
    _dygraph_only = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 device=None):
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

    def _acc_dtype(self, p, name):
        dt = self._acc_dtypes.get(name, "param")
        return p.dtype if dt == "param" else dt

    def _create_accumulators(self, p):
        return {n: torch.zeros(p.shape, dtype=self._acc_dtype(p, n),
                               device=p.device)
                for n in self._accumulator_names}

    # -- the update --------------------------------------------------------
    def _static_args(self, p):
        """The rule's hyper-parameters for parameter p."""
        return ()

    def _step_scalars(self, lr, t):
        """The values of `_scalars` for a step at lr and step count t: lr
        in float32, no bias corrections, go 1, the clip scale 1."""
        return np.array([np.float32(lr), 0.0, 0.0, 1.0, 1.0],
                        dtype=np.float32)

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

    def _param_scalars(self, p):
        """The buffer parameter p's rule reads: `_scalars`, or, where p's
        optimize_attr sets a learning rate, a copy whose lr is lr *
        param_lr in float32 (made on the device, after the guard and the
        clip have written their words)."""
        plr = _lr_factor(p)
        if plr == 1.0:
            return self._scalars
        return torch.cat((self._scalars[:1] * float(plr), self._scalars[1:]))

    def stage_step(self):
        """Count the step and fill `_scalars` with its values (lr and t), in
        stream order and without waiting for the device."""
        self._step_count += 1
        write_values(self._scalars,
                     self._step_scalars(self.get_lr(), self._step_count))

    def gate_update(self, ok):
        """Make the staged step's updates apply only where the 0-d bool
        tensor `ok` holds, decided on the device (the non-finite guard):
        `ok` goes into the scalar buffer's guard word, and every rule
        keeps its old values where the word is 0."""
        self._scalars[GO].copy_(ok)

    def _keeps_sparse(self, p):
        """A row-sparse gradient of p stays factored: no regularizer and no
        clip (the reference's test), and the rule has a sparse update."""
        return (self._grad_clip is None and self._regularization is None
                and getattr(p, "regularizer", None) is None
                and self._sparse_rule())

    def _sparse_rule(self):
        """The rule updates from a SelectedRows itself (SGD; lazy Adam)."""
        return False

    def _split_sparse(self, params_grads):
        """(dense pairs, sparse pairs): each SelectedRows gradient kept
        factored where `_keeps_sparse`, else densified."""
        dense, sparse = [], []
        for p, g in params_grads:
            if isinstance(g, SelectedRows):
                if self._keeps_sparse(p):
                    sparse.append((p, g))
                    continue
                g = g.to_dense()
            dense.append((p, g))
        return dense, sparse

    @torch.no_grad()
    def apply_updates(self, params_grads):
        """The reference's order over (parameter, gradient) pairs: the
        regularizer on every gradient, then the clip over the whole list,
        then the rule on each pair, in place, at the values `stage_step`
        staged; then the row-sparse updates (`_split_sparse`)."""
        dense, sparse = self._split_sparse(params_grads)
        self._apply_dense(self._clipped([(p, self._regularized(p, g))
                                         for p, g in dense]))
        for p, sr in sparse:
            self._apply_sparse(p, sr)

    def _apply_dense(self, params_grads):
        """The rule on each regularized and clipped dense pair."""
        for p, g in params_grads:
            self._apply_rule(p, g)

    def _apply_sparse(self, p, sr):
        raise NotImplementedError

    def _apply_rule(self, p, g):
        """The rule on one (parameter, gradient) pair, in place."""
        accs = self._get_accumulators(p)
        self._update_rule(self._static_args(p), p, g, self._param_scalars(p),
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
        self.apply_gradients([(p, g) for p, g in
                              ((p, p.grad) for p in params
                               if p.requires_grad)
                              if g is not None])

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Dygraph: loss.backward(), then step(). Static (`loss` a
        Variable): record the optimize directive on the loss's program,
        which `static.Executor` runs as one train step, over the
        program's trainable parameters unless the optimizer was given
        its own (reference :221-236). Returns (None, None)."""
        from ..static.program import Variable
        if isinstance(loss, Variable):
            loss.program.optimize_directive = (self, loss)
            if self._parameter_list is None:
                self._parameter_list = loss.program.all_parameters()
            return None, None
        loss.backward()
        self.step()
        return None, None

    # -- bookkeeping -------------------------------------------------------
    def clear_grad(self, set_to_zero=True):
        """Zero every parameter's gradient in place (set_to_zero), or drop
        it (None), which frees its memory; a row-sparse gradient is
        dropped either way."""
        for p in self._parameter_list or []:
            g = p.grad
            if g is None:
                continue
            if set_to_zero and not isinstance(g, SelectedRows):
                g.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

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
        step that holds them replays on from the loaded values (a value
        of another dtype, as the reference's rules may return, is cast to
        the accumulator's). The next step stages t = the loaded step count
        + 1."""
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

    set_dict = set_state_dict


# ---------------------------------------------------------------------------
# the rules (reference: optimizer/__init__.py, each class's _update_rule).
# `scalars` is the parameter's buffer [lr, c1, c2, go, scale]; lr and the
# bias corrections are 0-d float32 tensors on the device.


def _lr_go(scalars):
    return scalars[0], scalars[GO] != 0


class SGD(Optimizer):
    """param - lr * g, g the gradient in the parameter's dtype (reference
    :326), in float32 (float64 for a float64 parameter), rounded once to
    the parameter's dtype."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars):
        lr, go = _lr_go(scalars)
        g = _wide(grad.to(param.dtype))
        _commit(go, [(param, _wide(param) - lr * g)])
        return (param,)

    def _sparse_rule(self):
        return True

    def _apply_sparse(self, p, sr):
        """param[rows] += -lr * values, duplicates folded by the scatter
        (reference :295)."""
        lr = self._param_scalars(p)[0]
        p.index_add_(0, sr.rows, (-lr * sr.values).to(p.dtype))


class Momentum(Optimizer):
    """v = mu * velocity + g in the parameter's dtype (the velocity keeps
    it, as the reference's does), param - lr * v (or, with use_nesterov,
    param - lr * (g + mu * v)) in float32, or float64 for a float64
    parameter (reference :339)."""

    _accumulator_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _static_args(self, p):
        return (self._momentum, self._nesterov)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, velocity):
        mu, nesterov = static_args
        lr, go = _lr_go(scalars)
        dt = velocity.dtype
        g = _wide(grad.to(param.dtype))
        mu_w = _weak(mu, dt)
        v = _low_mul(_wide(velocity), mu_w, dt) + g
        if nesterov:
            step = lr * (g + _low_mul(v, mu_w, dt))
        else:
            step = lr * v
        _commit(go, [(param, _wide(param) - step), (velocity, v)])
        return param, velocity


class Lars(Optimizer):
    """LARS over momentum (reference :364): local_lr = lr * coeff ||w|| /
    (||g|| + wd ||w|| + eps + 1e-12) where both norms are positive (else
    lr), v = mu * velocity + local_lr * (g + wd * w), w - v; float32, the
    norms on the device. A parameter whose name holds one of
    `exclude_from_weight_decay` takes wd 0."""

    _accumulator_names = ["velocity"]
    _acc_dtypes = {"velocity": torch.float32}

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, parameters=None,
                 exclude_from_weight_decay=None, grad_clip=None, name=None,
                 device=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         device)
        self._momentum = float(momentum)
        self._coeff = float(lars_coeff)
        self._wd = float(lars_weight_decay)
        self._eps = float(epsilon)
        self._exclude = tuple(exclude_from_weight_decay or ())

    def _static_args(self, p):
        wd = self._wd
        name = _name(p) or ""
        if any(tag in name for tag in self._exclude):
            wd = 0.0
        return (self._momentum, self._coeff, wd, self._eps)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, velocity):
        mu, coeff, wd, eps = static_args
        lr, go = _lr_go(scalars)
        g = grad.float()
        p32 = param.float()
        w_norm = torch.sqrt(torch.sum(p32 * p32))
        g_norm = torch.sqrt(torch.sum(g * g))
        ratio = coeff * w_norm / (g_norm + wd * w_norm + eps + 1e-12)
        local_lr = lr * torch.where((w_norm > 0) & (g_norm > 0), ratio, 1.0)
        v = mu * velocity + local_lr * (g + wd * p32)
        _commit(go, [(param, p32 - v), (velocity, v)])
        return param, velocity


class Adam(Optimizer):
    _accumulator_names = ["moment1", "moment2"]
    _acc_dtypes = {"moment1": torch.float32, "moment2": torch.float32}
    _clip_word = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._lazy_mode = bool(lazy_mode)

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

    def _sparse_rule(self):
        return self._lazy_mode

    def _apply_sparse(self, p, sr):
        """Lazy Adam / AdamW on the merged rows (reference :304-328): the
        parameter (decayed first by AdamW's coeff) and both moments move
        on the touched rows only, at the staged lr, c1 and c2."""
        sr = sr.merged()
        sc = self._param_scalars(p)
        lr, c1, c2 = sc[0], sc[1], sc[2]
        b1, b2, eps, coeff, _ = self._static_args(p)
        accs = self._get_accumulators(p)
        m1, m2 = accs["moment1"], accs["moment2"]
        g = sr.values.float()
        p_rows = p.index_select(0, sr.rows).float()
        if coeff:
            p_rows = p_rows * (1.0 - lr * coeff)
        m1r = b1 * m1.index_select(0, sr.rows) + (1 - b1) * g
        m2r = b2 * m2.index_select(0, sr.rows) + (1 - b2) * (g * g)
        step = lr * (m1r / c1) / (torch.sqrt(m2r / c2) + eps)
        p.index_copy_(0, sr.rows, (p_rows - step).to(p.dtype))
        m1.index_copy_(0, sr.rows, m1r)
        m2.index_copy_(0, sr.rows, m2r)

    def _apply_dense(self, params_grads):
        """The rule over each (parameter dtype, gradient dtype) group of
        the regularized and clipped pairs at once (the clip wrote the
        scale word): one `fused_adamw_multi_or_none` call a group, one
        kernel launch, each tensor with its own coeff, clip bit and lr
        factor; with use_fused_optimizer off, the plain rule pair by
        pair."""
        groups = {}
        for p, g in params_grads:
            groups.setdefault((p.dtype, g.dtype), []).append((p, g))
        for pairs in groups.values():
            ps = [p for p, _ in pairs]
            accs = [self._get_accumulators(p) for p in ps]
            args = [self._static_args(p) for p in ps]
            if fused_adamw_multi_or_none(
                    ps, [g for _, g in pairs], self._scalars,
                    [a["moment1"] for a in accs], [a["moment2"] for a in accs],
                    beta1=self._beta1, beta2=self._beta2,
                    epsilon=self._epsilon, coeff=[a[3] for a in args],
                    scaled=[a[4] for a in args],
                    lr_factor=[_lr_factor(p) for p in ps]) is None:
                for p, g in pairs:
                    self._apply_rule(p, g)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, m1, m2):
        """Adam (coeff 0) and AdamW in one plain rule (the route with
        use_fused_optimizer off; `apply_updates` sends the rest to the
        kernel); static_args is (beta1, beta2, epsilon, coeff, scaled),
        scalars the step's (lr, c1, c2, go, scale)."""
        b1, b2, eps, coeff, scaled = static_args
        adamw_plain_scalars(param, grad, m1, m2, scalars, beta1=b1,
                            beta2=b2, epsilon=eps, coeff=coeff,
                            scaled=scaled)
        return param, m1, m2


class AdamW(Adam):
    """Decoupled weight decay (reference: optimizer/adamw.py): the
    parameter shrinks by (1 - lr * weight_decay) before the Adam step,
    for every parameter for which apply_decay_param_fun(qualname) holds
    (all of them when it is None); the others take coeff 0, Adam's
    rule. `lr_ratio` is taken and ignored, as the reference ignores it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 device=None):
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


class Adamax(Optimizer):
    """m = b1 m + (1 - b1) g and u = max(b2 u, |g|) in the parameter's
    dtype (the reference's accumulators keep it), param - lr / c1 * m /
    (u + eps) in float32 (float64 for a float64 parameter), c1 = 1 - b1^t
    (reference :516)."""

    _accumulator_names = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _static_args(self, p):
        return (self._beta1, self._beta2, self._epsilon)

    def _step_scalars(self, lr, t):
        return adam_step_scalars(lr, t, self._beta1, self._beta2)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, m, u):
        b1, b2, eps = static_args
        lr, go = _lr_go(scalars)
        c1 = scalars[1]
        g = _wide(grad.to(param.dtype))
        dt = m.dtype
        mn = (_low_mul(_wide(m), _weak(b1, dt), dt)
              + _low_mul(g, _weak(1 - b1, dt), dt))
        un = torch.maximum(_low_mul(_wide(u), _weak(b2, dt), dt), g.abs())
        step = lr / c1 * mn / (un + _weak(eps, dt))
        _commit(go, [(param, _wide(param) - step), (m, mn), (u, un)])
        return param, m, u


class Adagrad(Optimizer):
    """moment += g^2 (float32, from initial_accumulator_value), param -
    lr g / (sqrt(moment) + eps) (reference :539)."""

    _accumulator_names = ["moment"]
    _acc_dtypes = {"moment": torch.float32}

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._epsilon = float(epsilon)
        self._init_val = float(initial_accumulator_value)

    def _create_accumulators(self, p):
        return {"moment": torch.full(p.shape, self._init_val,
                                     dtype=torch.float32, device=p.device)}

    def _static_args(self, p):
        return (self._epsilon,)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, moment):
        (eps,) = static_args
        lr, go = _lr_go(scalars)
        g = grad.float()
        mn = moment + g * g
        new = param.float() - lr * g / (torch.sqrt(mn) + eps)
        _commit(go, [(param, new), (moment, mn)])
        return param, moment


class Adadelta(Optimizer):
    """Adadelta (reference :564): both accumulators float32 (the dtype
    the reference's rule returns them in)."""

    _accumulator_names = ["avg_squared_grad", "avg_squared_update"]
    _acc_dtypes = {"avg_squared_grad": torch.float32,
                   "avg_squared_update": torch.float32}

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._epsilon, self._rho = float(epsilon), float(rho)

    def _static_args(self, p):
        return (self._epsilon, self._rho)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, sq_g, sq_u):
        eps, rho = static_args
        lr, go = _lr_go(scalars)
        g = grad.float()
        sq_gn = rho * sq_g + (1 - rho) * (g * g)
        upd = -torch.sqrt((sq_u + eps) / (sq_gn + eps)) * g
        sq_un = rho * sq_u + (1 - rho) * (upd * upd)
        _commit(go, [(param, param.float() + lr * upd), (sq_g, sq_gn),
                     (sq_u, sq_un)])
        return param, sq_g, sq_u


class RMSProp(Optimizer):
    """RMSProp, centered or not, with momentum (reference :585):
    mean_square and momentum_acc float32; mean_grad float32 when centered,
    else the parameter's dtype, never written (as the reference returns
    it unchanged)."""

    _accumulator_names = ["mean_square", "mean_grad", "momentum_acc"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)
        self._acc_dtypes = {"mean_square": torch.float32,
                            "momentum_acc": torch.float32,
                            "mean_grad": (torch.float32 if self._centered
                                          else "param")}

    def _static_args(self, p):
        return (self._rho, self._epsilon, self._momentum, self._centered)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, ms, mg, mom):
        rho, eps, mu, centered = static_args
        lr, go = _lr_go(scalars)
        g = grad.float()
        msn = rho * ms + (1 - rho) * (g * g)
        out = [(ms, msn)]
        if centered:
            mgn = rho * mg + (1 - rho) * g
            denom = msn - mgn * mgn + eps
            out.append((mg, mgn))
        else:
            denom = msn + eps
        momn = mu * mom + lr * g / torch.sqrt(denom)
        _commit(go, [(param, param.float() - momn), (mom, momn)] + out)
        return param, ms, mg, mom


class Lamb(Optimizer):
    """LAMB (You et al. 2019; reference :613): Adam's moments in float32,
    r = m^ / (sqrt(v^) + eps) + wd w, the trust ratio ||w|| / ||r|| where
    both are positive (else 1), w - lr ratio r; the bias corrections from
    the scalar buffer, the norms and the choice on the device (no host
    read, so a captured step holds it). exclude_from_weight_decay_fn(p)
    true: wd 0 for p."""

    _accumulator_names = ["moment1", "moment2"]
    _acc_dtypes = {"moment1": torch.float32, "moment2": torch.float32}

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None,
                 device=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         device)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._lamb_wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _static_args(self, p):
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return (self._beta1, self._beta2, self._epsilon, wd)

    def _step_scalars(self, lr, t):
        return adam_step_scalars(lr, t, self._beta1, self._beta2)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, m1, m2):
        b1, b2, eps, wd = static_args
        lr, go = _lr_go(scalars)
        c1, c2 = scalars[1], scalars[2]
        g = grad.float()
        p32 = param.float()
        m1n = b1 * m1 + (1 - b1) * g
        m2n = b2 * m2 + (1 - b2) * (g * g)
        r = (m1n / c1) / (torch.sqrt(m2n / c2) + eps) + wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        _commit(go, [(param, p32 - lr * ratio * r), (m1, m1n), (m2, m2n)])
        return param, m1, m2


class Ftrl(Optimizer):
    """FTRL-Proximal (reference :655): squared and linear accumulators in
    float32; lr a device value, the lr_power == -0.5 branch by square
    roots, the others by pow."""

    _accumulator_names = ["squared", "linear"]
    _acc_dtypes = {"squared": torch.float32, "linear": torch.float32}

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._l1, self._l2 = float(l1), float(l2)
        self._lr_power = float(lr_power)

    def _static_args(self, p):
        return (self._l1, self._l2, self._lr_power)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, squared, linear):
        l1, l2, lr_power = static_args
        lr, go = _lr_go(scalars)
        g = grad.float()
        p32 = param.float()
        new_sq = squared + g * g
        if lr_power == -0.5:
            sigma = (torch.sqrt(new_sq) - torch.sqrt(squared)) / lr
        else:
            sigma = (torch.pow(new_sq, -lr_power)
                     - torch.pow(squared, -lr_power)) / lr
        lin = linear + g - sigma * p32
        x = l1 * torch.sign(lin) - lin
        if lr_power == -0.5:
            y = torch.sqrt(new_sq) / lr + 2.0 * l2
        else:
            y = torch.pow(new_sq, -lr_power) / lr + 2.0 * l2
        new_p = torch.where(lin.abs() > l1, x / y, 0.0)
        _commit(go, [(param, new_p), (squared, new_sq), (linear, lin)])
        return param, squared, linear


class DecayedAdagrad(Optimizer):
    """Adagrad with an exponentially decayed float32 squared-gradient
    accumulator (reference :699)."""

    _accumulator_names = ["moment"]
    _acc_dtypes = {"moment": torch.float32}

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._decay, self._epsilon = float(decay), float(epsilon)

    def _static_args(self, p):
        return (self._decay, self._epsilon)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, moment):
        decay, eps = static_args
        lr, go = _lr_go(scalars)
        g = grad.float()
        mn = decay * moment + (1.0 - decay) * (g * g)
        new = param.float() - lr * g / (torch.sqrt(mn) + eps)
        _commit(go, [(param, new), (moment, mn)])
        return param, moment


class ProximalGD(Optimizer):
    """SGD followed by the l1/l2 proximal shrink (reference :733)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._l1, self._l2 = float(l1), float(l2)

    def _static_args(self, p):
        return (self._l1, self._l2)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars):
        l1, l2 = static_args
        lr, go = _lr_go(scalars)
        prox = param.float() - lr * grad.float()
        _commit(go, [(param, _proximal_shrink(prox, lr, l1, l2))])
        return (param,)


class ProximalAdagrad(Optimizer):
    """An Adagrad step with the l1/l2 proximal shrink at the adapted
    learning rate (reference :755); the moment float32."""

    _accumulator_names = ["moment"]
    _acc_dtypes = {"moment": torch.float32}

    def __init__(self, learning_rate, l1=0.0, l2=0.0, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._l1, self._l2 = float(l1), float(l2)
        self._epsilon = float(epsilon)

    def _static_args(self, p):
        return (self._l1, self._l2, self._epsilon)

    @staticmethod
    def _update_rule(static_args, param, grad, scalars, moment):
        l1, l2, eps = static_args
        lr, go = _lr_go(scalars)
        g = grad.float()
        mn = moment + g * g
        alr = lr / (torch.sqrt(mn) + eps)
        prox = param.float() - alr * g
        _commit(go, [(param, _proximal_shrink(prox, alr, l1, l2)),
                     (moment, mn)])
        return param, moment


_DPSGD_CAPTURED = (
    "Dpsgd is dygraph-only: its per-step host-side gaussian noise draw "
    "cannot be baked into a compiled static update; use it with "
    "loss.backward() + opt.step()")


class Dpsgd(Optimizer):
    """Differentially private SGD (reference :797): each gradient divided
    by max(||g|| / clip, 1), plus one gaussian draw of N(0, sigma) over
    batch_size, times lr. The noise comes from the reference's host
    stream, numpy's RandomState(seed or None), one draw a parameter in
    order, so the port's draws equal the reference's. Eager only:
    make_train_step raises, with the reference's words."""

    _dygraph_only = True
    _captured_error = _DPSGD_CAPTURED

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, seed=0, name=None,
                 device=None):
        super().__init__(learning_rate, parameters, None, None, name, device)
        self._clip = float(clip)
        self._batch_size = float(batch_size)
        self._sigma = float(sigma)
        self._noise_rng = np.random.RandomState(seed or None)

    def _apply_dense(self, params_grads):
        for p, g in params_grads:
            noise = np.float32(self._noise_rng.normal(0.0, self._sigma))
            self._dpsgd_rule(p, g, self._param_scalars(p), float(noise))

    def _dpsgd_rule(self, param, grad, scalars, noise):
        lr, go = _lr_go(scalars)
        g = grad.float()
        l2 = torch.sqrt(torch.sum(g * g))
        scale = torch.where(l2 > self._clip, l2 / self._clip, 1.0)
        nz = torch.full((), noise, dtype=torch.float32, device=g.device)
        step = lr * (g / scale + nz / self._batch_size)
        _commit(go, [(param, param.float() - step)])
