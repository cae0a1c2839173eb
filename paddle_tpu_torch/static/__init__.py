"""paddle.static (counterpart of paddle_tpu/static/__init__.py): the
Program, its Executor, the model files and the passes.

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.vision.models import resnet50

    paddle.enable_static()
    img = static.data("image", [-1, 3, 224, 224], "float32")
    label = static.data("label", [-1, 1], "int64")
    loss = paddle.nn.functional.cross_entropy(resnet50(num_classes=100)(img),
                                              label)
    paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    static.apply_pass(static.default_main_program(), "amp_bf16_pass")
    exe = static.Executor()                     # the card
    (lv,) = exe.run(feed={"image": x, "label": y}, fetch_list=[loss])

`gradients(targets, inputs)` records one backward op over the pruned
forward slice (its body `torch.autograd.grad`), whose outputs are
fetchable through `Executor.run`; `append_backward(loss)` gives each
trainable parameter's.

Not ported yet (ROADMAP.md): the control flow (`cond`, `while_loop`,
`case`, `switch_case`), `static.nn`, `static.sparsity`, the dataset
trainers.
"""
from __future__ import annotations

import contextlib

import torch

from . import io, passes  # noqa: F401
from .executor import Executor, Scope, global_scope
from .io import load, load_inference_model, save, save_inference_model
from .passes import PassManager, apply_pass
from .program import (InputSpec, Program, Variable, data,
                      default_main_program, default_startup_program,
                      program_guard, reset_default_programs)

__all__ = ["Program", "Variable", "InputSpec", "data", "program_guard",
           "default_main_program", "default_startup_program",
           "reset_default_programs", "Executor", "Scope", "global_scope",
           "save_inference_model", "load_inference_model", "save", "load",
           "apply_pass", "PassManager", "CompiledProgram", "BuildStrategy",
           "ExecutionStrategy", "cpu_places", "cuda_places",
           "device_places", "name_scope", "append_backward",
           "gradients"]


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """[(parameter, its gradient Variable)] of every trainable parameter
    of the loss's program (or `parameter_list`), those named in
    `no_grad_set` left out (reference: static/__init__.py:15)."""
    params = parameter_list or loss.program.all_parameters()
    skip = {getattr(v, "name", v) for v in (no_grad_set or ())}
    params = [p for p in params if getattr(p, "name", None) not in skip]
    return list(zip(params, gradients([loss], params)))


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """The gradients of `targets` (seeded by `target_gradients`, ones where
    None) with respect to `inputs` (Variables or captured parameters), as
    Variables of one recorded backward op (reference: static/__init__.py
    :30). Its body runs the pruned forward slice again and takes
    `torch.autograd.grad`; an input is a cut point (its producers do not
    matter), and no gradient flows through a var named in `no_grad_set`
    (an input named there gets zeros)."""
    from .program import OpRecord, _new_var_name, prune_ops
    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
        else [inputs]
    program = targets[0].program
    target_names = [t.name for t in targets]

    def env_name(x):
        if isinstance(x, Variable):
            return x.name
        if isinstance(x, torch.Tensor) and id(x) in program.capture_names:
            return program.capture_names[id(x)]
        raise ValueError("gradients: %r is not a Variable or a tensor of "
                         "this program" % (getattr(x, "name", x),))

    input_names = [env_name(x) for x in inputs]
    stop = {getattr(v, "name", v) for v in (no_grad_set or ())}
    sub_ops, needed = prune_ops(program.ops, set(target_names))
    produced = {n for op in sub_ops for n in op.out_names}
    ext_names = sorted((needed - produced) | set(input_names))
    tg = list(target_gradients) if target_gradients is not None \
        else [None] * len(targets)
    ct_names = [None if g is None else env_name(g) for g in tg]

    def grad_fn(*values):
        env = dict(zip(ext_names, values[:len(ext_names)]))
        cts = iter(values[len(ext_names):])
        with torch.enable_grad():
            primals = [env[n].detach().requires_grad_(
                env[n].is_floating_point() or env[n].is_complex())
                for n in input_names]
            env.update(zip(input_names, primals))
            for n in stop & set(env):
                env[n] = env[n].detach()
            for op in sub_ops:
                ins = [ref if kind == "const" else env[ref]
                       for kind, ref in op.in_refs]
                outs = op.fn(*ins, **op.attrs)
                outs = outs if isinstance(outs, tuple) else (outs,)
                for n, o in zip(op.out_names, outs):
                    if n in input_names:
                        continue
                    env[n] = o.detach() if n in stop and isinstance(
                        o, torch.Tensor) else o
            outs = [env[t] for t in target_names]
            seeds = [torch.ones_like(o) if c is None
                     else next(cts).reshape(o.shape).to(o.dtype)
                     for o, c in zip(outs, ct_names)]
            pairs = [(o, g) for o, g in zip(outs, seeds) if o.requires_grad]
            live = [p for p, n in zip(primals, input_names)
                    if p.requires_grad and n not in stop]
            got = (torch.autograd.grad([o for o, _ in pairs],
                                       live, [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and live else [None] * len(live))
        by_id = {id(p): g for p, g in zip(live, got)}
        return tuple(by_id.get(id(p)) if by_id.get(id(p)) is not None
                     else torch.zeros_like(p) for p in primals)

    out_vars, out_names = [], []
    for x, n in zip(inputs, input_names):
        gname = _new_var_name("%s@GRAD" % n)
        shape = x._stage_shape if isinstance(x, Variable) else tuple(x.shape)
        gv = Variable(program, gname, shape, x.dtype, device=x.device)
        program.vars[gname] = gv
        out_vars.append(gv)
        out_names.append(gname)
    refs = [("var" if n in program.vars else "cap", n)
            for n in ext_names + [c for c in ct_names if c is not None]]
    program.ops.append(OpRecord("gradients", grad_fn, {}, refs, out_names))
    program.version += 1
    return out_vars


class CompiledProgram:
    """reference: fluid/compiler.py CompiledProgram. The Executor runs
    its program (one card, no build strategies)."""

    def __init__(self, program, build_strategy=None):
        self.program = program

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        return self


class BuildStrategy:
    pass


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1


def cpu_places(device_count=None):
    from ..framework.place import CPUPlace
    return [CPUPlace(0)]


def cuda_places(device_ids=None):
    """The cards as CUDAPlaces (all of them by default)."""
    import torch
    from ..framework.place import CUDAPlace
    ids = (device_ids if device_ids is not None
           else range(torch.cuda.device_count()))
    return [CUDAPlace(i) for i in ids]


def device_places(device_ids=None):
    return cuda_places(device_ids)


def name_scope(prefix=None):
    return contextlib.nullcontext()
