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

Not ported yet (ROADMAP.md): the control flow (`cond`, `while_loop`,
`case`, `switch_case`), `append_backward` / `gradients`, `static.nn`,
`static.sparsity`, the dataset trainers.
"""
from __future__ import annotations

import contextlib

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
           "device_places", "name_scope"]


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
