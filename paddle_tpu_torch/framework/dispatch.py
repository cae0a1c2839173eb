"""The registry of named ops (counterpart of paddle_tpu/framework/dispatch.py:
`OPS`, `primitive`).

The reference runs every op through its dispatcher, which unwraps
tensors, jits the op and tapes it for autograd; in static mode it hands
the call to `static/program.py` `stage_op`, which records it into the
current Program. The port's ops are plain PyTorch and torch autograd
tapes them, so the port keeps only the registry and the staging hook:

  * `@primitive(name)` registers a function under the reference's op type
    name, with the reference's attrs as keyword arguments (attrs that
    only matter to XLA or Pallas are taken and ignored by the function);
  * in dygraph a call checks one flag and calls the function straight
    through: no wrapping, no copy, the same kernels;
  * while static mode is on (`framework.state.enable_static`), a call
    whose inputs hold a static `Variable` or a trainable parameter records
    an `OpRecord(op_type, fn, attrs, in_refs, out_names)` into the current
    Program and returns its output Variables; any other call runs at once
    (a constant folded when the program is built).

A saved program names its ops by type, so `OPS` is also what
`static.load_inference_model` resolves a `.pdmodel` against, the
reference's artifacts included.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from .state import _MODE, staging

__all__ = ["OPS", "primitive"]

# op type -> the registered op: a function with `op_type`, `fn` (the
# function it calls) and `out_like` (see `primitive`)
OPS: Dict[str, Callable] = {}


def _detached(fn):
    def run(*args, **attrs):
        out = fn(*args, **attrs)
        if isinstance(out, tuple):
            return tuple(o.detach() if isinstance(o, torch.Tensor) else o
                         for o in out)
        return out.detach() if isinstance(out, torch.Tensor) else out
    return functools.update_wrapper(run, fn)


def primitive(name: str, out_like=None,
              nondiff: bool = False):
    """Decorator registering `fn` as the op `name` (see the module's
    note). `out_like`: the index of the input whose shape and dtype the
    output has, for an op whose function cannot run on meta tensors (a
    kernel wrapper, a random draw); else a recorded op's output shape
    comes from running `fn` on meta tensors; a tuple of indices, one an
    output, for an op of several outputs. `nondiff`: the outputs are
    detached, as the reference's nondiff ops give no gradient."""

    def deco(fn):
        if nondiff:
            fn = _detached(fn)
        def op(*args, **attrs):
            if _MODE[0] and staging():
                from ..static.program import stage_op
                out = stage_op(op, args, attrs)
                if out is not NotImplemented:
                    return out
            return fn(*args, **attrs)

        functools.update_wrapper(op, fn)
        op.op_type, op.fn, op.out_like = name, fn, out_like
        op.nondiff = nondiff
        OPS[name] = op
        return op

    return deco
