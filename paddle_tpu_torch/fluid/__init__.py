"""paddle.fluid, the legacy namespace (counterpart of
paddle_tpu/fluid/__init__.py): pre-2.0 scripts written against `import
paddle.fluid as fluid` (Program / Executor / layers.fc / dygraph.guard)
run on the port's modules. Everything here delegates; nothing is a
second implementation.
"""
from __future__ import annotations

import contextlib

import numpy as np

from ..framework import state as _state
from ..framework.place import CPUPlace, CUDAPinnedPlace, CUDAPlace  # noqa: F401
from ..framework.tensor import to_tensor
from ..nn.layer_base import ParamAttr  # noqa: F401
from ..static import (Executor, Program, Scope,  # noqa: F401
                      default_main_program, default_startup_program,
                      global_scope)
from ..static import program_guard as _modern_program_guard
from ..static.program import data  # noqa: F401
from .. import nn  # noqa: F401
from ..nn import initializer  # noqa: F401
from .. import optimizer as _opt_mod
from . import dygraph, io, layers  # noqa: F401

__all__ = ["CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "Executor",
           "Program", "Scope", "ParamAttr", "data", "layers", "dygraph",
           "io", "initializer", "optimizer", "default_main_program",
           "default_startup_program", "program_guard", "global_scope",
           "scope_guard", "enable_dygraph", "disable_dygraph",
           "in_dygraph_mode", "is_compiled_with_cuda", "create_lod_tensor"]


class _OptimizerCompat:
    """fluid.optimizer.*: the classic names over the port's classes."""

    SGD = SGDOptimizer = _opt_mod.SGD
    Momentum = MomentumOptimizer = _opt_mod.Momentum
    Adagrad = AdagradOptimizer = _opt_mod.Adagrad
    Adam = AdamOptimizer = _opt_mod.Adam
    AdamW = _opt_mod.AdamW
    Adamax = AdamaxOptimizer = _opt_mod.Adamax
    Adadelta = AdadeltaOptimizer = _opt_mod.Adadelta
    RMSProp = RMSPropOptimizer = _opt_mod.RMSProp
    Lamb = LambOptimizer = _opt_mod.Lamb
    Ftrl = FtrlOptimizer = _opt_mod.Ftrl
    Dpsgd = DpsgdOptimizer = _opt_mod.Dpsgd
    LarsMomentum = LarsMomentumOptimizer = _opt_mod.Lars
    DecayedAdagrad = DecayedAdagradOptimizer = _opt_mod.DecayedAdagrad
    ProximalGD = ProximalGDOptimizer = _opt_mod.ProximalGD
    ProximalAdagrad = ProximalAdagradOptimizer = _opt_mod.ProximalAdagrad


optimizer = _OptimizerCompat


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """fluid 1.x ran in static mode: the guard turns static mode on for
    its scope, besides guarding the programs."""
    prev = _state.in_static_mode()
    _state.enable_static()
    try:
        with _modern_program_guard(main_program, startup_program):
            yield
    finally:
        if not prev:
            _state.disable_static()


@contextlib.contextmanager
def scope_guard(scope):
    """Scopes are implicit (values live on the captured tensors): kept for
    the API."""
    yield scope


def enable_dygraph(place=None):
    _state.disable_static()


def disable_dygraph():
    _state.enable_static()


def in_dygraph_mode():
    return not _state.in_static_mode()


def is_compiled_with_cuda():
    import torch
    return torch.cuda.is_available()


def create_lod_tensor(data_arr, recursive_seq_lens, place=None):
    """The flat data as a Tensor on `place`: LoD lengths travel separately
    (the sequence ops take padded data and lengths)."""
    return to_tensor(np.asarray(data_arr), place=place)
