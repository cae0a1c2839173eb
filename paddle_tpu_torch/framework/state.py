"""Execution mode (counterpart of paddle_tpu/framework/state.py).

Dygraph runs ops at once. `enable_static()` turns on the static graph:
from then on a registered op (framework/dispatch.py) that meets a static
`Variable`, or a trainable parameter, records itself into the current
Program (static/program.py) instead of running, until
`disable_static()`. The port's grad mode is torch's own: `no_grad`,
`is_grad_enabled` and `set_grad_enabled` read and set torch's flag, with
no second flag that could drift from it.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["no_grad", "in_dygraph_mode", "is_grad_enabled",
           "set_grad_enabled", "enable_static", "disable_static",
           "in_static_mode", "staging", "running_program"]

# static mode on; a registered op stages only while it is on and this
# thread runs no program (an Executor or a Predictor calls the recorded
# ops' own functions, which never stage)
_MODE = [False]
_RUNNING = threading.local()


class no_grad(torch.no_grad):
    """paddle.no_grad: a context manager, and a decorator with or without
    the call (`@no_grad()`, `@no_grad`); torch's grad mode."""


def enable_static():
    """paddle.enable_static: registered ops record into the current
    Program from here on."""
    _MODE[0] = True


def disable_static():
    _MODE[0] = False


def in_static_mode() -> bool:
    return _MODE[0]


def in_dygraph_mode() -> bool:
    return not _MODE[0]


def staging() -> bool:
    """A registered op records itself instead of running."""
    return _MODE[0] and not getattr(_RUNNING, "depth", 0)


@contextlib.contextmanager
def running_program():
    """Inside the block this thread's registered ops run, static mode or
    not: the interpreter of a Program runs the recorded ops' functions."""
    _RUNNING.depth = getattr(_RUNNING, "depth", 0) + 1
    try:
        yield
    finally:
        _RUNNING.depth -= 1


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode):
    """Sets grad mode at once; as a context manager, puts the old mode
    back on exit (the reference's guard)."""
    return torch.set_grad_enabled(bool(mode))
