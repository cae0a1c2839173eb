"""Execution mode (counterpart of paddle_tpu/framework/state.py).

The port runs dygraph only (the static graph is not ported), and its grad
mode is torch's own: `no_grad`, `is_grad_enabled` and `set_grad_enabled`
read and set torch's flag, with no second flag that could drift from it.
"""
from __future__ import annotations

import torch

__all__ = ["no_grad", "in_dygraph_mode", "is_grad_enabled",
           "set_grad_enabled"]


class no_grad(torch.no_grad):
    """paddle.no_grad: a context manager, and a decorator with or without
    the call (`@no_grad()`, `@no_grad`); torch's grad mode."""


def in_dygraph_mode() -> bool:
    return True


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode):
    """Sets grad mode at once; as a context manager, puts the old mode
    back on exit (the reference's guard)."""
    return torch.set_grad_enabled(bool(mode))
