"""Tensor functions of the ported paths (counterpart of paddle_tpu/tensor,
whose ResNet imports `flatten` from here)."""
from __future__ import annotations

__all__ = ["flatten"]


def flatten(x, start_axis=0, stop_axis=-1):
    """Axes start_axis..stop_axis merged into one (reference:
    ops/manipulation.py flatten :66); a 0-d input becomes [1]."""
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return x.reshape(tuple(x.shape[:s]) + (-1,) + tuple(x.shape[e + 1:]))
