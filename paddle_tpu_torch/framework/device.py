"""Device resolution (counterpart of paddle_tpu/framework/place.py).

Every entry point of the port takes an explicit `device` that defaults to
"cuda". Asking for CUDA on a machine without it is an error, never a
silent move to the CPU: the CPU is used only when the caller names it.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (device,))
    return dev
