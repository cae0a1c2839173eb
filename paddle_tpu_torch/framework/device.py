"""Device resolution (counterpart of paddle_tpu/framework/place.py).

Every entry point of the port takes a `device` that defaults to the
current place (`place.set_device`), "gpu:0" unless the caller chose
another. Asking for CUDA on a machine without it is an error, never a
silent move to the CPU: the CPU is used only when the caller names it.

`write_values` fills a small device tensor from host numbers in stream
order without waiting for the device: the per-step values a captured train
step reads from device memory (the Philox word, the optimizer's lr and
bias corrections).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .place import Place, get_place

__all__ = ["resolve_device", "write_values"]


def resolve_device(device=None) -> torch.device:
    """The torch device of `device`: a torch device or its name, a Place,
    the reference's "gpu" / "gpu:N" for the card, or None for the current
    place (`place.set_device`; "gpu:0" unless the caller chose another)."""
    if device is None:
        device = get_place()
    if isinstance(device, Place):
        device = device.torch_name()
    elif isinstance(device, str) and device.split(":")[0] == "gpu":
        device = "cuda" + device[3:]
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (device,))
    return dev


# pinned host slots a device's small writes go through, by (device,
# dtype, numel): (pinned tensor, event of its last copy) each, used in turn
_SLOTS_PER_KEY = 8
_slots: Dict[tuple, List[tuple]] = {}
_turn: Dict[tuple, int] = {}


def write_values(dst: torch.Tensor, values: Sequence):
    """dst[:] = values (host numbers), as dst's next use on the current
    stream sees them. On CUDA the numbers go into one of a few pinned
    slots and from there by a non-blocking copy on the current stream: a
    blocking host-to-device copy would make the host wait for the work
    already queued. A slot is reused only after its last copy has run (its
    event). Never during a CUDA graph capture: the values are the host's
    per-call state, written before a replay, not recorded in it."""
    vals = np.asarray(values).astype(
        torch.empty((), dtype=dst.dtype).numpy().dtype).reshape(dst.shape)
    if dst.device.type != "cuda":
        dst.copy_(torch.from_numpy(vals))
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("write_values during a CUDA graph capture: the "
                           "host writes per-step values before a replay")
    key = (dst.device, dst.dtype, dst.numel())
    ring = _slots.get(key)
    if ring is None:
        ring = _slots[key] = [
            (torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True),
             torch.cuda.Event()) for _ in range(_SLOTS_PER_KEY)]
        _turn[key] = 0
    host, event = ring[_turn[key]]
    _turn[key] = (_turn[key] + 1) % _SLOTS_PER_KEY
    event.synchronize()                 # returns at once if never recorded
    host.numpy()[...] = vals
    dst.copy_(host, non_blocking=True)
    event.record(torch.cuda.current_stream(dst.device))
