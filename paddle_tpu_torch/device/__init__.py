"""paddle.device (counterpart of paddle_tpu/device/__init__.py): the
current device, the device count and the allocator's memory counters.

The reference reads PJRT's allocator; the port reads torch's CUDA caching
allocator (`torch.cuda.memory_allocated` and the rest). `device` is a
device name ("gpu:0", "cuda", "cpu"), a Place, an index or None (the
current place). A CPU device has no counters: its readings are 0, as the
reference's CPU reads 0. A CUDA device on a machine without CUDA raises
(`framework.device.resolve_device`).
"""
from __future__ import annotations

import torch

from ..framework.device import resolve_device
from ..framework.place import (get_device, is_compiled_with_cuda,
                               is_compiled_with_npu, is_compiled_with_rocm,
                               is_compiled_with_tpu, is_compiled_with_xpu,
                               set_device)

__all__ = ["get_device", "set_device", "get_device_count",
           "get_all_device_type", "memory_stats",
           "memory_allocated", "max_memory_allocated", "memory_reserved",
           "max_memory_reserved", "empty_cache", "synchronize", "cuda",
           "is_compiled_with_cuda",
           "is_compiled_with_rocm", "is_compiled_with_xpu",
           "is_compiled_with_npu", "is_compiled_with_tpu"]


def get_all_device_type():
    """The device types present, sorted: "cpu", and "gpu" with CUDA."""
    return sorted({"cpu"} | ({"gpu"} if torch.cuda.is_available() else set()))


def get_device_count(device_type=None):
    """The cards torch sees (0 without CUDA); 1 for "cpu"."""
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _cuda_device(device):
    """The torch device of `device`, or None for the CPU."""
    if isinstance(device, int):
        device = "cuda:%d" % device
    dev = resolve_device(device)
    return dev if dev.type == "cuda" else None


def memory_stats(device=None) -> dict:
    """The caching allocator's statistics ({} on the CPU)."""
    dev = _cuda_device(device)
    return {} if dev is None else dict(torch.cuda.memory_stats(dev))


def memory_allocated(device=None) -> int:
    """Bytes held by live tensors on the device."""
    dev = _cuda_device(device)
    return 0 if dev is None else int(torch.cuda.memory_allocated(dev))


def max_memory_allocated(device=None) -> int:
    """High-water mark of `memory_allocated`."""
    dev = _cuda_device(device)
    return 0 if dev is None else int(torch.cuda.max_memory_allocated(dev))


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds from CUDA."""
    dev = _cuda_device(device)
    return 0 if dev is None else int(torch.cuda.memory_reserved(dev))


def max_memory_reserved(device=None) -> int:
    dev = _cuda_device(device)
    return 0 if dev is None else int(torch.cuda.max_memory_reserved(dev))


def empty_cache():
    """Return the allocator's unused cached blocks to CUDA (nothing
    to do without CUDA)."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def synchronize(device=None):
    """Wait until the work queued on the device has run."""
    dev = _cuda_device(device)
    if dev is not None:
        torch.cuda.synchronize(dev)


class cuda:
    """paddle.device.cuda: the same counters."""

    memory_stats = staticmethod(memory_stats)
    memory_allocated = staticmethod(memory_allocated)
    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    max_memory_reserved = staticmethod(max_memory_reserved)
    empty_cache = staticmethod(empty_cache)
    synchronize = staticmethod(synchronize)

    @staticmethod
    def device_count():
        return get_device_count()
