"""Places and the current device (counterpart of
paddle_tpu/framework/place.py).

The reference's places name JAX devices; the port's name torch devices.
Its accelerator is the CUDA card: `CUDAPlace` is the accelerator place,
and the reference's other accelerator spellings (`TPUPlace`, `XPUPlace`,
`NPUPlace`, and "tpu", "xpu", "npu" in `set_device`) map to it, as the
reference maps "gpu" and `CUDAPlace` onto its TPU. `CUDAPinnedPlace` is
host memory.

The default place is "gpu:0" whether or not the machine has CUDA: unlike
the reference, which falls back to the CPU when it finds no accelerator,
the port never moves to the CPU unless the caller chose it
(`set_device("cpu")`, or a `place=` / `device=` argument). Code that needs
the device then raises (`framework.device.resolve_device`).
"""
from __future__ import annotations

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "NPUPlace", "get_place", "set_device", "get_device",
           "is_compiled_with_cuda", "is_compiled_with_rocm",
           "is_compiled_with_xpu", "is_compiled_with_npu",
           "is_compiled_with_tpu"]


class Place:
    """Base class of device identities."""

    _kind = "undefined"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return "Place(%s:%d)" % (self._kind, self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Place) and self._kind == other._kind
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self._kind, self.device_id))

    def torch_name(self) -> str:
        """The torch device string of this place ("cpu", "cuda",
        "cuda:1"): card 0 is "cuda", the current card, as every entry
        point of the port names it."""
        raise ValueError("place %r has no torch device" % (self,))


class CPUPlace(Place):
    _kind = "cpu"

    def torch_name(self):
        return "cpu"


class CUDAPlace(Place):
    _kind = "gpu"

    def torch_name(self):
        return "cuda" if self.device_id == 0 else "cuda:%d" % self.device_id


class CUDAPinnedPlace(CPUPlace):
    pass


# the reference's accelerator spellings, mapped to the port's accelerator
class TPUPlace(CUDAPlace):
    pass


class XPUPlace(CUDAPlace):
    pass


class NPUPlace(CUDAPlace):
    pass


_current_place = None


def get_place() -> Place:
    """The current place: "gpu:0" until `set_device` chose another."""
    global _current_place
    if _current_place is None:
        _current_place = CUDAPlace(0)
    return _current_place


def set_device(device) -> Place:
    """paddle.device.set_device parity: "cpu", "gpu", "gpu:1", "cuda:0",
    and the reference's "tpu", "xpu", "npu" for the accelerator; or a
    Place. Raises ValueError on any other name."""
    global _current_place
    if isinstance(device, Place):
        _current_place = device
        return _current_place
    name, _, idx = str(device).partition(":")
    idx = int(idx) if idx else 0
    name = name.lower()
    if name == "cpu":
        _current_place = CPUPlace(idx)
    elif name in ("gpu", "cuda", "tpu", "xpu", "npu"):
        _current_place = CUDAPlace(idx)
    else:
        raise ValueError("unknown device %r" % (device,))
    return _current_place


def get_device() -> str:
    """"gpu:0", "cpu:0", ...: the current place as the reference writes
    it."""
    p = get_place()
    return "%s:%d" % (p._kind, p.device_id)


def is_compiled_with_cuda() -> bool:
    """True when the installed torch is built for CUDA (whether or not a
    card is present)."""
    import torch
    return torch.version.cuda is not None


def is_compiled_with_rocm() -> bool:
    import torch
    return getattr(torch.version, "hip", None) is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False
