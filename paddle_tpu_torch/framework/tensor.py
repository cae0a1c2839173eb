"""The user-facing Tensor (counterpart of paddle_tpu/framework/tensor.py:
`Tensor` :31, `Parameter` :249, `to_tensor` :281).

The reference's Tensor wraps a jax array. The port's is a `torch.Tensor`
subclass that adds the reference's methods (`numpy`, `stop_gradient`,
`astype`, `cast`, `place`, `clear_gradient`, `set_value`, ...) and turns
torch's function dispatch off for itself
(`__torch_function__ = torch._C._disabled_torch_function_impl`): an op on
a port Tensor runs as on a plain tensor and returns a plain
`torch.Tensor`, so the modules and the captured CUDA graphs only ever see
plain tensors and pay nothing per op. What user code gets back is
wrapped at the boundary: `to_tensor` makes a Tensor leaf, and the train
and eval steps' loss and outputs, `paddle.grad`'s gradients and
`PyLayer`'s outputs are `Tensor.wrap` views (`as_subclass`: no copy,
still in the autograd graph).

Differences by design (each with its test in tests/test_torch_framework.py):
- `shape` is a `torch.Size` (a tuple), not the reference's list, and
  `size` is torch's method, not the reference's element count (`numel()`
  is the count on both);
- `dtype` is a torch dtype (`paddle.float32 is torch.float32`), which does
  not compare equal to its name;
- `numpy()` of a bfloat16 tensor is float32 (widened exactly): numpy has
  no bfloat16 without ml_dtypes;
- the result of an op on a Tensor is a plain `torch.Tensor` (torch's
  methods; wrap it with `Tensor.wrap` for the reference's).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .dtype import convert_dtype, dtype_name, get_default_dtype
from .place import CPUPlace, CUDAPlace
from .selected_rows import SelectedRows, grad_view

__all__ = ["Tensor", "Parameter", "to_tensor"]


class Tensor(torch.Tensor):
    """paddle.Tensor on a torch tensor: torch's methods plus the
    reference's. `stop_gradient` is `not requires_grad` (True by default,
    as in paddle)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def wrap(t):
        """`t` as a port Tensor: a view that shares its storage and its
        place in the autograd graph; None and Tensors pass through."""
        if t is None or isinstance(t, Tensor):
            return t
        return t.as_subclass(Tensor)

    # -- metadata -----------------------------------------------------------
    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not bool(value))

    @property
    def place(self):
        if self.device.type == "cuda":
            return CUDAPlace(self.device.index or 0)
        return CPUPlace(0)

    # -- grad ---------------------------------------------------------------
    @property
    def grad(self):
        """The gradient as a Tensor, or a SelectedRows where it is
        row-sparse (an embedding looked up with sparse=True)."""
        g = grad_view(torch.Tensor.grad.__get__(self))
        return g if isinstance(g, SelectedRows) else Tensor.wrap(g)

    @grad.setter
    def grad(self, value):
        torch.Tensor.grad.__set__(self, value)

    def backward(self, grad_tensor=None, retain_graph=False):
        """The reference's signature: `grad_tensor` seeds a non-scalar
        output; torch autograd accumulates into the leaves' `grad`."""
        torch.Tensor.backward(self, gradient=grad_tensor,
                              retain_graph=bool(retain_graph))

    def clear_gradient(self, set_to_zero=False):
        g = torch.Tensor.grad.__get__(self)
        if set_to_zero and g is not None and not g.is_sparse:
            g.detach_().zero_()
        else:
            self.grad = None

    def detach(self):
        return Tensor.wrap(torch.Tensor.detach(self))

    def clone(self, *args, **kwargs):
        return Tensor.wrap(torch.Tensor.clone(self, *args, **kwargs))

    # -- host interop -------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy (from the card when the tensor lies there); bfloat16
        comes back as float32, widened exactly."""
        t = torch.Tensor.detach(self)
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = torch.Tensor.numpy(torch.Tensor.cpu(t))
        return a.copy() if self.device.type == "cpu" else a

    def item(self, *args):
        """A Python number: the only element, or the element at a flat
        index or an index tuple (the reference's `item(*args)`)."""
        if args:
            return self.numpy().item(*args)
        return torch.Tensor.item(self)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self, *, tensor_contents=None):
        return ("Tensor(shape=%s, dtype=%s, place=%r, stop_gradient=%s,\n"
                "       %s)" % (list(self.shape), dtype_name(self.dtype),
                                self.place, self.stop_gradient,
                                np.array2string(self.numpy(),
                                                prefix="       ")))

    # -- dtype/device moves -------------------------------------------------
    def astype(self, dtype):
        return Tensor.wrap(torch.Tensor.to(self, convert_dtype(dtype)))

    def cast(self, dtype):
        return self.astype(dtype)

    def cpu(self, *args, **kwargs):
        return Tensor.wrap(torch.Tensor.cpu(self, *args, **kwargs))

    def cuda(self, *args, **kwargs):
        return Tensor.wrap(torch.Tensor.cuda(self, *args, **kwargs))

    def set_value(self, value):
        """Overwrite the values in place (no gradient), in this tensor's
        dtype; `value` (array, list or tensor) must have its shape."""
        src = (value.detach() if isinstance(value, torch.Tensor)
               else torch.from_numpy(np.array(value)))
        if tuple(src.shape) != tuple(self.shape):
            raise ValueError("set_value: shape %s into a tensor of shape %s"
                             % (list(src.shape), list(self.shape)))
        with torch.no_grad():
            torch.Tensor.copy_(self, src.to(self.dtype))
        return self


class Parameter(Tensor, torch.nn.Parameter):
    """A trainable tensor (reference: ParamBase): `trainable=True` gives
    `stop_gradient=False`; a `torch.nn.Parameter`, so a module registers
    it."""

    def __new__(cls, data, dtype=None, name=None, trainable=True):
        t = to_tensor(data, dtype=dtype,
                      place=data.device if isinstance(data, torch.Tensor)
                      else None)
        return torch.Tensor._make_subclass(cls, torch.Tensor.detach(t),
                                           bool(trainable))

    def __init__(self, data, dtype=None, name=None, trainable=True):
        self.name = name
        self.trainable = bool(trainable)
        self.persistable = True

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            memo[id(self)] = Parameter(torch.Tensor.clone(self).detach(),
                                       name=self.name,
                                       trainable=self.trainable)
        return memo[id(self)]

    def __reduce_ex__(self, proto):
        return (Parameter, (torch.Tensor.detach(self), None, self.name,
                            self.trainable))

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def _host_array(data, dtype):
    """Python data or a numpy array -> a CPU torch tensor, a copy: the
    dtype asked for, else numpy's, with float64 taken to the default
    dtype (the reference's `_to_array`)."""
    a = np.asarray(data)
    if dtype is None and a.dtype == np.float64:
        dtype = convert_dtype(get_default_dtype())
    if a.dtype == object:
        raise TypeError("to_tensor: cannot convert %r" % (type(data),))
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor: a new Tensor leaf holding a copy of `data` on
    `place` (a Place, a device name, or None for the current place: the
    card unless `set_device("cpu")`; raises without CUDA). A Python float
    or a float64 array becomes the default dtype (float32);
    `stop_gradient=True` by default; a tensor's gradient, if any, is not
    carried."""
    dev = resolve_device(place)
    dtype = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = torch.Tensor.detach(data)
        t = t.to(device=dev, dtype=dtype or t.dtype, copy=True)
    else:
        t = _host_array(data, dtype).to(dev)
    grad = not stop_gradient and (t.is_floating_point() or t.is_complex())
    return torch.Tensor._make_subclass(Tensor, t, grad)
