"""paddle.autograd (counterpart of paddle_tpu/autograd/__init__.py):
`backward` :31, `PyLayer` with `PyLayerContext` :46-73, and the
functional transforms `vjp`, `jvp`, `jacobian`, `hessian`, `Jacobian`,
`Hessian` :208-292.

The reference builds PyLayer on a jax custom_vjp recorded on its tape and
the transforms on jax.vjp/jvp/jacrev/hessian; the port builds PyLayer on
`torch.autograd.Function` and the transforms on
`torch.autograd.functional`. `func` is called with the port's Tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.autograd.functional as taf

from ..framework.autograd import backward as _backward
from ..framework.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "backward", "vjp", "jvp",
           "jacobian", "hessian", "Jacobian", "Hessian"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """reference: autograd/backward_mode.py backward(): one backward over
    each tensor of `tensors`, seeded by `grad_tensors`."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, torch.Tensor):
        grad_tensors = [grad_tensors]
    for i, (t, g) in enumerate(zip(tensors, grad_tensors)):
        _backward(t, g, retain_graph=retain_graph or i + 1 < len(tensors))


class PyLayerContext:
    """What `forward` hands to `backward` (reference: py_layer.py
    PyLayerContext). Tensors saved with `save_for_backward` go through
    torch's saved-tensor checks; any other object is kept as it is."""

    def __init__(self, ctx=None):
        self._ctx = ctx
        self._saved: Tuple = ()
        self._torch_saved = False

    def save_for_backward(self, *tensors):
        if self._ctx is not None and all(isinstance(t, torch.Tensor)
                                         for t in tensors):
            self._ctx.save_for_backward(*tensors)
            self._torch_saved = True
        else:
            self._saved = tuple(tensors)

    def saved_tensor(self):
        if self._torch_saved:
            return tuple(Tensor.wrap(t) for t in self._ctx.saved_tensors)
        return self._saved

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *args):
        if self._ctx is not None:
            self._ctx.mark_non_differentiable(*args)

    def set_materialize_grads(self, value: bool):
        if self._ctx is not None:
            self._ctx.set_materialize_grads(bool(value))


def _function_of(cls):
    """The `torch.autograd.Function` behind a PyLayer class, made once."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(ctx, kwargs, *args):
        pctx = ctx.pctx = PyLayerContext(ctx)
        ctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
        full = [Tensor.wrap(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        return cls.forward(pctx, *full, **kwargs)

    def backward(ctx, *grads):
        gouts = cls.backward(ctx.pctx, *(Tensor.wrap(g) for g in grads))
        if not isinstance(gouts, (tuple, list)):
            gouts = (gouts,)
        n = sum(ctx.tensor_args)
        if len(gouts) != n:
            raise RuntimeError("%s.backward returned %d grads for %d tensor "
                               "inputs" % (cls.__name__, len(gouts), n))
        it = iter(gouts)
        return (None,) + tuple(next(it) if is_t else None
                               for is_t in ctx.tensor_args)

    fn = type(cls.__name__ + "Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    cls._torch_function = fn
    return fn


class PyLayer:
    """A custom forward/backward op (reference: py_layer.py PyLayer):

        class cus_tanh(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = torch.tanh(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                y, = ctx.saved_tensor()
                return dy * (1 - y.square())

        y = cus_tanh.apply(x)

    `backward` returns one gradient for each tensor input (None for no
    gradient). Runs eagerly and inside a captured step alike: it is a
    `torch.autograd.Function`."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        out = _function_of(cls).apply(kwargs, *args)
        if isinstance(out, tuple):
            return tuple(Tensor.wrap(o) for o in out)
        return Tensor.wrap(out)


# ---------------------------------------------------------------------------
# functional transforms (reference: autograd/functional.py)


def _as_tuple(x):
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _wrap(x):
    if isinstance(x, (tuple, list)):
        return tuple(_wrap(v) for v in x)
    return Tensor.wrap(x)


def _tensor_fn(func):
    def fn(*xs):
        return func(*(Tensor.wrap(x) for x in xs))
    return fn


def vjp(func, xs, v=None):
    """(outputs, vjp): the vector-Jacobian product of `func` at `xs` with
    `v` (ones where None); one gradient, or a tuple for several xs."""
    xs = _as_tuple(xs)
    outs = func(*(Tensor.wrap(x) for x in xs))
    multi = isinstance(outs, (tuple, list))
    if v is None:
        v = tuple(torch.ones_like(o) for o in outs) if multi \
            else torch.ones_like(outs)
    elif not multi:
        v = _as_tuple(v)[0]
    outs, gs = taf.vjp(_tensor_fn(func), xs, v)
    gs = _as_tuple(gs)
    return _wrap(outs), (_wrap(gs) if len(gs) > 1 else _wrap(gs[0]))


def jvp(func, xs, v=None):
    """(outputs, jvp): the Jacobian-vector product of `func` at `xs` with
    the tangents `v` (ones where None)."""
    xs = _as_tuple(xs)
    v = tuple(torch.ones_like(x) for x in xs) if v is None else _as_tuple(v)
    outs, tans = taf.jvp(_tensor_fn(func), xs, v)
    return _wrap(outs), _wrap(tans)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """The dense Jacobian, [*out.shape, *x.shape] for one x and one output;
    a tuple by input (and by output) otherwise, as the reference's jacrev
    gives it."""
    xs = _as_tuple(xs)
    jac = taf.jacobian(_tensor_fn(func), xs, create_graph=create_graph,
                       strict=False)
    w = _wrap(jac)
    if len(xs) == 1 and isinstance(w, tuple) and len(w) == 1:
        return w[0]
    return w


def hessian(func, xs, create_graph=False, allow_unused=False):
    """The dense Hessian of a scalar function: [*x.shape, *x.shape] for one
    x, nested tuples by input pair otherwise."""
    xs = _as_tuple(xs)
    hess = taf.hessian(_tensor_fn(func), xs, create_graph=create_graph,
                       strict=False)
    w = _wrap(hess)
    if len(xs) == 1:
        while isinstance(w, tuple) and len(w) == 1:
            w = w[0]
    return w


class Jacobian:
    """The Jacobian as an indexable object (reference: functional.py
    Jacobian)."""

    def __init__(self, func, xs, is_batched=False):
        self._j = jacobian(func, xs)

    def __getitem__(self, idx):
        return self._j[idx] if isinstance(self._j, tuple) else \
            self._j.__getitem__(idx)

    @property
    def shape(self):
        return self._j.shape


class Hessian:
    """The Hessian as an indexable object (reference: functional.py
    Hessian)."""

    def __init__(self, func, xs, is_batched=False):
        self._h = hessian(func, xs)

    def __getitem__(self, idx):
        return self._h[idx] if isinstance(self._h, tuple) else \
            self._h.__getitem__(idx)

    @property
    def shape(self):
        return self._h.shape
