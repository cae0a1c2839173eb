"""The static graph's Program (counterpart of paddle_tpu/static/program.py).

In static mode (`paddle.enable_static()`) each registered op that meets a
`Variable` or a trainable parameter records an `OpRecord` into the
current Program (framework/dispatch.py -> `stage_op` -> `Program.add_op`)
instead of running; a Program is that op list, with the tensors it
captured (parameters, buffers, constants) by identity.

A `Variable` is a tensor on the `meta` device: building a program
allocates nothing on the card. Its shape reports -1 on a dynamic axis
(staged as 1), as the reference's does; an op's output shape comes from
running the op's function on meta tensors, or, for an op whose function
cannot take them (a kernel wrapper, a random draw), from the input it
names (the op's `out_like`). Nothing is recorded at the torch level: a
torch function that meets a Variable outside a registered op raises,
naming the function, and so does one that reads a Variable's values
(`.item()`, a data-dependent shape), as the reference's `prim.dynamic`
check does. `torch.zeros_like` of a Variable gives a constant of the
staged shape on the program's device, as the reference folds it.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from ..framework.device import resolve_device
from ..framework.dtype import convert_dtype

__all__ = ["Variable", "OpRecord", "Program", "prune_ops", "data",
           "default_main_program", "default_startup_program",
           "reset_default_programs", "program_guard", "InputSpec",
           "extend_targets_with_aliases", "resolve_aliases_into_env"]

_var_counter = [0]


def _new_var_name(stem="var"):
    _var_counter[0] += 1
    return "%s_%d" % (stem, _var_counter[0])


def _zeros_like(v, dtype=None, device=None, **kwargs):
    return torch.zeros(v._stage_shape, dtype=dtype or v.dtype,
                       device=device or v.device)


# torch functions of a Variable's shape alone, folded to constants (BERT's
# token type ids)
_FOLD = {torch.zeros_like: _zeros_like}
# torch functions that read values
_READS = {"item", "tolist", "__bool__", "__float__", "__int__",
          "__index__", "__array__", "nonzero", "numpy"}


class Variable(torch.Tensor):
    """A symbolic tensor of a Program (reference: program.py Variable): a
    meta tensor with `name`, `program`, `is_data`, `dyn_axes`,
    `persistable` and `stop_gradient`. Its Python operators (`+ - * /
    // % ** @`, unary `-`, the comparisons, `[...]`) and its methods
    `reshape`, `transpose`, `mean` and `sum` record the reference's ops
    (elementwise_add, ..., equal, ..., getitem / getitem_dyn, reshape2,
    transpose2, reduce_mean, reduce_sum), as the surface's functions do;
    any other torch function raises."""

    def __new__(cls, program, name, shape, dtype, stop_gradient=True,
                is_data=False, dyn_axes=(), device=None):
        return torch.Tensor._make_subclass(
            cls, torch.empty(tuple(shape), dtype=dtype, device="meta"))

    def __init__(self, program, name, shape, dtype, stop_gradient=True,
                 is_data=False, dyn_axes=(), device=None):
        d = self.__dict__
        d["name"] = name
        d["program"] = program
        d["is_data"] = is_data
        d["dyn_axes"] = tuple(dyn_axes)
        d["persistable"] = False
        d["declared"] = False           # a static.data feed's dtype
        d["stop_gradient"] = bool(stop_gradient)
        d["_stage_shape"] = tuple(int(s) for s in shape)
        d["_dtype"] = dtype
        d["_device"] = resolve_device(device)

    # -- what torch would read through __torch_function__ ----------------
    @property
    def name(self):
        return self.__dict__["name"]

    @property
    def shape(self):
        s = list(self._stage_shape)
        for a in self.dyn_axes:
            s[a] = -1
        return s

    @property
    def ndim(self):
        return len(self._stage_shape)

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        """The device the program runs on: constants made from this
        Variable's shape are made there."""
        return self._device

    def _meta(self):
        return torch.empty(self._stage_shape, dtype=self._dtype,
                           device="meta")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fold = _FOLD.get(func)
        if fold is not None:
            return fold(*args, **kwargs)
        name = getattr(func, "__name__", None) or repr(func)
        if name in _READS:
            raise RuntimeError(
                "static graph: %s reads the values of a Variable, which "
                "has none until Executor.run; compute it eagerly or "
                "fetch it" % name)
        raise TypeError(
            "static graph: torch function %s met a Variable outside a "
            "registered op (framework/dispatch.py OPS); the port records "
            "registered ops only" % name)

    # -- the reference's tensor methods, as registered ops ----------------
    def __getitem__(self, index):
        from ..tensor import getitem
        return getitem(self, index)

    def reshape(self, *shape):
        from ..tensor import reshape
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = shape[0]
        return reshape(self, shape)

    def transpose(self, *perm):
        """transpose(perm) as the reference's, or torch's
        transpose(dim0, dim1) (the port's modules call it so)."""
        from ..tensor import transpose
        if len(perm) == 1:
            perm = perm[0]
        else:
            d0, d1 = (p % self.ndim for p in perm)
            order = list(range(self.ndim))
            order[d0], order[d1] = order[d1], order[d0]
            perm = order
        return transpose(self, perm)

    def mean(self, axis=None, keepdim=False):
        from ..tensor import mean
        return mean(self, axis, keepdim)

    def sum(self, axis=None, dtype=None, keepdim=False):
        from ..tensor import sum as sum_
        return sum_(self, axis, dtype, keepdim)

    def __neg__(self):
        from ..tensor import neg
        return neg(self)

    def numpy(self):
        raise RuntimeError(
            "Variable %s has no value in static mode; run it through "
            "Executor.run(fetch_list=[...])" % self.name)

    def __hash__(self):
        return id(self)

    def __repr__(self, *args, **kwargs):
        return "Variable(name=%s, shape=%s, dtype=%s)" % (
            self.name, self.shape, str(self._dtype).replace("torch.", ""))

    __str__ = __repr__


def _operator(fn_name, reverse=False):
    """A Python operator of a Variable: the surface function `fn_name`
    (tensor/__init__.py), which records its registered op."""
    def method(self, other):
        from .. import tensor
        fn = getattr(tensor, fn_name)
        return fn(other, self) if reverse else fn(self, other)
    method.__name__ = fn_name
    return method


for _dunder, _fn in (("add", "add"), ("sub", "subtract"),
                     ("mul", "multiply"), ("truediv", "divide"),
                     ("floordiv", "floor_divide"), ("mod", "remainder"),
                     ("pow", "pow"), ("matmul", "matmul")):
    setattr(Variable, "__%s__" % _dunder, _operator(_fn))
    setattr(Variable, "__r%s__" % _dunder, _operator(_fn, reverse=True))
for _dunder, _fn in (("eq", "equal"), ("ne", "not_equal"),
                     ("lt", "less_than"), ("le", "less_equal"),
                     ("gt", "greater_than"), ("ge", "greater_equal")):
    setattr(Variable, "__%s__" % _dunder, _operator(_fn))
del _dunder, _fn


class OpRecord:
    """One recorded op (reference: OpDesc): in_refs are ("var", name),
    ("cap", name) or ("const", value)."""

    __slots__ = ("fn", "attrs", "in_refs", "out_names", "op_type")

    def __init__(self, op_type, fn, attrs, in_refs, out_names):
        self.op_type = op_type
        self.fn = fn
        self.attrs = attrs
        self.in_refs = in_refs
        self.out_names = out_names


def extend_targets_with_aliases(targets, aliases):
    """Add each aliased target's surviving ref to `targets` (in place), so
    that a prune keeps it producible."""
    for name in list(targets):
        kind_ref = aliases.get(name)
        if kind_ref is not None and kind_ref[0] != "const":
            targets.add(kind_ref[1])
    return targets


def resolve_aliases_into_env(env, aliases):
    """Give the vars a pass removed their values in a finished run's env
    (in place): constants directly, var/cap refs from their value."""
    for name, (kind, ref) in aliases.items():
        if name not in env:
            if kind == "const":
                env[name] = ref
            elif ref in env:
                env[name] = env[ref]
    return env


def prune_ops(ops, targets):
    """Backward slice: the ops needed for `targets`, and the names they
    read (reference: Executor prune)."""
    needed = set(targets)
    kept = []
    for op in reversed(ops):
        if any(n in needed for n in op.out_names):
            kept.append(op)
            for kind, ref in op.in_refs:
                if kind in ("var", "cap"):
                    needed.add(ref)
    return list(reversed(kept)), needed


class Program:
    """reference: program.py Program: one implicit block, the recorded op
    list, the captured tensors by identity, the optimize directive, the
    buffers an op's outputs overwrite after a run (a training batch
    norm's running statistics) and the aliases removal passes leave."""

    def __init__(self):
        self.ops: List[OpRecord] = []
        self.vars: Dict[str, Variable] = {}
        self.captured: Dict[int, torch.Tensor] = {}
        self.capture_names: Dict[int, str] = {}
        self.version = 0
        self.optimize_directive = None      # (optimizer, loss Variable)
        self.buffer_updates: List[Tuple[torch.Tensor, str]] = []
        self._feed_order: List[str] = []
        self.aliases: Dict[str, Tuple[str, object]] = {}

    def global_block(self):
        return self

    def all_parameters(self):
        return [t for t in self.captured.values()
                if isinstance(t, torch.nn.Parameter) and t.requires_grad
                and getattr(t, "trainable", True)]

    def list_vars(self):
        return list(self.vars.values())

    def var(self, name):
        return self.vars[name]

    def clone(self, for_test=False):
        """A copy sharing the records; for_test turns dropout into
        identity and a training batch norm into its inference form, and
        drops the buffer updates (reference: Program.clone)."""
        from ..framework.dispatch import OPS
        p = Program()
        p.vars = dict(self.vars)
        p.captured = dict(self.captured)
        p.capture_names = dict(self.capture_names)
        p.version = self.version
        p._feed_order = list(self._feed_order)
        p.aliases = dict(self.aliases)
        if not for_test:
            p.ops = list(self.ops)
            p.buffer_updates = list(self.buffer_updates)
            return p
        for op in self.ops:
            if op.op_type == "dropout_op":
                p.ops.append(OpRecord("identity", OPS["identity"].fn, {},
                                      [op.in_refs[0]], [op.out_names[0]]))
            elif op.op_type == "batch_norm_train_stats":
                attrs = {k: v for k, v in op.attrs.items()
                         if k in ("epsilon", "channel_last")}
                p.ops.append(OpRecord("batch_norm_infer",
                                      OPS["batch_norm_infer"].fn, attrs,
                                      list(op.in_refs[:5]),
                                      [op.out_names[0]]))
            else:
                p.ops.append(op)
        p.version += 1
        return p

    def __repr__(self):
        lines = ["Program(%d ops)" % len(self.ops)]
        for op in self.ops:
            ins = ", ".join(r[1] if r[0] != "const" else repr(r[1])[:20]
                            for r in op.in_refs)
            lines.append("  %s = %s(%s)" % (", ".join(op.out_names),
                                            op.op_type, ins))
        return "\n".join(lines)

    # -- recording ---------------------------------------------------------
    def _capture(self, t: torch.Tensor) -> str:
        if id(t) not in self.captured:
            name = getattr(t, "name", None)
            if not isinstance(name, str) or name in self.vars \
                    or name in self.capture_names.values():
                name = _new_var_name("capture")
            self.captured[id(t)] = t
            self.capture_names[id(t)] = name
        return self.capture_names[id(t)]

    def add_op(self, prim, args, attrs):
        in_refs, metas = [], []
        dyn_batch = False
        device = None
        for a in args:
            if isinstance(a, Variable):
                in_refs.append(("var", a.name))
                metas.append(a._meta())
                dyn_batch = dyn_batch or 0 in a.dyn_axes
                device = device or a.device
            elif isinstance(a, torch.Tensor):
                if a.device.type == "meta":
                    raise TypeError(
                        "static graph: op %s got a meta tensor that is not "
                        "a Variable (a torch function's result on one)"
                        % prim.op_type)
                in_refs.append(("cap", self._capture(a)))
                metas.append(torch.empty(a.shape, dtype=a.dtype,
                                         device="meta"))
                device = device or a.device
            else:
                in_refs.append(("const", a))
                metas.append(a)
        if prim.out_like is not None:
            likes = (prim.out_like if isinstance(prim.out_like, tuple)
                     else (prim.out_like,))
            outs = tuple(torch.empty(metas[i].shape, dtype=metas[i].dtype,
                                     device="meta") for i in likes)
            if not isinstance(prim.out_like, tuple):
                outs = outs[0]
        else:
            try:
                with torch.no_grad():
                    outs = prim.fn(*metas, **attrs)
            except (NotImplementedError, RuntimeError) as e:
                raise RuntimeError(
                    "static graph: op %s cannot be recorded (its output "
                    "depends on values, or its function takes no meta "
                    "tensor): %s" % (prim.op_type, e)) from e
        single = not isinstance(outs, tuple)
        outs_t = (outs,) if single else outs
        out_names = [_new_var_name(prim.op_type) for _ in outs_t]
        self.ops.append(OpRecord(prim.op_type, prim.fn, dict(attrs), in_refs,
                                 out_names))
        self.version += 1
        stop = all(a.stop_gradient for a in args
                   if isinstance(a, Variable)) and not any(
            isinstance(a, torch.Tensor) and not isinstance(a, Variable)
            and a.requires_grad for a in args)
        out_vars = []
        for n, o in zip(out_names, outs_t):
            dyn = (0,) if (dyn_batch and o.ndim >= 1
                           and o.shape[0] == 1) else ()
            v = Variable(self, n, tuple(o.shape), o.dtype,
                         stop_gradient=stop, dyn_axes=dyn, device=device)
            self.vars[n] = v
            out_vars.append(v)
        return out_vars[0] if single else tuple(out_vars)


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def reset_default_programs():
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    prev_m, prev_s = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = prev_m, prev_s


def stage_op(prim, args, attrs):
    """The static-mode hook of a registered op: NotImplemented (run it
    now) when no input is a Variable or a trainable parameter, else the
    op recorded into the current program. An op on a parameter records
    too, so that a parameter's expression trains the parameter."""
    has_var = any(isinstance(a, Variable) for a in args)
    touches_param = any(isinstance(a, torch.Tensor)
                        and not isinstance(a, Variable) and a.requires_grad
                        for a in args)
    if not has_var and not touches_param:
        return NotImplemented
    return _main_program.add_op(prim, args, attrs)


def data(name, shape, dtype="float32", lod_level=0):
    """paddle.static.data: a fed Variable; a -1 (or None) axis is dynamic,
    staged as 1 and run at the fed size."""
    shape = list(shape)
    dyn_axes = [i for i, s in enumerate(shape) if s in (-1, None)]
    concrete = tuple(1 if s in (-1, None) else int(s) for s in shape)
    v = Variable(_main_program, name, concrete, convert_dtype(dtype),
                 stop_gradient=True, is_data=True, dyn_axes=dyn_axes)
    v.__dict__["declared"] = True
    _main_program.vars[name] = v
    _main_program._feed_order.append(name)
    return v


class InputSpec:
    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = shape
        self.dtype = dtype
        self.name = name
