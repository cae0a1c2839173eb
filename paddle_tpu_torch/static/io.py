"""Static-graph model files (counterpart of paddle_tpu/static/io.py:
`save_inference_model`, `load_inference_model`, `save`, `load`).

The files have the reference's layout: a `.pdmodel` pickle holds `ops`
(op type, attrs, in_refs, out_names), `feed_names`, `fetch_names` and
`aliases`; a `.pdiparams` (or, for `save`, `.pdparams`) pickle maps
names to numpy arrays. So the reference's artifacts load here, and the
port's there. Every read goes through `_load_pickle`, whose unpickler
admits only numpy's array classes and plain Python values: loading never
imports the JAX package (or anything else), and a `.pdmodel` whose op
type is not in the registry (framework/dispatch.py OPS) raises, naming
the op. A bfloat16 capture is written as float32, widened exactly (numpy
has no bfloat16).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.dispatch import OPS
from ..framework.dtype import convert_dtype
from .program import (OpRecord, Program, Variable, default_main_program,
                      extend_targets_with_aliases, prune_ops)

__all__ = ["save_inference_model", "load_inference_model", "save", "load"]

# plain Python values a program's attrs hold
_BUILTINS = {"slice", "tuple", "list", "dict", "set", "frozenset", "int",
             "float", "bool", "str", "bytes", "complex", "range",
             "NoneType", "Ellipsis"}


class _Unpickler(pickle.Unpickler):
    """Admits numpy's arrays, dtypes and scalars and plain Python values;
    any other global raises."""

    def find_class(self, module, name):
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if module in ("numpy", "numpy.core.multiarray",
                      "numpy._core.multiarray", "numpy.core.numeric",
                      "numpy._core.numeric") and name in (
                          "ndarray", "dtype", "_reconstruct", "scalar",
                          "_frombuffer"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            "a program file may hold numpy arrays and plain values only, "
            "not %s.%s" % (module, name))


def _load_pickle(path):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _program_payload(program, feed_vars, fetch_vars):
    aliases = dict(program.aliases)
    targets = extend_targets_with_aliases({v.name for v in fetch_vars},
                                          aliases)
    kept, needed = prune_ops(program.ops, targets)
    ops = [{"op_type": op.op_type, "fn_name": op.op_type,
            "attrs": op.attrs, "in_refs": op.in_refs,
            "out_names": op.out_names} for op in kept]
    caps = {program.capture_names[i]: _host(t)
            for i, t in program.captured.items()
            if program.capture_names[i] in needed}
    return {"ops": ops, "captures": caps,
            "feed_names": [v.name for v in feed_vars],
            "fetch_names": [v.name for v in fetch_vars],
            "aliases": aliases}


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, optimize=True, **kwargs):
    """Write `path_prefix`.pdmodel and .pdiparams: the ops that
    `fetch_vars` need and the tensors they read. With optimize (the
    default) the inference fusion passes run on a clone first
    (passes.py `apply_inference_fusion`, the fetches protected). Returns
    the program written."""
    program = program or default_main_program()
    if not isinstance(feed_vars, (list, tuple)):
        feed_vars = [feed_vars]
    if not isinstance(fetch_vars, (list, tuple)):
        fetch_vars = [fetch_vars]
    if optimize:
        from .passes import apply_inference_fusion
        program = apply_inference_fusion(
            program, protected={v.name for v in fetch_vars})
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _program_payload(program, feed_vars, fetch_vars)
    with open(path_prefix + ".pdmodel", "wb") as f:
        pickle.dump({k: payload[k] for k in ("ops", "feed_names",
                                             "fetch_names", "aliases")}, f)
    with open(path_prefix + ".pdiparams", "wb") as f:
        pickle.dump(payload["captures"], f)
    return program


def load_inference_model(path_prefix, executor=None, device=None, **kwargs):
    """(program, feed_names, fetch_names) from `path_prefix`.pdmodel and
    .pdiparams, this package's or the reference's; the captured arrays
    become tensors on `device` (default the executor's place, else the
    current place)."""
    if device is None and executor is not None:
        device = executor.device
    dev = resolve_device(device)
    meta = _load_pickle(path_prefix + ".pdmodel")
    caps = _load_pickle(path_prefix + ".pdiparams")
    missing = sorted({rec["op_type"] for rec in meta["ops"]} - set(OPS))
    if missing:
        raise KeyError("the program uses ops this package has not "
                       "registered: %s" % ", ".join(missing))
    program = Program()
    for name, arr in caps.items():
        t = torch.from_numpy(np.array(arr)).to(dev)
        t.persistable = True
        program.captured[id(t)] = t
        program.capture_names[id(t)] = name
    for rec in meta["ops"]:
        program.ops.append(OpRecord(rec["op_type"], OPS[rec["op_type"]].fn,
                                    dict(rec["attrs"]), list(rec["in_refs"]),
                                    list(rec["out_names"])))
        program.version += 1
    # feeds and outputs as Variables of unknown shape (known when fed)
    for n in meta["feed_names"]:
        program.vars[n] = Variable(program, n, (), convert_dtype("float32"),
                                   is_data=True, device=dev)
        program._feed_order.append(n)
    for op in program.ops:
        for n in op.out_names:
            program.vars.setdefault(n, Variable(
                program, n, (), convert_dtype("float32"), device=dev))
    program.aliases = dict(meta.get("aliases", {}))
    return program, list(meta["feed_names"]), list(meta["fetch_names"])


def _persistables(program):
    updated = {id(b) for b, _ in program.buffer_updates}
    return {program.capture_names[i]: t
            for i, t in program.captured.items()
            if t.requires_grad or getattr(t, "persistable", False)
            or i in updated}


def save(program, model_path, protocol=4):
    """`model_path`.pdparams: the program's persistables (trainable
    parameters, persistable tensors and the buffers its runs update, a
    batch norm's running statistics) by name, as numpy arrays."""
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump({n: _host(t) for n, t in _persistables(program).items()},
                    f, protocol=protocol)


def load(program, model_path, executor=None, var_list=None):
    """Copy the values of `model_path`.pdparams into the program's
    captured tensors of the same names, in place (a built program keeps
    its tensors' addresses)."""
    values = _load_pickle(model_path + ".pdparams")
    by_name = {program.capture_names[i]: t
               for i, t in program.captured.items()}
    with torch.no_grad():
        for name, arr in values.items():
            t = by_name.get(name)
            if t is not None:
                t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))
