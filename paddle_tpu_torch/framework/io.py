"""paddle.save / paddle.load (the port's copy of paddle_tpu/framework/io.py:
pickled state dicts in the reference's layout, so that each package loads
the other's `.pdparams` / `.pdopt` files).

A tensor is pickled as the reference pickles its Tensor:
{"__paddle_tpu_tensor__": True, "data": <numpy array>, "name": ...,
"stop_gradient": ...}; dicts, lists and tuples nest. `save` is atomic and
durable (tmp file, fsync, rename, fsync of the directory), and `load`
unpickles through the reference's allowlist (`_RestrictedUnpickler`):
numpy array reconstruction, the ml_dtypes scalar types and a few plain
builtins resolve, anything else (`os.system`, arbitrary classes) raises
UnpicklingError instead of running.

bfloat16 (and the float8 types) without ml_dtypes: the reference pickles
such an array as numpy's reconstruction of an ndarray whose dtype is
`numpy.dtype(ml_dtypes.bfloat16)`. The port never imports ml_dtypes. Its
unpickler resolves the ml_dtypes type to a stand-in, and an array of that
dtype to a torch tensor made from the array's raw 2-byte words
(`torch.frombuffer`, as the checkpoint store reads them). Its pickler
writes the same opcodes the reference's numpy writes for such an array
(the global `ml_dtypes.bfloat16` by name, the raw words as the array's
bytes), so the reference loads a port bfloat16 tensor as a bfloat16
array. `load(..., return_numpy=True)` gives numpy arrays for every dtype
numpy has; a bfloat16 or float8 entry comes back as a CPU torch tensor of
that dtype (numpy has none).
"""
from __future__ import annotations

import io as _io
import os
import pickle

import numpy as np
import torch

from .device import resolve_device

__all__ = ["save", "load", "restricted_pickle_load"]

#: (module, name) pairs load() will resolve; everything else is refused.
_SAFE_GLOBALS = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("collections", "OrderedDict"),
    ("builtins", "complex"),
    ("builtins", "bytearray"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "slice"),
    ("builtins", "range"),
}

# the ml_dtypes types numpy lacks, by name, as torch dtypes
_TORCH_ONLY = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}
_ML_NAME = {v: k for k, v in _TORCH_ONLY.items()}


# ---------------------------------------------------------------- reading


class _MLType:
    """Stands for the global `ml_dtypes.<name>` while unpickling."""

    def __init__(self, name):
        self.name = name


class _MLDtype:
    """Stands for `numpy.dtype(ml_dtypes.<name>)` while unpickling; the
    dtype's own state (byte order, sizes) is read and dropped."""

    def __init__(self, name):
        self.name = name

    def __setstate__(self, state):
        pass


def _from_words(raw, dtype, shape, fortran=False) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if not raw:
        return torch.empty(shape, dtype=dtype)
    flat = torch.frombuffer(bytearray(raw), dtype=dtype)
    if fortran:
        return flat.reshape(shape[::-1]).permute(
            *reversed(range(len(shape)))).contiguous()
    return flat.reshape(shape)


class _Array:
    """What numpy's `_reconstruct(ndarray, ...)` returns while unpickling:
    the ndarray's state (version, shape, dtype, fortran, raw bytes) builds
    a numpy array, or a torch tensor where the dtype is an ml_dtypes one.
    `_resolve` swaps it for its value once the whole object is read."""

    __slots__ = ("value",)

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if isinstance(dtype, _MLDtype):
            self.value = _from_words(raw, _TORCH_ONLY[dtype.name], shape,
                                     fortran)
        else:
            arr = np.ndarray.__new__(np.ndarray, (0,), np.uint8)
            arr.__setstate__(state)
            self.value = arr


def _dtype(*args):
    if args and isinstance(args[0], _MLType):
        return _MLDtype(args[0].name)
    return np.dtype(*args)


def _reconstruct(cls, shape, typecode):
    return _Array()


def _scalar(real):
    """numpy's `scalar(dtype, raw)`; a 0-d torch tensor for an ml_dtypes
    dtype."""
    def scalar(dtype, *args):
        if isinstance(dtype, _MLDtype):
            return _from_words(args[0], _TORCH_ONLY[dtype.name], ())
        return real(dtype, *args)
    return scalar


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            if name == "dtype":
                return _dtype
            if name == "_reconstruct":
                return _reconstruct
            if name == "scalar":
                return _scalar(super().find_class(module, name))
            return super().find_class(module, name)
        if module == "ml_dtypes" and name in _TORCH_ONLY:
            return _MLType(name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle global {module}.{name} (paddle.load "
            "only restores plain data)")


def _resolve(obj):
    if isinstance(obj, _Array):
        return obj.value
    if isinstance(obj, dict):
        return type(obj)((k, _resolve(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve(v) for v in obj)
    return obj


def restricted_pickle_load(file):
    """Unpickle from a binary file object through the allowlist (also the
    read path for legacy pre-engine checkpoint payloads). Arrays come back
    as numpy arrays, those of a bfloat16 or float8 dtype as CPU torch
    tensors."""
    return _resolve(_RestrictedUnpickler(file).load())


# ---------------------------------------------------------------- writing


class _MLGlobal(type):
    """Metaclass of the stand-ins that pickle as `ml_dtypes.<name>`."""


_ML_GLOBALS = {n: _MLGlobal(n, (), {}) for n in _TORCH_ONLY}
_NP_RECONSTRUCT = np.zeros(0).__reduce__()[0]


class _MLDtypeOut:
    """Pickles as `numpy.dtype(ml_dtypes.<name>, False, True)`."""

    def __init__(self, name):
        self.name = name

    def __reduce__(self):
        return (np.dtype, (_ML_GLOBALS[self.name], False, True))


class _MLArrayOut:
    """Pickles as numpy pickles an ml_dtypes array: `_reconstruct(ndarray,
    (0,), b'b')`, then its state (1, shape, dtype, False, raw bytes)."""

    def __init__(self, t: torch.Tensor):
        self.shape = tuple(t.shape)
        self.name = _ML_NAME[t.dtype]
        flat = t.detach().cpu().contiguous().reshape(-1)
        self.raw = flat.view(torch.uint8).numpy().tobytes()

    def __reduce__(self):
        return (_NP_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                (1, self.shape, _MLDtypeOut(self.name), False, self.raw))


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing `ml_dtypes.<name>` for the
    stand-in types by name (the module is never imported)."""

    def save_global(self, obj, name=None):
        if not isinstance(obj, _MLGlobal):
            return super().save_global(obj, name)
        self.save("ml_dtypes")
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _tensor_data(t: torch.Tensor):
    if t.dtype in _ML_NAME:
        return _MLArrayOut(t)
    return t.detach().cpu().numpy().copy()


def _to_saveable(obj, name=None, flags=None):
    if isinstance(obj, torch.Tensor):
        if obj.dtype in _ML_NAME:
            flags["ml"] = True
        return {"__paddle_tpu_tensor__": True, "data": _tensor_data(obj),
                "name": name or "tensor", "stop_gradient":
                    not obj.requires_grad}
    if isinstance(obj, dict):
        return type(obj)((k, _to_saveable(v, str(k), flags))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v, None, flags) for v in obj)
    return obj


def _dumps(obj, protocol) -> bytes:
    flags = {}
    payload = _to_saveable(obj, None, flags)
    if not flags:
        return pickle.dumps(payload, protocol=protocol)
    buf = _io.BytesIO()
    _Pickler(buf, protocol=max(4, protocol)).dump(payload)
    return buf.getvalue()


def save(obj, path, protocol=4, **configs):
    """Pickle `obj` (torch tensors, numpy arrays and plain data, nested in
    dicts, lists and tuples) to `path` in the reference's layout,
    atomically and durably: a crash leaves the old file or the new one at
    `path`, never a truncated pickle."""
    data = _dumps(obj, protocol)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if d:
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def _from_saveable(obj, device, return_numpy):
    if isinstance(obj, dict):
        if obj.get("__paddle_tpu_tensor__"):
            data = obj["data"]
            if return_numpy:
                return data
            t = (data if isinstance(data, torch.Tensor)
                 else torch.from_numpy(np.require(data, requirements="C")))
            t = t.to(device)
            if not obj.get("stop_gradient", True) and t.is_floating_point():
                t.requires_grad_(True)
            return t
        return type(obj)((k, _from_saveable(v, device, return_numpy))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, device, return_numpy)
                         for v in obj)
    return obj


def load(path, device="cuda", **configs):
    """Unpickle `path` through the allowlist. Tensors come back as torch
    tensors on `device` (default "cuda", which raises without CUDA), or,
    with `return_numpy=True`, as numpy arrays (bfloat16 and float8 as CPU
    torch tensors) and no device is used."""
    return_numpy = bool(configs.get("return_numpy", False))
    dev = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        obj = restricted_pickle_load(f)
    return _from_saveable(obj, dev, return_numpy)
