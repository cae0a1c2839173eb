"""Shape and layout ops (counterpart of paddle_tpu/ops/manipulation.py):
cast, reshape, transpose, concat / split, gather / scatter, tile /
expand, flip / roll, pad and the indexing ops `Tensor.__getitem__`
records.

The registered ops take the reference's op type names and attrs; the
public functions beside them (`reshape`, `split`, ...) take the
reference's Python signatures and turn tensors given as shapes or axes
into ints on the host, as the reference does.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework.dispatch import primitive
from ..framework.dtype import convert_dtype
from .math import as_tensor, no_capture, promote


def int_tuple(v):
    """A shape, axes or sizes argument as a tuple of Python ints (tensors
    read on the host)."""
    if isinstance(v, torch.Tensor):
        return tuple(int(s) for s in v.reshape(-1).tolist())
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in v)


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


@primitive("cast")
def _cast(x, *, dtype):
    return x.to(convert_dtype(dtype))


def cast(x, dtype):
    """x in `dtype` (a name, numpy or torch dtype)."""
    return _cast(x, dtype=str(convert_dtype(dtype)).replace("torch.", ""))


@primitive("reshape2")
def _reshape(x, *, shape):
    return x.reshape(tuple(shape))


def reshape(x, shape, name=None):
    """op reshape2; one -1 takes the rest."""
    return _reshape(x, shape=int_tuple(shape))


@primitive("transpose2")
def _transpose(x, *, perm):
    return x.permute(tuple(perm))


def transpose(x, perm, name=None):
    """op transpose2: the axes in the order `perm`."""
    return _transpose(x, perm=int_tuple(perm))


def t(x, name=None):
    """The transpose of a matrix; a vector or scalar as it is."""
    if x.ndim <= 1:
        return x
    return _transpose(x, perm=(1, 0))


@primitive("flatten_contiguous_range")
def _flatten(x, *, start_axis=0, stop_axis=-1):
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return x.reshape(tuple(x.shape[:s]) + (-1,) + tuple(x.shape[e + 1:]))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes start_axis..stop_axis merged into one (op
    flatten_contiguous_range); a 0-d input becomes [1]."""
    return _flatten(x, start_axis=int(start_axis), stop_axis=int(stop_axis))


@primitive("squeeze2")
def _squeeze(x, *, axis=None):
    if axis is None:
        return x.squeeze()
    axes = tuple(a % x.ndim for a in (axis if isinstance(axis, (tuple, list))
                                      else (axis,))
                 if x.shape[a % x.ndim] == 1)
    return x.squeeze(axes) if axes else x


def squeeze(x, axis=None, name=None):
    """op squeeze2: the size-1 axes among `axis` (every size-1 axis for
    None) dropped; an axis of another size is kept."""
    return _squeeze(x, axis=int_tuple(axis) if axis is not None else None)


@primitive("unsqueeze2")
def _unsqueeze(x, *, axis):
    out = x
    for a in sorted(axis):
        out = out.unsqueeze(a if a >= 0 else a + out.ndim + 1)
    return out


def unsqueeze(x, axis, name=None):
    return _unsqueeze(x, axis=int_tuple(axis))


@primitive("concat_op")
def _concat(*xs, axis=0):
    return torch.cat(promote(*xs), dim=axis)


def concat(x, axis=0, name=None):
    return _concat(*x, axis=_int(axis))


@primitive("stack_op")
def _stack(*xs, axis=0):
    return torch.stack(promote(*xs), dim=axis)


def stack(x, axis=0, name=None):
    return _stack(*x, axis=_int(axis))


@primitive("unstack_op")
def _unstack(x, *, axis=0, num=None):
    n = num or x.shape[axis]
    if n != x.shape[axis]:
        raise ValueError("unstack: num %d, axis of size %d"
                         % (n, x.shape[axis]))
    return tuple(torch.unbind(x, dim=axis))


def unstack(x, axis=0, num=None):
    return list(_unstack(x, axis=int(axis), num=num))


@primitive("split_op")
def _split(x, *, sections, axis):
    if isinstance(sections, int):
        if x.shape[axis] % sections:
            raise ValueError("split: axis of size %d into %d equal parts"
                             % (x.shape[axis], sections))
        return tuple(torch.split(x, x.shape[axis] // sections, dim=axis))
    return tuple(torch.split(x, list(sections), dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """A number of equal sections, or their sizes with at most one -1 (the
    rest): a list of tensors."""
    axis = _int(axis) % x.ndim
    if isinstance(num_or_sections, (list, tuple)):
        secs = [_int(s) for s in num_or_sections]
        total = x.shape[axis]
        known = builtins.sum(s for s in secs if s != -1)
        secs = [s if s != -1 else total - known for s in secs]
        return list(_split(x, sections=tuple(secs), axis=axis))
    return list(_split(x, sections=_int(num_or_sections), axis=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def _clamp_index(i, dim):
    return builtins.max(i + dim, 0) if i < 0 else builtins.min(i, dim)


@primitive("slice_op")
def _slice(x, *, axes, starts, ends):
    idx = [builtins.slice(None)] * x.ndim
    for a, s, e in zip(axes, starts, ends):
        dim = x.shape[a]
        idx[a] = builtins.slice(_clamp_index(s, dim), _clamp_index(e, dim))
    return x[tuple(idx)]


def slice(x, axes, starts, ends):  # noqa: A001
    return _slice(x, axes=int_tuple(axes), starts=int_tuple(starts),
                  ends=int_tuple(ends))


def _strided(x, a, s, e, st):
    """x[s:e:st] along axis a with Python's slice rules, a negative
    stride included (torch slicing takes none)."""
    if st > 0:
        return x[(builtins.slice(None),) * a + (builtins.slice(s, e, st),)]
    rng = range(*builtins.slice(s, e, st).indices(x.shape[a]))
    idx = torch.tensor(list(rng), dtype=torch.int64, device=x.device)
    return x.index_select(a, idx)


@primitive("strided_slice_op")
def _strided_slice(x, *, axes, starts, ends, strides):
    for a, s, e, st in zip(axes, starts, ends, strides):
        x = _strided(x, a, s, e, st)
    return x


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _strided_slice(x, axes=int_tuple(axes), starts=int_tuple(starts),
                          ends=int_tuple(ends), strides=int_tuple(strides))


def _index_value(x, index):
    """x[index] for a static index of ints, slices (negative steps too),
    None and Ellipsis."""
    if not isinstance(index, tuple):
        index = (index,)
    if not any(isinstance(i, builtins.slice) and i.step is not None
               and i.step < 0 for i in index):
        return x[index]
    # torch slicing takes no negative step: expand the Ellipsis, then
    # apply the axes one by one
    n_real = builtins.sum(1 for i in index if i is not None
                          and i is not Ellipsis)
    out = []
    for i in index:
        if i is Ellipsis:
            out.extend([builtins.slice(None)] * (x.ndim - n_real))
        else:
            out.append(i)
    axis = 0
    pending = []
    for i in out:
        if i is None:
            pending.append(("new", axis))
            axis += 1
        elif isinstance(i, builtins.slice):
            pending.append(("slice", axis, i))
            axis += 1
        else:
            pending.append(("int", axis, i))
            axis += 1
    y = x
    offset = 0
    for p in pending:
        ax = p[1] - offset
        if p[0] == "new":
            y = y.unsqueeze(ax)
        elif p[0] == "slice":
            s = p[2]
            y = _strided(y, ax, s.start, s.stop, 1 if s.step is None
                         else s.step)
        else:
            y = y.select(ax, p[2])
            offset += 1
    return y


@primitive("getitem")
def _getitem(x, *, index):
    return _index_value(x, index)


@primitive("getitem_dyn")
def _getitem_dyn(x, *idx_arrays, index_template):
    it = iter(idx_arrays)
    idx = tuple(next(it).long() if isinstance(i, str) and i == "__arr__"
                else i for i in index_template)
    return x[idx]


def getitem(x, index):
    """x[index]: a static index (ints, slices, None, Ellipsis) records op
    getitem; tensor, list or array indices record getitem_dyn; a bool
    tensor of x's shape selects (masked_select)."""
    if isinstance(index, torch.Tensor) and index.dtype == torch.bool:
        from .math import masked_select
        return masked_select(x, index)
    items = index if isinstance(index, tuple) else (index,)
    if not any(isinstance(i, (torch.Tensor, np.ndarray, list))
               for i in items):
        return _getitem(x, index=index)
    arrays, template = [], []
    for i in items:
        if isinstance(i, (torch.Tensor, np.ndarray, list)):
            t = as_tensor(i, x.device)
            if t.dtype == torch.bool:
                no_capture("boolean indexing")
            arrays.append(t)
            template.append("__arr__")
        else:
            template.append(i)
    return _getitem_dyn(x, *arrays, index_template=tuple(template))


@primitive("gather_op")
def gather(x, index, *, axis=0):
    """The rows (slices along `axis`) at `index`, an index of any rank
    (jnp.take)."""
    idx = index.long()
    out = torch.index_select(x, axis, idx.reshape(-1))
    axis = axis % x.ndim
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


@primitive("gather_nd")
def gather_nd(x, index):
    idx = index.long()
    return x[tuple(idx.movedim(-1, 0))]


@primitive("take_along_axis_op")
def take_along_axis(x, indices, *, axis):
    return torch.take_along_dim(x, indices.long(), dim=axis)


def _along_axis_index(x, idx, axis):
    """Full index tuples for writing along `axis` at idx."""
    grids = []
    for d, s in enumerate(idx.shape):
        shape = [1] * idx.ndim
        shape[d] = s
        grids.append(torch.arange(s, device=x.device).reshape(shape)
                     .expand(idx.shape))
    grids[axis] = idx
    return tuple(grids)


@primitive("put_along_axis_op")
def put_along_axis(x, indices, values, *, axis, reduce="assign"):
    idx = indices.long()
    values = as_tensor(values, x.device, x.dtype).expand(idx.shape)
    where = _along_axis_index(x, idx, axis % x.ndim)
    if reduce == "assign":
        return x.index_put(where, values)
    if reduce == "add":
        return x.index_put(where, values, accumulate=True)
    if reduce in ("multiply", "mul"):
        factor = torch.ones_like(x).index_put(where, values)
        return x * factor
    raise ValueError("unknown reduce %r" % (reduce,))


@primitive("scatter_op")
def scatter(x, index, updates, *, overwrite=True):
    """Rows `index` of x replaced by `updates` (overwrite), or zeroed then
    summed over duplicate indices (overwrite=False)."""
    idx = index.long()
    if idx.ndim == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    if overwrite:
        return x.index_put((idx,), updates)
    zeroed = x.index_put((idx,), torch.zeros_like(updates))
    return zeroed.index_put((idx,), updates, accumulate=True)


@primitive("scatter_nd_add_op")
def scatter_nd_add(x, index, updates):
    idx = index.long()
    return x.index_put(tuple(idx.movedim(-1, 0)), updates, accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    """zeros(shape) with `updates` added at `index`."""
    z = torch.zeros(int_tuple(shape), dtype=updates.dtype,
                    device=updates.device)
    return scatter_nd_add(z, index, updates)


@primitive("index_select_op")
def index_select(x, index, *, axis=0):
    return gather.fn(x, index, axis=axis)


@primitive("index_sample_op")
def index_sample(x, index):
    return torch.take_along_dim(x, index.long(), dim=1)


@primitive("tile_op")
def _tile(x, *, repeat_times):
    return torch.tile(x, tuple(repeat_times))


def tile(x, repeat_times, name=None):
    return _tile(x, repeat_times=int_tuple(repeat_times))


@primitive("expand_v2")
def _expand(x, *, shape):
    lead = len(shape) - x.ndim
    tgt = tuple(x.shape[i - lead] if s == -1 else s
                for i, s in enumerate(shape))
    return x.expand(tgt)


def expand(x, shape, name=None):
    """x broadcast to `shape`; -1 keeps x's size on that axis."""
    return _expand(x, shape=int_tuple(shape))


def expand_as(x, y, name=None):
    return _expand(x, shape=tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return _expand(x, shape=int_tuple(shape))


@primitive("broadcast_tensors_op")
def _broadcast_tensors(*xs):
    return tuple(torch.broadcast_tensors(*xs))


def broadcast_tensors(inputs, name=None):
    return list(_broadcast_tensors(*inputs))


@primitive("flip_op")
def _flip(x, *, axis):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return torch.flip(x, tuple(axes))


def flip(x, axis, name=None):
    return _flip(x, axis=int_tuple(axis))


@primitive("roll_op")
def _roll(x, *, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, dims=axis)


def roll(x, shifts, axis=None, name=None):
    shifts = shifts if isinstance(shifts, int) else int_tuple(shifts)
    if axis is not None and not isinstance(axis, int):
        axis = int_tuple(axis)
    return _roll(x, shifts=shifts, axis=axis)


@primitive("rot90_op")
def _rot90(x, *, k, axes):
    return torch.rot90(x, k, tuple(axes))


def rot90(x, k=1, axes=(0, 1), name=None):
    return _rot90(x, k=int(k), axes=tuple(axes))


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "edge": "replicate", "wrap": "circular"}


@primitive("pad3d_op")
def _pad(x, *, paddings, mode="constant", value=0.0):
    """jnp.pad's modes over per-axis (low, high) pairs."""
    flat = []
    for lo, hi in reversed(tuple(paddings)):
        flat += [int(lo), int(hi)]
    if mode == "constant":
        return torch.nn.functional.pad(x, flat, mode="constant", value=value)
    # torch's reflect / replicate / circular take the trailing axes only,
    # behind two leading ones: pad the axes that need it one at a time
    out = x
    for a, (lo, hi) in enumerate(tuple(paddings)):
        if lo == 0 and hi == 0:
            continue
        moved = out.movedim(a, -1)
        shape = moved.shape
        flat2 = moved.reshape(1, -1, shape[-1])
        flat2 = torch.nn.functional.pad(flat2, [int(lo), int(hi)],
                                        mode=_PAD_MODES[mode])
        out = flat2.reshape(tuple(shape[:-1]) + (flat2.shape[-1],)) \
            .movedim(-1, a)
    return out


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        name=None):  # noqa: A002
    """paddle.nn.functional.pad's flat form: 2 * ndim numbers pad every
    axis in order; fewer pad the spatial axes, the last axis first
    (NCHW / NHWC)."""
    pad = int_tuple(pad)
    nd = x.ndim
    if len(pad) == nd * 2:
        pads = tuple((pad[2 * i], pad[2 * i + 1]) for i in range(nd))
    else:
        n_spatial = len(pad) // 2
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(n_spatial)]
        pairs = pairs[::-1]
        if data_format.endswith("C"):
            pads = ((0, 0),) + tuple(pairs) + ((0, 0),)
        else:
            pads = ((0, 0), (0, 0)) + tuple(pairs)
        pads = tuple(pads) + tuple((0, 0) for _ in range(nd - len(pads)))
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    return _pad(x, paddings=pads, mode=jmode, value=value)


@primitive("repeat_interleave_op")
def _repeat_interleave(x, *, repeats, axis=None):
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    """Each element (slice along `axis`) repeated; tensor repeats read on
    the host (the output's size depends on them)."""
    if isinstance(repeats, torch.Tensor):
        no_capture("repeat_interleave with tensor repeats")
        src = x.reshape(-1) if axis is None else x
        return torch.repeat_interleave(src, repeats.to(src.device).long(),
                                       dim=0 if axis is None else axis)
    return _repeat_interleave(x, repeats=int(repeats), axis=axis)


@primitive("moveaxis_op")
def _moveaxis(x, *, source, destination):
    return torch.movedim(x, source, destination)


def moveaxis(x, source, destination, name=None):
    return _moveaxis(x, source=int_tuple(source),
                     destination=int_tuple(destination))


@primitive("as_complex_op")
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@primitive("as_real_op")
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@primitive("unbind_op")
def _unbind(x, *, axis=0):
    return tuple(torch.unbind(x, dim=axis))


def unbind(x, axis=0):
    return list(_unbind(x, axis=int(axis)))


@primitive("unique_consecutive_op", nondiff=True)
def _unique_consecutive(x):
    """x (1-D) with each run of equal values kept once."""
    no_capture("unique_consecutive")
    return torch.unique_consecutive(x)


@primitive("shard_index_op", nondiff=True)
def shard_index(x, *, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(x, shard_size),
                       torch.full_like(x, ignore_value))
