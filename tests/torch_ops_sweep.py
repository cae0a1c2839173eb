"""The registry sweep of the port's tensor-op surface against the JAX
package's (imported by tests/test_torch_ops_*.py).

For every registered op of paddle_tpu/ops/{math,manipulation,creation,
linalg,random_ops}.py, the same seeded numpy inputs go through the
reference's op function (jnp, x64 on as the package sets it) and the
port's (torch, on the CPU). Compared:
  * each output's dtype, exactly;
  * each output's values: integers and bools exactly; floats within
    FWD_TOL[kind] of the reference's largest |value| (at least 1), with
    kind "elementwise" for ops of one element in one element out and
    "reduction" for the rest (sums in another order);
  * the vjp under one fixed cotangent (numpy RandomState(1234)) of the
    float outputs, for every float input the reference's own sweep
    differentiates (tests/test_op_auto.py SPECS), within GRAD_TOL of the
    reference gradient's largest |value| (at least 1).
Inputs come from the reference sweep's makers (`test_op_auto._build`:
uniform [0.25, 2.75] by default, its per-op domains and attrs), with the
overrides in EXTRA_SPECS for ops it leaves out (list inputs, factories,
dynamic shapes). Ops whose factors are unique only up to signs or order
are held by reconstruction in test_torch_ops_linalg.py instead
(RECONSTRUCT).
"""
from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu  # noqa: F401  (x64 on, the reference's registry)
from paddle_tpu.framework.dispatch import OPS as REF_OPS

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.framework.dispatch import OPS as PORT_OPS

import test_op_auto as _auto

FWD_TOL = {"elementwise": 1e-5, "reduction": 1e-4}
GRAD_TOL = 1e-4

# the reference modules whose ops this sweep covers
MODULES = ("math", "manipulation", "creation", "linalg", "random_ops")


def module_ops(module):
    """The op type names the reference module registers, in order."""
    import inspect
    import importlib
    mod = importlib.import_module("paddle_tpu.ops." + module)
    src = inspect.getsource(mod)
    names = []
    for line in src.splitlines():
        line = line.strip()
        if line.startswith("@primitive("):
            names.append(line.split('"')[1])
    return names


REF_MODULE_OPS = {m: module_ops(m) for m in MODULES}

# ops of one element in, one element out (and the copies): held to
# FWD_TOL["elementwise"]; the others reduce or mix elements, whose float
# sums may run in another order than XLA's
ELEMENTWISE = set("""
elementwise_add elementwise_sub elementwise_mul elementwise_div
elementwise_floordiv elementwise_mod elementwise_pow elementwise_max
elementwise_min elementwise_fmax elementwise_fmin atan2 scale neg abs sign
exp expm1 log log2 log10 log1p sqrt rsqrt square reciprocal sin cos tan asin
acos atan sinh cosh asinh acosh atanh ceil floor round trunc frac erf erfinv
lgamma digamma angle conj real imag isnan isinf isfinite clip clip_t stanh
logit nan_to_num increment lerp rad2deg deg2rad gcd lcm heaviside identity
scale_op equal not_equal greater_than greater_equal less_than less_equal
logical_and logical_or logical_xor logical_not bitwise_and bitwise_or
bitwise_xor bitwise_not isclose where cast reshape2 transpose2
flatten_contiguous_range squeeze2 unsqueeze2 concat_op stack_op unstack_op
split_op slice_op strided_slice_op getitem getitem_dyn gather_op gather_nd
take_along_axis_op index_select_op index_sample_op tile_op expand_v2
broadcast_tensors_op flip_op roll_op rot90_op pad3d_op repeat_interleave_op
moveaxis_op as_complex_op as_real_op unbind_op shard_index_op fill_constant
fill_like tril_op triu_op diag_v2 diagflat diag_embed diagonal meshgrid_op
complex_op masked_select multiplex frexp_op
""".split())


def U(lo, hi, shape=(4, 3)):
    return _auto.U(lo, hi, shape)


def I64(hi, shape):
    return _auto.I64(hi, shape)


# inputs and attrs for the ops the reference sweep white-lists or feeds
# nothing (lists, factories, dynamic shapes); each a (makers, attrs) pair
EXTRA_SPECS = {
    "concat_op": ([U(-1, 1, (2, 3)), U(-1, 1, (4, 3))], {"axis": 0}),
    "stack_op": ([U(-1, 1, (2, 3)), U(-1, 1, (2, 3))], {"axis": 1}),
    "broadcast_tensors_op": ([U(-1, 1, (2, 1)), U(-1, 1, (1, 3))], {}),
    "multiplex": ([lambda rs: np.array([[1], [0], [1]], np.int32),
                   U(-1, 1, (3, 4)), U(-1, 1, (3, 4))], {}),
    "meshgrid_op": ([U(-1, 1, (3,)), U(-1, 1, (4,))], {}),
    "multi_dot_op": ([U(-1, 1, (2, 3)), U(-1, 1, (3, 4)),
                      U(-1, 1, (4, 2))], {}),
    "einsum_op": ([U(-1, 1, (2, 3, 4)), U(-1, 1, (2, 4, 5))],
                  {"equation": "bij,bjk->bik"}),
    "masked_select": ([U(-1, 1, (4, 3)),
                       lambda rs: rs.rand(4, 3) > 0.4], {}),
    "nonzero": ([lambda rs: (rs.rand(4, 3) > 0.5).astype(np.float32)], {}),
    "unique": ([lambda rs: rs.randint(0, 5, (4, 3)).astype(np.float32)],
               {}),
    "unique_consecutive_op": (
        [lambda rs: np.array([1, 1, 2, 2, 2, 3, 1, 1], np.float32)], {}),
    "bincount_op": ([I64(6, (10,))], {"minlength": 3}),
    "getitem_dyn": ([U(-1, 1, (4, 3)), lambda rs: np.array([2, 0, 3],
                                                           np.int64)],
                    {"index_template": ("__arr__", slice(0, 2))}),
    "fill_constant": ([], {"shape": (2, 3), "fill_value": 1.5,
                           "dtype": "float32"}),
    "arange": ([], {"start": 0.0, "end": 2.0, "step": 0.3,
                    "dtype": "float32"}),
    "linspace": ([], {"start": -1.0, "stop": 2.0, "num": 7,
                      "dtype": "float32"}),
    "logspace": ([], {"start": 0.0, "stop": 2.0, "num": 5, "base": 10.0,
                      "dtype": "float32"}),
    "eye_op": ([], {"num_rows": 3, "num_columns": 4, "dtype": "float32"}),
    "histogram_op": ([U(-1, 1, (20,))], {"bins": 5}),
    "cummax": ([U(-1, 1, (4, 3))], {"axis": 0}),
    "sort_op": ([U(-1, 1, (4, 3))], {"axis": 0}),
    "argsort": ([U(-1, 1, (4, 3))], {"axis": 0, "descending": True}),
    "searchsorted_op": ([lambda rs: np.sort(rs.rand(2, 5), -1)
                         .astype(np.float32), U(0, 1, (2, 3))], {}),
    "tensordot_op": ([U(-1, 1, (2, 3, 4)), U(-1, 1, (3, 4, 5))],
                     {"axes": 2}),
    "dist_op": ([U(-1, 1, (4, 3)), U(-1, 1, (4, 3))], {"p": 3.0}),
    "diag_v2": ([U(-1, 1, (4,))], {"offset": 1, "padding_value": 0.5}),
    "diag_embed": ([U(-1, 1, (2, 3))], {"offset": 1}),
    "diagonal": ([U(-1, 1, (3, 4))], {"offset": 1}),
    "tril_op": ([U(-1, 1, (4, 4))], {"diagonal": -1}),
    "triu_op": ([U(-1, 1, (4, 4))], {"diagonal": 1}),
    "unstack_op": ([U(-1, 1, (3, 4))], {"axis": 1}),
    "unbind_op": ([U(-1, 1, (3, 4))], {"axis": 0}),
    "pad3d_op": ([U(-1, 1, (2, 3, 4))],
                 {"paddings": ((0, 0), (1, 2), (2, 1)), "mode": "reflect"}),
    "cross": ([U(-1, 1, (4, 3)), U(-1, 1, (4, 3))], {"axis": 1}),
    "cumsum": ([U(-1, 1, (4, 3))], {"axis": 1}),
    "cumprod": ([U(0.5, 1.5, (4, 3))], {"dim": 0}),
    "logcumsumexp": ([U(-1.5, 1.5, (4, 3))], {"axis": 0}),
    "reduce_sum": ([U(-1, 1, (4, 3))], {"axis": 1}),
    "reduce_mean": ([U(-1, 1, (4, 3))], {"axis": 0, "keepdim": True}),
    "reduce_prod": ([U(0.5, 1.5, (4, 3))], {"axis": 1}),
    "std": ([U(-1, 1, (4, 3))], {"axis": 0}),
    "var": ([U(-1, 1, (4, 3))], {"axis": 1, "unbiased": False}),
    "median": ([U(-1, 1, (4, 6))], {"axis": 1}),
    "nanmean": ([lambda rs: np.where(rs.rand(4, 3) > 0.8, np.nan,
                                     rs.rand(4, 3)).astype(np.float32)],
                {"axis": 0}),
    "nansum": ([lambda rs: np.where(rs.rand(4, 3) > 0.8, np.nan,
                                    rs.rand(4, 3)).astype(np.float32)], {}),
    "nan_to_num": ([lambda rs: np.array([1.0, np.nan, np.inf, -np.inf,
                                         -2.0], np.float32)],
                   {"nan": 0.5, "posinf": 9.0}),
    "argmax": ([U(-1, 1, (4, 3))], {"axis": 1}),
    "argmin": ([U(-1, 1, (4, 3))], {"axis": 0, "keepdim": True}),
    "quantile": ([U(-1, 1, (4, 5))], {"q": 0.3, "axis": 1}),
    "trace_op": ([U(-1, 1, (3, 4))], {"offset": 1}),
    "mul": ([U(-1, 1, (2, 3, 4)), U(-1, 1, (12, 5))],
            {"x_num_col_dims": 1}),
}

# ops whose factors are unique only up to signs or order: held by
# reconstruction (test_torch_ops_linalg.py)
RECONSTRUCT = {"svd_op", "qr_op", "lu_op", "eig_op", "eigh_op",
               "eigvals_op", "lstsq_op"}
# random ops: held to their distributions (test_torch_ops_linalg.py)
RANDOM = set(REF_MODULE_OPS["random_ops"])
# factories: the port's takes the device the reference has no word for
FACTORIES = {"fill_constant", "arange", "linspace", "logspace", "eye_op"}


def build(op):
    """(numpy inputs, attrs, differentiated input indices) of `op`."""
    if op in EXTRA_SPECS:
        makers, attrs = EXTRA_SPECS[op]
        rs = np.random.RandomState(zlib.crc32(op.encode()) % (2 ** 31))
        arrays = [mk(rs) for mk in makers]
        spec = _auto.SPECS.get(op, {})
    else:
        arrays, attrs, spec = _auto._build(op)
    diff = spec.get("grad", None)
    floats = [i for i, a in enumerate(arrays)
              if isinstance(a, np.ndarray)
              and np.issubdtype(a.dtype, np.floating)]
    if diff is None:
        diff = floats
    elif diff is False:
        diff = []
    if REF_OPS[op].nondiff:
        diff = []
    return arrays, dict(attrs), list(diff)


def _np(x):
    """An output as numpy (bfloat16 widened to float32) and its dtype
    name."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), name
    a = np.asarray(x)
    name = str(a.dtype)
    if name == "bfloat16":
        a = a.astype(np.float32)
    return a, name


def _tup(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def run_ref(op, arrays, attrs):
    ins = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for a in arrays]
    return _tup(REF_OPS[op].fn(*ins, **attrs))


def run_port(op, arrays, attrs, requires=()):
    ins = []
    for i, a in enumerate(arrays):
        if isinstance(a, np.ndarray):
            t = torch.from_numpy(np.array(a))
            if i in requires:
                t.requires_grad_(True)
            ins.append(t)
        else:
            ins.append(a)
    extra = {"device": "cpu"} if op in FACTORIES else {}
    return ins, _tup(PORT_OPS[op].fn(*ins, **attrs, **extra))


def scale_of(a):
    a = np.abs(np.asarray(a, np.float64))
    return max(1.0, float(np.nanmax(a))) if a.size else 1.0


def assert_close(op, got, want, kind, what="output"):
    g, gname = _np(got)
    w, wname = _np(want)
    assert gname == wname, "%s %s: dtype %s, reference %s" % (
        op, what, gname, wname)
    assert g.shape == w.shape, "%s %s: shape %s, reference %s" % (
        op, what, g.shape, w.shape)
    if w.dtype.kind in "biu" or w.dtype == bool:
        np.testing.assert_array_equal(g, w, err_msg="%s %s" % (op, what))
        return 0.0
    tol = FWD_TOL[kind] if what == "output" else GRAD_TOL
    if g.size == 0:
        return 0.0
    s = scale_of(w)
    err = float(np.nanmax(np.abs(g.astype(np.complex128)
                                 - w.astype(np.complex128)))) \
        if np.iscomplexobj(w) else float(np.nanmax(np.abs(
            g.astype(np.float64) - w.astype(np.float64))))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                  err_msg="%s %s NaNs" % (op, what))
    assert err <= tol * s, "%s %s: max error %.3g > %.3g (scale %.3g)" % (
        op, what, err, tol * s, s)
    return err / s


def cotangents(outs):
    rs = np.random.RandomState(1234)
    cts = []
    for o in outs:
        a, _ = _np(o)
        if a.dtype.kind == "f":
            cts.append(np.asarray(rs.rand(*a.shape), np.float32)
                       .astype(a.dtype))
        else:
            cts.append(None)
    return cts


def check_op(op, arrays=None, attrs=None, diff=None):
    """Forward values and dtypes, then the vjp, of `op` on both sides."""
    if arrays is None:
        arrays, attrs, diff = build(op)
    kind = "elementwise" if op in ELEMENTWISE else "reduction"
    ref_out = run_ref(op, arrays, attrs)
    ins, port_out = run_port(op, arrays, attrs, requires=set(diff or ()))
    assert len(ref_out) == len(port_out), op
    for i, (g, w) in enumerate(zip(port_out, ref_out)):
        assert_close(op, g, w, kind, "output")
    if REF_OPS[op].nondiff:
        assert all(not (isinstance(o, torch.Tensor) and o.requires_grad)
                   for o in port_out), "%s: nondiff output has a grad" % op
        return
    if not diff:
        return
    cts = cotangents(ref_out)
    fl = [i for i, c in enumerate(cts) if c is not None]
    if not fl:
        return

    def f(*dx):
        full = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in arrays]
        for j, i in enumerate(diff):
            full[i] = dx[j]
        outs = _tup(REF_OPS[op].fn(*full, **attrs))
        return tuple(outs[i] for i in fl)

    _, vjp = jax.vjp(f, *[jnp.asarray(arrays[i]) for i in diff])
    ref_g = vjp(tuple(jnp.asarray(cts[i]) for i in fl))
    loss = sum((port_out[i].to(torch.float64)
                * torch.from_numpy(cts[i].astype(np.float64))).sum()
               for i in fl if port_out[i].requires_grad)
    if not isinstance(loss, torch.Tensor):
        got = [None] * len(diff)
    else:
        got = torch.autograd.grad(loss, [ins[i] for i in diff],
                                  allow_unused=True)
    for i, g, w in zip(diff, got, ref_g):
        if g is None:
            g = torch.zeros(arrays[i].shape, dtype=ins[i].dtype)
        elif g.is_sparse:               # a row-sparse table gradient
            g = g.to_dense()
        assert_close(op, g, w, kind, "gradient of input %d" % i)
