"""The port's math ops against the JAX package's (paddle_tpu/ops/math.py):
the registry sweep (tests/torch_ops_sweep.py: forward values and dtypes,
the vjp under one cotangent) over every op of the module, then the dtype
rules, the gradients at ties and edges and the semantics that share a
name with torch but differ. Tolerances: torch_ops_sweep.FWD_TOL (1e-5
of the largest |value| for elementwise ops, 1e-4 for the rest),
GRAD_TOL (1e-4); integers, bools and indices exactly."""
import numpy as np
import pytest

import torch_threads  # noqa: F401
import torch_ops_sweep as sw

OPS = sorted(set(sw.REF_MODULE_OPS["math"]) - sw.RECONSTRUCT - sw.RANDOM)


@pytest.mark.parametrize("op", OPS)
def test_math_op_matches_reference(op):
    sw.check_op(op)


# ---------------------------------------------------------------------------
# the surface in both packages: the reference's functions on its Tensors,
# the port's on CPU tensors

import jax  # noqa: E402
import torch  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as pp  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def _ref_arg(a):
    return jp.to_tensor(a) if isinstance(a, np.ndarray) else a


def _port_arg(a):
    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a


def both(fn, *args, kind="reduction", **kw):
    """`fn` (a name of both packages' top level, or a pair of callables)
    on the same inputs: every output's dtype and values held as the
    sweep holds them. Returns the port's outputs."""
    rf, pf = ((getattr(jp, fn), getattr(pp, fn)) if isinstance(fn, str)
              else fn)
    want = rf(*[_ref_arg(a) for a in args], **kw)
    got = pf(*[_port_arg(a) for a in args], **kw)
    w = sw._tup(want)
    g = sw._tup(got)
    assert len(w) == len(g)
    for gi, wi in zip(g, w):
        sw.assert_close(str(fn), gi, wi.numpy() if hasattr(wi, "_data")
                        and wi.dtype.name != "bfloat16" else
                        np.asarray(wi._data) if hasattr(wi, "_data") else wi,
                        kind)
    return got


I64 = np.array([[3, -7, 4], [0, 5, -2]], np.int64)
I32 = I64.astype(np.int32)
F32 = np.array([[1.5, -2.25, 0.5], [3.0, 0.0, -0.75]], np.float32)
B = np.array([[True, False, True], [False, False, True]])


@pytest.mark.parametrize("case", [
    "int64_divide", "int32_divide", "int64_mean", "int32_mean", "bool_sum",
    "int32_sum", "int_plus_float", "bool_plus_int", "bool_plus_float",
    "bf16_times_float", "int_pow_int", "int_pow_float", "int_sqrt",
    "int32_exp", "bool_cumsum", "bool_prod", "bool_max", "bool_mean",
    "argmax_int64", "arange_float_step", "arange_ints", "arange_float_end",
    "full_int", "full_float", "one_hot_float32"])
def test_dtype_rules_follow_the_reference(case):
    """The reference runs with jax_enable_x64: int64 / int64 and int64
    means are float64, int32's float32; integer sums int64; a Python float
    with an integer tensor float64; bf16 with a Python float stays bf16."""
    if case == "int64_divide":
        both("divide", I64, I64 + 10)
    elif case == "int32_divide":
        both("divide", I32, I32 + 10)
    elif case == "int64_mean":
        both("mean", I64)
    elif case == "int32_mean":
        both("mean", I32, 1)
    elif case == "bool_sum":
        both("sum", B, 0)
    elif case == "int32_sum":
        both("sum", I32)
    elif case == "int_plus_float":
        both("add", I64, 2.5)
    elif case == "bool_plus_int":
        both("add", B, 1)
    elif case == "bool_plus_float":
        both("add", B, 1.5)
    elif case == "bf16_times_float":
        both((lambda x, s: jp.cast(x, "bfloat16") * s,
              lambda x, s: pp.multiply(pp.cast(x, "bfloat16"), s)), F32, 2.5)
    elif case == "int_pow_int":
        both("pow", I64, 2)
    elif case == "int_pow_float":
        both("pow", np.abs(I64), 0.5)
    elif case == "int_sqrt":
        both("sqrt", np.abs(I64))
    elif case == "int32_exp":
        both("exp", I32)
    elif case == "bool_cumsum":
        both("cumsum", B, 1)
    elif case == "bool_prod":
        both("prod", B)
    elif case == "bool_max":
        both("max", B, 1)
    elif case == "bool_mean":
        both("mean", B)
    elif case == "argmax_int64":
        both("argmax", F32, 1)
    elif case == "arange_float_step":
        both((jp.arange, lambda *a: pp.arange(*a, device="cpu")), 0, 2, 0.3)
    elif case == "arange_ints":
        both((jp.arange, lambda *a: pp.arange(*a, device="cpu")), 1, 9, 2)
    elif case == "arange_float_end":
        both((jp.arange, lambda *a: pp.arange(*a, device="cpu")), 5.0)
    elif case == "full_int":
        both((jp.full, lambda *a: pp.full(*a, device="cpu")), [2, 3], 7)
    elif case == "full_float":
        both((jp.full, lambda *a: pp.full(*a, device="cpu")), [2], 7.0)
    elif case == "one_hot_float32":
        # a difference by design: float32 rows, where the reference's
        # jax.nn.one_hot gives float64 under x64 (the port's float math
        # stays float32 on the card); the values are the same
        ids = np.array([0, 3, 1, 7], np.int64)
        got = pp.nn.functional.one_hot(torch.from_numpy(ids), 4)
        want = jp.nn.functional.one_hot(jp.to_tensor(ids), 4).numpy()
        assert got.dtype == torch.float32 and want.dtype == np.float64
        np.testing.assert_array_equal(got.numpy(), want)


# ties and edges: forward, dtype and vjp through the sweep's check
TIE = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, -1.0, 2.0]], np.float32)
EDGE = np.array([[-0.5, 0.0, 0.5, 0.25], [-1.0, 0.5, -0.5, 0.0]],
                np.float32)


@pytest.mark.parametrize("op,arrays,attrs", [
    ("elementwise_max", [TIE, TIE[::-1].copy()], {}),
    ("elementwise_min", [TIE, TIE[::-1].copy()], {}),
    ("elementwise_max", [TIE, TIE.copy()], {}),
    ("elementwise_fmax", [TIE, TIE[::-1].copy()], {}),
    ("elementwise_fmin", [TIE, TIE[::-1].copy()], {}),
    ("reduce_max", [TIE], {"axis": 1}),
    ("reduce_min", [TIE], {"axis": 0}),
    ("reduce_max", [TIE], {}),
    ("amax", [TIE], {"axis": 1, "keepdim": True}),
    ("amin", [TIE], {}),
    ("abs", [EDGE], {}),
    ("sign", [EDGE], {}),
    ("clip", [EDGE], {"min": -0.5, "max": 0.5}),
    ("clip_t", [EDGE, np.float32(-0.5), np.float32(0.5)], {}),
    ("median", [TIE], {"axis": 1}),
    ("median", [TIE[:, :3].copy()], {"axis": 1}),
    ("median", [TIE], {}),
    ("median", [TIE], {"axis": 0, "keepdim": True}),
    ("quantile", [TIE], {"q": 0.5, "axis": 1}),
    ("quantile", [TIE], {"q": [0.25, 0.75], "axis": 0}),
    ("sort_op", [TIE], {"axis": 1}),
    ("sort_op", [TIE], {"axis": 1, "descending": True}),
    ("argsort", [TIE], {"axis": 1, "descending": True}),
    ("argsort", [TIE], {"axis": 1}),
    ("top_k_v2", [TIE], {"k": 2}),
    ("top_k_v2", [TIE], {"k": 3, "largest": False}),
    ("top_k_v2", [TIE], {"k": 1, "axis": 0}),
    ("p_norm", [EDGE], {"porder": 2.0, "axis": 1}),
    ("round", [np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32)], {}),
])
def test_ties_and_edges_match_reference(op, arrays, attrs):
    """jnp's tie rules: maximum / minimum split a tie 1/2 each, fmax gives
    it to y, the max reductions share it, abs has gradient 1 at 0, clip
    1/2 at a bound, median the mean of the middle two through a stable
    sort, sort / top_k stable."""
    diff = [i for i, a in enumerate(arrays)
            if isinstance(a, np.ndarray) and a.ndim and a.dtype.kind == "f"]
    sw.check_op(op, [np.asarray(a) if not isinstance(a, np.ndarray) else a
                     for a in arrays], attrs,
                [] if sw.REF_OPS[op].nondiff else diff)


def test_kthvalue_and_max_with_axis():
    """max(x, axis) gives values only; kthvalue (value, index) from a
    stable sort."""
    v = both("max", TIE, 1)
    assert isinstance(v, torch.Tensor)
    both("kthvalue", TIE, 2, 1)
    both("kthvalue", TIE, 1, 0, True)


def test_semantics_that_differ_from_torchs():
    """median averages, split takes sizes with -1, gather takes an index
    of rank 2, scatter(overwrite=False) sums duplicates, expand takes -1,
    std / var unbiased, remainder and floor_divide by signs, unique's
    sorted outputs."""
    both("median", np.array([1.0, 4.0, 2.0, 8.0], np.float32))
    for g, w in zip(pp.split(torch.arange(10.0).reshape(2, 5), [2, -1, 1],
                             1),
                    jp.split(jp.to_tensor(np.arange(10.0, dtype=np.float32)
                                          .reshape(2, 5)), [2, -1, 1], 1)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert len(pp.split(torch.zeros(6, 2), 3)) == 3
    x = np.arange(12.0, dtype=np.float32).reshape(4, 3)
    both("gather", x, np.array([[0, 3], [1, 1]], np.int64), kind="elementwise")
    both("scatter", x, np.array([1, 1, 3], np.int64),
         np.ones((3, 3), np.float32), overwrite=False, kind="elementwise")
    both("scatter", x, np.array([1, 2], np.int64),
         np.ones((2, 3), np.float32), kind="elementwise")
    both("expand", np.ones((1, 3), np.float32), [2, -1], kind="elementwise")
    both("std", x, 0)
    both("var", x, 1, False)
    a = np.array([7, -7, 7, -7], np.int64)
    b = np.array([3, 3, -3, -3], np.int64)
    both("remainder", a, b, kind="elementwise")
    both("floor_divide", a, b, kind="elementwise")
    both("remainder", a.astype(np.float32), b.astype(np.float32) * 0.75,
         kind="elementwise")
    both("floor_divide", a.astype(np.float32), b.astype(np.float32),
         kind="elementwise")
    u = np.array([3, 1, 3, 2, 1, 1], np.int64)
    both("unique", u, return_index=True, return_inverse=True,
         return_counts=True)
    both("unique", u.astype(np.float32))
    both("unique_consecutive", u, return_inverse=True, return_counts=True)
    both("count_nonzero", F32, 1)
    both("numel", F32)
