"""The tensor-op surface in static programs and under auto_cast, against
the JAX package: a program built with Python operators and surface
functions records the reference's op types and gives the reference
program's outputs; a reference-saved .pdmodel with elementwise_mul, scale
and reduce_sum loads and runs in the port; the amp-listed ops cast as
the reference's under auto_cast O1 (bfloat16 results within one bfloat16
rounding, BF16_TOL of the largest |value|); ops whose output size depends
on values raise inside a CUDA graph capture."""
import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import torch_ops_sweep as sw

import paddle_tpu as jp
from paddle_tpu import static as jstatic
from paddle_tpu.framework import place as jplace
import paddle_tpu_torch as pp
from paddle_tpu_torch import static
from paddle_tpu_torch.framework import place as pplace

jax.config.update("jax_platforms", "cpu")

FWD_TOL = 1e-5
BF16_TOL = 1e-2


@pytest.fixture
def static_modes():
    saved = (pplace._current_place, jplace._current_place)
    pp.set_device("cpu")
    jp.enable_static()
    jstatic.reset_default_programs()
    pp.enable_static()
    static.reset_default_programs()
    yield
    jp.disable_static()
    jstatic.reset_default_programs()
    pp.disable_static()
    static.reset_default_programs()
    pplace._current_place, jplace._current_place = saved


def _program(pkg, st):
    x = st.data("x", [-1, 3], "float32")
    y = st.data("y", [-1, 3], "float32")
    a = (x * 2.0 - y) / (y + 4.0) + x @ pkg.transpose(y, [1, 0])[:, :3]
    b = a ** 2 % 3.0 + (-x) // 2.0
    c = pkg.sum(b, 1) + pkg.mean(a * (x > y), axis=1)
    d = pkg.scale(pkg.clip(c, -5.0, 5.0), 0.5, 1.0)
    e = pkg.where(d >= 1.0, d, pkg.zeros_like(d)) + pkg.max(x, 1)
    f = pkg.concat([pkg.unsqueeze(e, 1), x[:, :2]], axis=1)
    return [x, y], [pkg.cumsum(f, 1), pkg.argmax(f, 1), x == y, x != y,
                    x < y, x <= 0.0]


def test_operators_record_the_reference_op_types(static_modes):
    jfeeds, jouts = _program(jp, jstatic)
    feeds, outs = _program(pp, static)
    jtypes = [op.op_type for op in jstatic.default_main_program().ops]
    types = [op.op_type for op in static.default_main_program().ops]
    assert types == jtypes
    for t in ("elementwise_mul", "elementwise_sub", "elementwise_div",
              "elementwise_add", "matmul_v2", "elementwise_pow",
              "elementwise_mod", "elementwise_floordiv", "neg",
              "greater_than", "reduce_sum", "reduce_mean", "scale_op",
              "clip", "greater_equal", "where", "reduce_max", "concat_op",
              "unsqueeze2", "getitem", "cumsum", "argmax", "equal",
              "not_equal", "less_than", "less_equal", "transpose2"):
        assert t in types, t
    rs = np.random.RandomState(0)
    feed = {"x": rs.randn(5, 3).astype(np.float32),
            "y": rs.randn(5, 3).astype(np.float32)}
    feed["y"][1] = feed["x"][1]
    want = jstatic.Executor().run(feed=feed, fetch_list=jouts)
    got = static.Executor().run(feed=feed, fetch_list=outs)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if w.dtype.kind == "f":
            assert np.abs(g - w).max() <= FWD_TOL * max(1, np.abs(w).max())
        else:
            np.testing.assert_array_equal(g, w)


def test_a_reference_pdmodel_with_surface_ops_loads(static_modes,
                                                    tmp_path):
    x = jstatic.data("x", [-1, 4], "float32")
    w = jp.to_tensor(np.linspace(-1, 1, 4).astype(np.float32))
    y = jp.sum(jp.scale(x * w, 3.0, 0.5), axis=1, keepdim=True)
    exe = jstatic.Executor()
    a = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    (want,) = exe.run(feed={"x": a}, fetch_list=[y])
    prefix = str(tmp_path / "ref_surface")
    jstatic.save_inference_model(prefix, [x], [y], exe)
    types = [op.op_type for op in jstatic.default_main_program().ops]
    assert {"elementwise_mul", "scale_op", "reduce_sum"} <= set(types)
    pp.disable_static()
    prog, feeds, fetches = static.load_inference_model(prefix)
    assert [op.op_type for op in prog.ops] == types
    (got,) = static.Executor().run(prog, feed={feeds[0]: a},
                                   fetch_list=fetches)
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= FWD_TOL


def test_identity_scale_clean_pass_meets_a_recorded_scale(static_modes):
    """The pass that matches `scale` (identity_scale_clean) now sees the
    surface's scale ops, as the reference's pass does."""
    out = []
    for pkg, st in ((jp, jstatic), (pp, static)):
        x = st.data("x", [2, 3], "float32")
        y = pkg.scale(x, 1.0, 0.0) * 2.0
        prog = st.default_main_program()
        before = [op.op_type for op in prog.ops]
        st.apply_pass(prog, "identity_scale_clean_pass")
        out.append((before, [op.op_type for op in prog.ops]))
    assert out[0] == out[1]


AMP_OPS = {
    # op: (inputs, attrs)
    "exp": ([sw.U(-1, 1)], {}), "log": ([sw.U(0.5, 2)], {}),
    "log2": ([sw.U(0.5, 2)], {}), "log10": ([sw.U(0.5, 2)], {}),
    "log1p": ([sw.U(0.5, 2)], {}),
    "reduce_mean": ([sw.U(-1, 1)], {"axis": 1}),
    "reduce_sum": ([sw.U(-1, 1)], {}),
    "reduce_prod": ([sw.U(0.5, 1.5)], {"axis": 0}),
    "cumsum": ([sw.U(-1, 1)], {"axis": 1}),
    "logsumexp": ([sw.U(-1, 1)], {"axis": 1}),
    "p_norm": ([sw.U(-1, 1)], {"porder": 3.0, "axis": 1}),
    "frobenius_norm": ([sw.U(-1, 1)], {}),
    "bmm": ([sw.U(-1, 1, (2, 3, 4)), sw.U(-1, 1, (2, 4, 5))], {}),
    "mv": ([sw.U(-1, 1, (3, 4)), sw.U(-1, 1, (4,))], {}),
    "addmm": ([sw.U(-1, 1, (3, 5)), sw.U(-1, 1, (3, 4)),
               sw.U(-1, 1, (4, 5))], {}),
    "dot": ([sw.U(-1, 1, (5,)), sw.U(-1, 1, (5,))], {}),
    "einsum_op": ([sw.U(-1, 1, (3, 4)), sw.U(-1, 1, (4, 5))],
                  {"equation": "ij,jk->ik"}),
    "mul": ([sw.U(-1, 1, (3, 4)), sw.U(-1, 1, (4, 5))], {}),
    "matmul_v2": ([sw.U(-1, 1, (3, 4)), sw.U(-1, 1, (4, 5))], {}),
}


@pytest.mark.parametrize("op", sorted(AMP_OPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_amp_listed_ops_cast_as_the_reference(op, dtype):
    """Under auto_cast O1 a white-listed op computes in bfloat16, a
    black-listed one in float32, from float32 and from bfloat16 inputs;
    dtype exact, values within BF16_TOL of the largest |value|."""
    makers, attrs = AMP_OPS[op]
    rs = np.random.RandomState(5)
    arrays = [m(rs) for m in makers]
    jins = [jp.cast(jp.to_tensor(a), dtype) for a in arrays]
    pins = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    with jp.amp.auto_cast(level="O1"):
        want = sw.REF_OPS[op](*jins, **attrs)
    with pp.amp.auto_cast(level="O1"):
        got = sw.PORT_OPS[op](*pins, **attrs)
    wd = want.dtype.name
    gd = str(got.dtype).replace("torch.", "")
    assert gd == wd, (op, gd, wd)
    assert wd == ("bfloat16" if op in pp.amp.WHITE_LIST else "float32")
    w = np.asarray(want._data, np.float32)
    g = got.float().numpy()
    assert np.abs(g - w).max() <= BF16_TOL * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("fn", [
    lambda x: pp.nonzero(x), lambda x: pp.masked_select(x, x > 0),
    lambda x: pp.unique(x), lambda x: pp.tensor.getitem(x, x > 0),
    lambda x: pp.bincount(x.long().abs())])
def test_data_dependent_shapes_raise_inside_a_capture(fn, monkeypatch):
    """nonzero, masked_select, unique, a bool index and bincount read
    their size on the host: inside a CUDA graph capture they raise
    instead of baking one shape in (simulated on the CPU)."""
    x = torch.tensor([1.0, -2.0, 3.0])
    fn(x)                                   # eagerly: fine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        fn(x)
