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


# -- the static-recording repair: calls that raised in the port ------------

def _mha(pkg):
    jp.seed(0)
    return pkg.nn.MultiHeadAttention(8, 2)


def _moe(pkg):
    jp.seed(0)
    return pkg.incubate.MoELayer(8, 16, 4, top_k=2)


def _carry(jlayer, player):
    from paddle_tpu_torch.models import load_reference_state
    load_reference_state(player, {k: np.asarray(v.numpy()) for k, v in
                                  jlayer.state_dict().items()})


# name: (the reference's op types the port must record too, feeds (name,
# shape, dtype), build(pkg, F, feeds, layer) -> fetches, layer factory)
STATIC_CALLS = {
    "log_softmax": (
        {"log_softmax_op"}, [("x", [3, 5], "float32")],
        lambda P, F, v, L: [F.log_softmax(v[0], axis=1)], None),
    "kl_div_of_log_softmax": (
        {"log_softmax_op", "kldiv_loss_op"},
        [("x", [3, 5], "float32"), ("y", [3, 5], "float32")],
        lambda P, F, v, L: [F.kl_div(F.log_softmax(v[0]), v[1])], None),
    "softmax_dtype": (
        {"cast", "softmax_op"}, [("x", [3, 5], "float32")],
        lambda P, F, v, L: [F.softmax(v[0], dtype="float64")], None),
    "sdpa_masked": (
        {"scaled_dot_product_attention"},
        [("q", [2, 2, 4, 8], "float32"), ("k", [2, 2, 4, 8], "float32"),
         ("v", [2, 2, 4, 8], "float32"), ("m", [2, 1, 4, 4], "float32")],
        lambda P, F, v, L: [_sdpa_out(F.scaled_dot_product_attention(
            v[0], v[1], v[2], attn_mask=v[3]))], None),
    "mha_masked": (
        {"scaled_dot_product_attention"},
        [("x", [2, 4, 8], "float32"), ("m", [2, 1, 4, 4], "float32")],
        lambda P, F, v, L: [L(v[0], v[0], v[0], attn_mask=v[1])], _mha),
    "cross_entropy_weight": (
        {"softmax_with_cross_entropy", "lookup_table_v2"},
        [("x", [6, 4], "float32"), ("y", [6], "int64"),
         ("w", [4], "float32")],
        lambda P, F, v, L: [F.cross_entropy(v[0], v[1], weight=v[2])],
        None),
    "cross_entropy_ignore": (
        {"softmax_with_cross_entropy", "cast"},
        [("x", [6, 4], "float32"), ("y", [6], "int64")],
        lambda P, F, v, L: [F.cross_entropy(v[0], v[1], ignore_index=1)],
        None),
    "l1_loss": (
        {"abs", "reduce_mean"},
        [("x", [3, 4], "float32"), ("y", [3, 4], "float32")],
        lambda P, F, v, L: [F.l1_loss(v[0], v[1])], None),
    "batch_norm_no_stats": (
        {"batch_norm_train"}, [("x", [4, 3, 2, 2], "float32")],
        lambda P, F, v, L: [_first(F.batch_norm(v[0], None, None,
                                                training=True))], None),
    "fused_ln": (
        {"fused_bias_dropout_residual_layer_norm"},
        [("x", [4, 8], "float32"), ("r", [4, 8], "float32")],
        lambda P, F, v, L: [
            P.incubate.nn.functional.fused_bias_dropout_residual_layer_norm(
                v[0], v[1], dropout_rate=0.0)], None),
    "fused_residual": (
        {"fused_bias_dropout_residual"},
        [("x", [4, 8], "float32"), ("r", [4, 8], "float32")],
        lambda P, F, v, L: [
            P.incubate.nn.functional.fused_bias_dropout_residual(
                v[0], v[1], dropout_rate=0.0)], None),
    "fused_ln_pair": (
        {"fused_bias_dropout_residual_ln_pair"},
        [("x", [4, 8], "float32"), ("r", [4, 8], "float32")],
        lambda P, F, v, L: list(
            P.incubate.nn.functional.fused_bias_dropout_residual_ln_pair(
                v[0], v[1], dropout_rate=0.0)), None),
    "moe": (
        {"softmax_op", "einsum_op"}, [("x", [2, 6, 8], "float32")],
        lambda P, F, v, L: [L(v[0])], _moe),
}


def _sdpa_out(out):
    """The reference's F.sdpa returns (out, weights); the port's out."""
    return out[0] if isinstance(out, tuple) else out


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _feed(feeds):
    rs = np.random.RandomState(11)
    out = {}
    for name, shape, dtype in feeds:
        if dtype == "int64":
            out[name] = rs.randint(0, shape[-1] if name != "y" else 4,
                                   shape).astype(np.int64)
        elif name == "m":
            out[name] = np.where(rs.rand(*shape) > 0.3, 0.0,
                                 -1e9).astype(np.float32)
        elif name == "w":
            out[name] = rs.rand(*shape).astype(np.float32) + 0.5
        else:
            out[name] = rs.randn(*shape).astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(STATIC_CALLS))
def test_static_calls_that_raised_now_record(name, static_modes):
    """Each call builds under static mode in both packages: the port
    records the reference's op types (the registered ones the reference
    records for it) and runs through Executor to the reference program's
    result (FWD_TOL of the largest |value|, 1e-4 for the MoE block's
    einsums)."""
    from paddle_tpu.framework.flags import set_flags as jset
    from paddle_tpu_torch.framework.flags import set_flags as pset
    types, feeds, build, layer = STATIC_CALLS[name]
    fused = name.startswith("fused")
    jset({"FLAGS_use_fused_dropout_ln": fused})
    pset({"use_fused_dropout_ln": fused})
    try:
        if layer is not None:
            pp.disable_static()
            jp.disable_static()
            jl, pl = layer(jp), layer(pp)
            _carry(jl, pl)
            jp.enable_static()
            pp.enable_static()
        else:
            jl = pl = None
        jvars = [jstatic.data(n, s, d) for n, s, d in feeds]
        pvars = [static.data(n, s, d) for n, s, d in feeds]
        jouts = build(jp, jp.nn.functional, jvars, jl)
        pouts = build(pp, pp.nn.functional, pvars, pl)
        jtypes = {op.op_type for op in jstatic.default_main_program().ops}
        ptypes = {op.op_type for op in static.default_main_program().ops}
        assert types <= jtypes, (types - jtypes)
        assert types <= ptypes, (types - ptypes, ptypes)
        feed = _feed(feeds)
        want = jstatic.Executor().run(feed=feed, fetch_list=jouts)
        got = static.Executor().run(feed=feed, fetch_list=pouts)
    finally:
        jset({"FLAGS_use_fused_dropout_ln": False})
        pset({"use_fused_dropout_ln": False})
    tol = 1e-4 if name == "moe" else FWD_TOL
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if name == "cross_entropy_ignore":
            # the reference's mean is label-shaped, each element the mean
            # (ROADMAP queue 3, red reference behaviour); the port's is 0-d
            assert w.shape == (6,) and np.ptp(w) == 0.0
            w = w[0]
        assert g.shape == w.shape, (g.shape, w.shape)
        assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max())


def test_static_attention_with_dropout_records_and_runs(static_modes):
    """The plain attention route with dropout in training: the op
    scaled_dot_product_attention records (its keep mask drawn at each
    run, none while recording), and a run gives finite values of the
    reference's shape, zeros where the mask dropped a whole row's
    weights."""
    q = static.data("q", [2, 2, 4, 8], "float32")
    m = static.data("m", [2, 1, 4, 4], "float32")
    out = pp.nn.functional.scaled_dot_product_attention(
        q, q, q, attn_mask=m, dropout_p=0.5)
    types = [op.op_type for op in static.default_main_program().ops]
    assert types == ["scaled_dot_product_attention"]
    feed = _feed([("q", [2, 2, 4, 8], "float32"),
                  ("m", [2, 1, 4, 4], "float32")])
    a, b = (np.asarray(r) for r in static.Executor().run(
        feed=feed, fetch_list=[out, out]))
    assert a.shape == (2, 2, 4, 8) and np.isfinite(a).all()
    (c,) = static.Executor().run(feed=feed, fetch_list=[out])
    assert not np.array_equal(np.asarray(c), a)
