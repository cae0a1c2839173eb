"""The port's program passes (paddle_tpu_torch/static/passes.py) against
the JAX package's, on the CPU, on the models of tests/test_static_passes.py
and tests/test_fusion_passes.py: each program is built in both packages
from the same weights, the same pass runs on each, and the op types the
executor runs afterwards (the backward slice of the fetches) must be the
reference's, op for op; the outputs after the pass are held to the same
program's before it, and to the reference's.

Tolerances, relative to the largest |value| (at least 1): float32 1e-6
where the pass leaves the arithmetic as it was (dropout and identity
removal, fc_op, the fused add + activation), 1e-5 where it refolds
weights (conv + batch norm: the weights rounded once more); the
bfloat16 compute of amp_bf16_pass 2e-2 against float32 (bfloat16's
2^-9 rounding of the inputs and of the output) and 1e-2 against the
reference's bfloat16 (one bfloat16 ulp of the largest output).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu.framework import place as jplace
from paddle_tpu.static.passes import apply_inference_fusion as japply_fusion
from paddle_tpu.static.program import prune_ops as jprune
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn, static
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.static.passes import apply_inference_fusion
from paddle_tpu_torch.static.program import prune_ops
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

SAME_TOL, FOLD_TOL, BF16_TOL, BF16_REF_TOL = 1e-6, 1e-5, 2e-2, 1e-2


@pytest.fixture(autouse=True)
def static_modes():
    saved = pplace._current_place, jplace._current_place
    paddle.set_device("cpu")
    for pkg, st in ((jpaddle, jstatic), (paddle, static)):
        pkg.enable_static()
        st.reset_default_programs()
    yield
    for pkg, st in ((jpaddle, jstatic), (paddle, static)):
        pkg.disable_static()
        st.reset_default_programs()
    pplace._current_place, jplace._current_place = saved


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _carry(ref, port):
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})


def _compiled(prog, fetches, prune):
    ops, _ = prune(prog.ops, {v.name for v in fetches})
    return [o.op_type for o in ops]


class Pair:
    """One program in both packages: `ref`/`port` are (program, feed
    names, fetch Variables, executor)."""

    def __init__(self, build):
        jpaddle.seed(0)
        self.ref = build(jpaddle, jstatic, jnn, jnn.functional, None)
        self.port = build(paddle, static, nn, F, self.ref)

    def run(self, progs, feed):
        """Outputs of (reference program, port program) on `feed`."""
        (jp, jfetch, jexe), (pp, pfetch, pexe) = progs
        return (jexe.run(jp, feed=feed, fetch_list=jfetch),
                pexe.run(pp, feed=feed, fetch_list=pfetch))

    def programs(self, jp=None, pp=None):
        return ((jp or self.ref[0], self.ref[1], self.ref[2]),
                (pp or self.port[0], self.port[1], self.port[2]))

    def types(self, jp, pp):
        return (_compiled(jp, self.ref[1], jprune),
                _compiled(pp, self.port[1], prune_ops))


def _conv_bn_relu(pkg, st, nnmod, Fm, ref):
    """test_fusion_passes.py `_build_conv_bn_relu`: conv (with bias) ->
    batch norm (seeded statistics) -> relu, cloned for test."""
    x = st.data("img", [-1, 3, 8, 8], "float32")
    conv = nnmod.Conv2D(3, 8, 3, padding=1)
    bn = nnmod.BatchNorm2D(8)
    if ref is not None:
        _carry(ref[3][0], conv)
        _carry(ref[3][1], bn)
    else:
        bn._mean.set_value(np.random.RandomState(1).rand(8)
                           .astype(np.float32))
        bn._variance.set_value((np.random.RandomState(2).rand(8) + 0.5)
                               .astype(np.float32))
        bn.weight.set_value((np.random.RandomState(3).rand(8) + 0.5)
                            .astype(np.float32))
        bn.bias.set_value(np.random.RandomState(4).rand(8)
                          .astype(np.float32))
    c = conv(x)
    y = Fm.relu(bn(c))
    infer = st.default_main_program().clone(for_test=True)
    return infer, [y], st.Executor(), (conv, bn), c


def test_conv_bn_fuse_through_the_inference_fusion():
    pair = Pair(_conv_bn_relu)
    a = np.random.RandomState(5).randn(2, 3, 8, 8).astype(np.float32)
    before = pair.run(pair.programs(), {"img": a})
    jf = japply_fusion(pair.ref[0])
    pf = apply_inference_fusion(pair.port[0])
    jt, pt = pair.types(jf, pf)
    assert pt == jt == ["conv2d_op", "fused_elemwise_add_act"]
    assert [o.op_type for o in pair.port[0].ops] == [
        o.op_type for o in pair.ref[0].ops]           # the source untouched
    after = pair.run(pair.programs(jf, pf), {"img": a})
    assert _rel(after[1][0], before[1][0]) <= FOLD_TOL
    assert _rel(after[1][0], after[0][0]) <= FOLD_TOL
    assert _rel(before[1][0], before[0][0]) <= SAME_TOL


def test_conv_bn_fuse_pass_alone_and_its_veto():
    pair = Pair(_conv_bn_relu)
    a = np.random.RandomState(6).randn(1, 3, 8, 8).astype(np.float32)
    jc, pc = pair.ref[4], pair.port[4]
    jp, pp = pair.ref[0].clone(), pair.port[0].clone()
    src_refs = [list(o.in_refs) for o in pair.port[0].ops]
    jstatic.apply_pass(jp, "conv_bn_fuse_pass")
    static.apply_pass(pp, "conv_bn_fuse_pass")
    assert [list(o.in_refs) for o in pair.port[0].ops] == src_refs
    jt, pt = pair.types(jp, pp)
    assert pt == jt == ["conv2d_op", "elementwise_add", "relu"]
    out = pair.run(pair.programs(jp, pp), {"img": a})
    assert _rel(out[1][0], out[0][0]) <= FOLD_TOL
    # fetching the conv's own output vetoes the fold
    for fuse, prog, c in ((japply_fusion, pair.ref[0], jc),
                          (apply_inference_fusion, pair.port[0], pc)):
        fused = fuse(prog, protected={c.name})
        assert "batch_norm_infer" in [o.op_type for o in fused.ops]
    raw = static.Executor().run(pair.port[0], feed={"img": a},
                                fetch_list=[pc])[0]
    kept = apply_inference_fusion(pair.port[0], protected={pc.name})
    got = static.Executor().run(kept, feed={"img": a}, fetch_list=[pc])[0]
    np.testing.assert_array_equal(got, raw)


def test_batch_norm_without_a_conv_is_kept():
    def build(pkg, st, nnmod, Fm, ref):
        x = st.data("x", [-1, 4, 6, 6], "float32")
        y = nnmod.BatchNorm2D(4)(x)
        return st.default_main_program().clone(for_test=True), [y], \
            st.Executor()
    pair = Pair(build)
    jt, pt = pair.types(japply_fusion(pair.ref[0]),
                        apply_inference_fusion(pair.port[0]))
    assert pt == jt == ["batch_norm_infer"]


def _linear_softmax(pkg, st, nnmod, Fm, ref):
    x = st.data("x", [-1, 6], "float32")
    lin = nnmod.Linear(6, 4)
    if ref is not None:
        _carry(ref[3], lin)
    y = Fm.softmax(lin(x))
    return st.default_main_program(), [y], st.Executor(), lin


def test_fc_fuse_pass():
    pair = Pair(_linear_softmax)
    a = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    before = pair.run(pair.programs(), {"x": a})
    jp, pp = pair.ref[0].clone(), pair.port[0].clone()
    jstatic.apply_pass(jp, "fc_fuse_pass")
    static.apply_pass(pp, "fc_fuse_pass")
    jt, pt = pair.types(jp, pp)
    assert pt == jt == ["fc_op", "softmax_op"]
    after = pair.run(pair.programs(jp, pp), {"x": a})
    assert _rel(after[1][0], before[1][0]) <= SAME_TOL
    assert _rel(after[1][0], after[0][0]) <= SAME_TOL


def test_a_matmul_with_a_graph_bias_is_not_fused():
    def build(pkg, st, nnmod, Fm, ref):
        x = st.data("x", [-1, 4], "float32")
        b = st.data("b", [-1, 2], "float32")
        y = nnmod.Linear(4, 2)(x) + b
        return st.default_main_program(), [y], st.Executor()
    pair = Pair(build)
    jt, pt = pair.types(japply_fusion(pair.ref[0]),
                        apply_inference_fusion(pair.port[0]))
    assert pt == jt == ["fc_op", "elementwise_add"]


def _add_act(act):
    def build(pkg, st, nnmod, Fm, ref):
        x = st.data("x", [-1, 5], "float32")
        z = st.data("z", [-1, 5], "float32")
        y = (Fm.gelu(x + z, approximate=True) if act == "gelu"
             else getattr(Fm, act)(x + z))
        return st.default_main_program(), [y], st.Executor()
    return build


@pytest.mark.parametrize("act", ["relu", "gelu", "relu6", "sigmoid"])
def test_fuse_elewise_add_act_pass(act):
    pair = Pair(_add_act(act))
    feed = {"x": np.random.RandomState(1).randn(2, 5).astype(np.float32),
            "z": np.random.RandomState(2).randn(2, 5).astype(np.float32)}
    before = pair.run(pair.programs(), feed)
    jp, pp = pair.ref[0].clone(), pair.port[0].clone()
    jstatic.apply_pass(jp, "fuse_elewise_add_act_pass")
    static.apply_pass(pp, "fuse_elewise_add_act_pass")
    jt, pt = pair.types(jp, pp)
    assert pt == jt == ["fused_elemwise_add_act"]
    assert pp.ops[-1].attrs == jp.ops[-1].attrs
    after = pair.run(pair.programs(jp, pp), feed)
    assert _rel(after[1][0], before[1][0]) <= SAME_TOL
    assert _rel(after[1][0], after[0][0]) <= SAME_TOL


def test_an_add_with_two_consumers_is_not_fused():
    def build(pkg, st, nnmod, Fm, ref):
        x = st.data("x", [-1, 5], "float32")
        z = st.data("z", [-1, 5], "float32")
        s = x + z
        return st.default_main_program(), [Fm.relu(s), s + s], st.Executor()
    pair = Pair(build)
    jt, pt = pair.types(japply_fusion(pair.ref[0]),
                        apply_inference_fusion(pair.port[0]))
    assert pt == jt == ["elementwise_add", "relu", "elementwise_add"]


def _dropout_double(pkg, st, nnmod, Fm, ref):
    x = st.data("x", [-1, 8], "float32")
    h = Fm.dropout(x, 0.5, training=True)
    return st.default_main_program(), [h + h], st.Executor(), h


def test_delete_dropout_pass():
    pair = Pair(_dropout_double)
    jp, pp = pair.ref[0], pair.port[0]
    assert [o.op_type for o in pp.ops] == [o.op_type for o in jp.ops] == [
        "dropout_op", "elementwise_add"]
    jstatic.apply_pass(jp, "delete_dropout_pass")
    static.apply_pass(pp, "delete_dropout_pass")
    jt, pt = pair.types(jp, pp)
    assert pt == jt == ["elementwise_add"]
    a = np.ones((2, 8), np.float32)
    out = pair.run(pair.programs(), {"x": a})
    np.testing.assert_array_equal(out[1][0], 2 * a)
    np.testing.assert_array_equal(out[1][0], out[0][0])
    # the removed dropout's output stays fetchable through its alias
    (h,) = static.Executor().run(pp, feed={"x": a}, fetch_list=[pair.port[3]])
    np.testing.assert_array_equal(h, a)


def test_identity_scale_clean_pass():
    """clone(for_test=True) turns dropout into identity; the clean pass
    removes it and the identity's output resolves through its alias."""
    pair = Pair(_dropout_double)
    jp = pair.ref[0].clone(for_test=True)
    pp = pair.port[0].clone(for_test=True)
    assert [o.op_type for o in pp.ops] == [o.op_type for o in jp.ops] == [
        "identity", "elementwise_add"]
    jstatic.apply_pass(jp, "identity_scale_clean_pass")
    static.apply_pass(pp, "identity_scale_clean_pass")
    assert [o.op_type for o in pp.ops] == [o.op_type for o in jp.ops] == [
        "elementwise_add"]
    a = np.random.RandomState(5).randn(2, 8).astype(np.float32)
    out = pair.run(pair.programs(jp, pp), {"x": a})
    np.testing.assert_array_equal(out[1][0], out[0][0])
    h, y = static.Executor().run(pp, feed={"x": a},
                                 fetch_list=[pair.port[3], pair.port[1][0]])
    np.testing.assert_array_equal(h, a)
    np.testing.assert_array_equal(y, a + a)


def test_amp_bf16_pass_changes_the_compute_dtype():
    pair = Pair(lambda pkg, st, nnmod, Fm, ref: _linear16(st, nnmod, ref))
    a = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    before = pair.run(pair.programs(), {"x": a})
    jstatic.apply_pass(pair.ref[0], "amp_bf16_pass")
    static.apply_pass(pair.port[0], "amp_bf16_pass")
    wrapped = [getattr(o.fn, "_pt_bf16", False) for o in pair.port[0].ops]
    assert wrapped == [True, False]                 # matmul_v2, not the add
    jt, pt = pair.types(pair.ref[0], pair.port[0])
    assert pt == jt == ["matmul_v2", "elementwise_add"]
    after = pair.run(pair.programs(), {"x": a})
    assert after[1][0].dtype == np.float32
    assert not np.allclose(after[1][0], before[1][0], atol=1e-7)
    assert _rel(after[1][0], before[1][0]) <= BF16_TOL
    assert _rel(after[1][0], after[0][0]) <= BF16_REF_TOL


def _linear16(st, nnmod, ref):
    x = st.data("x", [-1, 16], "float32")
    lin = nnmod.Linear(16, 16)
    if ref is not None:
        _carry(ref[3], lin)
    return st.default_main_program(), [lin(x)], st.Executor(), lin


def test_pass_manager_and_the_registry():
    x = static.data("x", [-1, 8], "float32")
    y = F.dropout(x, 0.5, training=True)
    prog = static.default_main_program()
    v0 = prog.version
    static.PassManager(["delete_dropout_pass"]).apply(prog)
    assert prog.ops == [] and prog.version > v0
    assert prog.aliases[y.name] == ("var", "x")
    with pytest.raises(KeyError, match="no_such_pass"):
        static.apply_pass(prog, "no_such_pass")
