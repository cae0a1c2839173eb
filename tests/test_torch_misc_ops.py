"""The long-tail ops (ops/misc_ops.py) and fluid.layers of the port
against the JAX package's, on the CPU.

Each op runs through `torch_ops_sweep.check_op`: the reference sweep's
inputs (tests/test_op_auto.py SPECS) or chip_smoke.py's LEGACY_SPECS
where the reference sweep white-lists the op, dtypes exact, values
within 1e-4 of the largest |value| (1e-5 one-element ops), the vjp
within 1e-4. The edges named for this slice: hash_op's words whose mix
has its top bit set (bit-equal), viterbi_decode at ties (bit-equal
paths, the reference's tie order), the CRF's gradient against jax.vjp,
nce and shuffle_batch on the reference's own draws (their draws differ
by design: a torch generator against a JAX key), space_to_depth's
darknet channel order, fill_diagonal in both wrap modes and offsets,
segment_pool's four pool types. fluid.layers over the new ops in
dygraph against the reference's fluid.layers, and recorded in a static
program run by the Executor against the same calls in dygraph.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.framework.dispatch import OPS as JOPS
from paddle_tpu.ops import misc_ops as jmisc

import paddle_tpu_torch as paddle
from paddle_tpu_torch import fluid
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.ops import misc_ops

import chip_smoke as cs
import torch_ops_sweep as sw
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

# the reference sweep's inputs
SWEPT = ["affine_channel_op", "cvm_op", "center_loss_op",
         "squared_l2_distance_op", "teacher_student_sigmoid_loss_op",
         "fused_embedding_seq_pool_op", "squared_l2_norm_op",
         "hinge_loss_op", "rank_loss_op", "bpr_loss_op", "fsp_op",
         "pad_constant_like_op", "conv_shift_op", "row_conv_op",
         "correlation_op", "positive_negative_pair_op",
         "filter_by_instag_op", "beam_search_step_op", "data_norm_op",
         "linear_chain_crf_op", "hash_op", "fill_diagonal_op",
         "space_to_depth_op", "prroi_pool_op", "lookup_table_v2_sparse"]
# chip_smoke's inputs (white-listed or fed nothing by the reference sweep)
LEGACY = ["viterbi_decode_op", "segment_pool_op", "py_func_op",
          "center_loss_op", "squared_l2_distance_op", "hinge_loss_op",
          "rank_loss_op", "fill_diagonal_op", "hash_op", "space_to_depth_op",
          "beam_search_step_op", "filter_by_instag_op",
          "positive_negative_pair_op", "lookup_table_v2_sparse"]


@pytest.fixture(autouse=True)
def on_cpu():
    saved = pplace._current_place
    paddle.set_device("cpu")
    yield
    pplace._current_place = saved


@pytest.mark.parametrize("op", SWEPT)
def test_op_against_the_reference_sweep(op):
    sw.check_op(op)


@pytest.mark.parametrize("op", LEGACY)
def test_op_against_the_reference_on_legacy_specs(op):
    arrays, attrs = cs.legacy_inputs(op)
    floats = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    diff = [] if JOPS[op].nondiff else floats
    if op == "center_loss_op":
        attrs["need_update"] = False
        diff = [0]
    if op in ("teacher_student_sigmoid_loss_op", "rank_loss_op",
              "hinge_loss_op", "positive_negative_pair_op"):
        diff = [i for i in diff if i != (0 if op == "rank_loss_op" else 1)]
    sw.check_op(op, arrays, attrs, diff)


@pytest.mark.parametrize("pooltype", ["SUM", "MEAN", "MAX", "MIN"])
def test_segment_pool_each_pooltype(pooltype):
    x = np.random.RandomState(0).rand(7, 3).astype(np.float32)
    ids = np.array([0, 0, 1, 1, 1, 4, 4], np.int64)
    sw.check_op("segment_pool_op", [x, ids], {"pooltype": pooltype}, [0])


def test_hash_op_high_bits_are_the_references():
    ids = np.array([[0], [1], [7], [2 ** 31 + 5], [2 ** 40 + 7],
                    [2 ** 62 + 3], [-5], [987654321012]], np.int64)
    # the mix of some of these words has its top bit set, where a signed
    # shift or modulus would go wrong
    h = ids.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    assert (h >> np.uint64(63)).any()
    for mod_by in (100000007, 7, 2 ** 31 - 1):
        got = misc_ops.hash_bucket.fn(torch.from_numpy(ids), num_hash=4,
                                      mod_by=mod_by)
        want = np.asarray(JOPS["hash_op"].fn(jnp.asarray(ids), num_hash=4,
                                             mod_by=mod_by))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_decode_ties_take_the_references_order():
    rs = np.random.RandomState(0)
    # small integer scores: many exact ties between paths
    pot = rs.randint(0, 2, (4, 6, 3)).astype(np.float32)
    trans = rs.randint(0, 2, (3, 3)).astype(np.float32)
    lens = np.array([6, 4, 1, 3], np.int64)
    for bos in (True, False):
        s, p = misc_ops.viterbi_decode.fn(
            torch.from_numpy(pot), torch.from_numpy(trans),
            torch.from_numpy(lens), include_bos_eos_tag=bos)
        js, jp = JOPS["viterbi_decode_op"].fn(
            jnp.asarray(pot), jnp.asarray(trans), jnp.asarray(lens),
            include_bos_eos_tag=bos)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        assert p.dtype == torch.int64
    s, p = paddle.text.viterbi_decode(torch.from_numpy(pot),
                                      torch.from_numpy(trans),
                                      torch.from_numpy(lens))
    s2, p2 = paddle.text.ViterbiDecoder(torch.from_numpy(trans))(
        torch.from_numpy(pot), torch.from_numpy(lens))
    assert torch.equal(p, p2) and torch.equal(s, s2)


def test_linear_chain_crf_gradient_against_jax_vjp():
    arrays, _ = cs.legacy_inputs("linear_chain_crf_op")
    em, tr, lab, ln = arrays
    ct = np.random.RandomState(1).rand(2, 1).astype(np.float32)
    _, vjp = jax.vjp(lambda e, t: JOPS["linear_chain_crf_op"].fn(
        e, t, jnp.asarray(lab), jnp.asarray(ln)), jnp.asarray(em),
        jnp.asarray(tr))
    je, jt = vjp(jnp.asarray(ct))
    e = torch.from_numpy(em).requires_grad_(True)
    t = torch.from_numpy(tr).requires_grad_(True)
    out = misc_ops.linear_chain_crf.fn(e, t, torch.from_numpy(lab),
                                       torch.from_numpy(ln))
    ge, gt = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [e, t])
    np.testing.assert_allclose(ge.numpy(), np.asarray(je), atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jt), atol=1e-5)


def test_nce_on_the_references_negatives():
    arrays, attrs = cs.legacy_inputs("nce_op")
    x, w, b, lab, key = arrays
    k, V = attrs["num_neg_samples"], attrs["num_total_classes"]
    neg = np.asarray(jax.random.randint(
        jmisc._as_prng_key(jnp.asarray(key)), (x.shape[0], k), 0, V))
    want = JOPS["nce_op"].fn(*[jnp.asarray(a) for a in arrays], **attrs)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    got = misc_ops.nce_loss(*ins, torch.from_numpy(lab).reshape(-1),
                            torch.from_numpy(neg), float(np.log(k / V)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    ct = np.random.RandomState(2).rand(*got.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *t: JOPS["nce_op"].fn(
        *t, jnp.asarray(lab), jnp.asarray(key), **attrs),
        *[jnp.asarray(a) for a in (x, w, b)])
    for g, jg in zip(torch.autograd.grad((got * torch.from_numpy(ct)).sum(),
                                         ins), vjp(jnp.asarray(ct))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
    # the port's own draws: a seeded torch generator, in range, repeatable
    a = misc_ops.nce.fn(*[torch.from_numpy(v) for v in arrays], **attrs)
    b2 = misc_ops.nce.fn(*[torch.from_numpy(v) for v in arrays], **attrs)
    assert torch.equal(a, b2) and a.shape == (x.shape[0], 1)


def test_shuffle_batch_on_the_references_permutation():
    x = np.random.RandomState(3).rand(6, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jout, jperm = JOPS["shuffle_batch_op"].fn(jnp.asarray(x), key)
    t = torch.from_numpy(x).requires_grad_(True)
    out, perm = misc_ops.shuffle_rows(t, torch.from_numpy(
        np.asarray(jperm, np.int64)))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    (g,) = torch.autograd.grad(out.sum() * 2.0, [t])
    np.testing.assert_array_equal(g.numpy(), 2.0)
    # the port's draw: a permutation, the same for the same key
    o1, p1 = misc_ops.shuffle_batch.fn(torch.from_numpy(x), 7)
    o2, p2 = misc_ops.shuffle_batch.fn(torch.from_numpy(x), torch.tensor(7))
    assert torch.equal(p1, p2)
    assert sorted(p1.tolist()) == list(range(6))
    np.testing.assert_array_equal(o1.numpy(), x[p1.numpy()])


def test_space_to_depth_keeps_the_darknet_channel_order():
    x = np.arange(1 * 8 * 4 * 4, dtype=np.float32).reshape(1, 8, 4, 4)
    got = misc_ops.space_to_depth.fn(torch.from_numpy(x), blocksize=2)
    want = np.asarray(JOPS["space_to_depth_op"].fn(jnp.asarray(x),
                                                   blocksize=2))
    np.testing.assert_array_equal(got.numpy(), want)
    # not pixel_unshuffle's order
    assert not np.array_equal(
        got.numpy(), torch.nn.functional.pixel_unshuffle(
            torch.from_numpy(x), 2).numpy())
    with pytest.raises(ValueError):
        misc_ops.space_to_depth.fn(torch.zeros(1, 6, 4, 4), blocksize=2)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("offset", [-1, 0, 2])
@pytest.mark.parametrize("shape", [(7, 3), (3, 5), (4, 4)])
def test_fill_diagonal_both_modes(wrap, offset, shape):
    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    sw.check_op("fill_diagonal_op", [x], {"value": -2.0, "offset": offset,
                                          "wrap": wrap}, [0])


def test_py_func_and_filter_by_instag_refuse_nothing_on_the_cpu():
    x = torch.arange(6.0).reshape(2, 3)
    out = misc_ops.py_func_call(x, func=lambda a: a * 2, out_shape=(2, 3),
                                out_dtype="float32")
    assert torch.equal(out, x * 2)
    rows, idx, wts = misc_ops.filter_by_instag(
        x, torch.tensor([[5, -1], [6, -1]]), torch.tensor([9]))
    assert rows.shape == (1, 3) and idx.tolist() == [0]
    assert wts.tolist() == [0.0]


# ---------------------------------------------------------------------------
# fluid.layers over the new ops


def _fluid_cases():
    rs = np.random.RandomState(7)
    x = rs.rand(4, 5).astype(np.float32)
    lab = rs.randint(0, 5, (4, 1)).astype(np.int64)
    one = rs.rand(4, 1).astype(np.float32)
    bin_ = (rs.rand(4, 1) > 0.5).astype(np.float32)
    emb = rs.rand(8, 3).astype(np.float32)
    ids = rs.randint(0, 8, (2, 4)).astype(np.int64)
    return [
        ("hinge_loss", (one, bin_), {}),
        ("rank_loss", (bin_, one, one[::-1].copy()), {}),
        ("bpr_loss", (x, lab), {}),
        ("squared_l2_distance", (x, x[:1].copy()), {}),
        ("squared_l2_norm", (x,), {}),
        ("continuous_value_model", (x + 1.0, x[:, :2].copy() + 1.0), {}),
        ("teacher_student_sigmoid_loss", (one, bin_), {}),
        ("fused_embedding_seq_pool", (emb, None, ids), {}),
        ("fsp_matrix", (rs.rand(2, 3, 4, 4).astype(np.float32),
                        rs.rand(2, 2, 4, 4).astype(np.float32)), {}),
        ("pad_constant_like", (x, x[:2, :3].copy()), {"pad_value": 1.5}),
        ("conv_shift", (x, x[:, :3].copy()), {}),
        ("data_norm", (x, np.full((5,), 4.0, np.float32),
                       x.sum(0), (x * x).sum(0) + 1.0), {}),
        ("affine_channel", (x, x[0].copy(), x[1].copy()), {}),
    ]


def _as(mod, a):
    if a is None or not isinstance(a, np.ndarray):
        return a
    return (jpaddle.to_tensor(a) if mod is jpaddle.fluid
            else torch.from_numpy(a))


@pytest.mark.parametrize("case", _fluid_cases(), ids=lambda c: c[0])
def test_fluid_layers_in_dygraph_against_the_reference(case):
    name, args, kw = case
    got = getattr(fluid.layers, name)(*[_as(fluid, a) for a in args], **kw)
    want = getattr(jpaddle.fluid.layers, name)(
        *[_as(jpaddle.fluid, a) for a in args], **kw)
    for g, w in zip(sw._tup(got), sw._tup(want)):
        g, gn = sw._np(g)
        w, wn = sw._np(w.numpy() if hasattr(w, "numpy") else w)
        assert gn == wn, (name, gn, wn)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_fluid_layers_record_in_a_static_program():
    from paddle_tpu_torch import static
    rs = np.random.RandomState(8)
    x = rs.rand(4, 5).astype(np.float32)
    lab = rs.randint(0, 5, (4, 1)).astype(np.int64)
    prog = static.Program()
    with fluid.program_guard(prog):
        xv = fluid.data("x", [4, 5], "float32")
        lv = fluid.data("lab", [4, 1], "int64")
        out = fluid.layers.bpr_loss(fluid.layers.squared_l2_distance(
            xv, xv) + xv, lv)
    assert not paddle.in_static_mode()
    assert {op.op_type for op in prog.ops} >= {"squared_l2_distance_op",
                                               "bpr_loss_op"}
    (got,) = static.Executor("cpu").run(prog, feed={"x": x, "lab": lab},
                                        fetch_list=[out])
    want = fluid.layers.bpr_loss(fluid.layers.squared_l2_distance(
        torch.from_numpy(x), torch.from_numpy(x)) + torch.from_numpy(x),
        torch.from_numpy(lab))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)


def test_fluid_namespace_and_embedding_is_sparse():
    assert fluid.optimizer.AdamOptimizer is paddle.optimizer.Adam
    assert fluid.dygraph.Embedding is paddle.nn.Embedding
    with fluid.dygraph.guard():
        ids = fluid.dygraph.to_variable(np.array([[1, 1, 2]], np.int64))
        out = fluid.layers.embedding(ids, size=[10, 4], is_sparse=True,
                                     name="emb_sparse_t")
        out.sum().backward()
        again = fluid.layers.embedding(ids, size=[10, 4], is_sparse=True,
                                       name="emb_sparse_t")
    w = fluid.layers._DYGRAPH_CACHE[("embedding", "emb_sparse_t")].weight
    assert isinstance(w.grad, paddle.SelectedRows)
    assert w.grad.rows.tolist() == [1, 1, 2]
    assert torch.equal(out, again)
    arr = fluid.layers.array_write(torch.ones(2), 0)
    assert int(fluid.layers.array_length(arr)) == 1
