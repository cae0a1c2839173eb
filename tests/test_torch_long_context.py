"""The port's long-context attention tier against the JAX package's, on the
CPU: `ops.ring_attention.blockwise_attention` against the reference's
`_blockwise_attention` (forward, and the gradients of q, k, v through
`jax.vjp` with `checkpoint_blocks=True`), its dropout (the backward's
masks are the forward's; the gradient equals a dense route given the same
masks), fully masked rows, the gate of `F.scaled_dot_product_attention`
(`FLAGS_sdpa_chunked_threshold`, path `xla_chunked`) against the
reference's for each condition, and `benchmarks/train_bench.py`
`bench_gpt2_long`'s body at its own CPU shape (gpt_tiny, T=256, threshold
128), written against `import paddle_tpu_torch as paddle`.

Tolerances: float32 within 1e-5 absolute / 1e-4 relative, bfloat16 within
2e-2 (both sides sum in float32; the inputs and outputs round to
bfloat16); the bench body's two float32 losses within 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas_kernels import attention_path_counts as jpaths
from paddle_tpu.ops.ring_attention import _blockwise_attention

import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.ops import ring_attention as ra
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True)
def restore_state():
    saved = (pflags.all_flags(), dict(jflags._FLAGS),
             pplace._current_place, prandom.get_rng_state())
    yield
    pf, jf, place, rng = saved
    pflags._FLAGS.update(pf)
    jflags._FLAGS.update(jf)
    pplace._current_place = place
    prandom.set_rng_state(rng)


def _qkvd(B, H, Tq, Tk, D, seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, Tq, D).astype(np.float32) * scale
    k = rs.randn(B, H, Tk, D).astype(np.float32) * scale
    v = rs.randn(B, H, Tk, D).astype(np.float32)
    do = rs.randn(B, H, Tq, D).astype(np.float32)
    return q, k, v, do


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.detach().float().numpy()


CASES = [(T, bk, causal, dt) for T, bk in ((256, 128), (300, 128), (200, 64))
         for causal in (True, False) for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("T,block,causal,dtype", CASES)
def test_blockwise_forward_and_gradients_equal_the_reference(T, block,
                                                             causal, dtype):
    q, k, v, do = _qkvd(2, 3, T, T, 16)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)

    def ref(a, b, c):
        return _blockwise_attention(a, b, c, causal=causal,
                                    scale=16 ** -0.5, block_k=block,
                                    checkpoint_blocks=True)
    jo, vjp = jax.vjp(ref, *(jnp.asarray(x, jd) for x in (q, k, v)))
    jg = vjp(jnp.asarray(do, jd))
    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    to = ra.blockwise_attention(tq, tk, tv, causal, block_k=block)
    assert to.dtype == td
    to.backward(torch.tensor(do).to(td))
    np.testing.assert_allclose(_f32(to), _f32(jo), **TOL[dtype])
    for t, g in zip((tq, tk, tv), jg):
        assert t.grad.dtype == td
        np.testing.assert_allclose(_f32(t.grad), _f32(g), **TOL[dtype])


def test_block_geometry_and_ragged_edges():
    assert ra.block_geometry(8192) == (512, 16)
    assert ra.block_geometry(300, 128) == (128, 3)
    assert ra.block_geometry(100) == (100, 1)
    # Tq != Tk (not causal): the key axis is the blocked one
    q, k, v, _ = _qkvd(1, 2, 40, 130, 8)
    got = ra.blockwise_attention(*(torch.tensor(x) for x in (q, k, v)),
                                 False, block_k=64)
    want = ck.flash_attention_plain(*(torch.tensor(x) for x in (q, k, v)),
                                    False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError):
        ra.blockwise_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), True)
    with pytest.raises(ValueError):
        ra.blockwise_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), False, dropout_p=1.0)


@pytest.mark.parametrize("causal", [True, False])
def test_dropout_masks_regenerated_and_gradient_equals_dense(causal,
                                                             monkeypatch):
    p, block, T = 0.1, 64, 200
    q, k, v, do = _qkvd(1, 2, T, T, 8, seed=3)
    seen = []
    real = ck.dropout_keep

    def keep(word, delta, shape, pp):
        out = real(word, delta, shape, pp)
        seen.append((int(delta), out))
        return out
    monkeypatch.setattr(ck, "dropout_keep", keep)
    prandom.seed(7)
    tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    out = ra.blockwise_attention(tq, tk, tv, causal, dropout_p=p,
                                 block_k=block)
    nblk = ra.block_geometry(T, block)[1]
    assert len(seen) == nblk
    out.backward(torch.tensor(do))
    assert len(seen) == 2 * nblk
    fwd, bwd = seen[:nblk], seen[nblk:]
    assert len({d for d, _ in fwd}) == nblk          # a draw a block
    for (d1, m1), (d2, m2) in zip(fwd, bwd):
        assert d1 == d2 and torch.equal(m1, m2)
    # the dense route given the same masks
    full = torch.cat([m for _, m in fwd], dim=-1)
    assert full.shape == (1, 2, T, T)
    assert 0.85 < full.float().mean() < 0.95
    dq, dk, dv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    dense = ck.flash_attention_plain(dq, dk, dv, causal, keep=full,
                                     dropout_p=p)
    dense.backward(torch.tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    for a, b in ((tq, dq), (tk, dk), (tv, dv)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-4, atol=1e-5)
    # the next call draws new masks
    seen.clear()
    ra.blockwise_attention(tq.detach(), tk.detach(), tv.detach(), causal,
                           dropout_p=p, block_k=block)
    assert not torch.equal(seen[0][1], fwd[0][1])


def test_fully_masked_rows_give_no_nan():
    # causal: in every block after the first, the rows above the diagonal
    # see no key; large scores stress the -1e30 handling
    q, k, v, do = _qkvd(1, 2, 300, 300, 16, seed=5, scale=30.0)
    tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    out = ra.blockwise_attention(tq, tk, tv, True, block_k=64)
    out.backward(torch.tensor(do))
    for t in (out, tq.grad, tk.grad, tv.grad):
        assert torch.isfinite(t).all()
    jo = _blockwise_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=True, scale=0.25, block_k=64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               rtol=1e-4, atol=1e-5)
    # row 0 sees key 0 only
    np.testing.assert_allclose(out[0, :, 0].detach().numpy(), v[0, :, 0],
                               rtol=1e-6)


# ------------------------------------------------------------------ gate
# (name, Tq, Tk, causal, mask, dropout_p, training, threshold, path)
GATE = [
    ("at threshold", 128, 128, True, False, 0.0, True, 128, "xla_chunked"),
    ("above, not causal", 160, 160, False, False, 0.0, True, 128,
     "xla_chunked"),
    ("below threshold", 96, 96, True, False, 0.0, True, 128, "xla_sdpa"),
    ("threshold 0", 160, 160, True, False, 0.0, True, 0, "xla_sdpa"),
    ("additive mask", 160, 160, False, True, 0.0, True, 128, "xla_sdpa"),
    ("dropout 1", 160, 160, True, False, 1.0, True, 128, "xla_sdpa"),
    ("dropout 1, eval", 160, 160, True, False, 1.0, False, 128,
     "xla_chunked"),
    ("causal, Tq < Tk", 32, 160, True, False, 0.0, True, 128, "xla_sdpa"),
    ("not causal, Tq < Tk", 32, 160, False, False, 0.0, True, 128,
     "xla_chunked"),
]


@pytest.mark.parametrize("case", GATE, ids=[g[0] for g in GATE])
def test_gate_routes_as_the_reference(case):
    _, Tq, Tk, causal, masked, p, training, thr, path = case
    q, _, _, _ = _qkvd(1, 2, Tq, Tq, 8, seed=1)
    _, k, v, _ = _qkvd(1, 2, Tk, Tk, 8, seed=2)
    mask = (np.random.RandomState(4).randn(1, 1, Tq, Tk).astype(np.float32)
            if masked else None)
    flags = {"FLAGS_use_flash_attention": False,
             "FLAGS_sdpa_chunked_threshold": thr}
    paddle.set_flags(flags)
    jpaddle.set_flags(flags)
    j0 = jpaths()
    jo, _ = JF.scaled_dot_product_attention(
        *(jpaddle.to_tensor(x) for x in (q, k, v)),
        attn_mask=None if mask is None else jpaddle.to_tensor(mask),
        dropout_p=p, is_causal=causal, training=training)
    jdelta = {kk: n - j0.get(kk, 0) for kk, n in jpaths().items()
              if n != j0.get(kk, 0)}
    t0 = ck.attention_path_counts()
    to = F.scaled_dot_product_attention(
        *(torch.tensor(x) for x in (q, k, v)),
        attn_mask=None if mask is None else torch.tensor(mask),
        dropout_p=p, is_causal=causal, training=training)
    tdelta = {kk: n - t0[kk] for kk, n in ck.attention_path_counts().items()
              if n != t0[kk]}
    assert tdelta == jdelta == {path: 1}
    np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()),
                               rtol=1e-4, atol=1e-5)


def test_flash_gate_comes_first():
    q, k, v, _ = _qkvd(1, 2, 160, 160, 8)
    paddle.set_flags({"FLAGS_use_flash_attention": True,
                      "FLAGS_sdpa_chunked_threshold": 128})
    t0 = ck.attention_path_counts()
    F.scaled_dot_product_attention(*(torch.tensor(x) for x in (q, k, v)),
                                   is_causal=True)
    after = ck.attention_path_counts()
    assert after["flash"] == t0["flash"] + 1
    assert after["xla_chunked"] == t0["xla_chunked"]


# ------------------------------------------------------------ the bench
def _bench_gpt2_long_cpu(paddle, make_train_step, gpt_tiny, Criterion,
                         load=None):
    """benchmarks/train_bench.py bench_gpt2_long's body at its CPU shape
    (:236-243) with its harness's calls (`_gpt_train_bench` :52-110),
    dropouts 0 so that the two packages' steps can agree; `load` carries
    the reference's weights across. Returns the losses, read as the
    bench reads them, and the attention paths of the steps."""
    B, T, steps = 1, 256, 2
    paddle.set_flags({"FLAGS_sdpa_chunked_threshold": 128})
    net = gpt_tiny(vocab_size=1024, hidden_size=64, num_layers=2,
                   num_heads=4, intermediate_size=128,
                   max_position_embeddings=T + 1, attn_dropout_prob=0.0,
                   hidden_dropout_prob=0.0)
    if load is not None:
        load(net)
    core = getattr(net, "gpt", net)
    vocab = core.embeddings.word_embeddings.weight.shape[0]
    rs = np.random.RandomState(0)
    ids = paddle.to_tensor(rs.randint(0, vocab, (B, T + 1)).astype(np.int64))
    args = ([ids[:, :-1]], [ids[:, 1:]])
    paddle.seed(0)
    crit = Criterion()
    opt = paddle.optimizer.AdamW(parameters=net.parameters(),
                                 learning_rate=1e-4, weight_decay=0.01)
    step = make_train_step(net, lambda o, l: crit(o, l), opt)
    losses = []
    for _ in range(steps):
        loss, _ = step(*args)
        losses.append(float(loss.numpy()))
    return losses, net


def test_bench_gpt2_long_cpu_shape_two_steps_equal_the_reference():
    j0 = jpaths()
    jpaddle.seed(0)
    jl, _ = _bench_gpt2_long_cpu(jpaddle, jmake_train_step, jgpt_tiny,
                                    JCriterion)
    jdelta = {k: n - j0.get(k, 0) for k, n in jpaths().items()}
    # the port: the same body, `paddle` the port, the CPU chosen, the
    # flash kernels off (the chunked tier is the path with them off), the
    # reference's first weights (its build after seed(0)) carried across
    paddle.set_device("cpu")
    paddle.set_flags({"FLAGS_use_flash_attention": False})
    jpaddle.seed(0)
    ref = jgpt_tiny(vocab_size=1024, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128,
                    max_position_embeddings=257, attn_dropout_prob=0.0,
                    hidden_dropout_prob=0.0)
    init = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    t0 = ck.attention_path_counts()
    tl, _ = _bench_gpt2_long_cpu(
        paddle, paddle.jit.make_train_step, paddle.models.gpt_tiny,
        paddle.models.GPTPretrainingCriterion,
        load=lambda net: load_reference_state(net, init))
    tdelta = {k: n - t0[k] for k, n in ck.attention_path_counts().items()}
    assert tdelta["xla_chunked"] == 2 * 2 and tdelta["xla_sdpa"] == 0
    assert tdelta["flash"] == tdelta["flash_dropout"] == 0
    assert jdelta.get("xla_chunked", 0) > 0
    assert jdelta.get("xla_sdpa", 0) == 0
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[1] < tl[0]
    assert paddle.get_flags(["FLAGS_sdpa_chunked_threshold"]) == {
        "FLAGS_sdpa_chunked_threshold": 128}
