"""The PyTorch port's BERT/ERNIE pretraining path against the JAX package,
on the CPU.

A `bert_tiny` model is built in the JAX package with both dropout
probabilities at 0 (the two frameworks' dropout bits cannot match), its
weights are carried to the port, and the same numpy batch (the ERNIE
bench's: ids from RandomState(0), every fifth label -100, random NSP
labels) goes through both, with FLAGS_use_fused_dropout_ln on (the JAX
side then runs its fused Pallas kernels in interpret mode, the port the
plain versions through FusedDropoutResidualLNFunction) and off. The JAX
side's gradients come from jax.value_and_grad over its network with the
parameters swapped in (its criterion is raw jnp, which its eager tape
does not record), as its make_train_step takes them.

Tolerances: outputs, loss and first-step gradients at rtol 1e-4 / atol
1e-5 and the five-step AdamW loss trajectory at rtol 1e-4 (float32
through two layers, summed in other orders). Under auto_cast the loss is
held at rtol 2e-3: both sides round every matmul output to bfloat16
(2^-8 relative), and where their float32 accumulations differ in order a
product can land on the neighbouring bfloat16 value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu.framework.random import RNG as JRNG
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit.engine import _functional_fwd
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import BertPretrainingCriterion as JCriterion
from paddle_tpu.models import bert_tiny as jbert_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.transformer import MultiHeadAttention as JMHA
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import BertPretrainingCriterion
from paddle_tpu_torch.models import bert_tiny as tbert_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import MultiHeadAttention
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.transformer import _convert_attention_mask
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

VOCAB, B, T, LR, STEPS = 1024, 2, 32, 1e-3, 5
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
FUSED = "use_fused_dropout_ln"


def _set_fused(on):
    flags.set_flags({FUSED: on})
    paddle.set_flags({"FLAGS_" + FUSED: on})


@pytest.fixture(autouse=True)
def fused_off_after():
    yield
    _set_fused(False)
    flags.set_flags({"use_flash_attention": True})


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (B, T)).astype(np.int64)
    labels = ids.copy()
    labels[:, ::5] = -100
    nsp = rs.randint(0, 2, (B,)).astype(np.int64)
    return ids, labels, nsp


def _pair():
    paddle.seed(0)
    ref = jbert_tiny(**NO_DROPOUT)
    port = tbert_tiny(device="cpu", seed=1, **NO_DROPOUT)
    load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


def _jax_loss_and_grads(ref, ids, labels, nsp):
    """(loss, {name: gradient}) of the JAX model by jax.value_and_grad."""
    def loss_of(arrs):
        return JCriterion()(JTensor(arrs[0], _internal=True),
                            JTensor(arrs[1], _internal=True),
                            paddle.to_tensor(labels),
                            paddle.to_tensor(nsp))._data
    fwd, params, bufs = _functional_fwd(ref, loss_of)
    loss, grads = jax.value_and_grad(fwd)(
        [p._data for p in params], [b._data for b in bufs], JRNG.key,
        [jnp.asarray(ids)])
    names = [n for n, _ in ref.named_parameters()]
    return float(loss), {n: np.asarray(g) for n, g in zip(names, grads)}


@pytest.fixture(scope="module", params=[True, False],
                ids=["fused", "composed"])
def first_step(request):
    _set_fused(request.param)
    ref, port = _pair()
    ids, labels, nsp = _batch()
    jlogits, jnsp = ref(paddle.to_tensor(ids))
    jloss, jgrads = _jax_loss_and_grads(ref, ids, labels, nsp)
    tlogits, tnsp = port(torch.from_numpy(ids))
    tloss = BertPretrainingCriterion()(tlogits, tnsp, torch.from_numpy(labels),
                                       torch.from_numpy(nsp))
    tloss.backward()
    tgrads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    _set_fused(False)
    return dict(outs=[(tlogits.detach().numpy(), np.asarray(jlogits.numpy())),
                      (tnsp.detach().numpy(), np.asarray(jnsp.numpy()))],
                loss=(float(tloss.detach()), jloss), grads=(tgrads, jgrads))


def test_outputs_and_loss_match(first_step):
    for got, want in first_step["outs"]:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(*first_step["loss"], rtol=1e-4, atol=1e-5)


def test_first_step_gradients_match(first_step):
    tgrads, jgrads = first_step["grads"]
    assert sorted(tgrads) == sorted(jgrads) and len(tgrads) == 46
    for name, want in jgrads.items():
        np.testing.assert_allclose(tgrads[name], want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("on", [True, False], ids=["fused", "composed"])
def test_five_step_adamw_loss_trajectory_matches(on):
    _set_fused(on)
    ref, port = _pair()
    jcrit, tcrit = JCriterion(), BertPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                  learning_rate=LR, weight_decay=0.01)
    topt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                           weight_decay=0.01, device="cpu")
    jstep = jmake_train_step(ref, lambda a, b, c, d: jcrit(a, b, c, d), jopt)
    tstep = make_train_step(port, lambda a, b, c, d: tcrit(a, b, c, d), topt,
                            device="cpu")
    jl, tl = [], []
    ids, labels, nsp = _batch()       # one batch: the loss must fall
    for _ in range(STEPS):
        loss, _ = jstep([paddle.to_tensor(ids)],
                        [paddle.to_tensor(labels), paddle.to_tensor(nsp)])
        jl.append(float(loss.numpy()))
        loss, _ = tstep([torch.from_numpy(ids)],
                        [torch.from_numpy(labels), torch.from_numpy(nsp)])
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_auto_cast_dtypes_and_loss_match(monkeypatch):
    """Under auto_cast(level="O2") with float32 parameters, as the ERNIE
    bench runs: the matmuls and flash attention take bfloat16 inputs, the
    bias adds promote back to float32, layer norms and the losses run in
    float32. Every output's dtype equals the reference's; the loss agrees
    within rtol 2e-3 (bfloat16 matmul outputs, see the module note)."""
    _set_fused(True)
    ref, port = _pair()
    ids, labels, nsp = _batch()
    with jamp.auto_cast(level="O2"):
        jlogits, jnsp = ref(paddle.to_tensor(ids))
        jloss = JCriterion()(jlogits, jnsp, paddle.to_tensor(labels),
                             paddle.to_tensor(nsp))
    with amp.auto_cast(level="O2"):
        tlogits, tnsp = port(torch.from_numpy(ids))
        tloss = BertPretrainingCriterion()(
            tlogits, tnsp, torch.from_numpy(labels), torch.from_numpy(nsp))
    for got, want in ((tlogits, jlogits), (tnsp, jnsp), (tloss, jloss)):
        assert str(got.dtype).split(".")[-1] == \
            str(want.dtype).split(".")[-1]
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               rtol=2e-3)
    # the bfloat16 casts happened: flash attention saw bfloat16 inputs
    seen = []
    real = ck.FlashAttentionFunction.apply
    monkeypatch.setattr(ck.FlashAttentionFunction, "apply",
                        lambda *a: seen.append(a[0].dtype) or real(*a))
    with amp.auto_cast(level="O2"):
        port(torch.from_numpy(ids))
    port(torch.from_numpy(ids))
    assert seen == [torch.bfloat16] * 2 + [torch.float32] * 2
    # a train step under auto_cast keeps float32 parameters and gradients
    opt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                          device="cpu")
    crit = BertPretrainingCriterion()
    step = make_train_step(port, lambda a, b, c, d: crit(a, b, c, d), opt,
                           device="cpu")
    with amp.auto_cast(level="O2"):
        loss, _ = step([torch.from_numpy(ids)],
                       [torch.from_numpy(labels), torch.from_numpy(nsp)])
    assert np.isfinite(float(loss)) and loss.dtype == torch.float32
    assert {p.dtype for p in port.parameters()} == {torch.float32}


def test_criterion_ignore_index_and_the_tied_decoder_weight():
    rs = np.random.RandomState(1)
    logits = rs.randn(B, T, 40).astype(np.float32)
    nsp_logits = rs.randn(B, 2).astype(np.float32)
    nsp = np.array([0, 1], np.int64)
    crit, jcrit = BertPretrainingCriterion(), JCriterion()
    for keep in (0.5, 0.0):
        labels = rs.randint(0, 40, (B, T)).astype(np.int64)
        labels[rs.rand(B, T) >= keep] = -100
        for with_nsp in (True, False):
            extra_t = [torch.from_numpy(nsp)] if with_nsp else []
            extra_j = [paddle.to_tensor(nsp)] if with_nsp else []
            got = crit(torch.from_numpy(logits), torch.from_numpy(nsp_logits),
                       torch.from_numpy(labels), *extra_t)
            want = jcrit(paddle.to_tensor(logits),
                         paddle.to_tensor(nsp_logits),
                         paddle.to_tensor(labels), *extra_j)
            np.testing.assert_allclose(float(got), float(want.numpy()),
                                       rtol=1e-6, atol=1e-6)
            if keep == 0.0 and not with_nsp:
                assert float(got) == 0.0          # every label ignored
    # one parameter, two uses, listed once under its first use's name
    port = tbert_tiny(device="cpu", seed=0, **NO_DROPOUT)
    word = port.bert.embeddings.word_embeddings.weight
    assert port.cls.decoder_weight is word
    names = [n for n, p in port.named_parameters() if p is word]
    assert names == ["bert.embeddings.word_embeddings.weight"]
    ref = jbert_tiny(**NO_DROPOUT)
    assert sorted(ref.state_dict()) == sorted(
        n for n, _ in port.named_parameters())
    # its gradient is the sum of both uses
    ids = torch.from_numpy(_batch()[0])
    logits, _ = port(ids)
    logits.sum().backward()
    both = word.grad.clone()
    word.grad = None
    emb = port.bert.embeddings.word_embeddings(ids)
    h = port.cls.layer_norm(torch.nn.functional.gelu(port.cls.transform(
        port.bert.encoder(port.bert.embeddings.dropout(
            port.bert.embeddings.layer_norm(
                emb + port.bert.embeddings.position_embeddings(
                    torch.arange(T)) +
                port.bert.embeddings.token_type_embeddings(
                    torch.zeros_like(ids))))))))
    (h @ word.detach().t()).sum().backward()
    emb_only = word.grad.clone()
    decoder_only = h.detach().reshape(-1, h.shape[-1]).sum(0)
    torch.testing.assert_close(both, emb_only + decoder_only[None, :]
                               .expand_as(both), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["bool", "int", "float"])
def test_attention_masks_match_the_reference(kind):
    """bool/int masks keep True/nonzero positions ((1 - m) * -1e9 is
    added), float masks are added as they are; with use_flash_attention
    off, and on, where a masked call takes the plain attention (path
    xla_sdpa) as the reference's gate hands it to its composed
    attention."""
    flags.set_flags({"use_flash_attention": False})
    rs = np.random.RandomState(2)
    paddle.seed(0)
    jmha = JMHA(32, 4)
    mha = MultiHeadAttention(32, 4)
    load_reference_state(mha, {k: np.asarray(v.numpy())
                               for k, v in jmha.state_dict().items()})
    x = rs.randn(2, 8, 32).astype(np.float32)
    keep = rs.rand(2, 1, 8, 8) < 0.7
    keep[..., np.arange(8), np.arange(8)] = True      # no empty row
    mask = {"bool": keep, "int": keep.astype(np.int64),
            "float": np.where(keep, 0.0, -1e4).astype(np.float32)}[kind]
    want = jmha(paddle.to_tensor(x), attn_mask=paddle.to_tensor(mask))
    got = mha(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()),
                               rtol=1e-5, atol=1e-5)
    add = _convert_attention_mask(torch.from_numpy(mask), torch.float32)
    assert add.dtype == torch.float32
    assert bool((add[torch.from_numpy(keep)] == 0).all())
    # the BERT padding mask ([B, T], 1 = token) through the whole model
    ref, port = _pair()
    ids = _batch()[0]
    pad = np.ones((B, T), np.int64)
    pad[1, T // 2:] = 0
    jseq, _ = ref.bert(paddle.to_tensor(ids),
                       attention_mask=paddle.to_tensor(pad))
    tseq, _ = port.bert(torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(tseq.detach().numpy(), np.asarray(jseq.numpy()),
                               rtol=1e-4, atol=1e-5)
    # the same with the flash kernels on: the masked calls run the plain
    # attention, and no flash kernel
    flags.set_flags({"use_flash_attention": True})
    before = ck.attention_path_counts()
    got = mha(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()),
                               rtol=1e-5, atol=1e-5)
    tseq, _ = port.bert(torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(tseq.detach().numpy(), np.asarray(jseq.numpy()),
                               rtol=1e-4, atol=1e-5)
    after = ck.attention_path_counts()
    n_layers = len(port.bert.encoder.layers)
    assert after["xla_sdpa"] - before["xla_sdpa"] == 1 + n_layers
    assert all(after[k] == before[k] for k in ("flash", "flash_dropout"))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_dropout_one_matches_the_reference(causal):
    """dropout_p=1 in training with use_flash_attention on: the reference's
    gate hands the call to its XLA attention, whose where(keep, w / (1 -
    p), 0) drops every probability, and the port's gate hands it to the
    plain attention, which drops them all too: zeros on both sides. The
    forward only (the reference's gradient there is 0 * inf)."""
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(2, 4, 8, 16).astype(np.float32) for _ in range(3))
    paddle.seed(0)
    want, _ = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), dropout_p=1.0,
        is_causal=causal, training=True)
    before = ck.attention_path_counts()
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), dropout_p=1.0,
        is_causal=causal, training=True)
    after = ck.attention_path_counts()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    assert after["xla_sdpa"] == before["xla_sdpa"] + 1
    assert after["flash_dropout"] == before["flash_dropout"]
