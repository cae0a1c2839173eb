"""The PyTorch port's training slice against the JAX package, on the CPU.

A `gpt_tiny` model is built in the JAX package with both dropout
probabilities at 0 (the two frameworks' dropout bits cannot match), its
weights are carried to the port, and the same numpy batches go through
both. On the JAX side attention takes the Pallas flash kernel in interpret
mode (T=64 keeps Tq*Tk within its interpret limit of 64*64), with the
kernel's custom vjp; on the port's side the flash kernels' plain versions
run through FlashAttentionFunction.

Tolerances: the loss and the first step's gradients at rtol 1e-4 / atol
1e-5 (float32 through two layers, summed in different orders). After five
AdamW steps the parameters are held at atol 1e-5 wherever the first
step's |g| > 1e-4, and within 5 * lr everywhere: Adam's normalised step
m / sqrt(v) is near +-1 whatever the sign of a gradient near 0, so where
|g| is at rounding level the two runs may step in opposite directions,
by at most lr per step.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu.io import DataLoader as JDataLoader
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.ops.pallas_kernels import attention_path_counts as jpaths
from paddle_tpu_torch import amp, io, optimizer
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.io.prefetch import FEED_STALL
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.models import export_reference_state
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

VOCAB, B, T, LR, STEPS = 128, 2, 64, 1e-3, 5
NO_DROPOUT = dict(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (n, B, T + 1)).astype(np.int64)
    return [(x[:, :-1], x[:, 1:]) for x in ids]


def _pair():
    paddle.seed(0)
    ref = jgpt_tiny(**NO_DROPOUT)
    port = tgpt_tiny(device="cpu", seed=1, **NO_DROPOUT)
    load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def first_step():
    """Loss and gradients of one batch through both models."""
    ref, port = _pair()
    x, y = _batches(1)[0]
    before = jpaths()
    jloss = JCriterion()(ref(paddle.to_tensor(x)), paddle.to_tensor(y))
    jloss.backward()
    after = jpaths()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in
              ref.named_parameters()}
    tloss = GPTPretrainingCriterion()(port(torch.from_numpy(x)),
                                      torch.from_numpy(y))
    tloss.backward()
    tgrads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    return (float(jloss.numpy()), jgrads, float(tloss.detach()), tgrads,
            {k: after[k] - before.get(k, 0) for k in after})


def test_loss_and_first_step_gradients_match(first_step):
    jloss, jgrads, tloss, tgrads, jax_paths = first_step
    # the JAX side ran its flash kernel (interpret mode), not XLA sdpa
    assert jax_paths.get("flash", 0) > 0 and jax_paths.get("xla_sdpa", 0) == 0
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4, atol=1e-5)
    assert sorted(tgrads) == sorted(jgrads) and len(tgrads) == 28
    for name in jgrads:
        np.testing.assert_allclose(tgrads[name], jgrads[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def five_steps():
    ref, port = _pair()
    jcrit, tcrit = JCriterion(), GPTPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                  learning_rate=LR, weight_decay=0.01)
    topt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                           weight_decay=0.01, device="cpu")
    jstep = jmake_train_step(ref, lambda o, l: jcrit(o, l), jopt)
    tstep = make_train_step(port, lambda o, l: tcrit(o, l), topt,
                            device="cpu")
    jl, tl = [], []
    for x, y in _batches(STEPS):
        loss, _ = jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        jl.append(float(loss.numpy()))
        loss, _ = tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
        tl.append(float(loss))
    jparams = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    return jl, tl, jparams, export_reference_state(port), topt


def test_five_step_loss_trajectory_matches(five_steps):
    jl, tl, _, _, topt = five_steps
    assert topt._step_count == STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_parameters_after_five_steps_match(five_steps, first_step):
    _, _, jparams, tparams, _ = five_steps
    g1 = first_step[1]
    assert sorted(jparams) == sorted(tparams)
    for name, want in jparams.items():
        got = tparams[name]
        diff = np.abs(got - want)
        assert diff.max() <= 5 * LR, name
        live = np.abs(g1[name]) > 1e-4
        assert diff[live].max(initial=0.0) <= 1e-5, name


def test_o2_bf16_three_steps():
    port = tgpt_tiny(device="cpu", seed=0)              # dropout 0.1
    port.train()
    opt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                          weight_decay=0.01, device="cpu")
    port, opt = amp.decorate(port, opt, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion()
    step = make_train_step(port, lambda o, l: crit(o, l), opt, device="cpu")
    before = ck.attention_path_counts()
    losses = []
    for x, y in _batches(3, seed=3):
        loss, (logits,) = step([torch.from_numpy(x)], [torch.from_numpy(y)])
        assert loss.dtype == torch.bfloat16
        assert logits.dtype == torch.bfloat16
        losses.append(float(loss))
    after = ck.attention_path_counts()
    assert np.isfinite(losses).all()
    assert after["flash_dropout"] - before["flash_dropout"] == 3 * 2
    assert after["xla_sdpa"] == before["xla_sdpa"]
    assert {p.dtype for p in port.parameters()} == {torch.bfloat16}
    accs = [a for acc in opt._accumulators.values() for a in acc.values()]
    assert len(accs) == 2 * 28
    assert {a.dtype for a in accs} == {torch.float32}
    assert all(p.grad is None for p in port.parameters())


def test_auto_cast_o2_loss_and_logits_dtype_match():
    """Under auto_cast(level="O2") with float32 parameters the tied LM head
    is matmul_v2 (white list) on both sides: bfloat16 logits from
    bfloat16 operands; the criterion (softmax_with_cross_entropy, black
    list) in float32. The loss within rtol 2e-3: both sides round every
    matmul output to bfloat16 (2^-8 relative), and where their float32
    sums differ in order a product can land on the neighbouring bfloat16
    value."""
    ref, port = _pair()
    x, y = _batches(1, seed=5)[0]
    with jamp.auto_cast(level="O2"):
        jlogits = ref(paddle.to_tensor(x))
        jloss = JCriterion()(jlogits, paddle.to_tensor(y))
    with amp.auto_cast(level="O2"):
        tlogits = port(torch.from_numpy(x))
        tloss = GPTPretrainingCriterion()(tlogits, torch.from_numpy(y))
    for got, want in ((tlogits, jlogits), (tloss, jloss)):
        assert str(got.dtype).split(".")[-1] == \
            str(want.dtype).split(".")[-1]
    assert tlogits.dtype == torch.bfloat16 and tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               rtol=2e-3)
    assert {p.dtype for p in port.parameters()} == {torch.float32}


def test_decorate_o1_and_o0_return_the_models_as_they_are():
    """The reference's decorate casts only at O2: at O1 and O0 the same
    objects come back (a model, a list of them, with or without the
    optimizers) and no parameter changes its dtype."""
    ref, port = _pair()
    jopt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                  learning_rate=LR)
    topt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                           device="cpu")
    for level in ("O1", "O0"):
        for lib, model, opt in ((jamp, ref, jopt), (amp, port, topt)):
            assert lib.decorate(model, level=level) is model
            got_m, got_o = lib.decorate(model, opt, level=level)
            assert got_m is model and got_o is opt
            (got,) = lib.decorate([model], level=level)
            assert got is model
    assert {str(p.dtype).split(".")[-1] for p in ref.parameters()} == {
        "float32"}
    assert {p.dtype for p in port.parameters()} == {torch.float32}


class TokenStream:
    """The bench's synthetic stream (benchmarks/train_bench.py:191-197)."""

    def __len__(self):
        return 100000

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        return rs.randint(0, VOCAB, (T + 1,)).astype(np.int64)


class PortStream(TokenStream, io.Dataset):
    pass


class JaxStream(TokenStream, JDataset):
    pass


def test_dataloader_prefetch_yields_the_token_stream_in_order():
    loader = io.DataLoader(PortStream(), batch_size=4, shuffle=False,
                           prefetch_to_device=2, device="cpu")
    jloader = JDataLoader(JaxStream(), batch_size=4, num_workers=0,
                          shuffle=False, prefetch_to_device=2)
    it, jit_ = iter(loader), iter(jloader)
    stalls = FEED_STALL.count
    try:
        for n in range(3):
            batch, jbatch = next(it), next(jit_)
            want = np.stack([PortStream()[4 * n + i] for i in range(4)])
            assert batch.dtype == torch.int64 and batch.device.type == "cpu"
            np.testing.assert_array_equal(batch.numpy(), want)
            np.testing.assert_array_equal(batch.numpy(),
                                          np.asarray(jbatch.numpy()))
    finally:
        it.close()
        jit_.close()
    assert FEED_STALL.count == stalls + 3       # one wait per batch
    # a finite dataset ends; a feeder error reaches the consumer
    short = io.DataLoader([np.arange(3)] * 5, batch_size=2,
                          prefetch_to_device=2, device="cpu")
    assert [tuple(b.shape) for b in short] == [(2, 3), (2, 3), (1, 3)]

    class Broken(io.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("sample 2")
            return np.zeros(2)
    with pytest.raises(KeyError, match="sample 2"):
        list(io.DataLoader(Broken(), batch_size=1, prefetch_to_device=2,
                           device="cpu"))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_modes(mode):
    p = 0.3
    x = torch.from_numpy(np.random.RandomState(0).rand(200, 500)
                         .astype(np.float32) + 0.5)
    prandom.seed(5)
    y = F.dropout(x, p, training=True, mode=mode)
    kept = y != 0
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    np.testing.assert_array_equal(y[kept].numpy(), (x[kept] * scale).numpy()
                                  if mode == "downscale_in_infer"
                                  else (x[kept] / (1.0 - p)).numpy())
    n = x.numel()
    rate = kept.double().mean().item()
    assert abs(rate - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
    # the same seed draws the same mask
    prandom.seed(5)
    np.testing.assert_array_equal(
        F.dropout(x, p, training=True, mode=mode).numpy(), y.numpy())
    # eval: identity, or scaled by 1 - p in downscale_in_infer
    ev = F.dropout(x, p, training=False, mode=mode)
    want = x * (1.0 - p) if mode == "downscale_in_infer" else x
    np.testing.assert_array_equal(ev.numpy(), want.numpy())
    layer = Dropout(p, mode=mode)
    layer.eval()
    np.testing.assert_array_equal(layer(x).numpy(), want.numpy())
    layer.train()
    assert (layer(x) == 0).any()
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, p, mode="upscale")


def test_optimizer_state_dict_round_trip():
    crit = GPTPretrainingCriterion()
    a = tgpt_tiny(device="cpu", seed=2, **NO_DROPOUT)
    b = tgpt_tiny(device="cpu", seed=2, **NO_DROPOUT)
    opt_a = optimizer.AdamW(parameters=a.parameters(), learning_rate=LR,
                            device="cpu")
    step_a = make_train_step(a, lambda o, l: crit(o, l), opt_a,
                             device="cpu")
    batches = _batches(3, seed=7)
    for x, y in batches[:2]:
        step_a([torch.from_numpy(x)], [torch.from_numpy(y)])
    sd = opt_a.state_dict()
    assert sd["@step_count"] == 2
    assert len([k for k in sd if k.startswith("@acc_")]) == 2 * 28
    assert "gpt.ln_f.weight_moment1" in sd
    b.load_state_dict(a.state_dict())
    opt_b = optimizer.AdamW(parameters=b.parameters(), learning_rate=LR,
                            device="cpu")
    opt_b.set_state_dict({k: (v.numpy() if isinstance(v, torch.Tensor)
                              else v) for k, v in sd.items()})
    assert opt_b._step_count == 2
    # the snapshot does not move with later in-place updates
    m1 = sd["@acc_0_moment1"].clone()
    step_b = make_train_step(b, lambda o, l: crit(o, l), opt_b,
                             device="cpu")
    x, y = batches[2]
    step_a([torch.from_numpy(x)], [torch.from_numpy(y)])
    step_b([torch.from_numpy(x)], [torch.from_numpy(y)])
    torch.testing.assert_close(sd["@acc_0_moment1"], m1, rtol=0, atol=0)
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=n)


def test_adamw_decay_exemption_and_unported_options():
    m = tgpt_tiny(device="cpu", seed=3, **NO_DROPOUT)
    crit = GPTPretrainingCriterion()
    norms = lambda name: name.endswith("bias") or ".ln_" in name
    opt = optimizer.AdamW(parameters=m.parameters(), learning_rate=LR,
                          weight_decay=0.5, device="cpu",
                          apply_decay_param_fun=lambda n: not norms(n))
    assert opt._static_args(m.gpt.ln_f.weight)[3] == 0.0
    assert opt._static_args(m.gpt.layers[0].mlp.fc1.weight)[3] == 0.5
    with pytest.raises(NotImplementedError):
        optimizer.AdamW(parameters=m.parameters(), device="cpu",
                        weight_decay=lambda: 0.1)
    # lr_ratio is taken and ignored, as the reference takes it
    # (tests/test_torch_optimizers.py holds the update to the reference's)
    optimizer.AdamW(parameters=m.parameters(), device="cpu",
                    lr_ratio=lambda p: 1.0)
    # schedulers and clips are ported: what is neither raises TypeError
    with pytest.raises(TypeError, match="grad_clip"):
        optimizer.AdamW(grad_clip=object(), parameters=m.parameters(),
                        device="cpu")
    with pytest.raises(TypeError, match="LRScheduler"):
        optimizer.AdamW(learning_rate=object(), parameters=m.parameters(),
                        device="cpu")
    step = make_train_step(m, lambda o, l: crit(o, l), opt, device="cpu")
    x, y = _batches(1, seed=9)[0]
    step([torch.from_numpy(x)], [torch.from_numpy(y)])


def test_cross_entropy_ignore_index_and_reductions():
    from paddle_tpu.nn import functional as JF
    rs = np.random.RandomState(0)
    logits = rs.randn(3, 5, 11).astype(np.float32)
    label = rs.randint(0, 11, (3, 5)).astype(np.int64)
    label[0, :2] = -100
    for reduction in ("none", "mean", "sum"):
        want = np.asarray(JF.cross_entropy(
            paddle.to_tensor(logits), paddle.to_tensor(label),
            reduction=reduction).numpy())
        got = F.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(label), reduction=reduction)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        assert got.shape == (want.shape if reduction == "none" else ())
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                          reduction="none")
    assert (got[0, :2] == 0).all()
    # a non-negative ignore_index: "mean" divides by the labels kept
    want = np.asarray(JF.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label), ignore_index=3,
        reduction="mean").numpy())
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                          ignore_index=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the port's mean is 0-d; the reference's is label-shaped (its
    # denominator broadcasts), which assert_allclose does not show
    assert got.ndim == 0
    # computed in the logits' dtype, as the reference does
    assert F.cross_entropy(torch.from_numpy(logits).bfloat16(),
                           torch.from_numpy(label)).dtype == torch.bfloat16


# soft labels, class weights, use_softmax=False, label smoothing: the
# port's functions against the reference's on the same numpy arrays,
# float32 losses at rtol 1e-6 / atol 1e-6, gradients at 1e-5

def _ce_inputs(soft, seed=0, C=11):
    rs = np.random.RandomState(seed)
    logits = rs.randn(3, 5, C).astype(np.float32)
    if soft:
        label = rs.rand(3, 5, C).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = rs.randint(0, C, (3, 5)).astype(np.int64)
    return logits, label


def _both_ce(kw, soft, probs=False, weight=None, seed=0):
    """(port loss, reference loss, port logits grad, reference grad)."""
    from paddle_tpu.nn import functional as JF
    logits, label = _ce_inputs(soft, seed)
    if probs:
        e = np.exp(logits - logits.max(-1, keepdims=True))
        logits = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    extra = {}
    if weight is not None:
        extra = dict(weight=(paddle.to_tensor(weight),
                             torch.from_numpy(weight)))
    jx = paddle.to_tensor(logits, stop_gradient=False)
    tx = torch.from_numpy(logits).requires_grad_()
    want = JF.cross_entropy(jx, paddle.to_tensor(label), soft_label=soft,
                            **{k: v[0] for k, v in extra.items()}, **kw)
    got = F.cross_entropy(tx, torch.from_numpy(label), soft_label=soft,
                          **{k: v[1] for k, v in extra.items()}, **kw)
    want.sum().backward()
    got.sum().backward()
    return got, want, tx.grad, jx.grad


def _hold_ce(got, want, tg, jg):
    w = np.asarray(want.numpy())
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-6,
                               atol=1e-6)
    assert tuple(got.shape) == w.shape
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg.numpy()),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_softmax", [True, False],
                         ids=["softmax", "probs"])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_soft_label_cross_entropy_matches_the_reference(reduction,
                                                        use_softmax):
    _hold_ce(*_both_ce(dict(reduction=reduction, use_softmax=use_softmax),
                       True, probs=not use_softmax))


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_hard_label_cross_entropy_of_probabilities_matches(reduction):
    """use_softmax=False with hard labels: -log of the label's
    probability."""
    _hold_ce(*_both_ce(dict(reduction=reduction, use_softmax=False), False,
                       probs=True))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_class_weighted_cross_entropy_matches_the_reference(reduction,
                                                            soft):
    """A class weight: each hard label's loss times its weight, "mean"
    over the weights' sum; ignored with soft labels, as in the
    reference."""
    weight = np.random.RandomState(5).rand(11).astype(np.float32) + 0.5
    _hold_ce(*_both_ce(dict(reduction=reduction), soft, weight=weight))


@pytest.mark.parametrize("epsilon", [0.0, 0.1, 0.25])
def test_label_smooth_of_one_hot_matches_the_reference(epsilon):
    from paddle_tpu.nn import functional as JF
    ids = np.array([[0, 3, 10], [7, 11, 2]], np.int64)    # 11: no class
    want = JF.label_smooth(JF.one_hot(paddle.to_tensor(ids), 11),
                           epsilon=epsilon)
    got = F.label_smooth(F.one_hot(torch.from_numpy(ids), 11),
                         epsilon=epsilon)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-7, atol=1e-7)
    with pytest.raises(NotImplementedError):
        F.label_smooth(got, prior_dist=got[0, 0], epsilon=epsilon)


def test_smoothed_loss_and_the_layer_match_the_reference():
    """CrossEntropyLoss with soft labels from label_smooth(one_hot),
    a class weight, use_softmax=False and ignore_index, against the
    reference's layer; under auto_cast the bfloat16 logits and labels
    enter softmax_with_cross_entropy as float32 (its black list)."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch import nn
    logits, label = _ce_inputs(False, seed=3)
    soft = JF.label_smooth(JF.one_hot(paddle.to_tensor(label), 11))
    tsoft = F.label_smooth(F.one_hot(torch.from_numpy(label), 11))
    weight = np.linspace(0.5, 1.5, 11).astype(np.float32)
    for kw, jl, tl in (
            (dict(soft_label=True), soft, tsoft),
            (dict(ignore_index=4), paddle.to_tensor(label),
             torch.from_numpy(label)),
            (dict(use_softmax=False, reduction="sum"),
             paddle.to_tensor(label), torch.from_numpy(label))):
        x = logits if kw.get("use_softmax", True) else np.exp(logits) / \
            np.exp(logits).sum(-1, keepdims=True)
        want = jnn.CrossEntropyLoss(**kw)(paddle.to_tensor(x), jl)
        got = nn.CrossEntropyLoss(**kw)(torch.from_numpy(x), tl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=1e-6, atol=1e-6)
    want = jnn.CrossEntropyLoss(weight=paddle.to_tensor(weight))(
        paddle.to_tensor(logits), paddle.to_tensor(label))
    got = nn.CrossEntropyLoss(weight=torch.from_numpy(weight))(
        torch.from_numpy(logits), torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6, atol=1e-6)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jd = JF.softmax_with_cross_entropy(
            paddle.to_tensor(logits).astype("bfloat16"),
            soft.astype("bfloat16"), soft_label=True).dtype
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        td = F.softmax_with_cross_entropy(
            torch.from_numpy(logits).bfloat16(), tsoft.bfloat16(),
            soft_label=True).dtype
    assert td == torch.float32 and str(jd).endswith("float32")


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_softmax_with_cross_entropy_returns_the_softmax(soft):
    """return_softmax: (loss, softmax(logits)) as the reference's."""
    from paddle_tpu.nn import functional as JF
    logits, label = _ce_inputs(soft, seed=6)
    jl, js = JF.softmax_with_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label), soft_label=soft,
        return_softmax=True)
    tl, ts = F.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label), soft_label=soft,
        return_softmax=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                               rtol=1e-6, atol=1e-7)


def test_cross_entropy_weight_with_an_ignored_label():
    """A class weight with an ignored label: that position weighs 0 (the
    reference's lookup of -100 reads outside the weight: NaN)."""
    logits, label = _ce_inputs(False, seed=4)
    label[0, :2] = -100
    weight = np.linspace(0.5, 1.5, 11).astype(np.float32)
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                          weight=torch.from_numpy(weight))
    per = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                          reduction="none")
    w = np.where(label == -100, 0.0, weight[np.maximum(label, 0)])
    np.testing.assert_allclose(got.numpy(),
                               (per.numpy() * w).sum() / w.sum(), rtol=1e-6)


def test_eager_step_matches_the_train_step():
    # Optimizer.step() after loss.backward() is the train step's update
    crit = GPTPretrainingCriterion()
    a = tgpt_tiny(device="cpu", seed=4, **NO_DROPOUT)
    b = tgpt_tiny(device="cpu", seed=4, **NO_DROPOUT)
    opt_a = optimizer.AdamW(parameters=a.parameters(), learning_rate=LR,
                            device="cpu")
    opt_b = optimizer.AdamW(parameters=b.parameters(), learning_rate=LR,
                            device="cpu")
    step_a = make_train_step(a, lambda o, l: crit(o, l), opt_a,
                             device="cpu")
    for x, y in _batches(2, seed=5):
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        step_a([x], [y])
        crit(b(x), y).backward()
        opt_b.step()
        opt_b.clear_grad(set_to_zero=False)
        assert all(p.grad is None for p in b.parameters())
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=n)


def test_adam_l2_weight_decay_matches_reference():
    # Adam's weight_decay is an L2 term on the gradient, as in the
    # reference (optimizer L2Decay), unlike AdamW's decoupled decay
    from paddle_tpu_torch.nn import Linear
    rs = np.random.RandomState(0)
    x = rs.randn(5, 4).astype(np.float32)
    paddle.seed(0)
    jlin = paddle.nn.Linear(4, 3)
    jopt = paddle.optimizer.Adam(parameters=jlin.parameters(),
                                 learning_rate=LR, weight_decay=0.1)
    tlin = Linear(4, 3)
    load_reference_state(tlin, {k: np.asarray(v.numpy())
                                for k, v in jlin.state_dict().items()})
    topt = optimizer.Adam(parameters=tlin.parameters(), learning_rate=LR,
                          weight_decay=0.1, device="cpu")
    for _ in range(3):
        (jlin(paddle.to_tensor(x)) ** 2).sum().backward()
        jopt.step()
        jopt.clear_grad()
        (tlin(torch.from_numpy(x)) ** 2).sum().backward()
        topt.step()
        topt.clear_grad()
    for k, v in jlin.state_dict().items():
        np.testing.assert_allclose(getattr(tlin, k).detach().numpy(),
                                   np.asarray(v.numpy()), rtol=1e-6,
                                   atol=1e-6)


def test_shuffled_batches_cover_the_dataset_once():
    prandom.seed(1)
    data = [np.array([i]) for i in range(10)]
    got = [int(v) for b in io.DataLoader(data, batch_size=3, shuffle=True,
                                         device="cpu") for v in b]
    assert sorted(got) == list(range(10)) and got != list(range(10))


def test_rng_state_round_trip():
    x = torch.ones(64, 64)
    prandom.seed(7)
    state = prandom.get_rng_state()
    first = (F.dropout(x, 0.5), prandom.next_seed_offset())
    prandom.set_rng_state(state)
    second = (F.dropout(x, 0.5), prandom.next_seed_offset())
    torch.testing.assert_close(first[0], second[0], rtol=0, atol=0)
    assert first[1] == second[1]
    assert prandom.next_seed_offset()[1] == first[1][1] + 1
