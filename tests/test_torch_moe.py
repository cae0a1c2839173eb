"""The port's MoELayer and GPT-MoE against the JAX package's
(paddle_tpu/incubate/moe.py, models/gpt.py:300-416), on the CPU in
float32 at dropout 0.

The same weights (carried by models.load_reference_state) and numpy
inputs go through both. Tolerances: outputs and l_aux at rtol 1e-4 /
atol 1e-5 (float32 sums in another order; the reference's one-hot masks
are float64 under x64, the port's float32), gradients the same; the GPT
trajectory's losses at rtol 1e-4 over 3 AdamW steps. Routing is
discrete: every test asserts that both packages chose the same experts
for every token (no flip at these seeds), and reports the smallest gap
between the competing gate probabilities."""
import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401

import paddle_tpu as jp
from paddle_tpu.incubate import MoELayer as JMoE
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
import paddle_tpu_torch as pp
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.incubate import MoELayer
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                     export_reference_state, gpt_tiny,
                                     load_reference_state)

jax.config.update("jax_platforms", "cpu")

RTOL, ATOL = 1e-4, 1e-5
LR, STEPS, B, T, VOCAB = 1e-3, 3, 2, 16, 128
GPT_MOE = dict(moe_every_n_layers=2, moe_num_experts=4,
               attn_dropout_prob=0.0, hidden_dropout_prob=0.0)


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _moe_pair(d=16, h=24, e=4, top_k=2, cf=1.25, normalize=True, seed=7):
    jp.seed(seed)
    ref = JMoE(d_model=d, d_hidden=h, num_experts=e, top_k=top_k,
               capacity_factor=cf, normalize_gates=normalize)
    port = MoELayer(d, h, e, top_k=top_k, capacity_factor=cf,
                    normalize_gates=normalize)
    load_reference_state(port, _state(ref))
    return ref, port


def _routes(gate_w, x, top_k):
    """(first, second choices, the smallest gap between a chosen and the
    next probability) from numpy in float64."""
    logits = x.astype(np.float64) @ gate_w.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    order = np.argsort(-p, axis=-1, kind="stable")
    s = np.sort(p, -1)[:, ::-1]
    gaps = s[:, :top_k] - s[:, 1:top_k + 1]
    return order[:, :top_k], float(gaps.min())


@pytest.mark.parametrize("top_k,cf,normalize", [
    (2, 1.25, True), (2, 1.25, False), (1, 1.25, True), (2, 0.5, True),
    (1, 0.5, True)])
def test_moe_layer_output_l_aux_and_gradients_match(top_k, cf, normalize):
    """top-1 and top-2, with and without normalize_gates, and a small
    capacity that drops tokens (both packages drop the same ones)."""
    ref, port = _moe_pair(top_k=top_k, cf=cf, normalize=normalize)
    rs = np.random.RandomState(0)
    x = rs.randn(3, 8, 16).astype(np.float32)
    _, gap = _routes(_state(ref)["gate_weight"], x.reshape(-1, 16), top_k)
    assert gap > 1e-5, gap                  # no near tie at this seed
    jx = jp.to_tensor(x)
    jx.stop_gradient = False
    jy = ref(jx)
    w = rs.rand(*jy.shape).astype(np.float32)
    jloss = jp.sum(jy * jp.to_tensor(w)) + 0.3 * ref.l_aux
    jloss.backward()
    px = torch.from_numpy(x).requires_grad_(True)
    py = port(px)
    ploss = (py * torch.from_numpy(w)).sum() + 0.3 * port.l_aux
    ploss.backward()
    np.testing.assert_allclose(py.detach().numpy(), jy.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(port.l_aux), float(ref.l_aux.numpy()),
                               rtol=RTOL)
    np.testing.assert_allclose(px.grad.numpy(), jx.grad.numpy(), rtol=RTOL,
                               atol=ATOL)
    for name in ("gate_weight", "w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(
            getattr(port, name).grad.numpy(),
            getattr(ref, name).grad.numpy(), rtol=RTOL, atol=ATOL,
            err_msg=name)
    C = port.capacity(24)
    assert C == ref.capacity(24)
    dropped = int(port.dropped)
    assert 0 <= dropped <= 24 * top_k and (dropped > 0 or cf >= 1.0)


def test_l_aux_of_a_uniform_gate_is_one():
    ref, port = _moe_pair(d=8, h=8, e=4, top_k=1, cf=8.0, seed=1)
    with torch.no_grad():
        port.gate_weight.zero_()
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 8)
                         .astype(np.float32))
    port(x)
    np.testing.assert_allclose(float(port.l_aux), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(port.l_aux_value), 1.0, rtol=1e-6)


def test_capacity_drops_overflow_tokens():
    """All tokens prefer expert 0 (a uniform gate): with C = 2 < S the
    first two are served, the rest give 0 (reference test_moe.py:82)."""
    _, port = _moe_pair(d=8, h=8, e=2, top_k=1, cf=0.5, seed=2)
    with torch.no_grad():
        port.gate_weight.zero_()
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 8)
                         .astype(np.float32))
    y = port(x).detach().numpy()
    assert port.capacity(8) == 2 and int(port.dropped) == 6
    assert np.abs(y[:2]).sum() > 0
    np.testing.assert_allclose(y[2:], 0.0, atol=1e-6)


def _gpt_pair():
    jp.seed(3)
    ref = jgpt_tiny(**GPT_MOE)
    port = gpt_tiny(device="cpu", seed=4, **GPT_MOE)
    load_reference_state(port, _state(ref))
    return ref, port


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (n, B, T + 1)).astype(np.int64)
    return [(x[:, :-1], x[:, 1:]) for x in ids]


def test_load_reference_state_carries_the_moe_weights():
    ref, port = _gpt_pair()
    names = [n for n in _state(ref) if ".mlp." in n and "layers.1" in n]
    assert sorted(n.split(".")[-1] for n in names) == [
        "b1", "b2", "gate_weight", "l_aux_value", "w1", "w2"]
    back = export_reference_state(port)
    for n in names:
        np.testing.assert_array_equal(back[n], _state(ref)[n])
    assert isinstance(port.gpt.layers[1].mlp, MoELayer)
    assert not isinstance(port.gpt.layers[0].mlp, MoELayer)


def test_gpt_moe_loss_and_first_step_gradients_match():
    ref, port = _gpt_pair()
    x, y = _batches(1)[0]
    jcrit, pcrit = JCriterion(), GPTPretrainingCriterion()
    jloss = jcrit(ref(jp.to_tensor(x)), jp.to_tensor(y)) \
        + 0.01 * ref.gpt.moe_aux_loss()
    jloss.backward()
    ploss = pcrit(port(torch.from_numpy(x)), torch.from_numpy(y)) \
        + 0.01 * port.gpt.moe_aux_loss()
    ploss.backward()
    np.testing.assert_allclose(float(ploss), float(jloss.numpy()),
                               rtol=RTOL)
    np.testing.assert_allclose(float(port.gpt.moe_aux_loss()),
                               float(ref.gpt.moe_aux_loss().numpy()),
                               rtol=RTOL)
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in ref.named_parameters()}
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_gpt_moe_three_adamw_steps_match_and_l_aux_reads_after_a_step():
    ref, port = _gpt_pair()
    jcrit, pcrit = JCriterion(), GPTPretrainingCriterion()
    jopt = jp.optimizer.AdamW(parameters=ref.parameters(), learning_rate=LR,
                              weight_decay=0.01)
    popt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                           weight_decay=0.01, device="cpu")
    jstep = jmake_train_step(
        ref, lambda o, l: jcrit(o, l) + 0.01 * ref.gpt.moe_aux_loss(), jopt)
    pstep = make_train_step(
        port, lambda o, l: pcrit(o, l) + 0.01 * port.gpt.moe_aux_loss(),
        popt, device="cpu")
    jl, pl, jaux, paux = [], [], [], []
    for x, y in _batches(STEPS):
        loss, _ = jstep([jp.to_tensor(x)], [jp.to_tensor(y)])
        jl.append(float(loss.numpy()))
        jaux.append(float(ref.gpt.moe_aux_loss().numpy()))
        loss, _ = pstep([torch.from_numpy(x)], [torch.from_numpy(y)])
        pl.append(float(loss))
        # after the step: the buffer the step wrote, a number
        aux = port.gpt.moe_aux_loss()
        assert aux is port.gpt.layers[1].mlp.l_aux_value
        paux.append(float(aux))
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    np.testing.assert_allclose(paux, jaux, rtol=RTOL)
    assert all(np.isfinite(paux)) and min(paux) > 0
    jparams, pparams = _state(ref), export_reference_state(port)
    for n, v in jparams.items():
        np.testing.assert_allclose(pparams[n], v, rtol=1e-4, atol=5 * LR,
                                   err_msg=n)


def test_o2_bf16_dtypes_match_the_reference():
    ref, port = _gpt_pair()
    jopt = jp.optimizer.AdamW(parameters=ref.parameters(), learning_rate=LR)
    popt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                           device="cpu")
    ref, _ = jp.amp.decorate(ref, jopt, level="O2", dtype="bfloat16")
    port, _ = amp.decorate(port, popt, level="O2", dtype="bfloat16")
    x, _ = _batches(1)[0]
    jout = ref(jp.to_tensor(x))
    pout = port(torch.from_numpy(x))
    assert str(pout.dtype).replace("torch.", "") == jout.dtype.name
    moe = port.gpt.layers[1].mlp
    for n in ("gate_weight", "w1", "b1", "w2", "b2"):
        assert getattr(moe, n).dtype == torch.bfloat16
    # the gate runs in float32 under O2 too
    h = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    assert moe(h).dtype == torch.bfloat16 and moe.l_aux.dtype == torch.float32
