"""The port's compile-once train step against the JAX package, on the CPU.

`jit.make_train_step` keeps one program per input signature (the
reference's one executable an `_aval_sig`): on CUDA a captured CUDA graph,
replayed; on the CPU the same body run eagerly under the same counters,
which is what these tests drive. The step's per-call state reaches the
kernels through device memory, as the reference passes it as arguments:
the RNG's Philox word (each dropout draw of a step reads (seed, base +
i)) and the optimizer's scalar buffer (lr, 1 - beta1^t, 1 - beta2^t).

Tolerances: the programmed step against the JAX `make_train_step` at
p = 0 as in tests/test_torch_train.py (losses at rtol 1e-4; parameters
within 5 * lr everywhere and 1e-5 where the first step's |g| > 1e-4:
Adam's normalised step follows the sign of a gradient at rounding level).
The word and the scalar buffer are held bit for bit to the host
arguments they replace.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import BertPretrainingCriterion as JBertCriterion
from paddle_tpu.models import GPTPretrainingCriterion as JGPTCriterion
from paddle_tpu.models import bert_tiny as jbert_tiny
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.jit import StepPrograms, TrainStep, make_train_step
from paddle_tpu_torch.models import BertPretrainingCriterion
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.models import bert_tiny as tbert_tiny
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import export_reference_state
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

LR, STEPS = 1e-3, 3
GPT_VOCAB, BERT_VOCAB, B, T = 128, 1024, 2, 32
KW = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)


def _gpt_batches(n, seed=0, b=B, t=T):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, GPT_VOCAB, (n, b, t + 1)).astype(np.int64)
    return [([x[:, :-1]], [x[:, 1:]]) for x in ids]


def _bert_batches(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, BERT_VOCAB, (B, T)).astype(np.int64)
        labels = ids.copy()
        labels[:, ::5] = -100
        out.append(([ids], [labels, rs.randint(0, 2, (B,)).astype(np.int64)]))
    return out


MODELS = {
    "gpt": (jgpt_tiny, tgpt_tiny, JGPTCriterion, GPTPretrainingCriterion,
            dict(attn_dropout_prob=0.0, hidden_dropout_prob=0.0),
            _gpt_batches),
    "bert": (jbert_tiny, tbert_tiny, JBertCriterion, BertPretrainingCriterion,
             dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
             _bert_batches),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_programmed_step_matches_the_reference_over_three_steps(name):
    jmodel, tmodel, jcrit_cls, tcrit_cls, no_dropout, batches = MODELS[name]
    paddle.seed(0)
    ref = jmodel(**no_dropout)
    port = tmodel(device="cpu", seed=1, **no_dropout)
    load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    twin = tmodel(device="cpu", seed=1, **no_dropout)
    twin.load_state_dict(port.state_dict())
    jcrit, tcrit = jcrit_cls(), tcrit_cls()
    jopt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                  learning_rate=LR, weight_decay=0.01)
    topt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                           weight_decay=0.01, device="cpu")
    jstep = jmake_train_step(ref, lambda *a: jcrit(*a), jopt)
    tstep = make_train_step(port, lambda *a: tcrit(*a), topt, device="cpu")
    data = batches(STEPS)
    # the first step's gradients, from the same weights run eagerly
    (x0, y0) = data[0]
    outs = twin(*[_t(a) for a in x0])
    outs = list(outs) if isinstance(outs, tuple) else [outs]
    tcrit(*outs, *[_t(a) for a in y0]).backward()
    g1 = {n: p.grad.numpy() for n, p in twin.named_parameters()}
    jl, tl = [], []
    for x, y in data:
        loss, _ = jstep([paddle.to_tensor(a) for a in x],
                        [paddle.to_tensor(a) for a in y])
        jl.append(float(loss.numpy()))
        loss, _ = tstep([_t(a) for a in x], [_t(a) for a in y])
        tl.append(float(loss))
    assert tstep.compiles == 1 and tstep.replays == STEPS - 1
    assert topt._step_count == STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jparams = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    tparams = export_reference_state(port)
    names = dict(zip((n for n, _ in port.named_parameters()),
                     (n for n, _ in ref.named_parameters())))
    for tname, grad in g1.items():
        got, want = tparams[names[tname]], jparams[names[tname]]
        diff = np.abs(got - want)
        assert diff.max() <= 5 * LR, tname
        live = np.abs(grad) > 1e-4
        assert diff[live].max(initial=0.0) <= 1e-5, tname


def _gpt_step(seed=0, **kw):
    model = tgpt_tiny(device="cpu", seed=seed, **kw)
    model.train()
    opt = optimizer.AdamW(parameters=model.parameters(), learning_rate=LR,
                          weight_decay=0.01, device="cpu")
    crit = GPTPretrainingCriterion()
    return model, opt, make_train_step(model, lambda o, l: crit(o, l), opt,
                                       device="cpu")


def test_one_program_per_input_signature():
    _, _, step = _gpt_step(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)
    assert isinstance(step, TrainStep) and step.compiles == 0
    for x, y in _gpt_batches(3):
        step([_t(a) for a in x], [_t(a) for a in y])
    assert (step.compiles, step.replays) == (1, 2)
    for x, y in _gpt_batches(2, seed=1, t=16) + _gpt_batches(1, seed=2):
        step([_t(a) for a in x], [_t(a) for a in y])
    assert (step.compiles, step.replays) == (2, 4)
    assert sorted(step.programs.replays.values()) == [1, 3]
    assert len(step._static) == 2


def test_a_rebound_parameter_raises():
    model, _, step = _gpt_step(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)
    (x, y), = _gpt_batches(1)
    batch = ([_t(a) for a in x], [_t(a) for a in y])
    step(*batch)
    w = model.gpt.ln_f.weight
    with torch.no_grad():
        w.copy_(w * 2.0)                 # loaded in place: seen, fine
    step(*batch)
    w.data = w.detach().clone()          # rebound: its address moved
    with pytest.raises(RuntimeError, match="moved"):
        step(*batch)


def test_outputs_survive_the_next_call():
    _, _, step = _gpt_step()
    (x1, y1), (x2, y2) = _gpt_batches(2)
    loss, (logits,) = step([_t(x1[0])], [_t(y1[0])])
    kept = (loss.clone(), logits.clone())
    _, (logits2,) = step([_t(x2[0])], [_t(y2[0])])
    assert torch.equal(loss, kept[0]) and torch.equal(logits, kept[1])
    assert not torch.equal(logits2, logits)


@pytest.mark.parametrize("seed,base,delta", [
    (0x0123456789ABCDEF, 5, 3), (0xFEDCBA9876543210, 2 ** 32 - 2, 7),
    (7, 0, 0)])
def test_word_bits_equal_the_host_key_bits(seed, base, delta):
    word = prandom.philox_word(seed, base, "cpu")
    assert word.dtype == torch.int64 and tuple(word.shape) == (2,)
    offset = (base + delta) % 2 ** 32
    assert ck._key(word, delta) == (seed, offset)
    assert torch.equal(ck.attn_dropout_bits(word, delta, 3, 9, 11),
                       ck.attn_dropout_bits_plain(seed, offset, 3, 9, 11))
    assert torch.equal(ck.fused_dropout_bits(word, delta, 13, 40),
                       ck.fused_dropout_bits_plain(seed, offset, 13, 40))
    keep = ck.dropout_keep(word, delta, (2, 7, 40), 0.25)
    bits = ck.fused_dropout_bits_plain(seed, offset, 14, 40, tag=ck._KEEP_TAG)
    assert keep.dtype == torch.bool
    assert torch.equal(keep.reshape(14, 40), bits >= int(0.25 * 2 ** 32))
    # the keep mask's own tag: another draw than the fused kernels'
    assert not torch.equal(bits, ck.fused_dropout_bits_plain(seed, offset,
                                                             14, 40))


def _keys_of_a_step(step, batch):
    """The (seed, offset) of every flash forward the step launched."""
    seen = []
    real = ck.flash_fwd_train

    def recording(q, k, v, causal, dropout_p=0.0, word=None, delta=0,
                  need_lse=True):
        seen.append(ck._key(word, delta))
        return real(q, k, v, causal, dropout_p, word, delta, need_lse)
    ck.flash_fwd_train = recording
    try:
        step(*batch)
    finally:
        ck.flash_fwd_train = real
    return seen


def test_steps_draw_new_offsets_and_a_restored_state_repeats_them():
    _, _, step = _gpt_step(hidden_dropout_prob=0.0)       # attention 0.1
    (x, y), = _gpt_batches(1)
    batch = ([_t(x[0])], [_t(y[0])])
    prandom.seed(5)
    step(*batch)                                  # the build
    state = prandom.get_rng_state()
    base = prandom.RNG._offset
    first = _keys_of_a_step(step, batch)
    # one draw per layer, deltas 0, 1 from the base written before the step
    assert [o for _, o in first] == [base, base + 1]
    assert prandom.RNG._offset == base + 2
    second = _keys_of_a_step(step, batch)
    assert [o for _, o in second] == [base + 2, base + 3]
    assert {s for s, _ in first + second} == {prandom.RNG._kernel_seed}
    prandom.set_rng_state(state)
    assert _keys_of_a_step(step, batch) == first
    # a draw outside a step continues the count, from the word's base
    word, delta = prandom.RNG.draw(torch.device("cpu"))
    assert ck._key(word, delta)[1] == base + 2


def test_scalar_buffer_update_equals_the_host_rule_bit_for_bit():
    rs = np.random.RandomState(0)
    saved = flags.get_flags(["use_fused_optimizer"])
    try:
        for fused in (True, False):
            flags.set_flags({"use_fused_optimizer": fused})
            for dt in (torch.float32, torch.bfloat16):
                p = torch.from_numpy(rs.randn(6, 50).astype(np.float32))
                p = p.to(dt).requires_grad_()
                grads = [torch.from_numpy(rs.randn(6, 50).astype(np.float32)
                                          * 1e-2).to(dt) for _ in range(5)]
                opt = optimizer.AdamW(parameters=[p], learning_rate=1e-3,
                                      weight_decay=0.01, device="cpu")
                want = [p.detach().clone(), torch.zeros(6, 50),
                        torch.zeros(6, 50)]
                for t, g in enumerate(grads, start=1):
                    lr = 1e-3 if t < 3 else 3e-4        # changed mid-run
                    opt.set_lr(lr)
                    opt.apply_gradients([(p, g)])
                    ck.adamw_plain(want[0], g, want[1], want[2], lr, t,
                                   coeff=0.01, **KW)
                    np.testing.assert_array_equal(
                        opt._scalars.numpy(),
                        ck.adam_step_scalars(lr, t, 0.9, 0.999))
                    m1, m2 = (opt._get_accumulators(p)[n]
                              for n in ("moment1", "moment2"))
                    assert torch.equal(p.detach(), want[0]), (fused, dt, t)
                    assert torch.equal(m1, want[1]) and torch.equal(m2,
                                                                    want[2])
    finally:
        flags.set_flags(saved)


def test_step_programs_return_the_body_result_and_check_key_buffers():
    w = torch.zeros(3)
    progs = StepPrograms("cpu", lambda: [w])
    buf = torch.zeros(2)
    assert progs("k", lambda: w + 1, [buf]) is not None
    out = progs("k", lambda: ("again", buf.sum()), [buf])
    assert out[0] == "again"
    assert progs.replays == {"k": 1}
    with pytest.raises(RuntimeError, match="moved"):
        progs("k", lambda: None, [torch.zeros(2)])
