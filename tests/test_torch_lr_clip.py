"""The port's LR schedulers, gradient clips and regularizers against the
JAX package, on the CPU.

Schedulers are host arithmetic copied line for line, so their `last_lr`
must equal the reference's exactly over 30 steps, and each one's state
dict crosses between the packages both ways.

The clips and the schedule run inside the train step: a 2-layer GPT of
width 64 (`gpt_tiny`, float32, both dropouts 0) with the reference's
weights goes through the JAX `make_train_step` and the port's with the
same numpy batches. Tolerances, as in test_torch_train.py: losses at
rtol 1e-4; parameters after the steps within 1e-5 wherever the first
step's |g| > 1e-4, and within steps * lr everywhere (Adam's normalised
step is near +-1 whatever the sign of a gradient at rounding level).
"""
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                     export_reference_state,
                                     load_reference_state)
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.resilience import chaos
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

VOCAB, B, T = 128, 2, 64
NO_DROPOUT = dict(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)


# ---------------------------------------------------------------------------
# schedulers


def _schedulers(lib):
    """The 16 schedules (LinearWarmup twice: over a schedule, as the
    GPT-2 configuration takes it, and over a number)."""
    return {
        "NoamDecay": lambda: lib.NoamDecay(64, 5, learning_rate=2.0),
        "PiecewiseDecay": lambda: lib.PiecewiseDecay([3, 9, 20],
                                                     [0.1, 0.05, 0.01, 1e-3]),
        "NaturalExpDecay": lambda: lib.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: lib.InverseTimeDecay(0.5, 0.2),
        "PolynomialDecay": lambda: lib.PolynomialDecay(0.3, 12, 1e-3, 2.0),
        "PolynomialDecay_cycle": lambda: lib.PolynomialDecay(
            0.3, 7, 1e-3, 1.5, cycle=True),
        "LinearWarmup": lambda: lib.LinearWarmup(
            lib.CosineAnnealingDecay(1e-4, T_max=100), warmup_steps=4,
            start_lr=0.0, end_lr=1e-4),
        "LinearWarmup_number": lambda: lib.LinearWarmup(0.2, 6, 0.0, 0.2),
        "ExponentialDecay": lambda: lib.ExponentialDecay(0.4, 0.9),
        "MultiStepDecay": lambda: lib.MultiStepDecay(0.4, [4, 10, 25], 0.5),
        "StepDecay": lambda: lib.StepDecay(0.4, 7, 0.3),
        "LambdaDecay": lambda: lib.LambdaDecay(0.4, lambda e: 0.95 ** e),
        "MultiplicativeDecay": lambda: lib.MultiplicativeDecay(
            0.4, lambda e: 0.9),
        "CosineAnnealingDecay": lambda: lib.CosineAnnealingDecay(
            0.3, T_max=17, eta_min=1e-3),
        "ReduceOnPlateau": lambda: lib.ReduceOnPlateau(
            0.5, patience=2, cooldown=1, factor=0.5),
        "CyclicLR": lambda: lib.CyclicLR(1e-3, 1e-2, 4, step_size_down=6,
                                         mode="triangular2"),
        "OneCycleLR": lambda: lib.OneCycleLR(0.1, 25),
        "Pow2DecayWithLinearWarmup": lambda: lib.Pow2DecayWithLinearWarmup(
            5, 20, 0.2, 1e-3),
    }


SCHEDULES = sorted(_schedulers(tlr))
# the plateau schedule's metric: falls, then stalls
PLATEAU = [5.0, 4.0, 3.5, 3.6, 3.6, 3.7, 3.5, 3.49, 3.6, 3.6] * 3


def _advance(s, i):
    if isinstance(s, (tlr.ReduceOnPlateau, jlr.ReduceOnPlateau)):
        s.step(PLATEAU[i % len(PLATEAU)])
    else:
        s.step()


def _trajectory(s, n, start=0):
    out = []
    for i in range(start, start + n):
        out.append(s())
        _advance(s, i)
    return out


def test_every_schedule_is_ported():
    subclasses = {c.__name__ for c in vars(jlr).values()
                  if isinstance(c, type) and issubclass(c, jlr.LRScheduler)
                  and c is not jlr.LRScheduler}
    ported = {c.__name__ for c in vars(tlr).values()
              if isinstance(c, type) and issubclass(c, tlr.LRScheduler)
              and c is not tlr.LRScheduler}
    assert len(subclasses) == 16 and ported == subclasses
    assert {n.split("_")[0] for n in SCHEDULES} == subclasses


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_last_lr_equals_the_reference(name):
    got = _trajectory(_schedulers(tlr)[name](), 30)
    want = _trajectory(_schedulers(jlr)[name](), 30)
    assert got == want
    assert len(set(got)) > 1


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_state_dict_crosses_both_ways(name):
    """10 steps in one package, its state dict into the other's fresh
    schedule, 20 more steps in each: equal values."""
    for src_lib, dst_lib in ((jlr, tlr), (tlr, jlr)):
        src = _schedulers(src_lib)[name]()
        _trajectory(src, 10)
        dst = _schedulers(dst_lib)[name]()
        dst.set_state_dict(src.state_dict())
        assert _trajectory(dst, 20, 10) == _trajectory(src, 20, 10)


# ---------------------------------------------------------------------------
# clips and regularizers in the train step


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


def _first_grads():
    ref, _ = _pair()
    x, y = _batches(1)[0]
    loss = JCriterion()(ref(paddle.to_tensor(x)), paddle.to_tensor(y))
    loss.backward()
    return {n: np.abs(np.asarray(p.grad.numpy()))
            for n, p in ref.named_parameters()}


@pytest.fixture(scope="module")
def first_grads():
    return _first_grads()


def _run_both(make_opts, steps=4, no_clip=(), sched=False):
    """`steps` train steps through both packages' make_train_step with
    the optimizers `make_opts(ref, port)` gives; parameters named in
    `no_clip` get need_clip False on both sides."""
    ref, port = _pair()
    for model in (ref, port):
        for n, p in model.named_parameters():
            if n in no_clip:
                p.need_clip = False
    jopt, topt = make_opts(ref, port)
    jcrit, tcrit = JCriterion(), GPTPretrainingCriterion()
    jstep = jmake_train_step(ref, lambda o, l: jcrit(o, l), jopt)
    tstep = make_train_step(port, lambda o, l: tcrit(o, l), topt,
                            device="cpu")
    jl, tl, lrs = [], [], []
    for x, y in _batches(steps):
        loss, _ = jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        jl.append(float(loss.numpy()))
        loss, _ = tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
        tl.append(float(loss))
        lrs.append((float(topt._scalars[0]), np.float32(jopt.get_lr())))
        if sched:
            jopt._lr.step()
            topt._lr.step()
    jparams = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    return jl, tl, jparams, export_reference_state(port), topt, tstep, lrs


def _hold(jl, tl, jparams, tparams, g1, max_lr, steps):
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for name, want in jparams.items():
        diff = np.abs(tparams[name] - want)
        assert diff.max() <= steps * max_lr + 1e-7, name
        live = g1[name] > 1e-4
        assert diff[live].max(initial=0.0) <= 1e-5, name


CLIPS = {
    "value": lambda lib: lib.ClipGradByValue(2e-3),
    "norm": lambda lib: lib.ClipGradByNorm(0.05),
    "global_norm": lambda lib: lib.ClipGradByGlobalNorm(0.5),
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_clip_in_the_train_step_matches_the_reference(clip, first_grads):
    """Each clip class through make_train_step against the reference's
    compiled step, AdamW at lr 1e-3, one parameter with need_clip False
    (only ClipGradByGlobalNorm reads it, as in the reference)."""
    lr = 1e-3

    def opts(ref, port):
        return (jopt_mod.AdamW(learning_rate=lr, weight_decay=0.01,
                               parameters=ref.parameters(),
                               grad_clip=CLIPS[clip](jopt_mod)),
                optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                parameters=port.parameters(),
                                grad_clip=CLIPS[clip](optimizer),
                                device="cpu"))

    jl, tl, jp, tp, topt, step, _ = _run_both(
        opts, no_clip=("gpt.ln_f.weight",))
    _hold(jl, tl, jp, tp, first_grads, lr, 4)
    assert step.compiles == 1
    scale = float(topt._scalars[ck.SCALE])
    if clip == "global_norm":
        assert 0.0 < scale < 1.0           # the clip bit, on the device
    else:
        assert scale == 1.0                # composed ops: the word unused


def test_schedule_and_global_norm_clip_in_the_train_step(first_grads):
    """The GPT-2 configuration's optimizer (LinearWarmup over
    CosineAnnealingDecay, ClipGradByGlobalNorm(1.0), weight decay 0.01)
    at lr 1e-3: each step stages the schedule's value, as the reference's
    step takes it."""
    def opts(ref, port):
        mk = [_schedulers(lib)["LinearWarmup"]() for lib in (jlr, tlr)]
        for s in mk:                        # 1e-3 peak: the steps show
            s.end_lr = 1e-3
            s.lr.base_lr = 1e-3
        return (jopt_mod.AdamW(learning_rate=mk[0], weight_decay=0.01,
                               parameters=ref.parameters(),
                               grad_clip=jopt_mod.ClipGradByGlobalNorm(1.0)),
                optimizer.AdamW(learning_rate=mk[1], weight_decay=0.01,
                                parameters=port.parameters(),
                                grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                                device="cpu"))

    jl, tl, jp, tp, topt, step, lrs = _run_both(opts, steps=6, sched=True)
    _hold(jl, tl, jp, tp, first_grads, 1e-3, 6)
    assert [a for a, _ in lrs] == [float(b) for _, b in lrs]
    assert lrs[0][0] == 0.0 and lrs[4][0] == np.float32(1e-3)
    assert step.compiles == 1 and topt._step_count == 6


@pytest.mark.parametrize("reg", ["l1", "l2_then_clip"])
def test_regularizer_then_clip_order(reg, first_grads):
    """L1Decay, and L2Decay under ClipGradByGlobalNorm (the regularized
    gradient is what the clip sees), against the reference."""
    lr = 1e-3

    def kw(lib):
        if reg == "l1":
            return dict(weight_decay=lib.L1Decay(0.05))
        return dict(weight_decay=lib.L2Decay(2.0),
                    grad_clip=lib.ClipGradByGlobalNorm(0.5))

    def opts(ref, port):
        return (jopt_mod.Adam(learning_rate=lr, parameters=ref.parameters(),
                              **kw(jopt_mod)),
                optimizer.Adam(learning_rate=lr,
                               parameters=port.parameters(), device="cpu",
                               **kw(optimizer)))

    jl, tl, jp, tp, _, _, _ = _run_both(opts)
    _hold(jl, tl, jp, tp, first_grads, lr, 4)


def test_scale_word_equals_the_composed_float32_product():
    """Under O2 (bfloat16 parameters and gradients) the scale word gives
    the reference's float32 product g * scale: bit-equal to the composed
    clip (the gradient widened, times the scale) and then the rule, for
    the fused route's plain version and for the plain rule; and a
    bfloat16 product would differ."""
    rs = np.random.RandomState(4)
    shapes = [(64, 48), (48,), (7, 5)]
    params = [torch.from_numpy(rs.randn(*s).astype(np.float32) * 0.02
                               ).bfloat16() for s in shapes]
    grads = [torch.from_numpy(rs.randn(*s).astype(np.float32)).bfloat16()
             for s in shapes]
    clip = optimizer.ClipGradByGlobalNorm(0.5)
    pairs = list(zip(params, grads))
    scale = clip.scale(pairs)
    assert scale.dtype == torch.float32 and 0 < float(scale) < 1
    norm = math.sqrt(sum(float((g.float() ** 2).sum()) for g in grads))
    np.testing.assert_allclose(float(scale), 0.5 / norm, rtol=1e-6)
    sc = torch.from_numpy(ck.adam_step_scalars(1e-2, 3, 0.9, 0.999))
    sc[ck.SCALE] = scale
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)
    composed = [g for _, g in clip(pairs)]
    results = []
    for route in ("word_fused", "word_plain", "composed", "bf16_product"):
        p = [t.clone() for t in params]
        m = [torch.full(t.shape, 0.1) for t in params]
        v = [torch.full(t.shape, 0.2) for t in params]
        for i, g in enumerate(grads):
            if route == "word_fused":
                ck.adamw(p[i], g, m[i], v[i], sc, scaled=True, **kw)
            elif route == "word_plain":
                ck.adamw_plain_scalars(p[i], g, m[i], v[i], sc, scaled=True,
                                       **kw)
            else:
                gc = (composed[i] if route == "composed"
                      else g * scale.bfloat16())
                assert gc.dtype == (torch.float32 if route == "composed"
                                    else torch.bfloat16)
                ck.adamw_plain_scalars(p[i], gc, m[i], v[i], sc, **kw)
        results.append(p + m + v)
    for got in results[1:3]:
        for a, b in zip(got, results[0]):
            assert torch.equal(a, b)
    assert any(not torch.equal(a, b)
               for a, b in zip(results[3], results[0]))


def test_guard_with_global_norm_clip_still_skips_the_step():
    """A NaN step under ClipGradByGlobalNorm: the scale is NaN, the guard's
    word still stops the update, and the skip counters count it."""
    _, port = _pair()
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=port.parameters(),
                          grad_clip=optimizer.ClipGradByGlobalNorm(0.5),
                          device="cpu")
    crit = GPTPretrainingCriterion()
    chaos.configure("nan_at_step:2")
    set_flags({"FLAGS_skip_nonfinite_steps": True})
    try:
        step = make_train_step(port, lambda o, l: crit(o, l), opt,
                               device="cpu")
    finally:
        set_flags({"FLAGS_skip_nonfinite_steps": False})
        chaos.reset()
    states = []
    for x, y in _batches(3):
        loss, _ = step([torch.from_numpy(x)], [torch.from_numpy(y)])
        states.append(([p.detach().clone() for p in port.parameters()],
                       float(loss), float(opt._scalars[ck.SCALE])))
    assert step.skipped_steps == 1 and not step.last_step_skipped
    assert math.isnan(states[1][1]) and math.isnan(states[1][2])
    for a, b in zip(states[0][0], states[1][0]):
        assert torch.equal(a, b)
    assert np.isfinite(states[2][1]) and 0 < states[2][2] <= 1
    assert not all(torch.equal(a, b)
                   for a, b in zip(states[1][0], states[2][0]))


def test_optimizer_takes_a_scheduler_and_refuses_set_lr():
    sched = tlr.StepDecay(0.1, 2)
    p = torch.zeros(3, requires_grad=True)
    opt = optimizer.AdamW(learning_rate=sched, parameters=[p], device="cpu")
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)
    with pytest.raises(TypeError):
        optimizer.AdamW(learning_rate="0.1", parameters=[p], device="cpu")
    sched.step()
    sched.step()
    opt.stage_step()
    assert float(opt._scalars[0]) == np.float32(0.01)
    assert opt.state_dict()["LR_Scheduler"]["last_epoch"] == 2
