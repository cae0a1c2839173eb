"""The port's train-step guards, watchdog, chaos drills and telemetry, and
`make_eval_step`, against the JAX package, on the CPU.

The same seeded numpy weights and batches go through the reference's
`make_train_step` / `make_eval_step` and the port's (whose programs run
their bodies eagerly on the CPU). The models: `gpt_tiny` (2 layers,
hidden 64) without dropout at T=16, and, for the inf planted through an
input, a Linear(4, 2) whose loss sum(out * y) stays finite while the
gradient of its weight overflows. One PADDLE_TPU_CHAOS spec drives both
packages; each keeps its own fire-once counters, so the drills reset both.

Tolerances: float32 losses, parameters and both AdamW moments after each
step at rtol 1e-5 / atol 1e-6; a skipped step's state bit-equal to the
state before it (in the port; the reference's jnp.where is exact too).
Eval outputs and loss at rtol 1e-4 / atol 1e-5, as the forward parity
tests hold them (float32 through two layers, summed in other orders).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.flags import get_flags as jget_flags
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.framework.random import RNG as JRNG
from paddle_tpu.jit.engine import make_eval_step as jmake_eval_step
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import journal as jjournal
from paddle_tpu.observability import memprof as jmemprof
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.jit import (EvalStep, TrainStep, make_eval_step,
                                  make_train_step)
from paddle_tpu_torch.jit.engine import all_finite
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.observability import (flight, journal, memprof,
                                            metrics, tracing)
from paddle_tpu_torch.resilience import chaos, health, watchdog

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, B, T, LR = 128, 2, 16, 1e-3
NO_DROPOUT = dict(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)
GUARD_FLAGS = ("skip_nonfinite_steps", "step_watchdog_s",
               "step_watchdog_action")
RTOL, ATOL = 1e-5, 1e-6


def _set_both(values):
    flags.set_flags(values)
    jset_flags({"FLAGS_" + k: v for k, v in values.items()})


def _chaos(spec):
    """One spec for both packages, their fire-once counters restarted."""
    for mod in (chaos, jchaos):
        mod.reset()
    for mod in (chaos, jchaos):
        mod.configure(spec)


@pytest.fixture(autouse=True)
def guards_off_after():
    saved = flags.get_flags(list(GUARD_FLAGS))
    jsaved = jget_flags(["FLAGS_" + k for k in GUARD_FLAGS])
    yield
    flags.set_flags(saved)
    jset_flags(jsaved)
    chaos.reset()
    jchaos.reset()
    # a fired watchdog makes /healthz answer 503 for the rest of the
    # process, in either package: drop both counters so that no later
    # test in this worker (the servers' and the live planes') inherits it
    for registry in (metrics.REGISTRY, jmetrics.REGISTRY):
        registry.unregister("pt_watchdog_fires_total")


def _gpt_pair(**kw):
    paddle.seed(0)
    cfg = dict(NO_DROPOUT, **kw)
    ref = jgpt_tiny(**cfg)
    port = tgpt_tiny(device="cpu", seed=1, **cfg)
    load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


def _batches(n, seed=0, t=T):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (n, B, t + 1)).astype(np.int64)
    return [([x[:, :-1]], [x[:, 1:]]) for x in ids]


def _gpt_steps(ref, port):
    jcrit, tcrit = JCriterion(), GPTPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                  learning_rate=LR, weight_decay=0.01)
    topt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                           weight_decay=0.01, device="cpu")
    jstep = jmake_train_step(ref, lambda o, l: jcrit(o, l), jopt)
    tstep = make_train_step(port, lambda o, l: tcrit(o, l), topt,
                            device="cpu")
    return (jstep, jopt), (tstep, topt)


def _run(step, batch, lib):
    x, y = batch
    to = paddle.to_tensor if lib == "jax" else torch.from_numpy
    loss, _ = step([to(a) for a in x], [to(a) for a in y])
    return float(np.asarray(loss.numpy() if lib == "jax"
                            else loss.detach()))


def _state(model, opt):
    """Each parameter and its two moments, as numpy, by parameter name."""
    out = {}
    for name, p in model.named_parameters():
        accs = opt._get_accumulators(p)
        if isinstance(p, torch.Tensor):
            vals = [p.detach().numpy()] + [accs[k].numpy() for k in
                                           ("moment1", "moment2")]
        else:
            vals = [np.asarray(p.numpy())] + [np.asarray(accs[k]) for k in
                                              ("moment1", "moment2")]
        for suffix, v in zip(("", "@m1", "@m2"), vals):
            out[name + suffix] = np.array(v, copy=True)
    return out


def _assert_states_close(got, want, what):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg="%s %s" % (what, k))


# --------------------------------------------------------- the guard


@pytest.mark.parametrize("model", ["linear", "gpt"])
def test_nan_drill_matches_the_reference(model):
    """nan_at_step:3 with skip_nonfinite_steps on, 5 steps: the loss is NaN
    at step 3 only, that step is skipped (parameters and moments as after
    step 2, bit for bit), and every other step matches the reference.
    gpt_tiny's parameters are held through its moments only: its key
    bias has an exact gradient of 0, so both sides see rounding noise
    there, and Adam's normalised step turns noise of either sign into
    +-lr (tests/test_torch_train.py); the Linear model holds them too."""
    _set_both({"skip_nonfinite_steps": True})
    _chaos("nan_at_step:3")
    if model == "gpt":
        ref, port = _gpt_pair()
        (jstep, jopt), (tstep, topt) = _gpt_steps(ref, port)
        batches = _batches(5, seed=1)
    else:
        ref, port = _linear_pair()
        (jstep, jopt), (tstep, topt) = _linear_steps(ref, port)
        batches = _linear_batches(5)
    assert tstep.guard and tstep.nan_step == 3
    skips = {"jax": [], "port": []}
    losses = {"jax": [], "port": []}
    states = []
    for batch in batches:
        losses["jax"].append(_run(jstep, batch, "jax"))
        losses["port"].append(_run(tstep, batch, "port"))
        skips["jax"].append(jstep.last_step_skipped)
        skips["port"].append(tstep.last_step_skipped)
        states.append((_state(ref, jopt), _state(port, topt)))
    assert skips["jax"] == skips["port"] == [False, False, True, False,
                                             False]
    assert jstep.skipped_steps == tstep.skipped_steps == 1
    assert topt._step_count == jopt._step_count == 5
    nan = [np.isnan(x) for x in losses["port"]]
    assert nan == [np.isnan(x) for x in losses["jax"]] == [
        False, False, True, False, False]
    finite = [i for i in range(5) if not nan[i]]
    np.testing.assert_allclose([losses["port"][i] for i in finite],
                               [losses["jax"][i] for i in finite],
                               rtol=RTOL, atol=ATOL)
    for i, (want, got) in enumerate(states):
        if model == "gpt":
            want, got = ({k: v for k, v in d.items() if "@" in k}
                         for d in (want, got))
        _assert_states_close(got, want, "after step %d" % (i + 1))
    skipped, before = states[2][1], states[1][1]
    for k in before:
        np.testing.assert_array_equal(skipped[k], before[k], err_msg=k)
    # the steps after the skip moved the model again
    assert any(not np.array_equal(states[3][1][k], before[k])
               for k in before)


def _linear_pair():
    rs = np.random.RandomState(3)
    w = (rs.randn(4, 2) * 1e-4).astype(np.float32)
    b = np.zeros(2, np.float32)
    paddle.seed(0)
    ref = paddle.nn.Linear(4, 2)
    ref.set_state_dict({"weight": w, "bias": b})
    port = tnn.Linear(4, 2)
    load_reference_state(port, {"weight": w, "bias": b})
    return ref, port


def _linear_steps(ref, port):
    jopt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                  learning_rate=LR, weight_decay=0.01)
    topt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                           weight_decay=0.01, device="cpu")
    jstep = jmake_train_step(ref, lambda o, y: (o * y).sum(), jopt)
    tstep = make_train_step(port, lambda o, y: (o * y).sum(), topt,
                            device="cpu")
    return (jstep, jopt), (tstep, topt)


def _linear_batches(n, planted=None):
    """Linear(4, 2) batches; at step `planted` (1-based) one input element
    is 1e38: the loss stays finite (the weights are ~1e-4) while the
    weight's gradient, 1e38 * 10, overflows to inf."""
    rs = np.random.RandomState(4)
    out = []
    for i in range(n):
        x = rs.randn(B, 4).astype(np.float32)
        if i + 1 == planted:
            x[0, 0] = 1e38
        out.append(([x], [np.full((B, 2), 10.0, np.float32)]))
    return out


def test_inf_gradient_through_the_input_is_skipped_like_the_reference():
    _set_both({"skip_nonfinite_steps": True})
    ref, port = _linear_pair()
    (jstep, jopt), (tstep, topt) = _linear_steps(ref, port)
    assert tstep.nan_step is None
    skips, losses, states = [], [], []
    for batch in _linear_batches(4, planted=2):
        losses.append((_run(jstep, batch, "jax"), _run(tstep, batch, "port")))
        skips.append((jstep.last_step_skipped, tstep.last_step_skipped))
        states.append((_state(ref, jopt), _state(port, topt)))
    assert skips == [(False, False), (True, True), (False, False),
                     (False, False)]
    assert jstep.skipped_steps == tstep.skipped_steps == 1
    # the loss itself was finite: the gradient alone tripped the guard
    assert np.isfinite(losses[1]).all()
    np.testing.assert_allclose([t for _, t in losses], [j for j, _ in losses],
                               rtol=RTOL, atol=ATOL)
    for i, (want, got) in enumerate(states):
        _assert_states_close(got, want, "after step %d" % (i + 1))
    for k in states[0][1]:
        np.testing.assert_array_equal(states[1][1][k], states[0][1][k])


def test_all_finite_is_exact():
    big = torch.full((5,), 3e38)
    assert bool(all_finite(torch.tensor(1.0), [big, big.bfloat16()]))
    for bad in (float("nan"), float("inf"), -float("inf")):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(7).to(dtype)
            g[3] = bad
            assert not bool(all_finite(torch.tensor(1.0), [big, g]))
        assert not bool(all_finite(torch.tensor(bad), [big]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_finite_leaves_the_gradients_bit_equal(dtype):
    """The test only reads the gradients: every bit stays as it was, -0.0,
    subnormals, the largest finite values, NaN and inf included."""
    rs = np.random.RandomState(0)
    vals = np.concatenate([rs.randn(64), [-0.0, 1e-40, -1e-42, 3e38, -3e38,
                                          float("nan"), float("inf")]])
    grads = [torch.from_numpy(vals.astype(np.float32)).to(dtype),
             torch.from_numpy(rs.randn(3, 5).astype(np.float32)).to(dtype)]
    before = [g.clone() for g in grads]
    assert not bool(all_finite(torch.tensor(1.0), grads))
    for g, b in zip(grads, before):
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(g.view(bits), b.view(bits))


def test_guard_off_runs_the_same_update_and_reads_no_word():
    """A step made with the guard off leaves last_step_skipped alone and
    still updates through the guard word the host stages at 1."""
    ref, port = _gpt_pair()
    _, (tstep, topt) = _gpt_steps(ref, port)
    assert not tstep.guard
    _run(tstep, _batches(1)[0], "port")
    assert float(topt._scalars[3]) == 1.0
    assert tstep.last_step_skipped is False and tstep.skipped_steps == 0


# ------------------------------------------------------ watchdog, OOM


def test_watchdog_dump_names_the_hung_step(tmp_path, monkeypatch):
    """step_watchdog_s=0.3 with hang_at_step:2:1.0 (action warn): both
    packages' dumps name compiled train step 2, and the step completes."""
    _set_both({"step_watchdog_s": 0.3, "step_watchdog_action": "warn"})
    for lib in ("jax", "port"):
        _chaos("hang_at_step:2:1.0")
        diag = tmp_path / ("wd-%s.txt" % lib)
        monkeypatch.setenv(watchdog.ENV_FILE, str(diag))
        ref, port = _linear_pair()
        (jstep, _), (tstep, _) = _linear_steps(ref, port)
        step = jstep if lib == "jax" else tstep
        losses = [_run(step, b, lib) for b in _linear_batches(3)]
        assert np.isfinite(losses).all()
        text = diag.read_text()
        # (the reference's first step also compiles, which may outlast
        # the bound: a dump for step 1 is no failure)
        assert "'compiled train step 2' exceeded" in text, lib


def _oom_drill(lib, run_dir, monkeypatch):
    """oom:2 through one package's train step, with its journal and flight
    directory in `run_dir`: (the raised error, the journal's oom events,
    memory.json, pt_oom_total's change, retraces before and after the
    call that followed)."""
    fl, mp, jr, mt, tr = ((jflight, jmemprof, jjournal, jmetrics, jtracing)
                          if lib == "jax" else
                          (flight, memprof, journal, metrics, tracing))
    monkeypatch.setenv(flight.ENV_DIR, str(run_dir))
    fl.reset()
    mp.reset()
    j = jr.RunJournal(str(run_dir), run_id="drill", rank=0)
    prev = jr.set_journal(j)
    oom = mt.REGISTRY.get("pt_oom_total")
    n0 = oom.value if oom is not None else 0
    retraces = tr.RETRACES.labels("jit_train")
    _chaos("oom:2")
    try:
        ref, port = _linear_pair()
        (jstep, _), (tstep, _) = _linear_steps(ref, port)
        step = jstep if lib == "jax" else tstep
        batches = _linear_batches(3)
        r0 = retraces.value
        _run(step, batches[0], lib)
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED") as err:
            _run(step, batches[1], lib)
        r1 = retraces.value
        assert np.isfinite(_run(step, batches[2], lib))
        r2 = retraces.value
    finally:
        jr.set_journal(prev)
        j.close()
        fl.reset()
        mp.reset()
    with open(j.path) as f:
        events = [json.loads(line) for line in f]
    ooms = [(e["engine"], e["step"]) for e in events if e["event"] == "oom"]
    bundles = sorted((run_dir / "crash").iterdir())
    assert len(bundles) == 1
    with open(bundles[0] / "memory.json") as f:
        mem = json.load(f)
    n1 = mt.REGISTRY.get("pt_oom_total").value
    return (str(err.value), ooms, mem, n1 - n0, (r1 - r0, r2 - r1),
            step)


def test_oom_drill_matches_the_reference(tmp_path, monkeypatch):
    got = {lib: _oom_drill(lib, tmp_path / lib, monkeypatch)
           for lib in ("jax", "port")}
    for lib, (error, ooms, mem, n_oom, retraces, _) in got.items():
        assert "oom:2" in error, lib
        assert ooms == [("jit_train", 2)], lib
        assert (mem["engine"], mem["step"]) == ("jit_train", 2), lib
        assert "RESOURCE_EXHAUSTED" in mem["error"], lib
        assert "jit_train" in mem["executables"], lib
        assert n_oom == 1, lib
        # one build at the first call; the call after the OOM built none
        assert retraces == (1, 0), lib
    tstep = got["port"][5]
    assert (tstep.compiles, tstep.replays) == (1, 1)
    args = sum(t.numel() * t.element_size() for t in tstep._held())
    assert got["port"][2]["executables"]["jit_train"]["args_bytes"] == args


def test_ptdoctor_reads_a_port_run(tmp_path, monkeypatch):
    """A few port steps with the journal, heartbeat and flight directories
    in one run directory, then the oom:2 drill: `ptdoctor summary` shows
    the jit_train retraces and the steps (the loop's `step` events, as
    the reference's fit emits them), `ptdoctor crash` the OOM bundle and
    its step.

    The run is rank 0: the flight recorder and the heartbeat take their
    rank from PADDLE_TRAINER_ID, the launcher's variable, so the test sets
    it. A test that ran earlier in the same process may have left it set
    (the reference's `health.configure(dir, rank=5)` exports it, as the
    launcher would), and the bundle would then be rank 5's."""
    run = tmp_path / "run"
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv(flight.ENV_DIR, str(run))
    monkeypatch.setenv(health.ENV_DIR, str(run))
    monkeypatch.setenv(health.ENV_INTERVAL, "0")
    flight.reset()
    memprof.reset()
    health.reset()
    j = journal.RunJournal(str(run), run_id="ptdoctor", rank=0)
    prev = journal.set_journal(j)
    _chaos("oom:4")
    ref, port = _gpt_pair()
    _, (tstep, topt) = _gpt_steps(ref, port)
    try:
        for batch in _batches(5):
            try:
                loss = _run(tstep, batch, "port")
            except RuntimeError:
                continue
            journal.emit("step", step=topt._step_count, loss=loss)
    finally:
        journal.set_journal(prev)
        j.close()
        flight.reset()
        memprof.reset()
        health.reset()

    def doctor(cmd):
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "ptdoctor.py"), cmd,
             str(run)], capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return out.stdout
    summary = doctor("summary")
    assert "retraces: jit_train=1" in summary
    assert "last-alive step=5" in summary and "step-rate=" in summary
    assert "crash bundle: rank=0 reason=oom last-alive step=4" in summary
    crash = doctor("crash")
    assert "reason        oom" in crash
    assert "last_step     4" in crash and "RESOURCE_EXHAUSTED" in crash


# --------------------------------------------------------- telemetry


def _train_counters(mod):
    return (mod.RETRACES.labels("jit_train").value, mod.TRAIN_STEPS.value,
            mod.STEP_LATENCY.labels("jit_train").count)


def test_train_telemetry_counts_equal_the_reference():
    """Signatures T=16, 16, 8, 16, 8: two retraces (one a signature), five
    TRAIN_STEPS, three cache-hit latencies, in both packages; the flight
    ring's last dispatch names the last step."""
    ref, port = _gpt_pair()
    (jstep, _), (tstep, _) = _gpt_steps(ref, port)
    seq = [_batches(1, seed=i, t=t)[0]
           for i, t in enumerate((16, 16, 8, 16, 8))]
    deltas = {}
    for lib, step, mod in (("jax", jstep, jtracing), ("port", tstep, tracing)):
        c0 = _train_counters(mod)
        for batch in seq:
            _run(step, batch, lib)
        c1 = _train_counters(mod)
        deltas[lib] = tuple(b - a for a, b in zip(c0, c1))
    assert deltas["port"] == deltas["jax"] == (2, 5, 3)
    assert (tstep.compiles, tstep.replays) == (2, 3)
    assert tstep.telemetry.engine == "jit_train"
    assert flight._last_dispatch["engine"] == "jit_train"
    assert flight._last_dispatch["step"] == 5


# ---------------------------------------------------------- eval step


def test_eval_step_matches_the_reference():
    """make_eval_step with the criterion, the network in eval mode: loss and
    logits against the reference's, one program a signature (jit_eval
    retraces equal in both packages), parameters and RNG untouched, and
    outputs that outlive the next call."""
    ref, port = _gpt_pair()
    ref.eval()
    port.eval()
    jcrit, tcrit = JCriterion(), GPTPretrainingCriterion()
    jeval = jmake_eval_step(ref, lambda o, l: jcrit(o, l))
    teval = make_eval_step(port, lambda o, l: tcrit(o, l), device="cpu")
    assert isinstance(teval, EvalStep) and teval.compiles == 0
    params0 = {n: p.detach().clone() for n, p in port.named_parameters()}
    rng0, jkey0 = prandom.get_rng_state()["offset"], np.asarray(JRNG.key)
    seq = [_batches(1, seed=i, t=t)[0] for i, t in enumerate((16, 16, 8))]
    r0 = (jtracing.RETRACES.labels("jit_eval").value,
          tracing.RETRACES.labels("jit_eval").value)
    kept = None
    for x, y in seq:
        jloss, (jlogits,) = jeval([paddle.to_tensor(a) for a in x],
                                  [paddle.to_tensor(a) for a in y])
        tloss, (tlogits,) = teval([torch.from_numpy(a) for a in x],
                                  [torch.from_numpy(a) for a in y])
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits.numpy()),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(tloss), float(jloss.numpy()),
                                   rtol=1e-4, atol=1e-5)
        assert tloss.dtype == torch.float32 and not tloss.requires_grad
        if kept is None:
            kept = (tloss, tloss.clone())
    assert torch.equal(*kept)
    r1 = (jtracing.RETRACES.labels("jit_eval").value,
          tracing.RETRACES.labels("jit_eval").value)
    assert r1[0] - r0[0] == r1[1] - r0[1] == 2
    assert (teval.compiles, teval.replays) == (2, 1)
    assert teval.telemetry.engine == "jit_eval"
    for n, p in port.named_parameters():
        assert torch.equal(p, params0[n]) and p.grad is None, n
    assert prandom.get_rng_state()["offset"] == rng0
    np.testing.assert_array_equal(np.asarray(JRNG.key), jkey0)
    # without a loss: (None, outputs)
    loss, (logits,) = make_eval_step(port, device="cpu")(
        [torch.from_numpy(seq[0][0][0])])
    assert loss is None and logits.shape == (B, T, VOCAB)


def test_eval_step_in_train_mode_draws_as_the_network_does():
    """In train mode the eval step draws the network's dropout masks: the
    reference's key moves, and the port's Philox offset moves by the
    step's draws (one flash-attention draw a layer on the CPU)."""
    ref, port = _gpt_pair(attn_dropout_prob=0.1)
    ref.train()
    port.train()
    jeval = jmake_eval_step(ref)
    teval = make_eval_step(port, device="cpu")
    x = _batches(1)[0][0]
    jkey0 = np.asarray(JRNG.key)
    off0 = prandom.get_rng_state()["offset"]
    jeval([paddle.to_tensor(a) for a in x])
    teval([torch.from_numpy(a) for a in x])
    assert not np.array_equal(np.asarray(JRNG.key), jkey0)
    assert prandom.get_rng_state()["offset"] == off0 + len(port.gpt.layers)


def test_eval_step_program_is_one_per_signature_and_rejects_moved_weights():
    _, port = _gpt_pair()
    port.eval()
    teval = make_eval_step(port, device="cpu")
    x = [torch.from_numpy(_batches(1)[0][0][0])]
    teval(x)
    teval(x)
    assert (teval.compiles, teval.replays) == (1, 1)
    w = port.gpt.ln_f.weight
    w.data = w.data.clone()             # rebound, not copied into
    with pytest.raises(RuntimeError, match="moved"):
        teval(x)


def test_train_step_class_and_flags_are_read_when_made():
    """The guard and nan_at_step are read when the step is made, as the
    reference reads them at trace time."""
    _, port = _gpt_pair()
    opt = optimizer.AdamW(parameters=port.parameters(), learning_rate=LR,
                          device="cpu")
    crit = GPTPretrainingCriterion()
    flags.set_flags({"skip_nonfinite_steps": True})
    _chaos("nan_at_step:7")
    step = make_train_step(port, lambda o, l: crit(o, l), opt, device="cpu")
    flags.set_flags({"skip_nonfinite_steps": False})
    chaos.reset()
    assert isinstance(step, TrainStep)
    assert step.guard and step.nan_step == 7 and step._t is not None
    assert any(t is step._t for t in step._held())
