"""The port's high-level API (hapi Model, callbacks, AnomalyGuard, flops and
summary) against the JAX package's, on the CPU.

The same seeded weights (carried by models/convert.py) and the same
numpy batches go through `paddle_tpu.Model` and `paddle_tpu_torch.Model`:
  * `fit` on a tiny GPT (2 layers, hidden 64, T=16, dropouts 0) and on
    LeNet (2 epochs each), and on ResNet-18 (B=2, 64x64, 3 steps), with `prepare(jit=True)` on both sides
    (the reference's compiled step, the port's programmed step), and on
    the GPT and LeNet with `jit=False` on both sides (the eager loops):
    the per-step losses (tests/test_torch_hapi_fit.py, over this file's
    setups);
  * a recording callback sees the same hooks in the same order with the
    same log keys; `EarlyStopping` stops at the same epoch; the
    `LRScheduler` callback gives the same lr after every step, by step and
    by epoch;
  * `evaluate` and `predict` after a fit; `Model.save` of each package
    loaded by the other's `Model.load`, then one more step each;
  * the in-process preemption drill (`sigterm_at_step:2`,
    `exit_on_preempt=False`, as tests/test_resilience.py:268), with
    dropout on and 2 DataLoader worker processes: the resumed losses and
    parameters bit-equal to an uninterrupted port fit without workers;
  * AnomalyGuard's streak and its GradScaler coupling, as
    tests/test_resilience.py:363, with both packages' real GradScalers;
    fit under FLAGS_skip_nonfinite_steps with `nan_at_step:2`;
  * `telemetry_dir`: the reference's files and journal event names;
    `telemetry_http`: the live plane's `train_loop` block;
  * `flops` and `summary`: the reference's numbers.

Tolerances: losses, evaluate's loss and predict's outputs at rtol 1e-4 /
atol 1e-5, tests/test_torch_train.py's (float32 through the same layers,
summed in other orders). ResNet-18 runs tests/test_torch_resnet.py's
three batches at its float32 tolerance, 2e-4 of the largest loss
(measured: 5.8e-6); on other random batches of this size its third
step's loss has differed by 2.0e-4 (the batch norms amplify rounding
step by step, as that file's docstring sets out). The lr trajectories,
accuracies, hook sequences, epochs, counts and the drill are exact.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu.resilience.anomaly import AnomalyGuard as JAnomalyGuard
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu.vision.models import resnet18 as jresnet18
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.checkpoint import store
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.resilience import (AnomalyGuard, NonFiniteLossError,
                                         chaos)
from paddle_tpu_torch.vision.models import LeNet, resnet18
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

RTOL, ATOL = 1e-4, 1e-5
RESNET_TOL = 2e-4
VOCAB, T = 128, 16
NO_DROPOUT = dict(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


# ------------------------------------------------------------ the setups


def _gpt_data(n=6, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (n, T + 1)).astype(np.int64)
    return [(x[:-1], x[1:]) for x in ids]


def _image_data(n, shape, classes, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(*shape).astype(np.float32),
             np.array([rs.randint(0, classes)], np.int64)) for _ in range(n)]


def _gpt(jit, **kw):
    paddle.seed(0)
    cfg = dict(NO_DROPOUT, **kw)
    ref = jgpt_tiny(**cfg)
    port = tgpt_tiny(device="cpu", seed=1, **cfg)
    load_reference_state(port, _state(ref))
    jcrit, tcrit = JCriterion(), GPTPretrainingCriterion()
    jm = paddle.Model(ref)
    jm.prepare(paddle.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                      parameters=ref.parameters()),
               lambda o, y: jcrit(o, y), jit=jit)
    tm = pt.Model(port, device="cpu")
    tm.prepare(optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                               parameters=port.parameters(), device="cpu"),
               lambda o, y: tcrit(o, y), jit=jit)
    return jm, tm, _gpt_data(), 2


def _lenet(jit, lr=1e-3, metrics=False, sched=None):
    paddle.seed(0)
    ref = JLeNet()
    port = LeNet(device="cpu", seed=1)
    load_reference_state(port, _state(ref))
    jlr = paddle.optimizer.lr.StepDecay(lr, step_size=2, gamma=0.5) \
        if sched else lr
    tlr = optimizer.lr.StepDecay(lr, step_size=2, gamma=0.5) \
        if sched else lr
    jm = paddle.Model(ref)
    jm.prepare(paddle.optimizer.Adam(learning_rate=jlr,
                                     parameters=ref.parameters()),
               paddle.nn.CrossEntropyLoss(),
               metrics=paddle.metric.Accuracy() if metrics else None,
               jit=jit)
    tm = pt.Model(port, device="cpu")
    tm.prepare(optimizer.Adam(learning_rate=tlr, parameters=port.parameters(),
                              device="cpu"), CrossEntropyLoss(),
               metrics=pt.metric.Accuracy() if metrics else None, jit=jit)
    return jm, tm, _image_data(12, (1, 28, 28), 10), 4


def _resnet18(jit):
    paddle.seed(0)
    ref = jresnet18(num_classes=10)
    port = resnet18(num_classes=10, device="cpu", seed=1)
    load_reference_state(port, _state(ref))
    jm = paddle.Model(ref)
    jm.prepare(paddle.optimizer.Momentum(learning_rate=1e-3, momentum=0.9,
                                         parameters=ref.parameters()),
               paddle.nn.CrossEntropyLoss(), jit=jit)
    tm = pt.Model(port, device="cpu")
    tm.prepare(optimizer.Momentum(learning_rate=1e-3, momentum=0.9,
                                  parameters=port.parameters(),
                                  device="cpu"), CrossEntropyLoss(), jit=jit)
    # test_torch_resnet.py's three batches (B=2), as samples
    rs = np.random.RandomState(0)
    data = []
    for _ in range(3):
        x = rs.rand(2, 3, 64, 64).astype(np.float32)
        y = rs.randint(0, 10, (2, 1)).astype(np.int64)
        data += list(zip(x, y))
    return jm, tm, data, 2


SETUPS = {"gpt": _gpt, "lenet": _lenet, "resnet18": _resnet18}


class _Losses:
    """A callback class of either package recording each step's loss."""

    @staticmethod
    def of(Callback):
        class Losses(Callback):
            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(logs["loss"])
        return Losses()


def _fit_both(jm, tm, data, bs, jcallbacks=(), tcallbacks=(), **kw):
    jrec = _Losses.of(paddle.callbacks.Callback)
    trec = _Losses.of(pt.callbacks.Callback)
    jm.fit(data, batch_size=bs, shuffle=False, verbose=0,
           callbacks=[jrec] + list(jcallbacks), **kw)
    tm.fit(data, batch_size=bs, shuffle=False, verbose=0,
           callbacks=[trec] + list(tcallbacks), **kw)
    return np.array(jrec.losses), np.array(trec.losses)


# ------------------------------------------------------------ callbacks


def _hook_recorder(Callback):
    class Hooks(Callback):
        """Every hook called, with the sorted keys of its logs."""

        def __init__(self):
            super().__init__()
            self.seen = []

    def hook(name):
        def fn(self, *args, **kw):
            logs = kw.get("logs", args[-1] if args and isinstance(
                args[-1], dict) else None)
            self.seen.append((name, tuple(sorted(logs or {}))))
        return fn
    for name in dir(Callback):
        if name.startswith("on_"):
            setattr(Hooks, name, hook(name))
    return Hooks()


def test_callbacks_see_the_same_hooks_and_keys(tmp_path):
    jm, tm, data, bs = _lenet(True, metrics=True)
    jh, th = (_hook_recorder(paddle.callbacks.Callback),
              _hook_recorder(pt.callbacks.Callback))
    for m, h, d in ((jm, jh, "ref"), (tm, th, "port")):
        m.fit(data, eval_data=data[:8], batch_size=bs, epochs=2,
              shuffle=False, verbose=0, callbacks=[h],
              save_dir=str(tmp_path / d))
    assert th.seen == jh.seen
    assert ("on_eval_end", ("acc", "loss")) in th.seen
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))


def test_early_stopping_stops_at_the_same_epoch():
    jm, tm, data, bs = _lenet(True, lr=0.05)
    jes = paddle.callbacks.EarlyStopping(monitor="loss", patience=1)
    tes = pt.callbacks.EarlyStopping(monitor="loss", patience=1)
    want, got = _fit_both(jm, tm, data, bs, epochs=8, eval_data=data[:4],
                          jcallbacks=[jes], tcallbacks=[tes])
    # the same number of steps: the same epoch stopped the fit
    assert len(got) == len(want) < 8 * len(data) // bs
    assert tm.stop_training and jm.stop_training and tes.wait == jes.wait
    assert tes.best == pytest.approx(jes.best, rel=RTOL)


def _lr_recorder(Callback, opt):
    class Lr(Callback):
        def __init__(self):
            super().__init__()
            self.lrs = []

        def on_train_batch_end(self, step, logs=None):
            self.lrs.append(opt.get_lr())
    return Lr()


@pytest.mark.parametrize("by_step", [True, False])
def test_lr_scheduler_callback_trajectory(by_step):
    jm, tm, data, bs = _lenet(True, sched=True)
    jlr = _lr_recorder(paddle.callbacks.Callback, jm._optimizer)
    tlr = _lr_recorder(pt.callbacks.Callback, tm._optimizer)
    kw = dict(by_step=by_step, by_epoch=not by_step)
    want, got = _fit_both(
        jm, tm, data, bs, epochs=3,
        jcallbacks=[paddle.callbacks.LRScheduler(**kw), jlr],
        tcallbacks=[pt.callbacks.LRScheduler(**kw), tlr])
    assert tlr.lrs == jlr.lrs and len(set(tlr.lrs)) > 1
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ evaluate, predict, save/load


def test_evaluate_and_predict_match():
    jm, tm, data, bs = _lenet(True, metrics=True)
    _fit_both(jm, tm, data, bs, epochs=1)
    want, got = jm.evaluate(data, batch_size=bs, verbose=0), tm.evaluate(
        data, batch_size=bs, verbose=0)
    assert sorted(got) == sorted(want) and got["acc"] == want["acc"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL,
                               atol=ATOL)
    images = [x for x, _ in data]
    jp = jm.predict(images, batch_size=bs, stack_outputs=True, verbose=0)
    tp = tm.predict(images, batch_size=bs, stack_outputs=True, verbose=0)
    assert len(tp) == len(jp) == 1 and tp[0].dtype == np.float32
    np.testing.assert_allclose(tp[0], np.asarray(jp[0]), rtol=RTOL,
                               atol=ATOL)
    jb = jm.predict_batch([images[0][None]])
    tb = tm.predict_batch([images[0][None]])
    np.testing.assert_allclose(tb[0], np.asarray(jb[0]), rtol=RTOL,
                               atol=ATOL)


def test_predict_of_a_bfloat16_output_is_float32():
    lin = Linear(4, 3)
    m = pt.Model(amp.decorate(lin, level="O2", dtype="bfloat16"),
                 device="cpu")
    x = torch.ones(2, 4, dtype=torch.bfloat16)
    out = m.predict_batch([x])
    assert out[0].dtype == np.float32
    np.testing.assert_array_equal(out[0], lin(x).float().detach().numpy())


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_model_save_loads_in_the_other_package(tmp_path, direction):
    jm, tm, data, bs = _lenet(True)
    _fit_both(jm, tm, data[:8], bs, epochs=1)
    path = str(tmp_path / "ckpt")
    src, dst = (jm, tm) if direction == "ref_to_port" else (tm, jm)
    src.save(path)
    # the destination is the other package's fresh model
    jm2, tm2, _, _ = _lenet(True)
    dst2 = tm2 if dst is tm else jm2
    dst2.load(path)
    src_eval = src.evaluate(data, batch_size=bs, verbose=0)
    dst_eval = dst2.evaluate(data, batch_size=bs, verbose=0)
    np.testing.assert_allclose(dst_eval["loss"], src_eval["loss"],
                               rtol=RTOL, atol=ATOL)
    # the optimizer's moments and step count crossed too: one more step
    x = np.stack([d[0] for d in data[8:12]])
    y = np.stack([d[1] for d in data[8:12]])
    src_loss = src.train_batch([x], [y])["loss"]
    dst_loss = dst2.train_batch([x], [y])["loss"]
    np.testing.assert_allclose(dst_loss, src_loss, rtol=RTOL, atol=ATOL)
    assert dst2._optimizer._step_count == src._optimizer._step_count == 3


# ------------------------------------------------------------ preemption


def _dropout_gpt(seed=3):
    prandom.seed(11)
    port = tgpt_tiny(device="cpu", seed=seed)   # dropouts 0.1
    crit = GPTPretrainingCriterion()
    m = pt.Model(port, device="cpu")
    m.prepare(optimizer.AdamW(learning_rate=1e-3, parameters=port.parameters(),
                              device="cpu"), lambda o, y: crit(o, y))
    return m


def test_fit_in_process_preempt_and_resume(tmp_path):
    data = _gpt_data(8)
    full = _dropout_gpt()
    rec = _Losses.of(pt.callbacks.Callback)
    full.fit(data, batch_size=2, epochs=2, shuffle=False, verbose=0,
             callbacks=[rec])
    d = str(tmp_path / "auto")
    m = _dropout_gpt()
    first = _Losses.of(pt.callbacks.Callback)
    chaos.configure("sigterm_at_step:2")
    try:
        # worker processes here, none in the uninterrupted run: the same
        # batches in the same order
        m.fit(data, batch_size=2, epochs=2, shuffle=False, verbose=0,
              auto_checkpoint_dir=d, exit_on_preempt=False,
              callbacks=[first], num_workers=2)
    finally:
        chaos.reset()
    assert m.preempted and len(first.losses) == 3
    assert store.is_complete(os.path.join(d, "preempt_ckpt"))
    # a relaunch: a fresh model and optimizer from other seeds, resumed
    m2 = _dropout_gpt(seed=4)
    prandom.seed(99)
    rest = _Losses.of(pt.callbacks.Callback)
    m2.fit(data, batch_size=2, epochs=2, shuffle=False, verbose=0,
           auto_checkpoint_dir=d, exit_on_preempt=False, callbacks=[rest],
           num_workers=2)
    assert not m2.preempted
    assert not os.path.exists(os.path.join(d, "preempt_ckpt"))
    assert first.losses + rest.losses == rec.losses
    for a, b in zip(m2.network.parameters(), full.network.parameters()):
        assert torch.equal(a, b)
    assert m2._optimizer._step_count == full._optimizer._step_count == 8


# ------------------------------------------------------------ anomaly guard


@pytest.fixture
def guard_off_after():
    yield
    flags.set_flags({"skip_nonfinite_steps": False})
    jset_flags({"FLAGS_skip_nonfinite_steps": False})
    chaos.reset()
    jchaos.reset()


def test_anomaly_guard_streak_and_grad_scaler(guard_off_after):
    scales = []
    for Guard, Scaler in ((JAnomalyGuard, paddle.amp.GradScaler),
                          (AnomalyGuard, amp.GradScaler)):
        sc = Scaler(init_loss_scaling=1024.0)
        g = Guard(max_consecutive=3, scaler=sc)
        assert not g.observe(1.0)
        assert g.observe(float("nan"))
        assert g.observe(2.0, skipped=True)   # the step's flag wins
        assert not g.observe(0.5)             # the streak resets
        g.observe(float("inf"))
        g.observe(float("nan"))
        with pytest.raises(Exception) as e:
            g.observe(float("nan"))
        assert type(e.value).__name__ == "NonFiniteLossError"
        assert g.total_skipped == 5 and g.total_steps == 7
        scales.append(sc.get_init_loss_scaling())
    assert scales[1] == scales[0] == 1024.0 / 2 ** 5
    with pytest.raises(NonFiniteLossError):
        AnomalyGuard(max_consecutive=1).observe(float("nan"))


def _skips():
    m = REGISTRY.get("pt_nonfinite_steps_total")
    return m.value if m is not None else 0.0


@pytest.mark.parametrize("jit", [True, False])
def test_fit_skips_a_nan_step_under_the_flag(guard_off_after, jit):
    flags.set_flags({"skip_nonfinite_steps": True})
    jset_flags({"FLAGS_skip_nonfinite_steps": True})
    jm, tm, data, bs = _lenet(jit)
    data = data[:8]
    if jit:
        for mod in (chaos, jchaos):
            mod.configure("nan_at_step:2")
    else:                       # the eager loop: a NaN in the input
        x, y = data[bs]
        data = data[:bs] + [(x * np.nan, y)] + data[bs + 1:]
    jskip, tskip = [], []

    def skip_recorder(Callback, model, out):
        class Skip(Callback):
            def on_train_batch_end(self, step, logs=None):
                out.append(model.last_step_skipped)
        return Skip()
    before = _skips()
    want, got = _fit_both(
        jm, tm, data, bs, epochs=1,
        jcallbacks=[skip_recorder(paddle.callbacks.Callback, jm, jskip)],
        tcallbacks=[skip_recorder(pt.callbacks.Callback, tm, tskip)])
    assert tskip == jskip == [False, True]
    assert _skips() - before == 1
    assert np.isfinite(got[0]) and not np.isfinite(got[1])


# ------------------------------------------------------------ telemetry, flops


def _journal_events(d):
    with open(os.path.join(d, "journal-rank0.jsonl")) as f:
        return [json.loads(line)["event"] for line in f if line.strip()]


def test_telemetry_dir_holds_the_reference_files_and_events(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    jm, tm, data, bs = _lenet(True, metrics=True)
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    for m, d in ((jm, jd), (tm, td)):
        m.fit(data, batch_size=bs, epochs=1, shuffle=False, verbose=0,
              eval_data=data[:4], telemetry_dir=d)
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    tev, jev = _journal_events(td), _journal_events(jd)
    assert tev[0] == jev[0] == "run_start" and tev[-1] == jev[-1] == \
        "run_end"
    assert set(tev) == set(jev)
    assert tev.count("step") == jev.count("step") == len(data) // bs
    snap = json.load(open(os.path.join(td, "metrics.json")))
    assert snap["metrics"]["pt_train_steps_total"]["series"][0]["value"] \
        >= len(data) // bs


def test_telemetry_http_serves_the_train_loop(tmp_path, monkeypatch):
    """fit(telemetry_http=0) starts the live plane (a free port) with the
    reference's `train_loop` status block; the plane outlives fit."""
    import urllib.request
    from paddle_tpu_torch.observability import httpd
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    httpd.shutdown()
    _, tm, data, bs = _lenet(True)
    try:
        tm.fit(data[:8], batch_size=bs, epochs=1, shuffle=False, verbose=0,
               telemetry_dir=str(tmp_path), telemetry_http=0)
        srv = httpd.active_server()
        assert srv is not None
        with urllib.request.urlopen(srv.url + "/statusz", timeout=10) as r:
            st = json.loads(r.read().decode())
        assert st["train_loop"] == {"epochs": 1, "epoch": 0, "step": 2,
                                    "active": False}
        assert os.path.exists(httpd.endpoint_path(str(tmp_path), 0))
    finally:
        httpd.unregister_status("train_loop")
        httpd.shutdown()


@pytest.mark.parametrize("name,size", [("lenet", [2, 1, 28, 28]),
                                       ("resnet18", [1, 3, 64, 64])])
def test_flops_and_summary(name, size, capsys):
    paddle.seed(0)
    ref = JLeNet() if name == "lenet" else jresnet18(num_classes=10)
    port = LeNet(device="cpu") if name == "lenet" else resnet18(
        num_classes=10, device="cpu")
    assert pt.flops(port, size) == paddle.flops(ref, size)
    assert pt.summary(port) == paddle.summary(ref)
    assert pt.Model(port, device="cpu").summary() == paddle.summary(ref)
    capsys.readouterr()


def test_model_without_cuda_raises_unless_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.Model(Linear(2, 2))
    assert pt.Model(Linear(2, 2), device="cpu")._device.type == "cpu"
