"""The port's optimizers against the JAX package's, on the CPU.

Each of the reference's rules (paddle_tpu/optimizer: SGD, Momentum with
and without Nesterov, Lars, Adam, AdamW, Adamax, Adagrad, Adadelta,
RMSProp plain and centered, Lamb, Ftrl at lr_power -0.5 and -0.7,
DecayedAdagrad, ProximalGD, ProximalAdagrad, Dpsgd) is run on the same
parameters and gradients, made with numpy, in both packages.

Tolerances:
  * float32 parameters, 3 steps: rtol 1e-6 / atol 1e-7 on parameters and
    accumulators. Most rules come out bit-equal; XLA on the CPU may
    contract a multiply and an add into one FMA, or divide by a square
    root as a multiply by its reciprocal square root, which moves the
    last bit of a float32 result (a few 1e-7 relative), and the norms of
    Lars, Lamb and Dpsgd sum in another order.
  * bfloat16 parameters, one step at a time: each step starts both sides
    from the port's state (parameters in bfloat16, accumulators in the
    dtypes the port keeps them in, which are the dtypes the reference's
    rules return), and the port's parameter must equal the reference's
    result rounded to bfloat16 exactly: SGD, Momentum and Adamax return a
    float32 parameter there (ROADMAP.md section 3), the others a bfloat16
    one. Accumulators: bfloat16 ones exact, float32 ones at rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.framework.tensor import Parameter as JParam
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.incubate.checkpoint import save_checkpoint as jsave
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.incubate.checkpoint import load_checkpoint
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.resilience import chaos
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

RTOL, ATOL = 1e-6, 1e-7
SHAPES = [(4, 5), (7,)]
# (class name, keyword arguments, lr)
RULES = [
    ("SGD", {}, 0.01),
    ("Momentum", {}, 0.01),
    ("Momentum", {"use_nesterov": True}, 0.01),
    ("Lars", {"lars_weight_decay": 0.01}, 0.01),
    ("Adam", {}, 0.01),
    ("AdamW", {}, 0.01),
    ("Adamax", {}, 0.01),
    ("Adagrad", {"initial_accumulator_value": 0.1}, 0.1),
    ("Adadelta", {}, 1.0),
    ("RMSProp", {"momentum": 0.9}, 0.01),
    ("RMSProp", {"centered": True, "momentum": 0.5}, 0.01),
    ("Lamb", {}, 0.01),
    ("Ftrl", {"l1": 0.01, "l2": 0.01}, 0.01),
    ("Ftrl", {"l1": 0.01, "l2": 0.01, "lr_power": -0.7}, 0.01),
    ("DecayedAdagrad", {}, 0.01),
    ("ProximalGD", {"l1": 0.01, "l2": 0.01}, 0.01),
    ("ProximalAdagrad", {"l1": 0.01, "l2": 0.01}, 0.01),
]
RULE_IDS = ["%s%s" % (n, "-" + "-".join("%s=%s" % kv for kv in kw.items())
                      if kw else "") for n, kw, _ in RULES]
# the accumulators' dtypes at a bfloat16 parameter: what the reference's
# rule returns for each (and so what the port keeps)
BF16_ACC_DTYPES = {
    "Momentum": {"velocity": "bfloat16"},
    "Lars": {"velocity": "float32"},
    "Adam": {"moment1": "float32", "moment2": "float32"},
    "AdamW": {"moment1": "float32", "moment2": "float32"},
    "Adamax": {"moment": "bfloat16", "inf_norm": "bfloat16"},
    "Adagrad": {"moment": "float32"},
    "Adadelta": {"avg_squared_grad": "float32",
                 "avg_squared_update": "float32"},
    "RMSProp": {"mean_square": "float32", "mean_grad": "bfloat16",
                "momentum_acc": "float32"},
    "RMSProp-centered": {"mean_square": "float32", "mean_grad": "float32",
                         "momentum_acc": "float32"},
    "Lamb": {"moment1": "float32", "moment2": "float32"},
    "Ftrl": {"squared": "float32", "linear": "float32"},
    "DecayedAdagrad": {"moment": "float32"},
    "ProximalAdagrad": {"moment": "float32"},
}


def _np(a):
    """A float32 numpy copy of a jax array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().copy()
    return np.array(jnp.asarray(a).astype(jnp.float32), copy=True)


def _jdt(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _tdt(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _pair(name, kw, lr, dtype, seed=0):
    rs = np.random.RandomState(seed)
    init = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    jps = [JParam(a) for a in init]
    for p in jps:
        p._data = jnp.asarray(p._data).astype(_jdt(dtype))
    tps = [torch.nn.Parameter(torch.from_numpy(a).to(_tdt(dtype)))
           for a in init]
    jo = getattr(jopt, name)(learning_rate=lr, parameters=jps, **kw)
    to = getattr(topt, name)(learning_rate=lr, parameters=tps,
                             device="cpu", **kw)
    return jps, tps, jo, to, rs


def _set_grads(jps, tps, grads, dtype):
    for p, g in zip(jps, grads):
        p._grad = JTensor(jnp.asarray(g).astype(_jdt(dtype)), _internal=True)
    for p, g in zip(tps, grads):
        p.grad = torch.from_numpy(g).to(_tdt(dtype))


def _grads(rs):
    return [(rs.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]


def _accs(opt, p):
    return opt._get_accumulators(p)


@pytest.mark.parametrize("rule", RULES, ids=RULE_IDS)
def test_rule_float32_trajectory(rule):
    """3 steps at float32: parameters and accumulators within rtol 1e-6 /
    atol 1e-7 after every step."""
    name, kw, lr = rule
    jps, tps, jo, to, rs = _pair(name, kw, lr, "float32")
    for step in range(3):
        _set_grads(jps, tps, _grads(rs), "float32")
        jo.step()
        to.step()
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(_np(tp), _np(jp._data), rtol=RTOL,
                                       atol=ATOL, err_msg="step %d" % step)
            for n, a in _accs(to, tp).items():
                np.testing.assert_allclose(
                    _np(a), _np(jo._accumulators[id(jp)][n]), rtol=RTOL,
                    atol=ATOL, err_msg="%s step %d" % (n, step))
    assert to._step_count == jo._step_count == 3


def _load_port_state(jps, tps, jo, to):
    """The reference's parameters and accumulators <- the port's (same
    dtypes)."""
    for jp, tp in zip(jps, tps):
        jp._data = jnp.asarray(_np(tp)).astype(
            jnp.bfloat16 if tp.dtype == torch.bfloat16 else jnp.float32)
    sd = {}
    for k, v in to.state_dict().items():
        if isinstance(v, torch.Tensor):
            v = jnp.asarray(_np(v)).astype(
                jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        sd[k] = v
    jo.set_state_dict(sd)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("rule", RULES, ids=RULE_IDS)
def test_rule_bfloat16_one_step_at_a_time(rule, seed):
    """bfloat16 parameters, 4 steps, each from the port's state on both
    sides: the port's parameter equals the reference's result rounded to
    bfloat16 exactly; the accumulators keep the dtypes the reference's
    rule returns."""
    name, kw, lr = rule
    jps, tps, jo, to, rs = _pair(name, kw, lr, "bfloat16", seed=seed)
    key = name + ("-centered" if kw.get("centered") else "")
    for step in range(4):
        _load_port_state(jps, tps, jo, to)
        _set_grads(jps, tps, _grads(rs), "bfloat16")
        jo.step()
        to.step()
        for jp, tp in zip(jps, tps):
            assert tp.dtype == torch.bfloat16
            want = jnp.asarray(jp._data).astype(jnp.bfloat16)
            np.testing.assert_array_equal(_np(tp), _np(want),
                                          err_msg="step %d" % step)
            accs = _accs(to, tp)
            assert {n: str(a.dtype).replace("torch.", "")
                    for n, a in accs.items()} == BF16_ACC_DTYPES.get(key, {})
            for n, a in accs.items():
                ja = jo._accumulators[id(jp)][n]
                assert str(ja.dtype) == str(a.dtype).replace("torch.", "")
                tol = (0, 0) if a.dtype == torch.bfloat16 else (RTOL, ATOL)
                np.testing.assert_allclose(_np(a), _np(ja), rtol=tol[0],
                                           atol=tol[1], err_msg=n)


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adamax"])
def test_reference_promotes_a_bfloat16_parameter(name):
    """The reference's fault the port does not copy: one step of SGD,
    Momentum or Adamax on a bfloat16 parameter returns a float32 one
    there (its rule ends without .astype(param.dtype)); the port keeps
    bfloat16, the float32 result rounded once. Momentum's velocity and
    Adamax's moments stay bfloat16 on both sides."""
    jps, tps, jo, to, rs = _pair(name, {}, 0.01, "bfloat16")
    _set_grads(jps, tps, _grads(rs), "bfloat16")
    jo.step()
    to.step()
    for jp, tp in zip(jps, tps):
        assert str(jp._data.dtype) == "float32"
        assert tp.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _np(tp), _np(jnp.asarray(jp._data).astype(jnp.bfloat16)))
        for n, a in _accs(to, tp).items():
            assert str(jo._accumulators[id(jp)][n].dtype) == "bfloat16"
            assert a.dtype == torch.bfloat16


@pytest.mark.parametrize("rule", [r for r in RULES if r[0] in (
    "SGD", "Momentum", "Adamax")], ids=lambda r: r[0] + (
        "-nesterov" if r[1] else ""))
def test_rule_float64_parameter_stays_float64(rule):
    """SGD, Momentum and Adamax compute in the parameter's dtype in the
    reference (:326, :339, :516), so a float64 parameter's update keeps
    float64 there (ResNet-50's float64 parity in test_torch_static.py
    runs Momentum). 3 steps under x64 from float32-representable values:
    the port's parameters and accumulators within rtol 1e-12 of the
    reference's (the port rounded the update to float32 before: 1e-7)."""
    name, kw, lr = rule
    rs = np.random.RandomState(0)
    init = [rs.randn(*s).astype(np.float32).astype(np.float64)
            for s in SHAPES]
    with jax.enable_x64(True):
        jps = [JParam(a) for a in init]
        for p, a in zip(jps, init):
            p._data = jnp.asarray(a, dtype=jnp.float64)
        tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
        jo = getattr(jopt, name)(learning_rate=lr, parameters=jps, **kw)
        to = getattr(topt, name)(learning_rate=lr, parameters=tps,
                                 device="cpu", **kw)
        for step in range(3):
            grads = [rs.randn(*s) * 0.1 for s in SHAPES]
            for p, g in zip(jps, grads):
                p._grad = JTensor(jnp.asarray(g, dtype=jnp.float64),
                                  _internal=True)
            for p, g in zip(tps, grads):
                p.grad = torch.from_numpy(g.copy())
            jo.step()
            to.step()
            for jp, tp in zip(jps, tps):
                assert tp.dtype == torch.float64
                assert str(jp._data.dtype) == "float64"
                np.testing.assert_allclose(
                    tp.detach().numpy(), np.asarray(jp._data), rtol=1e-12,
                    atol=0, err_msg="step %d" % step)
                for n, a in _accs(to, tp).items():
                    np.testing.assert_allclose(
                        a.numpy(), np.asarray(jo._accumulators[id(jp)][n]),
                        rtol=1e-12, atol=0, err_msg="%s step %d" % (n, step))


# ---------------------------------------------------------------------------
# the base: minimize, aliases, per-parameter lr, lr_ratio, state dicts


def _quadratic(lib, w, target):
    if lib == "jax":
        return paddle.sum((w - paddle.to_tensor(target)) ** 2)
    return ((w - torch.from_numpy(target)) ** 2).sum()


def test_minimize_clear_gradients_and_set_dict():
    """minimize(loss) is backward then step (reference :221-236), as the
    reference's; clear_gradients and set_dict are clear_grad's and
    set_state_dict's aliases."""
    target = np.array([1.0, -2.0, 3.0], np.float32)
    jw = paddle.framework.Parameter(np.zeros(3, np.float32))
    tw = torch.nn.Parameter(torch.zeros(3))
    jo = jopt.Momentum(learning_rate=0.1, parameters=[jw])
    to = topt.Momentum(learning_rate=0.1, parameters=[tw], device="cpu")
    for _ in range(3):
        assert jo.minimize(_quadratic("jax", jw, target)) == (None, None)
        assert to.minimize(_quadratic("torch", tw, target)) == (None, None)
        jo.clear_gradients()
        to.clear_gradients()
        assert tw.grad is None or not tw.grad.any()
    np.testing.assert_allclose(_np(tw), np.asarray(jw.numpy()), rtol=RTOL,
                               atol=ATOL)
    assert topt.Optimizer.clear_gradients is topt.Optimizer.clear_grad
    assert topt.Optimizer.set_dict is topt.Optimizer.set_state_dict
    other = torch.nn.Parameter(torch.zeros(3))
    o2 = topt.Momentum(learning_rate=0.1, parameters=[other], device="cpu")
    o2.set_dict(to.state_dict())
    assert torch.equal(o2._get_accumulators(other)["velocity"],
                       to._get_accumulators(tw)["velocity"])
    assert o2._step_count == 3


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "Lamb"])
def test_per_parameter_learning_rate(name):
    """optimize_attr["learning_rate"] scales lr for its parameter (0.5
    here, a power of two: the reference's eager host product and the
    port's float32 product on the device agree)."""
    jps, tps, jo, to, rs = _pair(name, {}, 0.01, "float32")
    for p in jps[:1] + tps[:1]:
        p.optimize_attr = {"learning_rate": 0.5}
    for _ in range(2):
        _set_grads(jps, tps, _grads(rs), "float32")
        jo.step()
        to.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(_np(tp), _np(jp._data), rtol=RTOL,
                                   atol=ATOL)
    # the scaled parameter moved less than it would have
    plain = _pair(name, {}, 0.01, "float32")
    _, tps2, _, to2, rs2 = plain
    for _ in range(2):
        for p, g in zip(tps2, _grads(rs2)):
            p.grad = torch.from_numpy(g)
        to2.step()
    assert not torch.equal(tps2[0], tps[0]) and torch.equal(tps2[1], tps[1])


def test_adamw_lr_ratio_is_taken_and_ignored():
    """The reference accepts AdamW(lr_ratio=...) and ignores it
    (:469-474); so does the port."""
    rs = np.random.RandomState(3)
    init = rs.randn(6).astype(np.float32)
    runs = []
    for ratio in (None, lambda p: 0.5):
        w = torch.nn.Parameter(torch.from_numpy(init.copy()))
        o = topt.AdamW(learning_rate=0.01, parameters=[w], lr_ratio=ratio,
                       device="cpu")
        w.grad = torch.ones(6)
        o.step()
        runs.append(w.detach().clone())
    assert torch.equal(runs[0], runs[1])
    jw = JParam(init.copy())
    jo = jopt.AdamW(learning_rate=0.01, parameters=[jw],
                    lr_ratio=lambda p: 0.5)
    jw._grad = JTensor(jnp.ones(6), _internal=True)
    jo.step()
    np.testing.assert_allclose(_np(runs[1]), _np(jw._data), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["Momentum", "Lamb", "Adamax", "RMSProp",
                                  "Ftrl"])
@pytest.mark.parametrize("way", ["reference_to_port", "port_to_reference"])
def test_state_dicts_cross_load(name, way):
    """2 steps on one side, its state dict (and parameters) loaded into
    the other, then one more step on both: equal, as if one side had run
    all 3 (the keys @acc_{i}_{name} and @step_count are shared)."""
    kw = {"momentum": 0.9} if name == "RMSProp" else {}
    lr = 0.01
    jps, tps, jo, to, rs = _pair(name, kw, lr, "float32")
    grads = [_grads(rs) for _ in range(3)]
    src_is_ref = way == "reference_to_port"
    for g in grads[:2]:
        _set_grads(jps, tps, g, "float32")
        (jo if src_is_ref else to).step()
    if src_is_ref:
        for jp, tp in zip(jps, tps):
            with torch.no_grad():
                tp.copy_(torch.from_numpy(_np(jp._data)))
        to.set_state_dict({k: (np.asarray(v.numpy())
                               if isinstance(v, JTensor) else v)
                           for k, v in jo.state_dict().items()})
    else:
        _load_port_state(jps, tps, jo, to)
    assert jo._step_count == to._step_count == 2
    _set_grads(jps, tps, grads[2], "float32")
    jo.step()
    to.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(_np(tp), _np(jp._data), rtol=RTOL,
                                   atol=ATOL)
        for n, a in _accs(to, tp).items():
            np.testing.assert_allclose(_np(a),
                                       _np(jo._accumulators[id(jp)][n]),
                                       rtol=RTOL, atol=ATOL, err_msg=n)


# ---------------------------------------------------------------------------
# inside the train step


VOCAB, B, T = 128, 2, 16
NO_DROPOUT = dict(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)


def _gpt_pair():
    paddle.seed(0)
    ref = jgpt_tiny(**NO_DROPOUT)
    port = tgpt_tiny(device="cpu", seed=1, **NO_DROPOUT)
    load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (n, B, T + 1)).astype(np.int64)
    return [(x[:, :-1], x[:, 1:]) for x in ids]


def _no_decay(model):
    """Lamb's exclude_from_weight_decay_fn for `model`'s parameters:
    LayerNorm weights and biases, by the module path (the reference's
    parameters are named tensor_N, so the function tests identity)."""
    ids = {id(p) for n, p in model.named_parameters()
           if ".ln_" in n or "norm" in n or n.endswith(".bias")}
    return lambda p: id(p) in ids


def _make_steps(ref, port, name, **kw):
    jcrit, tcrit = JCriterion(), GPTPretrainingCriterion()
    jkw, tkw = dict(kw), dict(kw)
    if "clip_norm" in kw:               # a global-norm clip on each side
        norm = jkw.pop("clip_norm")
        tkw.pop("clip_norm")
        jkw["grad_clip"] = jopt.ClipGradByGlobalNorm(norm)
        tkw["grad_clip"] = topt.ClipGradByGlobalNorm(norm)
    if kw.get("exclude_from_weight_decay_fn") is _no_decay:
        jkw["exclude_from_weight_decay_fn"] = _no_decay(ref)
        tkw["exclude_from_weight_decay_fn"] = _no_decay(port)
    jo = getattr(jopt, name)(learning_rate=1e-3, parameters=ref.parameters(),
                             **jkw)
    to = getattr(topt, name)(learning_rate=1e-3,
                             parameters=port.parameters(), device="cpu",
                             **tkw)
    jstep = jmake_train_step(ref, lambda o, l: jcrit(o, l), jo)
    tstep = make_train_step(port, lambda o, l: tcrit(o, l), to,
                            device="cpu")
    return jstep, jo, tstep, to


def _run(jstep, tstep, x, y):
    jl, _ = jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
    tl, _ = tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
    return float(np.asarray(jl.numpy())), float(tl.detach())


@pytest.mark.parametrize("name,kw", [
    ("Momentum", {"momentum": 0.9}),
    ("Lamb", {"lamb_weight_decay": 0.01,
              "exclude_from_weight_decay_fn": _no_decay}),
    ("Momentum", {"momentum": 0.9, "clip_norm": 0.05})],
    ids=["Momentum", "Lamb", "Momentum-clip"])
def test_captured_step_matches_the_reference(name, kw):
    """make_train_step with Momentum, with Lamb (LayerNorm and biases
    excluded from the decay), and with Momentum under
    ClipGradByGlobalNorm(0.05) (a rule without the clip's scale word: the
    composed float32 product, which clips at these gradients) on
    gpt_tiny, float32, 3 steps, one parameter at optimize_attr learning
    rate 0.3 (the compiled reference's float32 lr * 0.3): losses at rtol
    1e-5, parameters and accumulators at atol 1e-5 (float32 through two
    layers in another summation order)."""
    ref, port = _gpt_pair()
    jname, jp = next(iter(ref.named_parameters()))
    tname, tp = next(iter(port.named_parameters()))
    jp.optimize_attr = {"learning_rate": 0.3}
    tp.optimize_attr = {"learning_rate": 0.3}
    jstep, jo, tstep, to = _make_steps(ref, port, name, **kw)
    for x, y in _batches(3, seed=4):
        jl, tl = _run(jstep, tstep, x, y)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tstep.compiles == 1 and to._step_count == 3
    jparams = dict(ref.named_parameters())
    for n, p in port.named_parameters():
        np.testing.assert_allclose(_np(p), _np(jparams[n]._data), atol=1e-5,
                                   err_msg=n)
        for an, a in _accs(to, p).items():
            np.testing.assert_allclose(
                _np(a), _np(jo._accumulators[id(jparams[n])][an]),
                atol=1e-5, err_msg="%s %s" % (n, an))


@pytest.mark.parametrize("name", ["Momentum", "RMSProp", "Lamb", "Adagrad"])
def test_guard_gates_a_non_adam_rule(name):
    """skip_nonfinite_steps with nan_at_step:2, 3 steps: step 2 is skipped
    on both sides, the port's parameters and accumulators after it
    bit-equal to their values after step 1 (the rule's guard word), and
    the step count advances through the skip, as the reference's
    compiled guard does."""
    flags.set_flags({"skip_nonfinite_steps": True})
    jset_flags({"FLAGS_skip_nonfinite_steps": True})
    for mod in (chaos, jchaos):
        mod.reset()
        mod.configure("nan_at_step:2")
    try:
        ref, port = _gpt_pair()
        kw = {"momentum": 0.9} if name == "RMSProp" else {}
        jstep, jo, tstep, to = _make_steps(ref, port, name, **kw)
        states, skips = [], []
        for x, y in _batches(3, seed=5):
            _run(jstep, tstep, x, y)
            skips.append((jstep.last_step_skipped, tstep.last_step_skipped))
            states.append([_np(t) for p in port.parameters()
                           for t in [p] + list(_accs(to, p).values())])
    finally:
        flags.set_flags({"skip_nonfinite_steps": False})
        jset_flags({"FLAGS_skip_nonfinite_steps": False})
        for mod in (chaos, jchaos):
            mod.reset()
    assert skips == [(False, False), (True, True), (False, False)]
    assert tstep.skipped_steps == jstep.skipped_steps == 1
    assert to._step_count == jo._step_count == 3
    for a, b in zip(states[1], states[0]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b)
               for a, b in zip(states[2], states[1]))
    jparams = dict(ref.named_parameters())
    for n, p in port.named_parameters():
        np.testing.assert_allclose(_np(p), _np(jparams[n]._data), atol=1e-5,
                                   err_msg=n)


def test_dpsgd_noise_stream_and_captured_refusal():
    """Dpsgd draws the reference's host noise stream (numpy's
    RandomState(seed), one draw a parameter in order): 3 eager steps
    equal the reference's within rtol 1e-6 (the clip norm sums in another
    order), and the draws equal a fresh RandomState(seed)'s. make_train_step
    refuses it with the reference's words, as the reference's does."""
    kw = dict(clip=0.05, batch_size=4.0, sigma=0.5, seed=5)
    jps, tps, jo, to, rs = _pair("Dpsgd", kw, 0.01, "float32")
    for _ in range(3):
        _set_grads(jps, tps, _grads(rs), "float32")
        jo.step()
        to.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(_np(tp), _np(jp._data), rtol=RTOL,
                                   atol=ATOL)
    fresh = np.random.RandomState(5)
    [fresh.normal(0.0, 0.5) for _ in range(6)]
    assert to._noise_rng.normal(0.0, 0.5) == jo._noise_rng.normal(
        0.0, 0.5) == fresh.normal(0.0, 0.5)
    ref, port = _gpt_pair()
    jstep, _, tstep, _ = _make_steps(ref, port, "Dpsgd")
    x, y = _batches(1)[0]
    with pytest.raises(NotImplementedError, match="dygraph-only") as te:
        tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
    with pytest.raises(NotImplementedError, match="dygraph-only") as je:
        jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", ["Momentum", "Lamb"])
def test_reference_store_loads_into_a_built_captured_step(name, tmp_path):
    """A store the reference wrote after 2 compiled steps at O2 bfloat16
    (Momentum: a bfloat16 velocity, which the reference's promotion has
    made float32 by its second step, with the parameters; Lamb: float32
    moments) loads into the port's built step (decorate O2 bfloat16): one
    program still, each accumulator equal to the store's value in the
    port's dtype, the parameters the store's values rounded to bfloat16,
    the step count 2; the next step replays."""
    paddle.seed(0)
    ref = jgpt_tiny(**NO_DROPOUT)
    jo = getattr(jopt, name)(learning_rate=1e-3, parameters=ref.parameters())
    ref, jo = jamp.decorate(ref, jo, level="O2", dtype="bfloat16")
    jcrit = JCriterion()
    jstep = jmake_train_step(ref, lambda o, l: jcrit(o, l), jo)
    batches = _batches(4, seed=6)
    for x, y in batches[:2]:
        jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
    path = str(tmp_path / "ck")
    jsave(path, ref, jo)

    port = tgpt_tiny(device="cpu", seed=2, **NO_DROPOUT)
    to = getattr(topt, name)(learning_rate=1e-3,
                             parameters=port.parameters(), device="cpu")
    port, to = amp.decorate(port, to, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion()
    step = make_train_step(port, lambda o, l: crit(o, l), to, device="cpu")
    x, y = batches[2]
    step([torch.from_numpy(x)], [torch.from_numpy(y)])      # built, run
    load_checkpoint(path, port, to)
    assert to._step_count == 2
    jparams = dict(ref.named_parameters())
    for n, p in port.named_parameters():
        want = jnp.asarray(jparams[n]._data).astype(jnp.bfloat16)
        np.testing.assert_array_equal(_np(p), _np(want), err_msg=n)
        for an, a in _accs(to, p).items():
            ja = jnp.asarray(jo._accumulators[id(jparams[n])][an]).astype(
                jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
            np.testing.assert_array_equal(_np(a), _np(ja), err_msg=an)
    x, y = batches[3]
    loss, _ = step([torch.from_numpy(x)], [torch.from_numpy(y)])
    assert step.compiles == 1 and step.replays == 1
    assert np.isfinite(float(loss)) and to._step_count == 3
