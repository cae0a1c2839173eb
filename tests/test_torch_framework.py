"""The port's framework core and top-level namespace against the JAX
package, on the CPU: `to_tensor` and the Tensor's methods, `Parameter`,
`no_grad`, the places and `set_device`, the default dtype, the RNG state,
the flags, `paddle.device`, and the names `bench.py` and
`benchmarks/train_bench.py` call, with only the import changed.

Every test runs under `restore_framework_state`, which puts the place, the
default dtype, the flags and the RNG state of both packages back after
it: a test that leaked such state into its xdist worker is what broke the
serving tests twice.

Differences from the reference by design, each shown here: the default
place is the card with no CPU fallback; `shape` is a `torch.Size`;
`dtype` is a torch dtype; a bfloat16 tensor's `numpy()` is float32;
models built after one `paddle.seed` draw the same weights.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import place as jplace

import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework import dtype as pdtype
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.framework import random as prandom
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def restore_framework_state():
    saved = (pplace._current_place, pdtype._default_dtype,
             pflags.all_flags(), prandom.get_rng_state(),
             jplace._current_place, jpaddle.get_default_dtype(),
             dict(jflags._FLAGS))
    yield
    (pplace._current_place, pdtype._default_dtype, pf, rng,
     jplace._current_place, jd, jf) = saved
    pflags._FLAGS.update(pf)
    prandom.set_rng_state(rng)
    jpaddle.set_default_dtype(jd)
    jflags._FLAGS.update(jf)


def _name(dt):
    return pdtype.dtype_name(dt)


# ------------------------------------------------------------- to_tensor
INPUTS = [
    ("python floats", [1.5, -2.0, 3.25], None),
    ("python ints", [[1, 2], [3, 4]], None),
    ("python bool", True, None),
    ("float64 array", np.linspace(-1, 1, 6).reshape(2, 3), None),
    ("float32 array", np.arange(4, dtype=np.float32), None),
    ("int32 array", np.arange(5, dtype=np.int32), None),
    ("uint8 array", np.arange(5, dtype=np.uint8), None),
    ("scalar float", 2.5, None),
    ("ints as float16", [1, 2, 3], "float16"),
    ("floats as int64", [1.0, 2.0], "int64"),
    ("float64 kept", np.ones(3), "float64"),
    ("floats as bfloat16", [0.5, 1.5, -3.0], "bfloat16"),
]


@pytest.mark.parametrize("what,data,dtype", INPUTS,
                         ids=[i[0] for i in INPUTS])
def test_to_tensor_dtype_and_values_equal_the_reference(what, data, dtype):
    paddle.set_device("cpu")
    ref = jpaddle.to_tensor(data, dtype=dtype)
    got = paddle.to_tensor(data, dtype=dtype)
    assert isinstance(got, paddle.Tensor)
    assert _name(got.dtype) == ref.dtype.name
    assert list(got.shape) == ref.shape
    want = np.asarray(ref.numpy()).astype(np.float64) \
        if ref.dtype.name == "bfloat16" else np.asarray(ref.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.stop_gradient is True and ref.stop_gradient is True
    assert got.is_leaf


def test_to_tensor_copies_and_takes_a_place():
    a = np.arange(3, dtype=np.float32)
    t = paddle.to_tensor(a, place=paddle.CPUPlace())
    a[0] = 7.0
    assert float(t[0]) == 0.0
    assert t.place == paddle.CPUPlace()
    src = torch.ones(2, requires_grad=True)
    u = paddle.to_tensor(src, place="cpu", stop_gradient=False)
    assert u.is_leaf and u.requires_grad and u.grad_fn is None
    assert u.data_ptr() != src.data_ptr()


def test_tensor_methods_equal_the_reference():
    paddle.set_device("cpu")
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    ref, got = jpaddle.to_tensor(x), paddle.to_tensor(x)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert got.item(1) == ref.item(1)
    assert got.tolist() == ref.tolist()
    assert got.numel() == ref.numel() == 6
    assert got.dim() == ref.dim() == 2
    for dt in ("float16", "int32", "float64", "bfloat16"):
        for meth in ("astype", "cast"):
            g, r = getattr(got, meth)(dt), getattr(ref, meth)(dt)
            assert isinstance(g, paddle.Tensor)
            assert _name(g.dtype) == r.dtype.name == dt
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(r.numpy()).astype(g.numpy().dtype))
    for meth in ("detach", "clone", "cpu"):
        g = getattr(got, meth)()
        assert isinstance(g, paddle.Tensor)
        np.testing.assert_array_equal(g.numpy(), x)
    got.set_value(np.full((2, 3), 2.0))
    ref.set_value(np.full((2, 3), 2.0))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert _name(got.dtype) == "float32"
    with pytest.raises(ValueError):
        got.set_value(np.zeros(4))
    assert "stop_gradient=True" in repr(got)


def test_backward_grad_and_clear_gradient_equal_the_reference():
    paddle.set_device("cpu")
    x = np.array([1.0, -2.0, 0.5], np.float32)
    jx = jpaddle.to_tensor(x, stop_gradient=False)
    tx = paddle.to_tensor(x, stop_gradient=False)
    assert jx.stop_gradient is tx.stop_gradient is False
    (jx * jx * jx).sum().backward()
    (tx * tx * tx).sum().backward()
    assert isinstance(tx.grad, paddle.Tensor)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-6)
    # a second backward accumulates, as in the reference
    (jx * 2.0).sum().backward()
    (tx * 2.0).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-6)
    tx.clear_gradient(set_to_zero=True)
    jx.clear_gradient(set_to_zero=True)
    np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.numpy())
    tx.clear_gradient()
    jx.clear_gradient()
    assert tx.grad is None and jx.grad is None
    # a non-scalar backward takes the seed
    y = tx * 3.0
    paddle.Tensor.wrap(y).backward(paddle.to_tensor([1.0, 2.0, 3.0]))
    np.testing.assert_allclose(tx.grad.numpy(), [3.0, 6.0, 9.0])
    # stop_gradient set on a leaf
    tx.stop_gradient = True
    assert not tx.requires_grad
    with pytest.raises(RuntimeError):
        (tx * 2.0).sum().backward()


def test_parameter_is_trainable_and_registers_in_a_module():
    paddle.set_device("cpu")
    ref = jpaddle.Parameter(np.ones((2, 2), np.float32))
    p = paddle.Parameter(np.ones((2, 2), np.float32), name="w")
    assert p.stop_gradient is ref.stop_gradient is False
    assert p.trainable and p.persistable and p.name == "w"
    frozen = paddle.Parameter(np.ones(2), trainable=False)
    assert frozen.stop_gradient and _name(frozen.dtype) == "float32"
    m = torch.nn.Module()
    m.w = p
    assert list(m.parameters())[0] is p
    import copy
    import pickle
    q = copy.deepcopy(p)
    assert isinstance(q, paddle.Parameter) and q.name == "w"
    assert q.data_ptr() != p.data_ptr()
    r = pickle.loads(pickle.dumps(frozen))
    assert isinstance(r, paddle.Parameter) and not r.trainable
    assert r.stop_gradient and torch.equal(r, frozen)
    (p * 3.0).sum().backward()
    np.testing.assert_array_equal(p.grad.numpy(), np.full((2, 2), 3.0))


def test_no_grad_and_grad_mode_are_torchs():
    paddle.set_device("cpu")
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    with paddle.no_grad():
        assert not paddle.is_grad_enabled()
        assert not (x * 2.0).requires_grad
    assert paddle.is_grad_enabled() and torch.is_grad_enabled()

    @paddle.no_grad()
    def f(t):
        return t * 2.0

    @paddle.no_grad
    def g(t):
        return t * 2.0

    assert not f(x).requires_grad and not g(x).requires_grad
    with paddle.set_grad_enabled(False):
        assert not torch.is_grad_enabled()
    assert torch.is_grad_enabled()
    assert paddle.in_dygraph_mode() and jpaddle.in_dygraph_mode()
    # the reference's top-level set_grad_enabled calls bool() in a module
    # whose `bool` is its dtype (paddle_tpu/__init__.py:46, :132): it
    # raises, a reference fault the port does not copy
    with pytest.raises(TypeError):
        jpaddle.set_grad_enabled(False)
    assert jpaddle.is_grad_enabled()


def test_places_and_set_device():
    # the default is the card: no CPU fallback (the reference falls back)
    pplace._current_place = None
    jplace._current_place = None
    assert paddle.get_device() == "gpu:0"
    assert jpaddle.get_device() == "cpu:0"          # this machine, no TPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.vision.models.LeNet()
    for name, want in (("cpu", "cpu:0"), ("gpu:1", "gpu:1"),
                       ("cuda", "gpu:0"), ("tpu", "gpu:0"),
                       ("xpu:2", "gpu:2")):
        paddle.set_device(name)
        assert paddle.get_device() == want
        assert paddle.device.get_device() == want
    with pytest.raises(ValueError):
        paddle.set_device("mlu")
    paddle.set_device("cpu")
    jpaddle.set_device("cpu")
    assert paddle.get_device() == jpaddle.get_device() == "cpu:0"
    net = paddle.vision.models.LeNet()
    assert next(net.parameters()).device.type == "cpu"
    assert paddle.to_tensor([1.0]).place == paddle.CPUPlace()
    assert paddle.CUDAPlace(0).torch_name() == "cuda"
    assert paddle.CUDAPlace(1).torch_name() == "cuda:1"
    assert isinstance(paddle.TPUPlace(0), paddle.CUDAPlace)
    assert paddle.CUDAPinnedPlace().torch_name() == "cpu"
    assert paddle.set_device(paddle.CPUPlace()) == paddle.CPUPlace()
    assert paddle.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert not paddle.device.is_compiled_with_tpu()


def test_default_dtype_equals_the_reference():
    paddle.set_device("cpu")
    assert paddle.get_default_dtype() == jpaddle.get_default_dtype() \
        == "float32"
    paddle.set_default_dtype("float64")
    jpaddle.set_default_dtype("float64")
    assert paddle.get_default_dtype() == jpaddle.get_default_dtype() \
        == "float64"
    assert _name(paddle.to_tensor(1.5).dtype) == \
        jpaddle.to_tensor(1.5).dtype.name == "float64"
    paddle.set_default_dtype(paddle.float16)
    assert _name(paddle.to_tensor([0.5]).dtype) == "float16"
    with pytest.raises(TypeError):
        paddle.set_default_dtype("int32")
    with pytest.raises(TypeError):
        jpaddle.set_default_dtype("int32")
    with pytest.raises(ValueError):
        pdtype.convert_dtype("float128")
    assert pdtype.convert_dtype("float") is torch.float32
    assert pdtype.convert_dtype(np.dtype("int16")) is torch.int16


def test_dtype_names_are_torchs():
    for n in ("uint8", "int8", "int16", "int32", "int64", "float16",
              "bfloat16", "float32", "float64", "complex64", "complex128"):
        assert getattr(paddle, n) is getattr(torch, n)
        assert getattr(jpaddle, n).name == n
    assert paddle.bool is torch.bool
    assert paddle.dtype is torch.dtype


def test_differences_by_design():
    paddle.set_device("cpu")
    t = paddle.to_tensor(np.zeros((2, 3), np.float32))
    r = jpaddle.to_tensor(np.zeros((2, 3), np.float32))
    assert r.shape == [2, 3] and t.shape == (2, 3)
    assert isinstance(t.shape, torch.Size) and t.shape != [2, 3]
    assert r.dtype == "float32" and t.dtype != "float32"
    assert t.dtype == paddle.float32
    assert r.size == 6 and t.size() == (2, 3) and t.numel() == 6
    b = paddle.to_tensor([1.0, 2.5], dtype="bfloat16")
    assert b.numpy().dtype == np.float32
    np.testing.assert_array_equal(b.numpy(), [1.0, 2.5])
    # an op's result is a plain torch tensor: no cost per op
    assert type(t + 1.0) is torch.Tensor
    assert isinstance(paddle.Tensor.wrap(t + 1.0), paddle.Tensor)


def test_seed_and_rng_state_round_trip():
    paddle.set_device("cpu")
    paddle.seed(3)
    state = paddle.get_rng_state()
    a = torch.rand(5, generator=prandom.RNG.cpu)
    b = torch.rand(5)
    paddle.set_rng_state(state)
    assert torch.equal(torch.rand(5, generator=prandom.RNG.cpu), a)
    paddle.seed(3)
    assert torch.equal(torch.rand(5), b)
    with pytest.raises(ValueError):
        paddle.set_rng_state(jpaddle.get_rng_state())


def test_seed_makes_model_initialisers_deterministic():
    paddle.set_device("cpu")
    nets = []
    for s in (0, 0, 1):
        paddle.seed(s)
        nets.append(paddle.vision.models.LeNet())
    w = [dict(n.state_dict()) for n in nets]
    assert all(torch.equal(w[0][k], w[1][k]) for k in w[0])
    assert not torch.equal(w[0]["fc.0.weight"], w[2]["fc.0.weight"])
    # an explicit seed wins over paddle.seed, as before
    explicit = paddle.vision.models.LeNet(seed=0)
    assert torch.equal(explicit.state_dict()["fc.0.weight"],
                       w[0]["fc.0.weight"])
    paddle.seed(0)
    g = paddle.models.gpt_tiny()
    assert torch.equal(g.state_dict()["gpt.embeddings.word_embeddings.weight"],
                       paddle.models.gpt_tiny(seed=0).state_dict()[
                           "gpt.embeddings.word_embeddings.weight"])


FLAG = "FLAGS_sdpa_chunked_threshold"


def test_flags_equal_the_reference():
    assert paddle.get_flags([FLAG]) == jpaddle.get_flags([FLAG]) \
        == {FLAG: 2048}
    assert paddle.get_flags(FLAG) == {FLAG: 2048}
    paddle.set_flags({FLAG: 128})
    assert paddle.get_flags([FLAG])[FLAG] == 128
    paddle.set_flags({"sdpa_chunked_threshold": 0})
    assert pflags.flag("sdpa_chunked_threshold") == 0
    shared = ["FLAGS_use_flash_attention", "FLAGS_use_fused_optimizer",
              "FLAGS_use_fused_dropout_ln", "FLAGS_skip_nonfinite_steps"]
    assert paddle.get_flags(shared) == jpaddle.get_flags(shared)
    for mod in (paddle, jpaddle):
        with pytest.raises(ValueError):
            mod.get_flags(["FLAGS_no_such_flag"])
        with pytest.raises(ValueError):
            mod.set_flags({"FLAGS_no_such_flag": 1})


def test_device_counters_on_the_cpu():
    paddle.set_device("cpu")
    d = paddle.device
    for fn in (d.memory_allocated, d.max_memory_allocated,
               d.memory_reserved, d.max_memory_reserved):
        assert fn() == 0 and fn("cpu") == 0
    assert d.memory_stats() == {} and d.cuda.memory_stats("cpu") == {}
    d.empty_cache()
    d.synchronize()
    assert d.get_device_count("cpu") == 1
    assert d.get_device_count() == d.cuda.device_count() == (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            d.memory_allocated("gpu:0")


# ------------------------------------------------------------- namespace
NAMES = ("seed", "get_rng_state", "set_rng_state", "to_tensor", "Tensor",
         "Parameter", "grad", "no_grad", "get_flags", "set_flags",
         "set_device", "get_device", "bool", "uint8", "int8", "int16",
         "int32", "int64", "float16", "bfloat16", "float32", "float64",
         "complex64", "complex128", "CPUPlace", "CUDAPlace",
         "CUDAPinnedPlace", "TPUPlace", "XPUPlace", "NPUPlace",
         "optimizer", "nn", "amp", "io", "jit", "autograd", "device",
         "vision", "models", "framework", "metric", "incubate", "inference",
         "checkpoint", "resilience", "observability", "tensor", "summary",
         "flops", "Model", "save", "load", "set_default_dtype",
         "get_default_dtype", "in_dygraph_mode", "is_grad_enabled",
         "set_grad_enabled", "is_compiled_with_cuda", "static",
         "enable_static", "disable_static")


@pytest.mark.parametrize("name", NAMES)
def test_top_level_name_resolves_as_in_the_reference(name):
    assert hasattr(paddle, name)
    assert hasattr(jpaddle, name)


def test_train_bench_and_bench_py_calls_resolve():
    # the attributes benchmarks/train_bench.py and bench.py reach
    for path in ("optimizer.AdamW", "optimizer.Adam", "optimizer.Momentum",
                 "amp.decorate", "amp.auto_cast", "nn.CrossEntropyLoss",
                 "io.DataLoader", "io.Dataset", "jit.make_train_step",
                 "models.gpt2_small", "models.gpt_tiny", "models.ernie_base",
                 "models.GPTPretrainingCriterion", "vision.models.LeNet",
                 "vision.models.resnet50", "vision.datasets.MNIST",
                 "metric.Accuracy", "observability.metrics.gauge",
                 "observability.tracing.STEP_INTERVAL"):
        obj = paddle
        for part in path.split("."):
            obj = getattr(obj, part)


def test_bench_lenet_fit_body_runs_with_the_import_changed(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SYNTH_SAMPLES", "64")
    paddle.set_device("cpu")
    # bench.py bench_lenet_fit, with `paddle` the port
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    paddle.seed(0)
    batch_size = 16
    model = paddle.Model(LeNet())
    opt = paddle.optimizer.Adam(parameters=model.parameters(),
                                learning_rate=1e-3)
    model.prepare(opt, paddle.nn.CrossEntropyLoss())
    train = MNIST(mode="train")
    x = np.stack([train[i][0] for i in range(batch_size)]).astype(np.float32)
    y = np.asarray([train[i][1] for i in range(batch_size)], np.int64)
    losses = [model.train_batch([x], [y])["loss"] for _ in range(2)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    # the same seed gives the same losses
    paddle.seed(0)
    again = paddle.Model(LeNet())
    again.prepare(paddle.optimizer.Adam(parameters=again.parameters(),
                                        learning_rate=1e-3),
                  paddle.nn.CrossEntropyLoss())
    assert [again.train_batch([x], [y])["loss"] for _ in range(2)] == losses


def test_train_step_loss_and_outputs_are_tensors():
    paddle.set_device("cpu")
    paddle.seed(0)
    net = paddle.models.gpt_tiny(attn_dropout_prob=0.0,
                                 hidden_dropout_prob=0.0)
    crit = paddle.models.GPTPretrainingCriterion()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=net.parameters())
    step = paddle.jit.make_train_step(net, lambda o, l: crit(o, l), opt)
    ids = paddle.to_tensor(
        np.random.RandomState(0).randint(0, 128, (2, 17)).astype(np.int64))
    loss, outs = step([ids[:, :-1]], [ids[:, 1:]])
    assert isinstance(loss, paddle.Tensor) and loss.stop_gradient
    assert np.isfinite(float(loss.numpy()))
    assert all(isinstance(o, paddle.Tensor) for o in outs)
    # run(): the same step for callers inside the port, plain tensors
    ploss, pouts = step.run([ids[:, :-1]], [ids[:, 1:]])
    assert type(ploss) is torch.Tensor and type(pouts[0]) is torch.Tensor
    ev = paddle.jit.make_eval_step(net, lambda o, l: crit(o, l))
    eloss, eouts = ev([ids[:, :-1]], [ids[:, 1:]])
    assert isinstance(eloss, paddle.Tensor)
    assert isinstance(eouts[0], paddle.Tensor)
    assert eouts[0].numpy().shape == (2, 16, 128)


def test_import_loads_no_jax_and_no_reference():
    code = ("import sys, paddle_tpu_torch as paddle\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]\n"
            "assert not bad, bad\n"
            "assert paddle.get_flags(['FLAGS_sdpa_chunked_threshold']) == "
            "{'FLAGS_sdpa_chunked_threshold': 2048}\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"


def test_flops_of_a_net_without_parameters_takes_the_current_place():
    # it built its input on the CPU whatever the place; now on the place
    net = torch.nn.Sequential(paddle.nn.ReLU())
    paddle.set_device("cpu")
    assert paddle.flops(net, [2, 8]) == jpaddle.flops(
        jpaddle.nn.Sequential(jpaddle.nn.ReLU()), [2, 8])
    if not torch.cuda.is_available():
        paddle.set_device("gpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.flops(net, [2, 8])
