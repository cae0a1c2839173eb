"""static.gradients / append_backward, the top-level remainder and the
name diff of the port against the JAX package, on the CPU.

`static.gradients` records one backward op over the pruned forward slice,
fetched through Executor.run: its values against the reference's
Executor on the same program (weights carried over) and against eager
autograd, within 1e-6 (rtol and atol: XLA's and torch's float32 sums
differ in the last bits), with target_gradients seeding the targets and
no_grad_set cutting the flow; `append_backward` gives every trainable
parameter's. The names the port binds: every public name of the
reference's top level, static, incubate, framework and device but the
ones of modules not ported yet, listed exactly here; the op registry
lacks exactly the 20 vision/ and quantization/ op types.
"""
import inspect
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.framework.dispatch import OPS as JOPS

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn, static
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.framework.dispatch import OPS
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

# queue 1 items 4-6 of ROADMAP.md: not ported yet
TOP_LEVEL_REMAINDER = {"distributed", "dataset", "reader", "utils", "onnx",
                       "quantization", "cost_model"}
# the reference's module artifacts (imports, not API)
ARTIFACTS = {"np", "math", "annotations"}
OPS_REMAINDER = {
    "anchor_generator_op", "box_clip_op", "box_coder",
    "box_decoder_and_assign_op", "deform_conv2d", "density_prior_box_op",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_fixed_scale", "int8_conv2d", "int8_linear",
    "iou_similarity_op", "polygon_box_transform_op", "prior_box",
    "psroi_pool_op", "roi_align", "roi_perspective_transform_op",
    "roi_pool_op", "sigmoid_focal_loss_op", "yolov3_loss_op"}


@pytest.fixture(autouse=True)
def on_cpu():
    saved = pplace._current_place
    paddle.set_device("cpu")
    yield
    pplace._current_place = saved
    paddle.disable_static()
    jpaddle.disable_static()


_DIFF = r"""
import json, jax
jax.config.update("jax_platforms", "cpu")
import paddle_tpu as j, paddle_tpu_torch as p
pub = lambda m: {n for n in dir(m) if not n.startswith("_")}
out = {"": sorted(pub(j) - pub(p))}
for sub in ("static", "incubate", "framework", "device"):
    out[sub] = sorted(pub(getattr(j, sub)) - pub(getattr(p, sub)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def name_diff():
    """The public names of each reference namespace that the port lacks,
    read in a fresh process: test modules that import a submodule add it
    to its package's names in this one."""
    import json
    import subprocess
    import sys
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", _DIFF], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return {k: set(v) for k, v in json.loads(
        out.stdout.strip().splitlines()[-1]).items()}


def test_the_registry_lacks_only_vision_and_quantization():
    missing = set(JOPS) - set(OPS)
    assert missing == OPS_REMAINDER, sorted(missing ^ OPS_REMAINDER)
    for op in missing:
        f = inspect.getsourcefile(JOPS[op].fn).replace(os.sep, "/")
        assert "/vision/" in f or "/quantization/" in f, (op, f)


def test_the_top_level_lacks_only_the_unported_modules(name_diff):
    assert name_diff[""] == TOP_LEVEL_REMAINDER | ARTIFACTS
    for n in ("SelectedRows", "fft", "signal", "distribution", "hub",
              "fluid", "text", "batch", "create_parameter",
              "enable_dygraph", "disable_dygraph", "in_dynamic_mode",
              "get_cuda_rng_state", "set_cuda_rng_state",
              "get_cudnn_version", "disable_signal_handler",
              "set_printoptions", "check_shape",
              "monkey_patch_math_varbase", "monkey_patch_variable",
              "full_version", "commit"):
        assert n in paddle.__all__, n


@pytest.mark.parametrize("sub,left", [
    ("static", {"case", "cond", "control_flow", "jax", "nn", "sparsity",
                "switch_case", "while_loop"}),
    ("incubate", {"GradientMergeOptimizer", "LookAhead", "ModelAverage",
                  "asp", "optimizer"}),
    ("framework", {"platform"}),
    ("device", set())])
def test_namespaces_lack_only_what_is_not_ported(sub, left, name_diff):
    assert name_diff[sub] == left


def test_top_level_functions():
    assert paddle.get_cuda_rng_state() == []     # no CUDA here
    paddle.set_cuda_rng_state([])
    assert paddle.get_cudnn_version() == torch.backends.cudnn.version()
    reader = paddle.batch(lambda: iter(range(7)), 3)
    assert list(reader()) == [[0, 1, 2], [3, 4, 5], [6]]
    assert list(paddle.batch(lambda: iter(range(7)), 3,
                             drop_last=True)()) == [[0, 1, 2], [3, 4, 5]]
    p = paddle.create_parameter([3, 4], "float32", name="w_t",
                                default_initializer=nn.initializer.Constant(
                                    0.5))
    assert p.requires_grad and p.name == "w_t" and p.shape == (3, 4)
    assert float(p.sum()) == 6.0 and p.device.type == "cpu"
    paddle.check_shape([2, -1, 3])
    with pytest.raises(ValueError):
        paddle.check_shape([2, -3])
    assert paddle.in_dynamic_mode()
    paddle.disable_dygraph()
    assert paddle.in_static_mode() and not paddle.in_dynamic_mode()
    paddle.enable_dygraph()
    assert paddle.in_dynamic_mode()
    assert paddle.framework.DType is torch.float32.__class__
    assert paddle.framework.in_static_mode() is False
    assert paddle.framework.selected_rows.SelectedRows is paddle.SelectedRows
    assert paddle.device.get_all_device_type() == ["cpu"]
    assert isinstance(paddle.full_version, str) and paddle.commit
    paddle.monkey_patch_math_varbase()
    paddle.monkey_patch_variable()
    paddle.disable_signal_handler()


def test_hub_loads_from_a_local_directory(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "def tiny(n=2):\n    '''a tiny model'''\n    return ('tiny', n)\n")
    assert paddle.hub.list(str(tmp_path)) == ["tiny"]
    assert paddle.hub.help(str(tmp_path), "tiny") == "a tiny model"
    assert paddle.hub.load(str(tmp_path), "tiny", n=3) == ("tiny", 3)
    with pytest.raises(NotImplementedError):
        paddle.hub.load("owner/repo", "tiny", source="github")


# ---------------------------------------------------------------------------
# static.gradients and append_backward


def _program(mod, w, b, x):
    """mean(tanh(x @ w + b)^2) in `mod`'s static mode, with its Linear
    holding w and b: (program, x var, linear, hidden, loss)."""
    mod.enable_static()
    prog = mod.static.Program()
    with mod.static.program_guard(prog):
        xv = mod.static.data("x", list(x.shape), "float32")
        lin = mod.nn.Linear(3, 2)
        for p, v in ((lin.weight, w), (lin.bias, b)):
            if mod is jpaddle:
                p.set_value(v.copy())
            else:
                with torch.no_grad():
                    p.copy_(torch.from_numpy(v))
        h = lin(xv)
        y = mod.tanh(h)
        loss = mod.mean(y * y)
    return prog, xv, lin, h, loss


def _data():
    rs = np.random.RandomState(0)
    return (rs.randn(3, 2).astype(np.float32),
            rs.randn(2).astype(np.float32),
            rs.randn(4, 3).astype(np.float32))


def _eager(w, b, x, seed=1.0):
    wt, bt, xt = (torch.from_numpy(a).requires_grad_(True) for a in (w, b, x))
    y = torch.tanh(xt @ wt + bt)
    loss = (y * y).mean()
    return [g.numpy() for g in torch.autograd.grad(loss * seed,
                                                   [xt, wt, bt])]


def test_gradients_against_the_reference_and_autograd():
    w, b, x = _data()
    prog, xv, lin, h, loss = _program(paddle, w, b, x)
    seed = static.data("seed", [], "float32")
    grads = static.gradients([loss], [xv, lin.weight, lin.bias],
                             target_gradients=[seed])
    paddle.disable_static()
    assert prog.ops[-1].op_type == "gradients"
    got = static.Executor("cpu").run(
        prog, feed={"x": x, "seed": np.float32(2.0)},
        fetch_list=[loss] + grads)
    jprog, jx, jlin, _, jloss = _program(jpaddle, w, b, x)
    jgrads = jpaddle.static.gradients([jloss], [jx, jlin.weight,
                                                jlin.bias])
    jpaddle.disable_static()
    want = jpaddle.static.Executor().run(jprog, feed={"x": x},
                                         fetch_list=[jloss] + jgrads)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for g, jg, eg in zip(got[1:], want[1:], _eager(w, b, x, 2.0)):
        np.testing.assert_allclose(g, 2.0 * np.asarray(jg), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(g, eg, rtol=1e-6, atol=1e-6)


def test_append_backward_and_no_grad_set():
    w, b, x = _data()
    prog, xv, lin, h, loss = _program(paddle, w, b, x)
    pairs = static.append_backward(loss)
    cut = static.gradients([loss], [xv], no_grad_set=[h])
    paddle.disable_static()
    assert [p for p, _ in pairs] == [lin.weight, lin.bias]
    got = static.Executor("cpu").run(prog, feed={"x": x},
                                     fetch_list=[g for _, g in pairs] + cut)
    _, ew, eb = _eager(w, b, x)
    np.testing.assert_allclose(got[0], ew, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], eb, rtol=1e-6, atol=1e-6)
    assert np.all(got[2] == 0.0)


def test_new_entry_points_default_to_the_card():
    """Without CUDA, the slice's entry points raise unless given the
    CPU (the place is the card by default, with no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    pplace._current_place = None
    for call in (lambda: paddle.fft.fftfreq(4),
                 lambda: paddle.distribution.Normal(0.0, 1.0),
                 lambda: paddle.create_parameter([2, 3]),
                 lambda: paddle.optimizer.Adam(lazy_mode=True),
                 lambda: paddle.fluid.create_lod_tensor([1.0], [[1]])):
        with pytest.raises(RuntimeError):
            call()
    assert paddle.fft.fftfreq(4, device="cpu").device.type == "cpu"
    assert paddle.distribution.Normal(0.0, 1.0, device="cpu").loc.device \
        .type == "cpu"
