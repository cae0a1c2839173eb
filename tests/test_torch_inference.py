"""The port's predictor (paddle_tpu_torch.inference: Config, Predictor,
create_predictor, PredictorPool) and its model files
(static.save_inference_model / load_inference_model) on the CPU.

The reference's own artifacts (its ResNet-18 in eval mode at 32x32 and
bert_tiny's MLM logits, written by the JAX package's
save_inference_model with its fusion passes) load in the port's
create_predictor unchanged, without importing JAX or the JAX package,
and give the reference Predictor's outputs within 1e-5 of the largest
|value| (float32: the same functions, float32 sums in another order);
through Config.enable_mkldnn_bfloat16() both packages compute in
bfloat16, held to 2e-2 of the largest |value| (bfloat16's 2^-9
roundings through two encoder layers, XLA and oneDNN rounding in their
own orders).
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import static as jstatic
from paddle_tpu.framework import place as jplace
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate_predictor
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn, static
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.inference import (Config, PredictorPool,
                                        create_predictor)
from paddle_tpu_torch.nn import functional as F
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

F32_TOL, BF16_TOL = 1e-5, 2e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_place():
    saved = pplace._current_place, jplace._current_place
    paddle.set_device("cpu")
    yield
    paddle.disable_static()
    static.reset_default_programs()
    pplace._current_place, jplace._current_place = saved


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _ref_export(build, spec, path):
    jpaddle.enable_static()
    jstatic.reset_default_programs()
    try:
        x = jstatic.data(*spec)
        out = build(x)
        jstatic.save_inference_model(path, [x], [out], jstatic.Executor())
    finally:
        jpaddle.disable_static()
        jstatic.reset_default_programs()


@pytest.fixture(scope="module")
def ref_artifacts(tmp_path_factory):
    """The reference's ResNet-18 and bert_tiny artifacts, their inputs and
    the reference Predictor's outputs (bert_tiny also in bfloat16)."""
    from paddle_tpu.models import bert_tiny
    from paddle_tpu.vision.models import resnet18
    root = tmp_path_factory.mktemp("reference_artifacts")
    jpaddle.seed(0)
    rn = resnet18(num_classes=10)
    rn.eval()
    bert = bert_tiny()
    bert.eval()
    paths = {"resnet": str(root / "resnet18"), "bert": str(root / "bert")}
    _ref_export(rn, ("image", [-1, 3, 32, 32], "float32"), paths["resnet"])
    _ref_export(lambda ids: bert(ids)[0], ("ids", [2, 16], "int64"),
                paths["bert"])
    inputs = {"resnet": np.random.RandomState(0).rand(2, 3, 32, 32)
              .astype(np.float32),
              "bert": np.random.RandomState(1).randint(0, 1024, (2, 16))
              .astype(np.int64)}
    outs = {k: jcreate_predictor(JConfig(paths[k] + ".pdmodel"))
            .run([inputs[k]])[0].numpy() for k in paths}
    cfg = JConfig(paths["bert"] + ".pdmodel")
    cfg.enable_mkldnn_bfloat16()
    outs["bert_bf16"] = jcreate_predictor(cfg).run([inputs["bert"]])[0] \
        .numpy()
    return paths, inputs, outs


@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_reference_artifact_loads_and_matches_the_reference_predictor(
        name, ref_artifacts):
    paths, inputs, outs = ref_artifacts
    pred = create_predictor(Config(paths[name] + ".pdmodel",
                                   paths[name] + ".pdiparams"))
    (got,) = pred.run([inputs[name]])
    assert got.dtype == torch.float32
    assert got.shape == outs[name].shape
    assert _rel(got.numpy(), outs[name]) <= F32_TOL
    types = {op.op_type for op in pred._program.ops}
    assert ("fused_elemwise_add_act" in types if name == "resnet"
            else "flash_attention" in types and "fc_op" in types)


def test_bfloat16_predictor_matches_the_reference_bfloat16(ref_artifacts):
    paths, inputs, outs = ref_artifacts
    cfg = Config(paths["bert"] + ".pdmodel")
    cfg.enable_mkldnn_bfloat16()
    (got,) = create_predictor(cfg).run([inputs["bert"]])
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), outs["bert_bf16"]) <= BF16_TOL
    assert _rel(got.numpy(), outs["bert"]) <= BF16_TOL


def test_loading_imports_neither_jax_nor_the_reference(ref_artifacts):
    paths, inputs, outs = ref_artifacts
    np.save(os.path.join(os.path.dirname(paths["bert"]), "ids.npy"),
            inputs["bert"])
    code = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch.inference import Config, create_predictor
paddle.set_device("cpu")
prefix = sys.argv[1]
pred = create_predictor(Config(prefix + ".pdmodel"))
out = pred.run([np.load(sys.argv[2])])[0].numpy()
np.save(sys.argv[3], out)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print("MODULES", bad)
"""
    out_path = paths["bert"] + "_out.npy"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code, paths["bert"],
         os.path.join(os.path.dirname(paths["bert"]), "ids.npy"), out_path],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "MODULES []" in res.stdout
    assert _rel(np.load(out_path), outs["bert"]) <= F32_TOL


def _port_model(tmp_path):
    """A conv -> batch norm -> relu -> pool -> linear -> softmax program of
    the port in eval mode, saved; returns (prefix, the static program's
    output on a batch, the batch)."""
    paddle.seed(3)
    paddle.enable_static()
    static.reset_default_programs()
    x = static.data("x", [-1, 3, 8, 8], "float32")
    conv, bn = nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4)
    with torch.no_grad():
        bn._mean.uniform_(-1, 1)
        bn._variance.uniform_(0.5, 2)
    bn.eval()
    lin = nn.Linear(16, 5)
    h = F.max_pool2d(F.relu(bn(conv(x))), 4)
    y = F.softmax(lin(paddle.tensor.flatten(h, 1)))
    exe = static.Executor()
    a = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
    (want,) = exe.run(feed={"x": a}, fetch_list=[y])
    prefix = str(tmp_path / "port_model")
    static.save_inference_model(prefix, [x], [y], exe)
    paddle.disable_static()
    return prefix, want, a


def test_the_ports_save_load_round_trip(tmp_path):
    prefix, want, a = _port_model(tmp_path)
    with open(prefix + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    assert sorted(meta) == ["aliases", "feed_names", "fetch_names", "ops"]
    assert [op["op_type"] for op in meta["ops"]] == [
        "conv2d_op", "fused_elemwise_add_act", "pool2d_op",
        "flatten_contiguous_range", "fc_op", "softmax_op"]
    with open(prefix + ".pdiparams", "rb") as f:
        caps = pickle.load(f)
    assert all(isinstance(v, np.ndarray) for v in caps.values())
    prog, feeds, fetches = static.load_inference_model(prefix)
    (got,) = static.Executor().run(prog, feed={feeds[0]: a},
                                   fetch_list=fetches)
    assert _rel(got, want) <= F32_TOL
    (out,) = create_predictor(Config(prefix)).run([a])
    assert _rel(out.numpy(), want) <= F32_TOL
    # the reference's predictor loads the port's file too
    jout = jcreate_predictor(JConfig(prefix)).run([a])[0].numpy()
    assert _rel(jout, want) <= F32_TOL


def test_handles_run_list_and_a_pool_sharing_its_programs(tmp_path):
    prefix, want, a = _port_model(tmp_path)
    pool = PredictorPool(Config(prefix + ".pdmodel"), size=3)
    p0, p1 = pool.retrieve(0), pool.retrieve(1)
    assert p0.programs is p1.programs is pool.retrieve(2).programs
    name, out_name = p0.get_input_names()[0], p0.get_output_names()[0]
    h = p0.get_input_handle(name)
    h.copy_from_cpu(a)
    assert h.shape() == [2, 3, 8, 8]
    p0.run()
    o = p0.get_output_handle(out_name)
    assert o.shape() == [2, 5]
    got0 = o.copy_to_cpu()
    assert isinstance(got0, np.ndarray) and _rel(got0, want) <= F32_TOL
    b = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    (got1,) = p1.run([b])
    # one program for the signature, built once, replayed by the member
    key = next(iter(p0.programs.builds))
    assert p0.programs.builds == {key: 1} and p0.programs.replays[key] == 1
    assert not np.array_equal(got1.numpy(), got0)
    np.testing.assert_array_equal(o.copy_to_cpu(), got0)   # p0's own
    (again,) = p0.run([a])
    np.testing.assert_array_equal(again.numpy(), got0)
    # a new signature is a new program
    p1.run([np.concatenate([a, b])])
    assert len(p0.programs.builds) == 2


def test_config_surface(tmp_path):
    cfg = Config(str(tmp_path / "m.pdmodel"), str(tmp_path / "m.pdiparams"))
    assert cfg.model_dir() == str(tmp_path / "m")
    assert cfg.prog_file() == str(tmp_path / "m.pdmodel")
    assert cfg.params_file() == str(tmp_path / "m.pdiparams")
    for knob in (cfg.switch_ir_optim, cfg.enable_memory_optim,
                 cfg.enable_mkldnn):
        knob()
    cfg.set_cpu_math_library_num_threads(2)
    cfg.enable_use_gpu(100, 0)
    assert cfg._device == "cuda:0"
    cfg.disable_gpu()
    assert cfg._device == "cpu"


def test_an_unknown_op_or_a_foreign_pickle_raises(tmp_path):
    prefix = str(tmp_path / "bad")
    with open(prefix + ".pdmodel", "wb") as f:
        pickle.dump({"ops": [{"op_type": "no_such_op", "attrs": {},
                              "in_refs": [("var", "x")],
                              "out_names": ["y"]}],
                     "feed_names": ["x"], "fetch_names": ["y"],
                     "aliases": {}}, f)
    with open(prefix + ".pdiparams", "wb") as f:
        pickle.dump({}, f)
    with pytest.raises(KeyError, match="no_such_op"):
        static.load_inference_model(prefix)
    with open(prefix + ".pdiparams", "wb") as f:
        pickle.dump({"w": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="getcwd"):
        static.load_inference_model(prefix)
