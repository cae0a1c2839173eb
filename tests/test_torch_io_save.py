"""The port's paddle.save / paddle.load, the checkpoint engine's legacy
`ckpt.pkl` read and the vision datasets, against the JAX package, on the
CPU.

  * `.pdparams` files written by either package load in the other: float32,
    int64 and bfloat16 tensors, nested dicts, lists and tuples, plain
    values, and `return_numpy=True`; bfloat16 with `ml_dtypes` blocked on
    the port's side (a child process with ml_dtypes, JAX and the JAX
    package blocked before any import), both ways;
  * the restricted unpickler refuses an `os.system` payload, in both
    packages; a save leaves no tmp file, also when pickling fails;
  * `_read_legacy` gives the reference's arrays, meta and extras for the
    same pre-engine `ckpt.pkl`, `load_checkpoint` restores it into a
    module and an optimizer, and a torn `ckpt.pkl` raises
    CheckpointCorruptError with reason "legacy" in both;
  * MNIST, FashionMNIST, Cifar10, Cifar100 (the synthetic branch, both
    modes) and the local-file branches (idx files, a Cifar pickle,
    DatasetFolder over .npy files) give the reference's samples.

Tolerance: none. Every value is compared bit for bit (bfloat16 through
its float32 widening, which is exact).
"""
import gzip
import os
import pickle
import struct
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.checkpoint import engine as jengine
from paddle_tpu.checkpoint.engine import CheckpointCorruptError as JCorrupt
from paddle_tpu.framework import io as jio
from paddle_tpu.vision import datasets as jdatasets
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.checkpoint import CheckpointCorruptError, engine
from paddle_tpu_torch.framework import io as pio
from paddle_tpu_torch.vision import datasets
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["float32", "int64", "bfloat16"]
_TORCH = {"float32": torch.float32, "int64": torch.int64,
          "bfloat16": torch.bfloat16}


def _values(dtype, shape=(3, 4), seed=0):
    rs = np.random.RandomState(seed)
    if dtype == "int64":
        return np.asarray(rs.randint(-50, 50, shape), np.int64)
    return np.asarray(rs.randn(*shape), np.float32)


def _port_tensor(dtype, shape=(3, 4), seed=0):
    return torch.from_numpy(_values(dtype, shape, seed)).to(_TORCH[dtype])


def _ref_tensor(dtype, shape=(3, 4), seed=0):
    return paddle.to_tensor(_values(dtype, shape, seed)).astype(dtype)


def _f32(x):
    """A tensor or array of either package as float32/int64 numpy."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    arr = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
    return arr.astype(np.float32) if arr.dtype == ml_dtypes.bfloat16 else arr


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_pdparams_load_in_the_reference(tmp_path, dtype):
    path = str(tmp_path / "m.pdparams")
    obj = {"w": _port_tensor(dtype), "nested": {
        "l": [_port_tensor(dtype, (2,), 1), (_port_tensor(dtype, (), 2),)],
        "n": 7, "s": "text"}, "e": _port_tensor(dtype, (0, 3), 3)}
    pio.save(obj, path)
    back = jio.load(path)
    assert str(back["w"].dtype).endswith(dtype)
    np.testing.assert_array_equal(_f32(back["w"]), _f32(obj["w"]))
    np.testing.assert_array_equal(_f32(back["nested"]["l"][0]),
                                  _f32(obj["nested"]["l"][0]))
    assert isinstance(back["nested"]["l"][1], tuple)
    np.testing.assert_array_equal(_f32(back["nested"]["l"][1][0]),
                                  _f32(obj["nested"]["l"][1][0]))
    assert back["nested"]["n"] == 7 and back["nested"]["s"] == "text"
    assert list(back["e"].shape) == [0, 3]
    raw = jio.load(path, return_numpy=True)
    assert str(np.asarray(raw["w"]).dtype) == dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_pdparams_load_in_the_port(tmp_path, dtype):
    path = str(tmp_path / "m.pdparams")
    obj = {"w": _ref_tensor(dtype), "list": [_ref_tensor(dtype, (5,), 1)],
           "tup": (_ref_tensor(dtype, (), 2), 3.5), "plain": {"k": 1}}
    jio.save(obj, path)
    back = pio.load(path, device="cpu")
    assert back["w"].dtype == _TORCH[dtype]
    np.testing.assert_array_equal(_f32(back["w"]), _f32(obj["w"]))
    np.testing.assert_array_equal(_f32(back["list"][0]),
                                  _f32(obj["list"][0]))
    assert isinstance(back["tup"], tuple) and back["tup"][1] == 3.5
    assert tuple(back["tup"][0].shape) == tuple(
        jio.load(path, return_numpy=True)["tup"][0].shape)
    assert back["plain"] == {"k": 1}
    raw = pio.load(path, return_numpy=True)
    if dtype == "bfloat16":
        # numpy has no bfloat16: a CPU torch tensor
        assert isinstance(raw["w"], torch.Tensor)
        assert raw["w"].dtype == torch.bfloat16
    else:
        assert isinstance(raw["w"], np.ndarray)
        assert str(raw["w"].dtype) == dtype
    np.testing.assert_array_equal(_f32(raw["w"]), _f32(obj["w"]))


def test_top_level_save_load_and_stop_gradient(tmp_path):
    path = str(tmp_path / "p.pdparams")
    w = torch.nn.Parameter(torch.ones(2, 2))
    pt.save({"w": w, "b": torch.zeros(2)}, path)
    back = pt.load(path, device="cpu")
    assert back["w"].requires_grad and not back["b"].requires_grad
    ref = paddle.load(path)
    assert not ref["w"].stop_gradient and ref["b"].stop_gradient
    if not torch.cuda.is_available():   # the default device is "cuda"
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.load(path)


_BLOCKED_CHILD = """
import sys
for m in ("ml_dtypes", "jax", "jaxlib", "paddle_tpu"):
    sys.modules[m] = None
import torch
import paddle_tpu_torch as pt
back = pt.load(sys.argv[1], device="cpu")
t = back["w"]
assert t.dtype == torch.bfloat16, t.dtype
pt.save({"w": t * 2, "n": [t[:1]]}, sys.argv[2])
print("BLOCKED_OK", float(t.float().sum()))
"""


def test_bf16_pdparams_with_ml_dtypes_blocked(tmp_path):
    """A child that cannot import ml_dtypes (nor JAX, nor the JAX package)
    loads a reference-written bfloat16 .pdparams and saves one, which the
    reference loads as bfloat16."""
    src, dst = str(tmp_path / "src.pdparams"), str(tmp_path / "dst.pdparams")
    arr = _values("bfloat16", (8, 4)).astype(ml_dtypes.bfloat16)
    jio.save({"w": paddle.to_tensor(arr)}, src)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CHILD, src, dst],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BLOCKED_OK" in out.stdout
    back = jio.load(dst)
    assert str(back["w"].dtype).endswith("bfloat16")
    np.testing.assert_array_equal(_f32(back["w"]),
                                  arr.astype(np.float32) * 2)
    np.testing.assert_array_equal(_f32(back["n"][0]),
                                  arr[:1].astype(np.float32))


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo owned",))


@pytest.mark.parametrize("loader", ["port", "reference"])
def test_unpickler_refuses_os_system(tmp_path, loader):
    path = str(tmp_path / "evil.pdparams")
    with open(path, "wb") as f:
        pickle.dump({"x": _Evil()}, f)
    load = (lambda: pio.load(path, device="cpu")) if loader == "port" \
        else (lambda: jio.load(path))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        load()
    with open(path, "rb") as f, pytest.raises(pickle.UnpicklingError):
        (pio if loader == "port" else jio).restricted_pickle_load(f)


def test_save_leaves_no_tmp_file(tmp_path):
    path = str(tmp_path / "sub" / "m.pdparams")
    pio.save({"w": torch.ones(3)}, path)
    pio.save({"w": torch.zeros(3)}, path)         # replaces atomically
    assert os.listdir(tmp_path / "sub") == ["m.pdparams"]
    assert float(pio.load(path, device="cpu")["w"].sum()) == 0.0
    with pytest.raises(Exception):
        pio.save({"f": lambda: 0}, path)          # unpicklable
    assert os.listdir(tmp_path / "sub") == ["m.pdparams"]
    assert float(pio.load(path, device="cpu")["w"].sum()) == 0.0


# ------------------------------------------------------------ legacy read


def _legacy_payload():
    rs = np.random.RandomState(4)
    return {"state_dict": {"weight": rs.randn(4, 2).astype(np.float32),
                           "bias": rs.randn(2).astype(np.float32)},
            "opt_state": {"@acc_0_velocity": rs.randn(4, 2).astype(
                np.float32), "@acc_1_velocity": np.zeros(2, np.float32),
                "@step_count": 3},
            "meta": {"epoch": 2, "note": "pre-engine"}}


def _write_legacy(d, payload):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "ckpt.pkl"), "wb") as f:
        pickle.dump(payload, f, protocol=4)


def test_read_legacy_equals_the_reference(tmp_path):
    d = str(tmp_path / "legacy")
    _write_legacy(d, _legacy_payload())
    got = engine._read_legacy(d)
    want = jengine._read_legacy(d)
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(np.asarray(got[0][k]), want[0][k])
    assert got[1] == want[1] and got[2] == want[2]


def test_legacy_checkpoint_restores_module_and_optimizer(tmp_path):
    d = str(tmp_path / "legacy")
    payload = _legacy_payload()
    _write_legacy(d, payload)
    lin = nn.Linear(4, 2)
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=lin.parameters(), device="cpu")
    meta = engine.load_checkpoint(d, lin, opt)
    assert meta == payload["meta"]
    np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                  payload["state_dict"]["weight"])
    assert opt._step_count == 3
    np.testing.assert_array_equal(
        opt._get_accumulators(lin.weight)["velocity"].numpy(),
        payload["opt_state"]["@acc_0_velocity"])


def test_torn_legacy_pickle_is_reason_legacy(tmp_path):
    for lib, d in (("port", str(tmp_path / "p")), ("ref", str(tmp_path /
                                                              "r"))):
        _write_legacy(d, _legacy_payload())
        path = os.path.join(d, "ckpt.pkl")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        if lib == "port":
            with pytest.raises(CheckpointCorruptError) as e:
                engine._read_legacy(d)
            assert e.value.reason == "legacy"
            with pytest.raises(CheckpointCorruptError) as e2:
                engine.load_checkpoint(d, nn.Linear(4, 2), fallback=False)
            assert e2.value.reason == "legacy"
        else:
            with pytest.raises(JCorrupt) as e:
                jengine._read_legacy(d)
            assert e.value.reason == "legacy"


# ------------------------------------------------------------ datasets


@pytest.fixture
def synth(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SYNTH_SAMPLES", "48")


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "Cifar10",
                                  "Cifar100"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_samples_bit_equal(synth, name, mode):
    ref = getattr(jdatasets, name)(mode=mode)
    port = getattr(datasets, name)(mode=mode, download=True)
    assert len(port) == len(ref) == 48
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.labels, ref.labels)
    for i in (0, 17, 47):
        (px, py), (rx, ry) = port[i], ref[i]
        assert px.dtype == rx.dtype and py.dtype == ry.dtype
        np.testing.assert_array_equal(px, rx)
        np.testing.assert_array_equal(py, ry)


def _write_idx(tmp_path, n=6):
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lab = rs.randint(0, 10, n).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())
    return ip, lp


def test_local_files_read_as_the_reference(tmp_path):
    ip, lp = _write_idx(tmp_path)
    port = datasets.MNIST(image_path=ip, label_path=lp)
    ref = jdatasets.MNIST(image_path=ip, label_path=lp)
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.labels, ref.labels)
    rs = np.random.RandomState(3)
    cifar = str(tmp_path / "batch")
    with open(cifar, "wb") as f:
        pickle.dump({b"data": rs.randint(0, 256, (5, 3072)).astype(
            np.uint8), b"labels": list(range(5))}, f)
    p, r = datasets.Cifar10(data_file=cifar), jdatasets.Cifar10(
        data_file=cifar)
    np.testing.assert_array_equal(p[3][0], r[3][0])
    assert int(p[3][1]) == int(r[3][1]) == 3
    for c in ("a", "b"):
        os.makedirs(tmp_path / "folder" / c)
        for j in range(2):
            np.save(str(tmp_path / "folder" / c / ("%d.npy" % j)),
                    rs.randn(2, 2).astype(np.float32))
    pf = datasets.DatasetFolder(str(tmp_path / "folder"))
    rf = jdatasets.DatasetFolder(str(tmp_path / "folder"))
    assert pf.classes == rf.classes and len(pf) == len(rf) == 4
    for i in range(4):
        np.testing.assert_array_equal(pf[i][0], rf[i][0])
        assert pf[i][1] == rf[i][1]
