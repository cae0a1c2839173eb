"""PyTorch + CUDA port of paddle_tpu's GPT serving and training paths, its
BERT/ERNIE pretraining path and its ResNet training path.

The JAX package `paddle_tpu` stays the reference; this package serves and
trains the same models through the same host API on an NVIDIA H100, with
the attention, residual-tail and optimizer kernels written by hand in
CUDA C++ for `sm_90a` (ops/csrc/).

    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.inference.serving import (ContinuousBatcher,
                                                    GenerationEngine,
                                                    Request)

    model = gpt2_small(seed=0)                       # device="cuda"
    eng = GenerationEngine(model, max_batch=8, max_seq_len=512,
                           prefill_buckets=(32, 128, 256))
    batcher = ContinuousBatcher(eng)

    # training: the JAX package's GPT-2 train bench, eagerly
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                          parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion()
    step = make_train_step(model, lambda o, l: crit(o, l), opt)
    loss, _ = step([ids[:, :-1]], [ids[:, 1:]])

    # ERNIE-base pretraining: the JAX package's ERNIE bench
    from paddle_tpu_torch.framework import set_flags
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_base
    set_flags({"FLAGS_use_fused_dropout_ln": True})
    net = ernie_base(seed=0)
    opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                          parameters=net.parameters())
    crit = BertPretrainingCriterion()
    step = make_train_step(net, lambda lg, nl, y1, y2: crit(lg, nl, y1, y2),
                           opt)
    with amp.auto_cast(level="O2"):
        loss, _ = step([ids], [mlm_labels, nsp_labels])

    # ResNet-50: the JAX package's ResNet bench, through the dygraph step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=100)
    opt = optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                             parameters=net.parameters())
    step = make_train_step(net, lambda o, y: F.cross_entropy(o, y), opt)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss, _ = step([images], [labels])

    # Model.fit: the JAX package's LeNet fit (bench.py), on the card
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    net = LeNet()
    model = paddle.Model(net)
    model.prepare(optimizer.Adam(learning_rate=1e-3,
                                 parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss(),
                  metrics=paddle.metric.Accuracy())
    model.fit(MNIST(mode="train"), batch_size=256, epochs=1,
              num_workers=2, save_dir="ckpt")
    paddle.save(net.state_dict(), "lenet.pdparams")

Entry points take a `device` that defaults to the current place: the
card ("gpu:0") unless the caller chose the CPU (`set_device("cpu")` or
device="cpu"); the card raises when CUDA is absent, never falling back to
the CPU. On CPU tensors every kernel wrapper runs its plain PyTorch
version instead.

The top level binds the reference's names (`paddle_tpu/__init__.py:46-151`)
whose modules the port has, so that the reference's scripts run with the
import changed:

    import paddle_tpu_torch as paddle
    paddle.seed(0)
    ids = paddle.to_tensor(np_ids)                   # on the card
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=net.parameters())
    net, opt = paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    paddle.set_flags({"FLAGS_sdpa_chunked_threshold": 4096})
    loss, _ = step([ids[:, :-1]], [ids[:, 1:]])
    print(float(loss.numpy()))

The static graph and the predictor (`static`, `enable_static`,
`disable_static`, `inference.Config` / `create_predictor`) run the
reference's static ResNet-50 training and its predictors:

    paddle.enable_static()
    img = paddle.static.data("image", [-1, 3, 224, 224], "float32")
    ...
    paddle.static.save_inference_model("rn50", [img], [logits], exe)
    pred = paddle.inference.create_predictor(
        paddle.inference.Config("rn50.pdmodel", "rn50.pdiparams"))

The tensor-op surface is bound at the top level, as the reference binds
it (`from .tensor import *`): `paddle.add`, `paddle.matmul`,
`paddle.sum(x, 1)`, `paddle.topk`, `paddle.einsum`, `paddle.arange`,
`paddle.randn`, ..., and `paddle.linalg`; each op is registered under the
reference's op type name (ops/math.py, manipulation.py, creation.py,
linalg.py, random_ops.py), so a static program records it.

Row-sparse gradients: `nn.Embedding(sparse=True)` gives its table a
`paddle.SelectedRows` gradient in dygraph, which `optimizer.SGD` applies
as a scatter-add and `Adam` / `AdamW(lazy_mode=True)` on the touched rows
only; captured steps (`make_train_step`, static programs) keep dense
gradients. `fft`, `signal`, `distribution`, `text`, `hub` and the legacy
`fluid` are bound.

Names whose modules are not ported stay unbound: `distributed`,
`dataset`, `reader`, `utils`, `onnx`, `quantization` and `cost_model`.

Float32 matrix products run in full float32: the reference computes in
float32, so TF32 is switched off for matmul and cuDNN at import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# dtypes
from .framework.dtype import bool_ as bool  # noqa: E402,F401,A004
from .framework.dtype import (uint8, int8, int16, int32,  # noqa: E402,F401
                              int64, float16, bfloat16, float32, float64,
                              complex64, complex128, set_default_dtype,
                              get_default_dtype)
from torch import dtype  # noqa: E402,F401
# places and the device
from .framework.place import (CPUPlace, CUDAPinnedPlace,  # noqa: E402,F401
                              CUDAPlace, NPUPlace, TPUPlace, XPUPlace,
                              get_device, set_device, is_compiled_with_cuda,
                              is_compiled_with_rocm, is_compiled_with_npu,
                              is_compiled_with_xpu)
# the tensor, grad mode, randomness, flags
from .framework.tensor import Parameter, Tensor, to_tensor  # noqa: E402,F401
from .framework.state import (disable_static,  # noqa: E402,F401
                              enable_static, in_dygraph_mode,
                              in_static_mode, is_grad_enabled, no_grad,
                              set_grad_enabled)
from .framework.random import (get_rng_state, seed,  # noqa: E402,F401
                               set_rng_state)
from .framework.flags import get_flags, set_flags  # noqa: E402,F401
from .framework.autograd import grad  # noqa: E402,F401
# the tensor-op surface at the top level, as the reference's
from .tensor import *  # noqa: E402,F401,F403

from . import (amp, autograd, checkpoint, device,  # noqa: E402,F401
               framework, hapi, incubate, inference, io, jit, metric,
               linalg, models, nn, observability, optimizer, resilience,
               static, tensor, vision)
from .ops import misc_ops  # noqa: E402,F401
from . import (distribution, fft, fluid, hub, signal,  # noqa: E402,F401
               text)
from .framework.selected_rows import SelectedRows  # noqa: E402,F401
from .framework.io import load, save  # noqa: E402,F401
from .hapi import callbacks, flops, summary  # noqa: E402,F401
from .hapi.model import Model  # noqa: E402,F401

__version__ = "0.1.0"
full_version = __version__
commit = "torch-cuda"


def batch(reader, batch_size, drop_last=False):
    """The classic reader batching: a reader of lists of batch_size
    samples (the last one shorter unless drop_last)."""

    def batch_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, device=None):
    """A trainable parameter outside any Layer, on `device` (the current
    place by default), drawn as `Layer.create_parameter` draws one
    (`default_initializer` where the ParamAttr names none)."""
    from .framework.device import resolve_device
    from .nn.layer_base import Layer
    p = Layer().create_parameter(shape, attr, dtype, is_bias,
                                 default_initializer)
    with torch.no_grad():
        p.data = p.data.to(resolve_device(device))
    if name is not None:
        p.name = name
    return p


def enable_dygraph(place=None):
    disable_static()


def disable_dygraph():
    enable_static()


def in_dynamic_mode():
    return in_dygraph_mode()


def get_cuda_rng_state():
    """The CUDA generators' states, one a card ([] without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.cuda.get_rng_state(i)
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list):
    """Restore the states `get_cuda_rng_state` returned."""
    for i, st in enumerate(state_list):
        torch.cuda.set_rng_state(st, i)


def get_cudnn_version():
    """cuDNN's version as an int (torch.backends.cudnn.version()), None
    without cuDNN."""
    return torch.backends.cudnn.version()


def disable_signal_handler():
    """The port installs no signal handlers of its own here: a no-op."""


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """numpy's print options (a Tensor prints through numpy)."""
    import numpy as _np
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth)) if v is not None}
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


def monkey_patch_math_varbase():
    """A no-op: the Tensor's operators are torch's."""


def monkey_patch_variable():
    """A no-op: a static Variable records its operators already."""


def check_shape(shape):
    """Raise for a dimension below -1."""
    for s in shape:
        if s is not None and int(s) < -1:
            raise ValueError("illegal dimension %s in shape %s"
                             % (s, shape))


__all__ = ["amp", "autograd", "checkpoint", "device", "framework", "hapi",
           "incubate", "inference", "io", "jit", "linalg", "metric",
           "models", "nn",
           "observability", "ops", "optimizer", "resilience", "static",
           "tensor", "vision", "enable_static", "disable_static",
           "in_static_mode", "Model", "callbacks", "flops", "summary", "save",
           "load", "bool", "uint8", "int8", "int16", "int32", "int64",
           "float16", "bfloat16", "float32", "float64", "complex64",
           "complex128", "dtype", "set_default_dtype", "get_default_dtype",
           "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "NPUPlace", "get_device", "set_device",
           "is_compiled_with_cuda", "is_compiled_with_rocm",
           "is_compiled_with_npu", "is_compiled_with_xpu", "Tensor",
           "Parameter", "to_tensor", "no_grad", "in_dygraph_mode",
           "is_grad_enabled", "set_grad_enabled", "seed", "get_rng_state",
           "set_rng_state", "get_flags", "set_flags", "grad",
           "SelectedRows", "fft", "signal", "distribution", "hub", "fluid",
           "text", "batch", "create_parameter", "enable_dygraph",
           "disable_dygraph", "in_dynamic_mode", "get_cuda_rng_state",
           "set_cuda_rng_state", "get_cudnn_version",
           "disable_signal_handler", "set_printoptions", "check_shape",
           "monkey_patch_math_varbase", "monkey_patch_variable",
           "full_version", "commit"] + tensor.__all__
