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

Entry points take an explicit `device` that defaults to "cuda" and raise
when CUDA is absent unless the caller passes device="cpu"; on CPU tensors
every kernel wrapper runs its plain PyTorch version instead.

Float32 matrix products run in full float32: the reference computes in
float32, so TF32 is switched off for matmul and cuDNN at import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import hapi, metric  # noqa: E402,F401
from .framework.io import load, save  # noqa: E402,F401
from .hapi import callbacks, flops, summary  # noqa: E402,F401
from .hapi.model import Model  # noqa: E402,F401

__all__ = ["amp", "checkpoint", "framework", "hapi", "incubate",
           "inference", "io", "jit", "metric", "models", "nn",
           "observability", "ops", "optimizer", "resilience", "tensor",
           "vision", "Model", "callbacks", "flops", "summary", "save",
           "load"]
