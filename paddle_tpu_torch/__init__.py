"""PyTorch + CUDA port of paddle_tpu's GPT serving path.

The JAX package `paddle_tpu` stays the reference; this package serves the
same models through the same host API on an NVIDIA H100, with the attention
kernels written by hand in CUDA C++ for `sm_90a` (ops/csrc/).

    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.inference.serving import (ContinuousBatcher,
                                                    GenerationEngine,
                                                    Request)

    model = gpt2_small(seed=0)                       # device="cuda"
    eng = GenerationEngine(model, max_batch=8, max_seq_len=512,
                           prefill_buckets=(32, 128, 256))
    batcher = ContinuousBatcher(eng)

Entry points take an explicit `device` that defaults to "cuda" and raise
when CUDA is absent unless the caller passes device="cpu"; on CPU tensors
every kernel wrapper runs its plain PyTorch version instead.

Float32 matrix products run in full float32: the reference computes in
float32, so TF32 is switched off for matmul and cuDNN at import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["framework", "inference", "models", "nn", "observability", "ops"]
