"""Rules the PyTorch port keeps: it (and chip_smoke.py) imports neither
JAX nor the JAX package, its entry points run on CUDA unless the caller
asks for the CPU, and a CPU tensor never counts as a kernel launch."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.framework.random import philox_word
from paddle_tpu_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")


def _py_files():
    for d, _, names in os.walk(PKG):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = list(_py_files())
    assert len(files) > 15
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_roots(p)
           if m in ("jax", "jaxlib", "paddle_tpu")]
    assert bad == []


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'paddle_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import paddle_tpu_torch\n"
        "from paddle_tpu_torch import (amp, framework, incubate, io, jit, "
        "models,\n"
        "                              nn, ops, optimizer)\n"
        "from paddle_tpu_torch.inference import serving\n"
        "from paddle_tpu_torch.observability import (flight, httpd, journal,"
        " memprof, metrics, spans, tracing)\n"
        "from paddle_tpu_torch.resilience import health\n"
        "from paddle_tpu_torch.inference.serving import InferenceServer\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is usable")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from paddle_tpu_torch.framework.device import resolve_device
    from paddle_tpu_torch.inference.serving import (GenerationEngine,
                                                    PagedKVCache)
    from paddle_tpu_torch.models import (bert_base, bert_tiny, ernie_base,
                                         gpt2_small, gpt_tiny)
    for build in (gpt_tiny, gpt2_small, bert_tiny, bert_base, ernie_base,
                  resolve_device):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(1, 1, 1, 8, 8)
    model = gpt_tiny(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(model, max_batch=1, max_seq_len=32,
                         prefill_buckets=(8,))
    from paddle_tpu_torch.inference.serving import InferenceServer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(model, max_batch=1, max_seq_len=32,
                        prefill_buckets=(8,))
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.optimizer import Adam, AdamW
    for build in (lambda: AdamW(parameters=model.parameters()),
                  lambda: Adam(parameters=model.parameters()),
                  lambda: make_train_step(model, lambda o, l: o.sum(),
                                          None),
                  lambda: DataLoader([np.zeros(2)], prefetch_to_device=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_cpu_tensors_leave_every_launch_counter_at_zero():
    from paddle_tpu_torch.inference.serving import (ContinuousBatcher,
                                                    GenerationEngine,
                                                    Request)
    from paddle_tpu_torch.models import gpt_tiny
    ck.launch_counts(reset=True)
    rs = np.random.RandomState(0)
    q = torch.from_numpy(rs.randn(1, 2, 8, 16).astype(np.float32))
    ck.flash_attention(q, q, q, True)
    qg = q.clone().requires_grad_()
    ck.flash_attention_or_none(qg, qg, qg, None, True,
                               dropout_p=0.2).sum().backward()
    word = philox_word(1, 2, "cpu")
    ck.attn_dropout_bits(word, 0, 2, 8, 8)
    w, m = torch.zeros(9), torch.zeros(9)
    sc = torch.from_numpy(ck.adam_step_scalars(1e-3, 1, 0.9, 0.999))
    ck.adamw(w, w.clone(), m, m.clone(), sc, beta1=0.9, beta2=0.999,
             epsilon=1e-8, coeff=0.01)
    kc = torch.zeros(1, 2, 16, 16)
    lens = torch.tensor([3], dtype=torch.int32)
    one = q[:, :, :1]
    ck.paged_decode(one, kc, kc.clone(), lens, one, one)
    qc = torch.zeros(1, 2, 16, 16, dtype=torch.int8)
    sc = torch.zeros(1, 2, 16)
    ck.paged_decode(one, qc, qc.clone(), lens, one, one, sc, sc.clone())
    x = torch.from_numpy(rs.randn(6, 32).astype(np.float32))
    v = torch.ones(32, requires_grad=True)
    xg = x.clone().requires_grad_()
    y, z = ck.fused_bias_dropout_residual_ln(xg, x, v, v, v, 0.3, 1e-5, True,
                                             "upscale_in_train")
    (y.sum() + z.sum()).backward()
    ck.fused_bias_dropout_residual_ln(xg, x, v, None, None, 0.3, 1e-5, True,
                                      "upscale_in_train").sum().backward()
    ck.fused_dropout_bits(word, 0, 6, 32)
    ck.dropout_keep(word, 0, (6, 32), 0.3)
    from paddle_tpu_torch.framework import set_flags
    from paddle_tpu_torch.models import bert_tiny
    set_flags({"use_fused_dropout_ln": True, "fused_block": True})
    try:
        gpt_tiny(device="cpu")(torch.zeros(1, 8, dtype=torch.long)) \
            .sum().backward()
        bert_tiny(device="cpu")(torch.zeros(1, 8, dtype=torch.long))[0] \
            .sum().backward()
    finally:
        set_flags({"use_fused_dropout_ln": False, "fused_block": False})
    for kv_dtype in ("float32", "int8"):
        eng = GenerationEngine(gpt_tiny(device="cpu"), max_batch=2,
                               max_seq_len=32, prefill_buckets=(8,),
                               kv_dtype=kv_dtype, device="cpu")
        b = ContinuousBatcher(eng)
        b.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
        b.run_until_idle()
    assert set(ck.launch_counts()) == {
        "flash_fwd", "flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv",
        "attn_dropout_bits", "fused_dropout_ln_fwd",
        "fused_dropout_residual_fwd", "fused_dropout_ln_bwd",
        "fused_dropout_bits", "dropout_keep", "adamw", "paged_decode",
        "paged_decode_int8"}
    assert set(ck.launch_counts().values()) == {0}


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ck.flash_attention(q, q, q, True)
    one = q[:, :, :1]
    lens = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ck.paged_decode(one, q, q, lens, one, one)
    lse = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ck.flash_bwd_dq(q, q, q, q, q, lse, True)
    with pytest.raises(ValueError, match="meta"):
        ck.adamw(q, q, q, q, torch.zeros(3, device="meta"), beta1=0.9,
                 beta2=0.999, epsilon=1e-8, coeff=0.0)
    rows = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ck.fused_dropout_ln_bwd(rows, rows, None, None, 0.0, 1.0, 1e-5)
    with pytest.raises(ValueError, match="meta"):
        ck.fused_dropout_bits(torch.zeros(2, dtype=torch.int64,
                                          device="meta"), 0, 4, 16)


def test_kernel_sources_are_listed_for_the_build():
    from paddle_tpu_torch.ops import _build
    assert set(_build.KERNEL_SOURCES) == {"flash_fwd", "flash_bwd", "adamw",
                                          "paged_decode", "fused_dropout_ln"}
    assert set(_build._SIGNATURES) == set(_build.KERNEL_SOURCES)
    for path in _build.KERNEL_SOURCES.values():
        assert os.path.exists(path)
    flags = " ".join(_build._NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags
