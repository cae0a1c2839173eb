"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX
package, its entry points run on CUDA unless the caller asks for the CPU,
and a CPU tensor never counts as a kernel launch."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

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
        "from paddle_tpu_torch import framework, models, nn, ops\n"
        "from paddle_tpu_torch.inference import serving\n"
        "from paddle_tpu_torch.observability import journal, metrics, spans\n"
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
    from paddle_tpu_torch.models import gpt2_small, gpt_tiny
    for build in (gpt_tiny, gpt2_small, resolve_device):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(1, 1, 1, 8, 8)
    model = gpt_tiny(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(model, max_batch=1, max_seq_len=32,
                         prefill_buckets=(8,))


def test_cpu_tensors_leave_every_launch_counter_at_zero():
    from paddle_tpu_torch.inference.serving import (ContinuousBatcher,
                                                    GenerationEngine,
                                                    Request)
    from paddle_tpu_torch.models import gpt_tiny
    ck.launch_counts(reset=True)
    rs = np.random.RandomState(0)
    q = torch.from_numpy(rs.randn(1, 2, 8, 16).astype(np.float32))
    ck.flash_attention(q, q, q, True)
    kc = torch.zeros(1, 2, 16, 16)
    lens = torch.tensor([3], dtype=torch.int32)
    one = q[:, :, :1]
    ck.paged_decode(one, kc, kc.clone(), lens, one, one)
    qc = torch.zeros(1, 2, 16, 16, dtype=torch.int8)
    sc = torch.zeros(1, 2, 16)
    ck.paged_decode(one, qc, qc.clone(), lens, one, one, sc, sc.clone())
    for kv_dtype in ("float32", "int8"):
        eng = GenerationEngine(gpt_tiny(device="cpu"), max_batch=2,
                               max_seq_len=32, prefill_buckets=(8,),
                               kv_dtype=kv_dtype, device="cpu")
        b = ContinuousBatcher(eng)
        b.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
        b.run_until_idle()
    assert ck.launch_counts() == {"flash_fwd": 0, "paged_decode": 0,
                                  "paged_decode_int8": 0}


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ck.flash_attention(q, q, q, True)
    one = q[:, :, :1]
    lens = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ck.paged_decode(one, q, q, lens, one, one)


def test_kernel_sources_are_listed_for_the_build():
    from paddle_tpu_torch.ops import _build
    assert set(_build.KERNEL_SOURCES) == {"flash_fwd", "paged_decode"}
    for path in _build.KERNEL_SOURCES.values():
        assert os.path.exists(path)
    flags = " ".join(_build._NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags
