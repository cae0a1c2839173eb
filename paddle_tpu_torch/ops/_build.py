"""Build the hand-written CUDA kernels at first use and load them.

Each source in ops/csrc/ is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with ctypes; no PyTorch header is
included, so a build takes seconds. Libraries go into ops/build/ (listed
in .gitignore), named by the hash of their source, so an edited source is
rebuilt and an unchanged one is loaded as it is.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o ops/build/lib<name>-<hash>.so csrc/<name>.cu

There is deliberately no --use_fast_math: the int8 append must equal
cuda_kernels.quantize_kv bit for bit (IEEE division, rintf). Every
pointer and the stream are declared c_void_p, and each C entry returns
cudaGetLastError(), which the wrappers check.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

__all__ = ["KERNEL_SOURCES", "BUILD_DIR", "build", "load", "build_logs"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")

KERNEL_SOURCES = {
    "flash_fwd": os.path.join(_HERE, "csrc", "flash_fwd.cu"),
    "paged_decode": os.path.join(_HERE, "csrc", "paged_decode.cu"),
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, strides*, B, H, Tq, Tk, D, causal, sm_scale, dtype, stream
    "flash_fwd": ("flash_fwd",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
    # q, nk, nv, strides*, kc, vc, ks, vs, lens, out, B, H, T, D,
    # sm_scale, quant, stream
    "paged_decode": ("paged_decode",
                     [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _F, _I, _P]),
}

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are built from ops/csrc/ on the machine with the GPU")
    return found


def _target(name: str) -> str:
    with open(KERNEL_SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest))


def build(names: Iterable[str] = None) -> float:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns the wall seconds spent; raises
    with the compiler's output when a build fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = out + ".tmp%d" % os.getpid()
        cmd = [_nvcc()] + _NVCC_FLAGS + ["-o", tmp, KERNEL_SOURCES[name]]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        _logs[name] = log
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def build_logs() -> Dict[str, str]:
    """nvcc output (ptxas register and shared-memory report) per kernel
    built by this process."""
    return dict(_logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name))
            sym, argtypes = _SIGNATURES[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
    return lib
