"""Build the hand-written CUDA kernels at first use and load them.

Each source in ops/csrc/ is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with ctypes; no PyTorch header is
included, so a build takes seconds. Libraries go into ops/build/ (listed
in .gitignore), named by the hash of their source and of the headers in
csrc/, so an edited source is rebuilt and an unchanged one is loaded as
it is.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o ops/build/lib<name>-<hash>.so csrc/<name>.cu

Where the toolkit's nvcc offers it (`nvcc --help` lists it), each nvcc
also runs with --split-compile=0: the device compiler's optimizer works on
the source's kernels in parallel, one thread a CPU. flash_bwd.cu and
fused_dropout_ln.cu hold dozens of template instances (by element type,
head size and dropout), which one thread compiles in turn.

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

_CSRC = os.path.join(_HERE, "csrc")
KERNEL_SOURCES = {
    name: os.path.join(_CSRC, name + ".cu")
    for name in ("flash_fwd", "flash_bwd", "adamw", "paged_decode",
                 "fused_dropout_ln")}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U = ctypes.c_uint
# dropout arguments of the flash kernels: on, threshold, scale, the Philox
# word (seed, base offset) in device memory, the call's delta
_DROP = [_I, _U, _F, _P, _U]
# library -> {C entry: argtypes}
_SIGNATURES = {
    "flash_fwd": {
        # q, k, v, o, lse, strides*, B, H, Tq, Tk, D, causal, sm_scale,
        # dtype, warps, tile, dropout..., stream
        "flash_fwd": [_P] * 6 + [_I] * 6 + [_F] + [_I] * 3 + _DROP + [_P],
        # out, word, delta, BH, Tq, Tk, stream
        "attn_dropout_bits": [_P, _P, _U, _I, _I, _I, _P],
    },
    "flash_bwd": {
        # q, k, v, o, dO, lse, dq, delta, strides*, B, H, Tq, Tk, D,
        # causal, sm_scale, dtype, dropout..., stream
        "flash_bwd_dq": [_P] * 9 + [_I] * 6 + [_F, _I] + _DROP + [_P],
        # q, k, v, dO, lse, delta, dk, dv, strides*, then as flash_bwd_dq
        "flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [_F, _I] + _DROP + [_P],
    },
    "adamw": {
        # table (host memory), count, ptype, gtype, scalars (lr, c1, c2,
        # go, scale in device memory), b1, 1-b1, b2, 1-b2, eps, stream
        "adamw_multi": [_P, _I, _I, _I, _P] + [_F] * 5 + [_P],
        # out: sizeof(Table), capacity, chunk, the fields' offsets
        "adamw_table_layout": [_P],
    },
    "paged_decode": {
        # q, nk, nv, strides*, kc, vc, ks, vs, lens, out, part, ticket, B,
        # H, T, D, lanes, vec, sm_scale, quant, stream
        "paged_decode": [_P] * 12 + [_I] * 6 + [_F, _I, _P],
    },
    "fused_dropout_ln": {
        # x, res, bias, gamma, beta, y, z, n, h, dtypes, with_ln, on, thr,
        # scale, eps, word, delta, stream
        "fused_dropout_ln_fwd": [_P] * 7 + [_I] * 5 + [_U, _F, _F, _P, _U,
                                                      _P],
        # z, dy, dz_extra, gamma, dx, dres, part, sums, n, h, grid, dtypes,
        # with_ln, on, thr, scale, eps, word, delta, stream
        "fused_dropout_ln_bwd": [_P] * 8 + [_I] * 6 + [_U, _F, _F, _P, _U,
                                                      _P],
        # out, word, delta, tag, n, h, thr, mask, stream
        "fused_dropout_bits": [_P, _P, _U, _U, _I, _I, _U, _I, _P],
    },
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


_split = []


def _split_flag():
    """["--split-compile=0"] where nvcc takes it, else []: asked once."""
    if not _split:
        out = subprocess.run([_nvcc(), "--help"], capture_output=True,
                             text=True)
        _split.append(["--split-compile=0"]
                      if "--split-compile" in out.stdout else [])
    return _split[0]


def _target(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(_CSRC) if n.endswith(".cuh"))
    for path in [KERNEL_SOURCES[name]] + [os.path.join(_CSRC, n)
                                          for n in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
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
        cmd = ([_nvcc()] + _NVCC_FLAGS + _split_flag()
               + ["-o", tmp, KERNEL_SOURCES[name]])
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
            for sym, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
    return lib
