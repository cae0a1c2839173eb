"""Global flag registry (copy of paddle_tpu/framework/flags.py:16-53).

Flags are plain typed python values seeded from FLAGS_* environment
variables at import. Only the flags the serving path reads are defined.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_FLAGS: Dict[str, Any] = {}


def define_flag(name: str, default, help_str: str = ""):
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _FLAGS[name] = value
    return value


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for f in flags:
        key = f[6:] if f.startswith("FLAGS_") else f
        if key not in _FLAGS:
            raise ValueError(f"unknown flag {f!r}")
        out[f] = _FLAGS[key]
    return out


def set_flags(flags: Dict[str, Any]):
    for f, v in flags.items():
        key = f[6:] if f.startswith("FLAGS_") else f
        if key not in _FLAGS:
            raise ValueError(f"unknown flag {f!r}")
        _FLAGS[key] = v


def flag(name: str):
    return _FLAGS[name]


define_flag("use_flash_attention", True,
            "route F.scaled_dot_product_attention to the hand-written "
            "flash-attention forward kernel (ops/csrc/flash_fwd.cu); False "
            "takes the plain PyTorch attention (path counter xla_sdpa)")
define_flag("paged_flash_decode", True,
            "route serving paged-decode attention to the hand-written "
            "paged-decode kernel (ops/csrc/paged_decode.cu: KV append, "
            "int8 quantize and dequant folded in); False takes the plain "
            "PyTorch version (path counter xla_paged)")
