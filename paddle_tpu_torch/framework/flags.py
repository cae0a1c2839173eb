"""Global flag registry (copy of paddle_tpu/framework/flags.py:16-53).

Flags are plain typed python values seeded from FLAGS_* environment
variables at import. Only the flags the ported paths read are defined.
"""
from __future__ import annotations

import contextlib
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


def all_flags() -> Dict[str, Any]:
    """A copy of every flag's value."""
    return dict(_FLAGS)


@contextlib.contextmanager
def flags_as(values: Dict[str, Any]):
    """Run a block with the flags at `values` (an `all_flags()` reading),
    then put back what they were: a step program built under some flags
    keeps them, as a jax.jit trace keeps what it read."""
    saved = dict(_FLAGS)
    _FLAGS.update(values)
    try:
        yield
    finally:
        _FLAGS.update(saved)


define_flag("use_flash_attention", True,
            "route F.scaled_dot_product_attention to the hand-written "
            "flash-attention forward kernel (ops/csrc/flash_fwd.cu); False "
            "takes the plain PyTorch attention (path counter xla_sdpa)")
define_flag("sdpa_chunked_threshold", 2048,
            "key length at which F.scaled_dot_product_attention's plain "
            "route (the flash kernels off or not taking the call) switches "
            "to the blockwise online-softmax tier (ops/ring_attention.py, "
            "path counter xla_chunked: K/V in blocks of 512, each block "
            "recomputed in the backward, no [Tq, Tk] tensor in either "
            "pass) instead of the dense [Tq, Tk] scores. Decided per call. "
            "0 disables")
define_flag("paged_flash_decode", True,
            "route serving paged-decode attention to the hand-written "
            "paged-decode kernel (ops/csrc/paged_decode.cu: KV append, "
            "int8 quantize and dequant folded in); False takes the plain "
            "PyTorch version (path counter xla_paged)")
define_flag("use_fused_optimizer", True,
            "route Adam/AdamW updates to the hand-written fused update "
            "kernel (ops/csrc/adamw.cu: one pass over param, grad and both "
            "moments, in place); False takes the plain PyTorch rule")
define_flag("use_fused_dropout_ln", False,
            "route residual tails (residual + dropout(x + bias), then the "
            "layer norm of a post-LN tail) to the hand-written fused "
            "kernels (ops/csrc/fused_dropout_ln.cu); False takes the "
            "composed PyTorch ops")
define_flag("fused_block", False,
            "GPTDecoderLayer: the attention epilogue and ln_2 as one fused "
            "kernel pass with two outputs (the residual stream z and "
            "ln_2(z)); False takes the layer's unfused route")
define_flag("skip_nonfinite_steps", False,
            "a train step whose loss or gradients are non-finite keeps the "
            "old parameters and optimizer state (the update is skipped). "
            "The choice is made on the device inside the captured step (no "
            "host round-trip before the update); read when the step is "
            "made, as the reference reads it at trace time")
define_flag("step_watchdog_s", 0.0,
            "when > 0, wrap each train-step replay and the synchronize "
            "after it in a resilience.StepWatchdog that dumps all-thread "
            "stacks after this many seconds instead of hanging silently. "
            "0 disables")
define_flag("step_watchdog_action", "warn",
            "watchdog behavior on fire: 'warn' (dump diagnostics, keep "
            "waiting) or 'abort' (dump then os._exit(124) so a supervisor "
            "restarts the process)")
define_flag("conv_algo", "auto",
            "convolution lowering (nn.functional.conv1d/2d/3d): 'direct' "
            "(torch's convolution, cuDNN on the card, in the model's own "
            "layout), 'im2col' (the patches, then one matmul over "
            "cin*prod(kernel); groups=1, a grouped call takes 'direct' as "
            "the reference routes it), 'nhwc' (4-D NCHW convs computed in "
            "torch.channels_last) or 'auto' (= 'direct': the reference's "
            "auto picks NHWC on a TPU only); counted in "
            "pt_conv_path_total{algo}")
