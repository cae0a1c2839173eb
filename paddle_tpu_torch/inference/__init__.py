"""Inference of the port (counterpart of paddle_tpu/inference/__init__.py):
the predictor of a saved program (`Config`, `Predictor`,
`create_predictor`, `PredictorPool`) and GPT serving (`serving`).

    from paddle_tpu_torch.inference import Config, create_predictor

    pred = create_predictor(Config("model.pdmodel", "model.pdiparams"))
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(images)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()

A predictor loads the program (static.load_inference_model: this
package's files or the reference's, read without importing the JAX
package) and runs it as the static Executor runs a forward program: one
program an input signature (each feed's shape and dtype), on the card a
CUDA graph captured at the signature's first run and replayed after.
`Config.enable_mkldnn_bfloat16()` runs it in bfloat16, as the
reference's does: every float32 weight and feed cast to bfloat16, the
outputs back to float32. The members of a `PredictorPool` share the
program, the weights and the graphs; each keeps its own feeds and
results, and one member runs at a time.

Not ported: `Predictor.export_stablehlo` (the reference's XLA export;
ROADMAP.md).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.tensor import Tensor
from ..static.executor import _Interpreter, _StaticRunStep, _as_feed
from ..static.io import load_inference_model
from . import serving

__all__ = ["Config", "Predictor", "create_predictor", "PredictorPool",
           "serving"]


class Config:
    """reference: paddle_analysis_config.h AnalysisConfig. The place is the
    current place (the card unless set_device("cpu")) unless
    `enable_use_gpu` or `disable_gpu` chose one; the knobs of other
    backends are accepted and do nothing."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[:-len(".pdmodel")]
        self._prefix = prog_file
        self._bf16 = False
        self._device = None

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = "cuda:%d" % device_id

    def disable_gpu(self):
        self._device = "cpu"

    def enable_mkldnn_bfloat16(self):
        self._bf16 = True

    def enable_mkldnn(self):
        pass

    def switch_ir_optim(self, flag=True):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def enable_memory_optim(self):
        pass

    def model_dir(self):
        return self._prefix

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def params_file(self):
        return (self._prefix or "") + ".pdiparams"


class _ZeroCopyTensor:
    """A predictor's input or output handle (reference: ZeroCopyTensor)."""

    def __init__(self, name, owner):
        self.name = name
        self._owner = owner

    def copy_from_cpu(self, arr):
        self._owner._feeds[self.name] = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        """A host copy of the output. From the card it lands in pinned
        memory (torch's caching host allocator reuses a block the caller
        has dropped): no page faults on a fresh buffer, a full-rate
        copy."""
        t = self._owner._results[self.name]
        if t.device.type != "cuda":
            return Tensor.wrap(t).numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host.numpy()

    def shape(self):
        v = self._owner._results.get(self.name)
        if v is None:
            v = self._owner._feeds.get(self.name)
        return list(np.shape(v)) if not isinstance(v, torch.Tensor) \
            else list(v.shape)


class Predictor:
    """reference: analysis_predictor.h. One program an input signature,
    kept built (see the module's note)."""

    def __init__(self, config: Config):
        self._config = config
        dev = resolve_device(config._device)
        program, feed_names, fetch_names = load_inference_model(
            config._prefix, device=dev)
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._feeds: Dict[str, np.ndarray] = {}
        self._results: Dict[str, torch.Tensor] = {}
        caps = [(program.capture_names[i], t)
                for i, t in program.captured.items()]
        cast = torch.bfloat16 if config._bf16 else None
        if cast is not None:
            caps = [(n, t.to(cast) if t.dtype == torch.float32 else t)
                    for n, t in caps]
        net = _Interpreter(program.ops, feed_names, fetch_names, caps,
                           aliases=program.aliases, cast=cast)
        self._step = _StaticRunStep(net, None, dev)
        self._lock = threading.Lock()

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name) -> _ZeroCopyTensor:
        return _ZeroCopyTensor(name, self)

    def get_output_handle(self, name) -> _ZeroCopyTensor:
        return _ZeroCopyTensor(name, self)

    @property
    def programs(self):
        """The `StepPrograms` of this predictor (and of its pool): builds
        and replays by input signature."""
        return self._step.programs

    def run(self, inputs: Optional[Sequence] = None):
        """Run on the handles' feeds, or on `inputs` (arrays in the order of
        get_input_names()); returns the outputs as port Tensors (copies
        that outlive the next run) and keeps them for the output
        handles."""
        if inputs is not None:
            for n, a in zip(self._feed_names, inputs):
                self._feeds[n] = a
        feeds = [_as_feed(self._feeds[n]) for n in self._feed_names]
        with self._lock:
            _, outs = self._step.run(feeds)
        self._results = dict(zip(self._fetch_names, outs))
        return [Tensor.wrap(o) for o in outs]

    def _share_clone(self) -> "Predictor":
        """A pool member sharing this predictor's program, weights, built
        programs and lock; its feeds and results are its own."""
        clone = object.__new__(Predictor)
        clone.__dict__.update(self.__dict__)
        clone._feeds = {}
        clone._results = {}
        return clone


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class PredictorPool:
    """reference: paddle_inference_api.h PredictorPool: `size` members,
    the first loads the model, the rest share it (`_share_clone`)."""

    def __init__(self, config: Config, size: int = 1):
        first = Predictor(config)
        self._preds = [first] + [first._share_clone()
                                 for _ in range(size - 1)]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]
