"""fluid.io, the legacy save/load API (counterpart of
paddle_tpu/fluid/io.py) over static/io.py and framework/io.py."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..framework.io import load as _load
from ..framework.io import save as _save
from ..io import DataLoader  # noqa: F401
from ..static.io import load_inference_model as _load_inf
from ..static.io import save_inference_model as _save_inf

__all__ = ["save_inference_model", "load_inference_model",
           "save_persistables", "load_persistables", "save", "load",
           "DataLoader"]


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, **kw):
    """The legacy signature: feed names, fetch Variables, a directory."""
    from ..static import default_main_program
    prog = main_program or default_main_program()
    feed_vars = [prog.vars[n] if isinstance(n, str) else n
                 for n in feeded_var_names]
    prefix = os.path.join(dirname, model_filename or "model")
    return _save_inf(prefix, feed_vars, list(target_vars), executor,
                     program=prog)


def load_inference_model(dirname, executor=None, model_filename=None,
                         params_filename=None):
    return _load_inf(os.path.join(dirname, model_filename or "model"),
                     executor)


def _params(main_program):
    from ..static import default_main_program
    prog = main_program or default_main_program()
    return [(p.name or "param_%d" % i, p)
            for i, p in enumerate(prog.all_parameters())]


def save_persistables(executor, dirname, main_program=None, filename=None):
    _save(dict(_params(main_program)),
          os.path.join(dirname, filename or "persistables.pdparams"))


def load_persistables(executor, dirname, main_program=None, filename=None):
    sd = _load(os.path.join(dirname, filename or "persistables.pdparams"),
               device="cpu")
    for key, p in _params(main_program):
        if key in sd:
            v = sd[key]
            with torch.no_grad():
                p.copy_(torch.as_tensor(np.asarray(
                    v.numpy() if hasattr(v, "numpy") else v)))


def save(state_dict, path):
    return _save(state_dict, path)


def load(path, **cfg):
    return _load(path, **cfg)
