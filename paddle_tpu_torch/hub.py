"""paddle.hub (counterpart of paddle_tpu/hub.py): models from a local
directory holding a hubconf.py (`source="local"`); the github and gitee
sources raise, as the reference's do, since they need the network."""
from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, "hubconf.py")
    if not os.path.exists(path):
        raise FileNotFoundError("no hubconf.py under %s" % repo_dir)
    spec = importlib.util.spec_from_file_location("paddle_hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.pop(0)
    return mod


def _check_source(source):
    if source != "local":
        raise NotImplementedError(
            "paddle.hub source=%r needs the network; use source='local' "
            "with a directory holding hubconf.py" % (source,))


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    """The public callables of the directory's hubconf.py."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    _check_source(source)
    return getattr(_load_hubconf(repo_dir), model).__doc__


def load(repo_dir, model, *args, source="local", force_reload=False,
         **kwargs):
    """hubconf.<model>(*args, **kwargs)."""
    _check_source(source)
    return getattr(_load_hubconf(repo_dir), model)(*args, **kwargs)
