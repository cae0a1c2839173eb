"""High-level API (the port's counterpart of paddle_tpu/hapi): `Model`,
its callbacks, and `flops` / `summary`."""
from . import callbacks  # noqa: F401
from .flops import flops, summary  # noqa: F401
from .model import InputSpec, Model  # noqa: F401

__all__ = ["Model", "InputSpec", "callbacks", "flops", "summary"]
