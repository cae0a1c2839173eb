"""Training step of the port (counterpart of paddle_tpu/jit)."""
from .engine import make_train_step

__all__ = ["make_train_step"]
