"""Vision models of the port (counterpart of paddle_tpu/vision)."""
from . import models

__all__ = ["models"]
