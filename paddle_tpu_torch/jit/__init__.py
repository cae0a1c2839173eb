"""Training step and compile-once step programs of the port (counterpart
of paddle_tpu/jit)."""
from .cuda_graph import StepPrograms
from .engine import TrainStep, make_train_step

__all__ = ["StepPrograms", "TrainStep", "make_train_step"]
