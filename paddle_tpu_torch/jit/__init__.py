"""Training and evaluation steps and compile-once step programs of the
port (counterpart of paddle_tpu/jit)."""
from .cuda_graph import StepPrograms
from .engine import EvalStep, TrainStep, make_eval_step, make_train_step

__all__ = ["StepPrograms", "TrainStep", "make_train_step", "EvalStep",
           "make_eval_step"]
