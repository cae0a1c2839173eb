"""Models of the port."""
from .convert import export_reference_state, load_reference_state
from .gpt import (GPT_CONFIGS, GPTForPretraining, GPTModel,
                  GPTPretrainingCriterion, ParallelCrossEntropy, gpt2_small,
                  gpt_tiny)

__all__ = ["GPT_CONFIGS", "GPTForPretraining", "GPTModel",
           "GPTPretrainingCriterion", "ParallelCrossEntropy", "gpt2_small",
           "gpt_tiny", "load_reference_state", "export_reference_state"]
