"""Models of the port."""
from .convert import load_reference_state
from .gpt import (GPT_CONFIGS, GPTForPretraining, GPTModel, gpt2_small,
                  gpt_tiny)

__all__ = ["GPT_CONFIGS", "GPTForPretraining", "GPTModel", "gpt2_small",
           "gpt_tiny", "load_reference_state"]
