"""Models of the port."""
from .bert import (BERT_CONFIGS, BertForPretraining, BertModel,
                   BertPretrainingCriterion, ErnieModel, bert_base,
                   bert_tiny, ernie_base)
from .convert import (export_reference_state, load_reference_state,
                      pack_qkv)
from .gpt import (GPT_CONFIGS, GPTForPretraining, GPTModel,
                  GPTPretrainingCriterion, ParallelCrossEntropy, gpt2_small,
                  gpt_tiny)

__all__ = ["BERT_CONFIGS", "BertForPretraining", "BertModel",
           "BertPretrainingCriterion", "ErnieModel", "bert_base",
           "bert_tiny", "ernie_base", "GPT_CONFIGS", "GPTForPretraining",
           "GPTModel", "GPTPretrainingCriterion", "ParallelCrossEntropy",
           "gpt2_small", "gpt_tiny", "load_reference_state",
           "export_reference_state", "pack_qkv"]
