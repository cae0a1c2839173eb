from .fused_transformer import (fused_bias_dropout_residual,
                                fused_bias_dropout_residual_layer_norm,
                                fused_bias_dropout_residual_ln_pair,
                                fused_feedforward,
                                fused_multi_head_attention)

__all__ = ["fused_bias_dropout_residual",
           "fused_bias_dropout_residual_layer_norm",
           "fused_bias_dropout_residual_ln_pair", "fused_feedforward",
           "fused_multi_head_attention"]
