"""GPT serving on the port: static-shape paged KV cache, bucketed-prefill
and decode engine, continuous-batching scheduler and SLO admission control.

    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.inference.serving import (ContinuousBatcher,
                                                    GenerationEngine,
                                                    Request)

    model = gpt2_small(seed=0)                      # on "cuda"
    eng = GenerationEngine(model, max_batch=8, max_seq_len=512,
                           prefill_buckets=(32, 128, 256))
    batcher = ContinuousBatcher(eng)
    req = batcher.submit(Request(prompt=[1, 2, 3], max_new_tokens=16))
    batcher.run_until_idle()                        # req.tokens filled
"""
from .cache import (LayerCacheView, PagedKVCache, PrefixCache, bucket_for,
                    dequantize_kv, quantize_kv)
from .engine import GenerationEngine
from .scheduler import ContinuousBatcher, Request, run_open_loop
from .slo import (AdmissionController, ShedError, SLOPolicy, VirtualClock,
                  WindowedPercentile)

__all__ = ["LayerCacheView", "PagedKVCache", "PrefixCache", "bucket_for",
           "dequantize_kv", "quantize_kv", "GenerationEngine",
           "ContinuousBatcher", "Request", "run_open_loop", "SLOPolicy",
           "AdmissionController", "ShedError", "VirtualClock",
           "WindowedPercentile"]
