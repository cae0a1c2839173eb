"""GPT serving on the port: static-shape paged KV cache, bucketed-prefill
and decode engine, continuous-batching scheduler, SLO admission control
and a threaded multi-worker front end:

    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.inference.serving import InferenceServer

    model = gpt2_small(seed=0)                      # on "cuda"
    with InferenceServer(model, max_batch=8, max_seq_len=512,
                         prefill_buckets=(32, 128, 256)) as srv:
        tokens = srv.submit(prompt_ids, max_new_tokens=64).result(60)

One engine without the front end: `GenerationEngine` behind a
`ContinuousBatcher` (`batcher.submit(Request(...))`, `run_until_idle()`).
"""
from .cache import (LayerCacheView, PagedKVCache, PrefixCache, bucket_for,
                    dequantize_kv, quantize_kv)
from .engine import GenerationEngine
from .scheduler import ContinuousBatcher, Request, run_open_loop
from .server import InferenceServer, ServeHandle
from .slo import (AdmissionController, ShedError, SLOPolicy, VirtualClock,
                  WindowedPercentile)

__all__ = ["LayerCacheView", "PagedKVCache", "PrefixCache", "bucket_for",
           "dequantize_kv", "quantize_kv", "GenerationEngine",
           "ContinuousBatcher", "Request", "run_open_loop",
           "InferenceServer", "ServeHandle", "SLOPolicy",
           "AdmissionController", "ShedError", "VirtualClock",
           "WindowedPercentile"]
