"""Static-shape paged KV cache + shared-prefix reuse for the serving engine
(counterpart of paddle_tpu/inference/serving/cache.py).

The cache is preallocated at engine construction as torch buffers on the
engine's device:

    k/v: [n_layers, max_batch, n_heads, max_seq_len, head_dim]
    lens: int32 [max_batch]   (tokens already resident per slot)

Unlike the reference, whose JAX arrays are immutable and are threaded
through each jitted step and returned anew, these buffers are updated IN
PLACE: a prefill copies its K/V into the slot's rows, and each decode
step's attention kernel writes only the appended row. A slot is freed by
overwriting it on its next prefill.

  * **int8 quantized KV** (`kv_dtype="int8"`): k/v are stored as int8 with
    a float32 scale per (layer, slot, head, token), the symmetric absmax
    scheme of `quantize_kv` (defined in ops/cuda_kernels.py, beside the
    kernel that repeats it, and re-exported here).
  * **`PrefixCache`**: LRU store of bucket-aligned prompt-prefix K/V keyed
    on the token ids. Its entries are copies (`clone()`), never views of
    the paged cache, which later in-place decode steps would overwrite.

`LayerCacheView` is the per-layer window handed to `GPTAttention` in a
decode step: views of one layer's buffers, written through in place.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch

from ...framework.device import resolve_device
from ...observability import metrics
# the int8 rule sits beside the paged-decode kernel that repeats it
from ...ops.cuda_kernels import dequantize_kv, quantize_kv

__all__ = ["LayerCacheView", "PagedKVCache", "PrefixCache", "bucket_for",
           "dequantize_kv", "quantize_kv", "prefix_cache_budget"]

PREFIX_HITS = metrics.counter(
    "pt_prefix_cache_hits_total",
    "Admissions that reused a cached shared-prefix K/V")
PREFIX_MISSES = metrics.counter(
    "pt_prefix_cache_misses_total",
    "Admissions that found no cached prefix and prefilled from scratch")
PREFIX_EVICTIONS = metrics.counter(
    "pt_prefix_cache_evictions_total",
    "Prefix entries evicted by the LRU byte budget")
PREFIX_BYTES = metrics.gauge(
    "pt_prefix_cache_bytes",
    "Bytes of K/V (+scales) currently held by the prefix cache")

# env knob: default byte budget for each engine's PrefixCache; 0 disables
PREFIX_CACHE_BYTES_ENV = "PADDLE_TPU_PREFIX_CACHE_BYTES"
_PREFIX_CACHE_DEFAULT = 256 << 20


class LayerCacheView:
    """One layer's slice of the paged cache during a decode step.

    k/v: [B, n_heads, max_seq_len, head_dim] views of the cache buffers;
    lens: int32 [B]. For a quantized cache, k/v are int8 and
    k_scale/v_scale are the float32 per-(slot, head, token) scales
    [B, n_heads, max_seq_len] (None otherwise). `GPTAttention.forward`
    detects this type (duck-typed on `.lens`) and the attention writes the
    step's K/V at each slot's `lens` row through these views."""

    __slots__ = ("k", "v", "lens", "k_scale", "v_scale")

    def __init__(self, k, v, lens, k_scale=None, v_scale=None):
        self.k = k
        self.v = v
        self.lens = lens
        self.k_scale = k_scale
        self.v_scale = v_scale


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest configured prefill bucket that fits `length` tokens; a
    prompt longer than the largest bucket is a caller error (raise, don't
    silently truncate someone's context)."""
    for b in buckets:
        if length <= b:
            return int(b)
    raise ValueError(
        "prompt of %d tokens exceeds the largest prefill bucket %d; "
        "configure larger prefill_buckets (each must stay <= max_seq_len)"
        % (length, max(buckets)))


class PagedKVCache:
    """The preallocated cache buffers, updated in place by the engine.

    `kv_dtype="int8"` stores k/v as int8 plus float32 `k_scale`/`v_scale`
    side buffers of shape [n_layers, max_batch, n_heads, max_seq_len]."""

    def __init__(self, n_layers: int, max_batch: int, n_heads: int,
                 max_seq_len: int, head_dim: int, kv_dtype="float32",
                 device="cuda"):
        dev = resolve_device(device)
        self.n_layers = int(n_layers)
        self.max_batch = int(max_batch)
        self.n_heads = int(n_heads)
        self.max_seq_len = int(max_seq_len)
        self.head_dim = int(head_dim)
        self.kv_dtype = str(kv_dtype)
        if self.kv_dtype not in ("float32", "int8"):
            raise ValueError("kv_dtype must be float32 or int8, got %r"
                             % (kv_dtype,))
        self.quantized = self.kv_dtype == "int8"
        shape = (self.n_layers, self.max_batch, self.n_heads,
                 self.max_seq_len, self.head_dim)
        store = torch.int8 if self.quantized else torch.float32
        self.k = torch.zeros(shape, dtype=store, device=dev)
        self.v = torch.zeros(shape, dtype=store, device=dev)
        self.lens = torch.zeros((self.max_batch,), dtype=torch.int32,
                                device=dev)
        if self.quantized:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
            self.v_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        else:
            self.k_scale = self.v_scale = None

    @property
    def nbytes(self) -> int:
        n = self.k.nbytes + self.v.nbytes + self.lens.nbytes
        if self.quantized:
            n += self.k_scale.nbytes + self.v_scale.nbytes
        return int(n)

    def view(self, layer: int) -> LayerCacheView:
        """Layer `layer`'s buffers as a LayerCacheView (views, not copies)."""
        if self.quantized:
            return LayerCacheView(self.k[layer], self.v[layer], self.lens,
                                  self.k_scale[layer], self.v_scale[layer])
        return LayerCacheView(self.k[layer], self.v[layer], self.lens)


def prefix_cache_budget(explicit: Optional[int] = None) -> int:
    """Resolve the prefix-cache byte budget: explicit arg beats the
    PADDLE_TPU_PREFIX_CACHE_BYTES env, which beats the 256 MiB default.
    <= 0 disables reuse entirely."""
    if explicit is not None:
        return int(explicit)
    try:
        return int(os.environ.get(PREFIX_CACHE_BYTES_ENV,
                                  _PREFIX_CACHE_DEFAULT))
    except ValueError:
        return _PREFIX_CACHE_DEFAULT


class PrefixCache:
    """LRU map from bucket-aligned token-id prefixes to their K/V.

    Keys are the prompt's first `p` token ids (p a configured prefill
    bucket); values are the tensors the engine stored after a cold
    prefill: (k, v) of shape [n_layers, 1, n_heads, p, head_dim] plus
    (k_scale, v_scale) when the paged cache is quantized. A quantized
    prefix is re-inserted verbatim, never re-quantized.

    Eviction is LRU under `max_bytes` (`PADDLE_TPU_PREFIX_CACHE_BYTES`)."""

    def __init__(self, max_bytes: int, buckets: Sequence[int]):
        self.max_bytes = int(max_bytes)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._entries: "OrderedDict[Tuple[int, ...], Tuple]" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _nbytes(arrays) -> int:
        return sum(int(a.nbytes) for a in arrays)

    def lookup(self, prompt) -> Tuple[int, Optional[Tuple]]:
        """(prefix_len, arrays) for the LONGEST cached prefix of `prompt`,
        or (0, None). Only proper prefixes qualify (p < len(prompt)): a hit
        must leave >= 1 suffix token to prefill, because the first
        generated token comes out of the suffix pass."""
        n = len(prompt)
        for p in reversed(self.buckets):
            if p >= n:
                continue
            key = tuple(int(t) for t in prompt[:p])
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                PREFIX_HITS.inc()
                return p, entry
        self.misses += 1
        PREFIX_MISSES.inc()
        return 0, None

    def store(self, key_tokens, arrays) -> bool:
        """Admit a prefix under the LRU byte budget. Refreshes recency on
        re-store of an existing key. Returns whether the entry is resident
        afterwards."""
        key = tuple(int(t) for t in key_tokens)
        if key in self._entries:
            self._entries.move_to_end(key)
            return True
        size = self._nbytes(arrays)
        if size > self.max_bytes:
            return False             # bigger than the whole budget
        while self.bytes + size > self.max_bytes and self._entries:
            _, old = self._entries.popitem(last=False)
            self.bytes -= self._nbytes(old)
            self.evictions += 1
            PREFIX_EVICTIONS.inc()
        self._entries[key] = tuple(arrays)
        self.bytes += size
        PREFIX_BYTES.set(self.bytes)
        return True
