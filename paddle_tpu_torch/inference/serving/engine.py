"""Generation engine: bucketed prefill + fixed-shape decode over the paged
KV cache (counterpart of paddle_tpu/inference/serving/engine.py).

Same host API as the reference: `prefill(slot, prompt)` admits a prompt
and returns its first generated token, `decode()` advances every slot by
one token. The work runs eagerly under `torch.no_grad()`:

  * prefill: the prompt is right-padded to its bucket (exact under the
    causal mask: pad columns sit to the right of every real query), runs
    through the model with zero-length legacy caches, so attention takes
    the flash kernel, and its per-layer K/V is copied into the slot;
  * suffix prefill: on a `PrefixCache` hit only the suffix runs, over the
    stored prefix K/V (plain bottom-right causal attention), and both
    halves are copied into the slot; the stored prefix is re-inserted
    verbatim (int8 payload and scales included);
  * decode: one [max_batch, 1] step for every slot; the paged-decode
    kernel appends each layer's K/V in place and attends over the live
    rows, and per-slot progress lives in `lens`, never in shapes.

The reference's JAX machinery has no counterpart here: no weight swapping,
no jit or donation (the cache is updated in place instead), no compile
cache, step telemetry or memory profiler.

Inactive slots keep decoding garbage into their clamped tail, by design:
the scheduler ignores tokens from slots it has not admitted.
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework.device import resolve_device
from ...models.gpt import _lm_logits
from ...observability import metrics
from . import cache as cache_mod

__all__ = ["GenerationEngine"]

PREFILL_BUCKET_HITS = metrics.counter(
    "pt_serve_prefill_bucket_total",
    "Prefills served per prompt-length bucket", labelnames=("bucket",))


class GenerationEngine:
    """Greedy decoding over a static-shape paged KV cache.

    Host API (used by the scheduler):
      prefill(slot, prompt) -> first generated token (admits a request)
      decode() -> np.int32[max_batch], next token for every slot

    `kv_dtype="int8"` swaps the paged cache for the quantized layout;
    `prefix_cache` is the shared-prefix store (None disables reuse; byte
    budget from the `prefix_cache_bytes` arg or
    PADDLE_TPU_PREFIX_CACHE_BYTES). After every `prefill()` the engine
    leaves `admit_info` (prefix_len/bucket of that admission) for the
    scheduler's `serve_admit` journal event. The model must already lie on
    `device`.
    """

    def __init__(self, model, max_batch=4, max_seq_len=128,
                 prefill_buckets=(32, 64, 128), pad_id=0,
                 kv_dtype="float32", prefix_cache_bytes=None,
                 device="cuda"):
        self.device = resolve_device(device)
        gpt = getattr(model, "gpt", model)
        if not hasattr(gpt, "layers") or not hasattr(gpt, "embeddings"):
            raise TypeError(
                "GenerationEngine expects a GPTForPretraining (or GPTModel);"
                " got %r" % type(model).__name__)
        wdev = gpt.embeddings.word_embeddings.weight.device
        if wdev.type != self.device.type:
            raise ValueError("the model lies on %s but the engine runs on "
                             "%s; move the model first" % (wdev, self.device))
        model.eval()
        self.model = model
        self._gpt = gpt
        self._n_layers = len(gpt.layers)
        attn = gpt.layers[0].attn
        self._n_heads = attn.num_heads
        self._head_dim = attn.head_dim
        self._max_pos = gpt.embeddings.position_embeddings.weight.shape[0]

        buckets = sorted(set(int(b) for b in prefill_buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError("prefill_buckets must be positive ints")
        if max_seq_len > self._max_pos:
            raise ValueError(
                "max_seq_len %d exceeds the model's position table (%d)"
                % (max_seq_len, self._max_pos))
        if buckets[-1] > max_seq_len:
            raise ValueError(
                "largest prefill bucket %d exceeds max_seq_len %d"
                % (buckets[-1], max_seq_len))
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self.buckets = tuple(buckets)
        self.pad_id = int(pad_id)
        self.bucket_hits = {b: 0 for b in self.buckets}

        self.kv = cache_mod.PagedKVCache(
            self._n_layers, self.max_batch, self._n_heads,
            self.max_seq_len, self._head_dim, kv_dtype=kv_dtype,
            device=self.device)
        self._last = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                                 device=self.device)
        budget = cache_mod.prefix_cache_budget(prefix_cache_bytes)
        self.prefix_cache = (cache_mod.PrefixCache(budget, self.buckets)
                             if budget > 0 else None)
        self.admit_info = {"prefix_len": 0, "bucket": 0}

    # -- cache plumbing ---------------------------------------------------

    def _insert_kv(self, kvs, tl, slot, offset=0, prefix=None):
        """Copy fresh float K/V (per layer [1, nh, T', hd], quantized first
        when the cache is int8) into the slot at row `offset`, preceded by
        a verbatim stored `prefix` at row 0, and set the slot's length."""
        kv = self.kv
        ks = torch.stack([c[0][0] for c in kvs])          # [L, nh, T', hd]
        vs = torch.stack([c[1][0] for c in kvs])
        end = offset + ks.shape[2]
        if prefix is not None:
            p = prefix[0].shape[3]
            kv.k[:, slot, :, :p] = prefix[0][:, 0]
            kv.v[:, slot, :, :p] = prefix[1][:, 0]
            if kv.quantized:
                kv.k_scale[:, slot, :, :p] = prefix[2][:, 0]
                kv.v_scale[:, slot, :, :p] = prefix[3][:, 0]
        if kv.quantized:
            ks, ks_sc = cache_mod.quantize_kv(ks)
            vs, vs_sc = cache_mod.quantize_kv(vs)
            kv.k_scale[:, slot, :, offset:end] = ks_sc
            kv.v_scale[:, slot, :, offset:end] = vs_sc
        kv.k[:, slot, :, offset:end] = ks.to(kv.k.dtype)
        kv.v[:, slot, :, offset:end] = vs.to(kv.v.dtype)
        kv.lens[slot] = tl

    def _logits(self, hidden):
        """Tied-head logits [B, 1, vocab] of the rows that pick tokens."""
        return _lm_logits(hidden, self._gpt.embeddings.word_embeddings.weight)

    def _first_token(self, hidden, row, slot):
        """Greedy token from `hidden[:, row]`; also becomes the slot's
        next decode input."""
        logits = self._logits(hidden[:, row:row + 1])
        tok = torch.argmax(logits[0, 0]).to(torch.int32)
        self._last[slot, 0] = tok
        return int(tok)

    def _ids(self, tokens, width):
        padded = np.full((1, width), self.pad_id, np.int64)
        padded[0, :len(tokens)] = tokens
        return torch.from_numpy(padded).to(self.device)

    # -- host API ---------------------------------------------------------

    def bucket_for(self, length: int) -> int:
        return cache_mod.bucket_for(length, self.buckets)

    def _suffix_bucket(self, suffix_len: int, prefix_len: int):
        """Smallest bucket holding the suffix such that prefix+bucket still
        fits the cache time axis; None -> fall back to a cold prefill."""
        for b in self.buckets:
            if b >= suffix_len and prefix_len + b <= self.max_seq_len:
                return b
        return None

    def prefill(self, slot: int, prompt) -> int:
        """Admit a prompt into `slot`; returns its first generated token.

        Consults the PrefixCache first: on a hit only the suffix runs
        through the model; on a miss the full bucketed prefill runs and the
        prompt's largest bucket-aligned head is stored for the next request
        that shares it. `admit_info` is left describing this admission."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        n = int(prompt.shape[0])
        if n < 1:
            raise ValueError("empty prompt")
        if not 0 <= slot < self.max_batch:
            raise ValueError("slot %d out of range" % slot)
        reused, entry, sb = 0, None, None
        if self.prefix_cache is not None:
            reused, entry = self.prefix_cache.lookup(prompt)
            if entry is not None:
                sb = self._suffix_bucket(n - reused, reused)
                if sb is None:
                    reused, entry = 0, None
        if entry is not None:
            tok = self._suffix_prefill(slot, prompt, n, reused, entry, sb)
            self.admit_info = {"prefix_len": reused, "bucket": sb}
            return tok
        b = self.bucket_for(n)
        self.bucket_hits[b] += 1
        PREFILL_BUCKET_HITS.labels(str(b)).inc()
        gpt = self._gpt
        with torch.no_grad():
            zero = torch.zeros((1, self._n_heads, 0, self._head_dim),
                               device=self.device)
            hidden, kvs = gpt(self._ids(prompt, b), None,
                              [(zero, zero)] * self._n_layers)
            tok = self._first_token(hidden, n - 1, slot)
            self._insert_kv(kvs, n, slot)
            if self.prefix_cache is not None:
                self._store_prefix(prompt, n, slot)
        self.admit_info = {"prefix_len": 0, "bucket": b}
        return tok

    def _suffix_prefill(self, slot, prompt, n, p, entry, sb) -> int:
        self.bucket_hits[sb] += 1
        PREFILL_BUCKET_HITS.labels(str(sb)).inc()
        with torch.no_grad():
            if self.kv.quantized:
                pkf = cache_mod.dequantize_kv(entry[0], entry[2])
                pvf = cache_mod.dequantize_kv(entry[1], entry[3])
            else:
                pkf, pvf = entry[0], entry[1]
            legacy = [(pkf[i], pvf[i]) for i in range(self._n_layers)]
            pos = torch.arange(sb, device=self.device) + p
            hidden, kvs = self._gpt(self._ids(prompt[p:], sb), pos, legacy)
            # hidden covers only the suffix: its true last row is n - p - 1
            tok = self._first_token(hidden, n - p - 1, slot)
            # kvs are prefix+suffix concats; keep only the fresh suffix
            fresh = [(k[:, :, p:], v[:, :, p:]) for k, v in kvs]
            self._insert_kv(fresh, n, slot, offset=p, prefix=entry)
        return tok

    def _store_prefix(self, prompt, n: int, slot: int) -> None:
        """Copy the slot's freshly prefilled K/V head (largest bucket <=
        prompt length) into the PrefixCache. Copies, not views: later
        in-place decode steps overwrite the slot."""
        p_store = 0
        for b in self.buckets:
            if b <= n:
                p_store = b
        if not p_store:
            return
        s = int(slot)
        bufs = [self.kv.k, self.kv.v]
        if self.kv.quantized:
            bufs += [self.kv.k_scale, self.kv.v_scale]
        arrays = [t[:, s:s + 1, :, :p_store].clone() for t in bufs]
        self.prefix_cache.store(prompt[:p_store], arrays)

    def decode(self) -> np.ndarray:
        """One decode step for the whole batch; next token per slot."""
        kv = self.kv
        gpt = self._gpt
        with torch.no_grad():
            views = [kv.view(i) for i in range(self._n_layers)]
            # the new token's absolute position == tokens already resident,
            # clamped so idle slots that hit the wall index a real row
            pos = torch.clamp(kv.lens, max=self._max_pos - 1)[:, None]
            hidden, _ = gpt(self._last, pos, views)
            tok = torch.argmax(self._logits(hidden),
                               dim=-1).to(torch.int32)            # [B, 1]
            kv.lens.copy_(torch.clamp(kv.lens + 1, max=self.max_seq_len))
            self._last = tok
        return tok.cpu().numpy().reshape(-1)
