"""Generation engine: bucketed prefill + compile-once decode over the paged
KV cache (counterpart of paddle_tpu/inference/serving/engine.py).

Same host API as the reference: `prefill(slot, prompt)` admits a prompt
and returns its first generated token, `decode()` advances every slot by
one token. Three program families cover all of decoding, as the
reference's three jitted executables do:

  * prefill(bucket): one program per prompt-length bucket. The prompt is
    right-padded to the bucket (exact under the causal mask: pad columns
    sit to the right of every real query), runs through the model with
    zero-length legacy caches, so attention takes the flash kernel, and
    its per-layer K/V is copied into the slot inside the same program;
  * suffix prefill(prefix_len, bucket): on a `PrefixCache` hit only the
    suffix runs, over the stored prefix K/V (plain bottom-right causal
    attention), and both halves are copied into the slot; the stored
    prefix is re-inserted verbatim (int8 payload and scales included).
    One program per (prefix length, suffix bucket) pair;
  * decode: ONE program. Every slot runs the same [max_batch, 1] step;
    the paged-decode kernel appends each layer's K/V in place and attends
    over the live rows, and per-slot progress lives in `lens`, never in
    shapes.

`jit/cuda_graph.StepPrograms` builds each program once, on CUDA as a
captured CUDA graph that every later call replays, on the CPU as the
same body run eagerly under the same counters (`prefill_compiles`,
`suffix_prefill_compiles`, `decode_compiles`). The bodies read and write
only the engine's static device buffers: the token ids of each bucket,
`slot` and `true_len` as int64 device scalars, the next decode input
`_last`, the paged cache with its kernel workspace, and the prefix
buffers of each prefix length. The host copies a request's values into
them before a dispatch; slot and length are device values, never host
indices, so one prefill program serves every slot and every prompt length
of its bucket, as the reference's traced scalars do. Where the reference
donates its cache and gets new buffers back, the port updates the cache
in place. Flags are read when a program is built and stay frozen in it.
`_DISPATCH_LOCK` serializes every dispatch and capture in the process.

Every program run is wrapped in `StepTelemetry("serve_prefill" |
"serve_suffix" | "serve_decode")` keyed by the program, so
`pt_jit_retraces_total{engine}` counts the programs built, as the
reference's counts its traces. Each program built is banked in memprof
(held tensors as argument bytes, the graphs' pool as temp bytes), and an
out-of-memory error leaves memprof's post-mortem before it unwinds.

Eager outside the programs, as in the reference: the bucket counters,
`admit_info` and the prefix store's copies.

Inactive slots keep decoding garbage into their clamped tail, by design:
the scheduler ignores tokens from slots it has not admitted.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ...framework.device import resolve_device
from ...jit.cuda_graph import StepPrograms
from ...models.gpt import _lm_logits
from ...observability import memprof, metrics, tracing
from . import cache as cache_mod

__all__ = ["GenerationEngine"]

PREFILL_BUCKET_HITS = metrics.counter(
    "pt_serve_prefill_bucket_total",
    "Prefills served per prompt-length bucket", labelnames=("bucket",))

# One process-wide lock around every dispatch and capture: a capture must
# not interleave with another engine's work, and server workers sharing a
# model dispatch one at a time.
_DISPATCH_LOCK = threading.Lock()


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
    `device`; its weights may be reloaded in place (`copy_`) between calls,
    never rebound.
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

        dev = self.device
        self.kv = cache_mod.PagedKVCache(
            self._n_layers, self.max_batch, self._n_heads,
            self.max_seq_len, self._head_dim, kv_dtype=kv_dtype, device=dev)
        # the programs' static inputs and outputs
        self._last = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                                 device=dev)
        self._ids = {b: torch.full((1, b), self.pad_id, dtype=torch.int64,
                                   device=dev) for b in self.buckets}
        self._slot = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._true_len = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._prefix = {}                   # prefix length -> its buffers
        # what the programs hold, listed without a reference back to the
        # engine, so that dropping the engine frees its graphs and pool
        held = (list(model.parameters()) + list(model.buffers())
                + [*self.kv.state(), *self.kv.workspace])
        self._programs = StepPrograms(dev, lambda: held)
        self._held = held
        self._prefill_tel = tracing.StepTelemetry("serve_prefill")
        self._suffix_tel = tracing.StepTelemetry("serve_suffix")
        self._decode_tel = tracing.StepTelemetry("serve_decode")
        budget = cache_mod.prefix_cache_budget(prefix_cache_bytes)
        self.prefix_cache = (cache_mod.PrefixCache(budget, self.buckets)
                             if budget > 0 else None)
        self.admit_info = {"prefix_len": 0, "bucket": 0}

    # -- program bodies ---------------------------------------------------

    def _run(self, key, body):
        """Dispatch the program `key`, built from `body` on first use."""
        self._programs(key, body)

    def _dispatch(self, tel, signature, key, body):
        """`_run` under `tel`'s span (caller holds `_DISPATCH_LOCK`). A
        program built by this call is banked in memprof; an OOM leaves its
        post-mortem (host-side reads and files only) before it unwinds."""
        built = key in self._programs.builds
        try:
            with tel.step(signature):
                self._run(key, body)
        except Exception as e:
            if memprof.is_oom(e):
                memprof.on_oom(tel.engine, e)
            raise
        if not built and key in self._programs.builds:
            analysis = memprof.analysis_from_arrays(self._held)
            if self.device.type == "cuda":
                pool = self._programs.pool_bytes()
                analysis.update(source="cuda_graph", temp_bytes=pool,
                                total_bytes=analysis["total_bytes"] + pool)
            memprof.bank_executable(tel.engine, analysis)

    def _insert_kv(self, kvs, offset=0, prefix=None):
        """Copy fresh float K/V (per layer [1, nh, T', hd], quantized first
        when the cache is int8) into slot `_slot` at row `offset`, preceded
        by a verbatim stored `prefix` at row 0, and set the slot's length
        to `_true_len`."""
        kv, slot = self.kv, self._slot
        ks = torch.stack([c[0] for c in kvs])             # [L, 1, nh, T', hd]
        vs = torch.stack([c[1] for c in kvs])
        end = offset + ks.shape[3]
        if prefix is not None:
            p = prefix[0].shape[3]
            kv.k[:, :, :, :p].index_copy_(1, slot, prefix[0])
            kv.v[:, :, :, :p].index_copy_(1, slot, prefix[1])
            if kv.quantized:
                kv.k_scale[..., :p].index_copy_(1, slot, prefix[2])
                kv.v_scale[..., :p].index_copy_(1, slot, prefix[3])
        if kv.quantized:
            ks, ks_sc = cache_mod.quantize_kv(ks)
            vs, vs_sc = cache_mod.quantize_kv(vs)
            kv.k_scale[..., offset:end].index_copy_(1, slot, ks_sc)
            kv.v_scale[..., offset:end].index_copy_(1, slot, vs_sc)
        kv.k[:, :, :, offset:end].index_copy_(1, slot, ks.to(kv.k.dtype))
        kv.v[:, :, :, offset:end].index_copy_(1, slot, vs.to(kv.v.dtype))
        kv.lens.index_copy_(0, slot, self._true_len.to(torch.int32))

    def _logits(self, hidden):
        """Tied-head logits [B, 1, vocab] of the rows that pick tokens."""
        return _lm_logits(hidden, self._gpt.embeddings.word_embeddings.weight)

    def _first_token(self, hidden, row):
        """Greedy token of `hidden[:, row]` (`row` a device index [1])
        becomes slot `_slot`'s next decode input."""
        logits = self._logits(hidden.index_select(1, row))   # [1, 1, vocab]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._last.index_copy_(0, self._slot, tok)

    def _prefill_fn(self, b):
        zero = torch.zeros((1, self._n_heads, 0, self._head_dim),
                           device=self.device)
        hidden, kvs = self._gpt(self._ids[b], None,
                                [(zero, zero)] * self._n_layers)
        self._first_token(hidden, self._true_len - 1)
        self._insert_kv(kvs)

    def _suffix_fn(self, p, sb):
        prefix = self._prefix[p]
        if self.kv.quantized:
            pkf = cache_mod.dequantize_kv(prefix[0], prefix[2])
            pvf = cache_mod.dequantize_kv(prefix[1], prefix[3])
        else:
            pkf, pvf = prefix[0], prefix[1]
        legacy = [(pkf[i], pvf[i]) for i in range(self._n_layers)]
        pos = torch.arange(sb, device=self.device) + p
        hidden, kvs = self._gpt(self._ids[sb], pos, legacy)
        # hidden covers only the suffix: its true last row is n - p - 1
        self._first_token(hidden, self._true_len - (p + 1))
        # kvs are prefix+suffix concats; keep only the fresh suffix
        fresh = [(k[:, :, p:], v[:, :, p:]) for k, v in kvs]
        self._insert_kv(fresh, offset=p, prefix=prefix)

    def _decode_fn(self):
        kv = self.kv
        views = [kv.view(i) for i in range(self._n_layers)]
        # the new token's absolute position == tokens already resident,
        # clamped so idle slots that hit the wall index a real row
        pos = torch.clamp(kv.lens, max=self._max_pos - 1)[:, None]
        hidden, _ = self._gpt(self._last, pos, views)
        tok = torch.argmax(self._logits(hidden), dim=-1).to(torch.int32)
        kv.lens.copy_(torch.clamp(kv.lens + 1, max=self.max_seq_len))
        self._last.copy_(tok)                                  # [B, 1]

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

    def _feed(self, width, tokens, true_len, slot):
        """Host values into the static inputs: `tokens` right-padded to
        `width`, the slot and the prompt's true length."""
        padded = np.full((1, width), self.pad_id, np.int64)
        padded[0, :len(tokens)] = tokens
        self._ids[width].copy_(torch.from_numpy(padded))
        self._slot.fill_(int(slot))
        self._true_len.fill_(int(true_len))

    def prefill(self, slot: int, prompt) -> int:
        """Admit a prompt into `slot`; returns its first generated token.

        Consults the PrefixCache first: on a hit only the suffix runs through
        the model; on a miss the full bucketed prefill runs and the prompt's
        largest bucket-aligned head is stored for the next request that
        shares it. `admit_info` is left describing this admission."""
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
        with _DISPATCH_LOCK, torch.no_grad():
            self._feed(b, prompt, n, slot)
            self._dispatch(self._prefill_tel, ("prefill", b),
                           ("prefill", b), lambda: self._prefill_fn(b))
            tok = int(self._last[slot, 0])
            if self.prefix_cache is not None:
                self._store_prefix(prompt, n, slot)
        self.admit_info = {"prefix_len": 0, "bucket": b}
        return tok

    def _suffix_prefill(self, slot, prompt, n, p, entry, sb) -> int:
        """The stored prefix is copied into the prefix buffers of its
        length, which every suffix program of that length reads; the entry
        stays resident in the PrefixCache."""
        self.bucket_hits[sb] += 1
        PREFILL_BUCKET_HITS.labels(str(sb)).inc()
        with _DISPATCH_LOCK, torch.no_grad():
            if p not in self._prefix:
                self._prefix[p] = tuple(torch.empty_like(a) for a in entry)
            for buf, a in zip(self._prefix[p], entry):
                buf.copy_(a)
            self._feed(sb, prompt[p:], n, slot)
            self._dispatch(self._suffix_tel, ("suffix", p, sb),
                           ("suffix", p, sb), lambda: self._suffix_fn(p, sb))
            return int(self._last[slot, 0])

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
        arrays = [t[:, s:s + 1, :, :p_store].clone()
                  for t in self.kv.state()[:-1]]           # all but lens
        self.prefix_cache.store(prompt[:p_store], arrays)

    def decode(self) -> np.ndarray:
        """One decode step for the whole batch; next token per slot."""
        with _DISPATCH_LOCK, torch.no_grad():
            self._dispatch(self._decode_tel, "decode", ("decode",),
                           self._decode_fn)
            tok = self._last.cpu()
        return tok.numpy().reshape(-1)

    # -- compile-once contract accounting ---------------------------------

    def _built(self, family) -> int:
        return sum(1 for key in self._programs.builds if key[0] == family)

    @property
    def prefill_compiles(self) -> int:
        """Cold-prefill programs built (<= number of buckets)."""
        return self._built("prefill")

    @property
    def suffix_prefill_compiles(self) -> int:
        """Suffix programs built, one per (prefix length, suffix bucket)
        pair seen; apart from prefill_compiles, so that count stays <= the
        number of buckets."""
        return self._built("suffix")

    @property
    def decode_compiles(self) -> int:
        """Decode programs built (must stay 1)."""
        return self._built("decode")
