"""The port's compile-once serving programs against the JAX engine, on the CPU.

On the CPU `jit/cuda_graph.StepPrograms` runs each step body eagerly under
the same keyed bookkeeping it keeps on CUDA, where the body is a captured
CUDA graph. So the contract of the reference's jitted executables holds
here: one prefill program per bucket, one suffix program per (prefix
length, suffix bucket) pair, exactly one decode program, with the same
tokens as the JAX engine on the same weights and prompts (tiny GPT of
`tests/test_serving.py`, weights carried across with
`load_reference_state`, prompts from numpy seeds). The device-indexed
cache writes are held bit for bit to the host-index slice assignment
they replace.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.serving import engine as tengine
from paddle_tpu_torch.jit.cuda_graph import StepPrograms
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

VOCAB = 64
SHAPE = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = jgpt_tiny(**SHAPE)
    ref.eval()
    port = tgpt_tiny(device="cpu", seed=1, **SHAPE)
    load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    port.eval()
    return ref, port


def _prompt(rs, n):
    return rs.randint(0, VOCAB, (n,)).astype(np.int64)


def _run_waves(serving, eng, waves):
    """Serve each wave of (prompt, max_new) through one batcher, the wave
    run to idle before the next; returns [(tokens, prefix_len)]."""
    b = serving.ContinuousBatcher(eng)
    out = []
    for wave in waves:
        reqs = [b.submit(serving.Request(prompt=p.copy(), max_new_tokens=m))
                for p, m in wave]
        b.run_until_idle()
        out += [(list(r.tokens), r.prefix_len) for r in reqs]
    return out


def _compile_once_waves():
    # tests/test_serving.py TestCompileOnce: five requests over buckets
    # (4, 8, 16), then three waves through the dirty slots
    rs = np.random.RandomState(2)
    first = [(_prompt(rs, n), m)
             for n, m in [(3, 5), (5, 3), (7, 4), (12, 6), (16, 2)]]
    return [first] + [[(_prompt(rs, 4), 3)] for _ in range(3)]


def test_compile_once_parity_with_the_jax_engine(models):
    ref, port = models
    cfg = dict(max_batch=2, max_seq_len=48, prefill_buckets=(4, 8, 16))
    waves = _compile_once_waves()
    engines, got = {}, {}
    for name, serving, model, dev in (("jax", jserving, ref, {}),
                                      ("port", tserving, port,
                                       {"device": "cpu"})):
        eng = serving.GenerationEngine(model, **cfg, **dev)
        got[name] = _run_waves(serving, eng, waves[:1])
        assert eng.decode_compiles == 1
        assert eng.prefill_compiles == 3
        got[name] += _run_waves(serving, eng, waves[1:])
        assert eng.decode_compiles == 1
        assert eng.prefill_compiles == 3
        engines[name] = eng
    assert engines["port"].bucket_hits == engines["jax"].bucket_hits \
        == {4: 4, 8: 2, 16: 2}
    assert got["port"] == got["jax"]
    programs = engines["port"]._programs
    assert set(programs.builds) == {("prefill", 4), ("prefill", 8),
                                    ("prefill", 16), ("decode",)}
    # every prefill after a bucket's first replays its program
    assert {k: programs.runs(k) for k in programs.builds
            if k[0] == "prefill"} == {("prefill", 4): 4, ("prefill", 8): 2,
                                      ("prefill", 16): 2}


def _suffix_waves():
    rs = np.random.RandomState(11)
    head8, head16 = _prompt(rs, 8), _prompt(rs, 16)
    cold = _prompt(rs, 12)
    div = cold.copy()
    div[7] = (div[7] + 1) % VOCAB        # diverges before the 8 boundary
    return [
        [(np.concatenate([head8, _prompt(rs, 4)]), 3)],   # stores head8
        [(np.concatenate([head8, _prompt(rs, 3)]), 4)],   # hit (8, 8)
        [(np.concatenate([head8, _prompt(rs, 2)]), 2)],   # hit (8, 8) again
        [(np.concatenate([head16, _prompt(rs, 3)]), 3)],  # miss, stores 16
        [(np.concatenate([head16, _prompt(rs, 5)]), 2)],  # hit (16, 8)
        [(cold, 2)], [(div, 2)],                          # misaligned: miss
        [(cold[:8], 2)],                 # equals a stored prefix: miss
    ]


def test_suffix_programs_one_per_pair_as_the_jax_engine(models):
    ref, port = models
    cfg = dict(max_batch=2, max_seq_len=32, prefill_buckets=(8, 16, 24),
               prefix_cache_bytes=32 << 20)
    waves = _suffix_waves()
    counts, got = {}, {}
    for name, serving, model, dev in (("jax", jserving, ref, {}),
                                      ("port", tserving, port,
                                       {"device": "cpu"})):
        eng = serving.GenerationEngine(model, **cfg, **dev)
        got[name] = _run_waves(serving, eng, waves[:5])
        after_hits = eng.suffix_prefill_compiles
        got[name] += _run_waves(serving, eng, waves[5:])
        counts[name] = (after_hits, eng.suffix_prefill_compiles,
                        eng.prefill_compiles, eng.decode_compiles,
                        eng.prefix_cache.hits)
    assert [p for _, p in got["port"]] == [0, 8, 8, 0, 16, 0, 0, 0]
    assert counts["port"] == counts["jax"] == (2, 2, 3, 1, 3)
    assert got["port"] == got["jax"]


def test_int8_engine_builds_one_decode_program(models):
    _, port = models
    eng = tserving.GenerationEngine(port, max_batch=2, max_seq_len=32,
                                    prefill_buckets=(8, 16, 24),
                                    kv_dtype="int8",
                                    prefix_cache_bytes=32 << 20,
                                    device="cpu")
    out = _run_waves(tserving, eng, _suffix_waves())
    assert [p for _, p in out] == [0, 8, 8, 0, 16, 0, 0, 0]
    assert eng.kv.quantized
    assert eng.decode_compiles == 1
    assert eng.prefill_compiles == 3
    assert eng.suffix_prefill_compiles == 2
    assert eng._programs.replays[("decode",)] > 10


# -- device-indexed writes --------------------------------------------------


def _filled_engine(port, kv_dtype, seed):
    """A CPU engine whose cache, lens and next inputs hold random values."""
    eng = tserving.GenerationEngine(port, max_batch=3, max_seq_len=16,
                                    prefill_buckets=(4, 8), kv_dtype=kv_dtype,
                                    device="cpu")
    g = torch.Generator().manual_seed(seed)
    state = []
    for buf in eng.kv.state():
        if buf.dtype == torch.int8:
            state.append(torch.randint(-127, 128, buf.shape, generator=g,
                                       dtype=torch.int8))
        elif buf.dtype == torch.int32:
            state.append(torch.randint(0, 17, buf.shape, generator=g,
                                       dtype=torch.int32))
        else:
            state.append(torch.randn(buf.shape, generator=g))
    eng.kv.set_state(state)
    eng._last.copy_(torch.randint(0, VOCAB, eng._last.shape, generator=g))
    return eng, g


def _host_index_insert(kv, kvs, tl, slot, offset=0, prefix=None):
    """The engine's cache insert before its programs: host-index slices
    (slot and length as python ints), on `kv`'s state in place."""
    ks = torch.stack([c[0][0] for c in kvs])
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
        ks, ks_sc = tserving.quantize_kv(ks)
        vs, vs_sc = tserving.quantize_kv(vs)
        kv.k_scale[:, slot, :, offset:end] = ks_sc
        kv.v_scale[:, slot, :, offset:end] = vs_sc
    kv.k[:, slot, :, offset:end] = ks.to(kv.k.dtype)
    kv.v[:, slot, :, offset:end] = vs.to(kv.v.dtype)
    kv.lens[slot] = tl


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("slot", [0, 2])
@pytest.mark.parametrize("offset,with_prefix", [(0, False), (4, True)])
def test_device_indexed_insert_writes_what_host_slices_wrote(
        models, kv_dtype, slot, offset, with_prefix):
    _, port = models
    eng, g = _filled_engine(port, kv_dtype, seed=slot + 7 * offset)
    kv = eng.kv
    want = tserving.PagedKVCache(kv.n_layers, kv.max_batch, kv.n_heads,
                                 kv.max_seq_len, kv.head_dim, kv_dtype,
                                 device="cpu")
    want.set_state([t.clone() for t in kv.state()])
    L, H, D = kv.n_layers, kv.n_heads, kv.head_dim
    kvs = [(torch.randn(1, H, 8, D, generator=g),
            torch.randn(1, H, 8, D, generator=g)) for _ in range(L)]
    prefix = None
    if with_prefix:                      # a stored entry: [L, 1, H, p, D]
        shape = (L, 1, H, offset, D)
        if kv.quantized:
            prefix = tuple(torch.randint(-127, 128, shape, generator=g,
                                         dtype=torch.int8) for _ in range(2))
            prefix += tuple(torch.rand(shape[:-1], generator=g)
                            for _ in range(2))
        else:
            prefix = tuple(torch.randn(shape, generator=g) for _ in range(2))
    tl = offset + 5
    eng._slot.fill_(slot)
    eng._true_len.fill_(tl)
    eng._insert_kv(kvs, offset, prefix)
    _host_index_insert(want, kvs, tl, slot, offset, prefix)
    for got_t, want_t in zip(kv.state(), want.state()):
        assert got_t.dtype == want_t.dtype
        assert torch.equal(got_t, want_t)


@pytest.mark.parametrize("slot", [0, 1, 2])
def test_first_token_writes_only_its_slot(models, slot):
    _, port = models
    eng, g = _filled_engine(port, "float32", seed=slot)
    hidden = torch.randn(1, 8, SHAPE["hidden_size"], generator=g)
    before = eng._last.clone()
    eng._slot.fill_(slot)
    eng._first_token(hidden, torch.tensor([5]))
    want = before.clone()
    want[slot, 0] = torch.argmax(eng._logits(hidden[:, 5:6])[0, 0])
    assert torch.equal(eng._last, want)


def test_prefill_program_serves_every_slot_and_length_of_its_bucket(models):
    # one program for bucket 8, prompts of 5-8 tokens into slots 2, 0, 1:
    # each slot's rows, scales and lens equal a fresh engine's single
    # prefill of that prompt into that slot
    _, port = models
    cfg = dict(max_batch=3, max_seq_len=16, prefill_buckets=(8,),
               kv_dtype="int8", device="cpu")
    rs = np.random.RandomState(5)
    prompts = [(2, _prompt(rs, 5)), (0, _prompt(rs, 8)), (1, _prompt(rs, 6))]
    eng = tserving.GenerationEngine(port, **cfg)
    toks = [eng.prefill(s, p) for s, p in prompts]
    assert eng.prefill_compiles == 1
    assert eng._programs.replays[("prefill", 8)] == 2
    for (s, p), tok in zip(prompts, toks):
        solo = tserving.GenerationEngine(port, **cfg)
        assert solo.prefill(s, p) == tok
        *rows, lens = eng.kv.state()
        *solo_rows, solo_lens = solo.kv.state()
        assert lens[s] == solo_lens[s] == len(p)
        for got_t, want_t in zip(rows, solo_rows):
            assert torch.equal(got_t[:, s], want_t[:, s])


# -- cache state ------------------------------------------------------------


def test_cache_state_roundtrip_arity_dtype_and_addresses():
    # tests/test_serving.py TestCacheState, plus: set_state copies into the
    # buffers the programs hold
    kv = tserving.PagedKVCache(2, 2, 2, 8, 4, device="cpu")
    st = kv.state()
    assert len(st) == 3
    ptrs = [t.data_ptr() for t in st]
    kv.set_state(st)                      # single-tuple form
    kv.set_state(*st)                     # splatted form
    kv8 = tserving.PagedKVCache(2, 2, 2, 8, 4, kv_dtype="int8", device="cpu")
    st8 = kv8.state()
    assert len(st8) == 5                  # scales travel with values
    kv8.set_state(st8)
    assert kv8.nbytes == 512 + 512 + 8
    with pytest.raises(ValueError, match="expects 5 arrays"):
        kv8.set_state(st)
    with pytest.raises(ValueError, match="dtype"):
        kv.set_state(st8[0], st8[1], st[2])
    with pytest.raises(ValueError, match="shape"):
        kv.set_state(torch.zeros(2, 2, 2, 4, 4), st[1], st[2])
    new = (torch.randn(st[0].shape), torch.randn(st[1].shape),
           torch.arange(2, dtype=torch.int32))
    kv.set_state(new)
    assert [t.data_ptr() for t in kv.state()] == ptrs
    for got_t, want_t in zip(kv.state(), new):
        assert torch.equal(got_t, want_t)


def test_cache_owns_the_paged_workspace_and_views_carry_it():
    kv = tserving.PagedKVCache(2, 3, 4, 100, 64, device="cpu")
    part, tickets = kv.workspace
    # the smallest chunk either geometry takes: 32 keys (single floats)
    assert ck.paged_workspace_numel(3, 4, 100, 64) == (3 * 4 * 4 * 66, 12)
    assert part.numel() == 3 * 4 * 4 * 66 and part.dtype == torch.float32
    assert tickets.numel() == 12 and tickets.dtype == torch.int32
    assert not tickets.any()
    view = kv.view(1)
    assert view.workspace is kv.workspace
    assert view.k.data_ptr() == kv.k[1].data_ptr()


def test_paged_decode_checks_a_callers_workspace():
    rs = np.random.RandomState(0)
    B, H, T, D = 2, 3, 40, 8
    q, nk, nv = (torch.from_numpy(rs.randn(B, H, 1, D).astype(np.float32))
                 for _ in range(3))
    kc = torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32))
    vc = torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32))
    lens = torch.tensor([3, 39], dtype=torch.int32)
    part, tickets = ck.paged_workspace_numel(B, H, T, D)
    ws = (torch.zeros(part), torch.zeros(tickets, dtype=torch.int32))
    args = (q, kc.clone(), vc.clone(), lens, nk, nv)
    out = ck.paged_decode(*args, workspace=ws)
    want = ck.paged_decode_plain(q, kc.clone(), vc.clone(), lens, nk, nv)
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="workspace"):
        ck.paged_decode(*args, workspace=(torch.zeros(1), ws[1]))
    with pytest.raises(ValueError, match="workspace"):
        ck.paged_decode(*args, workspace=(ws[0], ws[1].float()))


# -- program bookkeeping ----------------------------------------------------


def test_step_programs_build_once_per_key_and_count():
    w = torch.zeros(3)
    out = torch.zeros(1)
    progs = StepPrograms("cpu", lambda: [w, out])
    calls = []

    def body(tag):
        calls.append(tag)
        out.add_(1)
    for tag in ("a", "b", "a", "a", "b"):
        progs(("k", tag), lambda: body(tag))
    assert calls == ["a", "b", "a", "a", "b"]        # eager on the CPU
    assert out.item() == 5
    assert progs.builds == {("k", "a"): 1, ("k", "b"): 1}
    assert progs.replays == {("k", "a"): 2, ("k", "b"): 1}
    assert progs.runs(("k", "a")) == 3 and progs.runs(("k", "c")) == 0
    assert progs.capture_s == {("k", "a"): 0.0, ("k", "b"): 0.0}
    assert all(not any(d.values()) for d in progs.launches.values())
    assert progs.pool_bytes() is None


def test_step_programs_keep_the_flags_of_their_build():
    seen = []
    progs = StepPrograms("cpu", lambda: [])
    body = lambda: seen.append(flags.flag("paged_flash_decode"))  # noqa
    saved = flags.get_flags(["paged_flash_decode"])
    try:
        flags.set_flags({"paged_flash_decode": False})
        progs("k", body)
        flags.set_flags({"paged_flash_decode": True})
        progs("k", body)
        progs("k2", body)
        assert flags.flag("paged_flash_decode") is True
    finally:
        flags.set_flags(saved)
    assert seen == [False, False, True]


def test_step_programs_raise_when_a_held_tensor_moved():
    w = torch.zeros(4)
    progs = StepPrograms("cpu", lambda: [w])
    progs("k", lambda: None)
    w.copy_(torch.ones(4))                 # a load in place is fine
    progs("k", lambda: None)
    w.data = torch.zeros(4)                # rebound: its address moved
    with pytest.raises(RuntimeError, match="moved"):
        progs("k", lambda: None)
    with pytest.raises(RuntimeError, match="moved"):
        progs("other", lambda: None)


def test_engine_sees_a_weight_copy_and_refuses_a_rebound_weight(models):
    _, port = models
    model = tgpt_tiny(device="cpu", seed=3, **SHAPE)
    model.load_state_dict(port.state_dict())
    eng = tserving.GenerationEngine(model, max_batch=2, max_seq_len=16,
                                    prefill_buckets=(8,), device="cpu")
    eng.prefill(0, [1, 2, 3])
    eng.decode()
    w = model.gpt.ln_f.weight
    with torch.no_grad():
        w.copy_(w * 2.0)
    eng.decode()
    w.data = w.detach().clone()
    with pytest.raises(RuntimeError, match="moved"):
        eng.decode()


def test_launch_accounting_adds_and_takes_back_deltas():
    before = ck.launch_counts()
    ck.add_launches({"paged_decode": 3, "flash_fwd": 1}, times=2)
    delta = ck.launch_delta(before)
    assert delta["paged_decode"] == 6 and delta["flash_fwd"] == 2
    assert sum(delta.values()) == 8
    ck.add_launches(delta, -1)
    assert ck.launch_counts() == before


def test_every_dispatch_holds_the_dispatch_lock(models):
    _, port = models
    held = []

    class Probe(tserving.GenerationEngine):
        def _run(self, key, body):
            held.append((key[0], tengine._DISPATCH_LOCK.locked()))
            super()._run(key, body)
    eng = Probe(port, max_batch=2, max_seq_len=32, prefill_buckets=(8, 16),
                prefix_cache_bytes=1 << 20, device="cpu")
    rs = np.random.RandomState(3)
    head = _prompt(rs, 8)
    eng.prefill(0, np.concatenate([head, _prompt(rs, 2)]))
    eng.prefill(1, np.concatenate([head, _prompt(rs, 3)]))
    eng.decode()
    assert held == [("prefill", True), ("suffix", True), ("decode", True)]
    assert not tengine._DISPATCH_LOCK.locked()


def test_engines_in_threads_give_their_solo_tokens(models):
    # four engines on one model, each served from its own thread with a
    # short switch interval: the dispatch lock keeps each program run (and
    # the flags it runs under) whole, so every engine gives the tokens it
    # gives alone
    import sys
    import threading
    _, port = models
    rs = np.random.RandomState(21)
    waves = [[[(_prompt(rs, n), 4) for n in (3, 9)]] for _ in range(4)]

    def serve(wave):
        eng = tserving.GenerationEngine(port, max_batch=2, max_seq_len=32,
                                        prefill_buckets=(8, 16),
                                        device="cpu")
        return _run_waves(tserving, eng, wave)
    want = [serve(w) for w in waves]
    got = [None] * len(waves)

    def worker(i):
        got[i] = serve(waves[i])
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(waves))]
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert got == want
