"""The PyTorch port's GPT serving slice against the JAX package, on the CPU.

One `gpt_tiny`-shaped model is built in the JAX package, its weights are
carried to the port with `load_reference_state`, and the same inputs go
through both. The JAX engine runs its paged-decode kernel in Pallas
interpret mode (FLAGS_paged_flash_interpret) and its prefill through the
interpret-mode flash kernel; the port runs its kernels' plain versions.
Logits are held at atol 1e-4 (float32 through two layers, summed in
different orders); greedy tokens must be equal.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.ops import cuda_kernels as ck

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


@pytest.fixture
def jax_interpret():
    saved = get_flags(["paged_flash_decode", "paged_flash_interpret"])
    set_flags({"paged_flash_decode": True, "paged_flash_interpret": True})
    yield
    set_flags(saved)


@pytest.mark.parametrize("T", [7, 24, 64])
def test_forward_logits_match(models, T):
    ref, port = models
    ids = np.random.RandomState(T).randint(0, VOCAB, (2, T))
    want = ref(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, T, VOCAB)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_convert_rejects_missing_and_misshaped_weights(models):
    ref, port = models
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    bad = dict(state)
    bad.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="gpt.ln_f.bias"):
        load_reference_state(port, bad)
    bad = dict(state)
    bad["gpt.ln_f.bias"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="gpt.ln_f.bias"):
        load_reference_state(port, bad)


def _greedy(serving, model, kv_dtype, steps=16, **dev):
    eng = serving.GenerationEngine(model, max_batch=2, max_seq_len=32,
                                   prefill_buckets=(8,), kv_dtype=kv_dtype,
                                   **dev)
    rs = np.random.RandomState(4)
    toks = [[int(eng.prefill(s, rs.randint(1, VOCAB, (5,)).tolist()))]
            for s in range(2)]
    for _ in range(steps - 1):
        out = eng.decode()
        for s in range(2):
            toks[s].append(int(out[s]))
    return toks


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_engine_greedy_tokens_match(models, jax_interpret, kv_dtype):
    ref, port = models
    before = ck.attention_path_counts()
    got = _greedy(tserving, port, kv_dtype, device="cpu")
    after = ck.attention_path_counts()
    assert after["paged_flash"] > before["paged_flash"]
    assert after["flash"] > before["flash"]
    assert after["xla_paged"] == before["xla_paged"]
    assert after["xla_sdpa"] == before["xla_sdpa"]
    assert got == _greedy(jserving, ref, kv_dtype)


def _serve(serving, model, reqs, **dev):
    eng = serving.GenerationEngine(model, max_batch=2, max_seq_len=32,
                                   prefill_buckets=(8, 16, 24),
                                   prefix_cache_bytes=16 << 20, **dev)
    b = serving.ContinuousBatcher(eng)
    rs = [serving.Request(prompt=p.copy(), max_new_tokens=n)
          for p, n in reqs]
    for r in rs:
        b.submit(r)
    b.run_until_idle()
    return [(list(r.tokens), r.prefix_len) for r in rs]


def test_batcher_prefix_hit_and_mid_flight_admission(models, jax_interpret):
    # three requests on two slots: the third is admitted mid-flight; the
    # second shares a 16-token head with the first and is a prefix HIT,
    # admitted through the suffix prefill
    ref, port = models
    rs = np.random.RandomState(8)
    head = rs.randint(1, VOCAB, (16,))
    reqs = [(np.concatenate([head, rs.randint(1, VOCAB, (3,))]), 5),
            (np.concatenate([head, rs.randint(1, VOCAB, (4,))]), 7),
            (rs.randint(1, VOCAB, (6,)), 9)]
    got = _serve(tserving, port, reqs, device="cpu")
    assert [p for _, p in got] == [0, 16, 0]
    assert [len(t) for t, _ in got] == [5, 7, 9]
    assert got == _serve(jserving, ref, reqs)


def test_flags_off_take_the_plain_paths_with_equal_tokens(models):
    _, port = models
    want = _greedy(tserving, port, "float32", device="cpu")
    from paddle_tpu_torch.framework import flags
    saved = flags.get_flags(["use_flash_attention", "paged_flash_decode"])
    flags.set_flags({"use_flash_attention": False,
                     "paged_flash_decode": False})
    try:
        before = ck.attention_path_counts()
        got = _greedy(tserving, port, "float32", device="cpu")
        after = ck.attention_path_counts()
    finally:
        flags.set_flags(saved)
    assert after["flash"] == before["flash"]
    assert after["paged_flash"] == before["paged_flash"]
    assert after["xla_sdpa"] > before["xla_sdpa"]
    assert after["xla_paged"] > before["xla_paged"]
    assert got == want


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_stored_prefix_survives_the_slot_being_reused(models, kv_dtype):
    # the prefix cache holds copies: a later prefill into the same slot
    # overwrites the slot, never the stored prefix
    _, port = models
    eng = tserving.GenerationEngine(port, max_batch=1, max_seq_len=32,
                                    prefill_buckets=(8, 16),
                                    kv_dtype=kv_dtype,
                                    prefix_cache_bytes=16 << 20,
                                    device="cpu")
    rs = np.random.RandomState(2)
    eng.prefill(0, rs.randint(1, VOCAB, (12,)))
    (entry,) = eng.prefix_cache._entries.values()
    bufs = [eng.kv.k, eng.kv.v] + (
        [eng.kv.k_scale, eng.kv.v_scale] if eng.kv.quantized else [])
    for stored, buf in zip(entry, bufs):
        torch.testing.assert_close(stored, buf[:, 0:1, :, :8], rtol=0,
                                   atol=0)
    snapshot = [t.clone() for t in entry]
    eng.prefill(0, rs.randint(1, VOCAB, (12,)))
    for _ in range(3):
        eng.decode()
    for stored, snap in zip(entry, snapshot):
        torch.testing.assert_close(stored, snap, rtol=0, atol=0)


def test_decode_clamps_lens_and_positions_at_the_wall(models):
    # an idle slot keeps decoding past max_seq_len: lens stays at the wall
    # and the step stays finite
    _, port = models
    eng = tserving.GenerationEngine(port, max_batch=2, max_seq_len=16,
                                    prefill_buckets=(8,), device="cpu")
    eng.prefill(0, [1, 2, 3])
    for _ in range(20):
        out = eng.decode()
    assert eng.kv.lens.tolist() == [16, 16]
    assert np.all((out >= 0) & (out < VOCAB))


def test_training_mode_dropout_is_refused_until_ported():
    model = tgpt_tiny(device="cpu", **SHAPE)
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="model.eval"):
        model(ids)
    model.eval()
    assert model(ids).shape == (1, 4, VOCAB)
