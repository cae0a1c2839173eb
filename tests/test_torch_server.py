"""The port's InferenceServer against the JAX InferenceServer, on the CPU.

The request sequences of `tests/test_serving.py::TestServer` and
`tests/test_slo.py::TestServerShedding` run through both servers on the
same tiny GPT (weights carried across with `load_reference_state`,
prompts from numpy seeds): the same tokens, one prefill and one decode
program, an over-long request failing only its own handle, two workers
giving the tokens of one. A crash drill kills a worker's decode on its
third call: its handles fail with the cause chained, a crash bundle with
the reference's six files appears under PADDLE_TPU_FLIGHT_DIR, and the
live plane's /healthz answers 503 naming the dead worker, then 200 after
`stop()`. Every HTTP server binds port 0 and is shut down in a finally.
"""
import glob
import json
import os
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.observability import httpd as jhttpd
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.observability import flight, httpd

jax.config.update("jax_platforms", "cpu")

VOCAB = 64
SHAPE = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64)
BUNDLE_FILES = {"MANIFEST.json", "ring.jsonl", "stacks.txt", "metrics.json",
                "env.json", "memory.json"}


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


def _server(side, models, **kw):
    ref, port = models
    if side == "jax":
        return jserving.InferenceServer(ref, **kw)
    return tserving.InferenceServer(port, device="cpu", **kw)


def _prompt(rs, n):
    return rs.randint(0, VOCAB, (n,)).astype(np.int64)


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _staggered(srv):
    """test_serving.py TestServer's sequence: four staggered requests,
    then an over-long one (fails its handle) and a good one."""
    rs = np.random.RandomState(8)
    handles = []
    for i in range(4):
        handles.append(srv.submit(_prompt(rs, 3 + i).tolist(),
                                  max_new_tokens=3))
        time.sleep(0.01)
    results = [h.result(timeout=120) for h in handles]
    bad = srv.submit([1] * 30, max_new_tokens=8)          # over max_seq
    good = srv.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(RuntimeError):
        bad.result(timeout=60)
    return results + [good.result(timeout=120)]


def test_staggered_requests_match_the_jax_server(models):
    got = {}
    for side in ("jax", "port"):
        srv = _server(side, models, max_batch=2, max_seq_len=32,
                      prefill_buckets=(8,), workers=1)
        with srv:
            got[side] = _staggered(srv)
        eng = srv.engines[0]
        assert eng.decode_compiles == 1
        assert eng.prefill_compiles == 1
    assert [len(r) for r in got["port"]] == [3, 3, 3, 3, 2]
    assert got["port"] == got["jax"]


def test_submit_before_start_raises(models):
    srv = _server("port", models, max_batch=1, max_seq_len=16,
                  prefill_buckets=(8,))
    with pytest.raises(RuntimeError):
        srv.submit([1, 2], max_new_tokens=1)


def _burst(srv, n=6):
    rs = np.random.RandomState(3)
    handles = [srv.submit(_prompt(rs, 2 + 2 * i).tolist(), max_new_tokens=4)
               for i in range(n)]
    return [h.result(timeout=120) for h in handles]


def test_two_workers_give_the_tokens_of_one(models):
    got = {}
    for side, workers in (("jax", 1), ("port", 1), ("port", 2)):
        srv = _server(side, models, max_batch=2, max_seq_len=32,
                      prefill_buckets=(8, 16), workers=workers)
        with srv:
            got[side, workers] = _burst(srv)
        assert len(srv.engines) == workers
        assert all(e.decode_compiles <= 1 for e in srv.engines)
    assert got["port", 2] == got["port", 1] == got["jax", 1]


def test_more_workers_than_cores_lose_no_update(models):
    """Every worker shares the queue, the dispatch lock and the metrics:
    under a short switch interval no request, token or count is lost."""
    from paddle_tpu_torch.inference.serving import scheduler
    workers = min(len(os.sched_getaffinity(0)) + 1, 33)
    rs = np.random.RandomState(5)
    prompts = [_prompt(rs, 2 + i % 7).tolist() for i in range(3 * workers)]
    counted = (scheduler.ADMITTED, scheduler.COMPLETED, scheduler.TOKENS)
    before = [c.value for c in counted]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        srv = _server("port", models, max_batch=2, max_seq_len=32,
                      prefill_buckets=(8,), workers=workers)
        with srv:
            handles = [srv.submit(p, max_new_tokens=3) for p in prompts]
            got = [h.result(timeout=300) for h in handles]
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in srv._threads)
    n = len(prompts)
    assert [c.value - b for c, b in zip(counted, before)] == [n, n, 3 * n]
    one = _server("port", models, max_batch=2, max_seq_len=32,
                  prefill_buckets=(8,), workers=1)
    with one:
        want = [one.submit(p, max_new_tokens=3).result(timeout=300)
                for p in prompts]
    assert got == want


def test_shed_error_through_handle(models):
    # tests/test_slo.py TestServerShedding, on the port
    pol = tserving.SLOPolicy(ttft_budget_ms=1e6, max_queue_depth=1)
    srv = _server("port", models, max_batch=1, max_seq_len=32,
                  prefill_buckets=(8,), workers=1, poll_s=0.001, slo=pol)
    with srv:
        handles = [srv.submit([1, 2, 3], max_new_tokens=8)
                   for _ in range(12)]
        results, sheds = [], []
        for h in handles:
            try:
                results.append(h.result(timeout=120))
            except tserving.ShedError as e:
                sheds.append(e)
        assert sheds, "no request was shed by the burst"
        assert all(e.retry_after_s > 0 for e in sheds)
        assert all(e.reason in ("queue_full", "deadline_expired")
                   for e in sheds)
        assert results, "no request completed during the burst"
        again = srv.submit([1, 2, 3], max_new_tokens=2)
        assert len(again.result(timeout=120)) == 2


class _InjectedFault(RuntimeError):
    pass


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_crash_drill_bundle_and_healthz(models, tmp_path, monkeypatch):
    monkeypatch.setenv(flight.ENV_DIR, str(tmp_path))
    for var in (httpd.ENV_PORT, "PADDLE_TPU_HEARTBEAT_DIR"):
        monkeypatch.delenv(var, raising=False)
    flight.reset()
    httpd.shutdown()
    srv = _server("port", models, max_batch=2, max_seq_len=32,
                  prefill_buckets=(8,), workers=1, http_port=0)
    eng = srv.engines[0]
    decode, calls = eng.decode, []

    def failing_decode():
        calls.append(1)
        if len(calls) == 3:
            raise _InjectedFault("injected decode fault")
        return decode()
    eng.decode = failing_decode
    try:
        srv.start()
        url = srv._http.url
        handles = [srv.submit([1, 2, 3 + i], max_new_tokens=8)
                   for i in range(2)]
        for h in handles:
            with pytest.raises(RuntimeError) as ei:
                h.result(timeout=60)
            assert isinstance(ei.value.__cause__, _InjectedFault)
        deadline = time.time() + 10
        while srv._threads[0].is_alive() and time.time() < deadline:
            time.sleep(0.01)
        assert not srv._threads[0].is_alive()
        code, body = _get(url + "/healthz")
        assert code == 503
        check = json.loads(body)["checks"]["serve_loop"]
        assert not check["ok"]
        assert "dead serving worker(s): pt-serve-0" in check["detail"]
        srv.stop()
        code, _ = _get(url + "/healthz")
        assert code == 200                 # a stopped server is not sick
    finally:
        srv.stop()
        httpd.shutdown()
        flight.reset()
    bundles = glob.glob(os.path.join(str(tmp_path), "crash", "*"))
    assert len(bundles) == 1
    assert set(os.listdir(bundles[0])) == BUNDLE_FILES
    with open(os.path.join(bundles[0], "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["reason"] == "serve_loop"
    assert "injected decode fault" in manifest["error"]
    with open(os.path.join(bundles[0], "memory.json")) as f:
        memory = json.load(f)
    assert set(memory["executables"]) >= {"serve_prefill", "serve_decode"}


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_jax_crash_bundle_has_the_same_files(models, tmp_path, monkeypatch):
    """The reference's bundle for the same drill, as the port's must read."""
    from paddle_tpu.observability import flight as jflight
    monkeypatch.setenv(jflight.ENV_DIR, str(tmp_path))
    jflight.reset()
    jhttpd.shutdown()
    srv = _server("jax", models, max_batch=2, max_seq_len=32,
                  prefill_buckets=(8,), workers=1)
    eng = srv.engines[0]
    decode, calls = eng.decode, []

    def failing_decode():
        calls.append(1)
        if len(calls) == 3:
            raise _InjectedFault("injected decode fault")
        return decode()
    eng.decode = failing_decode
    try:
        srv.start()
        h = srv.submit([1, 2, 3], max_new_tokens=8)
        with pytest.raises(RuntimeError):
            h.result(timeout=120)
    finally:
        srv.stop()
        jflight.reset()
    bundles = glob.glob(os.path.join(str(tmp_path), "crash", "*"))
    assert len(bundles) == 1
    assert set(os.listdir(bundles[0])) == BUNDLE_FILES
