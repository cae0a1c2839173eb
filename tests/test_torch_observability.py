"""The port's observability and resilience modules against the reference's,
on the CPU.

Each module meets its reference on the same operations: the metrics
registry's Prometheus text byte for byte and its snapshot, the quantile
estimate of the live plane, heartbeat files read across the two packages
in both directions, the flight ring and crash bundle for the same events,
journal records reaching the ring, StepTelemetry's retraces against the
engine's program builds on the TestCompileOnce sequence, the /statusz
serving block after the same requests through both servers, and the
/journal redaction. memprof's readers return None here (CUDA is never
initialised), as the reference's do without JAX, so the memory samples
are stubbed to the same reading on both sides. Every HTTP server binds
port 0 and is stopped in a finally.
"""
import glob
import json
import math
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import httpd as jhttpd
from paddle_tpu.observability import journal as jjournal
from paddle_tpu.observability import memprof as jmemprof
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.resilience import health as jhealth
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.observability import (flight, httpd, journal, memprof,
                                            metrics, spans, tracing)
from paddle_tpu_torch.resilience import health

jax.config.update("jax_platforms", "cpu")

VOCAB = 64
SHAPE = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64)
# envelope fields that differ between two processes' records by nature
VOLATILE = ("ts", "run_id", "host", "pid")


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


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in VOLATILE}


# ----------------------------------------------------------------- metrics
def _drive_registry(mod):
    """One sequence of counter, gauge and histogram operations on a fresh
    registry of `mod` (escapes, labels, infinities, bucket edges)."""
    reg = mod.MetricsRegistry()
    c = reg.counter("pt_c_total", 'help with "quotes" and \\ and\nnewline',
                    labelnames=("route", "code"))
    c.labels("/metrics", 200).inc()
    c.labels(route='a"b\\c\nd', code="503").inc(2.5)
    reg.counter("pt_plain_total").inc(3)
    g = reg.gauge("pt_g", "a gauge", labelnames=("engine",))
    g.labels("serve_decode").set(-1.25)
    g.labels("inf").set(math.inf)
    g.labels("ninf").set(-math.inf)
    g.labels("serve_decode").inc(0.5)
    g.labels("big").set(1e21)
    h = reg.histogram("pt_h_seconds", "latency", labelnames=("engine",))
    for v in (0.0, 1e-4, 2e-4, 0.0003, 0.5, 7.0, 1e6):
        h.labels("serve_decode").observe(v)
    hb = reg.histogram("pt_hb_ms", "custom buckets",
                       buckets=(5.0, 1.0, 2.5))
    for v in (1.0, 1.0, 2.5, 3.0, 9.0, -1.0):
        hb.observe(v)
    reg.gauge("pt_unset")
    return reg


def test_prometheus_text_and_snapshot_equal_the_reference():
    ref, port = _drive_registry(jmetrics), _drive_registry(metrics)
    assert port.to_prometheus().encode() == ref.to_prometheus().encode()
    assert port.snapshot() == ref.snapshot()
    assert port.to_jsonl() == ref.to_jsonl()
    ref.unregister("pt_g")
    port.unregister("pt_g")
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.get("pt_g") is None and port.get("pt_plain_total").value == 3
    port.reset()
    assert port.to_prometheus() == "" and port.snapshot() == {}


def test_write_json_and_histogram_child(tmp_path):
    reg = _drive_registry(metrics)
    path = reg.write_json(str(tmp_path / "m.json"))
    with open(path) as f:
        dumped = json.load(f)
    assert dumped["metrics"] == json.loads(json.dumps(reg.snapshot()))
    child = reg.get("pt_hb_ms")._children[()]
    ref_child = _drive_registry(jmetrics).get("pt_hb_ms")._children[()]
    assert child.cumulative() == ref_child.cumulative()
    assert (child.count, child.sum) == (ref_child.count, ref_child.sum) \
        == (6, 15.5)


@pytest.mark.parametrize("seed", range(4))
def test_hist_quantile_matches_the_reference(seed):
    rs = np.random.RandomState(seed)
    edges = sorted(set(np.round(rs.gamma(2.0, 3.0, 8), 3).tolist()))
    counts = rs.randint(0, 5, len(edges) + 1)
    cum = list(zip(edges + [math.inf], np.cumsum(counts).tolist()))
    for q in (0.0, 0.05, 0.5, 0.95, 0.99, 1.0):
        assert httpd.hist_quantile(cum, q) == jhttpd.hist_quantile(cum, q)
    assert httpd.hist_quantile([], 0.5) is None
    assert httpd.hist_quantile([(1.0, 0), (math.inf, 0)], 0.5) is None


# --------------------------------------------------------------- heartbeat
def test_heartbeats_read_across_the_packages(tmp_path):
    for writer_mod, reader_mod, rank in ((health, jhealth, 1),
                                         (jhealth, health, 2)):
        w = writer_mod.HeartbeatWriter(str(tmp_path), rank,
                                       min_interval_s=0.0)
        assert w.tick(7)
        path = reader_mod.heartbeat_path(str(tmp_path), rank)
        assert path == w.path
        rec = reader_mod.read_heartbeat(path)
        assert rec["rank"] == rank and rec["step"] == 7
        assert rec["pid"] == os.getpid()
        stale = reader_mod.stale_seconds(path)
        assert 0 <= stale < 60
        assert reader_mod.stale_seconds(path, time.time() + 100) > 99
    assert health.read_heartbeat(str(tmp_path / "missing.json")) is None
    assert health.stale_seconds(str(tmp_path / "missing.json")) is None


def test_module_tick_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv(health.ENV_DIR, raising=False)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    health.reset()
    assert health.tick(3) is False              # unconfigured: a no-op
    w = health.configure(str(tmp_path), rank=0)
    try:
        assert w is not None and health.tick(4, force=True)
        assert jhealth.read_heartbeat(
            jhealth.heartbeat_path(str(tmp_path), 0))["step"] == 4
    finally:
        health.reset()


# ------------------------------------------------------------------ flight
def _same_events(fl, mem, monkeypatch):
    monkeypatch.setattr(mem, "read_device_memory", lambda: (1000, 4000))
    fl.record("boot", step=0)
    fl.note_compile("serve_decode", "decode")
    fl.note_dispatch("serve_decode", step=5)
    fl.step_finished("serve_decode", 0.25, miss=True)
    fl.record_raw({"ts": 1.0, "event": "serve_admit", "rid": 3})
    mem.bank_executable("serve_decode", {"source": "avals",
                                         "args_bytes": 64, "out_bytes": 0,
                                         "temp_bytes": 0,
                                         "gen_code_bytes": 0,
                                         "total_bytes": 64})


def test_flight_ring_and_bundle_match_the_reference(tmp_path, monkeypatch):
    bundles = {}
    rings = {}
    for name, fl, mem in (("jax", jflight, jmemprof),
                          ("port", flight, memprof)):
        fl.reset()
        mem.reset()
        try:
            fl.configure(str(tmp_path / name), rank=0)
            _same_events(fl, mem, monkeypatch)
            rings[name] = [_strip(r) for r in fl.ring_events()]
            bundles[name] = fl.dump_crash_bundle(
                "drill", exc=ValueError("boom"), last_step=5)
            # once per process unless forced
            assert fl.dump_crash_bundle("again") == bundles[name]
        finally:
            fl.reset()
            mem.reset()
    assert rings["port"] == rings["jax"]
    assert [r["event"] for r in rings["port"]] == [
        "boot", "compile_begin", "compile_end", "hbm", "serve_admit"]
    files = {k: sorted(os.listdir(p)) for k, p in bundles.items()}
    assert files["port"] == files["jax"] == sorted(
        ["MANIFEST.json", "ring.jsonl", "stacks.txt", "metrics.json",
         "env.json", "memory.json"])
    man = {}
    for k, p in bundles.items():
        with open(os.path.join(p, "MANIFEST.json")) as f:
            man[k] = json.load(f)
    assert set(man["port"]) == set(man["jax"])
    for key in ("reason", "rank", "last_step", "last_dispatch",
                "ring_events", "error"):
        if key == "last_dispatch":
            assert _strip(man["port"][key]) == _strip(man["jax"][key])
        else:
            assert man["port"][key] == man["jax"][key]
    with open(os.path.join(bundles["port"], "memory.json")) as f:
        mem_port = json.load(f)
    assert mem_port["executables"]["serve_decode"]["args_bytes"] == 64
    assert mem_port["hbm_history"][0]["in_use"] == 1000
    with open(os.path.join(bundles["port"], "env.json")) as f:
        env = json.load(f)
    assert not any(k.startswith(("JAX", "XLA")) for k in env["env"])


def test_sample_hbm_sets_the_gauges(monkeypatch):
    flight.reset()
    memprof.reset()
    monkeypatch.setattr(memprof, "read_device_memory",
                        lambda: (2048, 8192))
    try:
        assert flight.sample_hbm(force=True, phase="step") == 2048
        assert metrics.REGISTRY.get("pt_hbm_bytes_in_use").value == 2048
        assert metrics.REGISTRY.get("pt_hbm_peak_bytes").value == 8192
        assert memprof.hbm_history()[-1]["phase"] == "step"
        # rate-limited: a second sample right away is skipped
        assert flight.sample_hbm() is None
    finally:
        flight.reset()
        memprof.reset()


def test_journal_records_reach_the_flight_ring(tmp_path):
    rings = {}
    for name, fl, jr in (("jax", jflight, jjournal),
                         ("port", flight, journal)):
        fl.reset()
        jr.emit("no_journal", rid=1)
        j = jr.RunJournal(str(tmp_path / name), run_id="r", rank=0)
        prev = jr.set_journal(j)
        try:
            jr.emit("serve_admit", rid=2, slot=0)
            j.emit("direct", n=3)
        finally:
            jr.set_journal(prev)
            j.close()
        rings[name] = [_strip(r) for r in fl.ring_events()]
        fl.reset()
    assert rings["port"] == rings["jax"]
    assert [r["event"] for r in rings["port"]] == ["no_journal",
                                                   "serve_admit", "direct"]


# ------------------------------------------------------------------ memprof
def test_memprof_without_cuda_and_the_oom_path(tmp_path, monkeypatch):
    assert not torch.cuda.is_initialized()
    assert memprof.read_device_memory() is None
    assert memprof.device_kind() is None
    assert memprof.live_buffer_table() is None
    # the reference's two spellings (one synthetic drill serves both)
    for exc, want in ((RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
                       True),
                      (RuntimeError("Resource exhausted: 1GiB"), True),
                      (ValueError("shape mismatch"), False)):
        assert memprof.is_oom(exc) == jmemprof.is_oom(exc) == want
    assert memprof.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    monkeypatch.setenv(flight.ENV_DIR, str(tmp_path))
    flight.reset()
    memprof.reset()
    oom = metrics.REGISTRY.get("pt_oom_total")
    n0 = oom.value if oom is not None else 0
    try:
        path = memprof.on_oom("serve_decode", RuntimeError(
            "RESOURCE_EXHAUSTED: synthetic"), step=9)
    finally:
        flight.reset()
        memprof.reset()
    assert metrics.REGISTRY.get("pt_oom_total").value == n0 + 1
    with open(os.path.join(path, "memory.json")) as f:
        mem = json.load(f)
    assert mem["engine"] == "serve_decode" and mem["step"] == 9
    assert mem["buffers"] is None and mem["device_kind"] is None


def test_engine_oom_leaves_a_post_mortem_and_reraises(models, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv(flight.ENV_DIR, str(tmp_path))
    flight.reset()
    memprof.reset()
    eng = tserving.GenerationEngine(models[1], max_batch=2, max_seq_len=32,
                                    prefill_buckets=(8,), device="cpu")
    eng.prefill(0, [1, 2, 3])

    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (synthetic)")
    eng._decode_fn = oom
    try:
        with pytest.raises(torch.cuda.OutOfMemoryError, match="synthetic"):
            eng.decode()
    finally:
        flight.reset()
    bundles = glob.glob(os.path.join(str(tmp_path), "crash", "*"))
    assert len(bundles) == 1
    with open(os.path.join(bundles[0], "memory.json")) as f:
        mem = json.load(f)
    memprof.reset()
    assert mem["engine"] == "serve_decode"
    assert "OutOfMemoryError" in mem["error"]
    args = sum(t.numel() * t.element_size() for t in eng._held)
    assert mem["executables"]["serve_prefill"]["args_bytes"] == args


def test_configure_sets_signal_hooks_only_from_the_main_thread(
        tmp_path, monkeypatch):
    monkeypatch.setenv(flight.ENV_DUMP_ON_TERM, "1")
    prev_hook, prev_term = sys.excepthook, signal.getsignal(signal.SIGTERM)
    flight.reset()
    try:
        t = threading.Thread(target=flight.configure, args=(str(tmp_path),))
        t.start()
        t.join(10)
        assert not t.is_alive()
        assert signal.getsignal(signal.SIGTERM) == prev_term
        assert sys.excepthook is not prev_hook     # the dump chains in
        flight.reset()
        assert sys.excepthook is prev_hook
    finally:
        flight.reset()
        signal.signal(signal.SIGTERM, prev_term)


# ------------------------------------------------------------------ tracing
def _retraces(mod):
    return {e: mod.RETRACES.labels(e).value
            for e in ("serve_prefill", "serve_suffix", "serve_decode")}


def test_step_telemetry_retraces_equal_program_builds(models):
    # tests/test_serving.py TestCompileOnce, through both engines
    delta = {}
    for name, serving, model, mod, dev in (
            ("jax", jserving, models[0], jtracing, {}),
            ("port", tserving, models[1], tracing, {"device": "cpu"})):
        eng = serving.GenerationEngine(model, max_batch=2, max_seq_len=48,
                                       prefill_buckets=(4, 8, 16), **dev)
        r0 = _retraces(mod)
        rs = np.random.RandomState(2)
        b = serving.ContinuousBatcher(eng)
        for n, m in [(3, 5), (5, 3), (7, 4), (12, 6), (16, 2)]:
            b.submit(serving.Request(prompt=rs.randint(0, VOCAB, (n,)),
                                     max_new_tokens=m))
        b.run_until_idle()
        for _ in range(3):
            b.submit(serving.Request(prompt=rs.randint(0, VOCAB, (4,)),
                                     max_new_tokens=3))
            b.run_until_idle()
        r1 = _retraces(mod)
        delta[name] = {e: r1[e] - r0[e] for e in r0}
        assert delta[name] == {
            "serve_prefill": eng.prefill_compiles,
            "serve_suffix": eng.suffix_prefill_compiles,
            "serve_decode": eng.decode_compiles}
    assert delta["port"] == delta["jax"] == {
        "serve_prefill": 3, "serve_suffix": 0, "serve_decode": 1}


def test_telemetry_switch_turns_spans_and_steps_off():
    tel = tracing.StepTelemetry("test_switch")
    tracing.enable(False)
    try:
        with tel.step("a"):
            pass
        assert tel.retraces == 0
        assert spans.begin("x") is None
    finally:
        tracing.enable(True)
    with tel.step("a"):
        pass
    with tel.step("a"):
        pass
    assert tel.retraces == 1
    assert tracing.STEP_LATENCY.labels("test_switch").count == 1


# ------------------------------------------------------------------ statusz
def _status_serving(url):
    code, body = _get(url + "/statusz")
    assert code == 200
    return json.loads(body)["serving"]


COUNTED = ("admitted", "completed", "tokens", "prefix_cache_hits",
           "prefix_cache_misses")


def test_statusz_serving_block_equals_the_jax_servers(models):
    rs = np.random.RandomState(11)
    head = rs.randint(0, VOCAB, 8)
    waves = [[np.concatenate([head, rs.randint(0, VOCAB, 4)])],
             [np.concatenate([head, rs.randint(0, VOCAB, 3)]),
              rs.randint(0, VOCAB, 5)],
             [np.concatenate([head, rs.randint(0, VOCAB, 2)])]]
    got = {}
    for name, serving, model, hmod, dev in (
            ("jax", jserving, models[0], jhttpd, {}),
            ("port", tserving, models[1], httpd, {"device": "cpu"})):
        hmod.shutdown()
        srv = serving.InferenceServer(model, max_batch=2, max_seq_len=48,
                                      prefill_buckets=(8, 16), http_port=0,
                                      **dev)
        try:
            srv.start()
            url = srv._http.url
            before = _status_serving(url)
            tokens = []
            for wave in waves:
                hs = [srv.submit(p.tolist(), max_new_tokens=3)
                      for p in wave]
                tokens += [h.result(timeout=120) for h in hs]
            after = _status_serving(url)
            code, _ = _get(url + "/healthz")
            assert code == 200
            code, text = _get(url + "/metrics")
            assert code == 200 and "pt_serve_completed_total" in text
        finally:
            srv.stop()
            hmod.shutdown()
        got[name] = ({k: after.get(k, 0) - before.get(k, 0)
                      for k in COUNTED}, tokens)
        assert "ttft_ms" in after and after["ttft_ms"]["count"] > 0
    assert got["port"] == got["jax"]
    assert got["port"][0]["completed"] == 4
    assert got["port"][0]["tokens"] == 12
    assert got["port"][0]["prefix_cache_hits"] == 2


# ------------------------------------------------------------------ journal
def test_journal_redaction_matches_the_reference(tmp_path):
    lines = [json.dumps({"event": "cfg", "hf_token": "abc", "password": "p",
                         "step": 3}),
             json.dumps({"event": "cfg", "bearer": "b-sekrit",
                         "Cookie": "sid=deadbeef", "session_cookie": "c",
                         "bearer_auth": "x", "step": 7}),
             json.dumps({"event": "cfg", "barrier": "sync-1",
                         "cook_time_s": 12, "bear": "animal", "lr": 0.1}),
             '{"api_key": "k\\"q", "nested": {"secret_x": 5}}']
    for line in lines:
        assert httpd.redact_line(line) == jhttpd.redact_line(line)
    bodies = {}
    for name, jr, hmod in (("jax", jjournal, jhttpd),
                           ("port", journal, httpd)):
        j = jr.RunJournal(str(tmp_path / name), rank=0)
        prev = jr.set_journal(j)
        try:
            jr.emit("config", api_key="sekrit-123", lr=0.1,
                    authorization="Bearer abc")
            with hmod.TelemetryServer(port=0, endpoint_dir=None) as srv:
                code, bodies[name] = _get(srv.url + "/journal?n=10")
                assert code == 200
        finally:
            jr.set_journal(prev)
            j.close()
    # the servers' own http_listen lines name their ports
    recs = {k: [_strip(r) for r in map(json.loads, b.splitlines())
                if r["event"] == "config"] for k, b in bodies.items()}
    assert recs["port"] == recs["jax"] and len(recs["port"]) == 1
    assert "sekrit-123" not in bodies["port"]
    assert "Bearer abc" not in bodies["port"]
    assert '"lr": 0.1' in bodies["port"]


def test_endpoint_file_and_no_socket_without_a_port(tmp_path, monkeypatch):
    monkeypatch.delenv(httpd.ENV_PORT, raising=False)
    httpd.shutdown()
    assert httpd.ensure_server() is None
    assert httpd.start_from_env(str(tmp_path)) is None
    assert os.listdir(str(tmp_path)) == []
    with httpd.TelemetryServer(port=0, rank=3,
                               endpoint_dir=str(tmp_path)) as srv:
        with open(httpd.endpoint_path(str(tmp_path), 3)) as f:
            ep = json.load(f)
        assert ep["port"] == srv.port and ep["url"] == srv.url
        code, body = _get(srv.url + "/")
        assert code == 200 and "/metrics" in body
    assert not os.path.exists(httpd.endpoint_path(str(tmp_path), 3))
