"""The port's durable checkpoints against the JAX package's, on the CPU.

  * store: each package reads the other's stores, every dtype of
    tests/test_checkpoint.py's STORE_DTYPES (bfloat16 among them, with
    `ml_dtypes` blocked on the port's side), 0-d and empty arrays; for
    the same arrays both write byte-equal manifests and blobs; each
    corruption raises the same `reason` in both;
  * engine, both ways: 3 steps of a 2-layer GPT of width 64 (float32,
    dropouts 0) with the GPT-2 configuration's scheduler and clip in one
    package, `save_checkpoint`, a load in the other, then 2 more steps
    in each: losses and parameters within 1e-5 (atol; float32 through
    two layers summed in different orders differs by ~1e-7), step count
    and scheduler restored;
  * a load into a built, already-run `TrainStep` (dropout 0.1): one
    program, and the next steps bit-equal to an uninterrupted run's;
  * retention GC, stale-dir hygiene and bitflip quarantine, as the
    reference's TestRetention, TestHygiene and
    test_bitflip_chaos_end_to_end.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.checkpoint import store as jstore
from paddle_tpu.incubate.checkpoint import load_checkpoint as jload
from paddle_tpu.incubate.checkpoint import save_checkpoint as jsave
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.checkpoint import (CheckpointCorruptError,
                                         RetentionPolicy, engine, store)
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.incubate.checkpoint import (TrainEpochRange,
                                                  load_checkpoint,
                                                  save_checkpoint)
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                     export_reference_state,
                                     load_reference_state)
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.observability import journal as run_journal
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.resilience import chaos
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE_DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64",
                "float16", "bfloat16", "float32", "float64",
                "complex64", "complex128"]
VOCAB, B, T = 128, 2, 64
NO_DROPOUT = dict(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)


def _counter(name):
    m = REGISTRY.get(name)
    return m.value if m is not None else 0.0


def _flip_byte(path, offset=0):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _np_array(dtype, shape=(3, 5), seed=1):
    """The reference's array of `dtype` (bfloat16 through its dtype
    table, which uses ml_dtypes)."""
    np_dtype = paddle.framework.dtype.convert_dtype(dtype).np_dtype
    return (np.random.RandomState(seed).rand(*shape) * 4).astype(np_dtype)


def _port_array(arr):
    """The port's form of a reference array: a torch bfloat16 tensor for
    bfloat16 (numpy has none), the numpy array otherwise."""
    if str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).bfloat16()
    return arr


def _same(got, want):
    """A port-read value against a reference array, bit for bit."""
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# store


@pytest.mark.parametrize("dtype", STORE_DTYPES)
def test_reference_store_read_by_the_port(tmp_path, dtype, monkeypatch):
    arr = _np_array(dtype)
    d = str(tmp_path / "ck")
    jstore.write_store(d, {"a": arr}, meta={"dtype": dtype})
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    arrays, meta, _ = store.read_store(d)
    assert meta == {"dtype": dtype}
    _same(arrays["a"], arr)


@pytest.mark.parametrize("dtype", STORE_DTYPES)
def test_port_store_read_by_the_reference(tmp_path, dtype, monkeypatch):
    arr = _np_array(dtype)
    d = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "ml_dtypes", None)
        store.write_store(d, {"a": _port_array(arr)}, meta={"dtype": dtype})
    arrays, meta, _ = jstore.read_store(d)
    assert meta == {"dtype": dtype}
    assert arrays["a"].dtype == arr.dtype
    np.testing.assert_array_equal(arrays["a"], arr)


def _all_arrays():
    out = {"scalar": np.float32(3.5).reshape(()),
           "empty": np.zeros((0, 3), np.int64),
           "empty_bf16": np.zeros((0,), "bfloat16"),
           "scalar_bf16": np.asarray(1.5, "bfloat16")}
    for i, dtype in enumerate(STORE_DTYPES):
        out[dtype] = _np_array(dtype, (2, 3, 4), seed=i)
    return out


def test_manifests_and_blobs_are_byte_equal(tmp_path):
    """The same arrays, meta and extras written by each package: the
    manifests (hence the COMMIT) and every blob byte-equal."""
    arrays = _all_arrays()
    meta = {"epoch": 3, "note": "x"}
    extras = {"opt": {"@step_count": 7}, "has_opt": True}
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    jn = jstore.write_store(jd, arrays, meta=meta, extras=extras)
    tn = store.write_store(td, {k: _port_array(v) for k, v in arrays.items()},
                           meta=meta, extras=extras)
    assert jn == tn
    for name in (store.MANIFEST, store.COMMIT):
        with open(os.path.join(jd, name), "rb") as a, \
                open(os.path.join(td, name), "rb") as b:
            assert a.read() == b.read(), name
    for i in range(len(arrays)):
        blob = os.path.join(store.BLOB_DIR, "%d.bin" % i)
        with open(os.path.join(jd, blob), "rb") as a, \
                open(os.path.join(td, blob), "rb") as b:
            assert a.read() == b.read(), blob


def test_zero_d_and_empty_arrays_both_ways(tmp_path, monkeypatch):
    arrays = {k: v for k, v in _all_arrays().items()
              if k.startswith(("scalar", "empty"))}
    d, d2 = str(tmp_path / "ref"), str(tmp_path / "port")
    jstore.write_store(d, arrays)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "ml_dtypes", None)
        got, _, _ = store.read_store(d)
        store.write_store(d2, {k: _port_array(v) for k, v in arrays.items()})
    for k, v in arrays.items():
        _same(got[k], v)
    back, _, _ = jstore.read_store(d2)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
    assert float(got["scalar"]) == 3.5 and float(back["scalar"]) == 3.5


def _corrupt(d, reason):
    if reason == "missing":
        os.unlink(os.path.join(d, store.MANIFEST))
    elif reason == "incomplete":
        os.unlink(os.path.join(d, store.COMMIT))
    elif reason == "manifest":
        mpath = os.path.join(d, store.MANIFEST)
        m = json.load(open(mpath))
        m["meta"]["epoch"] = 999
        json.dump(m, open(mpath, "w"))
    elif reason == "blob_missing":
        os.unlink(os.path.join(d, "blobs", "1.bin"))
    elif reason == "truncated":
        with open(os.path.join(d, "blobs", "0.bin"), "r+b") as f:
            f.truncate(10)
    elif reason == "checksum":
        _flip_byte(os.path.join(d, "blobs", "0.bin"), offset=17)


@pytest.mark.parametrize("reason", ["missing", "incomplete", "manifest",
                                    "blob_missing", "truncated",
                                    "checksum"])
def test_each_corruption_reason_matches_the_reference(tmp_path, reason):
    d = str(tmp_path / "ck")
    jstore.write_store(d, {"a": np.arange(64, dtype=np.float32),
                           "b": np.arange(3.0)}, meta={"epoch": 1})
    _corrupt(d, reason)
    with pytest.raises(jstore.CheckpointCorruptError) as want:
        jstore.read_store(d)
    with pytest.raises(CheckpointCorruptError) as got:
        store.read_store(d)
    assert got.value.reason == want.value.reason == reason


_BLOCKED_CHILD = """
import sys
for m in ("ml_dtypes", "jax", "jaxlib", "paddle_tpu"):
    sys.modules[m] = None
import numpy as np
import torch
from paddle_tpu_torch import checkpoint, optimizer, resilience  # noqa
from paddle_tpu_torch.checkpoint import store
from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange  # noqa
from paddle_tpu_torch.optimizer import lr  # noqa
arrays, meta, extras = store.read_store(sys.argv[1])
t = arrays["w"]
assert isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
store.write_store(sys.argv[2], {"w": t * 2}, meta=meta, extras=extras)
print("BLOCKED_OK", float(t.float().sum()))
"""


def test_bf16_store_round_trips_with_ml_dtypes_blocked(tmp_path):
    """A child with ml_dtypes (and JAX and the JAX package) blocked before
    any import loads the port's checkpoint, resilience and scheduler
    modules, reads a reference-written bfloat16 store and writes one
    back, which the reference reads."""
    arr = _np_array("bfloat16", (16, 8))
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    jstore.write_store(src, {"w": arr}, meta={"k": 1})
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CHILD, src, dst],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BLOCKED_OK" in out.stdout
    back, meta, _ = jstore.read_store(dst)
    assert meta == {"k": 1} and str(back["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(back["w"].astype(np.float32),
                                  arr.astype(np.float32) * 2)


def test_store_imports_no_ml_dtypes():
    import ast
    with open(store.__file__) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not any("ml_dtypes" in n for n in names)


# ---------------------------------------------------------------------------
# engine, both ways, through the train step


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (n, B, T + 1)).astype(np.int64)
    return [(x[:, :-1], x[:, 1:]) for x in ids]


def _sched(lib):
    return lib.LinearWarmup(lib.CosineAnnealingDecay(1e-4, T_max=100),
                            warmup_steps=4, start_lr=0.0, end_lr=1e-4)


def _ref_side(seed):
    paddle.seed(seed)
    ref = jgpt_tiny(**NO_DROPOUT)
    opt = jopt_mod.AdamW(learning_rate=_sched(jlr), weight_decay=0.01,
                         parameters=ref.parameters(),
                         grad_clip=jopt_mod.ClipGradByGlobalNorm(1.0))
    crit = JCriterion()
    step = jmake_train_step(ref, lambda o, l: crit(o, l), opt)

    def run(x, y):
        loss, _ = step([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        opt._lr.step()
        return float(loss.numpy())
    return ref, opt, run


def _port_side(seed, weights_from=None, dropout=None):
    kw = {} if dropout else NO_DROPOUT
    port = tgpt_tiny(device="cpu", seed=seed, **kw)
    if weights_from is not None:
        load_reference_state(port, {k: np.asarray(v.numpy()) for k, v in
                                    weights_from.state_dict().items()})
    opt = optimizer.AdamW(learning_rate=_sched(tlr), weight_decay=0.01,
                          parameters=port.parameters(),
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                          device="cpu")
    crit = GPTPretrainingCriterion()
    step = make_train_step(port, lambda o, l: crit(o, l), opt, device="cpu")

    def run(x, y):
        loss, _ = step([torch.from_numpy(x)], [torch.from_numpy(y)])
        opt._lr.step()
        return float(loss)
    return port, opt, run, step


def _ref_params(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _hold(jl, tl, jp, tp):
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    batches = _batches(5)
    ref, jopt, jrun = _ref_side(0)
    for x, y in batches[:3]:
        jrun(x, y)
    path = str(tmp_path / "ck")
    jsave(path, ref, jopt, {"epoch": 0})
    port, topt, trun, _ = _port_side(seed=9)           # other weights
    assert load_checkpoint(path, port, topt) == {"epoch": 0}
    assert topt._step_count == 3 and topt._lr.last_epoch == 3
    assert topt._lr.state_dict() == jopt._lr.state_dict()
    jl = [jrun(x, y) for x, y in batches[3:]]
    tl = [trun(x, y) for x, y in batches[3:]]
    _hold(jl, tl, _ref_params(ref), export_reference_state(port))
    assert topt._step_count == 5


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    batches = _batches(5)
    paddle.seed(0)
    ref0 = jgpt_tiny(**NO_DROPOUT)
    port, topt, trun, _ = _port_side(seed=1, weights_from=ref0)
    for x, y in batches[:3]:
        trun(x, y)
    path = str(tmp_path / "ck")
    save_checkpoint(path, port, topt, {"epoch": 0})
    ref, jopt, jrun = _ref_side(5)                      # other weights
    assert jload(path, ref, jopt) == {"epoch": 0}
    assert jopt._step_count == 3 and jopt._lr.last_epoch == 3
    jl = [jrun(x, y) for x, y in batches[3:]]
    tl = [trun(x, y) for x, y in batches[3:]]
    _hold(jl, tl, _ref_params(ref), export_reference_state(port))


def test_snapshot_keeps_dtypes_and_stores_each_moment_once(tmp_path):
    """O2: bfloat16 parameters stay bfloat16 in the store (not widened),
    the moments float32, keyed by the reference's names; an optimizer
    tensor listed under two keys is written once."""
    from paddle_tpu_torch import amp
    port = tgpt_tiny(device="cpu", seed=0)
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=port.parameters(),
                          device="cpu")
    port, opt = amp.decorate(port, opt, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion()
    step = make_train_step(port, lambda o, l: crit(o, l), opt, device="cpu")
    x, y = _batches(1)[0]
    step([torch.from_numpy(x)], [torch.from_numpy(y)])
    path = str(tmp_path / "ck")
    save_checkpoint(path, port, opt)
    man = store.read_manifest(path)
    params = dict(port.named_parameters())
    p_keys = {k[2:] for k in man["arrays"] if k.startswith("p/")}
    assert p_keys == set(params)
    assert {man["arrays"]["p/" + k]["dtype"] for k in p_keys} == {"bfloat16"}
    o_keys = [k for k in man["arrays"] if k.startswith("o/")]
    assert sorted(o_keys) == sorted("o/@acc_%d_%s" % (i, n)
                                    for i in range(len(params))
                                    for n in ("moment1", "moment2"))
    assert {man["arrays"][k]["dtype"] for k in o_keys} == {"float32"}
    # the reference reads it (bfloat16 through ml_dtypes)
    arrays, _, extras = jstore.read_store(path)
    name = "gpt.layers.0.mlp.fc1.weight"
    np.testing.assert_array_equal(arrays["p/" + name].astype(np.float32),
                                  params[name].detach().float().numpy())
    assert extras["opt"]["@step_count"] == 1


def test_load_into_a_built_train_step_continues_bit_for_bit(tmp_path):
    """Dropout 0.1: an uninterrupted 5-step run against 3 steps, a save
    (RNG state in the meta), and a load into another model's step that
    has already run (built): one program, the step count staged t = 4,
    and steps 4-5 bit-equal (losses, parameters, moments)."""
    batches = _batches(6, seed=2)

    def side(seed, rng_seed):
        prandom.seed(rng_seed)
        return _port_side(seed, dropout=True)

    port, opt, run, _ = side(3, 7)
    full = [run(x, y) for x, y in batches[:5]]
    want = [p.detach().clone() for p in port.parameters()]
    want_m = [a.clone() for p in port.parameters()
              for a in opt._get_accumulators(p).values()]

    port, opt, run, _ = side(3, 7)
    for x, y in batches[:3]:
        run(x, y)
    path = str(tmp_path / "ck")
    save_checkpoint(path, port, opt, {"rng": prandom.get_rng_state()})

    port, opt, run, step = side(4, 99)
    run(*batches[5])                                    # built and run
    ptrs = [p.data_ptr() for p in port.parameters()] + \
        [a.data_ptr() for p in port.parameters()
         for a in opt._get_accumulators(p).values()] + \
        [opt._scalars.data_ptr()]
    meta = load_checkpoint(path, port, opt)
    prandom.set_rng_state(json.loads(json.dumps(meta["rng"])))
    assert opt._step_count == 3
    got = [run(x, y) for x, y in batches[3:5]]
    assert step.compiles == 1 and opt._step_count == 5
    assert float(opt._scalars[2]) == np.float32(1) - np.float32(0.999) ** 5
    assert got == full[3:]
    for a, b in zip(port.parameters(), want):
        assert torch.equal(a, b)
    got_m = [a for p in port.parameters()
             for a in opt._get_accumulators(p).values()]
    for a, b in zip(got_m, want_m):
        assert torch.equal(a, b)
    assert ptrs == [p.data_ptr() for p in port.parameters()] + \
        [a.data_ptr() for a in got_m] + [opt._scalars.data_ptr()]


def test_set_rng_state_refuses_the_reference_key():
    from paddle_tpu.framework.random import get_rng_state as jget
    key = jget()
    for bad in (key, np.asarray(key).tolist(), None, {"offset": 1}):
        with pytest.raises(ValueError):
            prandom.set_rng_state(bad)


# ---------------------------------------------------------------------------
# engine hygiene (the reference's TestEngine, TestRetention, TestHygiene)


def _make_net(seed=7):
    torch.manual_seed(seed)
    net = nn.Linear(4, 3)
    opt = optimizer.Adam(learning_rate=0.01, parameters=net.parameters(),
                         device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 4)
                         .astype("float32"))
    net(x).sum().backward()
    opt.step()
    opt.clear_grad()
    return net, opt


def test_layer_optimizer_roundtrip_and_corrupt_quarantine(tmp_path):
    net, opt = _make_net()
    p = str(tmp_path / "ck")
    save_checkpoint(p, net, opt, {"epoch": 3})
    w0 = net.weight.detach().clone()
    with torch.no_grad():
        net.weight.zero_()
    assert load_checkpoint(p, net, opt) == {"epoch": 3}
    assert torch.equal(net.weight, w0) and opt._step_count == 1
    _flip_byte(os.path.join(p, "blobs", "0.bin"))
    before = _counter("pt_ckpt_corrupt_total")
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(p, net, opt)
    assert not os.path.exists(p) and os.path.isdir(p + ".corrupt")
    assert _counter("pt_ckpt_corrupt_total") == before + 1


def test_load_latest_walks_back_to_last_good(tmp_path):
    net, opt = _make_net()
    jrn = run_journal.RunJournal(str(tmp_path / "journal"), run_id="t",
                                 rank=0)
    prev = run_journal.set_journal(jrn)
    try:
        p1, p2 = str(tmp_path / "epoch_1"), str(tmp_path / "epoch_2")
        save_checkpoint(p1, net, opt, {"epoch": 1})
        save_checkpoint(p2, net, opt, {"epoch": 2})
        _flip_byte(os.path.join(p2, "blobs", "0.bin"))
        c0, f0 = (_counter("pt_ckpt_corrupt_total"),
                  _counter("pt_ckpt_fallback_total"))
        path, meta = engine.load_latest([p2, p1], net, opt)
        assert path == p1 and meta == {"epoch": 1}
        assert os.path.isdir(p2 + ".corrupt")
        assert _counter("pt_ckpt_corrupt_total") == c0 + 1
        assert _counter("pt_ckpt_fallback_total") == f0 + 1
    finally:
        run_journal.set_journal(prev)
        jrn.close()
    with open(jrn.path) as f:
        events = [json.loads(line)["event"] for line in f]
    assert "checkpoint_corrupt" in events and "checkpoint_fallback" in events
    assert "checkpoint_save" in events


def test_bitflip_chaos_end_to_end(tmp_path):
    """bitflip_ckpt chaos corrupts one blob of the SECOND epoch save; a
    fresh TrainEpochRange quarantines it and restores epoch 0."""
    net, opt = _make_net(seed=5)
    root = str(tmp_path)
    tr = TrainEpochRange(2, "job", checkpoint_dir=root)
    saved_w = {}
    for e in tr.get():
        with torch.no_grad():
            net.weight.fill_(float(e + 1))
        saved_w[e] = net.weight.detach().clone()
        if e == 1:
            # blob counting starts when the spec is set, so :1 hits the
            # first blob of the SECOND epoch's save
            chaos.configure("bitflip_ckpt:1")
        try:
            tr.save(layer=net, optimizer=opt)
        finally:
            chaos.reset()
    tr2 = TrainEpochRange(2, "job", checkpoint_dir=root)
    assert tr2.restored_epoch == 1          # looks complete on disk
    meta = tr2.restore(net, opt)
    assert tr2.restored_epoch == 0          # fell back past the bitflip
    assert meta["epoch"] == 0
    assert torch.equal(net.weight, saved_w[0])
    assert os.path.isdir(os.path.join(root, "job", "epoch_1.corrupt"))


class TestRetention:
    def test_keep_last_and_keep_every(self, tmp_path):
        root = str(tmp_path)
        for e in range(10):
            store.write_store(os.path.join(root, "epoch_%d" % e),
                              {"a": np.arange(2.0)}, meta={"epoch": e})
        before = _counter("pt_ckpt_gc_total")
        removed = RetentionPolicy(keep_last=2, keep_every=4).apply(root)
        assert sorted(os.listdir(root)) == ["epoch_0", "epoch_4",
                                            "epoch_8", "epoch_9"]
        assert len(removed) == 6
        assert _counter("pt_ckpt_gc_total") == before + 6

    def test_refuses_keep_nothing(self):
        with pytest.raises(ValueError):
            RetentionPolicy(keep_last=0)

    def test_ignores_quarantined_and_stale_names(self, tmp_path):
        root = str(tmp_path)
        store.write_store(os.path.join(root, "epoch_1"),
                          {"a": np.arange(2.0)})
        os.makedirs(os.path.join(root, "epoch_0.corrupt"))
        os.makedirs(os.path.join(root, "epoch_2.tmp.123-0"))
        RetentionPolicy(keep_last=1).apply(root)
        assert sorted(os.listdir(root)) == [
            "epoch_0.corrupt", "epoch_1", "epoch_2.tmp.123-0"]


class TestHygiene:
    def test_epoch_scan_survives_stray_dirs(self, tmp_path):
        root = str(tmp_path)
        jdir = os.path.join(root, "j")
        os.makedirs(os.path.join(jdir, "epoch_3.old.9999991"))
        os.makedirs(os.path.join(jdir, "epoch_2.corrupt"))
        os.makedirs(os.path.join(jdir, "not_an_epoch"))
        store.write_store(os.path.join(jdir, "epoch_1"),
                          {"a": np.arange(2.0)}, meta={"epoch": 1})
        tr = TrainEpochRange(5, "j", checkpoint_dir=root)
        assert tr.restored_epoch == 1
        assert "epoch_3.old.9999991" not in os.listdir(jdir)
        assert "epoch_2.corrupt" in os.listdir(jdir)
        assert "not_an_epoch" in os.listdir(jdir)

    def test_sweep_recovers_orphaned_complete_tmp(self, tmp_path):
        """A crash between the full write and the commit rename: the .tmp
        dir is the only durable copy, which the sweep recovers."""
        root = str(tmp_path)
        tmp = os.path.join(root, "epoch_0.tmp.999999-0")
        store.write_store(tmp, {"a": np.arange(3.0)}, meta={"epoch": 0})
        engine.sweep_stale(root)
        assert store.is_complete(os.path.join(root, "epoch_0"))
        _, meta, _ = store.read_store(os.path.join(root, "epoch_0"))
        assert meta == {"epoch": 0}

    def test_default_directory_is_under_the_temporary_directory(
            self, tmp_path, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_CHECKPOINT_DIR", raising=False)
        monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
        tr = TrainEpochRange(2, "j")
        assert tr.dir == os.path.join(str(tmp_path), "paddle_tpu_ckpt", "j")
