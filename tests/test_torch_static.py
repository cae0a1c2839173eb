"""The port's static graph (paddle_tpu_torch/static: Program, Variable,
Executor, minimize, clone, save/load) against the JAX package's, on the
CPU: counterparts of tests/test_static.py's cases, each program built in
both packages from the same weights and fed the same numpy arrays.

Tolerances (relative to the largest |value| of the reference's tensor,
at least 1): float32 outputs of one forward 1e-6; the two-block ResNet's
5 Momentum steps at 32x32 (losses, parameters, running statistics) 1e-5.

ResNet-50 (train_bench.py bench_resnet50's static body; its tests are in
tests/test_torch_static_resnet.py, which imports this file's helpers)
runs as written at 32x32, B=4 in the port (float32: one program, 5
finite runs), and the static training is held to the reference in
float64 at 64x64, B=8 over 3 steps (each loss, and every parameter and
running statistic after its update) to 1e-8, on ResNet-18.
The float32 body is not held to the reference's float32 losses: at
32x32, B=4 the last stage's maps are 1x1 and its batch norms take
E[x^2] - E[x]^2 over 4 values a channel, so float32 rounding moves the
first loss by 1.2e-3 of the float64 one in the reference itself and the
second by 56% (tools/port_static_resnet50_parity.py prints both
packages in both dtypes).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu.framework import place as jplace
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn, static
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.models import (export_reference_state,
                                     load_reference_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.tensor import flatten
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

FWD_TOL, TRAIN_TOL = 1e-6, 1e-5
# ResNet-50 in float64 against the reference, 3 steps
F64_TOL, F64_STEPS = 1e-8, 3


@pytest.fixture(autouse=True)
def static_modes():
    """Both packages in static mode with fresh default programs, the port
    on the CPU; everything put back after."""
    saved = (pplace._current_place, jplace._current_place,
             prandom.get_rng_state())
    paddle.set_device("cpu")
    jpaddle.enable_static()
    jstatic.reset_default_programs()
    paddle.enable_static()
    static.reset_default_programs()
    yield
    jpaddle.disable_static()
    jstatic.reset_default_programs()
    paddle.disable_static()
    static.reset_default_programs()
    pplace._current_place, jplace._current_place, rng = saved
    prandom.set_rng_state(rng)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _types(prog):
    return [op.op_type for op in prog.ops]


def _linear_pair(i, o, seed=0):
    """nn.Linear(i, o) in both packages, the port's holding the
    reference's weights."""
    jpaddle.seed(seed)
    ref = jnn.Linear(i, o)
    port = nn.Linear(i, o)
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


def test_feed_fetch_roundtrip_and_repr():
    ref, port = _linear_pair(3, 3)
    jx = jstatic.data("x", [2, 3], "float32")
    x = static.data("x", [2, 3], "float32")
    jy = jnn.functional.relu(ref(jx)) + jx
    y = F.relu(port(x)) + x
    assert x.shape == [2, 3] and y.shape == [2, 3]
    a = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    (want,) = jstatic.Executor().run(feed={"x": a}, fetch_list=[jy])
    (got,) = static.Executor().run(feed={"x": a}, fetch_list=[y])
    assert _rel(got, want) <= FWD_TOL
    prog = static.default_main_program()
    assert _types(prog) == _types(jstatic.default_main_program()) == [
        "matmul_v2", "elementwise_add", "relu", "elementwise_add"]
    text = repr(prog)
    assert text.startswith("Program(4 ops)") and "relu(" in text
    assert y.name in prog.vars and prog.var(y.name) is y
    assert prog.global_block() is prog
    assert any(v is y for v in prog.list_vars())
    assert [p is port.weight or p is port.bias
            for p in prog.all_parameters()] == [True, True]


def test_dynamic_batch_one_program_fed_two_sizes():
    ref, port = _linear_pair(4, 2)
    jx = jstatic.data("x", [-1, 4], "float32")
    x = static.data("x", [-1, 4], "float32")
    jy, y = ref(jx), port(x)
    assert x.shape == [-1, 4] and y.shape == [-1, 2]
    jexe, exe = jstatic.Executor(), static.Executor()
    for bs in (2, 3):
        a = np.random.RandomState(bs).randn(bs, 4).astype(np.float32)
        (want,) = jexe.run(feed={"x": a}, fetch_list=[jy])
        (got,) = exe.run(feed={"x": a}, fetch_list=[y])
        assert got.shape == (bs, 2) and _rel(got, want) <= FWD_TOL
    assert len(exe._cache) == 2


def test_program_guard_isolates_programs():
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [2], "float32")
        y = x + 1.0
    assert len(main.ops) == 1 and len(static.default_main_program().ops) == 0
    (out,) = static.Executor().run(main, feed={"x": np.zeros(2, np.float32)},
                                   fetch_list=[y])
    np.testing.assert_array_equal(out, [1.0, 1.0])
    assert static.Executor().run(static.default_startup_program()) is None


def _two_block_resnet(nnmod, base, flat):
    """A stem conv + batch norm and two residual blocks of 8 channels,
    then the average pool and a linear head over 10 classes, built from
    `nnmod`'s layers (either package)."""

    class Block(base):
        def __init__(self, c):
            super().__init__()
            self.conv1 = nnmod.Conv2D(c, c, 3, padding=1, bias_attr=False)
            self.bn1 = nnmod.BatchNorm2D(c)
            self.conv2 = nnmod.Conv2D(c, c, 3, padding=1, bias_attr=False)
            self.bn2 = nnmod.BatchNorm2D(c)
            self.relu = nnmod.ReLU()

        def forward(self, x):
            out = self.relu(self.bn1(self.conv1(x)))
            return self.relu(self.bn2(self.conv2(out)) + x)

    class Net(base):
        def __init__(self):
            super().__init__()
            self.stem = nnmod.Conv2D(3, 8, 3, padding=1, bias_attr=False)
            self.bn = nnmod.BatchNorm2D(8)
            self.relu = nnmod.ReLU()
            self.block1 = Block(8)
            self.block2 = Block(8)
            self.pool = nnmod.AdaptiveAvgPool2D((1, 1))
            self.fc = nnmod.Linear(8, 10)

        def forward(self, x):
            x = self.relu(self.bn(self.stem(x)))
            x = self.block2(self.block1(x))
            return self.fc(flat(self.pool(x), 1))

    return Net()


def _resnet_pair():
    jpaddle.seed(0)
    ref = _two_block_resnet(jnn, jnn.Layer, jpaddle.flatten)
    port = _two_block_resnet(nn, torch.nn.Module, flatten)
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


def _state(model, port):
    return (export_reference_state(model) if port else
            {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()})


def test_minimize_trains_a_two_block_resnet_as_the_reference():
    ref, port = _resnet_pair()
    progs = []
    for pkg, st, model in ((jpaddle, jstatic, ref), (paddle, static, port)):
        img = st.data("image", [-1, 3, 32, 32], "float32")
        label = st.data("label", [-1, 1], "int64")
        loss = pkg.nn.functional.cross_entropy(model(img), label)
        pkg.optimizer.Momentum(learning_rate=0.01,
                               momentum=0.9).minimize(loss)
        progs.append((st.Executor(), loss, st.default_main_program()))
    assert _types(progs[0][2]) == _types(progs[1][2])
    assert len(progs[1][2].buffer_updates) == 10
    rs = np.random.RandomState(0)
    feeds = [{"image": rs.rand(4, 3, 32, 32).astype(np.float32),
              "label": rs.randint(0, 10, (4, 1)).astype(np.int64)}
             for _ in range(5)]
    for f in feeds:
        (want,), (got,) = (exe.run(prog, feed=f, fetch_list=[loss])
                           for exe, loss, prog in progs)
        assert abs(float(got) - float(want)) <= TRAIN_TOL * abs(float(want))
    want, got = _state(ref, False), _state(port, True)
    assert sorted(want) == sorted(got)
    for k in want:
        assert _rel(got[k], want[k]) <= TRAIN_TOL, k
    exe = progs[1][0]
    (cp,) = exe._cache.values()
    assert cp.step.compiles == 1 and cp.step.replays == 4


def test_static_loss_equals_the_dygraph_loss():
    ref, port = _linear_pair(4, 3)
    a = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    b = np.random.RandomState(2).randint(0, 3, (8, 1)).astype(np.int64)
    x = static.data("x", [8, 4], "float32")
    y = static.data("y", [8, 1], "int64")
    loss = F.cross_entropy(F.relu(port(x)), y)
    (static_loss,) = static.Executor().run(feed={"x": a, "y": b},
                                           fetch_list=[loss])
    jx = jstatic.data("x", [8, 4], "float32")
    jy = jstatic.data("y", [8, 1], "int64")
    jloss = jnn.functional.cross_entropy(jnn.functional.relu(ref(jx)), jy)
    (ref_loss,) = jstatic.Executor().run(feed={"x": a, "y": b},
                                         fetch_list=[jloss])
    paddle.disable_static()
    dy = F.cross_entropy(F.relu(port(torch.from_numpy(a))),
                         torch.from_numpy(b))
    assert float(static_loss) == float(dy.detach())
    assert _rel(static_loss, ref_loss) <= FWD_TOL


def test_clone_for_test_strips_dropout_and_runs_batch_norm_on_its_stats():
    x = static.data("x", [4, 3, 2, 2], "float32")
    bn = nn.BatchNorm2D(3)
    with torch.no_grad():
        bn._mean.copy_(torch.tensor([0.5, -1.0, 2.0]))
        bn._variance.copy_(torch.tensor([2.0, 0.5, 1.5]))
    y = F.dropout(bn(x), 0.9, training=True)
    prog = static.default_main_program()
    assert _types(prog) == ["batch_norm_train_stats", "dropout_op"]
    test_prog = prog.clone(for_test=True)
    assert _types(test_prog) == ["batch_norm_infer", "identity"]
    assert test_prog.buffer_updates == [] and len(prog.buffer_updates) == 2
    a = np.random.RandomState(0).randn(4, 3, 2, 2).astype(np.float32)
    (out,) = static.Executor().run(test_prog, feed={"x": a}, fetch_list=[y])
    jx = jstatic.data("x", [4, 3, 2, 2], "float32")
    jbn = jnn.BatchNorm2D(3)
    jbn._mean.set_value(bn._mean.numpy())
    jbn._variance.set_value(bn._variance.numpy())
    jy = jnn.functional.dropout(jbn(jx), 0.9, training=True)
    jtest = jstatic.default_main_program().clone(for_test=True)
    assert _types(jtest) == _types(test_prog)
    (want,) = jstatic.Executor().run(jtest, feed={"x": a}, fetch_list=[jy])
    assert _rel(out, want) <= FWD_TOL
    np.testing.assert_array_equal(bn._mean.numpy(), [0.5, -1.0, 2.0])


def test_dropout_draws_fresh_bits_every_run():
    paddle.seed(5)
    x = static.data("x", [1000], "float32")
    y = F.dropout(x, 0.5, training=True)
    exe = static.Executor()
    a = np.ones(1000, np.float32)
    (o1,) = exe.run(feed={"x": a}, fetch_list=[y])
    (o2,) = exe.run(feed={"x": a}, fetch_list=[y])
    for o in (o1, o2):
        assert set(np.unique(o)) == {0.0, 2.0}
        assert 0.4 < (o == 0).mean() < 0.6
    assert not np.array_equal(o1, o2)


def test_batch_norm_run_without_optimizer_moves_running_stats():
    x = static.data("x", [16, 4], "float32")
    bn = nn.BatchNorm1D(4, momentum=0.5)
    y = bn(x).mean()
    a = (np.random.RandomState(0).randn(16, 4) * 2 + 3).astype(np.float32)
    static.Executor().run(feed={"x": a}, fetch_list=[y])
    np.testing.assert_allclose(bn._mean.numpy(), 0.5 * a.mean(0), rtol=1e-6)


def test_interpreter_drops_each_var_after_its_last_use():
    """The compiled program's interpreter frees every intermediate after
    the last op that reads it (so a captured graph's pool can reuse its
    memory), and keeps the fetch targets and the buffer-update sources to
    the end; the values fetched are those of the eager forward."""
    x = static.data("x", [16, 4], "float32")
    lin = nn.Linear(4, 4)
    bn = nn.BatchNorm1D(4)
    mid = F.relu(lin(x))
    y = (bn(mid) + mid).mean()
    a = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    exe = static.Executor()
    got_mid, got_y = exe.run(feed={"x": a}, fetch_list=[mid, y])
    (cp,) = exe._cache.values()
    net = cp.step.network
    keep = {mid.name, y.name} | {n for _, n in net.buffer_updates}
    freed = [n for names in net._free for n in names]
    assert len(freed) == len(set(freed)) and not keep & set(freed)
    for i, op in enumerate(net.ops):
        for n in op.out_names:
            if n not in keep:
                last = max([j for j, o in enumerate(net.ops)
                            if ("var", n) in o.in_refs] + [i])
                assert n in net._free[last], (op.op_type, n)
    paddle.disable_static()
    try:
        w, b = lin.weight.detach().numpy(), lin.bias.detach().numpy()
        want_mid = np.maximum(a @ w + b, 0)
        var = want_mid.var(0)
        norm = (want_mid - want_mid.mean(0)) / np.sqrt(var + 1e-5)
        want_y = (norm + want_mid).mean()
    finally:
        paddle.enable_static()
    np.testing.assert_allclose(got_mid, want_mid, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-6)


def test_optimizer_parameter_subset_is_respected():
    jfrozen, frozen = _linear_pair(3, 3, seed=1)
    jhead, head = _linear_pair(3, 2, seed=2)
    frozen0 = frozen.weight.detach().clone()
    head0 = head.weight.detach().clone()
    a = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    lab = np.array([[0], [1], [1], [0]], np.int64)
    for pkg, st, fr, hd in ((jpaddle, jstatic, jfrozen, jhead),
                            (paddle, static, frozen, head)):
        x = st.data("x", [4, 3], "float32")
        y = st.data("y", [4, 1], "int64")
        loss = pkg.nn.functional.cross_entropy(hd(fr(x)), y)
        pkg.optimizer.SGD(learning_rate=0.5,
                          parameters=hd.parameters()).minimize(loss)
        st.Executor().run(feed={"x": a, "y": lab}, fetch_list=[loss])
    for ref, port in ((jfrozen, frozen), (jhead, head)):
        for name in ("weight", "bias"):
            assert _rel(getattr(port, name).detach().numpy(),
                        getattr(ref, name).numpy()) <= FWD_TOL
    assert not torch.equal(head.weight, head0)
    assert torch.equal(frozen.weight, frozen0)


def test_an_expression_of_a_parameter_trains_the_parameter():
    w0 = np.array([[0.5, -0.5, 1.0], [-0.25, 0.75, 0.25]], np.float32)
    a = np.random.RandomState(0).randn(4, 2).astype(np.float32)
    lab = np.array([[0], [1], [2], [1]], np.int64)
    out = []
    for pkg, st, matmul in ((jpaddle, jstatic, jpaddle.matmul),
                            (paddle, static, F.matmul)):
        w = pkg.framework.Parameter(w0.copy())
        x = st.data("x", [4, 2], "float32")
        y = st.data("y", [4, 1], "int64")
        logits = matmul(x, pkg.nn.functional.relu(w))
        both = logits + logits
        loss = pkg.nn.functional.cross_entropy(both, y)
        pkg.optimizer.SGD(learning_rate=0.1, parameters=[w]).minimize(loss)
        st.Executor().run(feed={"x": a, "y": lab}, fetch_list=[loss])
        out.append(np.asarray(w.numpy()))
    assert not np.array_equal(out[1], w0)
    assert _rel(out[1], out[0]) <= FWD_TOL
    assert _types(static.default_main_program())[0] == "relu"


def test_a_torch_call_on_a_variable_outside_a_registered_op_raises():
    x = static.data("x", [2, 3], "float32")
    with pytest.raises(TypeError, match="exp"):
        torch.exp(x)
    # an operator without a registered op raises too (`*` records
    # elementwise_mul)
    with pytest.raises(TypeError, match="Variable"):
        x << 1
    with pytest.raises(TypeError, match="static graph"):
        torch.nn.functional.softplus(x)
    with pytest.raises(RuntimeError, match="item"):
        x.item()
    with pytest.raises(RuntimeError, match="no value"):
        x.numpy()
    assert static.default_main_program().ops == []
    # a function of the shape alone folds to a constant of the staged shape
    z = torch.zeros_like(x)
    assert not isinstance(z, static.Variable) and tuple(z.shape) == (2, 3)


def test_static_mode_switches():
    assert paddle.in_static_mode() and not paddle.in_dygraph_mode()
    paddle.disable_static()
    assert paddle.in_dygraph_mode()
    # dygraph: a registered op runs at once
    assert float(F.relu(torch.tensor(-1.0))) == 0.0
    paddle.enable_static()
    x = static.data("x", [3], "float32")
    assert isinstance(F.relu(x), static.Variable)


def test_save_and_load_persistables(tmp_path):
    x = static.data("x", [4, 3, 2, 2], "float32")
    conv = nn.Conv2D(3, 2, 1)
    bn = nn.BatchNorm2D(2)
    y = bn(conv(x))
    prog = static.default_main_program()
    static.Executor().run(feed={"x": np.ones((4, 3, 2, 2), np.float32)},
                          fetch_list=[y])
    saved = {t: t.detach().clone() for t in (conv.weight, conv.bias,
                                             bn._mean, bn._variance)}
    static.save(prog, str(tmp_path / "m"))
    held = conv.weight
    with torch.no_grad():
        for t in saved:
            t.zero_()
    static.load(prog, str(tmp_path / "m"))
    assert conv.weight is held
    for t, v in saved.items():
        assert torch.equal(t, v)


def _resnet_program(pkg, st, net, dtype, hw):
    img = st.data("image", [-1, 3, hw, hw], dtype)
    label = st.data("label", [-1, 1], "int64")
    loss = pkg.nn.functional.cross_entropy(net(img), label)
    pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss


def test_bert_predictor_program_is_the_references_op_for_op():
    """inference_bench.py bench_bert's program at bert_tiny's size: the
    recorded op types, and those after the inference fusion, equal the
    reference's; the port's program from the reference's weights gives
    the reference's logits."""
    from paddle_tpu.models import bert_tiny as jbert_tiny
    from paddle_tpu.static.passes import apply_inference_fusion as jfusion
    from paddle_tpu_torch.models import bert_tiny
    from paddle_tpu_torch.static.passes import apply_inference_fusion
    jpaddle.seed(0)
    ref = jbert_tiny()
    ref.eval()
    port = bert_tiny(seed=1)
    port.eval()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    jids = jstatic.data("ids", [2, 16], "int64")
    ids = static.data("ids", [2, 16], "int64")
    jout, out = ref(jids)[0], port(ids)[0]
    jprog, prog = jstatic.default_main_program(), static.default_main_program()
    assert _types(prog) == _types(jprog)
    assert _types(prog).count("flash_attention") == 2
    jfused = jfusion(jprog, protected={jout.name})
    fused = apply_inference_fusion(prog, protected={out.name})
    assert _types(fused) == _types(jfused)
    a = np.random.RandomState(0).randint(0, 1024, (2, 16)).astype(np.int64)
    (want,) = jstatic.Executor().run(jfused, feed={"ids": a},
                                     fetch_list=[jout])
    (got,) = static.Executor().run(fused, feed={"ids": a}, fetch_list=[out])
    assert got.shape == (2, 16, 1024) and _rel(got, want) <= TRAIN_TOL
