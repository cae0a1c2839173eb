"""The port's recurrent family against the JAX package, on the CPU: the
fused op `ops.rnn_ops.rnn` (outputs and every input's gradient), the
cells, `RNN` and `BiRNN` with lengths, `get_initial_states`, the fused
classes' parameters, `rnn` in a static Program and under auto_cast, and
the Zaremba et al. (2014) LSTM language model of `chip_smoke.py` phase 24
(`ptb_model`, `ptb_loss`) at a small size, trained two clipped SGD steps
through both packages' make_train_step with the states carried.

Size: B = 3, T = 5, input 4, hidden 6 (the op and the classes); the
language model vocab 100, hidden 32, 2 layers, B = 4, T = 8. Each port
module gets the reference's weights (`load_reference_state`) and the
same numpy inputs; where outputs are compared, dropout is 0 or has no
key to draw with (the two packages' generators differ).

Tolerances: forward values within 1e-5 and gradients, losses and
parameters within 1e-4 of the largest |value| of each array (float32
sums over at most T steps in another order).
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import static as jstatic
from paddle_tpu.amp import auto_cast as jauto_cast
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.ops import rnn_ops as jrnn_ops
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import amp, nn, optimizer, static
from paddle_tpu_torch.framework import place as tplace
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import (export_reference_state,
                                     load_reference_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import rnn_ops
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

B, T, I, H = 3, 5, 4, 6
FWD, REL = 1e-5, 1e-4
LENS = np.array([5, 2, 3], np.int64)


@pytest.fixture(autouse=True)
def cpu_place():
    """The port's entry points on the CPU, the place put back after."""
    saved = tplace._current_place
    tpaddle.set_device("cpu")
    yield
    tplace._current_place = saved


def _rel(got, want, tol, what=""):
    """|got - want| <= tol * max |want|, the array's own largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), np.finfo(np.float32).tiny)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, (what, err, scale)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy())


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _carry(ref, port):
    load_reference_state(port, _state(ref))
    return port


def _weights(mode, layers, dirs, seed=1):
    """Per (layer, direction): w_ih, w_hh, b_ih, b_hh as numpy."""
    G = rnn_ops.GATES[mode] * H
    out, k = [], seed
    for layer in range(layers):
        for _ in range(dirs):
            in_sz = I if layer == 0 else H * dirs
            for shape in ((G, in_sz), (G, H), (G,), (G,)):
                out.append(_rand(*shape, seed=k, scale=0.4))
                k += 1
    return out


# (mode, layers, directions, time_major, lengths): a covering set in
# which each option appears
OP_CASES = [("RNN_TANH", 1, 1, False, False),
            ("RNN_RELU", 2, 2, True, True),
            ("LSTM", 2, 1, False, True),
            ("LSTM", 1, 2, True, False),
            ("LSTM", 2, 2, False, True),
            ("GRU", 2, 2, False, True),
            ("GRU", 1, 1, True, False),
            ("RNN_TANH", 2, 1, True, True)]


@pytest.mark.parametrize("mode,layers,dirs,time_major,lengths", OP_CASES)
def test_rnn_op_and_its_gradients_match_the_reference(mode, layers, dirs,
                                                      time_major, lengths):
    """y, h_n (c_n), and the gradients of x, h0, c0 and every weight under
    one cotangent, against the reference's `rnn` through jax.vjp. With 2
    layers the dropout is 0.5 but no key is given, as a recorded program
    calls the op: neither package drops (the reference drops only with a
    key)."""
    lstm = mode == "LSTM"
    x = _rand(*((T, B, I) if time_major else (B, T, I)))
    h0 = _rand(layers * dirs, B, H, seed=2)
    c0 = _rand(layers * dirs, B, H, seed=3) if lstm else None
    ws = _weights(mode, layers, dirs)
    attrs = dict(mode=mode, num_layers=layers, num_directions=dirs,
                 time_major=time_major, dropout=0.5 if layers == 2 else 0.0,
                 has_bias=True)
    seq = LENS if lengths else None
    prim = [x, h0] + ([c0] if lstm else []) + ws

    def jfn(x, h0, *rest):
        c = rest[0] if lstm else None
        w = rest[1:] if lstm else rest
        return jrnn_ops.rnn.fn(x, h0, c, seq, None, *w, **attrs)

    n_out = 3 if lstm else 2
    shapes = [(T, B, dirs * H) if time_major else (B, T, dirs * H)] + [
        (layers * dirs, B, H)] * (n_out - 1)
    cts = [_rand(*s, seed=10 + i) for i, s in enumerate(shapes)]

    @jax.jit
    def ref_run(prim, cts):
        out, vjp = jax.vjp(jfn, *prim)
        return out, vjp(tuple(cts))
    want, want_g = ref_run(prim, cts)
    tin = [torch.tensor(a, requires_grad=True) for a in prim]
    tc = tin[2] if lstm else None
    tw = tin[3:] if lstm else tin[2:]
    got = rnn_ops.rnn(tin[0], tin[1], tc,
                      None if seq is None else torch.from_numpy(seq), None,
                      *tw, **attrs)
    assert len(got) == len(want) == (3 if lstm else 2)
    for i, (g, w) in enumerate(zip(got, want)):
        _rel(_np(g), w, FWD, "output %d" % i)
    got_g = torch.autograd.grad(got, tin, [torch.from_numpy(c) for c in cts])
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _rel(_np(g), w, REL, "gradient of input %d" % i)
    if lengths:                     # padded steps output zeros
        y = _np(got[0]) if not time_major else _np(got[0]).swapaxes(0, 1)
        assert np.abs(y[1, 2:]).max() == 0.0


CELLS = {"SimpleRNNCell": {}, "relu": {"activation": "relu"},
         "LSTMCell": {}, "GRUCell": {}}


def _cell(name, pkg, **kw):
    cls = "SimpleRNNCell" if name == "relu" else name
    return getattr(pkg, cls)(I, H, **CELLS[name], **kw)


def _cell_states(name, seed=4):
    if name == "LSTMCell":
        return (_rand(B, H, seed=seed), _rand(B, H, seed=seed + 1))
    return _rand(B, H, seed=seed)


def _to(pkg_tensor, states, grad=False):
    if isinstance(states, tuple):
        return tuple(_to(pkg_tensor, s, grad) for s in states)
    if pkg_tensor is torch.tensor:
        return torch.tensor(states, requires_grad=grad)
    return paddle.to_tensor(states, stop_gradient=not grad)


def _flat(s):
    return list(s) if isinstance(s, tuple) else [s]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_step_and_its_gradients_match_the_reference(name):
    """One step from given states: the output, the new states and the
    gradients of the input, the states and the four weights."""
    paddle.seed(0)
    ref = _cell(name, jnn)
    port = _carry(ref, _cell(name, nn))
    x, st = _rand(B, I), _cell_states(name)
    jx, tx = paddle.to_tensor(x, stop_gradient=False), torch.tensor(
        x, requires_grad=True)
    js, ts = _to(paddle.to_tensor, st, True), _to(torch.tensor, st, True)
    jo, jn = ref(jx, js)
    to, tn = port(tx, ts)
    for got, want in zip([to] + _flat(tn), [jo] + _flat(jn)):
        _rel(_np(got), _np(want), FWD, name)
    g = _rand(B, H, seed=9)
    (sum(o * paddle.to_tensor(g) for o in _flat(jn))).sum().backward()
    (sum(o * torch.from_numpy(g) for o in _flat(tn))).sum().backward()
    pairs = [(tx, jx)] + list(zip(_flat(ts), _flat(js))) + [
        (getattr(port, k), getattr(ref, k))
        for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    for t, j in pairs:
        _rel(_np(t.grad), _np(j.grad), REL, name)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_get_initial_states_matches_the_reference(name):
    """Shapes, values, dtype and nesting from a batch reference, batch on
    axis 0 and 1, with an init value and a dtype."""
    ref, port = _cell(name, jnn), _cell(name, nn)
    x = _rand(2, 7, I)
    for kw in ({}, {"batch_dim_idx": 1, "init_value": 0.5},
               {"dtype": "float64", "init_value": -1.0}):
        want = ref.get_initial_states(paddle.to_tensor(x), **kw)
        got = port.get_initial_states(torch.from_numpy(x), **kw)
        assert isinstance(got, tuple) == isinstance(want, tuple)
        for g, w in zip(_flat(got), _flat(want)):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_array_equal(g.numpy(), w.numpy())
            assert str(g.dtype).split(".")[-1] == str(w.dtype).split(".")[-1]


# (cell, wrapper, time_major): RNN forward and reverse, BiRNN
WRAP_CASES = [("LSTMCell", "RNN", False), ("SimpleRNNCell", "RNN_reverse",
                                           True),
              ("GRUCell", "BiRNN", False), ("LSTMCell", "BiRNN", True)]


def _wrap(pkg, cells, kind, time_major):
    if kind == "BiRNN":
        return pkg.BiRNN(cells[0], cells[1], time_major=time_major)
    return pkg.RNN(cells[0], is_reverse=kind == "RNN_reverse",
                   time_major=time_major)


@pytest.mark.parametrize("cell,kind,time_major", WRAP_CASES)
def test_rnn_and_birnn_with_lengths_match_the_reference(cell, kind,
                                                        time_major):
    """The eager wrappers with sequence_length: outputs (zeros past each
    length), final states (kept from each row's last valid step) and the
    input's gradient."""
    paddle.seed(1)
    refs = [_cell(cell, jnn), _cell(cell, jnn)]
    ports = [_carry(r, _cell(cell, nn)) for r in refs]
    ref = _wrap(jnn, refs, kind, time_major)
    port = _wrap(nn, ports, kind, time_major)
    x = _rand(*((T, B, I) if time_major else (B, T, I)))
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    jy, js = ref(jx, sequence_length=paddle.to_tensor(LENS))
    ty, ts = port(tx, sequence_length=torch.from_numpy(LENS))
    _rel(_np(ty), _np(jy), FWD, "y")

    def leaves(s):
        if isinstance(s, (tuple, list)):
            return [e for x in s for e in leaves(x)]
        return [s]
    for g, w in zip(leaves(ts), leaves(js)):
        _rel(_np(g), _np(w), FWD, "states")
    g = _rand(*ty.shape, seed=5)
    (jy * paddle.to_tensor(g)).sum().backward()
    (ty * torch.from_numpy(g)).sum().backward()
    _rel(_np(tx.grad), _np(jx.grad), REL, "dx")


def test_birnn_equals_the_fused_gru():
    """BiRNN(GRUCell, GRUCell) and GRU(direction="bidirect") with the same
    weights give the same outputs and final states, with lengths."""
    gen = torch.Generator().manual_seed(0)
    gru = nn.GRU(I, H, direction="bidirect", generator=gen)
    cells = [nn.GRUCell(I, H), nn.GRUCell(I, H)]
    with torch.no_grad():
        for cell, sfx in zip(cells, ("", "_reverse")):
            for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(cell, k).copy_(getattr(gru, k + "_l0" + sfx))
    x, lens = torch.from_numpy(_rand(B, T, I)), torch.from_numpy(LENS)
    y, h = gru(x, sequence_length=lens)
    yb, (sf, sb) = nn.BiRNN(*cells)(x, sequence_length=lens)
    _rel(_np(yb), _np(y), FWD)
    _rel(_np(sf), _np(h[0]), FWD)
    _rel(_np(sb), _np(h[1]), FWD)


CLASS_CASES = [("SimpleRNN", {"activation": "relu"}), ("LSTM", {}),
               ("GRU", {})]


@pytest.mark.parametrize("cls,kw", CLASS_CASES, ids=[c for c, _ in
                                                     CLASS_CASES])
def test_fused_class_matches_the_reference(cls, kw):
    """2 layers, "bidirectional": the parameters' names in the
    reference's order, shapes, the Uniform(-1/sqrt(H), 1/sqrt(H)) bounds;
    with carried weights and initial states, the outputs and the input's
    gradient; the state dict exported back under the same names."""
    paddle.seed(2)
    ref = getattr(jnn, cls)(I, H, num_layers=2, direction="bidirectional",
                            **kw)
    port = getattr(nn, cls)(I, H, num_layers=2, direction="bidirect",
                            generator=torch.Generator().manual_seed(0), **kw)
    want = [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    assert [(n, tuple(p.shape)) for n, p in port.named_parameters()] == want
    bound = 1.0 / np.sqrt(H)
    for p in port.parameters():
        assert np.abs(_np(p)).max() <= bound
        assert np.abs(_np(p)).max() > 0.5 * bound
    _carry(ref, port)
    assert sorted(export_reference_state(port)) == sorted(_state(ref))
    x = _rand(B, T, I)
    h0 = _rand(4, B, H, seed=3)
    st = (h0, _rand(4, B, H, seed=4)) if cls == "LSTM" else h0
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    jy, jh = ref(jx, _to(paddle.to_tensor, st),
                 sequence_length=paddle.to_tensor(LENS))
    ty, th = port(tx, _to(torch.tensor, st),
                  sequence_length=torch.from_numpy(LENS))
    _rel(_np(ty), _np(jy), FWD, "y")
    for g, w in zip(_flat(th), _flat(jh)):
        _rel(_np(g), _np(w), FWD, "h_n")
    jy.sum().backward()
    ty.sum().backward()
    _rel(_np(tx.grad), _np(jx.grad), REL, "dx")


def test_param_attr_and_direction_checks():
    """weight_ih_attr / bias_hh_attr take their initializer and trainable
    flag; an unknown direction raises as in the reference."""
    lstm = nn.LSTM(I, H, weight_ih_attr=nn.ParamAttr(
        initializer=nn.initializer.Constant(0.5)), bias_hh_attr=nn.ParamAttr(
        trainable=False), generator=torch.Generator().manual_seed(0))
    assert torch.all(lstm.weight_ih_l0 == 0.5)
    assert not lstm.bias_hh_l0.requires_grad
    assert lstm.bias_hh_l0.abs().max() <= 1.0 / np.sqrt(H)
    with pytest.raises(ValueError):
        nn.GRU(I, H, direction="backward")
    with pytest.raises(ValueError):
        nn.SimpleRNN(I, H, activation="gelu")


def test_rnn_stays_uncast_under_auto_cast():
    """`rnn` is on neither auto_cast list: under O1 bfloat16 a float32 LSTM
    runs in float32 in both packages, to the same values."""
    paddle.seed(3)
    ref = jnn.LSTM(I, H)
    port = _carry(ref, nn.LSTM(I, H))
    x = _rand(B, T, I)
    with jauto_cast(level="O1", dtype="bfloat16"):
        jy, (jh, _) = ref(paddle.to_tensor(x))
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        ty, (th, _) = port(torch.from_numpy(x))
    assert ty.dtype == torch.float32 and str(jy.dtype).endswith("float32")
    _rel(_np(ty), _np(jy), FWD)
    _rel(_np(th), _np(jh), FWD)


def test_static_program_records_rnn_and_runs():
    """A static Program over a 2-layer GRU records the op type `rnn`, as the
    reference's does, and the Executor's run equals the dygraph forward
    on the same weights."""
    gru = nn.GRU(I, H, num_layers=2, generator=torch.Generator().manual_seed(
        0))
    x = _rand(B, T, I)
    want, _ = gru(torch.from_numpy(x))
    types = []
    for pkg, st, layer in ((paddle, jstatic, jnn.GRU(I, H, num_layers=2)),
                           (tpaddle, static, gru)):
        pkg.enable_static()
        try:
            main = st.Program()
            with st.program_guard(main, st.Program()):
                y, _ = layer(st.data("x", [B, T, I], "float32"))
            types.append([op.op_type for op in main.ops])
            if pkg is tpaddle:
                (got,) = st.Executor("cpu").run(main, feed={"x": x},
                                                fetch_list=[y])
        finally:
            pkg.disable_static()
    assert types[0] == types[1] == ["rnn"]
    _rel(np.asarray(got), _np(want), FWD)


def test_inter_layer_dropout_structure():
    """p > 0 with a key (training): between the layers each value is 0 or
    scaled by 1/(1 - p), a fresh mask on each call; eval and p = 0 apply
    none, and neither does p > 0 without a key (the reference drops only
    with one)."""
    p = 0.5
    x = torch.from_numpy(_rand(32, T, I))
    ws = [torch.from_numpy(w) for w in _weights("RNN_TANH", 2, 1)]
    eye = torch.eye(H)
    # layer 2 passes its input through (W_ih = I stacked over H = in,
    # W_hh = 0, no bias) into relu, so its output is the dropped layer 1
    # output where that is positive
    ws[4], ws[5] = eye, torch.zeros(H, H)
    ws[6], ws[7] = torch.zeros(H), torch.zeros(H)
    h0 = torch.zeros(2, 32, H)
    kw = dict(mode="RNN_RELU", num_layers=2)
    y1, _ = rnn_ops.rnn(x, h0, None, None, None, *ws, **kw)
    yd, _ = rnn_ops.rnn(x, h0, None, None, True, *ws, dropout=p, **kw)
    yd2, _ = rnn_ops.rnn(x, h0, None, None, True, *ws, dropout=p, **kw)
    yk, _ = rnn_ops.rnn(x, h0, None, None, None, *ws, dropout=p, **kw)
    assert torch.equal(yk, y1)
    live = y1 > 0
    kept = (yd != 0) & live
    assert 0.3 < kept.sum().item() / live.sum().item() < 0.7
    torch.testing.assert_close(yd[kept], y1[kept] / (1 - p), rtol=1e-6,
                               atol=0)
    assert not torch.equal(yd, yd2)
    lstm = nn.LSTM(I, H, num_layers=2, dropout=p)
    lstm.eval()
    a, _ = lstm(x)
    b, _ = lstm(x)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the language model of phase 24 at a small size

V, LH, LB, LT = 100, 32, 4, 8


def _jptb_model(vocab, hidden, layers, dropout, init):
    """The reference's twin of chip_smoke.ptb_model."""
    def attr():
        return jnn.ParamAttr(initializer=jnn.initializer.Uniform(-init,
                                                                 init))

    class LSTMLM(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = jnn.Embedding(vocab, hidden, weight_attr=attr())
            self.drop_in = jnn.Dropout(dropout)
            self.lstm = jnn.LSTM(hidden, hidden, layers, dropout=dropout,
                                 weight_ih_attr=attr(), weight_hh_attr=attr(),
                                 bias_ih_attr=attr(), bias_hh_attr=attr())
            self.drop_out = jnn.Dropout(dropout)
            self.proj = jnn.Linear(hidden, vocab, weight_attr=attr(),
                                   bias_attr=attr())

        def forward(self, ids, h0, c0):
            y, (h, c) = self.lstm(self.drop_in(self.embedding(ids)),
                                  (h0, c0))
            return self.proj(self.drop_out(y)), h, c

    return LSTMLM()


def _lm_batch(seed):
    ids = np.random.RandomState(seed).randint(0, V, (LB, LT + 1))
    return ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)


def test_language_model_two_clipped_sgd_steps_match_the_reference():
    """vocab 100, hidden 32, 2 layers, B = 4, T = 8, p = 0, weights from
    Uniform(-1.5, 1.5) (a wider draw than the paper's 0.04, so that the
    gradients' global norm passes the clip's 10): step 1's gradients, then two SGD(1.0)
    steps under ClipGradByGlobalNorm(10) with h_n, c_n carried from step
    1 into step 2: the losses, the carried states and every parameter."""
    paddle.seed(4)
    ref = _jptb_model(V, LH, 2, 0.0, 1.5)
    port = _carry(ref, chip_smoke.ptb_model(V, LH, 2, 0.0, 1.5,
                                            device="cpu"))
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    (x1, y1), (x2, y2) = _lm_batch(0), _lm_batch(1)
    z = np.zeros((2, LB, LH), np.float32)
    jl = chip_smoke.ptb_loss(JF, ref(paddle.to_tensor(x1), paddle.to_tensor(
        z), paddle.to_tensor(z))[0], paddle.to_tensor(y1))
    tl = chip_smoke.ptb_loss(F, port(torch.from_numpy(x1), torch.from_numpy(
        z), torch.from_numpy(z))[0], torch.from_numpy(y1))
    jl.backward()
    tl.backward()
    norm2 = 0.0
    for n, p in ref.named_parameters():
        _rel(_np(dict(port.named_parameters())[n].grad), _np(p.grad), REL, n)
        norm2 += float((_np(p.grad).astype(np.float64) ** 2).sum())
        p.clear_gradient()
    port.zero_grad(set_to_none=True)
    assert np.sqrt(norm2) > 10.0    # the clip acts on step 1

    jopt_ = jopt.SGD(learning_rate=1.0, parameters=ref.parameters(),
                     grad_clip=jopt.ClipGradByGlobalNorm(10.0))
    topt = optimizer.SGD(learning_rate=1.0, parameters=port.parameters(),
                         grad_clip=optimizer.ClipGradByGlobalNorm(10.0))
    jstep = jmake_train_step(ref, lambda o, h, c, y: chip_smoke.ptb_loss(
        JF, o, y), jopt_)
    tstep = make_train_step(port, lambda o, h, c, y: chip_smoke.ptb_loss(
        F, o, y), topt)
    jh = jc = paddle.to_tensor(z)
    th = tc = torch.from_numpy(z)
    for x, y in ((x1, y1), (x2, y2)):
        jloss, (_, jh, jc) = jstep([paddle.to_tensor(x), jh, jc],
                                   [paddle.to_tensor(y)])
        tloss, (_, th, tc) = tstep([torch.from_numpy(x), th, tc],
                                   [torch.from_numpy(y)])
        _rel(_np(tloss), _np(jloss), REL, "loss")
        _rel(_np(th), _np(jh), REL, "h_n")
        _rel(_np(tc), _np(jc), REL, "c_n")
    for n, p in ref.named_parameters():
        _rel(_np(dict(port.named_parameters())[n]), _np(p), REL, n)


def test_language_model_dropout_masks_at_p():
    """p = 0.65 in training: the embedding's dropout zeroes about 65 % of
    the values and scales the rest by 1/(1 - p); two calls draw two
    masks."""
    model = chip_smoke.ptb_model(V, LH, 2, 0.65, 0.04, device="cpu")
    model.train()
    e = model.embedding(torch.from_numpy(_lm_batch(0)[0]))
    a, b = model.drop_in(e), model.drop_in(e)
    kept = a != 0
    assert 0.25 < kept.float().mean().item() < 0.45
    torch.testing.assert_close(a[kept], e[kept] / 0.35, rtol=1e-6, atol=0)
    assert not torch.equal(a, b)
