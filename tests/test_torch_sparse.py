"""Row-sparse gradients of the port against the JAX package's, on the CPU.

Every case of tests/test_sparse_grads.py, held against the reference on
the same seeded numpy inputs (the port's table weights carried into the
reference's layer): `nn.Embedding(sparse=True)` gives a SelectedRows
gradient equal to the reference's (rows exact, values within 1e-6), the
padding rows zero, two backwards append (2 x 15 rows) and `merged()`
folds them, a dense gradient met with a sparse one is dense, a captured
step (`make_train_step`) stays dense and counts its dense lookups; SGD,
Adam (lazy and not) and AdamW (lazy) over 3 steps give the reference's
parameters and moments within 1e-6 (rtol 1e-6, atol 1e-7). AdamW over a
sparse table and dense parameters sends the dense ones to the row 7
kernel's wrapper in one group and keeps the table out of it. The small
DLRM of chip_smoke.py phase 27 (`dlrm_model(**DLRM_SMALL)`) against a
twin built from the JAX package, 3 steps of SGD and of lazy Adam,
float32: losses and parameters within 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import SelectedRows as JSelectedRows
from paddle_tpu.jit.engine import make_train_step as jmake_train_step

import paddle_tpu_torch as paddle
from paddle_tpu_torch import SelectedRows, nn
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.framework import selected_rows
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.ops import cuda_kernels as ck
import chip_smoke as cs
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

RTOL, ATOL = 1e-6, 1e-7
DLRM_TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    saved = pplace._current_place
    paddle.set_device("cpu")
    yield
    pplace._current_place = saved


def _ids(shape=(3, 5), vocab=50, seed=0, dup=True):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, shape).astype(np.int64)
    if dup:
        ids.flat[0] = ids.flat[1]
    return ids


def _pair(vocab=50, dim=8, sparse=True, seed=0, **kw):
    """(port Embedding, reference Embedding) holding the same weights."""
    torch.manual_seed(seed)
    emb = nn.Embedding(vocab, dim, sparse=sparse, **kw)
    jpaddle.seed(seed)
    jemb = jpaddle.nn.Embedding(vocab, dim, sparse=sparse, **kw)
    # a copy: JAX on the CPU may alias a numpy buffer it is given, and
    # the port updates its tensor in place
    jemb.weight.set_value(emb.weight.detach().numpy().copy())
    return emb, jemb


def _both(emb, jemb, ids, fn=lambda y: (y ** 2).sum()):
    fn(emb(torch.from_numpy(ids))).backward()
    fn(jemb(jpaddle.to_tensor(ids))).backward()


def _same_rows(g, jg):
    assert isinstance(g, SelectedRows) and isinstance(jg, JSelectedRows)
    assert g.height == jg.height and g.shape == jg.shape
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_allclose(g.values.numpy(), np.asarray(jg.values),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), jg.numpy(), rtol=RTOL, atol=ATOL)


class TestSparseBackward:
    def test_grad_is_selected_rows_and_matches_dense(self):
        ids = _ids()
        emb, jemb = _pair()
        _both(emb, jemb, ids)
        _same_rows(emb.weight.grad, jemb.weight.grad)
        dense, _ = _pair(sparse=False)
        (dense(torch.from_numpy(ids)) ** 2).sum().backward()
        np.testing.assert_allclose(emb.weight.grad.numpy(),
                                   dense.weight.grad.numpy(), rtol=RTOL,
                                   atol=ATOL)

    def test_padding_idx_rows_are_zero(self):
        ids = _ids()
        pad = int(ids.flat[2])
        emb, jemb = _pair(padding_idx=pad)
        _both(emb, jemb, ids, fn=lambda y: y.sum())
        g = emb.weight.grad
        assert g.rows.shape[0] == ids.size         # one row per id, kept
        assert np.abs(g.numpy()[pad]).max() == 0.0
        _same_rows(g, jemb.weight.grad)

    def test_accumulation_appends_then_merges(self):
        emb, jemb = _pair()
        for seed in (0, 1):
            _both(emb, jemb, _ids(seed=seed), fn=lambda y: y.sum())
        g, jg = emb.weight.grad, jemb.weight.grad
        assert g.rows.shape[0] == 2 * 15
        _same_rows(g, jg)
        merged, jmerged = g.merged(), jg.merged()
        assert merged.rows.shape[0] < g.rows.shape[0]
        _same_rows(merged, jmerged)
        np.testing.assert_allclose(merged.numpy(), g.numpy(), rtol=RTOL)
        assert g.append(g).rows.shape[0] == 60

    def test_dense_plus_sparse_accumulates_dense(self):
        emb, jemb = _pair()
        _both(emb, jemb, _ids(), fn=lambda y: y.sum())
        (emb.weight * 2.0).sum().backward()
        (jemb.weight * 2.0).sum().backward()
        g = emb.weight.grad
        assert not isinstance(g, SelectedRows)
        np.testing.assert_allclose(g.detach().numpy(),
                                   jemb.weight.grad.numpy(), rtol=RTOL,
                                   atol=ATOL)

    def test_clear_grad_drops_a_sparse_gradient(self):
        emb, _ = _pair()
        emb(torch.from_numpy(_ids())).sum().backward()
        opt = paddle.optimizer.SGD(0.1, parameters=emb.parameters())
        opt.clear_grad()
        assert emb.weight.grad is None
        emb(torch.from_numpy(_ids())).sum().backward()
        opt.clear_grad(set_to_zero=False)
        assert emb.weight.grad is None

    def test_traced_mode_stays_dense(self):
        """The captured step's body takes the dense gradient (counted in
        `dense_lookups`): its trajectory is the eager dense one's; the
        reference's traced step is dense too: the same trajectory."""
        ids = _ids()
        emb, jemb = _pair()
        dense, _ = _pair(sparse=False)
        w0 = emb.weight.detach().numpy().copy()
        opt = paddle.optimizer.SGD(0.1, parameters=emb.parameters())
        dopt = paddle.optimizer.SGD(0.1, parameters=dense.parameters())
        crit = lambda out, lab: (out ** 2).mean()  # noqa: E731
        jopt = jpaddle.optimizer.SGD(learning_rate=0.1,
                                     parameters=jemb.parameters())
        jstep = jmake_train_step(jemb, crit, jopt)
        selected_rows.dense_lookups(reset=True)
        step = make_train_step(emb, crit, opt)
        for _ in range(2):
            loss, _ = step([torch.from_numpy(ids)], [torch.from_numpy(ids)])
            dloss = crit(dense(torch.from_numpy(ids)), None)
            dloss.backward()
            dopt.step()
            dopt.clear_grad()
            jloss, _ = jstep([jpaddle.to_tensor(ids)],
                             [jpaddle.to_tensor(ids)])
            np.testing.assert_allclose(float(loss), float(dloss.detach()),
                                       rtol=RTOL)
            np.testing.assert_allclose(float(loss), float(jloss.numpy()),
                                       rtol=RTOL)
        # the body runs eagerly on the CPU: one dense lookup a call
        assert selected_rows.dense_lookups() == 2
        assert emb.weight.grad is None
        assert not np.allclose(emb.weight.detach().numpy(), w0)
        np.testing.assert_allclose(emb.weight.detach().numpy(),
                                   dense.weight.detach().numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(emb.weight.detach().numpy(),
                                   jemb.weight.numpy(), rtol=RTOL, atol=ATOL)

    def test_static_program_records_the_dense_op(self):
        from paddle_tpu_torch import static
        emb, _ = _pair()
        prog = static.Program()
        paddle.enable_static()
        try:
            with static.program_guard(prog):
                x = static.data("ids", [3, 5], "int64")
                emb(x)
        finally:
            paddle.disable_static()
        assert [op.op_type for op in prog.ops] == ["lookup_table_v2"]

    def test_a_table_that_is_not_a_leaf_takes_a_dense_gradient(self):
        w = torch.randn(10, 4, requires_grad=True)
        out = paddle.nn.functional.embedding(
            torch.tensor([1, 1, 3]), w * 2.0, sparse=True)
        out.sum().backward()
        assert not w.grad.is_sparse
        np.testing.assert_allclose(w.grad[1].numpy(), 4.0)


def _steps(make_opt, steps=3, **embkw):
    """Each package's weights (and moments) after `steps` steps of the
    sparse embedding, one batch of ids a step."""
    emb, jemb = _pair(**embkw)
    opt, jopt = make_opt(paddle, emb.parameters()), make_opt(
        jpaddle, jemb.parameters())
    for s in range(steps):
        _both(emb, jemb, _ids(seed=s, vocab=embkw.get("vocab", 50)),
              fn=lambda y: y.sum())
        opt.step()
        opt.clear_grad()
        jopt.step()
        jopt.clear_grad()
    return emb, jemb, opt, jopt


def _close_moments(emb, jemb, opt, jopt):
    accs = opt._get_accumulators(emb.weight)
    jaccs = jopt._get_accumulators(jemb.weight)
    for name in ("moment1", "moment2"):
        np.testing.assert_allclose(accs[name].numpy(),
                                   np.asarray(jaccs[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


class TestSparseOptimizers:
    def _check(self, make_opt, steps=3, moments=False, **embkw):
        emb, jemb, opt, jopt = _steps(make_opt, steps, **embkw)
        np.testing.assert_allclose(emb.weight.detach().numpy(),
                                   jemb.weight.numpy(), rtol=RTOL,
                                   atol=ATOL)
        if moments:
            _close_moments(emb, jemb, opt, jopt)
        return emb

    def test_sgd_sparse_matches_dense(self):
        emb = self._check(lambda m, ps: m.optimizer.SGD(
            learning_rate=0.1, parameters=ps))
        dense, _, _, _ = _steps(lambda m, ps: m.optimizer.SGD(
            learning_rate=0.1, parameters=ps), sparse=False)
        np.testing.assert_allclose(emb.weight.detach().numpy(),
                                   dense.weight.detach().numpy(), rtol=RTOL,
                                   atol=ATOL)

    def test_adam_nonlazy_sparse_matches_dense(self):
        emb = self._check(lambda m, ps: m.optimizer.Adam(
            learning_rate=0.1, parameters=ps), moments=True)
        dense, _, _, _ = _steps(lambda m, ps: m.optimizer.Adam(
            learning_rate=0.1, parameters=ps), sparse=False)
        np.testing.assert_allclose(emb.weight.detach().numpy(),
                                   dense.weight.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)

    def test_adam_lazy_first_step_matches_dense(self):
        emb = self._check(lambda m, ps: m.optimizer.Adam(
            learning_rate=0.1, parameters=ps, lazy_mode=True), steps=1,
            moments=True)
        dense, _, _, _ = _steps(lambda m, ps: m.optimizer.Adam(
            learning_rate=0.1, parameters=ps), steps=1, sparse=False)
        np.testing.assert_allclose(emb.weight.detach().numpy(),
                                   dense.weight.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)

    def test_adam_lazy_only_touches_seen_rows(self):
        torch.manual_seed(0)
        emb = nn.Embedding(100, 8, sparse=True)
        w0 = emb.weight.detach().numpy().copy()
        opt = paddle.optimizer.Adam(learning_rate=0.1, lazy_mode=True,
                                    parameters=emb.parameters())
        ids = _ids(vocab=10)
        for _ in range(3):
            emb(torch.from_numpy(ids)).sum().backward()
            opt.step()
            opt.clear_grad()
        w1 = emb.weight.detach().numpy()
        untouched = np.setdiff1d(np.arange(100), np.unique(ids))
        assert np.abs(w1[untouched] - w0[untouched]).max() == 0.0
        assert np.abs(w1[np.unique(ids)] - w0[np.unique(ids)]).min() > 0.0
        m1 = opt._get_accumulators(emb.weight)["moment1"].numpy()
        assert np.abs(m1[untouched]).max() == 0.0
        # and the reference's trajectory, moments too
        self._check(lambda m, ps: m.optimizer.Adam(
            learning_rate=0.1, parameters=ps, lazy_mode=True), moments=True,
            vocab=100)

    def test_adamw_lazy_decay_on_touched_rows(self):
        emb = self._check(lambda m, ps: m.optimizer.AdamW(
            learning_rate=0.1, weight_decay=0.5, parameters=ps,
            lazy_mode=True), moments=True, vocab=100)
        torch.manual_seed(0)
        emb = nn.Embedding(100, 8, sparse=True)
        w0 = emb.weight.detach().numpy().copy()
        opt = paddle.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                                     parameters=emb.parameters(),
                                     lazy_mode=True)
        emb(torch.tensor([[1, 2, 3]])).sum().backward()
        opt.step()
        untouched = np.setdiff1d(np.arange(100), [1, 2, 3])
        assert np.abs(emb.weight.detach().numpy()[untouched]
                      - w0[untouched]).max() == 0.0

    def test_weight_decay_densifies(self):
        self._check(lambda m, ps: m.optimizer.Adam(
            learning_rate=0.1, weight_decay=0.01, parameters=ps,
            lazy_mode=True), moments=True)

    def test_a_clip_densifies(self):
        self._check(lambda m, ps: m.optimizer.SGD(
            learning_rate=0.1, parameters=ps,
            grad_clip=m.optimizer.ClipGradByGlobalNorm(0.5)))

    def test_lr_scheduler_reaches_the_lazy_rule(self):
        self._check(lambda m, ps: m.optimizer.Adam(
            learning_rate=m.optimizer.lr.StepDecay(0.1, step_size=1,
                                                   gamma=0.5),
            parameters=ps, lazy_mode=True), moments=True)


def test_adamw_groups_dense_pairs_and_keeps_the_table_out(monkeypatch):
    from paddle_tpu_torch import optimizer as topt
    calls = []
    real = topt.fused_adamw_multi_or_none

    def spy(params, grads, *a, **k):
        calls.append([id(p) for p in params])
        return real(params, grads, *a, **k)
    monkeypatch.setattr(topt, "fused_adamw_multi_or_none", spy)
    torch.manual_seed(0)
    emb = nn.Embedding(30, 4, sparse=True)
    lin = nn.Linear(4, 3)
    lin2 = nn.Linear(3, 1)
    params = list(emb.parameters()) + list(lin.parameters()) + list(
        lin2.parameters())
    opt = paddle.optimizer.AdamW(learning_rate=0.01, lazy_mode=True,
                                 parameters=params)
    for s in range(2):
        out = lin2(torch.relu(lin(emb(torch.from_numpy(_ids(vocab=30,
                                                            seed=s))))))
        out.sum().backward()
        opt.step()
        opt.clear_grad()
    dense = {id(p) for p in params[1:]}
    assert len(calls) == 2                      # one group a step
    for c in calls:
        assert set(c) == dense and id(emb.weight) not in c
    assert ck.launch_counts()["adamw"] == 0     # CPU: the plain version


# ---------------------------------------------------------------------------
# the small DLRM of chip_smoke.py phase 27 against a twin on the JAX package


def _jdlrm(model, table_rows, dim):
    """The reference's DLRM holding `model`'s weights: its layers, the
    same forward."""
    J = jpaddle
    F = J.nn.functional
    n = len(table_rows) + 1
    li, lj = np.tril_indices(n, -1)
    flat = J.to_tensor((li * n + lj).astype(np.int64))
    embs = [J.nn.Embedding(r, dim, sparse=True) for r in table_rows]
    bot = [J.nn.Linear(*lin.weight.shape) for lin in model.bot]
    top = [J.nn.Linear(*lin.weight.shape) for lin in model.top]
    for je, e in zip(embs, model.emb):
        je.weight.set_value(e.weight.detach().numpy().copy())
    for jl, lin in zip(bot + top, list(model.bot) + list(model.top)):
        jl.weight.set_value(lin.weight.detach().numpy().copy())
        jl.bias.set_value(lin.bias.detach().numpy().copy())

    def forward(dense, ids):
        x = dense
        for lin in bot:
            x = F.relu(lin(x))
        rows = [e(ids[:, i]) for i, e in enumerate(embs)]
        t = J.reshape(J.concat([x] + rows, axis=1), [x.shape[0], n, dim])
        z = J.bmm(t, J.transpose(t, [0, 2, 1]))
        r = J.concat([x, J.gather(J.reshape(z, [x.shape[0], n * n]), flat,
                                  axis=1)], axis=1)
        for k, lin in enumerate(top):
            r = lin(r)
            r = F.sigmoid(r) if k == len(top) - 1 else F.relu(r)
        return r
    params = [p for layer in embs + bot + top for p in layer.parameters()]
    return forward, params, embs, bot + top


@pytest.mark.parametrize("rule", ["SGD", "Adam lazy"])
def test_small_dlrm_against_the_reference(rule):
    import paddle_tpu_torch.nn.functional as F
    cfg = cs.DLRM_SMALL
    model = cs.dlrm_model(**cfg, device="cpu")
    jfwd, jparams, jembs, jlins = _jdlrm(model, cfg["table_rows"],
                                         cfg["dim"])

    def make(m, ps):
        if rule == "SGD":
            return m.optimizer.SGD(learning_rate=cs.DLRM_LR, parameters=ps)
        return m.optimizer.Adam(learning_rate=cs.DLRM_ADAM_LR,
                                lazy_mode=True, parameters=ps)
    opt, jopt = make(paddle, model.parameters()), make(jpaddle, jparams)
    step = cs.dlrm_eager_step(model, opt, F)
    for dense, ids, y in cs.dlrm_batches(3, cs.DLRM_SMALL_B,
                                         cfg["table_rows"], seed=1):
        loss = float(step(torch.from_numpy(dense), torch.from_numpy(ids),
                          torch.from_numpy(y))[0])
        jloss = jpaddle.nn.functional.binary_cross_entropy(
            jfwd(jpaddle.to_tensor(dense), jpaddle.to_tensor(ids)),
            jpaddle.to_tensor(y))
        jloss.backward()
        assert isinstance(jembs[2].weight.grad, JSelectedRows)
        jopt.step()
        jopt.clear_grad()
        np.testing.assert_allclose(loss, float(jloss.numpy()),
                                   rtol=DLRM_TOL)
    for e, je in zip(model.emb, jembs):
        np.testing.assert_allclose(e.weight.detach().numpy(),
                                   je.weight.numpy(), rtol=DLRM_TOL,
                                   atol=DLRM_TOL)
    for lin, jl in zip(list(model.bot) + list(model.top), jlins):
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   jl.weight.numpy(), rtol=DLRM_TOL,
                                   atol=DLRM_TOL)


def test_dlrm_batches_repeat_hot_rows_and_stay_in_range():
    rows = (3, 1000, 10131227)
    (dense, ids, y), = cs.dlrm_batches(1, 4096, rows, seed=0)
    assert dense.dtype == np.float32 and ids.dtype == np.int64
    for i, r in enumerate(rows):
        assert ids[:, i].min() >= 0 and ids[:, i].max() < r
    # a power law: the top row takes a large share, ids repeat
    assert len(np.unique(ids[:, 2])) < 4096
    assert abs(float(y.mean()) - cs.DLRM_CTR) < 0.03
    n = len(cs.DLRM_KAGGLE_ROWS) + 1
    assert sum(cs.DLRM_KAGGLE_ROWS) == cs.DLRM_ROWS == 33762577
    assert cs.DLRM_KAGGLE["dim"] + n * (n - 1) // 2 == 367


def test_bounded_ops_fill_their_bounds_on_the_device(monkeypatch):
    """The bounds of clip_ties (binary_cross_entropy's clip, the hard
    activations, bce_with_logits, the margin losses) and normalize's
    epsilon are filled on the input's device, never copied from the host:
    a captured step (DLRM's BCE through make_train_step) cannot copy."""
    F = paddle.nn.functional
    rs = np.random.RandomState(0)
    p = torch.from_numpy(rs.rand(8, 1).astype(np.float32))
    y = torch.from_numpy((rs.rand(8, 1) > 0.5).astype(np.float32))
    x = torch.from_numpy(rs.randn(4, 6).astype(np.float32))
    calls = [lambda: F.binary_cross_entropy(p, y),
             lambda: F.binary_cross_entropy_with_logits(x[:, :1], y[:4]),
             lambda: F.relu6(x), lambda: F.hardsigmoid(x),
             lambda: F.hardswish(x), lambda: F.normalize(x, axis=1)]
    want = [c() for c in calls]

    def host_copy(*a, **k):
        raise AssertionError("a bound was copied from the host")
    monkeypatch.setattr(torch.Tensor, "new_tensor", host_copy)
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, host_copy)
    got = [c() for c in calls]
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
