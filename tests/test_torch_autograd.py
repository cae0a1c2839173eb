"""The port's `paddle.grad`, `Tensor.backward`, `paddle.autograd.backward`,
`PyLayer` and the functional transforms (`vjp`, `jvp`, `jacobian`,
`hessian`, `Jacobian`, `Hessian`) against the JAX package's, on the CPU,
on the same numpy inputs from a seed. float32 throughout, within 1e-5
relative (and 1e-6 absolute for values at 0).

Each function is written twice, once in the reference's ops and once in
torch's, since the port has no op surface of its own yet.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import autograd as jautograd

import paddle_tpu_torch as paddle
from paddle_tpu_torch import autograd
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.numpy()),
                               np.asarray(want.numpy()), rtol=RTOL,
                               atol=ATOL)


def _inputs(*shapes, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _pair(a, grad=True):
    return (jpaddle.to_tensor(a, stop_gradient=not grad),
            paddle.to_tensor(a, place="cpu", stop_gradient=not grad))


def test_grad_with_create_graph_gives_second_derivatives():
    (x,) = _inputs((5,))
    jx, tx = _pair(x)
    jy = (jx * jx * jx).sum()
    ty = (tx * tx * tx).sum()
    (jg,) = jpaddle.grad(jy, jx, create_graph=True)
    (tg,) = paddle.grad(ty, tx, create_graph=True)
    assert isinstance(tg, paddle.Tensor) and not tg.stop_gradient
    _close(tg, jg)
    (jg2,) = jpaddle.grad((jg * jg).sum(), jx)
    (tg2,) = paddle.grad((tg * tg).sum(), tx)
    _close(tg2, jg2)
    # paddle.grad touches no leaf's .grad
    assert tx.grad is None and jx.grad is None


def test_grad_outputs_retain_graph_and_allow_unused():
    x, w, u = _inputs((3, 4), (4, 2), (2,))
    (jx, tx), (jw, tw), (ju, tu) = _pair(x), _pair(w), _pair(u)
    jy, ty = jpaddle.matmul(jx, jw), torch.matmul(tx, tw)
    seed = _inputs((3, 2), seed=1)[0]
    js, ts = jpaddle.to_tensor(seed), paddle.to_tensor(seed, place="cpu")
    jgx, jgw = jpaddle.grad(jy, [jx, jw], grad_outputs=js)
    tgx, tgw = paddle.grad(ty, [tx, tw], grad_outputs=ts)
    _close(tgx, jgx)
    _close(tgw, jgw)
    # retain_graph=None keeps the graph, as the reference keeps its tape
    (tgx2,) = paddle.grad(ty, tx, grad_outputs=ts)
    _close(tgx2, jgx)
    (tgx3,) = paddle.grad(ty, tx, grad_outputs=ts, retain_graph=False)
    _close(tgx3, jgx)
    with pytest.raises(RuntimeError):
        paddle.grad(ty, tx, grad_outputs=ts)
    # an input the output does not reach
    jy, ty = (jx * 2.0).sum(), (tx * 2.0).sum()
    for mod, y, xs in ((jpaddle, jy, [jx, ju]), (paddle, ty, [tx, tu])):
        with pytest.raises(RuntimeError):
            mod.grad(y, xs)
    jgx, jgu = jpaddle.grad(jy, [jx, ju], allow_unused=True)
    tgx, tgu = paddle.grad(ty, [tx, tu], allow_unused=True)
    assert tgu is None and jgu is None
    _close(tgx, jgx)


def test_no_grad_vars_stop_the_flow():
    # the reference takes no_grad_vars and ignores it; the port stops the
    # gradient there, as paddle.grad documents
    (x,) = _inputs((4,))
    tx = paddle.to_tensor(x, place="cpu", stop_gradient=False)
    h = tx * 3.0
    y = (h * tx).sum()
    (g,) = paddle.grad(y, tx, no_grad_vars=[h])
    np.testing.assert_allclose(g.numpy(), 3.0 * x, rtol=RTOL)
    (g,) = paddle.grad(y, tx)
    np.testing.assert_allclose(g.numpy(), 6.0 * x, rtol=RTOL)


def test_autograd_backward_of_several_outputs():
    x, seed = _inputs((3,), (3,))
    jx, tx = _pair(x)
    js, ts = jpaddle.to_tensor(seed), paddle.to_tensor(seed, place="cpu")
    jautograd.backward([(jx * jx).sum(), jx * 3.0], [None, js])
    autograd.backward([(tx * tx).sum(), tx * 3.0], [None, ts])
    _close(tx.grad, jx.grad)


class _JTanh(jautograd.PyLayer):
    @staticmethod
    def forward(ctx, x, scale=1.0):
        y = jpaddle.tanh(x) * scale
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensor()
        return dy * (ctx.scale - y * y / ctx.scale)


class _TTanh(autograd.PyLayer):
    @staticmethod
    def forward(ctx, x, scale=1.0):
        y = torch.tanh(x) * scale
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensor()
        return dy * (ctx.scale - y * y / ctx.scale)


class _JPair(jautograd.PyLayer):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return a * b, a + b

    @staticmethod
    def backward(ctx, d1, d2):
        a, b = ctx.saved_tensor()
        return d1 * b + d2, d1 * a + d2


class _TPair(autograd.PyLayer):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return a * b, a + b

    @staticmethod
    def backward(ctx, d1, d2):
        a, b = ctx.saved_tensor()
        return d1 * b + d2, d1 * a + d2


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_pylayer_forward_and_backward_equal_the_reference(scale):
    (x,) = _inputs((2, 3))
    jx, tx = _pair(x)
    jy = _JTanh.apply(jx, scale=scale)
    ty = _TTanh.apply(tx, scale=scale)
    assert isinstance(ty, paddle.Tensor) and not ty.stop_gradient
    _close(ty, jy)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    _close(tx.grad, jx.grad)


def test_pylayer_with_two_outputs_and_a_constant_input():
    a, b = _inputs((4,), (4,))
    (ja, ta), (jb, tb) = _pair(a), _pair(b, grad=False)
    jp, js = _JPair.apply(ja, jb)
    tp, ts = _TPair.apply(ta, tb)
    _close(tp, jp)
    _close(ts, js)
    (jp.sum() + (js * js).sum()).backward()
    (tp.sum() + (ts * ts).sum()).backward()
    _close(ta.grad, ja.grad)
    assert tb.grad is None

    class Wrong(autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return a * b

        @staticmethod
        def backward(ctx, d):
            return d

    with pytest.raises(RuntimeError, match="returned 1 grads for 2"):
        Wrong.apply(ta, paddle.to_tensor(b, place="cpu",
                                         stop_gradient=False)).sum() \
            .backward()


# -------------------------------------------------------------- functional
FUNCS = {
    "tanh_scaled": (lambda x: jpaddle.tanh(x) * 2.0,
                    lambda x: torch.tanh(x) * 2.0),
    "cube_sum": (lambda x: (x * x * x).sum(), lambda x: (x * x * x).sum()),
    "matvec": (lambda x: jpaddle.matmul(x, x), lambda x: torch.matmul(x, x)),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_vjp_and_jvp_equal_the_reference(name):
    jf, tf = FUNCS[name]
    shape = (3, 3) if name == "matvec" else (4,)
    x, v = _inputs(shape, shape)
    jx, tx = _pair(x, grad=False)
    jo, jg = jautograd.vjp(jf, jx)
    to, tg = autograd.vjp(tf, tx)
    _close(to, jo)
    _close(tg, jg)
    out_shape = tuple(np.asarray(jo.numpy()).shape)
    if out_shape:
        (u,) = _inputs(out_shape, seed=2)
        jo, jg = jautograd.vjp(jf, jx, jpaddle.to_tensor(u))
        to, tg = autograd.vjp(tf, tx, paddle.to_tensor(u, place="cpu"))
        _close(tg, jg)
    jo, jt = jautograd.jvp(jf, jx, jpaddle.to_tensor(v))
    to, tt = autograd.jvp(tf, tx, paddle.to_tensor(v, place="cpu"))
    _close(to, jo)
    _close(tt, jt)
    jo, jt = jautograd.jvp(jf, jx)
    to, tt = autograd.jvp(tf, tx)
    _close(tt, jt)


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_jacobian_equals_the_reference(name):
    jf, tf = FUNCS[name]
    shape = (3, 3) if name == "matvec" else (4,)
    (x,) = _inputs(shape)
    jx, tx = _pair(x, grad=False)
    jj, tj = jautograd.jacobian(jf, jx), autograd.jacobian(tf, tx)
    assert tuple(tj.shape) == tuple(jj.shape)
    _close(tj, jj)
    J = autograd.Jacobian(tf, tx)
    assert tuple(J.shape) == tuple(jj.shape)
    _close(J[0], jautograd.Jacobian(jf, jx)[0])


def test_jacobian_and_hessian_of_two_inputs():
    a, b = _inputs((3,), (3,))
    (ja, ta), (jb, tb) = _pair(a, False), _pair(b, False)
    jf = lambda x, y: (x * x * y).sum()  # noqa: E731
    tf = lambda x, y: (x * x * y).sum()  # noqa: E731
    jj, tj = jautograd.jacobian(jf, [ja, jb]), autograd.jacobian(tf, [ta, tb])
    assert len(tj) == len(jj) == 2
    for t, j in zip(tj, jj):
        _close(t, j)
    jh, th = jautograd.hessian(jf, [ja, jb]), autograd.hessian(tf, [ta, tb])
    for i in range(2):
        for k in range(2):
            _close(th[i][k], jh[i][k])


def test_hessian_of_one_input_equals_the_reference():
    (x,) = _inputs((4,))
    jx, tx = _pair(x, grad=False)
    jf = lambda z: (jpaddle.tanh(z) * z * z).sum()  # noqa: E731
    tf = lambda z: (torch.tanh(z) * z * z).sum()  # noqa: E731
    jh, th = jautograd.hessian(jf, jx), autograd.hessian(tf, tx)
    assert tuple(th.shape) == (4, 4)
    _close(th, jh)
    H = autograd.Hessian(tf, tx)
    assert tuple(H.shape) == (4, 4)
    _close(H[1], jautograd.Hessian(jf, jx)[1])
