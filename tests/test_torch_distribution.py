"""paddle.distribution of the port against the JAX package's, on the CPU.

Uniform, Normal and Categorical at broadcast shapes: log_prob, probs,
entropy and kl_divergence within 1e-6 (rtol; atol 1e-6), float32 from
Python-number parameters; log_prob's -inf outside a Uniform's support.
`sample` draws from torch (a difference by design): held by shape,
dtype, support, a seed's repeat and the moments of 2e5 draws within 5
standard errors.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import distribution as jdist

import paddle_tpu_torch as paddle
from paddle_tpu_torch import distribution as dist
from paddle_tpu_torch.framework import place as pplace
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

TOL = dict(rtol=1e-6, atol=1e-6)
RS = np.random.RandomState(0)
LOC = RS.randn(3).astype(np.float32)
SCALE = (RS.rand(3) + 0.5).astype(np.float32)
VAL = RS.randn(4, 3).astype(np.float32)
LOGITS = RS.randn(4, 5).astype(np.float32)


@pytest.fixture(autouse=True)
def on_cpu():
    saved = pplace._current_place
    paddle.set_device("cpu")
    yield
    pplace._current_place = saved


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.numpy())


def _t(a):
    return torch.from_numpy(a)


def _j(a):
    return jpaddle.to_tensor(a)


@pytest.mark.parametrize("which", ["tensors", "numbers"])
def test_normal(which):
    if which == "tensors":
        p, q = dist.Normal(_t(LOC), _t(SCALE)), dist.Normal(_t(LOC * 0.5),
                                                            _t(SCALE + 0.1))
        jp, jq = jdist.Normal(_j(LOC), _j(SCALE)), jdist.Normal(
            _j(LOC * 0.5), _j(SCALE + 0.1))
    else:
        p, q = dist.Normal(0.3, 1.7), dist.Normal(-0.2, 0.9)
        jp, jq = jdist.Normal(0.3, 1.7), jdist.Normal(-0.2, 0.9)
    for got, want in ((p.log_prob(_t(VAL)), jp.log_prob(_j(VAL))),
                      (p.probs(_t(VAL)), jp.probs(_j(VAL))),
                      (p.entropy(), jp.entropy()),
                      (p.kl_divergence(q), jp.kl_divergence(jq)),
                      (dist.kl_divergence(p, q), jdist.kl_divergence(jp,
                                                                     jq))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_uniform():
    lo, hi = _t(LOC), _t(LOC + 2.0)
    u, ju = dist.Uniform(lo, hi), jdist.Uniform(_j(LOC), _j(LOC + 2.0))
    for got, want in ((u.log_prob(_t(VAL)), ju.log_prob(_j(VAL))),
                      (u.probs(_t(VAL)), ju.probs(_j(VAL))),
                      (u.entropy(), ju.entropy())):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert np.isneginf(_np(u.log_prob(_t(LOC - 1.0)))).all()
    np.testing.assert_allclose(_np(dist.Uniform(-1.0, 3.0).entropy()),
                               _np(jdist.Uniform(-1.0, 3.0).entropy()),
                               **TOL)


def test_categorical():
    c, jc = dist.Categorical(_t(LOGITS)), jdist.Categorical(_j(LOGITS))
    d, jd = (dist.Categorical(_t(LOGITS * 0.5)),
             jdist.Categorical(_j(LOGITS * 0.5)))
    v = np.array([0, 4, 2, 1], np.int64)
    for got, want in ((c.entropy(), jc.entropy()),
                      (c.log_prob(_t(v)), jc.log_prob(_j(v))),
                      (c.probs(_t(v)), jc.probs(_j(v))),
                      (c.kl_divergence(d), jc.kl_divergence(jd))):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_log_prob_gradients_flow_to_the_parameters():
    loc = _t(LOC.copy()).requires_grad_(True)
    dist.Normal(loc, _t(SCALE)).log_prob(_t(VAL)).sum().backward()
    want = ((VAL - LOC) / SCALE ** 2).sum(0)
    np.testing.assert_allclose(loc.grad.numpy(), want, rtol=1e-5)


def _moments(x, mean, var):
    x = x.double()
    n = x.numel()
    assert abs(float(x.mean()) - mean) <= 5 * (var / n) ** 0.5
    assert abs(float(x.var()) - var) <= 5 * var * (2.0 / n) ** 0.5


def test_samples_by_their_distributions():
    torch.manual_seed(0)
    s = dist.Normal(0.5, 2.0).sample([200000])
    assert s.shape == (200000,) and s.dtype == torch.float32
    _moments(s, 0.5, 4.0)
    u = dist.Uniform(_t(LOC), _t(LOC + 2.0)).sample([5, 7])
    assert u.shape == (5, 7, 3)
    assert bool((u >= _t(LOC)).all()) and bool((u < _t(LOC + 2.0)).all())
    _moments(dist.Uniform(-1.0, 3.0).sample([200000]), 1.0, 16.0 / 12)
    c = dist.Categorical(_t(LOGITS)).sample([1000])
    assert c.shape == (1000, 4) and c.dtype == torch.int64
    assert int(c.min()) >= 0 and int(c.max()) < 5
    p0 = torch.softmax(_t(LOGITS[0]), -1)[2].item()
    n = 1000
    assert abs(float((c[:, 0] == 2).float().mean()) - p0) <= 5 * (
        p0 * (1 - p0) / n) ** 0.5
    torch.manual_seed(3)
    a = dist.Normal(0.0, 1.0).sample([4])
    torch.manual_seed(3)
    assert torch.equal(a, dist.Normal(0.0, 1.0).sample([4]))
