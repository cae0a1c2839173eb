"""The port's metrics against the JAX package's, on the CPU: Accuracy
(top-k with ties, float32 and bfloat16 logits, integer labels of shape
[N] and [N, 1], one-hot labels), Precision, Recall, Auc (ROC and PR
curves) and the functional `accuracy`, on the same seeded inputs.

Ties: the reference ranks with a stable descending argsort (among equal
logits the lower class index first); the logits here are drawn from a
few values so that most rows tie, in both dtypes. Every accumulated
value is exact (counts over counts) and is compared with ==; the
functional accuracy is a float32 mean, compared with ==.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jmetric
from paddle_tpu_torch import metric
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

N, C = 64, 10


def _logits(seed):
    """Logits from 4 values only: ties in nearly every row."""
    rs = np.random.RandomState(seed)
    return rs.choice([-1.0, 0.0, 0.5, 2.0], size=(N, C)).astype(np.float32)


def _labels(seed, form):
    rs = np.random.RandomState(seed + 100)
    lab = rs.randint(0, C, N).astype(np.int64)
    if form == "flat":
        return lab
    if form == "column":
        return lab[:, None]
    return np.eye(C, dtype=np.float32)[lab]        # one-hot


def _port(x, dtype="float32"):
    t = torch.from_numpy(np.asarray(x))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _ref(x, dtype="float32"):
    t = paddle.to_tensor(np.asarray(x))
    return t.astype("bfloat16") if dtype == "bfloat16" else t


@pytest.mark.parametrize("topk", [(1,), (1, 5), (2, 3)])
@pytest.mark.parametrize("form", ["flat", "column", "onehot"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accuracy_with_ties(topk, form, dtype):
    pm, jm = metric.Accuracy(topk=topk), jmetric.Accuracy(topk=topk)
    got, want = [], []
    for seed in range(3):
        x = _logits(seed)
        y = _labels(seed, form)
        got.append(pm.update(pm.compute(_port(x, dtype), _port(y))))
        want.append(jm.update(jm.compute(_ref(x, dtype), _ref(y))))
        np.testing.assert_array_equal(
            pm.compute(_port(x, dtype), _port(y)).numpy(),
            np.asarray(jm.compute(_ref(x, dtype), _ref(y)).numpy()))
    assert got == want
    assert pm.accumulate() == jm.accumulate()
    assert pm.name() == jm.name()
    pm.reset()
    jm.reset()
    assert pm.accumulate() == jm.accumulate()


def test_accuracy_ties_rank_the_lower_index_first():
    """All logits equal: the stable order puts class 0 first, so only
    label 0 is a top-1 hit, labels 0-2 top-3 hits."""
    x = np.zeros((4, 5), np.float32)
    y = np.array([0, 1, 2, 4], np.int64)
    m = metric.Accuracy(topk=(1, 3))
    assert m.update(m.compute(_port(x), _port(y))) == [0.25, 0.75]


def _binary(seed):
    rs = np.random.RandomState(seed)
    p = rs.rand(N).astype(np.float32)
    p[:4] = 0.5                                  # the threshold itself
    return p, rs.randint(0, 2, N).astype(np.int64)


@pytest.mark.parametrize("name", ["Precision", "Recall"])
def test_precision_recall(name):
    pm, jm = getattr(metric, name)(), getattr(jmetric, name)()
    for seed in range(3):
        p, y = _binary(seed)
        pm.update(_port(p), _port(y))
        jm.update(_ref(p), _ref(y))
    assert pm.accumulate() == jm.accumulate()
    assert pm.name() == jm.name()


@pytest.mark.parametrize("curve", ["ROC", "PR"])
@pytest.mark.parametrize("two_columns", [False, True])
def test_auc(curve, two_columns):
    pm = metric.Auc(curve=curve, num_thresholds=255)
    jm = jmetric.Auc(curve=curve, num_thresholds=255)
    for seed in range(3):
        p, y = _binary(seed)
        if two_columns:
            p = np.stack([1 - p, p], axis=1)
        pm.update(_port(p), _port(y))
        jm.update(_ref(p), _ref(y))
    assert pm.accumulate() == jm.accumulate()
    np.testing.assert_array_equal(pm._stat_pos, jm._stat_pos)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functional_accuracy(k, dtype):
    x = _logits(7)
    y = _labels(7, "column")
    got = metric.accuracy(_port(x, dtype), _port(y), k=k)
    want = jmetric.accuracy(_ref(x, dtype), _ref(y), k=k)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(np.asarray(want.numpy()))
