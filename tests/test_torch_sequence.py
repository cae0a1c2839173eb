"""The sequence ops (paddle_tpu_torch/nn/functional_sequence.py, bound as
`F.sequence` and re-exported as `F.sequence_*`) against the JAX package's
(paddle_tpu/nn/functional/sequence.py), on the CPU, on the shapes of the
reference's own tests (tests/test_sequence_ops.py) and ragged batches
with an empty row.

The four device ops (`sequence_{reverse,softmax,pool,conv}_op`) are held
on values and on the gradients of their float inputs against one fixed
numpy cotangent, within 1e-5 of the reference's largest |value| (1e-4
for the pools' sums and the convolution's product); the host ops on exact
values, dtypes and shapes. The host ops refuse a CUDA graph capture.
"""
import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread a worker)

import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as F

jax.config.update("jax_platforms", "cpu")

ELEM, RED = 1e-5, 1e-4
LENS = np.array([3, 1, 4, 0], np.int64)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


def _pair(fn_ref, fn_port, arrays, diff, tol):
    jin = [jp.to_tensor(a, stop_gradient=i not in diff)
           for i, a in enumerate(arrays)]
    tin = [torch.tensor(a, requires_grad=i in diff)
           for i, a in enumerate(arrays)]
    jo, to = fn_ref(*jin), fn_port(*tin)
    _close(_np(to), _np(jo), tol)
    cot = np.random.RandomState(2).randn(*to.shape).astype(np.float32)
    (jo * jp.to_tensor(cot)).sum().backward()
    (to * torch.from_numpy(cot)).sum().backward()
    for i in diff:
        _close(_np(tin[i].grad), _np(jin[i].grad), RED)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 5), (4, 5, 3)])
def test_reverse_and_softmax(shape):
    x = _x(*shape)
    _pair(lambda a, n: JF.sequence_reverse(a, n),
          lambda a, n: F.sequence_reverse(a, n), [x, LENS], [0], ELEM)
    if len(shape) == 2:
        _pair(lambda a, n: JF.sequence_softmax(a, n),
              lambda a, n: F.sequence_softmax(a, n), [x, LENS], [0], ELEM)


@pytest.mark.parametrize("pool", ["sum", "average", "sqrt", "max", "first",
                                  "last", "AVERAGE"])
def test_pool_modes(pool):
    x = _x(4, 5, 3)
    lens = np.array([3, 1, 4, 2], np.int64)
    _pair(lambda a, n: JF.sequence_pool(a, pool, n),
          lambda a, n: F.sequence_pool(a, pool, n), [x, lens], [0], RED)


@pytest.mark.parametrize("ctx", [(3, None), (4, -1), (2, 0)])
def test_conv(ctx):
    length, start = ctx
    x, w = _x(3, 6, 4), _x(length * 4, 5, seed=1)
    lens = np.array([6, 2, 4], np.int64)
    _pair(lambda a, b, n: JF.sequence_conv(a, b, n, length, start),
          lambda a, b, n: F.sequence_conv(a, b, n, length, start),
          [x, w, lens], [0, 1], RED)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _host_cases():
    flat = _x(8, 2)
    ids = np.array([1, 2, 3, 2, 5, 2, 7, 8], np.int64)
    lens = np.array([3, 0, 5], np.int64)
    return {
        "pad": (lambda P, T: P.sequence_pad(T(flat), T(np.float32(0.5)),
                                            lengths=T(lens))),
        "pad_maxlen": (lambda P, T: P.sequence_pad(
            T(flat), T(np.float32(-1.0)), maxlen=6, lengths=T(lens))),
        "unpad": (lambda P, T: P.sequence_unpad(T(_x(3, 5, 2)), T(lens))),
        "expand": (lambda P, T: P.sequence_expand(T(_x(3, 2)),
                                                  T(np.array([2, 0, 3])))),
        "expand_as": (lambda P, T: P.sequence_expand_as(
            T(_x(3, 2)), T(np.array([1, 2, 1])))),
        "concat": (lambda P, T: P.sequence_concat(
            [T(flat), T(_x(5, 2, seed=1))],
            [T(lens), T(np.array([2, 2, 1], np.int64))])),
        "enumerate": (lambda P, T: P.sequence_enumerate(T(ids), T(lens), 3,
                                                        pad_value=-1)),
        "erase": (lambda P, T: P.sequence_erase(T(ids), T(lens), [2, 5])),
        "reshape": (lambda P, T: P.sequence_reshape(
            T(_x(8, 2)), T(np.array([2, 4, 2], np.int64)), 4)),
        "slice": (lambda P, T: P.sequence_slice(
            T(flat), T(lens), T(np.array([1, 0, 2], np.int64)),
            T(np.array([2, 0, 3], np.int64)))),
        "scatter": (lambda P, T: P.sequence_scatter(
            T(_x(3, 6)), T(np.array([0, 5, 2, 2, 1], np.int64)),
            T(_x(5, seed=3)), T(np.array([2, 0, 3], np.int64)))),
    }


@pytest.mark.parametrize("name", sorted(_host_cases()))
def test_host_ops(name):
    fn = _host_cases()[name]
    _same(fn(F, torch.tensor), fn(JF, jp.to_tensor))
    _same(fn(F.sequence, torch.tensor), fn(JF, jp.to_tensor))


def test_errors_as_the_reference():
    with pytest.raises(ValueError):
        F.sequence_pad(torch.zeros(4, 2), torch.tensor(0.0), maxlen=2,
                       lengths=torch.tensor([3, 1]))
    with pytest.raises(ValueError):
        F.sequence_pad(torch.zeros(4, 2), torch.tensor(0.0))
    with pytest.raises(ValueError):
        F.sequence_slice(torch.zeros(4, 2), torch.tensor([2, 2]),
                         torch.tensor([1, 0]), torch.tensor([2, 1]))
    with pytest.raises(ValueError):
        F.sequence_reshape(torch.zeros(3, 2), torch.tensor([3]), 4)
    with pytest.raises(ValueError):
        F.sequence_pool(torch.zeros(2, 3), "median", torch.tensor([1, 2]))


@pytest.mark.parametrize("name", ["unpad", "expand", "pad", "erase"])
def test_host_ops_refuse_a_capture(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        _host_cases()[name](F, torch.tensor)
