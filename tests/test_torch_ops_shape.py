"""The port's shape and creation ops against the JAX package's
(paddle_tpu/ops/manipulation.py, ops/creation.py): the registry sweep
(tests/torch_ops_sweep.py), the reference's calling forms (positional
and keyword axes, shapes as tensors), indexing, and the Tensor methods
whose names torch already defines (a difference by design, ROADMAP queue
3). Tolerances: torch_ops_sweep.FWD_TOL / GRAD_TOL; integers exactly."""
import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import torch_ops_sweep as sw

import paddle_tpu as jp
import paddle_tpu.tensor.manipulation  # noqa: F401
import paddle_tpu_torch as pp
from paddle_tpu_torch.framework import place as pplace

jax.config.update("jax_platforms", "cpu")

OPS = sorted((set(sw.REF_MODULE_OPS["manipulation"])
              | set(sw.REF_MODULE_OPS["creation"]))
             - sw.RECONSTRUCT - sw.RANDOM)


@pytest.fixture(autouse=True)
def on_cpu():
    saved = pplace._current_place
    pp.set_device("cpu")
    yield
    pplace._current_place = saved


@pytest.mark.parametrize("op", OPS)
def test_shape_and_creation_op_matches_reference(op):
    sw.check_op(op)


def _np(t):
    return np.asarray(t.numpy())


X = np.arange(24, dtype=np.float32).reshape(2, 3, 4)


def _pair():
    return jp.to_tensor(X), torch.from_numpy(X.copy())


@pytest.mark.parametrize("call", [
    lambda m, x: m.sum(x, 1),
    lambda m, x: m.sum(x, axis=[0, 2], keepdim=True),
    lambda m, x: m.sum(x, 1, "float64", True),
    lambda m, x: m.mean(x, 2, True),
    lambda m, x: m.max(x, 1),
    lambda m, x: m.min(x, axis=-1, keepdim=True),
    lambda m, x: m.prod(x, 0),
    lambda m, x: m.std(x, 1, False),
    lambda m, x: m.var(x, axis=0),
    lambda m, x: m.logsumexp(x, 2),
    lambda m, x: m.argmax(x, 2, True),
    lambda m, x: m.argsort(x, 1, True),
    lambda m, x: m.cumsum(x, 1),
    lambda m, x: m.cumprod(x, 2),
    lambda m, x: m.reshape(x, [4, -1]),
    lambda m, x: m.reshape(x, shape=(6, 4)),
    lambda m, x: m.transpose(x, [2, 0, 1]),
    lambda m, x: m.flatten(x, 1),
    lambda m, x: m.unsqueeze(x, [0, 2]),
    lambda m, x: m.squeeze(m.unsqueeze(x, 0), 0),
    lambda m, x: m.concat([x, x], axis=1),
    lambda m, x: m.stack([x, x], 1),
    lambda m, x: m.split(x, [1, -1], axis=2)[1],
    lambda m, x: m.chunk(x, 2, 2)[0],
    lambda m, x: m.tile(x, [1, 2, 1]),
    lambda m, x: m.expand(m.unsqueeze(x, 0), [2, -1, -1, -1]),
    lambda m, x: m.flip(x, [0, 2]),
    lambda m, x: m.roll(x, 2, 2),
    lambda m, x: m.rot90(x, 1, [1, 2]),
    lambda m, x: m.moveaxis(x, 0, 2),
    lambda m, x: m.slice(x, [1, 2], [0, 1], [2, 3]),
    lambda m, x: m.strided_slice(x, [2], [3], [0], [-2]),
    lambda m, x: m.tril(x[0]),
    lambda m, x: m.clip(x, 3.0, 9.0),
    lambda m, x: m.scale(x, 2.0, 1.0),
    lambda m, x: m.scale(x, 2.0, 1.0, False),
    lambda m, x: m.add_n([x, x, x]),
    lambda m, x: m.topk(x, 2, 1)[0],
    lambda m, x: m.topk(x, k=2, axis=1, largest=False)[1],
    lambda m, x: m.crop(x, [1, 2, -1], [1, 1, 1]),
    lambda m, x: m.tensor.manipulation.pad(m.unsqueeze(x, 0), [1, 0, 2, 1],
                                           mode="replicate"),
    lambda m, x: m.dist(x, x * 0.5, 3),
    lambda m, x: m.tensordot(x, x, [[1, 2], [1, 2]]),
    lambda m, x: m.einsum("ijk,ijk->ik", x, x),
    lambda m, x: m.kron(x[0], x[1]),
    lambda m, x: m.linalg.norm(x, 2, 1),
    lambda m, x: m.linalg.norm(x[0], float("inf"), [0, 1]),
    lambda m, x: m.pow(x, 2),
    lambda m, x: m.index_select(x, m.to_tensor(np.array([2, 0]), 
                                              place="cpu" if m is pp
                                              else None), 2),
    lambda m, x: m.count_nonzero(x, 1),
    lambda m, x: m.full_like(x, 3),
    lambda m, x: m.zeros_like(x, "int32"),
    lambda m, x: m.tolist(m.shape(x)),
    lambda m, x: m.is_tensor(x) and m.is_floating_point(x),
])
def test_call_forms_match_reference(call):
    """The reference's positional and keyword forms of the surface."""
    jx, px = _pair()
    want, got = call(jp, jx), call(pp, px)
    if isinstance(want, (list, bool)):
        assert got == want
        return
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("index", [
    (0,), (slice(None), 1), (Ellipsis, 2), (None, 1, slice(0, 2)),
    (slice(None, None, -1),), (1, slice(2, 0, -1), slice(None, None, 2)),
    ([1, 0],), (slice(None), [2, 0, 2]), (0, [1, 2], [3, 0]), "mask",
])
def test_getitem_matches_reference(index):
    """Tensor indexing: static indices (op getitem, negative steps too),
    list and tensor indices (getitem_dyn), a bool mask (masked_select)."""
    jx, px = _pair()
    if index == "mask":
        want = jx[jx > 11.0]
        got = pp.tensor.getitem(px, px > 11.0)
    else:
        want = jx[index]
        got = pp.tensor.getitem(px, index if len(index) > 1 else index[0])
    np.testing.assert_array_equal(_np(got), _np(want))


def test_tensor_methods_differences_by_design():
    """The port's Tensor gains the reference's method names torch lacks,
    with the reference's meaning; a name torch defines keeps torch's
    meaning (the port's modules call them on the tensors users hand in),
    while the top-level function has the reference's."""
    x = pp.to_tensor(X, place="cpu")
    assert set(pp.tensor.PADDLE_METHODS) == {
        "equal_all", "gather_nd", "greater_than", "less_than", "mod",
        "unstack"}
    # the reference's meaning for the names torch lacks
    jx = jp.to_tensor(X)
    np.testing.assert_array_equal(x.mod(5.0).numpy(), (jx % 5.0).numpy())
    np.testing.assert_array_equal(x.greater_than(x * 0 + 7).numpy(),
                                  (jx > 7.0).numpy())
    assert bool(x.equal_all(x.clone())) and len(x.unstack(1)) == 3
    idx = np.array([[0, 1], [1, 2]], np.int64)
    np.testing.assert_array_equal(
        x.gather_nd(torch.from_numpy(idx)).numpy(),
        jp.gather_nd(jx, jp.to_tensor(idx)).numpy())
    # torch's meaning where torch has the name, the reference's at the
    # top level
    assert tuple(x.transpose(0, 2).shape) == (4, 3, 2)
    assert tuple(pp.transpose(x, [2, 0, 1]).shape) == (4, 2, 3)
    assert [tuple(t.shape) for t in x.split(1, 2)][0] == (2, 3, 1)
    assert len(pp.split(x, 2, 2)) == 2
    vals, idx_ = x.max(1)
    assert tuple(idx_.shape) == (2, 4)
    assert isinstance(pp.max(x, 1), torch.Tensor)
    assert tuple(x.expand(2, 2, 3, 4).shape) == (2, 2, 3, 4)
    assert x.std().dtype == torch.float32
    assert isinstance(x.equal(x), bool)
    assert pp.equal(x, x).dtype == torch.bool
    g = x.gather(2, torch.zeros(2, 3, 1, dtype=torch.int64))
    assert tuple(g.shape) == (2, 3, 1)
    assert tuple(pp.gather(x, torch.tensor([1, 0]), axis=1).shape) == (
        2, 2, 4)
