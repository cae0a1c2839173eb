"""The port's linear algebra and random ops against the JAX package's
(paddle_tpu/ops/linalg.py, ops/random_ops.py), the coverage of the five
op modules, and the top-level bindings.

Linear algebra goes through the registry sweep (tests/torch_ops_sweep.py)
except the factorizations unique only up to signs or order, which are
held by reconstruction within RECON_TOL of the input's largest |value|
(U S Vh, Q R, P L U, A v = w v), their invariant outputs (singular
values, eigenvalues) to the reference within the sweep's tolerance.
Random ops: shape, dtype and range; the same draws twice from one
`paddle.seed`; the mean and variance of DRAWS draws within 5 sigma of the
distribution's (the two packages' generators differ, so no draw is
compared to JAX's)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import torch_ops_sweep as sw

import paddle_tpu as jp
import paddle_tpu.linalg  # noqa: F401
import paddle_tpu.tensor as jtensor
import paddle_tpu_torch as pp
from paddle_tpu_torch.framework import random as prandom

jax.config.update("jax_platforms", "cpu")

RECON_TOL = 1e-5
DRAWS = 200_000

OPS = sorted(set(sw.REF_MODULE_OPS["linalg"]) - sw.RECONSTRUCT)


@pytest.mark.parametrize("op", OPS)
def test_linalg_op_matches_reference(op):
    sw.check_op(op)


def _mat(m, n, seed=0, well=True):
    rs = np.random.RandomState(seed)
    a = rs.uniform(-1, 1, (m, n)).astype(np.float32)
    if well and m == n:
        a += n * np.eye(n, dtype=np.float32)
    return a


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.complex128)
                        - np.asarray(want, np.complex128)).max()
                 / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("shape", [(4, 3), (3, 5), (4, 4)])
def test_svd_reconstructs_and_its_values_match(shape):
    a = _mat(*shape)
    u, s, vh = sw.PORT_OPS["svd_op"](torch.from_numpy(a))
    ju, js, jvh = sw.run_ref("svd_op", [a], {})
    sw.assert_close("svd_op", s, js, "reduction")
    assert _rel((u * s) @ vh, a) <= RECON_TOL
    assert u.dtype == torch.float32 and tuple(u.shape) == ju.shape
    assert tuple(vh.shape) == jvh.shape
    # the singular values' gradient (sign-free) against the reference's
    w = np.random.RandomState(3).rand(*js.shape).astype(np.float32)
    t = torch.from_numpy(a).requires_grad_(True)
    (sw.PORT_OPS["svd_op"](t)[1] * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(sw.REF_OPS["svd_op"].fn(x)[1] * w))(
        jnp.asarray(a))
    sw.assert_close("svd_op", t.grad, jg, "reduction", "gradient")


@pytest.mark.parametrize("mode", ["reduced", "complete"])
def test_qr_reconstructs(mode):
    a = _mat(5, 3)
    out = sw.PORT_OPS["qr_op"](torch.from_numpy(a), mode=mode)
    ref = sw.run_ref("qr_op", [a], {"mode": mode})
    q, r = out
    assert _rel(q @ r, a) <= RECON_TOL
    assert tuple(q.shape) == ref[0].shape and tuple(r.shape) == ref[1].shape
    assert _rel(q.T @ q, np.eye(q.shape[1])) <= RECON_TOL


def test_lu_reconstructs_with_one_based_int32_pivots():
    a = _mat(4, 4, seed=2, well=False)
    lu, piv = sw.PORT_OPS["lu_op"](torch.from_numpy(a))
    jlu, jpiv = sw.run_ref("lu_op", [a], {})
    assert piv.dtype == torch.int32 and str(jpiv.dtype) == "int32"
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    assert _rel(lu, jlu) <= RECON_TOL
    P, L, U = torch.lu_unpack(lu, piv)
    assert _rel(P @ L @ U, a) <= RECON_TOL


def test_eig_eigh_eigvals_hold_their_pairs():
    a = _mat(4, 4, seed=5)
    w, v = sw.PORT_OPS["eig_op"](torch.from_numpy(a))
    jw, _ = sw.run_ref("eig_op", [a], {})
    ac = torch.from_numpy(a).to(torch.complex64)
    assert _rel(ac @ v, v * w) <= RECON_TOL
    assert w.dtype == torch.complex64 and str(jw.dtype) == "complex64"
    key = lambda z: (np.round(z.real, 4), np.round(z.imag, 4))  # noqa: E731
    assert _rel(sorted(w.numpy(), key=key),
                sorted(np.asarray(jw), key=key)) <= 1e-5
    ev = sw.PORT_OPS["eigvals_op"](torch.from_numpy(a))
    assert _rel(sorted(ev.numpy(), key=key), sorted(np.asarray(jw),
                                                    key=key)) <= 1e-5
    s = a + a.T
    w, v = sw.PORT_OPS["eigh_op"](torch.from_numpy(s))
    jw, _ = sw.run_ref("eigh_op", [s], {})
    sw.assert_close("eigh_op", w, jw, "reduction")
    assert _rel(torch.from_numpy(s) @ v, v * w) <= RECON_TOL


@pytest.mark.parametrize("shape", [(6, 3), (3, 5)])
def test_lstsq_matches_reference(shape):
    a = _mat(*shape, seed=7)
    b = _mat(shape[0], 2, seed=8)
    got = sw.PORT_OPS["lstsq_op"](torch.from_numpy(a), torch.from_numpy(b))
    want = sw.run_ref("lstsq_op", [a, b], {})
    for g, w in zip(got, want):
        sw.assert_close("lstsq_op", g, w, "reduction")


# ---------------------------------------------------------------------------
# random ops


@pytest.fixture
def rng_state():
    saved = prandom.get_rng_state()
    yield
    prandom.set_rng_state(saved)


def _moments(x, mean, var):
    x = x.double()
    n = x.numel()
    sd = var ** 0.5
    assert abs(float(x.mean()) - mean) <= 5 * sd / n ** 0.5, (
        float(x.mean()), mean)
    # the sample variance's sd is sqrt(mu4 - var^2) / sqrt(n); 5 sigma of
    # a kurtosis up to 9 (exponential) bounds it
    assert abs(float(x.var()) - var) <= 5 * var * (8.0 / n) ** 0.5, (
        float(x.var()), var)


@pytest.mark.parametrize("case", [
    "randn", "normal", "rand", "uniform", "randint", "randperm",
    "bernoulli", "multinomial", "poisson", "exponential"])
def test_random_op_distribution_and_seed(case, rng_state):
    """Shape, dtype and range; one seed repeats the draws; the first two
    moments of DRAWS draws."""
    n = DRAWS

    def draw():
        if case == "randn":
            return pp.randn([n], device="cpu")
        if case == "normal":
            return pp.normal(1.5, 2.0, [n], device="cpu")
        if case == "rand":
            return pp.rand([n], "float64", device="cpu")
        if case == "uniform":
            return pp.uniform([n], min=-2.0, max=3.0, device="cpu")
        if case == "randint":
            return pp.randint(-3, 7, [n], device="cpu")
        if case == "randperm":
            return pp.randperm(1000, device="cpu")
        if case == "bernoulli":
            return pp.bernoulli(torch.full((n,), 0.3))
        if case == "multinomial":
            return pp.multinomial(torch.tensor([1.0, 2.0, 7.0]), n, True)
        if case == "poisson":
            return pp.poisson(torch.full((n,), 4.0))
        return pp.tensor.exponential_ if False else \
            pp.ops.random_ops.exponential_(torch.empty(n), 2.0)

    pp.seed(11)
    x = draw()
    pp.seed(11)
    y = draw()
    assert torch.equal(x, y)
    pp.seed(12)
    assert not torch.equal(x, draw())
    want_dtype = {"rand": torch.float64, "randint": torch.int64,
                  "randperm": torch.int64, "multinomial": torch.int64}
    assert x.dtype == want_dtype.get(case, torch.float32)
    if case == "randn":
        _moments(x, 0.0, 1.0)
    elif case == "normal":
        _moments(x, 1.5, 4.0)
    elif case == "rand":
        assert 0.0 <= float(x.min()) and float(x.max()) < 1.0
        _moments(x, 0.5, 1 / 12)
    elif case == "uniform":
        assert -2.0 <= float(x.min()) and float(x.max()) < 3.0
        _moments(x, 0.5, 25 / 12)
    elif case == "randint":
        assert int(x.min()) == -3 and int(x.max()) == 6
        _moments(x, 1.5, (10 ** 2 - 1) / 12)
    elif case == "randperm":
        assert sorted(x.tolist()) == list(range(1000))
    elif case == "bernoulli":
        assert set(x.unique().tolist()) <= {0.0, 1.0}
        _moments(x, 0.3, 0.21)
    elif case == "multinomial":
        assert set(x.unique().tolist()) <= {0, 1, 2}
        p = np.array([0.1, 0.2, 0.7])
        m = float((p * np.arange(3)).sum())
        _moments(x, m, float((p * np.arange(3) ** 2).sum()) - m * m)
    elif case == "poisson":
        _moments(x, 4.0, 4.0)
    else:
        assert float(x.min()) >= 0.0
        _moments(x, 0.5, 0.25)


def test_uniform_with_a_seed_repeats_and_random_ops_register():
    a = pp.uniform([5], seed=3, device="cpu")
    b = pp.uniform([5], seed=3, device="cpu")
    assert torch.equal(a, b)
    for op in sw.REF_MODULE_OPS["random_ops"]:
        assert op in sw.PORT_OPS and sw.PORT_OPS[op].nondiff


# ---------------------------------------------------------------------------
# coverage and bindings

# op types of the five reference modules the port does not register, each
# with its reason (none)
NOT_PORTED = {}


def test_every_op_of_the_five_modules_is_registered():
    missing = {op for m in sw.MODULES for op in sw.REF_MODULE_OPS[m]
               if op not in sw.PORT_OPS}
    assert missing == set(NOT_PORTED), sorted(missing)
    assert sum(len(v) for v in sw.REF_MODULE_OPS.values()) == 216
    for m in sw.MODULES:
        for op in sw.REF_MODULE_OPS[m]:
            assert sw.PORT_OPS[op].nondiff == sw.REF_OPS[op].nondiff, op
    # the long-tail ops, fft and signal: every op type the reference's
    # ops/misc_ops.py, fft.py and signal.py register
    import inspect
    more = {op for op, prim in sw.REF_OPS.items()
            if inspect.getsourcefile(prim.fn).replace("\\", "/").endswith(
                ("paddle_tpu/ops/misc_ops.py", "paddle_tpu/fft.py",
                 "paddle_tpu/signal.py"))}
    assert len(more) == 50, len(more)
    assert not {op for op in more if op not in sw.PORT_OPS}
    for op in more:
        assert sw.PORT_OPS[op].nondiff == sw.REF_OPS[op].nondiff, op


def test_the_references_tensor_names_and_linalg_are_bound_at_top_level():
    names = {n for n in dir(jtensor) if not n.startswith("_")
             and not isinstance(getattr(jtensor, n), types.ModuleType)}
    names -= {"annotations"}
    missing = sorted(n for n in names if not hasattr(pp, n))
    assert not missing, missing
    assert set(jp.linalg.__all__) <= set(dir(pp.linalg))
    assert pp.linalg.inv is pp.linalg.inverse
    for n in ("add", "matmul", "concat", "split", "sum", "max", "where",
              "gather", "topk", "einsum", "arange", "zeros", "randn"):
        assert n in pp.__all__
