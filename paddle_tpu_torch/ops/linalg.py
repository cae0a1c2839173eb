"""Linear algebra ops (counterpart of paddle_tpu/ops/linalg.py): norms,
factorizations, solves, einsum, histograms and statistics, on
`torch.linalg` (cuSOLVER / cuBLAS on the card).

Factors are those of `torch.linalg`; where a factorization is unique only
up to signs or order (svd, qr, eig, eigh), the reference's may differ by
them, and the tests compare reconstructions. `lu` returns 1-based int32
pivots, `matrix_rank` int32, `histogram` and `bincount` int64, as the
reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..amp import amp_cast_inputs
from ..framework.dispatch import primitive
from .math import _float_in, no_capture, promote


@primitive("p_norm")
def _p_norm(x, *, porder=2.0, axis=None, keepdim=False):
    """The vector p-norm over `axis` (x flattened for None)."""
    (x,) = amp_cast_inputs("p_norm", [x])
    x = _float_in(x)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    if porder == np.inf:
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdim)
    if porder == -np.inf:
        return torch.amin(torch.abs(x), dim=axis, keepdim=keepdim)
    if porder == 0:
        return torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keepdim)
    a = torch.where(x >= 0, x, -x)          # jnp.abs: gradient 1 at 0
    return torch.pow(torch.sum(torch.pow(a, porder), dim=axis,
                               keepdim=keepdim), 1.0 / porder)


@primitive("frobenius_norm")
def _fro_norm(x, *, axis=None, keepdim=False):
    (x,) = amp_cast_inputs("frobenius_norm", [x])
    x = _float_in(x)
    if axis is None:
        return torch.sqrt(torch.sum(torch.square(x)))
    return torch.sqrt(torch.sum(torch.square(x), dim=tuple(axis),
                                keepdim=keepdim))


@primitive("matrix_norm")
def _matrix_norm(x, *, porder, axis, keepdim=False):
    """The induced 1 / inf (and -1 / -inf) norms over two axes."""
    a0, a1 = axis
    ax = torch.where(x >= 0, x, -x)
    if porder in (np.inf, -np.inf):
        red = torch.sum(ax, dim=a1, keepdim=True)
        out = torch.amax(red, dim=a0, keepdim=True) if porder > 0 \
            else torch.amin(red, dim=a0, keepdim=True)
    else:
        red = torch.sum(ax, dim=a0, keepdim=True)
        out = torch.amax(red, dim=a1, keepdim=True) if porder > 0 \
            else torch.amin(red, dim=a1, keepdim=True)
    if not keepdim:
        out = out.squeeze(tuple(sorted((a0 % x.ndim, a1 % x.ndim))))
    return out


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """paddle.linalg.norm: "fro" over all or two axes (the 2-norm over
    one), a vector p-norm over one axis or all, the induced 1 / inf norms
    over two."""
    if p == "fro":
        if axis is None or isinstance(axis, (list, tuple)):
            return _fro_norm(x, axis=tuple(axis) if axis is not None
                             else None, keepdim=keepdim)
        return _p_norm(x, porder=2.0, axis=int(axis), keepdim=keepdim)
    if isinstance(axis, (list, tuple)) and len(axis) == 2:
        if p in (np.inf, -np.inf, 1, -1):
            return _matrix_norm(x, porder=float(p), axis=tuple(axis),
                                keepdim=keepdim)
        raise ValueError("unsupported matrix norm order %r" % (p,))
    return _p_norm(x, porder=float(p),
                   axis=int(axis) if axis is not None else None,
                   keepdim=keepdim)


@primitive("cholesky_op")
def cholesky(x, *, upper=False):
    L = torch.linalg.cholesky(x)
    return L.transpose(-1, -2) if upper else L


@primitive("cholesky_solve_op")
def cholesky_solve(x, y, *, upper=False):
    """z with A z = x, A = L Lᵀ and y its factor (lower, or upper)."""
    L = y.transpose(-1, -2) if upper else y
    z = torch.linalg.solve_triangular(L, x, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), z, upper=True)


@primitive("inverse_op")
def inverse(x):
    return torch.linalg.inv(x)


@primitive("pinv_op")
def pinv(x, *, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@primitive("matrix_power_op")
def matrix_power(x, *, n):
    return torch.linalg.matrix_power(x, int(n))


@primitive("det_op")
def det(x):
    return torch.linalg.det(x)


@primitive("slogdet_op")
def slogdet(x):
    """[sign, log|det|] stacked on a new first axis."""
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


@primitive("svd_op")
def svd(x, *, full_matrices=False):
    """(U, S, Vh), x = U diag(S) Vh."""
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


@primitive("qr_op")
def qr(x, *, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r


@primitive("lu_op")
def lu(x):
    """(packed LU, 1-based int32 pivots), LAPACK's getrf."""
    lu_, piv = torch.linalg.lu_factor(x)
    return lu_, piv.to(torch.int32)


@primitive("eig_op")
def eig(x):
    w, v = torch.linalg.eig(x)
    return w, v


@primitive("eigh_op")
def eigh(x, *, UPLO="L"):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


@primitive("eigvals_op")
def eigvals(x):
    return torch.linalg.eigvals(x)


@primitive("eigvalsh_op")
def eigvalsh(x, *, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@primitive("matrix_rank_op", nondiff=True)
def matrix_rank(x, *, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, rtol=tol,
                                    hermitian=hermitian).to(torch.int32)


@primitive("solve_op")
def solve(x, y):
    return torch.linalg.solve(x, y)


@primitive("triangular_solve_op")
def triangular_solve(x, y, *, upper=True, transpose=False,
                     unitriangular=False):
    """z with op(x) z = y, op the transpose when asked."""
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(a, y, upper=upper != transpose,
                                         unitriangular=unitriangular)


@primitive("lstsq_op")
def lstsq(x, y, *, rcond=None):
    """(solution, residuals, rank int32, singular values) as
    jnp.linalg.lstsq computes them: the solution through the SVD with the
    singular values under rcond * the largest cut, the residuals the
    squared column sums of y - x @ solution in every case."""
    m, n = x.shape[-2], x.shape[-1]
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    cut = (torch.finfo(x.dtype).eps * max(m, n)) if rcond is None \
        else rcond
    mask = (s > 0) & (s >= cut * s[..., :1])
    rank = mask.sum(-1).to(torch.int32)
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    b = y[:, None] if y.ndim == 1 else y
    sol = vh.transpose(-1, -2) @ (s_inv[..., None]
                                  * (u.transpose(-1, -2) @ b))
    res = torch.sum(torch.square(b - x @ sol), dim=-2)
    return (sol.reshape(-1) if y.ndim == 1 else sol), res, rank, s


@primitive("multi_dot_op")
def multi_dot(*xs):
    return torch.linalg.multi_dot(promote(*xs))


@primitive("histogram_op", nondiff=True)
def histogram(x, *, bins=100, min=0, max=0):  # noqa: A002
    """int64 counts of `bins` equal bins over [min, max] (the data's range
    when both are 0), the last bin closed."""
    x = _float_in(x).float()
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.histc(x, bins=int(bins), min=lo, max=hi).to(torch.int64)


@primitive("bincount_op", nondiff=True)
def bincount(x, *, minlength=0):
    """int64 counts of each value of the non-negative integer x."""
    no_capture("bincount")
    return torch.bincount(x.reshape(-1).long(),
                          minlength=int(minlength)).to(torch.int64)


@primitive("trace_op")
def trace(x, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2).sum(-1)


@primitive("einsum_op")
def _einsum(*operands, equation):
    operands = amp_cast_inputs("einsum_op", list(operands))
    return torch.einsum(equation, *promote(*operands))


def einsum(equation, *operands):
    """torch.einsum over the operands (op einsum_op, white-listed under
    auto_cast); the operands may also come as one list."""
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return _einsum(*operands, equation=equation)


@primitive("corrcoef_op")
def corrcoef(x, *, rowvar=True):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


@primitive("cov_op")
def cov(x, *, rowvar=True, ddof=True):
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0)


def _fro(a):
    return torch.sqrt(torch.sum(torch.square(a), dim=(-2, -1)))


@primitive("cond_number_op")
def cond_number(x, *, p=None):
    """The condition number in the norm p (2 by default)."""
    if p is None or p == 2:
        s = torch.linalg.svdvals(x)
        return s[..., 0] / s[..., -1]
    if p == -2:
        s = torch.linalg.svdvals(x)
        return s[..., -1] / s[..., 0]
    if p == "fro":
        return _fro(x) * _fro(torch.linalg.inv(x))
    if p in (1, -1, np.inf, -np.inf, "nuc"):
        return torch.linalg.cond(x, p)
    raise ValueError("unsupported p=%r for cond" % (p,))
