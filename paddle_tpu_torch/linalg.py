"""paddle.linalg (counterpart of paddle_tpu/linalg.py): the linear algebra
functions of the tensor surface under their namespace, `inv` the alias of
`inverse`. The ops live in ops/linalg.py."""
from .tensor import (cholesky, cholesky_solve, cond, det, eig, eigh,  # noqa: F401
                     eigvals, eigvalsh, inverse, lstsq, lu, matrix_power,
                     matrix_rank, multi_dot, norm, pinv, qr, slogdet, solve,
                     svd, triangular_solve)

__all__ = ["cholesky", "cholesky_solve", "cond", "det", "eig", "eigh",
           "eigvals", "eigvalsh", "inv", "inverse", "lstsq", "lu",
           "matrix_power", "matrix_rank", "multi_dot", "norm", "pinv",
           "qr", "slogdet", "solve", "svd", "triangular_solve"]

inv = inverse
