"""Row-sparse gradients: the SelectedRows (counterpart of
paddle_tpu/framework/selected_rows.py).

An embedding looked up with `sparse=True` gives its table a gradient of
one row per id, duplicates kept, instead of a dense [V, D] tensor
(op `lookup_table_v2_sparse`, ops/nn_ops.py). torch autograd carries it
as an uncoalesced sparse COO tensor in the parameter's `grad`: torch's
accumulation appends a second sparse gradient's rows to the first (no
merge), and a dense gradient met with a sparse one gives a dense sum, as
the reference's tape does. `SelectedRows` is never what is stored: it is
the view that reading `.grad` builds over the COO tensor's indices and
values (`grad_view`), so the rows and values are the stored tensors
themselves.

Captured steps stay dense, as the reference's traced steps do: inside
`make_train_step`'s body or a static program (`dense_gradients()`), a
`sparse=True` lookup is the dense op, since a captured graph cannot take
the host-sized `unique` of a lazy update. `dense_lookups()` counts those
lookups.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = ["SelectedRows", "grad_view", "dense_gradients",
           "sparse_allowed", "dense_lookups"]

_STATE = threading.local()
_DENSE_LOOKUPS = [0]


class SelectedRows:
    """A row-sparse tensor: ``dense[rows[i]] += values[i]``; `rows` int64
    [n], `values` [n, ...], `height` the dense tensor's first dim."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        rows = torch.as_tensor(rows)
        self.rows = rows.reshape(-1).long()
        values = torch.as_tensor(values, device=self.rows.device)
        n = self.rows.shape[0]
        if values.dim() == 0 or values.shape[0] != n:
            values = values.reshape(n, -1)
        self.values = values
        self.height = int(height)

    @property
    def shape(self):
        return [self.height] + list(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def __repr__(self):
        return ("SelectedRows(height=%d, nnz_rows=%d, row_dim=%s)"
                % (self.height, self.rows.shape[0],
                   tuple(self.values.shape[1:])))

    def to_dense(self) -> torch.Tensor:
        """The dense tensor, duplicate rows summed (a scatter-add)."""
        out = torch.zeros([self.height] + list(self.values.shape[1:]),
                          dtype=self.values.dtype, device=self.values.device)
        return out.index_add_(0, self.rows, self.values)

    def numpy(self) -> np.ndarray:
        d = self.to_dense().detach()
        return (d.float() if d.dtype == torch.bfloat16 else d).cpu().numpy()

    def merged(self) -> "SelectedRows":
        """Duplicate rows folded: a unique of the rows (its size read on
        the host) and a segment sum of the values on the device; self
        where every row is already unique."""
        uniq, inv = torch.unique(self.rows, return_inverse=True)
        if uniq.shape[0] == self.rows.shape[0]:
            return self
        vals = torch.zeros((uniq.shape[0],) + tuple(self.values.shape[1:]),
                           dtype=self.values.dtype, device=self.values.device)
        return SelectedRows(uniq, vals.index_add_(0, inv, self.values),
                            self.height)

    def append(self, other: "SelectedRows") -> "SelectedRows":
        """Both gradients' rows, concatenated (no merge)."""
        if self.height != other.height:
            raise ValueError("height mismatch in sparse accumulation")
        return SelectedRows(torch.cat([self.rows, other.rows]),
                            torch.cat([self.values, other.values]),
                            self.height)


def grad_view(g):
    """A stored gradient as the reference reads it: a sparse COO tensor
    as a SelectedRows over its indices and values, else `g` itself."""
    if g is None or not g.is_sparse:
        return g
    return SelectedRows(g._indices()[0], g._values(), g.shape[0])


@contextlib.contextmanager
def dense_gradients():
    """Inside the block (a captured step's body, a static program's run)
    a `sparse=True` lookup takes the dense gradient."""
    depth = getattr(_STATE, "dense", 0)
    _STATE.dense = depth + 1
    try:
        yield
    finally:
        _STATE.dense = depth


def sparse_allowed(weight) -> bool:
    """A `sparse=True` lookup of `weight` gives a row-sparse gradient: in
    dygraph, outside `dense_gradients`, with grad mode on, for a leaf
    table (a gradient that flows on through the graph is dense, as the
    reference keeps SelectedRows on parameters only). A lookup refused
    inside `dense_gradients` counts in `dense_lookups`."""
    if getattr(_STATE, "dense", 0):
        _DENSE_LOOKUPS[0] += 1
        return False
    return (torch.is_grad_enabled() and weight.requires_grad
            and weight.grad_fn is None)


def dense_lookups(reset=False) -> int:
    """`sparse=True` lookups that ran dense inside a captured step or a
    static program (a captured step counts its build)."""
    n = _DENSE_LOOKUPS[0]
    if reset:
        _DENSE_LOOKUPS[0] = 0
    return n
