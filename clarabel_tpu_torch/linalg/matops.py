"""Matrix operations on dense tensors or static-pattern COO matrices,
batched over a leading lane axis.

A port of `clarabel_tpu/linalg/matops.py`: the loop solver is written
against these helpers, so the same IPM runs on dense data, (B, r, c)
tensors, and on sparse data, `SparseCOO` values (B, nnz) over one pattern
that every lane shares.  The pattern is fixed at setup; only the values
ride through the solve.

Every sum over a pattern runs in a fixed order (`SegmentSum`): the
entries are sorted once, on the host, by destination (stably, so entries
that meet keep their source order), and each destination's entries are
summed by `torch.segment_reduce`, which adds one segment's entries in
sequence.  On a card `index_add_` and `scatter_add_` sum by atomics, so
two runs could differ in the last bits and so could every equilibration
and factorization built on them (DEVIATIONS.md #18).
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import smallops as so


def on_device(owner, name: str, device, build=None) -> torch.Tensor:
    """A host array of `owner` (a plan, its maps, a pattern, a cone group
    or layout) as a tensor on `device`, made once per device and kept on
    the owner: `build()`, or the owner's attribute `name`, gives the numpy
    array the first time (integers as int64, for indexing).  Made before a
    CUDA graph is captured, a copy from the host never runs inside it."""
    cache = owner.__dict__.setdefault("_tensors", {})
    key = (name, str(device))
    t = cache.get(key)
    if t is None:
        arr = np.array(build() if build is not None else getattr(owner, name))
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
        t = torch.as_tensor(arr, device=device)
        cache[key] = t
    return t


class SegmentSum:
    """out[:, d] = Σ src[:, i] over the entries i with dest[i] == d, for
    d < size, in the order of i; entries with dest outside [0, size) drop.
    Built once on the host from `dest`; its index tensors are made once per
    device (`on_device`)."""

    def __init__(self, dest, size: int):
        dest = np.asarray(dest, dtype=np.int64).ravel()
        self.size = int(size)
        keep = np.flatnonzero((dest >= 0) & (dest < self.size))
        self.order = keep[np.argsort(dest[keep], kind="stable")]
        self.lengths = np.bincount(dest[keep], minlength=self.size)

    def tensors(self, device):
        return (on_device(self, "order", device),
                on_device(self, "lengths", device))

    def __call__(self, src):
        """src (B, n_src, ...) -> (B, size, ...)."""
        B = src.shape[0]
        rest = tuple(src.shape[2:])
        if self.order.size == 0:
            return src.new_zeros((B, self.size) + rest)
        order, lengths = self.tensors(src.device)
        data = src[:, order].movedim(1, 0)
        # unsafe: the lengths sum to the entries by construction, and the
        # check would read them on the host
        out = torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                                   unsafe=True)
        return out.movedim(0, 1)

    def amax(self, src):
        """max(0, max |src|) per destination, (B, n_src) -> (B, size)."""
        B = src.shape[0]
        if self.order.size == 0:
            return src.new_zeros((B, self.size))
        order, lengths = self.tensors(src.device)
        data = src[:, order].abs().movedim(1, 0)
        out = torch.segment_reduce(data, "max", lengths=lengths, axis=0,
                                   unsafe=True, initial=0.0)
        return out.movedim(0, 1)


class Pattern:
    """The shared pattern of a COO matrix: its rows and columns, its shape,
    and the fixed-order sums by row (for M x) and by column (for Mᵀ x)."""

    def __init__(self, rows, cols, shape: Tuple[int, int]):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.shape = (int(shape[0]), int(shape[1]))
        self.by_row = SegmentSum(self.rows, self.shape[0])
        self.by_col = SegmentSum(self.cols, self.shape[1])


class SparseCOO(NamedTuple):
    """COO matrix with values (B, nnz) over a static shared `Pattern`."""
    vals: torch.Tensor
    pattern: Pattern

    def to(self, *args, **kwargs):
        return self._replace(vals=self.vals.to(*args, **kwargs))


def make_sparse_coo(M_scipy) -> SparseCOO:
    """A scipy.sparse matrix as a one-lane SparseCOO in float64 on the CPU,
    in the matrix's COO entry order."""
    import scipy.sparse as sp

    M = sp.coo_matrix(M_scipy)
    vals = torch.as_tensor(np.asarray(M.data, dtype=np.float64))
    return SparseCOO(vals=vals[None], pattern=Pattern(M.row, M.col, M.shape))


def is_sparse(M) -> bool:
    return isinstance(M, SparseCOO)


def nrows(M) -> int:
    return M.pattern.shape[0] if is_sparse(M) else M.shape[-2]


def ncols(M) -> int:
    return M.pattern.shape[1] if is_sparse(M) else M.shape[-1]


def _products(M: SparseCOO, x, index: str):
    """vals * x[:, index] for x (B, K) or (B, K, k)."""
    g = x[:, on_device(M.pattern, index, x.device)]
    return M.vals[..., None] * g if x.dim() == 3 else M.vals * g


def mv(M, x):
    """M @ x for x (B, ncols) or (B, ncols, k)."""
    if not is_sparse(M):
        return so.mv(M, x)
    return M.pattern.by_row(_products(M, x, "cols"))


def rmv(M, x):
    """Mᵀ @ x."""
    if not is_sparse(M):
        return so.rmv(M, x)
    return M.pattern.by_col(_products(M, x, "rows"))


def col_abs_max(M):
    """Per-lane column inf-norms, (B, ncols); empty columns read 0."""
    if not is_sparse(M):
        return M.abs().amax(dim=1)
    return M.pattern.by_col.amax(M.vals)


def row_abs_max(M):
    """Per-lane row inf-norms, (B, nrows)."""
    if not is_sparse(M):
        return M.abs().amax(dim=2)
    return M.pattern.by_row.amax(M.vals)


def mean_col_abs_max(M):
    return col_abs_max(M).mean(dim=1)


def scale_lr(M, l, r):
    """diag(l) M diag(r), per lane; either may be None."""
    if not is_sparse(M):
        if l is not None:
            M = l[:, :, None] * M
        if r is not None:
            M = M * r[:, None, :]
        return M
    vals = M.vals
    if l is not None:
        vals = vals * l[:, on_device(M.pattern, "rows", vals.device)]
    if r is not None:
        vals = vals * r[:, on_device(M.pattern, "cols", vals.device)]
    return M._replace(vals=vals)


def scalar_mul(M, c):
    """c (B,) times M, per lane."""
    if not is_sparse(M):
        return M * c[:, None, None]
    return M._replace(vals=M.vals * c[:, None])
