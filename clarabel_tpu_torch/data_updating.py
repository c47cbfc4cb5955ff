"""Problem data updating for warm re-solves of the single-instance
`Solver`.

A copy of `clarabel_tpu/data_updating.py`: `update_P/q/A/b/update_data`
with the reference's guard rails (updates are disallowed while the
presolver or the chordal decomposition is active, reference:
src/data_updating.jl:149-158).  On the dense path matrix updates take a
full matrix or (rows, cols, values) triplets; P updates read the upper
triangle.  In sparse mode they take a same-pattern matrix, a CSC nzval
vector (the reference's native form) or triplets into the existing
pattern, and rewrite the COO values through index maps frozen at setup
(`SparseUpdateMaps`), so a warm re-solve keeps the built solve function
and the structure plan: nothing is analyzed again.  Every update drops
the solver's device-resident copy of the problem, so the next solve moves
the new data to the device.
"""

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class SparseUpdateMaps:
    """Frozen COO patterns + index maps for sparse-mode warm updates.

    The solve-function inputs are COO value arrays whose entry order was
    fixed at setup (it is baked into the KKT assembly maps).  Updates
    therefore only ever rewrite values:

    * P is held internally as the full symmetric pattern; the user-facing
      update surface is its upper triangle.  ``p_sym_from_triu`` scatters
      sorted-triu values onto the symmetric COO data order.
    * ``*_csc_order`` gives, for each entry of the sorted-key value
      array, its position in CSC nzval order — the reference's native
      update form (src/data_updating.jl:169-205 writes CSC nzvals).
    """

    n: int
    m: int
    # P upper triangle, sorted by row-major key r*n+c
    p_triu_keys: np.ndarray
    p_triu_vals: np.ndarray
    # position in sorted-triu array for each symmetric-COO data entry
    p_sym_from_triu: np.ndarray
    p_sym_rows: np.ndarray
    p_sym_cols: np.ndarray
    # permutation: sorted-triu position for the k-th CSC nzval of triu(P)
    p_csc_order: np.ndarray
    # A pattern, sorted by row-major key
    a_keys: np.ndarray
    a_vals: np.ndarray
    # position in sorted-key array for each A-COO data entry
    a_coo_from_sorted: np.ndarray
    a_rows: np.ndarray
    a_cols: np.ndarray
    a_csc_order: np.ndarray

    @staticmethod
    def build(P_sym_coo, A_coo, n: int) -> "SparseUpdateMaps":
        m = A_coo.shape[0]
        pr = np.asarray(P_sym_coo.row, dtype=np.int64)
        pc = np.asarray(P_sym_coo.col, dtype=np.int64)
        pv = np.asarray(P_sym_coo.data, dtype=np.float64)

        triu_mask = pr <= pc
        tr, tc, tv = pr[triu_mask], pc[triu_mask], pv[triu_mask]
        tkeys = tr * n + tc
        order = np.argsort(tkeys)
        tkeys, tv = tkeys[order], tv[order].copy()
        # map each symmetric entry (r,c) -> sorted-triu slot of (min,max)
        sym_keys = np.minimum(pr, pc) * n + np.maximum(pr, pc)
        p_sym_from_triu = np.searchsorted(tkeys, sym_keys)
        # CSC nzval order = sort by (col, row)
        p_csc_order = np.lexsort((tkeys // n, tkeys % n))

        ar = np.asarray(A_coo.row, dtype=np.int64)
        ac = np.asarray(A_coo.col, dtype=np.int64)
        av = np.asarray(A_coo.data, dtype=np.float64)
        akeys_data = ar * n + ac
        aorder = np.argsort(akeys_data)
        akeys = akeys_data[aorder]
        avals = av[aorder].copy()
        a_coo_from_sorted = np.searchsorted(akeys, akeys_data)
        a_csc_order = np.lexsort((akeys // n, akeys % n))

        return SparseUpdateMaps(
            n=n, m=m,
            p_triu_keys=tkeys, p_triu_vals=tv,
            p_sym_from_triu=p_sym_from_triu,
            p_sym_rows=pr, p_sym_cols=pc, p_csc_order=p_csc_order,
            a_keys=akeys, a_vals=avals,
            a_coo_from_sorted=a_coo_from_sorted,
            a_rows=ar, a_cols=ac, a_csc_order=a_csc_order,
        )

    # -- value-array rewrites -------------------------------------------
    def set_triu_P(self, rows, cols, vals):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if np.any(rows > cols):
            raise ValueError("P updates must index the upper triangle")
        keys = rows * self.n + cols
        pos = np.searchsorted(self.p_triu_keys, keys)
        ok = (pos < self.p_triu_keys.shape[0]) & (
            self.p_triu_keys[np.minimum(pos, self.p_triu_keys.shape[0] - 1)]
            == keys
        )
        if not np.all(ok):
            raise ValueError(
                "P update entries outside the original sparsity pattern"
            )
        self.p_triu_vals[pos] = vals

    def set_A(self, rows, cols, vals):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        keys = rows * self.n + cols
        pos = np.searchsorted(self.a_keys, keys)
        ok = (pos < self.a_keys.shape[0]) & (
            self.a_keys[np.minimum(pos, self.a_keys.shape[0] - 1)] == keys
        )
        if not np.all(ok):
            raise ValueError(
                "A update entries outside the original sparsity pattern"
            )
        self.a_vals[pos] = vals

    def sym_P_vals(self) -> np.ndarray:
        return self.p_triu_vals[self.p_sym_from_triu]

    def coo_A_vals(self) -> np.ndarray:
        return self.a_vals[self.a_coo_from_sorted]




def _invalidate_device_cache(solver):
    """Warm re-solves keep the problem data on the device
    (api.Solver.solve); an update drops that copy."""
    solver._dev_args = None


def _check_update_allowed(solver):
    """reference: src/data_updating.jl:149-158"""
    _invalidate_device_cache(solver)
    if solver.presolver is not None:
        raise ValueError("Data updates not allowed if presolver is active.")
    if solver.chordal_info is not None:
        raise ValueError(
            "Data updates not allowed if chordal decomposition is active."
        )
    if solver.settings.input_sparse_dropzeros:
        raise ValueError(
            "Data updates not allowed if input_sparse_dropzeros is enabled."
        )


def _refresh_sparse_args(solver):
    """The updated values back into the solve's inputs (reference
    data_updating.py:163-185)."""
    maps: SparseUpdateMaps = solver._sparse_maps
    sym_vals = maps.sym_P_vals()
    a_vals = maps.coo_A_vals()
    solver._data_args = (sym_vals, np.asarray(solver._q, dtype=np.float64),
                         a_vals, np.asarray(solver._b, dtype=np.float64))
    n, m = maps.n, maps.m
    solver._P_full = sp.csr_matrix(
        (sym_vals, (maps.p_sym_rows, maps.p_sym_cols)), shape=(n, n))
    solver._A = sp.csr_matrix((a_vals, (maps.a_rows, maps.a_cols)),
                              shape=(m, n))


def _matrix_to_triplets(data, shape, triu: bool):
    """A full-matrix update as (rows, cols, vals) over the whole matrix
    (the setter checks that they lie in the pattern)."""
    if sp.issparse(data):
        M = sp.coo_matrix(data)
    else:
        M = sp.coo_matrix(np.asarray(data, dtype=np.float64))
    if M.shape != shape:
        raise ValueError("Input must match dimension of original data.")
    if triu:
        M = sp.triu(M).tocoo()
    return M.row, M.col, M.data


def update_P(solver, data) -> None:
    """Overwrite P: an (n, n) matrix (its upper triangle is read), a
    (rows, cols, values) triplet tuple into the upper triangle, in sparse
    mode a CSC-ordered nzval vector of triu(P), or None."""
    if data is None:
        return
    _check_update_allowed(solver)
    if solver._sparse_mode:
        maps: SparseUpdateMaps = solver._sparse_maps
        if isinstance(data, tuple) and len(data) == 3:
            maps.set_triu_P(*data)
        elif isinstance(data, np.ndarray) and data.ndim == 1:
            v = np.asarray(data, dtype=np.float64)
            if v.shape[0] == 0:
                return
            if v.shape[0] != maps.p_triu_keys.shape[0]:
                raise ValueError("Input must match length of original data.")
            maps.p_triu_vals[maps.p_csc_order] = v
        else:
            rows, cols, vals = _matrix_to_triplets(
                data, (solver.n, solver.n), triu=True)
            # a full replacement: entries the new matrix leaves out become
            # explicit zeros
            maps.p_triu_vals[:] = 0.0
            maps.set_triu_P(rows, cols, vals)
        _refresh_sparse_args(solver)
        return
    from .api import _symmetrize_triu, _to_dense

    if isinstance(data, tuple) and len(data) == 3:
        rows, cols, vals = data
        P = np.triu(solver._P_full).copy()
        for i, j, v in zip(rows, cols, vals):
            if i > j:
                raise ValueError("P updates must index the upper triangle")
            P[i, j] = v
        solver._P_full = _symmetrize_triu(P)
    else:
        M = _to_dense(data).astype(np.float64)
        if M.shape != (solver.n, solver.n):
            raise ValueError("Input must match dimension of original data.")
        solver._P_full = _symmetrize_triu(M)


def update_q(solver, data) -> None:
    if data is None:
        return
    _check_update_allowed(solver)
    if isinstance(data, tuple) and len(data) == 2:
        idx, vals = data
        q = np.asarray(solver._q).copy()
        q[np.asarray(idx)] = vals
        solver._q = q
    else:
        v = np.asarray(data, dtype=np.float64).ravel()
        if v.shape[0] == 0:
            return
        if v.shape[0] != solver.n:
            raise ValueError("Input must match length of original data.")
        solver._q = v.copy()
    if solver._sparse_mode:
        _refresh_sparse_args(solver)


def update_A(solver, data) -> None:
    if data is None:
        return
    _check_update_allowed(solver)
    if solver._sparse_mode:
        maps: SparseUpdateMaps = solver._sparse_maps
        if isinstance(data, tuple) and len(data) == 3:
            maps.set_A(*data)
        elif isinstance(data, np.ndarray) and data.ndim == 1:
            v = np.asarray(data, dtype=np.float64)
            if v.shape[0] == 0:
                return
            if v.shape[0] != maps.a_keys.shape[0]:
                raise ValueError("Input must match length of original data.")
            maps.a_vals[maps.a_csc_order] = v
        else:
            rows, cols, vals = _matrix_to_triplets(
                data, (solver.m, solver.n), triu=False)
            maps.a_vals[:] = 0.0
            maps.set_A(rows, cols, vals)
        _refresh_sparse_args(solver)
        return
    from .api import _to_dense

    if isinstance(data, tuple) and len(data) == 3:
        rows, cols, vals = data
        A = solver._A.copy()
        A[np.asarray(rows), np.asarray(cols)] = vals
        solver._A = A
    else:
        M = _to_dense(data).astype(np.float64)
        if M.shape != (solver.m, solver.n):
            raise ValueError("Input must match dimension of original data.")
        solver._A = M.copy()


def update_b(solver, data) -> None:
    if data is None:
        return
    _check_update_allowed(solver)
    if isinstance(data, tuple) and len(data) == 2:
        idx, vals = data
        b = np.asarray(solver._b).copy()
        b[np.asarray(idx)] = vals
        solver._b = b
    else:
        v = np.asarray(data, dtype=np.float64).ravel()
        if v.shape[0] == 0:
            return
        if v.shape[0] != solver.m:
            raise ValueError("Input must match length of original data.")
        solver._b = v.copy()
    if solver._sparse_mode:
        _refresh_sparse_args(solver)


def update_data(solver, P=None, q=None, A=None, b=None) -> None:
    """reference: src/data_updating.jl:26-40"""
    update_P(solver, P)
    update_q(solver, q)
    update_A(solver, A)
    update_b(solver, b)
