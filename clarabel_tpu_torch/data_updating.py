"""Problem data updating for warm re-solves of the single-instance
`Solver`, dense path.

A copy of the dense part of `clarabel_tpu/data_updating.py` (l.141-333):
`update_P/q/A/b/update_data` with the reference's guard rails (updates are
disallowed while the presolver or the chordal decomposition is active,
reference: src/data_updating.jl:149-158).  Matrix updates take a full
matrix or (rows, cols, values) triplets; P updates read the upper
triangle.  The sparse mode's index maps come with ROADMAP.md Queue 1 item
11.  Every update drops the solver's device-resident copy of the problem,
so the next solve moves the new data to the device.
"""

import numpy as np


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


def update_P(solver, data) -> None:
    """Overwrite P: an (n, n) matrix (its upper triangle is read), a
    (rows, cols, values) triplet tuple into the upper triangle, or None."""
    if data is None:
        return
    _check_update_allowed(solver)
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


def update_A(solver, data) -> None:
    if data is None:
        return
    _check_update_allowed(solver)
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


def update_data(solver, P=None, q=None, A=None, b=None) -> None:
    """reference: src/data_updating.jl:26-40"""
    update_P(solver, P)
    update_q(solver, q)
    update_A(solver, A)
    update_b(solver, b)
