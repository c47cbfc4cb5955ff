"""The port's `Solver` with a structure plan on dense data (`device="cpu"`)
against the committed outputs of `clarabel_tpu.Solver`
(`tests/torch_fixtures/sparse.npz`), held as in
`tests/test_torch_sparse_solver.py`: `kkt_backend="multifrontal"` and
"auto" on grid QPs (the nested plan), `kkt_backend="blockarrow"` on a
banded QP; and a chordally decomposed SDP whose decomposed problem
(n + m > 2000) re-enters the sparse setup.  And the generators of [14]'s problems in
`clarabel_tpu_torch/bench_data.py` against the repository's own, bit for
bit, at the sizes [14] runs.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from clarabel_tpu_torch import bench_data

from test_torch_sparse_solver import solve_case


@pytest.mark.parametrize("name", ["grid_multifrontal", "grid_auto",
                                  "blockarrow_dense"])
def test_structured_solver_matches_the_reference(name):
    solver = solve_case(name)
    assert not solver._sparse_mode
    assert solver.linear_solver_info()["backend"] == solver._backend


def test_chordal_then_sparse():
    solver = solve_case("chordal_sparse")
    assert solver.chordal_info is not None and solver._sparse_mode


def _same(a, b):
    if sp.issparse(a):
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        assert a.shape == b.shape
        for k in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    else:
        np.testing.assert_array_equal(a, b)


def test_generators_equal_the_repository_ones():
    from benchmarks.configs import large_banded_qp_sparse
    from benchmarks.grid_qp import grid_qp_sparse
    from clarabel_tpu_torch.interop import cone_to_tuple
    from test_soc_rank2 import robust_ls_banded

    for a, b in zip(bench_data.grid_qp_sparse(60), grid_qp_sparse(60)):
        _same(a, b)
    mine, ref = bench_data.large_banded_qp_sparse(2500), \
        large_banded_qp_sparse(2500)
    for a, b in zip(mine[:4], ref[:4]):
        _same(a, b)
    assert [cone_to_tuple(c) for c in mine[4]] == \
        [cone_to_tuple(c) for c in ref[4]]
    mine = bench_data.robust_ls_banded(m=2000, n=500)
    ref = robust_ls_banded(m=2000, n=500)
    for i, (a, b) in enumerate(zip(mine, ref)):
        if i == 4:
            assert [cone_to_tuple(c) for c in a] == \
                [cone_to_tuple(c) for c in b]
        else:
            _same(a, b)
