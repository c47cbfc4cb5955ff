"""The port's `Solver` on its sparse and structured KKT (`device="cpu"`),
end to end, against the committed outputs of `clarabel_tpu.Solver` in
`tests/torch_fixtures/sparse.npz` (`make_sparse_fixtures.py`; its live
regeneration is marked slow).

The cases are those of `tests/test_sparse_mode.py` (the dense match, the
auto threshold, the dense fallback, update_b/update_q and
update_P/update_A, SOCs, exponential cones; the chordal decomposition
feeding the sparse setup is in `tests/test_torch_structured_solver.py`),
`tests/test_multifrontal.py` (the grid QP in sparse
mode) and `tests/test_soc_rank2.py` (the rank-2 SOC, a dense input routed
to it, the low-rank genpow cone with d2 = 60).  Each holds: the backend,
the plan's type and whether the sparse setup engaged, equal; the status
equal; iterations within 4; on SOLVED cases x within 1e-6 of the
reference (relative to max(1, |x|∞)), the objective within
1e-6·max(1, |obj|), and the true-KKT residuals (2-norms) of the port's
own output below 1e-7.  The dense-path structured cases are in
`tests/test_torch_structured_solver.py`.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.interop import cone_from_tuple

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
FIX = np.load(os.path.join(FIXTURES, "sparse.npz"))
TOL, KKT_TOL, IT_TOL = 1e-6, 1e-7, 4


def _coo(key):
    return sp.coo_matrix((FIX[f"{key}_val"], (FIX[f"{key}_row"],
                                              FIX[f"{key}_col"])),
                         shape=tuple(FIX[f"{key}_shape"])).tocsr()


def load_case(name):
    """(P, q, A, b, cones, settings) of a committed case, P and A scipy
    or dense as the case passes them."""
    P, A = _coo(f"{name}_P"), _coo(f"{name}_A")
    if not bool(FIX[f"{name}_sparse_in"]):
        P, A = P.toarray(), A.toarray()
    cones = [cone_from_tuple(tuple(c))
             for c in json.loads(str(FIX[f"{name}_cones"]))]
    st = ctt.Settings(**json.loads(str(FIX[f"{name}_settings"])))
    return P, FIX[f"{name}_q"], A, FIX[f"{name}_b"], cones, st


def true_kkt(P, q, A, b, sol):
    U = sp.triu(sp.csr_matrix(P))
    Pf = U + sp.triu(U, 1).T
    A = sp.csr_matrix(A)
    return (np.linalg.norm(A @ sol.x + sol.s - b),
            np.linalg.norm(Pf @ sol.x + q + A.T @ sol.z))


def check(key, solver, sol, P, q, A, b):
    """Hold a solution to the fixture's outputs under `key`."""
    plan = type(solver._structure).__name__ if solver._structure is not None \
        else ""
    assert solver._backend == str(FIX[f"{key}_backend"])
    assert plan == str(FIX[f"{key}_plan"])
    assert solver._sparse_mode == bool(FIX[f"{key}_sparse_mode"])
    assert int(sol.status) == int(FIX[f"{key}_status"])
    assert abs(sol.iterations - int(FIX[f"{key}_iterations"])) <= IT_TOL
    if sol.status != ctt.SolverStatus.SOLVED:
        return
    ref_x, ref_obj = FIX[f"{key}_x"], float(FIX[f"{key}_obj_val"])
    assert np.abs(sol.x - ref_x).max() <= TOL * max(1.0, np.abs(ref_x).max())
    assert abs(sol.obj_val - ref_obj) <= TOL * max(1.0, abs(ref_obj))
    rp, rd = true_kkt(P, q, A, b, sol)
    assert rp < KKT_TOL and rd < KKT_TOL, (rp, rd)


def solve_case(name):
    P, q, A, b, cones, st = load_case(name)
    solver = ctt.Solver(P, q, A, b, cones, st, device="cpu")
    check(name, solver, solver.solve(), P, q, A, b)
    return solver


@pytest.mark.parametrize("name", [
    "dense_match", "auto_threshold", "dense_fallback", "socs", "exp",
    "grid_sparse", "rank2", "rank2_dense_input", "lowrank_genpow"])
def test_solver_matches_the_reference(name):
    solver = solve_case(name)
    if name == "rank2":
        # the big SOC's Hs enters the assembly as its diagonal: O(d)
        # entries, not O(d²)
        d = solver.cones[0].dim
        assert solver._assembly.n_hs < 4 * (d + 2 * 80)
    if name == "lowrank_genpow":
        assert solver._assembly.n_hs <= 62 + 2


def test_update_b_and_q():
    """Warm vector updates in sparse mode: the plan and the built solve
    stay, and the re-solve matches the reference's."""
    name = "update_bq"
    P, q, A, b, cones, st = load_case(name)
    solver = ctt.Solver(P, q, A, b, cones, st, device="cpu")
    check(name, solver, solver.solve(), P, q, A, b)
    plan, fn = solver._structure, solver._solve_fn
    q2, b2 = FIX[f"{name}_updarg_q"], FIX[f"{name}_updarg_b"]
    solver.update_data(q=q2, b=b2)
    assert solver._dev_args is None
    check(f"{name}_upd", solver, solver.solve(), P, q2, A, b2)
    assert solver._structure is plan and solver._solve_fn is fn


def test_update_P_and_A():
    """Matrix updates in sparse mode: a full same-pattern P, an A nzval
    vector in CSC order (the reference's native form), then triplets; and
    the pattern and upper-triangle guards."""
    name = "update_PA"
    P, q, A, b, cones, st = load_case(name)
    solver = ctt.Solver(P, q, A, b, cones, st, device="cpu")
    solver.solve()
    P2 = _coo(f"{name}_updarg_P")
    solver.update_P(P2)
    solver.update_A(FIX[f"{name}_updarg_A_nzval"])
    A2 = sp.csc_matrix(A).copy()
    A2.data = FIX[f"{name}_updarg_A_nzval"]
    check(f"{name}_upd", solver, solver.solve(), P2, q, A2, b)

    solver.update_P(([0, 1], [0, 1], [P2[0, 0] * 3.0, P2[1, 1] * 3.0]))
    P3 = P2.toarray()
    P3[0, 0] *= 3.0
    P3[1, 1] *= 3.0
    fresh = ctt.Solver(sp.csr_matrix(P3), q, A2, b, cones, st, device="cpu")
    np.testing.assert_allclose(solver.solve().x, fresh.solve().x, rtol=0,
                               atol=1e-7)
    with pytest.raises(ValueError, match="pattern"):
        solver.update_A(([0], [solver.n - 1], [1.0]))
    with pytest.raises(ValueError, match="upper triangle"):
        solver.update_P(([1], [0], [1.0]))


def test_sparse_setup_reports_its_plan():
    """linear_solver_info names the backend the plan runs and its padded
    factor size; the setup keeps the analysis and map times."""
    solver = ctt.Solver(*load_case("grid_sparse"), device="cpu")
    info = solver.linear_solver_info()
    plan = solver._structure
    assert info["backend"] == "multifrontal" and info["variant"] == "sparse"
    assert info["factor_nnz"] == sum(
        lv.cnt * (lv.nr * (lv.nr + 1) // 2 + lv.nr * lv.nbd)
        for lv in plan.levels)
    assert solver._setup_split["analysis"] > 0
    assert solver._setup_split["maps"] > 0


@pytest.mark.slow
def test_regenerated_fixture_matches(tmp_path):
    """Live regeneration of one small case equals the committed one."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_sparse_fixtures",
        os.path.join(FIXTURES, "make_sparse_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    case = mod.small_cases()["dense_match"]
    out = mod.reference_outputs("dense_match", case)
    np.testing.assert_array_equal(out["x"], FIX["dense_match_x"])
    assert int(out["iterations"]) == int(FIX["dense_match_iterations"])
