"""The port's modeling edges on the CPU, against the JAX package's:

* `modeling.ProblemBuilder`: for the calls of `tests/test_modeling.py`
  the builder's P, q, A, b and cones equal the reference builder's, and
  the solve matches (status equal, x within 1e-6);
* the cvxpy data path (`interop/cvxpy_interface.py`) on the cases of
  `tests/test_cvxpy_interface.py:27-130`: the same cones, settings, status
  strings and parts, the solves matching the reference's; the live cvxpy
  cases importorskip cvxpy, as there;
* the structural protocols (`protocols.py`), realized as
  `tests/test_misc_classes.py:267` holds the reference's;
* `precompile.warmup(device="cpu")`: the reference `warmup()` statuses
  (`tests/torch_fixtures/long.json`).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import clarabel_tpu as ct
import clarabel_tpu_torch as ctt
from clarabel_tpu.interop import cvxpy_interface as ref_ci
from clarabel_tpu.modeling import ProblemBuilder as RefBuilder
from clarabel_tpu_torch.interop import cone_to_tuple
from clarabel_tpu_torch.interop import cvxpy_interface as ci
from clarabel_tpu_torch.modeling import ProblemBuilder

from torch_fixtures.make_long_fixtures import (BUILDER_CASES,
                                               SOLVED_BUILDER_CASES,
                                               builder_calls, conic_cases)

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = np.load(os.path.join(HERE, "torch_fixtures", "long.npz"))
X_TOL = 1e-6


@pytest.mark.parametrize("name", BUILDER_CASES)
def test_builder_matches_reference(name):
    got, ref = builder_calls(ProblemBuilder, name), \
        builder_calls(RefBuilder, name)
    np.testing.assert_array_equal(got._P, ref._P)
    np.testing.assert_array_equal(got._q, ref._q)
    np.testing.assert_array_equal(np.vstack(got._A_blocks),
                                  np.vstack(ref._A_blocks))
    np.testing.assert_array_equal(np.concatenate(got._b_blocks),
                                  np.concatenate(ref._b_blocks))
    assert [cone_to_tuple(c) for c in got._cones] == \
        [cone_to_tuple(c) for c in ref._cones]
    if name not in SOLVED_BUILDER_CASES:
        return
    sol = got.solve(device="cpu")
    assert sol.status == ctt.SolverStatus.SOLVED
    assert int(sol.status) == int(FIX[f"builder_{name}_status"])
    np.testing.assert_allclose(sol.x, FIX[f"builder_{name}_x"], rtol=0,
                               atol=X_TOL)


def test_builder_validation():
    pb = ProblemBuilder(3)
    with pytest.raises(ValueError):
        pb.add_equality(np.ones((2, 2)), [1.0, 2.0])
    with pytest.raises(ValueError):
        pb.minimize(P=np.eye(2))
    with pytest.raises(ValueError):
        pb.add_psd(np.zeros((4, 3)), np.zeros(4))  # 4 not triangular


def test_builder_solve_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the builder solves on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        builder_calls(ProblemBuilder, "qp_box").solve()


# ---- the cvxpy data path ----

def test_cones_from_dims_matches_reference():
    dims = {"z": 2, "l": 3, "q": [3, 4], "s": [2], "ep": 2, "p3d": [0.3],
            "pnd": [np.array([0.2, 0.8])]}
    got, ref = ci.cones_from_dims(dims), ref_ci.cones_from_dims(dims)
    assert [cone_to_tuple(c) for c in got] == \
        [cone_to_tuple(c) for c in ref]
    assert ci.cones_from_dims({"l": 1})[0].dim == 1


@pytest.mark.parametrize("args", [
    ({"max_iter": 55, "not_a_field": 1}, {"max_iter": 33}, False),
    ({}, {"verbose": True}, False),
    ({}, None, True)])
def test_resolve_settings_matches_reference(args):
    overrides, opts, verbose = args
    for base, rbase in ((None, None),
                        (ctt.Settings(max_iter=77), ct.Settings(max_iter=77))):
        got = ci.resolve_settings(base, overrides, opts, verbose)
        ref = ref_ci.resolve_settings(rbase, overrides, opts, verbose)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_status_strings_match_reference():
    for st in ctt.SolverStatus:
        assert ci.map_status(st) == ref_ci.map_status(ct.SolverStatus(
            int(st)))
    for k in ("OPTIMAL", "OPTIMAL_INACCURATE", "INFEASIBLE", "UNBOUNDED",
              "USER_LIMIT", "SOLVER_ERROR"):
        assert getattr(ci, k) == getattr(ref_ci, k)


def _ref_parts(name, offset):
    """The reference's solution_to_parts on its committed solution."""
    ref = {k: FIX[f"conic_{name}_{k}"] for k in ("status", "iterations",
                                                  "x", "z", "obj_val")}
    status = ref_ci.map_status(ct.SolverStatus(int(ref["status"])))
    if status in (ref_ci.OPTIMAL, ref_ci.OPTIMAL_INACCURATE,
                  ref_ci.USER_LIMIT):
        return status, float(ref["obj_val"]) + offset, ref["x"], ref["z"]
    return status, None, None, None


@pytest.mark.parametrize("name", sorted(conic_cases()))
def test_solve_conic_data_matches_reference(name):
    """Status, iterations within 4, objective, x and z within 1e-6.  On
    socp_zero, an equality-constrained SOCP with P = 0 (the min-norm class
    whose dense ldl steps ROADMAP.md Queue 3 lists), the default backend's
    status is held to SOLVED or ALMOST_SOLVED and its values to the
    reference's; the condensed backend is held to the reference's status
    as well (test_socp_zero_condensed_matches_reference)."""
    A, b, c, P, dims, opts = conic_cases()[name]
    sol = ci.solve_conic_data(A, b, c, P, dims, solver_opts=opts,
                              device="cpu")
    ref_status = int(FIX[f"conic_{name}_status"])
    if name == "socp_zero":
        assert int(sol.status) in (ref_status,
                                   int(ctt.SolverStatus.ALMOST_SOLVED))
    else:
        assert int(sol.status) == ref_status
    assert abs(sol.iterations - int(FIX[f"conic_{name}_iterations"])) <= 4
    parts = ci.solution_to_parts(sol, offset=1.5)
    rparts = _ref_parts(name, 1.5)
    if name != "socp_zero":
        assert parts[0] == rparts[0]
    if rparts[1] is None:
        assert parts[1:4] == (None, None, None)
        assert name == "infeasible"
    else:
        assert abs(parts[1] - rparts[1]) <= X_TOL
        np.testing.assert_allclose(parts[2], rparts[2], rtol=0, atol=X_TOL)
        np.testing.assert_allclose(parts[3], rparts[3], rtol=0, atol=X_TOL)
    assert parts[4]["num_iters"] == sol.iterations
    assert parts[4]["solver_specific_stats"] is sol


def test_socp_zero_condensed_matches_reference():
    A, b, c, P, dims, _ = conic_cases()["socp_zero"]
    sol = ci.solve_conic_data(A, b, c, P, dims,
                              solver_opts={"kkt_backend": "condensed"},
                              device="cpu")
    assert int(sol.status) == int(FIX["conic_socp_zero_status"])
    assert ci.solution_to_parts(sol, 0.0)[0] == ci.OPTIMAL
    np.testing.assert_allclose(sol.x, FIX["conic_socp_zero_x"], rtol=0,
                               atol=X_TOL)


def test_cvxpy_solver_name_and_guard():
    assert ci.ClarabelTPUTorch.name(None) == "CLARABEL_TPU_TORCH"
    if not ci._HAVE_CVXPY:
        with pytest.raises(ImportError, match="cvxpy"):
            ci.ClarabelTPUTorch()


def test_cvxpy_live():
    cp = pytest.importorskip("cvxpy")
    x = cp.Variable(2)
    prob = cp.Problem(cp.Minimize(x[0] + x[1]), [x[0] + 2 * x[1] >= 1,
                                                  x >= 0])
    prob.solve(solver=ci.ClarabelTPUTorch(device="cpu"))
    assert prob.status == cp.OPTIMAL
    assert abs(prob.value - 0.5) < 1e-6


# ---- protocols and warm-up ----

def test_protocols_realized():
    from clarabel_tpu_torch.protocols import (InfoLike, KKTBackend,
                                              SolutionLike, SolverLike)

    s = ctt.Solver(np.eye(2), np.ones(2), -np.eye(2), np.ones(2),
                   [ctt.NonnegativeConeT(2)], device="cpu")
    assert isinstance(s, SolverLike)
    sol = s.solve()
    assert isinstance(sol, SolutionLike)
    assert isinstance(s.get_info(), InfoLike)
    assert isinstance(ctt.BatchSolver([ctt.NonnegativeConeT(2)], 2,
                                      device="cpu"), SolverLike)
    assert isinstance(lambda P, A, state, fdt, signs: None, KKTBackend)


def test_warmup_matches_reference_statuses():
    with open(os.path.join(HERE, "torch_fixtures", "long.json")) as f:
        ref = json.load(f)["warmup"]
    got = ctt.precompile.warmup(device="cpu")
    assert {k: v.name for k, v in got.items()} == ref
    assert list(got) == list(ref)


def test_warmup_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: warmup runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctt.precompile.warmup(families=("lp",))
