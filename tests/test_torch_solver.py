"""The port's single-instance `Solver` (`clarabel_tpu_torch/api.py`), dense
path, on the CPU (`device="cpu"`: the plain versions of the kernels).

* The verify drive of the repository's verification recipe.
* Parity with `clarabel_tpu.Solver` on the committed cases of
  `tests/torch_fixtures/make_solver_fixtures.py` (its live regeneration is
  marked slow): statuses equal, iterations within 4, and on SOLVED cases
  the objective and x within 1e-6 (the tight end of the DEVIATIONS.md #4
  bars, which also allow x the sum of both certificate radii).
* The 64-case conformance battery of `tests/test_conformance.py` through
  the port, checked by `tests/conic_check.check_kkt` at its own bars: the
  problems are built over the reference's cone classes, which the oracle
  reads, and each is mapped to the port's class for the solve.
* Presolve, chordal decomposition, data updates, the JSON files of both
  packages, bad inputs, and what the port leaves out.  The four inputs
  that raised for ROADMAP.md Queue 1 item 11 (sparse and structured KKT)
  now solve, held to the reference's outputs in
  `tests/torch_fixtures/sparse.npz` as `tests/test_torch_sparse_solver.py`
  holds its cases.  The six inputs that raised for item 12 (a finite
  time_limit, timing=True, save_checkpoint, resume_from_checkpoint,
  profile_trace, print_timers) now run on the verify drive, held to the
  reference's solution; `mesh=`, which raised for item 13, now solves
  (a mesh of one rank here, with the unsharded solve's bits; the sharded
  paths are held in tests/test_torch_multidevice.py).
"""

import dataclasses
import importlib.util
import json
import os
import zlib

import numpy as np
import pytest
import torch

import clarabel_tpu as ct
import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.interop import (cone_from_tuple, cone_to_tuple,
                                        solver_from_reference)

from conic_check import check_kkt, dual_margin
from test_chordal import block_arrow_sdp
from test_conformance import CONE_MENU, PAIRS, make_feasible_problem

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
SOLVED = ctt.SolverStatus.SOLVED
FIX = np.load(os.path.join(FIXTURES, "solver.npz"))
CASES = sorted(k[:-len("_cones")] for k in FIX.files if k.endswith("_cones"))


def _port_cones(ref_cones):
    return [cone_from_tuple(cone_to_tuple(c)) for c in ref_cones]


def _case(name):
    P, q, A, b = (FIX[f"{name}_{k}"] for k in "PqAb")
    cones = [cone_from_tuple(tuple(t)) for t in
             json.loads(str(FIX[f"{name}_cones"]))]
    return P, q, A, b, cones


def _verify_problem():
    P = np.array([[4., 1.], [1., 2.]])
    q = np.ones(2)
    A = np.vstack([-np.array([[1., 1.], [1., 0.], [0., 1.]]),
                   np.array([[1., 1.], [1., 0.], [0., 1.]])])
    b = np.concatenate([-np.array([1., 0, 0]), np.array([1., 0.7, 0.7])])
    return P, q, A, b, [ctt.NonnegativeConeT(3), ctt.NonnegativeConeT(3)]


def test_verify_drive(capsys):
    """The verification recipe: SOLVED, x = [0.3, 0.7], objective 1.88,
    residuals below 1e-8; with verbose=True the banner, the iteration rows
    and the footer."""
    P, q, A, b, cones = _verify_problem()
    solver = ctt.Solver(P, q, A, b, cones, device="cpu")
    sol = solver.solve()
    assert sol.status == SOLVED
    np.testing.assert_allclose(sol.x, [0.3, 0.7], atol=1e-8)
    assert abs(sol.obj_val - 1.88) < 1e-8
    assert sol.r_prim < 1e-8 and sol.r_dual < 1e-8
    assert solver.get_solution() is sol
    assert solver.get_info().status == SOLVED
    assert solver.get_info().iterations == sol.iterations
    assert "Status: solved" in repr(sol)
    ctt.Solver(P, q, A, b, cones, ctt.Settings(verbose=True),
               device="cpu").solve()
    out = capsys.readouterr().out
    assert "clarabel_tpu_torch" in out and "iter    pcost" in out
    assert "terminated with status: solved" in out
    assert len([r for r in out.splitlines() if r.startswith("   ")]) \
        >= sol.iterations


def _assert_reference_parity(name, sol):
    ref = {k: FIX[f"{name}_{k}"] for k in
           ("x", "z", "s", "status", "iterations", "obj_val",
            "obj_val_dual")}
    assert int(sol.status) == int(ref["status"])
    assert abs(sol.iterations - int(ref["iterations"])) <= 4
    if sol.status == SOLVED:
        assert abs(sol.obj_val - float(ref["obj_val"])) < 1e-6
        np.testing.assert_allclose(sol.x, ref["x"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_matches_the_reference_solver(name):
    P, q, A, b, cones = _case(name)
    solver = ctt.Solver(P, q, A, b, cones, device="cpu")
    sol = solver.solve()
    _assert_reference_parity(name, sol)
    assert (solver.presolver is not None) == bool(FIX[f"{name}_presolved"])
    assert (solver.chordal_info is not None) == bool(FIX[f"{name}_chordal"])
    if name == "presolve":
        # the infinite bound's row comes back as s = 1e20, z = 0
        assert solver.presolver.m_reduced == len(b) - 1
        assert sol.s[4] == 1e20 and sol.z[4] == 0.0
        assert not solver.is_data_update_allowed()
        with pytest.raises(ValueError, match="presolver"):
            solver.update_q(q)
    if name == "chordal":
        assert sol.x.shape == (8,) and sol.z.shape == (28,)


@pytest.mark.slow
def test_solver_fixtures_regenerate():
    spec = importlib.util.spec_from_file_location(
        "make_solver_fixtures",
        os.path.join(FIXTURES, "make_solver_fixtures.py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    ref = maker.reference_outputs()
    for name in CASES:
        for k in ("status", "iterations"):
            np.testing.assert_array_equal(ref[name][k], FIX[f"{name}_{k}"])
        np.testing.assert_allclose(ref[name]["x"], FIX[f"{name}_x"],
                                   rtol=0, atol=1e-12)


# ---- the conformance battery of tests/test_conformance.py ----

def _battery():
    """(id, kind, arg): every cone pair x objective type, the primal
    infeasibility certificate per family, the dual one and the mix."""
    cases = [(f"{'+'.join(p)}-{'qp' if quad else 'lp'}", "pair", (p, quad))
             for p in PAIRS for quad in (False, True)]
    cases += [(f"primal-infeasible-{fam}", "primal", fam)
              for fam in sorted(set(CONE_MENU) - {"zero"})]
    cases += [("dual-infeasible", "dual", None), ("mix", "mix", None)]
    return cases


BATTERY = _battery()


@pytest.mark.parametrize("kind,arg", [c[1:] for c in BATTERY],
                         ids=[c[0] for c in BATTERY])
def test_conformance_battery(kind, arg):
    if kind == "pair":
        pair, quad = arg
        # a seed that does not depend on the interpreter's string hashing
        rng = np.random.default_rng(zlib.crc32("+".join(pair).encode())
                                    + quad)
        cones = [CONE_MENU[pair[0]](), CONE_MENU[pair[1]]()]
        P, q, A, b = make_feasible_problem(cones, rng, quad)
        sol = ctt.Solver(P, q, A, b, _port_cones(cones), device="cpu").solve()
        assert sol.status in (SOLVED, ctt.SolverStatus.ALMOST_SOLVED), \
            f"{pair}: {sol.status}"
        tol = 1e-6 if sol.status == SOLVED else 1e-3
        check_kkt(P, q, A, b, cones, sol, tol=tol)
    elif kind == "primal":
        rng = np.random.default_rng(42)
        cones = [CONE_MENU[arg]()]
        P, q, A, b = make_feasible_problem(cones, rng, quad=False)
        a = rng.standard_normal(A.shape[1])
        A2 = np.vstack([A, a, -a])
        b2 = np.concatenate([b, [0.0], [-1.0]])
        cones2 = cones + [ct.NonnegativeConeT(2)]
        sol = ctt.Solver(P, q, A2, b2, _port_cones(cones2),
                         device="cpu").solve()
        assert sol.status in (ctt.SolverStatus.PRIMAL_INFEASIBLE,
                              ctt.SolverStatus.ALMOST_PRIMAL_INFEASIBLE)
        zn = sol.z / max(np.linalg.norm(sol.z), 1e-300)
        assert np.linalg.norm(A2.T @ zn) < 1e-5
        assert float(b2 @ zn) < 0
        ofs = 0
        for cone in cones2:
            d = ct.cones.api.nvars(cone)
            assert dual_margin(cone, zn[ofs:ofs + d]) > -1e-6
            ofs += d
    elif kind == "dual":
        n = 3
        P, q = np.zeros((n, n)), np.array([-1.0, 0.0, 0.0])
        A, b = -np.eye(n), np.zeros(n)
        sol = ctt.Solver(P, q, A, b, [ctt.NonnegativeConeT(n)],
                         device="cpu").solve()
        assert sol.status in (ctt.SolverStatus.DUAL_INFEASIBLE,
                              ctt.SolverStatus.ALMOST_DUAL_INFEASIBLE)
        xn = sol.x / max(np.linalg.norm(sol.x), 1e-300)
        assert float(q @ xn) < 0
        assert np.min(-(A @ xn)) > -1e-8
    else:
        rng = np.random.default_rng(0)
        cones = [ct.ZeroConeT(2), ct.NonnegativeConeT(3),
                 ct.SecondOrderConeT(3), ct.ExponentialConeT()]
        P, q, A, b = make_feasible_problem(cones, rng, quad=True)
        sol = ctt.Solver(P, q, A, b, _port_cones(cones), device="cpu").solve()
        assert sol.status == SOLVED
        check_kkt(P, q, A, b, cones, sol, tol=1e-6)


def test_battery_has_64_cases():
    assert len(BATTERY) == 64


# ---- chordal decomposition, data updates, files, inputs ----

def test_chordal_decomposition_matches_the_undecomposed_solve():
    """tests/test_chordal.py's block-arrow SDP: the decomposed solve gives
    the undecomposed one's objective and x, and a PSD completed dual."""
    P, q, A, b, ref_cones = block_arrow_sdp(w=2)
    cones = _port_cones(ref_cones)
    off = ctt.Solver(P, q, A, b, cones,
                     ctt.Settings(chordal_decomposition_enable=False),
                     device="cpu").solve()
    solver = ctt.Solver(P, q, A, b, cones, ctt.Settings(
        chordal_decomposition_complete_dual=True), device="cpu")
    assert solver.chordal_info is not None
    on = solver.solve()
    assert off.status == SOLVED and on.status == SOLVED
    assert abs(on.obj_val - off.obj_val) < 1e-6
    assert np.linalg.norm(on.x - off.x) < 1e-5
    from clarabel_tpu_torch.chordal.decomp import _svec_to_mat_np

    Z = _svec_to_mat_np(on.z[6:], 8)
    assert np.linalg.eigvalsh(Z).min() > -1e-7


def test_update_then_resolve():
    """update_* drops the device copy; a warm re-solve after an update
    gives a fresh Solver's bits on the new data.  In-place changes to the
    caller's arrays after setup change nothing (DEVIATIONS.md #17)."""
    P, q, A, b, cones = _verify_problem()
    q_user = q.copy()
    solver = ctt.Solver(P, q_user, A, b, cones, device="cpu")
    first = solver.solve()
    assert solver._dev_args is not None
    q_user[:] = [5.0, -3.0]            # the caller's array, in place
    again = solver.solve()
    np.testing.assert_array_equal(again.x, first.x)
    assert solver.is_data_update_allowed()

    P2 = np.array([[3., 0.5], [0.5, 2.5]])
    q2, b2 = np.array([0.5, -1.0]), b.copy()
    b2[4] = 0.8
    A2 = A.copy()
    A2[0] = [-1.0, -2.0]
    solver.update_data(P=P2, q=q2, A=A2, b=b2)
    assert solver._dev_args is None
    warm = solver.solve()
    fresh = ctt.Solver(P2, q2, A2, b2, cones, device="cpu").solve()
    assert warm.status == SOLVED
    np.testing.assert_array_equal(warm.x, fresh.x)
    # triplet and index forms
    solver.update_P(([0], [1], [0.2]))
    solver.update_q(([1], [2.0]))
    solver.update_b(([0], [-1.5]))
    solver.update_A(([3], [1], [0.5]))
    P3 = P2.copy()
    P3[0, 1] = P3[1, 0] = 0.2
    q3 = q2.copy()
    q3[1] = 2.0
    b3 = b2.copy()
    b3[0] = -1.5
    A3 = A2.copy()
    A3[3, 1] = 0.5
    np.testing.assert_array_equal(
        solver.solve().x,
        ctt.Solver(P3, q3, A3, b3, cones, device="cpu").solve().x)
    with pytest.raises(ValueError, match="upper triangle"):
        solver.update_P(([1], [0], [1.0]))
    with pytest.raises(ValueError, match="dimension"):
        solver.update_A(np.ones((2, 2)))
    with pytest.raises(ValueError, match="length"):
        solver.update_q(np.ones(3))


def test_json_files_load_in_both_packages(tmp_path):
    """A file written by the reference loads in the port, and one written
    by the port loads in the reference, with the same problem data."""
    P, q, A, b, cones = _case("soc")
    port = ctt.load_from_file(os.path.join(FIXTURES, "solver_ref.json"),
                              device="cpu")
    np.testing.assert_array_equal(port._P_full, P)
    np.testing.assert_array_equal(port._A, A)
    np.testing.assert_array_equal(port._q, q)
    np.testing.assert_array_equal(port._b, b)
    assert [cone_to_tuple(c) for c in port.cones] == \
        [cone_to_tuple(c) for c in cones]
    _assert_reference_parity("soc", port.solve())

    path = str(tmp_path / "port.json")
    st = ctt.Settings(max_iter=77, tol_gap_abs=1e-7)
    ctt.save_to_file(ctt.Solver(P, q, A, b, cones, st, device="cpu"), path)
    ref = ct.load_from_file(path)
    np.testing.assert_array_equal(ref._P_full, P)
    np.testing.assert_array_equal(ref._A, A)
    np.testing.assert_array_equal(ref._q, q)
    np.testing.assert_array_equal(ref._b, b)
    assert [cone_to_tuple(c) for c in ref.cones] == \
        [cone_to_tuple(c) for c in cones]
    assert ref.settings.max_iter == 77 and ref.settings.tol_gap_abs == 1e-7
    # every setting as written, but the two unset flags the reference's
    # reader turns into inf, as it does with its own files
    got, want = dataclasses.asdict(ref.settings), dataclasses.asdict(st)
    assert {k for k in want if got[k] != want[k]} == {
        "dense_solve_via_inverse", "dense_ldl_diag_order"}
    assert np.isinf(got["dense_ldl_diag_order"])
    # the port's reader keeps them unset
    assert ctt.load_from_file(path, device="cpu").settings == st
    # the backend report matches the reference's on the same problem
    assert ref.linear_solver_info() == ctt.Solver(
        P, q, A, b, cones, st, device="cpu").linear_solver_info()


@pytest.mark.parametrize("name", ["soc", "zero"])
def test_carry_over_from_a_reference_solver(name):
    """`interop.solver_from_reference`: a set-up reference Solver's problem
    and settings, carried into the port, solve as the reference did."""
    P, q, A, b, cones = _case(name)
    ref = ct.Solver(P, q, A, b,
                    [getattr(ct, type(c).__name__)(*cone_to_tuple(c)[1:])
                     for c in cones], ct.Settings(max_iter=60))
    port = solver_from_reference(ref, device="cpu")
    assert port.settings == ctt.Settings(max_iter=60)
    for k in ("_P_full", "_q", "_A", "_b"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    _assert_reference_parity(name, port.solve())


@pytest.mark.parametrize("bad", ["A rows", "P shape", "cone total"])
def test_bad_inputs_raise(bad):
    P, q, A, b, cones = _verify_problem()
    if bad == "A rows":
        A = A[:-1]
    elif bad == "P shape":
        P = np.eye(3)
    else:
        cones = [ctt.NonnegativeConeT(3), ctt.NonnegativeConeT(2)]
    with pytest.raises(ValueError):
        ctt.Solver(P, q, A, b, cones, device="cpu")


def _mesh_solves():
    """The item-13 input: a mesh that is not a DeviceMesh raises
    TypeError, a problem without block-arrow structure raises the
    reference's ValueError, and the dryrun's chain QP on a mesh of one
    rank gives the unsharded block-arrow solve's bits."""
    from clarabel_tpu_torch.entry import chain_qp
    from test_torch_multidevice import world_of_one

    P, q, A, b, cones = _verify_problem()
    with pytest.raises(TypeError, match="DeviceMesh"):
        ctt.Solver(P, q, A, b, cones, mesh=object(), device="cpu")
    problem = chain_qp(8)
    ref = ctt.Solver(*problem, ctt.Settings(kkt_backend="blockarrow"),
                     device="cpu").solve()
    with world_of_one("gloo", "cpu", ("tp",)) as mesh:
        with pytest.raises(ValueError, match="block-arrow"):
            ctt.Solver(P, q, A, b, cones, mesh=mesh, device="cpu")
        solver = ctt.Solver(*problem, mesh=mesh, device="cpu")
        got = solver.solve()
    assert solver._backend == "blockarrow"
    assert got.status == ref.status == ctt.SolverStatus.SOLVED
    assert got.iterations == ref.iterations
    np.testing.assert_array_equal(got.x, ref.x)


def _long_solve(case, tmp_path):
    """Run one item-12 input on the verify drive; returns (the solution,
    what the call printed or wrote, for the case's own check)."""
    P, q, A, b, cones = _verify_problem()
    if case == "time_limit":
        return ctt.Solver(P, q, A, b, cones, ctt.Settings(time_limit=1.0),
                          device="cpu").solve(), None
    if case == "timing":
        return ctt.Solver(P, q, A, b, cones, timing=True,
                          device="cpu").solve(), None
    solver = ctt.Solver(P, q, A, b, cones, ctt.Settings(time_limit=600.0),
                        device="cpu")
    sol = solver.solve()
    if case == "save_checkpoint":
        path = str(tmp_path / "state.npz")
        solver.save_checkpoint(path)
        return sol, path
    if case == "resume_from_checkpoint":
        fn = solver._solve_fn
        data, carry = fn.prepare(*solver._device_args())
        solver._last_carry = fn.run_phases(data, carry, 3)
        path = str(tmp_path / "state.npz")
        solver.save_checkpoint(path)
        return solver.resume_from_checkpoint(path), None
    if case == "profile_trace":
        with solver.profile_trace(str(tmp_path)):
            sol = solver.solve()
        return sol, solver.last_trace
    solver.print_timers()
    return sol, None


# the input that raised for item 13 until the port took multi-device
ONCE_LEFT_OUT_13 = ("mesh",)
# the inputs that raised for item 11 until the port took the sparse and
# structured KKT: each now solves (the `left_out_*` cases of sparse.npz:
# sparse_data=True on the verify drive, scipy-sparse data with
# n + m > 2000, an SOC of dimension 40 over rows at most 10 % filled, and
# kkt_backend="auto" above n + m = 1024)
ONCE_LEFT_OUT = ("sparse_data", "sparse_big", "big_soc_sparse_rows",
                 "auto_above_1024")
# the inputs that raised for item 12 until the port took the long solves:
# each now runs on the verify drive and matches the reference's solution
ONCE_LEFT_OUT_12 = ("time_limit", "timing", "save_checkpoint",
                    "resume_from_checkpoint", "profile_trace",
                    "print_timers")


@pytest.mark.parametrize("case", sorted(set(ONCE_LEFT_OUT_13)
                                        | set(ONCE_LEFT_OUT)
                                        | set(ONCE_LEFT_OUT_12)))
def test_left_out_inputs_raise(case, tmp_path, capsys):
    """The inputs the port once left out (each raised NotImplementedError
    naming its ROADMAP.md item) now run: the item-11 inputs solve as the
    reference does, and so do the item-12 inputs (time limits, timing,
    checkpoints, profiles, the timer tree); `mesh=` (item 13) solves on a
    mesh and refuses what is not one."""
    if case in ONCE_LEFT_OUT:
        from test_torch_sparse_solver import solve_case

        solve_case(f"left_out_{case}")
        return
    if case in ONCE_LEFT_OUT_12:
        sol, made = _long_solve(case, tmp_path)
        _assert_reference_parity("verify", sol)
        if case in ("save_checkpoint", "profile_trace"):
            assert os.path.getsize(made) > 0
        if case == "print_timers":
            assert "device: cpu" in capsys.readouterr().out
        return
    _mesh_solves()


def test_solver_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the Solver runs on it")
    P, q, A, b, cones = _verify_problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctt.Solver(P, q, A, b, cones)
