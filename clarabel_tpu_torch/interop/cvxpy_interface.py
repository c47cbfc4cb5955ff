"""CVXPY solver interface for clarabel_tpu_torch.

The port's copy of the JAX package's `interop/cvxpy_interface.py`: the
same data path over the port's `Solver`, with `device=` (the card when
None), and a solver registered under its own name, CLARABEL_TPU_TORCH, so
that both packages can register with cvxpy (DEVIATIONS.md #19).

The Python-ecosystem analogue of the reference's MOI wrapper (reference:
src/MOI_wrapper/MOI_wrapper.jl) — it adapts a modeling tool's conic
standard form onto the native `Solver` API.  CVXPY's conic form

    min  cᵀx   s.t.  Ax + s = b,  s ∈ K

is already this solver's geometry (the reference flips constraint signs
the same way, MOI_wrapper.jl:625-673), so `apply` is a direct cone-order
mapping and `invert` a status/value repack.

The DATA PATH is factored into pure functions that do not import cvxpy —
`cones_from_dims`, `resolve_settings`, `solve_conic_data`, `map_status`,
`solution_to_parts` — so the reduction and recovery logic is
unit-testable in environments without cvxpy (tests/test_torch_modeling.py
runs them against the JAX package's; the live end-to-end tests
importorskip cvxpy).  Status strings mirror cvxpy.settings' constants,
which are plain strings by definition.

Usage (requires cvxpy ≥ 1.3, optional dependency):

    import cvxpy as cp
    from clarabel_tpu_torch.interop.cvxpy_interface import ClarabelTPUTorch
    prob.solve(solver=ClarabelTPUTorch())              # on the card
    prob.solve(solver=ClarabelTPUTorch(device="cpu"))

Cones supported: zero, nonnegative, SOC, PSD (scaled triangle — CVXPY's
svec convention matches the reference's √2 off-diagonal scaling),
exponential, 3-d power, and n-d power (PowConeND → generalized power
cone, mirroring the reference's MOI GenPowerCone extension).
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:  # pragma: no cover - exercised only when cvxpy is installed
    import cvxpy.settings as cvx_s
    from cvxpy.constraints import (
        ExpCone, NonNeg, PowCone3D, PSD, SOC, Zero,
    )
    try:
        from cvxpy.constraints import PowConeND
    except ImportError:  # older cvxpy
        PowConeND = None
    from cvxpy.reductions.solution import Solution, failure_solution
    from cvxpy.reductions.solvers.conic_solvers.conic_solver import (
        ConicSolver, dims_to_solver_dict,
    )

    _HAVE_CVXPY = True
except ImportError:  # pragma: no cover
    _HAVE_CVXPY = False

    class ConicSolver:  # type: ignore[no-redef]
        """Import-time stand-in so this module can be imported (and the
        class introspected) without cvxpy installed."""

        def __init_subclass__(cls, **kw):
            super().__init_subclass__(**kw)


# cvxpy.settings status-string constants (they ARE these strings; pinned
# here so the pure data path works without cvxpy, and asserted against
# the real module when it is importable)
OPTIMAL = "optimal"
OPTIMAL_INACCURATE = "optimal_inaccurate"
INFEASIBLE = "infeasible"
INFEASIBLE_INACCURATE = "infeasible_inaccurate"
UNBOUNDED = "unbounded"
UNBOUNDED_INACCURATE = "unbounded_inaccurate"
USER_LIMIT = "user_limit"
SOLVER_ERROR = "solver_error"

if _HAVE_CVXPY:  # keep the pinned strings honest
    assert OPTIMAL == cvx_s.OPTIMAL and USER_LIMIT == cvx_s.USER_LIMIT


def map_status(status) -> str:
    """SolverStatus -> cvxpy status string (MOI_wrapper.jl:48-85 role)."""
    from ..statuscodes import SolverStatus

    return {
        SolverStatus.SOLVED: OPTIMAL,
        SolverStatus.ALMOST_SOLVED: OPTIMAL_INACCURATE,
        SolverStatus.PRIMAL_INFEASIBLE: INFEASIBLE,
        SolverStatus.ALMOST_PRIMAL_INFEASIBLE: INFEASIBLE_INACCURATE,
        SolverStatus.DUAL_INFEASIBLE: UNBOUNDED,
        SolverStatus.ALMOST_DUAL_INFEASIBLE: UNBOUNDED_INACCURATE,
        SolverStatus.MAX_ITERATIONS: USER_LIMIT,
        SolverStatus.MAX_TIME: USER_LIMIT,
    }.get(status, SOLVER_ERROR)


def cones_from_dims(cone_dims: dict):
    """cvxpy solver-dims dict -> native cone list, in cvxpy's standard
    conic order (zero, nonneg, soc, psd, exp, pow3d, pownd).

    `cone_dims` uses cvxpy's `dims_to_solver_dict` keys: "z" (int),
    "l" (int), "q" (list of SOC dims), "s" (list of PSD side lengths),
    "ep" (int, # of exp cones), "p3d" (list of power-cone alphas),
    "pnd" (list of alpha vectors)."""
    from ..cones import api as ct

    cones = []
    if cone_dims.get("z"):
        cones.append(ct.ZeroConeT(cone_dims["z"]))
    if cone_dims.get("l"):
        cones.append(ct.NonnegativeConeT(cone_dims["l"]))
    for dim in cone_dims.get("q", []):
        cones.append(ct.SecondOrderConeT(dim))
    for dim in cone_dims.get("s", []):
        cones.append(ct.PSDTriangleConeT(dim))
    for _ in range(cone_dims.get("ep", 0)):
        cones.append(ct.ExponentialConeT())
    for alpha in cone_dims.get("p3d", []):
        cones.append(ct.PowerConeT(alpha))
    # n-dimensional power cones (cvxpy PowConeND -> generalized power
    # cone; the reference ships the analogous MOI extension,
    # reference: src/MOI_wrapper/MOI_extensions.jl:12-26)
    for alpha in cone_dims.get("pnd", []):
        alpha = np.asarray(alpha, dtype=np.float64).ravel()
        cones.append(ct.GenPowerConeT(alpha, 1))
    return cones


def resolve_settings(base, overrides: dict, solver_opts, verbose: bool):
    """Merge Settings overrides: constructor kwargs < solve-time
    solver_opts < explicit verbose flag; unknown keys are dropped (the
    reference's RawOptimizerAttribute passthrough role,
    MOI_wrapper.jl:240-266)."""
    from ..settings import Settings

    settings = base if base is not None else Settings()
    opts = dict(overrides)
    opts.update(solver_opts or {})
    opts.setdefault("verbose", bool(verbose))
    valid = {f.name for f in dataclasses.fields(Settings)}
    opts = {k: v for k, v in opts.items() if k in valid}
    return dataclasses.replace(settings, **opts)


def solve_conic_data(A, b, c, P, cone_dims, settings=None,
                     overrides=None, solver_opts=None, verbose=False,
                     device=None):
    """Solve cvxpy-standard conic data (min cᵀx s.t. Ax + s = b, s ∈ K)
    through the native Solver on `device` (the card when None).  Pure data
    path — no cvxpy objects."""
    from ..api import Solver

    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    cones = cones_from_dims(cone_dims)
    settings = resolve_settings(settings, overrides or {}, solver_opts,
                                verbose)
    solver = Solver(
        P if P is not None else np.zeros((n, n)),
        c, A, np.asarray(b, dtype=np.float64), cones, settings,
        device=device,
    )
    return solver.solve()


def solution_to_parts(solution, offset: float):
    """Native solution -> (status_str, opt_val, x, z, attr) with the
    objective offset applied; (status, None, None, None, attr) for
    non-value statuses.  The dual sign convention matches cvxpy's
    conic standard form directly (both use Ax + s = b with s ∈ K, so z
    needs no flip — same as the reference's MOI getters,
    MOI_wrapper.jl:197-296)."""
    status = map_status(solution.status)
    attr = {
        "solve_time": solution.solve_time,
        "num_iters": solution.iterations,
        "solver_specific_stats": solution,
    }
    if status in (OPTIMAL, OPTIMAL_INACCURATE, USER_LIMIT):
        opt_val = solution.obj_val + offset
        return (status, opt_val, np.asarray(solution.x),
                np.asarray(solution.z), attr)
    return status, None, None, None, attr


class ClarabelTPUTorch(ConicSolver):
    """CVXPY conic solver backed by clarabel_tpu_torch.

    Pass an *instance* to `problem.solve(solver=ClarabelTPUTorch())`
    (CVXPY's custom-solver mechanism), optionally with Settings overrides:
    `ClarabelTPUTorch(settings=Settings(max_iter=50))` or keyword overrides
    forwarded to Settings, and `device="cpu"` to solve on the CPU.
    """

    MIP_CAPABLE = False
    REQUIRES_CONSTR = True

    if _HAVE_CVXPY:
        SUPPORTED_CONSTRAINTS = [Zero, NonNeg, SOC, PSD, ExpCone,
                                 PowCone3D]
        if PowConeND is not None:
            SUPPORTED_CONSTRAINTS.append(PowConeND)

    def __init__(self, settings=None, device=None, **kwargs):
        if not _HAVE_CVXPY:
            raise ImportError(
                "cvxpy is not installed; the ClarabelTPUTorch CVXPY "
                "interface requires it (pip install cvxpy)"
            )
        self._settings = settings
        self._device = device
        self._overrides = kwargs

    # -- cvxpy Solver protocol -------------------------------------------
    def name(self):
        return "CLARABEL_TPU_TORCH"

    def import_solver(self):
        import clarabel_tpu_torch  # noqa: F401

    def supports_quad_obj(self) -> bool:
        # native quadratic objectives — no epigraph reformulation needed
        # (the reference advertises the same through MOI, README.md:50-57)
        return True

    def apply(self, problem):
        return super().apply(problem)

    def solve_via_data(self, data, warm_start, verbose, solver_opts,
                       solver_cache=None):
        return solve_conic_data(
            data[cvx_s.A], data[cvx_s.B], data[cvx_s.C],
            data.get(cvx_s.P, None),
            dims_to_solver_dict(data["dims"]),
            settings=self._settings, overrides=self._overrides,
            solver_opts=solver_opts, verbose=verbose, device=self._device,
        )

    def invert(self, solution, inverse_data):
        status, opt_val, x, z, attr = solution_to_parts(
            solution, inverse_data[cvx_s.OFFSET])
        attr = {
            cvx_s.SOLVE_TIME: attr["solve_time"],
            cvx_s.NUM_ITERS: attr["num_iters"],
            cvx_s.EXTRA_STATS: attr["solver_specific_stats"],
        }
        if opt_val is not None:
            primal_vars = {inverse_data[self.VAR_ID]: x}
            dual_vars = {inverse_data[self.DUAL_VAR_ID]: z}
            return Solution(status, opt_val, primal_vars, dual_vars, attr)
        return failure_solution(status, attr)
