"""The single-instance `Solver`, dense path.

A port of `clarabel_tpu/api.py` (`Solver` l.105, `setup` l.307-540, `solve`
l.543-584, `_package_solution` l.586-628, the getters and
`linear_solver_info` l.725):

    solver = Solver(P, q, A, b, cones, settings)        # on the card
    solver = Solver(P, q, A, b, cones, settings, device="cpu")
    solution = solver.solve()

solves  min ½x'Px + q'x  s.t. Ax + s = b, s ∈ K  for one problem.  Setup
runs the reference's host-side steps: the dimension checks, cone
collapsing, the cap of b at +infinity, the presolver (`presolver.py`) and
the chordal decomposition of sparse PSD cones (`chordal/`), then picks the
`ldl` or `condensed` backend as the reference does.  Solve runs the port's
batched loop solver (`ipm/loop.build_solve`) at B = 1 on the solver's
device: on a card its float32 factors go through K2; on the CPU the plain
versions run.  The problem stays on the device between warm solves; a
data update (`update_*`) drops that copy.

What this slice leaves out raises `NotImplementedError` naming the
ROADMAP.md item that brings it: `mesh=` (item 13), every input the
reference would set up in sparse mode (item 11), time limits, timing,
checkpoints, profiles and the timer tree (item 12).  None of them takes
the dense path in their place (DEVIATIONS.md #17).
"""

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import presolver as presolve_mod
from .cones.api import (GenPowerConeT, SecondOrderConeT, SupportedCone,
                        cones_collapse, nvars)
from .cones.layout import ConeLayout
from .ipm.loop import build_solve
from .parallel.batch_impl import resolve_device
from .settings import Settings
from .statuscodes import SolverStatus, status_string

# the reference's dimension from which SOC and genpow cones take the
# low-rank sparse path (clarabel_tpu/cones/ops.py:325)
SOC_RANK2_MIN_DIM = 33

# the outputs of the loop solver that the solution and info carry, in the
# order of the one fetch from the device
_VECTORS = ("x", "z", "s")
_SCALARS = ("status", "iterations", "obj_val", "obj_val_dual", "r_prim",
            "r_dual", "gap_abs", "gap_rel", "mu", "sigma", "step_length",
            "ktratio")


@dataclasses.dataclass
class DefaultSolution:
    """reference: src/types.jl:279-311"""
    x: np.ndarray
    z: np.ndarray
    s: np.ndarray
    status: SolverStatus
    obj_val: float
    obj_val_dual: float
    solve_time: float
    iterations: int
    r_prim: float
    r_dual: float

    def __repr__(self):
        return (
            f">>> clarabel_tpu_torch - Results\n"
            f"Status: {status_string(self.status)}\n"
            f"Iterations: {self.iterations}\nObjective: {self.obj_val:#.4g}\n"
            f"Solve time: {self.solve_time:.3e}s"
        )


@dataclasses.dataclass
class DefaultInfo:
    """Scalar iteration metrics (reference: src/types.jl:198-251)."""
    mu: float = np.nan
    sigma: float = np.nan
    step_length: float = np.nan
    iterations: int = 0
    cost_primal: float = np.nan
    cost_dual: float = np.nan
    res_primal: float = np.nan
    res_dual: float = np.nan
    gap_abs: float = np.nan
    gap_rel: float = np.nan
    ktratio: float = np.nan
    solve_time: float = 0.0
    status: SolverStatus = SolverStatus.UNSOLVED


def _issparse(M) -> bool:
    """A scipy.sparse matrix, by its interface (the port does not import
    scipy here)."""
    return hasattr(M, "toarray") and hasattr(M, "nnz")


def _to_dense(M) -> np.ndarray:
    if _issparse(M):
        return np.asarray(M.toarray())
    return np.asarray(M)


def _symmetrize_triu(P: np.ndarray) -> np.ndarray:
    """The API consumes only the upper-triangular part of P (as the
    reference, src/solver.jl:48) and works with the full symmetric matrix
    internally."""
    U = np.triu(P)
    return U + U.T - np.diag(np.diag(U))


def _not_in_slice(what: str, item: str):
    return NotImplementedError(
        f"{what}: ROADMAP.md Queue 1 item {item} (not ported yet)")


# built solve functions keyed by problem structure, a bounded LRU as the
# reference's (api.py:79-102)
_SOLVE_CACHE: "dict" = {}
_SOLVE_CACHE_MAX = 64


def _solve_cache_put(key, value):
    if key in _SOLVE_CACHE:
        _SOLVE_CACHE.pop(key)
    elif len(_SOLVE_CACHE) >= _SOLVE_CACHE_MAX:
        _SOLVE_CACHE.pop(next(iter(_SOLVE_CACHE)))
    _SOLVE_CACHE[key] = value


def _solve_cache_get(key):
    value = _SOLVE_CACHE.get(key)
    if value is not None:  # refresh LRU order
        _SOLVE_CACHE.pop(key)
        _SOLVE_CACHE[key] = value
    return value


class Solver:
    """Conic interior-point solver for one problem.

        solver = Solver(P, q, A, b, cones, settings, device=None)
        solution = solver.solve()

    `device`: the card when None (with no card, pass "cpu")."""

    def __init__(self, P=None, q=None, A=None, b=None,
                 cones: Optional[Sequence[SupportedCone]] = None,
                 settings: Optional[Settings] = None, mesh=None,
                 device=None, **kwargs):
        self.settings = settings if settings is not None else Settings()
        if kwargs:
            self.settings = dataclasses.replace(self.settings, **kwargs)
        if mesh is not None:
            raise _not_in_slice("Solver(mesh=...), the sharded "
                                "factorization", "13 (multi-device)")
        self.device = resolve_device(device)
        self.solution: Optional[DefaultSolution] = None
        self.info = DefaultInfo()
        self.presolver = None
        self.chordal_info = None
        self._setup_done = False
        self._first_solve_time = None
        self._dev_args = None
        if P is not None:
            self.setup(P, q, A, b, cones)

    # ------------------------------------------------------------------
    def _slice_check(self):
        st = self.settings
        if math.isfinite(st.time_limit):
            raise _not_in_slice("a finite time_limit", "12 (long solves)")
        if st.timing:
            raise _not_in_slice("Settings(timing=True)", "12 (long solves)")

    def _want_sparse(self, q, A, b, cones) -> bool:
        """The reference's rule for its sparse setup (api.py:317-347)."""
        want_sparse = self.settings.sparse_data
        if want_sparse is None:
            has_big_lowrank = cones is not None and any(
                isinstance(c, (SecondOrderConeT, GenPowerConeT))
                and nvars(c) >= SOC_RANK2_MIN_DIM for c in cones)
            if has_big_lowrank and not _issparse(A):
                Ad = np.asarray(A)
                has_big_lowrank = np.count_nonzero(Ad) <= 0.10 * Ad.size
            want_sparse = has_big_lowrank or (
                _issparse(A) and q.shape[0] + b.shape[0] > 2000)
        return bool(want_sparse)

    def setup(self, P, q, A, b, cones: Sequence[SupportedCone]):
        """reference: src/solver.jl:89-153"""
        t0 = time.perf_counter()
        from . import get_infinity

        self._slice_check()
        # copies: the solver's problem is fixed at setup, whatever the
        # caller later does to its arrays (DEVIATIONS.md #17)
        q = np.array(q, dtype=np.float64).ravel()
        b = np.array(b, dtype=np.float64).ravel()
        if self._want_sparse(q, A, b, cones):
            raise _not_in_slice("sparse setup (scipy-sparse data with "
                                "n + m > 2000, large SOC or genpow cones "
                                "over sparse rows, or sparse_data=True)",
                                "11 (sparse and structured KKT)")

        P = _to_dense(P).astype(np.float64)
        A = _to_dense(A).astype(np.float64)

        # dimension checks (reference: src/solver.jl:157-169)
        n, m = q.shape[0], b.shape[0]
        if A.shape != (m, n):
            raise ValueError("A and b or q have incompatible dimensions")
        if P.shape != (n, n):
            raise ValueError("P is not n-by-n")
        if sum(nvars(c) for c in cones) != m:
            raise ValueError(
                "Constraint dimensions inconsistent with size of cones")

        # cone collapsing (reference: cone_api.jl:96-153)
        cones = cones_collapse(list(cones))
        # cap b at +infinity (reference: src/problemdata.jl b=min(b,INF))
        infinity = get_infinity()
        b = np.minimum(b, infinity)

        # presolve (reference: src/presolver.jl)
        self.presolver = None
        if self.settings.presolve_enable:
            pres = presolve_mod.try_presolve(A, b, cones, infinity)
            if pres is not None:
                self.presolver = pres
                A, b = presolve_mod.presolve_reduce(pres, A, b)
                cones = pres.reduced_cones
                m = b.shape[0]

        # chordal decomposition of sparse PSD cones (reference: src/chordal/)
        self.chordal_info = None
        self._n_orig = n
        P_sym0 = _symmetrize_triu(P)
        from .chordal import try_chordal_decomposition

        chordal = try_chordal_decomposition(P_sym0, q, A, b, list(cones),
                                            self.settings)
        if chordal is not None:
            self.chordal_info, P_sym0, q, A, b, cones = chordal
            n, m = A.shape[1], A.shape[0]
            if n + m > 2000:
                # the reference tries its sparse setup on the decomposed
                # problem here (api.py:395-408)
                raise _not_in_slice(
                    "sparse setup of a chordally decomposed problem with "
                    "n + m > 2000", "11 (sparse and structured KKT)")

        self._P_full = P_sym0
        self._q, self._A, self._b = q, A, b
        self.n, self.m = n, m
        self.cones = list(cones)
        self.layout = ConeLayout(self.cones)
        if self.layout.m != m:
            raise ValueError("cone dimensions do not match constraint count")
        p_nonzero = bool(np.any(self._P_full != 0))
        self._p_nonzero = p_nonzero
        self._backend = self._choose_backend(n, m)

        cache_key = (self.layout.key, n, p_nonzero, self._backend,
                     dataclasses.astuple(self.settings), str(self.device))
        solve_fn = _solve_cache_get(cache_key)
        if solve_fn is None:
            solve_fn = build_solve(self.layout, self.settings, n, p_nonzero,
                                   kkt_backend=self._backend)
            _solve_cache_put(cache_key, solve_fn)
        self._solve_fn = solve_fn

        self._setup_time = time.perf_counter() - t0
        self._setup_done = True
        self._dev_args = None   # the device-resident warm-solve copy
        return self

    def _choose_backend(self, n: int, m: int) -> str:
        """The reference's choice (api.py:446-510) without a structure
        plan: "blockarrow" and "multifrontal" run the dense ldl loop (as
        `BatchSolver` does); "auto" takes `condensed` for tall problems and
        big SOCs, else `ldl`.  Above n + m = 1024 the reference's "auto"
        first analyzes the KKT pattern for a structure plan, which this
        slice does not port."""
        backend = self.settings.kkt_backend
        if backend in ("blockarrow", "multifrontal"):
            return backend          # build_solve runs the dense ldl loop
        if backend != "auto":
            return backend
        if n + m > 1024:
            raise _not_in_slice(
                "kkt_backend='auto' above n + m = 1024 (the structure "
                "analysis)", "11 (sparse and structured KKT)")
        big_soc = any(g.kind == "soc" and g.width >= SOC_RANK2_MIN_DIM
                      for g in self.layout.groups.values())
        tall = (m >= 2.5 * n and m >= 250) or big_soc
        return "condensed" if tall else "ldl"

    # ------------------------------------------------------------------
    def solve(self) -> DefaultSolution:
        """reference: src/solver.jl:189-380"""
        if not self._setup_done:
            raise RuntimeError("call setup() before solve()")
        self._slice_check()
        if self.settings.verbose:
            from . import info_print

            info_print.print_banner()
            info_print.print_configuration(self)
            info_print.print_status_header()
        t0 = time.perf_counter()
        if self._dev_args is None:
            self._dev_args = tuple(
                torch.from_numpy(np.ascontiguousarray(a)[None]).to(
                    self.device)
                for a in (self._P_full, self._q, self._A, self._b))
        out = self._solve_fn(*self._dev_args)
        # one fetch from the device for every field
        flat = torch.cat([out[k].reshape(-1).to(torch.float64)
                          for k in _VECTORS + _SCALARS]).cpu().numpy()
        host, off = {}, 0
        for k in _VECTORS + _SCALARS:
            size = out[k].numel()
            host[k] = flat[off:off + size] if k in _VECTORS else flat[off]
            off += size
        solve_time = time.perf_counter() - t0
        if self._first_solve_time is None:
            self._first_solve_time = solve_time
        return self._package_solution(host, solve_time)

    def _package_solution(self, out, solve_time) -> DefaultSolution:
        status = SolverStatus(int(out["status"]))
        x, z, s = out["x"], out["z"], out["s"]

        # reverse chordal decomposition (reference: src/solution.jl:31-36)
        if self.chordal_info is not None:
            from .chordal.decomp import decomp_reverse

            x, z, s = decomp_reverse(self.chordal_info, x, z, s, self.cones,
                                     self.settings)

        # reverse presolve (reference: src/presolver.jl:85-107)
        if self.presolver is not None:
            z, s = presolve_mod.presolve_reverse(self.presolver, z, s)

        self.solution = DefaultSolution(
            x=x, z=z, s=s, status=status,
            obj_val=float(out["obj_val"]),
            obj_val_dual=float(out["obj_val_dual"]),
            solve_time=solve_time,
            iterations=int(out["iterations"]),
            r_prim=float(out["r_prim"]),
            r_dual=float(out["r_dual"]),
        )
        self.info = DefaultInfo(
            mu=float(out["mu"]), sigma=float(out["sigma"]),
            step_length=float(out["step_length"]),
            iterations=int(out["iterations"]),
            cost_primal=float(out["obj_val"]),
            cost_dual=float(out["obj_val_dual"]),
            res_primal=float(out["r_prim"]), res_dual=float(out["r_dual"]),
            gap_abs=float(out["gap_abs"]), gap_rel=float(out["gap_rel"]),
            ktratio=float(out["ktratio"]),
            solve_time=solve_time, status=status,
        )
        if self.settings.verbose:
            from . import info_print

            info_print.print_footer(self.solution)
        return self.solution

    # ------------------------------------------------------------------
    def get_solution(self) -> Optional[DefaultSolution]:
        return self.solution

    def get_info(self) -> DefaultInfo:
        return self.info

    # data updating for warm re-solves (reference: src/data_updating.jl)
    def update_data(self, P=None, q=None, A=None, b=None):
        from . import data_updating as du

        du.update_data(self, P, q, A, b)

    def update_P(self, P):
        from . import data_updating as du

        du.update_P(self, P)

    def update_q(self, q):
        from . import data_updating as du

        du.update_q(self, q)

    def update_A(self, A):
        from . import data_updating as du

        du.update_A(self, A)

    def update_b(self, b):
        from . import data_updating as du

        du.update_b(self, b)

    def is_data_update_allowed(self) -> bool:
        from .data_updating import _check_update_allowed

        try:
            _check_update_allowed(self)
            return True
        except ValueError:
            return False

    def linear_solver_info(self) -> dict:
        """Backend description (reference: LinearSolverInfo, src/types.jl;
        nnz(L) becomes the dense factor size; api.py:725)."""
        N = self.n + self.m
        backend = self.settings.kkt_backend
        if backend == "auto":
            backend = "ldl"
        variant = (
            "blocked" if (backend == "ldl" and N > 512) else "unblocked"
        )
        return {
            "backend": backend,
            "variant": variant,
            "kkt_dim": N,
            "factor_nnz": N * (N + 1) // 2 if backend == "ldl" else
            self.n * (self.n + 1) // 2,
            "factor_dtype": self.settings.factor_dtype or "auto",
            "mixed_precision": self.settings.mixed_precision,
        }

    # ---- left to ROADMAP.md Queue 1 item 12 ----
    def save_checkpoint(self, path: str):
        raise _not_in_slice("save_checkpoint", "12 (long solves)")

    def resume_from_checkpoint(self, path: str):
        raise _not_in_slice("resume_from_checkpoint", "12 (long solves)")

    def profile_trace(self, log_dir: str):
        raise _not_in_slice("profile_trace", "12 (long solves)")

    def print_timers(self):
        raise _not_in_slice("print_timers", "12 (long solves)")
