"""The single-instance `Solver`.

A port of `clarabel_tpu/api.py` (`Solver` l.105, `_setup_sparse`
l.137-305, `setup` l.307-540, `solve` l.543-584, `_package_solution`
l.586-628, the getters and `linear_solver_info` l.725):

    solver = Solver(P, q, A, b, cones, settings)        # on the card
    solver = Solver(P, q, A, b, cones, settings, device="cpu")
    solution = solver.solve()

solves  min ½x'Px + q'x  s.t. Ax + s = b, s ∈ K  for one problem.  Setup
runs the reference's host-side steps: the dimension checks, cone
collapsing, the cap of b at +infinity, the presolver (`presolver.py`) and
the chordal decomposition of sparse PSD cones (`chordal/`), then picks the
backend as the reference does: `ldl` or `condensed`, or, from an analysis
of the KKT pattern, a block-arrow (`structure.py`) or nested-dissection
(`structure_nd.py`) plan for the `blockarrow` or `multifrontal` backend.
Sparse inputs (scipy-sparse data with n + m > 2000, big SOC or genpow
cones over sparse rows, `sparse_data=True`) take the sparse setup: P and A
stay COO end to end and the KKT is summed from their values through
assembly maps (`kkt/assembly_maps*.py`); where no plan is found, the dense
path runs, as in the reference.  Solve runs the port's batched loop solver
(`ipm/loop.build_solve`) at B = 1 on the solver's device: on a card its
float32 dense factors go through K2; on the CPU the plain versions run.
The problem stays on the device between warm solves; a data update
(`update_*`) drops that copy.

Long solves run the loop's stages (`solve.prepare`, `solve.run_phases`
with an iteration cap, `solve.finalize`) one at a time, with the same
bits as the one-shot solve: a finite `time_limit` runs 25 IPM iterations
a chunk and checks the wall clock between chunks (status MAX_TIME when it
runs out); `save_checkpoint` writes the last chunked solve's IPM state and
`resume_from_checkpoint` continues from it; `Settings(timing=True)` times
prepare, loop and finalize, and `print_timers` prints them with two
probes of one iteration; `profile_trace` records a `torch.profiler` trace
(DEVIATIONS.md #19).

`mesh=` (a `torch.distributed.device_mesh.DeviceMesh`) shards the
block-arrow factorization over the mesh's "tp" dim (else its first): every
rank of the mesh sets up the same Solver from the same data and returns
the whole solution (DEVIATIONS.md #20).  The mesh forces the block-arrow
backend, with the plan padded to a multiple of the tp size, and the
device defaults to the rank's own card.
"""

import contextlib
import dataclasses
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import presolver as presolve_mod
from .cones.api import (GenPowerConeT, SecondOrderConeT, SupportedCone,
                        cones_collapse, nvars)
from .cones.layout import ConeLayout
from .cones.ops import SOC_RANK2_MIN_DIM
from .ipm.loop import build_solve
from .parallel.batch_impl import resolve_device
from .parallel.multihost import (all_reduce, check_mesh, mesh_device,
                                 mesh_key, same_on_every_rank, tp_axis_of)
from .settings import Settings
from .statuscodes import SolverStatus, status_string

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


def _plan_factor_nnz(plan) -> int:
    """Entries of a plan's padded factors: the blocks' and the tail's
    lower triangles and the couplings, or each level's fronts."""
    if hasattr(plan, "levels"):
        return int(sum(lv.cnt * (lv.nr * (lv.nr + 1) // 2 + lv.nr * lv.nbd)
                       for lv in plan.levels))
    p, nb, nt = plan.p, plan.nb, plan.nt
    return int(p * nb * (nb + 1) // 2 + p * nb * nt + nt * (nt + 1) // 2)


class Solver:
    """Conic interior-point solver for one problem.

        solver = Solver(P, q, A, b, cones, settings, device=None)
        solution = solver.solve()

    `device`: the card when None (with no card, pass "cpu"); with a
    `mesh`, the rank's own card, cuda:{LOCAL_RANK % device_count()}."""

    def __init__(self, P=None, q=None, A=None, b=None,
                 cones: Optional[Sequence[SupportedCone]] = None,
                 settings: Optional[Settings] = None, mesh=None,
                 device=None, **kwargs):
        self.settings = settings if settings is not None else Settings()
        if kwargs:
            self.settings = dataclasses.replace(self.settings, **kwargs)
        # multi-device factorization (reference api.py:122-132)
        self.mesh = mesh
        self._tp_axis = None
        if mesh is not None:
            check_mesh(mesh)
            self._tp_axis = tp_axis_of(mesh)
            self.device = mesh_device(device)
        else:
            self.device = resolve_device(device)
        self.solution: Optional[DefaultSolution] = None
        self.info = DefaultInfo()
        self.presolver = None
        self.chordal_info = None
        self._structure = None
        self._sparse_mode = False
        self._setup_done = False
        self._first_solve_time = None
        self._dev_args = None
        self._last_carry = None
        self._timers = None
        self._timed_state = None
        if P is not None:
            self.setup(P, q, A, b, cones)

    # ------------------------------------------------------------------
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

        # copies: the solver's problem is fixed at setup, whatever the
        # caller later does to its arrays (DEVIATIONS.md #17)
        q = np.array(q, dtype=np.float64).ravel()
        b = np.array(b, dtype=np.float64).ravel()
        self._setup_split = {"analysis": 0.0, "maps": 0.0}
        if self._want_sparse(q, A, b, cones):
            if self._setup_sparse(P, q, A, b, cones, t0):
                return self
            # no structure found: the dense path (reference api.py:348-352)

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
            # a large decomposed problem (many clique-sized cones and
            # overlap columns) is usually sparse: try the sparse setup on
            # the transformed data (reference api.py:395-408)
            if n + m > 2000:
                chordal_info, n_orig = self.chordal_info, self._n_orig
                if self._setup_sparse(P_sym0, q, A, b, list(cones), t0,
                                      preprocessed=True):
                    self.chordal_info, self._n_orig = chordal_info, n_orig
                    return self

        self._P_full = P_sym0
        self._q, self._A, self._b = q, A, b
        self.n, self.m = n, m
        self.cones = list(cones)
        self.layout = ConeLayout(self.cones)
        if self.layout.m != m:
            raise ValueError("cone dimensions do not match constraint count")
        p_nonzero = bool(np.any(self._P_full != 0))
        self._p_nonzero = p_nonzero
        self._sparse_mode = False
        self._data_args = None
        self._backend = self._choose_backend(n, m)

        cache_key = (self.layout.key, n, p_nonzero, self._backend,
                     dataclasses.astuple(self.settings),
                     None if self._structure is None
                     else self._structure.key, str(self.device))
        cache_key += self._mesh_key()
        solve_fn = _solve_cache_get(cache_key)
        if solve_fn is None:
            solve_fn = build_solve(self.layout, self.settings, n, p_nonzero,
                                   structure=self._structure,
                                   kkt_backend=self._backend,
                                   mesh=self.mesh,
                                   tp_axis=self._tp_axis or "tp")
            _solve_cache_put(cache_key, solve_fn)
        self._solve_fn = solve_fn

        self._setup_time = time.perf_counter() - t0
        self._setup_done = True
        self._dev_args = None   # the device-resident warm-solve copy
        return self

    def _choose_backend(self, n: int, m: int) -> str:
        """The reference's choice (api.py:426-512), setting
        `self._structure`: "blockarrow" and "multifrontal" analyze the KKT
        pattern for their plan (without one they run the dense ldl loop);
        "auto" above n + m = 1024 analyzes both and takes a plan whose flop
        estimate beats half the dense factorization and the condensed one,
        else `condensed` for tall problems and big SOCs, else `ldl`."""
        from .structure import analyze_block_arrow
        from .structure_nd import NestedPlan, analyze_nested_dissection

        self._structure = None
        backend = self.settings.kkt_backend
        big = backend == "auto" and n + m > 1024
        ta = time.perf_counter()
        if self.mesh is not None:
            # the sharded factorization is block-arrow only
            self._structure = self._mesh_plan(analyze_block_arrow(
                self._P_full != 0, self._A != 0, self.layout))
            self._setup_split["analysis"] += time.perf_counter() - ta
            return "blockarrow"
        if backend == "blockarrow" or big:
            self._structure = analyze_block_arrow(
                self._P_full != 0, self._A != 0, self.layout)
        if backend == "multifrontal" or big:
            # multilevel nested dissection wins where the single-level
            # separator is large (grids, meshes): compared by flop estimate
            nd_plan = analyze_nested_dissection(
                self._P_full != 0, self._A != 0, self.layout)
            if nd_plan is not None and (
                    self._structure is None
                    or nd_plan.flop_estimate()
                    < self._structure.flop_estimate()):
                self._structure = nd_plan
        self._setup_split["analysis"] += time.perf_counter() - ta
        if backend != "auto":
            return backend
        N = n + m
        dense_flops = N ** 3 / 3.0
        st_flops = (self._structure.flop_estimate()
                    if self._structure is not None else float("inf"))
        big_soc = any(g.kind == "soc" and g.width >= SOC_RANK2_MIN_DIM
                      for g in self.layout.groups.values())
        tall = (m >= 2.5 * n and m >= 250) or big_soc
        cond_flops = (2.0 * m * n * n + n ** 3 / 3.0) if tall \
            else float("inf")
        if st_flops <= min(0.5 * dense_flops, cond_flops):
            return ("multifrontal" if isinstance(self._structure, NestedPlan)
                    else "blockarrow")
        self._structure = None
        return "condensed" if tall else "ldl"

    def _mesh_plan(self, plan):
        """A block-arrow plan for the mesh: padded to a multiple of the tp
        size (reference api.py:211-223, 431-443), and the same on every
        rank of the mesh (the analysis is deterministic; a rank factoring
        another plan's blocks would give wrong answers without an
        error)."""
        from .structure import pad_plan_blocks

        if plan is None:
            raise ValueError(
                "multi-device solve (mesh=...) requires block-arrow "
                "structure in the KKT pattern; none was found")
        tp = dist.get_world_size(self.mesh.get_group(self._tp_axis))
        plan = pad_plan_blocks(plan, tp)
        if not same_on_every_rank(int(plan.key[-1][:15], 16), self.mesh,
                                  self.device):
            raise RuntimeError("the ranks of the mesh found different "
                               "block-arrow plans")
        return plan

    def _mesh_key(self) -> tuple:
        """The mesh's part of the solve-cache key; the tp group itself
        too, since the built solve all-reduces over it."""
        if self.mesh is None:
            return ()
        return mesh_key(self.mesh) + (
            self._tp_axis, self.mesh.get_group(self._tp_axis))

    def _setup_sparse(self, P, q, A, b, cones, t0,
                      preprocessed: bool = False) -> bool:
        """The sparse setup (reference api.py:137-305): P and A stay COO
        end to end, with map-based assembly of a block-arrow or nested
        plan.  Returns False, and the caller runs the dense path, when no
        usable plan is found.  `preprocessed=True` skips the presolve and
        chordal resets (a chordally decomposed problem re-entering)."""
        import scipy.sparse as sp

        from . import get_infinity
        from .data_updating import SparseUpdateMaps
        from .kkt.assembly_maps import build_assembly_maps
        from .kkt.assembly_maps_nd import build_nested_assembly_maps
        from .linalg.matops import Pattern
        from .structure import analyze_block_arrow
        from .structure_nd import analyze_nested_dissection

        P = sp.csr_matrix(P).astype(np.float64)
        A = sp.csr_matrix(A).astype(np.float64)
        if self.settings.input_sparse_dropzeros:
            # stored zeros stay out of the KKT pattern (reference:
            # src/problemdata.jl dropzeros!; disables data updating)
            P.eliminate_zeros()
            A.eliminate_zeros()
        n, m = q.shape[0], b.shape[0]
        if A.shape != (m, n) or P.shape != (n, n):
            raise ValueError("dimension mismatch")
        if sum(nvars(c) for c in cones) != m:
            raise ValueError(
                "Constraint dimensions inconsistent with size of cones")

        if not preprocessed:
            cones = cones_collapse(list(cones))
            infinity = get_infinity()
            b = np.minimum(b, infinity)
            self.presolver = None
            if self.settings.presolve_enable:
                pres = presolve_mod.try_presolve(A, b, cones, infinity)
                if pres is not None:
                    self.presolver = pres
                    A = A[pres.keep_logical]
                    b = b[pres.keep_logical]
                    cones = pres.reduced_cones
                    m = b.shape[0]
            # chordal decomposition runs on the dense path; its output may
            # come back here with preprocessed=True
            self.chordal_info = None
            self._n_orig = n

        P_sym = (sp.triu(P) + sp.triu(P, 1).T).tocoo()
        A_coo = sp.coo_matrix(A)
        layout = ConeLayout(cones)
        if layout.m != m:
            raise ValueError("cone dimensions do not match constraint count")
        P_pat = ((P_sym.row, P_sym.col), (n, n))
        A_pat = ((A_coo.row, A_coo.col), (m, n))

        # big SOC and genpow cones take the low-rank Hs form (a diagonal
        # in the assembly, an SMW correction around the factor): their
        # rows stay singletons in the structure graph
        srk = SOC_RANK2_MIN_DIM if any(
            g.kind in ("soc", "genpow") and g.width >= SOC_RANK2_MIN_DIM
            for g in layout.groups.values()) else None

        requested = self.settings.kkt_backend
        ba_plan = nd_plan = None
        ta = time.perf_counter()
        if self.mesh is not None:
            # the sharded factorization is block-arrow only
            ba_plan = self._mesh_plan(analyze_block_arrow(
                P_pat, A_pat, layout, soc_rank2_min_dim=srk))
        elif requested != "multifrontal":
            ba_plan = analyze_block_arrow(P_pat, A_pat, layout,
                                          soc_rank2_min_dim=srk)
        if requested != "blockarrow" and self.mesh is None and srk is None:
            # the SMW path exists on the block-arrow backend only
            nd_plan = analyze_nested_dissection(P_pat, A_pat, layout)
        # the structurally cheaper factorization
        if ba_plan is not None and nd_plan is not None:
            if nd_plan.flop_estimate() < ba_plan.flop_estimate():
                ba_plan = None
            else:
                nd_plan = None
        if self.mesh is None and srk is None and ba_plan is not None \
                and n + m <= 4096 and (
                ba_plan.flop_estimate() > 0.5 * (n + m) ** 3 / 3.0):
            # the structure does not beat a dense factorization by a
            # useful margin and the problem is small enough to be dense:
            # the dense path picks condensed or ldl
            ba_plan = None
        analysis = time.perf_counter() - ta
        tm = time.perf_counter()
        if ba_plan is not None:
            plan = ba_plan
            maps = build_assembly_maps(
                (P_sym.row, P_sym.col), (A_coo.row, A_coo.col), layout,
                plan, soc_rank2_min_dim=srk)
        elif nd_plan is not None:
            plan = nd_plan
            maps = build_nested_assembly_maps(
                (P_sym.row, P_sym.col), (A_coo.row, A_coo.col), layout,
                plan)
        else:
            self._setup_split = {"analysis": analysis, "maps": 0.0}
            return False
        self._setup_split = {"analysis": analysis,
                             "maps": time.perf_counter() - tm}

        self._P_full = P_sym.tocsr()
        self._q, self._A, self._b = q, A, b
        self.n, self.m = n, m
        self.cones = list(cones)
        self.layout = layout
        self._p_nonzero = P_sym.nnz > 0
        self._structure = plan
        self._assembly = maps
        self._backend = ("blockarrow" if ba_plan is not None
                         else "multifrontal")
        self._sparse_mode = True
        # the COO entry order is fixed here: the maps, the patterns and the
        # data updates all read it (reference data_updating.py:29)
        self._patterns = (Pattern(P_sym.row, P_sym.col, (n, n)),
                          Pattern(A_coo.row, A_coo.col, (m, n)))
        self._data_args = (np.asarray(P_sym.data, np.float64), q,
                           np.asarray(A_coo.data, np.float64), b)
        self._sparse_maps = SparseUpdateMaps.build(P_sym, A_coo, n)

        cache_key = (layout.key, n, self._p_nonzero, "sparse",
                     dataclasses.astuple(self.settings), maps.key,
                     str(self.device)) + self._mesh_key()
        solve_fn = _solve_cache_get(cache_key)
        if solve_fn is None:
            solve_fn = build_solve(layout, self.settings, n,
                                   self._p_nonzero, structure=plan,
                                   assembly=maps, mesh=self.mesh,
                                   tp_axis=self._tp_axis or "tp")
            _solve_cache_put(cache_key, solve_fn)
        self._solve_fn = solve_fn

        self._setup_time = time.perf_counter() - t0
        self._setup_done = True
        self._dev_args = None
        return True

    # ------------------------------------------------------------------
    def solve(self) -> DefaultSolution:
        """reference: src/solver.jl:189-380"""
        if not self._setup_done:
            raise RuntimeError("call setup() before solve()")
        if self.settings.verbose:
            from . import info_print

            info_print.print_banner()
            info_print.print_configuration(self)
            info_print.print_status_header()
        t0 = time.perf_counter()
        if self._dev_args is None:
            self._dev_args = self._device_args()
        if math.isfinite(self.settings.time_limit):
            out = self._solve_chunked(t0)
        elif self.settings.timing:
            out = self._solve_timed()
        else:
            out = self._solve_fn(*self._dev_args)
        host = _fetch(out)
        solve_time = time.perf_counter() - t0
        if self._first_solve_time is None:
            self._first_solve_time = solve_time
        return self._package_solution(host, solve_time)

    def _device_args(self):
        """The problem on the device as the solve function takes it: dense
        (1, ...) tensors, or in sparse mode P and A as SparseCOO values
        (1, nnz) over the patterns fixed at setup."""
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)[None]).to(
                self.device)

        if not self._sparse_mode:
            return tuple(dev(a) for a in (self._P_full, self._q, self._A,
                                          self._b))
        from .linalg.matops import SparseCOO

        Pv, q, Av, b = self._data_args
        Ppat, Apat = self._patterns
        return (SparseCOO(dev(Pv), Ppat), dev(q), SparseCOO(dev(Av), Apat),
                dev(b))

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
        nnz(L) becomes the dense factor size; api.py:725).  With a
        structure plan it names the backend the plan runs and the size of
        its padded factors, where the reference names the setting
        (DEVIATIONS.md #18)."""
        N = self.n + self.m
        if self._structure is not None:
            return {
                "backend": self._backend,
                "variant": "sparse" if self._sparse_mode else "dense",
                "kkt_dim": N,
                "factor_nnz": _plan_factor_nnz(self._structure),
                "factor_dtype": self.settings.factor_dtype or "auto",
                "mixed_precision": self.settings.mixed_precision,
            }
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

    # ---- long solves (reference api.py:630-682, 745-835) ----
    def _solve_chunked(self, t0, chunk_iters: int = 25, checkpoint_cb=None,
                       carry=None):
        """Run the loop `chunk_iters` IPM iterations at a time, checking the
        wall clock against `settings.time_limit` between chunks (status
        MAX_TIME when it has run out; the reference checks it every
        iteration, src/info.jl:109-116) and handing each chunk's IPM state
        to `checkpoint_cb`.  Starts from `carry` when one is given (a
        resumed solve).  Each chunk ends with one read of the iteration
        count and status from the device."""
        fn = self._solve_fn
        if self._dev_args is None:
            self._dev_args = self._device_args()
        data, carry0 = fn.prepare(*self._dev_args)
        if carry is None:
            carry = carry0
        iters = int(carry.iters[0])
        while True:
            carry = fn.run_phases(data, carry, iters + chunk_iters)
            if checkpoint_cb is not None:
                checkpoint_cb(carry)
            iters, status = torch.stack(
                [carry.iters[0], carry.status[0]]).tolist()
            if status != int(SolverStatus.UNSOLVED):
                break
            if self._out_of_time(t0):
                carry = carry._replace(status=torch.full_like(
                    carry.status, int(SolverStatus.MAX_TIME)))
                break
        self._last_carry = carry
        return fn.finalize(data, carry)

    def _out_of_time(self, t0) -> bool:
        """Whether the time limit has run out; with a mesh, on any rank
        of the tp group, so that its ranks stop after the same chunk."""
        out = time.perf_counter() - t0 > self.settings.time_limit
        if self.mesh is None:
            return out
        flag = torch.tensor([int(out)], dtype=torch.int32,
                            device=self.device)
        return bool(all_reduce(flag, self.mesh.get_group(self._tp_axis)))

    def save_checkpoint(self, path: str):
        """Write the IPM state of the last chunked solve (a finite
        time_limit, or a resumed solve) to an .npz file: the fields of the
        port's `ipm.loop.Carry`, lane axis included (DEVIATIONS.md #19)."""
        if self._last_carry is None:
            raise RuntimeError("no IPM state available; run a chunked solve")
        np.savez(path, **{k: v.cpu().numpy()
                          for k, v in self._last_carry._asdict().items()})

    def resume_from_checkpoint(self, path: str) -> DefaultSolution:
        """Continue a solve from a state that `save_checkpoint` wrote, on
        this solver's device."""
        from .ipm.loop import Carry

        with np.load(path) as f:
            carry = Carry(**{k: torch.from_numpy(f[k]).to(self.device)
                             for k in Carry._fields})
        t0 = time.perf_counter()
        out = self._solve_chunked(t0, carry=carry)
        return self._package_solution(_fetch(out), time.perf_counter() - t0)

    def profile_trace(self, log_dir: str):
        """A context that records a `torch.profiler` profile of the solves
        inside it (CPU activity, and CUDA activity on a card) and writes it
        as a Chrome trace under `log_dir` when it closes (the reference's
        xprof trace; DEVIATIONS.md #19).  The path is then
        `self.last_trace`."""
        return _profile_trace(self, log_dir)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _solve_timed(self):
        """Prepare (equilibration and the initial point), the IPM loop and
        finalize, each ended by a synchronization with the device: the
        stages the one-shot solve runs, so the bits are its bits."""
        fn = self._solve_fn
        t0 = time.perf_counter()
        data, carry0 = fn.prepare(*self._dev_args)
        self._sync()
        t1 = time.perf_counter()
        final = fn.run_phases(data, carry0)
        self._sync()
        t2 = time.perf_counter()
        out = fn.finalize(data, final)
        self._sync()
        t3 = time.perf_counter()
        self._timers = {"prepare": t1 - t0, "loop": t2 - t1,
                        "finalize": t3 - t2,
                        "iterations": int(final.iters[0])}
        self._timed_state = (data, final)
        return out

    def _probe_phase_times(self):
        """Seconds of the per-iteration slices at the final IPM state, best
        of 3 after a warm call: CUDA events on a card, the host clock on
        the CPU."""
        data, carry = self._timed_state
        fn = self._solve_fn
        probes = {"cone scaling update": fn.probe_scaling,
                  "scaling + KKT factor + 2-RHS solve": fn.probe_step}
        cuda = self.device.type == "cuda"
        times = {}
        for name, probe in probes.items():
            probe(data, carry)          # warm
            self._sync()
            best = float("inf")
            for _ in range(3):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    probe(data, carry)
                    end.record()
                    end.synchronize()
                    best = min(best, start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    probe(data, carry)
                    best = min(best, time.perf_counter() - t0)
            times[name] = best
        return times

    def print_timers(self):
        """The timing tree (reference: print_timers, src/solver.jl:534;
        TimerOutputs tree src/types.jl:362-372).  With
        Settings(timing=True) solves run as timed stages and the tree shows
        them and the device probes of one iteration; otherwise only the
        totals the host sees."""
        where = (torch.cuda.get_device_name(self.device)
                 if self.device.type == "cuda" else "cpu")
        print(f"device: {where}")
        print(f"setup:                        {self._setup_time:10.4f} s")
        if self._first_solve_time is not None:
            print(f"solve (first):                "
                  f"{self._first_solve_time:10.4f} s")
        if self.solution is not None:
            print(f"solve (last):                 "
                  f"{self.solution.solve_time:10.4f} s")
        timers = self._timers
        if timers is None:
            print("  (enable Settings(timing=True) for the phase tree)")
            return
        iters = max(1, timers["iterations"])
        print(f"  ├ prepare (equilibration + initial point): "
              f"{timers['prepare']:.4f} s")
        print(f"  ├ IPM loop ({timers['iterations']} iterations): "
              f"{timers['loop']:.4f} s  "
              f"({timers['loop'] / iters * 1e3:.2f} ms/iter)")
        if self._timed_state is not None:
            for name, t in self._probe_phase_times().items():
                print(f"  │   ├ {name}: {t * 1e3:.2f} ms")
        print(f"  └ finalize (unscale + certificates): "
              f"{timers['finalize']:.4f} s")


def _fetch(out) -> dict:
    """The loop solver's outputs for lane 0, in one copy from the device:
    vectors as arrays, scalars as numbers."""
    flat = torch.cat([out[k].reshape(-1).to(torch.float64)
                      for k in _VECTORS + _SCALARS]).cpu().numpy()
    host, off = {}, 0
    for k in _VECTORS + _SCALARS:
        size = out[k].numel()
        host[k] = flat[off:off + size] if k in _VECTORS else flat[off]
        off += size
    return host


@contextlib.contextmanager
def _profile_trace(solver, log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if solver.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        solver._sync()
    path = os.path.join(log_dir, f"solver_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    solver.last_trace = path
