"""The homogeneous-embedding IPM loop solver, batched over a leading lane axis.

A port of `clarabel_tpu/ipm/loop.py` for every cone family (zero,
nonnegative, second-order, PSD triangle, exponential, power and
generalized power) with the dense `ldl` and the `condensed` KKT backends.
The reference builds a single-instance function and batches it with
`jax.vmap`; `build_solve` here returns the batched function itself,
solve(P (B,n,n), q (B,n), A (B,m,n), b (B,m)) -> dict of (B, ...) tensors,
and computes on the inputs' device.

What `vmap` does to the reference's control flow is written out:

* The IPM while-loop runs while any lane is active, and a lane that is not
  keeps its carry (`torch.where` on the lane axis).
* The status-gated `lax.cond(done_or_restart, skip_step, do_step)` computes
  both branches for every lane and selects per lane.  Lanes that are done
  are still factored; their values never reach a live lane, because every
  merge is a select and never a product with a mask.
* Refinement is masked per lane (`kkt.refine`).
* The inner loops (refinement, the backtracks, the one-sided Newton
  solves) ask the host whether a lane still runs once every
  `trips.TRIPS_PER_CHECK` trips (`trips.run_trips`).  On a card the IPM
  pass of an exp layout, and of a zero/nn/SOC layout over at most
  GRAPH_MAX_LANES lanes, is captured once as a CUDA graph and replayed,
  with one host check per pass (`_replay`).
* Layouts with a nonsymmetric cone take the asymmetric IPM: the
  unit-initialization start, and per lane the PrimalDual→Dual strategy
  machine with the barrier backtrack of Dual lanes (reference:
  src/solver.jl:407-514).  A generalized power cone pins every lane to
  Dual from the start, so no switch fires.  Symmetric layouts (PSD
  included) never run those ops.

Variable set: (x, z, s, τ, κ) with residuals
    rx = −Aᵀz − Px − qτ
    rz = s + Ax − bτ
    rτ = qᵀx + bᵀz + κ + xᵀPx/τ        (reference: src/residuals.jl:1-37)
"""

from typing import NamedTuple

import numpy as np
import torch

from ..cones.layout import ConeLayout
from ..cones import ops as cone_ops
from ..info_print import print_iterations
from ..kkt import dense as kkt
from ..linalg import batched_ldl
from ..linalg import matops
from ..linalg import smallops as so
from ..parallel.multihost import capturable
from ..settings import torch_dtype
from ..statuscodes import SolverStatus
from ..trips import run_trips
from .equilibration import ruiz_equilibrate

# scaling strategy codes (reference: src/types.jl:73-76); symmetric cones
# keep PrimalDual throughout, a nonsymmetric layout may downgrade a lane
PRIMAL_DUAL = 0
DUAL = 1

_BIG = 1e30  # large-but-finite in both f32 and f64

UNSOLVED = int(SolverStatus.UNSOLVED)
SOLVED = int(SolverStatus.SOLVED)
MAX_ITERATIONS = int(SolverStatus.MAX_ITERATIONS)
NUMERICAL_ERROR = int(SolverStatus.NUMERICAL_ERROR)
INSUFFICIENT_PROGRESS = int(SolverStatus.INSUFFICIENT_PROGRESS)


class Residuals(NamedTuple):
    rx: torch.Tensor
    rz: torch.Tensor
    rtau: torch.Tensor
    rx_inf: torch.Tensor
    rz_inf: torch.Tensor
    Px: torch.Tensor
    dot_qx: torch.Tensor
    dot_bz: torch.Tensor
    dot_sz: torch.Tensor
    dot_xPx: torch.Tensor


class Info(NamedTuple):
    cost_primal: torch.Tensor
    cost_dual: torch.Tensor
    res_primal: torch.Tensor
    res_dual: torch.Tensor
    res_primal_inf: torch.Tensor
    res_dual_inf: torch.Tensor
    gap_abs: torch.Tensor
    gap_rel: torch.Tensor
    ktratio: torch.Tensor


class Carry(NamedTuple):
    # current iterate
    x: torch.Tensor
    z: torch.Tensor
    s: torch.Tensor
    tau: torch.Tensor
    kappa: torch.Tensor
    # previous iterate (rollback for insufficient progress,
    # reference: src/solver.jl:346-347, src/info.jl:123-153)
    px: torch.Tensor
    pz: torch.Tensor
    ps: torch.Tensor
    ptau: torch.Tensor
    pkappa: torch.Tensor
    # previous-iterate info scalars
    prev_res_primal: torch.Tensor
    prev_res_dual: torch.Tensor
    prev_gap_abs: torch.Tensor
    prev_gap_rel: torch.Tensor
    # most recent iteration scalars
    mu: torch.Tensor
    alpha: torch.Tensor
    sigma: torch.Tensor
    # counters / state machine
    iters: torch.Tensor     # int32
    status: torch.Tensor    # int32
    scaling: torch.Tensor   # int32


def _select(mask, a, b):
    """Per lane: a where mask (B,) holds, else b."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _select_tuple(mask, new, old):
    return type(old)(*(_select(mask, a, b) for a, b in zip(new, old)))


def compute_residuals(P, q, A, b, x, z, s, tau, kappa) -> Residuals:
    """reference: src/residuals.jl:1-37"""
    qx = so.vdot(q, x)
    bz = so.vdot(b, z)
    sz = so.vdot(s, z)
    Px = matops.mv(P, x)
    xPx = so.vdot(x, Px)
    rx_inf = -matops.rmv(A, z)
    rz_inf = s + matops.mv(A, x)
    rx = rx_inf - Px - q * tau[:, None]
    rz = rz_inf - b * tau[:, None]
    rtau = qx + bz + kappa + xPx / tau
    return Residuals(rx, rz, rtau, rx_inf, rz_inf, Px, qx, bz, sz, xPx)


def _norm2_scaled(w, v):
    return torch.sqrt(((w * v) ** 2).sum(-1))


def compute_info(res: Residuals, x, z, s, tau, kappa, equil, normq,
                 normb) -> Info:
    """Equilibration-corrected convergence metrics.
    reference: src/info.jl:1-63"""
    tinv = 1.0 / tau
    cinv = 1.0 / equil.c
    d, dinv, e, einv = equil.d, equil.dinv, equil.e, equil.einv

    xPx_half = res.dot_xPx * tinv * tinv / 2.0
    cost_primal = (res.dot_qx * tinv + xPx_half) * cinv
    cost_dual = (-res.dot_bz * tinv - xPx_half) * cinv

    normx = _norm2_scaled(d, x)
    normz = _norm2_scaled(e, z) * cinv
    norms = _norm2_scaled(einv, s)

    one = torch.ones_like(tau)
    res_primal_inf = ((_norm2_scaled(dinv, res.rx_inf) * cinv)
                      / torch.maximum(one, normz))
    res_dual_inf = torch.maximum(
        _norm2_scaled(dinv, res.Px) / torch.maximum(one, normx),
        _norm2_scaled(einv, res.rz_inf) / torch.maximum(one, normx + norms),
    )

    normx = normx * tinv
    normz = normz * tinv
    norms = norms * tinv

    res_primal = (_norm2_scaled(einv, res.rz) * tinv
                  / torch.maximum(one, normb + normx + norms))
    res_dual = (_norm2_scaled(dinv, res.rx) * tinv * cinv
                / torch.maximum(one, normq + normx + normz))

    gap_abs = torch.abs(cost_primal - cost_dual)
    gap_rel = gap_abs / torch.maximum(
        one, torch.minimum(torch.abs(cost_primal), torch.abs(cost_dual)))
    ktratio = kappa * tinv
    return Info(cost_primal, cost_dual, res_primal, res_dual,
                res_primal_inf, res_dual_inf, gap_abs, gap_rel, ktratio)


def check_convergence(info: Info, res: Residuals, tols) -> torch.Tensor:
    """Per-lane status code (UNSOLVED if not converged).
    reference: src/info.jl:274-331"""
    (tol_gap_abs, tol_gap_rel, tol_feas,
     tol_infeas_abs, tol_infeas_rel, tol_ktratio,
     solved_st, pinf_st, dinf_st) = tols

    is_solved = (((info.gap_abs < tol_gap_abs) | (info.gap_rel < tol_gap_rel))
                 & (info.res_primal < tol_feas) & (info.res_dual < tol_feas))
    solved = (info.ktratio <= 1.0) & is_solved

    kt_big = info.ktratio > 1000.0 / tol_ktratio
    pinf = ((res.dot_bz < -tol_infeas_abs)
            & (info.res_primal_inf < -tol_infeas_rel * res.dot_bz))
    dinf = ((res.dot_qx < -tol_infeas_abs)
            & (info.res_dual_inf < -tol_infeas_rel * res.dot_qx))

    status = torch.full(solved.shape, UNSOLVED, dtype=torch.int32,
                        device=solved.device)
    status = torch.where(kt_big & dinf, dinf_st, status)
    status = torch.where(kt_big & pinf, pinf_st, status)
    status = torch.where(solved, solved_st, status)
    return status.to(torch.int32)


# The cone kinds whose IPM pass runs as a CUDA graph on a card.  PSD cones
# take their step lengths from torch.linalg.eigvalsh, which checks its
# result on the host; a pow or genpow pass runs one-sided Newton solves,
# which inside a graph would run to their 100-trip cap (`trips.run_trips`)
# in every scaling and in every trial of the barrier backtrack.
GRAPH_KINDS = frozenset({"zero", "nn", "soc", "exp"})

# The most lanes of a zero/nn/SOC layout whose IPM pass runs as a CUDA
# graph; above it the pass runs eager.  A replay runs the pass's inner
# loops to their caps: on the throughput loop that costs as much device
# time as the launches it saves at 16384 lanes, and more at 65536.  An exp
# layout's pass launches many more small kernels and replayed faster at
# every B measured, up to 65536, so it has no limit (H100: PERF.md
# section 5, `tools/megakernel_probe.py graphs`).
GRAPH_MAX_LANES = 8192


def backtrack_to_barrier(barrier, alpha_init, active, step, max_iter):
    """Backtracking line search on barrier(alpha) < 1 for the lanes
    `active` (the Dual ones), each for at most max_iter trips; the other
    lanes keep alpha_init.  reference: src/solver.jl:424-442"""

    def trip(c):
        alpha, done = c
        good = barrier(alpha) < 1.0
        return torch.where(done | good, alpha, alpha * step), done | good

    alpha, _ = run_trips(trip, (alpha_init, ~active), lambda c: c[1].all(),
                         max_iter)
    return alpha


def _replay(step, active_of, carry: Carry, counts) -> Carry:
    """Run `carry = step(carry)` while any lane is active, as replays of
    one captured CUDA graph: the graph steps a static copy of the carry in
    place and reduces the next pass's loop condition to one flag, which the
    host reads once per pass.  Inner loops inside the pass run to their
    caps (`trips.run_trips`); their lane masks keep every lane's bits.  A
    replay launches what the capture recorded, so K2's launch counts and
    the solve's factorization count (`counts`) grow by what one pass
    records."""
    if not bool(active_of(carry).any()):
        return carry
    static = Carry(*(t.clone() for t in carry))
    k2 = batched_ldl.kernel
    before = (k2.launches, k2.source_launches.copy(),
              counts["factorizations"])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for dst, src in zip(static, step(static)):
            dst.copy_(src)
        flag = active_of(static).any()
    per_pass = (k2.launches - before[0], k2.source_launches - before[1],
                counts["factorizations"] - before[2])
    k2.launches, k2.source_launches, counts["factorizations"] = before
    while True:
        graph.replay()
        k2.launches += per_pass[0]
        k2.source_launches.update(per_pass[1])
        counts["factorizations"] += per_pass[2]
        counts["replays"] += 1
        if not bool(flag):
            return static


def build_solve(layout: ConeLayout, settings, n: int, p_nonzero: bool,
                structure=None, assembly=None, kkt_backend=None,
                mesh=None, tp_axis="tp"):
    """Build the batched solve function for a fixed problem structure
    (cone layout and dimensions): solve(P, q, A, b) -> solution dict of
    (B, ...) tensors on the inputs' device.  P must be the FULL symmetric
    cost matrix.

    The backends are the dense `ldl`, `condensed`, and, with a structure
    plan, `blockarrow` (a `structure.BlockArrowPlan`) and `multifrontal`
    (a `structure_nd.NestedPlan`) on dense data.  `assembly` (the
    `kkt.assembly_maps` or `kkt.assembly_maps_nd` maps of a plan) takes
    sparse data: P and A are then `linalg.matops.SparseCOO`, and the KKT
    is summed from their values through the maps (reference loop.py:
    296-372).  Without a plan, which `BatchSolver` never passes,
    "blockarrow" and "multifrontal" run the dense ldl path, as the
    reference's build_solve does (loop.py:374, 398, 442-452), and "auto"
    means ldl.

    `mesh` (a DeviceMesh, with the plan's block count a multiple of the
    size of its `tp_axis`; `structure.pad_plan_blocks`) shards the
    block-arrow factorization over that axis's process group: every rank
    of the group runs this solve on the same data (reference loop.py:
    194-201).  Its pass runs as a CUDA graph only where the group's
    collectives can be captured (NCCL; `parallel.multihost.capturable`),
    else eager."""
    m = layout.m
    if kkt_backend is None:
        kkt_backend = settings.kkt_backend
    if kkt_backend == "megakernel":
        raise ValueError(
            "kkt_backend='megakernel' is a BatchSolver backend "
            "(parallel.batch_impl.BatchSolver); the loop solver supports "
            "ldl/condensed/auto")
    if kkt_backend not in ("ldl", "condensed", "auto", "blockarrow",
                           "multifrontal"):
        raise ValueError(f"unknown kkt_backend {kkt_backend!r}")
    # the reference's float32 default for multifrontal fronts off a CPU
    # (reference loop.py:228-258), read here as "on a CUDA card": a float64
    # solve with refinement, without mixed precision, on a layout without
    # zero or PSD cones; with maps, the nested ones mean multifrontal
    is_mf = kkt_backend == "multifrontal"
    if assembly is not None:
        from ..kkt.assembly_maps_nd import NestedAssemblyMaps

        is_mf = isinstance(assembly, NestedAssemblyMaps)
    mf_float32 = (is_mf
                  and settings.factor_dtype is None
                  and not any(g.kind in ("zero", "psd")
                              for g in layout.groups.values())
                  and settings.dtype == "float64"
                  and settings.iterative_refinement_enable
                  and not settings.mixed_precision)
    if kkt_backend in ("blockarrow", "multifrontal") and structure is None:
        # without a structure plan the reference's build_solve takes
        # neither branch and falls through to the dense ldl path
        kkt_backend = "ldl"
    dtype = torch_dtype(settings.dtype)
    degree = layout.degree
    if settings.factor_dtype is None:
        # every other backend factors at the solve dtype
        settings = settings.replace(factor_dtype=settings.dtype)
    if settings.dense_ldl_diag_order is None:
        # auto: descending-|diag| elimination order for zero/nn/soc layouts
        # only; nonsymmetric Hs blocks have dominant off-diagonals, where
        # the diagonal is a poor pivoting guide (reference loop.py:260-271)
        safe = all(g.kind in ("zero", "nn", "soc")
                   for g in layout.groups.values())
        settings = settings.replace(dense_ldl_diag_order=safe)
    eps_T = float(np.finfo(settings.dtype).eps)
    group = None if mesh is None else mesh.get_group(tp_axis)
    graphed = (not settings.verbose
               and all(g.kind in GRAPH_KINDS for g in layout.groups.values())
               and (group is None or capturable(group)))
    is_symmetric = layout.is_symmetric
    # generalized power cones have only the dual scaling
    # (reference: coneops_genpowcone.jl:21, loop.py:213-215, 272)
    scaling0 = (DUAL if any(g.kind == "genpow"
                            for g in layout.groups.values()) else PRIMAL_DUAL)

    def shift_to_cone_interior(vec, pd):
        """reference: src/variables.jl:180-208"""
        mm, pm = cone_ops.margins(layout, vec, pd)
        # a non-finite margin must force a shift, never skip it
        mm = torch.where(torch.isfinite(mm), mm, -torch.ones_like(mm))
        pm = torch.where(torch.isfinite(pm), pm, torch.zeros_like(pm))
        one = torch.ones_like(mm)
        if degree > 0:
            target = torch.maximum(one, 0.1 * pm / degree)
        else:
            target = one
        zero = torch.zeros_like(mm)
        amt1 = torch.where(mm <= 0, -mm, zero)
        amt2 = torch.where(mm <= 0, target,
                           torch.where(mm < target, target - mm, zero))
        vec = cone_ops.scaled_unit_shift(layout, vec, amt1, pd)
        vec = cone_ops.scaled_unit_shift(layout, vec, amt2, pd)
        return vec

    def make_kkt(P, A, state, factor_dtype, signs):
        """Factor at the given state and return (ok, solve_xz, solve_xz2),
        each per lane."""
        counts["factorizations"] += 1
        if assembly is not None:
            return make_kkt_sparse(P, A, state, factor_dtype)
        if structure is not None:
            return make_kkt_structured(P, A, state, factor_dtype, signs)
        if kkt_backend == "condensed":
            from ..kkt import condensed as kkt_cond
            from ..kkt import blockarrow as kkt_ba

            fac, _ = kkt_cond.assemble_and_factor_condensed(
                P, A, layout, state, signs, settings, factor_dtype)
            kkt_mv = kkt_ba.make_kkt_matvec(P, A, layout, state)

            def solve_xz(bx, bz):
                return kkt_cond.kkt_solve_xz_condensed(
                    fac, layout, state, kkt_mv, bx, bz, settings)

            def solve_xz2(bx1, bz1, bx2, bz2):
                return kkt_cond.kkt_solve_xz2_condensed(
                    fac, layout, state, kkt_mv, bx1, bz1, bx2, bz2, settings)

            return fac.ok, solve_xz, solve_xz2

        Hs = cone_ops.hs_dense(layout, state, P)
        fac = kkt.assemble_and_factor(P, A, Hs, signs, settings,
                                      factor_dtype=factor_dtype)

        def solve_xz(bx, bz):
            return kkt.kkt_solve_xz(fac, bx, bz, settings)

        def solve_xz2(bx1, bz1, bx2, bz2):
            return kkt.kkt_solve_xz2(fac, bx1, bz1, bx2, bz2, settings)

        return fac.ok, solve_xz, solve_xz2

    def make_kkt_sparse(P, A, state, factor_dtype):
        """Sparse data: the KKT summed from the values through the maps,
        with no dense K or Hs (reference loop.py:301-372)."""
        from ..kkt import blockarrow as kkt_ba
        from ..kkt.assembly_maps_nd import NestedAssemblyMaps
        from ..kkt.refine import solve_refined

        srk = getattr(assembly, "soc_rank2_min_dim", None)
        hs_vals = cone_ops.hs_flat_values(layout, state, P.vals,
                                          soc_rank2_min_dim=srk)
        kkt_mv = kkt_ba.make_kkt_matvec(P, A, layout, state)
        plan = assembly.plan

        if isinstance(assembly, NestedAssemblyMaps):
            from ..kkt import assembly_maps_nd as kkt_amnd
            from ..kkt import multifrontal as kkt_mf

            fac = kkt_amnd.factor_from_nested_maps(
                assembly, P.vals, A.vals, hs_vals, settings, factor_dtype)

            def solve_xz(bx, bz):
                return kkt_mf.kkt_solve_xz_multifrontal(
                    fac, plan, kkt_mv, bx, bz, settings)

            def solve_xz2(bx1, bz1, bx2, bz2):
                return kkt_mf.kkt_solve_xz2_multifrontal(
                    fac, plan, kkt_mv, bx1, bz1, bx2, bz2, settings)

            return fac.ok, solve_xz, solve_xz2

        from ..kkt import assembly_maps as kkt_am

        fac = kkt_am.factor_from_maps(assembly, P.vals, A.vals, hs_vals,
                                      settings, factor_dtype, group)
        ok_factor = fac.ok
        apply_fn = lambda r: kkt_ba._ba_apply(fac, plan, r, group)  # noqa
        if srk is not None:
            # the low-rank cone terms as an SMW correction around K₀
            from ..kkt.socrank import wrap_apply_smw

            U, usigns = cone_ops.soc_rank2_uv(layout, state, n, P.vals,
                                              soc_rank2_min_dim=srk)
            if U is not None:
                apply_fn, ok_smw = wrap_apply_smw(apply_fn, U, usigns,
                                                  settings)
                ok_factor = ok_factor & ok_smw

        def solve_xz(bx, bz):
            sol, ok = solve_refined(apply_fn, kkt_mv,
                                    torch.cat([bx, bz], dim=1), settings)
            return sol[:, :n], sol[:, n:], ok

        def solve_xz2(bx1, bz1, bx2, bz2):
            rhs = torch.stack([torch.cat([bx1, bz1], dim=1),
                               torch.cat([bx2, bz2], dim=1)], dim=2)
            sol, ok = solve_refined(apply_fn, kkt_mv, rhs, settings)
            return (sol[:, :n, 0], sol[:, n:, 0], sol[:, :n, 1],
                    sol[:, n:, 1], ok)

        return ok_factor, solve_xz, solve_xz2

    def make_kkt_structured(P, A, state, factor_dtype, signs):
        """Dense data with a plan: the blocks or fronts gathered out of the
        dense K (reference loop.py:374-420)."""
        from ..kkt import blockarrow as kkt_ba

        Hs = cone_ops.hs_dense(layout, state, P)
        kkt_mv = kkt_ba.make_kkt_matvec(P, A, layout, state)
        if kkt_backend == "multifrontal":
            from ..kkt import multifrontal as kkt_mf

            fac = kkt_mf.assemble_and_factor_multifrontal(
                P, A, Hs, structure, signs, settings, factor_dtype)

            def solve_xz(bx, bz):
                return kkt_mf.kkt_solve_xz_multifrontal(
                    fac, structure, kkt_mv, bx, bz, settings)

            def solve_xz2(bx1, bz1, bx2, bz2):
                return kkt_mf.kkt_solve_xz2_multifrontal(
                    fac, structure, kkt_mv, bx1, bz1, bx2, bz2, settings)

            return fac.ok, solve_xz, solve_xz2

        fac = kkt_ba.assemble_and_factor_blockarrow(
            P, A, Hs, structure, signs, settings, factor_dtype, group)

        def solve_xz(bx, bz):
            return kkt_ba.kkt_solve_xz_blockarrow(fac, structure, kkt_mv,
                                                  bx, bz, settings, group)

        def solve_xz2(bx1, bz1, bx2, bz2):
            return kkt_ba.kkt_solve_xz2_blockarrow(
                fac, structure, kkt_mv, bx1, bz1, bx2, bz2, settings,
                group)

        return fac.ok, solve_xz, solve_xz2

    def default_start(P, q, A, b, signs, factor_dtype):
        """reference: src/solver.jl:383-404, src/kktsystem.jl:95-132"""
        B = q.shape[0]
        one = torch.ones((B,), dtype=dtype, device=q.device)
        zero_n = torch.zeros_like(q)
        if not is_symmetric:
            # asymmetric problems: the unit point for every cone
            z0, s0 = cone_ops.unit_initialization(layout, dtype, B, q.device)
            return zero_n, z0, s0, one, one.clone()
        zero_m = torch.zeros_like(b)
        state0 = cone_ops.set_identity_scaling(layout, dtype, B, q.device)
        _, solve_xz, _ = make_kkt(P, A, state0, factor_dtype, signs)
        if p_nonzero:
            # QP initialization
            x0, z0, _ = solve_xz(-q, b)
            s0 = -z0
        else:
            # LP initialization
            x0, ms, _ = solve_xz(zero_n, b)
            s0 = -ms
            _, z0, _ = solve_xz(-q, zero_m)
        s0 = shift_to_cone_interior(s0, "primal")
        z0 = shift_to_cone_interior(z0, "dual")
        return x0, z0, s0, one, one.clone()

    def calc_step_length(dz, ds, dtau, dkappa, z, s, tau, kappa, state,
                         steptype):
        """reference: src/variables.jl:14-43 + solver_get_step_length"""
        big = torch.full_like(tau, _BIG)
        neg_one = -torch.ones_like(tau)
        a_tau = torch.where(dtau < 0,
                            -tau / torch.where(dtau < 0, dtau, neg_one), big)
        a_kappa = torch.where(
            dkappa < 0, -kappa / torch.where(dkappa < 0, dkappa, neg_one),
            big)
        amax = torch.clamp_max(torch.minimum(a_tau, a_kappa), 1.0)
        alpha = cone_ops.step_length(layout, state, dz, ds, z, s, amax,
                                     settings)
        if steptype == "combined":
            alpha = alpha * settings.max_step_fraction
        return alpha

    def barrier_fn(z, s, tau, kappa, dz, ds, dtau, dkappa, state, alpha):
        """reference: src/variables.jl:46-72"""
        central_coef = degree + 1
        cur_tau = tau + alpha * dtau
        cur_kappa = kappa + alpha * dkappa
        a = alpha[:, None]
        sz = so.vdot(z + a * dz, s + a * ds)
        mu = (sz + cur_tau * cur_kappa) / central_coef
        barrier = (central_coef * cone_ops._logsafe(mu)
                   - cone_ops._logsafe(cur_tau)
                   - cone_ops._logsafe(cur_kappa))
        return barrier + cone_ops.compute_barrier(layout, state, z, s, dz,
                                                  ds, alpha)

    def factor_dtype_of(device):
        """The factors' dtype on a device: float32 fronts on a card where
        the reference takes them off a CPU, else settings.factor_dtype."""
        return ("float32" if mf_float32 and device.type == "cuda"
                else settings.factor_dtype)

    def prepare(P, q, A, b):
        """Equilibration and the initial point: (data, initial carry)."""
        factor_dtype = factor_dtype_of(q.device)
        counts["factor_dtype"] = factor_dtype
        P, q, A, b = (t.to(dtype) for t in (P, q, A, b))
        device = q.device
        signs = torch.cat([torch.ones(n, dtype=dtype, device=device),
                           -torch.ones(m, dtype=dtype, device=device)])

        # -- equilibration (reference: src/problemdata.jl:133-221)
        P, A, q, b, equil = ruiz_equilibrate(layout, settings, P, A, q, b)
        normq = (equil.dinv * q).abs().amax(dim=1) / equil.c
        normb = (equil.einv * b).abs().amax(dim=1)

        # -- initial point
        x0, z0, s0, tau0, kappa0 = default_start(P, q, A, b, signs,
                                                 factor_dtype)

        B = q.shape[0]

        def full(v):
            return torch.full((B,), v, dtype=dtype, device=device)

        def ints(v):
            return torch.full((B,), v, dtype=torch.int32, device=device)

        carry0 = Carry(
            x=x0, z=z0, s=s0, tau=tau0, kappa=kappa0,
            px=x0, pz=z0, ps=s0, ptau=tau0, pkappa=kappa0,
            prev_res_primal=full(_BIG), prev_res_dual=full(_BIG),
            prev_gap_abs=full(_BIG), prev_gap_rel=full(_BIG),
            mu=full(_BIG), alpha=full(0.0), sigma=full(1.0),
            iters=ints(0), status=ints(UNSOLVED), scaling=ints(scaling0),
        )
        return (P, q, A, b, equil, normq, normb, signs), carry0

    def loop_body(data, carry: Carry, factor_dtype) -> Carry:
        P, q, A, b, equil, normq, normb, signs = data
        x, z, s, tau, kappa = carry.x, carry.z, carry.s, carry.tau, carry.kappa

        # -------- top-of-loop: residuals, info, termination --------
        res = compute_residuals(P, q, A, b, x, z, s, tau, kappa)
        mu = (res.dot_sz + tau * kappa) / (degree + 1)
        info = compute_info(res, x, z, s, tau, kappa, equil, normq, normb)
        if settings.verbose:
            # one row per lane and pass, as jax.debug.print under the
            # reference's vmap prints it: a host sync that only verbose
            # runs pay
            print_iterations(carry.iters, info, mu, carry.alpha)

        full_tols = (
            settings.tol_gap_abs, settings.tol_gap_rel, settings.tol_feas,
            settings.tol_infeas_abs, settings.tol_infeas_rel,
            settings.tol_ktratio,
            SOLVED, int(SolverStatus.PRIMAL_INFEASIBLE),
            int(SolverStatus.DUAL_INFEASIBLE),
        )
        status = check_convergence(info, res, full_tols)

        # poor progress checks (reference: src/info.jl:79-104)
        going_backwards = ((info.res_dual > carry.prev_res_dual)
                           | (info.res_primal > carry.prev_res_primal))
        stall_ratio = settings.stall_detection_ratio
        stagnating = ((info.res_dual > stall_ratio * carry.prev_res_dual)
                      | (info.res_primal
                         > stall_ratio * carry.prev_res_primal))
        after_first = (status == UNSOLVED) & (carry.iters > 1)
        cond_progress = after_first & going_backwards
        cond_stall = after_first & stagnating
        poor_hi = ((info.ktratio < 100.0 * eps_T)
                   & ((carry.prev_gap_abs < settings.tol_gap_abs)
                      | (carry.prev_gap_rel < settings.tol_gap_rel)))
        diverging = (info.ktratio < 1.0) & (
            ((info.res_dual > 100.0 * settings.tol_feas)
             & (info.res_dual > 100.0 * carry.prev_res_dual))
            | ((info.res_primal > 100.0 * settings.tol_feas)
               & (info.res_primal > 100.0 * carry.prev_res_primal)))
        insuff = (cond_stall & poor_hi) | (cond_progress & diverging)
        status = torch.where(insuff, INSUFFICIENT_PROGRESS, status)

        # iteration limit (reference: src/info.jl:109-116)
        status = torch.where(
            (status == UNSOLVED) & (carry.iters >= settings.max_iter),
            MAX_ITERATIONS, status).to(torch.int32)

        # insufficient-progress checkpoint (reference: src/solver.jl:453-472):
        # roll back to the previous iterate; a nonsymmetric layout's
        # PrimalDual lane downgrades to Dual and continues (it skips this
        # pass).  Symmetric cones never downgrade.
        restore = status == INSUFFICIENT_PROGRESS
        x = _select(restore, carry.px, x)
        z = _select(restore, carry.pz, z)
        s = _select(restore, carry.ps, s)
        tau = _select(restore, carry.ptau, tau)
        kappa = _select(restore, carry.pkappa, kappa)
        scaling = carry.scaling
        if is_symmetric:
            done_or_restart = status != UNSOLVED
        else:
            downgraded_ip = restore & (scaling == PRIMAL_DUAL)
            status = torch.where(downgraded_ip, UNSOLVED,
                                 status).to(torch.int32)
            scaling = torch.where(downgraded_ip, DUAL,
                                  scaling).to(torch.int32)
            done_or_restart = (status != UNSOLVED) | downgraded_ip

        skipped = carry._replace(x=x, z=z, s=s, tau=tau, kappa=kappa,
                                 mu=mu, status=status, scaling=scaling)

        # -------- phase B: scaling, KKT, predictor-corrector --------
        state, ok_scale = cone_ops.update_scaling(layout, None, s, z, mu,
                                                  scaling)
        iters = carry.iters + 1

        ok_factor, solve_xz, solve_xz2 = make_kkt(P, A, state, factor_dtype,
                                                  signs)
        ok_kkt = ok_factor & ok_scale

        # fused two-RHS solve: the constant part [-q; b] -> (x2, z2)
        # (reference: src/kktsystem.jl:80-92) with the affine step's solve
        aff_ds = cone_ops.affine_ds(layout, state, s)
        x2, z2, x1a, z1a, ok1 = solve_xz2(-q, b, res.rx, s - res.rz)
        ok_kkt = ok_kkt & ok1

        def tau_recovery(x1, z1, ds_const, rhs_tau, rhs_kappa):
            """Stages 2-3 of the 3-stage solve: two-solve τ recovery.
            reference: src/kktsystem.jl:135-215"""
            xi = x / tau[:, None]
            tau_num = (rhs_tau - rhs_kappa / tau
                       + so.vdot(q, x1) + so.vdot(b, z1)
                       + 2.0 * so.vdot(xi, matops.mv(P, x1)))
            xi_m_x2 = xi - x2
            tau_den = (kappa / tau - so.vdot(q, x2) - so.vdot(b, z2)
                       + so.vdot(xi_m_x2, matops.mv(P, xi_m_x2))
                       - so.vdot(x2, matops.mv(P, x2)))
            dtau = tau_num / tau_den
            dx = x1 + dtau[:, None] * x2
            dz = z1 + dtau[:, None] * z2
            ds = -(cone_ops.mul_Hs(layout, state, dz) + ds_const)
            dkappa = -(rhs_kappa + kappa * dtau) / tau
            return dx, dz, ds, dtau, dkappa

        # affine step (reference: src/variables.jl:107-121)
        dxa, dza, dsa, dtaua, dkappaa = tau_recovery(
            x1a, z1a, s, res.rtau, tau * kappa)

        alpha_aff = calc_step_length(dza, dsa, dtaua, dkappaa, z, s, tau,
                                     kappa, state, "affine")
        sigma = (1.0 - alpha_aff) ** 3

        # reduced Mehrotra correction on iteration 1
        # (reference: src/solver.jl:305-314)
        m_corr = torch.where(iters > 1, torch.ones_like(alpha_aff), alpha_aff)

        # combined step rhs (reference: src/variables.jl:124-162)
        sigma_mu = sigma * mu
        shift = cone_ops.combined_ds_shift(
            layout, state, m_corr[:, None] * dza, dsa, sigma_mu, z)
        comb_s = aff_ds + shift
        comb_x = (1.0 - sigma)[:, None] * res.rx
        comb_z = (1.0 - sigma)[:, None] * res.rz
        comb_tau = (1.0 - sigma) * res.rtau
        comb_kappa = -sigma_mu + m_corr * dtaua * dkappaa + tau * kappa

        ds_const = cone_ops.ds_from_dz_offset(layout, state, comb_s, z)
        x1, z1, ok3 = solve_xz(comb_x, ds_const - comb_z)
        dx, dz, ds, dtau, dkappa = tau_recovery(x1, z1, ds_const, comb_tau,
                                                comb_kappa)
        ok_kkt = ok_kkt & ok3

        # numerical-error checkpoint (reference: src/solver.jl:475-489): a
        # failed KKT is an error, except on a nonsymmetric layout's
        # PrimalDual lane, which downgrades to Dual
        kkt_fail = ~ok_kkt
        new_scaling = scaling
        if is_symmetric:
            fail_status = torch.where(kkt_fail, NUMERICAL_ERROR, UNSOLVED)
        else:
            can_downgrade = scaling == PRIMAL_DUAL
            new_scaling = torch.where(kkt_fail & can_downgrade, DUAL,
                                      scaling)
            fail_status = torch.where(kkt_fail & ~can_downgrade,
                                      NUMERICAL_ERROR, UNSOLVED)

        # final step length
        alpha = calc_step_length(dz, ds, dtau, dkappa, z, s, tau, kappa,
                                 state, "combined")

        # small-step checkpoint (reference: src/solver.jl:492-505)
        min_term = max(0.0, settings.min_terminate_step_length)
        if is_symmetric:
            small_terminate = alpha <= min_term
            take_step = ~kkt_fail & ~small_terminate
        else:
            # extra barrier backtrack on the Dual lanes (reference:
            # src/solver.jl:416-419)
            on_dual = scaling == DUAL
            alpha_bt = backtrack_to_barrier(
                lambda a: barrier_fn(z, s, tau, kappa, dz, ds, dtau, dkappa,
                                     state, a),
                alpha, on_dual, settings.linesearch_backtrack_step,
                settings.linesearch_max_iter)
            alpha = torch.where(on_dual, alpha_bt, alpha)
            # a PrimalDual lane with a short step switches to Dual
            small_switch = can_downgrade & (
                alpha < settings.min_switch_step_length)
            small_terminate = ~small_switch & (alpha <= min_term)
            new_scaling = torch.where(~kkt_fail & small_switch, DUAL,
                                      new_scaling)
            take_step = ~kkt_fail & ~small_switch & ~small_terminate
        new_scaling = new_scaling.to(torch.int32)
        fail_status = torch.where(
            (fail_status == UNSOLVED) & ~kkt_fail & small_terminate,
            INSUFFICIENT_PROGRESS, fail_status).to(torch.int32)

        alpha_eff = torch.where(take_step, alpha, torch.zeros_like(alpha))
        a = alpha_eff[:, None]

        # save the previous iterate before stepping
        # (reference: src/solver.jl:346-349)
        stepped = Carry(
            x=_select(take_step, x + a * dx, x),
            z=_select(take_step, z + a * dz, z),
            s=_select(take_step, s + a * ds, s),
            tau=_select(take_step, tau + alpha_eff * dtau, tau),
            kappa=_select(take_step, kappa + alpha_eff * dkappa, kappa),
            px=_select(take_step, x, carry.px),
            pz=_select(take_step, z, carry.pz),
            ps=_select(take_step, s, carry.ps),
            ptau=_select(take_step, tau, carry.ptau),
            pkappa=_select(take_step, kappa, carry.pkappa),
            prev_res_primal=_select(take_step, info.res_primal,
                                    carry.prev_res_primal),
            prev_res_dual=_select(take_step, info.res_dual,
                                  carry.prev_res_dual),
            prev_gap_abs=_select(take_step, info.gap_abs, carry.prev_gap_abs),
            prev_gap_rel=_select(take_step, info.gap_rel, carry.prev_gap_rel),
            mu=mu, alpha=alpha_eff, sigma=sigma,
            iters=iters, status=fail_status, scaling=new_scaling,
        )
        return _select_tuple(done_or_restart, skipped, stepped)

    def run_loop(data, carry: Carry, extra_cond, factor_dtype,
                 cap) -> Carry:
        """The IPM while-loop over the batch: each pass runs the body for
        every lane and keeps it only on the lanes whose loop condition
        holds (UNSOLVED, fewer than `cap` iterations, and `extra_cond`);
        the loop ends when it holds on none.  On a card, where the
        layout's cones allow it (`GRAPH_KINDS`) and, for a zero/nn/SOC
        layout, the batch has at most GRAPH_MAX_LANES lanes, the first
        pass runs as it is and the rest replay it as a CUDA graph
        (`_replay`), which reads `cap`, a device scalar, as it replays."""

        def active_of(c):
            active = (c.status == UNSOLVED) & (c.iters < cap)
            if extra_cond is not None:
                active = active & extra_cond(c)
            return active

        def step(c):
            return _select_tuple(active_of(c),
                                 loop_body(data, c, factor_dtype), c)

        if not bool(active_of(carry).any()):
            return carry
        carry = step(carry)
        if (graphed and carry.x.device.type == "cuda"
                and (not is_symmetric or carry.x.shape[0] <= GRAPH_MAX_LANES)):
            return _replay(step, active_of, carry, counts)
        while bool(active_of(carry).any()):
            carry = step(carry)
        return carry

    def run_phases(data, carry0: Carry, iter_cap=None) -> Carry:
        """Run the IPM loop(s) until every lane terminates or reaches
        `iter_cap` iterations (None: no cap).  The cap is a device scalar
        that the loop condition reads, so a chunk of a long solve runs the
        same passes as the one-shot solve (reference loop.py:563-579).  A
        chunk may end inside the float32 phase of mixed precision; the
        next one then starts there again while mu > mu_switch, as the
        reference's does."""
        factor_dtype = factor_dtype_of(carry0.x.device)
        cap = torch.as_tensor(2 ** 30 if iter_cap is None else iter_cap,
                              dtype=torch.int32, device=carry0.iters.device)
        if settings.mixed_precision:
            # two-phase precision schedule: factor in f32 while the barrier
            # parameter is large, then at factor_dtype for the final
            # iterations, where cond(KKT) ~ 1/μ² exceeds the f32 range
            mu_switch = settings.mixed_precision_mu_switch
            mid = run_loop(data, carry0, lambda c: c.mu > mu_switch,
                           "float32", cap)
            return run_loop(data, mid, None, factor_dtype, cap)
        return run_loop(data, carry0, None, factor_dtype, cap)

    def finalize(data, final: Carry):
        """Post-processing: almost-checks, unscaling, certificates."""
        P, q, A, b, equil, normq, normb, _ = data

        # ---- post-processing (reference: src/solver.jl:366-370) ----
        res = compute_residuals(P, q, A, b, final.x, final.z, final.s,
                                final.tau, final.kappa)
        info = compute_info(res, final.x, final.z, final.s, final.tau,
                            final.kappa, equil, normq, normb)

        # "almost" convergence checks at reduced tolerances
        # (reference: src/info.jl:198-214, 252-271)
        reduced_tols = (
            settings.reduced_tol_gap_abs, settings.reduced_tol_gap_rel,
            settings.reduced_tol_feas, settings.reduced_tol_infeas_abs,
            settings.reduced_tol_infeas_rel, settings.reduced_tol_ktratio,
            int(SolverStatus.ALMOST_SOLVED),
            int(SolverStatus.ALMOST_PRIMAL_INFEASIBLE),
            int(SolverStatus.ALMOST_DUAL_INFEASIBLE),
        )
        errored = ((final.status == NUMERICAL_ERROR)
                   | (final.status == INSUFFICIENT_PROGRESS)
                   | (final.status == MAX_ITERATIONS)
                   | (final.status == int(SolverStatus.MAX_TIME)))
        almost_status = check_convergence(info, res, reduced_tols)
        status = torch.where(errored & (almost_status != UNSOLVED),
                             almost_status, final.status).to(torch.int32)

        # unscale variables (reference: src/variables.jl:247-275)
        is_infeasible = torch.isin(status, torch.tensor([
            int(SolverStatus.PRIMAL_INFEASIBLE),
            int(SolverStatus.DUAL_INFEASIBLE),
            int(SolverStatus.ALMOST_PRIMAL_INFEASIBLE),
            int(SolverStatus.ALMOST_DUAL_INFEASIBLE)], dtype=status.dtype,
            device=status.device))
        scaleinv = torch.where(is_infeasible, 1.0 / final.kappa,
                               1.0 / final.tau)
        cinv = 1.0 / equil.c
        x_out = final.x * equil.d * scaleinv[:, None]
        z_out = final.z * equil.e * (scaleinv * cinv)[:, None]
        s_out = final.s * equil.einv * scaleinv[:, None]

        nan = torch.full_like(info.cost_primal, float("nan"))
        obj_val = torch.where(is_infeasible, nan, info.cost_primal)
        obj_val_dual = torch.where(is_infeasible, nan, info.cost_dual)

        return {
            "x": x_out,
            "z": z_out,
            "s": s_out,
            "status": status,
            "obj_val": obj_val,
            "obj_val_dual": obj_val_dual,
            "iterations": final.iters,
            "r_prim": info.res_primal,
            "r_dual": info.res_dual,
            "gap_abs": info.gap_abs,
            "gap_rel": info.gap_rel,
            "mu": final.mu,
            "step_length": final.alpha,
            "sigma": final.sigma,
            "ktratio": info.ktratio,
            "tau": final.tau * scaleinv,
            "kappa": final.kappa * scaleinv,
            # the final scaling strategy (PRIMAL_DUAL or DUAL), a
            # diagnostic the reference does not return
            "scaling": final.scaling,
        }

    def solve(P, q, A, b):
        data, carry0 = prepare(P, q, A, b)
        return finalize(data, run_phases(data, carry0))

    # timing probes (the Solver's print_timers): slices of one IPM
    # iteration at a given state (reference loop.py:955-981)
    def probe_scaling(data, carry: Carry):
        """The cone scaling update only."""
        return cone_ops.update_scaling(layout, None, carry.s, carry.z,
                                       carry.mu, carry.scaling)

    def probe_step(data, carry: Carry):
        """Scaling, KKT factor and the fused 2-RHS solve: the
        per-iteration linear algebra.  It is not counted among the solves'
        factorizations."""
        P, q, A, b, _, _, _, signs = data
        state, _ = cone_ops.update_scaling(layout, None, carry.s, carry.z,
                                           carry.mu, carry.scaling)
        before = counts["factorizations"]
        ok, _, solve_xz2 = make_kkt(P, A, state,
                                    factor_dtype_of(carry.x.device), signs)
        counts["factorizations"] = before
        res = compute_residuals(P, q, A, b, carry.x, carry.z, carry.s,
                                carry.tau, carry.kappa)
        x2, z2, x1, z1, ok1 = solve_xz2(-q, b, res.rx, carry.s - res.rz)
        return x2, z2, x1, z1, ok & ok1

    # what the solves did, for the smoke run's readings: the KKT
    # factorizations run (all lanes' at once, one a pass; a replayed pass
    # counts as it runs), the passes replayed as a CUDA graph and the last
    # solve's factor dtype
    counts = {"factorizations": 0, "replays": 0, "factor_dtype": None}
    solve.counts = counts
    solve.graphed = graphed
    # the stages of a solve, for chunked, resumed and timed solves
    # (reference loop.py:983-988)
    solve.prepare = prepare
    solve.run_phases = run_phases
    solve.finalize = finalize
    solve.probe_scaling = probe_scaling
    solve.probe_step = probe_step
    return solve
