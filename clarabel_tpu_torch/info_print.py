"""The console report of `Settings(verbose=True)`: the iteration rows, and
the single-instance `Solver`'s banner, configuration, header and footer.

A port of the row that `clarabel_tpu/info_print.py` `debug_print_iteration`
prints from inside the reference's loop body.  The reference batches its
loop with `jax.vmap`, under which `jax.debug.print` prints one row per lane
on every pass of the batched while-loop, lane by lane, finished lanes
included (their carry is frozen).  The port's batched loop prints the same
rows in the same order.  Each call reads the values to the host: a sync
that only verbose runs pay.
"""

ROW = ("{i:4d}  {pc: .4e}  {dc: .4e}  {ga:.2e}  {pr:.2e}  {dr:.2e}  "
       "{kt:.2e}  {mu:.2e}  {st:.2e}")


def print_iterations(iters, info, mu, alpha):
    """One row per lane: iteration, primal and dual cost, relative gap,
    primal and dual residual, κ/τ, μ and the last step length."""
    cols = [t.tolist() for t in (iters, info.cost_primal, info.cost_dual,
                                 info.gap_rel, info.res_primal,
                                 info.res_dual, info.ktratio, mu, alpha)]
    for i, pc, dc, ga, pr, dr, kt, m, st in zip(*cols):
        print(ROW.format(i=i, pc=pc, dc=dc, ga=ga, pr=pr, dr=dr, kt=kt,
                         mu=m, st=st))


# ---- the single-instance Solver's console report (reference:
# clarabel_tpu/info_print.py:10-85) ----

def print_banner():
    from . import __version__

    print("-------------------------------------------------------------")
    print(f"        clarabel_tpu_torch v{__version__}  -  conic IPM on CUDA")
    print("                (c) clarabel_tpu developers")
    print("-------------------------------------------------------------")


def print_configuration(solver):
    counts = {}
    for c in solver.layout.cones:
        counts[type(c).__name__] = counts.get(type(c).__name__, 0) + 1
    print(f"problem:\n  variables     = {solver.n}")
    print(f"  constraints   = {solver.m}")
    print("  cones (total) = " + str(len(solver.layout.cones)))
    for name, cnt in sorted(counts.items()):
        print(f"    : {name} = {cnt}")
    s = solver.settings
    print(
        f"settings:\n  dtype = {s.dtype}, "
        f"factor dtype = {s.factor_dtype or 'auto'}\n"
        f"  max iter = {s.max_iter}, tol_gap = {s.tol_gap_abs:g}, "
        f"tol_feas = {s.tol_feas:g}\n"
        f"  static reg = {s.static_regularization_enable} "
        f"({s.static_regularization_constant:g}), "
        f"dynamic reg = {s.dynamic_regularization_enable} "
        f"({s.dynamic_regularization_eps:g}, "
        f"{s.dynamic_regularization_delta:g})\n"
        f"  iter refine = {s.iterative_refinement_enable} "
        f"(reltol {s.iterative_refinement_reltol:g}), "
        f"equilibrate = {s.equilibrate_enable} "
        f"({s.equilibrate_max_iter} iters)"
    )
    if solver.presolver is not None:
        print(
            f"presolve: reduced rows {solver.presolver.m_full} -> "
            f"{solver.presolver.m_reduced}"
        )
    if solver.chordal_info is not None:
        npat = len(solver.chordal_info.spatterns)
        print(f"chordal decomposition: {npat} PSD cone(s) decomposed")


def print_status_header():
    print(
        "iter    pcost        dcost       gap       pres      dres      "
        "k/t        μ       step"
    )
    print(
        "-----------------------------------------------------------------"
        "-----------------------"
    )


def print_footer(solution):
    from .statuscodes import status_string

    print("-------------------------------------------------------------")
    print(
        f"terminated with status: {status_string(solution.status)}\n"
        f"solve time = {solution.solve_time:.3e}s, "
        f"iterations = {solution.iterations}, "
        f"objective = {solution.obj_val:.9g}"
    )
