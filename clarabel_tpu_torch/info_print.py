"""The iteration log of `Settings(verbose=True)`.

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
