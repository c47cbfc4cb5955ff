"""Iterative refinement around any KKT apply function, masked per lane.

A port of `clarabel_tpu/kkt/refine.py` (the reference's loop:
kktsolver_directldl.jl:389-449): residual stop-ratio test,
accept-or-rollback, and the abstol + reltol·‖b‖ target.  Under the
reference's `vmap` the while-loop runs until no lane is active and a lane
that is done keeps its carry; here every pass computes all lanes and
`torch.where` keeps the carry of the lanes that are not active, so each lane
gets what a loop run for it alone gives.  The dense and condensed backends
use the same masked loop (their unrolled accept-masked passes are the same
function).  Whether norme stays finite needs no check of its own: a lane's
ok starts as "the first residual is finite" and a pass is accepted only
with a finite residual.
"""

import torch

from ..trips import run_trips


def _lanes(mask, like):
    """(B,) mask viewed to broadcast against `like` (B, ...)."""
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def _inf_norm(v):
    """Per-lane max |v| over every non-lane axis."""
    return v.abs().flatten(1).amax(dim=1)


def refine(apply_fn, kkt_mv, rhs, x, abstol, reltol, stop_ratio, max_iter):
    """Refine x ≈ K⁻¹ rhs: at most `max_iter` passes of x += apply_fn(e),
    e = rhs − kkt_mv(x), each pass accepted per lane unless it stalls.
    A lane that is done keeps its carry through later passes, so the host
    checks for active lanes once every `trips.TRIPS_PER_CHECK` passes.
    Returns (x, ok), per lane."""
    normb = _inf_norm(rhs)
    e = rhs - kkt_mv(x)
    norme = _inf_norm(e)
    ok = torch.isfinite(norme)
    done = torch.zeros_like(ok)
    target = abstol + reltol * normb
    tiny = torch.finfo(norme.dtype).tiny

    def active(c):
        _, _, norme, ok, done = c
        return ~done & ok & (norme > target)

    def trip(c):
        x, e, norme, ok, done = c
        act = active(c)
        xnew = x + apply_fn(e)
        enew = rhs - kkt_mv(xnew)
        nn = _inf_norm(enew)
        okn = torch.isfinite(nn)
        ratio = norme / torch.where(nn != 0, nn, torch.full_like(nn, tiny))
        stop = ratio < stop_ratio
        accept = okn & (~stop | (ratio > 1.0)) & act
        done = torch.where(act, stop | ~okn, done)
        ok = torch.where(act, ok & okn, ok)
        x = torch.where(_lanes(accept, x), xnew, x)
        e = torch.where(_lanes(accept, e), enew, e)
        norme = torch.where(accept, nn, norme)
        return x, e, norme, ok, done

    x, _, _, ok, _ = run_trips(trip, (x, e, norme, ok, done),
                               lambda c: ~active(c).any(), max_iter)
    return x, ok


def solve_refined(apply_fn, kkt_mv, rhs, settings):
    """x ≈ K⁻¹ rhs via apply_fn, refined against kkt_mv with the settings'
    tolerances.  Returns (x, ok)."""
    return refine(apply_fn, kkt_mv, rhs, apply_fn(rhs),
                  settings.iterative_refinement_abstol,
                  settings.iterative_refinement_reltol,
                  settings.iterative_refinement_stop_ratio,
                  settings.iterative_refinement_max_iter)
