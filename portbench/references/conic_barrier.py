"""Plain reference: a primal log-barrier method for batched conic QPs.

    minimize 1/2 x'Px + q'x   subject to   s = b - A x in K,
    K = a product of nonnegative orthants and second-order cones,

in plain PyTorch, batched over a leading lane axis.  It shares no code,
algorithm or data with the program under test: it follows the central
path with a barrier method (Boyd and Vandenberghe, Convex Optimization,
section 11.3), where the program runs a primal-dual interior-point method
with its own equilibration, scaling and KKT solves.  It needs a strictly
feasible start and takes x = 0, so s = b has to lie inside K (the bench
family's b does); a batch where it does not raises.

For t = 1, 10, 100, ... it minimises F_t(x) = t f(x) + phi(b - A x) by
damped Newton steps, with phi = -sum log s_i over the nonnegative rows and
-log(s_0^2 - |s_1|^2) over each cone.  The centre x(t) is at most nu/t
above the optimum, nu = (nonnegative rows) + 2 (cones); the last stage has
nu/t below `gap` (1e-13 by default).  Each Newton step solves
(t P + A' D A) dx = -grad by Cholesky; the step length is the largest of
1, 1/2, 1/4, ... that keeps s inside K and decreases F_t by at least a
quarter of what the linear model predicts.  Differences of F_t are formed
directly (log1p of the slack ratios, the quadratic's exact increment), so
that a stage at t = 1e13 still sees its decrease in float64.

`mode` sets the arithmetic: "float64"; "float32"; "tf32", float32 with the
inputs of every product rounded to TF32's 10 mantissa bits, as a card
computes a float32 matmul when TF32 is allowed.  The two lower precisions
are the controls of `correct` (see `portbench/judge.py`).

`infeasibility` is the judge's measure of how far an answer lies outside
the cones, for this family.
"""

import math

import numpy as np
import torch

STEPS = 2.0 ** -torch.arange(40, dtype=torch.float64)   # 1, 1/2, ..., 2^-39


def tf32_round(t):
    """float32 -> the nearest value with a 10-bit mantissa (ties to even)."""
    bits = t.contiguous().view(torch.int32)
    keep = bits + 0x0FFF + ((bits >> 13) & 1)
    return (keep & ~0x1FFF).view(torch.float32)


class _Arith:
    def __init__(self, mode):
        if mode not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown mode {mode!r}")
        self.dtype = torch.float64 if mode == "float64" else torch.float32
        self.tf32 = mode == "tf32"

    def mm(self, a, b):
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def mv(self, a, x):
        return self.mm(a, x.unsqueeze(-1)).squeeze(-1)


def _segments(cones, m):
    segs, lo = [], 0
    for kind, dim in cones:
        if kind not in ("nn", "soc"):
            raise ValueError(f"the reference takes nn and soc cones, not "
                             f"{kind!r}")
        segs.append((kind, lo, lo + dim))
        lo += dim
    if lo != m:
        raise ValueError(f"cones cover {lo} rows, A has {m}")
    return segs


def infeasibility(A, b, x, cones):
    """How far s = b - A x lies outside K, lane by lane, over
    max(1, |b|_inf): the most negative nonnegative row and |s_1| - s_0 of
    each second-order cone, the worst of them, 0 inside.  Numpy arrays
    A (B, m, n), b (B, m), x (B, n) in; (B,) out."""
    s = b - np.einsum("bij,bj->bi", A, x)
    worst = np.zeros(len(s))
    for kind, lo, hi in _segments(cones, s.shape[1]):
        v = s[:, lo:hi]
        if kind == "nn":
            worst = np.maximum(worst, -v.min(axis=1))
        else:
            worst = np.maximum(worst,
                               np.linalg.norm(v[:, 1:], axis=1) - v[:, 0])
    return worst / np.maximum(1.0, np.abs(b).max(axis=1))


def _barrier_parts(s, segs):
    """(gradient of phi in s, Hessian of phi in s (B, m, m))."""
    B, m = s.shape
    g = torch.zeros_like(s)
    H = torch.zeros(B, m, m, dtype=s.dtype, device=s.device)
    for kind, lo, hi in segs:
        v = s[:, lo:hi]
        if kind == "nn":
            g[:, lo:hi] = -1.0 / v
            idx = torch.arange(lo, hi, device=s.device)
            H[:, idx, idx] = 1.0 / (v * v)
        else:
            Jv = torch.cat([v[:, :1], -v[:, 1:]], dim=1)
            norm1 = v[:, 1:].norm(dim=1)
            delta = (v[:, 0] - norm1) * (v[:, 0] + norm1)
            g[:, lo:hi] = -2.0 * Jv / delta[:, None]
            J = torch.ones(hi - lo, dtype=s.dtype, device=s.device)
            J[1:] = -1.0
            H[:, lo:hi, lo:hi] = (
                -2.0 * torch.diag(J) / delta[:, None, None]
                + 4.0 * Jv[:, :, None] * Jv[:, None, :]
                / (delta * delta)[:, None, None])
    return g, H


def _inside(s, segs):
    """Whether each slack (..., m) lies strictly inside K."""
    ok = torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device)
    for kind, lo, hi in segs:
        v = s[..., lo:hi]
        if kind == "nn":
            ok &= (v > 0).all(-1)
        else:
            ok &= v[..., 0] > v[..., 1:].norm(dim=-1)
    return ok


def _barrier_change(s, ds, alphas, segs):
    """phi(s + a ds) - phi(s) for each step a: (B, K), +inf outside K."""
    a = alphas[None, :, None]
    out = torch.zeros(s.shape[0], alphas.shape[0], dtype=s.dtype,
                      device=s.device)
    for kind, lo, hi in segs:
        v, dv = s[:, None, lo:hi], ds[:, None, lo:hi]
        if kind == "nn":
            ratio = a * dv / v                                 # (B, K, k)
            bad = (ratio <= -1).any(-1)
            out -= torch.log1p(ratio.clamp_min(-0.5)).sum(-1)
            out[bad] = math.inf
        else:
            v0, v1 = v[..., 0], v[..., 1:]
            d0, d1 = dv[..., 0], dv[..., 1:]
            norm1 = v1.norm(dim=-1)
            delta = (v0 - norm1) * (v0 + norm1)
            lin = 2.0 * (v0 * d0 - (v1 * d1).sum(-1))
            quad = d0 * d0 - (d1 * d1).sum(-1)
            a2 = a[..., 0]
            ratio = (a2 * lin + a2 * a2 * quad) / delta
            new0 = v0 + a2 * d0
            bad = (ratio <= -1) | (new0 <= 0)
            out -= torch.log1p(ratio.clamp_min(-0.5))
            out[bad] = math.inf
    return out


def solve(P, q, A, b, cones, mode="float64", gap=1e-13, t0=1.0, mu=10.0,
          newton_tol=1e-12, max_newton=60):
    """Solve every lane.  P (B, n, n) symmetric, q (B, n), A (B, m, n),
    b (B, m) as torch tensors (any device), `cones` a list of ("nn", k) and
    ("soc", d) in row order.  Returns (x, f, ok) in float64: the last
    iterate, its objective 1/2 x'Px + q'x and whether every stage ended
    with the Newton decrement below `newton_tol` * t, so each centre within
    newton_tol/2 of F_t's minimum in the objective's units (float64 runs;
    a lane stops a stage early where its iterate no longer changes, as the
    controls do where their precision ends, or where no step decreases
    F_t or the factorization fails)."""
    ar = _Arith(mode)
    dt = ar.dtype
    P, q, A, b = (t.to(dt) for t in (P, q, A, b))
    B, m, n = A.shape
    segs = _segments(cones, m)
    nu = sum(hi - lo if k == "nn" else 2 for k, lo, hi in segs)
    x = torch.zeros(B, n, dtype=dt, device=A.device)
    s = b.clone()
    if not bool(_inside(s, segs).all()):
        raise ValueError("s = b is not inside the cones: the reference "
                         "starts from x = 0 and needs it strictly feasible")
    ok = torch.ones(B, dtype=torch.bool, device=A.device)
    alive = torch.ones(B, dtype=torch.bool, device=A.device)
    At = A.transpose(1, 2)
    alphas = STEPS.to(device=A.device, dtype=dt)
    t = t0
    while True:
        converged = torch.zeros(B, dtype=torch.bool, device=A.device)
        stuck = torch.zeros(B, dtype=torch.bool, device=A.device)
        for _ in range(max_newton):
            gs, Hs = _barrier_parts(s, segs)
            Px = ar.mv(P, x)
            grad = t * (Px + q) - ar.mv(At, gs)
            H = t * P + ar.mm(ar.mm(At, Hs), A)
            L, info = torch.linalg.cholesky_ex(H)
            dx = -torch.cholesky_solve(grad.unsqueeze(-1), L).squeeze(-1)
            dec = -(grad * dx).sum(-1)
            good = (info == 0) & torch.isfinite(dec) & (dec >= 0)
            alive &= good
            converged |= alive & (dec <= newton_tol * t)
            step = alive & ~converged & ~stuck
            if not bool(step.any()):
                break
            ds = -ar.mv(A, dx)
            # F_t(x + a dx) - F_t(x), exactly: t (a g'dx + a^2/2 dx'Pdx)
            # + phi's change
            gdx = ((Px + q) * dx).sum(-1)
            dPd = (ar.mv(P, dx) * dx).sum(-1)
            df = t * (alphas[None, :] * gdx[:, None]
                      + 0.5 * alphas[None, :] ** 2 * dPd[:, None])
            dF = df + _barrier_change(s, ds, alphas, segs)
            # each trial point's slack as the next step will compute it,
            # which has to lie inside K in this precision
            x_try = x[:, None, :] + alphas[None, :, None] * dx[:, None, :]
            s_try = b[:, None, :] - ar.mm(x_try, At)
            accept = ((dF <= -0.25 * alphas[None, :] * dec[:, None])
                      & _inside(s_try, segs))
            first = torch.where(accept.any(1), accept.int().argmax(1),
                                torch.full_like(dec, -1, dtype=torch.long))
            a = alphas[first.clamp_min(0)]
            new = torch.where((step & (first >= 0))[:, None],
                              x + a[:, None] * dx, x)
            # a lane whose iterate no longer changes has reached the
            # precision's floor: it stops for this stage
            stuck |= step & (new == x).all(-1)
            x = new
            s = b - ar.mv(A, x)
        ok &= converged
        if nu / t <= gap:
            break
        t *= mu
    x64 = x.to(torch.float64)
    P64, q64 = P.to(torch.float64), q.to(torch.float64)
    f = 0.5 * (torch.matmul(P64, x64.unsqueeze(-1)).squeeze(-1)
               * x64).sum(-1) + (q64 * x64).sum(-1)
    return x64, f, ok
