"""Exponential, power and generalized power cone operations, batched over a
leading lane axis.

A port of `clarabel_tpu/cones/nonsymmetric.py`: dual and primal-dual
(BFGS-style) scalings, third-order corrections, Wright-omega and
Newton-Raphson primal gradients, and the feasibility backtracking line
searches.  A group of c cones is a (B, c, 3) tensor, or (B, c, d1 + d2)
for generalized power cones, which have only the dual scaling (its Hessian
kept as μ(D + pp' − qq' − rr')) and no third-order correction.

The reference's data-dependent `lax.while_loop`s (the one-sided
Newton-Raphson and the backtracking search) run under `jax.vmap`: the loop
goes on while any lane is active and a finished cone keeps its value.
Here each is a loop over the whole batch that masks the update per cone
and runs while any cone of any lane is active, checked on the host once
every `trips.TRIPS_PER_CHECK` trips, or run to its cap inside a CUDA graph
(`trips.run_trips`).

Cone math provenance (the reference's reference):
* exponential cone — src/cones/coneops_expcone.jl
* power cone       — src/cones/coneops_powcone.jl
* gen. power cone  — src/cones/coneops_genpowcone.jl
* shared strategy  — src/cones/coneops_nonsymmetric_common.jl
"""

import math

import numpy as np
import torch

from .layout import ConeGroup, _gather, _on, _scatter
from ..linalg.smallops import chol3_solve
from ..trips import run_trips

# exp-cone unit initialization (reference: coneops_expcone.jl:36-52)
_EXP_UNIT = (-1.051383945322714, 0.556409619469370, 1.258967884768947)


def _logsafe(x):
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)),
                       -math.inf)


def _eps(dtype):
    return float(torch.finfo(dtype).eps)


def _alpha(g: ConeGroup, like):
    """The group's exponents as a tensor like `like`: (c,) for pow cones,
    (c, d1) for generalized power cones."""
    return _on(g, "alpha", np.asarray(g.alpha, dtype=np.float64),
               like.device).to(like.dtype)


def _stack3(a, b, c):
    return torch.stack([a, b, c], dim=-1)


def _sym3(h11, h12, h13, h22, h23, h33):
    return torch.stack([_stack3(h11, h12, h13), _stack3(h12, h22, h23),
                        _stack3(h13, h23, h33)], dim=-2)


# ---------------------------------------------------------------------------
# scalar numerical subroutines (elementwise over any shape)
# ---------------------------------------------------------------------------

def _wright_omega(z):
    """ω(z): the solution y of y + log(y) = z for z >= 1.  reference:
    coneops_expcone.jl:412-468 (Santiago Serrano, thesis alg. 4), with the
    z^-3 series term applied as the JAX package applies it."""
    # series initialization for z < 1 + π
    zm1 = z - 1.0
    p1 = zm1
    w_small = 1.0 + 0.5 * p1
    p2 = p1 * zm1
    w_small = w_small + (1.0 / 16.0) * p2
    p3 = p2 * zm1
    w_small = w_small - (1.0 / 192.0) * p3
    p4 = p3 * zm1
    w_small = w_small - (1.0 / 3072.0) * p4
    p5 = p4 * zm1
    w_small = w_small + (13.0 / 61440.0) * p5

    # asymptotic initialization for larger z
    z_big = torch.clamp_min(z, 1.0 + math.pi)
    logz = torch.log(z_big)
    zinv = 1.0 / z_big
    w_big = z_big - logz
    q = logz * zinv
    w_big = w_big + q
    q = q * zinv
    w_big = w_big + q * (logz / 2.0 - 1.0)
    q = q * zinv
    w_big = w_big + q * (logz * logz / 3.0 - 1.5 * logz + 1.0)

    w = torch.where(z < 1.0 + math.pi, w_small, w_big)

    # two Santiago refinement iterations
    r = z - w - torch.log(torch.clamp_min(w, 1e-300))
    for _ in range(2):
        wp1 = w + 1.0
        t = wp1 * (wp1 + (2.0 * r) / 3.0)
        w = w * (1.0 + (r / wp1) * (t - 0.5 * r) / (t - r))
        r = (2.0 * w * w - 8.0 * w - 1.0) / (72.0 * wp1 ** 6) * r ** 4
    return w


def _newton_raphson_onesided(x0, f0, f1, dtype):
    """One-sided Newton-Raphson from a start left of the root, elementwise
    with a per-element stop (reference: coneops_nonsymmetric_common.jl:
    170-193); at most 100 steps.  f0/f1 map x (shape of x0) to that
    shape."""
    eps = _eps(dtype)
    sqrt_eps = math.sqrt(eps)

    def trip(c):
        x, done = c
        dfdx = f1(x)
        dx = -f0(x) / torch.where(dfdx != 0, dfdx, 1.0)
        stop = ((dx < eps)
                | ((dx / torch.where(x != 0, x, 1.0)).abs() < sqrt_eps)
                | (dfdx.abs() < eps))
        return torch.where(done | stop, x, x + dx), done | stop

    done = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    x, _ = run_trips(trip, (x0, done), lambda c: c[1].all(), 100)
    return x


def _backtrack_trips(alpha_min, step):
    """The trips after which `_backtrack_search` has ended every lane.  A
    lane that starts at alpha_init <= 1 and fails every test holds
    alpha_init * step^k after k trips and ends once that is below
    alpha_min: by trip ceil(log(alpha_min) / log(step)), with one trip to
    spare for the rounding of the repeated products.  None (no cap, as in
    the reference) where alpha_min <= 0 or step is not in (0, 1)."""
    if not (alpha_min > 0 and 0 < step < 1):
        return None
    return math.ceil(math.log(alpha_min) / math.log(step)) + 1


def _backtrack_search(Q, dQ, feas_fcn, alpha_init, alpha_min, step):
    """Per-cone feasibility backtracking from alpha_init (B,), at most 1,
    min over the cones of each lane (reference: coneops_nonsymmetric_common
    .jl:5-34).  Q, dQ: (B, c, 3)."""

    def trip(c):
        a, done = c
        feas = feas_fcn(Q + a[..., None] * dQ)
        newdone = done | feas
        a = torch.where(newdone, a, a * step)
        killed = ~newdone & (a < alpha_min)
        return torch.where(killed, 0.0, a), newdone | killed

    a = alpha_init[:, None].expand(Q.shape[:2]).clone()
    done = torch.zeros(Q.shape[:2], dtype=torch.bool, device=Q.device)
    a, _ = run_trips(trip, (a, done), lambda c: c[1].all(),
                     _backtrack_trips(alpha_min, step))
    return a.amin(dim=1)


# ---------------------------------------------------------------------------
# exponential cone internals (reference: coneops_expcone.jl:213-399)
# ---------------------------------------------------------------------------

def _exp_is_primal_feasible(S):
    s1, s2, s3 = S.unbind(-1)
    ok = (s3 > 0) & (s2 > 0)
    res = s2 * _logsafe(s3 / torch.where(s2 > 0, s2, 1.0)) - s1
    return ok & (res > 0)


def _exp_is_dual_feasible(Z):
    z1, z2, z3 = Z.unbind(-1)
    ok = (z3 > 0) & (z1 < 0)
    zsafe = torch.where(z1 < 0, z1, -1.0)
    res = z2 - z1 - z1 * _logsafe(-z3 / zsafe)
    return ok & (res > 0)


def _exp_barrier_dual(Z):
    z1, z2, z3 = Z.unbind(-1)
    l = _logsafe(-z3 / torch.where(z1 != 0, z1, -1.0))
    return -_logsafe(-z3 * z1) - _logsafe(z2 - z1 - z1 * l)


def _exp_barrier_primal(S):
    s1, s2, s3 = S.unbind(-1)
    s2s = torch.where(s2 > 0, s2, 1.0)
    s3s = torch.where(s3 > 0, s3, 1.0)
    arg = 1.0 - s1 / s2s - _logsafe(s2s / s3s)
    w = _wright_omega(torch.clamp_min(arg, 0.0))
    w = (w - 1.0) ** 2 / torch.where(w != 0, w, 1.0)
    val = -_logsafe(w) - 2.0 * _logsafe(s2) - _logsafe(s3) - 3.0
    return torch.where(_exp_is_primal_feasible(S), val, math.inf)


def _exp_grad_primal(S):
    """reference: coneops_expcone.jl:284-297"""
    s1, s2, s3 = S.unbind(-1)
    w = _wright_omega(1.0 - s1 / s2 - _logsafe(s2 / s3))
    g1 = 1.0 / ((w - 1.0) * s2)
    g2 = g1 + g1 * _logsafe(w * s2 / s3) - 1.0 / s2
    g3 = w / ((1.0 - w) * s3)
    return _stack3(g1, g2, g3)


def _exp_dual_grad_H(Z):
    """Gradient and Hessian of f*(z).  reference: coneops_expcone.jl:
    370-399"""
    z1, z2, z3 = Z.unbind(-1)
    l = _logsafe(-z3 / z1)
    r = -z1 * l - z1 + z2
    c2 = 1.0 / r
    grad = _stack3(c2 * l - 1.0 / z1, -c2, (c2 * z1 - 1.0) / z3)

    H11 = (r * r - z1 * r + l * l * z1 * z1) / (r * z1 * z1 * r)
    H12 = -l / (r * r)
    H22 = 1.0 / (r * r)
    H13 = (z2 - z1) / (r * r * z3)
    H23 = -z1 / (r * r * z3)
    H33 = (r * r - z1 * r + z1 * z1) / (r * r * z3 * z3)
    return grad, _sym3(H11, H12, H13, H22, H23, H33)


def _finite_u(H_dual, ds):
    u = chol3_solve(H_dual, ds)
    return torch.where(torch.isfinite(u).all(dim=-1, keepdim=True), u, 0.0)


def _exp_higher_correction(H_dual, Zc, ds, v):
    """3rd-order correction η.  reference: coneops_expcone.jl:319-366"""
    u = _finite_u(H_dual, ds)
    z1, z2, z3 = Zc.unbind(-1)
    u1, u2, u3 = u.unbind(-1)
    v1, v2, v3 = v.unbind(-1)

    gpsi2 = torch.ones_like(z1)
    gpsi3 = -z1 / z3
    gpsi1 = _logsafe(gpsi3)
    psi = z1 * gpsi1 - z1 + z2

    gpsi = _stack3(gpsi1, gpsi2, gpsi3)
    dotpsi_u = (gpsi * u).sum(-1)
    dotpsi_v = (gpsi * v).sum(-1)

    coef = ((u1 * (v1 / z1 - v3 / z3)
             + u3 * (z1 * v3 / z3 - v1) / z3) * psi
            - 2.0 * dotpsi_u * dotpsi_v) / (psi ** 3)
    eta = gpsi * coef[..., None]

    inv_psi2 = 1.0 / (psi * psi)
    eta1 = eta[..., 0] + (
        (1.0 / psi - 2.0 / z1) * u1 * v1 / (z1 * z1)
        - u3 * v3 / (z3 * z3) / psi
        + dotpsi_u * inv_psi2 * (v1 / z1 - v3 / z3)
        + dotpsi_v * inv_psi2 * (u1 / z1 - u3 / z3))
    eta3 = eta[..., 2] + (
        2.0 * (z1 / psi - 1.0) * u3 * v3 / (z3 ** 3)
        - (u3 * v1 + u1 * v3) / (z3 * z3) / psi
        + dotpsi_u * inv_psi2 * (z1 * v3 / (z3 * z3) - v1 / z3)
        + dotpsi_v * inv_psi2 * (z1 * u3 / (z3 * z3) - u1 / z3))
    return _stack3(eta1, eta[..., 1], eta3) / 2.0


# ---------------------------------------------------------------------------
# power cone internals (reference: coneops_powcone.jl:217-478); a is the
# (c,) exponent of each cone, broadcast over the lane axis
# ---------------------------------------------------------------------------

def _pow_phi_dual(Z, a):
    return (Z[..., 0] / a) ** (2 * a) * (Z[..., 1] / (1 - a)) ** (2 - 2 * a)


def _pow_is_primal_feasible(S, a):
    ok = (S[..., 0] > 0) & (S[..., 1] > 0)
    res = torch.exp(2 * a * _logsafe(S[..., 0])
                    + 2 * (1 - a) * _logsafe(S[..., 1])) - S[..., 2] ** 2
    return ok & (res > 0)


def _pow_is_dual_feasible(Z, a):
    ok = (Z[..., 0] > 0) & (Z[..., 1] > 0)
    res = torch.exp(2 * a * _logsafe(Z[..., 0] / a)
                    + 2 * (1 - a) * _logsafe(Z[..., 1] / (1 - a))) \
        - Z[..., 2] ** 2
    return ok & (res > 0)


def _pow_barrier_dual(Z, a):
    return (-_logsafe(_pow_phi_dual(Z, a) - Z[..., 2] ** 2)
            - (1 - a) * _logsafe(Z[..., 0])
            - a * _logsafe(Z[..., 1]))


def _pow_grad_primal(S, a, dtype):
    """Newton-Raphson primal gradient.  reference: coneops_powcone.jl:
    288-316, 449-478"""
    s1, s2, s3 = S.unbind(-1)
    phi = s1 ** (2 * a) * s2 ** (2 - 2 * a)
    abs_s = s3.abs()
    big = abs_s > _eps(dtype)
    abs_safe = torch.where(big, abs_s, 1.0)

    x0 = -1.0 / abs_safe + (
        2.0 * abs_safe
        + torch.sqrt(phi * phi / (abs_safe * abs_safe) + 3.0 * phi)
    ) / (phi - abs_safe * abs_safe)
    t0 = -2.0 * a * _logsafe(a) - 2.0 * (1 - a) * _logsafe(1 - a)

    def f0(x):
        t1 = x * x
        t2 = 2.0 * x / abs_safe
        return (2 * a * _logsafe(2 * a * t1 + (1 + a) * t2)
                + 2 * (1 - a) * _logsafe(2 * (1 - a) * t1 + (2 - a) * t2)
                - _logsafe(phi) - _logsafe(t1 + t2) - 2.0 * _logsafe(t2)
                + t0)

    def f1(x):
        t1 = x * x
        t2 = 2.0 * x / abs_safe
        return (2 * a * a / (a * x + (1 + a) / abs_safe)
                + 2 * (1 - a) * (1 - a) / ((1 - a) * x + (2 - a) / abs_safe)
                - 2.0 * (x + 1.0 / abs_safe) / (t1 + t2))

    g3abs = _newton_raphson_onesided(x0, f0, f1, dtype)
    g3 = torch.where(big, torch.sign(s3) * g3abs, 0.0)
    g1 = torch.where(big, -(a * g3 * s3 + 1.0 + a) / s1, -(1 + a) / s1)
    g2 = torch.where(big, -((1 - a) * g3 * s3 + 2.0 - a) / s2,
                     -(2 - a) / s2)
    return _stack3(g1, g2, g3)


def _pow_barrier_primal(S, a, dtype):
    g = _pow_grad_primal(S, a, dtype)
    val = (_logsafe((-g[..., 0] / a) ** (2 * a)
                    * (-g[..., 1] / (1 - a)) ** (2 - 2 * a)
                    - g[..., 2] ** 2)
           + (1 - a) * _logsafe(-g[..., 0]) + a * _logsafe(-g[..., 1])
           - 3.0)
    return torch.where(_pow_is_primal_feasible(S, a), val, math.inf)


def _pow_dual_grad_H(Z, a):
    """reference: coneops_powcone.jl:408-440"""
    z1, z2, z3 = Z.unbind(-1)
    phi = _pow_phi_dual(Z, a)
    psi = phi - z3 * z3

    g1p = 2 * a * phi / (z1 * psi)
    g2p = 2 * (1 - a) * phi / (z2 * psi)
    g3p = -2 * z3 / psi

    H11 = (g1p * g1p - 2 * a * (2 * a - 1) * phi / (z1 * z1 * psi)
           + (1 - a) / (z1 * z1))
    H12 = g1p * g2p - 4 * a * (1 - a) * phi / (z1 * z2 * psi)
    H22 = (g2p * g2p - 2 * (1 - a) * (1 - 2 * a) * phi / (z2 * z2 * psi)
           + a / (z2 * z2))
    H13 = g1p * g3p
    H23 = g2p * g3p
    H33 = g3p * g3p + 2.0 / psi
    grad = _stack3(-g1p - (1 - a) / z1, -g2p - a / z2, -g3p)
    return grad, _sym3(H11, H12, H13, H22, H23, H33)


def _pow_higher_correction(H_dual, Zc, a, ds, v):
    """reference: coneops_powcone.jl:329-404"""
    u = _finite_u(H_dual, ds)
    z1, z2, z3 = Zc.unbind(-1)
    u1, u2, u3 = u.unbind(-1)
    v1, v2, v3 = v.unbind(-1)
    phi = _pow_phi_dual(Zc, a)
    psi = phi - z3 * z3

    gpsi = _stack3(2 * a * phi / z1, 2 * (1 - a) * phi / z2, -2 * z3)

    Hpsi11 = 2 * a * (2 * a - 1) * phi / (z1 * z1)
    Hpsi12 = 4 * a * (1 - a) * phi / (z1 * z2)
    Hpsi22 = 2 * (1 - a) * (1 - 2 * a) * phi / (z2 * z2)

    dotpsi_u = (gpsi * u).sum(-1)
    dotpsi_v = (gpsi * v).sum(-1)

    Hpsi_v1 = Hpsi11 * v1 + Hpsi12 * v2
    Hpsi_v2 = Hpsi12 * v1 + Hpsi22 * v2
    Hpsi_v3 = -2.0 * v3

    u_dot_Hpsi_v = u1 * Hpsi_v1 + u2 * Hpsi_v2 + u3 * Hpsi_v3
    coef = (u_dot_Hpsi_v * psi - 2.0 * dotpsi_u * dotpsi_v) / (psi ** 3)
    coef2 = (4 * a * (2 * a - 1) * (1 - a) * phi
             * (u1 / z1 - u2 / z2) * (v1 / z1 - v2 / z2) / psi)
    inv_psi2 = 1.0 / (psi * psi)

    e1 = (coef * gpsi[..., 0] - 2 * (1 - a) * u1 * v1 / (z1 ** 3)
          + coef2 / z1 + Hpsi_v1 * dotpsi_u * inv_psi2)
    e2 = (coef * gpsi[..., 1] - 2 * a * u2 * v2 / (z2 ** 3)
          - coef2 / z2 + Hpsi_v2 * dotpsi_u * inv_psi2)
    e3 = coef * gpsi[..., 2] + Hpsi_v3 * dotpsi_u * inv_psi2

    Hpsi_u1 = Hpsi11 * u1 + Hpsi12 * u2
    Hpsi_u2 = Hpsi12 * u1 + Hpsi22 * u2
    Hpsi_u3 = -2.0 * u3
    return _stack3((e1 + Hpsi_u1 * dotpsi_v * inv_psi2) / 2.0,
                   (e2 + Hpsi_u2 * dotpsi_v * inv_psi2) / 2.0,
                   (e3 + Hpsi_u3 * dotpsi_v * inv_psi2) / 2.0)


# ---------------------------------------------------------------------------
# generalized power cone internals (reference: coneops_genpowcone.jl:
# 237-472); a is the (c, d1) exponent block, broadcast over the lane axis
# ---------------------------------------------------------------------------

def _genpow_phi_dual(U, a):
    return torch.exp((2 * a * _logsafe(U / a)).sum(-1))


def _genpow_is_primal_feasible(W, a, d1):
    S1, S2 = W[..., :d1], W[..., d1:]
    ok = (S1 > 0).all(dim=-1)
    res = torch.exp((2 * a * _logsafe(S1)).sum(-1)) - (S2 * S2).sum(-1)
    return ok & (res > 0)


def _genpow_is_dual_feasible(W, a, d1):
    Z1, Z2 = W[..., :d1], W[..., d1:]
    ok = (Z1 > 0).all(dim=-1)
    res = _genpow_phi_dual(Z1, a) - (Z2 * Z2).sum(-1)
    return ok & (res > 0)


def _genpow_barrier_dual(W, a, d1):
    Z1, Z2 = W[..., :d1], W[..., d1:]
    res = _genpow_phi_dual(Z1, a) - (Z2 * Z2).sum(-1)
    return -_logsafe(res) - ((1.0 - a) * _logsafe(Z1)).sum(-1)


def _genpow_grad_primal(W, a, d1, dtype):
    """Newton-Raphson primal gradient.  reference: coneops_genpowcone.jl:
    393-426, 437-472"""
    P, R = W[..., :d1], W[..., d1:]
    phi = torch.exp((2 * a * _logsafe(P)).sum(-1))
    norm_r = torch.sqrt((R * R).sum(-1))
    big = norm_r > _eps(dtype)
    nr = torch.where(big, norm_r, 1.0)
    psi_const = 1.0 / (a * a).sum(-1)       # ψ = 1/<α,α>

    x0 = -1.0 / nr + (
        psi_const * nr
        + torch.sqrt((phi / (nr * nr) + psi_const * psi_const - 1.0) * phi)
    ) / (phi - nr * nr)

    def f0(x):
        v = -_logsafe(2.0 * x / nr + x * x)
        return v + (2 * a * (_logsafe(x[..., None] * nr[..., None]
                                      + (1 + a) / a)
                             - _logsafe(P))).sum(-1)

    def f1(x):
        v = -(2.0 * x + 2.0 / nr) / (x * x + 2.0 * x / nr)
        return v + (2 * a * nr[..., None]
                    / (nr[..., None] * x[..., None] + (1 + a) / a)).sum(-1)

    g1 = _newton_raphson_onesided(x0, f0, f1, dtype)
    gr = torch.where(big[..., None], g1[..., None] * R / nr[..., None], 0.0)
    gp = torch.where(big[..., None],
                     -(1.0 + a + a * (g1 * norm_r)[..., None]) / P,
                     -(1.0 + a) / P)
    return torch.cat([gp, gr], dim=-1)


def _genpow_barrier_primal(W, a, d1, dtype):
    g = _genpow_grad_primal(W, a, d1, dtype)
    val = -_genpow_barrier_dual(-g, a, d1) - (d1 + 1.0)
    return torch.where(_genpow_is_primal_feasible(W, a, d1), val, math.inf)


def _genpow_dual_grad_H(W, a, d1):
    """Gradient and the Hessian's (d1, d2, p, q, r) data, with the ok flag
    ζ > 0.  reference: coneops_genpowcone.jl:337-389"""
    U, V = W[..., :d1], W[..., d1:]
    phi = _genpow_phi_dual(U, a)
    norm2w = (V * V).sum(-1)
    zeta = phi - norm2w
    ok = zeta > 0
    zeta_safe = torch.where(ok, zeta, 1.0)

    tau = 2.0 * a / U
    grad_head = -tau * (phi / zeta_safe)[..., None] - (1.0 - a) / U
    grad_tail = 2.0 * V / zeta_safe[..., None]
    grad = torch.cat([grad_head, grad_tail], dim=-1)

    p0 = torch.sqrt(phi * (phi + norm2w) / 2.0)
    p1 = -2.0 * phi / p0
    q0 = torch.sqrt(zeta_safe * phi / 2.0)
    r1 = 2.0 * torch.sqrt(zeta_safe / (phi + norm2w))

    dd1 = tau * (phi / zeta_safe)[..., None] / U + (1.0 - a) / (U * U)
    dd2 = 2.0 / zeta_safe

    p = torch.cat([p0[..., None] * tau / zeta_safe[..., None],
                   p1[..., None] * V / zeta_safe[..., None]], dim=-1)
    q = tau * (q0 / zeta_safe)[..., None]
    r = r1[..., None] * V / zeta_safe[..., None]
    return grad, dd1, dd2, p, q, r, ok


def _genpow_full(g: ConeGroup, state):
    """The genpow Hessian data as full-width vectors: the diagonal D and
    q, r padded with zeros to the cone's width, each (B, c, d1 + d2)."""
    dd1, dd2 = state["d1"], state["d2"]
    q, r = state["q"], state["r"]
    zt = q.new_zeros(q.shape[:-1] + (g.dim2,))
    zh = r.new_zeros(r.shape[:-1] + (g.dim1,))
    dvec = torch.cat([dd1, dd2[..., None].expand(zt.shape)], dim=-1)
    return dvec, state["p"], torch.cat([q, zt], dim=-1), \
        torch.cat([zh, r], dim=-1)


# ---------------------------------------------------------------------------
# primal-dual (BFGS) scaling for 3-d cones
# (reference: coneops_nonsymmetric_common.jl:50-164)
# ---------------------------------------------------------------------------

def _primal_dual_scaling_3d(H_dual, st, zt, S, Z, dtype):
    """The PD-scaled Hs, falling back per cone to μ_local * H_dual where
    the PD form is not usable.  All (..., 3) / (..., 3, 3)."""
    eps = _eps(dtype)
    dot_sz = (S * Z).sum(-1)
    mu = dot_sz / 3.0
    mut = (zt * st).sum(-1) / 3.0

    ds = S + mu[..., None] * st
    dz = Z + mu[..., None] * zt
    dot_dsz = (ds * dz).sum(-1)

    de1 = mu * mut - 1.0
    Hzt = (H_dual * zt[..., None, :]).sum(-1)
    de2 = (zt * Hzt).sum(-1) - 3.0 * mut * mut

    usable = ((de1.abs() > math.sqrt(eps)) & (de2.abs() > eps)
              & (dot_sz > 0) & (dot_dsz > 0))
    de2_safe = torch.where(de2 != 0, de2, 1.0)

    tmp = mut[..., None] * st - Hzt
    Hws = (H_dual
           - st[..., :, None] * st[..., None, :] / 3.0
           - tmp[..., :, None] * tmp[..., None, :]
           / de2_safe[..., None, None])
    t = mu * torch.sqrt((Hws * Hws).sum(dim=(-2, -1)))

    axis = torch.linalg.cross(Z, zt, dim=-1)
    axis_norm = torch.sqrt((axis * axis).sum(-1, keepdim=True))
    axis = axis / torch.where(axis_norm > 0, axis_norm, 1.0)

    dot_sz_safe = torch.where(dot_sz != 0, dot_sz, 1.0)
    dot_dsz_safe = torch.where(dot_dsz != 0, dot_dsz, 1.0)
    Hs_pd = (S[..., :, None] * S[..., None, :] / dot_sz_safe[..., None, None]
             + ds[..., :, None] * ds[..., None, :]
             / dot_dsz_safe[..., None, None]
             + t[..., None, None] * axis[..., :, None] * axis[..., None, :])
    usable = usable & torch.isfinite(Hs_pd).all(dim=-1).all(dim=-1)
    Hs_fallback = mu[..., None, None] * H_dual
    return torch.where(usable[..., None, None], Hs_pd, Hs_fallback)


# ---------------------------------------------------------------------------
# the group operations that cones/ops.py dispatches to
# ---------------------------------------------------------------------------

def unit_initialization(g: ConeGroup, z, s):
    """The unit point of the asymmetric start written into z and s
    (B, m)."""
    B = z.shape[0]
    if g.kind == "exp":
        vals = torch.tensor(_EXP_UNIT, dtype=z.dtype, device=z.device)
        vals = vals.expand(B, g.count, 3)
    elif g.kind == "genpow":
        a = _alpha(g, z)
        vals = torch.cat([torch.sqrt(1.0 + a),
                          a.new_zeros((g.count, g.dim2))], dim=-1)
        vals = vals.expand(B, g.count, g.width)
    else:
        a = _alpha(g, z)
        vals = torch.stack([torch.sqrt(1.0 + a), torch.sqrt(1.0 + (1.0 - a)),
                            torch.zeros_like(a)], dim=-1)
        vals = vals.expand(B, g.count, 3)
    return _scatter(z, g, vals), _scatter(s, g, vals)


def update_scaling(g: ConeGroup, s, z, mu, scaling_strategy):
    """reference: coneops_{expcone,powcone}.jl update_scaling! + update_Hs.
    mu and scaling_strategy are (B,); returns (state, ok (B,))."""
    S, Z = _gather(s, g), _gather(z, g)
    dtype = S.dtype
    if g.kind == "genpow":
        # dual scaling only (the layout is pinned to Dual)
        grad, dd1, dd2, p, q, r, okz = _genpow_dual_grad_H(
            Z, _alpha(g, Z), g.dim1)
        return ({"grad": grad, "d1": dd1, "d2": dd2, "p": p, "q": q,
                 "r": r, "mu": mu}, okz.all(dim=1))
    if g.kind == "exp":
        grad, H_dual = _exp_dual_grad_H(Z)
        zt = _exp_grad_primal(S)
    else:
        a = _alpha(g, S)
        grad, H_dual = _pow_dual_grad_H(Z, a)
        zt = _pow_grad_primal(S, a, dtype)
    Hs_pd = _primal_dual_scaling_3d(H_dual, grad, zt, S, Z, dtype)
    Hs_dual = mu[:, None, None, None] * H_dual
    Hs = torch.where((scaling_strategy == 0)[:, None, None, None], Hs_pd,
                     Hs_dual)
    ok = torch.isfinite(Hs).flatten(1).all(dim=1)
    return {"grad": grad, "H_dual": H_dual, "Hs": Hs, "z": Z}, ok


def hs_blocks(g: ConeGroup, state):
    """Dense per-cone Hs blocks (B, c, w, w): the stored 3×3 Hs, or the
    genpow μ(D + pp' − qq' − rr') (reference: coneops_genpowcone.jl:
    111-135, sparse form)."""
    if g.kind != "genpow":
        return state["Hs"]
    dvec, p, q, r = _genpow_full(g, state)
    outer = lambda u: u[..., :, None] * u[..., None, :]
    return ((torch.diag_embed(dvec) + outer(p) - outer(q) - outer(r))
            * state["mu"][:, None, None, None])


def mul_Hs(g: ConeGroup, state, X):
    """Hs x for the group's entries of X (B, m, k), (B, c, w, k)."""
    Xg = _gather(X, g)
    if g.kind != "genpow":
        return torch.matmul(state["Hs"], Xg)
    d1 = g.dim1
    p, q, r = state["p"][..., None], state["q"][..., None], \
        state["r"][..., None]
    coef_p = (p * Xg).sum(dim=2, keepdim=True)
    coef_q = (q * Xg[:, :, :d1]).sum(dim=2, keepdim=True)
    coef_r = (r * Xg[:, :, d1:]).sum(dim=2, keepdim=True)
    head = state["d1"][..., None] * Xg[:, :, :d1] - coef_q * q
    tail = state["d2"][..., None, None] * Xg[:, :, d1:] - coef_r * r
    out = torch.cat([head, tail], dim=2) + coef_p * p
    return out * state["mu"][:, None, None, None]


def mul_Hs_inv(g: ConeGroup, state, X):
    """Hs⁻¹ x, (B, c, w, k): a 3×3 Cholesky solve against the stored Hs,
    or for genpow three Sherman–Morrison rank-1 updates on the diagonal
    base of D + pp' − qq' − rr', divided by μ."""
    Xg = _gather(X, g)
    if g.kind != "genpow":
        return chol3_solve(state["Hs"], Xg)
    dvec, p, q, r = _genpow_full(g, state)
    dvec = dvec[..., None]
    apply_inv = lambda v: v / dvec
    for u, sgn in ((p, 1.0), (q, -1.0), (r, -1.0)):
        Au = apply_inv(u[..., None])[..., 0]
        denom = 1.0 + sgn * (u * Au).sum(-1)

        def apply_inv(v, prev=apply_inv, u=u, Au=Au, denom=denom, sgn=sgn):
            Av = prev(v)
            coef = (u[..., None] * Av).sum(dim=2)
            return Av - sgn * Au[..., None] * (
                coef[:, :, None, :] / denom[..., None, None])

    return apply_inv(Xg) / state["mu"][:, None, None, None]


def combined_ds_shift(g: ConeGroup, state, step_z, step_s, sigma_mu, shift):
    """shift = σμ·g(z) − η with the third-order correction η (exp, pow);
    genpow has no correction."""
    ds, v = _gather(step_s, g), _gather(step_z, g)
    if g.kind == "genpow":
        return _scatter(shift, g, state["grad"] * sigma_mu[:, None, None])
    if g.kind == "exp":
        eta = _exp_higher_correction(state["H_dual"], state["z"], ds, v)
    else:
        eta = _pow_higher_correction(state["H_dual"], state["z"],
                                     _alpha(g, ds), ds, v)
    out = state["grad"] * sigma_mu[:, None, None] - eta
    return _scatter(shift, g, out)


def _feasibility(g: ConeGroup, like):
    """(dual, primal) feasibility tests of the group's cones."""
    if g.kind == "exp":
        return _exp_is_dual_feasible, _exp_is_primal_feasible
    a = _alpha(g, like)
    if g.kind == "genpow":
        return (lambda W: _genpow_is_dual_feasible(W, a, g.dim1),
                lambda W: _genpow_is_primal_feasible(W, a, g.dim1))
    return (lambda W: _pow_is_dual_feasible(W, a),
            lambda W: _pow_is_primal_feasible(W, a))


def step_length(g: ConeGroup, dz, ds, z, s, alpha_max, settings):
    """The largest backtracked step from alpha_max (B,) that keeps every
    cone of the group feasible, per lane."""
    step = settings.linesearch_backtrack_step
    alpha_min = settings.min_terminate_step_length
    Z, S = _gather(z, g), _gather(s, g)
    dual_feas, prim_feas = _feasibility(g, Z)
    az = _backtrack_search(Z, _gather(dz, g), dual_feas, alpha_max,
                           alpha_min, step)
    a_s = _backtrack_search(S, _gather(ds, g), prim_feas, alpha_max,
                            alpha_min, step)
    return torch.minimum(az, a_s)


def compute_barrier(g: ConeGroup, z, s, dz, ds, alpha):
    """f*(z + α dz) + f(s + α ds) summed over the group, per lane; α
    (B,)."""
    a3 = alpha[:, None, None]
    Z = _gather(z, g) + a3 * _gather(dz, g)
    S = _gather(s, g) + a3 * _gather(ds, g)
    if g.kind == "exp":
        bd = torch.where(_exp_is_dual_feasible(Z), _exp_barrier_dual(Z),
                         math.inf)
        bp = _exp_barrier_primal(S)
    elif g.kind == "genpow":
        a = _alpha(g, Z)
        bd = torch.where(_genpow_is_dual_feasible(Z, a, g.dim1),
                         _genpow_barrier_dual(Z, a, g.dim1), math.inf)
        bp = _genpow_barrier_primal(S, a, g.dim1, Z.dtype)
    else:
        a = _alpha(g, Z)
        bd = torch.where(_pow_is_dual_feasible(Z, a),
                         _pow_barrier_dual(Z, a), math.inf)
        bp = _pow_barrier_primal(S, a, Z.dtype)
    return bd.sum(dim=1) + bp.sum(dim=1)
