"""Condensed (normal-equations) KKT backend, batched over a leading lane axis.

A port of `clarabel_tpu/kkt/condensed.py`.  With Hs⁻¹ in closed form per
cone (`cones.ops.mul_Hs_inv`), the step equations

    [P  Aᵀ] [x]   [bx]
    [A  -H ] [z] = [bz]

reduce to  (P + εI + Aᵀ H⁻¹ A) x = bx + Aᵀ H⁻¹ bz,  z = H⁻¹(A x − bz).
The n x n Schur matrix is Cholesky-factored per lane; iterative refinement
against the true augmented operator (`kkt.blockarrow.make_kkt_matvec`)
recovers the accuracy the normal equations lose.  Zero cones (Hs = 0) are
regularized to εI, which the refinement removes from the solution.
"""

from typing import NamedTuple, Optional

import torch

from ..cones import ops as cone_ops
from ..linalg import smallops as so
from ..settings import torch_dtype
from .refine import refine


class CondensedFactor(NamedTuple):
    Lchol: torch.Tensor            # (B, n, n) Cholesky factor of S
    Linv: Optional[torch.Tensor]   # explicit L⁻¹ (None on the small path)
    A: torch.Tensor
    eps: torch.Tensor              # (B,) zero-cone regularization
    ok: torch.Tensor               # (B,)


def chol_small(S):
    """Cholesky of (B, n, n) SPD matrices by rank-1 (outer-product)
    elimination; NaNs propagate on indefinite input (callers check
    finiteness)."""
    n = S.shape[-1]
    M = S
    cols = []
    for j in range(n):
        d = torch.sqrt(M[:, j, j])
        col = M[:, :, j] / d[:, None]
        col[:, :j] = 0.0
        cols.append(col)
        M = M - col[:, :, None] * col[:, None, :]
    return torch.stack(cols, dim=2)


def _cholesky(S):
    """The reference's factor: the elimination above for float64 with
    n ≤ 32, else the library factor with every entry NaN where it fails
    (as the JAX factor reports failure)."""
    if S.shape[-1] <= 32 and S.dtype == torch.float64:
        return chol_small(S)
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(L, float("nan")), L)


def assemble_and_factor_condensed(P, A, layout, state, signs, settings,
                                  factor_dtype):
    """Factor the condensed system; the true augmented KKT is never
    built: refinement applies it as an operator."""
    n = P.shape[-1]
    hsd = cone_ops.hs_diag(layout, state, P)
    maxdiag = torch.diagonal(P, dim1=-2, dim2=-1).abs().amax(dim=1)
    if hsd.shape[1]:
        maxdiag = torch.maximum(maxdiag, hsd.abs().amax(dim=1))
    eps = (settings.static_regularization_constant
           + settings.static_regularization_proportional * maxdiag)

    HinvA = cone_ops.mul_Hs_inv(layout, state, A, eps)     # (B, m, n)
    S = P + so.rmv(A, HinvA)
    S = S + eps[:, None, None] * torch.eye(n, dtype=S.dtype, device=S.device)

    fdt = torch_dtype(factor_dtype)
    Lchol = _cholesky(S.to(fdt))
    finite = torch.isfinite(Lchol)
    ok = finite.flatten(1).all(dim=1)
    Lchol = torch.where(finite, Lchol, torch.zeros_like(Lchol))
    if n <= 32 and fdt == torch.float64:
        Linv = None   # substitution path, no inverse needed
    else:
        # explicit L⁻¹ once per factor: every apply and every refinement
        # pass becomes two products
        eye = torch.eye(n, dtype=fdt, device=S.device).expand_as(Lchol)
        Linv = torch.linalg.solve_triangular(Lchol, eye, upper=False)
        Linv = torch.where(torch.isfinite(Linv), Linv, torch.zeros_like(Linv))
    return CondensedFactor(Lchol, Linv, A, eps, ok), state


def _condensed_apply(fac: CondensedFactor, layout, state, rhs):
    """One application of the condensed inverse to rhs = [bx; bz],
    (B, n+m) or (B, n+m, k)."""
    n = fac.Lchol.shape[-1]
    out_dtype = rhs.dtype
    bx, bz = rhs[:, :n], rhs[:, n:]
    Hinv_bz = cone_ops.mul_Hs_inv(layout, state, bz, fac.eps)
    w = (bx + so.rmv(fac.A, Hinv_bz)).to(fac.Lchol.dtype)
    vec = w.dim() == 2
    if vec:
        w = w.unsqueeze(-1)
    if fac.Linv is None:
        y = torch.linalg.solve_triangular(fac.Lchol, w, upper=False)
        x = torch.linalg.solve_triangular(fac.Lchol.transpose(-1, -2), y,
                                          upper=True)
    else:
        y = so.mm(fac.Linv, w)
        x = so.mm(fac.Linv.transpose(-1, -2), y)
    x = (x.squeeze(-1) if vec else x).to(out_dtype)
    z = cone_ops.mul_Hs_inv(layout, state, so.mv(fac.A, x) - bz, fac.eps)
    return torch.cat([x, z], dim=1)


def solve_refined_condensed(fac: CondensedFactor, layout, state, kkt_mv,
                            rhs, settings):
    """Condensed solve with iterative refinement on the augmented residual.
    The normal equations square the conditioning, so refinement runs to
    the float64 floor (abstol ≤ 1e-14, reltol ≤ 1e-15)."""
    x = _condensed_apply(fac, layout, state, rhs)
    return refine(
        lambda r: _condensed_apply(fac, layout, state, r), kkt_mv, rhs, x,
        min(settings.iterative_refinement_abstol, 1e-14),
        min(settings.iterative_refinement_reltol, 1e-15),
        settings.iterative_refinement_stop_ratio,
        settings.iterative_refinement_max_iter)


def kkt_solve_xz_condensed(fac, layout, state, kkt_mv, bx, bz, settings):
    n = bx.shape[1]
    sol, ok = solve_refined_condensed(
        fac, layout, state, kkt_mv, torch.cat([bx, bz], dim=1), settings)
    return sol[:, :n], sol[:, n:], ok


def kkt_solve_xz2_condensed(fac, layout, state, kkt_mv, bx1, bz1, bx2, bz2,
                            settings):
    """Two condensed solves as one two-column solve with joint
    refinement."""
    n = bx1.shape[1]
    rhs = torch.stack([torch.cat([bx1, bz1], dim=1),
                       torch.cat([bx2, bz2], dim=1)], dim=2)
    sol, ok = solve_refined_condensed(fac, layout, state, kkt_mv, rhs,
                                      settings)
    return sol[:, :n, 0], sol[:, n:, 0], sol[:, :n, 1], sol[:, n:, 1], ok
