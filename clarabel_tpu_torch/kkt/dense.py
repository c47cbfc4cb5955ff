"""Dense KKT system of the loop solver, batched over a leading lane axis.

A port of `clarabel_tpu/kkt/dense.py`:

    K = [ P   Aᵀ ]      Dsigns = (+1 ×n, −1 ×m)
        [ A  −Hs ]

with static regularization ±ε on the diagonal (ε = const + proportional ·
‖diag K‖∞, per lane), dynamic per-pivot regularization inside the LDL
factor, and iterative refinement against the unregularized K.

The factor takes one of two routes.  A float32 factor with N ≤ 80 takes
the K2 route (`_use_pallas`, the reference's name): `linalg.batched_ldl`
factors the whole batch and builds L⁻¹ in one call, which on CUDA tensors
is the hand-written kernel.  Every other factor is `linalg.ldl.ldl_factor`,
with the explicit inverse, for N ≤ 512, and the blocked
`linalg.ldl.ldl_factor_blocked` above that.
"""

from typing import NamedTuple, Optional

import torch

from ..linalg.ldl import (
    ldl_factor, ldl_factor_blocked, ldl_solve, invert_unit_lower,
    ldl_solve_via_inverse,
)
from ..linalg import smallops as so
from ..linalg.batched_ldl import MAX_N, batched_ldl_inverse
from ..settings import torch_dtype
from . import refine


class KKTFactor(NamedTuple):
    L: torch.Tensor          # (B, N, N): L, or L⁻¹ on the K2 route
    d: torch.Tensor          # (B, N)
    K_true: torch.Tensor     # unregularized K (for iterative refinement)
    ok: torch.Tensor         # (B,) bool
    Linv: Optional[torch.Tensor]   # explicit L⁻¹, None when not built
    perm: Optional[torch.Tensor]   # (B, N) elimination order, None: natural
    iperm: Optional[torch.Tensor]  # (B, N) inverse permutation


def _use_inverse(settings, N: int) -> bool:
    flag = settings.dense_solve_via_inverse
    if flag is None:
        # latency-bound regime: explicit inverse for small/medium KKT
        return N <= 512
    return bool(flag)


def _use_pallas(settings, factor_dtype, N: int, device) -> bool:
    """The K2 route: a float32 factor with N ≤ 80, unless `use_pallas` is
    False.  `None` (auto) turns it on for CUDA tensors, as the reference
    turns it on for a TPU; `True` takes it on the CPU too, where it runs
    the plain version."""
    flag = settings.use_pallas
    if flag is not None and not flag:
        return False
    if torch_dtype(factor_dtype) != torch.float32:
        return False
    if N > MAX_N:
        return False
    if flag:
        return True
    return torch.device(device).type == "cuda"


def _permute(x, perm):
    """x (B, N) or (B, N, k) with its rows taken in per-lane order perm."""
    idx = perm if x.dim() == 2 else perm[..., None].expand_as(x)
    return torch.gather(x, 1, idx)


def _factor_solve(fac: KKTFactor, rhs):
    """Apply the factorization at its own dtype and return rhs's dtype
    (mixed precision: a float32 factor applied to float64 residuals)."""
    out_dtype = rhs.dtype
    rhs_f = rhs.to(fac.L.dtype)
    if fac.perm is not None:
        rhs_f = _permute(rhs_f, fac.perm)
    if fac.Linv is not None:
        x = ldl_solve_via_inverse(fac.Linv, fac.d, rhs_f)
    else:
        x = ldl_solve(fac.L, fac.d, rhs_f)
    if fac.perm is not None:
        x = _permute(x, fac.iperm)
    return x.to(out_dtype)


def assemble_and_factor(P, A, Hs, signs, settings, factor_dtype=None):
    """Build K (B, N, N), apply static regularization, LDL-factor.  signs
    (N,) are the static pivot signs."""
    n = P.shape[-1]
    m = A.shape[-2]
    N = n + m
    K_true = torch.cat([torch.cat([P, A.transpose(-1, -2)], dim=2),
                        torch.cat([A, -Hs], dim=2)], dim=1)

    if settings.static_regularization_enable:
        diag = torch.diagonal(K_true, dim1=-2, dim2=-1)
        maxdiag = diag.abs().amax(dim=1)
        eps = (settings.static_regularization_constant
               + settings.static_regularization_proportional * maxdiag)
        K_reg = K_true + torch.diag_embed(signs * eps[:, None])
    else:
        K_reg = K_true

    # a lower-precision factor is refined against the full-precision K_true
    if factor_dtype is None:
        factor_dtype = settings.factor_dtype
    fdt = torch_dtype(factor_dtype)
    K_fac = K_reg.to(fdt)

    use_pallas = _use_pallas(settings, factor_dtype, N, K_true.device)
    # pivot-growth control: eliminate in descending |diag| order (per
    # lane); off on the K2 route, whose kernel takes static signs
    diag_order = settings.dense_ldl_diag_order
    if diag_order is None or use_pallas:
        diag_order = False
    perm = iperm = None
    lane_signs = signs
    if diag_order:
        dK = torch.diagonal(K_reg, dim1=-2, dim2=-1).abs()
        perm = torch.argsort(-dK, dim=1, stable=True)
        iperm = torch.argsort(perm, dim=1, stable=True)
        K_fac = torch.gather(K_fac, 1, perm[..., None].expand(-1, -1, N))
        K_fac = torch.gather(K_fac, 2, perm[:, None, :].expand(-1, N, -1))
        lane_signs = signs[perm]

    if use_pallas:
        Linv, d, ok = batched_ldl_inverse(
            K_fac, signs.to(fdt),
            settings.dynamic_regularization_eps,
            settings.dynamic_regularization_delta,
            settings.dynamic_regularization_enable)
        return KKTFactor(Linv, d, K_true, ok, Linv, perm, iperm)

    dyn = dict(dyn_eps=settings.dynamic_regularization_eps,
               dyn_delta=settings.dynamic_regularization_delta,
               dynamic_enable=settings.dynamic_regularization_enable)
    if N > 512:
        # the blocked factor, on K padded to a multiple of 128 with unit
        # pivots of sign +1 (reference kkt/dense.py:157-180)
        pad = (-N) % 128
        Kp = torch.nn.functional.pad(K_fac, (0, pad, 0, pad))
        Kp[:, N:, N:] = torch.eye(pad, dtype=fdt, device=K_fac.device)
        sp = torch.cat([lane_signs.to(fdt).expand(K_fac.shape[0], N),
                        torch.ones((K_fac.shape[0], pad), dtype=fdt,
                                   device=K_fac.device)], dim=1)
        Lp, dp, ok = ldl_factor_blocked(Kp, sp, **dyn)
        L, d = Lp[:, :N, :N], dp[:, :N]
    else:
        L, d, ok = ldl_factor(K_fac, lane_signs, **dyn)
    Linv = invert_unit_lower(L) if _use_inverse(settings, N) else None
    return KKTFactor(L, d, K_true, ok, Linv, perm, iperm)


def solve_refined(fac: KKTFactor, rhs, settings):
    """LDL solve with iterative refinement against K_true (reference:
    kktsolver_directldl.jl:389-466).  Returns (x, ok) per lane."""
    if not settings.iterative_refinement_enable:
        x = _factor_solve(fac, rhs)
        return x, torch.isfinite(x).flatten(1).all(dim=1)
    return refine.solve_refined(lambda r: _factor_solve(fac, r),
                                lambda v: so.mv(fac.K_true, v), rhs, settings)


def kkt_solve_xz(fac: KKTFactor, bx, bz, settings):
    """Solve with RHS [bx; bz] and split the result: (x, z, ok)."""
    n = bx.shape[1]
    sol, ok = solve_refined(fac, torch.cat([bx, bz], dim=1), settings)
    return sol[:, :n], sol[:, n:], ok


def kkt_solve_xz2(fac: KKTFactor, bx1, bz1, bx2, bz2, settings):
    """Two solves as one two-column solve with joint refinement:
    (x1, z1, x2, z2, ok)."""
    n = bx1.shape[1]
    rhs = torch.stack([torch.cat([bx1, bz1], dim=1),
                       torch.cat([bx2, bz2], dim=1)], dim=2)
    sol, ok = solve_refined(fac, rhs, settings)
    return sol[:, :n, 0], sol[:, n:, 0], sol[:, :n, 1], sol[:, n:, 1], ok
