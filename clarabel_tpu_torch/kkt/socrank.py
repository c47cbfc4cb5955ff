"""Sherman–Morrison–Woodbury correction for low-rank Hs terms, batched over
a leading lane axis.

A port of `clarabel_tpu/kkt/socrank.py`.  Large SOCs (and generalized power
cones) in sparse data mode assemble only a diagonal into the KKT
(`cones.ops.hs_flat_values` with soc_rank2_min_dim); the remaining rank-1
terms  K = K₀ + U S U'  are applied around the factored K₀:

    K⁻¹ = K₀⁻¹ − K₀⁻¹U (S⁻¹ + U'K₀⁻¹U)⁻¹ U'K₀⁻¹

with a dense capacitance system of one row per low-rank column, factored
once per IPM iteration.  This plays the role of the reference's sparse
SOC expansion (reference: cone_types.jl:65-117, directldl_datamaps.jl:
8-79) without changing the KKT dimension.  The refinement loop, which runs
against the true KKT operator (mul_Hs uses the exact rank structure of the
cone), restores SMW's conditional stability.
"""

import torch

from ..linalg.ldl import ldl_factor, ldl_solve


def wrap_apply_smw(apply0, U, signs, settings):
    """Wrap a K₀⁻¹ apply with the U S U' correction.  U (B, N, r), signs
    (r,) on U's device.  Returns (apply, ok): apply takes (B, N) and
    (B, N, k) right-hand sides; ok (B,) flags a finite capacitance
    factorization."""
    sgn = signs.to(U.dtype)
    Z = apply0(U)                                        # (B, N, r)
    C = torch.diag(1.0 / sgn) + torch.matmul(U.transpose(-1, -2), Z)
    Lc, dc, okc = ldl_factor(
        C, sgn,
        dyn_eps=settings.dynamic_regularization_eps,
        dyn_delta=settings.dynamic_regularization_delta,
        dynamic_enable=settings.dynamic_regularization_enable)

    def apply(rhs):
        vec = rhs.dim() == 2
        R = rhs.unsqueeze(-1) if vec else rhs
        y = apply0(R)                                    # (B, N, k)
        t = torch.matmul(U.transpose(-1, -2), y)         # (B, r, k)
        c = ldl_solve(Lc, dc, t)
        out = y - torch.matmul(Z, c)
        return out[..., 0] if vec else out

    return apply, okc
