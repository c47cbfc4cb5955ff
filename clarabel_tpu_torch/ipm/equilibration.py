"""Ruiz equilibration of the problem data, batched over a leading lane axis.

A port of `clarabel_tpu/ipm/equilibration.py`: the fixed-trip-count Ruiz
loop over the KKT block [P Aᵀ; A 0] with min/max scaling clips and a
separate cost scaling (reference: src/problemdata.jl:133-221), then cone
rectification, which forces scalar scaling on cones that cannot be scaled
elementwise (coneops_compositecone.jl:28-47).  P and A are dense (B, r, c)
tensors or `linalg.matops.SparseCOO` values over a shared pattern (the
reference's sparse branch, l.51-92, through the same matops helpers).
"""

from typing import NamedTuple

import torch

from ..cones.layout import ConeLayout
from ..cones import ops as cone_ops
from ..linalg import matops


class Equilibration(NamedTuple):
    d: torch.Tensor      # (B, n) variable scaling
    e: torch.Tensor      # (B, m) constraint scaling
    dinv: torch.Tensor
    einv: torch.Tensor
    c: torch.Tensor      # (B,) cost scaling


def ruiz_equilibrate(layout: ConeLayout, settings, P, A, q, b):
    """Equilibrate (P (B,n,n), A (B,m,n), q (B,n), b (B,m)), P and A dense
    or SparseCOO; returns the scaled data and the scalings."""
    B, n = q.shape
    d = torch.ones_like(q)
    e = torch.ones_like(b)
    c = torch.ones((B,), dtype=q.dtype, device=q.device)

    if not settings.equilibrate_enable:
        return P, A, q, b, Equilibration(d, e, d, e, c)

    smin = settings.equilibrate_min_scaling
    smax = settings.equilibrate_max_scaling

    for _ in range(settings.equilibrate_max_iter):
        # column inf-norms of [P Aᵀ; A 0]
        # (reference: src/utils/mathutils.jl:129-141 kkt_col_norms!)
        dwork = torch.maximum(matops.col_abs_max(P), matops.col_abs_max(A))
        ework = matops.row_abs_max(A)
        dwork = torch.where(dwork == 0, torch.ones_like(dwork), dwork)
        ework = torch.where(ework == 0, torch.ones_like(ework), ework)
        dwork = 1.0 / torch.sqrt(dwork)
        ework = 1.0 / torch.sqrt(ework)
        # bound the cumulative scaling
        dwork = torch.clamp(dwork, smin / d, smax / d)
        ework = torch.clamp(ework, smin / e, smax / e)

        # P <- D P D, A <- E A D, q <- D q, b <- E b
        P = matops.scale_lr(P, dwork, dwork)
        A = matops.scale_lr(A, ework, dwork)
        q = q * dwork
        b = b * ework
        d = d * dwork
        e = e * ework

        # cost scaling (reference: problemdata.jl:185-201)
        mean_col_norm_P = matops.mean_col_abs_max(P)
        inf_norm_q = (q.abs().amax(dim=1) if n > 0
                      else torch.zeros_like(c))
        do_cost = (mean_col_norm_P != 0) & (inf_norm_q != 0)
        scale_cost = torch.maximum(inf_norm_q, mean_col_norm_P)
        one = torch.ones_like(scale_cost)
        ctmp = torch.where(
            do_cost,
            torch.clamp(1.0 / torch.where(scale_cost != 0, scale_cost, one),
                        smin / c, smax / c),
            one)
        P = matops.scalar_mul(P, ctmp)
        q = q * ctmp[:, None]
        c = c * ctmp

    # cone rectification: scalar scaling on SOC cones
    delta, changed = cone_ops.rectify_equilibration(layout, e)
    if changed:
        A = matops.scale_lr(A, delta, None)
        b = b * delta
        e = e * delta

    return P, A, q, b, Equilibration(d, e, 1.0 / d, 1.0 / e, c)
