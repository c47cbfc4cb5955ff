"""Block-arrow structured KKT backend, batched over a leading lane axis.

A port of `clarabel_tpu/kkt/blockarrow.py`.  A host-computed
BlockArrowPlan (structure.py) factors the KKT as p independent diagonal
block LDLs, one batch of B·p blocks, plus one dense Schur complement per
lane.  Per-iteration work drops from O(N³) dense to O(p·nb³ + nb²·nt·p +
nt³): a large win for banded, grid and multi-scenario problems.
Iterative refinement against the full unpermuted KKT (`make_kkt_matvec`,
composed from its parts) keeps the accuracy, as in the dense and condensed
backends.

Sharded over a process group (`group`, the `tp` axis of a mesh): each rank
factors its contiguous share of the p blocks, [r·p/tp, (r+1)·p/tp); the
Schur sum Σ Bᵢᵀ Dᵢ⁻¹ Bᵢ, the count of failed blocks and the reduced
right-hand side are each all-reduced over the group (the reference's
`psum`s, blockarrow.py:108-116, 180-186), the dense Schur complement is
factored on every rank, and every rank rebuilds the whole solution vector
(DEVIATIONS.md #20).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..cones import ops as cone_ops
from ..linalg import matops
from ..linalg.matops import on_device
from ..linalg.ldl import ldl_factor, ldl_factor_blocked, ldl_solve
from ..parallel.multihost import all_reduce
from ..settings import torch_dtype
from ..structure import BlockArrowPlan
from .refine import solve_refined


class BlockArrowFactorS(NamedTuple):
    Lb: torch.Tensor       # (B, p, nb, nb)
    db: torch.Tensor       # (B, p, nb)
    DinvB: torch.Tensor    # (B, p, nb, nt)
    Bc: torch.Tensor       # (B, p, nb, nt) coupling blocks
    Ls: torch.Tensor       # (B, nt, nt)
    ds: torch.Tensor       # (B, nt)
    ok: torch.Tensor       # (B,)


def make_kkt_matvec(P, A, layout, state):
    """x -> [P Aᵀ; A −Hs] x for x (B, n+m) or (B, n+m, k), without the
    (n+m) x (n+m) matrix; P and A dense or SparseCOO (`linalg.matops`)."""
    n = matops.ncols(P)

    def matvec(x):
        x1, x2 = x[:, :n], x[:, n:]
        top = matops.mv(P, x1) + matops.rmv(A, x2)
        bot = matops.mv(A, x1) - cone_ops.mul_Hs(layout, state, x2)
        return torch.cat([top, bot], dim=1)

    return matvec


def dyn_kwargs(settings):
    return dict(dyn_eps=settings.dynamic_regularization_eps,
                dyn_delta=settings.dynamic_regularization_delta,
                dynamic_enable=settings.dynamic_regularization_enable)


def factor_batch(K, signs, dyn):
    """LDLᵀ of a batch of (·, nb, nb) blocks: the 128-blocked factor for
    large blocks (the plans pad nb to a multiple of 128 there), else the
    unblocked one (reference `_pick_factor_one`)."""
    nb = K.shape[-1]
    if nb >= 192 and nb % 128 == 0:
        return ldl_factor_blocked(K, signs, **dyn)
    return ldl_factor(K, signs, **dyn)


def local_blocks(p: int, group=None):
    """The blocks [lo, hi) this rank factors: all p without a group, else
    its contiguous share (p is a multiple of the group's size)."""
    if group is None:
        return 0, p
    import torch.distributed as dist

    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if p % size:
        raise ValueError(f"{p} blocks do not split over {size} ranks")
    return rank * p // size, (rank + 1) * p // size


def factor_blocks(D, Bc, C, bsigns, tsigns, settings, group=None):
    """The block-arrow numeric factorization: B·p block LDLs and a dense
    Schur complement per lane.  D (B, p, nb, nb), Bc (B, p, nb, nt),
    C (B, nt, nt); bsigns (p, nb), tsigns (nt,).  With a `group`, D, Bc
    and bsigns hold this rank's blocks only (`local_blocks`), and the
    Schur sum and the count of failed blocks are all-reduced over it."""
    dyn = dyn_kwargs(settings)
    B, p, nb, _ = D.shape
    nt = C.shape[-1]
    Lb, db, okb = factor_batch(D.reshape(B * p, nb, nb),
                               bsigns.expand(B, p, nb).reshape(B * p, nb),
                               dyn)
    DinvB = ldl_solve(Lb, db, Bc.reshape(B * p, nb, nt))
    Lb, db = Lb.view(B, p, nb, nb), db.view(B, p, nb)
    DinvB = DinvB.view(B, p, nb, nt)
    schur = torch.einsum("bpij,bpik->bjk", Bc, DinvB)
    if group is None:
        S = C - schur
        ok_blocks = okb.view(B, p).all(dim=1)
    else:
        S = C - all_reduce(schur, group)
        nbad = all_reduce((~okb).view(B, p).sum(dim=1, dtype=torch.int32),
                          group)
        ok_blocks = nbad == 0
    Ls, ds, oks = ldl_factor(S, tsigns, **dyn)
    return BlockArrowFactorS(Lb, db, DinvB, Bc, Ls, ds, ok_blocks & oks)


def assemble_and_factor_blockarrow(P, A, Hs, plan: BlockArrowPlan, signs,
                                   settings, factor_dtype, group=None):
    """Dense data with a plan: gather the blocks (this rank's, with a
    group) out of the regularized K (B, N, N) and factor them."""
    n, m = plan.n, plan.m
    N = n + m
    K_true = torch.cat([torch.cat([P, A.transpose(-1, -2)], dim=2),
                        torch.cat([A, -Hs], dim=2)], dim=1)
    maxdiag = torch.diagonal(K_true, dim1=-2, dim2=-1).abs().amax(dim=1)
    eps = (settings.static_regularization_constant
           + settings.static_regularization_proportional * maxdiag)
    K_reg = K_true + torch.diag_embed(signs * eps[:, None])
    fdt = torch_dtype(factor_dtype)

    # a pad row/column with a unit diagonal: sentinel gathers read unit
    # pivots (reference blockarrow.py:144-147)
    B = K_reg.shape[0]
    Kp = K_reg.new_zeros((B, N + 1, N + 1), dtype=fdt)
    Kp[:, :N, :N] = K_reg.to(fdt)
    Kp[:, N, N] = 1.0

    dev = K_reg.device
    lo, hi = local_blocks(plan.p, group)
    bi = on_device(plan, "block_idx", dev)[lo:hi]
    ti = on_device(plan, "tail_idx", dev)
    D = Kp[:, bi[:, :, None], bi[:, None, :]]
    Bc = Kp[:, bi[:, :, None], ti[None, None, :]]
    C = Kp[:, ti[:, None], ti[None, :]]

    # blocks that pad_plan_blocks appended are all-sentinel: their gather
    # reads Kp[N, N] = 1 at every position (an all-ones matrix), so they
    # become exact identities with zero couplings (reference
    # blockarrow.py:158-161)
    pad = np.nonzero((plan.block_idx[lo:hi] >= N).all(axis=1))[0]
    if len(pad):
        pad = on_device(plan, f"pad_blocks_{lo}_{hi}", dev, lambda: pad)
        D[:, pad] = on_device(plan, "eye_nb", dev,
                              lambda: np.eye(plan.nb)).to(fdt)
        # index_fill_: a scalar assigned through an index would be copied
        # from the host, which a CUDA graph cannot capture
        Bc.index_fill_(1, pad, 0.0)
    bsigns = on_device(plan, "block_signs", dev)[lo:hi].to(fdt)
    return factor_blocks(D, Bc, C, bsigns,
                         on_device(plan, "tail_signs", dev).to(fdt),
                         settings, group)


def _ba_apply(fac: BlockArrowFactorS, plan: BlockArrowPlan, rhs,
              group=None):
    """Apply the factorization to rhs (B, N) or (B, N, k), at the factor's
    dtype, returning rhs's dtype.  With a `group` the factor holds this
    rank's blocks: the reduced right-hand side is all-reduced, and so is a
    zero buffer into which each rank writes its blocks' part of the
    solution (an exact sum: every entry comes from one rank), so every rank
    returns the whole vector."""
    vec = rhs.dim() == 2
    R = rhs.unsqueeze(-1) if vec else rhs
    out_dtype = R.dtype
    B, N, k = R.shape
    _, p, nb, nt = fac.DinvB.shape
    Rp = torch.cat([R.to(fac.Lb.dtype), R.new_zeros((B, 1, k),
                                                    dtype=fac.Lb.dtype)], 1)
    lo, hi = local_blocks(plan.p, group)
    bi = on_device(plan, "block_idx", R.device)[lo:hi]
    ti = on_device(plan, "tail_idx", R.device)
    rb = Rp[:, bi]                                      # (B, p, nb, k)
    rt = Rp[:, ti]                                      # (B, nt, k)
    u = ldl_solve(fac.Lb.reshape(B * p, nb, nb), fac.db.reshape(B * p, nb),
                  rb.reshape(B * p, nb, k)).view(B, p, nb, k)
    red = torch.einsum("bpij,bpik->bjk", fac.Bc, u)
    red = rt - (red if group is None else all_reduce(red, group))
    y = ldl_solve(fac.Ls, fac.ds, red)                  # (B, nt, k)
    xb = u - torch.einsum("bpij,bjk->bpik", fac.DinvB, y)
    out = torch.zeros_like(Rp)
    out[:, bi] = xb          # pads land on the discarded row N
    if group is not None:
        all_reduce(out, group)
    out[:, ti] = y
    out = out[:, :N].to(out_dtype)
    return out[..., 0] if vec else out


def solve_refined_blockarrow(fac, plan, kkt_mv, rhs, settings, group=None):
    """Block-arrow solve with iterative refinement on the augmented
    residual (the parts-composed matvec, not a materialized K)."""
    return solve_refined(lambda r: _ba_apply(fac, plan, r, group), kkt_mv,
                         rhs, settings)


def kkt_solve_xz_blockarrow(fac, plan, kkt_mv, bx, bz, settings,
                            group=None):
    n = bx.shape[1]
    sol, ok = solve_refined_blockarrow(fac, plan, kkt_mv,
                                       torch.cat([bx, bz], dim=1), settings,
                                       group)
    return sol[:, :n], sol[:, n:], ok


def kkt_solve_xz2_blockarrow(fac, plan, kkt_mv, bx1, bz1, bx2, bz2,
                             settings, group=None):
    n = bx1.shape[1]
    rhs = torch.stack([torch.cat([bx1, bz1], dim=1),
                       torch.cat([bx2, bz2], dim=1)], dim=2)
    sol, ok = solve_refined_blockarrow(fac, plan, kkt_mv, rhs, settings,
                                       group)
    return sol[:, :n, 0], sol[:, n:, 0], sol[:, :n, 1], sol[:, n:, 1], ok
