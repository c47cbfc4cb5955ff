"""Multilevel nested-dissection (multifrontal) KKT backend, batched over a
leading lane axis.

A port of `clarabel_tpu/kkt/multifrontal.py`.  It executes the NestedPlan
of structure_nd.py: a level-synchronous multifrontal LDLᵀ in which every
tree level is one batched dense factorization over same-shaped padded
frontal matrices, B·cnt of them.  It is the multilevel generalization of
the single-level block-arrow backend (kkt/blockarrow.py) and the
counterpart of the reference's fill-reducing sparse LDL backends
(QDLDL/CHOLMOD, reference: src/kktsolvers/direct-ldl/directldl_qdldl.jl)
on grid- and mesh-structured problems.

Per level (bottom-up): gather the K entries each node owns into its
front, extend-add the children's update matrices, partially factor the
leading rows(t) pivots, emit the Schur update over bnd(t).  The solve is
a bottom-up forward sweep and a top-down backward sweep with static
index maps.  Every sum of overlapping contributions (the extend-add, the
forward sweep's boundary updates) runs in a fixed order
(`linalg.matops.SegmentSum`).  Iterative refinement against the
parts-composed KKT matvec keeps the accuracy, as in the other backends.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..linalg.ldl import ldl_solve
from ..linalg.matops import SegmentSum, on_device
from ..settings import torch_dtype
from ..structure_nd import NestedLevel, NestedPlan
from .blockarrow import dyn_kwargs, factor_batch
from .refine import solve_refined


class MFLevelFactor(NamedTuple):
    L: torch.Tensor       # (B, cnt, nr, nr)
    d: torch.Tensor       # (B, cnt, nr)
    B: torch.Tensor       # (B, cnt, nr, nbd) coupling rows(t) x bnd(t)
    DinvB: torch.Tensor   # (B, cnt, nr, nbd)


class MFFactor(NamedTuple):
    levels: Tuple[MFLevelFactor, ...]   # root first, like the plan
    ok: torch.Tensor                    # (B,)


def _level_cache(lv: NestedLevel, name, build):
    """A per-level helper built from the level's host arrays, made once."""
    cache = lv.__dict__.setdefault("_helpers", {})
    h = cache.get(name)
    if h is None:
        h = build()
        cache[name] = h
    return h


def _extend_summer(child_lv: NestedLevel, parent_f: int) -> SegmentSum:
    """The children's update matrices (2·cnt, nbd_c, nbd_c), flattened,
    summed into their parents' fronts (cnt, f, f): up_pos places each
    boundary entry in the parent's front; its sentinel (the parent's front
    size) drops."""
    def build():
        up = child_lv.up_pos.astype(np.int64)               # (2cnt, nbd_c)
        pid = np.arange(child_lv.cnt, dtype=np.int64) // 2
        f = parent_f
        dest = (pid[:, None, None] * f * f + up[:, :, None] * f
                + up[:, None, :])
        bad = (up[:, :, None] >= f) | (up[:, None, :] >= f)
        cnt = child_lv.cnt // 2
        return SegmentSum(np.where(bad, -1, dest), cnt * f * f)

    return _level_cache(child_lv, ("extend", parent_f), build)


def _extend_add(F, child_U, child_lv: NestedLevel):
    """F (B, cnt, f, f) plus the children's updates child_U
    (B, 2·cnt, nbd_c, nbd_c) at their up_pos positions."""
    B, cnt, f, _ = F.shape
    add = _extend_summer(child_lv, f)(child_U.reshape(B, -1).to(F.dtype))
    return F + add.view(B, cnt, f, f)


def _assemble_level_fronts(Kp, lv: NestedLevel, N: int, dtype):
    """Gather the K entries this level's nodes own into padded fronts
    (B, cnt, f, f): rows(t) x front(t) from K, the bnd x bnd quadrant
    zeroed (its entries belong to ancestors), unit pivots at row pads."""
    dev = Kp.device
    fi = on_device(lv, "front_idx", dev, lambda: np.concatenate(
        [lv.rows_idx, lv.bnd_idx], axis=1))
    F = Kp[:, fi[:, :, None], fi[:, None, :]].to(dtype)
    valid = fi < N
    F = torch.where(valid[:, :, None] & valid[:, None, :], F,
                    torch.zeros((), dtype=dtype, device=dev))
    if lv.nbd:
        F[:, :, lv.nr:, lv.nr:] = 0.0
    pad = (~valid[:, :lv.nr]).to(dtype)
    F[:, :, :lv.nr, :lv.nr] += torch.diag_embed(pad)
    return F


def factor_from_level_blocks(fronts, plan: NestedPlan, settings,
                             factor_dtype) -> MFFactor:
    """Factor the per-level fronts, fronts[li] (B, cnt, f, f), bottom-up."""
    dyn = dyn_kwargs(settings)
    fdtype = torch_dtype(factor_dtype)
    facs = [None] * len(plan.levels)
    child_U = None
    ok = None
    for li in range(plan.depth, -1, -1):
        lv = plan.levels[li]
        F = fronts[li].to(fdtype)
        Bsz, cnt, f, _ = F.shape
        nr, nbd = lv.nr, lv.nbd
        if child_U is not None:
            F = _extend_add(F, child_U, plan.levels[li + 1])
        D = F[:, :, :nr, :nr]
        Bm = F[:, :, :nr, nr:]
        rsigns = on_device(lv, "rows_signs", F.device).to(fdtype)
        L, d, okb = factor_batch(D.reshape(Bsz * cnt, nr, nr),
                                 rsigns.expand(Bsz, cnt, nr).reshape(-1, nr),
                                 dyn)
        okl = okb.view(Bsz, cnt).all(dim=1)
        ok = okl if ok is None else ok & okl
        L, d = L.view(Bsz, cnt, nr, nr), d.view(Bsz, cnt, nr)
        if nbd:
            DinvB = ldl_solve(L.reshape(-1, nr, nr), d.reshape(-1, nr),
                              Bm.reshape(-1, nr, nbd)).view(Bsz, cnt, nr,
                                                            nbd)
            # the update forwards the children's accumulated bnd x bnd
            # contributions (F's trailing quadrant after the extend-add)
            # plus the local Schur term
            child_U = (F[:, :, nr:, nr:]
                       - torch.einsum("bcij,bcik->bcjk", Bm, DinvB))
        else:
            DinvB = Bm
            child_U = None
        facs[li] = MFLevelFactor(L=L, d=d, B=Bm, DinvB=DinvB)
    return MFFactor(levels=tuple(facs), ok=ok)


def assemble_and_factor_multifrontal(P, A, Hs, plan: NestedPlan, signs,
                                     settings, factor_dtype) -> MFFactor:
    """Dense data with a plan: gather the fronts out of the regularized
    K (B, N, N) and factor them."""
    n, m = plan.n, plan.m
    N = n + m
    K_true = torch.cat([torch.cat([P, A.transpose(-1, -2)], dim=2),
                        torch.cat([A, -Hs], dim=2)], dim=1)
    maxdiag = torch.diagonal(K_true, dim1=-2, dim2=-1).abs().amax(dim=1)
    eps = (settings.static_regularization_constant
           + settings.static_regularization_proportional * maxdiag)
    K_reg = K_true + torch.diag_embed(signs * eps[:, None])
    # a pad row/column so sentinel gathers read zeros
    Kp = torch.nn.functional.pad(K_reg, (0, 1, 0, 1))
    fdtype = torch_dtype(factor_dtype)
    fronts = [_assemble_level_fronts(Kp, lv, N, fdtype)
              for lv in plan.levels]
    return factor_from_level_blocks(fronts, plan, settings, factor_dtype)


def _bnd_summer(lv: NestedLevel, N: int) -> SegmentSum:
    """Each node's boundary contributions (cnt·nbd) summed into the KKT
    rows, sentinels (>= N) dropped."""
    return _level_cache(lv, ("bnd", N), lambda: SegmentSum(
        lv.bnd_idx.astype(np.int64).ravel(), N))


def _mf_apply(fac: MFFactor, plan: NestedPlan, rhs):
    """Apply the multifrontal factorization to rhs (B, N) or (B, N, k), at
    the factor's dtype, returning rhs's dtype."""
    vec = rhs.dim() == 2
    R = rhs.unsqueeze(-1) if vec else rhs
    out_dtype = R.dtype
    B, N, k = R.shape
    dt = fac.levels[0].L.dtype
    dev = R.device
    W = R.to(dt)
    zero_row = W.new_zeros((B, 1, k))

    # forward sweep: leaves -> root
    us = [None] * len(plan.levels)
    for li in range(plan.depth, -1, -1):
        lv = plan.levels[li]
        lf = fac.levels[li]
        cnt, nr, nbd = lv.cnt, lv.nr, lv.nbd
        ridx = on_device(lv, "rows_idx", dev)
        rb = torch.cat([W, zero_row], dim=1)[:, ridx]     # (B, cnt, nr, k)
        u = ldl_solve(lf.L.reshape(-1, nr, nr), lf.d.reshape(-1, nr),
                      rb.reshape(-1, nr, k)).view(B, cnt, nr, k)
        us[li] = u
        if nbd:
            contrib = torch.einsum("bcij,bcik->bcjk", lf.B, u)
            W = W - _bnd_summer(lv, N)(contrib.reshape(B, cnt * nbd, k))

    # backward sweep: root -> leaves
    X = W.new_zeros((B, N + 1, k))
    for li in range(0, plan.depth + 1):
        lv = plan.levels[li]
        lf = fac.levels[li]
        cnt, nr, nbd = lv.cnt, lv.nr, lv.nbd
        if nbd:
            bidx = on_device(lv, "bnd_idx", dev)
            xb = X[:, bidx]                               # (B, cnt, nbd, k)
            xr = us[li] - torch.einsum("bcij,bcjk->bcik", lf.DinvB, xb)
        else:
            xr = us[li]
        flat = lv.rows_idx.ravel()
        rows = on_device(lv, "rows_real", dev, lambda: flat[flat < N])
        pos = on_device(lv, "rows_real_pos", dev,
                        lambda: np.flatnonzero(flat < N))
        X[:, rows] = xr.reshape(B, cnt * nr, k)[:, pos]

    X = X[:, :N].to(out_dtype)
    return X[..., 0] if vec else X


def kkt_solve_xz_multifrontal(fac, plan, kkt_mv, bx, bz, settings):
    n = bx.shape[1]
    sol, ok = solve_refined(lambda r: _mf_apply(fac, plan, r), kkt_mv,
                            torch.cat([bx, bz], dim=1), settings)
    return sol[:, :n], sol[:, n:], ok & fac.ok


def kkt_solve_xz2_multifrontal(fac, plan, kkt_mv, bx1, bz1, bx2, bz2,
                               settings):
    n = bx1.shape[1]
    rhs = torch.stack([torch.cat([bx1, bz1], dim=1),
                       torch.cat([bx2, bz2], dim=1)], dim=2)
    sol, ok = solve_refined(lambda r: _mf_apply(fac, plan, r), kkt_mv, rhs,
                            settings)
    return (sol[:, :n, 0], sol[:, n:, 0], sol[:, :n, 1], sol[:, n:, 1],
            ok & fac.ok)
