"""Dense quasidefinite LDLᵀ factorization, batched over a leading lane axis.

A port of `clarabel_tpu/linalg/ldl.py`: no pivoting (a symmetric
quasidefinite matrix has an LDLᵀ factor for any symmetric order), with
QDLDL-style dynamic regularization per pivot: if sign(j)·d(j) < eps then
d(j) <- sign(j)·delta.  Every function takes (B, N, N) matrices and
(B, N) or (B, N, k) right-hand sides.
"""

import math

import torch

from . import smallops as so


def ldl_factor(K, signs, dyn_eps=1e-13, dyn_delta=2e-7, dynamic_enable=True):
    """LDLᵀ of (B, N, N) symmetric quasidefinite K with pivot signs (N,) or
    (B, N).  Returns (L, d, ok): unit lower-triangular L (B, N, N), d (B, N)
    and ok (B,), true iff every pivot is finite and nonzero."""
    B, n, _ = K.shape
    signs = signs.to(K.dtype).expand(B, n)
    L = torch.zeros_like(K)
    d = torch.zeros((B, n), dtype=K.dtype, device=K.device)
    for j in range(n):
        # c_i = K[i,j] - sum_{k<j} L[i,k] L[j,k] d_k
        w = L[:, j, :j] * d[:, :j]
        c = K[:, :, j] - so.mv(L[:, :, :j], w)
        dj = c[:, j]
        if dynamic_enable:
            sj = signs[:, j]
            dj = torch.where(sj * dj < dyn_eps, sj * dyn_delta, dj)
        dj_safe = torch.where(dj != 0, dj, torch.ones_like(dj))
        col = c / dj_safe[:, None]
        col[:, :j] = 0.0
        col[:, j] = 1.0
        L[:, :, j] = col
        d[:, j] = dj
    ok = torch.isfinite(d).all(dim=1) & (d != 0).all(dim=1)
    return L, d, ok


def ldl_factor_blocked(K, signs, dyn_eps=1e-13, dyn_delta=2e-7,
                       dynamic_enable=True, block=128):
    """Blocked right-looking LDLᵀ of (B, N, N) K (reference
    `ldl_factor_blocked`, for N > 512): each diagonal block is factored
    with the unblocked `ldl_factor`, the panel below it by a triangular
    solve, and the trailing Schur complement is updated by one product.
    Requires N % block == 0 (the caller pads).  signs are (N,) or (B, N).
    Returns (L, d, ok) as `ldl_factor` does."""
    B, n, _ = K.shape
    if n % block:
        raise ValueError(f"N = {n} is not a multiple of the block {block}")
    signs = signs.to(K.dtype).expand(B, n)
    W = K.clone()
    d = torch.zeros((B, n), dtype=K.dtype, device=K.device)
    for j0 in range(0, n, block):
        j1 = j0 + block
        Lbb, db, _ = ldl_factor(W[:, j0:j1, j0:j1], signs[:, j0:j1],
                                dyn_eps, dyn_delta, dynamic_enable)
        # panel below the block: Lsub = panel Lbb^-T D^-1
        Lsub = torch.linalg.solve_triangular(
            Lbb, W[:, j1:, j0:j1].transpose(-1, -2), upper=False,
            unitriangular=True).transpose(-1, -2) / db[:, None, :]
        # trailing Schur update: W -= Lsub D Lsubᵀ
        W[:, j1:, j1:] -= torch.matmul(Lsub * db[:, None, :],
                                       Lsub.transpose(-1, -2))
        W[:, j1:, j0:j1] = Lsub
        W[:, j0:j1, j0:j1] = Lbb
        d[:, j0:j1] = db
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    L = torch.tril(W, -1) + eye
    ok = torch.isfinite(d).all(dim=1) & (d != 0).all(dim=1)
    return L, d, ok


def ldl_solve(L, d, b):
    """Solve (L D Lᵀ) x = b with two unit-triangular solves."""
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b.unsqueeze(-1)
    y = torch.linalg.solve_triangular(L, b, upper=False, unitriangular=True)
    y = y / d.unsqueeze(-1)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True,
                                      unitriangular=True)
    return x.squeeze(-1) if vec else x


def invert_unit_lower(L):
    """Explicit inverse of unit lower-triangular L in O(log N) products:
    with L = I + N (N nilpotent), L⁻¹ = Π_j (I + (−N)^(2^j))."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    A = -(L - eye)
    inv = eye + A
    power = A
    steps = max(0, math.ceil(math.log2(n)) - 1) if n > 1 else 0
    for _ in range(steps):
        power = so.mm(power, power)
        inv = inv + so.mm(inv, power)
    return inv


def ldl_solve_via_inverse(Linv, d, b):
    """Solve (L D Lᵀ) x = b given the explicit L⁻¹: two products and a
    scale."""
    vec = b.dim() == Linv.dim() - 1
    if vec:
        b = b.unsqueeze(-1)
    y = so.mv(Linv, b)
    y = y / d.unsqueeze(-1)
    x = so.rmv(Linv, y)
    return x.squeeze(-1) if vec else x
