"""PSD-triangle cone operations, batched over a leading lane axis.

A port of `clarabel_tpu/cones/psd.py`.  A group of c cones of side n is a
(B, c, t) block, t = n(n+1)/2, in scaled-triangle (svec) storage: the
upper triangle column by column, off-diagonals times √2.  NT scaling comes
from chol(S), chol(Z) and the SVD of L₂ᵀL₁; step lengths from eigenvalues;
the barrier from a Cholesky logdet.

Clique-size bucketed groups (`ConeLayout` with more than 4 PSD sides) hold
a side-k cone in the leading k×k block of the bucket's side-n matrix; the
pad block is pinned to the identity (or to 2⁴⁰·I inside the scaling
update), which makes every factorization exact on the real block.

Deviations from the reference, none of which changes a result beyond
rounding (DEVIATIONS.md #12):
* eigenvalues come from `torch.linalg.eigvalsh` at every side; the
  reference's closed forms for sides ≤ 3 (`_eigvalsh_sym`) exist only
  because the TPU's float64 `eigvalsh` returns NaN;
* a failed Cholesky is read from `cholesky_ex`'s `info`, where the
  reference reads a NaN factor; both zero the failed factor.

Cone math provenance (the reference's reference):
src/cones/coneops_psdtrianglecone.jl, coneops_symmetric_common.jl.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from .layout import ConeGroup, _gather, _scatter, _on

_ISQRT2 = 1.0 / math.sqrt(2.0)

# Pad-block diagonal inside the NT scaling update: far from the real
# singular values, so the SVD never mixes pad and real subspaces, and a
# power of two, so the pad block of R and Rinv is exactly the identity.
_PAD_SCALE = float(2.0 ** 40)


@lru_cache(maxsize=None)
def _tri_indices(n: int):
    """(rows, cols, scale, diag) of the column-major triu svec ordering
    (reference: coneops_psdtrianglecone.jl:469-483)."""
    rows, cols = [], []
    for col in range(n):
        for row in range(col + 1):
            rows.append(row)
            cols.append(col)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    diag = rows == cols
    scale_in = np.where(diag, 1.0, _ISQRT2)   # svec value -> matrix entry
    return rows, cols, scale_in, diag


@lru_cache(maxsize=None)
def _mat_map(n: int):
    """(n*n,) svec position of each matrix entry and its scale, so that
    svec_to_mat is one gather."""
    rows, cols, scale, _ = _tri_indices(n)
    pos = np.zeros((n, n), np.int64)
    sc = np.zeros((n, n))
    pos[rows, cols] = pos[cols, rows] = np.arange(len(rows))
    sc[rows, cols] = sc[cols, rows] = scale
    return pos.ravel(), sc.ravel()


@lru_cache(maxsize=None)
def _svec_basis(n: int) -> np.ndarray:
    """(t, n, n) orthonormal symmetric basis E_p with svec(X)_p = <E_p, X>."""
    rows, cols, _, _ = _tri_indices(n)
    E = np.zeros((len(rows), n, n))
    for p, (i, j) in enumerate(zip(rows, cols)):
        if i == j:
            E[p, i, i] = 1.0
        else:
            E[p, i, j] = E[p, j, i] = _ISQRT2
    return E


def _const(arr, like):
    return torch.as_tensor(arr, dtype=like.dtype, device=like.device)


def svec_to_mat(X, n: int):
    """(..., t) -> (..., n, n) symmetric."""
    pos, sc = _mat_map(n)
    M = X[..., torch.as_tensor(pos, device=X.device)] * _const(sc, X)
    return M.reshape(X.shape[:-1] + (n, n))


def mat_to_svec(M, n: int):
    """(..., n, n) -> (..., t): M_ii on the diagonal, (M_ij + M_ji)/√2 off
    it."""
    rows, cols, _, diag = _tri_indices(n)
    r = torch.as_tensor(rows, device=M.device)
    c = torch.as_tensor(cols, device=M.device)
    up, lo = M[..., r, c], M[..., c, r]
    return torch.where(torch.as_tensor(diag, device=M.device), up,
                       (up + lo) * _ISQRT2)


def _diag_svec_positions(n: int) -> np.ndarray:
    k = np.arange(n)
    return (k * (k + 1)) // 2 + k


def _diag_rows(g: ConeGroup, device):
    """Rows of the conic vector that hold the group's diagonal entries,
    without the pad entries of a bucketed group."""
    dp = _diag_svec_positions(g.psd_n)
    rows = g.idx[:, dp]
    if g.true_dims is not None:
        rows = rows[dp[None, :] < np.asarray(g.true_dims)[:, None]]
    return _on(g, "psd_diag_rows", rows.ravel().astype(np.int64), device)


def _sides(g: ConeGroup) -> np.ndarray:
    """(count,) true side of each cone of a bucketed group."""
    tds = np.asarray(g.true_dims, dtype=np.int64)
    return np.round((np.sqrt(8.0 * tds + 1.0) - 1.0) / 2.0).astype(np.int64)


def _pad_diag(g: ConeGroup):
    """(count, n) float mask of the pad diagonal entries of a bucketed
    group, or None when the group is exact.  Adding it to the diagonal
    pins each pad block to the identity: chol(blkdiag(S, I)) =
    blkdiag(chol(S), I), the logdet unchanged, the NT scaling
    block-diagonal with W_pad = I."""
    if g.true_dims is None:
        return None
    return (np.arange(g.psd_n)[None, :] >= _sides(g)[:, None]).astype(
        np.float64)


def _add_pad_eye(M, pad, value=1.0):
    """M + value * diag(pad) over (B, c, n, n); a no-op when pad is None.
    `value` is a float or a (B, c, 1) tensor."""
    if pad is None:
        return M
    return M + torch.diag_embed(value * _const(pad, M))


def _chol(M):
    """Batched Cholesky and its success flag; a failed factor reads 0."""
    L, info = torch.linalg.cholesky_ex(M)
    ok = info == 0
    return torch.where(ok[..., None, None], L, 0.0), ok


# ---------------------------------------------------------------------------
# the group operations that cones/ops.py dispatches to
# ---------------------------------------------------------------------------

def identity_scaling(g: ConeGroup, dtype, B: int, device):
    n, c = g.psd_n, g.count
    eye = torch.eye(n, dtype=dtype, device=device).expand(B, c, n, n)
    return {"R": eye.clone(), "Rinv": eye.clone(),
            "lam": torch.ones((B, c, n), dtype=dtype, device=device)}


def unit_initialization(g: ConeGroup, z, s):
    rows = _diag_rows(g, z.device)
    z, s = z.clone(), s.clone()
    z[:, rows] = 1.0
    s[:, rows] = 1.0
    return z, s


def margins(g: ConeGroup, zvec):
    """Per lane (min eigenvalue, sum of positive eigenvalues)."""
    pad = _pad_diag(g)
    Z = svec_to_mat(_gather(zvec, g), g.psd_n)
    if pad is None:
        e = torch.linalg.eigvalsh(Z)
        return e.amin(dim=(1, 2)), torch.clamp_min(e, 0.0).sum(dim=(1, 2))
    # pad blocks at a value above each real block's spectral radius, so
    # the first k eigenvalues of a side-k cone are its real spectrum
    padval = 1.0 + torch.sqrt((Z * Z).sum(dim=(-2, -1)))
    e = torch.linalg.eigvalsh(_add_pad_eye(Z, pad, padval[..., None]))
    real = torch.as_tensor(
        np.arange(g.psd_n)[None, :] < _sides(g)[:, None], device=Z.device)
    beta = torch.where(real, torch.clamp_min(e, 0.0), 0.0).sum(dim=(1, 2))
    return e[..., 0].amin(dim=1), beta


def scaled_unit_shift(g: ConeGroup, z, alpha):
    rows = _diag_rows(g, z.device)
    z = z.clone()
    z[:, rows] = z[:, rows] + alpha[:, None]
    return z


def update_scaling(g: ConeGroup, s, z):
    """NT scaling from chol(S), chol(Z) and the SVD of L₂ᵀL₁: λ, R =
    L₁VΛ^{-1/2}, Rinv = Λ^{-1/2}UᵀL₂ᵀ.  Returns (state, ok (B,)).
    reference: coneops_psdtrianglecone.jl:78-143"""
    n = g.psd_n
    pad = _pad_diag(g)
    S = _add_pad_eye(svec_to_mat(_gather(s, g), n), pad, _PAD_SCALE)
    Z = _add_pad_eye(svec_to_mat(_gather(z, g), n), pad, _PAD_SCALE)
    L1, ok1 = _chol(S)
    L2, ok2 = _chol(Z)
    ok = (ok1 & ok2).all(dim=1)

    tmp = torch.einsum("bcji,bcjk->bcik", L2, L1)      # L2ᵀ L1
    U, lam, Vt = torch.linalg.svd(tmp)
    lam_safe = torch.clamp_min(lam, torch.finfo(lam.dtype).tiny)
    lam_isqrt = 1.0 / torch.sqrt(lam_safe)
    R = torch.einsum("bcij,bckj->bcik", L1, Vt) * lam_isqrt[..., None, :]
    Rinv = lam_isqrt[..., :, None] * torch.einsum("bcji,bckj->bcik", U, L2)
    return {"R": R, "Rinv": Rinv, "lam": lam}, ok


def _mul_w_mat(R, X, transpose: bool):
    """Rᵀ X R (W x, :N) or R X Rᵀ (Wᵀ x, :T) in matrix form, over
    (B, c, n, n).  reference: coneops_psdtrianglecone.jl:409-437"""
    if transpose:
        return torch.einsum("bcij,bcjk,bclk->bcil", R, X, R)
    return torch.einsum("bcji,bcjk,bckl->bcil", R, X, R)


def hs_blocks(g: ConeGroup, state):
    """Dense per-cone Hs = skron(RRᵀ) blocks, (B, c, t, t):
    Hs[p, q] = <E_p, A E_q A>, A = RRᵀ."""
    R = state["R"]
    A = torch.einsum("bcij,bckj->bcik", R, R)
    E = _const(_svec_basis(g.psd_n), R)
    M = torch.einsum("bcij,qjk,bckl->bcqil", A, E, A)
    return torch.einsum("pij,bcqij->bcpq", E, M)


def _cols_to_mats(Xg, n):
    """(B, c, t, k) -> (B, c, k, n, n)."""
    return svec_to_mat(Xg.transpose(-1, -2), n)


def _mats_to_cols(M, n):
    """(B, c, k, n, n) -> (B, c, t, k)."""
    return mat_to_svec(M, n).transpose(-1, -2)


def mul_Hs(g: ConeGroup, state, X):
    """Hs x = svec(A X A), A = RRᵀ, for X (B, m, k): (B, c, t, k)."""
    n = g.psd_n
    R = state["R"]
    A = torch.einsum("bcij,bckj->bcik", R, R)[:, :, None]
    M = _cols_to_mats(_gather(X, g), n)
    return _mats_to_cols(A @ M @ A, n)


def mul_Hs_inv(g: ConeGroup, state, X):
    """Hs⁻¹ x = svec(G X G), G = RinvᵀRinv, for X (B, m, k):
    (B, c, t, k)."""
    n = g.psd_n
    Rinv = state["Rinv"]
    G = torch.einsum("bcji,bcjk->bcik", Rinv, Rinv)[:, :, None]
    M = _cols_to_mats(_gather(X, g), n)
    return _mats_to_cols(G @ M @ G, n)


def affine_ds(g: ConeGroup, state, ds):
    """ds = λ ∘ λ = diag(λ²).  reference: coneops_psdtrianglecone.jl:
    190-205"""
    lam = state["lam"]
    vals = lam.new_zeros(lam.shape[:2] + (g.width,))
    vals[..., _diag_svec_positions(g.psd_n)] = lam * lam
    return _scatter(ds, g, vals)


def combined_ds_shift(g: ConeGroup, state, step_z, step_s, sigma_mu, shift):
    """shift = W⁻¹Δs ∘ WΔz − σμe, sigma_mu (B,).  reference:
    coneops_symmetric_common.jl:2-35"""
    n = g.psd_n
    R, Rinv = state["R"], state["Rinv"]
    Dz = svec_to_mat(_gather(step_z, g), n)
    Ds = svec_to_mat(_gather(step_s, g), n)
    WDz = _mul_w_mat(R, Dz, transpose=False)       # Rᵀ Δz R
    WiDs = _mul_w_mat(Rinv, Ds, transpose=True)    # Rinv Δs Rinvᵀ
    C = 0.5 * (WiDs @ WDz + WDz @ WiDs)
    out = mat_to_svec(C, n)
    dp = _diag_svec_positions(n)
    out[..., dp] = out[..., dp] - sigma_mu[:, None, None]
    return _scatter(shift, g, out)


def ds_from_dz_offset(g: ConeGroup, state, ds, out):
    """out = Wᵀ(λ \\ ds), (λ \\ Z)_ij = 2 Z_ij / (λ_i + λ_j).
    reference: coneops_psdtrianglecone.jl:218-227, 336-354"""
    n = g.psd_n
    R, lam = state["R"], state["lam"]
    Z = svec_to_mat(_gather(ds, g), n)
    X = 2.0 * Z / (lam[..., :, None] + lam[..., None, :])
    return _scatter(out, g, mat_to_svec(_mul_w_mat(R, X, True), n))


def step_length(g: ConeGroup, state, dz, ds, z, s):
    """Per lane, the largest step from the least eigenvalue of
    Λ^{-1/2}(WΔ)Λ^{-1/2} for Δz and W⁻ᵀΔs, min over the cones.
    reference: coneops_psdtrianglecone.jl:230-254, 439-466"""
    n = g.psd_n
    R, Rinv, lam = state["R"], state["Rinv"], state["lam"]
    lam_isqrt = 1.0 / torch.sqrt(lam)

    def component(d_vec, Rx, transpose):
        Dt = _mul_w_mat(Rx, svec_to_mat(_gather(d_vec, g), n), transpose)
        M = lam_isqrt[..., :, None] * Dt * lam_isqrt[..., None, :]
        gamma = torch.linalg.eigvalsh(0.5 * (M + M.transpose(-1, -2))).amin(dim=-1)
        per = torch.where(gamma < 0,
                          1.0 / torch.clamp_min(-gamma, 1e-300), math.inf)
        return per.amin(dim=1)

    return torch.minimum(component(dz, R, False),
                         component(ds, Rinv, True))


def compute_barrier(g: ConeGroup, z, s, dz, ds, alpha):
    """-logdet(S) - logdet(Z) at the shifted point, per lane; +inf outside
    the cone.  alpha (B,)."""
    n = g.psd_n
    pad = _pad_diag(g)
    a3 = alpha[:, None, None]

    def logdet_term(x, dx):
        X = _add_pad_eye(svec_to_mat(_gather(x, g) + a3 * _gather(dx, g),
                                     n), pad)
        L, ok = _chol(X)
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        good = diag > 0
        val = 2.0 * torch.log(torch.where(good, diag, 1.0)).sum(-1)
        return torch.where(ok & good.all(dim=-1), -val, math.inf).sum(dim=1)

    return logdet_term(z, dz) + logdet_term(s, ds)
