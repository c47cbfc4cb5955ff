"""Batched cone operations over a static ConeLayout.

A port of `clarabel_tpu/cones/ops.py`: each cone family's operations are
tensor ops over a group's (B, count, width) array, with the lane axis
first.  Full conic vectors are (B, m); per-lane scalars are (B,).  The
scaling state is a dict {group name: {field: tensor}}: nn groups hold w
and λ as (B, k), SOC groups w and λ as (B, count, width) and η as
(B, count), PSD groups R, Rinv (B, count, n, n) and λ (B, count, n)
(`cones/psd.py`), exp and pow groups the dual gradient, the dual Hessian,
Hs (B, count, 3, 3) and z, genpow groups the dual gradient, μ and the
Hessian data (d1, d2, p, q, r) (`cones/nonsymmetric.py`).  The sparse
backends read Hs as flat values at host-side KKT coordinates
(`hs_flat_values`, `hs_coords`), with big SOC and genpow cones in their
low-rank form (`soc_rank2_uv`).

Cone math provenance (the reference's reference):
* zero cone       — src/cones/coneops_zerocone.jl
* nonnegative     — src/cones/coneops_nncone.jl
* second order    — src/cones/coneops_socone.jl
* PSD triangle    — src/cones/coneops_psdtrianglecone.jl
* symmetric glue  — src/cones/coneops_symmetric_common.jl
* exp, pow, genpow— src/cones/coneops_{expcone,powcone,genpowcone}.jl,
                    coneops_nonsymmetric_common.jl
"""

from typing import Dict, Tuple

import numpy as np
import torch

from .layout import ConeLayout, ConeGroup, _gather, _scatter, _grow, \
    _srow_set, _on
from . import nonsymmetric as nonsym_ops
from . import psd as psd_ops
from ..linalg.matops import on_device

# the nonsymmetric cones
NONSYM = ("exp", "pow", "genpow")

# large-but-finite stand-in for floatmax in step length ratios
_BIG = 1e30


def _norm(v, dim=-1):
    return torch.sqrt((v * v).sum(dim))


# ---------------------------------------------------------------------------
# second-order cone helpers (batched over the lane and cone axes)
# ---------------------------------------------------------------------------

def _soc_residual(Z):
    """(z0 - ||z1||)(z0 + ||z1||).  reference: coneops_socone.jl:415-419"""
    z1n = _norm(Z[..., 1:])
    return (Z[..., 0] - z1n) * (Z[..., 0] + z1n)


def _sqrt_soc_residual(Z):
    res = _soc_residual(Z)
    return torch.where(res > 0.0, torch.sqrt(torch.clamp_min(res, 0.0)),
                       torch.zeros_like(res))


def _soc_mul_W(w, eta, X):
    """y = W x (symmetric), ECOS fast product.  reference:
    coneops_socone.jl:313-333"""
    zeta = (w[..., 1:] * X[..., 1:]).sum(-1)
    c = X[..., 0] + zeta / (1.0 + w[..., 0])
    y0 = eta * (w[..., 0] * X[..., 0] + zeta)
    y1 = eta[..., None] * (X[..., 1:] + c[..., None] * w[..., 1:])
    return torch.cat([y0[..., None], y1], dim=-1)


def _soc_mul_Winv(w, eta, X):
    """y = W^{-1} x.  reference: coneops_socone.jl:336-357"""
    zeta = (w[..., 1:] * X[..., 1:]).sum(-1)
    c = -X[..., 0] + zeta / (1.0 + w[..., 0])
    etainv = 1.0 / eta
    y0 = etainv * (w[..., 0] * X[..., 0] - zeta)
    y1 = etainv[..., None] * (X[..., 1:] + c[..., None] * w[..., 1:])
    return torch.cat([y0[..., None], y1], dim=-1)


def _soc_circ(Y, Z):
    """x = y ∘ z.  reference: coneops_socone.jl:376-391"""
    x0 = (Y * Z).sum(-1)
    x1 = Y[..., :1] * Z[..., 1:] + Z[..., :1] * Y[..., 1:]
    return torch.cat([x0[..., None], x1], dim=-1)


def _flip_head(X, dim):
    """X with its index-0 entry along `dim` negated."""
    X = X.clone()
    X.select(dim, 0).neg_()
    return X


# ---------------------------------------------------------------------------
# identity scaling / initialization
# ---------------------------------------------------------------------------

def set_identity_scaling(layout: ConeLayout, dtype, B: int, device) -> Dict:
    """reference: coneops_{nncone,socone}.jl set_identity_scaling!"""
    state = {}
    for name, g in layout.groups.items():
        if g.kind == "nn":
            ones = torch.ones((B, g.width), dtype=dtype, device=device)
            state[name] = {"w": ones, "lam": ones.clone()}
        elif g.kind == "soc":
            w = torch.zeros((B, g.count, g.width), dtype=dtype, device=device)
            w[..., 0] = 1.0
            state[name] = {
                "w": w,
                "lam": torch.zeros_like(w),
                "eta": torch.ones((B, g.count), dtype=dtype, device=device),
            }
        elif g.kind == "zero":
            state[name] = {}
        elif g.kind == "psd":
            state[name] = psd_ops.identity_scaling(g, dtype, B, device)
        elif g.kind in NONSYM:
            raise RuntimeError(
                "identity scaling is never used for nonsymmetric cones "
                "(asymmetric problems use unit initialization)")
    return state


def _soc_heads(g: ConeGroup, device):
    return _on(g, "heads", g.idx[:, 0].astype("int64"), device)


def unit_initialization(layout: ConeLayout, dtype, B: int, device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit (z, s) for the asymmetric start.  reference:
    src/variables.jl:213-226 and the per-cone unit_initialization!"""
    z = torch.zeros((B, layout.m), dtype=dtype, device=device)
    s = z.clone()
    for name, g in layout.groups.items():
        if g.kind == "nn":
            ones = torch.ones((B,) + g.idx.shape, dtype=dtype, device=device)
            z, s = _scatter(z, g, ones), _scatter(s, g, ones)
        elif g.kind == "soc":
            z, s = z.clone(), s.clone()
            z[:, _soc_heads(g, device)] = 1.0
            s[:, _soc_heads(g, device)] = 1.0
        elif g.kind == "psd":
            z, s = psd_ops.unit_initialization(g, z, s)
        elif g.kind in NONSYM:
            z, s = nonsym_ops.unit_initialization(g, z, s)
    return z, s


# ---------------------------------------------------------------------------
# margins / shifts (symmetric initialization path)
# ---------------------------------------------------------------------------

def margins(layout: ConeLayout, z, pd: str):
    """Per lane (min margin, sum of positive margins).  reference:
    coneops_compositecone.jl:49-63 and the per-cone margins."""
    B = z.shape[0]
    alpha = torch.full((B,), _BIG, dtype=z.dtype, device=z.device)
    beta = torch.zeros((B,), dtype=z.dtype, device=z.device)
    for name, g in layout.groups.items():
        if g.kind == "nn":
            zg = _grow(z, g)
            alpha = torch.minimum(alpha, zg.amin(dim=1))
            beta = beta + torch.clamp_min(zg, 0.0).sum(dim=1)
        elif g.kind == "soc":
            Z = _gather(z, g)
            a = Z[..., 0] - _norm(Z[..., 1:])
            alpha = torch.minimum(alpha, a.amin(dim=1))
            beta = beta + torch.clamp_min(a, 0.0).sum(dim=1)
        elif g.kind == "psd":
            a, b = psd_ops.margins(g, z)
            alpha = torch.minimum(alpha, a)
            beta = beta + b
    return alpha, beta


def scaled_unit_shift(layout: ConeLayout, z, alpha, pd: str):
    """z += alpha * e per cone, alpha (B,); the zero cone projects to 0 on
    the primal side.  reference: the per-cone scaled_unit_shift!"""
    for name, g in layout.groups.items():
        if g.kind == "nn":
            z = _srow_set(z, g, _grow(z, g) + alpha[:, None])
        elif g.kind == "soc":
            heads = _soc_heads(g, z.device)
            z = z.clone()
            z[:, heads] = z[:, heads] + alpha[:, None]
        elif g.kind == "zero":
            if pd == "primal":
                z = _srow_set(z, g, torch.zeros_like(_grow(z, g)))
        elif g.kind == "psd":
            z = psd_ops.scaled_unit_shift(g, z, alpha)
    return z


# ---------------------------------------------------------------------------
# scaling update
# ---------------------------------------------------------------------------

def update_scaling(layout: ConeLayout, state, s, z, mu, scaling_strategy):
    """NT scaling update for every group.  Returns (new_state, ok (B,)).
    reference: coneops_nncone.jl:77-89, coneops_socone.jl:75-154,
    coneops_compositecone.jl:103-120."""
    ok = torch.ones((s.shape[0],), dtype=torch.bool, device=s.device)
    new_state = {}
    for name, g in layout.groups.items():
        if g.kind == "zero":
            new_state[name] = {}
        elif g.kind == "nn":
            sg, zg = _grow(s, g), _grow(z, g)
            prod = sg * zg
            ok = ok & (prod > 0).all(dim=1)
            prod_safe = torch.clamp_min(prod, 0.0)
            nz = zg != 0
            ratio_safe = torch.where(
                nz, sg / torch.where(nz, zg, torch.ones_like(zg)),
                torch.zeros_like(zg))
            new_state[name] = {
                "w": torch.sqrt(torch.clamp_min(ratio_safe, 0.0)),
                "lam": torch.sqrt(prod_safe),
            }
        elif g.kind == "soc":
            S, Z = _gather(s, g), _gather(z, g)
            zscale = _sqrt_soc_residual(Z)
            sscale = _sqrt_soc_residual(S)
            okg = (zscale > 0) & (sscale > 0)
            zs = torch.where(zscale > 0, zscale, torch.ones_like(zscale))
            ss = torch.where(sscale > 0, sscale, torch.ones_like(sscale))

            eta = torch.sqrt(ss / zs)

            w = S / ss[..., None]
            w = torch.cat([w[..., :1] + Z[..., :1] / zs[..., None],
                           w[..., 1:] - Z[..., 1:] / zs[..., None]], dim=-1)

            wscale = _sqrt_soc_residual(w)
            okg = okg & (wscale > 0)
            ws = torch.where(wscale > 0, wscale, torch.ones_like(wscale))
            w = w / ws[..., None]

            w1sq = (w[..., 1:] ** 2).sum(-1)
            w = torch.cat([torch.sqrt(1.0 + w1sq)[..., None], w[..., 1:]],
                          dim=-1)

            # scaling point λ: reference coneops_socone.jl:115-123
            gamma = 0.5 * ws
            lam1 = (
                ((gamma + Z[..., 0] / zs) / ss)[..., None] * S[..., 1:]
                + ((gamma + S[..., 0] / ss) / zs)[..., None] * Z[..., 1:]
            )
            lam1 = lam1 / (S[..., 0] / ss + Z[..., 0] / zs
                           + 2.0 * gamma)[..., None]
            lam = torch.cat([gamma[..., None], lam1], dim=-1)
            lam = lam * torch.sqrt(ss * zs)[..., None]

            ok = ok & okg.all(dim=1)
            new_state[name] = {"w": w, "lam": lam, "eta": eta}
        elif g.kind == "psd":
            st, okg = psd_ops.update_scaling(g, s, z)
            ok = ok & okg
            new_state[name] = st
        elif g.kind in NONSYM:
            st, okg = nonsym_ops.update_scaling(g, s, z, mu,
                                                scaling_strategy)
            ok = ok & okg
            new_state[name] = st
    return new_state, ok


# ---------------------------------------------------------------------------
# Hs (dense assembly, diagonal, products)
# ---------------------------------------------------------------------------

def _soc_J(width, dtype, device):
    """diag(J) = (1, -1, ..., -1), made on the device (no copy from the
    host, so a CUDA graph can capture it)."""
    return torch.cat([torch.ones((1,), dtype=dtype, device=device),
                      -torch.ones((width - 1,), dtype=dtype, device=device)])


def hs_dense(layout: ConeLayout, state: Dict, like):
    """The full (B, m, m) Hs = blkdiag of the per-cone W'W blocks, in the
    dtype and on the device of `like` (B, ...).  A pad row/column m absorbs
    the bucketed groups' sentinel entries."""
    m = layout.m
    B, dtype, device = like.shape[0], like.dtype, like.device
    H = torch.zeros((B, m + 1, m + 1), dtype=dtype, device=device)
    for name, g in layout.groups.items():
        if g.kind == "zero":
            continue
        if g.kind == "nn":
            w = state[name]["w"]
            row = _on(g, "row", g.idx[0].astype("int64"), device)
            H[:, row, row] = w * w
        elif g.kind == "soc":
            w, eta = state[name]["w"], state[name]["eta"]
            # H_i = eta^2 (2 w w' - J);  reference: coneops_socone.jl:169-187
            blocks = 2.0 * w[..., :, None] * w[..., None, :]
            blocks = blocks - torch.diag(_soc_J(g.width, dtype, device))
            blocks = blocks * (eta ** 2)[..., None, None]
            idx = _on(g, "idx", g.idx.astype("int64"), device)
            H[:, idx[:, :, None], idx[:, None, :]] = blocks.to(dtype)
        elif g.kind in NONSYM + ("psd",):
            idx = _on(g, "idx", g.idx.astype("int64"), device)
            H[:, idx[:, :, None], idx[:, None, :]] = \
                _hs_blocks(g, state[name]).to(dtype)
    return H[:, :m, :m]


def hs_diag(layout: ConeLayout, state: Dict, like):
    """Diagonal of Hs as (B, m), for the regularization scale, without the
    m x m matrix; dtype and device as `like` (B, ...)."""
    dtype = like.dtype
    y = torch.zeros((like.shape[0], layout.m), dtype=dtype,
                    device=like.device)
    for name, g in layout.groups.items():
        if g.kind == "zero":
            continue
        if g.kind == "nn":
            w = state[name]["w"]
            y = _srow_set(y, g, w * w)
        elif g.kind == "soc":
            w, eta = state[name]["w"], state[name]["eta"]
            jd = _soc_J(g.width, dtype, y.device)
            vals = (2.0 * w * w - jd) * (eta ** 2)[..., None]
            y = _scatter(y, g, vals)
        elif g.kind in NONSYM + ("psd",):
            y = _scatter(y, g, torch.diagonal(_hs_blocks(g, state[name]),
                                              dim1=-2, dim2=-1).to(dtype))
    return y


# SOCs (and generalized power cones) at or above this dimension use the
# low-rank Hs form in sparse data mode: only a diagonal enters the
# assembled KKT and the rank-1 terms are applied as a Sherman-Morrison-
# Woodbury correction (kkt/socrank.py).  The reference's counterpart of
# the sparse SOC expansion (reference: cone_types.jl:65-117,
# directldl_datamaps.jl:8-79): the KKT keeps its dimension, and the
# low-rank terms stay outside the factorization in a small dense
# capacitance system.
SOC_RANK2_MIN_DIM = 33


def _is_rank2_soc(g, soc_rank2_min_dim) -> bool:
    return (soc_rank2_min_dim is not None and g.kind == "soc"
            and g.width >= soc_rank2_min_dim)


def _is_lowrank_genpow(g, min_dim) -> bool:
    """Large generalized power cones take the same SMW form: their
    dual-scaling Hs = μ(D + pp' − qq' − rr') is diagonal plus rank 3
    (coneops_genpowcone.jl:14-18, directldl_datamaps.jl:81-167)."""
    return (min_dim is not None and g.kind == "genpow"
            and g.width >= min_dim)


def hs_flat_values(layout: ConeLayout, state: Dict, like,
                   soc_rank2_min_dim=None):
    """Every Hs entry, group by group, as (B, n_hs) in the dtype and on the
    device of `like` (B, ...), in the order of the KKT coordinates of
    `hs_coords`: the value side of the map-based sparse KKT assembly
    (reference: directldl_datamaps.jl)."""
    B, dtype = like.shape[0], like.dtype
    parts = []
    for name, g in layout.groups.items():
        st = state.get(name)
        if g.kind == "zero":
            continue  # Hs = 0: no values
        if g.kind == "nn":
            parts.append(st["w"] * st["w"])
        elif _is_rank2_soc(g, soc_rank2_min_dim):
            # only the η²I diagonal is assembled
            parts.append((st["eta"] ** 2)[..., None].expand(
                B, g.count, g.width).reshape(B, -1))
        elif _is_lowrank_genpow(g, soc_rank2_min_dim):
            dvec = torch.cat([st["d1"], st["d2"][..., None].expand(
                B, g.count, g.dim2)], dim=-1)
            parts.append((st["mu"][:, None, None] * dvec).reshape(B, -1))
        elif g.kind == "soc":
            w, eta = st["w"], st["eta"]
            blocks = 2.0 * w[..., :, None] * w[..., None, :]
            blocks = blocks - torch.diag(_soc_J(g.width, w.dtype, w.device))
            blocks = blocks * (eta ** 2)[..., None, None]
            parts.append(blocks.reshape(B, -1))
        elif g.kind in NONSYM + ("psd",):
            parts.append(_hs_blocks(g, st).reshape(B, -1))
        else:
            raise NotImplementedError(g.kind)
    if not parts:
        return like.new_zeros((B, 0))
    return torch.cat([p.to(dtype) for p in parts], dim=1)


def hs_coords(layout: ConeLayout, n: int, soc_rank2_min_dim=None):
    """Host-side (rows, cols) KKT coordinates of every entry that
    `hs_flat_values` emits, in the same order.  Conic rows are offset by
    n; bucketed-SOC pad entries get the out-of-range sentinel n + m, which
    the assembly drops."""
    m = layout.m
    sentinel = n + m
    rows_out, cols_out = [], []
    for name, g in layout.groups.items():
        if g.kind == "zero":
            continue
        idx = g.idx.astype(np.int64)
        # real indices to n + idx; sentinels stay out of range
        kk = np.where(idx >= m, sentinel, n + idx)
        if g.kind == "nn":
            rows_out.append(kk[0])
            cols_out.append(kk[0])
        elif _is_rank2_soc(g, soc_rank2_min_dim) or \
                _is_lowrank_genpow(g, soc_rank2_min_dim):
            # the diagonal only (the order of the low-rank values)
            rows_out.append(kk.reshape(-1))
            cols_out.append(kk.reshape(-1))
        else:
            r = np.broadcast_to(kk[:, :, None], (g.count, g.width, g.width))
            c = np.broadcast_to(kk[:, None, :], (g.count, g.width, g.width))
            # either side padded: drop the entry
            pad = (r >= sentinel) | (c >= sentinel)
            rows_out.append(np.where(pad, sentinel, r).reshape(-1))
            cols_out.append(np.where(pad, sentinel, c).reshape(-1))
    if not rows_out:
        return (np.zeros(0, dtype=np.int64),) * 2
    return np.concatenate(rows_out), np.concatenate(cols_out)


def soc_rank2_uv(layout: ConeLayout, state: Dict, n: int, like,
                 soc_rank2_min_dim=None):
    """Columns of the low-rank correction of the SMW-corrected sparse KKT
    (kkt/socrank.py), in the dtype and on the device of `like` (B, ...).

    For each rank-2 SOC,  Hs = η²(2ww' − J) = η²I + uu' − vv'  with
    u = √2·η·w and v = √2·η·e₀ (−J = I − 2e₀e₀', w'Jw = 1).  The KKT
    carries −Hs, so  K = K₀ + U S U'  with column signs s_u = −1,
    s_v = +1.  A low-rank genpow cone adds √μ p (sign −1), √μ q̄ and
    √μ r̄ (signs +1).  Returns (U, signs): U is (B, n+m, ncols) with the
    columns in the cones' conic rows, signs (ncols,) float64 on U's device
    (made once); (None, None) when the layout has no low-rank cone."""
    N = n + layout.m
    B, dtype, device = like.shape[0], like.dtype, like.device
    entries = []       # (rows (count, k) on the host, cols, values)
    signs = []
    for name, g in layout.groups.items():
        st = state.get(name)
        rows = n + g.idx.astype(np.int64)   # sentinel pads land on row N
        c = np.arange(g.count)[:, None]
        if _is_rank2_soc(g, soc_rank2_min_dim):
            base = len(signs)
            coef = np.sqrt(2.0) * st["eta"]
            entries.append((rows, base + 2 * c, coef[..., None] * st["w"]))
            entries.append((rows[:, :1], base + 2 * c + 1, coef[..., None]))
            signs.extend([-1.0, 1.0] * g.count)
        elif _is_lowrank_genpow(g, soc_rank2_min_dim):
            base = len(signs)
            smu = torch.sqrt(st["mu"])[:, None, None]
            d1 = g.dim1
            entries.append((rows, base + 3 * c, smu * st["p"]))
            entries.append((rows[:, :d1], base + 3 * c + 1, smu * st["q"]))
            entries.append((rows[:, d1:], base + 3 * c + 2, smu * st["r"]))
            signs.extend([-1.0, 1.0, 1.0] * g.count)
    if not signs:
        return None, None
    U = torch.zeros((B, N + 1, len(signs)), dtype=dtype, device=device)
    for i, (rows, cols, vals) in enumerate(entries):
        r = np.minimum(rows, N)
        cc = np.broadcast_to(cols, r.shape)
        key = f"uv_{n}_{soc_rank2_min_dim}_{i}"
        rt = on_device(layout, key + "r", device, lambda: r.ravel())
        ct = on_device(layout, key + "c", device, lambda: cc.ravel())
        U[:, rt, ct] = vals.reshape(B, -1).to(dtype)
    return U[:, :N], on_device(layout, f"uv_{n}_{soc_rank2_min_dim}_signs",
                               device, lambda: signs)


def _hs_blocks(g: ConeGroup, st):
    """Dense per-cone Hs blocks (B, count, width, width) of a PSD or
    nonsymmetric group."""
    if g.kind == "psd":
        return psd_ops.hs_blocks(g, st)
    return nonsym_ops.hs_blocks(g, st)


def _as_columns(x):
    """(B, m) or (B, m, k) -> ((B, m, k), was a vector)."""
    return (x.unsqueeze(-1), True) if x.dim() == 2 else (x, False)


def mul_Hs(layout: ConeLayout, state: Dict, x):
    """y = Hs x for x (B, m) or (B, m, k).  reference:
    coneops_compositecone.jl:138-150"""
    X, vec = _as_columns(x)
    y = torch.zeros_like(X)
    for name, g in layout.groups.items():
        if g.kind == "zero":
            continue
        if g.kind == "nn":
            w = state[name]["w"][..., None]
            y = _srow_set(y, g, w * (w * _grow(X, g)))
        elif g.kind == "soc":
            w, eta = state[name]["w"][..., None], state[name]["eta"]
            Xg = _gather(X, g)                      # (B, c, d, k)
            c = 2.0 * (w * Xg).sum(dim=2)           # (B, c, k)
            out = _flip_head(Xg, 2)
            out = out + c[:, :, None, :] * w
            out = out * (eta ** 2)[..., None, None]
            y = _scatter(y, g, out)
        elif g.kind == "psd":
            y = _scatter(y, g, psd_ops.mul_Hs(g, state[name], X))
        elif g.kind in NONSYM:
            y = _scatter(y, g, nonsym_ops.mul_Hs(g, state[name], X))
    return y[..., 0] if vec else y


def mul_Hs_inv(layout: ConeLayout, state: Dict, x, eps_zero):
    """y = Hs⁻¹ x per cone group with closed-form inverses, for x (B, m)
    or (B, m, k); `eps_zero` (B,) regularizes the zero-cone block (whose
    true Hs is 0).  SOC: Hs⁻¹ = η⁻²(2w̄w̄'−J), w̄ = Jw; PSD: svec(G X G),
    G = RinvᵀRinv; exp/pow: a 3×3 solve against the stored Hs block;
    genpow: three Sherman–Morrison updates of μ(D + pp' − qq' − rr')."""
    X, vec = _as_columns(x)
    y = torch.zeros_like(X)
    for name, g in layout.groups.items():
        if g.kind == "zero":
            y = _srow_set(y, g, _grow(X, g) / eps_zero[:, None, None])
        elif g.kind == "nn":
            w = state[name]["w"]
            y = _srow_set(y, g, _grow(X, g) / (w * w)[..., None])
        elif g.kind == "soc":
            w, eta = state[name]["w"], state[name]["eta"]
            wbar = torch.cat([w[..., :1], -w[..., 1:]], dim=-1)[..., None]
            Xg = _gather(X, g)                      # (B, c, d, k)
            ccoef = 2.0 * (wbar * Xg).sum(dim=2)    # (B, c, k)
            out = _flip_head(Xg, 2)                 # -J x = [-x0; x1]
            out = out + ccoef[:, :, None, :] * wbar
            out = out / (eta ** 2)[..., None, None]
            y = _scatter(y, g, out)
        elif g.kind == "psd":
            y = _scatter(y, g, psd_ops.mul_Hs_inv(g, state[name], X))
        elif g.kind in NONSYM:
            y = _scatter(y, g, nonsym_ops.mul_Hs_inv(g, state[name], X))
    return y[..., 0] if vec else y


# ---------------------------------------------------------------------------
# step direction RHS components
# ---------------------------------------------------------------------------

def affine_ds(layout: ConeLayout, state: Dict, s):
    """ds = λ ∘ λ (symmetric) or s (nonsymmetric).  reference:
    coneops_compositecone.jl:153-165"""
    ds = torch.zeros_like(s)
    for name, g in layout.groups.items():
        if g.kind == "zero":
            continue
        if g.kind == "nn":
            lam = state[name]["lam"]
            ds = _srow_set(ds, g, lam * lam)
        elif g.kind == "soc":
            lam = state[name]["lam"]
            ds = _scatter(ds, g, _soc_circ(lam, lam))
        elif g.kind == "psd":
            ds = psd_ops.affine_ds(g, state[name], ds)
        elif g.kind in NONSYM:
            ds = _scatter(ds, g, _gather(s, g))
    return ds


def combined_ds_shift(layout: ConeLayout, state: Dict, step_z, step_s,
                      sigma_mu, z):
    """shift = W⁻¹Δs ∘ WΔz − σμe (symmetric) or σμ·g(z) − η with the
    third-order correction η (exp, pow); sigma_mu (B,).  reference:
    coneops_symmetric_common.jl:2-35, coneops_nonsymmetric_common.jl"""
    shift = torch.zeros_like(step_z)
    for name, g in layout.groups.items():
        if g.kind == "zero":
            continue
        if g.kind == "nn":
            w = state[name]["w"]
            dz, ds = _grow(step_z, g), _grow(step_s, g)
            wdz = w * dz
            winv_ds = ds / w
            shift = _srow_set(shift, g, winv_ds * wdz - sigma_mu[:, None])
        elif g.kind == "soc":
            w, eta = state[name]["w"], state[name]["eta"]
            Dz, Ds = _gather(step_z, g), _gather(step_s, g)
            Wdz = _soc_mul_W(w, eta, Dz)
            Winv_ds = _soc_mul_Winv(w, eta, Ds)
            out = _soc_circ(Winv_ds, Wdz)
            out = torch.cat([out[..., :1] - sigma_mu[:, None, None],
                             out[..., 1:]], dim=-1)
            shift = _scatter(shift, g, out)
        elif g.kind == "psd":
            shift = psd_ops.combined_ds_shift(g, state[name], step_z, step_s,
                                              sigma_mu, shift)
        elif g.kind in NONSYM:
            shift = nonsym_ops.combined_ds_shift(g, state[name], step_z,
                                                 step_s, sigma_mu, shift)
    return shift


def ds_from_dz_offset(layout: ConeLayout, state: Dict, ds, z):
    """out = Wᵀ(λ \\ ds) (symmetric) or ds (nonsymmetric).  reference:
    coneops_compositecone.jl:185-202"""
    out = torch.zeros_like(ds)
    for name, g in layout.groups.items():
        if g.kind == "zero":
            continue
        if g.kind == "nn":
            out = _srow_set(out, g, _grow(ds, g) / _grow(z, g))
        elif g.kind == "soc":
            # stable form: reference coneops_socone.jl:241-268
            st = state[name]
            w, eta, lam = st["w"], st["eta"], st["lam"]
            Z, DS = _gather(z, g), _gather(ds, g)
            resz = _soc_residual(Z)
            lam1ds1 = (lam[..., 1:] * DS[..., 1:]).sum(-1)
            w1ds1 = (w[..., 1:] * DS[..., 1:]).sum(-1)
            O = torch.cat([Z[..., :1], -Z[..., 1:]], dim=-1)
            c = lam[..., 0] * DS[..., 0] - lam1ds1
            O = O * (c / resz)[..., None]
            O0 = O[..., :1] + (eta * w1ds1)[..., None]
            O1 = O[..., 1:] + eta[..., None] * (
                DS[..., 1:]
                + (w1ds1 / (1.0 + w[..., 0]))[..., None] * w[..., 1:])
            O = torch.cat([O0, O1], dim=-1) / lam[..., :1]
            out = _scatter(out, g, O)
        elif g.kind == "psd":
            out = psd_ops.ds_from_dz_offset(g, state[name], ds, out)
        elif g.kind in NONSYM:
            out = _scatter(out, g, _gather(ds, g))
    return out


# ---------------------------------------------------------------------------
# step length
# ---------------------------------------------------------------------------

def _ratio_bound(x, dx):
    """-x/dx where dx < 0, else BIG."""
    neg = dx < 0
    return torch.where(neg, -x / torch.where(neg, dx, -torch.ones_like(dx)),
                       torch.full_like(dx, _BIG))


def step_length(layout: ConeLayout, state, dz, ds, z, s, alpha_max,
                settings_ls):
    """Per lane, the largest step α ≤ alpha_max (B,) keeping (z+αdz, s+αds)
    in the cone.  Symmetric cones come first; with a nonsymmetric cone in
    the layout the step is then capped at 1−√eps and each nonsymmetric
    group backtracks from the running minimum.  reference:
    coneops_compositecone.jl:205-243."""
    alpha = alpha_max
    for name, g in layout.groups.items():
        if g.kind == "zero":
            continue
        if g.kind == "nn":
            az = _ratio_bound(_grow(z, g), _grow(dz, g)).amin(dim=1)
            a_s = _ratio_bound(_grow(s, g), _grow(ds, g)).amin(dim=1)
            alpha = torch.minimum(alpha, torch.minimum(az, a_s))
        elif g.kind == "soc":
            az = _soc_step_length_comp(_gather(z, g), _gather(dz, g))
            a_s = _soc_step_length_comp(_gather(s, g), _gather(ds, g))
            alpha = torch.minimum(alpha, torch.minimum(az, a_s))
        elif g.kind == "psd":
            alpha = torch.minimum(
                alpha, psd_ops.step_length(g, state[name], dz, ds, z, s))
    if not layout.is_symmetric:
        eps = float(torch.finfo(z.dtype).eps)
        alpha = torch.clamp_max(alpha, 1.0 - eps ** 0.5)
        for name, g in layout.groups.items():
            if g.kind in NONSYM:
                a = nonsym_ops.step_length(g, dz, ds, z, s, alpha,
                                           settings_ls)
                alpha = torch.minimum(alpha, a)
    return alpha


def _soc_step_length_comp(X, Y):
    """Per lane, the min positive root over the cones of the boundary
    quadratic, cancellation-safe.  X, Y (B, c, d) -> (B,).  reference:
    coneops_socone.jl:443-512"""
    x0, y0 = X[..., 0], Y[..., 0]
    big = torch.full_like(x0, _BIG)
    # scalar-part bound
    a0 = torch.where((x0 >= 0) & (y0 < 0),
                     -x0 / torch.where(y0 < 0, y0, -torch.ones_like(y0)),
                     big)

    a = _soc_residual(Y)
    b = 2.0 * (x0 * y0 - (X[..., 1:] * Y[..., 1:]).sum(-1))
    c = torch.clamp_min(_soc_residual(X), 0.0)
    d = b * b - 4.0 * a * c

    sqrt_d = torch.sqrt(torch.clamp_min(d, 0.0))
    t = torch.where(b >= 0, -b - sqrt_d, -b + sqrt_d)
    one = torch.ones_like(t)
    t_safe = torch.where(t != 0, t, one)
    a_safe = torch.where(a != 0, a, one)
    r1 = torch.where(t != 0, (2.0 * c) / t_safe, big)
    r2 = torch.where(a != 0, t / (2.0 * a_safe), big)
    r1 = torch.where(r1 < 0, big, r1)
    r2 = torch.where(r2 < 0, big, r2)
    root = torch.minimum(r1, r2)

    # edge cases mirror the reference's branch structure
    alpha_i = torch.where(
        ((a > 0) & (b > 0)) | (d < 0),
        big,
        torch.where(a == 0, big,
                    torch.where(c == 0,
                                torch.where(a >= 0, big,
                                            torch.zeros_like(a)),
                                root)))
    return torch.minimum(alpha_i, a0).amin(dim=1)


_logsafe = nonsym_ops._logsafe   # log, -inf where x <= 0 (mathutils.jl)


def compute_barrier(layout: ConeLayout, state, z, s, dz, ds, alpha):
    """f(s+αds) + f*(z+αdz) summed over the cones, per lane; α (B,).
    reference: coneops_compositecone.jl:246-265"""
    barrier = torch.zeros_like(alpha)
    a2 = alpha[:, None]
    for name, g in layout.groups.items():
        if g.kind == "zero":
            continue
        if g.kind == "nn":
            si = _grow(s, g) + a2 * _grow(ds, g)
            zi = _grow(z, g) + a2 * _grow(dz, g)
            barrier = barrier - _logsafe(si * zi).sum(dim=1)
        elif g.kind == "soc":
            a3 = alpha[:, None, None]
            rs = _soc_residual(_gather(s, g) + a3 * _gather(ds, g))
            rz = _soc_residual(_gather(z, g) + a3 * _gather(dz, g))
            per = torch.where((rs > 0) & (rz > 0), -_logsafe(rs * rz) / 2.0,
                              torch.inf)
            barrier = barrier + per.sum(dim=1)
        elif g.kind == "psd":
            barrier = barrier + psd_ops.compute_barrier(g, z, s, dz, ds,
                                                        alpha)
        elif g.kind in NONSYM:
            barrier = barrier + nonsym_ops.compute_barrier(g, z, s, dz, ds,
                                                           alpha)
    return barrier


# ---------------------------------------------------------------------------
# equilibration rectification
# ---------------------------------------------------------------------------

def rectify_equilibration(layout: ConeLayout, e):
    """Scalar (mean) scaling on cones that do not allow elementwise
    equilibration.  Returns (delta, any_changed) with e_new = delta * e.
    reference: coneops_defaults.jl:32-44, coneops_compositecone.jl:28-47"""
    delta = torch.ones_like(e)
    changed = False
    for name, g in layout.groups.items():
        if g.kind in ("zero", "nn"):
            continue
        eg = _gather(e, g)  # (B, count, width)
        if g.true_dims is not None:
            tdims = torch.as_tensor(g.true_dims, dtype=e.dtype,
                                    device=e.device)
            mean = eg.sum(dim=-1, keepdim=True) / tdims[:, None]
        else:
            mean = eg.mean(dim=-1, keepdim=True)
        eg_safe = torch.where(eg != 0, eg, torch.ones_like(eg))
        delta = _scatter(delta, g, mean / eg_safe)
        changed = True
    return delta, changed
