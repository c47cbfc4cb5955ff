"""The plain PyTorch version of the batched IPM megakernel (K1a).

Computes what the reference's one-block function
(`clarabel_tpu/ipm/megakernel.py` `compute`) computes for zero,
nonnegative and second-order segments, formula for formula, over a
(B, ·) batch: Ruiz equilibration with SOC rectification, the symmetric
initial point, the Mehrotra predictor-corrector loop over the condensed
KKT (Cholesky plus accept-masked refinement against the true operator),
the termination machine, and finalization.  Every per-lane update is
masked; the loops run while any lane is still active, so each lane's
result is what a loop run for that lane alone gives.  This is what lets
the CUDA kernel (`csrc/megakernel.cu`) run one instance per thread.

Arithmetic is native float64 where the reference uses f32-pair
double-float, triple-float residuals, or f32 norms and step lengths; the
Ruiz scalings alone are computed in float32 from |data|, as in the
reference (clarabel_tpu_torch/DEVIATIONS.md).

This is the port's path on the CPU.  On a card the main path runs the
CUDA kernel; this version then only serves to check it.

Inputs are the kernel's flats, component-major and lane-minor: Ptri
(n(n+1)/2, B) column-major upper triangle, q (n, B), A (n*m, B)
column-major, b (m, B); a batch-constant component may come as a 1-D
(d,) tensor instead.  Outputs are (OUTD, B) float64 values and (2, B)
int32 (status, iterations), OUTD = n + 2m + 13, in the reference's row
order.
"""

import torch

# status codes (statuscodes.SolverStatus), as the kernel writes them
UNSOLVED, SOLVED, PINF, DINF = 0, 1, 2, 3
ALMOST_SOLVED, ALMOST_PINF, ALMOST_DINF = 4, 5, 6
MAX_ITERATIONS, NUMERICAL_ERROR, INSUFFICIENT_PROGRESS = 7, 9, 10

BIG = 1e30
F64 = torch.float64


def _lanes(flat, d, B):
    """(d, B) or batch-constant (d,) flat -> (B, d) float64."""
    if flat.dim() == 1:
        return flat.to(F64).reshape(1, d).expand(B, d)
    return flat.to(F64).t()


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _unpack(Ptri, q, A, b, spec, B):
    """Flats -> per-lane P (B, n, n) full symmetric, q (B, n),
    A (B, m, n), b (B, m)."""
    n, m = spec.n, spec.m
    tri = _lanes(Ptri, n * (n + 1) // 2, B)
    gather = torch.tensor(spec.p_gather, device=tri.device)
    P = tri[:, gather].reshape(B, n, n).transpose(1, 2)   # [b, i, j]
    Acm = _lanes(A, n * m, B).reshape(B, n, m)            # [b, j, k]
    return (P, _lanes(q, n, B), Acm.transpose(1, 2), _lanes(b, m, B))


def ruiz(P, q, A, spec):
    """Ruiz equilibration scalings (d, e, c) computed in float32 from
    |P|, |A|, |q|, with the SOC rectification (reference l.2997-3046)."""
    st = spec.st
    B, n, m = q.shape[0], spec.n, spec.m
    dev = q.device
    d = torch.ones(B, n, dtype=torch.float32, device=dev)
    e = torch.ones(B, m, dtype=torch.float32, device=dev)
    c = torch.ones(B, dtype=torch.float32, device=dev)
    if not st.equilibrate_enable:
        return d, e, c
    smin = torch.tensor(st.equilibrate_min_scaling, dtype=torch.float32)
    smax = torch.tensor(st.equilibrate_max_scaling, dtype=torch.float32)
    smin, smax = smin.to(dev), smax.to(dev)
    Pa = P.to(torch.float32).abs()       # [b, i, j]
    Aa = A.to(torch.float32).abs()       # [b, k, j]
    qa = q.to(torch.float32).abs()
    for _ in range(st.equilibrate_max_iter):
        dwork = torch.maximum(Pa.amax(dim=1), Aa.amax(dim=1))
        ework = Aa.amax(dim=2)
        dwork = torch.where(dwork == 0, 1.0, dwork)
        ework = torch.where(ework == 0, 1.0, ework)
        dwork = 1.0 / torch.sqrt(dwork)
        ework = 1.0 / torch.sqrt(ework)
        dwork = torch.minimum(torch.maximum(dwork, smin / d), smax / d)
        ework = torch.minimum(torch.maximum(ework, smin / e), smax / e)
        Pa = Pa * dwork[:, None, :] * dwork[:, :, None]
        Aa = Aa * dwork[:, None, :] * ework[:, :, None]
        qa = qa * dwork
        d = d * dwork
        e = e * ework
        mean_p = Pa.amax(dim=1).sum(dim=1) / n
        inf_q = qa.amax(dim=1)
        do_cost = (mean_p != 0) & (inf_q != 0)
        scale_cost = torch.maximum(inf_q, mean_p)
        inv = 1.0 / torch.where(scale_cost != 0, scale_cost, 1.0)
        ctmp = torch.where(
            do_cost, torch.minimum(torch.maximum(inv, smin / c), smax / c),
            1.0)
        Pa = Pa * ctmp[:, None, None]
        qa = qa * ctmp[:, None]
        c = c * ctmp
    e = e.clone()
    for kind, lo, hi in spec.segs:
        if kind == "soc":
            e[:, lo:hi] = (e[:, lo:hi].sum(dim=1, keepdim=True)
                           / (hi - lo))
    return d, e, c


class _Ops:
    """The solver's subroutines over one batch's scaled data."""

    def __init__(self, spec, Ps, As, qe, be):
        self.spec = spec
        self.st = spec.st
        self.n, self.m = spec.n, spec.m
        self.segs = spec.segs
        self.Ps, self.As, self.qe, self.be = Ps, As, qe, be
        self.pn = spec.p_nonzero
        st = spec.st
        self.r_abstol = min(st.iterative_refinement_abstol, 1e-14)
        self.r_reltol = min(st.iterative_refinement_reltol, 1e-15)
        self.passes = (0 if not st.iterative_refinement_enable
                       else min(int(st.iterative_refinement_max_iter), 4))
        self.pdiag = (torch.diagonal(Ps, dim1=1, dim2=2).abs().amax(dim=1)
                      if self.pn else torch.zeros_like(qe[:, 0]))

    # ---- products with the scaled data ----
    def Px(self, x):
        if not self.pn:
            return torch.zeros_like(x)
        return (self.Ps * x[:, None, :]).sum(-1)

    def Ax(self, x):
        return (self.As * x[:, None, :]).sum(-1)

    def Aty(self, y):
        return (self.As * y[:, :, None]).sum(1)

    # ---- cone scaling (reference make_scaling, l.1452-1510) ----
    def make_scaling(self, s, z):
        ok = torch.ones_like(s[:, 0], dtype=torch.bool)
        state = []
        for kind, lo, hi in self.segs:
            sg, zg = s[:, lo:hi], z[:, lo:hi]
            if kind == "zero":
                state.append(None)
            elif kind == "nn":
                prod = sg * zg
                ok = ok & (prod > 0).all(dim=1)
                prod = prod.clamp_min(0.0)
                zsafe = torch.where(zg != 0, zg, 1.0)
                ratio = torch.where(zg != 0, sg / zsafe, 0.0)
                w = torch.sqrt(ratio.clamp_min(0.0))
                w2 = w * w
                state.append({"w2": w2, "winv2": 1.0 / w2,
                              "lam": torch.sqrt(prod)})
            else:
                zscale = _soc_res_sqrt(zg)
                sscale = _soc_res_sqrt(sg)
                okg = (zscale > 0) & (sscale > 0)
                zs = torch.where(zscale > 0, zscale, 1.0)
                ss = torch.where(sscale > 0, sscale, 1.0)
                zsinv, ssinv = 1.0 / zs, 1.0 / ss
                eta = torch.sqrt(ss * zsinv)
                w0 = sg[:, 0] * ssinv + zg[:, 0] * zsinv
                w1 = sg[:, 1:] * ssinv[:, None] - zg[:, 1:] * zsinv[:, None]
                w = torch.cat([w0[:, None], w1], dim=1)
                wscale = _soc_res_sqrt(w)
                okg = okg & (wscale > 0)
                ws = torch.where(wscale > 0, wscale, 1.0)
                w = w * (1.0 / ws)[:, None]
                w0n = torch.sqrt(_dot(w[:, 1:], w[:, 1:]) + 1.0)
                w = torch.cat([w0n[:, None], w[:, 1:]], dim=1)
                gamma = ws * 0.5
                den = 1.0 / (sg[:, 0] * ssinv + zg[:, 0] * zsinv
                             + gamma * 2.0)
                lam1 = ((((gamma + zg[:, 0] * zsinv) * ssinv)[:, None]
                         * sg[:, 1:]
                         + ((gamma + sg[:, 0] * ssinv) * zsinv)[:, None]
                         * zg[:, 1:]) * den[:, None])
                lam = torch.cat([gamma[:, None], lam1], dim=1)
                lam = lam * torch.sqrt(ss * zs)[:, None]
                eta2 = eta * eta
                wbar = torch.cat([w[:, :1], -w[:, 1:]], dim=1)
                ok = ok & okg
                state.append({"w": w, "lam": lam, "eta": eta,
                              "eta2": eta2, "etainv": 1.0 / eta,
                              "etainv2": 1.0 / eta2, "wbar": wbar})
        return state, ok

    def hs_diag(self, state):
        parts = []
        for stg, (kind, lo, hi) in zip(state, self.segs):
            if kind == "zero":
                parts.append(torch.zeros_like(self.be[:, lo:hi]))
            elif kind == "nn":
                parts.append(stg["w2"])
            else:
                w2 = 2.0 * stg["w"] * stg["w"]
                eta2 = stg["eta2"][:, None]
                parts.append(torch.cat([(w2[:, :1] - 1.0) * eta2,
                                        (w2[:, 1:] + 1.0) * eta2], dim=1))
        return torch.cat(parts, dim=1)

    def eps_of(self, diag):
        st = self.st
        maxdiag = torch.maximum(self.pdiag, diag.abs().amax(dim=1))
        return (st.static_regularization_constant
                + st.static_regularization_proportional * maxdiag)

    def hinv_apply(self, state, v, eps):
        """Hs^{-1} v, with 1/eps on zero-cone rows; state None is the
        identity scaling of the initial point.  v is (B, m) or
        (B, m, k) for k right-hand sides."""
        out = torch.empty_like(v)
        mat = v.dim() == 3
        for i, (kind, lo, hi) in enumerate(self.segs):
            vg = v[:, lo:hi]
            if kind == "zero":
                r = 1.0 / eps
                out[:, lo:hi] = vg * (r[:, None, None] if mat else r[:, None])
            elif state is None:
                out[:, lo:hi] = vg
            elif kind == "nn":
                w = state[i]["winv2"]
                out[:, lo:hi] = vg * (w[:, :, None] if mat else w)
            else:
                stg = state[i]
                wbar = stg["wbar"] if not mat else stg["wbar"][:, :, None]
                e2 = stg["etainv2"][:, None, None] if mat \
                    else stg["etainv2"][:, None]
                ccoef = (wbar * vg).sum(1, keepdim=True) * 2.0
                base = torch.cat([-vg[:, :1], vg[:, 1:]], dim=1)
                out[:, lo:hi] = (base + ccoef * wbar) * e2
        return out

    def hs_apply(self, state, v):
        """Hs v; the zero-cone block is 0 in the true operator."""
        out = torch.empty_like(v)
        for i, (kind, lo, hi) in enumerate(self.segs):
            vg = v[:, lo:hi]
            if kind == "zero":
                out[:, lo:hi] = 0.0
            elif state is None:
                out[:, lo:hi] = vg
            elif kind == "nn":
                out[:, lo:hi] = vg * state[i]["w2"]
            else:
                stg = state[i]
                w = stg["w"]
                c = _dot(w, vg) * 2.0
                base = torch.cat([-vg[:, :1], vg[:, 1:]], dim=1)
                out[:, lo:hi] = ((base + c[:, None] * w)
                                 * stg["eta2"][:, None])
        return out

    # ---- condensed KKT (reference build_kkt/chol_factor/chol_solve) ----
    def build_kkt(self, state, eps):
        n = self.n
        HinvA = self.hinv_apply(state, self.As, eps)          # (B, m, n)
        S = torch.matmul(self.As.transpose(1, 2), HinvA)     # [b, i, j]
        if self.pn:
            S = S + self.Ps
        idx = torch.arange(n, device=S.device)
        S[:, idx, idx] += eps[:, None]
        L = torch.zeros_like(S)
        Linv = torch.zeros_like(S[:, 0])
        ok = torch.ones_like(eps, dtype=torch.bool)
        for j in range(n):
            acc = S[:, j, j] - (L[:, j, :j] * L[:, j, :j]).sum(-1)
            ok = ok & (acc > 0)
            Ljj = torch.sqrt(acc.clamp_min(0.0))
            Ljj = torch.where(Ljj > 0, Ljj, 1.0)
            L[:, j, j] = Ljj
            Linv[:, j] = 1.0 / Ljj
            if j + 1 < n:
                acc = S[:, j + 1:, j] - (L[:, j + 1:, :j]
                                         * L[:, j:j + 1, :j]).sum(-1)
                L[:, j + 1:, j] = acc * Linv[:, j:j + 1]
        return {"state": state, "eps": eps, "L": L, "Linv": Linv}, ok

    def chol_solve(self, K, w):
        L, Linv, n = K["L"], K["Linv"], self.n
        y = torch.zeros_like(w)
        for j in range(n):
            y[:, j] = (w[:, j] - (L[:, j, :j] * y[:, :j]).sum(-1)) * Linv[:, j]
        x = torch.zeros_like(w)
        for i in range(n - 1, -1, -1):
            x[:, i] = ((y[:, i] - (L[:, i + 1:, i] * x[:, i + 1:]).sum(-1))
                       * Linv[:, i])
        return x

    def apply_once(self, K, bx, bz):
        hb = self.hinv_apply(K["state"], bz, K["eps"])
        xs = self.chol_solve(K, bx + self.Aty(hb))
        zs = self.hinv_apply(K["state"], self.Ax(xs) - bz, K["eps"])
        return xs, zs

    def kkt_resid(self, K, bx, bz, xs, zs):
        """(bx, bz) - K (xs, zs) of the true augmented operator."""
        top = self.Aty(zs) + self.Px(xs)
        bot = self.Ax(xs) - self.hs_apply(K["state"], zs)
        return bx - top, bz - bot

    def refined_solve(self, K, rhs):
        """Accept-masked refinement with joint multi-RHS norms (reference
        refined_solve, l.1861-1988): each lane iterates while its
        residual is above tolerance, at most `passes` times."""
        sols = [self.apply_once(K, bx, bz) for bx, bz in rhs]
        if self.passes <= 0:
            return sols, torch.isfinite(_pair_max(sols))
        normb = _pair_max(rhs)
        es = [self.kkt_resid(K, bx, bz, xs, zs)
              for (bx, bz), (xs, zs) in zip(rhs, sols)]
        norme = _pair_max(es)
        ok = torch.isfinite(norme)
        done = torch.zeros_like(ok)
        tol = self.r_abstol + self.r_reltol * normb
        stop_ratio = self.st.iterative_refinement_stop_ratio
        for _ in range(self.passes):
            active = ~done & ok & (norme > tol)
            if not bool(active.any()):
                break
            news = []
            for (ex, ez), (xs, zs) in zip(es, sols):
                dx, dz = self.apply_once(K, ex, ez)
                news.append((xs + dx, zs + dz))
            newe = [self.kkt_resid(K, bx, bz, xs, zs)
                    for (bx, bz), (xs, zs) in zip(rhs, news)]
            nn_ = _pair_max(newe)
            okn = torch.isfinite(nn_)
            ratio = norme / torch.where(nn_ != 0, nn_, _TINY)
            stop = ratio < stop_ratio
            accept = okn & (~stop | (ratio > 1.0)) & active
            done = (active & (stop | ~okn)) | (~active & done)
            ok = ok & (okn | ~active)
            a = accept[:, None]
            sols = [(torch.where(a, nx, xs), torch.where(a, nz, zs))
                    for (xs, zs), (nx, nz) in zip(sols, news)]
            es = [(torch.where(a, nx, xs), torch.where(a, nz, zs))
                  for (xs, zs), (nx, nz) in zip(es, newe)]
            norme = torch.where(accept, nn_, norme)
        return sols, ok & torch.isfinite(norme)

    # ---- initial point helpers ----
    def shift_to_interior(self, v, primal):
        """reference shift_to_interior (l.2015): move v into the cone
        interior; zero-cone rows project to 0 (primal) or stay (dual)."""
        mm = torch.full_like(v[:, 0], BIG)
        pm = torch.zeros_like(v[:, 0])
        for kind, lo, hi in self.segs:
            vg = v[:, lo:hi]
            if kind == "nn":
                mm = torch.minimum(mm, vg.amin(dim=1))
                pm = pm + vg.clamp_min(0.0).sum(dim=1)
            elif kind == "soc":
                a = vg[:, 0] - _norm(vg[:, 1:])
                mm = torch.minimum(mm, a)
                pm = pm + a.clamp_min(0.0)
        mm = torch.where(torch.isfinite(mm), mm, -1.0)
        pm = torch.where(torch.isfinite(pm), pm, 0.0)
        target = torch.clamp_min(0.1 * pm / max(self.spec.degree, 1), 1.0)
        amt1 = torch.where(mm <= 0, -mm, 0.0)
        amt2 = torch.where(mm <= 0, target,
                           torch.where(mm < target, target - mm, 0.0))
        amt = amt1 + amt2
        out = v.clone()
        for kind, lo, hi in self.segs:
            if kind == "zero":
                if primal:
                    out[:, lo:hi] = 0.0
            elif kind == "nn":
                out[:, lo:hi] = v[:, lo:hi] + amt[:, None]
            else:
                out[:, lo] = v[:, lo] + amt
        return out

    # ---- step length (reference step_length/soc_step_len) ----
    def step_length(self, dz, ds, z, s, amax):
        alpha = amax
        for kind, lo, hi in self.segs:
            if kind == "zero":
                continue
            if kind == "nn":
                for v, dv in ((z[:, lo:hi], dz[:, lo:hi]),
                              (s[:, lo:hi], ds[:, lo:hi])):
                    r = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                                    BIG)
                    alpha = torch.minimum(alpha, r.amin(dim=1))
            else:
                alpha = torch.minimum(alpha, _soc_step_len(z[:, lo:hi],
                                                           dz[:, lo:hi]))
                alpha = torch.minimum(alpha, _soc_step_len(s[:, lo:hi],
                                                           ds[:, lo:hi]))
        return alpha

    # ---- predictor-corrector pieces ----
    def affine_ds(self, state, s):
        out = torch.zeros_like(s)
        for stg, (kind, lo, hi) in zip(state, self.segs):
            if kind == "nn":
                out[:, lo:hi] = stg["lam"] * stg["lam"]
            elif kind == "soc":
                lam = stg["lam"]
                out[:, lo] = _dot(lam, lam)
                out[:, lo + 1:hi] = lam[:, :1] * lam[:, 1:] * 2.0
        return out

    def combined_ds_shift(self, state, dz, ds, sigma_mu):
        out = torch.zeros_like(dz)
        for stg, (kind, lo, hi) in zip(state, self.segs):
            dzg, dsg = dz[:, lo:hi], ds[:, lo:hi]
            if kind == "nn":
                out[:, lo:hi] = dzg * dsg - sigma_mu[:, None]
            elif kind == "soc":
                w, eta, etainv = stg["w"], stg["eta"], stg["etainv"]
                wdz = _mul_w(w, dzg, eta, inv=False)
                wids = _mul_w(w, dsg, etainv, inv=True)
                out[:, lo] = _dot(wids, wdz) - sigma_mu
                out[:, lo + 1:hi] = (wids[:, :1] * wdz[:, 1:]
                                     + wdz[:, :1] * wids[:, 1:])
        return out

    def ds_from_dz_offset(self, state, dsv, z):
        out = torch.zeros_like(dsv)
        for stg, (kind, lo, hi) in zip(state, self.segs):
            dsg, zg = dsv[:, lo:hi], z[:, lo:hi]
            if kind == "nn":
                out[:, lo:hi] = dsg / zg
            elif kind == "soc":
                w, eta, lam = stg["w"], stg["eta"], stg["lam"]
                z1n = _norm(zg[:, 1:])
                resz = (zg[:, 0] - z1n) * (zg[:, 0] + z1n)
                lam1ds1 = _dot(lam[:, 1:], dsg[:, 1:])
                w1ds1 = _dot(w[:, 1:], dsg[:, 1:])
                c = (lam[:, 0] * dsg[:, 0] - lam1ds1) * (1.0 / resz)
                o0 = zg[:, 0] * c + eta * w1ds1
                o1 = (-zg[:, 1:] * c[:, None]
                      + (dsg[:, 1:] + (w1ds1 * (1.0 / (w[:, 0] + 1.0)))[:, None]
                         * w[:, 1:]) * eta[:, None])
                lam0inv = 1.0 / lam[:, 0]
                out[:, lo] = o0 * lam0inv
                out[:, lo + 1:hi] = o1 * lam0inv[:, None]
        return out

    # ---- residuals and info (reference residuals/compute_info) ----
    def residuals(self, x, z, s, tau, kappa, tinv):
        sz = _dot(s, z)
        qx = _dot(self.qe, x)
        bz = _dot(self.be, z)
        Px = self.Px(x)
        xPx = _dot(x, Px)
        rx_inf = -self.Aty(z)
        rz_inf = s + self.Ax(x)
        rx = rx_inf - Px - self.qe * tau[:, None]
        rz = rz_inf - self.be * tau[:, None]
        rtau = qx + bz + kappa + xPx * tinv
        return dict(rx=rx, rz=rz, rtau=rtau, rx_inf=rx_inf, rz_inf=rz_inf,
                    Px=Px, qx=qx, bz=bz, sz=sz, xPx=xPx)

    def compute_info(self, sc, res, x, z, s, kappa, tinv):
        xPx_half = res["xPx"] * tinv * tinv * 0.5
        cost_primal = (res["qx"] * tinv + xPx_half) * sc["cinv"]
        cost_dual = (-res["bz"] * tinv - xPx_half) * sc["cinv"]
        normx = _norm(sc["d"] * x)
        normz = _norm(sc["e"] * z) * sc["cinv"]
        norms = _norm(sc["einv"] * s)
        one = torch.ones_like(normx)
        res_primal_inf = (_norm(sc["dinv"] * res["rx_inf"]) * sc["cinv"]
                          / torch.maximum(one, normz))
        res_dual_inf = torch.maximum(
            _norm(sc["dinv"] * res["Px"]) / torch.maximum(one, normx),
            _norm(sc["einv"] * res["rz_inf"])
            / torch.maximum(one, normx + norms))
        normx = normx * tinv
        normz = normz * tinv
        norms = norms * tinv
        res_primal = (_norm(sc["einv"] * res["rz"]) * tinv
                      / torch.maximum(one, sc["normb"] + normx + norms))
        res_dual = (_norm(sc["dinv"] * res["rx"]) * tinv * sc["cinv"]
                    / torch.maximum(one, sc["normq"] + normx + normz))
        gap_abs = (cost_primal - cost_dual).abs()
        gap_rel = gap_abs / torch.maximum(
            one, torch.minimum(cost_primal.abs(), cost_dual.abs()))
        return dict(cost_primal=cost_primal, cost_dual=cost_dual,
                    res_primal=res_primal, res_dual=res_dual,
                    res_primal_inf=res_primal_inf,
                    res_dual_inf=res_dual_inf, gap_abs=gap_abs,
                    gap_rel=gap_rel, ktratio=kappa * tinv)


_TINY = float(torch.finfo(torch.float32).tiny)


def _pair_max(pairs):
    mx = None
    for a, b in pairs:
        v = torch.maximum(a.abs().amax(dim=1), b.abs().amax(dim=1))
        mx = v if mx is None else torch.maximum(mx, v)
    return mx


def _soc_res_sqrt(X):
    x1n = _norm(X[:, 1:])
    res = (X[:, 0] - x1n) * (X[:, 0] + x1n)
    return torch.where(res > 0, torch.sqrt(res.clamp_min(0.0)), 0.0)


def _mul_w(w, X, eta, inv):
    zeta = _dot(w[:, 1:], X[:, 1:])
    denom = 1.0 / (w[:, 0] + 1.0)
    if not inv:
        c = X[:, 0] + zeta * denom
        y0 = (w[:, 0] * X[:, 0] + zeta) * eta
    else:
        c = -X[:, 0] + zeta * denom
        y0 = (w[:, 0] * X[:, 0] - zeta) * eta
    y1 = (X[:, 1:] + c[:, None] * w[:, 1:]) * eta[:, None]
    return torch.cat([y0[:, None], y1], dim=1)


def _soc_step_len(X, Y):
    """Min positive boundary root per lane (reference soc_step_len)."""
    x0, y0 = X[:, 0], Y[:, 0]
    a0 = torch.where((x0 >= 0) & (y0 < 0),
                     -x0 / torch.where(y0 < 0, y0, -1.0), BIG)
    a = Y[:, 0] * Y[:, 0] - _dot(Y[:, 1:], Y[:, 1:])
    b = (X[:, 0] * Y[:, 0] - _dot(X[:, 1:], Y[:, 1:])) * 2.0
    c = (X[:, 0] * X[:, 0] - _dot(X[:, 1:], X[:, 1:])).clamp_min(0.0)
    d = b * b - a * c * 4.0
    sqrt_d = torch.sqrt(d.clamp_min(0.0))
    t = torch.where(b >= 0, -b - sqrt_d, -b + sqrt_d)
    r1 = torch.where(t != 0, (2.0 * c) / torch.where(t != 0, t, 1.0), BIG)
    r2 = torch.where(a != 0, t / (2.0 * torch.where(a != 0, a, 1.0)), BIG)
    r1 = torch.where(r1 < 0, BIG, r1)
    r2 = torch.where(r2 < 0, BIG, r2)
    root = torch.minimum(r1, r2)
    alpha = torch.where(((a > 0) & (b > 0)) | (d < 0), BIG,
                        torch.where(a == 0, BIG,
                                    torch.where(c == 0,
                                                torch.where(a >= 0, BIG, 0.0),
                                                root)))
    return torch.minimum(alpha, a0)


def _check_convergence(info, bz, qx, tols):
    (tga, tgr, tfe, tia, tir, tkt, s_st, p_st, d_st) = tols
    is_solved = (((info["gap_abs"] < tga) | (info["gap_rel"] < tgr))
                 & (info["res_primal"] < tfe) & (info["res_dual"] < tfe))
    solved = (info["ktratio"] <= 1.0) & is_solved
    kt_big = info["ktratio"] > 1000.0 / tkt
    pinf = (bz < -tia) & (info["res_primal_inf"] < -tir * bz)
    dinf = (qx < -tia) & (info["res_dual_inf"] < -tir * qx)
    st = torch.full_like(bz, UNSOLVED, dtype=torch.int32)
    st = torch.where(kt_big & dinf, d_st, st)
    st = torch.where(kt_big & pinf, p_st, st)
    return torch.where(solved, s_st, st).to(torch.int32)


def tolerances(st):
    """(full, reduced) termination tolerance tuples."""
    full = (st.tol_gap_abs, st.tol_gap_rel, st.tol_feas, st.tol_infeas_abs,
            st.tol_infeas_rel, st.tol_ktratio, SOLVED, PINF, DINF)
    reduced = (st.reduced_tol_gap_abs, st.reduced_tol_gap_rel,
               st.reduced_tol_feas, st.reduced_tol_infeas_abs,
               st.reduced_tol_infeas_rel, st.reduced_tol_ktratio,
               ALMOST_SOLVED, ALMOST_PINF, ALMOST_DINF)
    return full, reduced


def mega_solve_plain(Ptri, q, A, b, spec, B):
    """The whole batched solve over B lanes; see the module docstring for
    the layout.  Returns (vals (OUTD, B) float64, ints (2, B) int32)."""
    st = spec.st
    n, m = spec.n, spec.m
    for name, t in zip("PqAb", (Ptri, q, A, b)):
        if t.dim() == 2 and t.shape[1] != B:
            raise ValueError(f"{name} has {t.shape[1]} lanes, not B={B}")
    P, qr, Ar, br = _unpack(Ptri, q, A, b, spec, B)

    # ---- equilibration: f32 scalings, f64 application ----
    d32, e32, c32 = ruiz(P, qr, Ar, spec)
    d, e, c = d32.to(F64), e32.to(F64), c32.to(F64)
    dinv, einv, cinv = 1.0 / d, 1.0 / e, 1.0 / c
    qe = qr * (d * c[:, None])
    be = br * e
    Ps = (P * (d[:, :, None] * (d[:, None, :] * c[:, None, None]))
          if spec.p_nonzero else torch.zeros_like(P))
    As = Ar * (e[:, :, None] * d[:, None, :])
    sc = dict(d=d, e=e, dinv=dinv, einv=einv, cinv=cinv,
              normq=(dinv * qe).abs().amax(dim=1) * cinv,
              normb=(einv * be).abs().amax(dim=1))
    ops = _Ops(spec, Ps, As, qe, be)

    # ---- initial point (symmetric cones; reference l.3139-3157) ----
    K0, _ = ops.build_kkt(None, ops.eps_of(torch.ones_like(be)))
    if spec.p_nonzero:
        sols, _ = ops.refined_solve(K0, [(-qe, be)])
        x, z = sols[0]
        s = -z
    else:
        sols, _ = ops.refined_solve(
            K0, [(torch.zeros_like(qe), be), (-qe, torch.zeros_like(be))])
        x, ms = sols[0]
        s = -ms
        z = sols[1][1]
    s = ops.shift_to_interior(s, primal=True)
    z = ops.shift_to_interior(z, primal=False)
    tau = torch.ones_like(qe[:, 0])
    kappa = torch.ones_like(tau)

    px, pz, ps, ptau, pkap = x, z, s, tau, kappa
    prev_rp = torch.full_like(tau, BIG)
    prev_rd = prev_rp.clone()
    prev_ga = prev_rp.clone()
    prev_gr = prev_rp.clone()
    mu_f = prev_rp.clone()
    alpha_f = torch.zeros_like(tau)
    sigma_f = torch.ones_like(tau)
    iters = torch.zeros_like(tau, dtype=torch.int32)
    status = torch.full_like(iters, UNSOLVED)
    full_tols, reduced_tols = tolerances(st)
    inv_deg1 = 1.0 / (spec.degree + 1)
    sr = st.stall_detection_ratio
    eps_T = float(torch.finfo(F64).eps)
    W = lambda msk, a, b_: torch.where(msk[:, None], a, b_)

    while bool((status == UNSOLVED).any()):
        active = status == UNSOLVED
        tinv = 1.0 / tau
        res = ops.residuals(x, z, s, tau, kappa, tinv)
        mu = (res["sz"] + tau * kappa) * inv_deg1
        info = ops.compute_info(sc, res, x, z, s, kappa, tinv)
        status1 = _check_convergence(info, res["bz"], res["qx"], full_tols)
        status1 = torch.where(active, status1, status)

        # poor-progress checks with the gap-aware stall test
        rp, rd = info["res_primal"], info["res_dual"]
        going_back = (rd > prev_rd) | (rp > prev_rp)
        stagnating = ((rd > sr * prev_rd) | (rp > sr * prev_rp)) & (
            (info["gap_abs"] > sr * prev_ga) & (info["gap_rel"] > sr * prev_gr))
        after_first = active & (status1 == UNSOLVED) & (iters > 1)
        poor_hi = (info["ktratio"] < 100.0 * eps_T) & (
            (prev_ga < st.tol_gap_abs) | (prev_gr < st.tol_gap_rel))
        tf100 = 100.0 * st.tol_feas
        diverging = (info["ktratio"] < 1.0) & (
            ((rd > tf100) & (rd > 100.0 * prev_rd))
            | ((rp > tf100) & (rp > 100.0 * prev_rp)))
        insuff = ((after_first & stagnating & poor_hi)
                  | (after_first & going_back & diverging))
        status2 = torch.where(insuff, INSUFFICIENT_PROGRESS, status1)
        status2 = torch.where(active & (status2 == UNSOLVED)
                              & (iters >= st.max_iter),
                              MAX_ITERATIONS, status2).to(torch.int32)

        # rollback for insufficient progress
        restore = active & (status2 == INSUFFICIENT_PROGRESS)
        xr, zr, sr_ = W(restore, px, x), W(restore, pz, z), W(restore, ps, s)
        taur = torch.where(restore, ptau, tau)
        kapr = torch.where(restore, pkap, kappa)
        do = active & (status2 == UNSOLVED)
        iters1 = iters + do.to(torch.int32)

        dx, dz, dsv, dtau, dkappa, alpha, sigma, kkt_fail = _pc_step(
            ops, x, z, s, tau, kappa, tinv, res, mu, iters1)

        fail_status = torch.where(kkt_fail, NUMERICAL_ERROR, UNSOLVED)
        small_term = alpha <= max(0.0, st.min_terminate_step_length)
        fail_status = torch.where((fail_status == UNSOLVED) & ~kkt_fail
                                  & small_term, INSUFFICIENT_PROGRESS,
                                  fail_status).to(torch.int32)
        take = ~kkt_fail & ~small_term
        alpha_eff = torch.where(take, alpha, 0.0)
        dotake = do & take
        a = alpha_eff[:, None]

        xn = W(dotake, x + dx * a, xr)
        zn = W(dotake, z + dz * a, zr)
        sn = W(dotake, s + dsv * a, sr_)
        taun = torch.where(dotake, tau + dtau * alpha_eff, taur)
        kapn = torch.where(dotake, kappa + dkappa * alpha_eff, kapr)
        px, pz, ps = W(dotake, x, px), W(dotake, z, pz), W(dotake, s, ps)
        ptau = torch.where(dotake, tau, ptau)
        pkap = torch.where(dotake, kappa, pkap)
        prev_rp = torch.where(dotake, rp, prev_rp)
        prev_rd = torch.where(dotake, rd, prev_rd)
        prev_ga = torch.where(dotake, info["gap_abs"], prev_ga)
        prev_gr = torch.where(dotake, info["gap_rel"], prev_gr)
        mu_f = torch.where(active, mu, mu_f)
        alpha_f = torch.where(do, alpha_eff, alpha_f)
        sigma_f = torch.where(do, sigma, sigma_f)
        status = torch.where(do, fail_status, status2).to(torch.int32)
        iters = iters1
        x, z, s, tau, kappa = xn, zn, sn, taun, kapn

    # ---- finalize ----
    tinv = 1.0 / tau
    res = ops.residuals(x, z, s, tau, kappa, tinv)
    info = ops.compute_info(sc, res, x, z, s, kappa, tinv)
    errored = ((status == NUMERICAL_ERROR)
               | (status == INSUFFICIENT_PROGRESS)
               | (status == MAX_ITERATIONS))
    almost = _check_convergence(info, res["bz"], res["qx"], reduced_tols)
    raw_status = status
    status = torch.where(errored & (almost != UNSOLVED), almost,
                         status).to(torch.int32)
    is_inf = ((status == PINF) | (status == DINF) | (status == ALMOST_PINF)
              | (status == ALMOST_DINF))
    scaleinv = 1.0 / torch.where(is_inf, kappa, tau)
    nan = torch.full_like(tau, float("nan"))
    scalars = [torch.where(is_inf, nan, info["cost_primal"]),
               torch.where(is_inf, nan, info["cost_dual"]),
               info["res_primal"], info["res_dual"], info["gap_abs"],
               info["gap_rel"], mu_f, alpha_f, sigma_f, info["ktratio"],
               tau * scaleinv, kappa * scaleinv, raw_status.to(F64)]
    vals = torch.cat([x * d * scaleinv[:, None],
                      z * e * (scaleinv * cinv)[:, None],
                      s * einv * scaleinv[:, None],
                      torch.stack(scalars, dim=1)], dim=1)
    return vals.t().contiguous(), torch.stack([status, iters]).contiguous()


def _pc_step(ops, x, z, s, tau, kappa, tinv, res, mu, iters1):
    """One Mehrotra predictor-corrector step (reference pc_step,
    l.2839-2977).  alpha is already scaled by max_step_fraction."""
    st = ops.st
    qe, be = ops.qe, ops.be
    state, ok_scale = ops.make_scaling(s, z)
    eps = ops.eps_of(ops.hs_diag(state))
    K, ok_chol = ops.build_kkt(state, eps)
    ok_kkt = ok_scale & ok_chol

    aff_ds = ops.affine_ds(state, s)
    sols, ok1 = ops.refined_solve(K, [(-qe, be), (res["rx"], s - res["rz"])])
    (x2, z2), (x1a, z1a) = sols
    ok_kkt = ok_kkt & ok1

    xi = x * tinv[:, None]
    xi_m_x2 = xi - x2
    tau_den = kappa * tinv - _dot(qe, x2) - _dot(be, z2)
    if ops.pn:
        tau_den = (tau_den + _dot(xi_m_x2, ops.Px(xi_m_x2))
                   - _dot(x2, ops.Px(x2)))

    def tau_recovery(x1, z1, ds_const, rhs_tau, rhs_kappa):
        tau_num = rhs_tau - rhs_kappa * tinv + _dot(qe, x1) + _dot(be, z1)
        if ops.pn:
            tau_num = tau_num + _dot(xi, ops.Px(x1)) * 2.0
        dtau = tau_num / tau_den
        dx = x1 + x2 * dtau[:, None]
        dz = z1 + z2 * dtau[:, None]
        dsv = -(ops.hs_apply(state, dz) + ds_const)
        dkappa = -(rhs_kappa + kappa * dtau) * tinv
        return dx, dz, dsv, dtau, dkappa

    def max_step(dtau, dkappa):
        a_tau = torch.where(dtau < 0, -tau / torch.where(dtau < 0, dtau, -1.0),
                            BIG)
        a_kap = torch.where(dkappa < 0,
                            -kappa / torch.where(dkappa < 0, dkappa, -1.0),
                            BIG)
        return torch.clamp_max(torch.minimum(a_tau, a_kap), 1.0)

    dxa, dza, dsa, dtaua, dkappaa = tau_recovery(x1a, z1a, s, res["rtau"],
                                                 tau * kappa)
    alpha_aff = ops.step_length(dza, dsa, z, s, max_step(dtaua, dkappaa))
    sigma = (1.0 - alpha_aff) ** 3
    m_corr = torch.where(iters1 > 1, 1.0, alpha_aff)
    sigma_mu = sigma * mu

    shift = ops.combined_ds_shift(state, dza * m_corr[:, None], dsa, sigma_mu)
    comb_s = aff_ds + shift
    one_m_sigma = 1.0 - sigma
    comb_x = res["rx"] * one_m_sigma[:, None]
    comb_z = res["rz"] * one_m_sigma[:, None]
    comb_tau = res["rtau"] * one_m_sigma
    comb_kappa = -sigma_mu + dtaua * dkappaa * m_corr + tau * kappa

    ds_const = ops.ds_from_dz_offset(state, comb_s, z)
    solsc, ok3 = ops.refined_solve(K, [(comb_x, ds_const - comb_z)])
    x1c, z1c = solsc[0]
    dx, dz, dsv, dtau, dkappa = tau_recovery(x1c, z1c, ds_const, comb_tau,
                                             comb_kappa)
    kkt_fail = ~(ok_kkt & ok3)
    alpha = ops.step_length(dz, dsv, z, s, max_step(dtau, dkappa))
    alpha = alpha * st.max_step_fraction
    return dx, dz, dsv, dtau, dkappa, alpha, sigma, kkt_fail
