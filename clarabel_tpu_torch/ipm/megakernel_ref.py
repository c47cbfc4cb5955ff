"""The plain PyTorch version of the batched IPM megakernel (K1a-K1e).

Computes what the reference's one-block function
(`clarabel_tpu/ipm/megakernel.py` `compute`) computes for zero,
nonnegative, second-order, PSD-triangle (side ≤ 3), exponential, power and
generalized power segments, formula for formula, over a (B, ·) batch: Ruiz
equilibration with cone rectification, the symmetric initial point (or the
unit initialization when the layout has a nonsymmetric segment), the
Mehrotra predictor-corrector loop over the condensed KKT (Cholesky plus
accept-masked refinement against the true operator), the termination
machine, and finalization.  With exp or pow segments (K1b) the loop adds
the dual and primal-dual 3×3 scalings, the third-order corrections, the
joint feasibility backtrack, and per lane the PrimalDual→Dual strategy
machine with the barrier backtrack of Dual lanes.  Generalized power
segments (K1c) have the dual scaling only, with Hs = μ(D + pp' − qq' − rr')
inverted by three Sherman–Morrison updates, no third-order correction, and
pin every lane to Dual from the start.  PSD segments (K1d) take the NT
scaling from clamped Cholesky factors and a one-sided Jacobi SVD, their
step lengths from Jacobi eigenvalues and their barrier from a Cholesky
logdet.  With `MegaSpec.two_phase` (K1e, nn, SOC and PSD layouts only)
a float32 first phase runs predictor-corrector steps in plain float32
until each lane hands off to the float64 loop (`_phase1`).
Every per-lane update is masked; the loops run while any lane is still
active, so each lane's result is what a loop run for that lane alone
gives.  This is what lets the CUDA kernel (`csrc/megakernel.cu`) run one
instance per thread.

Arithmetic is native float64 where the reference uses f32-pair
double-float, triple-float residuals, or f32 norms, step lengths, Newton
starts and barrier checks; the Ruiz scalings alone are computed in float32
from |data|, as in the reference (clarabel_tpu_torch/DEVIATIONS.md).

This is the port's path on the CPU.  On a card the main path runs the
CUDA kernel; this version then only serves to check it.

Inputs are the kernel's flats, component-major and lane-minor: Ptri
(n(n+1)/2, B) column-major upper triangle, q (n, B), A (n*m, B)
column-major, b (m, B); a batch-constant component may come as a 1-D
(d,) tensor instead.  Outputs are (OUTD, B) float64 values and (4, B)
int32 (status, iterations, final scaling strategy, iterations of the
float32 first phase), OUTD = n + 2m + 13, the values in the reference's
row order.
"""

import math

import torch

from ..cones.nonsymmetric import _wright_omega

# status codes (statuscodes.SolverStatus), as the kernel writes them
UNSOLVED, SOLVED, PINF, DINF = 0, 1, 2, 3
ALMOST_SOLVED, ALMOST_PINF, ALMOST_DINF = 4, 5, 6
MAX_ITERATIONS, NUMERICAL_ERROR, INSUFFICIENT_PROGRESS = 7, 9, 10

BIG = 1e30
F64 = torch.float64
EPS64 = float(torch.finfo(F64).eps)
EPS32 = float(torch.finfo(torch.float32).eps)

# scaling strategies (reference src/types.jl:73-76)
PRIMAL_DUAL, DUAL = 0, 1
NONSYM = ("exp", "pow")     # the 3-d nonsymmetric cones (K1b)
# the nonsymmetric step cap (reference l.2169-2172: 1 - 2^-12, where the
# Julia reference's 1 - sqrt(eps) rounds to 1 in f32; DEVIATIONS.md #11)
STEP_CAP = 1.0 - 2.0 ** -12
# trip limits of the joint feasibility backtrack (reference l.2209) and of
# the one-sided Newton iteration of the pow primal gradient (l.1029)
FEAS_TRIPS, NR_TRIPS = 60, 50
# hand-off rules of the float32 first phase (K1e; reference l.79-82): a
# lane leaves it when its step falls to P1_MIN_STEP, when its mu stops
# contracting by P1_STALL_RATIO from iteration P1_STALL_FROM_ITER on, or
# at the cap min(P1_CAP, max_iter) (MegaSpec.p1_cap)
P1_MIN_STEP, P1_STALL_RATIO, P1_STALL_FROM_ITER, P1_CAP = 0.01, 0.9, 5, 25


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
        if kind not in ("zero", "nn"):
            e[:, lo:hi] = (e[:, lo:hi].sum(dim=1, keepdim=True)
                           / (hi - lo))
    return d, e, c


class _Ops:
    """The solver's subroutines over one batch's scaled data, in the data's
    dtype: float64, or float32 in the first phase (`f32=True`), which also
    takes at most one refinement pass at float32 tolerances (reference
    l.89, 1842-1849) and stops the Jacobi sweeps at float32 rounding
    (DEVIATIONS.md #12)."""

    def __init__(self, spec, Ps, As, qe, be, f32=False):
        self.spec = spec
        self.st = spec.st
        self.n, self.m = spec.n, spec.m
        self.segs = spec.segs
        self.alphas = spec.alphas
        self.gp_alphas = spec.gp_alphas
        self.sweeps = spec.psd_sweeps
        self.nonsym = spec.nonsym
        self.Ps, self.As, self.qe, self.be = Ps, As, qe, be
        self.pn = spec.p_nonzero
        st = spec.st
        if f32:
            self.r_abstol, self.r_reltol = 1e-7, 3e-7
            self.passes = int(st.iterative_refinement_enable)
            self.jacobi_eps = EPS32
        else:
            self.r_abstol = min(st.iterative_refinement_abstol, 1e-14)
            self.r_reltol = min(st.iterative_refinement_reltol, 1e-15)
            self.passes = (0 if not st.iterative_refinement_enable
                           else min(int(st.iterative_refinement_max_iter), 4))
            self.jacobi_eps = EPS64
        self.pdiag = (torch.diagonal(Ps, dim1=1, dim2=2).abs().amax(dim=1)
                      if self.pn else torch.zeros_like(qe[:, 0]))
        # per-lane trip counts of the searches, kept when mega_solve_plain
        # is given a `trips` dict
        self.trips = None

    # ---- products with the scaled data ----
    def Px(self, x):
        if not self.pn:
            return torch.zeros_like(x)
        return (self.Ps * x[:, None, :]).sum(-1)

    def Ax(self, x):
        return (self.As * x[:, None, :]).sum(-1)

    def Aty(self, y):
        return (self.As * y[:, :, None]).sum(1)

    # ---- cone scaling (reference make_scaling, l.1355-1510) ----
    def make_scaling(self, s, z, mu, strat, live):
        """The scaling state per segment and ok (B,).  mu and strat (B,)
        choose the exp/pow Hs (Dual: mu·H_dual; PrimalDual: the BFGS
        form); `live` (B,) marks the lanes whose state is used."""
        ok = torch.ones_like(s[:, 0], dtype=torch.bool)
        state = []
        for (kind, lo, hi), a, al in zip(self.segs, self.alphas,
                                         self.gp_alphas):
            sg, zg = s[:, lo:hi], z[:, lo:hi]
            if kind == "zero":
                state.append(None)
            elif kind == "psd":
                # a breakdown of the chol factors is not fatal; non-finite
                # R or Rinv is (reference l.1418-1451)
                stg, fin = _psd_scaling(sg, zg, psd_side(hi - lo),
                                        self.sweeps, self.jacobi_eps)
                ok = ok & fin
                state.append(stg)
            elif kind == "genpow":
                d1 = len(al)
                zc, sc_ = list(zg.unbind(1)), list(sg.unbind(1))
                stg, okg = _gp_state(zc[:d1], zc[d1:], al, mu)
                ok = ok & okg & _gp_feas_primal(sc_[:d1], sc_[d1:], al)
                state.append(stg)
            elif kind in NONSYM:
                S3, Z3 = list(sg.unbind(1)), list(zg.unbind(1))
                g, Hd, zt, feas = _nonsym_grad_hess(kind, a, S3, Z3, live)
                pd_hs, _ = _pd_scaling_3d(Hd, g, zt, S3, Z3)
                use_pd = strat == PRIMAL_DUAL
                Hs = [torch.where(use_pd, p, h * mu)
                      for p, h in zip(pd_hs, Hd)]
                fin = _all_finite(Hs)
                ok = ok & feas & fin
                # a breakdown of the 3x3 factor is not fatal (reference
                # l.1397-1414, docs/DEVIATIONS.md #16)
                F, _ = _chol3_fac(Hs)
                state.append({"g": g, "Hd": Hd, "Hs": Hs, "F": F, "z": Z3})
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
            elif kind == "psd":
                # skron(RR') diagonal: slot (i,i) -> A_ii^2, (i<j) ->
                # A_ii A_jj + A_ij^2, A = RR'
                np_ = stg["np"]
                A = _mm(stg["R"], _mT(stg["R"]))
                parts.append(torch.stack(
                    [A[i][i] * A[i][i] if i == j
                     else A[i][i] * A[j][j] + A[i][j] * A[i][j]
                     for j in range(np_) for i in range(j + 1)], dim=1))
            elif kind == "genpow":
                parts.append(torch.stack(_gp_hs_diag(stg), dim=1))
            elif kind in NONSYM:
                h = stg["Hs"]
                parts.append(torch.stack([h[0], h[3], h[5]], dim=1))
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
            elif kind in ("psd", "genpow"):
                f = _psd_hinv if kind == "psd" else _gp_hinv
                out[:, lo:hi] = (torch.stack(
                    [f(state[i], vg[:, :, c]) for c in range(vg.shape[2])],
                    dim=2) if mat else f(state[i], vg))
            elif kind in NONSYM:
                F = [f[:, None] for f in state[i]["F"]] if mat \
                    else state[i]["F"]
                out[:, lo:hi] = torch.stack(
                    _chol3_solve_fac(F, list(vg.unbind(1))), dim=1)
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
            elif kind == "psd":
                stg = state[i]
                np_, R = stg["np"], stg["R"]
                X = _psd_unpack(list(vg.unbind(1)), np_)
                W = _mm(_mm(_mT(R), X), R)
                out[:, lo:hi] = _psd_pack(_mm(_mm(R, W), _mT(R)), np_)
            elif kind == "genpow":
                out[:, lo:hi] = torch.stack(
                    _gp_hs_apply(state[i], list(vg.unbind(1))), dim=1)
            elif kind in NONSYM:
                out[:, lo:hi] = torch.stack(
                    _hmul3(state[i]["Hs"], list(vg.unbind(1))), dim=1)
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
            elif kind == "psd":
                for e in _psd_eigvals(_psd_unpack(list(vg.unbind(1)),
                                                  psd_side(hi - lo)),
                                      self.sweeps):
                    mm = torch.minimum(mm, e)
                    pm = pm + e.clamp_min(0.0)
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
            elif kind == "psd":
                for j in range(psd_side(hi - lo)):
                    k = lo + j * (j + 1) // 2 + j
                    out[:, k] = v[:, k] + amt
            else:
                out[:, lo] = v[:, lo] + amt
        return out

    # ---- step length (reference step_length/soc_step_len) ----
    def step_length(self, state, dz, ds, z, s, amax, live):
        """Symmetric segments first; with nonsymmetric segments the step
        is then capped and backtracked jointly over all of them (reference
        l.2091-2229) on the `live` lanes."""
        alpha = amax
        for stg, (kind, lo, hi) in zip(state, self.segs):
            if kind in ("zero", "genpow") + NONSYM:
                continue
            if kind == "psd":
                alpha = torch.minimum(alpha, _psd_step_comp(
                    dz[:, lo:hi], stg["R"], stg["lam"], False, self.sweeps,
                    self.jacobi_eps))
                alpha = torch.minimum(alpha, _psd_step_comp(
                    ds[:, lo:hi], stg["Rinv"], stg["lam"], True,
                    self.sweeps, self.jacobi_eps))
            elif kind == "nn":
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
        if not self.nonsym:
            return alpha
        alpha = torch.clamp_max(alpha, STEP_CAP)
        step = self.st.linesearch_backtrack_step
        amin = self.st.min_terminate_step_length
        done = ~live
        trips = torch.zeros_like(alpha, dtype=torch.int32)
        for _ in range(FEAS_TRIPS):
            if bool(done.all()):
                break
            trips += (~done).to(torch.int32)
            newdone = done | self.nonsym_feasible(z, s, dz, ds, alpha)
            alpha = torch.where(newdone, alpha, alpha * step)
            killed = ~newdone & (alpha < amin)
            alpha = torch.where(killed, 0.0, alpha)
            done = newdone | killed
        if self.trips is not None:
            self.trips["feas"].append(trips)
        return alpha

    def nonsym_feasible(self, z, s, dz, ds, a):
        """(z + a dz, s + a ds) strictly inside every nonsymmetric
        segment's dual and primal cone, per lane."""
        ok = torch.ones_like(a, dtype=torch.bool)
        a2 = a[:, None]
        for (kind, lo, hi), al, gal in zip(self.segs, self.alphas,
                                           self.gp_alphas):
            if kind not in NONSYM + ("genpow",):
                continue
            Z = list((z[:, lo:hi] + a2 * dz[:, lo:hi]).unbind(1))
            S = list((s[:, lo:hi] + a2 * ds[:, lo:hi]).unbind(1))
            if kind == "genpow":
                d1 = len(gal)
                ok = (ok & _gp_feas_dual(Z[:d1], Z[d1:], gal)
                      & _gp_feas_primal(S[:d1], S[d1:], gal))
            elif kind == "exp":
                ok = ok & _exp_feas_dual(Z) & _exp_feas_primal(S)
            else:
                ok = ok & _pow_feas_dual(Z, al) & _pow_feas_primal(S, al)
        return ok

    def barrier_at(self, z, s, dz, ds, tau, kappa, dtau, dkappa, a,
                   newton=None):
        """The total barrier at the point a step a (B,) along the
        direction, float64 (reference barrier_at, l.2230-2269, in f32).
        `newton`, a list, receives each genpow segment's per-lane Newton
        trips."""
        cur_tau = tau + a * dtau
        cur_kappa = kappa + a * dkappa
        zs = z + a[:, None] * dz
        ss = s + a[:, None] * ds
        mu_a = ((zs * ss).sum(-1) + cur_tau * cur_kappa) / (
            self.spec.degree + 1)
        bar = ((self.spec.degree + 1) * _nslog(mu_a) - _nslog(cur_tau)
               - _nslog(cur_kappa))
        for (kind, lo, hi), al, gal in zip(self.segs, self.alphas,
                                           self.gp_alphas):
            zg, sg = zs[:, lo:hi], ss[:, lo:hi]
            if kind == "nn":
                bar = bar - _nslog(sg * zg).sum(-1)
            elif kind == "psd":
                np_ = psd_side(hi - lo)
                lz, okz = _psd_logdet(_psd_unpack(list(zg.unbind(1)), np_))
                ls, oks = _psd_logdet(_psd_unpack(list(sg.unbind(1)), np_))
                bar = bar + torch.where(okz & oks, -(lz + ls), BIG)
            elif kind == "genpow":
                bar = bar + _gp_barrier(gal, list(zg.unbind(1)),
                                        list(sg.unbind(1)), newton)
            elif kind == "soc":
                rs = sg[:, 0] * sg[:, 0] - (sg[:, 1:] * sg[:, 1:]).sum(-1)
                rz = zg[:, 0] * zg[:, 0] - (zg[:, 1:] * zg[:, 1:]).sum(-1)
                bar = bar + torch.where((rs > 0) & (rz > 0),
                                        -0.5 * _nslog(rs * rz), BIG)
            elif kind in NONSYM:
                bar = bar + _nonsym_barrier(kind, al, list(zg.unbind(1)),
                                            list(sg.unbind(1)))
        return bar

    def barrier_backtrack(self, z, s, dz, ds, tau, kappa, dtau, dkappa,
                          alpha, active):
        """Backtrack alpha on the `active` lanes until the barrier is
        below 1, at most linesearch_max_iter trips (reference pc_step,
        l.2948-2976)."""
        step = self.st.linesearch_backtrack_step
        done = ~active
        trips = torch.zeros_like(alpha, dtype=torch.int32)
        rec = self.trips
        for _ in range(int(self.st.linesearch_max_iter)):
            if bool(done.all()):
                break
            trips += (~done).to(torch.int32)
            newton = [] if rec is not None else None
            good = self.barrier_at(z, s, dz, ds, tau, kappa, dtau, dkappa,
                                   alpha, newton) < 1.0
            if newton:
                rec["newton"].append(torch.where(done, 0, sum(newton)))
            newdone = done | good
            alpha = torch.where(newdone, alpha, alpha * step)
            done = newdone
        if rec is not None:
            rec["barrier"].append(trips)
        return alpha

    # ---- predictor-corrector pieces ----
    def affine_ds(self, state, s):
        out = torch.zeros_like(s)
        for stg, (kind, lo, hi) in zip(state, self.segs):
            if kind in NONSYM + ("genpow",):
                out[:, lo:hi] = s[:, lo:hi]
            elif kind == "psd":
                for j, l in enumerate(stg["lam"]):
                    out[:, lo + j * (j + 1) // 2 + j] = l * l
            elif kind == "nn":
                out[:, lo:hi] = stg["lam"] * stg["lam"]
            elif kind == "soc":
                lam = stg["lam"]
                out[:, lo] = _dot(lam, lam)
                out[:, lo + 1:hi] = lam[:, :1] * lam[:, 1:] * 2.0
        return out

    def combined_ds_shift(self, state, dz, ds, sigma_mu):
        out = torch.zeros_like(dz)
        for stg, (kind, lo, hi), al in zip(state, self.segs, self.alphas):
            dzg, dsg = dz[:, lo:hi], ds[:, lo:hi]
            if kind == "psd":
                # W^{-1}Δs ∘ WΔz − σμe, the circ the symmetrized product
                np_, R, Ri = stg["np"], stg["R"], stg["Rinv"]
                Dz = _psd_unpack(list(dzg.unbind(1)), np_)
                Ds = _psd_unpack(list(dsg.unbind(1)), np_)
                WDz = _mm(_mm(_mT(R), Dz), R)
                WiDs = _mm(_mm(Ri, Ds), _mT(Ri))
                Pm, Qm = _mm(WiDs, WDz), _mm(WDz, WiDs)
                C = [[(Pm[i][j] + Qm[i][j]) * 0.5 for j in range(np_)]
                     for i in range(np_)]
                for i in range(np_):
                    C[i][i] = C[i][i] - sigma_mu
                out[:, lo:hi] = _psd_pack(C, np_)
            elif kind == "genpow":
                # no third-order correction
                out[:, lo:hi] = torch.stack(
                    [gj * sigma_mu for gj in stg["g"]], dim=1)
            elif kind in NONSYM:
                ds3, v3 = list(dsg.unbind(1)), list(dzg.unbind(1))
                if kind == "exp":
                    eta = _exp_higher_corr(stg["Hd"], stg["z"], ds3, v3)
                else:
                    eta = _pow_higher_corr(stg["Hd"], stg["z"], al, ds3, v3)
                out[:, lo:hi] = torch.stack(
                    [gj * sigma_mu - ej for gj, ej in zip(stg["g"], eta)],
                    dim=1)
            elif kind == "nn":
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
            if kind in NONSYM + ("genpow",):
                out[:, lo:hi] = dsg
            elif kind == "psd":
                # W'(λ \ Δs): (λ \ Z)_ij = 2 Z_ij / (λ_i + λ_j)
                np_, R, lam = stg["np"], stg["R"], stg["lam"]
                Zm = _psd_unpack(list(dsg.unbind(1)), np_)
                X = [[Zm[i][j] * 2.0 * (1.0 / (lam[i] + lam[j]))
                      for j in range(np_)] for i in range(np_)]
                out[:, lo:hi] = _psd_pack(_mm(_mm(R, X), _mT(R)), np_)
            elif kind == "nn":
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


# ---- exponential and power cones (K1b; reference l.848-1098, 1240-1353,
# 2271-2325, 2464-2584).  A segment's values are 3-lists of (B,) tensors;
# Hessians are 6-tuples (h11, h12, h13, h22, h23, h33). ----

def _nslog(x):
    """log, with -BIG where x <= 0 (reference nslogsafe)."""
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)), -BIG)


def _all_finite(vals):
    ok = torch.isfinite(vals[0])
    for v in vals[1:]:
        ok = ok & torch.isfinite(v)
    return ok


def _dot3(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _hmul3(H, v):
    h11, h12, h13, h22, h23, h33 = H
    return [h11 * v[0] + h12 * v[1] + h13 * v[2],
            h12 * v[0] + h22 * v[1] + h23 * v[2],
            h13 * v[0] + h23 * v[1] + h33 * v[2]]


def _chol3_fac(H):
    """Closed-form 3x3 Cholesky with clamped pivots; returns the factor
    (l21, l31, l32, 1/l11, 1/l22, 1/l33) and ok (reference chol3_fac)."""
    h11, h12, h13, h22, h23, h33 = H
    ok = h11 > 0
    l11 = torch.sqrt(h11.clamp_min(0.0))
    l11 = torch.where(l11 > 0, l11, 1.0)
    i11 = 1.0 / l11
    l21 = h12 * i11
    l31 = h13 * i11
    d2 = h22 - l21 * l21
    ok = ok & (d2 > 0)
    l22 = torch.sqrt(d2.clamp_min(0.0))
    l22 = torch.where(l22 > 0, l22, 1.0)
    i22 = 1.0 / l22
    l32 = (h23 - l31 * l21) * i22
    d3 = h33 - l31 * l31 - l32 * l32
    ok = ok & (d3 > 0)
    l33 = torch.sqrt(d3.clamp_min(0.0))
    l33 = torch.where(l33 > 0, l33, 1.0)
    return (l21, l31, l32, i11, i22, 1.0 / l33), ok


def _chol3_solve_fac(F, b):
    l21, l31, l32, i11, i22, i33 = F
    y1 = b[0] * i11
    y2 = (b[1] - l21 * y1) * i22
    y3 = (b[2] - l31 * y1 - l32 * y2) * i33
    x3 = y3 * i33
    x2 = (y2 - l32 * x3) * i22
    x1 = (y1 - l21 * x2 - l31 * x3) * i11
    return [x1, x2, x3]


def _exp_feas_dual(Z):
    z1, z2, z3 = Z
    zsafe = torch.where(z1 < 0, z1, -1.0)
    res = z2 - z1 - z1 * _nslog(-z3 / zsafe)
    return (z3 > 0) & (z1 < 0) & (res > 0)


def _exp_feas_primal(S):
    s1, s2, s3 = S
    res = s2 * _nslog(s3 / torch.where(s2 > 0, s2, 1.0)) - s1
    return (s3 > 0) & (s2 > 0) & (res > 0)


def _exp_grad_hess_dual(Z):
    """reference: coneops_expcone.jl:370-399"""
    z1, z2, z3 = Z
    l = _nslog(-z3 / z1)
    r = -z1 * l - z1 + z2
    c2 = 1.0 / r
    g = [c2 * l - 1.0 / z1, -c2, (c2 * z1 - 1.0) / z3]
    rr = r * r
    z1sq = z1 * z1
    H11 = (rr - z1 * r + l * l * z1sq) / (rr * z1sq)
    H12 = -l / rr
    H22 = 1.0 / rr
    H13 = (z2 - z1) / (rr * z3)
    H23 = -z1 / (rr * z3)
    H33 = (rr - z1 * r + z1sq) / (rr * z3 * z3)
    return g, (H11, H12, H13, H22, H23, H33)


def _exp_grad_primal(S):
    """reference: coneops_expcone.jl:284-297; the Wright omega is the
    float64 algorithm of cones/nonsymmetric.py (DEVIATIONS.md #11)."""
    s1, s2, s3 = S
    w = _wright_omega(1.0 - s1 / s2 - _nslog(s2 / s3))
    g1 = 1.0 / ((w - 1.0) * s2)
    g2 = g1 + g1 * _nslog(w * s2 / s3) - 1.0 / s2
    g3 = w / ((1.0 - w) * s3)
    return [g1, g2, g3]


def _pow_phi_dual(Z, a):
    return torch.exp(_nslog(Z[0] / a) * (2.0 * a)
                     + _nslog(Z[1] / (1.0 - a)) * (2.0 - 2.0 * a))


def _pow_feas_dual(Z, a):
    res = _pow_phi_dual(Z, a) - Z[2] * Z[2]
    return (Z[0] > 0) & (Z[1] > 0) & (res > 0)


def _pow_feas_primal(S, a):
    res = torch.exp(_nslog(S[0]) * (2.0 * a)
                    + _nslog(S[1]) * (2.0 - 2.0 * a)) - S[2] * S[2]
    return (S[0] > 0) & (S[1] > 0) & (res > 0)


def _pow_grad_hess_dual(Z, a):
    """reference: coneops_powcone.jl:408-440"""
    z1, z2, z3 = Z
    phi = _pow_phi_dual(Z, a)
    ipsi = 1.0 / (phi - z3 * z3)
    g1p = phi * ipsi * (2.0 * a) / z1
    g2p = phi * ipsi * (2.0 - 2.0 * a) / z2
    g3p = z3 * ipsi * (-2.0)
    H11 = (g1p * g1p - phi * ipsi * (2.0 * a * (2.0 * a - 1.0)) / (z1 * z1)
           + (1.0 - a) / (z1 * z1))
    H12 = g1p * g2p - phi * ipsi * (4.0 * a * (1.0 - a)) / (z1 * z2)
    H22 = (g2p * g2p
           - phi * ipsi * (2.0 * (1.0 - a) * (1.0 - 2.0 * a)) / (z2 * z2)
           + a / (z2 * z2))
    H13 = g1p * g3p
    H23 = g2p * g3p
    H33 = g3p * g3p + ipsi * 2.0
    g = [-g1p - (1.0 - a) / z1, -g2p - a / z2, -g3p]
    return g, (H11, H12, H13, H22, H23, H33)


def _pow_t0(a):
    return -2.0 * a * math.log(a) - 2.0 * (1.0 - a) * math.log(1.0 - a)


def _pow_nr(s1, s2, s3, a, live=None):
    """One-sided Newton-Raphson for |g3| of the pow primal gradient
    (reference _pow_nr32, l.986-1051, run in float64): at most NR_TRIPS
    steps, a per-lane stop.  Returns (x, big, 1/|s3| or 1)."""
    phi = torch.exp(2.0 * a * _nslog(s1) + (2.0 - 2.0 * a) * _nslog(s2))
    abs_s = s3.abs()
    big = abs_s > EPS64
    absf = torch.where(big, abs_s, 1.0)
    den = phi - absf * absf
    den = torch.where(den.abs() > 0, den, 1.0)
    x = -1.0 / absf + (2.0 * absf + torch.sqrt(
        (phi * phi / (absf * absf) + 3.0 * phi).clamp_min(0.0))) / den
    t0 = _pow_t0(a)

    def f0(x):
        t1 = x * x
        t2 = 2.0 * x / absf
        return (2.0 * a * _nslog(2.0 * a * t1 + (1.0 + a) * t2)
                + (2.0 - 2.0 * a) * _nslog((2.0 - 2.0 * a) * t1
                                           + (2.0 - a) * t2)
                - _nslog(phi) - _nslog(t1 + t2) - 2.0 * _nslog(t2) + t0)

    def f1(x):
        t1 = x * x
        t2 = 2.0 * x / absf
        return (2.0 * a * a / (a * x + (1.0 + a) / absf)
                + (2.0 - 2.0 * a) * (1.0 - a)
                / ((1.0 - a) * x + (2.0 - a) / absf)
                - 2.0 * (x + 1.0 / absf)
                / torch.where(t1 + t2 != 0, t1 + t2, 1.0))

    done = torch.zeros_like(big) if live is None else ~live
    for _ in range(NR_TRIPS):
        if bool(done.all()):
            break
        d1 = f1(x)
        dx = -f0(x) / torch.where(d1 != 0, d1, 1.0)
        stop = ((dx < EPS64)
                | ((dx / torch.where(x != 0, x, 1.0)).abs()
                   < math.sqrt(EPS64))
                | (d1.abs() < EPS64))
        x = torch.where(done | stop, x, x + dx)
        done = done | stop
    return x, big, absf


def _pow_grad_from(x, big, s1, s2, s3, a):
    g3 = torch.where(big, x * torch.where(s3 < 0, -1.0, 1.0), 0.0)
    g1 = torch.where(big, -(g3 * s3 * a + (1.0 + a)) / s1, -(1.0 + a) / s1)
    g2 = torch.where(big, -(g3 * s3 * (1.0 - a) + (2.0 - a)) / s2,
                     -(2.0 - a) / s2)
    return [g1, g2, g3]


def _pow_grad_primal(S, a, live=None):
    """reference: coneops_powcone.jl:288-316,449-478 (pow_grad_primal,
    l.1053-1096): the Newton iteration, then two Newton polish steps."""
    s1, s2, s3 = S
    x, big, absf = _pow_nr(s1, s2, s3, a, live)
    iabs = 1.0 / absf
    t0 = _pow_t0(a)
    for _ in range(2):
        t1 = x * x
        t2 = x * iabs * 2.0
        f0 = (_nslog(t1 * (2.0 * a) + t2 * (1.0 + a)) * (2.0 * a)
              + _nslog(t1 * (2.0 - 2.0 * a) + t2 * (2.0 - a))
              * (2.0 - 2.0 * a)
              - (_nslog(s1) * (2.0 * a) + _nslog(s2) * (2.0 - 2.0 * a))
              - _nslog(t1 + t2) - _nslog(t2) * 2.0 + t0)
        f1 = (1.0 / (x * a + iabs * (1.0 + a)) * (2.0 * a * a)
              + 1.0 / (x * (1.0 - a) + iabs * (2.0 - a))
              * ((2.0 - 2.0 * a) * (1.0 - a))
              - (x + iabs) * 2.0
              * (1.0 / torch.where(t1 + t2 != 0, t1 + t2, 1.0)))
        x = x - f0 / torch.where(f1 != 0, f1, 1.0)
    return _pow_grad_from(x, big, s1, s2, s3, a)


def _nonsym_grad_hess(kind, a, S, Z, live=None):
    """(dual gradient, dual Hessian, primal gradient, feasible) of one
    segment (reference nonsym_grad_hess, l.1342)."""
    if kind == "exp":
        feas = _exp_feas_dual(Z) & _exp_feas_primal(S)
        g, Hd = _exp_grad_hess_dual(Z)
        zt = _exp_grad_primal(S)
    else:
        feas = _pow_feas_dual(Z, a) & _pow_feas_primal(S, a)
        g, Hd = _pow_grad_hess_dual(Z, a)
        zt = _pow_grad_primal(S, a, live)
    return g, Hd, zt, feas


_SYM3 = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (0, 2): 2, (2, 0): 2,
         (1, 1): 3, (1, 2): 4, (2, 1): 4, (2, 2): 5}
_UPPER3 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _pd_scaling_3d(Hd, st_g, zt, S, Z):
    """The primal-dual (BFGS) Hs, with the per-lane fallback to the local
    mu times H_dual where it is not usable (reference pd_scaling_3d,
    l.1282-1334; coneops_nonsymmetric_common.jl:50-164)."""
    dot_sz = _dot3(S, Z)
    mu_l = dot_sz * (1.0 / 3.0)
    mut = _dot3(zt, st_g) * (1.0 / 3.0)
    dsv = [S[i] + mu_l * st_g[i] for i in range(3)]
    dzv = [Z[i] + mu_l * zt[i] for i in range(3)]
    dot_dsz = _dot3(dsv, dzv)
    de1 = mu_l * mut - 1.0
    Hzt = _hmul3(Hd, zt)
    de2 = _dot3(zt, Hzt) - mut * mut * 3.0
    usable = ((de1.abs() > math.sqrt(EPS64)) & (de2.abs() > EPS64)
              & (dot_sz > 0) & (dot_dsz > 0))
    ide2 = 1.0 / torch.where(de2 != 0, de2, 1.0)
    tmp = [mut * st_g[i] - Hzt[i] for i in range(3)]
    w = [Hd[_SYM3[i, j]] - st_g[i] * st_g[j] * (1.0 / 3.0)
         - tmp[i] * tmp[j] * ide2 for i, j in _UPPER3]
    frob = (w[0] * w[0] + w[3] * w[3] + w[5] * w[5]
            + (w[1] * w[1] + w[2] * w[2] + w[4] * w[4]) * 2.0)
    t = mu_l * torch.sqrt(frob.clamp_min(0.0))
    ax = [Z[1] * zt[2] - Z[2] * zt[1],
          Z[2] * zt[0] - Z[0] * zt[2],
          Z[0] * zt[1] - Z[1] * zt[0]]
    axn = torch.sqrt(_dot3(ax, ax).clamp_min(0.0))
    iaxn = 1.0 / torch.where(axn > 0, axn, 1.0)
    ax = [c * iaxn for c in ax]
    isz = 1.0 / torch.where(dot_sz != 0, dot_sz, 1.0)
    idsz = 1.0 / torch.where(dot_dsz != 0, dot_dsz, 1.0)
    pd = [S[i] * S[j] * isz + dsv[i] * dsv[j] * idsz + t * ax[i] * ax[j]
          for i, j in _UPPER3]
    usable = usable & _all_finite(pd)
    return [torch.where(usable, p, h * mu_l) for p, h in zip(pd, Hd)], usable


def _hd_solve_guarded(Hd, b3):
    """H_dual^{-1} b, or 0 where the factor breaks down or the result is
    not finite (reference _hd_solve_guarded, l.2464)."""
    F, okc = _chol3_fac(Hd)
    u = _chol3_solve_fac(F, b3)
    fin = _all_finite(u) & okc
    return [torch.where(fin, ui, 0.0) for ui in u]


def _finite_or_zero3(eta, ok):
    fin = _all_finite(eta) & ok
    return [torch.where(fin, e, 0.0) for e in eta]


def _exp_higher_corr(Hd, Zc, ds3, v3):
    """The third-order correction (reference exp_higher_corr, l.2493;
    coneops_expcone.jl:319-366), with the reference's psi noise guard."""
    u = _hd_solve_guarded(Hd, ds3)
    z1, z2, z3 = Zc
    gpsi3 = -z1 / z3
    gpsi1 = _nslog(gpsi3)
    psi = z1 * gpsi1 - z1 + z2
    psi_ok = psi > 1e-9 * ((z1 * gpsi1).abs() + z1.abs() + z2.abs())
    psi = torch.where(psi_ok, psi, 1.0)
    gpsi = [gpsi1, torch.ones_like(z1), gpsi3]
    dpu = _dot3(gpsi, u)
    dpv = _dot3(gpsi, v3)
    ipsi = 1.0 / psi
    ipsi2 = ipsi * ipsi
    iz1 = 1.0 / z1
    iz3 = 1.0 / z3
    coef = ((u[0] * (v3[0] * iz1 - v3[2] * iz3)
             + u[2] * (z1 * v3[2] * iz3 - v3[0]) * iz3) * psi
            - dpu * dpv * 2.0) * (ipsi2 * ipsi)
    eta = [gp * coef for gp in gpsi]
    eta0 = eta[0] + (
        (ipsi - iz1 * 2.0) * u[0] * v3[0] * (iz1 * iz1)
        - u[2] * v3[2] * (iz3 * iz3) * ipsi
        + dpu * ipsi2 * (v3[0] * iz1 - v3[2] * iz3)
        + dpv * ipsi2 * (u[0] * iz1 - u[2] * iz3))
    eta2 = eta[2] + (
        (z1 * ipsi - 1.0) * u[2] * v3[2] * (iz3 * iz3 * iz3) * 2.0
        - (u[2] * v3[0] + u[0] * v3[2]) * (iz3 * iz3) * ipsi
        + dpu * ipsi2 * (z1 * v3[2] * (iz3 * iz3) - v3[0] * iz3)
        + dpv * ipsi2 * (z1 * u[2] * (iz3 * iz3) - u[0] * iz3))
    return _finite_or_zero3([eta0 * 0.5, eta[1] * 0.5, eta2 * 0.5], psi_ok)


def _pow_higher_corr(Hd, Zc, a, ds3, v3):
    """The third-order correction (reference pow_higher_corr, l.2535;
    coneops_powcone.jl:329-404), with the reference's psi noise guard."""
    u = _hd_solve_guarded(Hd, ds3)
    z1, z2, z3 = Zc
    phi = _pow_phi_dual(Zc, a)
    psi = phi - z3 * z3
    psi_ok = psi > 1e-9 * (phi + z3 * z3)
    psi = torch.where(psi_ok, psi, 1.0)
    iz1, iz2 = 1.0 / z1, 1.0 / z2
    gpsi = [phi * iz1 * (2.0 * a), phi * iz2 * (2.0 - 2.0 * a), z3 * (-2.0)]
    Hp11 = phi * (iz1 * iz1) * (2.0 * a * (2.0 * a - 1.0))
    Hp12 = phi * (iz1 * iz2) * (4.0 * a * (1.0 - a))
    Hp22 = phi * (iz2 * iz2) * (2.0 * (1.0 - a) * (1.0 - 2.0 * a))
    dpu = _dot3(gpsi, u)
    dpv = _dot3(gpsi, v3)
    Hv = [Hp11 * v3[0] + Hp12 * v3[1], Hp12 * v3[0] + Hp22 * v3[1],
          v3[2] * (-2.0)]
    uHv = u[0] * Hv[0] + u[1] * Hv[1] + u[2] * Hv[2]
    ipsi = 1.0 / psi
    ipsi2 = ipsi * ipsi
    coef = (uHv * psi - dpu * dpv * 2.0) * (ipsi2 * ipsi)
    coef2 = (phi * (u[0] * iz1 - u[1] * iz2) * (v3[0] * iz1 - v3[1] * iz2)
             * ipsi * (4.0 * a * (2.0 * a - 1.0) * (1.0 - a)))
    e1 = (coef * gpsi[0] - u[0] * v3[0] * (iz1 * iz1 * iz1)
          * (2.0 * (1.0 - a)) + coef2 * iz1 + Hv[0] * dpu * ipsi2)
    e2 = (coef * gpsi[1] - u[1] * v3[1] * (iz2 * iz2 * iz2) * (2.0 * a)
          - coef2 * iz2 + Hv[1] * dpu * ipsi2)
    e3 = coef * gpsi[2] + Hv[2] * dpu * ipsi2
    Hu = [Hp11 * u[0] + Hp12 * u[1], Hp12 * u[0] + Hp22 * u[1],
          u[2] * (-2.0)]
    return _finite_or_zero3([(e1 + Hu[0] * dpv * ipsi2) * 0.5,
                             (e2 + Hu[1] * dpv * ipsi2) * 0.5,
                             (e3 + Hu[2] * dpv * ipsi2) * 0.5], psi_ok)


def _nonsym_barrier(kind, a, Z, S):
    """f*(z) + f(s) of one segment, BIG where infeasible (reference
    _nonsym_barrier32, l.2271-2324, in float64)."""
    z1, z2, z3 = Z
    s1, s2, s3 = S
    if kind == "exp":
        l = _nslog(-z3 / torch.where(z1 != 0, z1, -1.0))
        bd = -_nslog(-z3 * z1) - _nslog(z2 - z1 - z1 * l)
        dfeas = (z3 > 0) & (z1 < 0) & (z2 - z1 - z1 * l > 0)
        s2s = torch.where(s2 > 0, s2, 1.0)
        s3s = torch.where(s3 > 0, s3, 1.0)
        arg = 1.0 - s1 / s2s - _nslog(s2s / s3s)
        w = _wright_omega(arg.clamp_min(0.0))
        wm = (w - 1.0) * (w - 1.0) / torch.where(w != 0, w, 1.0)
        bp = -_nslog(wm) - 2.0 * _nslog(s2) - _nslog(s3) - 3.0
        pfeas = (s3 > 0) & (s2 > 0) & (s2 * _nslog(s3 / s2s) - s1 > 0)
    else:
        resd = _pow_phi_dual(Z, a) - z3 * z3
        bd = -_nslog(resd) - (1.0 - a) * _nslog(z1) - a * _nslog(z2)
        dfeas = (z1 > 0) & (z2 > 0) & (resd > 0)
        # the primal barrier through the dual barrier of -grad (reference
        # coneops_powcone.jl:310-317); the Newton iteration alone suffices
        # for the < 1 check
        x, big, _ = _pow_nr(s1, s2, s3, a)
        g1, g2, g3 = _pow_grad_from(x, big, s1, s2, s3, a)
        phig = _pow_phi_dual([-g1, -g2], a)
        bp = (_nslog(phig - g3 * g3) + (1.0 - a) * _nslog(-g1)
              + a * _nslog(-g2) - 3.0)
        pfeas = _pow_feas_primal(S, a)
    return torch.where(dfeas, bd, BIG) + torch.where(pfeas, bp, BIG)


# ---- PSD-triangle cones of side <= 3 (K1d; reference l.652-830,
# 1418-1451).  A side-np matrix is an np x np list of lists of (B,)
# tensors; svec rows follow the column-stacked upper triangle with the
# off-diagonals times sqrt(2). ----

_SR2 = math.sqrt(2.0)
_ISR2 = 1.0 / _SR2
# the Jacobi sweeps stop once no pair of a lane rotates (every pair is
# orthogonal, or off-diagonal, to float64 rounding), at most this many
# (MegaSpec.psd_sweeps; DEVIATIONS.md #12)
JACOBI_SWEEPS = 12


def psd_side(width):
    """The side of a PSD segment of `width` svec rows."""
    return {1: 1, 3: 2, 6: 3}[width]


def _psd_unpack(rows, np_):
    """svec rows (a list of (B,) tensors) -> symmetric matrix entries."""
    M = [[None] * np_ for _ in range(np_)]
    for j in range(np_):
        for i in range(j + 1):
            e = rows[j * (j + 1) // 2 + i]
            if i == j:
                M[i][j] = e
            else:
                M[i][j] = M[j][i] = e * _ISR2
    return M


def _psd_pack(M, np_):
    """Symmetric matrix entries -> (B, t) svec."""
    return torch.stack([M[i][j] if i == j else M[i][j] * _SR2
                        for j in range(np_) for i in range(j + 1)], dim=1)


def _mm(A, B_):
    n_ = len(A)
    out = []
    for i in range(n_):
        row = []
        for j in range(n_):
            acc = A[i][0] * B_[0][j]
            for k in range(1, n_):
                acc = acc + A[i][k] * B_[k][j]
            row.append(acc)
        out.append(row)
    return out


def _mT(A):
    return [list(r) for r in zip(*A)]


def _mat_chol(M):
    """Lower Cholesky with clamped pivots: a pivot that is not positive
    becomes 1 (reference mat_chol, l.683); returns (L, ok)."""
    np_ = len(M)
    zero = torch.zeros_like(M[0][0])
    L = [[zero] * np_ for _ in range(np_)]
    ok = torch.ones_like(zero, dtype=torch.bool)
    for j in range(np_):
        acc = M[j][j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        ok = ok & (acc > 0)
        d = torch.sqrt(acc.clamp_min(0.0))
        d = torch.where(d > 0, d, 1.0)
        L[j][j] = d
        idj = 1.0 / d
        for i in range(j + 1, np_):
            acc = M[i][j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc * idj
    return L, ok


def _jacobi_svd(A, sweeps, eps=EPS64):
    """One-sided (Hestenes) Jacobi SVD, A = U diag(sigma) V' (reference
    jacobi_svd, l.707): rotations orthogonalize the column pairs of A
    itself, so accuracy follows kappa(A), not kappa(A)^2.  A pair rotates
    while |a_p . a_q| > eps sqrt(|a_p|^2 |a_q|^2), eps the unit roundoff of
    the arithmetic (float64, or float32 in the first phase); sweeps run
    until no pair of any lane rotates, at most `sweeps`."""
    np_ = len(A)
    one = torch.ones_like(A[0][0])
    if np_ == 1:
        s0 = A[0][0].abs()
        s0 = torch.where(s0 > 0, s0, 1.0)
        return [s0], [[torch.where(A[0][0] >= 0, one, -one)]], [[one]]
    Ac = [list(r) for r in A]
    zero = torch.zeros_like(one)
    V = [[one if i == j else zero for j in range(np_)] for i in range(np_)]
    pairs = [(p, q) for q in range(1, np_) for p in range(q)]
    for _ in range(sweeps):
        rotated = torch.zeros_like(one, dtype=torch.bool)
        for p, q in pairs:
            al = sum(Ac[i][p] * Ac[i][p] for i in range(np_))
            be = sum(Ac[i][q] * Ac[i][q] for i in range(np_))
            ga = sum(Ac[i][p] * Ac[i][q] for i in range(np_))
            live = ga.abs() > eps * torch.sqrt(al * be)
            rotated = rotated | live
            ga_s = torch.where(live, ga, 1.0)
            zeta = (be - al) / (ga_s * 2.0)
            sgn = torch.where(zeta >= 0, 1.0, -1.0)
            t = sgn / (zeta.abs() + torch.sqrt(zeta * zeta + 1.0))
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s_ = t * c
            c = torch.where(live, c, 1.0)
            s_ = torch.where(live, s_, 0.0)
            for i in range(np_):
                aip, aiq = Ac[i][p], Ac[i][q]
                Ac[i][p] = c * aip - s_ * aiq
                Ac[i][q] = s_ * aip + c * aiq
                vip, viq = V[i][p], V[i][q]
                V[i][p] = c * vip - s_ * viq
                V[i][q] = s_ * vip + c * viq
        if not bool(rotated.any()):
            break
    sig, U = [], [[None] * np_ for _ in range(np_)]
    for j in range(np_):
        sj = torch.sqrt(sum(Ac[i][j] * Ac[i][j] for i in range(np_)))
        sjc = torch.where(sj > 0, sj, 1.0)
        sig.append(sjc)
        for i in range(np_):
            U[i][j] = Ac[i][j] / sjc
    return sig, U, V


def _psd_eigvals(M, sweeps, eps=EPS64):
    """All eigenvalues (a list, in no order) of a symmetric matrix of side
    <= 3 (reference psd_eigvals32, l.767, in float64): side 2 in closed
    form, side 3 by values-only cyclic Jacobi, rotating a pair while
    |a_pq| > eps sqrt(|a_pp a_qq|), until no pair of any lane rotates,
    at most `sweeps`."""
    np_ = len(M)
    if np_ == 1:
        return [M[0][0]]
    if np_ == 2:
        a, b, d = M[0][0], M[0][1], M[1][1]
        mid = 0.5 * (a + d)
        rad = torch.sqrt((0.5 * (a - d)) ** 2 + b * b)
        return [mid - rad, mid + rad]
    A = [list(r) for r in M]
    zero = torch.zeros_like(A[0][0])
    for _ in range(sweeps):
        rotated = torch.zeros_like(zero, dtype=torch.bool)
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = A[p][q]
            live = apq.abs() > eps * torch.sqrt((A[p][p] * A[q][q]).abs())
            rotated = rotated | live
            theta = (A[q][q] - A[p][p]) / (2.0 * torch.where(live, apq, 1.0))
            t = torch.sign(theta) / (theta.abs()
                                     + torch.sqrt(theta * theta + 1.0))
            t = torch.where(theta == 0, 1.0, t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s_ = t * c
            c = torch.where(live, c, 1.0)
            s_ = torch.where(live, s_, 0.0)
            app, aqq = A[p][p], A[q][q]
            A[p][p] = c * c * app - 2.0 * c * s_ * apq + s_ * s_ * aqq
            A[q][q] = s_ * s_ * app + 2.0 * c * s_ * apq + c * c * aqq
            A[p][q] = A[q][p] = torch.where(live, zero, apq)
            r = 3 - p - q
            arp, arq = A[r][p], A[r][q]
            A[r][p] = A[p][r] = c * arp - s_ * arq
            A[r][q] = A[q][r] = s_ * arp + c * arq
        if not bool(rotated.any()):
            break
    return [A[0][0], A[1][1], A[2][2]]


def _psd_logdet(M):
    """(logdet, ok) of a symmetric matrix through its Cholesky factor; ok
    is False outside the positive definite cone (reference psd_logdet32,
    l.814, in float64)."""
    np_ = len(M)
    val = torch.zeros_like(M[0][0])
    ok = torch.ones_like(val, dtype=torch.bool)
    L = [[None] * np_ for _ in range(np_)]
    for j in range(np_):
        acc = M[j][j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        ok = ok & (acc > 0)
        dj = torch.sqrt(acc.clamp_min(0.0))
        djs = torch.where(dj > 0, dj, 1.0)
        val = val + 2.0 * torch.log(djs)
        for i in range(j + 1, np_):
            acc = M[i][j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc / djs
        L[j][j] = djs
    return val, ok


def _psd_scaling(sg, zg, np_, sweeps, eps):
    """NT scaling of one segment: clamped, non-fatal chol of S and Z, the
    one-sided Jacobi SVD of L2'L1 = U diag(lam) V', R = L1 V lam^{-1/2},
    Rinv = lam^{-1/2} U' L2' (reference l.1418-1451).  Returns the state
    and whether R and Rinv are finite."""
    L1, _ = _mat_chol(_psd_unpack(list(sg.unbind(1)), np_))
    L2, _ = _mat_chol(_psd_unpack(list(zg.unbind(1)), np_))
    lam, U, V = _jacobi_svd(_mm(_mT(L2), L1), sweeps, eps)
    lis = [1.0 / torch.sqrt(l) for l in lam]
    L1V = _mm(L1, V)
    R = [[L1V[i][j] * lis[j] for j in range(np_)] for i in range(np_)]
    UtL2t = _mm(_mT(U), _mT(L2))
    Rinv = [[UtL2t[i][j] * lis[i] for j in range(np_)] for i in range(np_)]
    fin = _all_finite([e for row in R + Rinv for e in row])
    return {"R": R, "Rinv": Rinv, "lam": lam, "np": np_}, fin


def _psd_step_comp(dg, Rx, lam, transpose, sweeps, eps):
    """The largest step along one direction of a PSD segment: from the
    least eigenvalue of lam^{-1/2} (W d) lam^{-1/2} (reference
    l.2104-2150, in float64)."""
    np_ = len(Rx)
    li = [1.0 / torch.sqrt(l.clamp_min(_TINY)) for l in lam]
    D = _psd_unpack(list(dg.unbind(1)), np_)
    Mt = (_mm(_mm(Rx, D), _mT(Rx)) if transpose
          else _mm(_mm(_mT(Rx), D), Rx))
    Ms = [[0.5 * (Mt[i][j] + Mt[j][i]) * li[i] * li[j] for j in range(np_)]
          for i in range(np_)]
    eigs = _psd_eigvals(Ms, sweeps, eps)
    gmin = eigs[0]
    for e in eigs[1:]:
        gmin = torch.minimum(gmin, e)
    return torch.where(gmin < 0, 1.0 / torch.clamp_min(-gmin, 1e-30), BIG)


# ---- generalized power cones (K1c; reference l.1103-1239, 2326-2431).
# A segment's values are lists of (B,) tensors; al is the tuple of its
# exponents, d1 = len(al). ----

def _gp_phi_dual(U, al):
    acc = None
    for u, a in zip(U, al):
        t = _nslog(u / a) * (2.0 * a)
        acc = t if acc is None else acc + t
    return torch.exp(acc)


def _gp_feas_dual(U, V, al):
    ok = torch.ones_like(U[0], dtype=torch.bool)
    for u in U:
        ok = ok & (u > 0)
    res = _gp_phi_dual(U, al)
    for v in V:
        res = res - v * v
    return ok & (res > 0)


def _gp_feas_primal(S1, S2, al):
    ok = torch.ones_like(S1[0], dtype=torch.bool)
    acc = None
    for s1, a in zip(S1, al):
        ok = ok & (s1 > 0)
        t = _nslog(s1) * (2.0 * a)
        acc = t if acc is None else acc + t
    res = torch.exp(acc)
    for s2 in S2:
        res = res - s2 * s2
    return ok & (res > 0)


def _gp_state(U, V, al, mu):
    """Dual gradient and the rank-3 Hs data (D, p, q, r) with ok: the
    dual point is feasible and the data finite (reference genpow_state,
    l.1130; coneops_genpowcone.jl:337-389)."""
    d1 = len(al)
    phi = _gp_phi_dual(U, al)
    norm2w = torch.zeros_like(phi)
    for v in V:
        norm2w = norm2w + v * v
    zeta = phi - norm2w
    feas = zeta > 0
    for u in U:
        feas = feas & (u > 0)
    zs = torch.where(zeta > 0, zeta, 1.0)
    izeta = 1.0 / zs
    phiz = phi * izeta
    tau = [(1.0 / U[j]) * (2.0 * al[j]) for j in range(d1)]
    g = ([-tau[j] * phiz - (1.0 - al[j]) / U[j] for j in range(d1)]
         + [v * (izeta * 2.0) for v in V])
    dd = ([tau[j] * phiz / U[j] + (1.0 - al[j]) / (U[j] * U[j])
           for j in range(d1)] + [izeta * 2.0 for _ in V])
    p0 = torch.sqrt((phi * (phi + norm2w) * 0.5).clamp_min(0.0))
    p0s = torch.where(p0 > 0, p0, 1.0)
    p1 = -(phi * 2.0) / p0s
    p = [p0 * tau[j] * izeta for j in range(d1)] + [p1 * v * izeta
                                                    for v in V]
    q0 = torch.sqrt((zs * phi * 0.5).clamp_min(0.0))
    q = [tau[j] * q0 * izeta for j in range(d1)]
    r1 = torch.sqrt(((zs / (phi + norm2w)) * 4.0).clamp_min(0.0))
    r = [r1 * v * izeta for v in V]
    fin = _all_finite(g + dd + p + q + r)
    return {"g": g, "dd": dd, "p": p, "q": q, "r": r, "mu": mu,
            "d1": d1}, feas & fin


def _gp_hs_apply(stg, v):
    """mu (D v + p (p'v) - [q (q'v_head); 0] - [0; r (r'v_tail)])."""
    d1, dd, p, q, r = stg["d1"], stg["dd"], stg["p"], stg["q"], stg["r"]
    w = len(dd)
    cp = sum(p[j] * v[j] for j in range(w))
    cq = sum(q[j] * v[j] for j in range(d1))
    cr = sum(r[k] * v[d1 + k] for k in range(w - d1)) if w > d1 else None
    out = []
    for j in range(w):
        y = dd[j] * v[j] + p[j] * cp
        if j < d1:
            y = y - q[j] * cq
        else:
            y = y - r[j - d1] * cr
        out.append(y * stg["mu"])
    return out


def _gp_hinv_apply(stg, v):
    """(mu H)^{-1} v by three Sherman-Morrison rank-1 updates on the
    diagonal base (reference genpow_hinv_apply, l.1199): y0 = v / D,
    y_k = y_{k-1} - A_k u_k (u_k' y_{k-1}) sgn_k / (1 + sgn_k u_k' A_k u_k)
    with A_k u_k the (k-1)-th inverse applied to u_k."""
    d1, dd = stg["d1"], stg["dd"]
    w = len(dd)
    zero = torch.zeros_like(dd[0])
    idd = [1.0 / d for d in dd]
    us = ((stg["p"], 1.0), (stg["q"] + [zero] * (w - d1), -1.0),
          ([zero] * d1 + stg["r"], -1.0))
    updates = []

    def inv(x):
        y = [x[j] * idd[j] for j in range(w)]
        for u, Au, idn, sgn in updates:
            coef = sum(u[j] * y[j] for j in range(w)) * idn * sgn
            y = [y[j] - Au[j] * coef for j in range(w)]
        return y

    for u, sgn in us:
        Au = inv(u)
        denom = sum(u[j] * Au[j] for j in range(w)) * sgn + 1.0
        denom = torch.where(denom != 0, denom, 1.0)
        updates.append((u, Au, 1.0 / denom, sgn))
    imu = 1.0 / stg["mu"]
    return [y * imu for y in inv(v)]


def _gp_hs_diag(stg):
    d1 = stg["d1"]
    out = []
    for j in range(len(stg["dd"])):
        t = stg["dd"][j] + stg["p"][j] * stg["p"][j]
        u = stg["q"][j] if j < d1 else stg["r"][j - d1]
        out.append((t - u * u) * stg["mu"])
    return out


def _gp_barrier(al, Z, S, newton=None):
    """f*(z) + f(s) of one segment, BIG where infeasible (reference
    _genpow_barrier32, l.2326, in float64): the primal barrier through a
    one-sided Newton gradient (at most NR_TRIPS steps) and the dual
    barrier of -g.  `newton`, a list, receives the per-lane Newton trips
    (evaluations of the Newton function, as the kernel counts them)."""
    d1 = len(al)
    z1, z2 = Z[:d1], Z[d1:]
    s1, s2 = S[:d1], S[d1:]
    zero = torch.zeros_like(Z[0])
    resd = _gp_phi_dual(z1, al) - sum((v * v for v in z2), zero)
    bd = -_nslog(resd)
    dfeas = resd > 0
    for zj, a in zip(z1, al):
        bd = bd - (1.0 - a) * _nslog(zj)
        dfeas = dfeas & (zj > 0)

    lphi = sum((2.0 * a * _nslog(sj) for sj, a in zip(s1, al)), zero)
    phi = torch.exp(lphi)
    n2r = sum((v * v for v in s2), zero)
    norm_r = torch.sqrt(n2r.clamp_min(0.0))
    big = norm_r > EPS64
    nr = torch.where(big, norm_r, 1.0)
    psi_c = 1.0 / sum(a * a for a in al)
    den0 = torch.where((phi - nr * nr).abs() > 0, phi - nr * nr, 1.0)
    x = -1.0 / nr + (psi_c * nr + torch.sqrt(
        ((phi / (nr * nr) + psi_c * psi_c - 1.0) * phi).clamp_min(0.0))
    ) / den0

    def f0(x):
        v = -_nslog(2.0 * x / nr + x * x)
        for sj, a in zip(s1, al):
            v = v + 2.0 * a * (_nslog(x * nr + (1.0 + a) / a) - _nslog(sj))
        return v

    def f1(x):
        t1, t2 = x * x, 2.0 * x / nr
        v = -(2.0 * x + 2.0 / nr) / torch.where(t1 + t2 != 0, t1 + t2, 1.0)
        for a in al:
            v = v + 2.0 * a * nr / (nr * x + (1.0 + a) / a)
        return v

    done = torch.zeros_like(big)
    trips = torch.zeros_like(x, dtype=torch.int32)
    for _ in range(NR_TRIPS):
        if bool(done.all()):
            break
        trips += (~done).to(torch.int32)
        d1_ = f1(x)
        dx = -f0(x) / torch.where(d1_ != 0, d1_, 1.0)
        stop = ((dx < EPS64)
                | ((dx / torch.where(x != 0, x, 1.0)).abs()
                   < math.sqrt(EPS64))
                | (d1_.abs() < EPS64))
        x = torch.where(done | stop, x, x + dx)
        done = done | stop
    if newton is not None:
        newton.append(trips)
    gr = [torch.where(big, x * v / nr, 0.0) for v in s2]
    gp = [torch.where(big, -(1.0 + a + a * x * norm_r) / sj,
                      -(1.0 + a) / sj) for sj, a in zip(s1, al)]
    # the primal barrier is -f*(-g) - (d1 + 1)
    bdg = -_nslog(_gp_phi_dual([-g for g in gp], al)
                  - sum((v * v for v in gr), zero))
    for g, a in zip(gp, al):
        bdg = bdg - (1.0 - a) * _nslog(-g)
    bp = -bdg - (d1 + 1.0)
    pfeas = phi - n2r > 0
    for sj in s1:
        pfeas = pfeas & (sj > 0)
    return torch.where(dfeas, bd, BIG) + torch.where(pfeas, bp, BIG)


def _psd_hinv(stg, vg):
    """Hs^{-1} v = svec(Rinv' (Rinv X Rinv') Rinv) of one segment."""
    np_, Ri = stg["np"], stg["Rinv"]
    X = _psd_unpack(list(vg.unbind(1)), np_)
    T1 = _mm(_mm(Ri, X), _mT(Ri))
    return _psd_pack(_mm(_mm(_mT(Ri), T1), Ri), np_)


def _gp_hinv(stg, vg):
    return torch.stack(_gp_hinv_apply(stg, list(vg.unbind(1))), dim=1)


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


def mega_solve_plain(Ptri, q, A, b, spec, B, trips=None):
    """The whole batched solve over B lanes; see the module docstring for
    the layout.  Returns (vals (OUTD, B) float64, ints (4, B) int32).

    `trips`, a dict, receives the per-lane trip counts of the searches of
    a layout with nonsymmetric segments, one (B,) int32 tensor per search
    (0 on the lanes that do not run it): "feas", the joint feasibility
    backtracks (two per IPM step); "barrier", the barrier backtracks of
    the Dual lanes (one per step); "newton", each barrier evaluation's
    genpow Newton trips.  The kernel runs the same searches with the same
    counts, up to rounding; `coop_rounds` turns them into its schedule."""
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
    if trips is not None:
        trips.update(feas=[], barrier=[], newton=[])
        ops.trips = trips

    # ---- initial point (reference l.3089-3157) ----
    if spec.nonsym:
        # the unit point of every cone, x = 0
        x = torch.zeros_like(qe)
        z = unit_point(spec, B, qe.device)
        s = z.clone()
    else:
        K0, _ = ops.build_kkt(None, ops.eps_of(torch.ones_like(be)))
        if spec.p_nonzero:
            sols, _ = ops.refined_solve(K0, [(-qe, be)])
            x, z = sols[0]
            s = -z
        else:
            sols, _ = ops.refined_solve(
                K0, [(torch.zeros_like(qe), be),
                     (-qe, torch.zeros_like(be))])
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
    # a generalized power cone pins every lane to Dual (reference
    # l.560-568: allows_pd)
    strat = torch.full_like(iters, DUAL if spec.has("genpow")
                            else PRIMAL_DUAL)
    p1_iters = torch.zeros_like(iters)
    if spec.two_phase:
        carry = _phase1(spec, Ps, As, qe, be, sc, dict(
            x=x, z=z, s=s, tau=tau, kappa=kappa, px=px, pz=pz, ps=ps,
            ptau=ptau, pkap=pkap, prev_rp=prev_rp, prev_rd=prev_rd,
            prev_ga=prev_ga, prev_gr=prev_gr, mu_f=mu_f, alpha_f=alpha_f,
            sigma_f=sigma_f, iters=iters, strat=strat))
        (x, z, s, tau, kappa, px, pz, ps, ptau, pkap, prev_rp, prev_rd,
         prev_ga, prev_gr, mu_f, alpha_f, sigma_f, iters) = (
            carry[k] for k in _CARRY)
        p1_iters = iters.clone()
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

        # rollback for insufficient progress; with exp/pow segments a
        # PrimalDual lane downgrades to Dual and continues, skipping this
        # pass (reference l.3354-3383)
        restore = active & (status2 == INSUFFICIENT_PROGRESS)
        if spec.nonsym:
            downgraded_ip = restore & (strat == PRIMAL_DUAL)
            status2 = torch.where(downgraded_ip, UNSOLVED,
                                  status2).to(torch.int32)
            strat = torch.where(downgraded_ip, DUAL, strat).to(torch.int32)
        xr, zr, sr_ = W(restore, px, x), W(restore, pz, z), W(restore, ps, s)
        taur = torch.where(restore, ptau, tau)
        kapr = torch.where(restore, pkap, kappa)
        do = active & (status2 == UNSOLVED)
        if spec.nonsym:
            do = do & ~downgraded_ip
        iters1 = iters + do.to(torch.int32)

        dx, dz, dsv, dtau, dkappa, alpha, sigma, kkt_fail = _pc_step(
            ops, x, z, s, tau, kappa, tinv, res, mu, iters1, strat, do)

        # numerical-error and small-step checkpoints (reference
        # l.3391-3430): PrimalDual lanes downgrade instead of failing
        small_term = alpha <= max(0.0, st.min_terminate_step_length)
        if spec.nonsym:
            can_dg = strat == PRIMAL_DUAL
            fail_status = torch.where(kkt_fail & ~can_dg, NUMERICAL_ERROR,
                                      UNSOLVED)
            small_switch = (can_dg & ~kkt_fail
                            & (alpha < st.min_switch_step_length))
            small_term = small_term & ~small_switch
            dg_fail = (kkt_fail & can_dg) | small_switch
        else:
            fail_status = torch.where(kkt_fail, NUMERICAL_ERROR, UNSOLVED)
        fail_status = torch.where((fail_status == UNSOLVED) & ~kkt_fail
                                  & small_term, INSUFFICIENT_PROGRESS,
                                  fail_status).to(torch.int32)
        take = ~kkt_fail & ~small_term
        if spec.nonsym:
            take = take & ~dg_fail
            strat = torch.where(do & dg_fail, DUAL, strat).to(torch.int32)
            fail_status = torch.where(dg_fail, UNSOLVED,
                                      fail_status).to(torch.int32)
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
    return (vals.t().contiguous(),
            torch.stack([status, iters, strat, p1_iters]).contiguous())


def warp_costs(trips, warp=32):
    """(serial, cooperative) cost of one search over a batch, from its
    per-lane trip counts (B,) as `mega_solve_plain` keeps them: the sum
    over warps of the warp's largest count (what a warp pays when each
    lane runs its own loop), and the sum over warps of the rounds of the
    kernel's warp-cooperative search (csrc/megakernel.cu `coop_search`).
    Lanes l and l' share a warp when l // warp == l' // warp.  In a round
    the L lanes of a warp still searching share all the warp's threads
    (the lanes that search no more, or have finished, or lie past the
    batch, serve): the t-th takes the (t // L)-th untried step of the
    (t % L)-th lane, so a lane gets warp // L candidates, one more for the
    first warp % L, and is done once its count is reached."""
    t = trips.detach().to("cpu", torch.int64)
    pad = (-t.numel()) % warp
    t = torch.cat([t, torch.zeros(pad, dtype=torch.int64)]).view(-1, warp)
    serial = int(t.max(dim=1).values.sum())
    W = warp
    nxt = torch.zeros_like(t)
    rounds = 0
    while True:
        rem = nxt < t
        L = rem.sum(dim=1, keepdim=True)
        if not bool((L > 0).any()):
            return serial, rounds
        rounds += int((L > 0).sum())
        rank = torch.cumsum(rem.to(torch.int64), dim=1) - 1
        Ls = L.clamp_min(1)
        share = W // Ls + (rank < W % Ls).to(torch.int64)
        nxt = nxt + torch.where(rem, share, 0)


_CARRY = ("x", "z", "s", "tau", "kappa", "px", "pz", "ps", "ptau", "pkap",
          "prev_rp", "prev_rd", "prev_ga", "prev_gr", "mu_f", "alpha_f",
          "sigma_f", "iters")


def _phase1(spec, Ps, As, qe, be, sc, c):
    """The float32 first phase (K1e; reference loop_body1, l.3212-3281):
    predictor-corrector steps in plain float32 over float32 copies of the
    scaled data, each lane until it hands off to the float64 loop, at the
    top of an iteration when mu < switch_mu, mu is not finite, the lane
    reached p1_cap iterations, or mu stopped contracting; or after a step
    whose KKT solve failed or whose length is at most P1_MIN_STEP, which is
    then not taken.  Every read of the carry rounds it to float32; a taken
    step writes the new and the previous iterate, a step not taken leaves
    them as they were.  No status is set here.  Returns the carry (`c`,
    float64 values and int32 iterations) that the float64 loop starts
    from."""
    f32 = torch.float32
    ops = _Ops(spec, Ps.to(f32), As.to(f32), qe.to(f32), be.to(f32),
               f32=True)
    sc32 = {k: v.to(f32) for k, v in sc.items()}
    inv_deg1 = 1.0 / (spec.degree + 1)
    mu_f = c["mu_f"].to(f32)
    hand = torch.zeros_like(mu_f, dtype=torch.bool)
    W = lambda msk, a, b_: torch.where(msk[:, None], a, b_)
    while not bool(hand.all()):
        active = ~hand
        x, z, s, tau, kappa = (c[k].to(f32)
                               for k in ("x", "z", "s", "tau", "kappa"))
        iters = c["iters"]
        tinv = 1.0 / tau
        res = ops.residuals(x, z, s, tau, kappa, tinv)
        mu = (res["sz"] + tau * kappa) * inv_deg1
        info = ops.compute_info(sc32, res, x, z, s, kappa, tinv)
        hand_top = ((mu < spec.switch_mu) | ~torch.isfinite(mu)
                    | (iters >= spec.p1_cap)
                    | ((iters >= P1_STALL_FROM_ITER)
                       & (mu > P1_STALL_RATIO * mu_f)))
        do = active & ~hand_top
        iters1 = iters + do.to(torch.int32)
        dx, dz, dsv, dtau, dkappa, alpha, sigma, kkt_fail = _pc_step(
            ops, x, z, s, tau, kappa, tinv, res, mu, iters1, c["strat"], do)
        take = ~kkt_fail & ~(alpha <= P1_MIN_STEP)
        alpha_eff = torch.where(take, alpha, 0.0)
        dotake = do & take
        a = alpha_eff[:, None]
        for k, v, d in (("x", x, dx), ("z", z, dz), ("s", s, dsv)):
            c["p" + k] = W(dotake, v.to(F64), c["p" + k])
            c[k] = W(dotake, (v + d * a).to(F64), c[k])
        c["ptau"] = torch.where(dotake, tau.to(F64), c["ptau"])
        c["pkap"] = torch.where(dotake, kappa.to(F64), c["pkap"])
        c["tau"] = torch.where(dotake, (tau + dtau * alpha_eff).to(F64),
                               c["tau"])
        c["kappa"] = torch.where(
            dotake, (kappa + dkappa * alpha_eff).to(F64), c["kappa"])
        for k, f in (("prev_rp", "res_primal"), ("prev_rd", "res_dual"),
                     ("prev_ga", "gap_abs"), ("prev_gr", "gap_rel")):
            c[k] = torch.where(dotake, info[f].to(F64), c[k])
        mu_f = torch.where(active, mu, mu_f)
        c["alpha_f"] = torch.where(do, alpha_eff.to(F64), c["alpha_f"])
        c["sigma_f"] = torch.where(do, sigma.to(F64), c["sigma_f"])
        hand = hand | (active & (hand_top | (do & ~take)))
        c["iters"] = iters1
    c["mu_f"] = mu_f.to(F64)
    return c


def unit_point(spec, B, device):
    """The unit initialization of every cone, (B, m) (reference
    l.3096-3137)."""
    z = torch.zeros((B, spec.m), dtype=F64, device=device)
    for (kind, lo, hi), a, gal in zip(spec.segs, spec.alphas,
                                      spec.gp_alphas):
        if kind == "nn":
            z[:, lo:hi] = 1.0
        elif kind == "psd":
            for j in range(psd_side(hi - lo)):
                z[:, lo + j * (j + 1) // 2 + j] = 1.0
        elif kind == "genpow":
            for j, al in enumerate(gal):
                z[:, lo + j] = math.sqrt(1.0 + al)
        elif kind == "soc":
            z[:, lo] = 1.0
        elif kind == "exp":
            z[:, lo:hi] = torch.tensor(
                [-1.051383945322714, 0.556409619469370, 1.258967884768947],
                dtype=F64, device=device)
        elif kind == "pow":
            z[:, lo] = math.sqrt(1.0 + a)
            z[:, lo + 1] = math.sqrt(2.0 - a)
    return z


def _pc_step(ops, x, z, s, tau, kappa, tinv, res, mu, iters1, strat, live):
    """One Mehrotra predictor-corrector step (reference pc_step,
    l.2839-2977).  alpha is already scaled by max_step_fraction and, on
    the Dual lanes of a layout with nonsymmetric segments, backtracked to
    a barrier below 1.  `live` marks the lanes whose step is used."""
    st = ops.st
    qe, be = ops.qe, ops.be
    state, ok_scale = ops.make_scaling(s, z, mu, strat, live)
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
    alpha_aff = ops.step_length(state, dza, dsa, z, s,
                                max_step(dtaua, dkappaa), live)
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
    alpha = ops.step_length(state, dz, dsv, z, s, max_step(dtau, dkappa),
                            live)
    alpha = alpha * st.max_step_fraction
    if ops.nonsym:
        on_dual = strat == DUAL
        alpha_bt = ops.barrier_backtrack(z, s, dz, dsv, tau, kappa, dtau,
                                         dkappa, alpha, on_dual & live)
        alpha = torch.where(on_dual, alpha_bt, alpha)
    return dx, dz, dsv, dtau, dkappa, alpha, sigma, kkt_fail
