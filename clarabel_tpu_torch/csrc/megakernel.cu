// The batched conic IPM as one CUDA kernel, one instance per thread (K1a).
//
// Replaces: clarabel_tpu/ipm/megakernel.py `kernel` / `compute` (the Pallas
// megakernel launched by `_pallas_fn`), restricted to zero, nonnegative and
// second-order cone segments.  It computes what the plain PyTorch version
// clarabel_tpu_torch/ipm/megakernel_ref.py computes, formula for formula:
// Ruiz equilibration (scalings in float32, applied in float64), the
// symmetric initial point, the Mehrotra predictor-corrector loop over the
// condensed normal equations (unrolled dense Cholesky plus accept-masked
// refinement against the true augmented operator), the termination machine
// with the gap-aware stall check, and finalization.
//
// What bounds it on this card: FP64 operations.  A lane reads its P, q, A,
// b once (at most (n(n+1)/2 + n + nm + m) * 8 bytes, about 0.9 KB at the
// bench shape n=6, m=13, less when A is batch-constant) and writes
// (n + 2m + 13) * 8 + 8 bytes (0.37 KB), while one IPM iteration costs on
// the order of 10^4 FP64 operations (the condensed assembly, the factor,
// and up to ten refined solves with true-operator residuals), times ~8
// iterations.  Bytes over 3.35 TB/s are microseconds for the whole batch;
// operations over the FP64 rate are the bound (PERF.md works the count).
//
// What the design does about it: the reference's 1024-lane block loops
// are masked per lane, so each thread runs its own loops to its own exit
// and is never held back by the slowest lane of a block.  Every array is
// per thread with compile-time sizes (MK_N variables, MK_M cone rows,
// MK_S segments, set by the build per shape); the working set of ~800
// doubles does not fit in registers and lives in local memory, which is
// interleaved across the threads of a warp, so its accesses coalesce.
// The cone-segment table (kind, lo, hi) and the settings come by value in
// MkParams.  Inputs are component-major and lane-minor, (d, B) with a
// lane stride of 1, or (d,) with a lane stride of 0 for a component that
// is the same in every instance.  nvcc contracts a*b+c into FMA here and
// PyTorch's elementwise ops do not; the two versions may then differ by
// an iteration on marginal lanes (DEVIATIONS.md).
//
// Build (route (b): a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DMK_N=6 -DMK_M=13 -DMK_S=2 -o mk.so megakernel.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(MK_N) || !defined(MK_M) || !defined(MK_S)
#error "build with -DMK_N=<n> -DMK_M=<m> -DMK_S=<number of cone segments>"
#endif

namespace {

constexpr int N = MK_N;
constexpr int M = MK_M;
constexpr int S = MK_S;
constexpr int NT = N * (N + 1) / 2;
constexpr int OUTD = N + 2 * M + 13;
constexpr int THREADS = 128;
constexpr double BIG = 1e30;
constexpr double TINY32 = 1.1754943508222875e-38;   // float32 tiny
constexpr double EPS64 = 2.220446049250313e-16;

enum Status {
  UNSOLVED = 0, SOLVED = 1, PINF = 2, DINF = 3, ALMOST_SOLVED = 4,
  ALMOST_PINF = 5, ALMOST_DINF = 6, MAX_ITERATIONS = 7,
  NUMERICAL_ERROR = 9, INSUFFICIENT_PROGRESS = 10
};
enum SegKind { SEG_ZERO = 0, SEG_NN = 1, SEG_SOC = 2 };

}  // namespace

extern "C" {
// Settings and the cone-segment table; mirrored by a ctypes Structure in
// ipm/_cuda.py (doubles first, then ints).
struct MkParams {
  double eq_min_scaling, eq_max_scaling;
  double static_reg_constant, static_reg_proportional;
  double refine_abstol, refine_reltol, refine_stop_ratio;
  double max_step_fraction, min_terminate_step_length, stall_ratio;
  double tol[6];      // gap_abs, gap_rel, feas, infeas_abs, infeas_rel, ktratio
  double rtol[6];     // the reduced (ALMOST_*) tolerances, same order
  int seg_kind[S], seg_lo[S], seg_hi[S];
  int degree, p_nonzero, max_iter, eq_enable, eq_max_iter, refine_passes;
};
}

namespace {

// torch.minimum/maximum semantics: NaN if either operand is NaN
template <typename T> __device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

struct In {
  const double* p;
  long long ld;   // component stride
  long long ls;   // lane stride: 1, or 0 for a batch-constant component
};

__device__ __forceinline__ double at(const In& a, int k, long long lane) {
  return a.p[k * a.ld + lane * a.ls];
}

// The scaled problem of one lane.
struct Prob {
  double P[N * N];    // [i * N + j]
  double A[M * N];    // [k * N + j]
  double q[N], b[M];
  double d[N], e[M], dinv[N], einv[M];
  double cinv, normq, normb, pdiag;
};

// NT scaling state.  nn rows: w2 in w, 1/w2 in winv2; soc rows: w.
struct Scale {
  double w[M], winv2[M], lam[M];
  double eta[S], eta2[S], etainv[S], etainv2[S];
  bool ident;   // identity scaling (initial point)
};

struct Kkt {
  const Scale* sc;
  double L[N * N], Linv[N], eps;
};

struct Res {
  double rx[N], rz[M], rx_inf[N], rz_inf[M], Px[N];
  double rtau, qx, bz, sz, xPx;
};

struct Info {
  double cost_primal, cost_dual, res_primal, res_dual, res_primal_inf,
      res_dual_inf, gap_abs, gap_rel, ktratio;
};

struct Ctx {
  MkParams p;
  Prob pr;
};

template <int D> __device__ __forceinline__ double dotn(const double* a,
                                                        const double* b) {
  double acc = 0.0;
  for (int i = 0; i < D; ++i) acc += a[i] * b[i];
  return acc;
}

__device__ double vnorm(const double* v, int len) {
  double acc = 0.0;
  for (int i = 0; i < len; ++i) acc += v[i] * v[i];
  return sqrt(acc);
}

__device__ void Ax(const Prob& pr, const double* x, double* out) {
  for (int k = 0; k < M; ++k) {
    double acc = 0.0;
    for (int j = 0; j < N; ++j) acc += pr.A[k * N + j] * x[j];
    out[k] = acc;
  }
}

__device__ void Aty(const Prob& pr, const double* y, double* out) {
  for (int j = 0; j < N; ++j) {
    double acc = 0.0;
    for (int k = 0; k < M; ++k) acc += pr.A[k * N + j] * y[k];
    out[j] = acc;
  }
}

__device__ void Pxv(const Ctx& cx, const double* x, double* out) {
  for (int i = 0; i < N; ++i) {
    double acc = 0.0;
    if (cx.p.p_nonzero)
      for (int j = 0; j < N; ++j) acc += cx.pr.P[i * N + j] * x[j];
    out[i] = acc;
  }
}

__device__ double soc_res_sqrt(const double* X, int len) {
  const double x1n = vnorm(X + 1, len - 1);
  const double res = (X[0] - x1n) * (X[0] + x1n);
  return res > 0 ? sqrt(nmax(res, 0.0)) : 0.0;
}

// ---- cone scaling (reference make_scaling, l.1452-1510) ----
__device__ bool make_scaling(const Ctx& cx, const double* s,
                             const double* z, Scale& sc) {
  bool ok = true;
  sc.ident = false;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) continue;
    if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) {
        double prod = s[i] * z[i];
        ok = ok && (prod > 0);
        prod = nmax(prod, 0.0);
        const double zsafe = z[i] != 0 ? z[i] : 1.0;
        const double ratio = z[i] != 0 ? s[i] / zsafe : 0.0;
        const double w = sqrt(nmax(ratio, 0.0));
        const double w2 = w * w;
        sc.w[i] = w2;
        sc.winv2[i] = 1.0 / w2;
        sc.lam[i] = sqrt(prod);
      }
      continue;
    }
    const int len = hi - lo;
    const double* sg = s + lo;
    const double* zg = z + lo;
    double* w = sc.w + lo;
    double* lam = sc.lam + lo;
    const double zscale = soc_res_sqrt(zg, len);
    const double sscale = soc_res_sqrt(sg, len);
    bool okg = (zscale > 0) && (sscale > 0);
    const double zs = zscale > 0 ? zscale : 1.0;
    const double ss = sscale > 0 ? sscale : 1.0;
    const double zsinv = 1.0 / zs, ssinv = 1.0 / ss;
    const double eta = sqrt(ss * zsinv);
    w[0] = sg[0] * ssinv + zg[0] * zsinv;
    for (int i = 1; i < len; ++i) w[i] = sg[i] * ssinv - zg[i] * zsinv;
    const double wscale = soc_res_sqrt(w, len);
    okg = okg && (wscale > 0);
    const double ws = wscale > 0 ? wscale : 1.0;
    const double wsinv = 1.0 / ws;
    for (int i = 0; i < len; ++i) w[i] = w[i] * wsinv;
    double w1sq = 0.0;
    for (int i = 1; i < len; ++i) w1sq += w[i] * w[i];
    w[0] = sqrt(w1sq + 1.0);
    const double gamma = ws * 0.5;
    const double den = 1.0 / (sg[0] * ssinv + zg[0] * zsinv + gamma * 2.0);
    const double cs = (gamma + zg[0] * zsinv) * ssinv;
    const double cz = (gamma + sg[0] * ssinv) * zsinv;
    const double lscale = sqrt(ss * zs);
    lam[0] = gamma * lscale;
    for (int i = 1; i < len; ++i)
      lam[i] = ((cs * sg[i] + cz * zg[i]) * den) * lscale;
    sc.eta[g] = eta;
    sc.eta2[g] = eta * eta;
    sc.etainv[g] = 1.0 / eta;
    sc.etainv2[g] = 1.0 / (eta * eta);
    ok = ok && okg;
  }
  return ok;
}

// static regularization at this scaling (reference hs_diag_hi + eps_of)
__device__ double eps_of(const Ctx& cx, const Scale* sc) {
  double maxdiag = cx.pr.pdiag;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (sc == nullptr) {   // unit diagonal (initial point)
      if (hi > lo) maxdiag = nmax(maxdiag, 1.0);
      continue;
    }
    if (kind == SEG_ZERO) {
      if (hi > lo) maxdiag = nmax(maxdiag, 0.0);
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) maxdiag = nmax(maxdiag, fabs(sc->w[i]));
    } else {
      const double eta2 = sc->eta2[g];
      for (int i = lo; i < hi; ++i) {
        const double w2 = 2.0 * sc->w[i] * sc->w[i];
        const double dg = (i == lo ? w2 - 1.0 : w2 + 1.0) * eta2;
        maxdiag = nmax(maxdiag, fabs(dg));
      }
    }
  }
  return cx.p.static_reg_constant + cx.p.static_reg_proportional * maxdiag;
}

// Hs^{-1} v with 1/eps on zero-cone rows (reference hinv_apply)
__device__ void hinv_apply(const Ctx& cx, const Scale& sc, double eps,
                           const double* v, double* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      const double r = 1.0 / eps;
      for (int i = lo; i < hi; ++i) out[i] = v[i] * r;
    } else if (sc.ident) {
      for (int i = lo; i < hi; ++i) out[i] = v[i];
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = v[i] * sc.winv2[i];
    } else {
      double cc = sc.w[lo] * v[lo];
      for (int i = lo + 1; i < hi; ++i) cc += (-sc.w[i]) * v[i];
      cc = cc * 2.0;
      const double e2 = sc.etainv2[g];
      out[lo] = (-v[lo] + cc * sc.w[lo]) * e2;
      for (int i = lo + 1; i < hi; ++i) out[i] = (v[i] + cc * (-sc.w[i])) * e2;
    }
  }
}

// Hs v; the zero-cone block of the true operator is 0 (reference hs_apply)
__device__ void hs_apply(const Ctx& cx, const Scale& sc, const double* v,
                         double* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      for (int i = lo; i < hi; ++i) out[i] = 0.0;
    } else if (sc.ident) {
      for (int i = lo; i < hi; ++i) out[i] = v[i];
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = v[i] * sc.w[i];
    } else {
      double c = 0.0;
      for (int i = lo; i < hi; ++i) c += sc.w[i] * v[i];
      c = c * 2.0;
      const double e2 = sc.eta2[g];
      out[lo] = (-v[lo] + c * sc.w[lo]) * e2;
      for (int i = lo + 1; i < hi; ++i) out[i] = (v[i] + c * sc.w[i]) * e2;
    }
  }
}

// ---- condensed KKT: S = A' Hinv A + P + eps I, Cholesky in place ----
__device__ bool build_kkt(const Ctx& cx, const Scale& sc, double eps,
                          Kkt& kk) {
  kk.sc = &sc;
  kk.eps = eps;
  double col[M], hcol[M];
  for (int j = 0; j < N; ++j) {
    for (int k = 0; k < M; ++k) col[k] = cx.pr.A[k * N + j];
    hinv_apply(cx, sc, eps, col, hcol);
    for (int i = j; i < N; ++i) {
      double acc = 0.0;
      for (int k = 0; k < M; ++k) acc += cx.pr.A[k * N + i] * hcol[k];
      if (cx.p.p_nonzero) acc = acc + cx.pr.P[i * N + j];
      kk.L[i * N + j] = acc;
    }
    kk.L[j * N + j] += eps;
  }
  bool ok = true;
  for (int j = 0; j < N; ++j) {
    double ssq = 0.0;
    for (int k = 0; k < j; ++k) ssq += kk.L[j * N + k] * kk.L[j * N + k];
    const double acc = kk.L[j * N + j] - ssq;
    ok = ok && (acc > 0);
    double Ljj = sqrt(nmax(acc, 0.0));
    Ljj = Ljj > 0 ? Ljj : 1.0;
    kk.L[j * N + j] = Ljj;
    kk.Linv[j] = 1.0 / Ljj;
    for (int i = j + 1; i < N; ++i) {
      double sp = 0.0;
      for (int k = 0; k < j; ++k) sp += kk.L[i * N + k] * kk.L[j * N + k];
      kk.L[i * N + j] = (kk.L[i * N + j] - sp) * kk.Linv[j];
    }
  }
  return ok;
}

__device__ void chol_solve(const Kkt& kk, const double* w, double* x) {
  double y[N];
  for (int j = 0; j < N; ++j) {
    double sp = 0.0;
    for (int k = 0; k < j; ++k) sp += kk.L[j * N + k] * y[k];
    y[j] = (w[j] - sp) * kk.Linv[j];
  }
  for (int i = N - 1; i >= 0; --i) {
    double sp = 0.0;
    for (int k = i + 1; k < N; ++k) sp += kk.L[k * N + i] * x[k];
    x[i] = (y[i] - sp) * kk.Linv[i];
  }
}

__device__ void apply_once(const Ctx& cx, const Kkt& kk, const double* bx,
                           const double* bz, double* xs, double* zs) {
  double hb[M], w[N], t[M];
  hinv_apply(cx, *kk.sc, kk.eps, bz, hb);
  Aty(cx.pr, hb, w);
  for (int j = 0; j < N; ++j) w[j] = bx[j] + w[j];
  chol_solve(kk, w, xs);
  Ax(cx.pr, xs, t);
  for (int k = 0; k < M; ++k) t[k] = t[k] - bz[k];
  hinv_apply(cx, *kk.sc, kk.eps, t, zs);
}

// (bx, bz) - K (xs, zs) of the true augmented operator
__device__ void kkt_resid(const Ctx& cx, const Kkt& kk, const double* bx,
                          const double* bz, const double* xs,
                          const double* zs, double* ex, double* ez) {
  double t[N], u[N], v[M], h[M];
  Aty(cx.pr, zs, t);
  Pxv(cx, xs, u);
  for (int j = 0; j < N; ++j) ex[j] = bx[j] - (t[j] + u[j]);
  Ax(cx.pr, xs, v);
  hs_apply(cx, *kk.sc, zs, h);
  for (int k = 0; k < M; ++k) ez[k] = bz[k] - (v[k] - h[k]);
}

template <int K> __device__ double pair_max(const double (*a)[N],
                                            const double (*b)[M]) {
  double mx = 0.0;
  bool first = true;
  for (int r = 0; r < K; ++r) {
    double v = fabs(a[r][0]);
    for (int j = 1; j < N; ++j) v = nmax(v, fabs(a[r][j]));
    double u = fabs(b[r][0]);
    for (int k = 1; k < M; ++k) u = nmax(u, fabs(b[r][k]));
    v = nmax(v, u);
    mx = first ? v : nmax(mx, v);
    first = false;
  }
  return mx;
}

// Accept-masked refinement against the true operator (reference
// refined_solve, l.1861-1988); joint norms over the K right-hand sides.
template <int K>
__device__ bool refined_solve(const Ctx& cx, const Kkt& kk,
                              const double (*bx)[N], const double (*bz)[M],
                              double (*xs)[N], double (*zs)[M]) {
  for (int r = 0; r < K; ++r) apply_once(cx, kk, bx[r], bz[r], xs[r], zs[r]);
  const int passes = cx.p.refine_passes;
  if (passes <= 0) return isfinite(pair_max<K>(xs, zs));
  const double normb = pair_max<K>(bx, bz);
  double ex[K][N], ez[K][M];
  for (int r = 0; r < K; ++r)
    kkt_resid(cx, kk, bx[r], bz[r], xs[r], zs[r], ex[r], ez[r]);
  double norme = pair_max<K>(ex, ez);
  bool ok = isfinite(norme);
  bool done = false;
  const double tol = cx.p.refine_abstol + cx.p.refine_reltol * normb;
  for (int p = 0; p < passes; ++p) {
    const bool active = !done && ok && (norme > tol);
    if (!active) break;   // an inactive lane stays inactive
    double nx[K][N], nz[K][M], nex[K][N], nez[K][M];
    for (int r = 0; r < K; ++r) {
      double dx[N], dz[M];
      apply_once(cx, kk, ex[r], ez[r], dx, dz);
      for (int j = 0; j < N; ++j) nx[r][j] = xs[r][j] + dx[j];
      for (int k = 0; k < M; ++k) nz[r][k] = zs[r][k] + dz[k];
    }
    for (int r = 0; r < K; ++r)
      kkt_resid(cx, kk, bx[r], bz[r], nx[r], nz[r], nex[r], nez[r]);
    const double nn = pair_max<K>(nex, nez);
    const bool okn = isfinite(nn);
    const double ratio = norme / (nn != 0 ? nn : TINY32);
    const bool stop = ratio < cx.p.refine_stop_ratio;
    const bool accept = okn && (!stop || ratio > 1.0);
    done = stop || !okn;
    ok = ok && okn;
    if (accept) {
      for (int r = 0; r < K; ++r) {
        for (int j = 0; j < N; ++j) { xs[r][j] = nx[r][j]; ex[r][j] = nex[r][j]; }
        for (int k = 0; k < M; ++k) { zs[r][k] = nz[r][k]; ez[r][k] = nez[r][k]; }
      }
      norme = nn;
    }
  }
  return ok && isfinite(norme);
}

// ---- initial point (reference shift_to_interior, l.2015) ----
__device__ void shift_to_interior(const Ctx& cx, double* v, bool primal) {
  double mm = BIG, pm = 0.0;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_NN) {
      double mn = v[lo], ps = 0.0;
      for (int i = lo + 1; i < hi; ++i) mn = nmin(mn, v[i]);
      for (int i = lo; i < hi; ++i) ps += nmax(v[i], 0.0);
      mm = nmin(mm, mn);
      pm = pm + ps;
    } else if (kind == SEG_SOC) {
      const double a = v[lo] - vnorm(v + lo + 1, hi - lo - 1);
      mm = nmin(mm, a);
      pm = pm + nmax(a, 0.0);
    }
  }
  mm = isfinite(mm) ? mm : -1.0;
  pm = isfinite(pm) ? pm : 0.0;
  const int deg = cx.p.degree > 1 ? cx.p.degree : 1;
  const double target = nmax(0.1 * pm / deg, 1.0);
  const double amt1 = mm <= 0 ? -mm : 0.0;
  const double amt2 = mm <= 0 ? target : (mm < target ? target - mm : 0.0);
  const double amt = amt1 + amt2;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      if (primal)
        for (int i = lo; i < hi; ++i) v[i] = 0.0;
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) v[i] = v[i] + amt;
    } else {
      v[lo] = v[lo] + amt;
    }
  }
}

// ---- step length (reference step_length / soc_step_len) ----
__device__ double soc_step_len(const double* X, const double* Y, int len) {
  const double x0 = X[0], y0 = Y[0];
  const double a0 = (x0 >= 0 && y0 < 0) ? -x0 / (y0 < 0 ? y0 : -1.0) : BIG;
  double yy = 0.0, xy = 0.0, xx = 0.0;
  for (int i = 1; i < len; ++i) {
    yy += Y[i] * Y[i];
    xy += X[i] * Y[i];
    xx += X[i] * X[i];
  }
  const double a = Y[0] * Y[0] - yy;
  const double b = (X[0] * Y[0] - xy) * 2.0;
  const double c = nmax(X[0] * X[0] - xx, 0.0);
  const double d = b * b - a * c * 4.0;
  const double sqrt_d = sqrt(nmax(d, 0.0));
  const double t = b >= 0 ? -b - sqrt_d : -b + sqrt_d;
  double r1 = t != 0 ? (2.0 * c) / t : BIG;
  double r2 = a != 0 ? t / (2.0 * a) : BIG;
  r1 = r1 < 0 ? BIG : r1;
  r2 = r2 < 0 ? BIG : r2;
  const double root = nmin(r1, r2);
  double alpha;
  if ((a > 0 && b > 0) || d < 0) alpha = BIG;
  else if (a == 0) alpha = BIG;
  else if (c == 0) alpha = a >= 0 ? BIG : 0.0;
  else alpha = root;
  return nmin(alpha, a0);
}

__device__ double step_length(const Ctx& cx, const double* dz,
                              const double* ds, const double* z,
                              const double* s, double amax) {
  double alpha = amax;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) continue;
    if (kind == SEG_NN) {
      double az = BIG, as = BIG;
      bool first = true;
      for (int i = lo; i < hi; ++i) {
        const double rz = dz[i] < 0 ? -z[i] / dz[i] : BIG;
        const double rs = ds[i] < 0 ? -s[i] / ds[i] : BIG;
        az = first ? rz : nmin(az, rz);
        as = first ? rs : nmin(as, rs);
        first = false;
      }
      alpha = nmin(alpha, az);
      alpha = nmin(alpha, as);
    } else {
      alpha = nmin(alpha, soc_step_len(z + lo, dz + lo, hi - lo));
      alpha = nmin(alpha, soc_step_len(s + lo, ds + lo, hi - lo));
    }
  }
  return alpha;
}

// ---- predictor-corrector pieces ----
__device__ void affine_ds(const Ctx& cx, const Scale& sc, double* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      for (int i = lo; i < hi; ++i) out[i] = 0.0;
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = sc.lam[i] * sc.lam[i];
    } else {
      double acc = 0.0;
      for (int i = lo; i < hi; ++i) acc += sc.lam[i] * sc.lam[i];
      out[lo] = acc;
      for (int i = lo + 1; i < hi; ++i) out[i] = sc.lam[lo] * sc.lam[i] * 2.0;
    }
  }
}

// W X (inv = false) or W^{-1} X (inv = true) on one soc segment
__device__ void mul_w(const double* w, const double* X, int len,
                      double etaf, bool inv, double* y) {
  double zeta = 0.0;
  for (int i = 1; i < len; ++i) zeta += w[i] * X[i];
  const double denom = 1.0 / (w[0] + 1.0);
  const double c = (inv ? -X[0] : X[0]) + zeta * denom;
  y[0] = (inv ? w[0] * X[0] - zeta : w[0] * X[0] + zeta) * etaf;
  for (int i = 1; i < len; ++i) y[i] = (X[i] + c * w[i]) * etaf;
}

__device__ void combined_ds_shift(const Ctx& cx, const Scale& sc,
                                  const double* dz, const double* ds,
                                  double sigma_mu, double* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      for (int i = lo; i < hi; ++i) out[i] = 0.0;
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = dz[i] * ds[i] - sigma_mu;
    } else {
      const int len = hi - lo;
      double wdz[M], wids[M];
      mul_w(sc.w + lo, dz + lo, len, sc.eta[g], false, wdz);
      mul_w(sc.w + lo, ds + lo, len, sc.etainv[g], true, wids);
      double acc = 0.0;
      for (int i = 0; i < len; ++i) acc += wids[i] * wdz[i];
      out[lo] = acc - sigma_mu;
      for (int i = 1; i < len; ++i)
        out[lo + i] = wids[0] * wdz[i] + wdz[0] * wids[i];
    }
  }
}

__device__ void ds_from_dz_offset(const Ctx& cx, const Scale& sc,
                                  const double* dsv, const double* z,
                                  double* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      for (int i = lo; i < hi; ++i) out[i] = 0.0;
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = dsv[i] / z[i];
    } else {
      const double* w = sc.w + lo;
      const double* lam = sc.lam + lo;
      const double* zg = z + lo;
      const double* dsg = dsv + lo;
      const int len = hi - lo;
      const double eta = sc.eta[g];
      const double z1n = vnorm(zg + 1, len - 1);
      const double resz = (zg[0] - z1n) * (zg[0] + z1n);
      double lam1ds1 = 0.0, w1ds1 = 0.0;
      for (int i = 1; i < len; ++i) {
        lam1ds1 += lam[i] * dsg[i];
        w1ds1 += w[i] * dsg[i];
      }
      const double c = (lam[0] * dsg[0] - lam1ds1) * (1.0 / resz);
      const double o0 = zg[0] * c + eta * w1ds1;
      const double wc = w1ds1 * (1.0 / (w[0] + 1.0));
      const double lam0inv = 1.0 / lam[0];
      out[lo] = o0 * lam0inv;
      for (int i = 1; i < len; ++i)
        out[lo + i] = (-zg[i] * c + (dsg[i] + wc * w[i]) * eta) * lam0inv;
    }
  }
}

// ---- residuals, info, convergence (reference l.2702-2835) ----
__device__ void residuals(const Ctx& cx, const double* x, const double* z,
                          const double* s, double tau, double kappa,
                          double tinv, Res& r) {
  r.sz = dotn<M>(s, z);
  r.qx = dotn<N>(cx.pr.q, x);
  r.bz = dotn<M>(cx.pr.b, z);
  Pxv(cx, x, r.Px);
  r.xPx = dotn<N>(x, r.Px);
  Aty(cx.pr, z, r.rx_inf);
  for (int j = 0; j < N; ++j) r.rx_inf[j] = -r.rx_inf[j];
  Ax(cx.pr, x, r.rz_inf);
  for (int k = 0; k < M; ++k) r.rz_inf[k] = s[k] + r.rz_inf[k];
  for (int j = 0; j < N; ++j)
    r.rx[j] = r.rx_inf[j] - r.Px[j] - cx.pr.q[j] * tau;
  for (int k = 0; k < M; ++k) r.rz[k] = r.rz_inf[k] - cx.pr.b[k] * tau;
  r.rtau = r.qx + r.bz + kappa + r.xPx * tinv;
}

template <int D> __device__ double scaled_norm(const double* sc,
                                               const double* v) {
  double acc = 0.0;
  for (int i = 0; i < D; ++i) {
    const double t = sc[i] * v[i];
    acc += t * t;
  }
  return sqrt(acc);
}

__device__ void compute_info(const Ctx& cx, const Res& r, const double* x,
                             const double* z, const double* s, double kappa,
                             double tinv, Info& in) {
  const Prob& pr = cx.pr;
  const double xPx_half = r.xPx * tinv * tinv * 0.5;
  in.cost_primal = (r.qx * tinv + xPx_half) * pr.cinv;
  in.cost_dual = (-r.bz * tinv - xPx_half) * pr.cinv;
  double normx = scaled_norm<N>(pr.d, x);
  double normz = scaled_norm<M>(pr.e, z) * pr.cinv;
  double norms = scaled_norm<M>(pr.einv, s);
  in.res_primal_inf =
      scaled_norm<N>(pr.dinv, r.rx_inf) * pr.cinv / nmax(1.0, normz);
  in.res_dual_inf =
      nmax(scaled_norm<N>(pr.dinv, r.Px) / nmax(1.0, normx),
           scaled_norm<M>(pr.einv, r.rz_inf) / nmax(1.0, normx + norms));
  normx = normx * tinv;
  normz = normz * tinv;
  norms = norms * tinv;
  in.res_primal = scaled_norm<M>(pr.einv, r.rz) * tinv /
                  nmax(1.0, pr.normb + normx + norms);
  in.res_dual = scaled_norm<N>(pr.dinv, r.rx) * tinv * pr.cinv /
                nmax(1.0, pr.normq + normx + normz);
  in.gap_abs = fabs(in.cost_primal - in.cost_dual);
  in.gap_rel = in.gap_abs /
               nmax(1.0, nmin(fabs(in.cost_primal), fabs(in.cost_dual)));
  in.ktratio = kappa * tinv;
}

__device__ int check_convergence(const Info& in, double bz, double qx,
                                 const double* tol, int s_st, int p_st,
                                 int d_st) {
  const bool is_solved = (in.gap_abs < tol[0] || in.gap_rel < tol[1]) &&
                         in.res_primal < tol[2] && in.res_dual < tol[2];
  if (in.ktratio <= 1.0 && is_solved) return s_st;
  const bool kt_big = in.ktratio > 1000.0 / tol[5];
  const bool pinf = bz < -tol[3] && in.res_primal_inf < -tol[4] * bz;
  const bool dinf = qx < -tol[3] && in.res_dual_inf < -tol[4] * qx;
  if (kt_big && pinf) return p_st;
  if (kt_big && dinf) return d_st;
  return UNSOLVED;
}

struct Step {
  double dx[N], dz[M], ds[M];
  double dtau, dkappa, alpha, sigma;
  bool kkt_fail;
};

// tau recovery (reference pc_step.tau_recovery, src/kktsystem.jl:135-215)
__device__ void tau_recovery(const Ctx& cx, const Scale& sc,
                             const double* x1, const double* z1,
                             const double* x2, const double* z2,
                             const double* xi, const double* ds_const,
                             double rhs_tau, double rhs_kappa, double kappa,
                             double tinv, double tau_den, double* dx,
                             double* dz, double* dsv, double& dtau,
                             double& dkappa) {
  double tau_num = rhs_tau - rhs_kappa * tinv + dotn<N>(cx.pr.q, x1) +
                   dotn<M>(cx.pr.b, z1);
  if (cx.p.p_nonzero) {
    double px1[N];
    Pxv(cx, x1, px1);
    tau_num = tau_num + dotn<N>(xi, px1) * 2.0;
  }
  dtau = tau_num / tau_den;
  for (int j = 0; j < N; ++j) dx[j] = x1[j] + x2[j] * dtau;
  for (int k = 0; k < M; ++k) dz[k] = z1[k] + z2[k] * dtau;
  double h[M];
  hs_apply(cx, sc, dz, h);
  for (int k = 0; k < M; ++k) dsv[k] = -(h[k] + ds_const[k]);
  dkappa = -(rhs_kappa + kappa * dtau) * tinv;
}

__device__ double max_step(double tau, double kappa, double dtau,
                           double dkappa) {
  const double a_tau = dtau < 0 ? -tau / dtau : BIG;
  const double a_kap = dkappa < 0 ? -kappa / dkappa : BIG;
  return nmin(nmin(a_tau, a_kap), 1.0);
}

// One Mehrotra predictor-corrector step (reference pc_step, l.2839-2977)
__device__ void pc_step(const Ctx& cx, const double* x, const double* z,
                        const double* s, double tau, double kappa,
                        double tinv, const Res& res, double mu, int iters1,
                        Step& st) {
  Scale sc;
  const bool ok_scale = make_scaling(cx, s, z, sc);
  const double eps = eps_of(cx, &sc);
  Kkt kk;
  const bool ok_chol = build_kkt(cx, sc, eps, kk);
  bool ok_kkt = ok_scale && ok_chol;

  double aff[M];
  affine_ds(cx, sc, aff);
  double bx[2][N], bz[2][M], xs[2][N], zs[2][M];
  for (int j = 0; j < N; ++j) { bx[0][j] = -cx.pr.q[j]; bx[1][j] = res.rx[j]; }
  for (int k = 0; k < M; ++k) { bz[0][k] = cx.pr.b[k]; bz[1][k] = s[k] - res.rz[k]; }
  ok_kkt = refined_solve<2>(cx, kk, bx, bz, xs, zs) && ok_kkt;
  const double* x2 = xs[0];
  const double* z2 = zs[0];

  double xi[N], xm[N];
  for (int j = 0; j < N; ++j) { xi[j] = x[j] * tinv; xm[j] = xi[j] - x2[j]; }
  double tau_den = kappa * tinv - dotn<N>(cx.pr.q, x2) - dotn<M>(cx.pr.b, z2);
  if (cx.p.p_nonzero) {
    double t1[N], t2[N];
    Pxv(cx, xm, t1);
    Pxv(cx, x2, t2);
    tau_den = tau_den + dotn<N>(xm, t1) - dotn<N>(x2, t2);
  }

  // affine step
  double dxa[N], dza[M], dsa[M], dtaua, dkappaa;
  tau_recovery(cx, sc, xs[1], zs[1], x2, z2, xi, s, res.rtau, tau * kappa,
               kappa, tinv, tau_den, dxa, dza, dsa, dtaua, dkappaa);
  const double alpha_aff = step_length(cx, dza, dsa, z, s,
                                       max_step(tau, kappa, dtaua, dkappaa));
  const double oma = 1.0 - alpha_aff;
  const double sigma = oma * oma * oma;
  const double m_corr = iters1 > 1 ? 1.0 : alpha_aff;
  const double sigma_mu = sigma * mu;

  // combined step
  double dzm[M], shift[M];
  for (int k = 0; k < M; ++k) dzm[k] = dza[k] * m_corr;
  combined_ds_shift(cx, sc, dzm, dsa, sigma_mu, shift);
  for (int k = 0; k < M; ++k) aff[k] = aff[k] + shift[k];   // comb_s
  const double one_m_sigma = 1.0 - sigma;
  const double comb_tau = res.rtau * one_m_sigma;
  const double comb_kappa = -sigma_mu + dtaua * dkappaa * m_corr + tau * kappa;
  double ds_const[M];
  ds_from_dz_offset(cx, sc, aff, z, ds_const);
  for (int j = 0; j < N; ++j) bx[0][j] = res.rx[j] * one_m_sigma;
  for (int k = 0; k < M; ++k) bz[0][k] = ds_const[k] - res.rz[k] * one_m_sigma;
  double xc[1][N], zc[1][M];
  const bool ok3 = refined_solve<1>(cx, kk, bx, bz, xc, zc);
  tau_recovery(cx, sc, xc[0], zc[0], x2, z2, xi, ds_const, comb_tau,
               comb_kappa, kappa, tinv, tau_den, st.dx, st.dz, st.ds, st.dtau,
               st.dkappa);
  st.kkt_fail = !(ok_kkt && ok3);
  st.alpha = step_length(cx, st.dz, st.ds, z, s,
                         max_step(tau, kappa, st.dtau, st.dkappa)) *
             cx.p.max_step_fraction;
  st.sigma = sigma;
}

// ---- Ruiz equilibration: scalings in float32 (reference l.2997-3046) ----
__device__ void ruiz(const Ctx& cx, const double* Praw, const double* Araw,
                     const double* qraw, float* df, float* ef, float& cf) {
  for (int j = 0; j < N; ++j) df[j] = 1.0f;
  for (int k = 0; k < M; ++k) ef[k] = 1.0f;
  cf = 1.0f;
  if (!cx.p.eq_enable) return;
  const float smin = (float)cx.p.eq_min_scaling;
  const float smax = (float)cx.p.eq_max_scaling;
  float Pa[N * N], Aa[M * N], qa[N];
  for (int i = 0; i < N * N; ++i) Pa[i] = fabsf((float)Praw[i]);
  for (int i = 0; i < M * N; ++i) Aa[i] = fabsf((float)Araw[i]);
  for (int j = 0; j < N; ++j) qa[j] = fabsf((float)qraw[j]);
  for (int it = 0; it < cx.p.eq_max_iter; ++it) {
    float dw[N], ew[M];
    for (int j = 0; j < N; ++j) {
      float pc = Pa[j], ac = Aa[j];
      for (int i = 1; i < N; ++i) pc = nmax(pc, Pa[i * N + j]);
      for (int k = 1; k < M; ++k) ac = nmax(ac, Aa[k * N + j]);
      dw[j] = nmax(pc, ac);
    }
    for (int k = 0; k < M; ++k) {
      float r = Aa[k * N];
      for (int j = 1; j < N; ++j) r = nmax(r, Aa[k * N + j]);
      ew[k] = r;
    }
    for (int j = 0; j < N; ++j) {
      const float v = dw[j] == 0.0f ? 1.0f : dw[j];
      dw[j] = nmin(nmax(1.0f / sqrtf(v), smin / df[j]), smax / df[j]);
    }
    for (int k = 0; k < M; ++k) {
      const float v = ew[k] == 0.0f ? 1.0f : ew[k];
      ew[k] = nmin(nmax(1.0f / sqrtf(v), smin / ef[k]), smax / ef[k]);
    }
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < N; ++j) Pa[i * N + j] = Pa[i * N + j] * dw[j] * dw[i];
    for (int k = 0; k < M; ++k)
      for (int j = 0; j < N; ++j) Aa[k * N + j] = Aa[k * N + j] * dw[j] * ew[k];
    for (int j = 0; j < N; ++j) {
      qa[j] = qa[j] * dw[j];
      df[j] = df[j] * dw[j];
    }
    for (int k = 0; k < M; ++k) ef[k] = ef[k] * ew[k];
    float sum_p = 0.0f, inf_q = qa[0];
    for (int j = 0; j < N; ++j) {
      float pc = Pa[j];
      for (int i = 1; i < N; ++i) pc = nmax(pc, Pa[i * N + j]);
      sum_p = sum_p + pc;
    }
    for (int j = 1; j < N; ++j) inf_q = nmax(inf_q, qa[j]);
    const float mean_p = sum_p / (float)N;
    const bool do_cost = (mean_p != 0.0f) && (inf_q != 0.0f);
    const float scale_cost = nmax(inf_q, mean_p);
    const float inv = 1.0f / (scale_cost != 0.0f ? scale_cost : 1.0f);
    const float ctmp = do_cost ? nmin(nmax(inv, smin / cf), smax / cf) : 1.0f;
    for (int i = 0; i < N * N; ++i) Pa[i] = Pa[i] * ctmp;
    for (int j = 0; j < N; ++j) qa[j] = qa[j] * ctmp;
    cf = cf * ctmp;
  }
  // cone rectification: one scalar (the mean) on each SOC segment
  for (int g = 0; g < S; ++g) {
    if (cx.p.seg_kind[g] != SEG_SOC) continue;
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) acc = acc + ef[k];
    const float mean = acc / (float)(hi - lo);
    for (int k = lo; k < hi; ++k) ef[k] = mean;
  }
}

__device__ void solve_lane(Ctx& cx, const In& Pin, const In& qin,
                           const In& Ain, const In& bin, long long lane,
                           long long B, double* __restrict__ vals,
                           int* __restrict__ ints) {
  Prob& pr = cx.pr;
  const MkParams& p = cx.p;
  // raw data: P full symmetric from the column-major upper triangle
  for (int j = 0; j < N; ++j)
    for (int i = 0; i <= j; ++i) {
      const double v = at(Pin, j * (j + 1) / 2 + i, lane);
      pr.P[i * N + j] = v;
      pr.P[j * N + i] = v;
    }
  for (int j = 0; j < N; ++j)
    for (int k = 0; k < M; ++k) pr.A[k * N + j] = at(Ain, j * M + k, lane);
  double qraw[N];
  for (int j = 0; j < N; ++j) qraw[j] = at(qin, j, lane);

  float df[N], ef[M], cf;
  ruiz(cx, pr.P, pr.A, qraw, df, ef, cf);
  const double c = (double)cf;
  pr.cinv = 1.0 / c;
  for (int j = 0; j < N; ++j) {
    pr.d[j] = (double)df[j];
    pr.dinv[j] = 1.0 / pr.d[j];
    pr.q[j] = qraw[j] * (pr.d[j] * c);
  }
  for (int k = 0; k < M; ++k) {
    pr.e[k] = (double)ef[k];
    pr.einv[k] = 1.0 / pr.e[k];
    pr.b[k] = at(bin, k, lane) * pr.e[k];
  }
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j)
      pr.P[i * N + j] =
          p.p_nonzero ? pr.P[i * N + j] * (pr.d[i] * (pr.d[j] * c)) : 0.0;
  for (int k = 0; k < M; ++k)
    for (int j = 0; j < N; ++j)
      pr.A[k * N + j] = pr.A[k * N + j] * (pr.e[k] * pr.d[j]);
  pr.normq = fabs(pr.dinv[0] * pr.q[0]);
  for (int j = 1; j < N; ++j) pr.normq = nmax(pr.normq, fabs(pr.dinv[j] * pr.q[j]));
  pr.normq = pr.normq * pr.cinv;
  pr.normb = fabs(pr.einv[0] * pr.b[0]);
  for (int k = 1; k < M; ++k) pr.normb = nmax(pr.normb, fabs(pr.einv[k] * pr.b[k]));
  pr.pdiag = 0.0;
  if (p.p_nonzero) {
    pr.pdiag = fabs(pr.P[0]);
    for (int j = 1; j < N; ++j) pr.pdiag = nmax(pr.pdiag, fabs(pr.P[j * N + j]));
  }

  // ---- initial point (symmetric cones; reference l.3139-3157) ----
  double x[N], z[M], s[M];
  {
    Scale id;
    id.ident = true;
    Kkt k0;
    build_kkt(cx, id, eps_of(cx, nullptr), k0);
    if (p.p_nonzero) {
      double bx[1][N], bz[1][M], xs[1][N], zs[1][M];
      for (int j = 0; j < N; ++j) bx[0][j] = -pr.q[j];
      for (int k = 0; k < M; ++k) bz[0][k] = pr.b[k];
      refined_solve<1>(cx, k0, bx, bz, xs, zs);
      for (int j = 0; j < N; ++j) x[j] = xs[0][j];
      for (int k = 0; k < M; ++k) { z[k] = zs[0][k]; s[k] = -zs[0][k]; }
    } else {
      double bx[2][N], bz[2][M], xs[2][N], zs[2][M];
      for (int j = 0; j < N; ++j) { bx[0][j] = 0.0; bx[1][j] = -pr.q[j]; }
      for (int k = 0; k < M; ++k) { bz[0][k] = pr.b[k]; bz[1][k] = 0.0; }
      refined_solve<2>(cx, k0, bx, bz, xs, zs);
      for (int j = 0; j < N; ++j) x[j] = xs[0][j];
      for (int k = 0; k < M; ++k) { s[k] = -zs[0][k]; z[k] = zs[1][k]; }
    }
    shift_to_interior(cx, s, true);
    shift_to_interior(cx, z, false);
  }
  double tau = 1.0, kappa = 1.0;
  double px[N], pz[M], ps[M], ptau = tau, pkap = kappa;
  for (int j = 0; j < N; ++j) px[j] = x[j];
  for (int k = 0; k < M; ++k) { pz[k] = z[k]; ps[k] = s[k]; }
  double prev_rp = BIG, prev_rd = BIG, prev_ga = BIG, prev_gr = BIG;
  double mu_f = BIG, alpha_f = 0.0, sigma_f = 1.0;
  int iters = 0, status = UNSOLVED;
  const double inv_deg1 = 1.0 / (p.degree + 1);
  const double sr = p.stall_ratio;

  // ---- main loop: this lane runs until it terminates ----
  while (status == UNSOLVED) {
    const double tinv = 1.0 / tau;
    Res res;
    residuals(cx, x, z, s, tau, kappa, tinv, res);
    const double mu = (res.sz + tau * kappa) * inv_deg1;
    Info info;
    compute_info(cx, res, x, z, s, kappa, tinv, info);
    const int status1 =
        check_convergence(info, res.bz, res.qx, p.tol, SOLVED, PINF, DINF);

    const double rp = info.res_primal, rd = info.res_dual;
    const bool going_back = rd > prev_rd || rp > prev_rp;
    const bool stagnating = (rd > sr * prev_rd || rp > sr * prev_rp) &&
                            (info.gap_abs > sr * prev_ga &&
                             info.gap_rel > sr * prev_gr);
    const bool after_first = status1 == UNSOLVED && iters > 1;
    const bool poor_hi = info.ktratio < 100.0 * EPS64 &&
                         (prev_ga < p.tol[0] || prev_gr < p.tol[1]);
    const double tf100 = 100.0 * p.tol[2];
    const bool diverging =
        info.ktratio < 1.0 && ((rd > tf100 && rd > 100.0 * prev_rd) ||
                               (rp > tf100 && rp > 100.0 * prev_rp));
    const bool insuff = (after_first && stagnating && poor_hi) ||
                        (after_first && going_back && diverging);
    int status2 = insuff ? INSUFFICIENT_PROGRESS : status1;
    if (status2 == UNSOLVED && iters >= p.max_iter) status2 = MAX_ITERATIONS;
    mu_f = mu;
    if (status2 != UNSOLVED) {
      // terminated at the top of the loop; roll back on insufficient
      // progress (src/solver.jl:453-472)
      if (status2 == INSUFFICIENT_PROGRESS) {
        for (int j = 0; j < N; ++j) x[j] = px[j];
        for (int k = 0; k < M; ++k) { z[k] = pz[k]; s[k] = ps[k]; }
        tau = ptau;
        kappa = pkap;
      }
      status = status2;
      break;
    }
    const int iters1 = iters + 1;
    Step stp;
    pc_step(cx, x, z, s, tau, kappa, tinv, res, mu, iters1, stp);

    int fail_status = stp.kkt_fail ? NUMERICAL_ERROR : UNSOLVED;
    const bool small_term =
        stp.alpha <= nmax(0.0, p.min_terminate_step_length);
    if (fail_status == UNSOLVED && small_term)
      fail_status = INSUFFICIENT_PROGRESS;
    const bool take = !stp.kkt_fail && !small_term;
    const double a = take ? stp.alpha : 0.0;
    if (take) {
      for (int j = 0; j < N; ++j) { px[j] = x[j]; x[j] = x[j] + stp.dx[j] * a; }
      for (int k = 0; k < M; ++k) {
        pz[k] = z[k];
        ps[k] = s[k];
        z[k] = z[k] + stp.dz[k] * a;
        s[k] = s[k] + stp.ds[k] * a;
      }
      ptau = tau;
      pkap = kappa;
      tau = tau + stp.dtau * a;
      kappa = kappa + stp.dkappa * a;
      prev_rp = rp;
      prev_rd = rd;
      prev_ga = info.gap_abs;
      prev_gr = info.gap_rel;
    }
    alpha_f = a;
    sigma_f = stp.sigma;
    status = fail_status;
    iters = iters1;
  }

  // ---- finalize ----
  const double tinv = 1.0 / tau;
  Res res;
  residuals(cx, x, z, s, tau, kappa, tinv, res);
  Info info;
  compute_info(cx, res, x, z, s, kappa, tinv, info);
  const bool errored = status == NUMERICAL_ERROR ||
                       status == INSUFFICIENT_PROGRESS ||
                       status == MAX_ITERATIONS;
  const int almost = check_convergence(info, res.bz, res.qx, p.rtol,
                                       ALMOST_SOLVED, ALMOST_PINF, ALMOST_DINF);
  const int raw_status = status;
  if (errored && almost != UNSOLVED) status = almost;
  const bool is_inf = status == PINF || status == DINF ||
                      status == ALMOST_PINF || status == ALMOST_DINF;
  const double scaleinv = 1.0 / (is_inf ? kappa : tau);
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  double* o = vals + lane;
  int r = 0;
  for (int j = 0; j < N; ++j) o[(r++) * B] = x[j] * pr.d[j] * scaleinv;
  for (int k = 0; k < M; ++k)
    o[(r++) * B] = z[k] * pr.e[k] * (scaleinv * pr.cinv);
  for (int k = 0; k < M; ++k) o[(r++) * B] = s[k] * pr.einv[k] * scaleinv;
  const double scalars[13] = {
      is_inf ? nan : info.cost_primal, is_inf ? nan : info.cost_dual,
      info.res_primal, info.res_dual, info.gap_abs, info.gap_rel, mu_f,
      alpha_f, sigma_f, info.ktratio, tau * scaleinv, kappa * scaleinv,
      (double)raw_status};
  for (int i = 0; i < 13; ++i) o[(r++) * B] = scalars[i];
  ints[lane] = status;
  ints[B + lane] = iters;
}

__global__ void __launch_bounds__(THREADS)
mk_kernel(In P, In q, In A, In b, long long B, MkParams prm,
          double* __restrict__ vals, int* __restrict__ ints) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  Ctx cx;
  cx.p = prm;
  solve_lane(cx, P, q, A, b, lane, B, vals, ints);
}

}  // namespace

extern "C" {

// Shape this library was built for: {n, m, segments, OUTD}.
int mk_shape(int* out) {
  out[0] = N;
  out[1] = M;
  out[2] = S;
  out[3] = OUTD;
  return 0;
}

// Launch the whole batched solve on `stream`.  Input component k of lane l
// is ptr[k * ld + l * ls].  vals is (OUTD, B) float64, ints (2, B) int32.
// Returns cudaGetLastError() after the launch.
int mk_solve(const double* P, long long P_ld, long long P_ls,
             const double* q, long long q_ld, long long q_ls,
             const double* A, long long A_ld, long long A_ls,
             const double* b, long long b_ld, long long b_ls, long long B,
             MkParams prm, double* vals, int* ints, void* stream) {
  if (B <= 0) return 0;
  const In Pi{P, P_ld, P_ls}, qi{q, q_ld, q_ls}, Ai{A, A_ld, A_ls},
      bi{b, b_ld, b_ls};
  const long long blocks = (B + THREADS - 1) / THREADS;
  mk_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      Pi, qi, Ai, bi, B, prm, vals, ints);
  return (int)cudaGetLastError();
}

}  // extern "C"
