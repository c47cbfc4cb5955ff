// The batched conic IPM as one CUDA kernel, one instance per group of G
// threads (K1a on zero, nonnegative and second-order cone layouts).
//
// Replaces: clarabel_tpu/ipm/megakernel.py `kernel` / `compute` (the Pallas
// megakernel launched by `_pallas_fn`) on zero/nn/SOC layouts.  It
// computes what csrc/megakernel.cu and the plain PyTorch version
// clarabel_tpu_torch/ipm/megakernel_ref.py compute, formula for formula:
// Ruiz equilibration (scalings in float32, applied in float64), the
// symmetric initial point, the Mehrotra predictor-corrector loop over the
// condensed normal equations (dense Cholesky plus accept-masked refinement
// against the true augmented operator), the termination machine with the
// gap-aware stall check, and finalization.  Its inputs, outputs, MkParams
// and C interface are megakernel.cu's; ipm/_cuda.py launches it in its
// place on single-phase layouts of zero, nn and SOC segments up to 54
// lanes an SM (`variant_of`; at 62 lanes an SM, 8192 on the H100,
// megakernel.cu measured faster on the LP batch, PERF.md section 5).  The code is written over the
// scalar type R, as megakernel.cu's is; double is its one instance here.
//
// What held megakernel.cu back on this card: one lane per thread keeps a
// working set of about 1,200 words a lane (the scaled problem, the
// scalings, the factor, the refinement vectors) in runtime-indexed arrays,
// which ptxas places in local memory (255 registers and 9,648 bytes of
// stack a thread at the bench shape n=6, m=13).  At 255 registers an SM
// holds 8 warps, and their stacks leave L1 for L2 on every access.
//
// The design: one lane per group of G threads (G = 8 while m <= 8, 16
// while m <= 16, else 32), each owning rows of the lane's data.  Thread
// t of a group owns cone rows t, t+G, ... (RPT of them) and variable
// entries t, t+G, ... (CPT of them): for a cone row, its row of the
// scaled A, b, e, s, z, the scaling, the residual and the directions; for
// a variable, x, q, d, its row of P.  Each array has compile-time extents (MK_N, MK_M, G)
// and is indexed only by compile-time indices after unrolling, so it stays
// in registers.  What the rows share is reduced over the group with
// butterfly shuffles (__shfl_xor_sync of width G): the dot products, the
// A'y products, the 21 entries of A'H^-1 A + P at n = 6, and on a SOC
// segment its sums (one butterfly per SOC segment).  A butterfly gives
// every thread of the group the same bits (each step adds the same two
// operands; max and min take the lower thread's operand first), so the
// group's control flow (termination, step lengths, refinement stops) is
// uniform without a broadcast.  The n x n Cholesky factor and its solves
// run replicated in every thread, unrolled over n.  Sums taken over the
// group add in another order than megakernel.cu's loops, so the two
// kernels are not bit-equal (DEVIATIONS.md #15); the setup (Ruiz and the
// initial point's shift) reduces with max, or gathers the row values and
// sums them in megakernel.cu's order, and matches it.
//
// What bounds it: FP64 operations, as megakernel.cu (a lane reads about
// 0.9 KB and writes 0.37 KB at the bench shape; an IPM iteration is on the
// order of 10^4 FP64 operations).  The group adds shuffles: a butterfly of
// K doubles costs 2 K log2(G) shuffles a thread.  In blocks of 256 threads
// with at most 128 registers (2 blocks an SM), an SM holds 16 warps: at
// the bench shape (G = 16) 128 lanes at once, with 1,104 bytes of stack a
// thread left by ptxas (spilled temporaries of the refinement; PERF.md).
//
// Build (route (b): a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DMK_N=6 -DMK_M=13 -DMK_S=2 -DMK_NONSYM=0 \
//        -DMK_PSD=0 -DMK_GENPOW=0 -DMK_TWO_PHASE=0 -o mk.so megakernel_group.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(MK_N) || !defined(MK_M) || !defined(MK_S)
#error "build with -DMK_N=<n> -DMK_M=<m> -DMK_S=<number of cone segments>"
#endif
#ifndef MK_NONSYM
#define MK_NONSYM 0
#endif
#ifndef MK_PSD
#define MK_PSD 0
#endif
#ifndef MK_GENPOW
#define MK_GENPOW 0
#endif
#if MK_NONSYM || MK_PSD || MK_GENPOW
#error "megakernel_group.cu takes zero, nonnegative and second-order cones"
#endif
#ifndef MK_TWO_PHASE
#define MK_TWO_PHASE 0
#endif
#if MK_TWO_PHASE
#error "the float32 first phase (K1e) is built from megakernel.cu"
#endif
// chip_smoke.py's wrong group kernel: every butterfly sum drops its last
// step and takes thread 0's partial sum (a sum over half the group's rows)
#ifndef MK_WRONG_BUTTERFLY
#define MK_WRONG_BUTTERFLY 0
#endif

namespace {

constexpr int N = MK_N;
constexpr int M = MK_M;
constexpr int S = MK_S;
constexpr int NT = N * (N + 1) / 2;
constexpr int OUTD = N + 2 * M + 13;
constexpr int G = M <= 8 ? 8 : M <= 16 ? 16 : 32;
static_assert(G == 8 || G == 16 || G == 32, "a group is 8, 16 or 32 threads");
constexpr int RPT = (M + G - 1) / G;   // cone rows a thread owns
constexpr int CPT = (N + G - 1) / G;   // variable entries a thread owns
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;          // 2 blocks of 256: <= 128 registers
constexpr int LANES_PER_BLOCK = THREADS / G;
constexpr double BIG = 1e30;
constexpr double TINY32 = 1.1754943508222875e-38;   // float32 tiny
constexpr double EPS64 = 2.220446049250313e-16;

enum Status {
  UNSOLVED = 0, SOLVED = 1, PINF = 2, DINF = 3, ALMOST_SOLVED = 4,
  ALMOST_PINF = 5, ALMOST_DINF = 6, MAX_ITERATIONS = 7,
  NUMERICAL_ERROR = 9, INSUFFICIENT_PROGRESS = 10
};
enum SegKind { SEG_ZERO = 0, SEG_NN = 1, SEG_SOC = 2, NO_ROW = -1 };

}  // namespace

extern "C" {
// megakernel.cu's MkParams for single-phase layouts without exp, pow,
// genpow or PSD segments, field for field (ipm/_cuda.py mirrors it and
// checks its size).
struct MkParams {
  double eq_min_scaling, eq_max_scaling;
  double static_reg_constant, static_reg_proportional;
  double refine_abstol, refine_reltol, refine_stop_ratio;
  double max_step_fraction, min_terminate_step_length, stall_ratio;
  double tol[6];
  double rtol[6];
  double seg_alpha[S];
  double min_switch_step_length, linesearch_backtrack_step;
  int seg_kind[S], seg_lo[S], seg_hi[S];
  int degree, p_nonzero, max_iter, eq_enable, eq_max_iter, refine_passes;
  int linesearch_max_iter;
};
}

namespace {

template <typename T> __device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double mabs(double x) { return fabs(x); }
__device__ __forceinline__ float mabs(float x) { return fabsf(x); }

// the loop's settings, read in place from the kernel's parameter
template <typename R> struct Cfg {
  const MkParams* p;
  R refine_abstol, refine_reltol;
  int refine_passes;
};

struct In {
  const double* p;
  long long ld;   // component stride
  long long ls;   // lane stride: 1, or 0 for a batch-constant component
};

__device__ __forceinline__ double at(const In& a, int k, long long lane) {
  return a.p[k * a.ld + lane * a.ls];
}

// ---- the group: its threads in the warp, this thread's place in it, and
// the rows this thread owns ----
struct Grp {
  unsigned mask;
  int t;
  int kind[RPT];    // SegKind of each owned cone row (NO_ROW past m)
  int seg[RPT];     // its segment
  bool head[RPT];   // the first row of a SOC segment
};

__device__ __forceinline__ int row_of(const Grp& g, int r) { return g.t + r * G; }
__device__ __forceinline__ int col_of(const Grp& g, int c) { return g.t + c * G; }

// butterfly sums: every thread of the group ends with the same bits
template <int K, typename T>
__device__ __forceinline__ void gsum(const Grp& g, T (&v)[K]) {
#pragma unroll
  for (int off = G / 2; off > (MK_WRONG_BUTTERFLY ? 1 : 0); off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = v[k] + __shfl_xor_sync(g.mask, v[k], off, G);
  }
#if MK_WRONG_BUTTERFLY
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __shfl_sync(g.mask, v[k], 0, G);
#endif
}
template <typename T> __device__ __forceinline__ T gsum1(const Grp& g, T x) {
  T v[1] = {x};
  gsum<1>(g, v);
  return v[0];
}
// max and min with NaN propagating; the lower thread's operand first, so
// that both threads of a pair take the same of +0 and -0
template <int K, typename T>
__device__ __forceinline__ void gmax(const Grp& g, T (&v)[K]) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T o = __shfl_xor_sync(g.mask, v[k], off, G);
      v[k] = (g.t & off) ? nmax(o, v[k]) : nmax(v[k], o);
    }
  }
}
template <typename T> __device__ __forceinline__ T gmax1(const Grp& g, T x) {
  T v[1] = {x};
  gmax<1>(g, v);
  return v[0];
}
template <typename T> __device__ __forceinline__ T gmin1(const Grp& g, T x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const T o = __shfl_xor_sync(g.mask, x, off, G);
    x = (g.t & off) ? nmin(o, x) : nmin(x, o);
  }
  return x;
}
__device__ __forceinline__ bool gall(const Grp& g, bool b) {
  return __all_sync(g.mask, b) != 0;
}

// K per-row values summed over each SOC segment: out[k][r] holds the sum
// over row r's segment (rows of other kinds keep what they had)
template <int K, typename T>
__device__ __forceinline__ void seg_sum(const Grp& g, const MkParams& p,
                                        const T (&v)[K][RPT],
                                        T (&out)[K][RPT]) {
#pragma unroll
  for (int sg = 0; sg < S; ++sg) {
    if (p.seg_kind[sg] != SEG_SOC) continue;
    T acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = T(0);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        if (g.seg[r] == sg) acc[k] = acc[k] + v[k][r];
    }
    gsum<K>(g, acc);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if (g.seg[r] == sg) {
#pragma unroll
        for (int k = 0; k < K; ++k) out[k][r] = acc[k];
      }
  }
}

// the whole n-vector in every thread, from the owned entries
template <typename T>
__device__ __forceinline__ void gather_n(const Grp& g, const T (&v)[CPT],
                                         T (&full)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) full[j] = __shfl_sync(g.mask, v[j / G], j % G, G);
}
// the owned entries of a vector every thread holds whole
template <typename T>
__device__ __forceinline__ void pick_n(const Grp& g, const T (&full)[N],
                                       T (&own)[CPT]) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    T v = T(0);
#pragma unroll
    for (int j = c * G; j < N && j < (c + 1) * G; ++j)
      if (j == col_of(g, c)) v = full[j];
    own[c] = v;
  }
}
template <typename T>
__device__ __forceinline__ void gather_m(const Grp& g, const T (&v)[RPT],
                                         T (&full)[M]) {
#pragma unroll
  for (int k = 0; k < M; ++k) full[k] = __shfl_sync(g.mask, v[k / G], k % G, G);
}

// ---- the scaled problem of the lane: the owned rows ----
template <typename R> struct Prob {
  R A[RPT][N], b[RPT], e[RPT], einv[RPT];
  R P[CPT][N], q[CPT], d[CPT], dinv[CPT];
  R cinv, normq, normb, pdiag;
};

// Scaling state of the owned rows.  nn rows: w^2 in w, 1/w^2 in sa; soc
// rows: w, eta in sa, and the segment's head w0 and lam0.
template <typename R> struct Scale {
  R w[RPT], lam[RPT], sa[RPT], w0[RPT], lam0[RPT];
  bool ident;
};

template <typename R> struct Kkt {
  R L[NT], Linv[N], eps;   // L[i (i + 1) / 2 + j], j <= i
};

__device__ __forceinline__ constexpr int li(int i, int j) { return i * (i + 1) / 2 + j; }

// y = A x_full on the owned rows (megakernel.cu's order over j)
template <typename R>
__device__ __forceinline__ void Ax(const Prob<R>& pr, const R (&x)[N],
                                   R (&out)[RPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    R acc = R(0);
#pragma unroll
    for (int j = 0; j < N; ++j) acc += pr.A[r][j] * x[j];
    out[r] = acc;
  }
}

// the owned rows' terms of A'y, to be summed over the group
template <typename R>
__device__ __forceinline__ void Aty_part(const Prob<R>& pr, const R (&y)[RPT],
                                         R (&out)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    R acc = R(0);
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc += pr.A[r][j] * y[r];
    out[j] = acc;
  }
}

// (P x_full) on the owned entries
template <typename R>
__device__ __forceinline__ void Pxv(const MkParams& p, const Prob<R>& pr,
                                    const R (&x)[N], R (&out)[CPT]) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    R acc = R(0);
    if (p.p_nonzero) {
#pragma unroll
      for (int j = 0; j < N; ++j) acc += pr.P[c][j] * x[j];
    }
    out[c] = acc;
  }
}

// ---- cone scaling (reference make_scaling, l.1355-1510) ----
template <typename R>
__device__ __forceinline__ bool make_scaling(const Grp& g, const MkParams& p,
                                             const R (&s)[RPT],
                                             const R (&z)[RPT], Scale<R>& sc) {
  sc.ident = false;
  bool ok = true;
  // per SOC segment: |z1|^2, |s1|^2 and the heads z0, s0
  R v[4][RPT], sums[4][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool tl = g.kind[r] == SEG_SOC && !g.head[r];
    const bool hd = g.kind[r] == SEG_SOC && g.head[r];
    v[0][r] = tl ? z[r] * z[r] : R(0);
    v[1][r] = tl ? s[r] * s[r] : R(0);
    v[2][r] = hd ? z[r] : R(0);
    v[3][r] = hd ? s[r] : R(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) sums[k][r] = R(0);
  }
  seg_sum<4>(g, p, v, sums);
  R zsinv[RPT], ssinv[RPT], zsv[RPT], ssv[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    zsinv[r] = ssinv[r] = zsv[r] = ssv[r] = R(1);
    if (g.kind[r] == SEG_NN) {
      R prod = s[r] * z[r];
      ok = ok && (prod > 0);
      prod = nmax(prod, R(0));
      const R zsafe = z[r] != 0 ? z[r] : R(1);
      const R ratio = z[r] != 0 ? s[r] / zsafe : R(0);
      const R w = msqrt(nmax(ratio, R(0)));
      const R w2 = w * w;
      sc.w[r] = w2;
      sc.sa[r] = R(1) / w2;
      sc.lam[r] = msqrt(prod);
      sc.w0[r] = sc.lam0[r] = R(0);
    } else if (g.kind[r] == SEG_SOC) {
      const R z1n = msqrt(sums[0][r]), s1n = msqrt(sums[1][r]);
      const R z0 = sums[2][r], s0 = sums[3][r];
      const R zres = (z0 - z1n) * (z0 + z1n), sres = (s0 - s1n) * (s0 + s1n);
      const R zscale = zres > 0 ? msqrt(nmax(zres, R(0))) : R(0);
      const R sscale = sres > 0 ? msqrt(nmax(sres, R(0))) : R(0);
      ok = ok && (zscale > 0) && (sscale > 0);
      zsv[r] = zscale > 0 ? zscale : R(1);
      ssv[r] = sscale > 0 ? sscale : R(1);
      zsinv[r] = R(1) / zsv[r];
      ssinv[r] = R(1) / ssv[r];
      sc.sa[r] = msqrt(ssv[r] * zsinv[r]);
      sc.w[r] = g.head[r] ? s[r] * ssinv[r] + z[r] * zsinv[r]
                          : s[r] * ssinv[r] - z[r] * zsinv[r];
    } else {
      sc.w[r] = sc.sa[r] = sc.lam[r] = sc.w0[r] = sc.lam0[r] = R(0);
    }
  }
  // wscale from |w1|^2 and w0
  R v2[2][RPT], sums2[2][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool tl = g.kind[r] == SEG_SOC && !g.head[r];
    const bool hd = g.kind[r] == SEG_SOC && g.head[r];
    v2[0][r] = tl ? sc.w[r] * sc.w[r] : R(0);
    v2[1][r] = hd ? sc.w[r] : R(0);
    sums2[0][r] = sums2[1][r] = R(0);
  }
  seg_sum<2>(g, p, v2, sums2);
  R wsv[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    wsv[r] = R(1);
    if (g.kind[r] != SEG_SOC) continue;
    const R w1n = msqrt(sums2[0][r]);
    const R w0 = sums2[1][r];
    const R wres = (w0 - w1n) * (w0 + w1n);
    const R wscale = wres > 0 ? msqrt(nmax(wres, R(0))) : R(0);
    ok = ok && (wscale > 0);
    wsv[r] = wscale > 0 ? wscale : R(1);
    sc.w[r] = sc.w[r] * (R(1) / wsv[r]);
  }
  // w0 = sqrt(|w1|^2 + 1) after the normalization, then lam
  R v3[1][RPT], sums3[1][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    v3[0][r] = (g.kind[r] == SEG_SOC && !g.head[r]) ? sc.w[r] * sc.w[r] : R(0);
    sums3[0][r] = R(0);
  }
  seg_sum<1>(g, p, v3, sums3);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] != SEG_SOC) continue;
    const R w0 = msqrt(sums3[0][r] + R(1));
    if (g.head[r]) sc.w[r] = w0;
    sc.w0[r] = w0;
    const R z0 = sums[2][r], s0 = sums[3][r];
    const R gamma = wsv[r] * R(0.5);
    const R den = R(1) / (s0 * ssinv[r] + z0 * zsinv[r] + gamma * R(2));
    const R cs = (gamma + z0 * zsinv[r]) * ssinv[r];
    const R cz = (gamma + s0 * ssinv[r]) * zsinv[r];
    const R lscale = msqrt(ssv[r] * zsv[r]);
    sc.lam0[r] = gamma * lscale;
    sc.lam[r] = g.head[r] ? sc.lam0[r]
                          : ((cs * s[r] + cz * z[r]) * den) * lscale;
  }
  return gall(g, ok);
}

// static regularization at this scaling (reference hs_diag_hi + eps_of);
// ident: the unit diagonal of the initial point
template <typename R>
__device__ __forceinline__ R eps_of(const Grp& g, const MkParams& p,
                                    const Prob<R>& pr, const Scale<R>& sc) {
  R mx = R(0);
  if (sc.ident) {
    mx = R(1);   // every layout here has a nonempty segment
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (g.kind[r] == SEG_NN) {
        mx = nmax(mx, mabs(sc.w[r]));
      } else if (g.kind[r] == SEG_SOC) {
        const R eta = sc.sa[r];
        const R w2 = R(2) * sc.w[r] * sc.w[r];
        const R dg = (g.head[r] ? w2 - R(1) : w2 + R(1)) * (eta * eta);
        mx = nmax(mx, mabs(dg));
      }
    }
    mx = gmax1(g, mx);
  }
  const R maxdiag = nmax(pr.pdiag, mx);
  return R(p.static_reg_constant) + R(p.static_reg_proportional) * maxdiag;
}

// Hs^{-1} v with 1/eps on zero-cone rows (reference hinv_apply)
template <typename R>
__device__ __forceinline__ void hinv_apply(const Grp& g, const MkParams& p,
                                           const Scale<R>& sc, R eps,
                                           const R (&v)[RPT], R (&out)[RPT]) {
  R cv[1][RPT], cc[1][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    cv[0][r] = g.kind[r] == SEG_SOC
                   ? (g.head[r] ? sc.w[r] * v[r] : (-sc.w[r]) * v[r])
                   : R(0);
    cc[0][r] = R(0);
  }
  if (!sc.ident) seg_sum<1>(g, p, cv, cc);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] == SEG_ZERO) {
      out[r] = v[r] * (R(1) / eps);
    } else if (g.kind[r] == NO_ROW) {
      out[r] = R(0);
    } else if (sc.ident) {
      out[r] = v[r];
    } else if (g.kind[r] == SEG_NN) {
      out[r] = v[r] * sc.sa[r];
    } else {
      const R c = cc[0][r] * R(2);
      const R e2 = R(1) / (sc.sa[r] * sc.sa[r]);
      out[r] = g.head[r] ? (-v[r] + c * sc.w[r]) * e2
                         : (v[r] + c * (-sc.w[r])) * e2;
    }
  }
}

// Hs v; the zero-cone block of the true operator is 0 (reference hs_apply)
template <typename R>
__device__ __forceinline__ void hs_apply(const Grp& g, const MkParams& p,
                                         const Scale<R>& sc,
                                         const R (&v)[RPT], R (&out)[RPT]) {
  R cv[1][RPT], cc[1][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    cv[0][r] = g.kind[r] == SEG_SOC ? sc.w[r] * v[r] : R(0);
    cc[0][r] = R(0);
  }
  if (!sc.ident) seg_sum<1>(g, p, cv, cc);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] == SEG_ZERO || g.kind[r] == NO_ROW) {
      out[r] = R(0);
    } else if (sc.ident) {
      out[r] = v[r];
    } else if (g.kind[r] == SEG_NN) {
      out[r] = v[r] * sc.w[r];
    } else {
      const R c = cc[0][r] * R(2);
      const R e2 = sc.sa[r] * sc.sa[r];
      out[r] = g.head[r] ? (-v[r] + c * sc.w[r]) * e2
                         : (v[r] + c * sc.w[r]) * e2;
    }
  }
}

// ---- condensed KKT: S = A' Hinv A + P + eps I, Cholesky ----
template <typename R>
__device__ __forceinline__ bool build_kkt(const Grp& g, const MkParams& p,
                                          const Prob<R>& pr,
                                          const Scale<R>& sc, R eps,
                                          Kkt<R>& kk) {
  kk.eps = eps;
  // H^{-1} applied to every column of A, row by row; a SOC segment's
  // columns need their segment sums cc_j
  R cv[N][RPT], cc[N][RPT];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const R a = pr.A[r][j];
      cv[j][r] = g.kind[r] == SEG_SOC
                     ? (g.head[r] ? sc.w[r] * a : (-sc.w[r]) * a)
                     : R(0);
      cc[j][r] = R(0);
    }
  if (!sc.ident) seg_sum<N>(g, p, cv, cc);
  R part[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) part[k] = R(0);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    R h[N];
    const R rinv = R(1) / eps;
    const R e2 = g.kind[r] == SEG_SOC ? R(1) / (sc.sa[r] * sc.sa[r]) : R(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const R a = pr.A[r][j];
      if (g.kind[r] == SEG_ZERO) h[j] = a * rinv;
      else if (g.kind[r] == NO_ROW) h[j] = R(0);
      else if (sc.ident) h[j] = a;
      else if (g.kind[r] == SEG_NN) h[j] = a * sc.sa[r];
      else {
        const R c = cc[j][r] * R(2);
        h[j] = g.head[r] ? (-a + c * sc.w[r]) * e2 : (a + c * (-sc.w[r])) * e2;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int i = j; i < N; ++i) part[li(i, j)] += pr.A[r][i] * h[j];
  }
  if (p.p_nonzero) {
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int i = c * G; i < N && i < (c + 1) * G; ++i)
        if (i == col_of(g, c)) {
#pragma unroll
          for (int j = 0; j <= i; ++j) part[li(i, j)] += pr.P[c][j];
        }
  }
  gsum<NT>(g, part);
#pragma unroll
  for (int k = 0; k < NT; ++k) kk.L[k] = part[k];
#pragma unroll
  for (int j = 0; j < N; ++j) kk.L[li(j, j)] += eps;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    R ssq = R(0);
#pragma unroll
    for (int k = 0; k < j; ++k) ssq += kk.L[li(j, k)] * kk.L[li(j, k)];
    const R acc = kk.L[li(j, j)] - ssq;
    ok = ok && (acc > 0);
    R Ljj = msqrt(nmax(acc, R(0)));
    Ljj = Ljj > 0 ? Ljj : R(1);
    kk.L[li(j, j)] = Ljj;
    kk.Linv[j] = R(1) / Ljj;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      R sp = R(0);
#pragma unroll
      for (int k = 0; k < j; ++k) sp += kk.L[li(i, k)] * kk.L[li(j, k)];
      kk.L[li(i, j)] = (kk.L[li(i, j)] - sp) * kk.Linv[j];
    }
  }
  return ok;
}

template <typename R>
__device__ __forceinline__ void chol_solve(const Kkt<R>& kk, const R (&w)[N],
                                           R (&x)[N]) {
  R y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    R sp = R(0);
#pragma unroll
    for (int k = 0; k < j; ++k) sp += kk.L[li(j, k)] * y[k];
    y[j] = (w[j] - sp) * kk.Linv[j];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    R sp = R(0);
#pragma unroll
    for (int k = i + 1; k < N; ++k) sp += kk.L[li(k, i)] * x[k];
    x[i] = (y[i] - sp) * kk.Linv[i];
  }
}

template <typename R> struct Lane {
  const Grp& g;
  const MkParams& p;
  const Prob<R>& pr;
};

// one application of the condensed inverse to (bx, bz)
template <typename R>
__device__ __forceinline__ void apply_once(const Lane<R>& L, const Scale<R>& sc,
                                           const Kkt<R>& kk,
                                           const R (&bx)[CPT],
                                           const R (&bz)[RPT], R (&xs)[CPT],
                                           R (&zs)[RPT]) {
  R hb[RPT], w[N], bxf[N], xf[N], t[RPT];
  hinv_apply(L.g, L.p, sc, kk.eps, bz, hb);
  Aty_part(L.pr, hb, w);
  gsum<N>(L.g, w);
  gather_n(L.g, bx, bxf);
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = bxf[j] + w[j];
  chol_solve(kk, w, xf);
  pick_n(L.g, xf, xs);
  Ax(L.pr, xf, t);
#pragma unroll
  for (int r = 0; r < RPT; ++r) t[r] = t[r] - bz[r];
  hinv_apply(L.g, L.p, sc, kk.eps, t, zs);
}

// (bx, bz) - K (xs, zs) of the true augmented operator
template <typename R>
__device__ __forceinline__ void kkt_resid(const Lane<R>& L, const Scale<R>& sc,
                                          const R (&bx)[CPT],
                                          const R (&bz)[RPT],
                                          const R (&xs)[CPT],
                                          const R (&zs)[RPT], R (&ex)[CPT],
                                          R (&ez)[RPT]) {
  R tf[N], xf[N], to[CPT], u[CPT], v[RPT], h[RPT];
  Aty_part(L.pr, zs, tf);
  gsum<N>(L.g, tf);
  pick_n(L.g, tf, to);
  gather_n(L.g, xs, xf);
  Pxv(L.p, L.pr, xf, u);
#pragma unroll
  for (int c = 0; c < CPT; ++c) ex[c] = bx[c] - (to[c] + u[c]);
  Ax(L.pr, xf, v);
  hs_apply(L.g, L.p, sc, zs, h);
#pragma unroll
  for (int r = 0; r < RPT; ++r) ez[r] = bz[r] - (v[r] - h[r]);
}

template <int K, typename R>
__device__ __forceinline__ R pair_max(const Grp& g, const R (&a)[K][CPT],
                                      const R (&b)[K][RPT]) {
  R mx = R(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) mx = nmax(mx, mabs(a[k][c]));
#pragma unroll
    for (int r = 0; r < RPT; ++r) mx = nmax(mx, mabs(b[k][r]));
  }
  return gmax1(g, mx);
}

// Accept-masked refinement against the true operator (reference
// refined_solve, l.1861-1988); joint norms over the K right-hand sides
template <int K, typename R>
__device__ __forceinline__ bool refined_solve(const Lane<R>& L,
                                              const Cfg<R>& cf,
                                              const Scale<R>& sc,
                                              const Kkt<R>& kk,
                                              const R (&bx)[K][CPT],
                                              const R (&bz)[K][RPT],
                                              R (&xs)[K][CPT],
                                              R (&zs)[K][RPT]) {
#pragma unroll
  for (int k = 0; k < K; ++k) apply_once(L, sc, kk, bx[k], bz[k], xs[k], zs[k]);
  const int passes = cf.refine_passes;
  if (passes <= 0) return isfinite(pair_max<K>(L.g, xs, zs));
  const R normb = pair_max<K>(L.g, bx, bz);
  R ex[K][CPT], ez[K][RPT];
#pragma unroll
  for (int k = 0; k < K; ++k) kkt_resid(L, sc, bx[k], bz[k], xs[k], zs[k], ex[k], ez[k]);
  R norme = pair_max<K>(L.g, ex, ez);
  bool ok = isfinite(norme);
  bool done = false;
  const R tol = cf.refine_abstol + cf.refine_reltol * normb;
  for (int pass = 0; pass < passes; ++pass) {
    const bool active = !done && ok && (norme > tol);
    if (!active) break;   // uniform over the group
    R nx[K][CPT], nz[K][RPT], nex[K][CPT], nez[K][RPT];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      R dx[CPT], dz[RPT];
      apply_once(L, sc, kk, ex[k], ez[k], dx, dz);
#pragma unroll
      for (int c = 0; c < CPT; ++c) nx[k][c] = xs[k][c] + dx[c];
#pragma unroll
      for (int r = 0; r < RPT; ++r) nz[k][r] = zs[k][r] + dz[r];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) kkt_resid(L, sc, bx[k], bz[k], nx[k], nz[k], nex[k], nez[k]);
    const R nn = pair_max<K>(L.g, nex, nez);
    const bool okn = isfinite(nn);
    const R ratio = norme / (nn != 0 ? nn : R(TINY32));
    const bool stop = ratio < R(L.p.refine_stop_ratio);
    const bool accept = okn && (!stop || ratio > R(1));
    done = stop || !okn;
    ok = ok && okn;
    if (accept) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) { xs[k][c] = nx[k][c]; ex[k][c] = nex[k][c]; }
#pragma unroll
        for (int r = 0; r < RPT; ++r) { zs[k][r] = nz[k][r]; ez[k][r] = nez[k][r]; }
      }
      norme = nn;
    }
  }
  return ok && isfinite(norme);
}

// ---- step length (reference step_length / soc_step_len) ----
template <typename R>
__device__ __forceinline__ R soc_step(R x0, R y0, R yy, R xy, R xx) {
  const R a0 = (x0 >= 0 && y0 < 0) ? -x0 / (y0 < 0 ? y0 : R(-1)) : R(BIG);
  const R a = y0 * y0 - yy;
  const R b = (x0 * y0 - xy) * R(2);
  const R c = nmax(x0 * x0 - xx, R(0));
  const R d = b * b - a * c * R(4);
  const R sqrt_d = msqrt(nmax(d, R(0)));
  const R t = b >= 0 ? -b - sqrt_d : -b + sqrt_d;
  R r1 = t != 0 ? (R(2) * c) / t : R(BIG);
  R r2 = a != 0 ? t / (R(2) * a) : R(BIG);
  r1 = r1 < 0 ? R(BIG) : r1;
  r2 = r2 < 0 ? R(BIG) : r2;
  const R root = nmin(r1, r2);
  R alpha;
  if ((a > 0 && b > 0) || d < 0) alpha = R(BIG);
  else if (a == 0) alpha = R(BIG);
  else if (c == 0) alpha = a >= 0 ? R(BIG) : R(0);
  else alpha = root;
  return nmin(alpha, a0);
}

template <typename R>
__device__ __forceinline__ R step_length(const Grp& g, const MkParams& p,
                                         const R (&dz)[RPT],
                                         const R (&ds)[RPT],
                                         const R (&z)[RPT], const R (&s)[RPT],
                                         R amax) {
  // per SOC segment, for (z, dz) and (s, ds): the heads and the tail sums
  R v[10][RPT], sm[10][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool tl = g.kind[r] == SEG_SOC && !g.head[r];
    const bool hd = g.kind[r] == SEG_SOC && g.head[r];
    v[0][r] = hd ? z[r] : R(0);
    v[1][r] = hd ? dz[r] : R(0);
    v[2][r] = tl ? dz[r] * dz[r] : R(0);
    v[3][r] = tl ? z[r] * dz[r] : R(0);
    v[4][r] = tl ? z[r] * z[r] : R(0);
    v[5][r] = hd ? s[r] : R(0);
    v[6][r] = hd ? ds[r] : R(0);
    v[7][r] = tl ? ds[r] * ds[r] : R(0);
    v[8][r] = tl ? s[r] * ds[r] : R(0);
    v[9][r] = tl ? s[r] * s[r] : R(0);
#pragma unroll
    for (int k = 0; k < 10; ++k) sm[k][r] = R(0);
  }
  seg_sum<10>(g, p, v, sm);
  R alpha = R(BIG);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] == SEG_NN) {
      const R rz = dz[r] < 0 ? -z[r] / dz[r] : R(BIG);
      const R rs = ds[r] < 0 ? -s[r] / ds[r] : R(BIG);
      alpha = nmin(nmin(alpha, rz), rs);
    } else if (g.kind[r] == SEG_SOC && g.head[r]) {
      alpha = nmin(alpha, soc_step(sm[0][r], sm[1][r], sm[2][r], sm[3][r], sm[4][r]));
      alpha = nmin(alpha, soc_step(sm[5][r], sm[6][r], sm[7][r], sm[8][r], sm[9][r]));
    }
  }
  return nmin(amax, gmin1(g, alpha));
}

// ---- predictor-corrector pieces ----
template <typename R>
__device__ __forceinline__ void affine_ds(const Grp& g, const MkParams& p,
                                          const Scale<R>& sc, const R (&s)[RPT],
                                          R (&out)[RPT]) {
  R v[1][RPT], sm[1][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    v[0][r] = g.kind[r] == SEG_SOC ? sc.lam[r] * sc.lam[r] : R(0);
    sm[0][r] = R(0);
  }
  seg_sum<1>(g, p, v, sm);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] == SEG_NN) out[r] = sc.lam[r] * sc.lam[r];
    else if (g.kind[r] == SEG_SOC)
      out[r] = g.head[r] ? sm[0][r] : sc.lam0[r] * sc.lam[r] * R(2);
    else out[r] = R(0);
  }
}

// W dz - ... : sigma_mu shift of the combined step (reference
// combined_ds_shift): nn dz ds - sigma mu; soc (W^-1 ds) o (W dz) - sigma mu e
template <typename R>
__device__ __forceinline__ void combined_ds_shift(const Grp& g,
                                                  const MkParams& p,
                                                  const Scale<R>& sc,
                                                  const R (&dz)[RPT],
                                                  const R (&ds)[RPT],
                                                  R sigma_mu, R (&out)[RPT]) {
  R v[4][RPT], sm[4][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool tl = g.kind[r] == SEG_SOC && !g.head[r];
    const bool hd = g.kind[r] == SEG_SOC && g.head[r];
    v[0][r] = hd ? dz[r] : R(0);
    v[1][r] = hd ? ds[r] : R(0);
    v[2][r] = tl ? sc.w[r] * dz[r] : R(0);
    v[3][r] = tl ? sc.w[r] * ds[r] : R(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) sm[k][r] = R(0);
  }
  seg_sum<4>(g, p, v, sm);
  R wdz[RPT], wids[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    wdz[r] = wids[r] = R(0);
    if (g.kind[r] != SEG_SOC) continue;
    const R eta = sc.sa[r], etainv = R(1) / eta;
    const R w0 = sc.w0[r];
    const R denom = R(1) / (w0 + R(1));
    const R X0 = sm[0][r], Y0 = sm[1][r];
    const R cz = X0 + sm[2][r] * denom;          // W dz
    const R cs = -Y0 + sm[3][r] * denom;         // W^-1 ds
    if (g.head[r]) {
      wdz[r] = (w0 * X0 + sm[2][r]) * eta;
      wids[r] = (w0 * Y0 - sm[3][r]) * etainv;
    } else {
      wdz[r] = (dz[r] + cz * sc.w[r]) * eta;
      wids[r] = (ds[r] + cs * sc.w[r]) * etainv;
    }
  }
  R v2[3][RPT], sm2[3][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool hd = g.kind[r] == SEG_SOC && g.head[r];
    v2[0][r] = g.kind[r] == SEG_SOC ? wids[r] * wdz[r] : R(0);
    v2[1][r] = hd ? wids[r] : R(0);
    v2[2][r] = hd ? wdz[r] : R(0);
#pragma unroll
    for (int k = 0; k < 3; ++k) sm2[k][r] = R(0);
  }
  seg_sum<3>(g, p, v2, sm2);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] == SEG_NN) out[r] = dz[r] * ds[r] - sigma_mu;
    else if (g.kind[r] == SEG_SOC)
      out[r] = g.head[r] ? sm2[0][r] - sigma_mu
                         : sm2[1][r] * wdz[r] + sm2[2][r] * wids[r];
    else out[r] = R(0);
  }
}

template <typename R>
__device__ __forceinline__ void ds_from_dz_offset(const Grp& g,
                                                  const MkParams& p,
                                                  const Scale<R>& sc,
                                                  const R (&dsv)[RPT],
                                                  const R (&z)[RPT],
                                                  R (&out)[RPT]) {
  R v[5][RPT], sm[5][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool tl = g.kind[r] == SEG_SOC && !g.head[r];
    const bool hd = g.kind[r] == SEG_SOC && g.head[r];
    v[0][r] = tl ? z[r] * z[r] : R(0);
    v[1][r] = tl ? sc.lam[r] * dsv[r] : R(0);
    v[2][r] = tl ? sc.w[r] * dsv[r] : R(0);
    v[3][r] = hd ? z[r] : R(0);
    v[4][r] = hd ? dsv[r] : R(0);
#pragma unroll
    for (int k = 0; k < 5; ++k) sm[k][r] = R(0);
  }
  seg_sum<5>(g, p, v, sm);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] == SEG_NN) {
      out[r] = dsv[r] / z[r];
    } else if (g.kind[r] == SEG_SOC) {
      const R eta = sc.sa[r];
      const R z0 = sm[3][r], ds0 = sm[4][r];
      const R z1n = msqrt(sm[0][r]);
      const R resz = (z0 - z1n) * (z0 + z1n);
      const R lam1ds1 = sm[1][r], w1ds1 = sm[2][r];
      const R c = (sc.lam0[r] * ds0 - lam1ds1) * (R(1) / resz);
      const R lam0inv = R(1) / sc.lam0[r];
      if (g.head[r]) {
        const R o0 = z0 * c + eta * w1ds1;
        out[r] = o0 * lam0inv;
      } else {
        const R wc = w1ds1 * (R(1) / (sc.w0[r] + R(1)));
        out[r] = (-z[r] * c + (dsv[r] + wc * sc.w[r]) * eta) * lam0inv;
      }
    } else {
      out[r] = R(0);
    }
  }
}

// ---- residuals, info, convergence (reference l.2702-2835) ----
template <typename R> struct Res {
  R rx[CPT], rz[RPT], rx_inf[CPT], rz_inf[RPT], Px[CPT];
  R rtau, qx, bz, sz, xPx;
};

template <typename R> struct Info {
  R cost_primal, cost_dual, res_primal, res_dual, res_primal_inf,
      res_dual_inf, gap_abs, gap_rel, ktratio;
};

template <typename R>
__device__ __forceinline__ void residuals(const Lane<R>& L, const R (&x)[CPT],
                                          const R (&z)[RPT],
                                          const R (&s)[RPT], R tau, R kappa,
                                          R tinv, Res<R>& r) {
  R xf[N];
  gather_n(L.g, x, xf);
  Pxv(L.p, L.pr, xf, r.Px);
  R v[N + 4], aty[N];
  Aty_part(L.pr, z, aty);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = aty[j];
  R sz = R(0), qx = R(0), bz = R(0), xPx = R(0);
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    sz += s[k] * z[k];
    bz += L.pr.b[k] * z[k];
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    qx += L.pr.q[c] * x[c];
    xPx += x[c] * r.Px[c];
  }
  v[N] = sz;
  v[N + 1] = qx;
  v[N + 2] = bz;
  v[N + 3] = xPx;
  gsum<N + 4>(L.g, v);
  r.sz = v[N];
  r.qx = v[N + 1];
  r.bz = v[N + 2];
  r.xPx = v[N + 3];
#pragma unroll
  for (int j = 0; j < N; ++j) aty[j] = v[j];
  pick_n(L.g, aty, r.rx_inf);
#pragma unroll
  for (int c = 0; c < CPT; ++c) r.rx_inf[c] = -r.rx_inf[c];
  Ax(L.pr, xf, r.rz_inf);
#pragma unroll
  for (int k = 0; k < RPT; ++k) r.rz_inf[k] = s[k] + r.rz_inf[k];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    r.rx[c] = r.rx_inf[c] - r.Px[c] - L.pr.q[c] * tau;
#pragma unroll
  for (int k = 0; k < RPT; ++k) r.rz[k] = r.rz_inf[k] - L.pr.b[k] * tau;
  r.rtau = r.qx + r.bz + kappa + r.xPx * tinv;
}

template <typename R>
__device__ __forceinline__ void compute_info(const Lane<R>& L, const Res<R>& r,
                                             const R (&x)[CPT],
                                             const R (&z)[RPT],
                                             const R (&s)[RPT], R kappa,
                                             R tinv, Info<R>& in) {
  const Prob<R>& pr = L.pr;
  // sums of squares: |d x|, |e z|, |einv s|, |dinv rx_inf|, |dinv Px|,
  // |einv rz_inf|, |einv rz|, |dinv rx|
  R v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = R(0);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    R t = pr.d[c] * x[c];
    v[0] += t * t;
    t = pr.dinv[c] * r.rx_inf[c];
    v[3] += t * t;
    t = pr.dinv[c] * r.Px[c];
    v[4] += t * t;
    t = pr.dinv[c] * r.rx[c];
    v[7] += t * t;
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    R t = pr.e[k] * z[k];
    v[1] += t * t;
    t = pr.einv[k] * s[k];
    v[2] += t * t;
    t = pr.einv[k] * r.rz_inf[k];
    v[5] += t * t;
    t = pr.einv[k] * r.rz[k];
    v[6] += t * t;
  }
  gsum<8>(L.g, v);
  const R xPx_half = r.xPx * tinv * tinv * R(0.5);
  in.cost_primal = (r.qx * tinv + xPx_half) * pr.cinv;
  in.cost_dual = (-r.bz * tinv - xPx_half) * pr.cinv;
  R normx = msqrt(v[0]);
  R normz = msqrt(v[1]) * pr.cinv;
  R norms = msqrt(v[2]);
  in.res_primal_inf = msqrt(v[3]) * pr.cinv / nmax(R(1), normz);
  in.res_dual_inf = nmax(msqrt(v[4]) / nmax(R(1), normx),
                         msqrt(v[5]) / nmax(R(1), normx + norms));
  normx = normx * tinv;
  normz = normz * tinv;
  norms = norms * tinv;
  in.res_primal = msqrt(v[6]) * tinv / nmax(R(1), pr.normb + normx + norms);
  in.res_dual = msqrt(v[7]) * tinv * pr.cinv /
                nmax(R(1), pr.normq + normx + normz);
  in.gap_abs = mabs(in.cost_primal - in.cost_dual);
  in.gap_rel = in.gap_abs /
               nmax(R(1), nmin(mabs(in.cost_primal), mabs(in.cost_dual)));
  in.ktratio = kappa * tinv;
}

__device__ __forceinline__ int check_convergence(const Info<double>& in,
                                                 double bz, double qx,
                                                 const double* tol, int s_st,
                                                 int p_st, int d_st) {
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

template <typename R> struct Step {
  R dx[CPT], dz[RPT], ds[RPT];
  R dtau, dkappa, alpha, sigma;
  bool kkt_fail;
};

// tau recovery (reference pc_step.tau_recovery, src/kktsystem.jl:135-215)
template <typename R>
__device__ __forceinline__ void tau_recovery(
    const Lane<R>& L, const Scale<R>& sc, const R (&x1)[CPT],
    const R (&z1)[RPT], const R (&x2)[CPT], const R (&z2)[RPT],
    const R (&xi)[CPT], const R (&ds_const)[RPT], R rhs_tau, R rhs_kappa,
    R kappa, R tinv, R tau_den, R (&dx)[CPT], R (&dz)[RPT], R (&dsv)[RPT],
    R& dtau, R& dkappa) {
  R v[3] = {R(0), R(0), R(0)};
#pragma unroll
  for (int c = 0; c < CPT; ++c) v[0] += L.pr.q[c] * x1[c];
#pragma unroll
  for (int k = 0; k < RPT; ++k) v[1] += L.pr.b[k] * z1[k];
  if (L.p.p_nonzero) {
    R xf[N], px1[CPT];
    gather_n(L.g, x1, xf);
    Pxv(L.p, L.pr, xf, px1);
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[2] += xi[c] * px1[c];
  }
  gsum<3>(L.g, v);
  R tau_num = rhs_tau - rhs_kappa * tinv + v[0] + v[1];
  if (L.p.p_nonzero) tau_num = tau_num + v[2] * R(2);
  dtau = tau_num / tau_den;
#pragma unroll
  for (int c = 0; c < CPT; ++c) dx[c] = x1[c] + x2[c] * dtau;
#pragma unroll
  for (int k = 0; k < RPT; ++k) dz[k] = z1[k] + z2[k] * dtau;
  R h[RPT];
  hs_apply(L.g, L.p, sc, dz, h);
#pragma unroll
  for (int k = 0; k < RPT; ++k) dsv[k] = -(h[k] + ds_const[k]);
  dkappa = -(rhs_kappa + kappa * dtau) * tinv;
}

template <typename R>
__device__ __forceinline__ R max_step(R tau, R kappa, R dtau, R dkappa) {
  const R a_tau = dtau < 0 ? -tau / dtau : R(BIG);
  const R a_kap = dkappa < 0 ? -kappa / dkappa : R(BIG);
  return nmin(nmin(a_tau, a_kap), R(1));
}

// One Mehrotra predictor-corrector step (reference pc_step, l.2839-2977)
template <typename R>
__device__ __forceinline__ void pc_step(const Lane<R>& L, const Cfg<R>& cf,
                                        const R (&x)[CPT], const R (&z)[RPT],
                                        const R (&s)[RPT], R tau, R kappa,
                                        R tinv, const Res<R>& res, R mu,
                                        int iters1, Step<R>& st) {
  Scale<R> sc;
  Kkt<R> kk;
  const bool ok_scale = make_scaling(L.g, L.p, s, z, sc);
  const R eps = eps_of(L.g, L.p, L.pr, sc);
  const bool ok_chol = build_kkt(L.g, L.p, L.pr, sc, eps, kk);
  bool ok_kkt = ok_scale && ok_chol;

  R aff[RPT], bx[2][CPT], bz[2][RPT], xs[2][CPT], zs[2][RPT];
  affine_ds(L.g, L.p, sc, s, aff);
#pragma unroll
  for (int c = 0; c < CPT; ++c) { bx[0][c] = -L.pr.q[c]; bx[1][c] = res.rx[c]; }
#pragma unroll
  for (int k = 0; k < RPT; ++k) { bz[0][k] = L.pr.b[k]; bz[1][k] = s[k] - res.rz[k]; }
  ok_kkt = refined_solve<2>(L, cf, sc, kk, bx, bz, xs, zs) && ok_kkt;

  R xi[CPT], xm[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) { xi[c] = x[c] * tinv; xm[c] = xi[c] - xs[0][c]; }
  R v[4] = {R(0), R(0), R(0), R(0)};
#pragma unroll
  for (int c = 0; c < CPT; ++c) v[0] += L.pr.q[c] * xs[0][c];
#pragma unroll
  for (int k = 0; k < RPT; ++k) v[1] += L.pr.b[k] * zs[0][k];
  if (L.p.p_nonzero) {
    R xf[N], t1[CPT], t2[CPT];
    gather_n(L.g, xm, xf);
    Pxv(L.p, L.pr, xf, t1);
    gather_n(L.g, xs[0], xf);
    Pxv(L.p, L.pr, xf, t2);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      v[2] += xm[c] * t1[c];
      v[3] += xs[0][c] * t2[c];
    }
  }
  gsum<4>(L.g, v);
  R tau_den = kappa * tinv - v[0] - v[1];
  if (L.p.p_nonzero) tau_den = tau_den + v[2] - v[3];

  // affine step
  R dxa[CPT], dza[RPT], dsa[RPT], dtaua, dkappaa;
  tau_recovery(L, sc, xs[1], zs[1], xs[0], zs[0], xi, s, res.rtau, tau * kappa,
               kappa, tinv, tau_den, dxa, dza, dsa, dtaua, dkappaa);
  const R alpha_aff = step_length(L.g, L.p, dza, dsa, z, s,
                                  max_step(tau, kappa, dtaua, dkappaa));
  const R oma = R(1) - alpha_aff;
  const R sigma = oma * oma * oma;
  const R m_corr = iters1 > 1 ? R(1) : alpha_aff;
  const R sigma_mu = sigma * mu;

  // combined step
  R dzm[RPT], shift[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) dzm[k] = dza[k] * m_corr;
  combined_ds_shift(L.g, L.p, sc, dzm, dsa, sigma_mu, shift);
#pragma unroll
  for (int k = 0; k < RPT; ++k) aff[k] = aff[k] + shift[k];   // comb_s
  const R one_m_sigma = R(1) - sigma;
  const R comb_tau = res.rtau * one_m_sigma;
  const R comb_kappa = -sigma_mu + dtaua * dkappaa * m_corr + tau * kappa;
  R ds_const[RPT];
  ds_from_dz_offset(L.g, L.p, sc, aff, z, ds_const);
  R cbx[1][CPT], cbz[1][RPT], xc[1][CPT], zc[1][RPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) cbx[0][c] = res.rx[c] * one_m_sigma;
#pragma unroll
  for (int k = 0; k < RPT; ++k) cbz[0][k] = ds_const[k] - res.rz[k] * one_m_sigma;
  const bool ok3 = refined_solve<1>(L, cf, sc, kk, cbx, cbz, xc, zc);
  tau_recovery(L, sc, xc[0], zc[0], xs[0], zs[0], xi, ds_const, comb_tau,
               comb_kappa, kappa, tinv, tau_den, st.dx, st.dz, st.ds, st.dtau,
               st.dkappa);
  st.kkt_fail = !(ok_kkt && ok3);
  st.alpha = step_length(L.g, L.p, st.dz, st.ds, z, s,
                         max_step(tau, kappa, st.dtau, st.dkappa));
  st.sigma = sigma;
  st.alpha = st.alpha * R(L.p.max_step_fraction);
}

// ---- initial point (reference shift_to_interior, l.2015), on the
// gathered vector in megakernel.cu's order ----
__device__ __forceinline__ void shift_to_interior(const Grp& g,
                                                  const MkParams& p,
                                                  double (&v)[RPT],
                                                  bool primal) {
  double full[M];
  gather_m(g, v, full);
  double mm = BIG, pm = 0.0;
#pragma unroll
  for (int sg = 0; sg < S; ++sg) {
    const int lo = p.seg_lo[sg], hi = p.seg_hi[sg];
    const int kind = p.seg_kind[sg];
    if (kind == SEG_NN) {
      double mn = BIG, ps = 0.0;
      bool first = true;
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (i >= lo && i < hi) {
          mn = first ? full[i] : nmin(mn, full[i]);
          first = false;
          ps += nmax(full[i], 0.0);
        }
      mm = nmin(mm, mn);
      pm = pm + ps;
    } else if (kind == SEG_SOC) {
      double acc = 0.0, head = 0.0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i == lo) head = full[i];
        if (i > lo && i < hi) acc += full[i] * full[i];
      }
      const double a = head - sqrt(acc);
      mm = nmin(mm, a);
      pm = pm + nmax(a, 0.0);
    }
  }
  mm = isfinite(mm) ? mm : -1.0;
  pm = isfinite(pm) ? pm : 0.0;
  const int deg = p.degree > 1 ? p.degree : 1;
  const double target = nmax(0.1 * pm / deg, 1.0);
  const double amt1 = mm <= 0 ? -mm : 0.0;
  const double amt2 = mm <= 0 ? target : (mm < target ? target - mm : 0.0);
  const double amt = amt1 + amt2;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] == SEG_ZERO) {
      if (primal) v[r] = 0.0;
    } else if (g.kind[r] == SEG_NN || (g.kind[r] == SEG_SOC && g.head[r])) {
      v[r] = v[r] + amt;
    }
  }
}

// ---- Ruiz equilibration: scalings in float32 (reference l.2997-3046) ----
// Every reduction is a max, or a sum over data every thread holds whole
// in megakernel.cu's order, so the scalings are megakernel.cu's.
__device__ __forceinline__ void ruiz(const Grp& g, const MkParams& p,
                                     const double (&Praw)[CPT][N],
                                     const double (&Araw)[RPT][N],
                                     const double (&qraw)[CPT], float (&df)[N],
                                     float (&ef)[RPT], float& cf) {
#pragma unroll
  for (int j = 0; j < N; ++j) df[j] = 1.0f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) ef[r] = 1.0f;
  cf = 1.0f;
  if (!p.eq_enable) return;
  const float smin = (float)p.eq_min_scaling;
  const float smax = (float)p.eq_max_scaling;
  float Pa[CPT][N], Aa[RPT][N], qa[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int j = 0; j < N; ++j) Pa[c][j] = fabsf((float)Praw[c][j]);
    qa[c] = fabsf((float)qraw[c]);
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) Aa[r][j] = fabsf((float)Araw[r][j]);
  for (int it = 0; it < p.eq_max_iter; ++it) {
    // column maxima of P and of A
    float cm[2 * N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float pc = 0.0f, ac = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) pc = nmax(pc, Pa[c][j]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) ac = nmax(ac, Aa[r][j]);
      cm[j] = pc;
      cm[N + j] = ac;
    }
    gmax<2 * N>(g, cm);
    float dw[N], ew[RPT], dwo[CPT];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float v0 = nmax(cm[j], cm[N + j]);
      const float v = v0 == 0.0f ? 1.0f : v0;
      dw[j] = nmin(nmax(1.0f / sqrtf(v), smin / df[j]), smax / df[j]);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float rm = Aa[r][0];
#pragma unroll
      for (int j = 1; j < N; ++j) rm = nmax(rm, Aa[r][j]);
      const float v = rm == 0.0f ? 1.0f : rm;
      ew[r] = nmin(nmax(1.0f / sqrtf(v), smin / ef[r]), smax / ef[r]);
    }
    pick_n(g, dw, dwo);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int j = 0; j < N; ++j) Pa[c][j] = Pa[c][j] * dw[j] * dwo[c];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < N; ++j) Aa[r][j] = Aa[r][j] * dw[j] * ew[r];
#pragma unroll
    for (int c = 0; c < CPT; ++c) qa[c] = qa[c] * dwo[c];
#pragma unroll
    for (int j = 0; j < N; ++j) df[j] = df[j] * dw[j];
#pragma unroll
    for (int r = 0; r < RPT; ++r) ef[r] = ef[r] * ew[r];
    float pcm[N + 1];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float pc = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) pc = nmax(pc, Pa[c][j]);
      pcm[j] = pc;
    }
    float iq = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) iq = nmax(iq, qa[c]);
    pcm[N] = iq;
    gmax<N + 1>(g, pcm);
    float sum_p = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) sum_p = sum_p + pcm[j];
    const float inf_q = pcm[N];
    const float mean_p = sum_p / (float)N;
    const bool do_cost = (mean_p != 0.0f) && (inf_q != 0.0f);
    const float scale_cost = nmax(inf_q, mean_p);
    const float inv = 1.0f / (scale_cost != 0.0f ? scale_cost : 1.0f);
    const float ctmp = do_cost ? nmin(nmax(inv, smin / cf), smax / cf) : 1.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
#pragma unroll
      for (int j = 0; j < N; ++j) Pa[c][j] = Pa[c][j] * ctmp;
      qa[c] = qa[c] * ctmp;
    }
    cf = cf * ctmp;
  }
  // cone rectification: the mean on each SOC segment, summed in row order
  float full[M];
  gather_m(g, ef, full);
#pragma unroll
  for (int sg = 0; sg < S; ++sg) {
    if (p.seg_kind[sg] != SEG_SOC) continue;
    const int lo = p.seg_lo[sg], hi = p.seg_hi[sg];
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (k >= lo && k < hi) acc = acc + full[k];
    const float mean = acc / (float)(hi - lo);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if (g.seg[r] == sg) ef[r] = mean;
  }
}

// the lane's carry: the iterate, the previous iterate and the scalars the
// termination machine reads
struct Carry {
  double x[CPT], z[RPT], s[RPT], px[CPT], pz[RPT], ps[RPT];
  double tau, kappa, ptau, pkap;
  double prev_rp, prev_rd, prev_ga, prev_gr, mu_f, alpha_f, sigma_f;
};


__device__ __forceinline__ void solve_lane(const Grp& g, const MkParams& p,
                                           const In& Pin, const In& qin,
                                           const In& Ain, const In& bin,
                                           long long lane, long long B,
                                           double* __restrict__ vals,
                                           int* __restrict__ ints) {
  Prob<double> pr;
  // raw data of the owned rows: P full symmetric from the column-major
  // upper triangle, A row-wise from its column-major (m, n) layout
  double qraw[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = col_of(g, c);
    const bool ok = i < N;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      pr.P[c][j] = ok ? at(Pin, hi * (hi + 1) / 2 + lo, lane) : 0.0;
    }
    qraw[c] = ok ? at(qin, i, lane) : 0.0;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = row_of(g, r);
    const bool ok = k < M;
#pragma unroll
    for (int j = 0; j < N; ++j) pr.A[r][j] = ok ? at(Ain, j * M + k, lane) : 0.0;
  }

  float df[N], ef[RPT], cf;
  ruiz(g, p, pr.P, pr.A, qraw, df, ef, cf);
  const double c = (double)cf;
  pr.cinv = 1.0 / c;
  double dfull[N];
#pragma unroll
  for (int j = 0; j < N; ++j) dfull[j] = (double)df[j];
  double own_d[CPT];
  pick_n(g, dfull, own_d);
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const bool ok = col_of(g, cc) < N;
    pr.d[cc] = ok ? own_d[cc] : 0.0;
    pr.dinv[cc] = ok ? 1.0 / pr.d[cc] : 0.0;
    pr.q[cc] = qraw[cc] * (pr.d[cc] * c);
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = row_of(g, r);
    const bool ok = k < M;
    pr.e[r] = ok ? (double)ef[r] : 0.0;
    pr.einv[r] = ok ? 1.0 / pr.e[r] : 0.0;
    pr.b[r] = ok ? at(bin, k, lane) * pr.e[r] : 0.0;
  }
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
    for (int j = 0; j < N; ++j)
      pr.P[cc][j] = p.p_nonzero ? pr.P[cc][j] * (pr.d[cc] * (dfull[j] * c)) : 0.0;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) pr.A[r][j] = pr.A[r][j] * (pr.e[r] * dfull[j]);
  {
    double nq = 0.0, nb = 0.0, pdg = 0.0;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      nq = nmax(nq, fabs(pr.dinv[cc] * pr.q[cc]));
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == col_of(g, cc)) pdg = nmax(pdg, fabs(pr.P[cc][j]));
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) nb = nmax(nb, fabs(pr.einv[r] * pr.b[r]));
    double v[3] = {nq, nb, pdg};
    gmax<3>(g, v);
    pr.normq = v[0] * pr.cinv;
    pr.normb = v[1];
    pr.pdiag = p.p_nonzero ? v[2] : 0.0;
  }
  const Lane<double> L{g, p, pr};
  const Cfg<double> cfg{&p, p.refine_abstol, p.refine_reltol, p.refine_passes};

  // ---- initial point (reference l.3089-3157) ----
  Carry cy;
  {
    Scale<double> id;
    id.ident = true;
#pragma unroll
    for (int r = 0; r < RPT; ++r) id.w[r] = id.lam[r] = id.sa[r] = id.w0[r] = id.lam0[r] = 0.0;
    Kkt<double> k0;
    build_kkt(g, p, pr, id, eps_of(g, p, pr, id), k0);
    if (p.p_nonzero) {
      double bx[1][CPT], bz[1][RPT], xs[1][CPT], zs[1][RPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) bx[0][cc] = -pr.q[cc];
#pragma unroll
      for (int r = 0; r < RPT; ++r) bz[0][r] = pr.b[r];
      refined_solve<1>(L, cfg, id, k0, bx, bz, xs, zs);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) cy.x[cc] = xs[0][cc];
#pragma unroll
      for (int r = 0; r < RPT; ++r) { cy.z[r] = zs[0][r]; cy.s[r] = -zs[0][r]; }
    } else {
      double bx[2][CPT], bz[2][RPT], xs[2][CPT], zs[2][RPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) { bx[0][cc] = 0.0; bx[1][cc] = -pr.q[cc]; }
#pragma unroll
      for (int r = 0; r < RPT; ++r) { bz[0][r] = pr.b[r]; bz[1][r] = 0.0; }
      refined_solve<2>(L, cfg, id, k0, bx, bz, xs, zs);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) cy.x[cc] = xs[0][cc];
#pragma unroll
      for (int r = 0; r < RPT; ++r) { cy.s[r] = -zs[0][r]; cy.z[r] = zs[1][r]; }
    }
    shift_to_interior(g, p, cy.s, true);
    shift_to_interior(g, p, cy.z, false);
  }
  cy.tau = cy.kappa = cy.ptau = cy.pkap = 1.0;
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) cy.px[cc] = cy.x[cc];
#pragma unroll
  for (int r = 0; r < RPT; ++r) { cy.pz[r] = cy.z[r]; cy.ps[r] = cy.s[r]; }
  cy.prev_rp = cy.prev_rd = cy.prev_ga = cy.prev_gr = BIG;
  cy.mu_f = BIG;
  cy.alpha_f = 0.0;
  cy.sigma_f = 1.0;
  int iters = 0, status = UNSOLVED;
  const double inv_deg1 = 1.0 / (p.degree + 1);
  const double sr = p.stall_ratio;

  // ---- main loop: the group's control flow is uniform ----
  for (;;) {
    const double tau = cy.tau, kappa = cy.kappa;
    const double tinv = 1.0 / tau;
    Res<double> res;
    residuals(L, cy.x, cy.z, cy.s, tau, kappa, tinv, res);
    const double mu = (res.sz + tau * kappa) * inv_deg1;
    Info<double> info;
    compute_info(L, res, cy.x, cy.z, cy.s, kappa, tinv, info);
    const int status1 =
        check_convergence(info, res.bz, res.qx, p.tol, SOLVED, PINF, DINF);
    const double rp = info.res_primal, rd = info.res_dual;
    const bool going_back = rd > cy.prev_rd || rp > cy.prev_rp;
    const bool stagnating = (rd > sr * cy.prev_rd || rp > sr * cy.prev_rp) &&
                            (info.gap_abs > sr * cy.prev_ga &&
                             info.gap_rel > sr * cy.prev_gr);
    const bool after_first = status1 == UNSOLVED && iters > 1;
    const bool poor_hi = info.ktratio < 100.0 * EPS64 &&
                         (cy.prev_ga < p.tol[0] || cy.prev_gr < p.tol[1]);
    const double tf100 = 100.0 * p.tol[2];
    const bool diverging =
        info.ktratio < 1.0 && ((rd > tf100 && rd > 100.0 * cy.prev_rd) ||
                               (rp > tf100 && rp > 100.0 * cy.prev_rp));
    const bool insuff = (after_first && stagnating && poor_hi) ||
                        (after_first && going_back && diverging);
    int status2 = insuff ? INSUFFICIENT_PROGRESS : status1;
    if (status2 == UNSOLVED && iters >= p.max_iter) status2 = MAX_ITERATIONS;
    cy.mu_f = mu;
    if (status2 != UNSOLVED) {
      // terminated at the top of the loop; roll back on insufficient
      // progress (src/solver.jl:453-472)
      if (status2 == INSUFFICIENT_PROGRESS) {
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) cy.x[cc] = cy.px[cc];
#pragma unroll
        for (int r = 0; r < RPT; ++r) { cy.z[r] = cy.pz[r]; cy.s[r] = cy.ps[r]; }
        cy.tau = cy.ptau;
        cy.kappa = cy.pkap;
      }
      status = status2;
      break;
    }
    const int iters1 = iters + 1;
    Step<double> stp;
    pc_step(L, cfg, cy.x, cy.z, cy.s, tau, kappa, tinv, res, mu, iters1, stp);

    // numerical-error and small-step checkpoints (reference l.3391-3430)
    int fail_status = stp.kkt_fail ? NUMERICAL_ERROR : UNSOLVED;
    const bool small_term = stp.alpha <= nmax(0.0, p.min_terminate_step_length);
    if (fail_status == UNSOLVED && !stp.kkt_fail && small_term)
      fail_status = INSUFFICIENT_PROGRESS;
    const bool take = !stp.kkt_fail && !small_term;
    const double a = take ? stp.alpha : 0.0;
    if (take) {
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        cy.px[cc] = cy.x[cc];
        cy.x[cc] = cy.x[cc] + stp.dx[cc] * a;
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        cy.pz[r] = cy.z[r];
        cy.ps[r] = cy.s[r];
        cy.z[r] = cy.z[r] + stp.dz[r] * a;
        cy.s[r] = cy.s[r] + stp.ds[r] * a;
      }
      cy.ptau = tau;
      cy.pkap = kappa;
      cy.tau = tau + stp.dtau * a;
      cy.kappa = kappa + stp.dkappa * a;
      cy.prev_rp = info.res_primal;
      cy.prev_rd = info.res_dual;
      cy.prev_ga = info.gap_abs;
      cy.prev_gr = info.gap_rel;
    }
    cy.alpha_f = a;
    cy.sigma_f = stp.sigma;
    status = fail_status;
    iters = iters1;
    if (status != UNSOLVED) break;
  }

  // ---- finalize ----
  const double tau = cy.tau, kappa = cy.kappa;
  const double tinv = 1.0 / tau;
  Res<double> res;
  residuals(L, cy.x, cy.z, cy.s, tau, kappa, tinv, res);
  Info<double> info;
  compute_info(L, res, cy.x, cy.z, cy.s, kappa, tinv, info);
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
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int j = col_of(g, cc);
    if (j < N) o[(long long)j * B] = cy.x[cc] * pr.d[cc] * scaleinv;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = row_of(g, r);
    if (k < M) {
      o[(long long)(N + k) * B] = cy.z[r] * pr.e[r] * (scaleinv * pr.cinv);
      o[(long long)(N + M + k) * B] = cy.s[r] * pr.einv[r] * scaleinv;
    }
  }
  if (g.t == 0) {
    const double scalars[13] = {
        is_inf ? nan : info.cost_primal, is_inf ? nan : info.cost_dual,
        info.res_primal, info.res_dual, info.gap_abs, info.gap_rel, cy.mu_f,
        cy.alpha_f, cy.sigma_f, info.ktratio, tau * scaleinv, kappa * scaleinv,
        (double)raw_status};
#pragma unroll
    for (int i = 0; i < 13; ++i) o[(long long)(N + 2 * M + i) * B] = scalars[i];
    ints[lane] = status;
    ints[B + lane] = iters;
    ints[2 * B + lane] = 0;   // PrimalDual: the only strategy here
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mk_kernel(In P, In q, In A, In b, long long B,
          const __grid_constant__ MkParams prm, double* __restrict__ vals,
          int* __restrict__ ints) {
  const long long lane =
      (long long)blockIdx.x * LANES_PER_BLOCK + threadIdx.x / G;
  if (lane >= B) return;   // the whole group leaves together
  Grp g;
  g.t = threadIdx.x % G;
  g.mask = G == 32 ? 0xffffffffu
                   : (((1u << G) - 1u) << ((threadIdx.x % 32) / G * G));
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = row_of(g, r);
    g.kind[r] = NO_ROW;
    g.seg[r] = -1;
    g.head[r] = false;
#pragma unroll
    for (int sg = 0; sg < S; ++sg)
      if (k >= prm.seg_lo[sg] && k < prm.seg_hi[sg]) {
        g.kind[r] = prm.seg_kind[sg];
        g.seg[r] = sg;
        g.head[r] = k == prm.seg_lo[sg];
      }
  }
  solve_lane(g, prm, P, q, A, b, lane, B, vals, ints);
}

}  // namespace

extern "C" {

// Shape this library was built for: {n, m, segments, nonsymmetric, psd,
// genpow, two-phase, OUTD}.
int mk_shape(int* out) {
  out[0] = N;
  out[1] = M;
  out[2] = S;
  out[3] = MK_NONSYM;
  out[4] = MK_PSD;
  out[5] = MK_GENPOW;
  out[6] = MK_TWO_PHASE;
  out[7] = OUTD;
  return 0;
}

int mk_params_size(void) { return (int)sizeof(MkParams); }

// Launch the whole batched solve on `stream`: LANES_PER_BLOCK lanes a block
// of THREADS threads.  Input component k of lane l is ptr[k * ld + l * ls].
// vals is (OUTD, B) float64, ints (4, B) int32 (status, iterations, final
// scaling strategy; the kernel leaves the fourth row, the float32 phase's
// iterations, to the caller).  Returns
// cudaGetLastError() after the launch.
int mk_solve(const double* P, long long P_ld, long long P_ls,
             const double* q, long long q_ld, long long q_ls,
             const double* A, long long A_ld, long long A_ls,
             const double* b, long long b_ld, long long b_ls, long long B,
             MkParams prm, double* vals, int* ints, void* stream) {
  if (B <= 0) return 0;
  const In Pi{P, P_ld, P_ls}, qi{q, q_ld, q_ls}, Ai{A, A_ld, A_ls},
      bi{b, b_ld, b_ls};
  const long long blocks = (B + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
  mk_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      Pi, qi, Ai, bi, B, prm, vals, ints);
  return (int)cudaGetLastError();
}

}  // extern "C"
