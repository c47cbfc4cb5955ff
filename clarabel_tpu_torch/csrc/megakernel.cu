// The batched conic IPM as one CUDA kernel, one instance per thread (K1a;
// K1b where the build sets MK_NONSYM=1; K1c where it sets MK_GENPOW=1;
// K1d where it sets MK_PSD=1; K1e where it sets MK_TWO_PHASE=1).
//
// Replaces: clarabel_tpu/ipm/megakernel.py `kernel` / `compute` (the Pallas
// megakernel launched by `_pallas_fn`), restricted to zero, nonnegative and
// second-order cone segments (K1a) and exponential and power segments
// (K1b).  It computes what the plain PyTorch version
// clarabel_tpu_torch/ipm/megakernel_ref.py computes, formula for formula:
// Ruiz equilibration (scalings in float32, applied in float64), the
// symmetric initial point, the Mehrotra predictor-corrector loop over the
// condensed normal equations (unrolled dense Cholesky plus accept-masked
// refinement against the true augmented operator), the termination machine
// with the gap-aware stall check, and finalization.
//
// K1b (MK_NONSYM=1, only in libraries whose layout has an exp or pow
// segment, so K1a's code is unchanged): the unit-initialization start, the
// dual and primal-dual (BFGS) 3x3 scalings with their Cholesky factors, the
// Wright-omega and one-sided Newton primal gradients, the third-order
// corrections, the joint feasibility backtrack, and per lane the
// PrimalDual->Dual strategy machine with the barrier backtrack of Dual
// lanes (reference l.848-1098, 1240-1511, 2091-2325, 2464-2701,
// 2948-2976, 3355-3430).  log, exp and pow run in native FP64.  Each lane
// runs its own Newton and backtracking loops (up to 50 or 60 trips), so
// the lanes of a warp diverge there; this first version does nothing
// about that.
//
// K1c (MK_GENPOW=1, with MK_NONSYM=1, only where the layout has a
// generalized power segment): the dual-only genpow scaling with Hs =
// mu (D + pp' - qq' - rr') kept as per-row vectors, its inverse by three
// Sherman-Morrison updates, no third-order correction, the genpow cones in
// the joint feasibility backtrack, the primal barrier through a one-sided
// Newton gradient (at most 50 trips), and every lane on Dual from the
// start (reference l.1103-1239, 2181-2193, 2326-2431, 3119-3124).
// What bounds K1c: its backtracking searches, run lane by lane.  Every
// step runs two joint feasibility backtracks (2 d1 logs and two exps a
// trial) and, every lane being on Dual, the barrier backtrack, each trial
// of which runs a Newton solve of about four trips with d1 + 1 logs each.
// On the card the barrier backtrack alone took 41 % of the kernel at
// B = 131072 (97.5 ms against 57.3 ms with linesearch_max_iter 0), and a
// lane's serial trials hold its warp-mates idle: on chip_smoke.py's batch
// at B = 4096 one lane runs 51 iterations, with barrier backtracks of up
// to 50 trials, long after the rest of its warp is done (PERF.md section
// 5; tools/search_trips.py).  The design (`coop_search`): the warp shares
// the trials out.  Each searching lane stages its point and direction in
// shared memory and the warp's 32 threads try the searching lanes'
// candidate steps side by side, each lane taking its first passing step,
// the serial loop's.  The IPM loop runs while any lane of the warp does,
// so lanes that are done, and threads past the batch, help.
//
// K1d (MK_PSD=1, only where the layout has a PSD segment; sides <= 3):
// the NT scaling from clamped Cholesky factors of S and Z and a one-sided
// Jacobi SVD of L2'L1, the step length from the least Jacobi eigenvalue of
// lam^{-1/2} (W d) lam^{-1/2}, the barrier from a Cholesky logdet, and the
// PSD margins of the initial point (reference l.652-830, 1418-1451,
// 1579-1691, 2104-2150, 2255-2258, 2596-2681, 3125-3130).  Both Jacobi
// iterations run in float64 until no pair rotates, at most 12 sweeps
// (DEVIATIONS.md #12).  A lane's matrices are 3x3 arrays indexed with the
// segment's side at run time.
//
// K1e (MK_TWO_PHASE=1, only where the spec runs the float32 first phase:
// nn, SOC and PSD layouts with Settings.megakernel_two_phase): before the
// float64 loop each lane runs plain-float32 predictor-corrector steps over
// a float32 copy of its scaled data until it hands off (`phase1`,
// reference loop_cond1/loop_body1, l.3212-3281), with one refinement pass
// at float32 tolerances and the Jacobi sweeps stopped at float32 rounding.
// The code both phases share (scaling, condensed KKT and Cholesky, refined
// solves, tau recovery, step lengths, residuals, info) is written once as
// templates over the scalar type R, rather than a header included twice in
// two namespaces: the structs and functions then stay in this one file,
// double remains the only instance in a library without MK_TWO_PHASE (so
// K1a-K1d compile to the code they had), and a caller names its precision
// by the types it passes.  Literals enter as R(...) and math goes through
// overloads that pick sqrtf and fabsf for float, so the float instance
// never promotes to FP64.  `phase1` is not inlined: its float32 working set
// is a frame of its own.
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
// The launch: one lane per thread, in blocks of 32 threads while blocks of
// 128 would leave SMs without a block (at B = 4096, 128 blocks of 32 on
// 132 SMs in place of 32 blocks of 128), else of 128; K1b always of 128.
// At B = 4096 that took K1a from 2.80 to 1.82 ms and K1c from 9.0 to 5.0
// ms on the card, where K1b measured slower in blocks of 32 (PERF.md
// section 5).
//
// Build (route (b): a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DMK_N=6 -DMK_M=13 -DMK_S=2 -DMK_NONSYM=0 \
//        -DMK_PSD=0 -DMK_GENPOW=0 -DMK_TWO_PHASE=0 -o mk.so megakernel.cu

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
#if MK_GENPOW && !MK_NONSYM
#error "a generalized power segment is nonsymmetric: build with MK_NONSYM=1"
#endif
#ifndef MK_TWO_PHASE
#define MK_TWO_PHASE 0
#endif
#if MK_TWO_PHASE && MK_NONSYM
#error "the float32 first phase runs on nn, SOC and PSD layouts only"
#endif
// the warp-cooperative backtracking searches (`coop_search`): in K1c, whose
// feasibility tests and barrier (a Newton solve per evaluation) are costly
// enough to pay for staging; K1b keeps one serial loop per lane
#define MK_COOP MK_GENPOW

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
constexpr double SQRT_EPS64 = 1.4901161193847656e-08;
constexpr double PI = 3.141592653589793;
// the nonsymmetric step cap (reference l.2169-2172) and the trip limits of
// the joint feasibility backtrack and of the pow Newton iteration
constexpr double STEP_CAP = 1.0 - 1.0 / 4096.0;
constexpr int FEAS_TRIPS = 60, NR_TRIPS = 50;
enum Strategy { PRIMAL_DUAL = 0, DUAL = 1 };

enum Status {
  UNSOLVED = 0, SOLVED = 1, PINF = 2, DINF = 3, ALMOST_SOLVED = 4,
  ALMOST_PINF = 5, ALMOST_DINF = 6, MAX_ITERATIONS = 7,
  NUMERICAL_ERROR = 9, INSUFFICIENT_PROGRESS = 10
};
enum SegKind { SEG_ZERO = 0, SEG_NN = 1, SEG_SOC = 2, SEG_EXP = 3,
               SEG_POW = 4, SEG_GENPOW = 5, SEG_PSD = 6 };
#if MK_GENPOW
constexpr int GPW = 16;   // the widest generalized power segment
#endif
#if MK_PSD
constexpr double SR2 = 1.4142135623730951, ISR2 = 0.7071067811865476;
#endif
#if MK_TWO_PHASE
// the float32 first phase's hand-off rules (reference l.79-82; the mu
// switch and the iteration cap come in MkParams) and its refinement
// tolerances (reference l.1842-1849)
constexpr float P1_MIN_STEP = 0.01f, P1_STALL_RATIO = 0.9f;
constexpr int P1_STALL_FROM_ITER = 5;
constexpr double P1_REFINE_ABSTOL = 1e-7, P1_REFINE_RELTOL = 3e-7;
#endif

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
  double seg_alpha[S];  // a pow segment's exponent (0 for the other kinds)
  double min_switch_step_length, linesearch_backtrack_step;
  int seg_kind[S], seg_lo[S], seg_hi[S];
  int degree, p_nonzero, max_iter, eq_enable, eq_max_iter, refine_passes;
  int linesearch_max_iter;
#if MK_GENPOW
  double gp_alpha[S][GPW];  // a genpow segment's exponents (0 elsewhere)
  int gp_d1[S];             // their count (0 for the other kinds)
#endif
#if MK_PSD
  // the Jacobi sweeps of the SVD and of the eigenvalues stop once no pair
  // rotates, at most this many
  int psd_sweeps;
#endif
#if MK_TWO_PHASE
  // the float32 first phase: a lane hands off to the float64 loop once its
  // mu falls below p1_switch_mu or after p1_cap iterations; its refined
  // solves take at most p1_refine_passes passes
  double p1_switch_mu;
  int p1_cap, p1_refine_passes;
#endif
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

// The code that the float32 first phase (K1e) shares with the float64
// loop is written once over the scalar type R: a template parameter of
// the structs and device functions below.  R = double is the only
// instance in a library built without MK_TWO_PHASE, so K1a-K1d compile
// as before; R = float adds the first phase's instance.  Literals enter
// as R(...) so that the float instance computes in float32 throughout,
// and these overloads call the float math functions there.
__device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double mabs(double x) { return fabs(x); }
__device__ __forceinline__ float mabs(float x) { return fabsf(x); }
// the unit roundoff that stops a Jacobi sweep (DEVIATIONS.md #12)
template <typename R> struct Eps;
template <> struct Eps<double> { static constexpr double v = EPS64; };
template <> struct Eps<float> { static constexpr float v = 1.1920928955078125e-07f; };

struct In {
  const double* p;
  long long ld;   // component stride
  long long ls;   // lane stride: 1, or 0 for a batch-constant component
};

__device__ __forceinline__ double at(const In& a, int k, long long lane) {
  return a.p[k * a.ld + lane * a.ls];
}

// The scaled problem of one lane.
template <typename R> struct ProbT {
  R P[N * N];    // [i * N + j]
  R A[M * N];    // [k * N + j]
  R q[N], b[M];
  R d[N], e[M], dinv[N], einv[M];
  R cinv, normq, normb, pdiag;
};

// Scaling state.  nn rows: w2 in w, 1/w2 in winv2; soc rows: w.  exp/pow
// segments (K1b): the dual gradient g, the dual Hessian Hd, Hs and its 3x3
// factor F (6 entries each: h11 h12 h13 h22 h23 h33; F: l21 l31 l32 and
// the inverse pivots), and z.
template <typename R> struct ScaleT {
  R w[M], winv2[M], lam[M];
  R eta[S], eta2[S], etainv[S], etainv2[S];
#if MK_NONSYM
  R ns_g[S][3], ns_Hd[S][6], ns_Hs[S][6], ns_F[S][6], ns_z[S][3];
#endif
#if MK_GENPOW
  // genpow segments (K1c), per row: the dual gradient, the diagonal D,
  // p, and q on the head rows or r on the tail rows; and mu
  R gp_g[M], gp_dd[M], gp_p[M], gp_qr[M], gp_mu;
#endif
#if MK_PSD
  // PSD segments (K1d): R, Rinv (3x3, row-major) and lam
  R psd_R[S][9], psd_Ri[S][9], psd_lam[S][3];
#endif
  bool ident;   // identity scaling (initial point)
};

template <typename R> struct KktT {
  const ScaleT<R>* sc;
  R L[N * N], Linv[N], eps;
};

template <typename R> struct ResT {
  R rx[N], rz[M], rx_inf[N], rz_inf[M], Px[N];
  R rtau, qx, bz, sz, xPx;
};

template <typename R> struct InfoT {
  R cost_primal, cost_dual, res_primal, res_dual, res_primal_inf,
      res_dual_inf, gap_abs, gap_rel, ktratio;
};

template <typename R> struct CtxT {
  MkParams p;
  ProbT<R> pr;
};

using Prob = ProbT<double>;
using Scale = ScaleT<double>;
using Kkt = KktT<double>;
using Res = ResT<double>;
using Info = InfoT<double>;
using Ctx = CtxT<double>;

template <int D, typename R> __device__ __forceinline__ R dotn(const R* a,
                                                               const R* b) {
  R acc = R(0);
  for (int i = 0; i < D; ++i) acc += a[i] * b[i];
  return acc;
}

template <typename R> __device__ R vnorm(const R* v, int len) {
  R acc = R(0);
  for (int i = 0; i < len; ++i) acc += v[i] * v[i];
  return msqrt(acc);
}

template <typename R>
__device__ void Ax(const ProbT<R>& pr, const R* x, R* out) {
  for (int k = 0; k < M; ++k) {
    R acc = R(0);
    for (int j = 0; j < N; ++j) acc += pr.A[k * N + j] * x[j];
    out[k] = acc;
  }
}

template <typename R>
__device__ void Aty(const ProbT<R>& pr, const R* y, R* out) {
  for (int j = 0; j < N; ++j) {
    R acc = R(0);
    for (int k = 0; k < M; ++k) acc += pr.A[k * N + j] * y[k];
    out[j] = acc;
  }
}

template <typename R>
__device__ void Pxv(const CtxT<R>& cx, const R* x, R* out) {
  for (int i = 0; i < N; ++i) {
    R acc = R(0);
    if (cx.p.p_nonzero)
      for (int j = 0; j < N; ++j) acc += cx.pr.P[i * N + j] * x[j];
    out[i] = acc;
  }
}

template <typename R> __device__ R soc_res_sqrt(const R* X, int len) {
  const R x1n = vnorm(X + 1, len - 1);
  const R res = (X[0] - x1n) * (X[0] + x1n);
  return res > 0 ? msqrt(nmax(res, R(0))) : R(0);
}

#if MK_NONSYM
// ---- exponential and power cones (K1b; the plain version's helpers in
// megakernel_ref.py, formula for formula).  Hessians are 6-vectors
// (h11 h12 h13 h22 h23 h33). ----

// log, with -BIG where x <= 0 (reference nslogsafe)
__device__ __forceinline__ double nslog(double x) {
  return x > 0 ? log(x) : -BIG;
}

__device__ __forceinline__ double dot3(const double* u, const double* v) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

__device__ void hmul3(const double* H, const double* v, double* out) {
  out[0] = H[0] * v[0] + H[1] * v[1] + H[2] * v[2];
  out[1] = H[1] * v[0] + H[3] * v[1] + H[4] * v[2];
  out[2] = H[2] * v[0] + H[4] * v[1] + H[5] * v[2];
}

// closed-form 3x3 Cholesky with clamped pivots: F = (l21, l31, l32, 1/l11,
// 1/l22, 1/l33); returns whether every pivot was positive
__device__ bool chol3_fac(const double* H, double* F) {
  bool ok = H[0] > 0;
  double l11 = sqrt(nmax(H[0], 0.0));
  l11 = l11 > 0 ? l11 : 1.0;
  const double i11 = 1.0 / l11;
  const double l21 = H[1] * i11, l31 = H[2] * i11;
  const double d2 = H[3] - l21 * l21;
  ok = ok && d2 > 0;
  double l22 = sqrt(nmax(d2, 0.0));
  l22 = l22 > 0 ? l22 : 1.0;
  const double i22 = 1.0 / l22;
  const double l32 = (H[4] - l31 * l21) * i22;
  const double d3 = H[5] - l31 * l31 - l32 * l32;
  ok = ok && d3 > 0;
  double l33 = sqrt(nmax(d3, 0.0));
  l33 = l33 > 0 ? l33 : 1.0;
  F[0] = l21; F[1] = l31; F[2] = l32;
  F[3] = i11; F[4] = i22; F[5] = 1.0 / l33;
  return ok;
}

__device__ void chol3_solve_fac(const double* F, const double* b,
                                double* x) {
  const double y1 = b[0] * F[3];
  const double y2 = (b[1] - F[0] * y1) * F[4];
  const double y3 = (b[2] - F[1] * y1 - F[2] * y2) * F[5];
  const double x3 = y3 * F[5];
  const double x2 = (y2 - F[2] * x3) * F[4];
  x[0] = (y1 - F[0] * x2 - F[1] * x3) * F[3];
  x[1] = x2;
  x[2] = x3;
}

// y + log(y) = z (float64; cones/nonsymmetric.py _wright_omega)
__device__ double wright_omega(double z) {
  const double zm1 = z - 1.0;
  const double p1 = zm1;
  double w_small = 1.0 + 0.5 * p1;
  const double p2 = p1 * zm1;
  w_small = w_small + (1.0 / 16.0) * p2;
  const double p3 = p2 * zm1;
  w_small = w_small - (1.0 / 192.0) * p3;
  const double p4 = p3 * zm1;
  w_small = w_small - (1.0 / 3072.0) * p4;
  const double p5 = p4 * zm1;
  w_small = w_small + (13.0 / 61440.0) * p5;
  const double z_big = nmax(z, 1.0 + PI);
  const double logz = log(z_big);
  const double zinv = 1.0 / z_big;
  double w_big = z_big - logz;
  double q = logz * zinv;
  w_big = w_big + q;
  q = q * zinv;
  w_big = w_big + q * (logz / 2.0 - 1.0);
  q = q * zinv;
  w_big = w_big + q * (logz * logz / 3.0 - 1.5 * logz + 1.0);
  double w = z < 1.0 + PI ? w_small : w_big;
  double r = z - w - log(nmax(w, 1e-300));
  for (int k = 0; k < 2; ++k) {
    const double wp1 = w + 1.0;
    const double t = wp1 * (wp1 + (2.0 * r) / 3.0);
    w = w * (1.0 + (r / wp1) * (t - 0.5 * r) / (t - r));
    r = (2.0 * w * w - 8.0 * w - 1.0) / (72.0 * pow(wp1, 6.0)) * pow(r, 4.0);
  }
  return w;
}

__device__ bool exp_feas_dual(const double* Z) {
  const double zsafe = Z[0] < 0 ? Z[0] : -1.0;
  const double res = Z[1] - Z[0] - Z[0] * nslog(-Z[2] / zsafe);
  return Z[2] > 0 && Z[0] < 0 && res > 0;
}

__device__ bool exp_feas_primal(const double* S) {
  const double res = S[1] * nslog(S[2] / (S[1] > 0 ? S[1] : 1.0)) - S[0];
  return S[2] > 0 && S[1] > 0 && res > 0;
}

// reference: coneops_expcone.jl:370-399
__device__ void exp_grad_hess_dual(const double* Z, double* g, double* H) {
  const double z1 = Z[0], z2 = Z[1], z3 = Z[2];
  const double l = nslog(-z3 / z1);
  const double r = -z1 * l - z1 + z2;
  const double c2 = 1.0 / r;
  g[0] = c2 * l - 1.0 / z1;
  g[1] = -c2;
  g[2] = (c2 * z1 - 1.0) / z3;
  const double rr = r * r, z1sq = z1 * z1;
  H[0] = (rr - z1 * r + l * l * z1sq) / (rr * z1sq);
  H[1] = -l / rr;
  H[2] = (z2 - z1) / (rr * z3);
  H[3] = 1.0 / rr;
  H[4] = -z1 / (rr * z3);
  H[5] = (rr - z1 * r + z1sq) / (rr * z3 * z3);
}

// reference: coneops_expcone.jl:284-297
__device__ void exp_grad_primal(const double* S, double* g) {
  const double s1 = S[0], s2 = S[1], s3 = S[2];
  const double w = wright_omega(1.0 - s1 / s2 - nslog(s2 / s3));
  const double g1 = 1.0 / ((w - 1.0) * s2);
  g[0] = g1;
  g[1] = g1 + g1 * nslog(w * s2 / s3) - 1.0 / s2;
  g[2] = w / ((1.0 - w) * s3);
}

__device__ __forceinline__ double pow_phi_dual(double z1, double z2,
                                               double a) {
  return exp(nslog(z1 / a) * (2.0 * a) + nslog(z2 / (1.0 - a)) * (2.0 - 2.0 * a));
}

__device__ bool pow_feas_dual(const double* Z, double a) {
  const double res = pow_phi_dual(Z[0], Z[1], a) - Z[2] * Z[2];
  return Z[0] > 0 && Z[1] > 0 && res > 0;
}

__device__ bool pow_feas_primal(const double* S, double a) {
  const double res =
      exp(nslog(S[0]) * (2.0 * a) + nslog(S[1]) * (2.0 - 2.0 * a)) - S[2] * S[2];
  return S[0] > 0 && S[1] > 0 && res > 0;
}

// reference: coneops_powcone.jl:408-440
__device__ void pow_grad_hess_dual(const double* Z, double a, double* g,
                                   double* H) {
  const double z1 = Z[0], z2 = Z[1], z3 = Z[2];
  const double phi = pow_phi_dual(z1, z2, a);
  const double ipsi = 1.0 / (phi - z3 * z3);
  const double g1p = phi * ipsi * (2.0 * a) / z1;
  const double g2p = phi * ipsi * (2.0 - 2.0 * a) / z2;
  const double g3p = z3 * ipsi * (-2.0);
  H[0] = g1p * g1p - phi * ipsi * (2.0 * a * (2.0 * a - 1.0)) / (z1 * z1) +
         (1.0 - a) / (z1 * z1);
  H[1] = g1p * g2p - phi * ipsi * (4.0 * a * (1.0 - a)) / (z1 * z2);
  H[2] = g1p * g3p;
  H[3] = g2p * g2p -
         phi * ipsi * (2.0 * (1.0 - a) * (1.0 - 2.0 * a)) / (z2 * z2) +
         a / (z2 * z2);
  H[4] = g2p * g3p;
  H[5] = g3p * g3p + ipsi * 2.0;
  g[0] = -g1p - (1.0 - a) / z1;
  g[1] = -g2p - a / z2;
  g[2] = -g3p;
}

__device__ __forceinline__ double pow_t0(double a) {
  return -2.0 * a * log(a) - 2.0 * (1.0 - a) * log(1.0 - a);
}

// one-sided Newton-Raphson for |g3| of the pow primal gradient (reference
// _pow_nr32, l.986-1051, in float64); sets big and absf
__device__ double pow_nr(double s1, double s2, double s3, double a,
                         bool& big, double& absf) {
  const double phi = exp(2.0 * a * nslog(s1) + (2.0 - 2.0 * a) * nslog(s2));
  const double abs_s = fabs(s3);
  big = abs_s > EPS64;
  absf = big ? abs_s : 1.0;
  double den = phi - absf * absf;
  den = fabs(den) > 0 ? den : 1.0;
  double x = -1.0 / absf +
             (2.0 * absf + sqrt(nmax(phi * phi / (absf * absf) + 3.0 * phi,
                                     0.0))) / den;
  const double t0 = pow_t0(a);
  for (int k = 0; k < NR_TRIPS; ++k) {
    const double t1 = x * x, t2 = 2.0 * x / absf;
    const double f0 = 2.0 * a * nslog(2.0 * a * t1 + (1.0 + a) * t2) +
                      (2.0 - 2.0 * a) *
                          nslog((2.0 - 2.0 * a) * t1 + (2.0 - a) * t2) -
                      nslog(phi) - nslog(t1 + t2) - 2.0 * nslog(t2) + t0;
    const double d1 = 2.0 * a * a / (a * x + (1.0 + a) / absf) +
                      (2.0 - 2.0 * a) * (1.0 - a) /
                          ((1.0 - a) * x + (2.0 - a) / absf) -
                      2.0 * (x + 1.0 / absf) / (t1 + t2 != 0 ? t1 + t2 : 1.0);
    const double dx = -f0 / (d1 != 0 ? d1 : 1.0);
    const bool stop = dx < EPS64 ||
                      fabs(dx / (x != 0 ? x : 1.0)) < SQRT_EPS64 ||
                      fabs(d1) < EPS64;
    if (stop) break;
    x = x + dx;
  }
  return x;
}

__device__ void pow_grad_from(double x, bool big, const double* S, double a,
                              double* g) {
  const double g3 = big ? x * (S[2] < 0 ? -1.0 : 1.0) : 0.0;
  g[0] = big ? -(g3 * S[2] * a + (1.0 + a)) / S[0] : -(1.0 + a) / S[0];
  g[1] = big ? -(g3 * S[2] * (1.0 - a) + (2.0 - a)) / S[1]
             : -(2.0 - a) / S[1];
  g[2] = g3;
}

// reference: coneops_powcone.jl:288-316,449-478 (pow_grad_primal,
// l.1053-1096): the Newton iteration, then two Newton polish steps
__device__ void pow_grad_primal(const double* S, double a, double* g) {
  bool big;
  double absf;
  double x = pow_nr(S[0], S[1], S[2], a, big, absf);
  const double iabs = 1.0 / absf, t0 = pow_t0(a);
  for (int k = 0; k < 2; ++k) {
    const double t1 = x * x, t2 = x * iabs * 2.0;
    const double f0 = nslog(t1 * (2.0 * a) + t2 * (1.0 + a)) * (2.0 * a) +
                      nslog(t1 * (2.0 - 2.0 * a) + t2 * (2.0 - a)) *
                          (2.0 - 2.0 * a) -
                      (nslog(S[0]) * (2.0 * a) +
                       nslog(S[1]) * (2.0 - 2.0 * a)) -
                      nslog(t1 + t2) - nslog(t2) * 2.0 + t0;
    const double f1 = 1.0 / (x * a + iabs * (1.0 + a)) * (2.0 * a * a) +
                      1.0 / (x * (1.0 - a) + iabs * (2.0 - a)) *
                          ((2.0 - 2.0 * a) * (1.0 - a)) -
                      (x + iabs) * 2.0 *
                          (1.0 / (t1 + t2 != 0 ? t1 + t2 : 1.0));
    x = x - f0 / (f1 != 0 ? f1 : 1.0);
  }
  pow_grad_from(x, big, S, a, g);
}

// the primal-dual (BFGS) Hs, with the fallback to mu_local H_dual where it
// is not usable (reference pd_scaling_3d, l.1282-1334)
__device__ void pd_scaling_3d(const double* Hd, const double* st,
                              const double* zt, const double* S,
                              const double* Z, double* Hs) {
  const double dot_sz = dot3(S, Z);
  const double mu_l = dot_sz * (1.0 / 3.0);
  const double mut = dot3(zt, st) * (1.0 / 3.0);
  double dsv[3], dzv[3], Hzt[3], tmp[3];
  for (int i = 0; i < 3; ++i) {
    dsv[i] = S[i] + mu_l * st[i];
    dzv[i] = Z[i] + mu_l * zt[i];
  }
  const double dot_dsz = dot3(dsv, dzv);
  const double de1 = mu_l * mut - 1.0;
  hmul3(Hd, zt, Hzt);
  const double de2 = dot3(zt, Hzt) - mut * mut * 3.0;
  bool usable = fabs(de1) > SQRT_EPS64 && fabs(de2) > EPS64 && dot_sz > 0 &&
                dot_dsz > 0;
  const double ide2 = 1.0 / (de2 != 0 ? de2 : 1.0);
  for (int i = 0; i < 3; ++i) tmp[i] = mut * st[i] - Hzt[i];
  const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
  double w[6];
  for (int k = 0; k < 6; ++k)
    w[k] = Hd[k] - st[I[k]] * st[J[k]] * (1.0 / 3.0) -
           tmp[I[k]] * tmp[J[k]] * ide2;
  const double frob = w[0] * w[0] + w[3] * w[3] + w[5] * w[5] +
                      (w[1] * w[1] + w[2] * w[2] + w[4] * w[4]) * 2.0;
  const double t = mu_l * sqrt(nmax(frob, 0.0));
  double ax[3] = {Z[1] * zt[2] - Z[2] * zt[1], Z[2] * zt[0] - Z[0] * zt[2],
                  Z[0] * zt[1] - Z[1] * zt[0]};
  const double axn = sqrt(nmax(dot3(ax, ax), 0.0));
  const double iaxn = 1.0 / (axn > 0 ? axn : 1.0);
  for (int i = 0; i < 3; ++i) ax[i] = ax[i] * iaxn;
  const double isz = 1.0 / (dot_sz != 0 ? dot_sz : 1.0);
  const double idsz = 1.0 / (dot_dsz != 0 ? dot_dsz : 1.0);
  double pd[6];
  for (int k = 0; k < 6; ++k) {
    pd[k] = S[I[k]] * S[J[k]] * isz + dsv[I[k]] * dsv[J[k]] * idsz +
            t * ax[I[k]] * ax[J[k]];
    usable = usable && isfinite(pd[k]);
  }
  for (int k = 0; k < 6; ++k) Hs[k] = usable ? pd[k] : Hd[k] * mu_l;
}

// H_dual^{-1} b, or 0 where the factor breaks down or the result is not
// finite (reference _hd_solve_guarded, l.2464)
__device__ void hd_solve_guarded(const double* Hd, const double* b,
                                 double* u) {
  double F[6];
  const bool okc = chol3_fac(Hd, F);
  chol3_solve_fac(F, b, u);
  const bool fin = okc && isfinite(u[0]) && isfinite(u[1]) && isfinite(u[2]);
  for (int i = 0; i < 3; ++i) u[i] = fin ? u[i] : 0.0;
}

__device__ void finite_or_zero3(double* eta, bool ok) {
  const bool fin = ok && isfinite(eta[0]) && isfinite(eta[1]) &&
                   isfinite(eta[2]);
  for (int i = 0; i < 3; ++i) eta[i] = fin ? eta[i] : 0.0;
}

// third-order correction (reference exp_higher_corr, l.2493)
__device__ void exp_higher_corr(const double* Hd, const double* Zc,
                                const double* ds3, const double* v3,
                                double* eta) {
  double u[3];
  hd_solve_guarded(Hd, ds3, u);
  const double z1 = Zc[0], z2 = Zc[1], z3 = Zc[2];
  const double gpsi3 = -z1 / z3;
  const double gpsi1 = nslog(gpsi3);
  double psi = z1 * gpsi1 - z1 + z2;
  const bool psi_ok = psi > 1e-9 * (fabs(z1 * gpsi1) + fabs(z1) + fabs(z2));
  psi = psi_ok ? psi : 1.0;
  const double gpsi[3] = {gpsi1, 1.0, gpsi3};
  const double dpu = dot3(gpsi, u), dpv = dot3(gpsi, v3);
  const double ipsi = 1.0 / psi, ipsi2 = ipsi * ipsi;
  const double iz1 = 1.0 / z1, iz3 = 1.0 / z3;
  const double coef = ((u[0] * (v3[0] * iz1 - v3[2] * iz3) +
                        u[2] * (z1 * v3[2] * iz3 - v3[0]) * iz3) * psi -
                       dpu * dpv * 2.0) * (ipsi2 * ipsi);
  const double e0 = gpsi[0] * coef, e1 = gpsi[1] * coef, e2 = gpsi[2] * coef;
  const double eta0 =
      e0 + ((ipsi - iz1 * 2.0) * u[0] * v3[0] * (iz1 * iz1) -
            u[2] * v3[2] * (iz3 * iz3) * ipsi +
            dpu * ipsi2 * (v3[0] * iz1 - v3[2] * iz3) +
            dpv * ipsi2 * (u[0] * iz1 - u[2] * iz3));
  const double eta2 =
      e2 + ((z1 * ipsi - 1.0) * u[2] * v3[2] * (iz3 * iz3 * iz3) * 2.0 -
            (u[2] * v3[0] + u[0] * v3[2]) * (iz3 * iz3) * ipsi +
            dpu * ipsi2 * (z1 * v3[2] * (iz3 * iz3) - v3[0] * iz3) +
            dpv * ipsi2 * (z1 * u[2] * (iz3 * iz3) - u[0] * iz3));
  eta[0] = eta0 * 0.5;
  eta[1] = e1 * 0.5;
  eta[2] = eta2 * 0.5;
  finite_or_zero3(eta, psi_ok);
}

// third-order correction (reference pow_higher_corr, l.2535)
__device__ void pow_higher_corr(const double* Hd, const double* Zc,
                                double a, const double* ds3,
                                const double* v3, double* eta) {
  double u[3];
  hd_solve_guarded(Hd, ds3, u);
  const double z1 = Zc[0], z2 = Zc[1], z3 = Zc[2];
  const double phi = pow_phi_dual(z1, z2, a);
  double psi = phi - z3 * z3;
  const bool psi_ok = psi > 1e-9 * (phi + z3 * z3);
  psi = psi_ok ? psi : 1.0;
  const double iz1 = 1.0 / z1, iz2 = 1.0 / z2;
  const double gpsi[3] = {phi * iz1 * (2.0 * a), phi * iz2 * (2.0 - 2.0 * a),
                          z3 * (-2.0)};
  const double Hp11 = phi * (iz1 * iz1) * (2.0 * a * (2.0 * a - 1.0));
  const double Hp12 = phi * (iz1 * iz2) * (4.0 * a * (1.0 - a));
  const double Hp22 = phi * (iz2 * iz2) * (2.0 * (1.0 - a) * (1.0 - 2.0 * a));
  const double dpu = dot3(gpsi, u), dpv = dot3(gpsi, v3);
  const double Hv[3] = {Hp11 * v3[0] + Hp12 * v3[1],
                        Hp12 * v3[0] + Hp22 * v3[1], v3[2] * (-2.0)};
  const double uHv = u[0] * Hv[0] + u[1] * Hv[1] + u[2] * Hv[2];
  const double ipsi = 1.0 / psi, ipsi2 = ipsi * ipsi;
  const double coef = (uHv * psi - dpu * dpv * 2.0) * (ipsi2 * ipsi);
  const double coef2 = phi * (u[0] * iz1 - u[1] * iz2) *
                       (v3[0] * iz1 - v3[1] * iz2) * ipsi *
                       (4.0 * a * (2.0 * a - 1.0) * (1.0 - a));
  const double e1 = coef * gpsi[0] -
                    u[0] * v3[0] * (iz1 * iz1 * iz1) * (2.0 * (1.0 - a)) +
                    coef2 * iz1 + Hv[0] * dpu * ipsi2;
  const double e2 = coef * gpsi[1] -
                    u[1] * v3[1] * (iz2 * iz2 * iz2) * (2.0 * a) -
                    coef2 * iz2 + Hv[1] * dpu * ipsi2;
  const double e3 = coef * gpsi[2] + Hv[2] * dpu * ipsi2;
  const double Hu[3] = {Hp11 * u[0] + Hp12 * u[1], Hp12 * u[0] + Hp22 * u[1],
                        u[2] * (-2.0)};
  eta[0] = (e1 + Hu[0] * dpv * ipsi2) * 0.5;
  eta[1] = (e2 + Hu[1] * dpv * ipsi2) * 0.5;
  eta[2] = (e3 + Hu[2] * dpv * ipsi2) * 0.5;
  finite_or_zero3(eta, psi_ok);
}

// f*(z) + f(s) of one segment, BIG where infeasible (reference
// _nonsym_barrier32, l.2271-2324, in float64)
__device__ double nonsym_barrier(int kind, double a, const double* Z,
                                 const double* S) {
  const double z1 = Z[0], z2 = Z[1], z3 = Z[2];
  const double s1 = S[0], s2 = S[1], s3 = S[2];
  double bd, bp;
  bool dfeas, pfeas;
  if (kind == SEG_EXP) {
    const double l = nslog(-z3 / (z1 != 0 ? z1 : -1.0));
    bd = -nslog(-z3 * z1) - nslog(z2 - z1 - z1 * l);
    dfeas = z3 > 0 && z1 < 0 && z2 - z1 - z1 * l > 0;
    const double s2s = s2 > 0 ? s2 : 1.0, s3s = s3 > 0 ? s3 : 1.0;
    const double arg = 1.0 - s1 / s2s - nslog(s2s / s3s);
    const double w = wright_omega(nmax(arg, 0.0));
    const double wm = (w - 1.0) * (w - 1.0) / (w != 0 ? w : 1.0);
    bp = -nslog(wm) - 2.0 * nslog(s2) - nslog(s3) - 3.0;
    pfeas = s3 > 0 && s2 > 0 && s2 * nslog(s3 / s2s) - s1 > 0;
  } else {
    const double resd = pow_phi_dual(z1, z2, a) - z3 * z3;
    bd = -nslog(resd) - (1.0 - a) * nslog(z1) - a * nslog(z2);
    dfeas = z1 > 0 && z2 > 0 && resd > 0;
    bool big;
    double absf, g[3];
    const double x = pow_nr(s1, s2, s3, a, big, absf);
    pow_grad_from(x, big, S, a, g);
    const double phig = pow_phi_dual(-g[0], -g[1], a);
    bp = nslog(phig - g[2] * g[2]) + (1.0 - a) * nslog(-g[0]) +
         a * nslog(-g[1]) - 3.0;
    pfeas = pow_feas_primal(S, a);
  }
  return (dfeas ? bd : BIG) + (pfeas ? bp : BIG);
}
#endif  // MK_NONSYM

#if MK_PSD
// ---- PSD-triangle cones of side <= 3 (K1d; the plain version's helpers
// in megakernel_ref.py, formula for formula).  A side-np matrix is a
// row-major 3x3 array, M[i * 3 + j]; svec rows follow the column-stacked
// upper triangle with the off-diagonals times sqrt(2). ----

__device__ __forceinline__ int psd_side(int width) {
  return width == 1 ? 1 : (width == 3 ? 2 : 3);
}

template <typename R>
__device__ void psd_unpack(const R* v, int np, R* Mt) {
  for (int j = 0; j < np; ++j)
    for (int i = 0; i <= j; ++i) {
      const R e = v[j * (j + 1) / 2 + i];
      if (i == j) {
        Mt[i * 3 + j] = e;
      } else {
        Mt[i * 3 + j] = e * R(ISR2);
        Mt[j * 3 + i] = e * R(ISR2);
      }
    }
}

template <typename R>
__device__ void psd_pack(const R* Mt, int np, R* v) {
  for (int j = 0; j < np; ++j)
    for (int i = 0; i <= j; ++i)
      v[j * (j + 1) / 2 + i] = i == j ? Mt[i * 3 + j] : Mt[i * 3 + j] * R(SR2);
}

// C = A B (C must not alias A or B)
template <typename R>
__device__ void mat_mm(const R* A, const R* Bm, int np, R* C) {
  for (int i = 0; i < np; ++i)
    for (int j = 0; j < np; ++j) {
      R acc = A[i * 3] * Bm[j];
      for (int k = 1; k < np; ++k) acc = acc + A[i * 3 + k] * Bm[k * 3 + j];
      C[i * 3 + j] = acc;
    }
}

template <typename R>
__device__ void mat_T(const R* A, int np, R* T) {
  for (int i = 0; i < np; ++i)
    for (int j = 0; j < np; ++j) T[i * 3 + j] = A[j * 3 + i];
}

// Y = X' A X (tr = false) or X A X' (tr = true)
template <typename R>
__device__ void mat_sandwich(const R* X, const R* A, int np, bool tr, R* Y) {
  R Xt[9], T1[9];
  mat_T(X, np, Xt);
  if (tr) {
    mat_mm(X, A, np, T1);
    mat_mm(T1, Xt, np, Y);
  } else {
    mat_mm(Xt, A, np, T1);
    mat_mm(T1, X, np, Y);
  }
}

// lower Cholesky with clamped pivots (a pivot that is not positive
// becomes 1; reference mat_chol, l.683)
template <typename R>
__device__ void mat_chol(const R* Mt, int np, R* L) {
  for (int k = 0; k < 9; ++k) L[k] = R(0);
  for (int j = 0; j < np; ++j) {
    R acc = Mt[j * 3 + j];
    for (int k = 0; k < j; ++k) acc = acc - L[j * 3 + k] * L[j * 3 + k];
    R d = msqrt(nmax(acc, R(0)));
    d = d > 0 ? d : R(1);
    L[j * 3 + j] = d;
    const R idj = R(1) / d;
    for (int i = j + 1; i < np; ++i) {
      R a2 = Mt[i * 3 + j];
      for (int k = 0; k < j; ++k) a2 = a2 - L[i * 3 + k] * L[j * 3 + k];
      L[i * 3 + j] = a2 * idj;
    }
  }
}

// one-sided (Hestenes) Jacobi SVD, A = U diag(sig) V' (reference
// jacobi_svd, l.707): a column pair rotates while |a_p . a_q| > eps
// |a_p| |a_q|, eps the unit roundoff of R; sweeps run until no pair
// rotates, at most `sweeps`
template <typename R>
__device__ void jacobi_svd(const R* A, int np, int sweeps, R* sig, R* U,
                           R* V) {
  for (int k = 0; k < 9; ++k) V[k] = R(0);
  if (np == 1) {
    R s0 = mabs(A[0]);
    sig[0] = s0 > 0 ? s0 : R(1);
    U[0] = A[0] >= 0 ? R(1) : R(-1);
    V[0] = R(1);
    return;
  }
  R Ac[9];
  for (int k = 0; k < 9; ++k) Ac[k] = A[k];
  for (int i = 0; i < np; ++i) V[i * 3 + i] = R(1);
  for (int sw = 0; sw < sweeps; ++sw) {
    bool rotated = false;
    for (int q = 1; q < np; ++q)
      for (int p = 0; p < q; ++p) {
        R al = Ac[p] * Ac[p], be = Ac[q] * Ac[q], ga = Ac[p] * Ac[q];
        for (int i = 1; i < np; ++i) {
          al = al + Ac[i * 3 + p] * Ac[i * 3 + p];
          be = be + Ac[i * 3 + q] * Ac[i * 3 + q];
          ga = ga + Ac[i * 3 + p] * Ac[i * 3 + q];
        }
        if (!(mabs(ga) > Eps<R>::v * msqrt(al * be))) continue;
        rotated = true;
        const R zeta = (be - al) / (ga * R(2));
        const R sgn = zeta >= 0 ? R(1) : R(-1);
        const R t = sgn / (mabs(zeta) + msqrt(zeta * zeta + R(1)));
        const R c = R(1) / msqrt(t * t + R(1));
        const R s_ = t * c;
        for (int i = 0; i < np; ++i) {
          const R aip = Ac[i * 3 + p], aiq = Ac[i * 3 + q];
          Ac[i * 3 + p] = c * aip - s_ * aiq;
          Ac[i * 3 + q] = s_ * aip + c * aiq;
          const R vip = V[i * 3 + p], viq = V[i * 3 + q];
          V[i * 3 + p] = c * vip - s_ * viq;
          V[i * 3 + q] = s_ * vip + c * viq;
        }
      }
    if (!rotated) break;
  }
  for (int j = 0; j < np; ++j) {
    R acc = Ac[j] * Ac[j];
    for (int i = 1; i < np; ++i) acc = acc + Ac[i * 3 + j] * Ac[i * 3 + j];
    const R sj = msqrt(acc);
    const R sjc = sj > 0 ? sj : R(1);
    sig[j] = sjc;
    for (int i = 0; i < np; ++i) U[i * 3 + j] = Ac[i * 3 + j] / sjc;
  }
}

// all eigenvalues (in no order) of a symmetric matrix of side <= 3
// (reference psd_eigvals32, l.767, in R): side 2 in closed form, side 3 by
// values-only cyclic Jacobi, a pair rotating while |a_pq| > eps
// sqrt(|a_pp a_qq|), until no pair rotates, at most `sweeps`
template <typename R>
__device__ void psd_eigvals(const R* Mt, int np, int sweeps, R* e) {
  if (np == 1) {
    e[0] = Mt[0];
    return;
  }
  if (np == 2) {
    const R a = Mt[0], b = Mt[1], d = Mt[4];
    const R mid = R(0.5) * (a + d);
    const R h = R(0.5) * (a - d);
    const R rad = msqrt(h * h + b * b);
    e[0] = mid - rad;
    e[1] = mid + rad;
    return;
  }
  R A[9];
  for (int k = 0; k < 9; ++k) A[k] = Mt[k];
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  for (int sw = 0; sw < sweeps; ++sw) {
    bool rotated = false;
    for (int r0 = 0; r0 < 3; ++r0) {
      const int p = P[r0], q = Q[r0];
      const R apq = A[p * 3 + q];
      const R app = A[p * 3 + p], aqq = A[q * 3 + q];
      if (!(mabs(apq) > Eps<R>::v * msqrt(mabs(app * aqq)))) continue;
      rotated = true;
      const R theta = (aqq - app) / (R(2) * apq);
      const R sg = theta > 0 ? R(1) : (theta < 0 ? R(-1) : R(0));
      R t = sg / (mabs(theta) + msqrt(theta * theta + R(1)));
      t = theta == 0 ? R(1) : t;
      const R c = R(1) / msqrt(t * t + R(1));
      const R s_ = t * c;
      A[p * 3 + p] = c * c * app - R(2) * c * s_ * apq + s_ * s_ * aqq;
      A[q * 3 + q] = s_ * s_ * app + R(2) * c * s_ * apq + c * c * aqq;
      A[p * 3 + q] = R(0);
      A[q * 3 + p] = R(0);
      const int r = 3 - p - q;
      const R arp = A[r * 3 + p], arq = A[r * 3 + q];
      A[r * 3 + p] = c * arp - s_ * arq;
      A[p * 3 + r] = A[r * 3 + p];
      A[r * 3 + q] = s_ * arp + c * arq;
      A[q * 3 + r] = A[r * 3 + q];
    }
    if (!rotated) break;
  }
  e[0] = A[0];
  e[1] = A[4];
  e[2] = A[8];
}

// logdet through the Cholesky factor; ok is false outside the positive
// definite cone (reference psd_logdet32, l.814, in float64)
__device__ double psd_logdet(const double* Mt, int np, bool& ok) {
  double L[9], val = 0.0;
  ok = true;
  for (int j = 0; j < np; ++j) {
    double acc = Mt[j * 3 + j];
    for (int k = 0; k < j; ++k) acc = acc - L[j * 3 + k] * L[j * 3 + k];
    ok = ok && acc > 0;
    const double dj = sqrt(nmax(acc, 0.0));
    const double djs = dj > 0 ? dj : 1.0;
    val = val + 2.0 * log(djs);
    for (int i = j + 1; i < np; ++i) {
      double a2 = Mt[i * 3 + j];
      for (int k = 0; k < j; ++k) a2 = a2 - L[i * 3 + k] * L[j * 3 + k];
      L[i * 3 + j] = a2 / djs;
    }
    L[j * 3 + j] = djs;
  }
  return val;
}

// NT scaling of one segment: clamped, non-fatal chol of S and Z, the
// Jacobi SVD of L2'L1 = U diag(lam) V', R = L1 V lam^{-1/2}, Rinv =
// lam^{-1/2} U' L2' (reference l.1418-1451); returns whether R and Rinv
// are finite
template <typename R>
__device__ bool psd_scaling(const R* sg, const R* zg, int np, int sweeps,
                            R* Rm, R* Ri, R* lam) {
  R Sm[9], Zm[9], L1[9], L2[9], L2t[9], Am[9], U[9], V[9];
  psd_unpack(sg, np, Sm);
  psd_unpack(zg, np, Zm);
  mat_chol(Sm, np, L1);
  mat_chol(Zm, np, L2);
  mat_T(L2, np, L2t);
  mat_mm(L2t, L1, np, Am);
  jacobi_svd(Am, np, sweeps, lam, U, V);
  R lis[3], L1V[9], Ut[9], UtL2t[9];
  for (int j = 0; j < np; ++j) lis[j] = R(1) / msqrt(lam[j]);
  mat_mm(L1, V, np, L1V);
  mat_T(U, np, Ut);
  mat_mm(Ut, L2t, np, UtL2t);
  bool fin = true;
  for (int i = 0; i < np; ++i)
    for (int j = 0; j < np; ++j) {
      Rm[i * 3 + j] = L1V[i * 3 + j] * lis[j];
      Ri[i * 3 + j] = UtL2t[i * 3 + j] * lis[i];
      fin = fin && isfinite(Rm[i * 3 + j]) && isfinite(Ri[i * 3 + j]);
    }
  return fin;
}

// the largest step along d of one segment, from the least eigenvalue of
// lam^{-1/2} (W d) lam^{-1/2}, W d = R' D R (tr = false) or R D R'
// (reference l.2104-2150, in R)
template <typename R>
__device__ R psd_step_comp(const R* dg, const R* Rx, const R* lam, int np,
                           int sweeps, bool tr) {
  R D[9], Mt[9], Ms[9], li[3], e[3];
  for (int j = 0; j < np; ++j) li[j] = R(1) / msqrt(nmax(lam[j], R(TINY32)));
  psd_unpack(dg, np, D);
  mat_sandwich(Rx, D, np, tr, Mt);
  for (int i = 0; i < np; ++i)
    for (int j = 0; j < np; ++j)
      Ms[i * 3 + j] = R(0.5) * (Mt[i * 3 + j] + Mt[j * 3 + i]) * li[i] * li[j];
  psd_eigvals(Ms, np, sweeps, e);
  R gmin = e[0];
  for (int j = 1; j < np; ++j) gmin = nmin(gmin, e[j]);
  return gmin < 0 ? R(1) / nmax(-gmin, R(1e-30)) : R(BIG);
}
#endif  // MK_PSD

#if MK_GENPOW
// ---- generalized power cones (K1c; the plain version's helpers in
// megakernel_ref.py).  A segment of width w = d1 + d2 <= GPW; al holds
// its d1 exponents. ----

__device__ double gp_phi_dual(const double* U, const double* al, int d1) {
  double acc = nslog(U[0] / al[0]) * (2.0 * al[0]);
  for (int j = 1; j < d1; ++j) acc = acc + nslog(U[j] / al[j]) * (2.0 * al[j]);
  return exp(acc);
}

__device__ bool gp_feas_dual(const double* W, const double* al, int d1,
                             int w) {
  bool ok = true;
  for (int j = 0; j < d1; ++j) ok = ok && W[j] > 0;
  double res = gp_phi_dual(W, al, d1);
  for (int k = d1; k < w; ++k) res = res - W[k] * W[k];
  return ok && res > 0;
}

__device__ bool gp_feas_primal(const double* W, const double* al, int d1,
                               int w) {
  bool ok = true;
  double acc = 0.0;
  for (int j = 0; j < d1; ++j) {
    ok = ok && W[j] > 0;
    const double t = nslog(W[j]) * (2.0 * al[j]);
    acc = j == 0 ? t : acc + t;
  }
  double res = exp(acc);
  for (int k = d1; k < w; ++k) res = res - W[k] * W[k];
  return ok && res > 0;
}

// dual gradient and the rank-3 Hs data into the per-row arrays of sc
// (q on the head rows, r on the tail rows); returns whether the dual
// point is feasible and the data finite (reference genpow_state, l.1130)
__device__ bool gp_state(const double* Z, const double* al, int d1, int w,
                         int lo, Scale& sc) {
  const double phi = gp_phi_dual(Z, al, d1);
  double norm2w = 0.0;
  for (int k = d1; k < w; ++k) norm2w = norm2w + Z[k] * Z[k];
  const double zeta = phi - norm2w;
  bool ok = zeta > 0;
  for (int j = 0; j < d1; ++j) ok = ok && Z[j] > 0;
  const double zs = zeta > 0 ? zeta : 1.0;
  const double izeta = 1.0 / zs;
  const double phiz = phi * izeta;
  double p0 = sqrt(nmax(phi * (phi + norm2w) * 0.5, 0.0));
  const double p0s = p0 > 0 ? p0 : 1.0;
  const double p1 = -(phi * 2.0) / p0s;
  const double q0 = sqrt(nmax(zs * phi * 0.5, 0.0));
  const double r1 = sqrt(nmax((zs / (phi + norm2w)) * 4.0, 0.0));
  for (int j = 0; j < d1; ++j) {
    const double tau = (1.0 / Z[j]) * (2.0 * al[j]);
    sc.gp_g[lo + j] = -tau * phiz - (1.0 - al[j]) / Z[j];
    sc.gp_dd[lo + j] = tau * phiz / Z[j] + (1.0 - al[j]) / (Z[j] * Z[j]);
    sc.gp_p[lo + j] = p0 * tau * izeta;
    sc.gp_qr[lo + j] = tau * q0 * izeta;
  }
  for (int k = d1; k < w; ++k) {
    sc.gp_g[lo + k] = Z[k] * (izeta * 2.0);
    sc.gp_dd[lo + k] = izeta * 2.0;
    sc.gp_p[lo + k] = p1 * Z[k] * izeta;
    sc.gp_qr[lo + k] = r1 * Z[k] * izeta;
  }
  for (int j = 0; j < w; ++j)
    ok = ok && isfinite(sc.gp_g[lo + j]) && isfinite(sc.gp_dd[lo + j]) &&
         isfinite(sc.gp_p[lo + j]) && isfinite(sc.gp_qr[lo + j]);
  return ok;
}

// mu (D v + p (p'v) - [q (q'v_head); 0] - [0; r (r'v_tail)])
__device__ void gp_hs_apply(const Scale& sc, int lo, int d1, int w,
                            const double* v, double* out) {
  const double* dd = sc.gp_dd + lo;
  const double* p = sc.gp_p + lo;
  const double* qr = sc.gp_qr + lo;
  double cp = p[0] * v[0], cq = qr[0] * v[0], cr = 0.0;
  for (int j = 1; j < w; ++j) cp = cp + p[j] * v[j];
  for (int j = 1; j < d1; ++j) cq = cq + qr[j] * v[j];
  for (int k = d1; k < w; ++k) cr = k == d1 ? qr[k] * v[k] : cr + qr[k] * v[k];
  for (int j = 0; j < w; ++j) {
    double y = dd[j] * v[j] + p[j] * cp;
    y = j < d1 ? y - qr[j] * cq : y - qr[j] * cr;
    out[j] = y * sc.gp_mu;
  }
}

// the k-th rank-1 vector of Hs/mu = D + pp' - qq' - rr' (k = 0, 1, 2:
// p, [q; 0], [0; r]) at row j
__device__ __forceinline__ double gp_u(const Scale& sc, int lo, int d1,
                                       int k, int j) {
  if (k == 0) return sc.gp_p[lo + j];
  if (k == 1) return j < d1 ? sc.gp_qr[lo + j] : 0.0;
  return j < d1 ? 0.0 : sc.gp_qr[lo + j];
}

// (mu H)^{-1} v by three Sherman-Morrison rank-1 updates on the diagonal
// base (reference genpow_hinv_apply, l.1199): y0 = v / D, y_k = y_{k-1} -
// A_k u_k (u_k' y_{k-1}) sgn_k / (1 + sgn_k u_k' A_k u_k), A_k u_k the
// (k-1)-th inverse applied to u_k
__device__ void gp_hinv_apply(const Scale& sc, int lo, int d1, int w,
                              const double* v, double* out) {
  const double sgn[3] = {1.0, -1.0, -1.0};
  double idd[GPW], Au[3][GPW], idn[3], y[GPW];
  for (int j = 0; j < w; ++j) idd[j] = 1.0 / sc.gp_dd[lo + j];
  for (int k = 0; k <= 3; ++k) {
    // the base inverse of u_k (of v for k = 3), then the k earlier updates
    for (int j = 0; j < w; ++j)
      y[j] = (k < 3 ? gp_u(sc, lo, d1, k, j) : v[j]) * idd[j];
    for (int u = 0; u < k; ++u) {
      double acc = gp_u(sc, lo, d1, u, 0) * y[0];
      for (int j = 1; j < w; ++j) acc = acc + gp_u(sc, lo, d1, u, j) * y[j];
      const double coef = acc * idn[u] * sgn[u];
      for (int j = 0; j < w; ++j) y[j] = y[j] - Au[u][j] * coef;
    }
    if (k == 3) break;
    double acc = gp_u(sc, lo, d1, k, 0) * y[0];
    for (int j = 1; j < w; ++j) acc = acc + gp_u(sc, lo, d1, k, j) * y[j];
    double denom = acc * sgn[k] + 1.0;
    denom = denom != 0 ? denom : 1.0;
    idn[k] = 1.0 / denom;
    for (int j = 0; j < w; ++j) Au[k][j] = y[j];
  }
  const double imu = 1.0 / sc.gp_mu;
  for (int j = 0; j < w; ++j) out[j] = y[j] * imu;
}

// f*(z) + f(s) of one segment, BIG where infeasible (reference
// _genpow_barrier32, l.2326, in float64): the primal barrier through a
// one-sided Newton gradient (at most NR_TRIPS steps) and the dual barrier
// of -g
__device__ double gp_barrier(const double* al, int d1, int w,
                             const double* Z, const double* Sv) {
  double n2z = 0.0;
  for (int k = d1; k < w; ++k) n2z = n2z + Z[k] * Z[k];
  const double resd = gp_phi_dual(Z, al, d1) - n2z;
  double bd = -nslog(resd);
  bool dfeas = resd > 0;
  for (int j = 0; j < d1; ++j) {
    bd = bd - (1.0 - al[j]) * nslog(Z[j]);
    dfeas = dfeas && Z[j] > 0;
  }
  double lphi = 0.0, n2r = 0.0, psi_c = 0.0;
  for (int j = 0; j < d1; ++j) {
    lphi = lphi + 2.0 * al[j] * nslog(Sv[j]);
    psi_c = psi_c + al[j] * al[j];
  }
  psi_c = 1.0 / psi_c;
  for (int k = d1; k < w; ++k) n2r = n2r + Sv[k] * Sv[k];
  const double phi = exp(lphi);
  const double norm_r = sqrt(nmax(n2r, 0.0));
  const bool big = norm_r > EPS64;
  const double nr = big ? norm_r : 1.0;
  const double den0 = fabs(phi - nr * nr) > 0 ? phi - nr * nr : 1.0;
  double x = -1.0 / nr +
             (psi_c * nr +
              sqrt(nmax((phi / (nr * nr) + psi_c * psi_c - 1.0) * phi, 0.0))) /
                 den0;
  for (int it = 0; it < NR_TRIPS; ++it) {
    double f0 = -nslog(2.0 * x / nr + x * x);
    const double t1 = x * x, t2 = 2.0 * x / nr;
    double f1 = -(2.0 * x + 2.0 / nr) / (t1 + t2 != 0 ? t1 + t2 : 1.0);
    for (int j = 0; j < d1; ++j) {
      const double a = al[j];
      f0 = f0 + 2.0 * a * (nslog(x * nr + (1.0 + a) / a) - nslog(Sv[j]));
      f1 = f1 + 2.0 * a * nr / (nr * x + (1.0 + a) / a);
    }
    const double dx = -f0 / (f1 != 0 ? f1 : 1.0);
    const bool stop = dx < EPS64 ||
                      fabs(dx / (x != 0 ? x : 1.0)) < SQRT_EPS64 ||
                      fabs(f1) < EPS64;
    if (stop) break;
    x = x + dx;
  }
  // the primal barrier is -f*(-g) - (d1 + 1)
  double ng[GPW], n2g = 0.0;
  for (int j = 0; j < d1; ++j)
    ng[j] = big ? (1.0 + al[j] + al[j] * x * norm_r) / Sv[j]
                : (1.0 + al[j]) / Sv[j];
  for (int k = d1; k < w; ++k) {
    const double gr = big ? x * Sv[k] / nr : 0.0;
    n2g = n2g + gr * gr;
  }
  double bdg = -nslog(gp_phi_dual(ng, al, d1) - n2g);
  for (int j = 0; j < d1; ++j) bdg = bdg - (1.0 - al[j]) * nslog(ng[j]);
  const double bp = -bdg - (d1 + 1.0);
  bool pfeas = phi - n2r > 0;
  for (int j = 0; j < d1; ++j) pfeas = pfeas && Sv[j] > 0;
  return (dfeas ? bd : BIG) + (pfeas ? bp : BIG);
}
#endif  // MK_GENPOW

// ---- cone scaling (reference make_scaling, l.1355-1510); mu and strat
// choose the exp/pow Hs (Dual: mu H_dual; PrimalDual: the BFGS form) ----
template <typename R>
__device__ bool make_scaling(const CtxT<R>& cx, const R* s, const R* z,
                             R mu, int strat, ScaleT<R>& sc) {
  bool ok = true;
  sc.ident = false;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) continue;
#if MK_PSD
    if (kind == SEG_PSD) {
      // a breakdown of the chol factors is not fatal; non-finite R or
      // Rinv is (reference l.1418-1451)
      ok = psd_scaling(s + lo, z + lo, psd_side(hi - lo), cx.p.psd_sweeps,
                       sc.psd_R[g], sc.psd_Ri[g], sc.psd_lam[g]) && ok;
      continue;
    }
#endif
#if MK_GENPOW
    if (kind == SEG_GENPOW) {
      const int d1 = cx.p.gp_d1[g], w = hi - lo;
      sc.gp_mu = mu;
      const bool okg = gp_state(z + lo, cx.p.gp_alpha[g], d1, w, lo, sc);
      ok = ok && okg && gp_feas_primal(s + lo, cx.p.gp_alpha[g], d1, w);
      continue;
    }
#endif
#if MK_NONSYM
    if (kind == SEG_EXP || kind == SEG_POW) {
      const double a = cx.p.seg_alpha[g];
      const double S3[3] = {s[lo], s[lo + 1], s[lo + 2]};
      const double Z3[3] = {z[lo], z[lo + 1], z[lo + 2]};
      double zt[3], pd[6];
      bool feas;
      if (kind == SEG_EXP) {
        feas = exp_feas_dual(Z3) && exp_feas_primal(S3);
        exp_grad_hess_dual(Z3, sc.ns_g[g], sc.ns_Hd[g]);
        exp_grad_primal(S3, zt);
      } else {
        feas = pow_feas_dual(Z3, a) && pow_feas_primal(S3, a);
        pow_grad_hess_dual(Z3, a, sc.ns_g[g], sc.ns_Hd[g]);
        pow_grad_primal(S3, a, zt);
      }
      pd_scaling_3d(sc.ns_Hd[g], sc.ns_g[g], zt, S3, Z3, pd);
      bool fin = true;
      for (int k = 0; k < 6; ++k) {
        const double h = strat == PRIMAL_DUAL ? pd[k] : sc.ns_Hd[g][k] * mu;
        sc.ns_Hs[g][k] = h;
        fin = fin && isfinite(h);
      }
      ok = ok && feas && fin;
      // a breakdown of the 3x3 factor is not fatal (reference l.1397-1414)
      chol3_fac(sc.ns_Hs[g], sc.ns_F[g]);
      for (int k = 0; k < 3; ++k) sc.ns_z[g][k] = Z3[k];
      continue;
    }
#endif
    if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) {
        R prod = s[i] * z[i];
        ok = ok && (prod > 0);
        prod = nmax(prod, R(0));
        const R zsafe = z[i] != 0 ? z[i] : R(1);
        const R ratio = z[i] != 0 ? s[i] / zsafe : R(0);
        const R w = msqrt(nmax(ratio, R(0)));
        const R w2 = w * w;
        sc.w[i] = w2;
        sc.winv2[i] = R(1) / w2;
        sc.lam[i] = msqrt(prod);
      }
      continue;
    }
    const int len = hi - lo;
    const R* sg = s + lo;
    const R* zg = z + lo;
    R* w = sc.w + lo;
    R* lam = sc.lam + lo;
    const R zscale = soc_res_sqrt(zg, len);
    const R sscale = soc_res_sqrt(sg, len);
    bool okg = (zscale > 0) && (sscale > 0);
    const R zs = zscale > 0 ? zscale : R(1);
    const R ss = sscale > 0 ? sscale : R(1);
    const R zsinv = R(1) / zs, ssinv = R(1) / ss;
    const R eta = msqrt(ss * zsinv);
    w[0] = sg[0] * ssinv + zg[0] * zsinv;
    for (int i = 1; i < len; ++i) w[i] = sg[i] * ssinv - zg[i] * zsinv;
    const R wscale = soc_res_sqrt(w, len);
    okg = okg && (wscale > 0);
    const R ws = wscale > 0 ? wscale : R(1);
    const R wsinv = R(1) / ws;
    for (int i = 0; i < len; ++i) w[i] = w[i] * wsinv;
    R w1sq = R(0);
    for (int i = 1; i < len; ++i) w1sq += w[i] * w[i];
    w[0] = msqrt(w1sq + R(1));
    const R gamma = ws * R(0.5);
    const R den = R(1) / (sg[0] * ssinv + zg[0] * zsinv + gamma * R(2));
    const R cs = (gamma + zg[0] * zsinv) * ssinv;
    const R cz = (gamma + sg[0] * ssinv) * zsinv;
    const R lscale = msqrt(ss * zs);
    lam[0] = gamma * lscale;
    for (int i = 1; i < len; ++i)
      lam[i] = ((cs * sg[i] + cz * zg[i]) * den) * lscale;
    sc.eta[g] = eta;
    sc.eta2[g] = eta * eta;
    sc.etainv[g] = R(1) / eta;
    sc.etainv2[g] = R(1) / (eta * eta);
    ok = ok && okg;
  }
  return ok;
}

// static regularization at this scaling (reference hs_diag_hi + eps_of)
template <typename R>
__device__ R eps_of(const CtxT<R>& cx, const ScaleT<R>* sc) {
  R maxdiag = cx.pr.pdiag;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (sc == nullptr) {   // unit diagonal (initial point)
      if (hi > lo) maxdiag = nmax(maxdiag, R(1));
      continue;
    }
    if (kind == SEG_ZERO) {
      if (hi > lo) maxdiag = nmax(maxdiag, R(0));
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) maxdiag = nmax(maxdiag, mabs(sc->w[i]));
#if MK_NONSYM
    } else if (kind == SEG_EXP || kind == SEG_POW) {
      const R* h = sc->ns_Hs[g];   // h11, h22, h33
      maxdiag = nmax(nmax(nmax(maxdiag, fabs(h[0])), fabs(h[3])), fabs(h[5]));
#endif
#if MK_GENPOW
    } else if (kind == SEG_GENPOW) {
      // mu (D + p^2 - q^2 or r^2)
      for (int i = lo; i < hi; ++i) {
        const double u = sc->gp_qr[i];
        const double t = sc->gp_dd[i] + sc->gp_p[i] * sc->gp_p[i];
        maxdiag = nmax(maxdiag, fabs((t - u * u) * sc->gp_mu));
      }
#endif
#if MK_PSD
    } else if (kind == SEG_PSD) {
      // skron(RR') diagonal: slot (i,i) -> A_ii^2, (i<j) -> A_ii A_jj +
      // A_ij^2, A = RR'
      const int np = psd_side(hi - lo);
      R Rt[9], A[9];
      mat_T(sc->psd_R[g], np, Rt);
      mat_mm(sc->psd_R[g], Rt, np, A);
      for (int j = 0; j < np; ++j)
        for (int i = 0; i <= j; ++i) {
          const R dg = i == j ? A[i * 3 + i] * A[i * 3 + i]
                              : A[i * 3 + i] * A[j * 3 + j] +
                                    A[i * 3 + j] * A[i * 3 + j];
          maxdiag = nmax(maxdiag, mabs(dg));
        }
#endif
    } else {
      const R eta2 = sc->eta2[g];
      for (int i = lo; i < hi; ++i) {
        const R w2 = R(2) * sc->w[i] * sc->w[i];
        const R dg = (i == lo ? w2 - R(1) : w2 + R(1)) * eta2;
        maxdiag = nmax(maxdiag, mabs(dg));
      }
    }
  }
  return R(cx.p.static_reg_constant) +
         R(cx.p.static_reg_proportional) * maxdiag;
}

// Hs^{-1} v with 1/eps on zero-cone rows (reference hinv_apply)
template <typename R>
__device__ void hinv_apply(const CtxT<R>& cx, const ScaleT<R>& sc, R eps,
                           const R* v, R* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      const R r = R(1) / eps;
      for (int i = lo; i < hi; ++i) out[i] = v[i] * r;
    } else if (sc.ident) {
      for (int i = lo; i < hi; ++i) out[i] = v[i];
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = v[i] * sc.winv2[i];
#if MK_NONSYM
    } else if (kind == SEG_EXP || kind == SEG_POW) {
      chol3_solve_fac(sc.ns_F[g], v + lo, out + lo);
#endif
#if MK_GENPOW
    } else if (kind == SEG_GENPOW) {
      gp_hinv_apply(sc, lo, cx.p.gp_d1[g], hi - lo, v + lo, out + lo);
#endif
#if MK_PSD
    } else if (kind == SEG_PSD) {
      // svec(Rinv' (Rinv X Rinv') Rinv)
      const int np = psd_side(hi - lo);
      R X[9], T1[9], Y[9];
      psd_unpack(v + lo, np, X);
      mat_sandwich(sc.psd_Ri[g], X, np, true, T1);
      mat_sandwich(sc.psd_Ri[g], T1, np, false, Y);
      psd_pack(Y, np, out + lo);
#endif
    } else {
      R cc = sc.w[lo] * v[lo];
      for (int i = lo + 1; i < hi; ++i) cc += (-sc.w[i]) * v[i];
      cc = cc * R(2);
      const R e2 = sc.etainv2[g];
      out[lo] = (-v[lo] + cc * sc.w[lo]) * e2;
      for (int i = lo + 1; i < hi; ++i) out[i] = (v[i] + cc * (-sc.w[i])) * e2;
    }
  }
}

// Hs v; the zero-cone block of the true operator is 0 (reference hs_apply)
template <typename R>
__device__ void hs_apply(const CtxT<R>& cx, const ScaleT<R>& sc, const R* v,
                         R* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      for (int i = lo; i < hi; ++i) out[i] = R(0);
    } else if (sc.ident) {
      for (int i = lo; i < hi; ++i) out[i] = v[i];
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = v[i] * sc.w[i];
#if MK_NONSYM
    } else if (kind == SEG_EXP || kind == SEG_POW) {
      hmul3(sc.ns_Hs[g], v + lo, out + lo);
#endif
#if MK_GENPOW
    } else if (kind == SEG_GENPOW) {
      gp_hs_apply(sc, lo, cx.p.gp_d1[g], hi - lo, v + lo, out + lo);
#endif
#if MK_PSD
    } else if (kind == SEG_PSD) {
      // svec(R (R' X R) R')
      const int np = psd_side(hi - lo);
      R X[9], W[9], Y[9];
      psd_unpack(v + lo, np, X);
      mat_sandwich(sc.psd_R[g], X, np, false, W);
      mat_sandwich(sc.psd_R[g], W, np, true, Y);
      psd_pack(Y, np, out + lo);
#endif
    } else {
      R c = R(0);
      for (int i = lo; i < hi; ++i) c += sc.w[i] * v[i];
      c = c * R(2);
      const R e2 = sc.eta2[g];
      out[lo] = (-v[lo] + c * sc.w[lo]) * e2;
      for (int i = lo + 1; i < hi; ++i) out[i] = (v[i] + c * sc.w[i]) * e2;
    }
  }
}

// ---- condensed KKT: S = A' Hinv A + P + eps I, Cholesky in place ----
template <typename R>
__device__ bool build_kkt(const CtxT<R>& cx, const ScaleT<R>& sc, R eps,
                          KktT<R>& kk) {
  kk.sc = &sc;
  kk.eps = eps;
  R col[M], hcol[M];
  for (int j = 0; j < N; ++j) {
    for (int k = 0; k < M; ++k) col[k] = cx.pr.A[k * N + j];
    hinv_apply(cx, sc, eps, col, hcol);
    for (int i = j; i < N; ++i) {
      R acc = R(0);
      for (int k = 0; k < M; ++k) acc += cx.pr.A[k * N + i] * hcol[k];
      if (cx.p.p_nonzero) acc = acc + cx.pr.P[i * N + j];
      kk.L[i * N + j] = acc;
    }
    kk.L[j * N + j] += eps;
  }
  bool ok = true;
  for (int j = 0; j < N; ++j) {
    R ssq = R(0);
    for (int k = 0; k < j; ++k) ssq += kk.L[j * N + k] * kk.L[j * N + k];
    const R acc = kk.L[j * N + j] - ssq;
    ok = ok && (acc > 0);
    R Ljj = msqrt(nmax(acc, R(0)));
    Ljj = Ljj > 0 ? Ljj : R(1);
    kk.L[j * N + j] = Ljj;
    kk.Linv[j] = R(1) / Ljj;
    for (int i = j + 1; i < N; ++i) {
      R sp = R(0);
      for (int k = 0; k < j; ++k) sp += kk.L[i * N + k] * kk.L[j * N + k];
      kk.L[i * N + j] = (kk.L[i * N + j] - sp) * kk.Linv[j];
    }
  }
  return ok;
}

template <typename R>
__device__ void chol_solve(const KktT<R>& kk, const R* w, R* x) {
  R y[N];
  for (int j = 0; j < N; ++j) {
    R sp = R(0);
    for (int k = 0; k < j; ++k) sp += kk.L[j * N + k] * y[k];
    y[j] = (w[j] - sp) * kk.Linv[j];
  }
  for (int i = N - 1; i >= 0; --i) {
    R sp = R(0);
    for (int k = i + 1; k < N; ++k) sp += kk.L[k * N + i] * x[k];
    x[i] = (y[i] - sp) * kk.Linv[i];
  }
}

template <typename R>
__device__ void apply_once(const CtxT<R>& cx, const KktT<R>& kk, const R* bx,
                           const R* bz, R* xs, R* zs) {
  R hb[M], w[N], t[M];
  hinv_apply(cx, *kk.sc, kk.eps, bz, hb);
  Aty(cx.pr, hb, w);
  for (int j = 0; j < N; ++j) w[j] = bx[j] + w[j];
  chol_solve(kk, w, xs);
  Ax(cx.pr, xs, t);
  for (int k = 0; k < M; ++k) t[k] = t[k] - bz[k];
  hinv_apply(cx, *kk.sc, kk.eps, t, zs);
}

// (bx, bz) - K (xs, zs) of the true augmented operator
template <typename R>
__device__ void kkt_resid(const CtxT<R>& cx, const KktT<R>& kk, const R* bx,
                          const R* bz, const R* xs, const R* zs, R* ex,
                          R* ez) {
  R t[N], u[N], v[M], h[M];
  Aty(cx.pr, zs, t);
  Pxv(cx, xs, u);
  for (int j = 0; j < N; ++j) ex[j] = bx[j] - (t[j] + u[j]);
  Ax(cx.pr, xs, v);
  hs_apply(cx, *kk.sc, zs, h);
  for (int k = 0; k < M; ++k) ez[k] = bz[k] - (v[k] - h[k]);
}

template <int K, typename R>
__device__ R pair_max(const R (*a)[N], const R (*b)[M]) {
  R mx = R(0);
  bool first = true;
  for (int r = 0; r < K; ++r) {
    R v = mabs(a[r][0]);
    for (int j = 1; j < N; ++j) v = nmax(v, mabs(a[r][j]));
    R u = mabs(b[r][0]);
    for (int k = 1; k < M; ++k) u = nmax(u, mabs(b[r][k]));
    v = nmax(v, u);
    mx = first ? v : nmax(mx, v);
    first = false;
  }
  return mx;
}

// Accept-masked refinement against the true operator (reference
// refined_solve, l.1861-1988); joint norms over the K right-hand sides.
template <int K, typename R>
__device__ bool refined_solve(const CtxT<R>& cx, const KktT<R>& kk,
                              const R (*bx)[N], const R (*bz)[M],
                              R (*xs)[N], R (*zs)[M]) {
  for (int r = 0; r < K; ++r) apply_once(cx, kk, bx[r], bz[r], xs[r], zs[r]);
  const int passes = cx.p.refine_passes;
  if (passes <= 0) return isfinite(pair_max<K>(xs, zs));
  const R normb = pair_max<K>(bx, bz);
  R ex[K][N], ez[K][M];
  for (int r = 0; r < K; ++r)
    kkt_resid(cx, kk, bx[r], bz[r], xs[r], zs[r], ex[r], ez[r]);
  R norme = pair_max<K>(ex, ez);
  bool ok = isfinite(norme);
  bool done = false;
  const R tol = R(cx.p.refine_abstol) + R(cx.p.refine_reltol) * normb;
  for (int p = 0; p < passes; ++p) {
    const bool active = !done && ok && (norme > tol);
    if (!active) break;   // an inactive lane stays inactive
    R nx[K][N], nz[K][M], nex[K][N], nez[K][M];
    for (int r = 0; r < K; ++r) {
      R dx[N], dz[M];
      apply_once(cx, kk, ex[r], ez[r], dx, dz);
      for (int j = 0; j < N; ++j) nx[r][j] = xs[r][j] + dx[j];
      for (int k = 0; k < M; ++k) nz[r][k] = zs[r][k] + dz[k];
    }
    for (int r = 0; r < K; ++r)
      kkt_resid(cx, kk, bx[r], bz[r], nx[r], nz[r], nex[r], nez[r]);
    const R nn = pair_max<K>(nex, nez);
    const bool okn = isfinite(nn);
    const R ratio = norme / (nn != 0 ? nn : R(TINY32));
    const bool stop = ratio < R(cx.p.refine_stop_ratio);
    const bool accept = okn && (!stop || ratio > R(1));
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
#if MK_PSD
    if (kind == SEG_PSD) {
      const int np = psd_side(hi - lo);
      double Mt[9], e[3];
      psd_unpack(v + lo, np, Mt);
      psd_eigvals(Mt, np, cx.p.psd_sweeps, e);
      for (int j = 0; j < np; ++j) {
        mm = nmin(mm, e[j]);
        pm = pm + nmax(e[j], 0.0);
      }
    }
#endif
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
#if MK_PSD
    } else if (kind == SEG_PSD) {
      for (int j = 0; j < psd_side(hi - lo); ++j) {
        const int k = lo + j * (j + 1) / 2 + j;
        v[k] = v[k] + amt;
      }
#endif
    } else {
      v[lo] = v[lo] + amt;
    }
  }
}

// ---- step length (reference step_length / soc_step_len) ----
template <typename R>
__device__ R soc_step_len(const R* X, const R* Y, int len) {
  const R x0 = X[0], y0 = Y[0];
  const R a0 = (x0 >= 0 && y0 < 0) ? -x0 / (y0 < 0 ? y0 : R(-1)) : R(BIG);
  R yy = R(0), xy = R(0), xx = R(0);
  for (int i = 1; i < len; ++i) {
    yy += Y[i] * Y[i];
    xy += X[i] * Y[i];
    xx += X[i] * X[i];
  }
  const R a = Y[0] * Y[0] - yy;
  const R b = (X[0] * Y[0] - xy) * R(2);
  const R c = nmax(X[0] * X[0] - xx, R(0));
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

#if MK_NONSYM
// (z + a dz, s + a ds) strictly inside every exp/pow segment's dual and
// primal cone
__device__ bool nonsym_feasible(const Ctx& cx, const double* z,
                                const double* s, const double* dz,
                                const double* ds, double a) {
  bool ok = true;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], kind = cx.p.seg_kind[g];
#if MK_GENPOW
    if (kind == SEG_GENPOW) {
      const int w = cx.p.seg_hi[g] - lo, d1 = cx.p.gp_d1[g];
      double Z[GPW], Sv[GPW];
      for (int i = 0; i < w; ++i) {
        Z[i] = z[lo + i] + a * dz[lo + i];
        Sv[i] = s[lo + i] + a * ds[lo + i];
      }
      ok = ok && gp_feas_dual(Z, cx.p.gp_alpha[g], d1, w) &&
           gp_feas_primal(Sv, cx.p.gp_alpha[g], d1, w);
      continue;
    }
#endif
    if (kind != SEG_EXP && kind != SEG_POW) continue;
    double Z[3], Sv[3];
    for (int i = 0; i < 3; ++i) {
      Z[i] = z[lo + i] + a * dz[lo + i];
      Sv[i] = s[lo + i] + a * ds[lo + i];
    }
    if (kind == SEG_EXP)
      ok = ok && exp_feas_dual(Z) && exp_feas_primal(Sv);
    else
      ok = ok && pow_feas_dual(Z, cx.p.seg_alpha[g]) &&
           pow_feas_primal(Sv, cx.p.seg_alpha[g]);
  }
  return ok;
}
#endif

// the Scale argument that only PSD segments read
#if MK_PSD
#define PSD_SC_PARAM const ScaleT<R> &sc,
#define PSD_SC_ARG sc,
#else
#define PSD_SC_PARAM
#define PSD_SC_ARG
#endif

// symmetric segments first; with nonsymmetric segments the step is then
// capped and backtracked jointly over all of them (reference l.2091-2229),
// here or, in K1c, by `coop_search`
template <typename R>
__device__ R step_length(const CtxT<R>& cx, PSD_SC_PARAM const R* dz,
                         const R* ds, const R* z, const R* s, R amax) {
  R alpha = amax;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO || kind == SEG_EXP || kind == SEG_POW) continue;
#if MK_GENPOW
    if (kind == SEG_GENPOW) continue;
#endif
#if MK_PSD
    if (kind == SEG_PSD) {
      const int np = psd_side(hi - lo);
      alpha = nmin(alpha, psd_step_comp(dz + lo, sc.psd_R[g], sc.psd_lam[g],
                                        np, cx.p.psd_sweeps, false));
      alpha = nmin(alpha, psd_step_comp(ds + lo, sc.psd_Ri[g],
                                        sc.psd_lam[g], np, cx.p.psd_sweeps,
                                        true));
      continue;
    }
#endif
    if (kind == SEG_NN) {
      R az = R(BIG), as = R(BIG);
      bool first = true;
      for (int i = lo; i < hi; ++i) {
        const R rz = dz[i] < 0 ? -z[i] / dz[i] : R(BIG);
        const R rs = ds[i] < 0 ? -s[i] / ds[i] : R(BIG);
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
#if MK_NONSYM
  alpha = nmin(alpha, STEP_CAP);
#if !MK_COOP
  for (int k = 0; k < FEAS_TRIPS; ++k) {
    if (nonsym_feasible(cx, z, s, dz, ds, alpha)) break;
    alpha = alpha * cx.p.linesearch_backtrack_step;
    if (alpha < cx.p.min_terminate_step_length) {
      alpha = 0.0;
      break;
    }
  }
#endif
#endif
  return alpha;
}

// ---- predictor-corrector pieces ----
template <typename R>
__device__ void affine_ds(const CtxT<R>& cx, const ScaleT<R>& sc, const R* s,
                          R* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      for (int i = lo; i < hi; ++i) out[i] = R(0);
    } else if (kind == SEG_EXP || kind == SEG_POW) {
      for (int i = lo; i < hi; ++i) out[i] = s[i];
#if MK_GENPOW
    } else if (kind == SEG_GENPOW) {
      for (int i = lo; i < hi; ++i) out[i] = s[i];
#endif
#if MK_PSD
    } else if (kind == SEG_PSD) {
      // lam o lam: lam_j^2 on the svec diagonal slots
      const int np = psd_side(hi - lo);
      for (int i = lo; i < hi; ++i) out[i] = R(0);
      for (int j = 0; j < np; ++j)
        out[lo + j * (j + 1) / 2 + j] = sc.psd_lam[g][j] * sc.psd_lam[g][j];
#endif
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = sc.lam[i] * sc.lam[i];
    } else {
      R acc = R(0);
      for (int i = lo; i < hi; ++i) acc += sc.lam[i] * sc.lam[i];
      out[lo] = acc;
      for (int i = lo + 1; i < hi; ++i) out[i] = sc.lam[lo] * sc.lam[i] * R(2);
    }
  }
}

// W X (inv = false) or W^{-1} X (inv = true) on one soc segment
template <typename R>
__device__ void mul_w(const R* w, const R* X, int len, R etaf, bool inv,
                      R* y) {
  R zeta = R(0);
  for (int i = 1; i < len; ++i) zeta += w[i] * X[i];
  const R denom = R(1) / (w[0] + R(1));
  const R c = (inv ? -X[0] : X[0]) + zeta * denom;
  y[0] = (inv ? w[0] * X[0] - zeta : w[0] * X[0] + zeta) * etaf;
  for (int i = 1; i < len; ++i) y[i] = (X[i] + c * w[i]) * etaf;
}

template <typename R>
__device__ void combined_ds_shift(const CtxT<R>& cx, const ScaleT<R>& sc,
                                  const R* dz, const R* ds, R sigma_mu,
                                  R* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      for (int i = lo; i < hi; ++i) out[i] = R(0);
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = dz[i] * ds[i] - sigma_mu;
#if MK_NONSYM
    } else if (kind == SEG_EXP || kind == SEG_POW) {
      // sigma mu g(z) - eta, eta the third-order correction
      double eta[3];
      if (kind == SEG_EXP)
        exp_higher_corr(sc.ns_Hd[g], sc.ns_z[g], ds + lo, dz + lo, eta);
      else
        pow_higher_corr(sc.ns_Hd[g], sc.ns_z[g], cx.p.seg_alpha[g], ds + lo,
                        dz + lo, eta);
      for (int i = 0; i < 3; ++i)
        out[lo + i] = sc.ns_g[g][i] * sigma_mu - eta[i];
#endif
#if MK_GENPOW
    } else if (kind == SEG_GENPOW) {
      // sigma mu g(z); no third-order correction
      for (int i = lo; i < hi; ++i) out[i] = sc.gp_g[i] * sigma_mu;
#endif
#if MK_PSD
    } else if (kind == SEG_PSD) {
      // W^{-1} ds o W dz - sigma mu e, the circ the symmetrized product
      const int np = psd_side(hi - lo);
      R Dz[9], Ds[9], WDz[9], WiDs[9], Pm[9], Qm[9], C[9];
      psd_unpack(dz + lo, np, Dz);
      psd_unpack(ds + lo, np, Ds);
      mat_sandwich(sc.psd_R[g], Dz, np, false, WDz);
      mat_sandwich(sc.psd_Ri[g], Ds, np, true, WiDs);
      mat_mm(WiDs, WDz, np, Pm);
      mat_mm(WDz, WiDs, np, Qm);
      for (int i = 0; i < np; ++i)
        for (int j = 0; j < np; ++j)
          C[i * 3 + j] = (Pm[i * 3 + j] + Qm[i * 3 + j]) * R(0.5);
      for (int i = 0; i < np; ++i) C[i * 3 + i] = C[i * 3 + i] - sigma_mu;
      psd_pack(C, np, out + lo);
#endif
    } else {
      const int len = hi - lo;
      R wdz[M], wids[M];
      mul_w(sc.w + lo, dz + lo, len, sc.eta[g], false, wdz);
      mul_w(sc.w + lo, ds + lo, len, sc.etainv[g], true, wids);
      R acc = R(0);
      for (int i = 0; i < len; ++i) acc += wids[i] * wdz[i];
      out[lo] = acc - sigma_mu;
      for (int i = 1; i < len; ++i)
        out[lo + i] = wids[0] * wdz[i] + wdz[0] * wids[i];
    }
  }
}

template <typename R>
__device__ void ds_from_dz_offset(const CtxT<R>& cx, const ScaleT<R>& sc,
                                  const R* dsv, const R* z, R* out) {
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_ZERO) {
      for (int i = lo; i < hi; ++i) out[i] = R(0);
    } else if (kind == SEG_EXP || kind == SEG_POW) {
      for (int i = lo; i < hi; ++i) out[i] = dsv[i];
#if MK_GENPOW
    } else if (kind == SEG_GENPOW) {
      for (int i = lo; i < hi; ++i) out[i] = dsv[i];
#endif
#if MK_PSD
    } else if (kind == SEG_PSD) {
      // W'(lam \ ds): (lam \ Z)_ij = 2 Z_ij / (lam_i + lam_j)
      const int np = psd_side(hi - lo);
      const R* lam = sc.psd_lam[g];
      R Zm[9], X[9], Y[9];
      psd_unpack(dsv + lo, np, Zm);
      for (int i = 0; i < np; ++i)
        for (int j = 0; j < np; ++j)
          X[i * 3 + j] = Zm[i * 3 + j] * R(2) * (R(1) / (lam[i] + lam[j]));
      mat_sandwich(sc.psd_R[g], X, np, true, Y);
      psd_pack(Y, np, out + lo);
#endif
    } else if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) out[i] = dsv[i] / z[i];
    } else {
      const R* w = sc.w + lo;
      const R* lam = sc.lam + lo;
      const R* zg = z + lo;
      const R* dsg = dsv + lo;
      const int len = hi - lo;
      const R eta = sc.eta[g];
      const R z1n = vnorm(zg + 1, len - 1);
      const R resz = (zg[0] - z1n) * (zg[0] + z1n);
      R lam1ds1 = R(0), w1ds1 = R(0);
      for (int i = 1; i < len; ++i) {
        lam1ds1 += lam[i] * dsg[i];
        w1ds1 += w[i] * dsg[i];
      }
      const R c = (lam[0] * dsg[0] - lam1ds1) * (R(1) / resz);
      const R o0 = zg[0] * c + eta * w1ds1;
      const R wc = w1ds1 * (R(1) / (w[0] + R(1)));
      const R lam0inv = R(1) / lam[0];
      out[lo] = o0 * lam0inv;
      for (int i = 1; i < len; ++i)
        out[lo + i] = (-zg[i] * c + (dsg[i] + wc * w[i]) * eta) * lam0inv;
    }
  }
}

// ---- residuals, info, convergence (reference l.2702-2835) ----
template <typename R>
__device__ void residuals(const CtxT<R>& cx, const R* x, const R* z,
                          const R* s, R tau, R kappa, R tinv, ResT<R>& r) {
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

template <int D, typename R>
__device__ R scaled_norm(const R* sc, const R* v) {
  R acc = R(0);
  for (int i = 0; i < D; ++i) {
    const R t = sc[i] * v[i];
    acc += t * t;
  }
  return msqrt(acc);
}

template <typename R>
__device__ void compute_info(const CtxT<R>& cx, const ResT<R>& r, const R* x,
                             const R* z, const R* s, R kappa, R tinv,
                             InfoT<R>& in) {
  const ProbT<R>& pr = cx.pr;
  const R xPx_half = r.xPx * tinv * tinv * R(0.5);
  in.cost_primal = (r.qx * tinv + xPx_half) * pr.cinv;
  in.cost_dual = (-r.bz * tinv - xPx_half) * pr.cinv;
  R normx = scaled_norm<N>(pr.d, x);
  R normz = scaled_norm<M>(pr.e, z) * pr.cinv;
  R norms = scaled_norm<M>(pr.einv, s);
  in.res_primal_inf =
      scaled_norm<N>(pr.dinv, r.rx_inf) * pr.cinv / nmax(R(1), normz);
  in.res_dual_inf =
      nmax(scaled_norm<N>(pr.dinv, r.Px) / nmax(R(1), normx),
           scaled_norm<M>(pr.einv, r.rz_inf) / nmax(R(1), normx + norms));
  normx = normx * tinv;
  normz = normz * tinv;
  norms = norms * tinv;
  in.res_primal = scaled_norm<M>(pr.einv, r.rz) * tinv /
                  nmax(R(1), pr.normb + normx + norms);
  in.res_dual = scaled_norm<N>(pr.dinv, r.rx) * tinv * pr.cinv /
                nmax(R(1), pr.normq + normx + normz);
  in.gap_abs = mabs(in.cost_primal - in.cost_dual);
  in.gap_rel = in.gap_abs /
               nmax(R(1), nmin(mabs(in.cost_primal), mabs(in.cost_dual)));
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

template <typename R> struct StepT {
  R dx[N], dz[M], ds[M];
  R dtau, dkappa, alpha, sigma;
  bool kkt_fail;
};
using Step = StepT<double>;

// tau recovery (reference pc_step.tau_recovery, src/kktsystem.jl:135-215)
template <typename R>
__device__ void tau_recovery(const CtxT<R>& cx, const ScaleT<R>& sc,
                             const R* x1, const R* z1, const R* x2,
                             const R* z2, const R* xi, const R* ds_const,
                             R rhs_tau, R rhs_kappa, R kappa, R tinv,
                             R tau_den, R* dx, R* dz, R* dsv, R& dtau,
                             R& dkappa) {
  R tau_num = rhs_tau - rhs_kappa * tinv + dotn<N>(cx.pr.q, x1) +
              dotn<M>(cx.pr.b, z1);
  if (cx.p.p_nonzero) {
    R px1[N];
    Pxv(cx, x1, px1);
    tau_num = tau_num + dotn<N>(xi, px1) * R(2);
  }
  dtau = tau_num / tau_den;
  for (int j = 0; j < N; ++j) dx[j] = x1[j] + x2[j] * dtau;
  for (int k = 0; k < M; ++k) dz[k] = z1[k] + z2[k] * dtau;
  R h[M];
  hs_apply(cx, sc, dz, h);
  for (int k = 0; k < M; ++k) dsv[k] = -(h[k] + ds_const[k]);
  dkappa = -(rhs_kappa + kappa * dtau) * tinv;
}

template <typename R>
__device__ R max_step(R tau, R kappa, R dtau, R dkappa) {
  const R a_tau = dtau < 0 ? -tau / dtau : R(BIG);
  const R a_kap = dkappa < 0 ? -kappa / dkappa : R(BIG);
  return nmin(nmin(a_tau, a_kap), R(1));
}

#if MK_NONSYM
// the total barrier a step a along the direction, float64 (reference
// barrier_at, l.2230-2269, in f32)
__device__ double barrier_at(const Ctx& cx, const double* z, const double* s,
                             const double* dz, const double* ds, double tau,
                             double kappa, double dtau, double dkappa,
                             double a) {
  const double cur_tau = tau + a * dtau, cur_kappa = kappa + a * dkappa;
  double zs[M], ss[M], sz = 0.0;
  for (int k = 0; k < M; ++k) {
    zs[k] = z[k] + a * dz[k];
    ss[k] = s[k] + a * ds[k];
    sz += zs[k] * ss[k];
  }
  const double deg1 = (double)(cx.p.degree + 1);
  const double mu_a = (sz + cur_tau * cur_kappa) / deg1;
  double bar = deg1 * nslog(mu_a) - nslog(cur_tau) - nslog(cur_kappa);
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    if (kind == SEG_NN) {
      double acc = 0.0;
      for (int i = lo; i < hi; ++i) acc += nslog(ss[i] * zs[i]);
      bar = bar - acc;
    } else if (kind == SEG_SOC) {
      double s1 = 0.0, z1 = 0.0;
      for (int i = lo + 1; i < hi; ++i) {
        s1 += ss[i] * ss[i];
        z1 += zs[i] * zs[i];
      }
      const double rs = ss[lo] * ss[lo] - s1, rz = zs[lo] * zs[lo] - z1;
      bar = bar + ((rs > 0 && rz > 0) ? -0.5 * nslog(rs * rz) : BIG);
    } else if (kind == SEG_EXP || kind == SEG_POW) {
      bar = bar + nonsym_barrier(kind, cx.p.seg_alpha[g], zs + lo, ss + lo);
    }
#if MK_GENPOW
    if (kind == SEG_GENPOW)
      bar = bar + gp_barrier(cx.p.gp_alpha[g], cx.p.gp_d1[g], hi - lo,
                             zs + lo, ss + lo);
#endif
#if MK_PSD
    if (kind == SEG_PSD) {
      const int np = psd_side(hi - lo);
      double Zm[9], Sm[9];
      bool okz, oks;
      psd_unpack(zs + lo, np, Zm);
      psd_unpack(ss + lo, np, Sm);
      const double lz = psd_logdet(Zm, np, okz);
      const double ls = psd_logdet(Sm, np, oks);
      bar = bar + ((okz && oks) ? -(lz + ls) : BIG);
    }
#endif
  }
  return bar;
}
#endif

#if MK_COOP
// ---- warp-cooperative backtracking searches (K1c) ----
//
// The joint feasibility backtrack of a step length and the barrier
// backtrack of a Dual lane try alpha_k = alpha_0 * step^k for k = 0, 1, ...
// (k successive multiplications) and keep the first alpha_k that passes.
// A lane searching alone in its warp would hold 31 threads idle for every
// trip, and the warp pays for its slowest lane.  Here the warp shares the
// candidates out: each searching lane stages its point and direction in
// shared memory, laid out [word][thread], and in each round the L lanes of
// the warp still searching share its 32 threads, thread t trying the
// (t / L)-th untried candidate of the (t % L)-th lane (ipm/
// megakernel_ref.py `warp_costs` counts the rounds).  A lane takes the
// smallest candidate that passes, or, when none does, exactly what the
// serial loop leaves: 0 once alpha_k fell below min_terminate_step_length
// (feasibility), else alpha_limit.  Every candidate is formed and tested by
// the code the serial loop ran, on the same values, so every lane's alpha
// is the serial loop's.  The IPM loop runs while any lane of the warp
// does, and a lane that takes no step in a trip (it is done, or lies past
// the batch) passes through the step's searches as a helper.

constexpr unsigned FULL_MASK = 0xffffffffu;
// staged words per thread: z, s, dz, ds (M each), tau, kappa, dtau, dkappa
// and alpha_0
constexpr int STAGE_WORDS = 4 * M + 5;

// the n-th set bit of m (n from 0)
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// Called by every thread of the warp at the same point.  `want`: this
// lane searches, from alpha0 along (dz, ds) at (z, s) (and tau, kappa,
// dtau, dkappa for the barrier).  Returns the lane's alpha (alpha0 where
// it does not search).
template <bool BARRIER>
__device__ double coop_search(const Ctx& cx, bool want, const double* z,
                              const double* s, const double* dz,
                              const double* ds, double tau, double kappa,
                              double dtau, double dkappa, double alpha0) {
  extern __shared__ double mk_stage[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int wl = tid & 31, wb = tid - wl;
  auto stage = [&](int w, int t) -> double& { return mk_stage[w * T + t]; };
  const double step = cx.p.linesearch_backtrack_step;
  const double amin = cx.p.min_terminate_step_length;
  const int limit = BARRIER ? cx.p.linesearch_max_iter : FEAS_TRIPS;
  if (want) {
    for (int k = 0; k < M; ++k) {
      stage(k, tid) = z[k];
      stage(M + k, tid) = s[k];
      stage(2 * M + k, tid) = dz[k];
      stage(3 * M + k, tid) = ds[k];
    }
    stage(4 * M, tid) = tau;
    stage(4 * M + 1, tid) = kappa;
    stage(4 * M + 2, tid) = dtau;
    stage(4 * M + 3, tid) = dkappa;
    stage(4 * M + 4, tid) = alpha0;
  }
  __syncwarp();
  double result = alpha0;
  bool searching = want && limit > 0;
  int next = 0;   // this lane's first untried candidate
  unsigned m = __ballot_sync(FULL_MASK, searching);
  while (m) {
    const int L = __popc(m);
    const int j = nth_bit(m, wl % L);          // the lane this thread serves
    const int k = __shfl_sync(FULL_MASK, next, j) + wl / L;
    // candidate k of lane j: k multiplications, cut where the serial loop
    // cuts (feasibility: a step below min_terminate_step_length)
    double a = stage(4 * M + 4, wb + j);
    bool cut = false;
    for (int i = 0; i < k; ++i) {
      a = a * step;
      if (!BARRIER && a < amin) cut = true;
    }
    bool pass = false;
    if (k < limit && !cut) {
      double zc[M], sc[M], dzc[M], dsc[M];
      for (int r = 0; r < M; ++r) {
        zc[r] = stage(r, wb + j);
        sc[r] = stage(M + r, wb + j);
        dzc[r] = stage(2 * M + r, wb + j);
        dsc[r] = stage(3 * M + r, wb + j);
      }
      pass = BARRIER ? barrier_at(cx, zc, sc, dzc, dsc,
                                  stage(4 * M, wb + j),
                                  stage(4 * M + 1, wb + j),
                                  stage(4 * M + 2, wb + j),
                                  stage(4 * M + 3, wb + j), a) < 1.0
                     : nonsym_feasible(cx, zc, sc, dzc, dsc, a);
    }
    const unsigned passed = __ballot_sync(FULL_MASK, pass);
    if (searching) {
      // the threads that served this lane, in candidate order
      const int rank = __popc(m & ((1u << wl) - 1u));
      unsigned mine = 0;
      for (int t = rank; t < 32; t += L) mine |= 1u << t;
      const unsigned hit = passed & mine;
      const int kk = hit ? next + (__ffs(hit) - 1) / L
                         : next + __popc(mine);
      double ak = alpha0;
      bool cutk = false;
      for (int i = 0; i < kk && i < limit; ++i) {
        ak = ak * step;
        if (!BARRIER && ak < amin) cutk = true;
      }
      if (hit) {
        result = ak;
        searching = false;
      } else if (cutk) {
        result = 0.0;
        searching = false;
      } else if (kk >= limit) {
        result = ak;
        searching = false;
      } else {
        next = kk;
      }
    }
    m = __ballot_sync(FULL_MASK, searching);
  }
  __syncwarp();
  return result;
}

#endif

// One Mehrotra predictor-corrector step (reference pc_step, l.2839-2977);
// on a Dual lane (K1b) the step is then backtracked to a barrier below 1.
// `run`: this lane takes a step.  In K1c every thread of the warp calls
// this at the same point, and those that do not run serve the warp's
// cooperative searches.
template <typename R>
__device__ void pc_step(const CtxT<R>& cx, bool run, const R* x,
                        const R* z, const R* s, R tau, R kappa, R tinv,
                        const ResT<R>& res, R mu, int iters1, int strat,
                        StepT<R>& st) {
  ScaleT<R> sc;
  KktT<R> kk;
  bool ok_kkt = false;
  R aff[M], bx[2][N], bz[2][M], xs[2][N], zs[2][M], xi[N], tau_den = R(0);
  R dxa[N], dza[M], dsa[M], dtaua = R(0), dkappaa = R(0), alpha_aff = R(0);
  if (run) {
    const bool ok_scale = make_scaling(cx, s, z, mu, strat, sc);
    const R eps = eps_of(cx, &sc);
    const bool ok_chol = build_kkt(cx, sc, eps, kk);
    ok_kkt = ok_scale && ok_chol;

    affine_ds(cx, sc, s, aff);
    for (int j = 0; j < N; ++j) { bx[0][j] = -cx.pr.q[j]; bx[1][j] = res.rx[j]; }
    for (int k = 0; k < M; ++k) { bz[0][k] = cx.pr.b[k]; bz[1][k] = s[k] - res.rz[k]; }
    ok_kkt = refined_solve<2>(cx, kk, bx, bz, xs, zs) && ok_kkt;
    const R* x2 = xs[0];
    const R* z2 = zs[0];

    R xm[N];
    for (int j = 0; j < N; ++j) { xi[j] = x[j] * tinv; xm[j] = xi[j] - x2[j]; }
    tau_den = kappa * tinv - dotn<N>(cx.pr.q, x2) - dotn<M>(cx.pr.b, z2);
    if (cx.p.p_nonzero) {
      R t1[N], t2[N];
      Pxv(cx, xm, t1);
      Pxv(cx, x2, t2);
      tau_den = tau_den + dotn<N>(xm, t1) - dotn<N>(x2, t2);
    }

    // affine step
    tau_recovery(cx, sc, xs[1], zs[1], x2, z2, xi, s, res.rtau, tau * kappa,
                 kappa, tinv, tau_den, dxa, dza, dsa, dtaua, dkappaa);
    alpha_aff = step_length(cx, PSD_SC_ARG dza, dsa, z, s,
                            max_step(tau, kappa, dtaua, dkappaa));
  }
#if MK_COOP
  alpha_aff = coop_search<false>(cx, run, z, s, dza, dsa, 0.0, 0.0, 0.0, 0.0,
                                 alpha_aff);
#endif
  if (run) {
    const R* x2 = xs[0];
    const R* z2 = zs[0];
    const R oma = R(1) - alpha_aff;
    const R sigma = oma * oma * oma;
    const R m_corr = iters1 > 1 ? R(1) : alpha_aff;
    const R sigma_mu = sigma * mu;

    // combined step
    R dzm[M], shift[M];
    for (int k = 0; k < M; ++k) dzm[k] = dza[k] * m_corr;
    combined_ds_shift(cx, sc, dzm, dsa, sigma_mu, shift);
    for (int k = 0; k < M; ++k) aff[k] = aff[k] + shift[k];   // comb_s
    const R one_m_sigma = R(1) - sigma;
    const R comb_tau = res.rtau * one_m_sigma;
    const R comb_kappa = -sigma_mu + dtaua * dkappaa * m_corr + tau * kappa;
    R ds_const[M];
    ds_from_dz_offset(cx, sc, aff, z, ds_const);
    for (int j = 0; j < N; ++j) bx[0][j] = res.rx[j] * one_m_sigma;
    for (int k = 0; k < M; ++k) bz[0][k] = ds_const[k] - res.rz[k] * one_m_sigma;
    R xc[1][N], zc[1][M];
    const bool ok3 = refined_solve<1>(cx, kk, bx, bz, xc, zc);
    tau_recovery(cx, sc, xc[0], zc[0], x2, z2, xi, ds_const, comb_tau,
                 comb_kappa, kappa, tinv, tau_den, st.dx, st.dz, st.ds,
                 st.dtau, st.dkappa);
    st.kkt_fail = !(ok_kkt && ok3);
    st.alpha = step_length(cx, PSD_SC_ARG st.dz, st.ds, z, s,
                           max_step(tau, kappa, st.dtau, st.dkappa));
    st.sigma = sigma;
  }
#if MK_COOP
  st.alpha = coop_search<false>(cx, run, z, s, st.dz, st.ds, 0.0, 0.0, 0.0,
                                0.0, st.alpha);
#endif
  st.alpha = st.alpha * R(cx.p.max_step_fraction);
#if MK_COOP
  st.alpha = coop_search<true>(cx, run && strat == DUAL, z, s, st.dz, st.ds,
                               tau, kappa, st.dtau, st.dkappa, st.alpha);
#elif MK_NONSYM
  if (run && strat == DUAL) {
    for (int k = 0; k < cx.p.linesearch_max_iter; ++k) {
      if (barrier_at(cx, z, s, st.dz, st.ds, tau, kappa, st.dtau, st.dkappa,
                     st.alpha) < 1.0)
        break;
      st.alpha = st.alpha * cx.p.linesearch_backtrack_step;
    }
  }
#endif
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
  // cone rectification: one scalar (the mean) on each segment that is not
  // elementwise (soc, psd, exp, pow, genpow)
  for (int g = 0; g < S; ++g) {
    if (cx.p.seg_kind[g] == SEG_ZERO || cx.p.seg_kind[g] == SEG_NN) continue;
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) acc = acc + ef[k];
    const float mean = acc / (float)(hi - lo);
    for (int k = lo; k < hi; ++k) ef[k] = mean;
  }
}

#if MK_TWO_PHASE
// The float32 first phase (K1e; reference loop_cond1/loop_body1,
// l.3212-3281) of one lane, over float32 copies of the scaled data
// (reference _Dat.to_f32, l.523-528) and the float instance of the loop's
// code.  Each iteration reads the carry rounded to float32 and hands off
// to the float64 loop at the top when mu < p1_switch_mu, mu is not finite,
// the lane has run p1_cap iterations, or mu stopped contracting (mu >
// 0.9 mu_prev from iteration 5 on); after the step when the KKT solve
// failed or alpha <= 0.01, in which case the step is not taken.  A taken
// step writes the new and the previous iterate (float32 values); a step
// not taken leaves the carry as it was.  prev_*, mu_f, alpha_f and
// sigma_f update as the float64 loop updates them; no status is set.
// Returns the phase's iteration count, where the float64 loop's count
// starts.  Not inlined: its float32 working set (the data copy, scaling,
// factor and refinement arrays) is a frame of its own, dead before the
// float64 loop's exists.
__device__ __noinline__ int phase1(const Ctx& cx, double* x, double* z,
                                   double* s, double& tau, double& kappa,
                                   double* px, double* pz, double* ps,
                                   double& ptau, double& pkap,
                                   double& prev_rp, double& prev_rd,
                                   double& prev_ga, double& prev_gr,
                                   double& mu_f, double& alpha_f,
                                   double& sigma_f) {
  CtxT<float> c32;
  c32.p = cx.p;
  c32.p.refine_abstol = P1_REFINE_ABSTOL;
  c32.p.refine_reltol = P1_REFINE_RELTOL;
  c32.p.refine_passes = cx.p.p1_refine_passes;
  ProbT<float>& pr = c32.pr;
  const Prob& pd = cx.pr;
  for (int i = 0; i < N * N; ++i) pr.P[i] = (float)pd.P[i];
  for (int i = 0; i < M * N; ++i) pr.A[i] = (float)pd.A[i];
  for (int j = 0; j < N; ++j) {
    pr.q[j] = (float)pd.q[j];
    pr.d[j] = (float)pd.d[j];
    pr.dinv[j] = (float)pd.dinv[j];
  }
  for (int k = 0; k < M; ++k) {
    pr.b[k] = (float)pd.b[k];
    pr.e[k] = (float)pd.e[k];
    pr.einv[k] = (float)pd.einv[k];
  }
  pr.cinv = (float)pd.cinv;
  pr.normq = (float)pd.normq;
  pr.normb = (float)pd.normb;
  pr.pdiag = (float)pd.pdiag;
  const float inv_deg1 = (float)(1.0 / (cx.p.degree + 1));
  const float switch_mu = (float)cx.p.p1_switch_mu;
  float muf = (float)mu_f;
  int iters = 0;
  for (;;) {
    float xf[N], zf[M], sf[M];
    for (int j = 0; j < N; ++j) xf[j] = (float)x[j];
    for (int k = 0; k < M; ++k) {
      zf[k] = (float)z[k];
      sf[k] = (float)s[k];
    }
    const float tauf = (float)tau, kapf = (float)kappa;
    const float tinv = 1.0f / tauf;
    ResT<float> res;
    residuals(c32, xf, zf, sf, tauf, kapf, tinv, res);
    const float mu = (res.sz + tauf * kapf) * inv_deg1;
    InfoT<float> info;
    compute_info(c32, res, xf, zf, sf, kapf, tinv, info);
    const bool hand_top =
        mu < switch_mu || !isfinite(mu) || iters >= cx.p.p1_cap ||
        (iters >= P1_STALL_FROM_ITER && mu > P1_STALL_RATIO * muf);
    muf = mu;
    if (hand_top) break;
    ++iters;
    StepT<float> st;
    pc_step(c32, true, xf, zf, sf, tauf, kapf, tinv, res, mu, iters,
            PRIMAL_DUAL, st);
    const bool take = !st.kkt_fail && !(st.alpha <= P1_MIN_STEP);
    alpha_f = take ? st.alpha : 0.0f;
    sigma_f = st.sigma;
    if (!take) break;
    const float a = st.alpha;
    for (int j = 0; j < N; ++j) {
      px[j] = xf[j];
      x[j] = xf[j] + st.dx[j] * a;
    }
    for (int k = 0; k < M; ++k) {
      pz[k] = zf[k];
      ps[k] = sf[k];
      z[k] = zf[k] + st.dz[k] * a;
      s[k] = sf[k] + st.ds[k] * a;
    }
    ptau = tauf;
    pkap = kapf;
    tau = tauf + st.dtau * a;
    kappa = kapf + st.dkappa * a;
    prev_rp = info.res_primal;
    prev_rd = info.res_dual;
    prev_ga = info.gap_abs;
    prev_gr = info.gap_rel;
  }
  mu_f = muf;
  return iters;
}
#endif

__device__ void solve_lane(Ctx& cx, const In& Pin, const In& qin,
                           const In& Ain, const In& bin, long long lane,
                           long long B, double* __restrict__ vals,
                           int* __restrict__ ints) {
  Prob& pr = cx.pr;
  const MkParams& p = cx.p;
  // a thread past the batch's end (in K1c it stays to serve its warp's
  // cooperative searches) runs lane 0's setup and no step
  const bool valid = lane < B;
  const long long ln = valid ? lane : 0;
  // raw data: P full symmetric from the column-major upper triangle
  for (int j = 0; j < N; ++j)
    for (int i = 0; i <= j; ++i) {
      const double v = at(Pin, j * (j + 1) / 2 + i, ln);
      pr.P[i * N + j] = v;
      pr.P[j * N + i] = v;
    }
  for (int j = 0; j < N; ++j)
    for (int k = 0; k < M; ++k) pr.A[k * N + j] = at(Ain, j * M + k, ln);
  double qraw[N];
  for (int j = 0; j < N; ++j) qraw[j] = at(qin, j, ln);

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
    pr.b[k] = at(bin, k, ln) * pr.e[k];
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

  // ---- initial point (reference l.3089-3157) ----
  double x[N], z[M], s[M];
#if MK_NONSYM
  // the unit point of every cone, x = 0
  for (int j = 0; j < N; ++j) x[j] = 0.0;
  for (int g = 0; g < S; ++g) {
    const int lo = cx.p.seg_lo[g], hi = cx.p.seg_hi[g];
    const int kind = cx.p.seg_kind[g];
    for (int i = lo; i < hi; ++i) z[i] = 0.0;
    if (kind == SEG_NN) {
      for (int i = lo; i < hi; ++i) z[i] = 1.0;
    } else if (kind == SEG_SOC) {
      z[lo] = 1.0;
    } else if (kind == SEG_EXP) {
      z[lo] = -1.051383945322714;
      z[lo + 1] = 0.556409619469370;
      z[lo + 2] = 1.258967884768947;
    } else if (kind == SEG_POW) {
      z[lo] = sqrt(1.0 + cx.p.seg_alpha[g]);
      z[lo + 1] = sqrt(2.0 - cx.p.seg_alpha[g]);
    }
#if MK_GENPOW
    if (kind == SEG_GENPOW)
      for (int j = 0; j < cx.p.gp_d1[g]; ++j)
        z[lo + j] = sqrt(1.0 + cx.p.gp_alpha[g][j]);
#endif
#if MK_PSD
    if (kind == SEG_PSD)
      for (int j = 0; j < psd_side(hi - lo); ++j)
        z[lo + j * (j + 1) / 2 + j] = 1.0;
#endif
  }
  for (int k = 0; k < M; ++k) s[k] = z[k];
#else
  {
    Scale id;
    id.ident = true;
    Kkt k0;
    build_kkt(cx, id, eps_of<double>(cx, nullptr), k0);
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
#endif
  double tau = 1.0, kappa = 1.0;
  double px[N], pz[M], ps[M], ptau = tau, pkap = kappa;
  for (int j = 0; j < N; ++j) px[j] = x[j];
  for (int k = 0; k < M; ++k) { pz[k] = z[k]; ps[k] = s[k]; }
  double prev_rp = BIG, prev_rd = BIG, prev_ga = BIG, prev_gr = BIG;
  double mu_f = BIG, alpha_f = 0.0, sigma_f = 1.0;
  int iters = 0, status = UNSOLVED, strat = PRIMAL_DUAL;
#if MK_GENPOW
  // a generalized power cone pins every lane to Dual (reference l.560-568)
  strat = DUAL;
#endif
#if MK_TWO_PHASE
  iters = phase1(cx, x, z, s, tau, kappa, px, pz, ps, ptau, pkap, prev_rp,
                 prev_rd, prev_ga, prev_gr, mu_f, alpha_f, sigma_f);
  const int p1_iters = iters;
#endif
  const double inv_deg1 = 1.0 / (p.degree + 1);
  const double sr = p.stall_ratio;

  // ---- main loop: this lane runs until it terminates.  In K1c the loop
  // runs while any lane of the warp does, so that every thread reaches the
  // cooperative searches of each trip (a lane that is done, or that
  // restarts a trip, serves them) ----
  bool act = valid;
  for (;;) {
#if MK_COOP
    if (!__any_sync(FULL_MASK, act)) break;
#else
    if (!act) break;
#endif
    bool run = false;
    double tinv = 0.0, mu = 0.0;
    Res res;
    Info info;
    if (act) {
      tinv = 1.0 / tau;
      residuals(cx, x, z, s, tau, kappa, tinv, res);
      mu = (res.sz + tau * kappa) * inv_deg1;
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
      run = status2 == UNSOLVED;
      if (!run) {
        // terminated at the top of the loop; roll back on insufficient
        // progress (src/solver.jl:453-472)
        bool restart = false;
        if (status2 == INSUFFICIENT_PROGRESS) {
          for (int j = 0; j < N; ++j) x[j] = px[j];
          for (int k = 0; k < M; ++k) { z[k] = pz[k]; s[k] = ps[k]; }
          tau = ptau;
          kappa = pkap;
#if MK_NONSYM
          // a PrimalDual lane downgrades to Dual and starts the next trip
          // from the restored iterate (reference l.3354-3383)
          if (strat == PRIMAL_DUAL) {
            strat = DUAL;
            restart = true;
          }
#endif
        }
        if (!restart) {
          status = status2;
          act = false;
        }
      }
    }
    const int iters1 = iters + 1;
    Step stp;
    pc_step(cx, run, x, z, s, tau, kappa, tinv, res, mu, iters1, strat, stp);
    if (!run) continue;

    // numerical-error and small-step checkpoints (reference l.3391-3430)
    int fail_status = stp.kkt_fail ? NUMERICAL_ERROR : UNSOLVED;
    bool small_term = stp.alpha <= nmax(0.0, p.min_terminate_step_length);
#if MK_NONSYM
    // a PrimalDual lane downgrades to Dual instead of failing
    const bool can_dg = strat == PRIMAL_DUAL;
    if (stp.kkt_fail && can_dg) fail_status = UNSOLVED;
    const bool small_switch =
        can_dg && !stp.kkt_fail && stp.alpha < p.min_switch_step_length;
    small_term = small_term && !small_switch;
    const bool dg_fail = (stp.kkt_fail && can_dg) || small_switch;
#endif
    if (fail_status == UNSOLVED && !stp.kkt_fail && small_term)
      fail_status = INSUFFICIENT_PROGRESS;
    bool take = !stp.kkt_fail && !small_term;
#if MK_NONSYM
    if (dg_fail) {
      take = false;
      strat = DUAL;
      fail_status = UNSOLVED;
    }
#endif
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
      prev_rp = info.res_primal;
      prev_rd = info.res_dual;
      prev_ga = info.gap_abs;
      prev_gr = info.gap_rel;
    }
    alpha_f = a;
    sigma_f = stp.sigma;
    status = fail_status;
    act = status == UNSOLVED;
    iters = iters1;
  }
  if (!valid) return;

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
  ints[2 * B + lane] = strat;
#if MK_TWO_PHASE
  ints[3 * B + lane] = p1_iters;
#endif
}

// Threads per block: 32 while blocks of THREADS would leave SMs without a
// block (B < THREADS * SMs; at B = 4096, 128 blocks of 32 in place of 32
// blocks of 128 on 132 SMs), else THREADS.  With the cooperative searches
// a block also holds STAGE_WORDS doubles of shared memory per thread; where
// THREADS of them would pass the 227 KB a block may have (M > 55) the
// block is halved.
int launch_threads(long long B, int sms) {
#if MK_NONSYM && !MK_COOP
  // K1b keeps blocks of THREADS: with blocks of 32 the exp batch took
  // 1.256 ms at B = 4096 against 0.773 ms (PERF.md section 5)
  (void)B;
  (void)sms;
  return THREADS;
#else
  int big = THREADS;
#if MK_COOP
  while (big > 32 && (size_t)STAGE_WORDS * sizeof(double) * big > 232448)
    big /= 2;
#endif
  return B < (long long)big * sms ? 32 : big;
#endif
}

// the dynamic shared memory of a block: the cooperative searches' staging
// (K1c)
size_t shared_bytes(int threads) {
#if MK_COOP
  return (size_t)STAGE_WORDS * sizeof(double) * threads;
#else
  (void)threads;
  return 0;
#endif
}

__global__ void __launch_bounds__(THREADS)
mk_kernel(In P, In q, In A, In b, long long B, MkParams prm,
          double* __restrict__ vals, int* __restrict__ ints) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
#if !MK_COOP
  if (lane >= B) return;
#endif
  Ctx cx;
  cx.p = prm;
  solve_lane(cx, P, q, A, b, lane, B, vals, ints);
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

// sizeof(MkParams), for the ctypes mirror to check against.
int mk_params_size(void) { return (int)sizeof(MkParams); }

// Launch the whole batched solve on `stream`.  Input component k of lane l
// is ptr[k * ld + l * ls].  vals is (OUTD, B) float64, ints (4, B) int32
// (status, iterations, final scaling strategy, and with MK_TWO_PHASE the
// float32 phase's iterations; without it the kernel leaves that row to the
// caller).  Returns cudaGetLastError() after the launch.
int mk_solve(const double* P, long long P_ld, long long P_ls,
             const double* q, long long q_ld, long long q_ls,
             const double* A, long long A_ld, long long A_ls,
             const double* b, long long b_ld, long long b_ls, long long B,
             MkParams prm, double* vals, int* ints, void* stream) {
  if (B <= 0) return 0;
  const In Pi{P, P_ld, P_ls}, qi{q, q_ld, q_ls}, Ai{A, A_ld, A_ls},
      bi{b, b_ld, b_ls};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = launch_threads(B, sms);
  const long long blocks = (B + threads - 1) / threads;
  const size_t smem = shared_bytes(threads);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(mk_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  mk_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      Pi, qi, Ai, bi, B, prm, vals, ints);
  return (int)cudaGetLastError();
}

}  // extern "C"
