// The batched conic IPM as one CUDA kernel, one instance per group of G
// threads (K1a on zero, nonnegative and second-order cone layouts; K1b
// where the build sets MK_NONSYM=1, with exponential and power cones).
//
// Replaces: clarabel_tpu/ipm/megakernel.py `kernel` / `compute` (the Pallas
// megakernel launched by `_pallas_fn`) on zero/nn/SOC layouts and on
// layouts with exp/pow segments (no genpow or PSD segment).  It
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
// megakernel.cu measured faster on the LP batch, PERF.md section 5), and
// on exp/pow layouts up to `_cuda.NONSYM_GROUP_LANES_PER_SM`.  The code is
// written over the scalar type R, as megakernel.cu's is; double is its
// one instance here.
//
// K1b (MK_NONSYM=1): the unit-initialization start, the dual and
// primal-dual (BFGS) 3x3 scalings with their Cholesky factors, the
// Wright-omega and one-sided Newton primal gradients, the third-order
// corrections, the joint feasibility backtrack, and per lane the
// PrimalDual->Dual strategy machine with the barrier backtrack of Dual
// lanes (megakernel.cu's K1b, formula for formula).  An exp or pow
// segment's three rows are gathered into every thread of the group by
// shuffles, and its 3x3 work runs there replicated on bit-equal operands,
// as the n x n Cholesky does, so the strategy switch, the step lengths
// and the stops stay uniform over the group.  What one thread of
// megakernel.cu does serially in its backtracking searches, the group
// shares: its G threads try G consecutive candidate steps side by side
// and the lane takes the first that passes, the serial loop's step
// (`feas_search`, `barrier_search`).  What bounds K1b at the exp shape
// (n = 3, m = 5): nearly all of a lane's work is this replicated 3x3 and
// n x n work, so the group issues about G times the instructions of one
// lane per thread; it gains where a batch leaves the card's SMs short of
// warps and where lanes' searches diverge, and loses where the thread
// kernel's lanes fill the card (PERF.md section 5: hence the cap).
//
// What held megakernel.cu back on this card: one lane per thread keeps a
// working set of about 1,200 words a lane (the scaled problem, the
// scalings, the factor, the refinement vectors) in runtime-indexed arrays,
// which ptxas places in local memory (255 registers and 9,648 bytes of
// stack a thread at the bench shape n=6, m=13).  At 255 registers an SM
// holds 8 warps, and their stacks leave L1 for L2 on every access.
//
// The design: one lane per group of G threads (G = 8 while m <= 8, 16
// while m <= 16, else 32; 8 on exp/pow layouts, where 2 and 4 measured
// slower or failed a bar, PERF.md section 5), each owning rows of the
// lane's data.  Thread
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
// What bounds K1a: FP64 operations, as megakernel.cu (a lane reads about
// 0.9 KB and writes 0.37 KB at the bench shape; an IPM iteration is on the
// order of 10^4 FP64 operations).  The group adds shuffles: a butterfly of
// K doubles costs 2 K log2(G) shuffles a thread.  K1a: in blocks of 256
// threads with at most 128 registers (2 blocks an SM), an SM holds 16
// warps: at the bench shape (G = 16) 128 lanes at once, with 1,104 bytes
// of stack a thread left by ptxas (spilled temporaries of the refinement;
// PERF.md).  K1b: in blocks of 64 with up to 255 registers, 8 warps an SM,
// 32 lanes at G = 8, with 656 bytes of stack.
//
// K1d (PSD) and K1e (the float32 first phase) stay in megakernel.cu.  Their
// group builds were tried on the H100 and taken back out (PERF.md section
// 6): K1d ran slower than megakernel.cu at every batch size on psd_zero,
// and on psd3 and psd2 but at 8 lanes an SM (a PSD segment's matrix work
// ran replicated in every thread of the group, so a warp carried the
// serial 3x3 work of 32 / G lanes where megakernel.cu's carries 32), and
// K1e, faster than megakernel.cu with G = 8 on bench, infeasible and lp up
// to 112 lanes an SM, failed lp's SOLVED count on the fixed batch, a bar
// megakernel.cu itself fails under two of three 1e-15 changes of q.
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
#if MK_PSD || MK_GENPOW
#error "megakernel_group.cu takes zero, nonnegative, second-order, exponential and power cones"
#endif
#ifndef MK_TWO_PHASE
#define MK_TWO_PHASE 0
#endif
#if MK_TWO_PHASE
#error "the float32 first phase (K1e) is built from megakernel.cu"
#endif
// chip_smoke.py's wrong group kernels: every butterfly sum drops its last
// step and takes thread 0's partial sum (a sum over half the group's rows);
// the shared searches of K1b take the last passing trial of a round, not
// the first
#ifndef MK_WRONG_BUTTERFLY
#define MK_WRONG_BUTTERFLY 0
#endif
#ifndef MK_WRONG_SEARCH
#define MK_WRONG_SEARCH 0
#endif

namespace {

constexpr int N = MK_N;
constexpr int M = MK_M;
constexpr int S = MK_S;
constexpr int NT = N * (N + 1) / 2;
constexpr int OUTD = N + 2 * M + 13;
#if MK_NONSYM
constexpr int G = 8;   // exp/pow layouts (K1b)
#else
constexpr int G = M <= 8 ? 8 : M <= 16 ? 16 : 32;
#endif
static_assert(G == 2 || G == 4 || G == 8 || G == 16 || G == 32,
              "a group is 2, 4, 8, 16 or 32 threads");
constexpr int RPT = (M + G - 1) / G;   // cone rows a thread owns
constexpr int CPT = (N + G - 1) / G;   // variable entries a thread owns
#if MK_NONSYM
// K1b: blocks of 64 threads, so that a batch of 4096 lanes spreads over
// the card (512 blocks of 8 lanes over 132 SMs), with up to 255 registers
// a thread (at 128 its stack was 1,168 bytes against 656, and it ran
// slower at 4096 lanes: PERF.md section 5)
constexpr int THREADS = 64;
constexpr int MIN_BLOCKS = 4;          // 4 blocks of 64: <= 255 registers
#else
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;          // 2 blocks of 256: <= 128 registers
#endif
constexpr int LANES_PER_BLOCK = THREADS / G;
constexpr double BIG = 1e30;
constexpr double TINY32 = 1.1754943508222875e-38;   // float32 tiny
constexpr double EPS64 = 2.220446049250313e-16;
#if MK_NONSYM
constexpr double SQRT_EPS64 = 1.4901161193847656e-08;
constexpr double PI = 3.141592653589793;
// the nonsymmetric step cap (reference l.2169-2172) and the trip limits of
// the joint feasibility backtrack and of the pow Newton iteration
constexpr double STEP_CAP = 1.0 - 1.0 / 4096.0;
constexpr int FEAS_TRIPS = 60, NR_TRIPS = 50;
// exp and pow segments a layout can hold (three rows each)
constexpr int NSL = S < M / 3 ? S : M / 3;
static_assert(NSL >= 1, "an exp or pow segment has three rows");
enum Strategy { PRIMAL_DUAL = 0, DUAL = 1 };
#endif

enum Status {
  UNSOLVED = 0, SOLVED = 1, PINF = 2, DINF = 3, ALMOST_SOLVED = 4,
  ALMOST_PINF = 5, ALMOST_DINF = 6, MAX_ITERATIONS = 7,
  NUMERICAL_ERROR = 9, INSUFFICIENT_PROGRESS = 10
};
enum SegKind { SEG_ZERO = 0, SEG_NN = 1, SEG_SOC = 2, SEG_EXP = 3,
               SEG_POW = 4, NO_ROW = -1 };

}  // namespace

extern "C" {
// megakernel.cu's MkParams for single-phase layouts without genpow or PSD
// segments, field for field (ipm/_cuda.py mirrors it and checks its size).
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
#if MK_NONSYM
  // the exp and pow segments in order, one slot each: kind (NO_ROW for an
  // empty slot), first row and a pow segment's exponent; and the slot of
  // each owned row (-1 for rows of other kinds)
  int ns_kind[NSL], ns_lo[NSL];
  double ns_a[NSL];
  int ns_of[RPT];
#endif
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

#if MK_NONSYM
// ---- exponential and power segments (K1b): the segment's three rows
// gathered into every thread of the group, where the 3x3 work runs
// replicated on bit-equal operands (megakernel.cu's helpers, formula for
// formula; Hessians are 6-vectors h11 h12 h13 h22 h23 h33) ----

// rows lo, lo+1, lo+2 of a per-row vector, in every thread
template <typename T>
__device__ __forceinline__ void seg_gather3(const Grp& g, int lo,
                                            const T (&v)[RPT], T (&V)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int k = lo + i, slot = k / G;
    T send = v[0];
#pragma unroll
    for (int r = 1; r < RPT; ++r)
      if (r == slot) send = v[r];
    V[i] = __shfl_sync(g.mask, send, k % G, G);
  }
}
// the entry of V for owned row r of the segment starting at lo
template <typename T>
__device__ __forceinline__ T seg_pick3(const Grp& g, int r, int lo,
                                       const T (&V)[3]) {
  const int off = row_of(g, r) - lo;
  return off == 0 ? V[0] : off == 1 ? V[1] : V[2];
}

// log, with -BIG where x <= 0 (reference nslogsafe)
__device__ __forceinline__ double nslog(double x) {
  return x > 0 ? log(x) : -BIG;
}

__device__ __forceinline__ double dot3(const double* u, const double* v) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

__device__ __forceinline__ void hmul3(const double* H, const double* v,
                                      double* out) {
  out[0] = H[0] * v[0] + H[1] * v[1] + H[2] * v[2];
  out[1] = H[1] * v[0] + H[3] * v[1] + H[4] * v[2];
  out[2] = H[2] * v[0] + H[4] * v[1] + H[5] * v[2];
}

// closed-form 3x3 Cholesky with clamped pivots: F = (l21, l31, l32, 1/l11,
// 1/l22, 1/l33); returns whether every pivot was positive
__device__ __forceinline__ bool chol3_fac(const double* H, double* F) {
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

__device__ __forceinline__ void chol3_solve_fac(const double* F,
                                                const double* b, double* x) {
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
__device__ __forceinline__ double wright_omega(double z) {
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
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const double wp1 = w + 1.0;
    const double t = wp1 * (wp1 + (2.0 * r) / 3.0);
    w = w * (1.0 + (r / wp1) * (t - 0.5 * r) / (t - r));
    r = (2.0 * w * w - 8.0 * w - 1.0) / (72.0 * pow(wp1, 6.0)) * pow(r, 4.0);
  }
  return w;
}

__device__ __forceinline__ bool exp_feas_dual(const double* Z) {
  const double zsafe = Z[0] < 0 ? Z[0] : -1.0;
  const double res = Z[1] - Z[0] - Z[0] * nslog(-Z[2] / zsafe);
  return Z[2] > 0 && Z[0] < 0 && res > 0;
}

__device__ __forceinline__ bool exp_feas_primal(const double* S) {
  const double res = S[1] * nslog(S[2] / (S[1] > 0 ? S[1] : 1.0)) - S[0];
  return S[2] > 0 && S[1] > 0 && res > 0;
}

// reference: coneops_expcone.jl:370-399
__device__ __forceinline__ void exp_grad_hess_dual(const double* Z,
                                                   double* g, double* H) {
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
__device__ __forceinline__ void exp_grad_primal(const double* S, double* g) {
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

__device__ __forceinline__ bool pow_feas_dual(const double* Z, double a) {
  const double res = pow_phi_dual(Z[0], Z[1], a) - Z[2] * Z[2];
  return Z[0] > 0 && Z[1] > 0 && res > 0;
}

__device__ __forceinline__ bool pow_feas_primal(const double* S, double a) {
  const double res =
      exp(nslog(S[0]) * (2.0 * a) + nslog(S[1]) * (2.0 - 2.0 * a)) - S[2] * S[2];
  return S[0] > 0 && S[1] > 0 && res > 0;
}

// reference: coneops_powcone.jl:408-440
__device__ __forceinline__ void pow_grad_hess_dual(const double* Z, double a,
                                                   double* g, double* H) {
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
__device__ __forceinline__ double pow_nr(double s1, double s2, double s3,
                                         double a, bool& big, double& absf) {
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

__device__ __forceinline__ void pow_grad_from(double x, bool big,
                                              const double* S, double a,
                                              double* g) {
  const double g3 = big ? x * (S[2] < 0 ? -1.0 : 1.0) : 0.0;
  g[0] = big ? -(g3 * S[2] * a + (1.0 + a)) / S[0] : -(1.0 + a) / S[0];
  g[1] = big ? -(g3 * S[2] * (1.0 - a) + (2.0 - a)) / S[1]
             : -(2.0 - a) / S[1];
  g[2] = g3;
}

// reference: coneops_powcone.jl:288-316,449-478 (pow_grad_primal,
// l.1053-1096): the Newton iteration, then two Newton polish steps
__device__ __forceinline__ void pow_grad_primal(const double* S, double a,
                                                double* g) {
  bool big;
  double absf;
  double x = pow_nr(S[0], S[1], S[2], a, big, absf);
  const double iabs = 1.0 / absf, t0 = pow_t0(a);
#pragma unroll
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
__device__ __forceinline__ void pd_scaling_3d(const double* Hd,
                                              const double* st,
                                              const double* zt,
                                              const double* S,
                                              const double* Z, double* Hs) {
  const double dot_sz = dot3(S, Z);
  const double mu_l = dot_sz * (1.0 / 3.0);
  const double mut = dot3(zt, st) * (1.0 / 3.0);
  double dsv[3], dzv[3], Hzt[3], tmp[3];
#pragma unroll
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
#pragma unroll
  for (int i = 0; i < 3; ++i) tmp[i] = mut * st[i] - Hzt[i];
  constexpr int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
  double w[6];
#pragma unroll
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
#pragma unroll
  for (int i = 0; i < 3; ++i) ax[i] = ax[i] * iaxn;
  const double isz = 1.0 / (dot_sz != 0 ? dot_sz : 1.0);
  const double idsz = 1.0 / (dot_dsz != 0 ? dot_dsz : 1.0);
  double pd[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    pd[k] = S[I[k]] * S[J[k]] * isz + dsv[I[k]] * dsv[J[k]] * idsz +
            t * ax[I[k]] * ax[J[k]];
    usable = usable && isfinite(pd[k]);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) Hs[k] = usable ? pd[k] : Hd[k] * mu_l;
}

// H_dual^{-1} b, or 0 where the factor breaks down or the result is not
// finite (reference _hd_solve_guarded, l.2464)
__device__ __forceinline__ void hd_solve_guarded(const double* Hd,
                                                 const double* b, double* u) {
  double F[6];
  const bool okc = chol3_fac(Hd, F);
  chol3_solve_fac(F, b, u);
  const bool fin = okc && isfinite(u[0]) && isfinite(u[1]) && isfinite(u[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) u[i] = fin ? u[i] : 0.0;
}

__device__ __forceinline__ void finite_or_zero3(double* eta, bool ok) {
  const bool fin = ok && isfinite(eta[0]) && isfinite(eta[1]) &&
                   isfinite(eta[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) eta[i] = fin ? eta[i] : 0.0;
}

// third-order correction (reference exp_higher_corr, l.2493)
__device__ __forceinline__ void exp_higher_corr(const double* Hd,
                                                const double* Zc,
                                                const double* ds3,
                                                const double* v3,
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
__device__ __forceinline__ void pow_higher_corr(const double* Hd,
                                                const double* Zc, double a,
                                                const double* ds3,
                                                const double* v3,
                                                double* eta) {
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

// the dual gradient and Hessian of a segment at Z
__device__ __forceinline__ void ns_grad_hess_dual(int kind, double a,
                                                  const double* Z, double* g,
                                                  double* H) {
  if (kind == SEG_EXP) exp_grad_hess_dual(Z, g, H);
  else pow_grad_hess_dual(Z, a, g, H);
}

// f*(z) + f(s) of one segment, BIG where infeasible (reference
// _nonsym_barrier32, l.2271-2324, in float64)
__device__ __forceinline__ double nonsym_barrier(int kind, double a,
                                                 const double* Z,
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

// ---- the scaled problem of the lane: the owned rows ----
template <typename R> struct Prob {
  R A[RPT][N], b[RPT], e[RPT], einv[RPT];
  R P[CPT][N], q[CPT], d[CPT], dinv[CPT];
  R cinv, normq, normb, pdiag;
};

// Scaling state of the owned rows.  nn rows: w^2 in w, 1/w^2 in sa; soc
// rows: w, eta in sa, and the segment's head w0 and lam0.  exp/pow
// segments (K1b), in every thread: Hs and its 3x3 factor F (l21 l31 l32
// and the inverse pivots) per slot.
template <typename R> struct Scale {
  R w[RPT], lam[RPT], sa[RPT], w0[RPT], lam0[RPT];
#if MK_NONSYM
  R ns_Hs[NSL][6], ns_F[NSL][6];
#endif
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
                                             const R (&z)[RPT], R mu,
                                             int strat, Scale<R>& sc) {
  sc.ident = false;
  bool ok = true;
#if MK_NONSYM
  // exp/pow segments: mu and strat choose Hs (Dual: mu H_dual;
  // PrimalDual: the BFGS form); a breakdown of the 3x3 factor is not fatal
  // (reference l.1397-1414)
#pragma unroll
  for (int u = 0; u < NSL; ++u) {
    if (g.ns_kind[u] == NO_ROW) continue;
    const double a = g.ns_a[u];
    double S3[3], Z3[3], gd[3], Hd[6], zt[3], pd[6];
    seg_gather3(g, g.ns_lo[u], s, S3);
    seg_gather3(g, g.ns_lo[u], z, Z3);
    bool feas;
    if (g.ns_kind[u] == SEG_EXP) {
      feas = exp_feas_dual(Z3) && exp_feas_primal(S3);
      exp_grad_hess_dual(Z3, gd, Hd);
      exp_grad_primal(S3, zt);
    } else {
      feas = pow_feas_dual(Z3, a) && pow_feas_primal(S3, a);
      pow_grad_hess_dual(Z3, a, gd, Hd);
      pow_grad_primal(S3, a, zt);
    }
    pd_scaling_3d(Hd, gd, zt, S3, Z3, pd);
    bool fin = true;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const double h = strat == PRIMAL_DUAL ? pd[k] : Hd[k] * mu;
      sc.ns_Hs[u][k] = h;
      fin = fin && isfinite(h);
    }
    ok = ok && feas && fin;
    chol3_fac(sc.ns_Hs[u], sc.ns_F[u]);
  }
#else
  (void)mu;
  (void)strat;
#endif
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
#if MK_NONSYM
#pragma unroll
    for (int u = 0; u < NSL; ++u) {
      if (g.ns_kind[u] == NO_ROW) continue;
      const R* h = sc.ns_Hs[u];   // h11, h22, h33
      mx = nmax(nmax(nmax(mx, mabs(h[0])), mabs(h[3])), mabs(h[5]));
    }
#endif
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
#if MK_NONSYM
  R ns[NSL][3];   // F^-1 v on each exp/pow segment
#pragma unroll
  for (int u = 0; u < NSL; ++u) {
    if (g.ns_kind[u] == NO_ROW || sc.ident) continue;
    R V3[3];
    seg_gather3(g, g.ns_lo[u], v, V3);
    chol3_solve_fac(sc.ns_F[u], V3, ns[u]);
  }
#endif
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] == SEG_ZERO) {
      out[r] = v[r] * (R(1) / eps);
    } else if (g.kind[r] == NO_ROW) {
      out[r] = R(0);
    } else if (sc.ident) {
      out[r] = v[r];
#if MK_NONSYM
    } else if (g.ns_of[r] >= 0) {
      R o = R(0);
#pragma unroll
      for (int u = 0; u < NSL; ++u)
        if (u == g.ns_of[r]) o = seg_pick3(g, r, g.ns_lo[u], ns[u]);
      out[r] = o;
#endif
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
#if MK_NONSYM
  R ns[NSL][3];   // Hs v on each exp/pow segment
#pragma unroll
  for (int u = 0; u < NSL; ++u) {
    if (g.ns_kind[u] == NO_ROW || sc.ident) continue;
    R V3[3];
    seg_gather3(g, g.ns_lo[u], v, V3);
    hmul3(sc.ns_Hs[u], V3, ns[u]);
  }
#endif
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (g.kind[r] == SEG_ZERO || g.kind[r] == NO_ROW) {
      out[r] = R(0);
    } else if (sc.ident) {
      out[r] = v[r];
#if MK_NONSYM
    } else if (g.ns_of[r] >= 0) {
      R o = R(0);
#pragma unroll
      for (int u = 0; u < NSL; ++u)
        if (u == g.ns_of[r]) o = seg_pick3(g, r, g.ns_lo[u], ns[u]);
      out[r] = o;
#endif
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
#if MK_NONSYM
  // F^-1 of every column of A on the exp/pow segments, at the owned rows
  R nsh[N][RPT];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    R col[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      col[r] = pr.A[r][j];
      nsh[j][r] = R(0);
    }
#pragma unroll
    for (int u = 0; u < NSL; ++u) {
      if (g.ns_kind[u] == NO_ROW || sc.ident) continue;
      R V3[3], X3[3];
      seg_gather3(g, g.ns_lo[u], col, V3);
      chol3_solve_fac(sc.ns_F[u], V3, X3);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        if (g.ns_of[r] == u) nsh[j][r] = seg_pick3(g, r, g.ns_lo[u], X3);
    }
  }
#endif
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
#if MK_NONSYM
      else if (g.ns_of[r] >= 0) h[j] = nsh[j][r];
#endif
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

#if MK_NONSYM
// ---- the searches of K1b, shared over the group ----
//
// The joint feasibility backtrack of a step length and the barrier
// backtrack of a Dual lane try alpha_k = alpha_0 * step^k for k = 0, 1, ...
// (k successive products) and keep the first alpha_k that passes.  The G
// threads of a lane's group hold its point and direction already, so they
// try G consecutive candidates side by side: in round r thread t tries
// k = r G + t, and the lane takes the first candidate of the round that
// passes (a ballot over the group), or, where none does, exactly what the
// serial loop leaves: 0 once alpha_k fell below min_terminate_step_length
// (feasibility), else alpha at the trip limit.  Each thread forms its
// candidate by the serial loop's products and tests it with the serial
// loop's code on the same values, so the lane's alpha is the serial
// loop's, and it reaches every thread by a shuffle from the thread that
// holds it.  The rounds run while no thread has settled the search, so
// the group's control flow stays uniform.

// this group's bits of a ballot, thread t at bit t
__device__ __forceinline__ unsigned group_ballot(const Grp& g, bool b) {
  const unsigned all = __ballot_sync(g.mask, b);
  return G == 32 ? all
                 : (all >> ((threadIdx.x % 32) / G * G)) & ((1u << G) - 1u);
}

// the thread of a round whose candidate the lane takes
__device__ __forceinline__ int first_hit(unsigned hits) {
#if MK_WRONG_SEARCH
  return 31 - __clz(hits);   // the wrong kernel: the last passing trial
#else
  return __ffs(hits) - 1;
#endif
}

// a lane's exp/pow segments at its point and along its direction, in
// every thread
struct NsPoint {
  double z[NSL][3], s[NSL][3], dz[NSL][3], ds[NSL][3];
};

__device__ __forceinline__ void ns_point(const Grp& g, const double (&z)[RPT],
                                         const double (&s)[RPT],
                                         const double (&dz)[RPT],
                                         const double (&ds)[RPT],
                                         NsPoint& pt) {
#pragma unroll
  for (int u = 0; u < NSL; ++u) {
    if (g.ns_kind[u] == NO_ROW) continue;
    seg_gather3(g, g.ns_lo[u], z, pt.z[u]);
    seg_gather3(g, g.ns_lo[u], s, pt.s[u]);
    seg_gather3(g, g.ns_lo[u], dz, pt.dz[u]);
    seg_gather3(g, g.ns_lo[u], ds, pt.ds[u]);
  }
}

// (z + a dz, s + a ds) strictly inside every exp/pow segment's dual and
// primal cone
__device__ __forceinline__ bool ns_feasible(const Grp& g, const NsPoint& pt,
                                            double a) {
  bool ok = true;
#pragma unroll
  for (int u = 0; u < NSL; ++u) {
    if (g.ns_kind[u] == NO_ROW) continue;
    double Z[3], Sv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Z[i] = pt.z[u][i] + a * pt.dz[u][i];
      Sv[i] = pt.s[u][i] + a * pt.ds[u][i];
    }
    if (g.ns_kind[u] == SEG_EXP)
      ok = ok && exp_feas_dual(Z) && exp_feas_primal(Sv);
    else
      ok = ok && pow_feas_dual(Z, g.ns_a[u]) && pow_feas_primal(Sv, g.ns_a[u]);
  }
  return ok;
}

// the joint feasibility backtrack from alpha0 (reference l.2091-2229)
__device__ __forceinline__ double feas_search(const Grp& g, const MkParams& p,
                                              const NsPoint& pt,
                                              double alpha0) {
  const double step = p.linesearch_backtrack_step;
  const double amin = p.min_terminate_step_length;
  double a = alpha0;
  bool cut = false;   // some alpha_i, 1 <= i <= k, fell below amin
  for (int i = 0; i < g.t; ++i) {
    a = a * step;
    cut = cut || a < amin;
  }
  for (int base = 0;; base += G) {
    const int k = base + g.t;
    const bool pass = k < FEAS_TRIPS && !cut && ns_feasible(g, pt, a);
    const unsigned hits = group_ballot(g, pass);
    const unsigned cuts = group_ballot(g, cut && k <= FEAS_TRIPS);
    if (hits) return __shfl_sync(g.mask, a, first_hit(hits), G);
    if (cuts) return 0.0;
    if (base + G > FEAS_TRIPS)
      return __shfl_sync(g.mask, a, FEAS_TRIPS - base, G);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      a = a * step;
      cut = cut || a < amin;
    }
  }
}

// the total barrier a step a along the direction, over the lane's whole
// rows in every thread (megakernel.cu's barrier_at, in its order of sums;
// reference barrier_at, l.2230-2269, in f32)
__device__ __forceinline__ double barrier_at(const MkParams& p,
                                             const double (&zf)[M],
                                             const double (&sf)[M],
                                             const double (&dzf)[M],
                                             const double (&dsf)[M],
                                             double tau, double kappa,
                                             double dtau, double dkappa,
                                             double a) {
  const double cur_tau = tau + a * dtau, cur_kappa = kappa + a * dkappa;
  double zs[M], ss[M], sz = 0.0;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    zs[k] = zf[k] + a * dzf[k];
    ss[k] = sf[k] + a * dsf[k];
    sz += zs[k] * ss[k];
  }
  const double deg1 = (double)(p.degree + 1);
  const double mu_a = (sz + cur_tau * cur_kappa) / deg1;
  double bar = deg1 * nslog(mu_a) - nslog(cur_tau) - nslog(cur_kappa);
#pragma unroll
  for (int sg = 0; sg < S; ++sg) {
    const int lo = p.seg_lo[sg], hi = p.seg_hi[sg];
    const int kind = p.seg_kind[sg];
    if (kind == SEG_NN) {
      double acc = 0.0;
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (i >= lo && i < hi) acc += nslog(ss[i] * zs[i]);
      bar = bar - acc;
    } else if (kind == SEG_SOC) {
      double s1 = 0.0, z1 = 0.0, s0 = 0.0, z0 = 0.0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i == lo) {
          s0 = ss[i];
          z0 = zs[i];
        }
        if (i > lo && i < hi) {
          s1 += ss[i] * ss[i];
          z1 += zs[i] * zs[i];
        }
      }
      const double rs = s0 * s0 - s1, rz = z0 * z0 - z1;
      bar = bar + ((rs > 0 && rz > 0) ? -0.5 * nslog(rs * rz) : BIG);
    } else if (kind == SEG_EXP || kind == SEG_POW) {
      double Z3[3] = {0.0, 0.0, 0.0}, S3[3] = {0.0, 0.0, 0.0};
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (i == lo + c) {
            Z3[c] = zs[i];
            S3[c] = ss[i];
          }
      bar = bar + nonsym_barrier(kind, p.seg_alpha[sg], Z3, S3);
    }
  }
  return bar;
}

// the barrier backtrack of a Dual lane from alpha0 (reference
// src/solver.jl:416-419)
__device__ __forceinline__ double barrier_search(
    const Grp& g, const MkParams& p, const double (&z)[RPT],
    const double (&s)[RPT], const double (&dz)[RPT], const double (&ds)[RPT],
    double tau, double kappa, double dtau, double dkappa, double alpha0) {
  double zf[M], sf[M], dzf[M], dsf[M];
  gather_m(g, z, zf);
  gather_m(g, s, sf);
  gather_m(g, dz, dzf);
  gather_m(g, ds, dsf);
  const double step = p.linesearch_backtrack_step;
  const int limit = p.linesearch_max_iter > 0 ? p.linesearch_max_iter : 0;
  double a = alpha0;
  for (int i = 0; i < g.t; ++i) a = a * step;
  for (int base = 0;; base += G) {
    const int k = base + g.t;
    const bool pass = k < limit && barrier_at(p, zf, sf, dzf, dsf, tau, kappa,
                                              dtau, dkappa, a) < 1.0;
    const unsigned hits = group_ballot(g, pass);
    if (hits) return __shfl_sync(g.mask, a, first_hit(hits), G);
    if (base + G > limit) return __shfl_sync(g.mask, a, limit - base, G);
#pragma unroll
    for (int i = 0; i < G; ++i) a = a * step;
  }
}
#endif  // MK_NONSYM

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
  alpha = nmin(amax, gmin1(g, alpha));
#if MK_NONSYM
  // capped, then backtracked jointly over the exp/pow segments
  // (reference l.2091-2229)
  alpha = nmin(alpha, R(STEP_CAP));
  NsPoint pt;
  ns_point(g, z, s, dz, ds, pt);
  alpha = feas_search(g, p, pt, alpha);
#endif
  return alpha;
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
#if MK_NONSYM
    else if (g.ns_of[r] >= 0) out[r] = s[r];
#endif
    else out[r] = R(0);
  }
}

// W dz - ... : sigma_mu shift of the combined step (reference
// combined_ds_shift): nn dz ds - sigma mu; soc (W^-1 ds) o (W dz) - sigma mu
// e; exp/pow sigma mu g(z) - eta, eta the third-order correction, with the
// dual gradient and Hessian at z computed again (as make_scaling computed
// them, to the bit)
template <typename R>
__device__ __forceinline__ void combined_ds_shift(const Grp& g,
                                                  const MkParams& p,
                                                  const Scale<R>& sc,
                                                  const R (&dz)[RPT],
                                                  const R (&ds)[RPT],
                                                  const R (&z)[RPT],
                                                  R sigma_mu, R (&out)[RPT]) {
#if MK_NONSYM
  R ns[NSL][3];
#pragma unroll
  for (int u = 0; u < NSL; ++u) {
    if (g.ns_kind[u] == NO_ROW) continue;
    double Z3[3], DS3[3], DZ3[3], gd[3], Hd[6], eta[3];
    seg_gather3(g, g.ns_lo[u], z, Z3);
    seg_gather3(g, g.ns_lo[u], ds, DS3);
    seg_gather3(g, g.ns_lo[u], dz, DZ3);
    ns_grad_hess_dual(g.ns_kind[u], g.ns_a[u], Z3, gd, Hd);
    if (g.ns_kind[u] == SEG_EXP)
      exp_higher_corr(Hd, Z3, DS3, DZ3, eta);
    else
      pow_higher_corr(Hd, Z3, g.ns_a[u], DS3, DZ3, eta);
#pragma unroll
    for (int i = 0; i < 3; ++i) ns[u][i] = gd[i] * sigma_mu - eta[i];
  }
#else
  (void)z;
#endif
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
#if MK_NONSYM
    else if (g.ns_of[r] >= 0) {
      R o = R(0);
#pragma unroll
      for (int u = 0; u < NSL; ++u)
        if (u == g.ns_of[r]) o = seg_pick3(g, r, g.ns_lo[u], ns[u]);
      out[r] = o;
    }
#endif
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
#if MK_NONSYM
    } else if (g.ns_of[r] >= 0) {
      out[r] = dsv[r];
#endif
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

// One Mehrotra predictor-corrector step (reference pc_step, l.2839-2977);
// on a Dual lane (K1b) the step is then backtracked to a barrier below 1
template <typename R>
__device__ __forceinline__ void pc_step(const Lane<R>& L, const Cfg<R>& cf,
                                        const R (&x)[CPT], const R (&z)[RPT],
                                        const R (&s)[RPT], R tau, R kappa,
                                        R tinv, const Res<R>& res, R mu,
                                        int iters1, int strat, Step<R>& st) {
  Scale<R> sc;
  Kkt<R> kk;
  const bool ok_scale = make_scaling(L.g, L.p, s, z, mu, strat, sc);
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
  combined_ds_shift(L.g, L.p, sc, dzm, dsa, z, sigma_mu, shift);
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
#if MK_NONSYM
  if (strat == DUAL)
    st.alpha = barrier_search(L.g, L.p, z, s, st.dz, st.ds, tau, kappa,
                              st.dtau, st.dkappa, st.alpha);
#endif
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
  // cone rectification: the mean on each segment that is not elementwise
  // (soc, exp, pow), summed in row order
  float full[M];
  gather_m(g, ef, full);
#pragma unroll
  for (int sg = 0; sg < S; ++sg) {
    if (p.seg_kind[sg] == SEG_ZERO || p.seg_kind[sg] == SEG_NN) continue;
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
#if MK_NONSYM
  // the unit point of every cone, x = 0
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) cy.x[cc] = 0.0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    double v = 0.0;
    if (g.kind[r] == SEG_NN || (g.kind[r] == SEG_SOC && g.head[r])) v = 1.0;
#pragma unroll
    for (int u = 0; u < NSL; ++u) {
      if (u != g.ns_of[r]) continue;
      const int off = row_of(g, r) - g.ns_lo[u];
      if (g.ns_kind[u] == SEG_EXP)
        v = off == 0 ? -1.051383945322714
                     : off == 1 ? 0.556409619469370 : 1.258967884768947;
      else
        v = off == 0 ? sqrt(1.0 + g.ns_a[u])
                     : off == 1 ? sqrt(2.0 - g.ns_a[u]) : 0.0;
    }
    cy.z[r] = v;
    cy.s[r] = v;
  }
#else
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
#endif
  cy.tau = cy.kappa = cy.ptau = cy.pkap = 1.0;
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) cy.px[cc] = cy.x[cc];
#pragma unroll
  for (int r = 0; r < RPT; ++r) { cy.pz[r] = cy.z[r]; cy.ps[r] = cy.s[r]; }
  cy.prev_rp = cy.prev_rd = cy.prev_ga = cy.prev_gr = BIG;
  cy.mu_f = BIG;
  cy.alpha_f = 0.0;
  cy.sigma_f = 1.0;
  int iters = 0, status = UNSOLVED, strat = 0;
#if MK_NONSYM
  strat = PRIMAL_DUAL;
#endif
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
      bool restart = false;
      if (status2 == INSUFFICIENT_PROGRESS) {
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) cy.x[cc] = cy.px[cc];
#pragma unroll
        for (int r = 0; r < RPT; ++r) { cy.z[r] = cy.pz[r]; cy.s[r] = cy.ps[r]; }
        cy.tau = cy.ptau;
        cy.kappa = cy.pkap;
#if MK_NONSYM
        // a PrimalDual lane downgrades to Dual and starts the next trip
        // from the restored iterate (reference l.3354-3383)
        if (strat == PRIMAL_DUAL) {
          strat = DUAL;
          restart = true;
        }
#endif
      }
      if (restart) continue;
      status = status2;
      break;
    }
    const int iters1 = iters + 1;
    Step<double> stp;
    pc_step(L, cfg, cy.x, cy.z, cy.s, tau, kappa, tinv, res, mu, iters1,
            strat, stp);

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
    ints[2 * B + lane] = strat;   // PrimalDual (0) but on a K1b lane
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
#if MK_NONSYM
  // the exp/pow segments in order, one slot each
#pragma unroll
  for (int u = 0; u < NSL; ++u) {
    g.ns_kind[u] = NO_ROW;
    g.ns_lo[u] = 0;
    g.ns_a[u] = 0.0;
  }
  int used = 0;
#pragma unroll
  for (int sg = 0; sg < S; ++sg) {
    const int kind = prm.seg_kind[sg];
    if (kind != SEG_EXP && kind != SEG_POW) continue;
#pragma unroll
    for (int u = 0; u < NSL; ++u)
      if (u == used) {
        g.ns_kind[u] = kind;
        g.ns_lo[u] = prm.seg_lo[sg];
        g.ns_a[u] = prm.seg_alpha[sg];
      }
    ++used;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = row_of(g, r);
    g.ns_of[r] = -1;
#pragma unroll
    for (int u = 0; u < NSL; ++u)
      if (g.ns_kind[u] != NO_ROW && k >= g.ns_lo[u] && k < g.ns_lo[u] + 3)
        g.ns_of[r] = u;
  }
#endif
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
