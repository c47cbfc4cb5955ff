// Batched LDL^T factor of quasidefinite KKT matrices with the explicit
// inverse of the unit lower factor, in float32 (K2), for N <= 32: one
// library per N, with the rows of an instance in registers.
//
// Replaces: clarabel_tpu/linalg/pallas_ldl.py `_ldl_inv_kernel` (launched by
// `batched_ldl_inverse`) for N <= 32 (N = 19 at the bench shape);
// csrc/ldl_inverse_rows_wide.cu takes 32 < N <= 80 the same way over
// several warps.  It computes what csrc/ldl_inverse.cu (the simple kernel
// this design is held to, bit for bit) and the plain PyTorch version
// clarabel_tpu_torch/linalg/batched_ldl.py `ldl_inverse_plain` compute:
// for j = 0..N-1 the pivot K[j,j], regularized by the sign-aware rule when
// dynamic regularization is on (s_j * pivot < eps becomes s_j * delta); d_j
// records it; col_i = K[i,j] / pivot below it (a zero pivot divides as 1);
// the trailing update K[i,k] -= col_i * (pivot * col_k); and
// M[i,:] -= col_i * M[j,:], M = L^-1.  ok is all-finite(d) and all(d != 0).
// Each entry is updated by the same expression in the same order of j as
// in csrc/ldl_inverse.cu, so both kernels give the same bits.
//
// What bounds it on this card: bytes.  An instance must read K's lower
// triangle once (the 32-byte sectors its rows touch) and write N x N of
// L^-1, N of d and one byte of ok: at N = 19 and B = 65536 that is 184 MB,
// 0.055 ms at 3.35 TB/s, against about 2N^3/3 float32 operations an
// instance (0.004 ms at 67 TFLOP/s).  This kernel stages the whole of K.
//
// What held csrc/ldl_inverse.cu back there (1.11 ms at N = 19): N is a
// run-time argument, so every element loop divides indices by run-time
// values; it updates every entry of L^-1 at every step where only
// (N - j - 1)(j + 1) can change; its trailing update covers both triangles
// of K; and every step ends in __syncwarp over shared memory.
//
// The design: N is a compile-time constant (-DK2_N), so every loop below
// unrolls and every register array is indexed by compile-time indices.
// One warp per instance, lane i owning row i: it holds row i of K's lower
// triangle and row i of L^-1 in registers.  At step j the pivot comes from
// lane j by a shuffle, every lane applies the regularization, lane i > j
// forms col_i = K[i][j] / pivot, each t_k = pivot * col_k is broadcast
// from lane k, and lane i updates K[i][k] for j < k <= i (the entries above
// the diagonal are never read) and M[i][k] for k <= j, with M[j][k]
// broadcast from lane j (row j of L^-1 is zero right of column j).  No
// shared memory and no __syncwarp inside the elimination.  A block of
// WARPS warps takes WARPS consecutive instances, whose K's are one
// contiguous range: the block stages it into shared memory with 16-byte
// loads, and writes L^-1 back the same way, so that global memory is read
// and written in whole lines (a lane reading its row straight from global
// memory would stride by 4N bytes).
//
// The entries this elimination skips change in csrc/ldl_inverse.cu's
// full-row update only through a non-finite value (0 * inf = NaN): a col_i
// or an entry of L^-1 that is not finite, and either leaves a non-finite
// entry in the L^-1 this kernel computes.  So an instance whose L^-1 ends
// with one runs the elimination again from its K in shared memory with
// the full-row update (every lane, every column), and every instance gets
// csrc/ldl_inverse.cu's d and L^-1 to the bit (DEVIATIONS.md #16).
//
// Build (route (b): a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DK2_N=19 -o ldl_inverse_rows.so ldl_inverse_rows.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef K2_N
#error "build with -DK2_N=<N>, the one N (1 to 32) this library takes"
#endif

namespace {

constexpr int N = K2_N;
static_assert(N >= 1 && N <= 32, "one lane a row: N is 1 to 32");
constexpr int WARPS = 8;                  // instances (warps) per block
constexpr int THREADS = 32 * WARPS;
// 4 blocks an SM (32 warps): at most 64 registers a thread
constexpr int MIN_BLOCKS = 4;
constexpr int TILE = WARPS * N * N;       // floats of K, then of L^-1
constexpr unsigned FULL = 0xffffffffu;

// Copy `count` floats from src to dst, 16 bytes a thread where both are
// 16-byte aligned, the tail (or everything, unaligned) a float at a time.
__device__ __forceinline__ void block_copy(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int count) {
  int done = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int quads = count / 4;
    for (int e = threadIdx.x; e < quads; e += THREADS)
      reinterpret_cast<float4*>(dst)[e] =
          reinterpret_cast<const float4*>(src)[e];
    done = quads * 4;
  }
  for (int e = done + threadIdx.x; e < count; e += THREADS) dst[e] = src[e];
}

// The elimination of the warp's instance from row `lane` of its K (`mine`,
// lower triangle): L^-1's row in Mr, the lane's pivot in dj, and whether
// every pivot was finite and non-zero.  ALL: csrc/ldl_inverse.cu's full-row
// update of L^-1 (every lane, every column), else the update of the
// entries that can change, k <= j on the lanes below j.
template <bool ALL>
__device__ __forceinline__ bool eliminate(const float* mine, bool load,
                                          int lane,
                                          const float* __restrict__ signs,
                                          float dyn_eps, float dyn_delta,
                                          int dyn_enable, float (&Mr)[N],
                                          float& dj) {
  float Kr[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    Kr[k] = (load && k <= lane) ? mine[k] : 0.f;
    Mr[k] = k == lane ? 1.f : 0.f;
  }
  bool good = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float pivot = __shfl_sync(FULL, Kr[j], j);
    if (dyn_enable) {
      const float sj = signs[j];
      if (sj * pivot < dyn_eps) pivot = sj * dyn_delta;
    }
    good = good && isfinite(pivot) && pivot != 0.f;
    if (lane == j) dj = pivot;
    const float ps = pivot != 0.f ? pivot : 1.f;
    const bool below = lane > j;
    const float c = below ? Kr[j] / ps : 0.f;
    const float t = ps * c;
#pragma unroll
    for (int k = j + 1; k < N; ++k) {
      const float tk = __shfl_sync(FULL, t, k);
      if (k <= lane) Kr[k] = Kr[k] - c * tk;
    }
#pragma unroll
    for (int k = 0; k < (ALL ? N : j + 1); ++k) {
      const float mjk = __shfl_sync(FULL, Mr[k], j);
      if (ALL || below) Mr[k] = Mr[k] - c * mjk;
    }
  }
  return good;
}

// The instance again with the full-row update, its L^-1 row stored to
// `mine`, its pivot to d[lane] and its ok flag to *ok; out of line, so that
// the common path keeps its registers.
__device__ __noinline__ void eliminate_full(float* mine, bool load,
                                            bool live, int lane,
                                            const float* __restrict__ signs,
                                            float dyn_eps, float dyn_delta,
                                            int dyn_enable,
                                            float* __restrict__ d,
                                            unsigned char* __restrict__ ok) {
  float Mr[N];
  float dj = 0.f;
  const bool good = eliminate<true>(mine, load, lane, signs, dyn_eps,
                                    dyn_delta, dyn_enable, Mr, dj);
  __syncwarp();
  if (live) {
    if (lane < N) {
#pragma unroll
      for (int k = 0; k < N; ++k) mine[k] = Mr[k];
      d[lane] = dj;
    }
    if (lane == 0) *ok = good ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ldl_rows_kernel(const float* __restrict__ K, const float* __restrict__ signs,
                long long B, float dyn_eps, float dyn_delta, int dyn_enable,
                float* __restrict__ Linv, float* __restrict__ d,
                unsigned char* __restrict__ ok) {
  __shared__ __align__(16) float tile[TILE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * WARPS;
  const int here = (int)(B - first < WARPS ? B - first : WARPS);
  const long long base = first * (N * N);
  block_copy(tile, K + base, here * N * N);
  __syncthreads();

  const bool live = warp < here;   // warp-uniform
  const bool load = live && lane < N;
  float* mine = tile + warp * (N * N) + lane * N;
  const long long inst = first + warp;
  float Mr[N];
  float dj = 0.f;
  const bool good = eliminate<false>(mine, load, lane, signs, dyn_eps,
                                     dyn_delta, dyn_enable, Mr, dj);
  bool finite = true;
#pragma unroll
  for (int k = 0; k < N; ++k) finite = finite && isfinite(Mr[k]);
  if (__any_sync(FULL, load && !finite)) {
    eliminate_full(mine, load, live, lane, signs, dyn_eps, dyn_delta,
                   dyn_enable, d + inst * N, ok + inst);
  } else if (live) {
    if (lane < N) {
#pragma unroll
      for (int k = 0; k < N; ++k) mine[k] = Mr[k];
      d[inst * N + lane] = dj;
    }
    if (lane == 0) ok[inst] = good ? 1 : 0;
  }
  __syncthreads();
  block_copy(Linv + base, tile, here * N * N);
}

}  // namespace

extern "C" {

// The one N this library takes (csrc/ldl_inverse.cu's function of the same
// name gives the largest N it takes).
int ldl_max_n() { return N; }

// Factor B instances on `stream`, as csrc/ldl_inverse.cu's function of the
// same name: K is (B, n, n) float32, contiguous and symmetric (only its
// lower triangle is read); signs (n,) float32; Linv (B, n, n) and d (B, n)
// float32; ok (B,) bytes.  n must be this library's N.  Returns
// cudaGetLastError() after the launch.
int ldl_inverse(const float* K, const float* signs, int n, long long B,
                float dyn_eps, float dyn_delta, int dyn_enable, float* Linv,
                float* d, unsigned char* ok, void* stream) {
  if (B <= 0) return 0;
  if (n != N) return (int)cudaErrorInvalidValue;
  const long long blocks = (B + WARPS - 1) / WARPS;
  ldl_rows_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      K, signs, B, dyn_eps, dyn_delta, dyn_enable, Linv, d, ok);
  return (int)cudaGetLastError();
}

}  // extern "C"
