// Batched LDL^T factor of quasidefinite KKT matrices with the explicit
// inverse of the unit lower factor, in float32 (K2), for 32 < N <= 80: one
// library per N, the rows of an instance in registers over ceil(N/32) warps.
//
// Replaces: clarabel_tpu/linalg/pallas_ldl.py `_ldl_inv_kernel` (launched by
// `batched_ldl_inverse`) for 32 < N <= 80; csrc/ldl_inverse_rows.cu takes
// N <= 32.  It computes the column elimination of that file's header, as
// csrc/ldl_inverse.cu (the simple kernel this design is held to, bit for
// bit) and the plain PyTorch version
// clarabel_tpu_torch/linalg/batched_ldl.py `ldl_inverse_plain` do, updating
// each entry by the same expression in the same order of j.
//
// What bounds it on this card: bytes.  An instance must read K's lower
// triangle once (440 32-byte sectors at N = 80) and write N x N of L^-1,
// N of d and one byte of ok: at N = 80 and B = 65536 that is 2.622 GB,
// 0.783 ms at 3.35 TB/s, against about 2N^3/3 float32 operations an
// instance (0.340 ms at 67 TFLOP/s).  This kernel stages the whole of K
// (25,600 B an instance at N = 80, where 14,080 would do).
//
// What held csrc/ldl_inverse.cu back there: one warp an instance with
// 2N^2 + 3N floats of shared memory (52 KB at N = 80), so that an SM ran 4
// warps; a run-time N, so that every element loop divides by it; updates
// of both triangles of K and of every entry of L^-1 at every step, four
// times the entries that can change; and two passes through shared memory
// a step.
//
// The design: N is a compile-time constant (-DK2_N), so every loop below
// unrolls and every register index is compile-time (nothing on the
// stack).  One block an instance, W = ceil(N/32) warps, thread i owning
// row i in one register array r of N floats: slot k holds K[i][k] while
// k > j and L^-1[i][k] once k <= j (slot i, the pivot's, is never an entry
// of L^-1, which is 1 there; slots above i hold values no one reads).  At
// step j every thread has the pivot, published and regularized in step
// j - 1; thread i > j forms col_i = K[i][j] / pivot and writes
// t_i = pivot * col_i to a shared vector x, thread j writes row j of L^-1
// (final after step j - 1) into x's first j entries, and thread j + 1
// writes its updated diagonal K[j+1][j+1] - col_{j+1} t_{j+1} (the
// expression of its own update), regularized, as the next pivot.  One
// barrier: x is double-buffered, so no other is needed in the step.  Then
// thread i > j reads x with 16-byte broadcast loads and updates its row:
// slot j becomes 0 - col_i (0 - col_i * 1 exactly), every other slot
// r[k] - col_i * x[k].  A warp whose rows are all at or above j skips the
// update.  K is staged into shared memory with 16-byte loads at an odd row
// pitch, so that threads reading their rows meet no bank conflict, and
// L^-1 goes back the same way: global memory is read and written in whole
// lines.  No tensor cores: the elimination is a sequence of rank-1 updates
// whose bits must equal csrc/ldl_inverse.cu's, entry by entry, and TF32 or
// bf16 wgmma would change them.
//
// The entries this elimination skips change in csrc/ldl_inverse.cu's
// full-row update only through a non-finite value (0 * inf = NaN), which
// leaves a non-finite entry in the L^-1 computed here (DEVIATIONS.md #16).
// So an instance whose L^-1 ends with one runs the elimination again, K
// staged anew from global memory into registers and L^-1 in the shared
// tile, with csrc/ldl_inverse.cu's full-row update (every row, every
// column), and every instance gets that kernel's d, L^-1 and ok to the bit.
//
// Build (route (b): a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DK2_N=80 -o ldl_inverse_rows_wide.so \
//        ldl_inverse_rows_wide.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef K2_N
#error "build with -DK2_N=<N>, the one N (33 to 80) this library takes"
#endif

namespace {

constexpr int N = K2_N;
static_assert(N >= 33 && N <= 80, "rows over several warps: N is 33 to 80");
constexpr int THREADS = 32 * ((N + 31) / 32);   // one block an instance
constexpr int PITCH = N | 1;                    // odd row pitch of the tile
constexpr int XN = (N + 3) / 4 * 4;             // x in whole float4s, ...
constexpr int XS = XN + 4;                      // ... then the next pivot
// registers: the row's N floats and the 16-byte loads of x in flight, at
// least 48 and up to about N more (ptxas spilled at N = 80 under 128 and
// did not under 168); as many blocks an SM as those leave room for
constexpr int REGS = ((N + 48 > 2 * N + 8 ? N + 48 : 2 * N + 8) + 7) / 8 * 8;
constexpr int MIN_BLOCKS = 65536 / (THREADS * REGS);

// Entry e of a row-major N x N matrix in the tile.
__device__ __forceinline__ int at(int e) { return e / N * PITCH + e % N; }

// Floats of src (an instance's N x N block in global memory) before the
// first 16-byte boundary.
__device__ __forceinline__ int lead(const float* p) {
  const int head = (int)(((16 - ((uintptr_t)p & 15)) & 15) >> 2);
  return head < N * N ? head : N * N;
}

// K's block into the tile, 16 bytes a thread between the ragged ends.
// (No shared-memory pointer here is __restrict__: other threads write
// through it between barriers, and restrict would let the compiler move
// its loads across them.)
__device__ __forceinline__ void stage_in(float* tile,
                                         const float* __restrict__ src) {
  const int head = lead(src);
  const int quads = (N * N - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int e = threadIdx.x; e < head; e += THREADS) tile[at(e)] = src[e];
  for (int q = threadIdx.x; q < quads; q += THREADS) {
    const float4 v = s4[q];
    const int e = head + 4 * q;
    tile[at(e)] = v.x;
    tile[at(e + 1)] = v.y;
    tile[at(e + 2)] = v.z;
    tile[at(e + 3)] = v.w;
  }
  for (int e = head + 4 * quads + threadIdx.x; e < N * N; e += THREADS)
    tile[at(e)] = src[e];
}

// The tile (L^-1) into dst's N x N block, the same way.
__device__ __forceinline__ void stage_out(float* __restrict__ dst,
                                          const float* tile) {
  const int head = lead(dst);
  const int quads = (N * N - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int e = threadIdx.x; e < head; e += THREADS) dst[e] = tile[at(e)];
  for (int q = threadIdx.x; q < quads; q += THREADS) {
    const int e = head + 4 * q;
    d4[q] = make_float4(tile[at(e)], tile[at(e + 1)], tile[at(e + 2)],
                        tile[at(e + 3)]);
  }
  for (int e = head + 4 * quads + threadIdx.x; e < N * N; e += THREADS)
    dst[e] = tile[at(e)];
}

// The pivot under the sign-aware dynamic regularization.
__device__ __forceinline__ float regularize(float pivot, float sj,
                                            float dyn_eps, float dyn_delta,
                                            int dyn_enable) {
  return (dyn_enable && sj * pivot < dyn_eps) ? sj * dyn_delta : pivot;
}

// r[j] for a run-time j (the redo's loop over j does not unroll).
__device__ __forceinline__ float pick(const float (&r)[N], int j) {
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) v = k == j ? r[k] : v;
  return v;
}

// The instance again with csrc/ldl_inverse.cu's full-row update: K staged
// anew from Kg, its row in registers (the lower triangle is all that is
// read), L^-1's rows in the tile.  Leaves L^-1 in the tile and the pivots
// in dg (thread 0 stores each); returns whether every pivot was finite and
// non-zero.
__device__ __forceinline__ bool eliminate_full(
    float* tile, float* tb, float* mrow, const float* __restrict__ Kg,
    int row, const float* __restrict__ signs, float dyn_eps,
    float dyn_delta, int dyn_enable, float* __restrict__ dg) {
  const bool mine = row < N;
  float* piv = tb + XN;
  stage_in(tile, Kg);
  __syncthreads();
  float r[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    r[k] = (mine && k <= row) ? tile[row * PITCH + k] : 0.f;
  __syncthreads();   // every row read before the tile becomes L^-1
  if (mine)
    for (int k = 0; k < N; ++k) tile[row * PITCH + k] = k == row ? 1.f : 0.f;
  bool good = true;
#pragma unroll 1
  for (int j = 0; j < N; ++j) {
    if (row == j) *piv = pick(r, j);
    __syncthreads();
    const float pivot =
        regularize(*piv, signs[j], dyn_eps, dyn_delta, dyn_enable);
    good = good && isfinite(pivot) && pivot != 0.f;
    if (row == 0) dg[j] = pivot;
    const float ps = pivot != 0.f ? pivot : 1.f;
    const bool below = mine && row > j;
    const float c = below ? pick(r, j) / ps : 0.f;
    const float t = ps * c;
    if (mine) tb[row] = t;
    if (row == j)
      for (int k = 0; k < N; ++k) mrow[k] = tile[j * PITCH + k];
    __syncthreads();
    if (mine) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (below && k > j) r[k] = r[k] - c * tb[k];
      float* mi = tile + row * PITCH;
      for (int k = 0; k < N; ++k) mi[k] = mi[k] - c * mrow[k];
    }
  }
  __syncthreads();
  return good;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ldl_rows_wide_kernel(const float* __restrict__ K,
                     const float* __restrict__ signs, float dyn_eps,
                     float dyn_delta, int dyn_enable,
                     float* __restrict__ Linv, float* __restrict__ d,
                     unsigned char* __restrict__ ok) {
  __shared__ __align__(16) float tile[N * PITCH];
  __shared__ __align__(16) float xs[2][XS];
  const long long inst = blockIdx.x;
  const int row = threadIdx.x;
  const bool mine = row < N;
  const float* Kg = K + inst * (N * N);
  stage_in(tile, Kg);
  __syncthreads();

  float r[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    r[k] = (mine && k <= row) ? tile[row * PITCH + k] : 0.f;
  // the sign of the row's pivot, for the thread that publishes it
  const float my_sign = mine ? signs[row] : 0.f;
  float pivot = regularize(tile[0], signs[0], dyn_eps, dyn_delta,
                           dyn_enable);
  float dj = 0.f;
  bool good = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    good = good && isfinite(pivot) && pivot != 0.f;
    if (row == j) dj = pivot;
    if (j == N - 1) break;
    float* x = xs[j & 1];
    const float ps = pivot != 0.f ? pivot : 1.f;
    const bool below = mine && row > j;
    const float c = below ? r[j] / ps : 0.f;
    const float t = ps * c;
    if (below) x[row] = t;
    if (row == j) {
#pragma unroll
      for (int k = 0; k + 4 <= j; k += 4)
        *reinterpret_cast<float4*>(x + k) =
            make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]);
#pragma unroll
      for (int k = j / 4 * 4; k < j; ++k) x[k] = r[k];
    }
    if (row == j + 1)
      x[XN] = regularize(r[j + 1] - c * t, my_sign, dyn_eps, dyn_delta,
                         dyn_enable);
    __syncthreads();
    pivot = x[XN];
    if (below) {
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + k0);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u < N ? k0 + u : N - 1;
          if (k0 + u < N) r[k] = k == j ? 0.f - c : r[k] - c * xv[u];
        }
      }
    }
  }

  // L^-1's row into the tile: entries left of the diagonal, 1, zeros
  bool bad = false;
  if (mine) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < row) bad = bad || !isfinite(r[k]);
      tile[row * PITCH + k] = k < row ? r[k] : (k == row ? 1.f : 0.f);
    }
  }
  if (__syncthreads_or(bad))
    good = eliminate_full(tile, xs[0], xs[1], Kg, row, signs, dyn_eps,
                          dyn_delta, dyn_enable, d + inst * N);
  else if (mine)
    d[inst * N + row] = dj;
  if (row == 0) ok[inst] = good ? 1 : 0;
  stage_out(Linv + inst * (N * N), tile);
}

}  // namespace

extern "C" {

// The one N this library takes.
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
  if (n != N || B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ldl_rows_wide_kernel<<<(unsigned)B, THREADS, 0, (cudaStream_t)stream>>>(
      K, signs, dyn_eps, dyn_delta, dyn_enable, Linv, d, ok);
  return (int)cudaGetLastError();
}

}  // extern "C"
