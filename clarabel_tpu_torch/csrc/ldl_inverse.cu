// Batched LDL^T factor of quasidefinite KKT matrices with the explicit
// inverse of the unit lower factor, in float32 (K2): the simple kernel the
// rows design (csrc/ldl_inverse_rows.cu for N <= 32,
// csrc/ldl_inverse_rows_wide.cu up to 80) is held to, bit for bit.  No
// path routes to it.
//
// Replaced: clarabel_tpu/linalg/pallas_ldl.py `_ldl_inv_kernel` (launched by
// `batched_ldl_inverse`), until the rows design took every N.  It
// computes what that kernel and the plain
// PyTorch version clarabel_tpu_torch/linalg/batched_ldl.py
// `ldl_inverse_plain` compute, column by column: for j = 0..N-1 the pivot
// is K[j,j]; with dynamic regularization on, a pivot with s_j * pivot < eps
// becomes s_j * delta (QDLDL's sign-aware rule on static signs); d_j records
// it; the column below the pivot is K[i,j] / pivot (a zero pivot divides as
// 1); the trailing update is K[i,k] -= col_i * (pivot * col_k); and the
// inverse of L accumulates as M[i,:] -= col_i * M[j,:].  ok is
// all-finite(d) and all(d != 0).
//
// What bounds it on this card: bytes, at every N.  An instance must read
// K's lower triangle once (the 32-byte sectors its rows touch) and write
// N x N of L^-1, N of d and one byte of ok, against about 2N^3/3 float32
// operations that the algorithm needs: at B = 65536, 184 MB (0.055 ms at
// 3.35 TB/s) against 0.004 ms at 67 TFLOP/s at N = 19, and 2.622 GB
// (0.783 ms) against 0.340 ms at N = 80.  This kernel reads the whole of
// K, and its full-row updates are its own excess, about four times the
// entries that can change.
//
// What the design does about it: one warp per instance, with K and the
// growing L^-1 in shared memory (2 N^2 floats, plus the current column, its
// scaled copy and the pivot row of L^-1).  The loads and stores of K and
// L^-1 are lane-strided over the contiguous N x N block, so a warp moves
// 128 contiguous bytes at a time.  Each elimination step spreads the
// trailing update over the 32 lanes; every lane computes the pivot itself,
// so the only synchronisation is __syncwarp.  The elimination itself is
// sequential in j, as in the reference, so this is a simple kernel that is
// right, not a fast one; N is a run-time argument up to 80, so one build
// serves every shape.  Only the rows and columns after j of K change at
// step j: the other entries of the reference's full-shape update are never
// read again.  The update of L^-1 covers every row, as the reference's does,
// so that non-finite inputs propagate the same way.
//
// Build (route (b): a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o ldl_inverse.so ldl_inverse.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_N = 80;
constexpr int MAX_WARPS = 8;                 // warps (instances) per block
constexpr size_t SMEM_BUDGET = 96 * 1024;    // shared memory per block
constexpr size_t SMEM_DEFAULT = 48 * 1024;   // above this, opt in

__host__ __device__ inline size_t floats_per_warp(int n) {
  return 2 * (size_t)n * n + 3 * (size_t)n;
}

__global__ void ldl_inv_kernel(const float* __restrict__ K,
                               const float* __restrict__ signs, int n,
                               long long B, float dyn_eps, float dyn_delta,
                               int dyn_enable, float* __restrict__ Linv,
                               float* __restrict__ d,
                               unsigned char* __restrict__ ok) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long inst = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (inst >= B) return;   // the whole warp leaves: no block-wide barrier

  const int nn = n * n;
  float* Ks = smem + (size_t)warp * floats_per_warp(n);   // K, updated
  float* Ms = Ks + nn;                                    // L^-1
  float* col = Ms + nn;                                   // column of L
  float* t = col + n;                                     // pivot * col
  float* mrow = t + n;                                    // row j of L^-1

  const float* Kg = K + inst * nn;
  for (int e = lane; e < nn; e += 32) {
    Ks[e] = Kg[e];
    Ms[e] = (e / n == e % n) ? 1.f : 0.f;
  }
  __syncwarp();

  bool good = true;
  for (int j = 0; j < n; ++j) {
    float pivot = Ks[j * n + j];
    if (dyn_enable) {
      const float sj = signs[j];
      if (sj * pivot < dyn_eps) pivot = sj * dyn_delta;
    }
    good = good && isfinite(pivot) && pivot != 0.f;
    if (lane == 0) d[inst * n + j] = pivot;
    const float ps = pivot != 0.f ? pivot : 1.f;
    for (int i = lane; i < n; i += 32) {
      const float c = i > j ? Ks[i * n + j] / ps : 0.f;
      col[i] = c;
      t[i] = ps * c;
      mrow[i] = Ms[j * n + i];
    }
    __syncwarp();
    const int r = n - j - 1;
    for (int e = lane; e < r * r; e += 32) {
      const int i = j + 1 + e / r;
      const int k = j + 1 + e % r;
      Ks[i * n + k] = Ks[i * n + k] - col[i] * t[k];
    }
    for (int e = lane; e < nn; e += 32) {
      const int i = e / n;
      const int k = e % n;
      Ms[e] = Ms[e] - col[i] * mrow[k];
    }
    __syncwarp();
  }

  float* Lg = Linv + inst * nn;
  for (int e = lane; e < nn; e += 32) Lg[e] = Ms[e];
  if (lane == 0) ok[inst] = good ? 1 : 0;
}

}  // namespace

extern "C" {

// The largest N this library takes.
int ldl_max_n() { return MAX_N; }

// Factor B instances on `stream`.  K is (B, n, n) float32, contiguous and
// symmetric; signs (n,) float32; Linv (B, n, n) and d (B, n) float32; ok (B,)
// bytes.  Returns cudaGetLastError() after the launch (or the error of the
// shared-memory opt-in).
int ldl_inverse(const float* K, const float* signs, int n, long long B,
                float dyn_eps, float dyn_delta, int dyn_enable, float* Linv,
                float* d, unsigned char* ok, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const size_t per_warp = floats_per_warp(n) * sizeof(float);
  int warps = (int)(SMEM_BUDGET / per_warp);
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  if (warps < 1) warps = 1;
  const size_t smem = per_warp * warps;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        ldl_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (B + warps - 1) / warps;
  ldl_inv_kernel<<<(unsigned)blocks, 32 * warps, smem,
                   (cudaStream_t)stream>>>(K, signs, n, B, dyn_eps,
                                           dyn_delta, dyn_enable, Linv, d,
                                           ok);
  return (int)cudaGetLastError();
}

}  // extern "C"
