"""K2: the batched float32 LDLᵀ factor with an explicit L⁻¹.

The reference (`clarabel_tpu/linalg/pallas_ldl.py`) runs this as a Pallas
kernel over 128-instance lane blocks, reached from `vmap` through a JAX
primitive with a batching rule.  The port batches explicitly, so neither
the lane padding nor the primitive is needed: `batched_ldl_inverse` takes
the whole (B, N, N) batch.  On CUDA tensors it launches a hand-written
kernel and counts the launch: the rows design, built once per N with the
rows of an instance in registers, from `csrc/ldl_inverse_rows.cu` (one warp
an instance) for N ≤ ONE_WARP_MAX_N and from `csrc/ldl_inverse_rows_wide.cu`
(ceil(N/32) warps an instance) up to MAX_N.  `csrc/ldl_inverse.cu`, one
build for every N with the instance in shared memory, is the simple kernel
both are held to bit for bit; no path routes to it.  All three have the
same C interface.  On CPU tensors it runs `ldl_inverse_plain`, the same
column elimination in PyTorch.  A failed build or launch raises; nothing
falls back.

The solve with L⁻¹ (two batched products and a scale,
`linalg.ldl.ldl_solve_via_inverse`) stays as torch ops, as the JAX package
computes it outside Pallas too.
"""

import collections
import ctypes
import os

import torch

from ..cuda_build import CudaLibrary

MAX_N = 80   # the route rule (kkt/dense.py) sends N <= 80 here
ONE_WARP_MAX_N = 32   # csrc/ldl_inverse_rows.cu: one lane a row, one warp


def ldl_inverse_plain(K, signs, dyn_eps=1e-13, dyn_delta=2e-7,
                      dynamic_enable=True):
    """The plain version: `_ldl_inv_kernel`'s column elimination over a
    (B, N, N) float32 batch.  Returns (Linv (B, N, N), d (B, N), ok (B,))."""
    B, n, _ = K.shape
    K = K.clone()
    M = torch.eye(n, dtype=K.dtype, device=K.device).expand(B, n, n).clone()
    rows = torch.arange(n, device=K.device)
    signs = signs.to(K.dtype)
    d = torch.empty((B, n), dtype=K.dtype, device=K.device)
    for j in range(n):
        pivot = K[:, j, j]
        if dynamic_enable:
            sj = signs[j]
            pivot = torch.where(sj * pivot < dyn_eps, sj * dyn_delta, pivot)
        d[:, j] = pivot
        pivot_safe = torch.where(pivot != 0, pivot, torch.ones_like(pivot))
        colv = K[:, :, j] / pivot_safe[:, None]
        col = torch.where(rows > j, colv, torch.zeros_like(colv))
        K = K - col[:, :, None] * (pivot_safe[:, None] * col)[:, None, :]
        M = M - col[:, :, None] * M[:, j][:, None, :]
    ok = torch.isfinite(d).all(dim=1) & (d != 0).all(dim=1)
    return M, d, ok


class LdlInverseKernel(CudaLibrary):
    """The CUDA kernels' libraries and the launch counts.  A variant is
    (N,) for the rows design, built for that N alone (`-DK2_N=N`, so N is
    in the library's name) from `csrc/ldl_inverse_rows.cu` for
    N <= ONE_WARP_MAX_N and from `csrc/ldl_inverse_rows_wide.cu` above, or
    () for `csrc/ldl_inverse.cu`, whose one build takes every N up to 80
    (a subclass pins it to compare the designs).  `launches` counts every
    launch and `source_launches` the launches of each source, by its file
    name."""

    def __init__(self):
        super().__init__("ldl_inverse.cu", macros=("K2_N",), tags=("n",))
        self.launches = 0
        self.source_launches = collections.Counter()

    def reset_counts(self) -> None:
        """Set every launch count to 0."""
        self.launches = 0
        self.source_launches.clear()

    def source_for(self, variant=()) -> str:
        if not variant:
            return self.source
        name = ("ldl_inverse_rows.cu" if variant[0] <= ONE_WARP_MAX_N
                else "ldl_inverse_rows_wide.cu")
        return os.path.join(os.path.dirname(self.source), name)

    def variant(self, n: int):
        """The library an (B, n, n) batch launches: the rows design built
        for n."""
        return (n,)

    def bind(self, lib: ctypes.CDLL, variant) -> None:
        vp = ctypes.c_void_p
        lib.ldl_inverse.argtypes = [vp, vp, ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_float, ctypes.c_float,
                                    ctypes.c_int, vp, vp, vp, vp]
        lib.ldl_inverse.restype = ctypes.c_int
        lib.ldl_max_n.argtypes = []
        lib.ldl_max_n.restype = ctypes.c_int
        want = variant[0] if variant else MAX_N
        if lib.ldl_max_n() != want:
            raise RuntimeError(f"{self.lib_path(variant)} takes N up to "
                               f"{lib.ldl_max_n()}, not {want}")

    def __call__(self, K, signs, dyn_eps, dyn_delta, dynamic_enable):
        """Launch over the batch; returns (Linv, d, ok) on K's device."""
        if K.device.type != "cuda" or signs.device != K.device:
            raise ValueError("K and signs must be on one CUDA device")
        if K.dtype != torch.float32 or signs.dtype != torch.float32:
            raise ValueError(f"K and signs must be float32, got {K.dtype} "
                             f"and {signs.dtype}")
        if K.dim() != 3 or K.shape[1] != K.shape[2]:
            raise ValueError(f"K must be (B, N, N), got {tuple(K.shape)}")
        B, n, _ = K.shape
        if not 1 <= n <= MAX_N:
            raise ValueError(f"N must be in 1..{MAX_N}, got {n}")
        if signs.shape != (n,):
            raise ValueError(f"signs must be ({n},), got {tuple(signs.shape)}")
        K = K.contiguous()
        signs = signs.contiguous()
        Linv = torch.empty_like(K)
        d = torch.empty((B, n), dtype=K.dtype, device=K.device)
        ok = torch.empty((B,), dtype=torch.bool, device=K.device)
        if B == 0:
            return Linv, d, ok
        variant = self.variant(n)
        lib = self.load(variant)
        with torch.cuda.device(K.device):
            stream = torch.cuda.current_stream(K.device).cuda_stream
            rc = lib.ldl_inverse(K.data_ptr(), signs.data_ptr(), n, B,
                                 float(dyn_eps), float(dyn_delta),
                                 int(bool(dynamic_enable)), Linv.data_ptr(),
                                 d.data_ptr(), ok.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"ldl_inverse launch failed: CUDA error {rc}")
        self.launches += 1
        self.source_launches[os.path.basename(self.source_for(variant))] += 1
        return Linv, d, ok


kernel = LdlInverseKernel()


def batched_ldl_inverse(K, signs, dyn_eps=1e-13, dyn_delta=2e-7,
                        dynamic_enable=True):
    """LDLᵀ and L⁻¹ of a (B, N, N) float32 batch with static pivot signs
    (N,).  Returns (Linv (B, N, N), d (B, N), ok (B,)): the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors; mixed devices raise."""
    devs = {K.device.type, signs.device.type}
    if devs == {"cuda"}:
        return kernel(K, signs, dyn_eps, dyn_delta, dynamic_enable)
    if devs == {"cpu"}:
        return ldl_inverse_plain(K, signs, dyn_eps, dyn_delta,
                                 dynamic_enable)
    raise ValueError(f"K and signs on mixed devices: {sorted(devs)}")
