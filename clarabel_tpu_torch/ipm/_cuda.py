"""Build, bind and launch the CUDA megakernel (`csrc/megakernel.cu`).

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C interface and loaded with ctypes: one library per problem shape
(n, m, number of cone segments), built at first use from the sources in
this package into `build/kernels/` beside the package (a directory that
`.gitignore` lists).  The library name carries a hash of the source and
the flags, so an edited source builds anew.

`megakernel(Ptri, q, A, b, spec, B)` checks its inputs, allocates the outputs
with `torch.empty`, launches on the current stream and counts the launch.
It never falls back to the plain version: a failed build or launch raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "megakernel.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_SEG_CODES = {"zero": 0, "nn": 1, "soc": 2}

Shape = Tuple[int, int, int]   # (n, m, number of segments)


@functools.lru_cache(maxsize=None)
def _params_struct(nseg: int):
    """The ctypes mirror of MkParams for `nseg` cone segments (one class
    per count: ctypes checks a by-value argument's class)."""
    seg = ctypes.c_int * nseg

    class MkParams(ctypes.Structure):
        _fields_ = [
            ("eq_min_scaling", ctypes.c_double),
            ("eq_max_scaling", ctypes.c_double),
            ("static_reg_constant", ctypes.c_double),
            ("static_reg_proportional", ctypes.c_double),
            ("refine_abstol", ctypes.c_double),
            ("refine_reltol", ctypes.c_double),
            ("refine_stop_ratio", ctypes.c_double),
            ("max_step_fraction", ctypes.c_double),
            ("min_terminate_step_length", ctypes.c_double),
            ("stall_ratio", ctypes.c_double),
            ("tol", ctypes.c_double * 6),
            ("rtol", ctypes.c_double * 6),
            ("seg_kind", seg),
            ("seg_lo", seg),
            ("seg_hi", seg),
            ("degree", ctypes.c_int),
            ("p_nonzero", ctypes.c_int),
            ("max_iter", ctypes.c_int),
            ("eq_enable", ctypes.c_int),
            ("eq_max_iter", ctypes.c_int),
            ("refine_passes", ctypes.c_int),
        ]

    return MkParams


def _params(spec):
    st = spec.st
    prm = _params_struct(len(spec.segs))()
    prm.eq_min_scaling = st.equilibrate_min_scaling
    prm.eq_max_scaling = st.equilibrate_max_scaling
    prm.static_reg_constant = st.static_regularization_constant
    prm.static_reg_proportional = st.static_regularization_proportional
    prm.refine_abstol = min(st.iterative_refinement_abstol, 1e-14)
    prm.refine_reltol = min(st.iterative_refinement_reltol, 1e-15)
    prm.refine_stop_ratio = st.iterative_refinement_stop_ratio
    prm.max_step_fraction = st.max_step_fraction
    prm.min_terminate_step_length = st.min_terminate_step_length
    prm.stall_ratio = st.stall_detection_ratio
    prm.tol[:] = [st.tol_gap_abs, st.tol_gap_rel, st.tol_feas,
                  st.tol_infeas_abs, st.tol_infeas_rel, st.tol_ktratio]
    prm.rtol[:] = [st.reduced_tol_gap_abs, st.reduced_tol_gap_rel,
                   st.reduced_tol_feas, st.reduced_tol_infeas_abs,
                   st.reduced_tol_infeas_rel, st.reduced_tol_ktratio]
    for g, (kind, lo, hi) in enumerate(spec.segs):
        prm.seg_kind[g] = _SEG_CODES[kind]
        prm.seg_lo[g] = lo
        prm.seg_hi[g] = hi
    prm.degree = spec.degree
    prm.p_nonzero = int(spec.p_nonzero)
    prm.max_iter = st.max_iter
    prm.eq_enable = int(st.equilibrate_enable)
    prm.eq_max_iter = st.equilibrate_max_iter
    prm.refine_passes = (0 if not st.iterative_refinement_enable
                         else min(int(st.iterative_refinement_max_iter), 4))
    return prm


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def shape_of(spec) -> Shape:
    return (spec.n, spec.m, len(spec.segs))


class Megakernel:
    """The built libraries, one per shape, and the launch count."""

    def __init__(self):
        self.launches = 0
        self.build_logs: Dict[Shape, str] = {}
        self._libs: Dict[Shape, ctypes.CDLL] = {}
        self._lock = threading.Lock()

    def lib_path(self, shape: Shape) -> str:
        with open(SOURCE, "rb") as f:
            h = hashlib.sha1(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        n, m, nseg = shape
        return os.path.join(
            BUILD_DIR, f"megakernel_n{n}_m{m}_s{nseg}_{h.hexdigest()[:12]}.so")

    def build(self, shapes: Iterable[Shape]) -> None:
        """Compile every missing shape, one nvcc per shape, all started
        together; raises if any build fails."""
        with self._lock:
            todo = [s for s in dict.fromkeys(shapes)
                    if s not in self._libs and not os.path.exists(
                        self.lib_path(s))]
            os.makedirs(BUILD_DIR, exist_ok=True)
            procs = []
            for shape in todo:
                n, m, nseg = shape
                out = self.lib_path(shape)
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [nvcc_path(), *NVCC_FLAGS, f"-DMK_N={n}",
                       f"-DMK_M={m}", f"-DMK_S={nseg}", "-o", tmp, SOURCE]
                procs.append((shape, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for shape, out, tmp, proc in procs:
                log, _ = proc.communicate()
                self.build_logs[shape] = log
                if proc.returncode != 0:
                    failed.append((shape, log))
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("nvcc failed for " + "; ".join(
                    f"shape {s}:\n{log}" for s, log in failed))

    def _lib(self, shape: Shape) -> ctypes.CDLL:
        lib = self._libs.get(shape)
        if lib is None:
            self.build([shape])
            lib = ctypes.CDLL(self.lib_path(shape))
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            lib.mk_solve.argtypes = [vp, ll, ll, vp, ll, ll, vp, ll, ll,
                                     vp, ll, ll, ll,
                                     _params_struct(shape[2]), vp, vp, vp]
            lib.mk_solve.restype = ctypes.c_int
            lib.mk_shape.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.mk_shape.restype = ctypes.c_int
            got = (ctypes.c_int * 4)()
            lib.mk_shape(got)
            if tuple(got[:3]) != shape:
                raise RuntimeError(f"{self.lib_path(shape)} was built for "
                                   f"{tuple(got[:3])}, not {shape}")
            self._libs[shape] = lib
        return lib

    def __call__(self, Ptri, q, A, b, spec, B):
        """Launch the batched solve over B lanes; returns (vals (OUTD, B)
        float64, ints (2, B) int32) on the inputs' device."""
        dims = (spec.triu, spec.n, spec.n * spec.m, spec.m)
        device = Ptri.device
        if B < 1:
            raise ValueError(f"B must be at least 1, got {B}")
        strides = []
        for name, t, d in zip(("P", "q", "A", "b"), (Ptri, q, A, b), dims):
            if t.device != device or t.device.type != "cuda":
                raise ValueError(f"{name} must be on {device} (CUDA)")
            if t.dtype != torch.float64:
                raise ValueError(f"{name} must be float64, got {t.dtype}")
            if t.dim() == 1:
                if t.shape[0] != d or t.stride(0) != 1:
                    raise ValueError(f"{name} must be a contiguous ({d},)")
                strides.append((1, 0))
            elif t.dim() == 2:
                if t.shape[0] != d or t.stride(1) != 1:
                    raise ValueError(
                        f"{name} must be ({d}, B) with unit lane stride, "
                        f"got shape {tuple(t.shape)} strides {t.stride()}")
                if t.shape[1] != B:
                    raise ValueError(
                        f"{name} has {t.shape[1]} lanes, not B={B}")
                strides.append((t.stride(0), 1))
            else:
                raise ValueError(f"{name} must be 1-D or 2-D")
        vals = torch.empty((spec.outd, B), dtype=torch.float64, device=device)
        ints = torch.empty((2, B), dtype=torch.int32, device=device)
        lib = self._lib(shape_of(spec))
        args = []
        for t, (ld, ls) in zip((Ptri, q, A, b), strides):
            args += [t.data_ptr(), ld, ls]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.mk_solve(*args, B, _params(spec), vals.data_ptr(),
                              ints.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"megakernel launch failed: CUDA error {rc}")
        self.launches += 1
        return vals, ints


megakernel = Megakernel()
