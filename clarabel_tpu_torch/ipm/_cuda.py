"""Bind and launch the CUDA megakernel (K1a-K1e).

Single-phase zero/nn/SOC layouts (K1a) launch the group kernel of
`csrc/megakernel_group.cu`, one lane per group of threads, up to
GROUP_LANES_PER_SM lanes for each SM of the card, and `csrc/megakernel.cu`,
one lane per thread, above that; single-phase layouts with exp or pow
segments and no genpow or PSD segment (K1b) launch the group kernel up to
NONSYM_GROUP_LANES_PER_SM lanes an SM and `csrc/megakernel.cu` above; every
other layout (K1c-K1e) launches `csrc/megakernel.cu` (`variant_of`;
`group_eligible` says why).  Both sources have the same C interface and
MkParams.  The kernel has compile-time
sizes, so there is one library per problem shape and source: n, m, the
number of cone segments, three flags that compile a cone family's code in
only where the layout has such a segment (a nonsymmetric segment: K1b; a
generalized power segment: K1c; a PSD segment: K1d), one that compiles in
the float32 first phase (K1e) where the spec runs it, and the source.
Each is built at first use by `cuda_build.CudaLibrary` (nvcc for sm_90a,
loaded with ctypes).

`megakernel(Ptri, q, A, b, spec, B)` checks its inputs, allocates the outputs
with `torch.empty`, launches on the current stream and counts the launch
(and, for a group library, the launch of `megakernel_group.cu`; for a
two-phase library, the launch of K1e).  It never falls back to
the plain version or to the single phase: a failed build or launch raises.
"""

import ctypes
import functools
import os
from typing import Tuple

import torch

from ..cuda_build import CudaLibrary, nvcc_path  # noqa: F401 (re-exported)

_SEG_CODES = {"zero": 0, "nn": 1, "soc": 2, "exp": 3, "pow": 4,
              "genpow": 5, "psd": 6}
GPW = 16    # the widest generalized power segment (csrc GPW)

# (n, m, segments, nonsymmetric 0/1, psd 0/1, genpow 0/1, two-phase 0/1)
Shape = Tuple[int, int, int, int, int, int, int]


@functools.lru_cache(maxsize=None)
def _params_struct(nseg: int, psd: int, genpow: int, two_phase: int):
    """The ctypes mirror of MkParams for `nseg` cone segments, with the
    genpow fields where the library has K1c, the PSD field where it has
    K1d and the first phase's fields where it has K1e (one class per
    variant: ctypes checks a by-value argument's class).  `bind` checks
    its size against the library's sizeof(MkParams)."""
    seg = ctypes.c_int * nseg
    seg_d = ctypes.c_double * nseg
    gp_fields = [("gp_alpha", ctypes.c_double * (nseg * GPW)),
                 ("gp_d1", seg)] if genpow else []
    psd_fields = [("psd_sweeps", ctypes.c_int)] if psd else []
    p1_fields = [("p1_switch_mu", ctypes.c_double),
                 ("p1_cap", ctypes.c_int),
                 ("p1_refine_passes", ctypes.c_int)] if two_phase else []

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
            ("seg_alpha", seg_d),
            ("min_switch_step_length", ctypes.c_double),
            ("linesearch_backtrack_step", ctypes.c_double),
            ("seg_kind", seg),
            ("seg_lo", seg),
            ("seg_hi", seg),
            ("degree", ctypes.c_int),
            ("p_nonzero", ctypes.c_int),
            ("max_iter", ctypes.c_int),
            ("eq_enable", ctypes.c_int),
            ("eq_max_iter", ctypes.c_int),
            ("refine_passes", ctypes.c_int),
            ("linesearch_max_iter", ctypes.c_int),
        ] + gp_fields + psd_fields + p1_fields

    return MkParams


def _params(spec):
    st = spec.st
    prm = _params_struct(len(spec.segs), int(spec.has("psd")),
                         int(spec.has("genpow")), int(spec.two_phase))()
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
    prm.min_switch_step_length = st.min_switch_step_length
    prm.linesearch_backtrack_step = st.linesearch_backtrack_step
    prm.linesearch_max_iter = int(st.linesearch_max_iter)
    for g, ((kind, lo, hi), a) in enumerate(zip(spec.segs, spec.alphas)):
        prm.seg_kind[g] = _SEG_CODES[kind]
        prm.seg_lo[g] = lo
        prm.seg_hi[g] = hi
        prm.seg_alpha[g] = a
        if kind == "genpow":
            al = spec.gp_alphas[g]
            prm.gp_d1[g] = len(al)
            for j, v in enumerate(al):
                prm.gp_alpha[g * GPW + j] = v
    if spec.has("psd"):
        prm.psd_sweeps = spec.psd_sweeps
    if spec.two_phase:
        prm.p1_switch_mu = spec.switch_mu
        prm.p1_cap = spec.p1_cap
        prm.p1_refine_passes = int(st.iterative_refinement_enable)
    prm.degree = spec.degree
    prm.p_nonzero = int(spec.p_nonzero)
    prm.max_iter = st.max_iter
    prm.eq_enable = int(st.equilibrate_enable)
    prm.eq_max_iter = st.equilibrate_max_iter
    prm.refine_passes = (0 if not st.iterative_refinement_enable
                         else min(int(st.iterative_refinement_max_iter), 4))
    return prm


def shape_of(spec) -> Shape:
    return (spec.n, spec.m, len(spec.segs), int(spec.nonsym),
            int(spec.has("psd")), int(spec.has("genpow")),
            int(spec.two_phase))


# A library: the shape and which source it builds from (1: the group
# kernel, 0: one lane per thread; nvcc gets it as MK_GROUP, which neither
# source reads: it names the library)
Variant = Tuple[int, int, int, int, int, int, int, int]

# The group kernel runs K1a while the batch has at most this many lanes
# for each SM of the card: up to 54.3 lanes an SM it was faster on every
# batch (bench, lp, qp_eq), at 62.1 slower on lp (the H100; PERF.md section
# 5, `tools/megakernel_probe.py sweep --parts gsweep`).
GROUP_LANES_PER_SM = 54
# ... and K1b (exp and pow segments) up to this many (None would mean at
# every B): with G = 8 and up to 255 registers a thread an SM holds 8 warps,
# 32 lanes, in one wave; at 32.0 lanes an SM the group kernel was faster on
# exp, pow and switch, at 33.9 slower on exp and pow (the H100; PERF.md
# section 5, `tools/megakernel_probe.py sweep --parts nsweep`).
NONSYM_GROUP_LANES_PER_SM = 32


def group_eligible(shape: Shape) -> bool:
    """Single-phase layouts without genpow or PSD segments (K1a, K1b): the
    layouts `csrc/megakernel_group.cu` takes.  K1c, K1d and K1e (the first
    phase) stay in `csrc/megakernel.cu`: K1c's cooperative searches share
    a warp, and the group builds of K1d and K1e lost on the H100, K1d on
    time at every batch size on psd_zero, K1e on lp's SOLVED count bar
    (the group source's header; PERF.md section 6)."""
    return not any(shape[4:7])


def group_cap(shape: Shape):
    """Lanes an SM up to which an eligible shape takes the group kernel
    (None: at every batch size): each the largest at which the group
    kernel was faster than `csrc/megakernel.cu` on every batch of its
    family (K1a: bench, lp, qp_eq; K1b: exp, pow, switch)."""
    return NONSYM_GROUP_LANES_PER_SM if shape[3] else GROUP_LANES_PER_SM


def variant_of(shape: Shape, B: int, sms: int) -> Variant:
    """The library a launch over B lanes on a card with `sms` SMs takes:
    the group kernel for an eligible shape up to its `group_cap` lanes an
    SM, else the one-lane-per-thread kernel."""
    cap = group_cap(shape)
    grp = group_eligible(shape) and (cap is None or B <= cap * sms)
    return tuple(shape) + (int(grp),)


def variants_of(shape: Shape):
    """Every library a shape may launch."""
    if not group_eligible(shape):
        return [tuple(shape) + (0,)]
    return [tuple(shape) + (g,) for g in ((1,) if group_cap(shape) is None
                                          else (0, 1))]


def source_for(variant) -> str:
    """`megakernel_group.cu` (one lane per group of threads: K1a and K1b up
    to their caps) or `megakernel.cu` (one lane per thread: above the caps,
    and K1c-K1e; also for a bare shape)."""
    return ("megakernel_group.cu" if len(variant) > 7 and variant[7]
            else "megakernel.cu")


class Megakernel(CudaLibrary):
    """The built libraries, one per variant (the shape and its source),
    and the launch counts: every launch, the launches of group libraries
    (`megakernel_group.cu`) and those of two-phase libraries (K1e)."""

    def __init__(self):
        super().__init__("megakernel.cu",
                         macros=("MK_N", "MK_M", "MK_S", "MK_NONSYM",
                                 "MK_PSD", "MK_GENPOW", "MK_TWO_PHASE",
                                 "MK_GROUP"),
                         tags=("n", "m", "s", "ns", "psd", "gp", "tp", "grp"))
        self.launches = 0
        self.group_launches = 0
        self.two_phase_launches = 0
        self._sms = {}

    def source_for(self, variant: Variant) -> str:
        return os.path.join(os.path.dirname(self.source),
                            source_for(tuple(variant)))

    def variant(self, spec, B: int, device) -> Variant:
        index = torch.device(device).index
        index = torch.cuda.current_device() if index is None else index
        if index not in self._sms:
            self._sms[index] = torch.cuda.get_device_properties(
                index).multi_processor_count
        return variant_of(shape_of(spec), B, self._sms[index])

    def bind(self, lib: ctypes.CDLL, variant: Variant) -> None:
        shape = tuple(variant[:7])
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        params = _params_struct(shape[2], shape[4], shape[5], shape[6])
        lib.mk_solve.argtypes = [vp, ll, ll, vp, ll, ll, vp, ll, ll,
                                 vp, ll, ll, ll, params, vp, vp, vp]
        lib.mk_solve.restype = ctypes.c_int
        lib.mk_shape.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.mk_shape.restype = ctypes.c_int
        lib.mk_params_size.argtypes = []
        lib.mk_params_size.restype = ctypes.c_int
        got = (ctypes.c_int * 8)()
        lib.mk_shape(got)
        if tuple(got[:7]) != shape:
            raise RuntimeError(f"{self.lib_path(variant)} was built for "
                               f"{tuple(got[:7])}, not {shape}")
        if lib.mk_params_size() != ctypes.sizeof(params):
            raise RuntimeError(
                f"MkParams is {lib.mk_params_size()} bytes in "
                f"{self.lib_path(variant)}, {ctypes.sizeof(params)} in its "
                "ctypes mirror")

    def __call__(self, Ptri, q, A, b, spec, B):
        """Launch the batched solve over B lanes; returns (vals (OUTD, B)
        float64, ints (4, B) int32: status, iterations, final scaling
        strategy, iterations of the float32 first phase) on the inputs'
        device."""
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
        ints = torch.empty((4, B), dtype=torch.int32, device=device)
        if not spec.two_phase:
            ints[3].zero_()     # a single-phase library leaves this row
        variant = self.variant(spec, B, device)
        lib = self.load(variant)
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
        self.group_launches += int(source_for(variant) != "megakernel.cu")
        self.two_phase_launches += int(spec.two_phase)
        return vals, ints


megakernel = Megakernel()
