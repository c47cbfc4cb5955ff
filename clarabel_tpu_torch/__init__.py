"""clarabel_tpu_torch — the PyTorch / CUDA port of clarabel_tpu.

A homogeneous-embedding interior-point method for convex conic programs

    min  (1/2) x'Px + q'x   s.t.  Ax + s = b,  s in K

written in PyTorch for an NVIDIA H100, beside the JAX package that stays
as its reference.  The port so far covers `BatchSolver` over batches of
same-layout programs with zero, nonnegative, second-order, exponential and
power cones: the whole batched solve as one hand-written CUDA kernel
(`csrc/megakernel.cu`; exp and pow cones as its K1b part), the batched
IPM loop solver with the dense ldl and condensed KKT backends (float64,
float32 and mixed precision; float32 factors through the CUDA LDL kernel
`csrc/ldl_inverse.cu`), and the rescue cascade.  On the CPU (the caller
passes `device="cpu"`) each kernel's plain PyTorch version runs instead.

The package imports torch and numpy only.
"""

from .settings import Settings
from .statuscodes import SolverStatus
from .cones.api import (
    ZeroConeT,
    NonnegativeConeT,
    SecondOrderConeT,
    ExponentialConeT,
    PowerConeT,
    GenPowerConeT,
    PSDTriangleConeT,
)
from .parallel.batch_impl import BatchSolver, BatchSolution

__version__ = "0.1.0"


def version() -> str:
    """reference: src/version.jl:1-16"""
    return __version__


# module-level get/set infinity (reference: src/Clarabel.jl:14-20)
_INFINITY_DEFAULT = 1e20
_infinity = _INFINITY_DEFAULT


def get_infinity() -> float:
    return _infinity


def set_infinity(v: float) -> None:
    global _infinity
    _infinity = float(v)


def default_infinity() -> None:
    set_infinity(_INFINITY_DEFAULT)
