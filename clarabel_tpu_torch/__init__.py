"""clarabel_tpu_torch — the PyTorch / CUDA port of clarabel_tpu.

A homogeneous-embedding interior-point method for convex conic programs

    min  (1/2) x'Px + q'x   s.t.  Ax + s = b,  s in K

written in PyTorch for an NVIDIA H100, beside the JAX package that stays
as its reference.  The port so far covers `BatchSolver` over batches of
same-layout programs with every cone family of the reference: the whole
batched solve as hand-written CUDA kernels (`csrc/megakernel.cu`,
`csrc/megakernel_group.cu`), fed in chunks that overlap the copies with the
kernels, the batched IPM loop solver with the dense ldl and condensed KKT
backends (float64, float32 and mixed precision; float32 factors through
the CUDA LDL kernels `csrc/ldl_inverse*.cu`), and the rescue cascade; the
single-instance `Solver` on the dense path (presolve, chordal
decomposition, data updates, JSON files), with its sparse and
structured KKT, time limits, checkpoints, stage timers and profiles;
`entry()` (`clarabel_tpu_torch/entry.py`); the QPS and CBF readers
(`io/`), the `ProblemBuilder` (`modeling`), the cvxpy data path
(`interop/cvxpy_interface.py`), the command line (`python -m
clarabel_tpu_torch file.qps`) and `precompile.warmup`.  On the CPU (the
caller passes `device="cpu"`) each kernel's plain PyTorch version runs
instead.

The package imports torch and numpy; the readers, the sparse setup and
the JSON files also scipy.sparse, when they are called.
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
from .api import Solver, DefaultSolution, DefaultInfo
from . import modeling
from . import precompile

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


def save_to_file(solver, filename: str) -> None:
    """Write a `Solver`'s problem and settings to a Clarabel JSON file
    (io/json_io.py)."""
    from .io.json_io import save_to_file as _save

    _save(solver, filename)


def load_from_file(filename: str, settings=None, device=None):
    """A set-up `Solver` for a Clarabel JSON file (io/json_io.py)."""
    from .io.json_io import load_from_file as _load

    return _load(filename, settings, device=device)
