"""Warm the port up with tiny representative workloads.

The counterpart of the JAX package's `precompile.py` (and of the
reference's SnoopPrecompile workload set, src/precompile.jl:49-75): one
tiny problem per cone family is solved.  On a card, `warmup` first builds
the CUDA libraries that those families' `BatchSolver` layouts launch (the
megakernel's libraries of each layout, from both sources where a layout
takes both, and K2's for float32 factors), one nvcc for each, all started
together (`cuda_build.build_together`), so that a user's first batched
solve of such a layout does not wait on nvcc.  Libraries already built
are not built again.

    from clarabel_tpu_torch import precompile
    precompile.warmup()                 # on the card
    precompile.warmup(device="cpu")     # the plain versions, no build
"""

import numpy as np

FAMILIES = ("lp", "qp", "socp", "sdp", "exp", "pow")


def instances(families=FAMILIES):
    """{family: (P, q, A, b, cones)}: the JAX package's tiny instances
    (its precompile.py:15-63), problem for problem."""
    from .cones.api import (ExponentialConeT, NonnegativeConeT, PowerConeT,
                            PSDTriangleConeT, SecondOrderConeT, ZeroConeT)

    out = {}
    if "lp" in families:
        out["lp"] = (np.zeros((2, 2)), np.array([1.0, 1.0]), -np.eye(2),
                     np.zeros(2), [NonnegativeConeT(2)])
    if "qp" in families:
        out["qp"] = (np.eye(2), np.array([-1.0, 1.0]),
                     np.vstack([np.ones((1, 2)), -np.eye(2)]),
                     np.array([1.0, 0.0, 0.0]),
                     [ZeroConeT(1), NonnegativeConeT(2)])
    if "socp" in families:
        out["socp"] = (np.eye(2), np.zeros(2),
                       -np.vstack([np.zeros((1, 2)), np.eye(2)]),
                       np.array([1.0, 0.0, 0.0]), [SecondOrderConeT(3)])
    if "sdp" in families:
        out["sdp"] = (np.eye(3), np.zeros(3), np.eye(3),
                      np.array([1.0, 0.0, 1.0]), [PSDTriangleConeT(2)])
    if "exp" in families:
        A = np.zeros((3, 2))
        A[0, 0] = -1.0
        A[1, 1] = -1.0
        out["exp"] = (np.eye(2) * 0.1, np.array([1.0, -1.0]), A,
                      np.array([0.0, 0.0, 1.0]), [ExponentialConeT()])
    if "pow" in families:
        A = -np.vstack([np.eye(2), np.zeros((1, 2))])
        out["pow"] = (np.eye(2) * 0.1, np.array([0.0, -1.0]), A,
                      np.array([1.0, 1.0, 0.0]), [PowerConeT(0.5)])
    return out


def library_requests(settings=None, families=FAMILIES, device="cuda"):
    """[(CudaLibrary, variants)] that the families' layouts launch on a
    card under `settings`: each `BatchSolver` layout's megakernel
    libraries where it takes the megakernel, and K2's library at the
    layout's N = n + m where its factors are float32."""
    from .ipm import _cuda
    from .linalg import batched_ldl
    from .parallel.batch_impl import BatchSolver
    from .settings import Settings

    settings = settings or Settings()
    mega, k2 = set(), set()
    float32 = (settings.mixed_precision or settings.dtype == "float32"
               or settings.factor_dtype == "float32")
    for P, q, A, b, cones in instances(families).values():
        n, m = q.shape[0], b.shape[0]
        bs = BatchSolver(cones, n, settings, device=device)
        if bs._mega_fn is not None:
            mega.update(_cuda.variants_of(_cuda.shape_of(bs._mega_fn.spec)))
        if float32 and n + m <= batched_ldl.MAX_N:
            k2.add(batched_ldl.kernel.variant(n + m))
    return [(_cuda.megakernel, sorted(mega)),
            (batched_ldl.kernel, sorted(k2))]


def warmup(settings=None, families=FAMILIES, device=None):
    """Build the families' CUDA libraries (on a card), then solve one tiny
    instance per family with `Solver`; returns {family: SolverStatus}.
    `device`: the card when None (with no card, pass "cpu")."""
    from . import cuda_build
    from .api import Solver
    from .parallel.batch_impl import resolve_device
    from .settings import Settings

    settings = settings or Settings()
    device = resolve_device(device)
    if device.type == "cuda":
        cuda_build.build_together(*library_requests(settings, families,
                                                    device))
    return {name: Solver(P, q, A, b, cones, settings,
                         device=device).solve().status
            for name, (P, q, A, b, cones) in instances(families).items()}
