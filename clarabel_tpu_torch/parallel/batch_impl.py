"""BatchSolver: solve thousands of same-layout conic programs at once.

This slice of the port covers batches of zero/nonnegative/second-order
programs in the megakernel regime.  The whole batched solve is one launch
of the CUDA kernel on the card (`csrc/megakernel.cu`), or its plain
PyTorch version when the caller asks for the CPU.  Everything outside the
slice raises `NotImplementedError` naming the ROADMAP.md item that will
bring it, instead of being ignored.
"""

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..settings import Settings
from ..statuscodes import SolverStatus
from ..cones.api import SupportedCone, cones_collapse
from ..cones.layout import ConeLayout
from ..ipm import megakernel

_LOOP_SOLVER = "ROADMAP.md Queue 1 item 5 (loop solver, dense backends)"


class BatchSolution:
    """Batched solve result.  x/status/obj_val/iterations are eager
    numpy; z/s/r_prim/r_dual stay on the device until first read
    (ipm/megakernel.LazyOutputs)."""

    def __init__(self, out, solve_time: float):
        self._out = out
        self.x = np.asarray(out["x"])
        self.status = np.asarray(out["status"])
        self.obj_val = np.asarray(out["obj_val"])
        self.iterations = np.asarray(out["iterations"])
        self.solve_time = solve_time

    @property
    def z(self) -> np.ndarray:
        return np.asarray(self._out["z"])

    @property
    def s(self) -> np.ndarray:
        return np.asarray(self._out["s"])

    @property
    def r_prim(self) -> np.ndarray:
        return np.asarray(self._out["r_prim"])

    @property
    def r_dual(self) -> np.ndarray:
        return np.asarray(self._out["r_dual"])

    @property
    def all_solved(self) -> bool:
        return bool(np.all(self.status == int(SolverStatus.SOLVED)))


def resolve_device(device) -> torch.device:
    """`None` means the card; with no card the caller must ask for the
    CPU explicitly.  Nothing moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch version on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _slice_check(layout: ConeLayout, settings: Settings, n: int, mesh,
                 rescue, rescue_settings) -> None:
    """Raise NotImplementedError for whatever this slice does not port."""
    names = {type(c).__name__ for c in layout.cones}
    if names & {"ExponentialConeT", "PowerConeT"}:
        raise NotImplementedError(
            "exponential/power cones: ROADMAP.md Queue 1 item 8 "
            "(nonsymmetric cones, kernel K1b)")
    if "GenPowerConeT" in names:
        raise NotImplementedError(
            "generalized power cones: ROADMAP.md Queue 1 item 8 "
            "(nonsymmetric cones, kernel K1c)")
    if "PSDTriangleConeT" in names:
        raise NotImplementedError(
            "PSD cones: ROADMAP.md Queue 1 item 9 (PSD cones, kernel K1d)")
    if settings.kkt_backend not in ("auto", "megakernel"):
        raise NotImplementedError(
            f"kkt_backend={settings.kkt_backend!r}: {_LOOP_SOLVER}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: ROADMAP.md Queue 1 item 13 (multi-device)")
    if rescue is not None or rescue_settings is not None:
        raise NotImplementedError(
            "rescue=: ROADMAP.md Queue 1 item 6 (rescue cascade)")
    if settings.mixed_precision or settings.factor_dtype not in (
            None, "float64"):
        raise NotImplementedError(
            "mixed precision / f32 factors: ROADMAP.md Queue 1 item 10")
    if settings.dtype != "float64":
        raise NotImplementedError(
            f"dtype={settings.dtype!r}: ROADMAP.md Queue 1 item 10 "
            "(f32 solves)")
    if settings.megakernel_two_phase:
        raise NotImplementedError(
            "megakernel_two_phase=True: ROADMAP.md Queue 2 K1e "
            "(f32 first phase)")
    if not megakernel.eligible(layout, settings, n):
        if settings.kkt_backend == "megakernel":
            raise ValueError(
                "kkt_backend='megakernel' requires a small dense "
                "zero/nn/soc layout at float64 with at least one barrier "
                "cone (see ipm.megakernel.eligible)")
        raise NotImplementedError(
            f"layouts outside the megakernel regime: {_LOOP_SOLVER}")


class BatchSolver:
    """Batched solver over instances sharing one cone layout.

        bs = BatchSolver(cones, n, settings)            # on the card
        bs = BatchSolver(cones, n, settings, device="cpu")
        sol = bs.solve(P, q, A, b)     # leading batch axis on every array
    """

    def __init__(self, cones: Sequence[SupportedCone], n: int,
                 settings: Optional[Settings] = None, mesh=None,
                 p_nonzero: bool = True, rescue: Optional[str] = None,
                 rescue_settings: Optional[Settings] = None,
                 device=None):
        self.settings = settings if settings is not None else Settings()
        self.cones = cones_collapse(list(cones))
        self.layout = ConeLayout(self.cones)
        self.n = int(n)
        self.m = self.layout.m
        _slice_check(self.layout, self.settings, self.n, mesh, rescue,
                     rescue_settings)
        self.device = resolve_device(device)
        self._mega_fn = megakernel.build_mega_solve(
            self.layout, self.settings, self.n, p_nonzero=p_nonzero,
            device=self.device)

    def _check_shapes(self, P, q, A, b):
        n, m = self.n, self.m
        if q.ndim != 2 or q.shape[1] != n:
            raise ValueError(f"q must be (B, {n}), got {q.shape}")
        B = q.shape[0]
        if B < 1:
            raise ValueError("empty batch")
        if P.shape != (B, n, n):
            raise ValueError(f"P must be ({B}, {n}, {n}), got {P.shape}")
        if A.shape != (B, m, n):
            raise ValueError(
                f"A must be ({B}, {m}, {n}) for cones of total dim {m}, "
                f"got {A.shape}")
        if b.shape != (B, m):
            raise ValueError(f"b must be ({B}, {m}), got {b.shape}")

    def solve(self, P, q, A, b) -> BatchSolution:
        """P: (B,n,n) full or upper-triangular symmetric (or None for LP
        batches); q: (B,n); A: (B,m,n); b: (B,m).  P passes through raw:
        the kernel reads its upper triangle only."""
        q, A, b = (np.asarray(x, np.float64) for x in (q, A, b))
        if P is None:
            P = np.zeros((q.shape[0] if q.ndim else 0, self.n, self.n))
        P = np.asarray(P, np.float64)
        self._check_shapes(P, q, A, b)
        t0 = time.perf_counter()
        out = self._mega_fn(P, q, A, b)
        return BatchSolution(out, time.perf_counter() - t0)
