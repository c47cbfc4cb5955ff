"""BatchSolver: solve thousands of same-layout conic programs at once.

Backends, resolved as the reference resolves them
(`clarabel_tpu/parallel/batch_impl.py`), with "not on a CPU" read as "on a
CUDA card":

* the megakernel: the whole batched solve as one launch of the CUDA kernel
  (`csrc/megakernel.cu`), or its plain PyTorch version when the caller
  asks for it on the CPU with `kkt_backend="megakernel"`.  As in the
  reference it ignores `factor_dtype` (it factors in float64, and the
  rescue's stages force float64 factors) and runs a float32 first phase
  where `megakernel_two_phase` is set and the layout allows it;
* the loop solver (`ipm/loop.py`) with the `condensed` or the dense `ldl`
  KKT backend, batched over the lanes; float32 factors with N ≤ 80 go
  through the LDL kernel K2 (`csrc/ldl_inverse.cu`) on the card.

`rescue=` re-solves the lanes that did not reach SOLVED with a cascade of
loop solvers.  `kkt_backend="blockarrow"` and `"multifrontal"` run the
dense `ldl` loop, as the reference's BatchSolver does (it passes no
structure plan).

`mesh=` (a DeviceMesh with a "dp" dim) splits the lanes over "dp": every
rank of the mesh calls `solve` with the whole batch, solves its share of
the lanes on its own card (ranks along "tp" solve the same share, as the
reference's P("dp") replicates over tp), and every rank gets the whole
batch's outputs, on which the rescue then runs (DEVIATIONS.md #20).  Under
a mesh "auto" does not pick the megakernel, and asking for it raises.
"""

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..settings import Settings
from ..statuscodes import SolverStatus
from ..cones.api import SupportedCone, cones_collapse
from ..cones.layout import ConeLayout
from ..ipm import megakernel
from ..ipm.loop import build_solve
from .multihost import all_reduce, check_mesh, mesh_device

SOLVED = int(SolverStatus.SOLVED)


class BatchSolution:
    """Batched solve result.  x/status/obj_val/iterations are eager
    numpy; on the megakernel path z/s/r_prim/r_dual stay on the device
    until first read (ipm/megakernel.LazyOutputs)."""

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
        return bool(np.all(self.status == SOLVED))


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


def _next_pow2(k: int) -> int:
    return 1 << max(0, (k - 1)).bit_length()


def _symmetrize_triu(P):
    """(B, n, n) per-instance P_sym = triu(P,1) + triu(P,1)' + diag(P):
    accepts either full-symmetric or upper-triangular input."""
    U = np.triu(P, 1)
    eye = np.eye(P.shape[-1])
    diag = np.diagonal(P, axis1=-2, axis2=-1)
    return U + np.swapaxes(U, -1, -2) + diag[..., None, :] * eye


def _check_options(mesh, rescue) -> None:
    if mesh is not None:
        check_mesh(mesh)
        if "dp" not in (mesh.mesh_dim_names or ()):
            raise ValueError("BatchSolver(mesh=...) splits the lanes over "
                             "a 'dp' dim, which the mesh does not name")
    if rescue not in (None, "cpu", "same"):
        raise ValueError(f"rescue must be None, 'cpu' or 'same', got "
                         f"{rescue!r}")


def resolve_backend(layout: ConeLayout, settings: Settings, n: int,
                    device: torch.device, mesh=None) -> str:
    """The reference's rule (batch_impl.py:110-120): "auto" is the
    megakernel on a card when the layout is eligible and there is no
    mesh, else `condensed` when the layout has no zero cone, else the
    dense `ldl` loop."""
    backend = settings.kkt_backend
    if backend == "auto":
        if (mesh is None and device.type == "cuda"
                and megakernel.eligible(layout, settings, n)):
            return "megakernel"
        if not any(g.kind == "zero" for g in layout.groups.values()):
            return "condensed"
        return "ldl"
    return backend


class BatchSolver:
    """Batched solver over instances sharing one cone layout.

        bs = BatchSolver(cones, n, settings)            # on the card
        bs = BatchSolver(cones, n, settings, device="cpu")
        sol = bs.solve(P, q, A, b)     # leading batch axis on every array

    `rescue`: a second pass over the lanes that did not reach SOLVED.
    "same" re-solves them on the solver's device, "cpu" on the CPU (the
    caller's explicit request), each with a cascade of loop solvers in
    float64: the primary backend, then `ldl` and `condensed` with
    equilibration off.  Each stage sees only the lanes the earlier stages
    left, and a lane takes a stage's result only where it is SOLVED.

    `mesh`: a DeviceMesh with a "dp" dim over which the lanes split (B
    must be a multiple of its size); the device is then the rank's own
    card when None."""

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
        _check_options(mesh, rescue)
        self._mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else mesh_device(device))

        backend = resolve_backend(self.layout, self.settings, self.n,
                                  self.device, mesh)
        self._mega_fn = None
        self._solve_fn = None
        if backend == "megakernel":
            if mesh is not None:
                raise ValueError("megakernel does not support mesh=")
            st = self.settings
            if not megakernel.eligible(self.layout, st, self.n):
                raise ValueError(
                    "kkt_backend='megakernel' requires a small dense "
                    "layout at float64 with at least one barrier cone "
                    "(see ipm.megakernel.eligible)")
            self._mega_fn = megakernel.build_mega_solve(
                self.layout, st, self.n, p_nonzero=p_nonzero,
                device=self.device)
            backend = "condensed"  # the rescue's primary stage
        else:
            self._solve_fn = build_solve(self.layout, self.settings, self.n,
                                         p_nonzero, kkt_backend=backend)

        self._rescue_fns = None
        if rescue is not None:
            self._rescue_device = (torch.device("cpu") if rescue == "cpu"
                                   else self.device)
            rs = rescue_settings if rescue_settings is not None else \
                dataclasses.replace(self.settings, factor_dtype="float64",
                                    mixed_precision=False)
            rs_ne = dataclasses.replace(rs, equilibrate_enable=False)
            stages = [
                (backend, rs),
                ("ldl", dataclasses.replace(rs_ne, kkt_backend="ldl")),
                ("condensed", dataclasses.replace(rs_ne,
                                                  kkt_backend="condensed")),
            ]
            self._rescue_fns = [build_solve(self.layout, st_, self.n,
                                            p_nonzero, kkt_backend=bk)
                                for bk, st_ in stages]

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

    def _run_loop(self, fn, P, q, A, b, device):
        """A loop solver over host arrays -> host arrays, per key."""
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (P, q, A, b)]
        return {k: v.cpu().numpy() for k, v in fn(*args).items()}

    def _run_sharded(self, P, q, A, b):
        """The loop solver on this rank's share of the lanes, the outputs
        then gathered to every rank: each rank writes its lanes into a
        zero float64 buffer of the whole batch and the buffers are
        all-reduced over "dp" (an exact sum: every entry comes from one
        rank; integers and float32 are exact in float64)."""
        mesh = self._mesh
        B = q.shape[0]
        group = mesh.get_group("dp")
        dp = torch.distributed.get_world_size(group)
        if B % dp:
            raise ValueError(f"batch of {B} lanes does not split over the "
                             f"{dp} ranks of the dp axis")
        lo = mesh.get_local_rank("dp") * (B // dp)
        lanes = slice(lo, lo + B // dp)
        args = [torch.from_numpy(np.ascontiguousarray(a[lanes])).to(
            self.device) for a in (P, q, A, b)]
        out = self._solve_fn(*args)
        keys = list(out)
        widths = [out[k][0].numel() for k in keys]
        buf = torch.zeros((B, sum(widths)), dtype=torch.float64,
                          device=self.device)
        buf[lanes] = torch.cat([out[k].reshape(B // dp, -1).to(torch.float64)
                                for k in keys], dim=1)
        host = all_reduce(buf, group).cpu()
        gathered, off = {}, 0
        for k, w in zip(keys, widths):
            gathered[k] = host[:, off:off + w].to(out[k].dtype).reshape(
                (B,) + tuple(out[k].shape[1:])).numpy()
            off += w
        return gathered

    def _rescue_pass(self, out, P, q, A, b):
        """Re-solve the lanes that did not reach SOLVED, stage by stage,
        and keep a stage's result on the lanes it solves.  Lanes are padded
        to a power of two (at least 32, by cycling the failed indices) so
        that repeated rescues see a few batch shapes."""
        B = out["status"].shape[0]
        for fn in self._rescue_fns:
            idx = np.nonzero(out["status"] != SOLVED)[0]
            if len(idx) == 0:
                return out
            Bp = min(max(32, _next_pow2(len(idx))), B)
            pad = np.resize(idx, Bp)
            # the megakernel path passes P through raw (upper-triangular or
            # full): symmetrize just the rescued slice
            rargs = [arr[pad] for arr in (P, q, A, b)]
            rargs[0] = _symmetrize_triu(rargs[0])
            rout = self._run_loop(fn, *rargs, self._rescue_device)
            fixed = rout["status"][:len(idx)] == SOLVED
            take = idx[fixed]
            if len(take):
                sel = np.nonzero(fixed)[0]
                for k in list(out.keys()):
                    if k not in rout:
                        continue
                    merged = np.array(out[k])   # never write into a view
                    merged[take] = rout[k][sel]
                    out[k] = merged
                if hasattr(out, "merge_lanes"):
                    # LazyOutputs: z/s/diagnostics merge when first read
                    out.merge_lanes(take, sel, rout)
        return out

    def solve(self, P, q, A, b) -> BatchSolution:
        """P: (B,n,n) full or upper-triangular symmetric (or None for LP
        batches); q: (B,n); A: (B,m,n); b: (B,m).  On the megakernel path P
        passes through raw (the kernel reads its upper triangle only); the
        loop path symmetrizes it."""
        q, A, b = (np.asarray(x, np.float64) for x in (q, A, b))
        if P is None:
            P = np.zeros((q.shape[0] if q.ndim else 0, self.n, self.n))
        P = np.asarray(P, np.float64)
        self._check_shapes(P, q, A, b)
        t0 = time.perf_counter()
        if self._mega_fn is not None:
            out = self._mega_fn(P, q, A, b)
        elif self._mesh is not None:
            P = _symmetrize_triu(P)
            out = self._run_sharded(P, q, A, b)
        else:
            P = _symmetrize_triu(P)
            out = self._run_loop(self._solve_fn, P, q, A, b, self.device)
        if self._rescue_fns is not None:
            out = self._rescue_pass(out, P, q, A, b)
        return BatchSolution(out, time.perf_counter() - t0)
