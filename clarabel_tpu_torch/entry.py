"""The port's entry point: the batched conic-IPM solve and its example batch.

The counterpart of `entry()` in the repository's `__graft_entry__.py`
(l.26-38), which returns `jax.vmap(build_solve(...))` for the cones
[NonnegativeConeT(6), SecondOrderConeT(7)] under `Settings()` and
`_example_batch()`.  Here `build_solve` is the port's batched loop solver
(`ipm/loop.py`), which takes (B, ...) tensors itself.

    fn, (P, q, A, b) = entry()              # on the card
    fn, args = entry(device="cpu")          # the plain versions, on the CPU
    out = fn(*args)                         # dict of (B, ...) tensors

`dryrun_multichip()` is the counterpart of the same file's
`dryrun_multichip` (l.41-125): under an initialized process group, every
rank solves a batch split over a "dp" mesh and one QP whose block-arrow
factorization is sharded over a "tp" mesh (`parallel/dryrun.py` starts
the ranks).
"""

from typing import Callable, Tuple

import numpy as np
import torch

from . import bench_data
from .cones.api import NonnegativeConeT, SecondOrderConeT
from .cones.layout import ConeLayout
from .ipm.loop import build_solve
from .parallel.batch_impl import resolve_device
from .settings import Settings

N = 6


def example_batch(B: int = 4, n: int = N, seed: int = 0):
    """`_example_batch` of `__graft_entry__.py` (l.12-23), draw for draw:
    numpy (P, q, A, b) with P full symmetric.  It is the same generator as
    `bench_data.make_batch`."""
    return bench_data.make_batch(B, n, seed)


def entry(device=None) -> Tuple[Callable, Tuple[torch.Tensor, ...]]:
    """(fn, (P, q, A, b)): the batched solve for [NN(6), SOC(7)] under
    `Settings()` and the example batch as float64 tensors on `device`
    (the card when None; with no card, pass "cpu")."""
    device = resolve_device(device)
    cones = [NonnegativeConeT(N), SecondOrderConeT(N + 1)]
    fn = build_solve(ConeLayout(cones), Settings(), N, p_nonzero=True)
    args = tuple(torch.from_numpy(a).to(device) for a in example_batch())
    return fn, args


def chain_qp(grid: int, seed: int = 0):
    """The dryrun's chain QP (`__graft_entry__.py` l.95-111): a banded P
    over 2·grid variables, grid chain equalities and boxes ±5; returns
    (P, q, A, b, cones)."""
    from .cones.api import ZeroConeT

    rng = np.random.default_rng(seed)
    nq = 2 * grid
    Pq = np.zeros((nq, nq))
    for i in range(nq):
        Pq[i, i] = rng.uniform(1.0, 3.0)
        if i + 1 < nq:
            v = rng.uniform(-0.3, 0.3)
            Pq[i, i + 1] = Pq[i + 1, i] = v
    qq = rng.standard_normal(nq)
    Aeq = np.zeros((grid, nq))
    for i in range(grid):
        Aeq[i, 2 * i], Aeq[i, 2 * i + 1] = 1.0, -1.0
    A = np.vstack([Aeq, np.eye(nq), -np.eye(nq)])
    b = np.concatenate([rng.standard_normal(grid) * 0.1, 5 * np.ones(nq),
                        5 * np.ones(nq)])
    return Pq, qq, A, b, [ZeroConeT(grid), NonnegativeConeT(2 * nq)]


def _expect(cond, msg):
    if not cond:
        raise AssertionError(msg)


def dryrun_multichip(n_devices=None, device=None) -> str:
    """Run on every rank of an initialized process group: a batch of
    2·n_devices lanes at n = 4 split over a "dp" mesh of n_devices ranks,
    then the chain QP (grid max(8, 2·tp)) with its block-arrow
    factorization sharded over a "tp" mesh of the same ranks.  Checks what
    the reference's dryrun asserts, prints its summary line on rank 0 and
    returns it.  `n_devices`: the world size when None; `device`: the
    rank's own card when None (a CPU world passes "cpu")."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .api import Solver
    from .parallel.batch_impl import BatchSolver
    from .parallel.multihost import mesh_device
    from .statuscodes import SolverStatus

    if not dist.is_initialized():
        raise RuntimeError("dryrun_multichip runs under an initialized "
                           "process group (parallel/dryrun.py starts one)")
    if n_devices is None:
        n_devices = dist.get_world_size()
    dev = mesh_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)      # before DeviceMesh picks a card
    ranks = torch.arange(n_devices)
    dp_mesh = DeviceMesh(dev.type, ranks, mesh_dim_names=("dp",))

    n = 4
    cones = [NonnegativeConeT(n), SecondOrderConeT(n + 1)]
    B = 2 * n_devices
    P, q, A, b = example_batch(B=B, n=n, seed=1)
    out = BatchSolver(cones, n, Settings(), mesh=dp_mesh,
                      device=dev).solve(P, q, A, b)
    _expect(out.x.shape == (B, n), f"x of shape {out.x.shape}")
    statuses = out.status
    # the reference accepts ALMOST_SOLVED on a minority of marginal lanes
    # (`__graft_entry__.py` l.71-86): the dryrun checks the sharding
    ok_lanes = np.isin(statuses, (int(SolverStatus.SOLVED),
                                  int(SolverStatus.ALMOST_SOLVED)))
    _expect(ok_lanes.all(), f"dp-sharded batch failed: {statuses}")
    n_solved = int((statuses == int(SolverStatus.SOLVED)).sum())
    _expect(n_solved >= B - 2,
            f"dp-sharded batch did not converge: {statuses}")

    tp_mesh = DeviceMesh(dev.type, ranks, mesh_dim_names=("tp",))
    solver = Solver(*chain_qp(max(8, 2 * n_devices)), mesh=tp_mesh,
                    device=dev)
    _expect(solver._backend == "blockarrow", solver._backend)
    _expect(solver._structure.p % n_devices == 0,
            f"{solver._structure.p} blocks over {n_devices} ranks")
    sol = solver.solve()
    _expect(sol.status == SolverStatus.SOLVED,
            f"tp-sharded IPM did not converge: {sol.status}")
    _expect(sol.r_prim < 1e-8 and sol.r_dual < 1e-8,
            f"residuals {sol.r_prim:.2e} {sol.r_dual:.2e}")
    line = (f"dryrun_multichip OK on {n_devices} devices (dp batch solve "
            f"statuses={statuses.tolist()}; tp-sharded IPM SOLVED in "
            f"{sol.iterations} iters, r_prim={sol.r_prim:.2e}, "
            f"r_dual={sol.r_dual:.2e})")
    if dist.get_rank() == 0:
        print(line, flush=True)
    return line
