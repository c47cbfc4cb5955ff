"""The port's entry point: the batched conic-IPM solve and its example batch.

The counterpart of `entry()` in the repository's `__graft_entry__.py`
(l.26-38), which returns `jax.vmap(build_solve(...))` for the cones
[NonnegativeConeT(6), SecondOrderConeT(7)] under `Settings()` and
`_example_batch()`.  Here `build_solve` is the port's batched loop solver
(`ipm/loop.py`), which takes (B, ...) tensors itself.

    fn, (P, q, A, b) = entry()              # on the card
    fn, args = entry(device="cpu")          # the plain versions, on the CPU
    out = fn(*args)                         # dict of (B, ...) tensors
"""

from typing import Callable, Tuple

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
