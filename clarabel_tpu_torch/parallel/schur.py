"""Distributed block-arrow KKT factorization via Schur complements.

A port of `clarabel_tpu/parallel/schur.py`.  A block-arrow quasidefinite
system

    K = [ D_1                 B_1 ]
        [      D_2            B_2 ]
        [           ...       ... ]
        [ B_1ᵀ B_2ᵀ  ...       C  ]

is sharded over the `tp` dim of a DeviceMesh: each rank LDL-factors its
contiguous share of the diagonal blocks D_i and forms their Schur
contribution Σ B_iᵀ D_i⁻¹ B_i; one all-reduce over the axis gives the dense
Schur complement S = C − Σ B_iᵀ D_i⁻¹ B_i, which every rank factors.  A
solve needs one more all-reduce for the reduced right-hand side, and one
to give every rank the whole solution.  The factor and the solve are the
Solver's own (`kkt/blockarrow.factor_blocks` and `_ba_apply`), over a plan
whose blocks are the consecutive rows of K.

Every rank of the mesh calls `factor` and `solve` with the same full host
arrays, and gets the whole numpy solution back.
"""

import numpy as np
import torch

from ..kkt.blockarrow import _ba_apply, factor_blocks, local_blocks
from ..settings import Settings
from ..structure import BlockArrowPlan
from .multihost import check_mesh, mesh_device


class BlockArrowKKT:
    """Multi-device block-arrow KKT solver: p diagonal blocks of size nb
    and a tail of size nt, the blocks sharded over the mesh's `axis` (p
    must be a multiple of its size).  `device`: the rank's own card when
    None; a CPU mesh passes "cpu"."""

    def __init__(self, mesh, p: int, nb: int, nt: int, signs_blk=None,
                 signs_tail=None, axis: str = "tp", device=None):
        check_mesh(mesh)
        self.mesh, self.axis = mesh, axis
        self.p, self.nb, self.nt = p, nb, nt
        self.group = mesh.get_group(axis)
        self.device = mesh_device(device)
        self.lo, self.hi = local_blocks(p, self.group)
        N = p * nb + nt
        self.plan = BlockArrowPlan(
            perm=np.arange(N),
            block_idx=np.arange(p * nb).reshape(p, nb),
            tail_idx=np.arange(p * nb, N),
            block_signs=np.broadcast_to(
                np.ones(nb) if signs_blk is None else np.asarray(signs_blk,
                                                                 float),
                (p, nb)).copy(),
            tail_signs=(np.ones(nt) if signs_tail is None
                        else np.asarray(signs_tail, float)),
            n=N, m=0)
        self._fac = None

    def _tensor(self, a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64),
                               device=self.device)

    def factor(self, D_blocks, B_blocks, C) -> bool:
        """D_blocks (p, nb, nb), B_blocks (p, nb, nt), C (nt, nt), all of
        them on every rank; each rank factors its own blocks.  Returns
        whether every block and the Schur complement factored."""
        lo, hi = self.lo, self.hi
        plan = self.plan
        self._fac = factor_blocks(
            self._tensor(D_blocks[lo:hi])[None],
            self._tensor(B_blocks[lo:hi])[None], self._tensor(C)[None],
            self._tensor(plan.block_signs[lo:hi]),
            self._tensor(plan.tail_signs), Settings(), self.group)
        return bool(self._fac.ok[0])

    def solve(self, rhs_blocks, rhs_tail):
        """K [x; y] = [rhs_blocks; rhs_tail] for rhs_blocks (p, nb) and
        rhs_tail (nt,): numpy x (p, nb) and y (nt,), on every rank."""
        if self._fac is None:
            raise RuntimeError("call factor() before solve()")
        rhs = np.concatenate([np.reshape(rhs_blocks, -1),
                              np.reshape(rhs_tail, -1)])
        sol = _ba_apply(self._fac, self.plan, self._tensor(rhs)[None],
                        self.group)[0].cpu().numpy()
        cut = self.p * self.nb
        return sol[:cut].reshape(self.p, self.nb), sol[cut:]
