"""Presolver: eliminate nonnegative-cone rows with infinite bounds.

Host-side setup-time reduction, mirroring the reference presolver
(reference: src/presolver.jl:110-152 reduce, :27-53 map construction,
:85-107 reverse).  Rows i in nonnegative cones with b[i] > INFINITY*(1-10ε)
are dropped; the reverse step reinstates s[i] = INFINITY, z[i] = 0.
A copy of `clarabel_tpu/presolver.py` over the port's cone classes.
"""

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .cones.api import SupportedCone, NonnegativeConeT, ZeroConeT, nvars


@dataclasses.dataclass
class Presolver:
    keep_logical: np.ndarray            # (m_full,) bool
    reduced_cones: List[SupportedCone]
    m_full: int
    m_reduced: int
    infinity: float

    @property
    def is_reduced(self) -> bool:
        return self.m_reduced < self.m_full


def try_presolve(A, b, cones: Sequence[SupportedCone], infinity: float) -> Optional[Presolver]:
    """Detect and build the reduction, or None if nothing to reduce."""
    m = b.shape[0]
    thresh = infinity * (1.0 - 10 * np.finfo(np.float64).eps)
    keep = np.ones(m, dtype=bool)
    reduced_cones: List[SupportedCone] = []
    any_reduced = False

    ofs = 0
    for cone in cones:
        k = nvars(cone)
        if isinstance(cone, NonnegativeConeT):
            blk = b[ofs:ofs + k] < thresh
            keep[ofs:ofs + k] = blk
            newdim = int(blk.sum())
            if newdim != k:
                any_reduced = True
            if newdim > 0:
                reduced_cones.append(NonnegativeConeT(newdim))
        else:
            reduced_cones.append(cone)
        ofs += k

    if not any_reduced:
        return None
    return Presolver(
        keep_logical=keep,
        reduced_cones=reduced_cones,
        m_full=m,
        m_reduced=int(keep.sum()),
        infinity=infinity,
    )


def presolve_reduce(p: Presolver, A, b):
    return A[p.keep_logical, :], b[p.keep_logical]


def presolve_reverse(p: Presolver, z_red, s_red):
    """Scatter reduced duals/slacks back to full size.
    reference: src/presolver.jl:85-107"""
    z = np.zeros(p.m_full, dtype=z_red.dtype)
    s = np.full(p.m_full, p.infinity, dtype=s_red.dtype)
    z[p.keep_logical] = z_red
    s[p.keep_logical] = s_red
    return z, s
