"""Lightweight problem-building interface.

The reference exposes its solver to modeling tools through a MOI wrapper
(`Clarabel.Optimizer`, reference: src/MOI_wrapper/MOI_wrapper.jl) that
assembles `min ½x'Px + q'x s.t. Ax + s = b, s ∈ K` from individually added
constraints.  The Python counterpart here is a small builder that plays
the same role for users who think in constraint blocks rather than in a
pre-assembled (P, q, A, b, cones) tuple:

    pb = ProblemBuilder(n)
    pb.minimize(P=..., q=...)
    pb.add_equality(Aeq, beq)          # Aeq x == beq
    pb.add_inequality(G, h)            # G x <= h
    pb.add_bound_box(lb, ub)           # lb <= x <= ub
    pb.add_soc(C, d)                   # (C x + d) ∈ second-order cone
    pb.add_psd(C, d)                   # svec-matrix (C x + d) ⪰ 0
    pb.add_exp(C, d); pb.add_pow(C, d, alpha); pb.add_genpow(C, d, a, m2)
    sol = pb.solve(settings)                  # on the card
    sol = pb.solve(settings, device="cpu")

Internally each call appends rows to A/b with the matching cone, with the
sign convention s = b − Ax ∈ K.  The port's copy of the JAX package's
`modeling.py`; `build` and `solve` take the `Solver`'s `device`.
"""

from typing import List, Optional, Sequence

import numpy as np

from .cones.api import (
    SupportedCone, ZeroConeT, NonnegativeConeT, SecondOrderConeT,
    ExponentialConeT, PowerConeT, GenPowerConeT, PSDTriangleConeT,
    nvars, triangular_number,
)
from .settings import Settings


class ProblemBuilder:
    def __init__(self, n: int):
        self.n = int(n)
        self._P = np.zeros((n, n))
        self._q = np.zeros(n)
        self._A_blocks: List[np.ndarray] = []
        self._b_blocks: List[np.ndarray] = []
        self._cones: List[SupportedCone] = []

    # ------------------------------------------------------------------
    def minimize(self, P=None, q=None):
        """Set the objective ½x'Px + q'x (triu of P is used)."""
        if P is not None:
            P = np.asarray(P, dtype=np.float64)
            if P.shape != (self.n, self.n):
                raise ValueError("P must be n-by-n")
            self._P = P
        if q is not None:
            q = np.asarray(q, dtype=np.float64).ravel()
            if q.shape[0] != self.n:
                raise ValueError("q must have length n")
            self._q = q
        return self

    def _add_block(self, A, b, cone: SupportedCone):
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        b = np.atleast_1d(np.asarray(b, dtype=np.float64))
        if A.shape != (b.shape[0], self.n):
            raise ValueError(
                f"constraint block shape mismatch: A {A.shape}, b {b.shape}"
            )
        if b.shape[0] != nvars(cone):
            raise ValueError("rows do not match cone dimension")
        self._A_blocks.append(A)
        self._b_blocks.append(b)
        self._cones.append(cone)
        return self

    # ------------------------------------------------------------------
    def add_equality(self, Aeq, beq):
        """Aeq x == beq."""
        beq = np.atleast_1d(np.asarray(beq, dtype=np.float64))
        return self._add_block(Aeq, beq, ZeroConeT(beq.shape[0]))

    def add_inequality(self, G, h):
        """G x <= h  (slack in the nonnegative cone)."""
        h = np.atleast_1d(np.asarray(h, dtype=np.float64))
        return self._add_block(G, h, NonnegativeConeT(h.shape[0]))

    def add_bound_box(self, lb=None, ub=None):
        """lb <= x <= ub (either side optional; np.inf entries skipped)."""
        eye = np.eye(self.n)
        if ub is not None:
            ub = np.broadcast_to(np.asarray(ub, dtype=np.float64), (self.n,))
            keep = np.isfinite(ub)
            if keep.any():
                self.add_inequality(eye[keep], ub[keep])
        if lb is not None:
            lb = np.broadcast_to(np.asarray(lb, dtype=np.float64), (self.n,))
            keep = np.isfinite(lb)
            if keep.any():
                self.add_inequality(-eye[keep], -lb[keep])
        return self

    def add_soc(self, C, d):
        """(C x + d) ∈ second-order cone (first row is the cone scalar)."""
        d = np.atleast_1d(np.asarray(d, dtype=np.float64))
        return self._add_block(-np.asarray(C), d, SecondOrderConeT(d.shape[0]))

    def add_exp(self, C, d):
        """(C x + d) ∈ exponential cone (3 rows)."""
        return self._add_block(-np.asarray(C), d, ExponentialConeT())

    def add_pow(self, C, d, alpha: float):
        """(C x + d) ∈ power cone with exponent alpha (3 rows)."""
        return self._add_block(-np.asarray(C), d, PowerConeT(alpha))

    def add_genpow(self, C, d, alpha: Sequence[float], dim2: int):
        return self._add_block(
            -np.asarray(C), d, GenPowerConeT(tuple(alpha), dim2)
        )

    def add_psd(self, C, d):
        """svec-matrix (C x + d) ⪰ 0; rows are svec entries (√2-scaled
        off-diagonals, column-major upper triangle)."""
        d = np.atleast_1d(np.asarray(d, dtype=np.float64))
        t = d.shape[0]
        # invert triangular number
        nd = int((np.sqrt(8 * t + 1) - 1) / 2)
        if triangular_number(nd) != t:
            raise ValueError("psd block row count is not a triangular number")
        return self._add_block(-np.asarray(C), d, PSDTriangleConeT(nd))

    # ------------------------------------------------------------------
    def build(self, settings: Optional[Settings] = None, device=None):
        """The set-up `Solver` (on the card when `device` is None)."""
        from .api import Solver

        if self._A_blocks:
            A = np.vstack(self._A_blocks)
            b = np.concatenate(self._b_blocks)
        else:
            A = np.zeros((0, self.n))
            b = np.zeros(0)
        return Solver(self._P, self._q, A, b, list(self._cones), settings,
                      device=device)

    def solve(self, settings: Optional[Settings] = None, device=None):
        return self.build(settings, device).solve()
