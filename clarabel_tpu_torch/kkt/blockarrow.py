"""The true augmented KKT operator, composed from its parts.

Only `make_kkt_matvec` of `clarabel_tpu/kkt/blockarrow.py` is ported: the
condensed backend refines against it.  The block-arrow factorization waits
for ROADMAP.md Queue 1 item 11 (sparse and structured KKT).
"""

import torch

from ..cones import ops as cone_ops
from ..linalg import smallops as so


def make_kkt_matvec(P, A, layout, state):
    """x -> [P Aᵀ; A −Hs] x for x (B, n+m) or (B, n+m, k), without the
    (n+m) x (n+m) matrix."""
    n = P.shape[-1]

    def matvec(x):
        x1, x2 = x[:, :n], x[:, n:]
        top = so.mv(P, x1) + so.rmv(A, x2)
        bot = so.mv(A, x1) - cone_ops.mul_Hs(layout, state, x2)
        return torch.cat([top, bot], dim=1)

    return matvec
