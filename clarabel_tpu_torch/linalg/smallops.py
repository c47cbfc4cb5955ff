"""Small batched products over a leading lane axis.

The reference (`clarabel_tpu/linalg/smallops.py`) writes these contractions
as unrolled sums, because float64 `dot_general` on a TPU pays a large fixed
cost.  The card has native float64 and float32 products, so the port's
versions are plain batched matmuls: every operand carries the lane axis
first, (B, ...).  Float32 products run in full float32 on the card
(`torch.backends.cuda.matmul.allow_tf32` is False by default), and the port
does not change that.
"""

import torch


def vdot(x, y):
    """Per-lane xᵀy: (B, K), (B, K) -> (B,)."""
    return (x * y).sum(-1)


def mv(A, x):
    """A @ x for A (B, m, K) and x (B, K) or (B, K, r)."""
    if x.dim() == A.dim() - 1:
        return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)
    return torch.matmul(A, x)


def rmv(A, x):
    """Aᵀ @ x for A (B, K, n) and x (B, K) or (B, K, r)."""
    return mv(A.transpose(-1, -2), x)


def mm(A, B):
    """A @ B for batched matrices."""
    return torch.matmul(A, B)


def chol3_solve(H, B):
    """Batched 3×3 SPD solve by the closed-form Cholesky and substitution
    of the reference (`clarabel_tpu/linalg/smallops.py` chol3_solve;
    src/utils/mathutils.jl:427-466).  NaNs propagate on indefinite input.

    H: (..., 3, 3); B: (..., 3) or (..., 3, k)."""
    vec_in = B.dim() == H.dim() - 1
    if vec_in:
        B = B.unsqueeze(-1)
    l11 = torch.sqrt(H[..., 0, 0])
    l21 = H[..., 1, 0] / l11
    l31 = H[..., 2, 0] / l11
    l22 = torch.sqrt(H[..., 1, 1] - l21 * l21)
    l32 = (H[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(H[..., 2, 2] - l31 * l31 - l32 * l32)
    l11, l21, l31, l22, l32, l33 = (t[..., None] for t in
                                    (l11, l21, l31, l22, l32, l33))
    # forward: L y = B; back: Lᵀ x = y
    y1 = B[..., 0, :] / l11
    y2 = (B[..., 1, :] - l21 * y1) / l22
    y3 = (B[..., 2, :] - l31 * y1 - l32 * y2) / l33
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    X = torch.stack([x1, x2, x3], dim=-2)
    return X[..., 0] if vec_in else X
