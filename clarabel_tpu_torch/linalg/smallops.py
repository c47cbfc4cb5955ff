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
