"""The bench family: min 1/2 x'Px + q'x  s.t.  x <= ub,  ||x|| <= r.

The distribution of `bench.py` `make_batch` (lines 75-85; the port's copy
is `clarabel_tpu_torch/bench_data.make_batch`): per lane F (n x n) with
N(0, 1/n) entries, P = F F' + I/2, q ~ N(0, I), ub ~ U(0.5, 1.5)^n and
r ~ U(1, 2).  Cones [NN(n), SOC(n + 1)], m = 2n + 1: s = b - A x with
A = [I; 0; -I] and b = [ub; r; 0], so the nn rows hold x <= ub and the
SOC holds (r, x).

The original draws lane by lane from numpy on the host, about a second a
batch of 16,384 lanes at n = 26; a pool of dozens of batches would make
set-up most of a run.  So the draws are made on the run's device with a
`torch.Generator` seeded from (seed, batch), in a few large calls, in
float64, and copied to the host once: the same distribution, other
numbers.  A is the same for every lane; one host array serves every batch
of the pool.
"""

import numpy as np
import torch


def _torch_seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 64, k]).generate_state(
        1, np.uint64)[0])


def make_pool(B, n, count, seed, device):
    """`count` batches of B lanes, each (P, q, A, b) as host float64
    arrays; batch k is drawn from (seed, k) alone."""
    A = np.ascontiguousarray(np.broadcast_to(
        np.vstack([np.eye(n), np.zeros((1, n)), -np.eye(n)]),
        (B, 2 * n + 1, n)))
    eye = 0.5 * torch.eye(n, dtype=torch.float64, device=device)
    pool = []
    for k in range(count):
        g = torch.Generator(device=device)
        g.manual_seed(_torch_seed(seed, k))
        F = torch.randn(B, n, n, generator=g, device=device,
                        dtype=torch.float64) / np.sqrt(n)
        q = torch.randn(B, n, generator=g, device=device,
                        dtype=torch.float64)
        u = torch.rand(B, n + 1, generator=g, device=device,
                       dtype=torch.float64)
        P = torch.bmm(F, F.transpose(1, 2))
        P = 0.5 * (P + P.transpose(1, 2)) + eye     # symmetric bit for bit
        b = torch.cat([0.5 + u[:, :n], 1.0 + u[:, n:],
                       torch.zeros(B, n, dtype=torch.float64,
                                   device=device)], dim=1)
        pool.append((P.cpu().numpy(), q.cpu().numpy(), A,
                     b.cpu().numpy()))
    return pool
