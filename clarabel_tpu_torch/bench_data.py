"""Instance generators for the batched small-conic workloads.

The port's own copies of the generators in the repository's `bench.py`
(`make_batch`, the qp_eq batch and the exponential-cone batch), so that the
port and its smoke script draw the same instances as the JAX package's
benchmark from the same seed, plus two variants of the bench shape
(primal-infeasible lanes and an LP batch with P = 0), a power-cone batch,
and batches of quasidefinite KKT matrices for the LDL kernel.  numpy only.
"""

import numpy as np


def make_batch(B, n, seed=0):
    """The bench-shape SOCP batch: x <= ub (nn rows), ||x|| <= r (one SOC
    of dim n+1); P = F F' + I/2.  Cones [NN(n), SOC(n+1)], m = 2n+1.
    A copy of `bench.make_batch`, draw for draw."""
    rng = np.random.default_rng(seed)
    Ps, qs, As, bs = [], [], [], []
    for _ in range(B):
        F = rng.standard_normal((n, n)) / np.sqrt(n)
        Ps.append(F @ F.T + 0.5 * np.eye(n))
        qs.append(rng.standard_normal(n))
        As.append(np.vstack([np.eye(n), np.zeros((1, n)), -np.eye(n)]))
        bs.append(np.concatenate([rng.uniform(0.5, 1.5, n),
                                  [rng.uniform(1.0, 2.0)], np.zeros(n)]))
    return (np.stack(Ps), np.stack(qs), np.stack(As), np.stack(bs))


def make_qp_eq(B, n, seed=1):
    """The qp_eq batch of `bench.py`: sum x = 1 (zero cone), x <= ub,
    -sum x <= 0.5.  Cones [Zero(1), NN(n+1)], m = n+2."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", F, F) + 0.5 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = np.zeros((B, n + 2, n))
    A[:, 0, :] = 1.0
    A[:, 1:n + 1] = np.eye(n)
    A[:, n + 1] = -1.0
    b = np.concatenate([np.ones((B, 1)), rng.uniform(0.5, 1.5, (B, n)),
                        np.full((B, 1), 0.5)], axis=1)
    return P, q, A, b


def infeasible_lanes(B, every=8, first=3):
    """Lane indices that `make_infeasible_batch` makes infeasible."""
    return np.arange(first, B, every)


def make_infeasible_batch(B, n, seed=2, every=8, first=3):
    """The bench shape with x0 <= -3 on every `every`-th lane: together
    with ||x|| <= r, r in [1, 2], those lanes are primal infeasible."""
    P, q, A, b = make_batch(B, n, seed)
    b[infeasible_lanes(B, every, first), 0] = -3.0
    return P, q, A, b


def make_lp_batch(B, n, seed=3):
    """The bench shape as an LP (P = 0, solved with p_nonzero=False):
    the SOC bounds every lane."""
    _, q, A, b = make_batch(B, n, seed)
    return None, q, A, b


def _nonsym_rows(B, n):
    """A of the exp and pow batches: x0 <= b0, x1 <= b1 (nn rows) and
    (x0, x1, x2) + s = b3 in the 3-d cone."""
    A = np.zeros((B, 5, n))
    for r, c in ((0, 0), (1, 1), (2, 0), (3, 1), (4, 2)):
        A[:, r, c] = 1.0
    return A


def make_exp_batch(B, seed=2):
    """The exponential-cone batch of `bench.py` (`exp_cone_batched`): n=3,
    cones [NN(2), Exp()], m=5; P = F F' + I/2, q < -0.5.  A copy of
    `bench.py`'s draws, draw for draw."""
    n = 3
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", F, F) + 0.5 * np.eye(n)
    q = -np.abs(rng.standard_normal((B, n))) - 0.5
    A = _nonsym_rows(B, n)
    b = np.zeros((B, 5))
    b[:, 0] = 2.0
    b[:, 1] = 2.0
    b[:, 2] = rng.uniform(1.0, 2.0, B)
    b[:, 3] = rng.uniform(2.0, 3.0, B)
    b[:, 4] = rng.uniform(3.0, 5.0, B)
    return P, q, A, b


def make_pow_batch(B, seed=1, alpha=0.6):
    """The power-cone batch of `tests/test_megakernel_nonsym.py`
    (`_pow_batch`): n=3, cones [NN(2), Pow(alpha)], m=5.  Its draws, in
    bulk."""
    n = 3
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", F, F) + 0.5 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = _nonsym_rows(B, n)
    b = np.zeros((B, 5))
    b[:, 0] = 3.0
    b[:, 1] = 3.0
    b[:, 2] = rng.uniform(2.0, 3.0, B)
    b[:, 3] = rng.uniform(2.0, 3.0, B)
    b[:, 4] = rng.uniform(-0.3, 0.3, B)
    return P, q, A, b


def make_kkts(B, n, m, seed=0):
    """B quasidefinite KKT matrices [P A'; A -H] of size n + m, with
    P = F F' + n I and H diagonal in [0.5, 2], and their pivot signs
    (+1 n times, -1 m times): the distribution of
    `tests/test_pallas_kernel.py` make_kkts, drawn in bulk (so not its
    draws)."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n))
    P = np.einsum("bij,bkj->bik", F, F) + n * np.eye(n)
    A = rng.standard_normal((B, m, n))
    H = rng.uniform(0.5, 2.0, (B, m))
    K = np.zeros((B, n + m, n + m))
    K[:, :n, :n] = P
    K[:, n:, :n] = A
    K[:, :n, n:] = np.swapaxes(A, 1, 2)
    K[:, n:, n:] = -H[:, :, None] * np.eye(m)
    return K, np.concatenate([np.ones(n), -np.ones(m)])


def _svec(M):
    """Scaled upper-triangle vectorization of the trailing (nd, nd) axes,
    column by column, off-diagonals times sqrt(2)."""
    nd = M.shape[-1]
    out = []
    for c in range(nd):
        for r in range(c + 1):
            out.append(M[..., r, c] * (1.0 if r == c else np.sqrt(2.0)))
    return np.stack(out, axis=-1)


def make_sdp_batch(B, nd, seed=0):
    """The small-SDP batch of `tests/test_megakernel_psd.py` (`_sdp_batch`,
    which `bench.py` solves at side 3, seed 13): min q'x + x'Px/2 s.t.
    |x_i| <= 1 and B0 - sum x_i A_i psd.  n=3, cones [NN(6), PSD(nd)],
    m = 6 + nd(nd+1)/2.  Its draws, in bulk."""
    rng = np.random.default_rng(seed)
    nx = 3
    F = rng.standard_normal((B, nx, nx)) / np.sqrt(nx)
    P = np.einsum("bij,bkj->bik", F, F) + 0.3 * np.eye(nx)
    q = rng.standard_normal((B, nx))
    Amats = rng.standard_normal((B, nx, nd, nd))
    Amats = Amats + np.swapaxes(Amats, -1, -2)
    B0 = rng.standard_normal((B, nd, nd))
    B0 = B0 + np.swapaxes(B0, -1, -2)
    w = np.linalg.eigvalsh(B0)[:, 0]
    B0 = B0 + (np.abs(w) + 1.0)[:, None, None] * np.eye(nd)
    A = np.concatenate([
        np.broadcast_to(np.eye(nx), (B, nx, nx)),
        -np.broadcast_to(np.eye(nx), (B, nx, nx)),
        np.stack([_svec(Amats[:, i]) for i in range(nx)], axis=-1),
    ], axis=1)
    b = np.concatenate([np.ones((B, 2 * nx)), _svec(B0)], axis=1)
    return P, q, A, b


def make_sdp_zero_batch(B, nd=2, seed=77):
    """The equality-constrained SDP of `tests/test_megakernel_psd.py`
    (`test_psd_megakernel_with_zero_cone`): the SDP batch with its first
    bound row replaced by sum(x) = 0.5.  Cones [Zero(1), NN(5), PSD(nd)]."""
    P, q, A, b = make_sdp_batch(B, nd, seed)
    A = np.concatenate([np.ones((B, 1, 3)), A[:, 1:]], axis=1)
    b = np.concatenate([np.full((B, 1), 0.5), b[:, 1:]], axis=1)
    return P, q, A, b


def make_genpow_batch(B, seed=4):
    """The generalized-power-cone batch of `tests/test_megakernel_nonsym.py`
    (`test_genpow_matches_loop`): n=4, cones [NN(2), GenPow((0.3, 0.7), 2)],
    m=6.  Its draws, in bulk."""
    n = 4
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", F, F) + 0.5 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = np.zeros((B, 6, n))
    for r, c in ((0, 0), (1, 1), (2, 0), (3, 1), (4, 2), (5, 3)):
        A[:, r, c] = 1.0
    b = np.zeros((B, 6))
    b[:, 0] = 3.0
    b[:, 1] = 3.0
    b[:, 2] = rng.uniform(2.0, 3.0, B)
    b[:, 3] = rng.uniform(2.0, 3.0, B)
    b[:, 4] = rng.uniform(-0.3, 0.3, B)
    b[:, 5] = rng.uniform(-0.3, 0.3, B)
    return P, q, A, b


def make_large_qp_eq(B, n=200, n_eq=20, n_low=100, seed=5):
    """Dense QPs whose KKT system is larger than 512 (N = 2n + n_eq +
    n_low): P = F F'/n + I/2, q random, n_eq random equality rows (a zero
    cone) through a point of the box, x <= 1 on every variable and
    x >= -1 on the first n_low.  Cones [Zero(n_eq), NN(n + n_low)]."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", F, F) / n + 0.5 * np.eye(n)
    q = rng.standard_normal((B, n))
    Aeq = rng.standard_normal((B, n_eq, n)) / np.sqrt(n)
    x0 = rng.uniform(-0.5, 0.5, (B, n))
    low = np.zeros((n_low, n))
    low[np.arange(n_low), np.arange(n_low)] = -1.0
    A = np.concatenate([Aeq, np.broadcast_to(np.eye(n), (B, n, n)),
                        np.broadcast_to(low, (B, n_low, n))], axis=1)
    b = np.concatenate([np.einsum("bij,bj->bi", Aeq, x0),
                        np.ones((B, n + n_low))], axis=1)
    return P, q, A, b
