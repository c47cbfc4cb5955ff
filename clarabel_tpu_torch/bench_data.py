"""Instance generators for the batched small-conic workloads.

The port's own copies of the generators in the repository's `bench.py`
(`make_batch`, the qp_eq batch and the exponential-cone batch), so that the
port and its smoke script draw the same instances as the JAX package's
benchmark from the same seed, plus two variants of the bench shape
(primal-infeasible lanes and an LP batch with P = 0), a power-cone batch,
and batches of quasidefinite KKT matrices for the LDL kernel; and the
single-instance sparse problems of the repository's benchmark
configurations (`grid_qp_sparse`, `large_banded_qp_sparse`,
`robust_ls_banded`), which the sparse `Solver` takes; and the BASELINE.md
configurations of `benchmarks/configs.py` (`markowitz_qp`, `cvxqp_style`,
`aug2d_style`, `robust_least_squares_socp`, `batched_socp`,
`maxcut_sdp`), which `baseline_torch.py` runs.  numpy and scipy.sparse
only.
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


def grid_qp_sparse(g, seed=7):
    """The 2-D grid-Laplacian QP of `benchmarks/grid_qp.py` (l.22), the
    nested-dissection plan's problem class: min ½x'Px + q'x s.t. x ≥ 0 on
    a g x g grid, n = g², as scipy-sparse (P, q, A, b) with A = −I; its
    cones are [NonnegativeConeT(g²)]."""
    import scipy.sparse as sp

    n = g * g
    rng = np.random.default_rng(seed)
    diag = 4.0 + rng.uniform(0.5, 1.5, n)
    rows, cols, vals = [], [], []

    def idx(i, j):
        return i * g + j

    for i in range(g):
        for j in range(g):
            rows.append(idx(i, j))
            cols.append(idx(i, j))
            vals.append(diag[idx(i, j)])
            for di, dj in ((0, 1), (1, 0)):
                if i + di < g and j + dj < g:
                    rows += [idx(i, j), idx(i + di, j + dj)]
                    cols += [idx(i + di, j + dj), idx(i, j)]
                    vals += [-1.0, -1.0]
    P = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    q = rng.standard_normal(n)
    A = -sp.eye(n).tocsr()
    b = np.zeros(n)
    return P, q, A, b


def large_banded_qp_sparse(grid=2500, seed=0):
    """The AUG2DC-scale banded QP of `benchmarks/configs.py` (l.167),
    assembled in scipy sparse: n = 2·grid variables, grid chain equalities
    (a zero cone) and 4·grid bounds.  Returns (P, q, A, b, cones) with the
    port's cone classes."""
    import scipy.sparse as sps

    from .cones.api import NonnegativeConeT, ZeroConeT

    rng = np.random.default_rng(seed)
    n = 2 * grid
    diag = rng.uniform(1.0, 3.0, n)
    off = rng.uniform(-0.4, 0.4, n - 1)
    P = sps.diags([off, diag, off], offsets=[-1, 0, 1], format="csr")
    q = rng.standard_normal(n)
    m_eq = grid
    rows = np.repeat(np.arange(m_eq), 2)
    cols = np.empty(2 * m_eq, dtype=np.int64)
    cols[0::2] = 2 * np.arange(m_eq)
    cols[1::2] = 2 * np.arange(m_eq) + 1
    vals = np.tile([1.0, -1.0], m_eq)
    Aeq = sps.coo_matrix((vals, (rows, cols)), shape=(m_eq, n)).tocsr()
    beq = rng.standard_normal(m_eq) * 0.1
    eye = sps.identity(n, format="csr")
    A = sps.vstack([Aeq, eye, -eye]).tocsr()
    b = np.concatenate([beq, 5 * np.ones(n), 5 * np.ones(n)])
    cones = [ZeroConeT(m_eq), NonnegativeConeT(2 * n)]
    return P, q, A, b, cones


def robust_ls_banded(m=240, n=80, band=3, seed=0):
    """The robust least-squares SOCP of `tests/test_soc_rank2.py` (l.19):
    min t s.t. ||Fx − g|| ≤ t, |x_i| ≤ 2, with a banded F, so the KKT
    keeps a block-arrow structure beside the big SOC.  Returns (P, q, A,
    b, cones, F, g) with the port's cone classes."""
    import scipy.sparse as sp

    from .cones.api import NonnegativeConeT, SecondOrderConeT

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        j0 = int(i * n / m)
        for dj in range(band):
            j = min(n - 1, j0 + dj)
            rows.append(i)
            cols.append(j)
            vals.append(rng.standard_normal())
    F = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    g = rng.standard_normal(m)

    nv = n + 1  # x and the epigraph variable t
    # SOC rows: s0 = t (row [0..0, -1], b 0); s_i = (Fx − g)_i
    A_soc = sp.vstack([
        sp.coo_matrix(([-1.0], ([0], [n])), shape=(1, nv)),
        sp.hstack([-F, sp.csr_matrix((m, 1))]),
    ])
    b_soc = np.concatenate([[0.0], -g])
    # bounds |x_i| <= 2
    eye = sp.eye(n, format="csr")
    Z1 = sp.csr_matrix((n, 1))
    A_bnd = sp.vstack([sp.hstack([eye, Z1]), sp.hstack([-eye, Z1])])
    b_bnd = 2.0 * np.ones(2 * n)

    A = sp.vstack([A_soc, A_bnd]).tocsr()
    b = np.concatenate([b_soc, b_bnd])
    P = sp.csr_matrix((nv, nv))
    q = np.zeros(nv)
    q[n] = 1.0
    cones = [SecondOrderConeT(m + 1), NonnegativeConeT(2 * n)]
    return P, q, A, b, cones, F, g


# The BASELINE.md configurations: copies of the generators in
# `benchmarks/configs.py`, draw for draw, each returning the port's cone
# classes.  `baseline_torch.py` runs them.

def markowitz_qp(n_assets=200, seed=0):
    """min (1/2) x'Σx - γ μ'x  s.t.  1'x = 1, x >= 0 (configs.py l.19)."""
    from .cones.api import NonnegativeConeT, ZeroConeT

    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n_assets, max(10, n_assets // 10)))
    Sigma = F @ F.T / n_assets + 0.01 * np.eye(n_assets)
    mu = rng.uniform(0.0, 0.1, n_assets)
    gamma = 1.0

    P = Sigma
    q = -gamma * mu
    A = np.vstack([np.ones((1, n_assets)), -np.eye(n_assets)])
    b = np.concatenate([[1.0], np.zeros(n_assets)])
    cones = [ZeroConeT(1), NonnegativeConeT(n_assets)]
    return P, q, A, b, cones


def cvxqp_style(n=100, seed=0):
    """Convex QP in the CVXQP family structure: sparse P (tridiag-ish),
    m = n/2 sparse equality constraints, box constraints (configs.py
    l.35)."""
    from .cones.api import NonnegativeConeT, ZeroConeT

    rng = np.random.default_rng(seed)
    m_eq = n // 2
    # sparse SPD P: tridiagonal + a few random couplings
    P = np.diag(rng.uniform(1.0, 5.0, n))
    off = rng.uniform(-0.5, 0.5, n - 1)
    P += np.diag(off, 1) + np.diag(off, -1)
    P = P + n * 1e-3 * np.eye(n)
    q = rng.standard_normal(n)
    # each equality touches ~3 variables
    Aeq = np.zeros((m_eq, n))
    for i in range(m_eq):
        cols = rng.choice(n, 3, replace=False)
        Aeq[i, cols] = rng.standard_normal(3)
    beq = Aeq @ rng.uniform(-1, 1, n)
    # box: -10 <= x <= 10
    A = np.vstack([Aeq, np.eye(n), -np.eye(n)])
    b = np.concatenate([beq, 10 * np.ones(n), 10 * np.ones(n)])
    cones = [ZeroConeT(m_eq), NonnegativeConeT(2 * n)]
    return P, q, A, b, cones


def aug2d_style(grid=10, seed=0):
    """AUG2DC-style expanded quadratic network problem on a 2-d grid
    (configs.py l.59)."""
    from .cones.api import ZeroConeT

    rng = np.random.default_rng(seed)
    n = 2 * grid * grid
    m_eq = grid * grid
    P = np.eye(n)
    q = rng.standard_normal(n) * 0.1
    Aeq = np.zeros((m_eq, n))
    for i in range(m_eq):
        Aeq[i, 2 * i] = 1.0
        Aeq[i, 2 * i + 1] = -1.0
        if i + 1 < m_eq:
            Aeq[i, (2 * i + 2) % n] = 0.5
    beq = rng.standard_normal(m_eq) * 0.1
    cones = [ZeroConeT(m_eq)]
    return P, q, Aeq, beq, cones


def robust_least_squares_socp(m=2000, n=500, seed=0):
    """Robust LS: min t + rho*u  s.t. ||Fx - g|| <= t, ||x|| <= u, dense
    (configs.py l.77).  Variables: (x, t, u) in R^{n+2}."""
    from .cones.api import SecondOrderConeT

    rng = np.random.default_rng(seed)
    F = rng.standard_normal((m, n)) / np.sqrt(m)
    g = rng.standard_normal(m)
    rho = 0.1

    nv = n + 2
    P = np.zeros((nv, nv))
    q = np.zeros(nv)
    q[n] = 1.0      # t
    q[n + 1] = rho  # u

    # SOC 1: s = (t, Fx - g) in K_{m+1}
    A1 = np.zeros((m + 1, nv))
    A1[0, n] = -1.0
    A1[1:, :n] = -F
    b1 = np.concatenate([[0.0], -g])
    # SOC 2: s = (u, x) in K_{n+1}
    A2 = np.zeros((n + 1, nv))
    A2[0, n + 1] = -1.0
    A2[1:, :n] = -np.eye(n)
    b2 = np.zeros(n + 1)

    A = np.vstack([A1, A2])
    b = np.concatenate([b1, b2])
    cones = [SecondOrderConeT(m + 1), SecondOrderConeT(n + 1)]
    return P, q, A, b, cones


def batched_socp(B=4096, n=6, seed=0):
    """Batch of small random SOCPs (configs.py l.110): the bench shape,
    drawn as `make_batch` draws it.  Returns ((P, q, A, b), cones)."""
    from .cones.api import NonnegativeConeT, SecondOrderConeT

    cones = [NonnegativeConeT(n), SecondOrderConeT(n + 1)]
    return make_batch(B, n, seed), cones


def maxcut_sdp(nv=100, density=0.05, seed=0):
    """Max-cut SDP relaxation, dual form (configs.py l.125):
        min 1'y  s.t.  diag(y) − L/4 ⪰ 0
    over a sparse banded graph Laplacian.  The PSD rows of [A b] carry the
    graph's sparsity, so the chordal decomposition engages."""
    from .cones.api import PSDTriangleConeT

    rng = np.random.default_rng(seed)
    W = np.zeros((nv, nv))
    for i in range(nv - 1):
        W[i, i + 1] = W[i + 1, i] = rng.uniform(0.5, 1.5)
    extra = int(density * nv * nv / 2)
    for _ in range(extra):
        i, j = rng.integers(0, nv, 2)
        if i != j and abs(i - j) < 8:
            W[i, j] = W[j, i] = rng.uniform(0.5, 1.5)
    L = np.diag(W.sum(axis=1)) - W
    t = nv * (nv + 1) // 2

    def tri(i, j):
        i, j = min(i, j), max(i, j)
        return (j * (j + 1)) // 2 + i

    def svec(M):
        out = np.zeros(t)
        for col in range(nv):
            for row in range(col + 1):
                out[tri(row, col)] = M[row, col] * (
                    1.0 if row == col else np.sqrt(2.0)
                )
        return out

    # variables y ∈ R^nv;  s = svec(diag(y) − L/4) ∈ PSD cone
    P = np.zeros((nv, nv))
    q = np.ones(nv)
    A_psd = np.zeros((t, nv))
    for i in range(nv):
        A_psd[tri(i, i), i] = -1.0
    b_psd = -svec(L / 4.0)
    cones = [PSDTriangleConeT(nv)]
    return P, q, A_psd, b_psd, cones
