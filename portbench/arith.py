"""Frozen roofline arithmetic and peaks of the benchmark.

Copies of `chip_smoke.py`'s `flops_per_iteration`, `psd_genpow_flops`,
`k2_ops` and `k2_bound_ms` as they stand at the benchmark's first
commit, so that the yardstick cannot move with the program: a later change
to the program or to its smoke script leaves these numbers alone.
The peaks are NVIDIA's data sheet for one H100 SXM (dense, at the full
700 W power limit): HBM bandwidth in bytes/s, FP64 and FP32 outside the
tensor cores in operations/s.
"""

import numpy as np

HBM_RATE, FP64_RATE, FP32_RATE = 3.35e12, 34e12, 67e12


def segments(cones):
    """[(kind, lo, hi)] of a configuration's cones, [(kind, dim)] in row
    order: the `segs` of `flops_per_iteration`."""
    segs, lo = [], 0
    for kind, dim in cones:
        segs.append((kind, lo, lo + dim))
        lo += dim
    return tuple(segs)


def flops_per_iteration(n, m, segs, passes):
    """FP64 operations of one IPM iteration of the kernel, counted from
    its code with `passes` refinement passes per refined solve; an FMA
    counts two, a log, exp, pow or sqrt one.  A lower bound: the small
    per-segment scalar work, the comparisons, and every trip of a Newton
    or backtracking loop after its first are left out."""
    n_soc = sum(hi - lo for k, lo, hi in segs if k == "soc")
    n_ns = sum(1 for k, _, _ in segs if k in ("exp", "pow"))
    hinv_x, extra = psd_genpow_flops(segs, m)
    # an exp/pow segment's 3x3 solve or product costs 18 in place of the
    # 3 of three nn rows
    hinv = m + 4 * n_soc + 15 * n_ns + hinv_x  # one Hs^-1 (or Hs) apply
    matvec = 2 * m * n                        # A x or A' y
    pmv = 2 * n * n                           # P x
    chol_solve = 2 * n * n
    apply_once = 2 * hinv + 2 * matvec + chol_solve + n + m
    resid = 2 * matvec + pmv + hinv + 2 * (n + m)
    build = n * (hinv + (n + 1) * m) + n * n * n // 3 + n * n
    # 2-RHS solve (affine + constant) and 1-RHS corrector, each with its
    # first residual evaluation and `passes` (apply + residual) passes
    solves = 3 * (apply_once + resid) * (1 + passes) - 3 * resid
    residuals = 2 * matvec + pmv + 6 * (n + m) + 4 * n
    info = 8 * (n + m) + 20
    scaling = 8 * (m - n_soc) + 20 * n_soc
    tau = 3 * pmv + 12 * (n + m)
    steps = 2 * 2 * 8 * m                     # affine + combined step lengths
    shifts = 3 * 12 * m                       # affine_ds, combined shift, ds
    # per exp/pow segment: the dual gradient and Hessian (~60), the primal
    # gradient (Wright omega or one Newton trip and two polish steps, ~80),
    # the BFGS scaling (~150), two 3x3 factors (~40), the third-order
    # correction (~140), one trip of each feasibility backtrack (2 x 2 x
    # ~25)
    nonsym = n_ns * (60 + 80 + 150 + 40 + 140 + 100)
    return (residuals + info + scaling + build + solves + tau + steps
            + shifts + nonsym + extra)


def psd_genpow_flops(segs, m):
    """(the extra FP64 operations of one Hs^-1 or Hs apply, the other
    extra operations of one iteration) of the PSD (K1d) and generalized
    power (K1c) segments over what the same rows cost as nn rows, counted
    as `flops_per_iteration` counts, one trip of every Jacobi, Newton or
    backtracking loop (0, 0 for a layout without such segments).  Side-k
    PSD: a k x k product is 2k^3; an Hs apply is two sandwiches (four
    products); the scaling two factors, L2'L1, one Jacobi sweep of the SVD
    (k(k-1)/2 pairs, ~22k + 15 each) and R, Rinv; each of the four step
    components a sandwich and one eigenvalue sweep (~30); the shifts three
    sandwiches and two products.  Genpow of width w = d1 + d2: Hs^-1 by
    three Sherman-Morrison updates with their A u vectors (~33w), the
    scaling (at least 11w + 30 with its logs and exps), one trip of both
    feasibility tests per step length (~4w each), and one barrier trip (at
    least 7w + 10, and 3m for the rest of the barrier)."""
    hinv_x, extra = 0, 0
    for kind, lo, hi in segs:
        w = hi - lo
        if kind == "psd":
            k = {1: 1, 3: 2, 6: 3}[w]
            mm = 2 * k ** 3
            hinv_x += 4 * mm + w
            scaling = (2 * k ** 3 // 3 + mm + k * (k - 1) // 2 * (22 * k + 15)
                       + 2 * mm + 2 * k * k)
            steps = 4 * (2 * mm + 3 * k * k + 30)
            shifts = 3 * 2 * mm + 2 * mm + 3 * k * k
            extra += scaling + steps + shifts + mm + 3 * w
        elif kind == "genpow":
            hinv_x += 32 * w
            extra += (11 * w + 30) + 2 * 2 * 4 * w + (7 * w + 10 + 3 * m)
    return hinv_x, extra


def k2_ops(N):
    """FP32 operations one instance needs (not what the kernel does, which
    updates whole rows): the LDL' factorization, per column j with
    r = N-1-j rows below r divisions, r products pivot*col and the
    symmetric trailing update of the lower triangle (r(r+1) operations),
    and the inverse of the unit lower-triangular factor, 2(i-j) operations
    for each entry (i, j) below the diagonal: (N^3 - N)/3 in all.  About
    2N^3/3."""
    factor = sum(2 * r + r * (r + 1) for r in (N - 1 - j for j in range(N)))
    return factor + (N ** 3 - N) // 3


def k2_bound_ms(N, B):
    """The larger of bytes over HBM bandwidth and FP32 operations over the
    FP32 rate.  The bytes: K's lower triangle read once (the function
    reads nothing above the diagonal), counted in the 32-byte sectors that
    its rows touch in the contiguous (B, N, N) batch from an aligned base;
    L^-1 (whole), d and ok written once; the signs."""
    # the sectors repeat every 8 instances (8 * 4N^2 bytes is 32 N^2)
    start = (np.arange(min(B, 8))[:, None] * N * N
             + np.arange(N)[None, :] * N) * 4
    end = start + (np.arange(N)[None, :] + 1) * 4
    per_lane = ((end - 1) // 32 - start // 32 + 1).sum(axis=1)
    k_sectors = int(per_lane.sum()) * (B // 8) + int(per_lane[:B % 8].sum())
    nbytes = 32 * k_sectors + B * (N * N * 4 + N * 4 + 1) + N * 4
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops_ms = B * k2_ops(N) / FP32_RATE * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes, B * k2_ops(N)
