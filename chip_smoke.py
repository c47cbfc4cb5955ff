#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (clarabel_tpu_torch) on one NVIDIA card.

Builds the CUDA kernels from the sources beside this script, in parallel:
the batched IPM megakernel as K1a (zero/nn/SOC layouts: one lane per
group of threads, clarabel_tpu_torch/csrc/megakernel_group.cu, up to 54
lanes an SM, and one lane per thread, csrc/megakernel.cu, above), as K1b
(exponential and power cones: the group kernel up to
_cuda.NONSYM_GROUP_LANES_PER_SM lanes an SM, csrc/megakernel.cu above), as
K1d (PSD cones of side at most 3), as K1c (generalized power cones) and as
K1e (its float32 first phase, on the bench and psd3 shapes; these three
from csrc/megakernel.cu), two wrong group kernels (K1a's butterfly sums
without their last step; K1b's searches taking the last passing trial of
a round), and the float32 LDL-inverse kernel K2 (the rows design, one
library per N with the rows of an instance in registers:
csrc/ldl_inverse_rows.cu built for N = 19 and 8, one warp an instance, and
csrc/ldl_inverse_rows_wide.cu built for N = 79 and 80, ceil(N/32) warps an
instance; and csrc/ldl_inverse.cu, the simple kernel both are held to bit
for bit, which no path launches).  Phase [1] prints each library's build
seconds, its ptxas line and the local loads and stores in its SASS; every
phase prints its seconds.
Holds each against its plain PyTorch version on the card, drives the
port's paths through `BatchSolver.solve` and prints what it measured:

* [1] the card, the toolchain and the builds;
* [2]-[4] K1a, each of its two sources, against its plain version on four
  batches (with the wrong kernels, and the wrong group kernel against
  the group source), and the main path
  (the megakernel on the bench shape: n=6, cones [NN(6), SOC(7)], 1e-8
  tolerances) at B = 4096, 65536 and 131072;
* [5] K2 against its plain version at N = 19, 79 and 80 (the rows
  design's two sources; 19 and 79 are the libraries [6] launches),
  B = 65536, a wrong K2 (dynamic regularization off) that its bars must
  reject, at each N the shared-memory kernel
  (csrc/ldl_inverse.cu) pinned beside it, whose d, L^-1 and ok it must
  give to the bit on every lane, and the first B/2 instances alone, whose
  bits must be those of the full batch;
* [6] the loop solver on the card: `Settings.throughput()` (float32, K2
  once per IPM iteration) at B = 4096 and 65536 on the bench shape and at
  B = 16384 on the bench family at n = 26 (N = 79, the wide rows build),
  and the ldl backend with mixed precision at 4096, each with the kernel
  and with the plain K2;
* [7] the rescue cascade behind the megakernel on the LP batch;
* [8] K1b: each source the exp path launches against its plain version on
  the exponential-cone batch of `bench.py` (n=3, cones [NN(2), Exp()]), a
  power-cone batch and the exponential batch with the PrimalDual->Dual
  switch forced, wrong kernels its bars must reject (and the wrong group
  kernel on the group source), `BatchSolver.solve` on the exponential
  batch at B = 4096, 65536 and 131072, the condensed loop on the card, and
  the rescue cascade behind the megakernel;
* [9] K1d: the megakernel against its plain version on the small-SDP
  batches (side 3, the PSD batch of `bench.py`; side 2; side 2 with a zero
  cone), beside the plain version against itself under 1e-15 changes of q
  (three on side 3), wrong kernels its bars must reject,
  `BatchSolver.solve` on the side-3 batch at B = 4096, 65536 and 131072,
  the condensed loop on the card and the rescue behind the megakernel;
* [10] K1c: the same on the generalized-power-cone batch, every lane on the
  Dual strategy;
* [11] K1e: the megakernel with its float32 first phase
  (`Settings.megakernel_two_phase`) against its plain version on the
  bench, infeasible, lp and psd3 batches, beside the plain version against
  itself under a 1e-7 change of q and, on bench, lp and psd3, three 1e-15
  changes, wrong kernels its bars must reject, `BatchSolver.solve` with
  the first phase on bench and psd3 at B = 4096, 65536 and 131072, the
  single and the two phases side by side at 1e-8 and 1e-5 tolerances, the
  rescue behind it, and the zero-cone and exponential layouts, where
  two-phase changes nothing;
* [12] the main path's host side on bench, psd3 and exp at B = 4096 and
  131072: `BatchSolver.solve` with one dispatch and with chunks (the
  rule's size, or 1024 lanes where the rule makes one dispatch), the
  wall and the steps of each (the batch-constant scan, pinned staging, the copy, the device gather, the kernels, the copy
  back), the launches per source; every lane's bits against one dispatch
  of the same library over its chunk; at 4096 every chunk held to the
  family's bars against the plain version over the batch, at 131072 to
  the true-KKT bar and those the plain version against itself meets over
  the batch under three 1e-15 changes of q, each chunk's readings
  printed;
* [13] the single-instance `Solver` on the card: the verify drive, the
  verify drive with mixed precision (K2 launches counted), and a primal-
  and a dual-infeasible problem, against the reference's outputs in
  tests/torch_fixtures/solver.npz;
* [14] the `Solver`'s sparse and structured KKT on the card at full size:
  the 60x60 grid QP (multifrontal, float32 fronts), the AUG2DC-scale
  banded QP (multifrontal, float64 fronts; then update_q and update_b and
  a warm re-solve that analyzes nothing again) and the robust
  least-squares SOCP with a 2001-row SOC (block-arrow with the rank-2 SMW
  correction), against the reference's outputs in
  tests/torch_fixtures/sparse.npz, with the setup split (analysis, maps,
  the rest), cold and warm solve, time per IPM iteration and
  factorizations;
* [15] long solves on the card: on [14]'s grid60 solver the chunked solve
  (chunks of 25 and of 5 iterations, each chunk capturing the loop's CUDA
  graph again) and `time_limit=600`, a tiny time limit (one chunk),
  a checkpoint after 3 iterations and its resume, `timing=True` with the
  `print_timers` tree (the probes timed by CUDA events), each with the
  one-shot solve's bits, and `profile_trace` around one warm solve (its
  CUDA kernel events counted, the device's busy share printed); then the
  verify drive under mixed precision with a time limit (K2's launches
  counted), against tests/torch_fixtures/long.npz;
* [16] the BASELINE runner (`baseline_torch.py`) at run_all.py's full
  scale: the four committed `benchmarks/data/*_style.qps` files, the
  Markowitz, CVXQP-style, AUG2DC-style, robust least-squares and max-cut
  rows against the reference's outputs in tests/torch_fixtures/long.npz,
  the batched SOCP row (B = 4096, K1a's group kernel, its launches
  counted) against K1a's plain version; `python -m clarabel_tpu_torch
  benchmarks/data/CVXQP1_style.qps` once as a subprocess; and
  `precompile.warmup()` twice (its libraries built in [1]);
* [17] multi-device on the one card: (a) a world of one rank over NCCL in
  this process, where the sharded `Solver` on [14]'s rls2000 (its IPM pass
  replayed as a CUDA graph with the NCCL all-reduces in it) and the
  dp-sharded `BatchSolver` on the bench batch at B = 4096 under
  `Settings.throughput()` (K2 on the loop, its launches counted) give the
  unsharded solves' bits, and `dryrun_multichip()`; (b) two ranks on
  cuda:0 over gloo (`parallel/dryrun.launch`): the `Solver` with tp = 2 on
  rls2000, eager, held to [14]'s solve and to the reference's outputs,
  the `BatchSolver` with dp = 2, held to the unsharded solves of each
  rank's share, and the dryrun, with the ms per IPM iteration and the
  time in the all-reduces; then the check that nothing imported JAX.

Every phase fails the run (non-zero exit) when its bar is not met.

    python3 chip_smoke.py

It needs one CUDA card and exits non-zero without one, or when the port's
package is not beside it.  The line before the card's line is a JSON object
with the kernels' numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the full power limit): HBM
# bandwidth in bytes/s, and FP64 and FP32 outside the tensor cores in
# operations/s (the kernels issue plain FP64 and FP32 FMAs)
HBM_RATE, FP64_RATE, FP32_RATE = 3.35e12, 34e12, 67e12

BENCH_N = 6
THROUGHPUT_BATCHES = (4096, 65536, 131072)

# Parity bars, kernel against its plain version on the card, per batch: x
# on the lanes both solve, and iterations within 1 on a share of those
# lanes and within a maximum on all.  Fixed from the readings of the kernel
# and of the plain version under a 1e-15 change of q (PERF.md;
# clarabel_tpu_torch/DEVIATIONS.md #4).  Objectives within OBJ_TOL and the
# true-KKT residuals of the kernel's SOLVED lanes below KKT_TOL (|s'z|
# below SZ_TOL) hold on every batch.
BARS = {
    "bench": dict(x=1e-4, within1=0.99, it_max=4),
    "qp_eq": dict(x=1e-6, within1=0.99, it_max=4),
    "infeasible": dict(x=1e-4, within1=0.99, it_max=4),
    "lp": dict(x=3e-4, within1=0.96, it_max=15),
}
OBJ_TOL, KKT_TOL, SZ_TOL = 1e-6, 1e-7, 1e-6

# Wrong kernels: the kernel run with one setting changed, as a fault in
# one constant or one stage would change it.  The bars must reject each of
# them on every batch.
WRONG_KERNELS = {
    "step fraction 0.95": {"max_step_fraction": 0.95},
    "no refinement": {"iterative_refinement_enable": False},
    "gap tolerances 1e-7": {"tol_gap_abs": 1e-7, "tol_gap_rel": 1e-7},
}


# K2 against its plain version (float32, nvcc contracts to FMA where
# PyTorch does not): ok equal on every lane; d within D_TOL * max(1, |d|);
# L⁻¹ within LINV_TOL of the lane's largest |L⁻¹| entry (at least 1).  The
# batch trips the dynamic regularization on a quarter of the lanes, so a
# K2 without it fails the d bar.
# N = 19 (the bench shape's KKT), 79 (the n = 26 bench KKT, which [6]'s
# wide run launches) and 80 (the widest the route takes)
K2_SHAPES = ((6, 13), (26, 53), (30, 50))
K2_B = 65536
D_TOL, LINV_TOL = 1e-4, 1e-4

# The loop paths with the kernel against the same paths with the plain K2
# on the card: the kernel's SOLVED count at least the plain version's less
# 0.1 % of B (as for K1a); on the lanes both solve, objectives within
# obj_rel * max(1, |obj|), and iterations within 1 on a share within1 of
# them and within it_max on all.  Beside them, the plain K2 against itself
# with q moved by `jitter` (relative): what rounding alone moves.
LOOP_BARS = {
    "throughput": dict(obj_rel=1e-4, within1=0.95, it_max=8, jitter=1e-7),
    "mixed": dict(obj_rel=1e-6, within1=0.99, it_max=4, jitter=1e-15),
}
# (settings, B, n): the bench family at n = 26 has N = n + m = 79, the
# widest KKT the K2 route takes on it
LOOP_BATCHES = (("throughput", 4096, BENCH_N),
                ("throughput", 65536, BENCH_N), ("mixed", 4096, BENCH_N),
                ("throughput", 16384, 26))
RESCUE_B = (4096, 131072)
DEVICE = "cuda"   # the phases' device (a rehearsal on the CPU sets "cpu")

# [8] K1b.  The exponential batch is bench.py's exp_cone_batched; the
# switch batch is the same with min_switch_step_length raised so that the
# lanes take the PrimalDual->Dual switch.  Bars as BARS (kernel against
# plain on the card; x, iterations within 1 on a share of the lanes both
# solve and within a maximum on all), set from the kernel's readings and
# the plain version's under a 1e-15 change of q (PERF.md; DEVIATIONS.md
# #4 and #11).  Wrong kernels as WRONG_KERNELS; the first changes only
# code that nonsymmetric cones run (both backtracking line searches).
NONSYM_N, NONSYM_B, SWITCH = 3, 4096, 0.9
NONSYM_BARS = {
    "exp": dict(x=1.5e-4, within1=0.98, it_max=10),
    "pow": dict(x=1e-4, within1=0.998, it_max=4),
    "switch": dict(x=1e-4, within1=0.98, it_max=8),
}
WRONG_NONSYM = {
    "backtrack step 0.5": {"linesearch_backtrack_step": 0.5},
    "step fraction 0.95": {"max_step_fraction": 0.95},
    "gap tolerances 1e-7": {"tol_gap_abs": 1e-7, "tol_gap_rel": 1e-7},
}
NONSYM_THROUGHPUT = (4096, 65536, 131072)

# [9] K1d on the small-SDP batches of tests/test_megakernel_psd.py (psd3 is
# bench.py's psd_cone_batched: n=3, cones [NN(6), PSD(3)]; psd2 the same at
# side 2; psd_zero with a zero cone) and [10] K1c on the genpow batch of
# tests/test_megakernel_nonsym.py (n=4, [NN(2), GenPow((0.3, 0.7), 2)]).
# Bars as BARS, set from the kernel's readings and the plain version's
# under a 1e-15 change of q (PERF.md); the PSD slacks of SOLVED lanes must
# keep their least eigenvalue above -EIG_TOL.  On psd3 the true-KKT bar is
# 5e-7 in place of KKT_TOL: at 4096 lanes the plain version's own SOLVED
# lanes read up to 1.6e-7 there (its termination is relative to b, whose
# PSD block is up to ~10).  Wrong kernels as
# WRONG_KERNELS: "no Jacobi sweep" leaves the SVD and the eigenvalues
# unrotated; one sweep is wrong at side 3 only (one rotation diagonalizes
# a 2 x 2); the backtrack step changes only code that genpow runs there.
FAMILY_B = 4096
FAMILY_THROUGHPUT = (4096, 65536, 131072)
EIG_TOL = 1e-8
PSD_BARS = {
    "psd3": dict(x=5e-5, within1=0.99, it_max=4, kkt=5e-7),
    "psd2": dict(x=1e-6, within1=0.99, it_max=4),
    "psd_zero": dict(x=1e-6, within1=0.99, it_max=4),
}
GENPOW_BARS = {"genpow": dict(x=1e-6, within1=0.99, it_max=4)}
WRONG_PSD = {
    "no Jacobi sweep": {"psd_sweeps": 0},
    "step fraction 0.95": {"max_step_fraction": 0.95},
    "gap tolerances 1e-7": {"tol_gap_abs": 1e-7, "tol_gap_rel": 1e-7},
}
WRONG_PSD3 = {"one Jacobi sweep": {"psd_sweeps": 1}}
WRONG_GENPOW = {
    "backtrack step 0.5": {"linesearch_backtrack_step": 0.5},
    "step fraction 0.95": {"max_step_fraction": 0.95},
    "gap tolerances 1e-7": {"tol_gap_abs": 1e-7, "tol_gap_rel": 1e-7},
}

# [11] K1e, the float32 first phase (`Settings.megakernel_two_phase`), on
# the bench, infeasible, lp and psd3 batches at B = 4096.  The first phase
# rounds to float32 and nvcc contracts its a*b+c to FMA where PyTorch does
# not, so what rounding alone moves is read with q moved by 1e-7
# (relative), not 1e-15.  Bars as BARS, plus the phase-1 iterations per
# lane: equal on a share p1_equal of the lanes and within p1_max on all.
# Set between the kernel's and the plain version's readings under that
# jitter and the wrong kernels' (PERF.md).  Wrong kernels: no first phase
# (switch_mu 1e30: every lane hands off at once), a first phase to its cap
# or its stall (switch_mu 1e-9), no refinement in either phase.
TWO_PHASE_B = 4096
TWO_PHASE_THROUGHPUT = (4096, 65536, 131072)
TWO_PHASE_BARS = {
    "bench": dict(x=1e-4, within1=0.99, it_max=4, p1_equal=0.99, p1_max=1),
    "infeasible": dict(x=1e-4, within1=0.99, it_max=5, p1_equal=0.99,
                       p1_max=1),
    "lp": dict(x=3e-4, within1=0.95, it_max=15, p1_equal=0.99, p1_max=2),
    "psd3": dict(x=5e-5, within1=0.99, it_max=4, p1_equal=0.99, p1_max=1,
                 kkt=5e-7),
}
WRONG_TWO_PHASE = {
    "no first phase": {"megakernel_switch_mu": 1e30},
    "first phase to its cap": {"megakernel_switch_mu": 1e-9},
    "no refinement": {"iterative_refinement_enable": False},
}
RELAXED = {"tol_gap_abs": 1e-5, "tol_gap_rel": 1e-5, "tol_feas": 1e-5}

# [12] the main path's host side: each family's batch in one dispatch and
# in chunks (`ipm/megakernel.build_mega_solve`), at these sizes, each with
# the chunk size of the rule (`megakernel.chunk_lanes`) or, where the rule
# makes one dispatch, with CHUNK_FORCED lanes a chunk.  Every lane must
# have the bits of one dispatch of the same library over its chunk.  At
# FAMILY_B lanes, the size the bars were set on, every chunk is held to
# its family's bars against the plain version over the batch.  At 131072
# lanes every chunk is held to the bars that the plain version against
# itself meets over the batch under each of the 1e-15 changes of q of
# JITTER_SEEDS, and to the true-KKT bar; a bar that compares with the
# plain version and that it fails there measures rounding at that size
# (bench's iterations; psd3's iterations and x, where one lane's x moves
# by 6.05e-5 under two of the three changes; exp's x, PERF.md section 6),
# and the chunk's reading of it is printed, not held.
CHUNK_BATCHES = (4096, 131072)
CHUNK_FORCED = 1024
JITTER_SEEDS = (7, 8, 9)

# [13] the single-instance Solver: the cases of
# tests/torch_fixtures/solver.npz, with the reference Solver's outputs
SOLVER_FIXTURE = os.path.join("tests", "torch_fixtures", "solver.npz")
SOLVER_N = 8            # n + m of the verify drive: K2's N under mixed


# [14] the sparse and structured Solver: the large cases of
# tests/torch_fixtures/sparse.npz, remade from the port's generators
# (bench_data), held to the reference Solver's outputs: backend and plan
# type equal, status equal, iterations within SPARSE_IT_TOL, objective
# within SPARSE_TOL * max(1, |obj|) and x within SPARSE_TOL * max(1,
# |x|inf), and the true-KKT residuals (2-norms) of the port's own output
# below KKT_TOL (tests/test_megakernel.py:66-95).  |s'z| is printed beside
# the reference's own, not held: the reference's solution of banded2500
# reads 6.09e-6 (the fixture), above the North star's SZ_TOL
# (DEVIATIONS.md #18).
SPARSE_FIXTURE = os.path.join("tests", "torch_fixtures", "sparse.npz")
SPARSE_CASES = ("grid60", "banded2500", "rls2000")
SPARSE_TOL, SPARSE_IT_TOL = 1e-6, 4

# [15] long solves on grid60 (the [14] solver, so its plan analysis is not
# paid twice) and on the verify drive under mixed precision: chunks of
# LONG_CHUNKS iterations, a checkpoint after LONG_CAP iterations
LONG_CHUNKS = (25, 5)
LONG_CAP = 3
LONG_FIXTURE = os.path.join("tests", "torch_fixtures", "long.npz")

# [16] the BASELINE runner (baseline_torch.py) at run_all.py's full scale,
# each single row held to the reference Solver's outputs in
# tests/torch_fixtures/long.npz (`row_*`): status equal, iterations within
# SPARSE_IT_TOL, x within SPARSE_TOL of the reference relative to max(1,
# |x|inf), the objective within SPARSE_TOL * max(1, |obj|) and the
# true-KKT residuals (2-norms) of the port's own output below KKT_TOL.  As
# [12] does at scale, a bar that the reference fails against itself under
# the three 1e-15 changes of q of JITTER_SEEDS (made on the CPU into the
# fixture, `spread_row_*`: x against its unchanged solution, and its own
# worst true KKT) measures rounding on that row: the port's reading of it
# is printed beside the reference's, not held.  Only the robust
# least-squares SOCP has such bars, x and true KKT (DEVIATIONS.md #19).
# The batched row (B = 4096, K1a's group kernel) is held to K1a's plain
# version on the card under BARS["bench"] and its SOLVED count to the
# reference BatchSolver's less 0.1 % of B.
BASELINE_B = 4096

# [17] multi-device on the one card: (a) a world of one rank over NCCL in
# this process, whose sums are the identity, so the sharded Solver on
# rls2000 (its IPM pass graphed) and the dp-sharded BatchSolver at
# MULTI_B lanes under Settings.throughput() (K2 on the loop) must give the
# unsharded solves' bits; (b) MULTI_RANKS ranks on cuda:0 over gloo,
# started by parallel/dryrun.launch (joined within MULTI_JOIN_S): the
# Solver with tp = 2 on rls2000, eager (gloo's collectives cannot be
# captured), held to [14]'s unsharded solve (status and iterations equal,
# |dx| < 1e-8 max(1, |x|), tests/test_blockarrow_sharded_ipm.py:40-43; and
# r_prim, r_dual < 1e-8) and to the reference's rls2000 at [14]'s bars, and
# the BatchSolver with dp = 2 at MULTI_B lanes.  On the card a lane's
# bits depend on the batch size it is solved at (not on the other lanes'
# data: a permuted batch, or one half solved twice over, gives the same
# bits), so each rank's lanes are held to the bits of the unsharded
# BatchSolver solving them as one batch of MULTI_B / 2 lanes; the reading
# against the unsharded solve of all MULTI_B lanes (the reference's bar
# there, statuses equal and x and objectives within 1e-9,
# tests/test_batch_sharded.py:29-31) is printed beside the same reading
# of the unsharded solver's own halves.  The dryrun runs in both worlds.
MULTI_B = 4096
MULTI_RANKS = 2
MULTI_JOIN_S = 300


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


def search_costs(trips):
    """What the searches of one plain-version solve cost a warp, from the
    per-lane trip counts it kept (megakernel_ref.mega_solve_plain's
    `trips`): for the joint feasibility backtracks and the barrier
    backtracks, (evaluations, the sum over warps and searches of the
    warp's largest trip count, which a warp pays when each lane runs its
    own loop, the same sum of the rounds of the kernel's cooperative
    search).  The schedule is fixed by the counts, and the plain version's
    arithmetic is the kernel's, so the kernel's counts are these up to
    rounding."""
    from clarabel_tpu_torch.ipm import megakernel_ref

    out = {}
    for kind in ("feas", "barrier"):
        ev = serial = rounds = 0
        for t in trips[kind]:
            sv, rv = megakernel_ref.warp_costs(t)
            ev += int(t.sum())
            serial += sv
            rounds += rv
        out[kind] = (ev, serial, rounds)
    return out


def describe_searches(costs):
    return "; ".join(
        f"{what}: {ev} evaluations, per-warp serial trips {serial}, "
        f"cooperative rounds {rounds}"
        + (f" ({rounds / serial:.3f} of serial)" if serial else "")
        for what, (ev, serial, rounds) in (
            ("feasibility backtracks", costs["feas"]),
            ("barrier backtracks", costs["barrier"])))


def true_kkt(P, q, A, b, x, z, s):
    rp = np.linalg.norm(np.einsum("bij,bj->bi", A, x) + s - b, axis=1)
    rd = np.linalg.norm(np.einsum("bij,bj->bi", P, x) + q
                        + np.einsum("bji,bj->bi", A, z), axis=1)
    return rp, rd, np.abs(np.einsum("bi,bi->b", s, z))


# GPU cycles (about 0.1 s on an H100) that the stream sleeps before a timed
# run, so that the timed calls are queued behind the sleep and a stall of
# the host between them is not timed
QUEUE_CYCLES = 200_000_000


def events_times(fn, reps):
    """Per-call ms of fn on the card (CUDA events between the calls), after
    one warm-up call; the calls are queued behind a sleep on the stream,
    so the events time the card's work rather than the host's pace (a
    call that waits for the card, as the plain versions do, still times
    its host).  Returns (the reps' ms, the last call's result)."""
    import torch

    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(QUEUE_CYCLES)
    marks[0].record()
    for i in range(reps):
        out = fn()
        marks[i + 1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])], out


def events_ms(fn, reps):
    """Mean ms per call of fn on the card (`events_times`); returns (ms,
    the last call's result)."""
    times, out = events_times(fn, reps)
    return sum(times) / reps, out


def chunked_kernel_ms(data, spec, reps=3):
    """The kernel-only time of one solve as the main path runs it: the
    batch staged in the chunks of the rule (`megakernel.staged_chunks`, as
    `BatchSolver.solve` cuts it), then every chunk's launch timed with
    CUDA events (mean of `reps` after a warm-up).  Returns (ms, the
    number of chunks)."""
    import torch
    from clarabel_tpu_torch.ipm import megakernel

    chunks = list(megakernel.staged_chunks(*data, spec,
                                           torch.device(DEVICE)))
    ms, _ = events_ms(lambda: [megakernel.solve_flats(*cf, spec, hi - lo)
                               for lo, hi, cf, _ in chunks], reps)
    return ms, len(chunks)


def main_path_steps(phase, name, data, spec, card):
    """Where one solve's wall time goes on the main path, chunked by the
    rule: the batch-constant scan, the staging in pinned memory, the copy,
    the device gather, the kernels, the copy back with unpacking, each
    step synchronised (`tools/host_probe.py` `steps`; host clock, the
    kernels by CUDA events)."""
    import torch

    steps, C = load_tool("host_probe").steps(
        data, spec, None, "device", "chunk", torch.device(DEVICE))
    print(f"[{phase}] {name} B={len(data[1])} one solve in chunks of {C}, "
          f"ms: " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items())
          + f"; card {card}", flush=True)


def synced_wall(fn):
    """Host seconds of fn() ending in a synchronise; returns (s, result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def pinned_kernel(group):
    """The megakernel wrapper held to one of K1a's sources whatever B is:
    the group kernel (megakernel_group.cu) for group=1, one lane per
    thread (megakernel.cu) for 0.  It loads the libraries the port's own
    wrapper builds, and its launches are not the port's."""
    from clarabel_tpu_torch.ipm import _cuda

    class Pinned(_cuda.Megakernel):
        def variant(self, spec, B, device):
            return _cuda.shape_of(spec) + (group,)

    return Pinned()


def wrong_group_kernel(macro="MK_WRONG_BUTTERFLY"):
    """The group kernel (csrc/megakernel_group.cu) built with `macro`=1:
    MK_WRONG_BUTTERFLY (K1a), every butterfly sum drops its last step and
    takes thread 0's partial sum, a sum over half of the group's rows, which
    the bars of [2] and [3] must reject; MK_WRONG_SEARCH (K1b), the shared
    searches take the last passing trial of a round, not the first, which
    the bars of [8] must reject."""
    import os as _os
    from clarabel_tpu_torch.ipm import _cuda

    class WrongGroup(_cuda.Megakernel):
        def __init__(self):
            super().__init__()
            self.source = _os.path.join(_os.path.dirname(self.source),
                                        "megakernel_group.cu")
            self.stem = "megakernel_group_wrong"
            self.macros += (macro,)
            self.tags += ("wb" if macro == "MK_WRONG_BUTTERFLY" else "ws",)

        def source_for(self, variant):
            return self.source

        def variant(self, spec, B, device):
            return _cuda.shape_of(spec) + (1, 1)

    return WrongGroup()


def pinned_k2(rows):
    """The K2 wrapper held to one kernel whatever N is: the rows kernel
    (csrc/ldl_inverse_rows.cu) for rows=True, the shared-memory kernel
    (csrc/ldl_inverse.cu, the design the rows kernel replaced at N <= 32)
    for False.  It loads the libraries the port's own wrapper builds, and
    its launches are not the port's."""
    from clarabel_tpu_torch.linalg import batched_ldl

    class Pinned(batched_ldl.LdlInverseKernel):
        def variant(self, n):
            return (n,) if rows else ()

    return Pinned()


def sass_counts(path):
    """Counts in the SASS of a built library (`cuobjdump -sass`): its
    instructions, local loads (LDL) and stores (STL), and generic loads
    and stores (LD.E, ST.E)."""
    import re
    from clarabel_tpu_torch import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     text)
    return dict(instructions=len(ops),
                LDL=sum(o.startswith("LDL") for o in ops),
                STL=sum(o.startswith("STL") for o in ops),
                LD=sum(o.startswith("LD.E") or o == "LD" for o in ops),
                ST=sum(o.startswith("ST.E") or o == "ST" for o in ops))


class PhaseClock:
    """Prints each phase's seconds as the next one starts."""

    def __init__(self):
        self.name, self.t0 = None, time.perf_counter()

    def start(self, name):
        """Close the running phase and start `name` (None: the last)."""
        now = time.perf_counter()
        if self.name is not None:
            print(f"{self.name} took {now - self.t0:.1f} s", flush=True)
        self.name, self.t0 = name, now


# ---- K2: the float32 LDL-inverse kernel ----

def k2_inputs(n, m, B, seed):
    """B KKT matrices of size n+m (bench_data.make_kkts) on which the
    dynamic regularization trips: every 8th lane has its first pivot
    decoupled and below eps, every 8th lane from the 4th has its last
    (z-block) pivot turned positive."""
    from clarabel_tpu_torch import bench_data

    K, signs = bench_data.make_kkts(B, n, m, seed)
    K[0::8, 0, 1:] = 0.0
    K[0::8, 1:, 0] = 0.0
    K[0::8, 0, 0] = 1e-9
    K[4::8, -1, -1] = 1e3
    return K, signs


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


def k2_readings(got, plain):
    """What the kernel's (L^-1, d, ok) read against the plain version's."""
    Linv, d, ok = got
    pL, pd, pok = plain
    both = ok & pok
    scale = pL.abs().amax(dim=(1, 2)).clamp_min(1.0)
    linv = ((Linv - pL).abs().amax(dim=(1, 2)) / scale)[both]
    drel = ((d - pd).abs() / pd.abs().clamp_min(1.0)).amax(dim=1)[both]
    absd = max(float((Linv - pL).abs().amax(dim=(1, 2))[both].max()),
               float((d - pd).abs().amax(dim=1)[both].max()))
    return dict(ok_equal=bool((ok == pok).all()), ok=int(ok.sum()),
                linv=float(linv.max()), d=float(drel.max()), abs=absd)


def k2_violations(r):
    out = []
    if not r["ok_equal"]:
        out.append("ok")
    if not r["d"] <= D_TOL:
        out.append("d")
    if not r["linv"] <= LINV_TOL:
        out.append("L^-1")
    return out


def same_bits(a, b):
    """Whether two K2 results (L^-1, d, ok) are equal bit for bit, NaNs
    included; and the count of lanes where they are not."""
    import torch

    i32 = torch.int32
    lanes = ((a[0].view(i32) != b[0].view(i32)).flatten(1).any(1)
             | (a[1].view(i32) != b[1].view(i32)).any(1) | (a[2] != b[2]))
    n = int(lanes.sum())
    return n == 0, n


def k2_phase(card, failures):
    """[5] K2 against its plain version at each N of K2_SHAPES (the rows
    design: csrc/ldl_inverse_rows.cu at N = 19, csrc/ldl_inverse_rows_wide.cu
    at N = 79 and 80), and the wrong K2 that the bars must reject; at each
    N the shared-memory kernel (csrc/ldl_inverse.cu) pinned beside it,
    whose bits it must give on every lane, and the first B/2 instances
    alone, whose bits must be the full batch's.  Returns the numbers of
    each N."""
    import torch
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch.linalg import batched_ldl

    st = ctt.Settings.throughput()   # the main path's regularization
    eps, delta = st.dynamic_regularization_eps, \
        st.dynamic_regularization_delta
    shared = pinned_k2(False)
    out = {}
    for n, m in K2_SHAPES:
        N = n + m
        K, signs = k2_inputs(n, m, K2_B, seed=N)
        K = torch.tensor(K, dtype=torch.float32, device=DEVICE)
        signs = torch.tensor(signs, dtype=torch.float32, device=DEVICE)
        variant = batched_ldl.kernel.variant(N)
        src = os.path.basename(batched_ldl.kernel.source_for(variant))
        k_times, got = events_times(
            lambda: batched_ldl.kernel(K, signs, eps, delta, True), 20)
        k_ms = sum(k_times) / len(k_times)
        p_ms, plain = events_ms(
            lambda: batched_ldl.ldl_inverse_plain(K, signs, eps, delta, True),
            1)
        r = k2_readings(got, plain)
        wrong = k2_readings(batched_ldl.kernel(K, signs, eps, delta, False),
                            plain)
        bound, by, nbytes, ops = k2_bound_ms(N, K2_B)
        tag = f"[5] K2 N={N} B={K2_B}"
        print(f"{tag}: kernel ({src}) {k_ms:.4f} ms (mean of 20 launches, "
              f"each {min(k_times):.4f} to {max(k_times):.4f}), plain "
              f"{p_ms:.2f} ms, bound {bound:.4f} ms by {by} ({nbytes} bytes, "
              f"{ops:.3e} FP32 ops); card {card}", flush=True)
        log = batched_ldl.kernel.build_logs.get(variant, "")
        for line in log.splitlines():
            if "registers" in line or "stack" in line:
                print(f"{tag}: ptxas {src}: {line.strip()}", flush=True)
        c = sass_counts(batched_ldl.kernel.lib_path(variant))
        print(f"{tag}: sass {src}: {c['instructions']} instructions, "
              f"{c['LDL']} local loads (LDL), {c['STL']} local stores (STL),"
              f" {c['LD']} and {c['ST']} generic (LD.E, ST.E)", flush=True)
        # the simple kernel the rows design is held to, bit for bit
        s_ms, sh = events_ms(lambda: shared(K, signs, eps, delta, True), 20)
        equal, n_uneq = same_bits(got, sh)
        print(f"{tag}: the shared-memory kernel (ldl_inverse.cu, pinned) "
              f"{s_ms:.4f} ms, {s_ms / k_ms:.2f}x the rows design's; d, "
              f"L^-1 and ok equal to the rows design's on every lane: "
              f"{equal} ({n_uneq} of {K2_B} lanes differ)", flush=True)
        if not equal:
            failures.append(f"{tag}: {n_uneq} lanes differ from "
                            "ldl_inverse.cu")
        del sh
        # does a lane's bits depend on the batch it is launched in?
        half = batched_ldl.kernel(K[:K2_B // 2], signs, eps, delta, True)
        equal, n_uneq = same_bits(half, tuple(t[:K2_B // 2] for t in got))
        print(f"{tag}: the first B/2 = {K2_B // 2} instances alone: d, "
              f"L^-1 and ok equal to the full batch's: {equal} ({n_uneq} "
              f"lanes differ)", flush=True)
        if not equal:
            failures.append(f"{tag}: the first B/2 instances alone differ "
                            "from the full batch")
        del half
        for what, rd in (("kernel", r), ("wrong K2 (no dynamic "
                                          "regularization)", wrong)):
            bad = k2_violations(rd)
            print(f"{tag}: {what} vs plain: ok on {rd['ok']} lanes (equal "
                  f"to plain: {rd['ok_equal']}), max rel |dL^-1| "
                  f"{rd['linv']:.3e}, max rel |dd| {rd['d']:.3e}, max abs "
                  f"{rd['abs']:.3e}; fails: {', '.join(bad) or 'none'}",
                  flush=True)
        print(f"{tag}: bars: ok equal, d {D_TOL:.0e}, L^-1 {LINV_TOL:.0e}")
        if k2_violations(r):
            failures.append(f"{tag}: the kernel fails its bars")
        if not k2_violations(wrong):
            failures.append(f"{tag}: the bars pass the wrong K2")
        out[N] = dict(n=N, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                      bound_by=by, max_abs_err=r["abs"], source=src)
        del K, got, plain
        torch.cuda.empty_cache()
    return out


# ---- the loop solver and the rescue cascade on the card ----

def plain_k2_route():
    """Context in which the loop's K2 route runs the plain version on the
    card (for the comparison only; the port never does this)."""
    import contextlib
    from clarabel_tpu_torch.kkt import dense
    from clarabel_tpu_torch.linalg import batched_ldl

    @contextlib.contextmanager
    def swapped():
        dense.batched_ldl_inverse = batched_ldl.ldl_inverse_plain
        try:
            yield
        finally:
            dense.batched_ldl_inverse = batched_ldl.batched_ldl_inverse

    return swapped()


def loop_readings(k, p, B):
    SOLVED = 1
    ks, ps = k.status == SOLVED, p.status == SOLVED
    both = ks & ps
    dobj = (np.abs(k.obj_val - p.obj_val)
            / np.maximum(1.0, np.abs(p.obj_val)))[both]
    dit = np.abs(k.iterations.astype(int) - p.iterations)[both]
    return dict(solved=int(ks.sum()), plain_solved=int(ps.sum()),
                dobj=float(dobj.max(initial=0.0)),
                within1=float((dit <= 1).mean()) if dit.size else 1.0,
                it_max=int(dit.max(initial=0)))


def loop_phase(card, failures):
    """[6] Settings.throughput() and ldl with mixed precision through
    BatchSolver.solve on the card, each with the kernel and with the plain
    K2, on the bench family at each (settings, B, n) of LOOP_BATCHES.
    Returns K2's launches on these main paths by source file."""
    import torch
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data
    from clarabel_tpu_torch.ipm import _cuda
    from clarabel_tpu_torch.linalg import batched_ldl

    settings = {
        "throughput": ctt.Settings.throughput(),
        "mixed": ctt.Settings(kkt_backend="ldl", mixed_precision=True),
    }
    widths = sorted({n for _, _, n in LOOP_BATCHES})
    cones = {n: [ctt.NonnegativeConeT(n), ctt.SecondOrderConeT(n + 1)]
             for n in widths}
    big = {n: bench_data.make_batch(max(B for _, B, w in LOOP_BATCHES
                                        if w == n), n, 0) for n in widths}
    for name, n in dict.fromkeys((name, n) for name, _, n in LOOP_BATCHES):
        ctt.BatchSolver(cones[n], n, settings[name], device=DEVICE).solve(
            *(a[:256] for a in big[n]))
    launches = collections.Counter()
    for name, B, n in LOOP_BATCHES:
        N = n + 2 * n + 1
        bs = ctt.BatchSolver(cones[n], n, settings[name], device=DEVICE)
        data = tuple(a[:B] for a in big[n])
        kern = batched_ldl.kernel
        kern.reset_counts()
        _cuda.megakernel.launches = 0       # this path's run starts here
        wall, k = synced_wall(lambda: bs.solve(*data))
        run = kern.source_launches.copy()   # ... and ends here
        launches += run
        with plain_k2_route():
            p_wall, p = synced_wall(lambda: bs.solve(*data))
            bars = LOOP_BARS[name]
            qj = data[1] * (1 + bars["jitter"] * np.random.default_rng(
                7).standard_normal(data[1].shape))
            pj = bs.solve(data[0], qj, *data[2:])
        K, signs = k2_inputs(n, 2 * n + 1, B, seed=B)
        K = torch.tensor(K, dtype=torch.float32, device=DEVICE)
        signs = torch.tensor(signs, dtype=torch.float32, device=DEVICE)
        st = settings["throughput"]
        k2_ms, _ = events_ms(lambda: kern(
            K, signs, st.dynamic_regularization_eps,
            st.dynamic_regularization_delta, True), 5)
        src = os.path.basename(kern.source_for(kern.variant(N)))
        others = sum(run.values()) - run[src]
        r = loop_readings(k, p, B)
        rj = loop_readings(pj, p, B)
        tag = f"[6] {name} n={n} B={B}"
        solved = r["solved"]
        print(f"{tag}: {solved / wall:,.0f} solves/s wall ({wall * 1e3:.1f} "
              f"ms), mean iters {k.iterations.mean():.3f}, not SOLVED "
              f"{B - solved}, statuses "
              f"{np.bincount(k.status, minlength=11).tolist()}; K2 "
              f"launches {run[src]} (N = {N}, {src}; other sources "
              f"{others}), K2 {k2_ms:.4f} ms per launch at "
              f"this B; megakernel launches {_cuda.megakernel.launches}; "
              f"card {card}", flush=True)
        for what, rd in (("kernel", r), (f"plain(q*(1+{bars['jitter']:.0e}"
                                         f"*xi))", rj)):
            print(f"{tag}: {what} vs plain K2 on the card: SOLVED "
                  f"{rd['solved']} vs {rd['plain_solved']}, max rel |dobj| "
                  f"{rd['dobj']:.3e}, iters within 1 on {rd['within1']:.4f}, "
                  f"max diff {rd['it_max']}", flush=True)
        print(f"{tag}: plain K2 wall {p_wall * 1e3:.1f} ms; bars: SOLVED at "
              f"least plain less 0.1 % of B, objective {bars['obj_rel']:.0e},"
              f" iters within 1 on {bars['within1']} and {bars['it_max']} on "
              f"all", flush=True)
        bad = []
        if solved < r["plain_solved"] - 0.001 * B:
            bad.append("SOLVED count")
        if r["dobj"] > bars["obj_rel"]:
            bad.append("objective")
        if r["within1"] < bars["within1"] or r["it_max"] > bars["it_max"]:
            bad.append("iterations")
        if run[src] <= 0:
            bad.append(f"K2's {src} for N = {N} was not launched")
        if not np.isfinite(k.x[k.status == 1]).all():
            bad.append("non-finite x")
        for v in bad:
            failures.append(f"{tag}: {v}")
        del K, signs
    return launches


def rescue_phase(card, failures):
    """[7] The LP batch through the megakernel with and without
    rescue="same": the lanes the cascade closes at B = 4096, and the wall
    time with and without it at B = 131072."""
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data

    cones = [ctt.NonnegativeConeT(BENCH_N), ctt.SecondOrderConeT(BENCH_N + 1)]
    _, q, A, b = bench_data.make_lp_batch(max(RESCUE_B), BENCH_N, 3)
    st = ctt.Settings()
    plain = ctt.BatchSolver(cones, BENCH_N, st, p_nonzero=False,
                            device=DEVICE)
    resc = ctt.BatchSolver(cones, BENCH_N, st, p_nonzero=False,
                           rescue="same", device=DEVICE)
    for B in RESCUE_B:
        data = (None, q[:B], A[:B], b[:B])
        plain.solve(*data)
        resc.solve(*data)
        w0, s0 = synced_wall(lambda: plain.solve(*data))
        w1, s1 = synced_wall(lambda: resc.solve(*data))
        before, after = int((s0.status == 1).sum()), int((s1.status == 1).sum())
        kept = s0.status == 1
        P0 = np.zeros((B, BENCH_N, BENCH_N))
        rp, rd, sz = true_kkt(P0, q[:B], A[:B], b[:B], s1.x, s1.z, s1.s)
        ok1 = s1.status == 1
        kkt = max(rp[ok1].max(initial=0.0), rd[ok1].max(initial=0.0))
        print(f"[7] lp B={B}: megakernel alone {w0 * 1e3:.1f} ms wall, "
              f"SOLVED {before}, statuses "
              f"{np.bincount(s0.status, minlength=11).tolist()}; with "
              f"rescue='same' {w1 * 1e3:.1f} ms wall, SOLVED {after} "
              f"({after - before} of {B - before} closed), statuses "
              f"{np.bincount(s1.status, minlength=11).tolist()}; true KKT "
              f"of the SOLVED lanes {kkt:.3e}; card {card}", flush=True)
        if after < before:
            failures.append(f"[7] lp B={B}: the rescue lost SOLVED lanes")
        if not np.array_equal(s1.x[kept], s0.x[kept]):
            failures.append(f"[7] lp B={B}: the rescue changed solved lanes")
        if kkt >= KKT_TOL:
            failures.append(f"[7] lp B={B}: true KKT {kkt:.3e}")


def two_phase_phase(card, failures, big, psd_big, qp_data, exp_data):
    """[11] K1e: the two-phase megakernel against its plain version on
    four batches at TWO_PHASE_B, with the wrong kernels; BatchSolver.solve
    with megakernel_two_phase=True on bench and psd3 at every B of
    TWO_PHASE_THROUGHPUT (the main path of K1e, whose launches it counts);
    the single and the two phases side by side at 1e-8 and 1e-5
    tolerances; the rescue behind the two-phase kernel; and the layouts
    where two-phase is a no-op (qp_eq, exp).  `big` and `psd_big` are the
    bench and psd3 batches at the largest B.  Returns the kernels-line
    numbers of K1e."""
    import torch
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data
    from clarabel_tpu_torch.ipm import _cuda, megakernel, megakernel_ref

    SOLVED = 1
    dev = torch.device("cuda")
    two = ctt.Settings(megakernel_two_phase=True)
    nn_soc = [ctt.NonnegativeConeT(BENCH_N),
              ctt.SecondOrderConeT(BENCH_N + 1)]
    psd3 = [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)]
    B0 = TWO_PHASE_B
    cases = {
        "bench": (nn_soc, BENCH_N, True, tuple(a[:B0] for a in big)),
        "infeasible": (nn_soc, BENCH_N, True,
                       bench_data.make_infeasible_batch(B0, BENCH_N, 2)),
        "lp": (nn_soc, BENCH_N, False,
               bench_data.make_lp_batch(B0, BENCH_N, 3)),
        "psd3": (psd3, 3, True, tuple(a[:B0] for a in psd_big)),
    }

    def p1_readings(k, p):
        d = np.abs(k["p1_iterations"] - p["p1_iterations"])
        return dict(p1_equal=float((d == 0).mean()), p1_max=int(d.max()),
                    p1_mean=float(k["p1_iterations"].mean()))

    def p1_violations(r, bars):
        return (["phase-1 iterations"] if r["p1_equal"] < bars["p1_equal"]
                or r["p1_max"] > bars["p1_max"] else [])

    def p1_describe(r):
        return (f"phase-1 iters equal on {r['p1_equal']:.4f}, max diff "
                f"{r['p1_max']}, mean {r['p1_mean']:.3f}")

    res = {}
    for name, (cones, n, pn, data) in cases.items():
        P, q, A, b = data
        if P is None:
            P = np.zeros((q.shape[0], n, n))
        solver = ctt.BatchSolver(cones, n, two, p_nonzero=pn)
        spec = solver._mega_fn.spec
        bars = TWO_PHASE_BARS[name]
        B, flats = megakernel.prepare(P, q, A, b, spec, dev)
        k_ms, (kv, ki) = events_ms(
            lambda: _cuda.megakernel(*flats, spec, B), 3)
        p_ms, (pv, pi) = events_ms(
            lambda: megakernel_ref.mega_solve_plain(*flats, spec, B), 1)
        k, p = outputs(kv, ki, spec), outputs(pv, pi, spec)
        tag = f"[11] {name} B={B}"
        r = dict(readings(k, p, P, q, A, b), **p1_readings(k, p))
        print(f"{tag}: two-phase kernel {k_ms:.3f} ms, plain {p_ms:.1f} "
              f"ms; statuses kernel "
              f"{np.bincount(k['status'], minlength=11).tolist()}, plain "
              f"{np.bincount(p['status'], minlength=11).tolist()}; mean "
              f"iters {k['iterations'].mean():.3f}; card {card}",
              flush=True)
        print(f"{tag}: kernel vs plain: {describe(r)}; {p1_describe(r)}",
              flush=True)
        # what rounding alone moves: q changed by 1e-7 (the first phase's
        # float32) and, but on infeasible, by 1e-15 over JITTER_SEEDS; the
        # bars each would fail are printed, not held
        for scale, seeds in ((1e-7, (7,)), (1e-15, JITTER_SEEDS
                                            if name != "infeasible" else ())):
            for js in seeds:
                qj = q * (1 + scale * np.random.default_rng(js)
                          .standard_normal(q.shape))
                _, flats_j = megakernel.prepare(P, qj, A, b, spec, dev)
                pj = outputs(*megakernel_ref.mega_solve_plain(
                    *flats_j, spec, B), spec)
                del flats_j
                rj = dict(readings(pj, p, P, qj, A, b), **p1_readings(pj, p))
                fails = violations(rj, bars, B) + p1_violations(rj, bars)
                print(f"{tag}: plain(q*(1+{scale:.0e}*xi), seed {js}) vs "
                      f"plain: {describe(rj)}; {p1_describe(rj)}; would "
                      f"fail: {', '.join(fails) or 'none'} (printed, not "
                      f"held)", flush=True)
        print(f"{tag}: bars: x {bars['x']:.1e}, iters within 1 on "
              f"{bars['within1']} and within {bars['it_max']} on all, "
              f"phase-1 iters equal on {bars['p1_equal']} and within "
              f"{bars['p1_max']} on all, objective {OBJ_TOL:.0e}, true KKT "
              f"{bars.get('kkt', KKT_TOL):.0e}, |s'z| {SZ_TOL:.0e}, SOLVED "
              f"at least plain less 0.1 % of B", flush=True)
        for v in violations(r, bars, B) + p1_violations(r, bars):
            failures.append(f"{tag}: the kernel fails the {v} bar")
        if not all(np.isfinite(k[f]).all() for f in ("x", "z", "s")):
            failures.append(f"{tag}: non-finite x/z/s from the kernel")
        if name != "infeasible" and not (k["p1_iterations"] > 0).all():
            failures.append(f"{tag}: lanes without a float32 step")
        if name == "infeasible":
            lanes = bench_data.infeasible_lanes(B)
            if not np.isin(k["status"][lanes], [2, 5]).all():
                failures.append(f"{tag}: infeasible lanes not detected")
        for wname, change in WRONG_TWO_PHASE.items():
            wspec = megakernel.make_spec(solver.layout, two.replace(**change),
                                         n, pn)
            w = outputs(*_cuda.megakernel(*flats, wspec, B), spec)
            rw = dict(readings(w, p, P, q, A, b), **p1_readings(w, p))
            rejected = violations(rw, bars, B) + p1_violations(rw, bars)
            print(f"{tag}: wrong kernel ({wname}) vs plain: {describe(rw)}; "
                  f"{p1_describe(rw)}; rejected by: "
                  f"{', '.join(rejected) or 'none'}", flush=True)
            if not rejected:
                failures.append(f"{tag}: the bars pass the wrong kernel "
                                f"({wname})")
        res[name] = dict(ms=k_ms, plain_ms=p_ms, spec=spec, B=B,
                         max_abs_err=max(r["dx"], r["dobj"]),
                         iters=k["iterations"], p1=k["p1_iterations"],
                         in_bytes=sum(t.numel() * 8 for t in flats))
        del flats

    # the main path: BatchSolver.solve with the first phase on
    batches = {"bench": (nn_soc, BENCH_N, big), "psd3": (psd3, 3, psd_big)}
    walls, outs = {}, {}

    def best_wall(solver, data):
        solver.solve(*data)                # warm-up
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            out = solver.solve(*data)
            wall = time.perf_counter() - t0
            best = wall if best is None else min(best, wall)
        return best, out

    torch.cuda.synchronize()
    _cuda.megakernel.launches = 0           # K1e's main path starts here
    _cuda.megakernel.two_phase_launches = 0
    for name, (cones, n, data) in batches.items():
        solver = ctt.BatchSolver(cones, n, two)
        for B in TWO_PHASE_THROUGHPUT:
            walls[name, B, 1e-8, True], outs[name, B, 1e-8, True] = \
                best_wall(solver, tuple(a[:B] for a in data))
    launches = _cuda.megakernel.two_phase_launches    # ... and ends here
    print(f"[11] K1e launches on the two-phase path: {launches} (all "
          f"megakernel launches: {_cuda.megakernel.launches})", flush=True)
    if launches <= 0:
        failures.append("[11] BatchSolver.solve did not launch K1e")

    # the single and the two phases side by side, at 1e-8 and 1e-5
    for name, (cones, n, data) in batches.items():
        for tol in (1e-8, 1e-5):
            for tp in (False, True):
                st = ctt.Settings(megakernel_two_phase=tp,
                                  **(RELAXED if tol == 1e-5 else {}))
                solver = ctt.BatchSolver(cones, n, st)
                spec = solver._mega_fn.spec
                for B in (min(TWO_PHASE_THROUGHPUT),
                          max(TWO_PHASE_THROUGHPUT)):
                    sub = tuple(a[:B] for a in data)
                    k_ms, k_chunks = chunked_kernel_ms(sub, spec)
                    if (name, B, tol, tp) not in walls:
                        walls[name, B, tol, tp], outs[name, B, tol, tp] = \
                            best_wall(solver, sub)
                    wall, out = walls[name, B, tol, tp], outs[name, B, tol,
                                                             tp]
                    counts = np.bincount(out.status, minlength=11).tolist()
                    p1 = np.asarray(out._out["p1_iterations"])
                    print(f"[11] {name} B={B} tol={tol:.0e} two_phase="
                          f"{tp}: kernel {k_ms:.3f} ms ({k_chunks} chunks); "
                          f"{counts[SOLVED] / (k_ms / 1e3):,.0f} certified "
                          f"solves/s kernel-only, "
                          f"{counts[SOLVED] / wall:,.0f} wall (best of 3: "
                          f"{wall * 1e3:.2f} ms); SOLVED {counts[SOLVED]}, "
                          f"ALMOST {counts[4]}, statuses {counts}; iters "
                          f"mean {out.iterations.mean():.3f} max "
                          f"{out.iterations.max()}; phase-1 iters mean "
                          f"{p1.mean():.3f}; card {card}", flush=True)
        out = outs[name, min(TWO_PHASE_THROUGHPUT), 1e-8, True]
        P, q, A, b = (a[:min(TWO_PHASE_THROUGHPUT)] for a in data)
        rp, rd, _ = true_kkt(P, q, A, b, out.x, out.z, out.s)
        ok1 = out.status == SOLVED
        kkt = max(rp[ok1].max(initial=0.0), rd[ok1].max(initial=0.0))
        if kkt >= TWO_PHASE_BARS[name].get("kkt", KKT_TOL):
            failures.append(f"[11] {name}: true KKT {kkt:.3e} on the "
                            f"two-phase path")

    # the rescue behind the two-phase kernel
    data = tuple(a[:B0] for a in big)
    alone = ctt.BatchSolver(nn_soc, BENCH_N, two)
    resc = ctt.BatchSolver(nn_soc, BENCH_N, two, rescue="same")
    resc.solve(*data)
    w0, s0 = synced_wall(lambda: alone.solve(*data))
    w1, s1 = synced_wall(lambda: resc.solve(*data))
    before = int((s0.status == SOLVED).sum())
    after = int((s1.status == SOLVED).sum())
    kept = s0.status == SOLVED
    print(f"[11] bench rescue B={B0}: two-phase megakernel alone "
          f"{w0 * 1e3:.1f} ms wall, SOLVED {before}; with rescue='same' "
          f"{w1 * 1e3:.1f} ms wall, SOLVED {after} ({after - before} of "
          f"{B0 - before} closed), statuses "
          f"{np.bincount(s1.status, minlength=11).tolist()}; card {card}",
          flush=True)
    if after < before or not np.array_equal(s1.x[kept], s0.x[kept]):
        failures.append("[11] bench rescue: SOLVED lanes lost or changed")

    # where the reference turns the first phase off: the same library and
    # the same bits as the single phase
    for name, cones, n, data in (
            ("qp_eq", [ctt.ZeroConeT(1), ctt.NonnegativeConeT(BENCH_N + 1)],
             BENCH_N, qp_data),
            ("exp", [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()],
             NONSYM_N, exp_data)):
        one = ctt.BatchSolver(cones, n).solve(*data)
        bs2 = ctt.BatchSolver(cones, n, two)
        before2, before_all = (_cuda.megakernel.two_phase_launches,
                               _cuda.megakernel.launches)
        got = bs2.solve(*data)
        same = all(np.array_equal(getattr(got, f), getattr(one, f))
                   for f in ("x", "z", "s", "status", "iterations"))
        k1e = _cuda.megakernel.two_phase_launches - before2
        print(f"[11] {name} with megakernel_two_phase=True: library "
              f"{_cuda.shape_of(bs2._mega_fn.spec)}, K1e launches {k1e}, "
              f"megakernel launches {_cuda.megakernel.launches - before_all}"
              f"; the single phase's bits: {same}", flush=True)
        if not same or k1e or bs2._mega_fn.spec.two_phase:
            failures.append(f"[11] {name}: two-phase is not a no-op")

    # K1e's bound at bench B: float32 operations of the first phase's
    # iterations (one refinement pass) at the FP32 rate and float64
    # operations of the rest at the FP64 rate, against the bytes
    r = res["bench"]
    spec = r["spec"]
    p1_iters = int(r["p1"].sum())
    p2_iters = int(r["iters"].sum()) - p1_iters
    f32_ops = p1_iters * flops_per_iteration(spec.n, spec.m, spec.segs, 1)
    f64_ops = p2_iters * flops_per_iteration(spec.n, spec.m, spec.segs, 0)
    ops_ms = (f32_ops / FP32_RATE + f64_ops / FP64_RATE) * 1e3
    nbytes = r["in_bytes"] + r["B"] * (spec.outd * 8 + 4 * 4)
    bytes_ms = nbytes / HBM_RATE * 1e3
    print(f"[11] K1e bound at bench B={r['B']}: {f32_ops:.3e} FP32 ops "
          f"({p1_iters} phase-1 iterations) and {f64_ops:.3e} FP64 ops "
          f"({p2_iters} phase-2 iterations) -> {ops_ms:.4f} ms, {nbytes} "
          f"bytes -> {bytes_ms:.4f} ms", flush=True)
    return dict(launches=launches,
                max_abs_err=max(v["max_abs_err"] for v in res.values()),
                ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def outputs(vals, ints, spec):
    """The kernel's (or its plain version's) outputs as host arrays, by
    name."""
    from clarabel_tpu_torch.ipm import megakernel

    eager, rest = megakernel.split_outputs(vals, ints, spec)
    o = megakernel.unpack_eager(eager.cpu().numpy(), spec.n)
    o.update(megakernel.unpack_rest(rest.cpu().numpy(), spec.m))
    return o


def readings(k, p, P, q, A, b):
    """What output k reads against the plain version's output p."""
    SOLVED = 1
    ks, ps = k["status"] == SOLVED, p["status"] == SOLVED
    both = ks & ps
    dx = np.abs(k["x"] - p["x"]).max(axis=1)[both]
    dobj = np.abs(k["obj_val"] - p["obj_val"])[both]
    dit = np.abs(k["iterations"] - p["iterations"])[both]
    rp, rd, sz = true_kkt(P, q, A, b, k["x"], k["z"], k["s"])
    return dict(
        solved=int(ks.sum()), plain_solved=int(ps.sum()),
        both=int(both.sum()), dx=dx.max(initial=0.0),
        dx_lanes=int((dx > 1e-6).sum()), dobj=dobj.max(initial=0.0),
        equal=(dit == 0).mean() if dit.size else 1.0,
        within1=(dit <= 1).mean() if dit.size else 1.0,
        it_max=int(dit.max(initial=0)),
        kkt=max(rp[ks].max(initial=0.0), rd[ks].max(initial=0.0)),
        sz=sz[ks].max(initial=0.0))


def violations(r, bars, B):
    """The bars that readings r fail."""
    out = []
    if r["solved"] < r["plain_solved"] - 0.001 * B:
        out.append("SOLVED count")
    if r["dobj"] > OBJ_TOL:
        out.append("objective")
    if r["dx"] > bars["x"]:
        out.append("x")
    if r["within1"] < bars["within1"] or r["it_max"] > bars["it_max"]:
        out.append("iterations")
    if r["kkt"] >= bars.get("kkt", KKT_TOL) or r["sz"] >= SZ_TOL:
        out.append("true KKT")
    return out


def describe(r):
    return (f"SOLVED {r['solved']} (plain {r['plain_solved']}); on the "
            f"{r['both']} lanes both solve: max|dx| {r['dx']:.3e} "
            f"({r['dx_lanes']} lanes > 1e-6), max|dobj| {r['dobj']:.3e}, "
            f"iters equal on {r['equal']:.4f}, within 1 on "
            f"{r['within1']:.4f}, max diff {r['it_max']}; true KKT "
            f"{r['kkt']:.3e}, |s'z| {r['sz']:.3e}")


def load_tool(name):
    """A module of tools/ (it is beside this script in the checkout)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chunk_phase(card, failures, families):
    """[12] The main path's host side.  `families`: name -> (cones, n,
    bars, the batch at the largest size).  For each family and each B of
    CHUNK_BATCHES: the plain version over the batch (the bars' yardstick),
    then `BatchSolver.solve` in one dispatch and in chunks, best of 3 warm
    solves each, with the steps one at a time (tools/host_probe.py) and
    the launches per source; each chunk's lanes must have the bits of one
    dispatch of the same library over that chunk and meet the family's
    bars.  Returns the launches of the chunked runs by source."""
    import torch
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch.ipm import _cuda, megakernel, megakernel_ref

    probe = load_tool("host_probe")
    dev = torch.device(DEVICE)
    chunked_launches = {"megakernel_group.cu": 0, "megakernel.cu": 0}
    for name, (cones, n, bars, big) in families.items():
        bs = ctt.BatchSolver(cones, n, ctt.Settings(kkt_backend="megakernel"),
                             device=DEVICE)
        spec = bs._mega_fn.spec
        for B in CHUNK_BATCHES:
            data = tuple(a[:B] for a in big)
            P, q, A, b = data
            _, flats = megakernel.prepare(*data, spec, dev)
            t0 = time.perf_counter()
            p = outputs(*megakernel_ref.mega_solve_plain(*flats, spec, B),
                        spec)
            p_s = time.perf_counter() - t0
            del flats
            # at scale, the bars that rounding alone fails: the plain
            # version again with q moved by 1e-15 over JITTER_SEEDS, each
            # against the plain version over the batch; they are not held,
            # but for the true-KKT bar, which reads the kernel's own
            # solution and is held at every size
            noise = set()
            for js in (JITTER_SEEDS if B > FAMILY_B else ()):
                qj = q * (1 + 1e-15 * np.random.default_rng(js)
                          .standard_normal(q.shape))
                _, flats = megakernel.prepare(P, qj, A, b, spec, dev)
                rj = readings(outputs(*megakernel_ref.mega_solve_plain(
                    *flats, spec, B), spec), p, P, qj, A, b)
                del flats
                vj = violations(rj, bars, B)
                noise |= set(vj) - {"true KKT"}
                print(f"[12] {name} B={B}: the plain version against itself "
                      f"(q jitter seed {js}) over the batch: {describe(rj)};"
                      f" fails: {', '.join(vj) or 'none'}", flush=True)
            if B > FAMILY_B:
                print(f"[12] {name} B={B}: bars not held at this B (the "
                      f"plain version against itself fails them): "
                      f"{', '.join(sorted(noise)) or 'none'}", flush=True)
            dims = (spec.triu, spec.n, spec.n * spec.m, spec.m)
            width = sum(d for d, raw in zip(dims, data)
                        if not megakernel.is_const(np.asarray(raw)))
            rule = megakernel.chunk_lanes(width, B)
            configs = [("one dispatch", B),
                       (f"chunks of {rule}" if rule < B else
                        f"chunks of {CHUNK_FORCED}",
                        rule if rule < B else CHUNK_FORCED)]
            for label, C in configs:
                tag = f"[12] {name} B={B} {label}"
                bs._mega_fn = megakernel.build_mega_solve(
                    bs.layout, bs.settings, n, device=dev, chunk=C)
                before = (_cuda.megakernel.launches,
                          _cuda.megakernel.group_launches)
                bs.solve(*data)                       # warm-up
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sol = bs.solve(*data)
                    walls.append(time.perf_counter() - t0)
                wall = min(walls)
                grp = (_cuda.megakernel.group_launches - before[1]) // 4
                thr = (_cuda.megakernel.launches - before[0]) // 4 - grp
                if C < B:
                    chunked_launches["megakernel_group.cu"] += 4 * grp
                    chunked_launches["megakernel.cu"] += 4 * thr
                k = {f: np.asarray(sol._out[f]) for f in
                     ["x", "obj_val", "status", "iterations", "z", "s"]
                     + megakernel.REST_NAMES}
                # each chunk against one dispatch of the same library over
                # its lanes, bit for bit, and against the plain version
                unequal, worst, failing = 0, None, []
                for lo in range(0, B, C):
                    hi = min(B, lo + C)
                    sub = tuple(a[lo:hi] for a in data)
                    _, cf = megakernel.prepare(*sub, spec, dev)
                    one = outputs(*megakernel.solve_flats(*cf, spec, hi - lo),
                                  spec)
                    unequal += sum(
                        np.ascontiguousarray(one[f]).tobytes()
                        != np.ascontiguousarray(k[f][lo:hi]).tobytes()
                        for f in k)
                    kc = {f: v[lo:hi] for f, v in k.items()}
                    pc = {f: v[lo:hi] for f, v in p.items()}
                    r = readings(kc, pc, *sub)
                    read = violations(r, bars, hi - lo)
                    bad = [v for v in read if v not in noise]
                    if B > FAMILY_B:
                        print(f"{tag}: the chunk at lane {lo} against the "
                              f"bars: {', '.join(read) or 'passes'}; of "
                              f"those held: {', '.join(bad) or 'passes'} "
                              f"({describe(r)})", flush=True)
                    if bad:
                        failing.append((lo, bad, describe(r)))
                    if worst is None or r["dx"] > worst["dx"]:
                        worst = r
                steps, _ = probe.steps(data, spec, C, "device", "chunk", dev)
                solved = int((sol.status == 1).sum())
                print(f"{tag}: {solved / wall:,.0f} solves/s wall (best of "
                      f"3: {wall * 1e3:.2f} ms); launches per solve: "
                      f"megakernel_group.cu {grp}, megakernel.cu {thr}; "
                      f"steps ms: " + ", ".join(
                          f"{s_} {v:.2f}" for s_, v in steps.items())
                      + f"; card {card}", flush=True)
                print(f"{tag}: {-(-B // C)} chunks; fields unequal to one "
                      f"dispatch over the chunk: {unequal}; the chunk with "
                      f"the largest |dx| against the plain version ("
                      f"{p_s:.1f} s over the batch): {describe(worst)}; "
                      + f"chunks failing the bars held: {len(failing)}",
                      flush=True)
                if unequal:
                    failures.append(f"{tag}: {unequal} fields differ from "
                                    "one dispatch over the chunk")
                for lo, bad, d in failing:
                    failures.append(f"{tag}: the chunk at lane {lo} fails "
                                    f"the {', '.join(bad)} bar ({d})")
    return chunked_launches


def solver_phase(card, failures):
    """[13] The single-instance Solver on the card against the reference
    Solver's outputs (tests/torch_fixtures/solver.npz): the verify drive,
    the same with mixed precision (its float32 factors through K2, whose
    launches it counts), and a primal- and a dual-infeasible problem.
    Returns K2's launches under mixed precision."""
    import torch
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch.interop import cone_from_tuple
    from clarabel_tpu_torch.linalg import batched_ldl

    fix = np.load(os.path.join(HERE, SOLVER_FIXTURE))

    def case(name):
        cones = [cone_from_tuple(tuple(t))
                 for t in json.loads(str(fix[f"{name}_cones"]))]
        return [fix[f"{name}_{k}"] for k in "PqAb"] + [cones]

    k2_launches = 0
    for name, st in (("verify", ctt.Settings()),
                     ("verify", ctt.Settings(mixed_precision=True)),
                     ("primal_infeasible", ctt.Settings()),
                     ("dual_infeasible", ctt.Settings())):
        P, q, A, b, cones = case(name)
        solver = ctt.Solver(P, q, A, b, cones, st, device=DEVICE)
        k2_before = batched_ldl.kernel.launches
        sol = solver.solve()
        k2 = batched_ldl.kernel.launches - k2_before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve()
        warm = time.perf_counter() - t0
        tag = (f"[13] {name}" + (" mixed precision" if st.mixed_precision
                                 else ""))
        ref_status = int(fix[f"{name}_status"])
        dx = (float(np.abs(sol.x - fix[f"{name}_x"]).max())
              if sol.status == 1 else float("nan"))
        print(f"{tag}: {sol.status.name} (reference "
              f"{ctt.SolverStatus(ref_status).name}), {sol.iterations} "
              f"iterations (reference {int(fix[f'{name}_iterations'])}), "
              f"max|dx| against the reference {dx:.3e}, r_prim "
              f"{sol.r_prim:.2e}, r_dual {sol.r_dual:.2e}; K2 launches {k2}; "
              f"warm solve {warm * 1e3:.2f} ms; card {card}", flush=True)
        if int(sol.status) != ref_status:
            failures.append(f"{tag}: status {sol.status.name}, the "
                            f"reference's {ref_status}")
        if abs(sol.iterations - int(fix[f"{name}_iterations"])) > 4:
            failures.append(f"{tag}: iterations {sol.iterations}")
        if sol.status == 1 and not (dx < 1e-6 and sol.r_prim < 1e-8
                                    and sol.r_dual < 1e-8):
            failures.append(f"{tag}: x or residuals off the reference")
        if st.mixed_precision:
            k2_launches += k2
            if k2 <= 0:
                failures.append(f"{tag}: no K2 launch")
        elif k2:
            failures.append(f"{tag}: float64 factors launched K2")
    return k2_launches


def sparse_problem(name):
    """(P, q, A, b, cones, settings) of a [14] case, from the port's
    generators at the size of the repository's configurations."""
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data

    if name == "grid60":
        P, q, A, b = bench_data.grid_qp_sparse(60)
        return P, q, A, b, [ctt.NonnegativeConeT(3600)], ctt.Settings()
    if name == "banded2500":
        P, q, A, b, cones = bench_data.large_banded_qp_sparse(2500)
        return P, q, A, b, cones, ctt.Settings()
    P, q, A, b, cones, _, _ = bench_data.robust_ls_banded(m=2000, n=500)
    return P, q, A, b, cones, ctt.Settings(sparse_data=True)


def sparse_true_kkt(P, q, A, b, sol):
    """2-norms of the primal and dual residuals of the original sparse
    problem at the solution, and |s'z|."""
    import scipy.sparse as sp

    U = sp.triu(sp.csr_matrix(P))
    Pf = U + sp.triu(U, 1).T
    A = sp.csr_matrix(A)
    return (float(np.linalg.norm(A @ sol.x + sol.s - b)),
            float(np.linalg.norm(Pf @ sol.x + q + A.T @ sol.z)),
            float(abs(sol.s @ sol.z)))


def sparse_check(tag, fix, key, sol, kkt, failures):
    """Hold one solution to the fixture's outputs under `key` and to the
    true-KKT bar; returns (max|dx| relative, |dobj| relative)."""
    ref_x = fix[f"{key}_x"]
    ref_obj = float(fix[f"{key}_obj_val"])
    ref_status = int(fix[f"{key}_status"])
    ref_it = int(fix[f"{key}_iterations"])
    dx = float(np.abs(sol.x - ref_x).max() / max(1.0, np.abs(ref_x).max()))
    dobj = abs(sol.obj_val - ref_obj) / max(1.0, abs(ref_obj))
    if int(sol.status) != ref_status:
        failures.append(f"{tag}: status {sol.status.name}, the "
                        f"reference's {ref_status}")
    if abs(sol.iterations - ref_it) > SPARSE_IT_TOL:
        failures.append(f"{tag}: {sol.iterations} iterations, the "
                        f"reference's {ref_it}")
    if not (dx <= SPARSE_TOL and dobj <= SPARSE_TOL):
        failures.append(f"{tag}: x ({dx:.3e}) or objective ({dobj:.3e}) "
                        f"off the reference")
    if not (kkt[0] < KKT_TOL and kkt[1] < KKT_TOL):
        failures.append(f"{tag}: true KKT {kkt[:2]}")
    return dx, dobj


def sparse_phase(card, failures):
    """[14] The Solver's sparse and structured KKT on the card against the
    reference Solver's outputs (tests/torch_fixtures/sparse.npz).  Returns
    the readings per case, grid60's solver with its problem (P, q, A, b),
    which [15] reuses, and each case's warm solution, against which [17]
    holds its sharded solves."""
    import torch
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import native_symbolic, structure, structure_nd

    fix = np.load(os.path.join(HERE, SPARSE_FIXTURE))
    loaded = native_symbolic.available()
    print(f"[14] native symbolic library loaded: {loaded} "
          f"({os.path.relpath(native_symbolic.LIB_PATH, HERE)})", flush=True)
    if not loaded:
        failures.append("[14] the native symbolic library did not load")
    readings, solutions, kept = {}, {}, None
    for name in SPARSE_CASES:
        tag = f"[14] {name}"
        P, q, A, b, cones, st = sparse_problem(name)
        t0 = time.perf_counter()
        solver = ctt.Solver(P, q, A, b, cones, st, device=DEVICE)
        setup = time.perf_counter() - t0
        split = dict(solver._setup_split)
        counts = solver._solve_fn.counts
        plan = type(solver._structure).__name__
        f0 = counts["factorizations"]
        t0 = time.perf_counter()
        sol = solver.solve()       # the one fetch syncs with the card
        cold = time.perf_counter() - t0
        nfac = counts["factorizations"] - f0
        t0 = time.perf_counter()
        warm_sol = solver.solve()
        warm = time.perf_counter() - t0
        kkt = sparse_true_kkt(P, q, A, b, sol)
        dx, dobj = sparse_check(tag, fix, name, sol, kkt, failures)
        r = dict(setup_s=setup, analysis_s=split["analysis"],
                 maps_s=split["maps"],
                 rest_s=setup - split["analysis"] - split["maps"],
                 cold_s=cold, warm_s=warm, iterations=sol.iterations,
                 ms_per_iteration=warm / max(1, sol.iterations) * 1e3,
                 factorizations=nfac, factor_dtype=counts["factor_dtype"],
                 backend=solver._backend, plan=plan)
        print(f"{tag}: {solver._backend} {plan} "
              f"{fix[name + '_plan_shapes']} (reference "
              f"{fix[name + '_backend']} {fix[name + '_plan']} "
              f"{fix[name + '_plan_shapes']}), factors "
              f"{counts['factor_dtype']}; {sol.status.name} in "
              f"{sol.iterations} iterations (reference "
              f"{int(fix[name + '_iterations'])}); x within {dx:.3e}, "
              f"objective within {dobj:.3e} of the reference; true KKT "
              f"{kkt[0]:.2e} {kkt[1]:.2e} |s'z| {kkt[2]:.2e} (reference "
              f"{float(fix[name + '_kkt'][2]):.2e}); setup "
              f"{setup:.3f} s (analysis {split['analysis']:.3f}, maps "
              f"{split['maps']:.3f}, rest {r['rest_s']:.3f}); solve cold "
              f"{cold:.3f} s, warm {warm:.3f} s, "
              f"{r['ms_per_iteration']:.2f} ms per IPM iteration, "
              f"{nfac} factorizations; card {card}", flush=True)
        if solver._backend != str(fix[name + "_backend"]) \
                or plan != str(fix[name + "_plan"]):
            failures.append(f"{tag}: {solver._backend} {plan}, the "
                            f"reference's {fix[name + '_backend']} "
                            f"{fix[name + '_plan']}")
        if not np.array_equal(warm_sol.x, sol.x):
            failures.append(f"{tag}: the warm solve's x differs from the "
                            f"cold solve's bits")
        if name == "grid60" and counts["factor_dtype"] != "float32":
            failures.append(f"{tag}: fronts in {counts['factor_dtype']}, "
                            f"not float32")
        if name == "rls2000" and solver._assembly.soc_rank2_min_dim is None:
            failures.append(f"{tag}: no rank-2 SMW correction")
        if name == "banded2500":
            # update_q and update_b, then a warm re-solve that must not
            # analyze the pattern again
            def refuse(*a, **k):
                raise RuntimeError("analysis after a data update")

            saved = (structure.analyze_block_arrow,
                     structure_nd.analyze_nested_dissection)
            structure.analyze_block_arrow = refuse
            structure_nd.analyze_nested_dissection = refuse
            try:
                q2, b2 = fix[f"{name}_updarg_q"], fix[f"{name}_updarg_b"]
                t0 = time.perf_counter()
                solver.update_q(q2)
                solver.update_b(b2)
                usol = solver.solve()
                upd = time.perf_counter() - t0
            finally:
                (structure.analyze_block_arrow,
                 structure_nd.analyze_nested_dissection) = saved
            ukkt = sparse_true_kkt(P, q2, A, b2, usol)
            udx, udobj = sparse_check(f"{tag} after update_q/update_b", fix,
                                      f"{name}_upd", usol, ukkt, failures)
            r.update(update_s=upd, update_iterations=usol.iterations)
            print(f"{tag} after update_q and update_b: {usol.status.name} "
                  f"in {usol.iterations} iterations (reference "
                  f"{int(fix[name + '_upd_iterations'])}), x within "
                  f"{udx:.3e}, objective within {udobj:.3e}; true KKT "
                  f"{ukkt[0]:.2e} {ukkt[1]:.2e}; update and warm solve "
                  f"{upd:.3f} s, no analysis; card {card}", flush=True)
        readings[name] = r
        solutions[name] = warm_sol
        if name == "grid60":
            kept = (solver, P, q, A, b)     # [15] runs its long solves
        del solver
        torch.cuda.empty_cache()
    return readings, kept, solutions


def long_phase(card, failures, grid):
    """[15] Long solves on the card: chunked (LONG_CHUNKS iterations a
    chunk, each chunk captures the loop's CUDA graph again and replays it)
    and time-limited solves, a tiny time limit, a checkpoint after
    LONG_CAP iterations and its resume, a timed solve with the timer tree,
    and a profiled warm solve, on [14]'s grid60 solver; then the verify
    drive under mixed precision with a time limit, K2's launches counted.
    Every path must give the one-shot solve's bits."""
    import tempfile

    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch.api import _fetch
    from clarabel_tpu_torch.interop import cone_from_tuple
    from clarabel_tpu_torch.linalg import batched_ldl

    def same_bits(tag, got, ref):
        same = (int(got.status) == int(ref.status)
                and got.iterations == ref.iterations
                and all(np.array_equal(getattr(got, k), getattr(ref, k))
                        for k in ("x", "z", "s")))
        print(f"{tag}: {got.status.name} in {got.iterations} iterations; "
              f"bits {'equal to' if same else 'DIFFERENT from'} the "
              f"one-shot solve's", flush=True)
        if not same:
            failures.append(f"{tag}: not the one-shot solve's bits")

    solver, P, q, A, b = grid
    base = solver.settings
    one = solver.solve()
    t = time.perf_counter()
    one = solver.solve()
    one_s = time.perf_counter() - t
    print(f"[15] grid60 one-shot: {one.status.name} in {one.iterations} "
          f"iterations, {one_s:.3f} s; card {card}", flush=True)
    for chunk in LONG_CHUNKS:
        t = time.perf_counter()
        out = solver._solve_chunked(time.perf_counter(), chunk_iters=chunk)
        got = solver._package_solution(_fetch(out), 0.0)
        same_bits(f"[15] grid60 chunks of {chunk} ({time.perf_counter() - t:.3f}"
                  f" s)", got, one)
    solver.settings = base.replace(time_limit=600.0)
    same_bits("[15] grid60 time_limit=600", solver.solve(), one)
    solver.settings = base.replace(time_limit=1e-12)
    out = _fetch(solver._solve_chunked(time.perf_counter(), chunk_iters=1))
    tiny = ctt.SolverStatus(int(out["status"]))
    print(f"[15] grid60 time_limit=1e-12, chunks of 1: {tiny.name} after "
          f"{int(out['iterations'])} iteration(s)", flush=True)
    if tiny not in (ctt.SolverStatus.MAX_TIME, ctt.SolverStatus.ALMOST_SOLVED,
                    ctt.SolverStatus.SOLVED) or int(out["iterations"]) != 1:
        failures.append(f"[15] tiny time limit: {tiny.name} after "
                        f"{int(out['iterations'])} iterations")
    solver.settings = base
    with tempfile.TemporaryDirectory() as d:
        fn = solver._solve_fn
        data, carry = fn.prepare(*solver._dev_args)
        solver._last_carry = fn.run_phases(data, carry, LONG_CAP)
        path = os.path.join(d, "state.npz")
        solver.save_checkpoint(path)
        size = os.path.getsize(path)
        t = time.perf_counter()
        resumed = solver.resume_from_checkpoint(path)
        same_bits(f"[15] grid60 checkpoint after {LONG_CAP} iterations "
                  f"({size} bytes), resumed ({time.perf_counter() - t:.3f} "
                  f"s)", resumed, one)
        solver.settings = base.replace(timing=True)
        same_bits("[15] grid60 timing=True", solver.solve(), one)
        print("[15] print_timers:", flush=True)
        solver.print_timers()
        timers = dict(solver._timers)
        probes = solver._probe_phase_times()
        solver.settings = base
        print(f"[15] grid60 stages: prepare {timers['prepare'] * 1e3:.2f} "
              f"ms, loop {timers['loop'] * 1e3:.2f} ms "
              f"({timers['loop'] / max(1, timers['iterations']) * 1e3:.2f} "
              f"ms per iteration), finalize {timers['finalize'] * 1e3:.2f} "
              f"ms; probes (CUDA events, best of 3): "
              + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in probes.items())
              + f"; card {card}", flush=True)
        solver._sync()
        with solver.profile_trace(d):
            t = time.perf_counter()
            prof_sol = solver.solve()
            solver._sync()
            wall = time.perf_counter() - t
        with open(solver.last_trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        busy = sum(float(e.get("dur", 0.0)) for e in kernels) / 1e6
        print(f"[15] profile_trace: {len(kernels)} CUDA kernel events in "
              f"{len(events)} trace events, device busy {busy * 1e3:.2f} ms "
              f"of {wall * 1e3:.2f} ms wall (busy share {busy / wall:.4f}); "
              f"card {card}", flush=True)
        same_bits("[15] grid60 under profile_trace", prof_sol, one)
        if not kernels:
            failures.append("[15] the trace holds no CUDA kernel event")
    long_readings = dict(timers, probes=probes, kernel_events=len(kernels),
                         busy_share=busy / wall, one_shot_s=one_s)

    # the verify drive under mixed precision, time-limited: K2 at N = 8
    fix = np.load(os.path.join(HERE, SOLVER_FIXTURE))
    lfix = np.load(os.path.join(HERE, LONG_FIXTURE))
    vP, vq, vA, vb = (fix[f"verify_{k}"] for k in "PqAb")
    cones = [cone_from_tuple(tuple(t))
             for t in json.loads(str(fix["verify_cones"]))]
    mixed = ctt.Settings(mixed_precision=True)
    one = ctt.Solver(vP, vq, vA, vb, cones, mixed, device=DEVICE).solve()
    batched_ldl.kernel.reset_counts()
    sol = ctt.Solver(vP, vq, vA, vb, cones, mixed.replace(time_limit=600.0),
                     device=DEVICE).solve()
    k2 = (batched_ldl.kernel.launches,
          batched_ldl.kernel.source_launches["ldl_inverse_rows.cu"])
    same_bits("[15] verify drive, mixed precision, time_limit=600", sol, one)
    dx = float(np.abs(sol.x - lfix["chunked_verify_mixed_x"]).max())
    print(f"[15] verify drive, mixed precision, time-limited: K2 launches "
          f"{k2[0]} ({k2[1]} ldl_inverse_rows.cu); max|dx| against the "
          f"reference's time-limited solve {dx:.3e}; card {card}", flush=True)
    if k2[1] <= 0:
        failures.append("[15] the time-limited mixed-precision solve "
                        "launched no K2")
    if int(sol.status) != int(lfix["chunked_verify_mixed_status"]) \
            or dx > SPARSE_TOL:
        failures.append(f"[15] the time-limited mixed-precision solve is "
                        f"off the reference ({sol.status.name}, {dx:.3e})")
    long_readings["k2_launches"] = k2[0]
    return long_readings


def baseline_phase(card, failures):
    """[16] The BASELINE runner (baseline_torch.py) on the card at
    run_all.py's full scale: every single row held to the reference's
    outputs, the batched row through K1a's group kernel held to its plain
    version, the command line once as a subprocess, and
    precompile.warmup().  Returns the readings."""
    import torch
    import baseline_torch
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import precompile
    from clarabel_tpu_torch.ipm import _cuda, megakernel, megakernel_ref

    fix = np.load(os.path.join(HERE, LONG_FIXTURE))
    rows = {}
    for key, name, gen in baseline_torch.single_rows(1.0):
        tag = f"[16] {key}"
        sol, t, (P, q, A, b, _) = baseline_torch.run_single(name, gen,
                                                            DEVICE)
        ref_x = fix[f"row_{key}_x"]
        ref_obj = float(fix[f"row_{key}_obj_val"])
        dx = float(np.abs(sol.x - ref_x).max()
                   / max(1.0, np.abs(ref_x).max()))
        dobj = abs(sol.obj_val - ref_obj) / max(1.0, abs(ref_obj))
        ref_dx = float(fix[f"spread_row_{key}_dx"])
        ref_kkt = float(fix[f"spread_row_{key}_kkt"])
        rounding = ({"x"} if ref_dx > SPARSE_TOL else set()) | (
            {"true KKT"} if ref_kkt >= KKT_TOL else set())
        U = np.triu(P)
        Pf = U + np.triu(U, 1).T
        rp = float(np.linalg.norm(A @ sol.x + sol.s - b))
        rd = float(np.linalg.norm(Pf @ sol.x + q + A.T @ sol.z))
        ref_it = int(fix[f"row_{key}_iterations"])
        print(f"{tag}: {sol.status.name} in {sol.iterations} iterations "
              f"(reference {ref_it}); x within {dx:.3e} (the reference "
              f"against itself {ref_dx:.3e}), objective within "
              f"{dobj:.3e}; true KKT {rp:.2e} {rd:.2e} (the reference's "
              f"own up to {ref_kkt:.2e}); not held, rounding: "
              f"{', '.join(sorted(rounding)) or 'none'}; best warm solve "
              f"{t * 1e3:.3f} ms; card {card}", flush=True)
        if int(sol.status) != int(fix[f"row_{key}_status"]):
            failures.append(f"{tag}: status {sol.status.name}")
        if abs(sol.iterations - ref_it) > SPARSE_IT_TOL:
            failures.append(f"{tag}: {sol.iterations} iterations")
        if dobj > SPARSE_TOL:
            failures.append(f"{tag}: objective ({dobj:.3e}) off the "
                            f"reference")
        if "x" not in rounding and dx > SPARSE_TOL:
            failures.append(f"{tag}: x ({dx:.3e}) off the reference")
        if "true KKT" not in rounding and not (rp < KKT_TOL
                                               and rd < KKT_TOL):
            failures.append(f"{tag}: true KKT {rp:.2e} {rd:.2e}")
        rows[key] = dict(status=sol.status.name, iterations=sol.iterations,
                         ms=t * 1e3, dx=dx)

    # the batched row: K1a's group kernel at B = 4096
    _cuda.megakernel.launches = 0
    _cuda.megakernel.group_launches = 0
    out, dt, (P, q, A, b), bs = baseline_torch.run_batched(BASELINE_B,
                                                           DEVICE)
    launches = (_cuda.megakernel.launches, _cuda.megakernel.group_launches)
    spec = bs._mega_fn.spec
    B, flats = megakernel.prepare(P, q, A, b, spec, torch.device(DEVICE))
    p = outputs(*megakernel_ref.mega_solve_plain(*flats, spec, B), spec)
    k = {"status": out.status, "x": out.x, "obj_val": out.obj_val,
         "iterations": out.iterations, "z": out.z, "s": out.s}
    r = readings(k, p, P, q, A, b)
    solved = int((out.status == 1).sum())
    ref_solved = int(fix["batched_solved"])
    print(f"[16] batched: K1a launches {launches[0]} ({launches[1]} "
          f"megakernel_group.cu); against the plain version: {describe(r)}; "
          f"SOLVED {solved} (reference BatchSolver {ref_solved}); best warm "
          f"solve {dt * 1e3:.3f} ms, {solved / dt:,.0f} solves/s; card "
          f"{card}", flush=True)
    for v in violations(r, BARS["bench"], B):
        failures.append(f"[16] batched: the {v} bar")
    if launches[1] <= 0:
        failures.append("[16] the batched row launched no K1a group kernel")
    if solved < ref_solved - 0.001 * B:
        failures.append(f"[16] batched: SOLVED {solved}, the reference's "
                        f"{ref_solved}")
    rows["batched"] = dict(solved=solved, ms=dt * 1e3, solves_per_s=solved
                           / dt, launches=launches[1])

    # the command line, once, as a user runs it
    t = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "clarabel_tpu_torch",
         os.path.join("benchmarks", "data", "CVXQP1_style.qps")],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    last = (cli.stdout.strip().splitlines() or [""])[-1]
    print(f"[16] python -m clarabel_tpu_torch benchmarks/data/"
          f"CVXQP1_style.qps: exit {cli.returncode} in "
          f"{time.perf_counter() - t:.1f} s: {last}", flush=True)
    if cli.returncode != 0 or "status=SOLVED" not in cli.stdout:
        failures.append(f"[16] the command line: exit {cli.returncode}, "
                        f"{cli.stderr.strip()[-300:]}")

    # warmup: its libraries were built in [1]'s parallel build
    with open(os.path.join(HERE, "tests", "torch_fixtures",
                           "long.json")) as f:
        ref_warm = json.load(f)["warmup"]
    def missing_libraries(requests):
        return [(lib, v) for lib, variants in requests for v in variants
                if not os.path.exists(lib.lib_path(v))]

    requests = precompile.library_requests(device=DEVICE)
    missing = missing_libraries(requests)
    times = []
    for _ in range(2):
        t = time.perf_counter()
        statuses = precompile.warmup(device=DEVICE)
        times.append(time.perf_counter() - t)
        got = {k: v.name for k, v in statuses.items()}
        if got != ref_warm:
            failures.append(f"[16] warmup statuses {got}")
    after = missing_libraries(requests)
    n_libs = sum(len(v) for _, v in requests)
    print(f"[16] precompile.warmup(): {got} (reference {ref_warm}); "
          f"{n_libs} libraries, {len(missing)} missing before the first "
          f"call, {len(after)} after; first call {times[0]:.3f} s, second "
          f"{times[1]:.3f} s; card {card}", flush=True)
    if after:
        failures.append(f"[16] warmup left {len(after)} libraries unbuilt")
    return dict(rows=rows, warmup_s=times)


def _multidevice_solution(sol):
    return {"x": sol.x, "z": sol.z, "s": sol.s, "status": int(sol.status),
            "iterations": sol.iterations, "obj_val": sol.obj_val,
            "r_prim": sol.r_prim, "r_dual": sol.r_dual}


def multidevice_rank(rank, world, out_dir):
    """One rank of [17](b), on cuda:0 under a gloo group of `world` ranks:
    rls2000 with tp = world (cold, warm, and a third solve with the
    collectives' host time), the bench batch with dp = world under
    Settings.throughput(), and the dryrun; writes out_dir/rank{rank}.npz."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data
    from clarabel_tpu_torch.entry import dryrun_multichip
    from clarabel_tpu_torch.linalg import batched_ldl
    from clarabel_tpu_torch.parallel.multihost import collectives

    res = {}
    ranks = torch.arange(world)
    tp = DeviceMesh("cuda", ranks, mesh_dim_names=("tp",))
    P, q, A, b, cones, st = sparse_problem("rls2000")
    solver = ctt.Solver(P, q, A, b, cones, st, mesh=tp)
    res["solver_graphed"] = solver._solve_fn.graphed
    res["solver_device"] = str(solver.device)
    res["solver_p"] = solver._structure.p
    solver.solve()
    t0 = time.perf_counter()
    sol = solver.solve()
    res["solver_wall_s"] = time.perf_counter() - t0
    # a third solve with the collectives timed (each all-reduce between two
    # synchronizations, which that solve's own wall then includes)
    collectives.timed = True
    collectives.reset()
    t0 = time.perf_counter()
    solver.solve()
    res["solver_timed_wall_s"] = time.perf_counter() - t0
    res["solver_collective_s"] = collectives.seconds
    res["solver_collectives"] = collectives.calls
    collectives.timed = False
    res.update({f"solver_{k}": v
                for k, v in _multidevice_solution(sol).items()})
    del solver
    torch.cuda.empty_cache()

    dp = DeviceMesh("cuda", ranks, mesh_dim_names=("dp",))
    Pb, qb, Ab, bb = bench_data.make_batch(MULTI_B, BENCH_N, 0)
    bs = ctt.BatchSolver([ctt.NonnegativeConeT(BENCH_N),
                          ctt.SecondOrderConeT(BENCH_N + 1)], BENCH_N,
                         ctt.Settings.throughput(), mesh=dp)
    bs.solve(Pb, qb, Ab, bb)
    batched_ldl.kernel.reset_counts()
    collectives.timed = True
    collectives.reset()
    t0 = time.perf_counter()
    out = bs.solve(Pb, qb, Ab, bb)
    res["batch_wall_s"] = time.perf_counter() - t0
    res["batch_collective_s"] = collectives.seconds
    collectives.timed = False
    res["batch_k2_rows_launches"] = \
        batched_ldl.kernel.source_launches["ldl_inverse_rows.cu"]
    res.update({f"batch_{k}": getattr(out, k)
                for k in ("x", "status", "obj_val", "iterations")})
    res["dryrun"] = dryrun_multichip()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def batch_spread(rk, full):
    """A rank's gathered batch against a whole-batch solve: max |dx|,
    max |dobj| (NaN where both are NaN counts as equal) and the count of
    lanes whose status differs."""
    gap = np.abs(rk["batch_obj_val"] - full["obj_val"])
    both_nan = np.isnan(rk["batch_obj_val"]) & np.isnan(full["obj_val"])
    return (float(np.abs(rk["batch_x"] - full["x"]).max()),
            float(np.where(both_nan, 0.0, gap).max()),
            int((rk["batch_status"] != full["status"]).sum()))


def multidevice_phase(card, failures, rls_ref, rls_ms):
    """[17] Multi-device on the card: (a) a world of one rank over NCCL in
    this process, then (b) MULTI_RANKS ranks on cuda:0 over gloo.
    `rls_ref` and `rls_ms` are [14]'s unsharded rls2000 solution and its
    ms per IPM iteration.  Returns the readings and the K2 launches of
    (a)'s sharded batch (a main path of K2)."""
    import shutil
    import tempfile
    import types

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data
    from clarabel_tpu_torch.entry import dryrun_multichip
    from clarabel_tpu_torch.linalg import batched_ldl
    from clarabel_tpu_torch.parallel.dryrun import launch
    from clarabel_tpu_torch.parallel.multihost import capturable

    readings = {}
    fix = np.load(os.path.join(HERE, SPARSE_FIXTURE))
    P, q, A, b, cones, st = sparse_problem("rls2000")
    cones_b = [ctt.NonnegativeConeT(BENCH_N),
               ctt.SecondOrderConeT(BENCH_N + 1)]
    batch = bench_data.make_batch(MULTI_B, BENCH_N, 0)
    thr = ctt.Settings.throughput()
    ref_b = ctt.BatchSolver(cones_b, BENCH_N, thr).solve(*batch)

    # (a) a world of one rank over NCCL
    torch.cuda.set_device(0)
    tmp = tempfile.mkdtemp(prefix="rendezvous_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            world_size=1, rank=0)
    try:
        mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("dp", "tp"))
        solver = ctt.Solver(P, q, A, b, cones, st, mesh=mesh)
        fn = solver._solve_fn
        why = ("the tp group is NCCL, whose collectives a CUDA graph "
               "captures" if capturable(mesh.get_group("tp"))
               else "the tp group cannot be captured")
        solver.solve()
        r0 = fn.counts["replays"]
        t0 = time.perf_counter()
        sol = solver.solve()
        warm = time.perf_counter() - t0
        replays = fn.counts["replays"] - r0
        ms = warm / max(1, sol.iterations) * 1e3
        same = (int(sol.status) == int(rls_ref.status)
                and sol.iterations == rls_ref.iterations
                and all(np.array_equal(getattr(sol, k), getattr(rls_ref, k))
                        for k in ("x", "z", "s")))
        print(f"[17](a) rls2000, Solver(mesh=(dp 1, tp 1)) over NCCL: "
              f"{'graphed' if fn.graphed else 'eager'} ({why}; "
              f"{replays} passes replayed); p = {solver._structure.p}; "
              f"{sol.status.name} in {sol.iterations} iterations; bits "
              f"{'equal to' if same else 'DIFFERENT from'} [14]'s "
              f"unsharded solve; {ms:.2f} ms per IPM iteration ([14]: "
              f"{rls_ms:.2f}); card {card}", flush=True)
        if not same:
            failures.append("[17](a) rls2000: not the unsharded bits")
        if not fn.graphed or replays <= 0:
            failures.append("[17](a) rls2000: the NCCL pass did not replay "
                            "as a CUDA graph")
        readings["a_rls2000"] = dict(ms_per_iteration=ms,
                                     unsharded_ms_per_iteration=rls_ms,
                                     iterations=sol.iterations,
                                     replays=replays)
        del solver, fn
        torch.cuda.empty_cache()

        dp_mesh = DeviceMesh("cuda", torch.zeros(1, dtype=torch.int64),
                             mesh_dim_names=("dp",))
        bs = ctt.BatchSolver(cones_b, BENCH_N, thr, mesh=dp_mesh)
        batched_ldl.kernel.reset_counts()
        t0 = time.perf_counter()
        out = bs.solve(*batch)
        wall = time.perf_counter() - t0
        k2 = batched_ldl.kernel.source_launches["ldl_inverse_rows.cu"]
        same = all(np.array_equal(getattr(out, k), getattr(ref_b, k))
                   for k in ("status", "iterations", "x", "obj_val"))
        print(f"[17](a) bench B={MULTI_B}, BatchSolver(mesh=dp 1) under "
              f"Settings.throughput(): {int((out.status == 1).sum())} "
              f"SOLVED; bits {'equal to' if same else 'DIFFERENT from'} the "
              f"unsharded solve's; K2 launches {k2} (ldl_inverse_rows.cu, of "
              f"{batched_ldl.kernel.launches} in all); "
              f"{wall:.3f} s; card {card}", flush=True)
        if not same:
            failures.append("[17](a) dp batch: not the unsharded bits")
        if k2 <= 0:
            failures.append("[17](a) dp batch: no K2 launch")
        readings["a_batch"] = dict(wall_s=wall, k2_rows_launches=k2)
        line = dryrun_multichip()
        if not line.startswith("dryrun_multichip OK on 1 devices"):
            failures.append(f"[17](a) dryrun: {line}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    # (b) MULTI_RANKS ranks on cuda:0 over gloo
    out_dir = tempfile.mkdtemp(prefix="multidevice_")
    t0 = time.perf_counter()
    codes = launch(multidevice_rank, MULTI_RANKS, "gloo", None, (out_dir,),
                   timeout=MULTI_JOIN_S)
    print(f"[17](b) {MULTI_RANKS} ranks on cuda:0 over gloo: exit codes "
          f"{codes} in {time.perf_counter() - t0:.1f} s", flush=True)
    if codes != [0] * MULTI_RANKS:
        failures.append(f"[17](b) rank exit codes {codes}")
        shutil.rmtree(out_dir, ignore_errors=True)
        return readings, k2
    ranks = []
    for r in range(MULTI_RANKS):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            ranks.append({k: f[k] for k in f.files})
    shutil.rmtree(out_dir, ignore_errors=True)
    # the unsharded solves of each rank's share of the lanes, each as one
    # batch, side by side
    share = MULTI_B // MULTI_RANKS
    parts = [ctt.BatchSolver(cones_b, BENCH_N, thr).solve(
        *(a[r * share:(r + 1) * share] for a in batch))
        for r in range(MULTI_RANKS)]
    shares = {k: np.concatenate([getattr(o, k) for o in parts])
              for k in ("status", "iterations", "x", "obj_val")}
    ref_x = rls_ref.x
    for r, rk in enumerate(ranks):
        tag = f"[17](b) rank {r}"
        got = types.SimpleNamespace(
            x=rk["solver_x"], z=rk["solver_z"], s=rk["solver_s"],
            status=ctt.SolverStatus(int(rk["solver_status"])),
            iterations=int(rk["solver_iterations"]),
            obj_val=float(rk["solver_obj_val"]))
        dx = float(np.linalg.norm(got.x - ref_x))
        kkt = sparse_true_kkt(P, q, A, b, got)
        fdx, fdobj = sparse_check(f"{tag} rls2000 against the reference",
                                  fix, "rls2000", got, kkt, failures)
        ms = float(rk["solver_wall_s"]) / max(1, got.iterations) * 1e3
        timed_ms = (float(rk["solver_timed_wall_s"]) / max(1, got.iterations)
                    * 1e3)
        coll = float(rk["solver_collective_s"])
        print(f"{tag} rls2000, Solver(mesh=tp {MULTI_RANKS}) on "
              f"{rk['solver_device']}, "
              f"{'graphed' if bool(rk['solver_graphed']) else 'eager'} "
              f"(gloo's collectives cannot be captured), p = "
              f"{int(rk['solver_p'])}: {got.status.name} in "
              f"{got.iterations} iterations ([14]: {rls_ref.iterations}); "
              f"|dx| {dx:.3e} against [14]'s unsharded x (|x| "
              f"{np.linalg.norm(ref_x):.3e}); x within {fdx:.3e}, objective "
              f"within {fdobj:.3e} of the reference; r_prim "
              f"{float(rk['solver_r_prim']):.2e} r_dual "
              f"{float(rk['solver_r_dual']):.2e}; warm {ms:.2f} ms per IPM "
              f"iteration; with each all-reduce between two "
              f"synchronizations {timed_ms:.2f} ms, of which "
              f"{coll / max(1, got.iterations) * 1e3:.2f} ms in "
              f"{int(rk['solver_collectives'])} all-reduces (share "
              f"{coll / float(rk['solver_timed_wall_s']):.3f}); card {card}",
              flush=True)
        if (got.status != rls_ref.status
                or got.iterations != rls_ref.iterations
                or not dx < 1e-8 * max(1.0, np.linalg.norm(ref_x))):
            failures.append(f"{tag} rls2000: off [14]'s unsharded solve")
        if not (float(rk["solver_r_prim"]) < 1e-8
                and float(rk["solver_r_dual"]) < 1e-8):
            failures.append(f"{tag} rls2000: residuals above 1e-8")
        bits = all(np.array_equal(rk[f"batch_{k}"], shares[k])
                   for k in ("status", "iterations", "x", "obj_val"))
        full = {k: getattr(ref_b, k) for k in ("status", "x", "obj_val")}
        bx, bobj, bst = batch_spread(rk, full)
        hx, hobj, hst = batch_spread(
            {f"batch_{k}": v for k, v in shares.items()}, full)
        bms = (float(rk["batch_wall_s"])
               / max(1, int(rk["batch_iterations"].max())) * 1e3)
        print(f"{tag} bench B={MULTI_B}, BatchSolver(mesh=dp "
              f"{MULTI_RANKS}) under Settings.throughput(): every lane's "
              f"bits {'equal to' if bits else 'DIFFERENT from'} the "
              f"unsharded solves of each {share}-lane share; "
              f"against the unsharded solve of all {MULTI_B} lanes "
              f"{bst} statuses differ, max |dx| {bx:.3e}, max |dobj| "
              f"{bobj:.3e} (the unsharded shares read {hst}, {hx:.3e}, "
              f"{hobj:.3e}); {float(rk['batch_wall_s']):.3f} s, {bms:.2f} ms"
              f" per IPM pass, {float(rk['batch_collective_s']) * 1e3:.2f} "
              f"ms in the gather; K2 launches "
              f"{int(rk['batch_k2_rows_launches'])} on this rank; card "
              f"{card}", flush=True)
        if not bits:
            failures.append(f"{tag} dp batch: not the unsharded bits of "
                            f"the shares")
        line = str(rk["dryrun"])
        print(f"{tag}: {line}", flush=True)
        if not line.startswith(f"dryrun_multichip OK on {MULTI_RANKS} "):
            failures.append(f"{tag} dryrun: {line}")
        readings[f"b_rank{r}"] = dict(
            ms_per_iteration=ms,
            collective_ms_per_iteration=coll / max(1, got.iterations) * 1e3,
            timed_ms_per_iteration=timed_ms,
            collective_share=coll / float(rk["solver_timed_wall_s"]),
            collectives=int(rk["solver_collectives"]),
            iterations=got.iterations, dx=dx,
            batch_s=float(rk["batch_wall_s"]),
            batch_bits_of_shares=bits, batch_max_dx_whole=bx,
            batch_status_differ_whole=bst, batch_gather_ms=float(
                rk["batch_collective_s"]) * 1e3,
            batch_k2_rows_launches=int(rk["batch_k2_rows_launches"]))
    return readings, k2


def main():
    if not os.path.isdir(os.path.join(HERE, "clarabel_tpu_torch")):
        fail("clarabel_tpu_torch/ is not beside chip_smoke.py: run it from "
             "a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, HERE)
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data
    from clarabel_tpu_torch import cuda_build
    from clarabel_tpu_torch.ipm import _cuda, megakernel, megakernel_ref
    from clarabel_tpu_torch.linalg import batched_ldl
    from clarabel_tpu_torch.statuscodes import SolverStatus

    if any(k == "jax" or k.startswith(("jax.", "clarabel_tpu."))
           or k == "clarabel_tpu" for k in sys.modules):
        fail("the port pulled in JAX or the JAX package")

    SOLVED = int(SolverStatus.SOLVED)
    INF = {int(SolverStatus.PRIMAL_INFEASIBLE),
           int(SolverStatus.DUAL_INFEASIBLE),
           int(SolverStatus.ALMOST_PRIMAL_INFEASIBLE),
           int(SolverStatus.ALMOST_DUAL_INFEASIBLE)}
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: device and toolchain, kernel build ----
    clock = PhaseClock()
    clock.start("[1]")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True)
    print(f"[1] card: {card}", flush=True)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"[1] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    nn_soc = [ctt.NonnegativeConeT(BENCH_N), ctt.SecondOrderConeT(BENCH_N + 1)]
    qp_cones = [ctt.ZeroConeT(1), ctt.NonnegativeConeT(BENCH_N + 1)]
    cases = {
        "bench": (nn_soc, True, bench_data.make_batch(4096, BENCH_N, 0)),
        "qp_eq": (qp_cones, True, bench_data.make_qp_eq(4096, BENCH_N, 1)),
        "infeasible": (nn_soc, True,
                       bench_data.make_infeasible_batch(4096, BENCH_N, 2)),
        "lp": (nn_soc, False, bench_data.make_lp_batch(4096, BENCH_N, 3)),
    }
    solvers = {name: ctt.BatchSolver(c, BENCH_N, ctt.Settings(),
                                     p_nonzero=pn)
               for name, (c, pn, _) in cases.items()}
    exp_cones = [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()]
    pow_cones = [ctt.NonnegativeConeT(2), ctt.PowerConeT(0.6)]
    exp_solver = ctt.BatchSolver(exp_cones, NONSYM_N, ctt.Settings())
    shapes = sorted({_cuda.shape_of(s._mega_fn.spec)
                     for s in solvers.values()})
    k1b_shape = _cuda.shape_of(exp_solver._mega_fn.spec)
    k1d_shapes = sorted({_cuda.shape_of(ctt.BatchSolver(
        [ctt.ZeroConeT(z), ctt.NonnegativeConeT(6 - z),
         ctt.PSDTriangleConeT(k)], 3)._mega_fn.spec)
        for z, k in ((0, 3), (0, 2), (1, 2))})
    k1c_shape = _cuda.shape_of(ctt.BatchSolver(
        [ctt.NonnegativeConeT(2), ctt.GenPowerConeT((0.3, 0.7), 2)],
        4)._mega_fn.spec)
    two = ctt.Settings(megakernel_two_phase=True)
    k1e_shapes = [_cuda.shape_of(ctt.BatchSolver(c, n, two)._mega_fn.spec)
                  for c, n in ((nn_soc, BENCH_N),
                               ([ctt.NonnegativeConeT(6),
                                 ctt.PSDTriangleConeT(3)], 3))]
    # the wrong group kernels: K1a's on the bench shape, K1b's on the exp
    # shape
    wrong_group = wrong_group_kernel()
    wrong_shapes = [_cuda.shape_of(solvers["bench"]._mega_fn.spec)]
    wrong_search = wrong_group_kernel("MK_WRONG_SEARCH")
    t0 = time.perf_counter()
    all_shapes = shapes + [k1b_shape] + k1d_shapes + [k1c_shape] + k1e_shapes
    # the libraries this run launches: a zero/nn/SOC or exp/pow shape takes
    # the group kernel or the one-lane-per-thread kernel by B; the bench
    # shapes run at every B of THROUGHPUT_BATCHES, the exp shape at every B
    # of NONSYM_THROUGHPUT, the other shapes at 4096
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bench_shapes = {_cuda.shape_of(solvers["bench"]._mega_fn.spec),
                    k1e_shapes[0]}
    k1b_variants = sorted({_cuda.variant_of(k1b_shape, B, sms)
                           for B in NONSYM_THROUGHPUT})
    variants = sorted({_cuda.variant_of(sh, B, sms) for sh in all_shapes
                       for B in (THROUGHPUT_BATCHES if sh in bench_shapes
                                 else (4096,))}
                      | {v for sh in shapes for v in _cuda.variants_of(sh)}
                      | set(k1b_variants))
    # K2: [5]'s N, [6]'s (the wide loop run: N = 79), the Solver's, and
    # the shared-memory kernel pinned beside them (the variant ())
    k2_variants = sorted({batched_ldl.kernel.variant(n + m)
                          for n, m in K2_SHAPES}
                         | {batched_ldl.kernel.variant(n + 2 * n + 1)
                            for _, _, n in LOOP_BATCHES}
                         | {batched_ldl.kernel.variant(SOLVER_N), ()})
    # precompile.warmup()'s libraries ([16]), in the same parallel build
    from clarabel_tpu_torch import precompile

    warm_requests = precompile.library_requests()
    variants = sorted(set(variants) | set(warm_requests[0][1]))
    k2_variants = sorted(set(k2_variants) | set(warm_requests[1][1]))
    cuda_build.build_together(
        (_cuda.megakernel, variants), (batched_ldl.kernel, k2_variants),
        (wrong_group, [sh + (1, 1) for sh in wrong_shapes]),
        (wrong_search, [k1b_shape + (1, 1)]
         if any(v[7] for v in k1b_variants) else []))
    print(f"[1] built K1a for {len(shapes)} shapes {shapes}, K1b for "
          f"{k1b_variants}, K1d for {k1d_shapes}, K1c for {k1c_shape}, K1e "
          f"for {k1e_shapes} (zero/nn/SOC shapes from both sources: "
          f"{[v for v in variants if not v[3] and _cuda.group_eligible(v)]})"
          f", K2 {k2_variants} ((N,): the rows design for that N; (): "
          f"ldl_inverse.cu), and the wrong group kernels in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)",
          flush=True)
    for lib in (_cuda.megakernel, batched_ldl.kernel):
        for variant, log in lib.build_logs.items():
            src = os.path.basename(lib.source_for(variant))
            print(f"[1] built {src} {variant} in "
                  f"{lib.build_seconds[variant]:.1f} s")
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "stack" in line:
                    print(f"[1] ptxas {src} {variant}: {line.strip()}")
    libs = ([(_cuda.source_for(v), _cuda.megakernel.lib_path(v), v)
             for v in variants]
            + [(os.path.basename(batched_ldl.kernel.source_for(v)),
                batched_ldl.kernel.lib_path(v), v) for v in k2_variants])
    # one cuobjdump for each library, all running together
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=8) as pool:
        counts = list(pool.map(sass_counts, [path for _, path, _ in libs]))
    for (src, path, v), c in zip(libs, counts):
        print(f"[1] sass {src} {v}: {c['instructions']} "
              f"instructions, {c['LDL']} local loads (LDL), {c['STL']} local "
              f"stores (STL), {c['LD']} and {c['ST']} generic (LD.E, ST.E)")

    # ---- phases 2-3: kernel vs plain version on the card ----
    clock.start("[2]-[3]")
    failures = []
    # K1a's two sources, each held to the bars on every batch: the main
    # path launches the group kernel at B = 4096 and one lane per thread
    # at 65536 and 131072
    k1a_kernels = {"megakernel_group.cu": pinned_kernel(1),
                   "megakernel.cu": pinned_kernel(0)}

    def check(name):
        cones, pn, (P, q, A, b) = cases[name]
        spec = solvers[name]._mega_fn.spec
        bars = BARS[name]
        if P is None:
            P = np.zeros((q.shape[0], BENCH_N, BENCH_N))
        B, flats = megakernel.prepare(P, q, A, b, spec, dev)
        p_ms, (pv, pi) = events_ms(
            lambda: megakernel_ref.mega_solve_plain(*flats, spec, B), 1)
        p = outputs(pv, pi, spec)
        # the plain version again with q moved by 1e-15 (relative): how far
        # rounding alone moves x and the iteration count on this batch
        qj = q * (1 + 1e-15 * np.random.default_rng(7).standard_normal(
            q.shape))
        _, flats_j = megakernel.prepare(P, qj, A, b, spec, dev)
        pj = outputs(*megakernel_ref.mega_solve_plain(*flats_j, spec, B),
                     spec)
        phase = f"[{2 if name == 'bench' else 3}] {name} B={B}"
        print(f"{phase}: plain {p_ms:.1f} ms; plain(q*(1+1e-15*xi)) vs "
              f"plain: {describe(readings(pj, p, P, qj, A, b))}", flush=True)
        print(f"{phase}: bars: x {bars['x']:.0e}, iters within 1 on "
              f"{bars['within1']} and within {bars['it_max']} on all, "
              f"objective {OBJ_TOL:.0e}, true KKT {KKT_TOL:.0e}, |s'z| "
              f"{SZ_TOL:.0e}, SOLVED at least plain less 0.1 % of B")
        out = {}
        for src, kern in k1a_kernels.items():
            tag = f"{phase} {src}"

            def bar(ok, msg):
                if not ok:
                    print(f"FAIL: {tag}: {msg}", flush=True)
                    failures.append(f"{tag}: {msg}")

            k_ms, (kv, ki) = events_ms(lambda: kern(*flats, spec, B), 3)
            k = outputs(kv, ki, spec)
            r = readings(k, p, P, q, A, b)
            print(f"{tag}: kernel {k_ms:.3f} ms; kernel statuses "
                  f"{np.bincount(k['status'], minlength=11).tolist()}",
                  flush=True)
            print(f"{tag}: kernel vs plain: {describe(r)}", flush=True)
            for v in violations(r, bars, B):
                bar(False, f"the kernel fails the {v} bar")
            bar(all(np.isfinite(k[f]).all() for f in ("x", "z", "s")),
                "non-finite x/z/s from the kernel")
            inf_lane = np.isin(k["status"], list(INF))
            bar((np.isnan(k["obj_val"]) == inf_lane).all(),
                "objective not NaN exactly on the infeasible lanes")
            if name == "infeasible":
                lanes = bench_data.infeasible_lanes(B)
                ok = np.isin(k["status"][lanes],
                             [int(SolverStatus.PRIMAL_INFEASIBLE),
                              int(SolverStatus.ALMOST_PRIMAL_INFEASIBLE)])
                bar(ok.all(), f"infeasible lanes not detected: "
                    f"{k['status'][lanes][~ok][:10]}")
                bar(np.delete(k["status"] == SOLVED, lanes).mean() >= 0.99,
                    "feasible lanes not solved")
            # the bars must tell a wrong kernel from this one
            for wname, change in WRONG_KERNELS.items():
                wspec = dataclasses.replace(spec,
                                            st=spec.st.replace(**change))
                w = outputs(*kern(*flats, wspec, B), spec)
                rw = readings(w, p, P, q, A, b)
                rejected = violations(rw, bars, B)
                print(f"{tag}: wrong kernel ({wname}) vs plain: "
                      f"{describe(rw)}; rejected by: "
                      f"{', '.join(rejected) or 'none'}", flush=True)
                bar(rejected, f"the bars pass the wrong kernel ({wname})")
            if (src == "megakernel_group.cu"
                    and _cuda.shape_of(spec) in wrong_shapes):
                # the group kernel without its last butterfly step
                w = outputs(*wrong_group(*flats, spec, B), spec)
                rw = readings(w, p, P, q, A, b)
                rejected = violations(rw, bars, B)
                print(f"{tag}: wrong group kernel (last butterfly step "
                      f"dropped) vs plain: {describe(rw)}; rejected by: "
                      f"{', '.join(rejected) or 'none'}", flush=True)
                bar(rejected, "the bars pass the wrong group kernel")
            out[src] = dict(ms=k_ms, plain_ms=p_ms,
                            max_abs_err=max(r["dx"], r["dobj"]),
                            iters=k["iterations"], spec=spec, B=B,
                            flats=flats)
        return out

    results = {name: check(name) for name in cases}

    # ---- phase 4: throughput through BatchSolver.solve ----
    clock.start("[4]")
    big = bench_data.make_batch(max(THROUGHPUT_BATCHES), BENCH_N, 0)
    bs = solvers["bench"]
    spec = bs._mega_fn.spec
    kernel_ms, n_chunks = {}, {}
    for B in THROUGHPUT_BATCHES:
        kernel_ms[B], n_chunks[B] = chunked_kernel_ms(
            tuple(a[:B] for a in big), spec)
    torch.cuda.synchronize()

    _cuda.megakernel.launches = 0          # the main path's run starts here
    _cuda.megakernel.group_launches = 0
    batched_ldl.kernel.launches = 0
    lines = []
    for B in THROUGHPUT_BATCHES:
        data = tuple(a[:B] for a in big)
        bs.solve(*data)                    # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = bs.solve(*data)
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        solved = int((out.status == SOLVED).sum())
        lines.append(
            f"[4] B={B}: {solved / wall:,.0f} solves/s wall (host arrays to "
            f"host results, best of 3: {wall * 1e3:.2f} ms), "
            f"{solved / (kernel_ms[B] / 1e3):,.0f} solves/s kernel-only "
            f"({kernel_ms[B]:.3f} ms, {n_chunks[B]} chunks); mean iters "
            f"{out.iterations.mean():.3f}; not SOLVED {B - solved}; "
            f"card {card}")
    launches = _cuda.megakernel.launches   # ... and ends here
    k1a_launches = {"megakernel_group.cu": _cuda.megakernel.group_launches}
    k1a_launches["megakernel.cu"] = launches - k1a_launches[
        "megakernel_group.cu"]
    k2_on_k1a_path = batched_ldl.kernel.launches
    for line in lines:
        print(line, flush=True)
    print(f"[4] megakernel launches on the main path: {launches}, of which "
          f"{k1a_launches['megakernel_group.cu']} megakernel_group.cu and "
          f"{k1a_launches['megakernel.cu']} megakernel.cu (K2: "
          f"{k2_on_k1a_path})")
    for src, n_launched in k1a_launches.items():
        if n_launched <= 0:
            fail(f"BatchSolver.solve did not launch {src} on the main path")
    print(f"[4] plain version on the card, bench B=4096: "
          f"{results['bench']['megakernel.cu']['plain_ms']:.1f} ms (no "
          f"yardstick); card {card}")

    # where one solve's wall time goes at the largest batch
    main_path_steps(4, "bench", tuple(a[:max(THROUGHPUT_BATCHES)]
                                      for a in big), spec, card)

    # bound: the larger of bytes over HBM bandwidth and FP64 operations of
    # this run's iterations over the FP64 rate (bench shape, B=4096), for
    # each of K1a's sources (their iteration counts may differ)
    k1a_bounds = {}
    for src, r in results["bench"].items():
        spec, B = r["spec"], r["B"]
        in_bytes = sum(t.numel() * 8 for t in r["flats"])
        out_bytes = B * (spec.outd * 8 + 3 * 4)
        passes = 0   # a lower bound: refinement passes taken would add work
        flops = int(r["iters"].sum()) * flops_per_iteration(
            spec.n, spec.m, spec.segs, passes)
        bytes_ms = (in_bytes + out_bytes) / HBM_RATE * 1e3
        ops_ms = flops / FP64_RATE * 1e3
        k1a_bounds[src] = (max(bytes_ms, ops_ms),
                           "operations" if ops_ms >= bytes_ms else "bytes")
        print(f"[4] bound of {src} at bench B={B}: {flops:.3e} FP64 ops -> "
              f"{ops_ms:.4f} ms, {in_bytes + out_bytes} bytes -> "
              f"{bytes_ms:.4f} ms")

    # ---- phases 5-7: K2, the loop solver and the rescue cascade ----
    clock.start("[5]")
    k2 = k2_phase(card, failures)
    clock.start("[6]")
    k2_launches = loop_phase(card, failures)
    print(f"[6] K2 launches on the loop paths by source: "
          f"{dict(sorted(k2_launches.items()))}", flush=True)
    for src in ("ldl_inverse_rows.cu", "ldl_inverse_rows_wide.cu"):
        if k2_launches[src] <= 0:
            failures.append(f"[6] the loop paths did not launch {src}")
    clock.start("[7]")
    rescue_phase(card, failures)

    # ---- phase 8: K1b (exponential and power cones) ----
    clock.start("[8]")
    # every K1b source the exp path launches (the group kernel up to
    # _cuda.NONSYM_GROUP_LANES_PER_SM lanes an SM, one lane per thread
    # above), each held to the bars
    k1b_kernels = {_cuda.source_for(v): pinned_kernel(v[7])
                   for v in k1b_variants}

    def check_nonsym(name, cones, data, st):
        """K1b against its plain version on one batch at NONSYM_B, for each
        of its sources; the plain version against itself under a 1e-15
        change of q; the wrong kernels, and on the group source the wrong
        group kernel (its searches take the last passing trial of a
        round)."""
        P, q, A, b = data
        spec = ctt.BatchSolver(cones, NONSYM_N, st)._mega_fn.spec
        bars = NONSYM_BARS[name]
        B, flats = megakernel.prepare(P, q, A, b, spec, dev)
        trips = {}
        p_ms, (pv, pi) = events_ms(
            lambda: megakernel_ref.mega_solve_plain(*flats, spec, B,
                                                    trips=trips), 1)
        p = outputs(pv, pi, spec)
        qj = q * (1 + 1e-15 * np.random.default_rng(7).standard_normal(
            q.shape))
        _, flats_j = megakernel.prepare(P, qj, A, b, spec, dev)
        pj = outputs(*megakernel_ref.mega_solve_plain(*flats_j, spec, B),
                     spec)
        phase = f"[8] {name} B={B}"
        print(f"{phase}: searches (plain version's trips): "
              f"{describe_searches(search_costs(trips))}", flush=True)
        print(f"{phase}: plain {p_ms:.1f} ms; plain(q*(1+1e-15*xi)) vs "
              f"plain: {describe(readings(pj, p, P, qj, A, b))}", flush=True)
        print(f"{phase}: bars: x {bars['x']:.1e}, iters within 1 on "
              f"{bars['within1']} and within {bars['it_max']} on all, "
              f"objective {OBJ_TOL:.0e}, true KKT {KKT_TOL:.0e}, |s'z| "
              f"{SZ_TOL:.0e}, SOLVED at least plain less 0.1 % of B",
              flush=True)
        out = {}
        for src, kern in k1b_kernels.items():
            tag = f"{phase} {src}"
            k_ms, (kv, ki) = events_ms(lambda: kern(*flats, spec, B), 3)
            k = outputs(kv, ki, spec)
            r = readings(k, p, P, q, A, b)
            dual_k, dual_p = int(ki[2].sum()), int(pi[2].sum())
            print(f"{tag}: kernel {k_ms:.3f} ms; kernel statuses "
                  f"{np.bincount(k['status'], minlength=11).tolist()}; lanes"
                  f" ending on the Dual strategy: kernel {dual_k}, plain "
                  f"{dual_p}; card {card}", flush=True)
            print(f"{tag}: kernel vs plain: {describe(r)}", flush=True)
            for v in violations(r, bars, B):
                failures.append(f"{tag}: the kernel fails the {v} bar")
            if not all(np.isfinite(k[f][k["status"] == SOLVED]).all()
                       for f in ("x", "z", "s")):
                failures.append(f"{tag}: non-finite x/z/s on SOLVED lanes")
            if name == "switch" and dual_k < B // 2:
                failures.append(f"{tag}: only {dual_k} lanes took the "
                                f"switch")
            wrong = {w: kern for w in WRONG_NONSYM}
            if src == "megakernel_group.cu":
                wrong["group searches take the last passing trial"] = \
                    wrong_search
            for wname, wkern in wrong.items():
                wspec = dataclasses.replace(
                    spec, st=spec.st.replace(**WRONG_NONSYM.get(wname, {})))
                w = outputs(*wkern(*flats, wspec, B), spec)
                rw = readings(w, p, P, q, A, b)
                rejected = violations(rw, bars, B)
                print(f"{tag}: wrong kernel ({wname}) vs plain: "
                      f"{describe(rw)}; rejected by: "
                      f"{', '.join(rejected) or 'none'}", flush=True)
                if not rejected:
                    failures.append(f"{tag}: the bars pass the wrong kernel "
                                    f"({wname})")
            out[src] = dict(ms=k_ms, plain_ms=p_ms, iters=k["iterations"],
                            max_abs_err=max(r["dx"], r["dobj"]), spec=spec,
                            B=B, flats=flats)
        return out

    mega_st = ctt.Settings(kkt_backend="megakernel")
    exp_big = bench_data.make_exp_batch(max(NONSYM_THROUGHPUT))
    exp_data = tuple(a[:NONSYM_B] for a in exp_big)
    nonsym = {
        "exp": check_nonsym("exp", exp_cones, exp_data, mega_st),
        "pow": check_nonsym("pow", pow_cones,
                            bench_data.make_pow_batch(NONSYM_B), mega_st),
        "switch": check_nonsym(
            "switch", exp_cones, exp_data,
            mega_st.replace(min_switch_step_length=SWITCH)),
    }

    # BatchSolver.solve on the exponential batch through the megakernel
    exp_spec = exp_solver._mega_fn.spec
    k1b_ms, k1b_chunks = {}, {}
    for B in NONSYM_THROUGHPUT:
        k1b_ms[B], k1b_chunks[B] = chunked_kernel_ms(
            tuple(a[:B] for a in exp_big), exp_spec)
    lines = []
    exp_out = {}
    _cuda.megakernel.launches = 0          # the exp path's run starts here
    _cuda.megakernel.group_launches = 0
    for B in NONSYM_THROUGHPUT:
        data = tuple(a[:B] for a in exp_big)
        exp_solver.solve(*data)            # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = exp_solver.solve(*data)
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        exp_out[B] = (out, wall)
        solved = int((out.status == SOLVED).sum())
        lines.append(
            f"[8] exp B={B}: {solved / wall:,.0f} solves/s wall (best of 3:"
            f" {wall * 1e3:.2f} ms), {solved / (k1b_ms[B] / 1e3):,.0f} "
            f"solves/s kernel-only ({k1b_ms[B]:.3f} ms, {k1b_chunks[B]} "
            f"chunks); mean iters "
            f"{out.iterations.mean():.3f}; not SOLVED {B - solved}, "
            f"statuses {np.bincount(out.status, minlength=11).tolist()}; "
            f"card {card}")
    k1b_launches = {"megakernel_group.cu":   # ... and ends here
                    _cuda.megakernel.group_launches}
    k1b_launches["megakernel.cu"] = (_cuda.megakernel.launches
                                     - k1b_launches["megakernel_group.cu"])
    for line in lines:
        print(line, flush=True)
    print(f"[8] megakernel launches on the exp path, by source: "
          f"{k1b_launches}", flush=True)
    for src in k1b_kernels:
        if k1b_launches[src] <= 0:
            failures.append(f"[8] BatchSolver.solve did not launch K1b's "
                            f"{src} on the exp path")
    # where one exp solve's wall time goes at the largest batch (as [4])
    main_path_steps(8, "exp", tuple(a[:max(NONSYM_THROUGHPUT)]
                                    for a in exp_big), exp_spec, card)
    out, _ = exp_out[NONSYM_B]
    P, q, A, b = exp_data
    rp, rd, sz = true_kkt(P, q, A, b, out.x, out.z, out.s)
    ok1 = out.status == SOLVED
    kkt = max(rp[ok1].max(initial=0.0), rd[ok1].max(initial=0.0))
    if kkt >= KKT_TOL:
        failures.append(f"[8] exp B={NONSYM_B}: true KKT {kkt:.3e}")

    # the condensed loop on the card, on the same batch
    loop_bs = ctt.BatchSolver(exp_cones, NONSYM_N,
                              ctt.Settings(kkt_backend="condensed"))
    loop_bs.solve(*(a[:256] for a in exp_data))
    lw, lo = synced_wall(lambda: loop_bs.solve(*exp_data))
    l_solved = int((lo.status == SOLVED).sum())
    k_solved = int(ok1.sum())
    print(f"[8] condensed loop exp B={NONSYM_B}: {lw * 1e3:.1f} ms wall, "
          f"SOLVED {l_solved} (the megakernel: {k_solved}), mean iters "
          f"{lo.iterations.mean():.3f}, statuses "
          f"{np.bincount(lo.status, minlength=11).tolist()}; card {card}",
          flush=True)

    # the rescue cascade behind the megakernel: on the exp batch, and on
    # the switch setting, which leaves lanes unsolved
    switch_st = ctt.Settings(min_switch_step_length=SWITCH)
    for name, st, sizes in (("exp", ctt.Settings(), RESCUE_B),
                            ("switch", switch_st, (NONSYM_B,))):
        plain_bs = ctt.BatchSolver(exp_cones, NONSYM_N, st)
        resc = ctt.BatchSolver(exp_cones, NONSYM_N, st, rescue="same")
        for B in sizes:
            data = tuple(a[:B] for a in exp_big)
            plain_bs.solve(*data)
            resc.solve(*data)
            w0, s0 = synced_wall(lambda: plain_bs.solve(*data))
            w1, s1 = synced_wall(lambda: resc.solve(*data))
            before = int((s0.status == SOLVED).sum())
            after = int((s1.status == SOLVED).sum())
            kept = s0.status == SOLVED
            print(f"[8] {name} rescue B={B}: megakernel alone "
                  f"{w0 * 1e3:.1f} ms wall, SOLVED {before}; with "
                  f"rescue='same' {w1 * 1e3:.1f} ms wall, SOLVED {after} "
                  f"({after - before} of {B - before} closed), statuses "
                  f"{np.bincount(s1.status, minlength=11).tolist()}; card "
                  f"{card}", flush=True)
            if after < before or not np.array_equal(s1.x[kept],
                                                    s0.x[kept]):
                failures.append(f"[8] {name} rescue B={B}: SOLVED lanes "
                                f"lost or changed")

    # K1b's bound, for each source: bytes and FP64 operations of this run's
    # exp batch (their iteration counts may differ)
    k1b_bounds = {}
    for src, rn in nonsym["exp"].items():
        ns_in = sum(t.numel() * 8 for t in rn["flats"])
        ns_out = rn["B"] * (rn["spec"].outd * 8 + 3 * 4)
        ns_flops = int(rn["iters"].sum()) * flops_per_iteration(
            rn["spec"].n, rn["spec"].m, rn["spec"].segs, 0)
        ns_bytes_ms = (ns_in + ns_out) / HBM_RATE * 1e3
        ns_ops_ms = ns_flops / FP64_RATE * 1e3
        k1b_bounds[src] = (max(ns_bytes_ms, ns_ops_ms),
                           "operations" if ns_ops_ms >= ns_bytes_ms
                           else "bytes")
        print(f"[8] K1b bound of {src} at exp B={rn['B']}: {ns_flops:.3e} "
              f"FP64 ops -> {ns_ops_ms:.4f} ms, {ns_in + ns_out} bytes -> "
              f"{ns_bytes_ms:.4f} ms", flush=True)

    # ---- phases 9-10: K1d (PSD cones) and K1c (generalized power cones)
    def psd_min_eig(spec, s):
        """(B,) least eigenvalue over the PSD segments of slacks s (B, m)
        (+inf without one)."""
        out = np.full(s.shape[0], np.inf)
        for kind, lo, hi in spec.segs:
            if kind != "psd":
                continue
            k = {1: 1, 3: 2, 6: 3}[hi - lo]
            M = np.zeros((s.shape[0], k, k))
            p = lo
            for c in range(k):
                for r_ in range(c + 1):
                    v = s[:, p] / (1.0 if r_ == c else np.sqrt(2.0))
                    M[:, r_, c] = M[:, c, r_] = v
                    p += 1
            out = np.minimum(out, np.linalg.eigvalsh(M)[:, 0])
        return out

    def check_family(phase, name, cones, n, data, bars, wrong,
                     seeds=JITTER_SEEDS[:1]):
        """K1c or K1d against its plain version on one batch, the plain
        version against itself under 1e-15 changes of q (one for each seed
        of `seeds`, with the bars each would fail, printed and not held),
        and the wrong kernels (a change of the spec, such as the Jacobi
        sweep cap, or of the settings)."""
        P, q, A, b = data
        spec = ctt.BatchSolver(cones, n, mega_st)._mega_fn.spec
        B, flats = megakernel.prepare(P, q, A, b, spec, dev)
        k_ms, (kv, ki) = events_ms(
            lambda: _cuda.megakernel(*flats, spec, B), 3)
        trips = {}
        p_ms, (pv, pi) = events_ms(
            lambda: megakernel_ref.mega_solve_plain(*flats, spec, B,
                                                    trips=trips), 1)
        k, p = outputs(kv, ki, spec), outputs(pv, pi, spec)
        tag = f"[{phase}] {name} B={B}"
        if spec.nonsym:
            print(f"{tag}: searches (plain version's trips): "
                  f"{describe_searches(search_costs(trips))}", flush=True)
        r = readings(k, p, P, q, A, b)
        counts = np.bincount(k["status"], minlength=11).tolist()
        pcounts = np.bincount(p["status"], minlength=11).tolist()
        dual_k, dual_p = int(ki[2].sum()), int(pi[2].sum())
        eig = psd_min_eig(spec, k["s"])[k["status"] == SOLVED]
        print(f"{tag}: kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms; statuses "
              f"kernel {counts}, plain {pcounts} (ALMOST {counts[4]} vs "
              f"{pcounts[4]}, MAX_ITERATIONS {counts[7]} vs {pcounts[7]});"
              f" mean iters {k['iterations'].mean():.3f}; lanes ending on "
              f"the Dual strategy: kernel {dual_k}, plain {dual_p}; least "
              f"PSD slack eigenvalue of the SOLVED lanes "
              f"{eig.min(initial=np.inf):.3e}; card {card}", flush=True)
        print(f"{tag}: kernel vs plain: {describe(r)}", flush=True)
        for js in seeds:
            qj = q * (1 + 1e-15 * np.random.default_rng(js).standard_normal(
                q.shape))
            _, flats_j = megakernel.prepare(P, qj, A, b, spec, dev)
            rj = readings(outputs(*megakernel_ref.mega_solve_plain(
                *flats_j, spec, B), spec), p, P, qj, A, b)
            del flats_j
            print(f"{tag}: plain(q*(1+1e-15*xi), seed {js}) vs plain: "
                  f"{describe(rj)}; would fail: "
                  f"{', '.join(violations(rj, bars, B)) or 'none'} (printed,"
                  f" not held)", flush=True)
        print(f"{tag}: bars: x {bars['x']:.1e}, iters within 1 on "
              f"{bars['within1']} and within {bars['it_max']} on all, "
              f"objective {OBJ_TOL:.0e}, true KKT "
              f"{bars.get('kkt', KKT_TOL):.0e}, |s'z| {SZ_TOL:.0e}, PSD "
              f"slack eigenvalue above -{EIG_TOL:.0e}, SOLVED at least "
              f"plain less 0.1 % of B", flush=True)
        for v in violations(r, bars, B):
            failures.append(f"{tag}: the kernel fails the {v} bar")
        if not all(np.isfinite(k[f][k["status"] == SOLVED]).all()
                   for f in ("x", "z", "s")):
            failures.append(f"{tag}: non-finite x/z/s on SOLVED lanes")
        if not (eig > -EIG_TOL).all():
            failures.append(f"{tag}: a PSD slack leaves the cone")
        if spec.has("genpow") and (dual_k != B or dual_p != B):
            failures.append(f"{tag}: lanes off the Dual strategy")
        for wname, change in wrong.items():
            spec_change = {f: v for f, v in change.items()
                           if f in ("psd_sweeps",)}
            st_change = {f: v for f, v in change.items()
                         if f not in spec_change}
            wspec = dataclasses.replace(spec, st=spec.st.replace(**st_change),
                                        **spec_change)
            w = outputs(*_cuda.megakernel(*flats, wspec, B), spec)
            rw = readings(w, p, P, q, A, b)
            rejected = violations(rw, bars, B)
            print(f"{tag}: wrong kernel ({wname}) vs plain: {describe(rw)};"
                  f" rejected by: {', '.join(rejected) or 'none'}",
                  flush=True)
            if not rejected:
                failures.append(f"{tag}: the bars pass the wrong kernel "
                                f"({wname})")
        return dict(ms=k_ms, plain_ms=p_ms, iters=k["iterations"],
                    max_abs_err=max(r["dx"], r["dobj"]), spec=spec, B=B,
                    flats=flats)

    def family_main_path(phase, name, cones, n, big, sizes, kkt_tol,
                         rescue_sizes):
        """BatchSolver.solve on `big`'s first B lanes for each B: kernel-only
        and wall certified solves/s, statuses, the launch count of this run,
        and where one solve's time goes at the largest B; then the
        condensed loop at the smallest B and the rescue behind the kernel
        at `rescue_sizes`."""
        solver = ctt.BatchSolver(cones, n)
        spec = solver._mega_fn.spec
        k_ms, k_chunks = {}, {}
        for B in sizes:
            k_ms[B], k_chunks[B] = chunked_kernel_ms(
                tuple(a[:B] for a in big), spec)
        lines, outs = [], {}
        _cuda.megakernel.launches = 0      # this path's run starts here
        for B in sizes:
            data = tuple(a[:B] for a in big)
            solver.solve(*data)            # warm-up
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = solver.solve(*data)
                walls.append(time.perf_counter() - t0)
            wall = min(walls)
            outs[B] = out
            counts = np.bincount(out.status, minlength=11).tolist()
            solved = counts[SOLVED]
            lines.append(
                f"[{phase}] {name} B={B}: {solved / wall:,.0f} certified "
                f"solves/s wall (best of 3: {wall * 1e3:.2f} ms), "
                f"{solved / (k_ms[B] / 1e3):,.0f} kernel-only "
                f"({k_ms[B]:.3f} ms, {k_chunks[B]} chunks); SOLVED {solved}, ALMOST {counts[4]}, "
                f"MAX_ITERATIONS {counts[7]}, statuses {counts}; mean iters "
                f"{out.iterations.mean():.3f}; card {card}")
        launches = _cuda.megakernel.launches   # ... and ends here
        for line in lines:
            print(line, flush=True)
        print(f"[{phase}] megakernel launches on the {name} path: "
              f"{launches}", flush=True)
        if launches <= 0:
            failures.append(f"[{phase}] BatchSolver.solve did not launch "
                            f"the {name} kernel")
        main_path_steps(phase, name, tuple(a[:max(sizes)] for a in big),
                        spec, card)
        B0 = min(sizes)
        out = outs[B0]
        P, q, A, b = (a[:B0] for a in big)
        rp, rd, sz = true_kkt(P, q, A, b, out.x, out.z, out.s)
        ok1 = out.status == SOLVED
        kkt = max(rp[ok1].max(initial=0.0), rd[ok1].max(initial=0.0))
        if kkt >= kkt_tol:
            failures.append(f"[{phase}] {name} B={B0}: true KKT {kkt:.3e}")
        # the condensed loop on the card, on the same batch
        loop_bs = ctt.BatchSolver(cones, n,
                                  ctt.Settings(kkt_backend="condensed"))
        data = tuple(a[:B0] for a in big)
        loop_bs.solve(*(a[:256] for a in data))
        lw, lo = synced_wall(lambda: loop_bs.solve(*data))
        lc = np.bincount(lo.status, minlength=11).tolist()
        print(f"[{phase}] condensed loop {name} B={B0}: {lw * 1e3:.1f} ms "
              f"wall, SOLVED {lc[SOLVED]} (the megakernel: {int(ok1.sum())})"
              f", ALMOST {lc[4]}, MAX_ITERATIONS {lc[7]}, mean iters "
              f"{lo.iterations.mean():.3f}, statuses {lc}; card {card}",
              flush=True)
        # the rescue cascade behind the megakernel
        resc = ctt.BatchSolver(cones, n, rescue="same")
        for B in rescue_sizes:
            data = tuple(a[:B] for a in big)
            resc.solve(*data)
            w0, s0 = synced_wall(lambda: solver.solve(*data))
            w1, s1 = synced_wall(lambda: resc.solve(*data))
            before = int((s0.status == SOLVED).sum())
            after = int((s1.status == SOLVED).sum())
            kept = s0.status == SOLVED
            print(f"[{phase}] {name} rescue B={B}: megakernel alone "
                  f"{w0 * 1e3:.1f} ms wall, SOLVED {before}; with "
                  f"rescue='same' {w1 * 1e3:.1f} ms wall, SOLVED {after} "
                  f"({after - before} of {B - before} closed), statuses "
                  f"{np.bincount(s1.status, minlength=11).tolist()}; card "
                  f"{card}", flush=True)
            if after < before or not np.array_equal(s1.x[kept],
                                                    s0.x[kept]):
                failures.append(f"[{phase}] {name} rescue B={B}: SOLVED "
                                f"lanes lost or changed")
        return launches

    def family_bound(res):
        """(bound ms, bound_by) of one batch's kernel run: its bytes over
        HBM bandwidth against the FP64 operations of its iterations."""
        fin = sum(t.numel() * 8 for t in res["flats"])
        fout = res["B"] * (res["spec"].outd * 8 + 3 * 4)
        flops = int(res["iters"].sum()) * flops_per_iteration(
            res["spec"].n, res["spec"].m, res["spec"].segs, 0)
        b_ms = (fin + fout) / HBM_RATE * 1e3
        o_ms = flops / FP64_RATE * 1e3
        print(f"[{res['phase']}] bound at {res['name']} B={res['B']}: "
              f"{flops:.3e} FP64 ops -> {o_ms:.4f} ms, {fin + fout} bytes "
              f"-> {b_ms:.4f} ms", flush=True)
        return max(b_ms, o_ms), ("operations" if o_ms >= b_ms else "bytes")

    clock.start("[9]")
    psd3_cones = [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)]
    psd_big = bench_data.make_sdp_batch(max(FAMILY_THROUGHPUT), 3, 13)
    psd = {}
    for name, cones, data in (
            ("psd3", psd3_cones, tuple(a[:FAMILY_B] for a in psd_big)),
            ("psd2", [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(2)],
             bench_data.make_sdp_batch(FAMILY_B, 2, 12)),
            ("psd_zero", [ctt.ZeroConeT(1), ctt.NonnegativeConeT(5),
                          ctt.PSDTriangleConeT(2)],
             bench_data.make_sdp_zero_batch(FAMILY_B))):
        wrong = dict(WRONG_PSD, **(WRONG_PSD3 if name == "psd3" else {}))
        psd[name] = check_family(
            9, name, cones, 3, data, PSD_BARS[name], wrong,
            JITTER_SEEDS if name == "psd3" else JITTER_SEEDS[:1])
    k1d_launches = family_main_path(
        9, "psd3", psd3_cones, 3, psd_big, FAMILY_THROUGHPUT,
        PSD_BARS["psd3"]["kkt"], (FAMILY_B, max(FAMILY_THROUGHPUT)))
    k1d_bound = family_bound(dict(psd["psd3"], phase=9, name="psd3"))

    clock.start("[10]")
    gp_cones = [ctt.NonnegativeConeT(2), ctt.GenPowerConeT((0.3, 0.7), 2)]
    gp_big = bench_data.make_genpow_batch(max(FAMILY_THROUGHPUT))
    gp = check_family(10, "genpow", gp_cones, 4,
                      tuple(a[:FAMILY_B] for a in gp_big),
                      GENPOW_BARS["genpow"], WRONG_GENPOW)
    # the rescue at 4096 only: at 131072 the kernel leaves 26 lanes
    # INSUFFICIENT_PROGRESS, which the loop stages run to their iteration
    # limit, about 130 s on the card (PERF.md)
    k1c_launches = family_main_path(10, "genpow", gp_cones, 4, gp_big,
                                    FAMILY_THROUGHPUT, KKT_TOL, (FAMILY_B,))
    k1c_bound = family_bound(dict(gp, phase=10, name="genpow"))

    # ---- phase 11: K1e (the float32 first phase) ----
    clock.start("[11]")
    k1e = two_phase_phase(card, failures, big, psd_big, cases["qp_eq"][2],
                          exp_data)

    # ---- phase 12: the main path's host side, one dispatch and chunks ----
    clock.start("[12]")
    chunked = chunk_phase(card, failures, {
        "bench": (nn_soc, BENCH_N, BARS["bench"], big),
        "psd3": (psd3_cones, 3, PSD_BARS["psd3"], psd_big),
        "exp": (exp_cones, NONSYM_N, NONSYM_BARS["exp"], exp_big)})
    print(f"[12] launches of the chunked runs, by source: {chunked}",
          flush=True)

    # ---- phase 13: the single-instance Solver ----
    clock.start("[13]")
    solver_k2 = solver_phase(card, failures)
    print(f"[13] K2 launches of the Solver under mixed precision: "
          f"{solver_k2}", flush=True)

    # ---- phase 14: the Solver's sparse and structured KKT ----
    clock.start("[14]")
    sparse, grid, sparse_solutions = sparse_phase(card, failures)
    print(f"[14] readings: {json.dumps(sparse)}", flush=True)

    # ---- phase 15: long solves ----
    clock.start("[15]")
    long_readings = long_phase(card, failures, grid)
    del grid
    print(f"[15] readings: {json.dumps(long_readings)}", flush=True)

    # ---- phase 16: the BASELINE runner, the command line, warmup ----
    clock.start("[16]")
    baseline = baseline_phase(card, failures)
    print(f"[16] readings: {json.dumps(baseline)}", flush=True)

    # ---- phase 17: multi-device ----
    clock.start("[17]")
    multi, multi_k2 = multidevice_phase(
        card, failures, sparse_solutions["rls2000"],
        sparse["rls2000"]["ms_per_iteration"])
    k2_launches["ldl_inverse_rows.cu"] += multi_k2
    print(f"[17] readings: {json.dumps(multi)}", flush=True)
    # every module of the port (and the runner) is imported by now
    import clarabel_tpu_torch.__main__  # noqa: F401
    import clarabel_tpu_torch.interop.cvxpy_interface  # noqa: F401
    import clarabel_tpu_torch.io.cbf  # noqa: F401
    import clarabel_tpu_torch.parallel.schur  # noqa: F401
    import clarabel_tpu_torch.protocols  # noqa: F401
    if any(k == "jax" or k.startswith(("jax.", "clarabel_tpu."))
           or k == "clarabel_tpu" for k in sys.modules):
        failures.append("the port pulled in JAX or the JAX package")

    clock.start(None)
    if failures:
        fail("; ".join(failures))
    # K2's rows design: its one-warp source at N = 19, its wide source at
    # N = 79, the library [6]'s wide run launches (and N = 80 beside it)
    k2_main, k2_wide, k2_widest = (k2[n + m] for n, m in K2_SHAPES)
    # K1a, one entry per source: launches from the main path's run; ms,
    # the plain version's ms and the bound at bench B = 4096; max_abs_err
    # over the batches of [2]-[3]
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"clarabel_tpu_torch/csrc/{src}",
        "replaces": "clarabel_tpu/ipm/megakernel.py:3523",
        "launches": k1a_launches[src],
        "max_abs_err": max(v[src]["max_abs_err"] for v in results.values()),
        "ms": results["bench"][src]["ms"],
        "plain_ms": results["bench"][src]["plain_ms"],
        "bound_ms": k1a_bounds[src][0],
        "bound_by": k1a_bounds[src][1],
        # no PyTorch call computes the IPM
        "library_ms": None,
    } for name, src in (("megakernel_group", "megakernel_group.cu"),
                        ("megakernel", "megakernel.cu"))] + [{
        # K2's rows design, one entry per source: ms, the plain version's
        # and the bound at [5]'s B and the N whose library the main paths
        # of [6] and [17] launch (19; 79), launches from those runs; the
        # wide entry also gives [5]'s readings at N = 80
        "name": name,
        "n": r["n"],
        "route": "cuda",
        "source": f"clarabel_tpu_torch/csrc/{r['source']}",
        "replaces": "clarabel_tpu/linalg/pallas_ldl.py:99",
        "launches": k2_launches[r["source"]],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        # torch.linalg.ldl_factor pivots (Bunch-Kaufman) and has no
        # sign-aware regularization: no PyTorch call computes this function
        "library_ms": None,
        **extra,
    } for name, r, extra in (
        ("ldl_inverse", k2_main, {}),
        ("ldl_inverse_wide", k2_wide, {"at_n80": {
            k: k2_widest[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "max_abs_err")}}))] + [{
        # K1b, one entry per source the exp path launches: ms, the plain
        # version's ms and the bound at exp B = 4096; max_abs_err over exp,
        # pow and switch
        "name": ("megakernel_nonsym_group" if src == "megakernel_group.cu"
                 else "megakernel_nonsym"),
        "route": "cuda",
        "source": f"clarabel_tpu_torch/csrc/{src}",
        "replaces": "clarabel_tpu/ipm/megakernel.py:3523",
        "launches": k1b_launches[src],
        "max_abs_err": max(v[src]["max_abs_err"] for v in nonsym.values()),
        "ms": nonsym["exp"][src]["ms"],
        "plain_ms": nonsym["exp"][src]["plain_ms"],
        "bound_ms": k1b_bounds[src][0],
        "bound_by": k1b_bounds[src][1],
        "library_ms": None,
    } for src in k1b_kernels] + [{
        "name": "megakernel_psd",
        "route": "cuda",
        "source": "clarabel_tpu_torch/csrc/megakernel.cu",
        "replaces": "clarabel_tpu/ipm/megakernel.py:3523",
        "launches": k1d_launches,
        "max_abs_err": max(v["max_abs_err"] for v in psd.values()),
        "ms": psd["psd3"]["ms"],
        "plain_ms": psd["psd3"]["plain_ms"],
        "bound_ms": k1d_bound[0],
        "bound_by": k1d_bound[1],
        # no PyTorch call computes the IPM
        "library_ms": None,
    }, {
        "name": "megakernel_genpow",
        "route": "cuda",
        "source": "clarabel_tpu_torch/csrc/megakernel.cu",
        "replaces": "clarabel_tpu/ipm/megakernel.py:3523",
        "launches": k1c_launches,
        "max_abs_err": gp["max_abs_err"],
        "ms": gp["ms"],
        "plain_ms": gp["plain_ms"],
        "bound_ms": k1c_bound[0],
        "bound_by": k1c_bound[1],
        # no PyTorch call computes the IPM
        "library_ms": None,
    }, {
        "name": "megakernel_two_phase",
        "route": "cuda",
        "source": "clarabel_tpu_torch/csrc/megakernel.cu",
        "replaces": "clarabel_tpu/ipm/megakernel.py:3523",
        "launches": k1e["launches"],
        "max_abs_err": k1e["max_abs_err"],
        "ms": k1e["ms"],
        "plain_ms": k1e["plain_ms"],
        "bound_ms": k1e["bound_ms"],
        "bound_by": k1e["bound_by"],
        # no PyTorch call computes the IPM
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
