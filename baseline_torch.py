#!/usr/bin/env python3
"""The BASELINE.md configurations through the PyTorch / CUDA port.

The sibling of `benchmarks/run_all.py` for `clarabel_tpu_torch`: the same
rows, drawn by the port's copies of the generators in
`benchmarks/configs.py` (`clarabel_tpu_torch/bench_data.py`), at the same
scale (`--quick`: a quarter), and the same timing: each single-instance
row is one `Solver` set up once, solved once (the first solve) and then
best of 3 warm solves; the batched row is `BatchSolver` on
`batched_socp(4096, 6)`, solved once and then best of 3 warm solves.

* the four Maros–Mészáros-style files `benchmarks/data/*_style.qps`,
  read through the port's `load_qps` (read only: this runner never writes
  them);
* the Markowitz QP (200 assets), the CVXQP-style QP (n = 200), the
  AUG2DC-style QP (grid 10), the robust least-squares SOCP (m = 2000,
  n = 500, dense) and the max-cut SDP (60 nodes, chordally decomposed);
* batched SOCPs at B = 4096 (the megakernel on a card).

    python3 baseline_torch.py                  # on the card
    python3 baseline_torch.py --device cpu --quick

It prints the reference runner's line for each row, then the card's name
and power limit (`nvidia-smi`, as `bench_torch.py` prints them), and as
its last line one JSON object: per row its status, iterations and best
warm solve ms, and on the batched row its SOLVED count and solves/s.
It imports neither JAX nor the JAX package.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, "benchmarks", "data")
QPS_FILES = ("AUG2DC_style.qps", "CVXQP1_style.qps", "CVXQP2_style.qps",
             "CVXQP3_style.qps")
BATCH_N = 6


def single_rows(scale=1.0):
    """[(key, row name, generator)] of the single-instance rows, in the
    reference runner's order; a generator returns (P, q, A, b, cones)."""
    from clarabel_tpu_torch import bench_data
    from clarabel_tpu_torch.io.qps import load_qps

    rows = []
    for fname in QPS_FILES:
        def gen(path=os.path.join(DATA_DIR, fname)):
            p = load_qps(path)
            return p.P.toarray(), p.q, p.A.toarray(), p.b, p.cones

        rows.append((fname.split("_")[0].lower(),
                     f"qps {fname.replace('_style.qps', '-style')}", gen))
    rows += [
        ("markowitz", "markowitz QP (200)", lambda: bench_data.markowitz_qp(
            n_assets=int(200 * scale) or 50)),
        ("cvxqp", "cvxqp-style sparse QP", lambda: bench_data.cvxqp_style(
            n=int(200 * scale) or 50)),
        ("aug2d", "aug2d-style QP", lambda: bench_data.aug2d_style(
            grid=int(10 * scale) or 5)),
        ("robust_ls", "robust LS SOCP",
         lambda: bench_data.robust_least_squares_socp(
             m=int(2000 * scale), n=int(500 * scale))),
        ("maxcut", "max-cut SDP (chordal)", lambda: bench_data.maxcut_sdp(
            nv=int(60 * scale) or 20)),
    ]
    return rows


def run_single(name, gen, device, settings=None, repeats=3):
    """Set up one row's Solver, solve it once, then time `repeats` warm
    solves; prints the reference runner's line.  Returns (the last
    solution, the best warm seconds, the problem)."""
    import clarabel_tpu_torch as ctt

    problem = gen()
    P, q, A, b, cones = problem
    solver = ctt.Solver(P, q, A, b, cones, settings or ctt.Settings(),
                        device=device)
    sol = solver.solve()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        sol = solver.solve()
        times.append(time.perf_counter() - t0)
    t = min(times)
    print(f"{name:28s} status={sol.status.name:9s} iters={sol.iterations:3d} "
          f"obj={sol.obj_val: .6e} rp={sol.r_prim:.1e} rd={sol.r_dual:.1e} "
          f"time={t * 1e3:8.1f}ms", flush=True)
    return sol, t, problem


def run_batched(B, device, settings=None, repeats=3):
    """`BatchSolver` on `batched_socp(B, 6)`: one solve, then best of
    `repeats` warm solves; prints the reference runner's line.  Returns
    (the last solution, the best warm seconds, the batch, the solver)."""
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data
    from clarabel_tpu_torch.statuscodes import SolverStatus

    (P, q, A, b), cones = bench_data.batched_socp(B=B, n=BATCH_N)
    bs = ctt.BatchSolver(cones, BATCH_N, settings or ctt.Settings(),
                         device=device)
    out = bs.solve(P, q, A, b)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = bs.solve(P, q, A, b)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    ns = int(np.sum(out.status == int(SolverStatus.SOLVED)))
    print(f"{'batched SOCP B=' + str(B):28s} solved={ns}/{B} "
          f"iters(mean)={out.iterations.mean():.1f} "
          f"rp(max)={out.r_prim.max():.1e} time={dt * 1e3:8.1f}ms "
          f"-> {ns / dt:8.0f} solves/s", flush=True)
    return out, dt, (P, q, A, b), bs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="a quarter of the scale, as run_all.py --quick")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: the card)")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row keys (default: every row); "
                         "'batched' is the batched row")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import torch

    from bench_torch import card_line
    from clarabel_tpu_torch.parallel.batch_impl import resolve_device

    device = resolve_device(args.device)
    scale = 0.25 if args.quick else 1.0
    wanted = None if args.rows is None else set(args.rows.split(","))
    rows = {}
    for key, name, gen in single_rows(scale):
        if wanted is None or key in wanted:
            sol, t, _ = run_single(name, gen, device)
            rows[key] = {"status": sol.status.name,
                         "iterations": sol.iterations, "ms": t * 1e3}
    if wanted is None or "batched" in wanted:
        B = int(4096 * scale)
        out, dt, _, _ = run_batched(B, device)
        ns = int(np.sum(out.status == 1))
        rows["batched"] = {"status": f"SOLVED {ns}/{B}",
                           "iterations": float(out.iterations.mean()),
                           "ms": dt * 1e3, "solves_per_s": ns / dt}
    on_card = device.type == "cuda"
    card = card_line() if on_card else None
    print(card if card else "card: none (cpu)")
    print(json.dumps({
        "rows": rows, "scale": scale,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "card": card}))


if __name__ == "__main__":
    main()
