#!/usr/bin/env python3
"""Per-lane trip counts of the megakernel's backtracking searches, from its
plain PyTorch version on the CPU (no card needed).

    python3 tools/search_trips.py [genpow] [--B 4096] [--slice]

Runs `ipm/megakernel_ref.mega_solve_plain` on the generalized-power-cone
batch of chip_smoke.py phase [10] (`bench_data.make_genpow_batch`; with
--slice the first B lanes of its 131072-lane batch, as chip_smoke.py takes
them, else a batch of B drawn anew) and prints, for the joint feasibility
backtracks and the barrier backtracks: the number of searches, the
evaluations, the histogram of trips per lane and search, the sum over
warps of each search's largest trip count (what a warp pays when each lane
runs its own loop), the rounds of K1c's cooperative search
(`megakernel_ref.warp_costs`) and the evaluations over 32 (what a warp
would pay with the trips spread evenly); and the histogram of the genpow
barrier's Newton trips per evaluation.

    python3 tools/search_trips.py loops [--B 4096]

Counts the trips of the loop solver's inner loops (`trips.run_trips`:
iterative refinement, the one-sided Newton solves, the feasibility and
barrier backtracks) on the CPU, on the first B lanes of chip_smoke.py's
loop batches: `Settings.throughput()` on bench and the condensed loop on
exp, psd3 and genpow.  For each loop it prints the histogram of the trips
each call takes (the loop that checks after every trip), and for a check
every k trips (k = 1, 2, 4, 8) the host checks and the trips run.  Imports
no JAX.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import clarabel_tpu_torch as ctt  # noqa: E402
from clarabel_tpu_torch import bench_data  # noqa: E402
from clarabel_tpu_torch.ipm import megakernel, megakernel_ref  # noqa: E402


def hist(a):
    return {int(k): int(v) for k, v in enumerate(np.bincount(a)) if v and k}


def loop_trips(B):
    """The inner loops' trips per call on the loop paths (module docstring)."""
    from clarabel_tpu_torch.cones import nonsymmetric
    from clarabel_tpu_torch.ipm import loop
    from clarabel_tpu_torch.kkt import refine

    calls = []

    def counting(module):
        def run(trip, state, finished, cap):
            t = 0
            while (cap is None or t < cap) and not bool(finished(state)):
                state = trip(state)
                t += 1
            kind = {"refine": "refinement", "loop": "barrier backtrack"}.get(
                module, "newton" if cap == 100 else "feasibility backtrack")
            calls.append((kind, t, cap))
            return state
        return run

    for mod, name in ((refine, "refine"), (nonsymmetric, "nonsymmetric"),
                      (loop, "loop")):
        mod.run_trips = counting(name)
    paths = {
        "throughput bench": (
            [ctt.NonnegativeConeT(6), ctt.SecondOrderConeT(7)], 6,
            ctt.Settings.throughput(), bench_data.make_batch(65536, 6, 0)),
        "condensed exp": (
            [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()], 3,
            ctt.Settings(kkt_backend="condensed"),
            bench_data.make_exp_batch(131072)),
        "condensed psd3": (
            [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3,
            ctt.Settings(kkt_backend="condensed"),
            bench_data.make_sdp_batch(131072, 3, 13)),
        "condensed genpow": (
            [ctt.NonnegativeConeT(2), ctt.GenPowerConeT((0.3, 0.7), 2)], 4,
            ctt.Settings(kkt_backend="condensed"),
            bench_data.make_genpow_batch(131072)),
    }
    for name, (cones, n, st, big) in paths.items():
        calls.clear()
        t0 = time.perf_counter()
        sol = ctt.BatchSolver(cones, n, st, device="cpu").solve(
            *(a[:B] for a in big))
        print(f"{name} B={B}: CPU {time.perf_counter() - t0:.1f} s, mean "
              f"iterations {sol.iterations.mean():.3f}, statuses "
              f"{np.bincount(sol.status, minlength=11).tolist()}")
        for kind in ("refinement", "newton", "feasibility backtrack",
                     "barrier backtrack"):
            got = [(t, cap) for k, t, cap in calls if k == kind]
            if not got:
                continue
            T = np.array([t for t, _ in got])
            cost = []
            for k in (1, 2, 4, 8):
                checks = runs = 0
                for t, cap in got:
                    chunks = -(-t // k)
                    checks += 1 + chunks
                    runs += chunks * k if cap is None else min(cap,
                                                               chunks * k)
                cost.append(f"k={k}: {checks} checks, {runs} trips")
            print(f"  {kind}: {len(got)} calls, {int(T.sum())} trips, "
                  f"trips per call {hist_all(T)}; " + "; ".join(cost))


def hist_all(a):
    return {int(k): int(v) for k, v in enumerate(np.bincount(a)) if v}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="genpow",
                    choices=("genpow", "loops"))
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--slice", action="store_true")
    args = ap.parse_args()
    if args.mode == "loops":
        loop_trips(args.B)
        return
    cones = [ctt.NonnegativeConeT(2), ctt.GenPowerConeT((0.3, 0.7), 2)]
    spec = ctt.BatchSolver(cones, 4, ctt.Settings(kkt_backend="megakernel"),
                           device="cpu")._mega_fn.spec
    data = (tuple(a[:args.B] for a in bench_data.make_genpow_batch(131072))
            if args.slice else bench_data.make_genpow_batch(args.B))
    B, flats = megakernel.prepare(*data, spec, "cpu")
    trips = {}
    t0 = time.perf_counter()
    _, ints = megakernel_ref.mega_solve_plain(*flats, spec, B, trips=trips)
    print(f"genpow B={B} ({'first lanes of 131072' if args.slice else 'drawn anew'}"
          f"), plain version on the CPU in {time.perf_counter() - t0:.1f} s;"
          f" iterations mean {float(ints[1].float().mean()):.3f}, max "
          f"{int(ints[1].max())}")
    for kind in ("feas", "barrier"):
        T = torch.stack(trips[kind]).numpy()
        serial = rounds = 0
        for t in trips[kind]:
            s, r = megakernel_ref.warp_costs(t)
            serial += s
            rounds += r
        print(f"{kind}: {T.shape[0]} searches, {int(T.sum())} evaluations, "
              f"trips per lane and search {hist(T[T > 0].ravel())}; sum over "
              f"warps of the largest trips {serial}, cooperative rounds "
              f"{rounds} ({rounds / serial:.3f}), evaluations / 32 "
              f"{T.sum() / 32:.1f}")
    N = torch.stack(trips["newton"]).numpy()
    print(f"newton: {int((N > 0).sum())} barrier evaluations, trips per "
          f"evaluation mean {N[N > 0].mean():.3f}, {hist(N[N > 0].ravel())}")


if __name__ == "__main__":
    main()
