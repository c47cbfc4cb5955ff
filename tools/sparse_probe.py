#!/usr/bin/env python3
"""Phase [14] of chip_smoke.py alone: the `Solver`'s sparse and structured
KKT on the card at full size (grid60, banded2500, rls2000), held to the
reference's outputs in tests/torch_fixtures/sparse.npz, with its readings
(setup split, cold and warm solve, ms per IPM iteration, factorizations).
No kernel is built: this path launches none.

    python3 tools/sparse_probe.py [--cases grid60,banded2500,rls2000]
                                  [--out readings.json]

Exits non-zero when a bar of [14] is not met.  With --device cpu it runs
the same cases on the CPU (float64 fronts there, so grid60's dtype check
fails by design).

    python3 tools/sparse_probe.py --profile [--cases ...]

Profiles one warm solve of each case on the card instead
(`torch.profiler`, CUDA activity): the wall, the kernels' summed device
time and the card's idle share over the solve, the kernel launches, and
the kernels that take the most device time.

    python3 tools/sparse_probe.py --graphs [--turns 2] [--cases ...]

Times warm solves of each case with the IPM pass replayed as a CUDA graph
(the loop's default for these layouts) and run eagerly (the loop built
with no cone kind in `ipm/loop.GRAPH_KINDS`), in turns (eager, graph,
graph, eager, ...), with the statuses, iterations and whether x has the
same bits.  Imports no JAX.
"""

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def profile_case(name, card, top=8):
    """One warm solve of a [14] case under torch.profiler: wall ms, the
    kernels' summed device ms, the idle share, launches, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import clarabel_tpu_torch as ctt

    P, q, A, b, cones, st = chip_smoke.sparse_problem(name)
    solver = ctt.Solver(P, q, A, b, cones, st, device="cuda")
    solver.solve()
    iters = solver.solve().iterations
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    r = dict(wall_ms=wall, device_ms=busy, idle_share=1.0 - busy / wall,
             launches=launches, iterations=iters,
             launches_per_iteration=launches / max(1, iters),
             top=[[k[:90], round(v, 3)] for k, v in by_name.most_common(top)])
    print(f"[14] {name} profiled: wall {wall:.1f} ms, kernels {busy:.1f} ms "
          f"of device time, idle share {r['idle_share']:.3f}, {launches} "
          f"launches ({r['launches_per_iteration']:.0f} per IPM iteration); "
          f"card {card}", flush=True)
    for k, v in r["top"]:
        print(f"    {v:9.3f} ms  {k}")
    return r


def graphs_case(name, card, turns):
    """Warm solves of a [14] case, graphed and eager, in turns: wall ms
    of each (the solve ends in one fetch from the card)."""
    import torch

    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import api
    from clarabel_tpu_torch.ipm import loop

    P, q, A, b, cones, st = chip_smoke.sparse_problem(name)
    solvers = {}
    kinds = loop.GRAPH_KINDS
    for mode in ("graph", "eager"):
        api._SOLVE_CACHE.clear()
        loop.GRAPH_KINDS = kinds if mode == "graph" else frozenset()
        try:
            solvers[mode] = ctt.Solver(P, q, A, b, cones, st, device="cuda")
        finally:
            loop.GRAPH_KINDS = kinds
    api._SOLVE_CACHE.clear()
    sols = {mode: s.solve() for mode, s in solvers.items()}
    times = {"graph": [], "eager": []}
    for t in range(turns):
        order = ("eager", "graph") if t % 2 == 0 else ("graph", "eager")
        for mode in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sols[mode] = solvers[mode].solve()
            times[mode].append((time.perf_counter() - t0) * 1e3)
    g, e = sols["graph"], sols["eager"]
    r = dict(graph_ms=times["graph"], eager_ms=times["eager"],
             status=[g.status.name, e.status.name],
             iterations=[g.iterations, e.iterations],
             x_bits_equal=bool((g.x == e.x).all()))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"[14] {name} graphed against eager: median warm solve "
          f"{med['graph']:.1f} ms against {med['eager']:.1f} ms "
          f"({med['graph'] / g.iterations:.2f} against "
          f"{med['eager'] / e.iterations:.2f} ms per IPM iteration); "
          f"{r['status']}, {r['iterations']} iterations, x bits equal "
          f"{r['x_bits_equal']}; card {card}", flush=True)
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(chip_smoke.SPARSE_CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--graphs", action="store_true")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    chip_smoke.SPARSE_CASES = tuple(args.cases.split(","))
    chip_smoke.DEVICE = args.device
    card = chip_smoke.card_line() if args.device == "cuda" else "cpu"
    failures = []
    if args.profile:
        readings = {name: profile_case(name, card)
                    for name in chip_smoke.SPARSE_CASES}
    elif args.graphs:
        readings = {name: graphs_case(name, card, args.turns)
                    for name in chip_smoke.SPARSE_CASES}
    else:
        readings = chip_smoke.sparse_phase(card, failures)[0]
    print(json.dumps(readings))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "readings": readings,
                       "failures": failures}, f, indent=1)
    if failures:
        print("FAIL: " + "; ".join(failures))
        sys.exit(1)


if __name__ == "__main__":
    main()
