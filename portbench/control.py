#!/usr/bin/env python3
"""The control of `correct`: the reference in the program's place, one
precision down, judged as a run judges the program.

    python3 portbench/control.py --workload socp_n6.b131072 \\
        --seeds 101,102,103 --calls 400

For each seed it draws the cell's pool and the lanes a run with that seed
samples over `--calls` calls (the same draws as `harness.main`), solves
them with the configuration's reference in the precision just below the
one the cell states (traffic file's `precision`: float64 -> float32,
float32 -> TF32, float32 with every product's inputs rounded to 10
mantissa bits), takes those answers as the program's, SOLVED on every
lane, and prints the judge's readings beside the cell's limits.  The
control has to come out not correct on every seed.

Prints one JSON line a seed; exits 1 where a control came out correct.
On the card; `portbench/tests/test_pb_control.py` calls
`control_readings` on the CPU at a small size.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, judge  # noqa: E402

LOWER = {"float64": "float32", "float32": "tf32"}


def control_readings(root, cell, seed, calls, device, mode):
    """The judge's readings of the reference's `mode` answers on the lanes
    a run of `calls` calls with `seed` would sample."""
    pool = harness.make_pool(root, cell, seed, device)
    tr, cfg = cell.traffic, cell.config
    rng = harness.seed_rng(seed, 1 << 20)
    B, S = tr["batch"], tr["sample_lanes"]
    picks = [(i % len(pool), rng.integers(0, B, S)) for i in range(calls)]
    ref = harness.load_part(root, "references", cfg["reference"])
    cones = [tuple(c) for c in cfg["cones"]]
    want = judge.wanted_lanes([judge.Sample(k, p, None, np.ones(S, bool))
                               for k, p in picks])
    block = tr["reference_block"]
    optima = judge.reference_solve(ref.solve, pool, want, cones, device,
                                   "float64", block)
    answers = judge.reference_solve(ref.solve, pool, want, cones, device,
                                    mode, block)
    samples = []
    for k, p in picks:
        lanes, x = answers[k][0], answers[k][1]
        samples.append(judge.Sample(k, p, x[np.searchsorted(lanes, p)],
                                    np.ones(S, bool)))
    return judge.readings(pool, samples, optima, ref, cones, 0)


def main(argv=None, root=ROOT):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, required=True,
                    help="calls whose sampled lanes are judged, as many "
                         "as a run of the cell makes")
    args = ap.parse_args(argv)
    cell = harness.load_cell(root, args.workload)
    mode = LOWER[cell.traffic["precision"]]
    device = torch.device("cuda")
    came_out_correct = False
    for seed in (int(s) for s in args.seeds.split(",")):
        read = control_readings(root, cell, seed, args.calls, device, mode)
        correct, checks = judge.verdict(read, cell.limits)
        came_out_correct |= correct
        print(json.dumps({"workload": cell.name, "seed": seed, "mode": mode,
                          "correct": correct, "checks": checks}),
              flush=True)
    return 1 if came_out_correct else 0


if __name__ == "__main__":
    sys.exit(main())
