#!/usr/bin/env python3
"""Phase [17] of chip_smoke.py alone: multi-device on one card, (a) a
world of one rank over NCCL and (b) two ranks on cuda:0 over gloo, held to
rls2000's unsharded solve (solved here first, as [14] solves it) and to
the reference's outputs in tests/torch_fixtures/sparse.npz.  Builds only
K2's library for the bench shape (N = 19), which the dp batch launches.

    python3 tools/multidevice_probe.py [--out readings.json]

Exits non-zero when a bar of [17] is not met.

    python3 tools/multidevice_probe.py --spread

Measures instead how a lane's bits depend on the batch it is solved in,
unsharded, on the bench batch at 4096 lanes under Settings.throughput()
and the float64 ldl and condensed loops: each half and the first quarter
solved alone against the same lanes of the whole batch (lanes whose x
differs, max |dx|, statuses and iterations changed), a permuted batch,
and the first half solved twice over as one 4096-lane batch.  Imports no
JAX.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def spread(card):
    """Per-lane bits against the batch a lane is solved in (see above)."""
    import numpy as np

    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data

    n = chip_smoke.BENCH_N
    cones = [ctt.NonnegativeConeT(n), ctt.SecondOrderConeT(n + 1)]
    B = chip_smoke.MULTI_B
    P, q, A, b = bench_data.make_batch(B, n, 0)
    perm = np.random.default_rng(0).permutation(B)
    twice = np.concatenate([np.arange(B // 2)] * 2)
    out = {}
    for name, st in (("throughput", ctt.Settings.throughput()),
                     ("float64 ldl", ctt.Settings(kkt_backend="ldl")),
                     ("float64 condensed",
                      ctt.Settings(kkt_backend="condensed"))):
        bs = ctt.BatchSolver(cones, n, st)
        whole = bs.solve(P, q, A, b)
        rows = {}
        for lo, hi in ((0, B // 2), (B // 2, B), (0, B // 4)):
            part = bs.solve(P[lo:hi], q[lo:hi], A[lo:hi], b[lo:hi])
            dx = np.abs(part.x - whole.x[lo:hi])
            rows[f"[{lo},{hi})"] = dict(
                lanes_differing=int((dx.max(axis=1) > 0).sum()),
                max_dx=float(dx.max()),
                statuses_changed=int(
                    (part.status != whole.status[lo:hi]).sum()),
                iterations_changed=int(
                    (part.iterations != whole.iterations[lo:hi]).sum()))
        pm = bs.solve(P[perm], q[perm], A[perm], b[perm])
        rows["permuted_bits_equal"] = bool(
            np.array_equal(pm.x[np.argsort(perm)], whole.x))
        tw = bs.solve(P[twice], q[twice], A[twice], b[twice])
        rows["half_twice_bits_equal"] = bool(
            np.array_equal(tw.x[:B // 2], whole.x[:B // 2])
            and np.array_equal(tw.x[B // 2:], whole.x[:B // 2]))
        print(f"{name}, B={B}: {json.dumps(rows)}; card {card}",
              flush=True)
        out[name] = rows
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--spread", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("this probe needs a card")
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch.linalg import batched_ldl

    card = chip_smoke.card_line()
    n = chip_smoke.BENCH_N
    batched_ldl.kernel.build([batched_ldl.kernel.variant(n + 2 * n + 1)])
    if args.spread:
        readings = spread(card)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"card": card, "spread": readings}, f, indent=1)
        return
    P, q, A, b, cones, st = chip_smoke.sparse_problem("rls2000")
    solver = ctt.Solver(P, q, A, b, cones, st)
    solver.solve()
    t0 = time.perf_counter()
    ref = solver.solve()
    ms = (time.perf_counter() - t0) / max(1, ref.iterations) * 1e3
    print(f"rls2000 unsharded: {ref.status.name} in {ref.iterations} "
          f"iterations, {ms:.2f} ms per IPM iteration; card {card}",
          flush=True)
    del solver
    failures = []
    t0 = time.perf_counter()
    readings, k2 = chip_smoke.multidevice_phase(card, failures, ref, ms)
    print(f"[17] took {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(readings))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "readings": readings, "k2": k2,
                       "failures": failures}, f, indent=1)
    if failures:
        print("FAIL: " + "; ".join(failures))
        sys.exit(1)


if __name__ == "__main__":
    main()
