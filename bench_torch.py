#!/usr/bin/env python3
"""Benchmark of the PyTorch / CUDA port: batched small-conic throughput.

The sibling of `bench.py` for `clarabel_tpu_torch`.  It solves the same
batches, drawn from the same seeds (`clarabel_tpu_torch/bench_data.py`:
`make_batch` is a copy of `bench.py:75-85`), with the megakernel
(`BatchSolver(cones, n, Settings(kkt_backend="megakernel"),
rescue="cpu")`) at the 1e-8 tolerances, and counts SOLVED lanes only:

* the bench shape (n=6, cones [NN(6), SOC(7)]) at --batch, --batch-mid,
  --batch-big and --batch-xl lanes, best of --repeats warm solves each;
* the equality-constrained QP (zero + nonnegative cones), the
  exponential-cone, the small-SDP (side 3) and the generalized-power-cone
  batches at --batch lanes, best of 2 warm solves (no rescue on the exp,
  psd and genpow batches, as in `bench.py`).

Wall times run from host numpy arrays to host results; numbers are not
rounded.  On a card it also
times the kernels alone with CUDA events on the bench batch at each size,
in the chunks the solve cuts (kernel-only solves/s) and reports the card's name and power limit from
`nvidia-smi`.  There is no `vs_baseline`: `bench.py`'s is against TPU and
CPU figures, which are no yardstick for the card.

    python3 bench_torch.py                    # on the card
    python3 bench_torch.py --device cpu --batch 16 --batch-mid 0 \\
        --batch-big 0 --batch-xl 0 --repeats 1  # the plain versions

Prints one JSON line with `bench.py`'s keys (`metric`, `value`, `unit`,
`batch`, `solved`, `wall_s`, `mean_iters`, `b_scaling`, and one entry per
batch family) and `kernel_solves_per_sec`, `kernel_ms`, `card`, `device`.
It imports neither JAX nor the JAX package.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N = 6   # variables per instance of the bench shape


def card_line():
    """`nvidia-smi`'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: the card)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--batch-mid", type=int, default=16384)
    ap.add_argument("--batch-big", type=int, default=65536)
    ap.add_argument("--batch-xl", type=int, default=131072)
    ap.add_argument("--repeats", type=int, default=3,
                    help="warm solves per bench size (best taken)")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import torch

    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data
    from clarabel_tpu_torch.ipm import megakernel
    from clarabel_tpu_torch.parallel.batch_impl import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    SOLVED = int(ctt.SolverStatus.SOLVED)
    ALMOST = int(ctt.SolverStatus.ALMOST_SOLVED)
    settings = ctt.Settings(kkt_backend="megakernel")

    def timed(bs, data, repeats):
        """Best of `repeats` warm solves (one warm-up first)."""
        bs.solve(*data)
        best = None
        for _ in range(repeats):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = bs.solve(*data)
            dt = time.perf_counter() - t0
            solved = int(np.sum(out.status == SOLVED))
            r = {
                "batch": len(data[1]),
                "solves_per_sec": solved / dt,
                "solved": solved,
                "almost": int(np.sum(out.status == ALMOST)),
                "wall_s": dt,
                "mean_iters": float(np.mean(out.iterations)),
            }
            if best is None or r["solves_per_sec"] > best["solves_per_sec"]:
                best = r
        return best

    def kernel_ms(bs, data):
        """CUDA-event ms of the kernels alone of one solve as
        `BatchSolver.solve` runs it: the batch staged on the card in the
        chunks of the rule (`megakernel.staged_chunks`), then every
        chunk's launch timed, mean of 3 after a warm-up; the launches are
        queued behind a sleep on the stream so that the host's pace is not
        timed."""
        spec = bs._mega_fn.spec
        chunks = list(megakernel.staged_chunks(*data, spec, device))

        def run():
            return [megakernel.solve_flats(*cf, spec, hi - lo)
                    for lo, hi, cf, _ in chunks]

        run()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        e0.record()
        for _ in range(3):
            outs = run()
        e1.record()
        torch.cuda.synchronize()
        solved = sum(int((ints[0] == SOLVED).sum()) for _, ints in outs)
        return e0.elapsed_time(e1) / 3, solved, len(chunks)

    cones = [ctt.NonnegativeConeT(N), ctt.SecondOrderConeT(N + 1)]
    bs = ctt.BatchSolver(cones, N, settings, rescue="cpu", device=device)
    sizes = [B for B in (args.batch, args.batch_mid, args.batch_big,
                         args.batch_xl) if B > 0]
    big = bench_data.make_batch(max(sizes), N, 0)
    results, best = {}, None
    for B in sizes:
        data = tuple(a[:B] for a in big)
        r = timed(bs, data, args.repeats)
        if on_card:
            ms, ksolved, r["kernel_chunks"] = kernel_ms(bs, data)
            r["kernel_ms"] = ms
            r["kernel_solves_per_sec"] = ksolved / ms * 1e3
        results[str(B)] = r
        if best is None or r["solves_per_sec"] > best["solves_per_sec"]:
            best = r

    Bf = args.batch
    family_runs = {
        "qp_eq_zero_cone": ([ctt.ZeroConeT(1), ctt.NonnegativeConeT(N + 1)],
                            N, bench_data.make_qp_eq(Bf, N, 1), "cpu"),
        "exp_cone_batched": ([ctt.NonnegativeConeT(2), ctt.ExponentialConeT()],
                             3, bench_data.make_exp_batch(Bf), None),
        "psd_cone_batched": ([ctt.NonnegativeConeT(6),
                              ctt.PSDTriangleConeT(3)], 3,
                             bench_data.make_sdp_batch(Bf, 3, 13), None),
        "genpow_cone_batched": ([ctt.NonnegativeConeT(2),
                                 ctt.GenPowerConeT((0.3, 0.7), 2)], 4,
                                bench_data.make_genpow_batch(Bf), None),
    }
    families = {}
    for key, (fcones, n, data, rescue) in family_runs.items():
        fs = ctt.BatchSolver(fcones, n, settings, rescue=rescue,
                             device=device)
        families[key] = timed(fs, data, min(2, args.repeats))

    headline = results[str(args.batch)]
    print(json.dumps({
        "metric": f"batched_socp_throughput_n{N}",
        "value": best["solves_per_sec"],
        "unit": "solves/s (1e-8 tol)",
        "batch": best["batch"],
        "solved": best["solved"],
        "wall_s": best["wall_s"],
        "mean_iters": best["mean_iters"],
        "b_scaling": results,
        **families,
        "kernel_solves_per_sec": headline.get("kernel_solves_per_sec"),
        "kernel_ms": headline.get("kernel_ms"),
        "device": (torch.cuda.get_device_name(device) if on_card
                   else "cpu"),
        "card": card_line() if on_card else None,
    }))


if __name__ == "__main__":
    main()
