"""One run of one cell: set-up, a measured window, the readings, the check.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The harness is driven by data.  `BENCHMARK.json` names each cell's
configuration and traffic mix and lists the metrics; everything that
belongs to one of them sits in a file of its own under `portbench/`:

* `configs/<config>.json`: the problem family's sizes and cones, its
  generator (`generators/<name>.py`) and its plain reference
  (`references/<name>.py`, which solves the family again and measures how
  far an answer lies outside its cones);
* `traffic/<traffic>.json`: lanes a call, the accuracy tier (a `Settings`
  preset and overrides), the rescue, the pool of distinct batches, the
  warm-up calls and the lanes of each call that the check samples;
* `workloads/<cell>.json`: the limits of the comparison that decides
  `correct`, with the readings they were set from;
* `metrics/<metric>.py`: a `read(run)` that returns the metric's value
  from the run's record, or None where it finds nothing to read.

A new cell, configuration or metric is new files (and its entries in
`BENCHMARK.json`); this file stays as it is.

What a run does.  Set-up, timed from the start of the process: import the
program (`clarabel_tpu_torch`, the system under test; nothing of the JAX
package), draw the pool of distinct batches from `--seed`, build the
`BatchSolver`, and make the warm-up calls, which build or load every
kernel the cell's shape needs.  The window: one caller in a closed loop
calls `BatchSolver.solve` on host numpy batches, cycling through the pool,
until `--seconds` have passed; the window ends with the call that ends
after that, so it holds whole calls and all their time.  With `--trace 1`
`torch.profiler` records the window (portbench/trace.py) and the run
reports the per-layer metrics; with `--trace 0` the end-to-end ones.
After the window: the peak device memory, the program's state freed, then
the reference solves the sampled lanes again and the judge
(portbench/judge.py) compares.  The last lines of standard error give each
compared number beside its limit; the last line of standard output is the
result as one JSON object.
"""

import argparse
import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import judge

PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "clarabel_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclasses.dataclass
class Run:
    """What the readers in `metrics/` read."""
    cell: Cell
    setup_s: float
    window_s: float
    walls: List[float]          # every call's seconds, host arrays in to out
    lanes: int                  # lanes of all the window's calls
    solved: int
    iterations: int             # summed over every lane of every call
    device: object = None       # trace.DeviceRecord of a traced card run


def load_part(root, kind, name):
    """`portbench/<kind>/<name>.py` under `root`, loaded by its path."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


def _named(entries, name, what):
    hits = [e for e in entries if e["name"] == name]
    if len(hits) != 1:
        raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")
    return hits[0]


def load_cell(root, name) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    wl = _named(bench["workloads"], name, "workload")
    cfg = _named(bench["configs"], wl["config"], "config")

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]

    return Cell(
        name=name, chips=int(wl["chips"]),
        config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(root, "portbench", "traffic",
                                   wl["traffic"] + ".json")),
        limits=_json(os.path.join(root, "portbench", "workloads",
                                  name + ".json"))["limits"],
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]))


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """Stream `stream` of `seed` (any whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % 2 ** 64, stream]))


def make_pool(root, cell: Cell, seed: int, device):
    """The pool of distinct batches, each (P, q, A, b) on the host, drawn
    on `device` from `seed` by the configuration's generator."""
    gen = load_part(root, "generators", cell.config["generator"])
    return gen.make_pool(cell.traffic["batch"], cell.config["n"],
                         cell.traffic["pool"], seed, device)


def program_cones(ctt, cones):
    """The configuration's cones as the program's cone objects (every kind
    the program takes, so that a configuration of another family is a
    data file)."""
    kinds = {"zero": ctt.ZeroConeT, "nn": ctt.NonnegativeConeT,
             "soc": ctt.SecondOrderConeT, "exp": ctt.ExponentialConeT,
             "pow": ctt.PowerConeT, "psd": ctt.PSDTriangleConeT,
             "genpow": ctt.GenPowerConeT}
    return [kinds[c[0]](*c[1:]) for c in cones]


def program_settings(ctt, traffic):
    presets = {"default": ctt.Settings, "throughput": ctt.Settings.throughput}
    return presets[traffic["settings"]](**traffic.get("settings_overrides",
                                                      {}))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metrics(root, run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = load_part(root, "metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root=ROOT, device=None, t_process=None,
         wrap_solve: Optional[Callable] = None) -> int:
    """Run one cell once and print its result; returns the exit code.
    `device=None` asks for the card and fails without one; the tests pass
    "cpu" (the program's plain versions) and may wrap the solver's `solve`
    (`wrap_solve(solve) -> solve`) to plant a fault under the window."""
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse_args(argv)
    cell = load_cell(root, args.workload)

    import torch
    if device is None:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if seen < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s); torch sees {seen}", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    import clarabel_tpu_torch as ctt
    from . import trace

    cfg, tr = cell.config, cell.traffic
    pool = make_pool(root, cell, args.seed, dev)
    solver = ctt.BatchSolver(program_cones(ctt, cfg["cones"]), cfg["n"],
                             program_settings(ctt, tr), rescue=tr["rescue"],
                             device=dev)
    solve = solver.solve if wrap_solve is None else wrap_solve(solver.solve)
    for i in range(tr["warmup_calls"]):
        solve(*pool[i % len(pool)])
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    SOLVED = int(ctt.SolverStatus.SOLVED)
    wrong_codes = [int(getattr(ctt.SolverStatus, s)) for s in
                   judge.INFEASIBLE]
    sample_rng = seed_rng(args.seed, 1 << 20)
    B, S = tr["batch"], tr["sample_lanes"]
    walls, samples = [], []
    per_batch = [[] for _ in pool]      # (wall, most iterations) a call
    lanes = solved = iterations = wrong = 0
    not_solved = collections.Counter()     # status code: lanes
    tracer = trace.Tracer(dev) if args.trace else None
    span = (torch.profiler.record_function if tracer
            else (lambda name: contextlib.nullcontext()))
    if tracer:
        tracer.start()
    t_start = time.perf_counter()
    while True:
        k = len(walls) % len(pool)
        t0 = time.perf_counter()
        with span(trace.CALL_SPAN):
            sol = solve(*pool[k])
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        status = np.asarray(sol.status)
        lanes += len(status)
        ok = status == SOLVED
        solved += int(np.count_nonzero(ok))
        not_solved.update(status[~ok].tolist())
        wrong += int(np.isin(status, wrong_codes).sum())
        its = np.asarray(sol.iterations)
        iterations += int(its.sum())
        per_batch[k].append((t1 - t0, int(its.max())))
        pick = sample_rng.integers(0, B, S)
        samples.append(judge.Sample(k, pick, np.array(sol.x[pick]),
                                    status[pick] == SOLVED))
        if t1 - t_start >= args.seconds:
            break
    window_s = time.perf_counter() - t_start
    record = tracer.stop() if tracer else None

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    del sol, solver, solve
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    run = Run(cell=cell, setup_s=setup_s, window_s=window_s, walls=walls,
              lanes=lanes, solved=solved, iterations=iterations,
              device=record if on_card else None)
    metrics = read_metrics(root, run, cell.per_layer if args.trace
                           else cell.end_to_end)

    ref = load_part(root, "references", cfg["reference"])
    cones = [tuple(c) for c in cfg["cones"]]
    optima = judge.reference_solve(ref.solve, pool,
                                   judge.wanted_lanes(samples), cones, dev,
                                   "float64", tr["reference_block"])
    readings = judge.readings(pool, samples, optima, ref, cones,
                              wrong)
    correct, checks = judge.verdict(readings, cell.limits)

    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)} after the "
              f"window; no result", file=sys.stderr)
        return 3

    device_out = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": cell.chips if on_card else 0,
                  "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": lanes,
              "failed": lanes - solved, "metrics": metrics,
              "device": device_out}
    if run.device is not None:
        device_out["busy_s"] = record.busy_s
        device_out["window_s"] = record.window_s
        result["breakdown"] = {
            "device_ops": record.top_device_ops(),
            "idle_gaps": [[n, s] for n, s in record.idle_by_host[:10]]}
    result["checks"] = checks
    print("lanes not SOLVED, by status: " + (", ".join(
        f"{ctt.SolverStatus(code).name} {count}"
        for code, count in sorted(not_solved.items())) or "none"),
        file=sys.stderr)
    for k, calls in enumerate(per_batch):
        if calls:
            w, it = np.array(calls).T
            print(f"pool batch {k}: {len(calls)} calls, wall ms median "
                  f"{np.median(w) * 1e3:.2f} (min {w.min() * 1e3:.2f}, max "
                  f"{w.max() * 1e3:.2f}), most iterations of a lane "
                  f"{int(it.min())}-{int(it.max())}", file=sys.stderr)
    if record is not None:
        print(f"trace: {record.calls} calls, {len(record.kernels)} kernel "
              f"names, {len(record.copies)} copy names; device events not "
              f"counted as work: {record.skipped}", file=sys.stderr)
    for name, c in checks.items():
        bound = (f"limit {c['limit']!r}" if "limit" in c
                 else f"at least {c['least']!r}")
        print(f"check {name}: {c['value']!r} {bound}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0

