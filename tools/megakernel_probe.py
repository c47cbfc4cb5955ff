#!/usr/bin/env python3
"""Timing probes of the CUDA megakernel (K1a-K1e) on one NVIDIA card.

Two modes, each run from the root of a checkout on a machine with a card:

    python3 tools/megakernel_probe.py sweep [--src DIR] [--parts P] [--only RE]
    python3 tools/megakernel_probe.py compare --parent DIR [--only RE]
    (either with --out FILE.json)

`sweep` measures one tree's kernel (`DIR/clarabel_tpu_torch/csrc/
megakernel.cu`, this checkout by default) with its launch opened up: the
source is copied with the launch's block size and the kernel's L1/shared
carveout made settable (nothing else changes), built with nvcc for every
shape below, and timed with CUDA events:

* every K1 library at B = 4096 with blocks of 32, 64 and 128 threads;
* K1d (psd3) and K1a (bench) at B = 4096 ... 131072, with the carveout
  at CUDA's default and with cudaFuncAttributePreferredSharedMemoryCarveout
  set to 0 (the most L1);
* K1c (genpow) at B = 4096 and 131072 with linesearch_max_iter 50 (the
  default) and 0 (no barrier backtrack: a timing probe only, the statuses
  differ).

`compare` builds the megakernel of this checkout and of the tree at DIR
(for example a `git archive` of the parent commit) for the same shapes,
runs each on the batches of chip_smoke.py phases [2]-[4] and [8]-[11] at
B = 4096 and 131072 in turns (parent, change, change, parent), and checks
that statuses, iteration counts, strategies, phase-1 counts and every
output value are equal lane for lane.  It fails when they are not.

Both print one line per reading, with the card's name and power limit,
and with --out write the readings to a JSON file.  Neither imports JAX or
the JAX package.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import clarabel_tpu_torch as ctt  # noqa: E402
from clarabel_tpu_torch import bench_data, cuda_build  # noqa: E402
from clarabel_tpu_torch.ipm import _cuda, megakernel  # noqa: E402

SIZES = (4096, 8192, 16384, 32768, 65536, 131072)
ENDS = (4096, 131072)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cases():
    """name -> (cones, n, settings, p_nonzero, batch maker(B)); the shapes
    and batches of chip_smoke.py.  Where chip_smoke.py takes the first B
    lanes of its largest batch, so does `batch`."""
    nn_soc = [ctt.NonnegativeConeT(6), ctt.SecondOrderConeT(7)]
    exp = [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()]
    psd3 = [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)]
    st, two = ctt.Settings(), ctt.Settings(megakernel_two_phase=True)
    return {
        "K1a bench": (nn_soc, 6, st, True,
                      lambda B: bench_data.make_batch(B, 6, 0)),
        "K1a qp_eq": ([ctt.ZeroConeT(1), ctt.NonnegativeConeT(7)], 6, st,
                      True, lambda B: bench_data.make_qp_eq(B, 6, 1)),
        "K1a infeasible": (nn_soc, 6, st, True,
                           lambda B: bench_data.make_infeasible_batch(B, 6,
                                                                      2)),
        "K1a lp": (nn_soc, 6, st, False,
                   lambda B: bench_data.make_lp_batch(B, 6, 3)),
        "K1b exp": (exp, 3, st, True, bench_data.make_exp_batch),
        "K1b pow": ([ctt.NonnegativeConeT(2), ctt.PowerConeT(0.6)], 3, st,
                    True, bench_data.make_pow_batch),
        "K1b switch": (exp, 3, st.replace(min_switch_step_length=0.9), True,
                       bench_data.make_exp_batch),
        "K1d psd3": (psd3, 3, st, True,
                     lambda B: bench_data.make_sdp_batch(B, 3, 13)),
        "K1d psd2": ([ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(2)], 3,
                     st, True, lambda B: bench_data.make_sdp_batch(B, 2, 12)),
        "K1d psd_zero": ([ctt.ZeroConeT(1), ctt.NonnegativeConeT(5),
                          ctt.PSDTriangleConeT(2)], 3, st, True,
                         bench_data.make_sdp_zero_batch),
        "K1c genpow": ([ctt.NonnegativeConeT(2),
                        ctt.GenPowerConeT((0.3, 0.7), 2)], 4, st, True,
                       bench_data.make_genpow_batch),
        "K1e bench": (nn_soc, 6, two, True,
                      lambda B: bench_data.make_batch(B, 6, 0)),
        "K1e infeasible": (nn_soc, 6, two, True,
                           lambda B: bench_data.make_infeasible_batch(B, 6,
                                                                      2)),
        "K1e lp": (nn_soc, 6, two, False,
                   lambda B: bench_data.make_lp_batch(B, 6, 3)),
        "K1e psd3": (psd3, 3, two, True,
                     lambda B: bench_data.make_sdp_batch(B, 3, 13)),
    }


def spec_of(case):
    cones, n, st, pn, _ = case
    return megakernel.make_spec(ctt.BatchSolver(
        cones, n, st.replace(kkt_backend="megakernel"),
        device="cpu").layout, st, n, pn)


SLICED = ("K1a bench", "K1b exp", "K1b switch", "K1d psd3", "K1c genpow",
          "K1e bench", "K1e psd3")
_BIG = {}


def batch(name, case, B):
    """chip_smoke.py's batch of `name` at B lanes."""
    make = case[4]
    if name not in SLICED:
        return make(B)
    if make not in _BIG:
        _BIG[make] = make(max(ENDS))
    return tuple(None if a is None else a[:B] for a in _BIG[make])


def flats_of(name, case, spec, B):
    n = case[1]
    P, q, A, b = batch(name, case, B)
    if P is None:
        P = np.zeros((B, n, n))
    return megakernel.prepare(P, q, A, b, spec, torch.device("cuda"))[1]


def events_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


class TreeKernel(_cuda.Megakernel):
    """The megakernel built from another tree's source (or a patched copy
    of one), bound as the port binds its own."""

    def __init__(self, source, stem):
        super().__init__()
        self.source, self.stem = source, stem


# the launch with its block size from launch_threads, and the older
# launch in blocks of THREADS
PATCH_RULE = "const int threads = launch_threads(B, sms);"
PATCHED_RULE = ("const int threads = g_probe_threads > 0 ? g_probe_threads "
                ": launch_threads(B, sms);")
PATCH_LAUNCH = (
    "const long long blocks = (B + THREADS - 1) / THREADS;\n"
    "  mk_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(")
PATCHED_LAUNCH = (
    "const long long blocks = (B + g_probe_threads - 1) / g_probe_threads;\n"
    "  mk_kernel<<<(unsigned)blocks, g_probe_threads, 0, "
    "(cudaStream_t)stream>>>(")
PROBE_CONFIG = """static int g_probe_threads = THREADS;
// the probe's knobs: the block size of the next launches, and the
// kernel's preferred shared-memory carveout (percent; -1 is the default,
// cudaSharedmemCarveoutDefault)
int mk_probe_config(int threads, int carveout) {
  g_probe_threads = threads;
  return (int)cudaFuncSetAttribute(
      mk_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
}

int mk_solve("""


def patched_kernel(src_tree):
    """(A TreeKernel of src_tree's megakernel.cu with the launch's block
    size and the carveout settable through mk_probe_config, the block size
    value that leaves the source's own)."""
    with open(os.path.join(src_tree, "clarabel_tpu_torch", "csrc",
                           "megakernel.cu")) as f:
        text = f.read()
    if PATCH_RULE in text:
        text = text.replace(PATCH_RULE, PATCHED_RULE)
        config, default = PROBE_CONFIG.replace("= THREADS;", "= 0;"), 0
    elif PATCH_LAUNCH in text:
        text = text.replace(PATCH_LAUNCH, PATCHED_LAUNCH)
        config, default = PROBE_CONFIG, 128
    else:
        raise SystemExit("the source's launch is not one this probe patches")
    text = text.replace("int mk_solve(", config, 1)
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_build.BUILD_DIR, "megakernel_probe.cu")
    with open(path, "w") as f:
        f.write(text)
    kern = TreeKernel(path, "megakernel_probe")
    bind = kern.bind

    def bind_config(lib, shape):
        bind(lib, shape)
        lib.mk_probe_config.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mk_probe_config.restype = ctypes.c_int

    kern.bind = bind_config
    return kern, default



def ptxas_lines(kern):
    for variant, log in kern.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "stack" in line:
                print(f"ptxas {kern.stem} {variant}: {line.strip()}",
                      flush=True)


def sweep(args, card, out):
    kern, default_threads = patched_kernel(args.src)
    all_cases = cases()
    names = [nm for nm in ("K1a bench", "K1b exp", "K1d psd3", "K1c genpow",
                           "K1e bench") if re.search(args.only, nm)]
    specs = {nm: spec_of(all_cases[nm]) for nm in names}
    t0 = time.perf_counter()
    cuda_build.build_together(
        (kern, sorted({_cuda.shape_of(s) for s in specs.values()})))
    print(f"built {len(specs)} libraries in {time.perf_counter() - t0:.1f} "
          f"s; card {card}", flush=True)
    ptxas_lines(kern)

    def run(nm, B, threads=128, carveout=-1, **change):
        spec = specs[nm]
        if change:
            spec = dataclasses.replace(spec, st=spec.st.replace(**change))
        flats = flats_of(nm, all_cases[nm], spec, B)
        lib = kern.load(_cuda.shape_of(spec))
        rc = lib.mk_probe_config(threads, carveout)
        if rc:
            raise SystemExit(f"mk_probe_config failed: CUDA error {rc}")
        ms, (v, i) = events_ms(lambda: kern(*flats, spec, B))
        lib.mk_probe_config(default_threads, -1)
        iters = float(i[1].float().mean())
        rec = dict(kernel=nm, B=B, threads=threads, carveout=carveout,
                   change=change, ms=ms, mean_iters=iters,
                   solved=int((i[0] == 1).sum()))
        print(f"{nm} B={B} threads={threads} carveout={carveout} "
              f"{change or ''}: {ms:.3f} ms, mean iters {iters:.3f}, SOLVED "
              f"{rec['solved']}; card {card}", flush=True)
        out.append(rec)
        del flats

    parts = args.parts.split(",")
    if "tpb" in parts:
        for nm in names:
            for threads in (32, 64, 128):
                run(nm, 4096, threads)
    if "carveout" in parts:
        for nm in ("K1d psd3", "K1a bench"):
            for B in SIZES:
                for carveout in (-1, 0):
                    run(nm, B, 128, carveout)
    if "lsi" in parts:
        for B in ENDS:
            for lsi in (50, 0):
                run("K1c genpow", B, linesearch_max_iter=lsi)


def compare(args, card, out):
    new = _cuda.megakernel
    old = TreeKernel(os.path.join(os.path.abspath(args.parent),
                                  "clarabel_tpu_torch", "csrc",
                                  "megakernel.cu"), "megakernel_parent")
    all_cases = {nm: c for nm, c in cases().items()
                 if re.search(args.only, nm)}
    specs = {nm: spec_of(c) for nm, c in all_cases.items()}
    shapes = sorted({_cuda.shape_of(s) for s in specs.values()})
    t0 = time.perf_counter()
    cuda_build.build_together((new, shapes), (old, shapes))
    print(f"built {2 * len(shapes)} libraries in "
          f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    ptxas_lines(old)
    ptxas_lines(new)
    unequal = []
    for nm, case in all_cases.items():
        spec = specs[nm]
        for B in ENDS:
            flats = flats_of(nm, case, spec, B)
            times, res = {"parent": [], "change": []}, {"parent": [],
                                                         "change": []}
            for who in ("parent", "change", "change", "parent"):
                kern = old if who == "parent" else new
                ms, (v, i) = events_ms(lambda: kern(*flats, spec, B))
                times[who].append(ms)
                res[who].append((v.view(torch.int64), i))
            det = {who: bool(torch.equal(r[0][0], r[1][0])
                             and torch.equal(r[0][1], r[1][1]))
                   for who, r in res.items()}
            (pv, pi), (cv, ci) = res["parent"][1], res["change"][1]
            same_ints = bool(torch.equal(pi, ci))
            # bitwise: NaN objectives of infeasible lanes compare equal
            same_vals = bool(torch.equal(pv, cv))
            dv = pv != cv
            lanes = int((dv.any(dim=0) | (pi != ci).any(dim=0)).sum())
            n = spec.n
            both = (pi[0] == 1) & (ci[0] == 1)
            xd = (pv[:n].view(torch.float64) - cv[:n].view(torch.float64))
            dx = float(xd.abs()[:, both].max()) if bool(both.any()) else 0.0
            rec = dict(kernel=nm, B=B, parent_ms=times["parent"],
                       change_ms=times["change"], ints_equal=same_ints,
                       vals_equal=same_vals, lanes_differing=lanes,
                       deterministic=det,
                       status_differing=int((pi[0] != ci[0]).sum()),
                       iterations_differing=int((pi[1] != ci[1]).sum()),
                       x_lanes_differing=int(dv[:n].any(dim=0).sum()),
                       max_dx_solved=dx)
            print(f"{nm} B={B}: parent {times['parent'][0]:.3f} / "
                  f"{times['parent'][1]:.3f} ms, change "
                  f"{times['change'][0]:.3f} / {times['change'][1]:.3f} ms "
                  f"(turns parent, change, change, parent); statuses, "
                  f"iterations, strategies, phase-1 counts equal: "
                  f"{same_ints}; every value bit-equal: {same_vals}; lanes "
                  f"differing {lanes} of {B} (status {rec['status_differing']}"
                  f", iterations {rec['iterations_differing']}, x "
                  f"{rec['x_lanes_differing']}, max |dx| on lanes both solve "
                  f"{dx:.3e}); each repeat bit-equal: parent {det['parent']}, "
                  f"change {det['change']}; card {card}", flush=True)
            out.append(rec)
            if not (same_ints and same_vals):
                unequal.append(f"{nm} B={B}")
            del flats, res, pv, pi, cv, ci, dv
            torch.cuda.empty_cache()
    return unequal


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("sweep", "compare"))
    ap.add_argument("--src", default=HERE)
    ap.add_argument("--parent")
    ap.add_argument("--only", default="",
                    help="a regular expression: the kernels whose name "
                    "(as 'K1c genpow') it matches")
    ap.add_argument("--out", help="a JSON file for the readings")
    ap.add_argument("--parts", default="tpb,carveout,lsi",
                    help="sweep: which of tpb (block sizes), carveout and "
                    "lsi (K1c's barrier backtrack) to run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.mode == "compare" and not args.parent:
        raise SystemExit("compare needs --parent DIR")
    card = card_line()
    print(f"card {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    out = []
    bad = sweep(args, card, out) if args.mode == "sweep" else \
        compare(args, card, out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, readings=out), f, indent=1)
    if bad:
        raise SystemExit(f"not bit-equal: {', '.join(bad)}")


if __name__ == "__main__":
    main()
