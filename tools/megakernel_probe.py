#!/usr/bin/env python3
"""Timing probes of the CUDA megakernel (K1a-K1e) on one NVIDIA card.

Its modes, each run from the root of a checkout on a machine with a card:

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
output value are equal lane for lane.  It fails when they are not where
this checkout launches megakernel.cu, the parent's source; where it
launches the group kernel it counts the lanes whose status, iterations or
x differ.

`sweep --parts bsweep` times K1a and K1e on bench at every B of SIZES
with the library's own launch and prints the warps each SM holds there.
`sweep --parts gsweep [--sizes B,B,...] [--turns T]` times the group
kernel (`megakernel_group.cu`, and a copy with G = 8 at the bench shape)
against the one-lane-per-thread kernel on K1a bench, lp, qp_eq and K1e
bench, in turns: where `ipm/_cuda.GROUP_LANES_PER_SM` comes from.

`sass [--src DIR]` builds the K1a and K1e bench libraries of a tree and
counts, in `cuobjdump -sass` of each, the local loads and stores (`LDL`,
`STL`) and the generic ones (`LD.E`, `ST.E`).

`loops --parent DIR` times the loop solver's paths of chip_smoke.py on the
card, the tree at DIR (imported under another package name) against this
checkout in turns: `Settings.throughput()` on bench at B = 65536 and 4096 and the
condensed loop on exp, psd3 and genpow at B = 4096; on the first three
this checkout also runs with its IPM pass left eager (`ipm.loop.GRAPH_KINDS`
emptied), and every path with its inner loops checking the host every
k trips (`trips.TRIPS_PER_CHECK` set to each of 1, 2 and 4 but its own,
eager too), the order of turns run --turns times.  Statuses and iterations
must equal the parent's lane for lane.  Then the genpow rescue at
B = 131072, this checkout only.

`sweep --parts nsweep [--sizes B,B,...] [--turns T]` times K1b: this
checkout's one-lane-per-thread kernel against its group kernel with G = 2,
4 and 8 (patched copies under build/) on exp, pow and switch, in turns,
with their ptxas lines and SASS counts, and holds each to chip_smoke.py's
`NONSYM_BARS` at B = 4096: where the group size of exp/pow layouts and
`ipm/_cuda.NONSYM_GROUP_LANES_PER_SM` come from.

`k2 [--parent DIR] [--turns T]` times K2 at N = 19, 33, 79 and 80
(chip_smoke.py's two and `K2_PROBE_SHAPES`), B = 65536: the rows design
(`csrc/ldl_inverse_rows.cu` for N <= 32, `csrc/ldl_inverse_rows_wide.cu`
above), the shared-memory kernel (`csrc/ldl_inverse.cu`) pinned at every N
and the parent tree's K2 as its wrapper routes it, in turns, each held to
K2's bars, with build seconds, ptxas lines, SASS counts and the count of
lanes whose d, L^-1 or ok differ from the shared-memory kernel's, bit for
bit.

`graphs [--sizes B,B,...] [--turns T]` times this checkout's loop solver
with its IPM pass replayed as a CUDA graph against the pass left eager,
on `Settings.throughput()` bench and the condensed exp loop, in turns:
where `ipm/loop.GRAPH_MAX_LANES` comes from.

`bars --family psd3 [--seeds S] [--sizes B]` reads psd3 at B = 131072 on
two data seeds (13, chip_smoke.py's, and 14): the kernel in one dispatch
(whose bits every chunk of the rule has, chip_smoke.py [12]) and the
plain version with q moved by 1e-15 over S seeds, each against the plain
version and held to `PSD_BARS["psd3"]`; then, on the lanes where the
kernel's |dx| exceeds the x bar (or its three largest), a second
witness: the float64 loop solver on the CPU, each lane alone, at 1e-8,
1e-10 and 1e-11, and each solution's distance from the tightest that
reached SOLVED.

Each prints one line per reading, with the card's name and power limit,
and with --out writes the readings to a JSON file.  None imports JAX or
the JAX package.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
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

    def __init__(self, source, stem, group=0):
        super().__init__()
        self.source, self.stem, self.group = source, stem, group

    def source_for(self, variant):
        return self.source

    def variant(self, spec, B, device):
        return _cuda.shape_of(spec) + (self.group,)

    def variants(self, shapes):
        return [tuple(sh) + (self.group,) for sh in shapes]


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



GROUP_SIZE_RULE = "constexpr int G = M <= 8 ? 8 : M <= 16 ? 16 : 32;"
# the group size of exp/pow layouts (K1b)
NONSYM_GROUP_SIZE_RULE = re.compile(
    r"constexpr int G = \d+;( +// exp/pow layouts \(K1b\))")


NONSYM_MIN_BLOCKS_RULE = re.compile(
    r"constexpr int MIN_BLOCKS = \d+;( +// \d+ blocks of 64: <= \d+ registers)")


def group_source_with(g, nonsym=False, min_blocks=None):
    """A copy of this checkout's megakernel_group.cu under build/ with its
    group size fixed at g threads (the rule line of zero/nn/SOC layouts, or
    with nonsym that of exp/pow layouts, replaced), and with min_blocks the
    exp/pow layouts' blocks of 64 an SM in __launch_bounds__ (4: up to 255
    registers a thread, 8: up to 128); its path."""
    with open(os.path.join(HERE, "clarabel_tpu_torch", "csrc",
                           "megakernel_group.cu")) as f:
        text = f.read()
    if nonsym:
        text, n = NONSYM_GROUP_SIZE_RULE.subn(
            lambda mt: f"constexpr int G = {g};{mt.group(1)}", text)
    else:
        n = text.count(GROUP_SIZE_RULE)
        text = text.replace(GROUP_SIZE_RULE, f"constexpr int G = {g};")
    if min_blocks is not None:
        text, m = NONSYM_MIN_BLOCKS_RULE.subn(
            lambda mt: f"constexpr int MIN_BLOCKS = {min_blocks};", text)
        n = n if m == 1 else 0
    if n != 1:
        raise SystemExit("megakernel_group.cu has no group-size rule this "
                         "probe patches")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(
        cuda_build.BUILD_DIR,
        f"megakernel_group_{'ns' if nonsym else ''}g{g}"
        f"{'' if min_blocks is None else f'_mb{min_blocks}'}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def ptxas_lines(kern):
    for variant, log in kern.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "stack" in line:
                print(f"ptxas {kern.stem} {variant}: {line.strip()}",
                      flush=True)


def sweep(args, card, out):
    if args.parts == "gsweep":
        return group_sweep(args, card, out)
    if args.parts == "nsweep":
        return nonsym_sweep(args, card, out)
    kern, default_threads = patched_kernel(args.src)
    all_cases = cases()
    names = [nm for nm in ("K1a bench", "K1b exp", "K1d psd3", "K1c genpow",
                           "K1e bench") if re.search(args.only, nm)]
    if args.parts in ("bsweep", "gsweep"):
        names = [nm for nm in names if nm in ("K1a bench", "K1e bench")]
    specs = {nm: spec_of(all_cases[nm]) for nm in names}
    t0 = time.perf_counter()
    cuda_build.build_together(
        (kern, kern.variants(sorted({_cuda.shape_of(s)
                                     for s in specs.values()}))))
    print(f"built {len(specs)} libraries in {time.perf_counter() - t0:.1f} "
          f"s; card {card}", flush=True)
    ptxas_lines(kern)

    def run(nm, B, threads=128, carveout=-1, **change):
        spec = specs[nm]
        if change:
            spec = dataclasses.replace(spec, st=spec.st.replace(**change))
        flats = flats_of(nm, all_cases[nm], spec, B)
        lib = kern.load(kern.variant(spec, B, "cuda"))
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
    if "bsweep" in parts:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for nm in ("K1a bench", "K1e bench"):
            if nm not in specs:
                continue
            for B in SIZES:
                threads = 32 if B < 128 * sms else 128
                blocks = -(-B // threads)
                print(f"{nm} B={B}: the source's launch takes blocks of "
                      f"{threads}, {blocks} blocks, {B / 32 / sms:.2f} warps "
                      f"an SM if every block is resident at once", flush=True)
                run(nm, B, default_threads)
    if "gsweep" in parts:
        group_sweep(args, card, out)
    if "lsi" in parts:
        for B in ENDS:
            for lsi in (50, 0):
                run("K1c genpow", B, linesearch_max_iter=lsi)


def group_sweep(args, card, out):
    """This checkout's one-lane-per-thread kernel (megakernel.cu) against
    its group kernel (megakernel_group.cu, and the group kernel with G = 8
    on bench) on K1a bench, lp, qp_eq and K1e bench (those --only matches)
    at every B of --sizes, in turns (thread, group, group, thread, --turns
    times over); prints each kernel's times and their median."""
    csrc = os.path.join(HERE, "clarabel_tpu_torch", "csrc")
    thread = TreeKernel(os.path.join(csrc, "megakernel.cu"), "gs_thread")
    group = TreeKernel(os.path.join(csrc, "megakernel_group.cu"), "gs_group",
                       group=1)
    g8 = TreeKernel(group_source_with(8), "gs_group_g8", group=1)
    all_cases = cases()
    names = [nm for nm in ("K1a bench", "K1a lp", "K1a qp_eq", "K1e bench")
             if re.search(args.only, nm)]
    sizes = [int(b) for b in args.sizes.split(",")]
    specs = {nm: spec_of(all_cases[nm]) for nm in names}
    shapes = sorted({_cuda.shape_of(s) for s in specs.values()})
    bench_shapes = [_cuda.shape_of(spec_of(all_cases[nm]))
                    for nm in ("K1a bench", "K1e bench")]
    t0 = time.perf_counter()
    cuda_build.build_together(
        (thread, thread.variants(shapes)), (group, group.variants(shapes)),
        (g8, g8.variants([sh for sh in shapes if sh in bench_shapes])))
    print(f"gsweep: built in {time.perf_counter() - t0:.1f} s; card {card}",
          flush=True)
    for k in (group, g8):
        ptxas_lines(k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for nm in names:
        spec = specs[nm]
        kerns = {"thread": thread, "group": group}
        if _cuda.shape_of(spec) in bench_shapes:
            kerns["group G=8"] = g8
        for B in sizes:
            flats = flats_of(nm, all_cases[nm], spec, B)
            order = (list(kerns) + list(kerns)[::-1]) * args.turns
            times = {k: [] for k in kerns}
            solved = {}
            for who in order:
                ms, (v, i) = events_ms(lambda: kerns[who](*flats, spec, B))
                times[who].append(ms)
                solved[who] = int((i[0] == 1).sum())
            med = {k: float(np.median(t)) for k, t in times.items()}
            rec = dict(kernel=nm, B=B, times=times, median_ms=med,
                       solved=solved)
            print(f"gsweep {nm} B={B} ({B / sms:.1f} lanes an SM): " +
                  "; ".join(f"{k} {' / '.join(f'{x:.3f}' for x in t)} ms, "
                            f"median {med[k]:.3f} (SOLVED {solved[k]})"
                            for k, t in times.items()) +
                  f" (turns {', '.join(list(kerns) + list(kerns)[::-1])}, "
                  f"{args.turns} times); card {card}", flush=True)
            out.append(rec)
            del flats
            torch.cuda.empty_cache()


NONSYM_NAMES = ("K1b exp", "K1b pow", "K1b switch")


def nonsym_kernels(spec):
    """K1b's libraries of this checkout: one lane per thread
    (megakernel.cu) and the group kernel (megakernel_group.cu) at each
    entry of the comma-separated `spec`, "G" (group size G, the source's
    register cap) or "G:mbK" (and K blocks of 64 threads an SM in
    __launch_bounds__: up to 65536 / (64 K) registers a thread); patched
    copies under build/."""
    csrc = os.path.join(HERE, "clarabel_tpu_torch", "csrc")
    kerns = {"thread": TreeKernel(os.path.join(csrc, "megakernel.cu"),
                                  "ns_thread")}
    for item in spec.split(","):
        g, _, mb = item.partition(":")
        mb = int(mb[2:]) if mb else None
        kerns[f"group G={g}{f' mb{mb}' if mb else ''}"] = TreeKernel(
            group_source_with(int(g), True, mb),
            f"ns_group_g{g}{f'_mb{mb}' if mb else ''}", group=1)
    return kerns


def nonsym_sweep(args, card, out):
    """K1b: this checkout's one-lane-per-thread kernel against its group
    kernel at G = 2, 4 and 8 on exp, pow and switch (those --only matches)
    at every B of --sizes, in turns (thread, G=2, G=4, G=8 and back,
    --turns times over).  At B = 4096 each is also held to chip_smoke.py's
    NONSYM_BARS against the plain version, with the wrong kernels.  Prints
    each kernel's ptxas line, SASS counts, times and their median: where
    the group size and `_cuda.NONSYM_GROUP_LANES_PER_SM` come from."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from clarabel_tpu_torch.ipm import megakernel_ref

    kerns = nonsym_kernels(args.groups)
    all_cases = cases()
    names = [nm for nm in NONSYM_NAMES if re.search(args.only, nm)]
    sizes = [int(b) for b in args.sizes.split(",")]
    specs = {nm: spec_of(all_cases[nm]) for nm in names}
    shapes = sorted({_cuda.shape_of(s) for s in specs.values()})
    t0 = time.perf_counter()
    cuda_build.build_together(*[(k, k.variants(shapes))
                                for k in kerns.values()])
    print(f"nsweep: built in {time.perf_counter() - t0:.1f} s; card {card}",
          flush=True)
    for kname, k in kerns.items():
        ptxas_lines(k)
        for v in k.variants(shapes):
            c = cs.sass_counts(k.lib_path(v))
            print(f"sass K1b {kname} {v}: {c['instructions']} instructions, "
                  f"LDL {c['LDL']}, STL {c['STL']}; card {card}", flush=True)
            out.append(dict(kernel="K1b", variant=kname, sass=c))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    for nm in names:
        spec = specs[nm]
        short = nm.split()[1]
        if 4096 in sizes and not args.no_bars:
            P, q, A, b = batch(nm, all_cases[nm], 4096)
            B, flats = megakernel.prepare(P, q, A, b, spec, dev)
            p = cs.outputs(*megakernel_ref.mega_solve_plain(*flats, spec, B),
                           spec)
            for kname, kern in kerns.items():
                r = cs.readings(cs.outputs(*kern(*flats, spec, B), spec), p,
                                P, q, A, b)
                v = cs.violations(r, cs.NONSYM_BARS[short], B)
                wrong = []
                for wname, change in cs.WRONG_NONSYM.items():
                    wspec = dataclasses.replace(
                        spec, st=spec.st.replace(**change))
                    rw = cs.readings(cs.outputs(*kern(*flats, wspec, B),
                                                spec), p, P, q, A, b)
                    if not cs.violations(rw, cs.NONSYM_BARS[short], B):
                        wrong.append(wname)
                print(f"nsweep bars {nm} B={B} {kname} vs plain: "
                      f"{cs.describe(r)}; fails: {', '.join(v) or 'none'}; "
                      f"wrong kernels passed: {', '.join(wrong) or 'none'}; "
                      f"card {card}", flush=True)
                out.append(dict(kernel=nm, variant=kname, B=B, fails=v,
                                wrong_passed=wrong))
            del flats
        for B in sizes:
            flats = flats_of(nm, all_cases[nm], spec, B)
            order = (list(kerns) + list(kerns)[::-1]) * args.turns
            times = {k: [] for k in kerns}
            solved, iters = {}, {}
            for who in order:
                ms, (v, i) = events_ms(lambda: kerns[who](*flats, spec, B))
                times[who].append(ms)
                solved[who] = int((i[0] == 1).sum())
                iters[who] = float(i[1].float().mean())
            med = {k: float(np.median(t)) for k, t in times.items()}
            rec = dict(kernel=nm, B=B, times=times, median_ms=med,
                       solved=solved, mean_iters=iters)
            print(f"nsweep {nm} B={B} ({B / sms:.1f} lanes an SM): " +
                  "; ".join(f"{k} {' / '.join(f'{x:.3f}' for x in t)} ms, "
                            f"median {med[k]:.3f} (SOLVED {solved[k]}, mean "
                            f"iters {iters[k]:.3f})"
                            for k, t in times.items()) +
                  f"; card {card}", flush=True)
            out.append(rec)
            del flats
            torch.cuda.empty_cache()
    return []


# (n, m) of the K2 probe beyond chip_smoke.py's K2_SHAPES: N = 33, the
# narrowest wide build, and 79, the bench family's widest (n = 26)
K2_PROBE_SHAPES = ((10, 23), (26, 53))


def k2_probe(args, card, out):
    """K2 at N = 19, 33, 79 and 80, B = 65536: this checkout's rows design
    (csrc/ldl_inverse_rows.cu up to N = 32, csrc/ldl_inverse_rows_wide.cu
    above), the shared-memory kernel (csrc/ldl_inverse.cu) pinned at every
    N and, with --parent, the parent tree's K2 as its wrapper routed it
    (its rows kernel up to N = 32, its ldl_inverse.cu above), in turns
    (--turns times over), each held to K2's bars against the plain
    version; prints build seconds, ptxas lines, SASS counts, and the count
    of lanes whose d, L^-1 or ok differ from the shared-memory kernel's,
    bit for bit."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from clarabel_tpu_torch.linalg import batched_ldl

    class Shared(batched_ldl.LdlInverseKernel):
        """The shared-memory kernel at every N."""

        def variant(self, n):
            return ()

    class Parent(batched_ldl.LdlInverseKernel):
        """The parent tree's K2: its rows kernel up to N = 32 and its
        shared-memory kernel above."""

        def __init__(self, root):
            super().__init__()
            self.csrc = os.path.join(os.path.abspath(root),
                                     "clarabel_tpu_torch", "csrc")
            self.source = os.path.join(self.csrc, "ldl_inverse.cu")
            self.stem = "ldl_inverse_parent"

        def source_for(self, variant=()):
            return os.path.join(self.csrc, "ldl_inverse_rows.cu"
                                if variant else "ldl_inverse.cu")

        def variant(self, n):
            return (n,) if n <= 32 else ()

    kerns = {"rows": batched_ldl.LdlInverseKernel(), "shared": Shared()}
    if args.parent:
        kerns["parent"] = Parent(args.parent)
    shapes = sorted(cs.K2_SHAPES + K2_PROBE_SHAPES, key=sum)
    t0 = time.perf_counter()
    cuda_build.build_together(*[
        (k, sorted({k.variant(n + m) for n, m in shapes}))
        for k in kerns.values()])
    print(f"k2: built in {time.perf_counter() - t0:.1f} s; card {card}",
          flush=True)
    for kname, k in kerns.items():
        for v, log in k.build_logs.items():
            print(f"build K2 {kname} {v} "
                  f"({os.path.basename(k.source_for(v))}): "
                  f"{k.build_seconds[v]:.1f} s", flush=True)
            for line in log.splitlines():
                if "registers" in line or "stack" in line:
                    print(f"ptxas K2 {kname} {v}: {line.strip()}", flush=True)
            c = cs.sass_counts(k.lib_path(v))
            print(f"sass K2 {kname} {v}: {c['instructions']} instructions, "
                  f"LDL {c['LDL']}, STL {c['STL']}, LD.E {c['LD']}, ST.E "
                  f"{c['ST']}; card {card}", flush=True)
    st = ctt.Settings.throughput()
    eps, delta = (st.dynamic_regularization_eps,
                  st.dynamic_regularization_delta)
    for n, m in shapes:
        N = n + m
        K, signs = cs.k2_inputs(n, m, cs.K2_B, seed=N)
        K = torch.tensor(K, dtype=torch.float32, device="cuda")
        signs = torch.tensor(signs, dtype=torch.float32, device="cuda")
        plain = batched_ldl.ldl_inverse_plain(K, signs, eps, delta, True)
        here = kerns
        order = (list(here) + list(here)[::-1]) * args.turns
        times = {k: [] for k in here}
        res = {}
        for who in order:
            ms, res[who] = events_ms(
                lambda: here[who](K, signs, eps, delta, True), 20)
            times[who].append(ms)
        med = {k: float(np.median(t)) for k, t in times.items()}
        bound = cs.k2_bound_ms(N, cs.K2_B)
        print(f"k2 N={N} B={cs.K2_B}: " + "; ".join(
            f"{k} {' / '.join(f'{x:.4f}' for x in t)} ms, median "
            f"{med[k]:.4f}" for k, t in times.items()) +
            f"; bound {bound[0]:.4f} ms by {bound[1]}; card {card}",
            flush=True)
        for who, got in res.items():
            r = cs.k2_readings(got, plain)
            print(f"k2 N={N} {who} vs plain: ok equal {r['ok_equal']}, "
                  f"max rel |dL^-1| {r['linv']:.3e}, max rel |dd| "
                  f"{r['d']:.3e}; fails: "
                  f"{', '.join(cs.k2_violations(r)) or 'none'}", flush=True)
        for who, got in res.items():
            equal, n_uneq = cs.same_bits(got, res["shared"])
            print(f"k2 N={N} {who} vs shared: d, L^-1 and ok equal bit for "
                  f"bit on every lane: {equal} ({n_uneq} of {cs.K2_B} lanes "
                  f"differ)", flush=True)
        out.append(dict(kernel="K2", N=N, times=times, median_ms=med,
                        bound_ms=bound[0]))
        del K, plain, res
        torch.cuda.empty_cache()
    return []


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
    cuda_build.build_together(
        (new, [v for sh in shapes for v in _cuda.variants_of(sh)]),
        (old, old.variants(shapes)))
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
            # the change's source at this B: the parent's megakernel.cu is
            # held bit for bit only where the change launches the same
            # source (a group kernel sums in another order, DEVIATIONS.md
            # #15)
            src = _cuda.source_for(new.variant(spec, B, "cuda"))
            rec = dict(kernel=nm, B=B, source=src, parent_ms=times["parent"],
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
                  f"change {det['change']}; the change's source {src}; card "
                  f"{card}", flush=True)
            out.append(rec)
            if not (same_ints and same_vals) and src == "megakernel.cu":
                unequal.append(f"{nm} B={B}")
            del flats, res, pv, pi, cv, ci, dv
            torch.cuda.empty_cache()
    return unequal


def sass(args, card, out):
    """Local and generic loads and stores in the SASS of a tree's K1a and
    K1e bench libraries, per function."""
    all_cases = cases()
    names = [nm for nm in ("K1a bench", "K1e bench")
             if re.search(args.only, nm)]
    src = os.path.join(os.path.abspath(args.src), "clarabel_tpu_torch",
                       "csrc")
    for nm in names:
        spec = spec_of(all_cases[nm])
        shape = _cuda.shape_of(spec)
        for name in ("megakernel.cu", "megakernel_group.cu"):
            if not os.path.exists(os.path.join(src, name)):
                continue
            sass_one(nm, name, shape, src, card, out)
    return []


def sass_one(nm, name, shape, src, card, out):
    """The SASS counts of one library: `name` of tree `src` at `shape`."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    tree = TreeKernel(os.path.join(src, name),
                      f"sass_{os.path.splitext(name)[0]}",
                      group=int(name == "megakernel_group.cu"))
    variant = tree.variants([shape])[0]
    cuda_build.build_together((tree, [variant]))
    ptxas_lines(tree)
    c = cs.sass_counts(tree.lib_path(variant))
    print(f"sass {nm} {name} {shape}: {c['instructions']} instructions, LDL "
          f"{c['LDL']}, STL {c['STL']}, generic LD.E {c['LD']}, ST.E "
          f"{c['ST']}; card {card}", flush=True)
    out.append(dict(kernel=nm, source=name, **c))


class FlagKernel(TreeKernel):
    """A TreeKernel built with extra nvcc flags."""

    def __init__(self, source, stem, group, flags):
        super().__init__(source, stem, group)
        self.extra = tuple(flags)

    def flags_for(self, variant):
        return self.extra


def bar_counts(tag, fails, card, out):
    """Print and record how often each bar failed over the readings
    `fails` (one list of failed bars per reading)."""
    names = sorted({v for f in fails for v in f})
    print(f"bars summary {tag}: {len(fails)} readings; " + (", ".join(
        f"{v} failed {sum(v in f for f in fails)}" for v in names)
        or "no bar failed") + f"; card {card}", flush=True)
    out.append(dict(summary=tag, readings=len(fails),
                    failed={v: sum(v in f for f in fails) for v in names}))


def bars_nonsym(args, card, out):
    """chip_smoke.py's NONSYM_BARS of [8] (K1b against its plain version on
    the card, B = 4096) on exp, pow and switch, for the one-lane-per-thread
    kernel (megakernel.cu, the parent's K1b), the group kernel as this
    checkout builds it and the group kernel with G = 4; each kernel on the
    fixed batch and with q moved by 1e-15 (relative) over --seeds seeds,
    beside the plain version against itself under the same moves; then
    how often each bar failed."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from clarabel_tpu_torch.ipm import megakernel_ref

    csrc = os.path.join(HERE, "clarabel_tpu_torch", "csrc")
    kerns = {
        "thread": TreeKernel(os.path.join(csrc, "megakernel.cu"),
                             "bn_thread"),
        "group": TreeKernel(os.path.join(csrc, "megakernel_group.cu"),
                            "bn_group", 1),
        "group G=4": TreeKernel(group_source_with(4, True), "bn_group_g4", 1),
    }
    all_cases = cases()
    names = [nm for nm in NONSYM_NAMES if re.search(args.only, nm)]
    specs = {nm: spec_of(all_cases[nm]) for nm in names}
    shapes = sorted({_cuda.shape_of(s) for s in specs.values()})
    cuda_build.build_together(*[(k, k.variants(shapes))
                                for k in kerns.values()])
    for k in kerns.values():
        ptxas_lines(k)
    dev = torch.device("cuda")
    seeds = list(range(7, 7 + args.seeds))
    for nm in names:
        spec = specs[nm]
        bars_ = cs.NONSYM_BARS[nm.split()[1]]
        P, q, A, b = batch(nm, all_cases[nm], 4096)
        B, flats = megakernel.prepare(P, q, A, b, spec, dev)
        p = cs.outputs(*megakernel_ref.mega_solve_plain(*flats, spec, B),
                       spec)
        jit = []
        for seed in seeds:
            qj = q * (1 + 1e-15 * np.random.default_rng(seed)
                      .standard_normal(q.shape))
            jit.append((qj, megakernel.prepare(P, qj, A, b, spec, dev)[1]))
        fails = []
        for seed, (qj, fj) in zip(seeds, jit):
            pj = cs.outputs(*megakernel_ref.mega_solve_plain(*fj, spec, B),
                            spec)
            r = cs.readings(pj, p, P, qj, A, b)
            fails.append(cs.violations(r, bars_, B))
            print(f"bars {nm} plain(q jitter seed {seed}) vs plain: "
                  f"{cs.describe(r)}; fails: {', '.join(fails[-1]) or 'none'}",
                  flush=True)
        bar_counts(f"{nm} plain vs itself (jittered)", fails, card, out)
        for kname, kern in kerns.items():
            ms, (kv, ki) = events_ms(lambda: kern(*flats, spec, B))
            r = cs.readings(cs.outputs(kv, ki, spec), p, P, q, A, b)
            v = cs.violations(r, bars_, B)
            print(f"bars {nm} {kname} ({ms:.3f} ms) vs plain: "
                  f"{cs.describe(r)}; fails: {', '.join(v) or 'none'}",
                  flush=True)
            fails = []
            for seed, (qj, fj) in zip(seeds, jit):
                rj = cs.readings(cs.outputs(*kern(*fj, spec, B), spec), p, P,
                                 qj, A, b)
                fails.append(cs.violations(rj, bars_, B))
                print(f"bars {nm} {kname}(q jitter seed {seed}) vs plain: "
                      f"{cs.describe(rj)}; fails: "
                      f"{', '.join(fails[-1]) or 'none'}", flush=True)
            bar_counts(f"{nm} {kname} (fixed batch fails: "
                       f"{', '.join(v) or 'none'}; jittered)", fails, card,
                       out)
        del flats, jit
        torch.cuda.empty_cache()
    return []


def bars_k2(args, card, out):
    """K2's bars of [5] (ok equal, d and L^-1 within 1e-4 of the plain
    version) at N = 19 and 80, B = 65536: the plain version against itself
    with K moved by 1e-7 (relative; a move of 1e-15 vanishes in float32)
    over --seeds seeds, and the rows design and the shared-memory kernel
    on the fixed and the moved batches; then
    how often each bar failed."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from clarabel_tpu_torch.linalg import batched_ldl

    class Shared(batched_ldl.LdlInverseKernel):
        def variant(self, n):
            return ()

    kerns = {"rows": batched_ldl.LdlInverseKernel(), "shared": Shared()}
    st = ctt.Settings.throughput()
    eps, delta = (st.dynamic_regularization_eps,
                  st.dynamic_regularization_delta)
    seeds = list(range(7, 7 + args.seeds))
    for n, m in cs.K2_SHAPES:
        N = n + m
        K0, signs = cs.k2_inputs(n, m, cs.K2_B, seed=N)
        signs = torch.tensor(signs, dtype=torch.float32, device="cuda")

        def moved(seed):
            Kj = K0 if seed is None else K0 * (
                1 + 1e-7 * np.random.default_rng(seed).standard_normal(
                    K0.shape))
            Kj = (Kj + Kj.transpose(0, 2, 1)) / 2 if seed is not None else Kj
            return torch.tensor(Kj, dtype=torch.float32, device="cuda")

        K = moved(None)
        plain = batched_ldl.ldl_inverse_plain(K, signs, eps, delta, True)
        fails = []
        for seed in seeds:
            Kj = moved(seed)
            r = cs.k2_readings(batched_ldl.ldl_inverse_plain(
                Kj, signs, eps, delta, True), plain)
            fails.append(cs.k2_violations(r))
            print(f"bars K2 N={N} plain(K jitter seed {seed}) vs plain: ok "
                  f"equal {r['ok_equal']}, max rel |dL^-1| {r['linv']:.3e}, "
                  f"max rel |dd| {r['d']:.3e}; fails: "
                  f"{', '.join(fails[-1]) or 'none'}", flush=True)
            del Kj
        bar_counts(f"K2 N={N} plain vs itself (jittered)", fails, card, out)
        for kname, kern in kerns.items():
            r = cs.k2_readings(kern(K, signs, eps, delta, True), plain)
            v = cs.k2_violations(r)
            fails = []
            for seed in seeds:
                rj = cs.k2_readings(kern(moved(seed), signs, eps, delta,
                                         True), plain)
                fails.append(cs.k2_violations(rj))
                print(f"bars K2 N={N} {kname}(K jitter seed {seed}) vs plain:"
                      f" ok equal {rj['ok_equal']}, max rel |dL^-1| "
                      f"{rj['linv']:.3e}, max rel |dd| {rj['d']:.3e}; fails: "
                      f"{', '.join(fails[-1]) or 'none'}", flush=True)
            bar_counts(f"K2 N={N} {kname} (fixed batch: max rel |dL^-1| "
                       f"{r['linv']:.3e}, |dd| {r['d']:.3e}, fails "
                       f"{', '.join(v) or 'none'}; jittered)", fails, card,
                       out)
        del K, plain
        torch.cuda.empty_cache()
    return []


def bars_psd3(args, card, out):
    """psd3 at scale (see the module's docstring): whether the kernel's x
    reading above the bar is the kernel's or the lane's."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from clarabel_tpu_torch.ipm import megakernel_ref

    bars_ = cs.PSD_BARS["psd3"]
    cones = [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)]
    spec = spec_of(cases()["K1d psd3"])
    dev = torch.device("cuda")
    B = int(args.sizes.split(",")[-1])
    cuda_build.build_together(
        (_cuda.megakernel, [_cuda.megakernel.variant(spec, B, dev)]))
    seeds = list(range(7, 7 + args.seeds))
    for data_seed in (13, 14):
        P, q, A, b = bench_data.make_sdp_batch(B, 3, data_seed)
        _, flats = megakernel.prepare(P, q, A, b, spec, dev)
        p = cs.outputs(*megakernel_ref.mega_solve_plain(*flats, spec, B),
                       spec)
        k = cs.outputs(*_cuda.megakernel(*flats, spec, B), spec)
        r = cs.readings(k, p, P, q, A, b)
        print(f"psd3 seed {data_seed} B={B} kernel vs plain: "
              f"{cs.describe(r)}; fails: "
              f"{', '.join(cs.violations(r, bars_, B)) or 'none'}; card "
              f"{card}", flush=True)
        out.append(dict(seed=data_seed, who="kernel", B=B, dx=r["dx"],
                        it_max=r["it_max"], within1=r["within1"],
                        fails=cs.violations(r, bars_, B)))
        del flats
        jit = []
        for js in seeds:
            qj = q * (1 + 1e-15 * np.random.default_rng(js)
                      .standard_normal(q.shape))
            _, fj = megakernel.prepare(P, qj, A, b, spec, dev)
            pj = cs.outputs(*megakernel_ref.mega_solve_plain(*fj, spec, B),
                            spec)
            del fj
            rj = cs.readings(pj, p, P, qj, A, b)
            print(f"psd3 seed {data_seed} B={B} plain(q jitter seed {js}) "
                  f"vs plain: {cs.describe(rj)}; fails: "
                  f"{', '.join(cs.violations(rj, bars_, B)) or 'none'}",
                  flush=True)
            out.append(dict(seed=data_seed, who=f"plain jitter {js}", B=B,
                            dx=rj["dx"], it_max=rj["it_max"],
                            within1=rj["within1"],
                            fails=cs.violations(rj, bars_, B)))
            jit.append(pj)
        both = (k["status"] == 1) & (p["status"] == 1)
        dx = np.where(both, np.abs(k["x"] - p["x"]).max(axis=1), 0.0)
        lanes = np.nonzero(dx > bars_["x"])[0]
        if lanes.size == 0:
            lanes = np.argsort(dx)[-3:]
        for lane in lanes:
            # the witness, each lane alone: the tightest tolerance at which
            # the loop solves it (its eigenvalue step can fail to converge
            # near the end)
            wit = {}
            for tol in (1e-8, 1e-10, 1e-11):
                st = ctt.Settings(kkt_backend="ldl", tol_gap_abs=tol,
                                  tol_gap_rel=tol, tol_feas=tol)
                try:
                    sol = ctt.BatchSolver(cones, 3, st, device="cpu").solve(
                        P[lane:lane + 1], q[lane:lane + 1],
                        A[lane:lane + 1], b[lane:lane + 1])
                except RuntimeError as exc:
                    print(f"psd3 seed {data_seed} lane {lane}: the loop at "
                          f"{tol:.0e} raised {type(exc).__name__}",
                          flush=True)
                    continue
                wit[tol] = (np.asarray(sol.x)[0], int(sol.status[0]),
                            int(sol.iterations[0]))
            solved = [t for t in wit if wit[t][1] == 1]
            tol_w = min(solved or wit)
            xw = wit[tol_w][0]

            def far(x):
                return float(np.abs(x[lane] - xw).max())

            row = dict(
                seed=data_seed, lane=int(lane),
                kernel_vs_plain=float(dx[lane]),
                plain_jitter_vs_plain=max(
                    float(np.abs(pj["x"][lane] - p["x"][lane]).max())
                    for pj in jit),
                witness_tol=tol_w, witness_status=wit[tol_w][1],
                witness_iterations=wit[tol_w][2],
                kernel_to_witness=far(k["x"]), plain_to_witness=far(p["x"]),
                plain_jitter_to_witness=max(far(pj["x"]) for pj in jit),
                loop_1e8_to_witness=(float(np.abs(wit[1e-8][0] - xw).max())
                                     if 1e-8 in wit else None),
                iterations=dict(kernel=int(k["iterations"][lane]),
                                plain=int(p["iterations"][lane])))
            out.append(row)
            print(f"psd3 seed {data_seed} lane {lane}: |dx| kernel vs plain "
                  f"{row['kernel_vs_plain']:.3e}, plain jittered vs plain "
                  f"(largest of {len(seeds)}) "
                  f"{row['plain_jitter_vs_plain']:.3e}; distance from the "
                  f"loop at {tol_w:.0e} (status {row['witness_status']}, "
                  f"{row['witness_iterations']} iterations): kernel "
                  f"{row['kernel_to_witness']:.3e}, plain "
                  f"{row['plain_to_witness']:.3e}, plain jittered (largest) "
                  f"{row['plain_jitter_to_witness']:.3e}, the loop at 1e-8 "
                  f"{row['loop_1e8_to_witness'] or 0.0:.3e}; iterations kernel "
                  f"{row['iterations']['kernel']}, plain "
                  f"{row['iterations']['plain']}", flush=True)
        torch.cuda.empty_cache()
    return []


def bars(args, card, out):
    """chip_smoke.py's bars of [2], [3] and [11] (kernel against its plain
    version on the card, B = 4096) for the one-lane-per-thread kernel and
    for group-kernel variants (G = 8 and 16, each with and without
    -fmad=false), and, to show how near the bars each reading is, the same
    readings with q moved by 1e-15 (relative, three seeds) for the kernel
    and for the plain version against itself.  With --family k1b or k2,
    `bars_nonsym` or `bars_k2` in its place."""
    if args.family == "k1b":
        return bars_nonsym(args, card, out)
    if args.family == "k2":
        return bars_k2(args, card, out)
    if args.family == "psd3":
        return bars_psd3(args, card, out)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from clarabel_tpu_torch.ipm import megakernel_ref

    csrc = os.path.join(HERE, "clarabel_tpu_torch", "csrc")
    g8, g16 = group_source_with(8), group_source_with(16)
    kerns = {
        "thread": TreeKernel(os.path.join(csrc, "megakernel.cu"), "b_thread"),
        "group G=8": TreeKernel(g8, "b_g8", 1),
        "group G=8 nofma": FlagKernel(g8, "b_g8nf", 1, ("-fmad=false",)),
        "group G=16": TreeKernel(g16, "b_g16", 1),
        "group G=16 nofma": FlagKernel(g16, "b_g16nf", 1, ("-fmad=false",)),
    }
    all_cases = cases()
    names = ["K1a bench", "K1a qp_eq", "K1a infeasible", "K1a lp",
             "K1e bench", "K1e infeasible", "K1e lp"]
    specs = {nm: spec_of(all_cases[nm]) for nm in names}
    shapes = sorted({_cuda.shape_of(s) for s in specs.values()})
    t0 = time.perf_counter()
    cuda_build.build_together(*[(k, k.variants(shapes))
                                for k in kerns.values()])
    print(f"bars: built in {time.perf_counter() - t0:.1f} s; card {card}",
          flush=True)
    for k in kerns.values():
        ptxas_lines(k)
    dev = torch.device("cuda")
    for nm in names:
        spec = specs[nm]
        two = spec.two_phase
        bars_ = (cs.TWO_PHASE_BARS if two else cs.BARS)[nm.split()[1]]
        P, q, A, b = batch(nm, all_cases[nm], 4096)
        if P is None:
            P = np.zeros((q.shape[0], spec.n, spec.n))
        B, flats = megakernel.prepare(P, q, A, b, spec, dev)
        p = cs.outputs(*megakernel_ref.mega_solve_plain(*flats, spec, B),
                       spec)
        jit = []
        for seed in (7, 8, 9):
            qj = q * (1 + 1e-15 * np.random.default_rng(seed)
                      .standard_normal(q.shape))
            jit.append((qj, megakernel.prepare(P, qj, A, b, spec, dev)[1]))
        for seed, (qj, fj) in zip((7, 8, 9), jit):
            pj = cs.outputs(*megakernel_ref.mega_solve_plain(*fj, spec, B),
                            spec)
            r = cs.readings(pj, p, P, qj, A, b)
            v = cs.violations(r, bars_, B)
            print(f"bars {nm} plain(q jitter seed {seed}) vs plain: "
                  f"{cs.describe(r)}; fails: {', '.join(v) or 'none'}",
                  flush=True)
        for kname, kern in kerns.items():
            ms, (kv, ki) = events_ms(lambda: kern(*flats, spec, B))
            r = cs.readings(cs.outputs(kv, ki, spec), p, P, q, A, b)
            v = cs.violations(r, bars_, B)
            fails = [len(v)]
            print(f"bars {nm} {kname} ({ms:.3f} ms) vs plain: "
                  f"{cs.describe(r)}; fails: {', '.join(v) or 'none'}",
                  flush=True)
            for seed, (qj, fj) in zip((7, 8, 9), jit):
                rj = cs.readings(cs.outputs(*kern(*fj, spec, B), spec), p, P,
                                 qj, A, b)
                vj = cs.violations(rj, bars_, B)
                fails.append(len(vj))
                print(f"bars {nm} {kname}(q jitter seed {seed}) vs plain: "
                      f"{cs.describe(rj)}; fails: {', '.join(vj) or 'none'}",
                      flush=True)
            out.append(dict(kernel=nm, variant=kname, ms=ms, fails=fails))
        del flats, jit
        torch.cuda.empty_cache()
    return []


LOOP_PATHS = ("throughput bench", "throughput bench 4096", "throughput wide",
              "condensed exp", "condensed psd3", "condensed genpow")


def parent_package(tree):
    """The port package of another tree, imported as
    `clarabel_tpu_torch_parent` from a copy under build/."""
    root = os.path.join(HERE, "build", "loop_parent")
    dst = os.path.join(root, "clarabel_tpu_torch_parent")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(os.path.abspath(tree), "clarabel_tpu_torch"),
                    dst, ignore=shutil.ignore_patterns("__pycache__"))
    sys.path.insert(0, root)
    import clarabel_tpu_torch_parent
    return clarabel_tpu_torch_parent


def loop_case(pkg, name, B=None):
    """(solver, data) of a loop path, built from package `pkg`, at the
    path's own B or at B lanes."""
    import importlib
    bd = importlib.import_module(pkg.__name__ + ".bench_data")
    if name.startswith("throughput bench"):
        cones = [pkg.NonnegativeConeT(6), pkg.SecondOrderConeT(7)]
        if B is None:
            B = 4096 if name.endswith("4096") else 65536
        data = tuple(a[:B] for a in bd.make_batch(max(B, 65536), 6, 0))
        return pkg.BatchSolver(cones, 6, pkg.Settings.throughput(),
                               device="cuda"), data
    if name == "throughput wide":   # chip_smoke.py [6]'s n = 26: N = 79
        cones = [pkg.NonnegativeConeT(26), pkg.SecondOrderConeT(27)]
        data = bd.make_batch(B or 16384, 26, 0)
        return pkg.BatchSolver(cones, 26, pkg.Settings.throughput(),
                               device="cuda"), data
    kind = name.split()[1]
    if kind == "exp":
        cones = [pkg.NonnegativeConeT(2), pkg.ExponentialConeT()]
        n, big = 3, bd.make_exp_batch(131072)
    elif kind == "psd3":
        cones = [pkg.NonnegativeConeT(6), pkg.PSDTriangleConeT(3)]
        n, big = 3, bd.make_sdp_batch(131072, 3, 13)
    else:
        cones = [pkg.NonnegativeConeT(2), pkg.GenPowerConeT((0.3, 0.7), 2)]
        n, big = 4, bd.make_genpow_batch(131072)
    return pkg.BatchSolver(cones, n, pkg.Settings(kkt_backend="condensed"),
                           device="cuda"), tuple(a[:B or 4096] for a in big)


def loops(args, card, out):
    import importlib
    parent = parent_package(args.parent)
    loop_mod = importlib.import_module("clarabel_tpu_torch.ipm.loop")
    trips_mod = importlib.import_module("clarabel_tpu_torch.trips")
    k_own, graph_kinds = trips_mod.TRIPS_PER_CHECK, loop_mod.GRAPH_KINDS
    k2 = importlib.import_module("clarabel_tpu_torch.linalg.batched_ldl")
    bad = []

    def variant(name, label):
        """(solver, data) of this checkout with the variant's constants;
        they are read when the solver is built and when it runs."""
        loop_mod.GRAPH_KINDS = graph_kinds if label == "change" \
            else frozenset()
        try:
            return loop_case(ctt, name)
        finally:
            loop_mod.GRAPH_KINDS = graph_kinds

    def timed(solver, data, label):
        trips_mod.TRIPS_PER_CHECK = (int(label[2:]) if label.startswith("k=")
                                     else k_own)
        solver.solve(*(a[:256] for a in data))
        torch.cuda.synchronize()
        k2.kernel.launches = 0
        t0 = time.perf_counter()
        sol = solver.solve(*data)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sol, k2.kernel.launches

    for name in LOOP_PATHS:
        if not re.search(args.only, name):
            continue
        ps, pdata = loop_case(parent, name)
        labels = ["change"] + [f"k={k}" for k in (1, 2, 4) if k != k_own]
        if name in ("throughput bench", "throughput bench 4096",
                    "condensed exp"):
            labels.insert(1, "eager")
        solvers = {lb: variant(name, lb)[0] for lb in labels}
        data = pdata
        order = (["parent"] + labels + labels[::-1] + ["parent"]) * args.turns
        walls = {lb: [] for lb in ["parent"] + labels}
        sols = {}
        for lb in order:
            solver = ps if lb == "parent" else solvers[lb]
            w, sol, l2 = timed(solver, data, lb)
            walls[lb].append(w)
            sols[lb] = (sol, l2)
        p = sols["parent"][0]
        for lb in labels:
            sol, l2 = sols[lb]
            same_st = bool(np.array_equal(sol.status, p.status))
            same_it = bool(np.array_equal(sol.iterations, p.iterations))
            same_x = bool(np.array_equal(sol.x.view(np.int64),
                                         p.x.view(np.int64)))
            rec = dict(path=name, variant=lb, parent_s=walls["parent"],
                       change_s=walls[lb], statuses_equal=same_st,
                       iterations_equal=same_it, x_bit_equal=same_x,
                       k2_launches=l2, parent_k2=sols["parent"][1],
                       statuses=np.bincount(sol.status,
                                            minlength=11).tolist())
            print(f"loops {name} B={len(data[1])} {lb}: parent "
                  f"{' / '.join(f'{w * 1e3:.1f}' for w in walls['parent'])}"
                  f" ms (median {np.median(walls['parent']) * 1e3:.1f}), "
                  f"{lb} {' / '.join(f'{w * 1e3:.1f}' for w in walls[lb])} "
                  f"ms (median {np.median(walls[lb]) * 1e3:.1f}) (turns "
                  f"{', '.join(order[:len(order) // args.turns])}, "
                  f"{args.turns} times); statuses equal to the "
                  f"parent's lane for lane: {same_st}, iterations {same_it},"
                  f" x bit-equal {same_x}; K2 launches {l2} (parent "
                  f"{sols['parent'][1]}); statuses {rec['statuses']}; card "
                  f"{card}", flush=True)
            out.append(rec)
            if not (same_st and same_it):
                bad.append(f"{name} {lb}")
        del ps, solvers, sols, p
        torch.cuda.empty_cache()
    trips_mod.TRIPS_PER_CHECK, loop_mod.GRAPH_KINDS = k_own, graph_kinds
    if re.search(args.only, "genpow rescue"):
        cones = [ctt.NonnegativeConeT(2), ctt.GenPowerConeT((0.3, 0.7), 2)]
        big = bench_data.make_genpow_batch(131072)
        alone = ctt.BatchSolver(cones, 4, device="cuda")
        resc = ctt.BatchSolver(cones, 4, rescue="same", device="cuda")
        alone.solve(*(a[:256] for a in big))
        resc.solve(*(a[:4096] for a in big))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s0 = alone.solve(*big)
        t1 = time.perf_counter()
        s1 = resc.solve(*big)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        before = int((s0.status == 1).sum())
        rec = dict(path="genpow rescue", B=131072, alone_s=t1 - t0,
                   rescue_s=t2 - t1, solved_before=before,
                   solved_after=int((s1.status == 1).sum()),
                   statuses=np.bincount(s1.status, minlength=11).tolist(),
                   left_statuses=np.bincount(s0.status,
                                             minlength=11).tolist())
        print(f"loops genpow rescue B=131072: megakernel alone "
              f"{rec['alone_s']:.3f} s, SOLVED {before}, statuses "
              f"{rec['left_statuses']}; with rescue='same' "
              f"{rec['rescue_s']:.3f} s, SOLVED {rec['solved_after']}, "
              f"statuses {rec['statuses']}; card {card}", flush=True)
        out.append(rec)
    return bad


def graphs(args, card, out):
    """This checkout's loop solver with its IPM pass replayed as a CUDA
    graph against the same pass left eager (`ipm.loop.GRAPH_KINDS`
    emptied), on `Settings.throughput()` bench and the condensed exp loop
    at every B of --sizes, in turns (graph, eager, eager, graph, --turns
    times over).  Statuses and iterations must be equal between the two."""
    import importlib
    loop_mod = importlib.import_module("clarabel_tpu_torch.ipm.loop")
    graph_kinds, max_lanes = loop_mod.GRAPH_KINDS, loop_mod.GRAPH_MAX_LANES
    loop_mod.GRAPH_MAX_LANES = 1 << 62      # every B of --sizes may replay
    bad = []
    for name in ("throughput bench", "condensed exp"):
        if not re.search(args.only, name):
            continue
        for B in (int(b) for b in args.sizes.split(",")):
            solvers = {}
            for label in ("graph", "eager"):
                loop_mod.GRAPH_KINDS = (graph_kinds if label == "graph"
                                        else frozenset())
                solvers[label], data = loop_case(ctt, name, B)
            walls, sols = {"graph": [], "eager": []}, {}
            for label in ("graph", "eager", "eager", "graph") * args.turns:
                loop_mod.GRAPH_KINDS = (graph_kinds if label == "graph"
                                        else frozenset())
                solvers[label].solve(*(a[:256] for a in data))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sols[label] = solvers[label].solve(*data)
                torch.cuda.synchronize()
                walls[label].append(time.perf_counter() - t0)
            loop_mod.GRAPH_KINDS = graph_kinds
            g, e = sols["graph"], sols["eager"]
            same = bool(np.array_equal(g.status, e.status)
                        and np.array_equal(g.iterations, e.iterations))
            med = {k: float(np.median(w)) for k, w in walls.items()}
            out.append(dict(path=name, B=B, walls_s=walls, median_s=med,
                            statuses_equal=same))
            print(f"graphs {name} B={B}: " + "; ".join(
                f"{k} {' / '.join(f'{w * 1e3:.1f}' for w in ws)} ms, median "
                f"{med[k] * 1e3:.1f}" for k, ws in walls.items()) +
                f" (turns graph, eager, eager, graph, {args.turns} times); "
                f"statuses and iterations equal: {same}; card {card}",
                flush=True)
            if not same:
                bad.append(f"{name} B={B}")
            del solvers, sols, g, e
            torch.cuda.empty_cache()
    loop_mod.GRAPH_MAX_LANES = max_lanes
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("sweep", "compare", "sass", "loops",
                                     "bars", "graphs", "k2"))
    ap.add_argument("--src", default=HERE)
    ap.add_argument("--parent")
    ap.add_argument("--only", default="",
                    help="a regular expression: the kernels whose name "
                    "(as 'K1c genpow') it matches")
    ap.add_argument("--out", help="a JSON file for the readings")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="sweep --parts gsweep and graphs: the batch sizes, "
                    "comma-separated")
    ap.add_argument("--groups", default="2,4,8",
                    help="sweep --parts nsweep: the group kernel's group "
                    "sizes, comma-separated, each G or G:mbK (K blocks of "
                    "64 an SM in __launch_bounds__)")
    ap.add_argument("--family", default="k1a",
                    choices=("k1a", "k1b", "k2", "psd3"),
                    help="bars: which kernels' bars (K1a and K1e, K1b, K2, "
                    "psd3 at --sizes' last B)")
    ap.add_argument("--seeds", type=int, default=3,
                    help="bars --family k1b|k2|psd3: how many jitter "
                    "seeds")
    ap.add_argument("--no-bars", action="store_true",
                    help="sweep --parts nsweep: times only")
    ap.add_argument("--turns", type=int, default=1,
                    help="gsweep, loops and graphs: how many times the "
                    "order of turns runs")
    ap.add_argument("--parts", default="tpb,carveout,lsi",
                    help="sweep: which of tpb (block sizes), carveout and "
                    "lsi (K1c's barrier backtrack), bsweep (K1a and K1e "
                    "bench over B) and gsweep (the group kernel against "
                    "one lane per thread over --sizes) to run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.mode in ("compare", "loops") and not args.parent:
        raise SystemExit(f"{args.mode} needs --parent DIR")
    card = card_line()
    print(f"card {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    out = []
    bad = dict(sweep=sweep, compare=compare, sass=sass, loops=loops,
               bars=bars, graphs=graphs, k2=k2_probe)[args.mode](args, card,
                                                                 out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, readings=out), f, indent=1)
    if bad:
        raise SystemExit(f"not bit-equal: {', '.join(bad)}")


if __name__ == "__main__":
    main()
