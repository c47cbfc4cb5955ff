#!/usr/bin/env python3
"""Where the megakernel path's wall time goes on one NVIDIA card, and which
host side makes it shortest.

    python3 tools/host_probe.py [--sizes B,B] [--chunks C,C,...]
                                [--turns T] [--out FILE.json]

For the batches bench (n=6, [NN(6), SOC(7)]), psd3 (n=3, [NN(6), PSD(3)])
and exp (n=3, [NN(2), Exp()]) of chip_smoke.py at B = 4096 and 131072 it
times the solve of `ipm/megakernel.build_mega_solve` (host arrays to host
results, best of 3 after a warm-up) for:

* one dispatch over the whole batch with host packing (the port before
  chunks) and with device packing;
* every chunk size of --chunks below B, with host and with device packing,
  each chunk taking the library of the whole batch's size and, where the
  layout has a group kernel, of its own size (`library_by`);
* the chunk rule (`megakernel.chunk_lanes`) as shipped.

The shipped solve packs on the device and gives each chunk its own size's
library; the other configurations run this probe's copy of its dispatch
(`host_packed_solve`) or hold the library to the whole batch's size
(`library_of`).

Beside each wall it prints the steps one at a time, each synchronised:
the batch-constant scan (`is_const` on the raw arrays), host packing,
staging in pinned memory, the copy to the card, the device gather, the
kernels (CUDA events, summed over the chunks), the copy back with unpack;
and the SOLVED count, which must equal one dispatch's.  The order of the
configurations is reversed on every other turn.  Each line carries the
card's name and power limit.  It imports neither JAX nor the JAX package.
"""

import argparse
import contextlib
import json
import os
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

SOLVED = int(ctt.SolverStatus.SOLVED)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def families():
    st = ctt.Settings(kkt_backend="megakernel")
    return {
        "bench": ([ctt.NonnegativeConeT(6), ctt.SecondOrderConeT(7)], 6, st,
                  lambda B: bench_data.make_batch(B, 6, 0)),
        "psd3": ([ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3, st,
                 lambda B: bench_data.make_sdp_batch(B, 3, 13)),
        "exp": ([ctt.NonnegativeConeT(2), ctt.ExponentialConeT()], 3, st,
                bench_data.make_exp_batch),
    }


def best_wall(fn, reps=3):
    fn()
    best, out = None, None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn()
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, out = dt, o
    return best * 1e3, out


@contextlib.contextmanager
def library_of(lanes):
    """Within: every megakernel launch takes the library a batch of
    `lanes` takes, whatever its own B (None: its own)."""
    if lanes is None:
        yield
        return
    kern = _cuda.megakernel
    own = type(kern).variant
    kern.variant = lambda spec, B, device: own(kern, spec, lanes, device)
    try:
        yield
    finally:
        del kern.variant


def host_packed_solve(spec, dev, chunk):
    """A copy of `build_mega_solve`'s dispatch with each chunk packed on
    the host (`megakernel.host_pack`, the numpy packing of `prepare`) and
    copied in one piece; returns solve(P, q, A, b) -> the eager fields."""
    def solve(P, q, A, b):
        raws = megakernel._as_host(P, q, A, b)
        B = raws[1].shape[0]
        const = [megakernel.is_const(r) for r in raws]
        flats = megakernel.shared_flats(raws, const, spec, dev)
        dims = (spec.triu, spec.n, spec.n * spec.m, spec.m)
        width = sum(d for d, c in zip(dims, const) if not c)
        C = megakernel.chunk_lanes(width, B) if chunk is None else chunk
        on_card = dev.type == "cuda"
        copy = megakernel._copy_stream(dev) if on_card else None
        compute = torch.cuda.current_stream(dev) if on_card else None
        outs, keep = [], []
        for lo in range(0, B, C):
            hi = min(B, lo + C)
            cf = list(flats)
            if not all(const):
                (packed,), pinned = megakernel._stage(
                    [megakernel.host_pack(raws, const, spec, lo, hi)], dev,
                    copy, compute)
                for i, f in enumerate(megakernel.split_packed(packed, const,
                                                              spec)):
                    if f is not None:
                        cf[i] = f
                keep += pinned
            outs.append(megakernel.solve_flats(*cf, spec, hi - lo))
        vals = torch.cat([v for v, _ in outs], 1)
        ints = torch.cat([i for _, i in outs], 1)
        eager, _ = megakernel.split_outputs(vals, ints, spec)
        return megakernel.unpack_eager(eager.cpu().numpy(), spec.n)

    return solve


def probe_solve(layout, st, n, dev, chunk, packing, library_by):
    """The solve of one configuration: the shipped `build_mega_solve` for
    device packing, this probe's copy for host packing; under
    library_by "batch" every chunk takes the whole batch's library."""
    if packing == "device":
        inner = megakernel.build_mega_solve(layout, st, n, device=dev,
                                            chunk=chunk)
    else:
        inner = host_packed_solve(
            megakernel.make_spec(layout, st, n, True), dev, chunk)

    def solve(P, q, A, b):
        with library_of(len(q) if library_by == "batch" else None):
            return inner(P, q, A, b)

    return solve


def steps(solve_args, spec, chunk, packing, library_by, dev):
    """The solve's steps one at a time, each synchronised, ms."""
    raws = megakernel._as_host(*solve_args)
    B = raws[1].shape[0]
    t = {}
    t0 = time.perf_counter()
    const = [megakernel.is_const(r) for r in raws]
    t["const scan"] = (time.perf_counter() - t0) * 1e3
    dims = (spec.triu, spec.n, spec.n * spec.m, spec.m)
    width = sum(d for d, c in zip(dims, const) if not c)
    C = megakernel.chunk_lanes(width, B) if chunk is None else chunk
    flats = megakernel.shared_flats(raws, const, spec, dev)
    exts = megakernel._device_exts(spec, dev)
    t.update({"host packing": 0.0, "staging": 0.0, "copy": 0.0,
              "device gather": 0.0, "kernel": 0.0})
    outs = []
    idx = [i for i, c in enumerate(const) if not c]
    for lo in range(0, B, C):
        hi = min(B, lo + C)
        cf = list(flats)
        t0 = time.perf_counter()
        if packing == "host":
            arrays = [megakernel.host_pack(raws, const, spec, lo, hi)]
        else:
            arrays = [raws[i][lo:hi] for i in idx]
        t1 = time.perf_counter()
        pinned = []
        for a in arrays:
            buf = torch.empty(a.shape, dtype=torch.float64, pin_memory=True)
            buf.numpy()[...] = a
            pinned.append(buf)
        t2 = time.perf_counter()
        devs = [p.to(dev, non_blocking=True) for p in pinned]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if packing == "host":
            for i, f in enumerate(megakernel.split_packed(devs[0], const,
                                                          spec)):
                if f is not None:
                    cf[i] = f
        else:
            for i, d in zip(idx, devs):
                cf[i] = exts[i](d)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        with library_of(B if library_by == "batch" else None):
            outs.append(megakernel.solve_flats(*cf, spec, hi - lo))
        e1.record()
        torch.cuda.synchronize()
        t["host packing"] += (t1 - t0) * 1e3
        t["staging"] += (t2 - t1) * 1e3
        t["copy"] += (t3 - t2) * 1e3
        t["device gather"] += (t4 - t3) * 1e3
        t["kernel"] += e0.elapsed_time(e1)
    t0 = time.perf_counter()
    vals = torch.cat([v for v, _ in outs], 1)
    ints = torch.cat([i for _, i in outs], 1)
    eager, _ = megakernel.split_outputs(vals, ints, spec)
    megakernel.unpack_eager(eager.cpu().numpy(), spec.n)
    t["copy back"] = (time.perf_counter() - t0) * 1e3
    return t, C


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="4096,131072")
    ap.add_argument("--chunks", default="1024,2048,4096,8192,16384,32768,"
                                        "65536")
    ap.add_argument("--families", default="bench,psd3,exp")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    card = card_line()
    dev = torch.device("cuda")
    sizes = [int(s) for s in args.sizes.split(",")]
    chunks = [int(c) for c in args.chunks.split(",")]
    fams = {k: v for k, v in families().items()
            if k in args.families.split(",")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {card}; {sms} SMs; torch {torch.__version__}", flush=True)

    # build every library the configurations launch, in parallel
    variants = set()
    specs = {}
    for name, (cones, n, st, _) in fams.items():
        bs = ctt.BatchSolver(cones, n, st, device="cpu")
        spec = megakernel.make_spec(bs.layout, st, n, True)
        specs[name] = (bs.layout, spec)
        shape = _cuda.shape_of(spec)
        for B in sizes + chunks:
            variants.add(_cuda.variant_of(shape, B, sms))
    t0 = time.perf_counter()
    cuda_build.build_together((_cuda.megakernel, sorted(variants)))
    print(f"built {sorted(variants)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    readings = []
    for name, (cones, n, st, make) in fams.items():
        layout, spec = specs[name]
        big = make(max(sizes))
        grp = _cuda.group_eligible(_cuda.shape_of(spec))
        for B in sizes:
            data = tuple(a[:B] for a in big)
            configs = [(B, "host", "batch"), (B, "device", "batch"),
                       (None, "host", "batch"), (None, "device", "batch")]
            for c in chunks:
                if c < B:
                    for pk in ("host", "device"):
                        configs.append((c, pk, "batch"))
                        if grp:
                            configs.append((c, pk, "chunk"))
            ref = None
            for turn in range(args.turns):
                order = configs if turn % 2 == 0 else configs[::-1]
                for chunk, pk, lib in order:
                    fn = probe_solve(layout, st, n, dev, chunk, pk, lib)
                    before = dict(launches=_cuda.megakernel.launches,
                                  group=_cuda.megakernel.group_launches)
                    wall, out = best_wall(lambda: fn(*data))
                    launches = (_cuda.megakernel.launches
                                - before["launches"]) // 4
                    group = (_cuda.megakernel.group_launches
                             - before["group"]) // 4
                    st_ = np.asarray(out["status"])
                    solved = int((st_ == SOLVED).sum())
                    if ref is None:
                        ref = st_
                    t, C = steps(data, spec, chunk, pk, lib, dev)
                    r = dict(family=name, B=B, chunk=C,
                             rule=chunk is None, packing=pk, library_by=lib,
                             turn=turn, wall_ms=wall, solved=solved,
                             statuses_equal=bool(np.array_equal(st_, ref)),
                             launches=launches, group_launches=group,
                             solves_per_s=solved / wall * 1e3, card=card,
                             **{k: v for k, v in t.items()})
                    readings.append(r)
                    print(f"{name} B={B} chunk={C}{' (rule)' if chunk is None else ''} "
                          f"packing={pk} library_by={lib} turn {turn}: wall "
                          f"{wall:.2f} ms ({r['solves_per_s']:,.0f} "
                          f"solves/s), SOLVED {solved}, statuses equal "
                          f"{r['statuses_equal']}; launches {launches} "
                          f"(group {group}); steps ms: "
                          + ", ".join(f"{k} {v:.2f}" for k, v in t.items())
                          + f"; card {card}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, readings=readings), f, indent=1)


if __name__ == "__main__":
    main()
