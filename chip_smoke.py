#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (clarabel_tpu_torch) on one NVIDIA card.

Builds the batched IPM megakernel (clarabel_tpu_torch/csrc/megakernel.cu)
from the sources beside this script, holds it against its plain PyTorch
version on the card, drives the port's main path (`BatchSolver.solve` on
the bench shape: n=6, cones [NN(6), SOC(7)], 1e-8 tolerances) at B = 4096,
65536 and 131072, and prints what it measured.  Every phase fails the run
(non-zero exit) when its bar is not met.

    python3 chip_smoke.py

It needs one CUDA card and exits non-zero without one, or when the port's
package is not beside it.  The line before the last is a JSON object with
the kernel's numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the full power limit): HBM
# bandwidth in bytes/s and FP64 outside the tensor cores in operations/s
# (the kernel issues plain FP64 FMAs)
HBM_RATE, FP64_RATE = 3.35e12, 34e12

BENCH_N = 6
THROUGHPUT_BATCHES = (4096, 65536, 131072)

# Parity bars, kernel against its plain version on the card, per batch: x
# on the lanes both solve, and iterations within 1 on a share of those
# lanes and within a maximum on all.  Fixed from the readings of the kernel
# and of the plain version under a 1e-15 change of q (PERF.md;
# clarabel_tpu_torch/DEVIATIONS.md #4).  Objectives within OBJ_TOL and the
# true-KKT residuals of the kernel's SOLVED lanes below KKT_TOL (|s'z|
# below SZ_TOL) hold on every batch.
BARS = {
    "bench": dict(x=1e-4, within1=0.99, it_max=4),
    "qp_eq": dict(x=1e-6, within1=0.99, it_max=4),
    "infeasible": dict(x=1e-4, within1=0.99, it_max=4),
    "lp": dict(x=3e-4, within1=0.96, it_max=15),
}
OBJ_TOL, KKT_TOL, SZ_TOL = 1e-6, 1e-7, 1e-6

# Wrong kernels: the kernel run with one setting changed, as a fault in
# one constant or one stage would change it.  The bars must reject each of
# them on every batch.
WRONG_KERNELS = {
    "step fraction 0.95": {"max_step_fraction": 0.95},
    "no refinement": {"iterative_refinement_enable": False},
    "gap tolerances 1e-7": {"tol_gap_abs": 1e-7, "tol_gap_rel": 1e-7},
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def flops_per_iteration(n, m, segs, passes):
    """FP64 operations of one IPM iteration of the kernel, counted from
    its code with `passes` refinement passes per refined solve; an FMA
    counts two.  A lower bound: the small per-segment scalar work and
    the comparisons are left out."""
    n_soc = sum(hi - lo for k, lo, hi in segs if k == "soc")
    hinv = m + 4 * n_soc                      # one Hs^-1 (or Hs) apply
    matvec = 2 * m * n                        # A x or A' y
    pmv = 2 * n * n                           # P x
    chol_solve = 2 * n * n
    apply_once = 2 * hinv + 2 * matvec + chol_solve + n + m
    resid = 2 * matvec + pmv + hinv + 2 * (n + m)
    build = n * (hinv + (n + 1) * m) + n * n * n // 3 + n * n
    # 2-RHS solve (affine + constant) and 1-RHS corrector, each with its
    # first residual evaluation and `passes` (apply + residual) passes
    solves = 3 * (apply_once + resid) * (1 + passes) - 3 * resid
    residuals = 2 * matvec + pmv + 6 * (n + m) + 4 * n
    info = 8 * (n + m) + 20
    scaling = 8 * (m - n_soc) + 20 * n_soc
    tau = 3 * pmv + 12 * (n + m)
    steps = 2 * 2 * 8 * m                     # affine + combined step lengths
    shifts = 3 * 12 * m                       # affine_ds, combined shift, ds
    return (residuals + info + scaling + build + solves + tau + steps
            + shifts)


def true_kkt(P, q, A, b, x, z, s):
    rp = np.linalg.norm(np.einsum("bij,bj->bi", A, x) + s - b, axis=1)
    rd = np.linalg.norm(np.einsum("bij,bj->bi", P, x) + q
                        + np.einsum("bji,bj->bi", A, z), axis=1)
    return rp, rd, np.abs(np.einsum("bi,bi->b", s, z))


def main():
    if not os.path.isdir(os.path.join(HERE, "clarabel_tpu_torch")):
        fail("clarabel_tpu_torch/ is not beside chip_smoke.py: run it from "
             "a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, HERE)
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch import bench_data
    from clarabel_tpu_torch.ipm import _cuda, megakernel, megakernel_ref
    from clarabel_tpu_torch.statuscodes import SolverStatus

    if any(k == "jax" or k.startswith(("jax.", "clarabel_tpu."))
           or k == "clarabel_tpu" for k in sys.modules):
        fail("the port pulled in JAX or the JAX package")

    SOLVED = int(SolverStatus.SOLVED)
    INF = {int(SolverStatus.PRIMAL_INFEASIBLE),
           int(SolverStatus.DUAL_INFEASIBLE),
           int(SolverStatus.ALMOST_PRIMAL_INFEASIBLE),
           int(SolverStatus.ALMOST_DUAL_INFEASIBLE)}
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: device and toolchain, kernel build ----
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"],
                          capture_output=True, text=True)
    print(f"[1] card: {card}", flush=True)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"[1] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    nn_soc = [ctt.NonnegativeConeT(BENCH_N), ctt.SecondOrderConeT(BENCH_N + 1)]
    qp_cones = [ctt.ZeroConeT(1), ctt.NonnegativeConeT(BENCH_N + 1)]
    cases = {
        "bench": (nn_soc, True, bench_data.make_batch(4096, BENCH_N, 0)),
        "qp_eq": (qp_cones, True, bench_data.make_qp_eq(4096, BENCH_N, 1)),
        "infeasible": (nn_soc, True,
                       bench_data.make_infeasible_batch(4096, BENCH_N, 2)),
        "lp": (nn_soc, False, bench_data.make_lp_batch(4096, BENCH_N, 3)),
    }
    solvers = {name: ctt.BatchSolver(c, BENCH_N, ctt.Settings(),
                                     p_nonzero=pn)
               for name, (c, pn, _) in cases.items()}
    shapes = sorted({_cuda.shape_of(s._mega_fn.spec)
                     for s in solvers.values()})
    t0 = time.perf_counter()
    _cuda.megakernel.build(shapes)
    print(f"[1] built {len(shapes)} kernel shapes {shapes} in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc)", flush=True)
    for shape, log in _cuda.megakernel.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print(f"[1] ptxas {shape}: {line.strip()}")

    def events_ms(fn, reps):
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

    # ---- phases 2-3: kernel vs plain version on the card ----
    def outputs(vals, ints, spec):
        eager, rest = megakernel.split_outputs(vals, ints, spec)
        o = megakernel.unpack_eager(eager.cpu().numpy(), spec.n)
        o.update(megakernel.unpack_rest(rest.cpu().numpy(), spec.m))
        return o

    def readings(k, p, P, q, A, b):
        """What output k reads against the plain version's output p."""
        ks, ps = k["status"] == SOLVED, p["status"] == SOLVED
        both = ks & ps
        dx = np.abs(k["x"] - p["x"]).max(axis=1)[both]
        dobj = np.abs(k["obj_val"] - p["obj_val"])[both]
        dit = np.abs(k["iterations"] - p["iterations"])[both]
        rp, rd, sz = true_kkt(P, q, A, b, k["x"], k["z"], k["s"])
        return dict(
            solved=int(ks.sum()), plain_solved=int(ps.sum()),
            both=int(both.sum()), dx=dx.max(initial=0.0),
            dx_lanes=int((dx > 1e-6).sum()), dobj=dobj.max(initial=0.0),
            equal=(dit == 0).mean() if dit.size else 1.0,
            within1=(dit <= 1).mean() if dit.size else 1.0,
            it_max=int(dit.max(initial=0)),
            kkt=max(rp[ks].max(initial=0.0), rd[ks].max(initial=0.0)),
            sz=sz[ks].max(initial=0.0))

    def violations(r, bars, B):
        """The bars that readings r fail."""
        out = []
        if r["solved"] < r["plain_solved"] - 0.001 * B:
            out.append("SOLVED count")
        if r["dobj"] > OBJ_TOL:
            out.append("objective")
        if r["dx"] > bars["x"]:
            out.append("x")
        if r["within1"] < bars["within1"] or r["it_max"] > bars["it_max"]:
            out.append("iterations")
        if r["kkt"] >= KKT_TOL or r["sz"] >= SZ_TOL:
            out.append("true KKT")
        return out

    def describe(r):
        return (f"SOLVED {r['solved']} (plain {r['plain_solved']}); on the "
                f"{r['both']} lanes both solve: max|dx| {r['dx']:.3e} "
                f"({r['dx_lanes']} lanes > 1e-6), max|dobj| {r['dobj']:.3e}, "
                f"iters equal on {r['equal']:.4f}, within 1 on "
                f"{r['within1']:.4f}, max diff {r['it_max']}; true KKT "
                f"{r['kkt']:.3e}, |s'z| {r['sz']:.3e}")

    failures = []

    def check(name):
        cones, pn, (P, q, A, b) = cases[name]
        spec = solvers[name]._mega_fn.spec
        bars = BARS[name]
        if P is None:
            P = np.zeros((q.shape[0], BENCH_N, BENCH_N))
        B, flats = megakernel.prepare(P, q, A, b, spec, dev)
        k_ms, (kv, ki) = events_ms(
            lambda: _cuda.megakernel(*flats, spec, B), 3)
        p_ms, (pv, pi) = events_ms(
            lambda: megakernel_ref.mega_solve_plain(*flats, spec, B), 1)
        k, p = outputs(kv, ki, spec), outputs(pv, pi, spec)
        # the plain version again with q moved by 1e-15 (relative): how far
        # rounding alone moves x and the iteration count on this batch
        qj = q * (1 + 1e-15 * np.random.default_rng(7).standard_normal(
            q.shape))
        _, flats_j = megakernel.prepare(P, qj, A, b, spec, dev)
        pj = outputs(*megakernel_ref.mega_solve_plain(*flats_j, spec, B),
                     spec)
        tag = f"[{2 if name == 'bench' else 3}] {name} B={B}"

        def bar(ok, msg):
            if not ok:
                print(f"FAIL: {tag}: {msg}", flush=True)
                failures.append(f"{tag}: {msg}")

        r = readings(k, p, P, q, A, b)
        print(f"{tag}: kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms; kernel "
              f"statuses {np.bincount(k['status'], minlength=11).tolist()}",
              flush=True)
        print(f"{tag}: kernel vs plain: {describe(r)}", flush=True)
        print(f"{tag}: plain(q*(1+1e-15*xi)) vs plain: "
              f"{describe(readings(pj, p, P, qj, A, b))}", flush=True)
        print(f"{tag}: bars: x {bars['x']:.0e}, iters within 1 on "
              f"{bars['within1']} and within {bars['it_max']} on all, "
              f"objective {OBJ_TOL:.0e}, true KKT {KKT_TOL:.0e}, |s'z| "
              f"{SZ_TOL:.0e}, SOLVED at least plain less 0.1 % of B")
        for v in violations(r, bars, B):
            bar(False, f"the kernel fails the {v} bar")
        bar(all(np.isfinite(k[f]).all() for f in ("x", "z", "s")),
            "non-finite x/z/s from the kernel")
        inf_lane = np.isin(k["status"], list(INF))
        bar((np.isnan(k["obj_val"]) == inf_lane).all(),
            "objective not NaN exactly on the infeasible lanes")
        if name == "infeasible":
            lanes = bench_data.infeasible_lanes(B)
            ok = np.isin(k["status"][lanes],
                         [int(SolverStatus.PRIMAL_INFEASIBLE),
                          int(SolverStatus.ALMOST_PRIMAL_INFEASIBLE)])
            bar(ok.all(), f"infeasible lanes not detected: "
                f"{k['status'][lanes][~ok][:10]}")
            bar(np.delete(k["status"] == SOLVED, lanes).mean() >= 0.99,
                "feasible lanes not solved")
        # the bars must tell a wrong kernel from this one
        for wname, change in WRONG_KERNELS.items():
            wspec = dataclasses.replace(spec, st=spec.st.replace(**change))
            w = outputs(*_cuda.megakernel(*flats, wspec, B), spec)
            rw = readings(w, p, P, q, A, b)
            rejected = violations(rw, bars, B)
            print(f"{tag}: wrong kernel ({wname}) vs plain: "
                  f"{describe(rw)}; rejected by: "
                  f"{', '.join(rejected) or 'none'}", flush=True)
            bar(rejected, f"the bars pass the wrong kernel ({wname})")
        return dict(ms=k_ms, plain_ms=p_ms,
                    max_abs_err=max(r["dx"], r["dobj"]), iters=k["iterations"], spec=spec, B=B, flats=flats)

    results = {name: check(name) for name in cases}

    # ---- phase 4: throughput through BatchSolver.solve ----
    big = bench_data.make_batch(max(THROUGHPUT_BATCHES), BENCH_N, 0)
    bs = solvers["bench"]
    spec = bs._mega_fn.spec
    kernel_ms = {}
    for B in THROUGHPUT_BATCHES:
        data = tuple(a[:B] for a in big)
        _, flats = megakernel.prepare(*data, spec, dev)
        kernel_ms[B], _ = events_ms(
            lambda: _cuda.megakernel(*flats, spec, B), 3)
        del flats
    torch.cuda.synchronize()

    _cuda.megakernel.launches = 0          # the main path's run starts here
    lines = []
    for B in THROUGHPUT_BATCHES:
        data = tuple(a[:B] for a in big)
        bs.solve(*data)                    # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = bs.solve(*data)
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        solved = int((out.status == SOLVED).sum())
        lines.append(
            f"[4] B={B}: {solved / wall:,.0f} solves/s wall (host arrays to "
            f"host results, best of 3: {wall * 1e3:.2f} ms), "
            f"{solved / (kernel_ms[B] / 1e3):,.0f} solves/s kernel-only "
            f"({kernel_ms[B]:.3f} ms); mean iters "
            f"{out.iterations.mean():.3f}; not SOLVED {B - solved}; "
            f"card {card}")
    launches = _cuda.megakernel.launches   # ... and ends here
    for line in lines:
        print(line, flush=True)
    print(f"[4] megakernel launches on the main path: {launches}")
    if launches <= 0:
        fail("BatchSolver.solve did not launch the CUDA kernel")
    print(f"[4] plain version on the card, bench B=4096: "
          f"{results['bench']['plain_ms']:.1f} ms (no yardstick); card {card}")

    # where one solve's wall time goes at the largest batch: packing on the
    # host, packing plus the copy to the card, the kernel, and the copy
    # back with unpacking (each step synchronised; host clock)
    data = tuple(a[:max(THROUGHPUT_BATCHES)] for a in big)
    marks = [time.perf_counter()]
    megakernel.prepare(*data, spec, "cpu")
    marks.append(time.perf_counter())
    B, flats = megakernel.prepare(*data, spec, dev)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    vals, ints = _cuda.megakernel(*flats, spec, B)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    eager, _ = megakernel.split_outputs(vals, ints, spec)
    megakernel.unpack_eager(eager.cpu().numpy(), spec.n)
    marks.append(time.perf_counter())
    steps = np.diff(marks) * 1e3
    print(f"[4] B={len(data[1])} one solve, ms: host packing {steps[0]:.2f}; "
          f"packing + copy to the card {steps[1]:.2f}; kernel {steps[2]:.2f}; "
          f"copy back + unpack {steps[3]:.2f}; card {card}")

    # bound: the larger of bytes over HBM bandwidth and FP64 operations of
    # this run's iterations over the FP64 rate (bench shape, B=4096)
    r = results["bench"]
    spec, B = r["spec"], r["B"]
    in_bytes = sum(t.numel() * 8 for t in r["flats"])
    out_bytes = B * (spec.outd * 8 + 2 * 4)
    passes = 0   # a lower bound: refinement passes taken would add work
    flops = int(r["iters"].sum()) * flops_per_iteration(
        spec.n, spec.m, spec.segs, passes)
    bytes_ms = (in_bytes + out_bytes) / HBM_RATE * 1e3
    ops_ms = flops / FP64_RATE * 1e3
    print(f"[4] bound at bench B={B}: {flops:.3e} FP64 ops -> {ops_ms:.4f} ms,"
          f" {in_bytes + out_bytes} bytes -> {bytes_ms:.4f} ms")
    if failures:
        fail("; ".join(failures))
    kernels = [{
        "name": "megakernel",
        "route": "cuda",
        "source": "clarabel_tpu_torch/csrc/megakernel.cu",
        "replaces": "clarabel_tpu/ipm/megakernel.py:3523",
        "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in results.values()),
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
