#!/usr/bin/env python3
"""Which lanes the float32 first phase (K1e) leaves INSUFFICIENT_PROGRESS,
and why: an experiment on the plain PyTorch version, on the CPU.

    python3 tools/two_phase_handoff.py [--B 32768]

Solves the first B lanes of chip_smoke.py's psd3 batch
(`bench_data.make_sdp_batch(131072, 3, 13)`) with
`Settings(megakernel_two_phase=True)` through `ipm/megakernel_ref.py`,
lists the lanes that end INSUFFICIENT_PROGRESS with their iteration and
first-phase counts and whether the state handed to the float64 loop is
finite, and solves those lanes again four ways: the single phase; two
phases as they are; two phases with the reference's `_ArF32.sqrt`
mirrored in the first phase (a non-positive or NaN argument gives 0); two
phases with the `prev_*` values reset at the hand-off.  Each of the last
two patches the plain version inside this process only.  Imports no JAX.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import clarabel_tpu_torch as ctt  # noqa: E402
from clarabel_tpu_torch import bench_data  # noqa: E402
from clarabel_tpu_torch.ipm import megakernel, megakernel_ref as mr  # noqa

INSUFF = 10
CONES = [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)]


def solve(data, two_phase, variant=None):
    """(statuses, iterations, phase-1 iterations, the hand-off carry) of
    the plain version on `data`."""
    st = ctt.Settings(kkt_backend="megakernel",
                      megakernel_two_phase=two_phase)
    spec = ctt.BatchSolver(CONES, 3, st, device="cpu")._mega_fn.spec
    B, flats = megakernel.prepare(*data, spec, "cpu")
    saved, phase1, sqrt = {}, mr._phase1, torch.sqrt

    def handoff(*args):
        c = phase1(*args)
        saved.update(c)
        if variant == "reset prev_*":
            for k in ("prev_rp", "prev_rd", "prev_ga", "prev_gr"):
                c[k] = torch.full_like(c[k], mr.BIG)
        return c

    def sqrt32(x, *a, **kw):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return torch.where(x > 0, sqrt(x), torch.zeros_like(x))
        return sqrt(x, *a, **kw)

    mr._phase1 = handoff
    if variant == "sqrt clamp":
        torch.sqrt = sqrt32
    try:
        _, ints = mr.mega_solve_plain(*flats, spec, B)
    finally:
        mr._phase1, torch.sqrt = phase1, sqrt
    return ints[0].numpy(), ints[1].numpy(), ints[3].numpy(), saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=32768)
    args = ap.parse_args()
    big = bench_data.make_sdp_batch(131072, 3, 13)
    status, iters, p1, carry = solve(tuple(a[:args.B] for a in big), True)
    lanes = np.nonzero(status == INSUFF)[0]
    finite = all(bool(torch.isfinite(v[lanes]).all())
                 for v in carry.values() if v.dtype.is_floating_point)
    print(f"psd3, first {args.B} lanes, two phases: statuses "
          f"{np.bincount(status, minlength=11).tolist()}; "
          f"INSUFFICIENT_PROGRESS on lanes {lanes.tolist()}, at iterations "
          f"{iters[lanes].tolist()}, first-phase steps {p1[lanes].tolist()};"
          f" hand-off state finite on them: {finite}")
    sub = tuple(a[lanes] for a in big)
    for name, two, variant in (("single phase", False, None),
                               ("two phases", True, None),
                               ("two phases, sqrt clamp", True, "sqrt clamp"),
                               ("two phases, prev_* reset", True,
                                "reset prev_*")):
        s, it, _, _ = solve(sub, two, variant)
        print(f"those {len(lanes)} lanes alone, {name}: statuses "
              f"{s.tolist()}, iterations {it.tolist()}")


if __name__ == "__main__":
    main()
