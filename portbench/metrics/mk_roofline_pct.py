"""The megakernel's share of its roofline over the traced window: the
least time the card could take for the work the lanes needed, over the
device time of the K1 launches.

Least time = max(FP64 operations at the FP64 peak, bytes at the HBM
peak).  Operations: the frozen `flops_per_iteration(n, m, segs, 0)` (no
refinement passes: a lower bound) times the iterations summed over every
lane of every call, whichever of K1's sources ran them.  Bytes: each lane's
inputs read once (P, q, A and b in float64, as the caller hands them in)
and its outputs written once (x, z, s, the objective and two residuals in
float64; status and iterations in int32), from the configuration's shapes.
"""

from portbench import arith, kernels


def read(run):
    if run.device is None:
        return None
    kernel_s = run.device.kernel_seconds(kernels.is_k1)
    if kernel_s <= 0:
        return None
    cfg = run.cell.config
    n, m = cfg["n"], cfg["m"]
    ops = arith.flops_per_iteration(n, m, arith.segments(cfg["cones"]),
                                    0) * run.iterations
    per_lane = 8 * (n * n + n + m * n + m) + 8 * (n + 2 * m + 3) + 2 * 4
    least = max(ops / arith.FP64_RATE, run.lanes * per_lane / arith.HBM_RATE)
    return 100.0 * least / kernel_s
