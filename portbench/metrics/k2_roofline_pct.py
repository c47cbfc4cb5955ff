"""K2's share of its roofline over the traced window: the frozen
`k2_bound_ms(N, F)` at N = n + m (the dense ldl KKT) over K2's device
time, for F = the factorizations K2 was given: its launches in the
window's trace, each over the call's whole batch (the loop factors every
lane of its batch in each pass, `ipm/loop.py`).  This is the kernel's own
efficiency; how much of that work the lanes needed is the loop's, read by
`k2_lanes_need_pct`."""

from portbench import arith, kernels


def read(run):
    if run.device is None:
        return None
    s = run.device.kernel_seconds(kernels.is_k2)
    if s <= 0:
        return None
    cfg = run.cell.config
    given = run.device.kernel_launches(kernels.is_k2) * run.cell.traffic[
        "batch"]
    bound_ms = arith.k2_bound_ms(cfg["n"] + cfg["m"], given)[0]
    return 100.0 * bound_ms * 1e-3 / s
