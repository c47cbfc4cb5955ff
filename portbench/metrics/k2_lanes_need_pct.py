"""The share of K2's factorizations that the lanes needed, over the traced
window: 100 x the sum over lanes of (iterations + 1) (one factorization
for the start and one an iteration) over the factorizations K2 was given
(its launches in the trace times the call's batch).  The rest is the
loop's policy of factoring every lane of the batch in each pass until its
slowest lane ends; a loop that factors only the lanes still running moves
this, and leaves K2's own work per factorization as it is."""

from portbench import kernels


def read(run):
    if run.device is None:
        return None
    launches = run.device.kernel_launches(kernels.is_k2)
    if launches <= 0:
        return None
    given = launches * run.cell.traffic["batch"]
    return 100.0 * (run.iterations + run.lanes) / given
