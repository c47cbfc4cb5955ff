"""Device milliseconds per call of the traced window of every kernel that
is neither the megakernel K1 nor K2 (`kernels.is_loop_op`) nor a copy or
set: the loop solver's torch operations."""

from portbench import kernels


def read(run):
    if run.device is None:
        return None
    s = run.device.kernel_seconds(kernels.is_loop_op)
    return s / run.device.calls * 1e3 if s > 0 else None
