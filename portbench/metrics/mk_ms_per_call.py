"""Device milliseconds of the megakernel launches (K1, `kernels.is_k1`)
per call of the traced window; None where the window launched none."""

from portbench import kernels


def read(run):
    if run.device is None:
        return None
    s = run.device.kernel_seconds(kernels.is_k1)
    return s / run.device.calls * 1e3 if s > 0 else None
