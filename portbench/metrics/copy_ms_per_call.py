"""Device milliseconds of the memcpy and memset work (host to device and
back, the megakernel path's staging) per call of the traced window."""


def read(run):
    if run.device is None:
        return None
    s = run.device.copy_seconds()
    return s / run.device.calls * 1e3 if s > 0 else None
