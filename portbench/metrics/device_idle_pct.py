"""100 x (1 - the union of the device's busy intervals (kernels, copies
and sets) over the traced window's length): the share of the window in
which the card ran nothing."""


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
