"""Device: share of the traced window in which no kernel or copy ran on the
card, in %."""


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
