"""Kernels: the least time of the window's device work over the kernel time
in the trace, in %. The least time is the bytes counted by the cell's
reference from its own records and shapes (``device_bytes``: each input
byte read once, each output byte written once) at the card's HBM peak;
copies are not kernels and are left out of the time."""

from streambench import peaks


def read(run):
    if run.device is None or run.device.kernel_s <= 0:
        return None
    least_s = run.reference.device_bytes(
        run.expected, run.log, run.cell.config) / peaks.HBM_BYTES_PER_S
    return 100.0 * least_s / run.device.kernel_s
