"""The op calls' least time from their shapes over the device time launched inside their spans, in %."""

from portbench import readers


def read(run):
    return readers.kernel_roofline(run)
