"""1 - the union of device-busy intervals over the traced window, in %."""

from portbench import readers


def read(run):
    return readers.device_idle(run)
