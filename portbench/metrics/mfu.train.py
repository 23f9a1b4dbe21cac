"""The reference's forward, loss and backward FLOPs a step over the traced time a step and the bf16 dense peak, in %."""

from portbench import readers


def read(run):
    return readers.mfu(run)
