"""The reference forward's FLOPs a request over the traced time a request and the bf16 dense peak, in %."""

from portbench import readers


def read(run):
    return readers.mfu(run)
