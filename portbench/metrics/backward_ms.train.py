"""The span around the train step's gradients stage, per step."""

from portbench import readers


def read(run):
    return readers.span_ms(run, "gradients")
