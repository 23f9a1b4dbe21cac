"""The span around the train step's losses stage, per step."""

from portbench import readers


def read(run):
    return readers.span_ms(run, "losses")
