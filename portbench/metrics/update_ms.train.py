"""The span around the train step's apply stage (the guard and Ranger), per step."""

from portbench import readers


def read(run):
    return readers.span_ms(run, "apply")
