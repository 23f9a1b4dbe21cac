"""The span around InferStep.solve, over the window, per request."""

from portbench import readers


def read(run):
    return readers.span_ms(run, "solve")
