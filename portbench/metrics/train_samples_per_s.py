"""Samples of the train steps completed in the window, over its seconds."""

from portbench import readers


def read(run):
    return readers.rate(run, "train")
