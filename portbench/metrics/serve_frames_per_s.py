"""Frames whose poses reached the host in the window, over its seconds."""

from portbench import readers


def read(run):
    return readers.rate(run, "serve")
