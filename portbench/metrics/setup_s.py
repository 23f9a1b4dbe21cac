"""Seconds from the process's start to the window's start: imports, the kernels' load, weights, the pool and the warm-up."""

from portbench import readers


def read(run):
    return run["setup_s"]
