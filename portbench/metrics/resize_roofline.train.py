"""Kernel 6's calls (ops/resize_bilinear.py) in a training step: their
least time, the input read and the output written once over 3.35 TB/s,
over the device time of the work launched inside their spans, in %. Its
backward is ATen's and lies outside the spans. A traced run wraps the
calls of the ops in OPS."""

from portbench import readers

OPS = ("resize_bilinear",)


def read(run):
    return readers.op_roofline(run, OPS)
