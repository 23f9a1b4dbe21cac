"""The least time that kernels 1-5's calls allow from their shapes over
the device time of the work launched inside their spans, in %: the sum
over readers.KERNELS_1_5 (linear_multi, surface_multi, aggregate, knn,
nearest_multi) alone; an op added later has a reading of its own. A
traced run wraps the calls of the ops in OPS."""

from portbench import readers

OPS = readers.KERNELS_1_5


def read(run):
    return readers.op_roofline(run, OPS)
