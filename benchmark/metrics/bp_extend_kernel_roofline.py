"""Share of its roofline of K1, the bit-parallel extension
(bp_extend_kernel), in %."""
from benchmark.metrics._roofline import share


def read(run):
    return share(run, "bp_extend_kernel")
