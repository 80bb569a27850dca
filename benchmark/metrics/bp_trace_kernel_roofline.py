"""Share of its roofline of K2, the bit-parallel trace (bp_trace_kernel),
in %."""
from benchmark.metrics._roofline import share


def read(run):
    return share(run, "bp_trace_kernel")
