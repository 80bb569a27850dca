"""Share of its roofline of K3, the 128-lane wide trace of K2's failures
(wide_trace_kernel), in %."""
from benchmark.metrics._roofline import share


def read(run):
    return share(run, "wide_trace_kernel")
