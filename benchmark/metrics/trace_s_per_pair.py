"""Seconds of trace and emit a pair (t_trace: K2, K3's retries, the
host's records and sort), mean over the window's pairs."""
from benchmark.metrics._pairs import mean_of


def read(run):
    return mean_of(run, ('t_trace',))
