"""Seconds of seeding a pair (the program's t_seed: the k-mer index of B,
the hit scans, the seeds' sort), mean over the window's pairs."""
from benchmark.metrics._pairs import mean_of


def read(run):
    return mean_of(run, ('t_seed',))
