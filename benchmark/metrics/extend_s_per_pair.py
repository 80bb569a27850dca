"""Seconds of extension and dedupe a pair (t_extend + t_dedupe: K1's
phases and the host dedupe), mean over the window's pairs."""
from benchmark.metrics._pairs import mean_of


def read(run):
    return mean_of(run, ('t_extend', 't_dedupe'))
