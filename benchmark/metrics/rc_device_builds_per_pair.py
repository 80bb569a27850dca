"""Reverse-complement twins made on the device a pair (the program's
counter rc_dev_built: a twin's bases made by its revcomp kernel from the
block's device-resident forward bases, at their first use), mean over
the window's pairs.  Each build is work, so fewer is better: 1.0 where
every pair brings a new B block, less where twins outlive their pair."""
from benchmark.metrics._pairs import mean_of


def read(run):
    return mean_of(run, ('rc_dev_built',))
