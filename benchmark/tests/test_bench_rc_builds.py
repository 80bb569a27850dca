"""The reader of rc_device_builds_per_pair: the program's counter
rc_dev_built over the window's pairs, and no reading from a program
without it."""
import pytest

from benchmark import run


def reading(r):
    return run.load_metric("rc_device_builds_per_pair").read(r)


def test_reader_on_hand_made_units():
    r = dict(trace={}, units=[
        dict(pairs=[dict(rc_dev_built=1)]),
        dict(pairs=[dict(rc_dev_built=2), dict(rc_dev_built=0)])])
    assert reading(r) == pytest.approx(1.0)


def test_reader_gives_none_without_the_counter():
    assert reading(dict(trace={}, units=[dict(pairs=[dict(t_rc=2.0)])])) \
        is None
