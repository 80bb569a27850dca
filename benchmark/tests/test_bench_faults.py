"""`correct` comes out false when the timed path is broken underneath a
run (benchmark/faults.py), with the harness's look for a card skipped:
the control (-k15 -h100) and each fault a cell can have, on both
entries, on the CPU at a small size; and true when nothing is broken."""
import pytest

from benchmark import faults, run
from benchmark.tests import tiny

CELLS = ["ecoli-k12-clr30x.sweep", "dmel-r6-clr30x-b100.pair"]


def one_run(cell, breaker=None, trace=False):
    wl, cfg = tiny.load(cell)
    return run.run_cell(cell, 2 ** 31 + 77, 0.5, trace, device="cpu",
                        workload=wl, config=cfg, breaker=breaker)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res, checks = one_run(cell, trace=True)
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert "breakdown" in res


@pytest.mark.parametrize("kind", sorted(faults.BREAKERS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(cell, kind):
    res, checks = one_run(cell, faults.BREAKERS[kind])
    assert not res["correct"], checks
