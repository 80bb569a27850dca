"""The port's other sweep forms must write the bytes of its single-host
run_overlap_plan (which tests/test_torch_sweep.py holds byte-equal to
damar_tpu's): two hosts over one directory; and
DAMAR_RESIDENT_BLOCKS=1, so that blocks are released and caches cleared
while a pair's emit is still pending on the worker thread.  Tolerance:
byte equality."""
import pytest
import torch

from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.pipeline import overlap as ov
from damar_tpu_torch.pipeline.planner import run_overlap_plan
from test_torch_sweep import MIN_LEN, assert_same_sweep, make_db, sweep_reads

torch.set_num_threads(2)
CFG = OverlapConfig(min_len=MIN_LEN)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-host sweep: (its directory, the reads, its stats)."""
    reads = sweep_reads()
    w = str(tmp_path_factory.mktemp("single"))
    db = make_db(w, reads)
    assert db.nblocks >= 3
    stats = run_overlap_plan(f"{w}/E.db", CFG, verbose=False, device="cpu")
    return w, reads, stats


def test_two_hosts_equal_one(single, tmp_path):
    w1, reads, stats = single
    w = str(tmp_path)
    make_db(w, reads)
    s0 = run_overlap_plan(f"{w}/E.db", CFG, verbose=False, nhosts=2,
                          host_id=0, device="cpu")
    # host 0 is done, host 1 has not run: no block has all its pairs
    assert s0["merges_deferred"] == 3
    s1 = run_overlap_plan(f"{w}/E.db", CFG, verbose=False, nhosts=2,
                          host_id=1, device="cpu")
    assert s0["pairs"] + s1["pairs"] == stats["pairs"]
    assert s0["overlaps"] + s1["overlaps"] == stats["overlaps"]
    assert_same_sweep(w1, w)


def test_one_resident_block_threaded(single, tmp_path, monkeypatch):
    """Every B block is released as the next one comes and the A block's
    cache is cleared at each new row, while the previous pair's emit
    still runs on the worker thread: its state holds what it reads."""
    w1, reads, stats = single
    w = str(tmp_path)
    make_db(w, reads)
    released = []
    real = ov.release_device_buffers
    monkeypatch.setattr(ov, "release_device_buffers",
                        lambda blk: released.append(1) or real(blk))
    monkeypatch.setenv("DAMAR_RESIDENT_BLOCKS", "1")
    got = run_overlap_plan(f"{w}/E.db", CFG, verbose=False, device="cpu")
    assert released
    assert got["pairs"] == stats["pairs"]
    assert got["overlaps"] == stats["overlaps"]
    assert_same_sweep(w1, w)
