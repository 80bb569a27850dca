"""overlap_pairs_pipelined of the port (one form on every device: the
emit on a worker thread), without size_hints, with empty ones and with
hints far too small, must give the outputs of a plain loop of
overlap_block_pair (which the slice and sweep tests hold byte-equal to
damar_tpu).  Also: the size_hints rule, release_device_buffers against a
pending emit, and a failing prefetch is logged where the reference
swallows it.  Tolerance: array equality."""
import logging

import numpy as np
import pytest
import torch

from damar_tpu_torch.core.blocks import block_from_db, block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.pipeline import overlap as ov
from test_torch_sweep import MIN_LEN, make_db, sweep_reads

torch.set_num_threads(2)
CFG = OverlapConfig(min_len=MIN_LEN)


def same_las(x, y):
    for k in ("headers", "trace", "offsets"):
        np.testing.assert_array_equal(getattr(x.columns, k),
                                      getattr(y.columns, k))


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """Two pairs of a 3-block DB through a plain loop of
    overlap_block_pair: (the pairs, their outputs)."""
    db = make_db(str(tmp_path_factory.mktemp("db")), sweep_reads())
    b1, b2 = block_from_db(db, 1), block_from_db(db, 2)
    pairs = [(b1, b1, True), (b1, b2, False)]
    return pairs, [ov.overlap_block_pair(a, b, CFG, s, device="cpu")
                   for a, b, s in pairs]


@pytest.mark.parametrize("hints", [None, {}, {"raw": 2, "nnz": 2}],
                         ids=["none", "empty", "too_small"])
def test_pipelined_equals_loop(loop, hints):
    pairs, want = loop
    sh = None if hints is None else dict(hints)
    jobs = [dict(tag=k, blk_a=a, blk_b=b, self_block=s, size_hints=sh)
            for k, (a, b, s) in enumerate(pairs)]
    pulled = []

    def job_iter():
        for job in jobs:
            pulled.append(job["tag"])
            yield job

    got = []
    for out in ov.overlap_pairs_pipelined(job_iter(), CFG, device="cpu"):
        # results come in submission order; the sweep has pulled the
        # next job (after this pair's device phases) by then
        got.append(out)
        assert out[0] == len(got) - 1
        assert len(pulled) == min(len(got) + 1, len(jobs))
    assert len(got) == len(want)
    for (tag, la, lb, st), (wa, wb, wst) in zip(got, want):
        same_las(la, wa)
        same_las(lb, wb)
        for k in ("seeds", "extents", "kept", "dropped_trace",
                  "trace_retries"):
            assert st[k] == wst[k], k
    assert got[0][1].novl > 0 and got[1][2].novl > 0
    if sh is not None:
        assert sh["raw"] > 2 and sh["nnz"] > 2


def test_size_hints_running_max_halved():
    """raw/nnz follow the reference's rule: max(this pair's exact total,
    half the previous hint)."""
    reads = sweep_reads().reads[:60]
    blk = block_from_reads(reads)
    sh = {"raw": 1 << 30, "nnz": 1 << 30}
    st = ov.overlap_pair_device(blk, blk, CFG, True, size_hints=sh,
                                device="cpu")
    assert sh == {"raw": 1 << 29, "nnz": 1 << 29}
    assert not st["stats"]["seed_overflow"]
    sh = {"raw": 2, "nnz": 2}             # far too small: grown, exact
    ov.overlap_pair_device(blk, blk, CFG, True, size_hints=sh, device="cpu")
    assert sh["raw"] > 2 and sh["nnz"] > 2


def test_prefetch_failure_is_logged(monkeypatch, caplog):
    """The reference swallows a failed prefetch; the port logs it (and the
    pair's own upload then fails loudly)."""
    class Blk:
        cap = 1 << 20

    def boom(*a, **k):
        raise RuntimeError("upload failed")
    monkeypatch.setattr(ov, "_dev_arr", boom)
    with caplog.at_level(logging.WARNING, logger=ov.log.name):
        ov._prefetch(dict(blk_a=Blk(), blk_b=None), "cpu")
    assert "prefetch" in caplog.text and "upload failed" in caplog.text
    big = Blk()
    big.cap = ov.PREFETCH_CAP + 1           # too large: not prefetched
    caplog.clear()
    ov._prefetch(dict(blk_a=big), "cpu")
    assert caplog.text == ""


def test_release_device_buffers_keeps_host_caches():
    reads = sweep_reads().reads[:40]
    blk = block_from_reads(reads)
    state = ov.overlap_pair_device(blk, blk, CFG, True, device="cpu")
    assert {"dev_arrs", "trace_pool", "a_index", "rc_block"} <= set(blk.cache)
    rc = blk.cache["rc_block"]
    assert "dev_arrs" in rc.cache
    ov.release_device_buffers(blk)
    assert set(blk.cache) == {"rc_block", "mp_base"}      # host arrays
    assert "dev_arrs" not in rc.cache
    # the state still holds the pool: emit runs without the caches
    la, lb, _ = ov.overlap_pair_emit(state)
    assert "trace_pool" not in blk.cache
    wa, wb, _ = ov.overlap_block_pair(blk, blk, CFG, True, device="cpu")
    same_las(la, wa)
    same_las(lb, wb)
