"""Two faults of damar_tpu's ring (damar_tpu/parallel/distributed.py),
each shown in the reference beside the port's result (ROADMAP.md §3):

- 3l: the grow ladder (:458-485) is `for _ in range(5): ... else:
  raise`, and the result of the fifth re-run is never checked: a matrix
  that fits after exactly five doublings of a cap raises ValueError.
  Shown with the hit cap on the grow case's DB (tests/
  test_torch_ring_grow.py): the reference raises at h0 and gives its
  bytes at 2 x h0 (four doublings); the port at h0 gives those bytes.
- 3m: the columnar dedupe packs the B-block index as int32 << 21
  (:500-503), which wraps from block 1,024 on, and :518-528 then file
  the kept records under other (A, B) pairs for 1,025 to 2,048 blocks.
  The reference's expression and the port's int64 keys are evaluated on
  the same arrays at B-blocks 1,023-2,047, and the port's dedupe pass is
  run on extents of such pairs.  A reference ring over 1,025 blocks is
  beyond tier-1's time.
Tolerance: byte equality of the .las shards; exact integers."""
import numpy as np
import pytest

from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.parallel import distributed as dd
from test_torch_ring import (SPREAD_CFG, las_bytes, reference_ring,
                             spread_blocks)


def test_fault_3l_fifth_doubling_is_checked(tmp_path):
    tmp = str(tmp_path)
    blocks, cfg = spread_blocks(8, 85, cov=4.0), OverlapConfig(**SPREAD_CFG)
    # the most hits of a pair: the port's sized buffers hold them all
    _, counts, _ = dd.distributed_overlap(blocks, cfg, device="cpu")
    top = int(counts[:, :, 2].max())
    h0 = top // 32 + 1
    assert h0 * 16 < top <= h0 * 32       # exactly five doublings
    rblocks = spread_blocks(8, 85, cov=4.0, ref=True)
    rcfg = RefConfig(seed_batch=256, **SPREAD_CFG)
    with pytest.raises(ValueError, match="still saturates"):
        reference_ring(tmp, rblocks, rcfg, seed_cap=1024, hit_cap=h0)
    want = reference_ring(tmp, rblocks, rcfg, seed_cap=1024,
                          hit_cap=2 * h0)
    las, counts, _ = dd.distributed_overlap_las(
        blocks, cfg, seed_cap=1024, hit_cap=h0, device="cpu")
    got = [las_bytes(las[i], f"{tmp}/port.{i}.las") for i in sorted(las)]
    assert got == want["shards"]
    np.testing.assert_array_equal(counts, want["counts"])


def test_fault_3m_block_index_keys():
    rng = np.random.default_rng(1023)
    jj = np.arange(1023, 2048)
    ii = rng.integers(0, 2048, len(jj))
    rows = np.zeros((len(jj), 8), np.int32)
    rows[:, 0] = rng.integers(0, 1 << 20, len(jj))
    rows[:, 1] = rng.integers(0, 1 << 20, len(jj))
    rows[:, 2] = rng.integers(0, 2, len(jj))
    # the reference's keys and their decoding (distributed.py:500-503,
    # :518-519), on the same arrays
    with np.errstate(over="ignore"):
        a_enc = (ii.astype(np.int32) << 20) | rows[:, 0]
        b_enc = ((jj.astype(np.int32) << 21) | (rows[:, 2] << 20)
                 | rows[:, 1])
    n = 2048
    pair = (a_enc.astype(np.int64) >> 20) * n + (b_enc.astype(np.int64)
                                                 >> 21)
    ref_i, ref_j = pair // n, pair % n
    wraps = jj >= 1024
    assert (ref_j[~wraps] == jj[~wraps]).all()
    assert ((ref_i != ii) | (ref_j != jj))[wraps].all()
    # the port's int64 keys give every field back, and their order is
    # the tuples' (i, aread, j, comp, bread)
    a_key, b_key = dd.dedupe_keys(ii, jj, rows)
    i2, ar2, j2, c2, br2 = dd.split_keys(a_key, b_key)
    for got, want in ((i2, ii), (ar2, rows[:, 0]), (j2, jj),
                      (c2, rows[:, 2]), (br2, rows[:, 1])):
        np.testing.assert_array_equal(got, want)
    order = np.lexsort((b_key, a_key))
    np.testing.assert_array_equal(order, np.lexsort(
        (rows[:, 1], rows[:, 2], jj, rows[:, 0], ii)))


def test_fault_3m_dedupe_files_records_under_their_pair():
    """The port's columnar dedupe over extents of pairs (i, j) with j in
    1,023-2,047 of a 2,048-block ring keeps each under its own pair."""
    rng = np.random.default_rng(7)
    exts = {}
    for j in (1023, 1024, 1500, 2047):
        for i in (0, 5, 2047):
            e = np.full((6, 8), -1, np.int32)
            e[:4, 0] = rng.integers(0, 50, 4)
            e[:4, 1] = rng.integers(0, 50, 4)
            e[:4, 2] = rng.integers(0, 2, 4)
            e[:4, 3], e[:4, 4] = 0, 1000 + np.arange(4)
            e[:4, 5], e[:4, 6] = 0, 1000 + np.arange(4)
            e[:4, 7] = 10
            exts[(i, j)] = e
    kept = dd._dedupe(exts, 2048, OverlapConfig(min_len=500))
    assert sorted(kept) == sorted(exts)
    for key, kr in kept.items():
        want = exts[key][:4]
        order = np.lexsort((want[:, 1], want[:, 2], want[:, 0]))
        np.testing.assert_array_equal(kr, want[order])
