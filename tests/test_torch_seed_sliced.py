"""Port vs reference: the sliced seeding path of find_seeds_canonical_dev
(the emitting tuples compacted chunk by chunk, split by B read into two
slices, each slice filled and banded, the seeds merged by their band
keys), forced at small sizes in both packages by lowering _SLICE_CAP
and _SLICE_CHUNK, as damar_tpu's own tests/test_overlap.py
(TestSlicedSeeding) does.  Tolerance: exact equality (integers).

The port's sliced seeds equal the reference's sliced seeds and its own
unsliced ones, on self and distinct pairs, masked and not (the .las
bytes of a forced-sliced pair: tests/test_torch_seed_las.py).  Off those
paths, the reference's faults in its sliced path (ROADMAP.md section 3)
and how the port avoids them:
- 3a: the reference takes slice 1 through a window of the rounded-up
  slice size, which it moves back when it runs past the stream's end,
  so slice 0's tail is seeded twice and slice 1's tail never;
- 3b: the reference needs the tuple table to be a multiple of the chunk;
- 3c: under an explicit hit_cap each of the reference's slices may fill
  up to that cap, so the pair exceeds it and no overflow is reported."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.ops import seeding as ref_seeding
from damar_tpu.utils.sim import make_genome, sample_reads
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.ops import seeding

torch.set_num_threads(2)
COLS = ("aread", "bread", "apos", "bpos", "cov", "comp")
# below every pair's hits and the 2^17 buffer floor, so every pair here
# takes the sliced path, with hit_cap None (the port sizes from the
# total) or explicit (both packages size from the capped buffer)
SLICE_CAP = 1 << 10
HIT_CAP, SEED_CAP = 1 << 22, 1 << 15


@pytest.fixture(scope="module")
def reads():
    g = make_genome(40_000, seed=61)
    return sample_reads(g, coverage=8.0, mean_len=3000, err=0.13,
                        seed=62).reads


def _mask(cap, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros(cap, bool)
    for s in rng.integers(0, cap, cap // 2000):
        m[s:s + int(rng.integers(50, 400))] = True
    return m


def _sliced(monkeypatch, chunk=1 << 19):
    for mod in (seeding, ref_seeding):
        monkeypatch.setattr(mod, "_SLICE_CAP", SLICE_CAP)
        monkeypatch.setattr(mod, "_SLICE_CHUNK", chunk)


def _port(pa, pb, self_pair, ma=None, mb=None, **kw):
    t = lambda m: None if m is None else torch.as_tensor(m)  # noqa: E731
    kw = dict(dict(hit_cap=HIT_CAP, seed_cap=SEED_CAP), **kw)
    return seeding.find_seeds_canonical_dev(
        pa, pb, OverlapConfig(), mask_a=t(ma), mask_b=t(mb),
        upper_only=self_pair, self_pair=self_pair, device="cpu", **kw)


def _ref(ra, rb, self_pair, ma=None, mb=None, **kw):
    j = lambda m: None if m is None else jnp.asarray(m)  # noqa: E731
    kw = dict(dict(hit_cap=HIT_CAP, seed_cap=SEED_CAP), **kw)
    r = ref_seeding.find_seeds_canonical_dev(
        ra, rb, RefConfig(), mask_a=j(ma), mask_b=j(mb),
        upper_only=self_pair, self_pair=self_pair, **kw)
    return {k: np.asarray(v) for k, v in r.items()}


def _rows(r):
    n = int(r["nseeds"])
    return np.stack([np.asarray(r[k])[:n] for k in COLS], axis=1)


def _same(want, got):
    """Same seeds in the same order, same totals."""
    for k in ("nseeds", "total_seeds", "total_hits"):
        assert int(want[k]) == int(got[k]), k
    np.testing.assert_array_equal(_rows(got), _rows(want))


def _blocks(reads, self_pair):
    if self_pair:
        return ref_block(reads), ref_block(reads), \
            block_from_reads(reads), block_from_reads(reads)
    h = len(reads) // 2
    return (ref_block(reads[:h]), ref_block(reads[h:]),
            block_from_reads(reads[:h]), block_from_reads(reads[h:]))


@pytest.mark.parametrize("self_pair", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_sliced_equals_reference_and_unsliced(reads, monkeypatch,
                                              self_pair, masked):
    ra, rb, pa, pb = _blocks(reads, self_pair)
    ma = _mask(pa.cap, 5) if masked else None
    mb = None if self_pair or not masked else _mask(pb.cap, 6)
    unsliced = _port(pa, pb, self_pair, ma, mb)
    assert unsliced["path"] == "packed"
    _sliced(monkeypatch)
    got = _port(pa, pb, self_pair, ma, mb)
    want = _ref(ra, rb, self_pair, ma, mb)
    assert got["path"] == "sliced" and int(got["nseeds"]) > 100
    assert all(s["hits"] > 0 for s in got["slices"])
    assert not got["overflow"] and not bool(want["overflow"])
    assert got["total_emit"] == int(want["total_emit"])
    _same(want, got)
    _same(unsliced, got)


def test_skewed_split_fault_3a(reads, monkeypatch):
    """B's first reads short, so slice 0 is small and slice 1's rounded
    window runs past the end of the reference's stream (one chunk here):
    the reference seeds slice 0's tuples twice and loses slice 1's tail.
    The port takes each slice's rows exactly."""
    h = len(reads) // 2
    short = [r[:400] for r in reads[h:h + h // 2]]
    b_reads = short + list(reads[h + h // 2:])
    ra, rb = ref_block(reads[:h]), ref_block(b_reads)
    pa, pb = block_from_reads(reads[:h]), block_from_reads(b_reads)
    unsliced = _port(pa, pb, False)
    _sliced(monkeypatch, chunk=1 << 20)
    got = _port(pa, pb, False)
    n0, n1 = (s["tuples"] for s in got["slices"])
    assert got["path"] == "sliced" and 0 < 4 * n0 < n1
    _same(unsliced, got)
    want = _ref(ra, rb, False)
    rows = _rows(want)
    dup = (rows[1:] == rows[:-1]).all(axis=1).sum()
    assert dup > 0 and int(want["total_seeds"]) != got["total_seeds"]
    assert len(np.unique(rows, axis=0)) < len(rows)


def test_ragged_table_fault_3b(reads, monkeypatch):
    """A chunk that does not divide the tuple table: the reference
    cannot reshape its per-chunk counts; the port's last chunk is what
    is left, and its seeds are the unsliced ones."""
    ra, rb, pa, pb = _blocks(reads, True)
    unsliced = _port(pa, pb, True)
    _sliced(monkeypatch, chunk=300_000)
    assert pa.cap % 300_000
    got = _port(pa, pb, True)
    assert got["path"] == "sliced"
    _same(unsliced, got)
    with pytest.raises(TypeError, match="reshape"):
        _ref(ra, rb, True)


def test_explicit_cap_overflow_fault_3c(reads, monkeypatch):
    """An explicit hit_cap below the pair's hits but above each slice's:
    the reference fills both slices whole and reports no overflow; the
    port bounds the pair's total by the cap and reports the overflow
    (run_overlap_plan then refuses the pair)."""
    ra, rb, pa, pb = _blocks(reads, True)
    _sliced(monkeypatch)
    full = _port(pa, pb, True)
    t0, t1 = (s["hits"] for s in full["slices"])
    cap = (max(t0, t1) + t0 + t1) // 2
    assert max(t0, t1) < cap < t0 + t1
    got = _port(pa, pb, True, hit_cap=cap)
    assert got["path"] == "sliced" and got["overflow"]
    assert sum(s["buffer"] for s in got["slices"]) <= cap
    want = _ref(ra, rb, True, hit_cap=cap)
    assert not bool(want["overflow"])
    assert int(want["total_hits"]) == t0 + t1 > cap
