"""The reference's plain (forward, one orientation) seeding API and two
sort helpers in the port, against damar_tpu on the same inputs: the
soft-masked shared segment of tests/test_masking.py:79-94 and blocks of
simulated reads for find_seeds, find_seeds_dev (self and distinct
pairs, the compaction and the caps that overflow), match_hits,
compact_hits and compact_hits_packed; test_sort.py's inputs for
radix_sort_multi and merge_ranks.  Tolerance: exact (every array and
count equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block_from_reads
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.ops import seeding as ref_seed
from damar_tpu.ops import sort as ref_sort
from damar_tpu.ops.kmers import mask_vector_from_track
from damar_tpu.pipeline import masking as ref_masking
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.ops import seeding, sort
from damar_tpu_torch.utils import sim

KEYS = ("aread", "bread", "apos", "bpos", "cov")


def np_(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same_seeds(got: dict, want: dict, ints=("nseeds", "total_seeds",
                                                   "total_hits")):
    for k in KEYS:
        np.testing.assert_array_equal(np_(got[k]), np_(want[k]), err_msg=k)
    for k in ints:
        assert int(got[k]) == int(np_(want[k])), k


@pytest.fixture(scope="module")
def shared():
    """test_masking.py's pair: a 400 bp segment shared by two reads."""
    rng = np.random.default_rng(94)
    seg = rng.integers(0, 4, 400).astype(np.uint8)
    a = np.concatenate([rng.integers(0, 4, 800).astype(np.uint8), seg])
    b = np.concatenate([seg, rng.integers(0, 4, 800).astype(np.uint8)])
    return a, b


def test_find_seeds_masked_segment(shared):
    a, b = shared
    ra, rb = ref_block_from_reads([a]), ref_block_from_reads([b])
    pa, pb = block_from_reads([a]), block_from_reads([b])
    rcfg, cfg = RefConfig(seed_batch=128), OverlapConfig()
    mask = ref_masking.Track("rep", [np.array([800, 1200], np.int32)])
    ma = mask_vector_from_track(mask.data, ra.starts, ra.cap)
    plain = seeding.find_seeds(pa, pb, cfg, device="cpu")
    assert plain["nseeds"] > 0
    assert_same_seeds(plain, ref_seed.find_seeds(ra, rb, rcfg),
                      ("nseeds", "total_seeds", "nhits", "total_hits"))
    masked = seeding.find_seeds(pa, pb, cfg, mask_a=np.asarray(ma),
                                device="cpu")
    assert masked["nseeds"] == 0
    assert_same_seeds(masked, ref_seed.find_seeds(ra, rb, rcfg, mask_a=ma),
                      ("nseeds", "total_seeds", "nhits", "total_hits"))


def test_find_seeds_device_has_no_default(shared):
    a, b = shared
    blk = block_from_reads([a])
    with pytest.raises(TypeError):
        seeding.find_seeds(blk, blk, OverlapConfig())
    with pytest.raises(TypeError, match="device"):
        seeding.find_seeds_dev(blk, blk, OverlapConfig())


def sim_blocks(ref: bool):
    g = sim.make_genome(30_000, seed=41)
    reads = sim.sample_reads(g, coverage=5, mean_len=1500, err=0.1, seed=42,
                             min_len=600).reads
    mk = ref_block_from_reads if ref else block_from_reads
    h = len(reads) // 2
    return mk(reads[:h]), mk(reads[h:])


@pytest.mark.parametrize("upper_only", (False, True))
def test_find_seeds_sim_blocks(upper_only):
    (ra, rb), (pa, pb) = sim_blocks(True), sim_blocks(False)
    for x, y, px, py in ((ra, rb, pa, pb), (ra, ra, pa, pa)):
        want = ref_seed.find_seeds(x, y, RefConfig(), upper_only=upper_only,
                                   seed_cap=1 << 12)
        got = seeding.find_seeds(px, py, OverlapConfig(),
                                 upper_only=upper_only, seed_cap=1 << 12,
                                 device="cpu")
        assert got["nseeds"] > 0
        assert_same_seeds(got, want, ("nseeds", "total_seeds", "nhits",
                                      "total_hits"))


@pytest.mark.parametrize("case", ("self", "distinct", "compact",
                                  "overflow"))
def test_find_seeds_dev(case):
    (ra, rb), (pa, pb) = sim_blocks(True), sim_blocks(False)
    kw = dict(seed_cap=1 << 12)
    if case == "self":
        x, y, px, py = ra, ra, pa, pa
        kw.update(self_pair=True, upper_only=True)
    else:
        x, y, px, py = ra, rb, pa, pb
    if case == "compact":
        kw.update(upper_only=True, compact_cap=1 << 10)
    if case == "overflow":
        kw.update(hit_cap=1 << 11, seed_cap=16)
    want = ref_seed.find_seeds_dev(x, y, RefConfig(), **kw)
    got = seeding.find_seeds_dev(px, py, OverlapConfig(), device="cpu", **kw)
    assert_same_seeds(got, want, ("nseeds", "total_seeds", "total_hits",
                                  "total_compact"))
    for k in ("raw_cap", "compact_cap"):
        assert got[k] == int(want[k]), k
    assert got["overflow"] == bool(np.asarray(want["overflow"]))
    assert got["overflow"] == (case == "overflow")


def test_match_and_compact_hits():
    (ra, rb), (pa, pb) = sim_blocks(True), sim_blocks(False)
    k = 14
    rac, rap = ref_seed.build_index(jnp.asarray(ra.bases),
                                    jnp.asarray(ra.read_id), k)
    rbc, rbp = ref_seed.build_index(jnp.asarray(rb.bases),
                                    jnp.asarray(rb.read_id), k)
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    pac, pap = seeding.build_index(t(pa.bases), t(pa.read_id), k)
    pbc, pbp = seeding.build_index(t(pb.bases), t(pb.read_id), k)
    for cap in (1 << 16, 1 << 9):
        want = ref_seed.match_hits(rac, rap, rbc, rbp, k=k, hit_cap=cap)
        got = seeding.match_hits(pac, pap, pbc, pbp, k=k, hit_cap=cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np_(g), np_(w))
    apos, bpos, nhits, _ = want
    ga, gb, gn, _ = got
    for upper, supp, ident in ((True, False, False), (False, True, False),
                               (True, False, True)):
        w = ref_seed.compact_hits(apos, bpos, nhits, jnp.asarray(ra.read_id),
                                  jnp.asarray(ra.read_id), out_cap=300,
                                  upper_only=upper, suppress_equal=supp,
                                  include_self=ident)
        g = seeding.compact_hits(ga, gb, gn, t(pa.read_id), t(pa.read_id),
                                 out_cap=300, upper_only=upper,
                                 suppress_equal=supp, include_self=ident)
        for x, y in zip(g, w):
            np.testing.assert_array_equal(np_(x), np_(y))


def test_compact_hits_packed_fault_3n():
    """damar_tpu's compact_hits_packed (seeding.py:1248) raises
    OverflowError on every call: its fill 0xFFFFFFFF goes into jnp.where
    as an int32 weak type (fault 3n, ROADMAP.md §3).  The port's is held
    against the reference's own pieces computing what it means: the read
    ordinals from the payloads, the same filter, and compact_flagged
    with fill -1, which wraps to 0xFFFFFFFF in the uint32 payloads."""
    rng = np.random.default_rng(8)
    ap = (rng.integers(0, 60, 2000) << 14 | rng.integers(0, 1 << 14, 2000)
          ).astype(np.uint32)
    bp = (rng.integers(0, 60, 2000) << 14 | rng.integers(0, 1 << 14, 2000)
          ).astype(np.uint32)
    kw = dict(a_rpos_bits=13, b_rpos_bits=13, out_cap=1024)
    with pytest.raises(OverflowError):
        ref_seed.compact_hits_packed(jnp.asarray(ap), jnp.asarray(bp), 1500,
                                     upper_only=True, **kw)
    ar, br = ap >> 14, bp >> 14
    t = lambda x: torch.as_tensor(x.astype(np.int64))  # noqa: E731
    for upper, supp, ident in ((True, False, False), (False, True, False),
                               (True, False, True), (False, False, False)):
        live = np.arange(2000) < 1500
        if upper:
            live &= (ar <= br) if ident else (ar < br)
        if supp:
            live &= ar != br
        (wa, wb), wn, wt = ref_sort.compact_flagged(
            jnp.asarray(live), (jnp.asarray(ap), jnp.asarray(bp)),
            out_cap=1024, fill=-1)
        ga, gb, gn, gt = seeding.compact_hits_packed(
            t(ap), t(bp), 1500, upper_only=upper, suppress_equal=supp,
            include_self=ident, **kw)
        np.testing.assert_array_equal(np_(ga), np_(wa).astype(np.int64))
        np.testing.assert_array_equal(np_(gb), np_(wb).astype(np.int64))
        assert (gn, gt) == (int(wn), int(wt))
        assert (np_(ga)[gn:] == 0xFFFFFFFF).all() and 0 < gn <= 1024


def test_radix_sort_multi_and_merge_ranks():
    rng = np.random.default_rng(8)
    n = 3000
    k0 = rng.integers(0, 1 << 10, n).astype(np.int32)
    k1 = rng.integers(0, 1 << 12, n).astype(np.int32)
    pay = np.arange(n, dtype=np.int32)
    (wk0, wk1), (wp,) = ref_sort.radix_sort_multi(
        (jnp.asarray(k0), jnp.asarray(k1)), (jnp.asarray(pay),), (10, 12))
    (gk0, gk1), (gp,) = sort.radix_sort_multi(
        (torch.as_tensor(k0), torch.as_tensor(k1)), (torch.as_tensor(pay),),
        (10, 12))
    for g, w in ((gk0, wk0), (gk1, wk1), (gp, wp)):
        np.testing.assert_array_equal(np_(g), np_(w))
    rng = np.random.default_rng(10)
    a = np.sort(rng.integers(0, 1 << 16, 2000).astype(np.int32))
    b = np.sort(rng.integers(0, 1 << 16, 1500).astype(np.int32))
    want = ref_sort.merge_ranks(jnp.asarray(a), jnp.asarray(b), 16)
    got = sort.merge_ranks(torch.as_tensor(a), torch.as_tensor(b), 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np_(w))
