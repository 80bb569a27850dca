"""Port vs reference for masking (pipeline/masking.py), the datander
search under it (ops/seeding.py find_tandem_seeds, pipeline/overlap.py
extend_seeds on K1's plain version) and plan_masking.  Tolerance: exact
equality.  The reference runs as the port's other tests run it
(DAMAR_BP=jax from conftest, damar_tpu.native.available -> False where
its kernels are reached).

Also shows fault 3g of the reference (ROADMAP.md section 3):
find_tandem_seeds fills a hit buffer capped at 1 << 20 in B-tuple-major
order, so on a block of ~1 Mbp and more it silently drops the hits of
the k-mers with the highest codes; the port sizes its buffers from the
counts."""
import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import MaskConfig as RefMaskConfig
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.formats.las import LasColumns as RefColumns
from damar_tpu.formats.las import LasFile as RefLasFile
from damar_tpu.ops import kmers as ref_kmers
from damar_tpu.ops import seeding as ref_seeding
from damar_tpu.pipeline import masking as ref_masking
from damar_tpu.pipeline import overlap as ref_ov
from damar_tpu.pipeline.planner import plan_masking as ref_plan_masking
from damar_tpu.utils import dust as ref_dust
from damar_tpu.utils.sim import make_genome, sample_reads
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import MaskConfig, OverlapConfig
from damar_tpu_torch.formats.las import LasColumns, LasFile
from damar_tpu_torch.ops import kmers, seeding
from damar_tpu_torch.pipeline import masking
from damar_tpu_torch.pipeline import overlap as ov
from damar_tpu_torch.pipeline.planner import plan_masking
from damar_tpu_torch.utils import dust

torch.set_num_threads(2)
SEED_KEYS = ("aread", "bread", "apos", "bpos", "cov")
EXT_KEYS = ("aread", "bread", "abpos", "aepos", "bbpos", "bepos", "diffs")


@pytest.fixture()
def device_route(monkeypatch):
    from damar_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("DAMAR_BP", "jax")


@pytest.fixture(scope="module")
def tandem_reads():
    """~370 kbp of reads over a 60 kbp genome with 6 planted tandems."""
    g = make_genome(60_000, seed=5, tandem=6)
    return sample_reads(g, coverage=6.0, mean_len=4000, err=0.12,
                        seed=6).reads


def low_complexity_reads(rng, n: int) -> list:
    """Random reads of 3-8,000 bp with up to three planted runs of a
    1-5 bp unit (homopolymers, dinucleotide repeats, ...)."""
    reads = []
    for _ in range(n):
        m = int(rng.integers(3, 8000))
        r = rng.integers(0, 4, m).astype(np.uint8)
        for _ in range(int(rng.integers(0, 4))):
            a, L = int(rng.integers(0, m)), int(rng.integers(10, 400))
            unit = rng.integers(0, 4, int(rng.integers(1, 6)))
            r[a:a + L] = np.tile(unit, L)[:len(r[a:a + L])]
        reads.append(r)
    return reads


@pytest.mark.parametrize("window,thresh", [(64, 2.0), (32, 1.0),
                                           (20, 0.5), (100, 3.0),
                                           (64, 0.0), (160, 40.0),
                                           (200, 30.0)])
def test_dust_block_planted_runs(window, thresh):
    """The port counts each window's equal-triplet pairs where the
    reference counts triplets with a one-hot prefix per read: the same
    intervals, read by read, on 150 reads in one block.  Windows of 160
    and 200 hold more equal pairs a position than int8 counts and more
    separators than a byte codes."""
    reads = low_complexity_reads(np.random.default_rng(window), 150)
    got = dust.dust_block(reads, window, thresh)
    assert sum(len(g) for g in got) > 0
    for r, g in zip(reads, got):
        want = ref_dust.dust_read(r, window, thresh)
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g, want)


def test_dust_homopolymer_and_random():
    rng = np.random.default_rng(3)
    reads = [np.zeros(300, np.uint8),                  # one homopolymer
             rng.integers(0, 4, 2000).astype(np.uint8),
             np.concatenate([rng.integers(0, 4, 500).astype(np.uint8),
                             np.tile(np.array([0, 1], np.uint8), 80),
                             rng.integers(0, 4, 400).astype(np.uint8),
                             np.full(90, 3, np.uint8),
                             rng.integers(0, 4, 300).astype(np.uint8)]),
             rng.integers(0, 4, 40).astype(np.uint8)]  # below the window
    for window, thresh in ((64, 2.0), (32, 1.0)):
        got = dust.dust_block(reads, window, thresh)
        want = ref_dust.dust_block(reads, window, thresh)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(
                g, ref_dust.dust_read(reads[i], window, thresh))
    got = dust.dust_block(reads)
    assert len(got[0]) == 2 and len(got[2]) >= 4 and len(got[3]) == 0


def random_headers(rng, n: int, nreads: int, rlen):
    h = np.zeros((n, 10), np.int32)
    h[:, 7] = rng.integers(0, nreads + 3, n)       # some absent reads
    h[:, 8] = rng.integers(0, nreads, n)
    L = rlen[np.minimum(h[:, 7], nreads - 1)]
    b = rng.integers(0, L - 50)
    h[:, 2] = b
    h[:, 4] = np.minimum(b + rng.integers(50, 3000, n), L)
    return h


def test_coverage_and_merge_columnar(rng):
    nreads = 40
    rlen = rng.integers(1000, 6000, nreads).astype(np.int64)
    h = random_headers(rng, 900, nreads, rlen)
    j = np.minimum(h[:, 7], nreads - 1).astype(np.int64)
    for thr in (0, 1, 3, 7):
        got = masking._coverage_data(j, h[:, 2], h[:, 4], rlen, nreads, thr)
        want = ref_masking._coverage_data(j, h[:, 2], h[:, 4], rlen, nreads,
                                          thr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for r in range(nreads):                       # the scalar sweep
        ev = [(int(b), int(e)) for b, e in h[j == r][:, [2, 4]]]
        for thr in (1, 3):
            np.testing.assert_array_equal(
                masking.coverage_intervals(ev, int(rlen[r]), thr),
                ref_masking.coverage_intervals(ev, int(rlen[r]), thr))
    lo = h[:, 2].astype(np.int64)
    hi = h[:, 4].astype(np.int64)
    got = masking._merge_intervals_by_read(j, lo, hi, nreads)
    want = ref_masking._merge_intervals_by_read(j, lo, hi, nreads)
    assert len(got) == nreads
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("high", [1.0, 2.0, 3.5])
def test_repeat_tracks(rng, high):
    nreads = 30
    rlen = rng.integers(1000, 6000, nreads).astype(np.int64)
    h = random_headers(rng, 700, nreads, rlen)
    h[:80, 7], h[:80, 2], h[:80, 4] = 0, 200, 900     # a pile-up on read 0
    cols = LasColumns(h, np.zeros(0, np.uint8), np.zeros(len(h) + 1))
    ref_cols = RefColumns(h.copy(), np.zeros(0, np.uint8),
                          np.zeros(len(h) + 1))
    idx = {i + 100: i for i in range(nreads)}            # absolute ids
    h[:, 7] += 100
    ref_cols.headers[:, 7] += 100
    las, ref_las = LasFile(100, columns=cols), RefLasFile(100,
                                                          columns=ref_cols)
    got = masking.repeat_track_coverage(las, rlen, idx, nreads, 4)
    want = ref_masking.repeat_track_coverage(ref_las, rlen, idx, nreads, 4)
    for g, w in zip(got.data, want.data):
        np.testing.assert_array_equal(g, w)
    # low_mult is ignored by both (fault 3d): only high_mult is held
    got = masking.repeat_track_relative(las, rlen, idx, nreads,
                                        high_mult=high)
    want = ref_masking.repeat_track_relative(ref_las, rlen, idx, nreads,
                                             high_mult=high)
    assert got.expected_coverage == want.expected_coverage
    for g, w in zip(got.data, want.data):
        np.testing.assert_array_equal(g, w)
    assert got.masked_bp() > 0


def test_kmer_codes(tandem_reads):
    blk = block_from_reads(tandem_reads[:10])
    mask = np.zeros(blk.cap, bool)
    mask[::7] = True
    for k in (12, 14):
        for m in (None, mask):
            c, v = kmers.kmer_codes(torch.as_tensor(blk.bases),
                                    torch.as_tensor(blk.read_id), k,
                                    None if m is None else torch.as_tensor(m))
            rc, rv = ref_kmers.kmer_codes(blk.bases, blk.read_id, k, m)
            np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
            np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_tandem_seeds_extension_and_track(tandem_reads, device_route):
    """Below the reference's caps the search, its extension and the
    track all equal the reference's."""
    rb, pb = ref_block(tandem_reads), block_from_reads(tandem_reads)
    want = ref_seeding.find_tandem_seeds(rb, RefConfig())
    got = seeding.find_tandem_seeds(pb, OverlapConfig(), device="cpu")
    assert want["total_hits"] == want["nhits"] == got["nhits"] \
        == got["total_hits"]
    assert want["total_seeds"] == want["nseeds"] == got["nseeds"] > 100
    for k in SEED_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    ext_w = ref_ov.extend_seeds(rb, rb, want, RefConfig(), comp=False)
    ext_g = ov.extend_seeds(pb, pb, got, OverlapConfig(), device="cpu")
    assert ext_g["n"] == ext_w["n"] > 100
    for k in EXT_KEYS:
        np.testing.assert_array_equal(ext_g[k], ext_w[k])
    tw = ref_masking.tandem_track(rb, RefConfig(), RefMaskConfig())
    tg = masking.tandem_track(pb, OverlapConfig(), MaskConfig(),
                              device="cpu")
    assert tg.masked_bp() == tw.masked_bp() > 10_000
    for g, w in zip(tg.data, tw.data):
        np.testing.assert_array_equal(g, w)


def test_reference_fault_3g_truncation(device_route):
    """Fault 3g: at ~1.2 Mbp the reference's default hit cap holds a
    fraction of the self merge's hits, and its seeds are those of the
    k-mers with the lowest codes.  The port's sized buffers hold every
    hit and give the reference's seeds under caps large enough for all;
    the port with the reference's caps passed gives its truncated
    seeds."""
    g = make_genome(100_000, seed=41, tandem=10)
    reads = sample_reads(g, coverage=12.0, mean_len=5000, err=0.12,
                         seed=42).reads
    rb, pb = ref_block(reads), block_from_reads(reads)
    cfg, rcfg = OverlapConfig(), RefConfig()
    trunc = ref_seeding.find_tandem_seeds(rb, rcfg)
    assert trunc["nhits"] == 1 << 20 < trunc["total_hits"]
    full = ref_seeding.find_tandem_seeds(rb, rcfg, hit_cap=1 << 23,
                                         seed_cap=1 << 17)
    assert full["nhits"] == full["total_hits"] == trunc["total_hits"]
    assert full["nseeds"] == full["total_seeds"] > trunc["nseeds"]
    sized = seeding.find_tandem_seeds(pb, cfg, device="cpu")
    assert sized["nhits"] == sized["total_hits"] == full["total_hits"]
    assert sized["nseeds"] == sized["total_seeds"] == full["nseeds"]
    for k in SEED_KEYS:
        np.testing.assert_array_equal(sized[k].numpy()[:full["nseeds"]],
                                      full[k][:full["nseeds"]])
    capped = seeding.find_tandem_seeds(
        pb, cfg, hit_cap=seeding.REF_TANDEM_HIT_CAP,
        seed_cap=seeding.REF_TANDEM_SEED_CAP, device="cpu")
    assert (capped["nhits"], capped["total_hits"], capped["nseeds"]) == \
        (trunc["nhits"], trunc["total_hits"], trunc["nseeds"])
    for k in SEED_KEYS:
        np.testing.assert_array_equal(capped[k].numpy(), trunc[k])


def test_device_has_no_default(tandem_reads):
    pb = block_from_reads(tandem_reads[:3])
    with pytest.raises(TypeError, match="device"):
        seeding.find_tandem_seeds(pb, OverlapConfig())
    with pytest.raises(TypeError, match="device"):
        masking.tandem_track(pb, OverlapConfig(), MaskConfig())
    with pytest.raises(TypeError, match="device"):
        ov.extend_seeds(pb, pb, {"nseeds": 0}, OverlapConfig())
    with pytest.raises(TypeError, match="device"):
        ov.retrace_rows(LasFile(100), [], pb, pb, OverlapConfig())


@pytest.mark.parametrize("case", ["split", "explicit_cap"])
def test_tandem_search_above_slice_cap(tandem_reads, monkeypatch, case):
    """With _SLICE_CAP lowered below the block's hits: the sized search
    runs by ranges of reads (split), and its seeds, counts and buffers
    are the unsplit search's and the reference's (caps that hold every
    hit); an explicit hit_cap still reproduces the reference's cut
    however far it passes _SLICE_CAP, in one piece."""
    rb, pb = ref_block(tandem_reads), block_from_reads(tandem_reads)
    cfg, rcfg = OverlapConfig(), RefConfig()
    if case == "split":
        unsplit = seeding.find_tandem_seeds(pb, cfg, device="cpu")
        want = ref_seeding.find_tandem_seeds(rb, rcfg)
        monkeypatch.setattr(seeding, "_SLICE_CAP",
                            unsplit["total_hits"] // 5)
        got = seeding.find_tandem_seeds(pb, cfg, device="cpu")
        assert got["pieces"] >= 5 and unsplit["pieces"] == 1
        assert got["hit_buffer"] < unsplit["hit_buffer"]
        for k in ("nseeds", "total_seeds", "nhits", "total_hits",
                  "seed_buffer"):
            assert got[k] == unsplit[k], k
        for k in SEED_KEYS:
            assert torch.equal(got[k], unsplit[k]), k
    else:
        monkeypatch.setattr(seeding, "_SLICE_CAP", 1 << 10)
        want = ref_seeding.find_tandem_seeds(rb, rcfg, hit_cap=1 << 16)
        got = seeding.find_tandem_seeds(pb, cfg, hit_cap=1 << 16,
                                        device="cpu")
        assert got["hit_buffer"] == got["nhits"] == 1 << 16
        assert got["pieces"] == 1 and got["total_hits"] > 1 << 16
    assert (got["nhits"], got["total_hits"], got["nseeds"]) == \
        (want["nhits"], want["total_hits"], want["nseeds"])
    assert want["nseeds"] == want["total_seeds"] > 0
    for k in SEED_KEYS:
        np.testing.assert_array_equal(got[k].numpy()[:want["nseeds"]],
                                      want[k][:want["nseeds"]])


@pytest.mark.parametrize("nblocks", [1, 3, 6])
def test_plan_masking(nblocks):
    got = plan_masking("X", nblocks)
    want = ref_plan_masking("X", nblocks)
    assert [(j.name, j.kind, j.args, j.deps) for j in got] == \
        [(j.name, j.kind, j.args, j.deps) for j in want]
    assert [j.name for j in got if j.name.startswith("tan.")][-1] == \
        "tan.merge"
