"""Card-only checks: each CUDA kernel of damar_tpu_torch against its plain
torch version on the same inputs on the card.  Tolerance: exact equality
(integer outputs).  Skipped where there is no CUDA device; this file
imports neither jax nor damar_tpu, so on the GPU machine it runs with

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from damar_tpu_torch.ops import wave_bp, wave_wide
from damar_tpu_torch.ops.words import pack_bases
from damar_tpu_torch.utils.sim import (band_batch, edge_units, unit_batch,
                                       wide_trace_batch)

W = 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def _ext(rng, S, **kw):
    A, B, ao, bo, alim, blim, rv = unit_batch(rng, S, **kw)
    return [torch.as_tensor(x) for x in (A, B, ao, bo, alim, blim)], \
        torch.as_tensor(rv)


def _check_extend(dev, args, rv, max_rows):
    """K1 (one launch, counted once) == its plain version."""
    aw, bw = pack_bases(args[0]), pack_bases(args[1])
    plain = wave_bp.extend_bp_plain(aw, bw, *args[2:], rv, 128, max_rows,
                                    5, 60)
    before = wave_bp.extend_wave_bp.launches
    kern = wave_bp.extend_bp_kernel(
        aw.to(dev), bw.to(dev), *(x.to(dev) for x in args[2:]), rv.to(dev),
        128, max_rows, 5, 60)
    assert wave_bp.extend_wave_bp.launches == before + 1
    _same(plain, kern)


@pytest.mark.cuda
@pytest.mark.parametrize("max_rows,dirs", [(65536, "mixed"),
                                           (128, "mixed"),
                                           (65536, "fwd"), (65536, "rev")])
def test_extend_kernel_matches_plain(dev, max_rows, dirs):
    args, rv = _ext(np.random.default_rng(max_rows), 2000)
    if dirs != "mixed":
        rv = torch.full_like(rv, dirs == "rev")
    _check_extend(dev, args, rv, max_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["longest_first", "random"])
def test_extend_mixed_lengths_one_launch(dev, order):
    """Units of 1 to ~20,000 rows in one launch, laid out longest first
    or in random order: the persistent queue hands them out longest
    first either way, and no output depends on the layout."""
    args, rv = _ext(np.random.default_rng(11), 700, min_len=1,
                    max_len=20_000)
    alim, blim = args[4], args[5]
    assert int(alim.max()) > 10_000 and int(alim.min()) < 50
    if order == "longest_first":
        perm = torch.argsort(torch.minimum(alim, blim), descending=True)
    else:
        perm = torch.as_tensor(np.random.default_rng(3).permutation(700))
    args = args[:2] + [x[perm] for x in args[2:]]
    _check_extend(dev, args, rv[perm], 65536)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 33, 129, 1031])
def test_extend_odd_unit_counts(dev, S):
    """S = 1 and S not a multiple of a warp or of the block."""
    args, rv = _ext(np.random.default_rng(S), S)
    _check_extend(dev, args, rv, 65536)


@pytest.mark.cuda
def test_extend_windows_past_pool_edges(dev):
    """Forward and reverse units whose windows run past both ends of the
    pool (word reads across the clip)."""
    A, B, ao, bo, alim, blim, rv = edge_units(np.random.default_rng(9), 64)
    args = [torch.as_tensor(x) for x in (A, B, ao, bo, alim, blim)]
    _check_extend(dev, args, torch.as_tensor(rv), 65536)


def _trace_args(rng, S, offsets=False, **kw):
    """Trace extents from a unit batch: starts 0 and offsets at the
    origins, or (offsets) each origin split into a start and a small
    offset, both off word boundaries."""
    A, B, ao, bo, alim, blim, _ = unit_batch(rng, S, **kw)
    alim = np.minimum(alim, len(A) - ao).astype(np.int32)
    blim = np.minimum(blim, len(B) - bo).astype(np.int32)
    abp, bbp = ao, bo
    if offsets:
        abp = np.minimum(rng.integers(1, 90, len(ao)), ao).astype(np.int32)
        bbp = np.minimum(rng.integers(1, 90, len(bo)), bo).astype(np.int32)
    return [torch.as_tensor(x) for x in (A, B, ao - abp, bo - bbp, abp, bbp,
                                         alim, blim)]


@pytest.mark.cuda
@pytest.mark.parametrize("tspace,max_segs", [(100, 32), (126, 24),
                                             (250, 12)])
def test_trace_kernel_matches_plain(dev, tspace, max_segs):
    args = _trace_args(np.random.default_rng(tspace), 2000)
    want = wave_bp.trace_wave_bp(*args, tspace=tspace, max_segs=max_segs)
    got = wave_bp.trace_wave_bp(*(x.to(dev) for x in args), tspace=tspace,
                                max_segs=max_segs)
    _same(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("tspace,max_segs,S", [(100, 64, 517),
                                               (126, 48, 33),
                                               (250, 24, 1),
                                               (100, 6, 400)])
def test_trace_offsets_odd_counts_and_cap(dev, tspace, max_segs, S):
    """Starts off word boundaries, S not a multiple of a warp, and (the
    last case) a bucket at its cap: most extents need more segments than
    max_segs and stop there."""
    args = _trace_args(np.random.default_rng(S + tspace), S, offsets=True,
                       max_len=6000)
    before = wave_bp.trace_wave_bp.launches
    want = wave_bp.trace_wave_bp(*args, tspace=tspace, max_segs=max_segs)
    got = wave_bp.trace_wave_bp(*(x.to(dev) for x in args), tspace=tspace,
                                max_segs=max_segs)
    assert wave_bp.trace_wave_bp.launches == before + 1
    _same(want, got)
    if max_segs == 6:
        assert int((want[1] == max_segs).sum()) > S // 2


def _dp_inputs(seed, S, R, track):
    *vals, cont = band_batch(np.random.default_rng(seed), S, track, R)
    return [torch.as_tensor(x) for x in vals], torch.as_tensor(cont)


@pytest.mark.cuda
@pytest.mark.parametrize("track,recenter", [(False, False), (True, True),
                                            (True, False), (False, True)])
def test_dp_rows_kernel_matches_plain(dev, track, recenter):
    args, cont = _dp_inputs(3, 3000, 100, track)
    kw = dict(R=100, W=W, diff_cost=5, xdrop=60, track_best=track,
              recenter=recenter)
    want = wave_wide.dp_rows(*args, cont=cont, **kw)
    got = wave_wide.dp_rows(*(x.to(dev) for x in args), cont=cont.to(dev),
                            **kw)
    _same(want, got)


@pytest.mark.cuda
def test_trace_wave_on_card_matches_cpu(dev):
    A, B, ao, bo, alim, blim, _ = unit_batch(np.random.default_rng(4), 300)
    alim = np.minimum(alim, len(A) - ao).astype(np.int32)
    blim = np.minimum(blim, len(B) - bo).astype(np.int32)
    z = np.zeros(len(ao), np.int32)
    args = [torch.as_tensor(x) for x in (A, B, z, z, ao, bo, alim, blim)]
    want = wave_wide.trace_wave(*args, max_segs=32)
    got = wave_wide.trace_wave(*(x.to(dev) for x in args), max_segs=32)
    _same(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("tspace,max_segs,S,max_len", [
    (100, 64, 1, 2500), (100, 64, 33, 2500), (126, 48, 1031, 2500),
    (100, 256, 120, 20_000), (100, 6, 400, 6000), (100, 64, 517, 6000),
    (126, 256, 60, 20_000)])
def test_wide_trace_kernel_matches_plain(dev, tspace, max_segs, S, max_len):
    """One wide_trace_kernel launch against trace_wave_plain: extents of
    1 to max_len rows, starts off word boundaries, windows past both pool
    edges, drifting commits, the d >= INF_I commit, alim = 0 rows, and
    (max_segs 6) the last slot overwritten."""
    A, B, *vecs = wide_trace_batch(np.random.default_rng(S + max_len), S,
                                   max_len=max_len)
    aw, bw = pack_bases(torch.as_tensor(A)), pack_bases(torch.as_tensor(B))
    vecs = [torch.as_tensor(x) for x in vecs]
    want = wave_wide.trace_wave_plain(aw.to(dev), bw.to(dev),
                                      *(x.to(dev) for x in vecs), tspace,
                                      max_segs)
    before = wave_wide.trace_wave.launches
    got = wave_wide.trace_wide_kernel(aw.to(dev), bw.to(dev),
                                      *(x.to(dev) for x in vecs), tspace,
                                      max_segs)
    assert wave_wide.trace_wave.launches == before + 1
    _same(want, got)


@pytest.mark.cuda
def test_no_work_launches_nothing(dev):
    """A wrapper given no items launches nothing (the C side returns
    before its launch) and counts nothing."""
    e = torch.empty(0, dtype=torch.int32, device=dev)
    w = torch.zeros(4, dtype=torch.int32, device=dev)
    counters = (wave_bp.extend_wave_bp, wave_bp.trace_wave_bp,
                wave_wide.trace_wave)
    before = [f.launches for f in counters]
    wave_bp.extend_bp_kernel(w, w, e, e, e, e, e.bool(), 128, 65536, 5, 60)
    for fn in (wave_bp.trace_bp_kernel, wave_wide.trace_wide_kernel):
        trace, nseg, dsum = fn(w, w, e, e, e, e, e, e, 100, 8)
        assert trace.shape == (0, 8, 2) and nseg.numel() == 0
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dirs", ["mixed", "fwd"])
def test_extend_wave_wide_on_card_matches_cpu(dev, dirs):
    """The wide extension over dp_rows_kernel (one launch per 128 rows)
    == over dp_rows_plain, on a fuzz batch and at the pool's edges."""
    rng = np.random.default_rng(17)
    for batch in (unit_batch(rng, 300), edge_units(rng, 64)):
        A, B, ao, bo, alim, blim, rv = (torch.as_tensor(x) for x in batch)
        kw = dict(dirs=rv) if dirs == "mixed" else dict(reverse=False)
        cpu = wave_wide.extend_wave_wide(A, B, ao, bo, alim, blim, **kw)
        before = wave_wide.dp_rows.launches
        kw = {k: v.to(dev) if torch.is_tensor(v) else v
              for k, v in kw.items()}
        card = wave_wide.extend_wave_wide(
            *(x.to(dev) for x in (A, B, ao, bo, alim, blim)), **kw)
        assert wave_wide.dp_rows.launches > before
        _same(cpu, card)


@pytest.mark.cuda
def test_pipelined_on_card_matches_sequential(dev):
    """Two small pairs through overlap_pairs_pipelined on the card (the
    emit on a worker thread with its own stream) == a loop of
    overlap_block_pair there."""
    from damar_tpu_torch.core.blocks import block_from_reads
    from damar_tpu_torch.core.config import OverlapConfig
    from damar_tpu_torch.pipeline import overlap as ov
    from damar_tpu_torch.utils.sim import make_genome, sample_reads
    reads = sample_reads(make_genome(40_000, seed=3), coverage=10.0,
                         mean_len=3000, err=0.14, seed=4).reads
    h = len(reads) // 2
    a = block_from_reads(reads[:h], ids=np.arange(h))
    b = block_from_reads(reads[h:], ids=np.arange(h, len(reads)))
    cfg = OverlapConfig()
    pairs = [(a, a, True), (a, b, False)]
    want = [ov.overlap_block_pair(x, y, cfg, s, device=dev)
            for x, y, s in pairs]
    sh = {}
    jobs = [dict(tag=k, blk_a=x, blk_b=y, self_block=s, size_hints=sh)
            for k, (x, y, s) in enumerate(pairs)]
    got = list(ov.overlap_pairs_pipelined(jobs, cfg, device=dev))
    assert [g[0] for g in got] == [0, 1]
    for (_, la, lb, _), (wa, wb, _) in zip(got, want):
        assert la.novl == wa.novl > 0
        for x, y in ((la, wa), (lb, wb)):
            for k in ("headers", "trace", "offsets"):
                assert np.array_equal(getattr(x.columns, k),
                                      getattr(y.columns, k))


@pytest.mark.cuda
def test_tandem_track_on_card_matches_cpu(dev):
    """The datander search and its K1 extension on the card give the CPU
    path's seeds, extents and track."""
    from damar_tpu_torch.core.blocks import block_from_reads
    from damar_tpu_torch.core.config import MaskConfig, OverlapConfig
    from damar_tpu_torch.ops.seeding import find_tandem_seeds
    from damar_tpu_torch.pipeline.masking import tandem_track
    from damar_tpu_torch.utils.sim import make_genome, sample_reads
    g = make_genome(60_000, seed=5, tandem=6)
    blk = block_from_reads(sample_reads(g, coverage=6.0, mean_len=4000,
                                        err=0.12, seed=6).reads)
    cfg = OverlapConfig()
    s_gpu = find_tandem_seeds(blk, cfg, device=dev)
    s_cpu = find_tandem_seeds(blk, cfg, device="cpu")
    for k in ("aread", "bread", "apos", "bpos", "cov"):
        assert torch.equal(s_gpu[k].cpu(), s_cpu[k])
    before = wave_bp.extend_wave_bp.launches
    t_gpu = tandem_track(blk, cfg, MaskConfig(), device=dev)
    assert wave_bp.extend_wave_bp.launches == before + 2   # two phases
    t_cpu = tandem_track(blk, cfg, MaskConfig(), device="cpu")
    assert t_gpu.masked_bp() == t_cpu.masked_bp() > 0
    for a, b in zip(t_gpu.data, t_cpu.data):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_retrace_rows_on_card_matches_cpu(dev):
    """retrace_rows on the card (K3's wide_trace_kernel) writes the CPU
    path's headers and payload."""
    from damar_tpu_torch.core.blocks import block_from_reads
    from damar_tpu_torch.core.config import OverlapConfig
    from damar_tpu_torch.pipeline import overlap as ov
    from damar_tpu_torch.utils.sim import make_genome, sample_reads
    reads = sample_reads(make_genome(30_000, seed=3), coverage=8.0,
                         mean_len=3000, err=0.14, seed=4).reads
    blk = block_from_reads(reads)
    cfg = OverlapConfig(min_len=500)
    la, lb, _ = ov.overlap_block_pair(blk, blk, cfg, True, device=dev)
    out = []
    for d in (dev, "cpu"):
        las = type(la)(la.tspace, columns=la.columns.permute(
            np.arange(la.novl)))
        rows = np.arange(0, las.novl, 3)
        before = wave_wide.trace_wave.launches
        dropped = ov.retrace_rows(las, rows, block_from_reads(reads),
                                  block_from_reads(reads), cfg, device=d)
        if d != "cpu":
            assert wave_wide.trace_wave.launches > before
        out.append((dropped, las.columns))
    assert out[0][0] == out[1][0]
    for k in ("headers", "trace", "offsets"):
        assert np.array_equal(getattr(out[0][1], k), getattr(out[1][1], k))


@pytest.mark.cuda
@pytest.mark.parametrize("bands,semi", [((64, 96), True), ((700, 96), True),
                                        ((200,), False), ((700,), False)])
def test_band_align_kernel_matches_plain(dev, bands, semi):
    """K4 on a ragged batch of mixed bands (narrow and wide pairs in one
    launch), both modes: ops, offsets and jstart equal
    band_align_plain's, and the wrapper counts the launch."""
    from damar_tpu_torch.ops import band_align as ba
    from damar_tpu_torch.utils.sim import align_pairs_batch
    rng = np.random.default_rng(21)
    pairs = align_pairs_batch(rng, 200, bands=bands, semiglobal=semi)
    n0 = ba.band_align.launches
    got = ba.align_pairs(pairs, semi, device=dev)
    assert ba.band_align.launches == n0 + 1
    want = ba.align_pairs(pairs, semi, device="cpu")
    for (g, gj), (w, wj) in zip(got, want):
        assert np.array_equal(g, w) and gj == wj


def _k4_same(dev, pairs, semi):
    """One K4 launch (align_pairs on the card, counted once) and the
    device-tensor wrapper band_align_kernel both equal band_align_plain
    on the pairs."""
    from damar_tpu_torch.ops import band_align as ba
    n0 = ba.band_align.launches
    got = ba.align_pairs(pairs, semi, device=dev)
    assert ba.band_align.launches == n0 + 1
    want = ba.align_pairs(pairs, semi, device="cpu")
    for (g, gj), (w, wj) in zip(got, want):
        assert np.array_equal(g, w) and gj == wj
    args = ba.pack_pairs(pairs, dev)
    for x, y in zip(ba.band_align_kernel(*args, semi),
                    ba.band_align_plain(*[t.cpu() for t in args], semi)):
        assert torch.equal(x.cpu(), y)


# (bands, longest template): narrow pairs only; each wide group size (2
# to 6 warps, widths on both sides of each warp edge) with its codes in
# shared memory (templates up to 500); the widest band with templates
# whose codes do not fit (1,300 x 384 bytes: global scratch, staged walk)
K4_CLASSES = {"narrow": ((64, 96, 127), 1300),
              "w2": ((128, 255), 500), "w3": ((256, 383), 500),
              "w4": ((384, 500), 500), "w5": ((600, 639), 500),
              "w6": ((640, 696, 767), 500), "global_codes": ((767,), 1300)}


@pytest.mark.cuda
@pytest.mark.parametrize("semi", [True, False])
@pytest.mark.parametrize("cls", list(K4_CLASSES))
def test_band_align_classes_match_plain(dev, cls, semi):
    """Each of K4's classes alone, both modes, exactly as
    band_align_plain."""
    from damar_tpu_torch.ops import band_align as ba
    from damar_tpu_torch.utils.sim import align_pairs_batch
    bands, max_len = K4_CLASSES[cls]
    pairs = align_pairs_batch(np.random.default_rng(len(cls) + semi), 60,
                              bands=bands, semiglobal=semi,
                              max_len=max_len)
    plan = ba.plan_launch([len(p[0]) for p in pairs],
                          [len(p[1]) for p in pairs], [p[2] for p in pairs])
    if cls == "narrow":
        assert plan.n_wide == 0 and plan.smem == 0
    else:
        assert plan.n_narrow == 0
        assert (plan.c_off >= 0).any() == (cls == "global_codes")
    _k4_same(dev, pairs, semi)


@pytest.mark.cuda
def test_band_align_polish_like_launch(dev):
    """A polish window's launch (utils.sim.polish_window_pairs: one
    500-code template, 21 covers at band 96, 3 first covers at bands
    216-615 on template slices) in one launch, narrow and wide blocks
    together, equal to
    band_align_plain; a band above MAX_BAND and a global walk out of the
    band raise on the card."""
    from damar_tpu_torch.ops import band_align as ba
    from damar_tpu_torch.utils.sim import polish_window_pairs
    pairs = polish_window_pairs(np.random.default_rng(31))
    tmpl = pairs[1][0]
    plan = ba.plan_launch([len(p[0]) for p in pairs],
                          [len(p[1]) for p in pairs], [p[2] for p in pairs])
    assert plan.n_wide == 3 and plan.smem > 0
    _k4_same(dev, pairs, True)
    with pytest.raises(ValueError, match="band"):
        ba.align_pairs([(tmpl, tmpl, ba.MAX_BAND + 1)], device=dev)
    with pytest.raises(ValueError, match="band"):
        ba.align_pairs([(tmpl, tmpl[:10], 8)], False, device=dev)


# a fresh process whose first K4 launch is one wide pair (band 128, m =
# 500) whose codes fit 48 KB but not 48 KB less the kernel's static
# shared memory: the launch must raise the kernel's limit itself
K4_FIRST_LAUNCH = """
import numpy as np
from damar_tpu_torch.ops import band_align as ba
from damar_tpu_torch.utils.sim import mutate
rng = np.random.default_rng(128)
t = rng.integers(0, 4, 500).astype(np.uint8)
pairs = [(t, mutate(t, 0.12, rng), 128)]
plan = ba.plan_launch([500], [len(pairs[0][1])], [128])
assert 40_000 < plan.smem <= 48 * 1024, plan.smem
got = ba.align_pairs(pairs, device="cuda")
want = ba.align_pairs(pairs, device="cpu")
assert all(np.array_equal(g, w) and gj == wj
           for (g, gj), (w, wj) in zip(got, want))
"""


@pytest.mark.cuda
def test_band_align_first_launch_near_48k(dev):
    """K4's first launch in a process, at 40,080 bytes of codes in
    shared memory, equals band_align_plain."""
    r = subprocess.run([sys.executable, "-c", K4_FIRST_LAUNCH],
                       capture_output=True, text=True, timeout=900,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.cuda
def test_polish_on_card_matches_cpu(dev):
    """correct_reads and polish_rounds through K4 on the card give the CPU
    path's sequences."""
    from damar_tpu_torch.pipeline import consensus as cs
    from damar_tpu_torch.utils.sim import make_genome, mutate
    rng = np.random.default_rng(22)
    g = make_genome(6_000, seed=23)
    reads = [mutate(g[s:s + 2500], 0.12, rng) for s in range(0, 3600, 300)]
    lay = [(i, 0, s) for i, s in enumerate(range(0, 3600, 300))]
    seq_of = lambda i, d: reads[i]  # noqa: E731
    out = [cs.polish_rounds(g.copy(), lay, seq_of, rounds=2, device=d)
           for d in (dev, "cpu")]
    assert np.array_equal(out[0], out[1])


def _rc_block(rng, total: int, pad: int = 3):
    """A block of random reads (gamma lengths, mean ~6 kbp, some of 1
    base) of about `total` bases, padded past nbases."""
    from damar_tpu_torch.core.blocks import block_from_reads
    lens = np.maximum(1, rng.gamma(3.0, 2000.0, total // 6000 + 1)
                      .astype(np.int64))
    lens[::97] = 1
    reads = [rng.integers(0, 4, int(k), dtype=np.uint8) for k in lens]
    n = int(lens.sum())
    return block_from_reads(reads, cap=n + pad)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["quads", "offset"])
def test_revcomp_kernel_matches_revcomp_block(dev, aligned):
    """revcomp_kernel's twin of a ~10 Mbp block == revcomp_block, one
    launch, on arrays as uploaded (16-byte quads) and at an odd offset
    (position by position)."""
    from damar_tpu_torch.core.blocks import revcomp_block
    from damar_tpu_torch.ops import revcomp
    blk = _rc_block(np.random.default_rng(31), 10_000_000)
    args = [torch.as_tensor(x) for x in (blk.bases, blk.read_id,
                                         blk.starts.astype(np.int64))]
    if aligned:
        b, r, s = (x.to(dev) for x in args)
    else:
        b, r = (torch.empty(x.shape[0] + 1, dtype=x.dtype, device=dev)[1:]
                for x in args[:2])
        b.copy_(args[0])
        r.copy_(args[1])
        s = args[2].to(dev)
    before = revcomp.revcomp_bases.launches
    got = revcomp.revcomp_bases(b, r, s, blk.nbases)
    torch.cuda.synchronize()
    assert revcomp.revcomp_bases.launches == before + 1
    assert np.array_equal(got.cpu().numpy(), revcomp_block(blk).bases)


@pytest.mark.cuda
def test_pair_stream_makes_twins_on_card(dev):
    """A small distinct pair, three times through overlap_pairs_pipelined
    with B's caches dropped before each job (A's kept), gives the CPU
    path's .las bytes; B's twin is made on the card each pair (A's too in
    the first), no host twin is built, and neither twin has host bases.
    A self pair's pool holds its shared twin once."""
    from damar_tpu_torch.core.blocks import block_from_reads
    from damar_tpu_torch.core.config import OverlapConfig
    from damar_tpu_torch.pipeline import overlap as ov
    from damar_tpu_torch.utils.sim import make_genome, sample_reads
    reads = sample_reads(make_genome(40_000, seed=3), coverage=10.0,
                         mean_len=3000, err=0.14, seed=4).reads
    h = len(reads) // 2

    def blocks():
        return (block_from_reads(reads[:h], ids=np.arange(h)),
                block_from_reads(reads[h:], ids=np.arange(h, len(reads))))
    cfg = OverlapConfig()
    want = ov.overlap_block_pair(*blocks(), cfg, False, device="cpu")
    a, b = blocks()
    twins = []

    def jobs():
        for k in range(3):
            ov.release_device_buffers(b)
            if "rc_block" in b.cache:
                twins.append(b.cache["rc_block"])
            b.cache.clear()
            yield dict(tag=k, blk_a=a, blk_b=b, self_block=False)
    got = list(ov.overlap_pairs_pipelined(jobs(), cfg, device=dev))
    twins.append(b.cache["rc_block"])
    assert [g[0] for g in got] == [0, 1, 2]
    for _, la, lb, st in got:
        assert la.novl == want[0].novl > 0
        for x, y in ((la, want[0]), (lb, want[1])):
            for k in ("headers", "trace", "offsets"):
                assert np.array_equal(getattr(x.columns, k),
                                      getattr(y.columns, k))
    assert [g[3]["rc_dev_built"] for g in got] == [2, 1, 1]
    assert len(twins) == 3 and len({id(t) for t in twins}) == 3
    assert a.cache["rc_block"].bases is None
    assert all(t.bases is None for t in twins)
    s, _ = blocks()
    ov.overlap_block_pair(s, s, cfg, True, device=dev)
    rc = s.cache["rc_block"]
    assert rc.bases is None
    words, oa, obf, obc, oar = s.cache["trace_pool"][2], *ov._trace_pool(
        s, s, rc, rc, True, dev)[1:]
    assert (oa, obf, obc, oar) == (0, 0, s.cap, s.cap)
    assert words.shape[0] == 2 * s.cap // 16
