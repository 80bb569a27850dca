"""Port vs reference for the scrub stages (pipeline/scrub.py and the
retrace, pipeline/overlap.py retrace_rows) on one pile: damar_tpu's own
overlap of a small simulated DB (repeats, chimeric reads), written as
.las and read by both packages.  Before the pile goes in, some records
are cut into two fragments on their trace grid, either overlapping by
one segment (a negative junction gap: LAstitch leaves the merged chain
without a trace and hands it to the retrace) or one segment apart (a
positive gap: LAstitch bridges the trace).  Tolerance: exact equality
of arrays, byte equality of .las and track files.

The reference runs its retrace on the wide band of its all-device route
(damar_tpu.native.available -> False: ops.wave.trace_wave, the twin of
the Pallas kernel), as the port's other tests run it."""
import filecmp

import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.core.config import ScrubConfig as RefScrubConfig
from damar_tpu.formats import dazzdb as ref_db
from damar_tpu.formats import las as ref_las
from damar_tpu.formats import tracks as ref_tracks
from damar_tpu.pipeline import overlap as ref_ov
from damar_tpu.pipeline import scrub as ref_scrub
from damar_tpu.pipeline.planner import run_overlap_plan as ref_plan
from damar_tpu.utils.sim import make_genome, sample_reads, write_sim_fasta
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig, ScrubConfig
from damar_tpu_torch.formats import las, tracks
from damar_tpu_torch.formats.las import (H_ABPOS, H_AEPOS, H_AREAD,
                                         H_BBPOS, H_BREAD, H_DIFFS, H_FLAGS,
                                         H_TLEN, LasColumns, LasFile,
                                         _decode_trace, encode_trace_columns)
from damar_tpu_torch.formats.oflags import OVL_COMP, OVL_DISCARD
from damar_tpu_torch.pipeline import overlap as ov
from damar_tpu_torch.pipeline import scrub

torch.set_num_threads(2)
MIN_LEN = 500


def fragment(pile: LasFile, rng) -> LasFile:
    """Cut every 4th record of >= 8 trace segments in two on its segment
    grid: alternately overlapping by segment k-1 (both fragments hold
    it) or leaving segment k out.  Every fragment keeps an exact slice
    of the record's trace."""
    c = pile.columns
    ts, small = pile.tspace, pile.small
    rows = _decode_trace(c.trace, small)
    seg_off = c.offsets // (2 if small else 4)
    heads, traces = [], []
    cut = 0
    for i in range(c.n):
        h = c.headers[i]
        tr = rows[seg_off[i]:seg_off[i + 1]]
        m = len(tr)
        if i % 4 or m < 8:
            heads.append(h.copy())
            traces.append(tr)
            continue
        a = [int(h[H_ABPOS])] + [(int(h[H_ABPOS]) // ts + j) * ts
                                 for j in range(1, m)] + [int(h[H_AEPOS])]
        b = int(h[H_BBPOS]) + np.concatenate([[0], np.cumsum(tr[:, 1])])
        k = int(rng.integers(3, m - 3))
        if tr[k - 1, 1] > 100 or tr[k, 1] > 100:
            heads.append(h.copy())
            traces.append(tr)
            continue
        spans = ((0, k), (k - 1, m)) if cut % 2 == 0 else ((0, k), (k + 1, m))
        cut += 1
        for s0, s1 in spans:
            f = h.copy()
            f[H_ABPOS], f[H_AEPOS] = a[s0], a[s1]
            f[H_BBPOS], f[5] = b[s0], b[s1]
            f[H_TLEN] = 2 * (s1 - s0)
            f[H_DIFFS] = int(tr[s0:s1, 0].sum())
            heads.append(f)
            traces.append(tr[s0:s1])
    offs = np.concatenate([[0], np.cumsum([len(t) for t in traces])])
    payload, boffs = encode_trace_columns(np.concatenate(traces), offs,
                                          small)
    out = LasFile(ts, columns=LasColumns(np.stack(heads), payload, boffs))
    out.sort()
    return out


@pytest.fixture(scope="module")
def pile(tmp_path_factory):
    """(path of the fragmented pile, reads, read lengths by id)."""
    from damar_tpu import native
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    mp.setenv("DAMAR_BP", "jax")
    w = tmp_path_factory.mktemp("scrub")
    g = make_genome(40_000, seed=3, n_repeats=3)
    sim = sample_reads(g, coverage=12.0, mean_len=3000, err=0.14, seed=4,
                       chimera_frac=0.1)
    write_sim_fasta(f"{w}/r.fasta", sim)
    ref_db.create_db(f"{w}/E.db", [f"{w}/r.fasta"])
    db = ref_db.db_split(f"{w}/E.db", size_mb=1, cutoff=500)
    try:
        ref_plan(f"{w}/E.db", RefConfig(min_len=MIN_LEN), verbose=False)
    finally:
        mp.undo()
    whole = las.read_las(f"{w}/E.1.las")
    cut = fragment(whole, np.random.default_rng(5))
    assert cut.novl > whole.novl + 20
    las.write_las(f"{w}/cut.las", cut)
    reads = [db.read_seq(i) for i in range(db.ureads)]
    rlen_of = {i: len(r) for i, r in enumerate(reads)}
    return str(w), reads, rlen_of


@pytest.fixture(scope="module")
def chain(pile):
    """Both packages' scrub chain on the pile: stitch -> retrace (the
    needed rows, B reads in a subset block that lacks one of them) ->
    LAq -> LAfix -> LAgap -> clip to trim."""
    from damar_tpu import native
    w, reads, rlen_of = pile
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    mp.setenv("DAMAR_BP", "jax")
    out = {}
    try:
        for tag, mod, lasm, blk_of, cfg, scfg, dev in (
                ("ref", ref_scrub, ref_las, ref_block, RefConfig(MIN_LEN),
                 RefScrubConfig(), {}),
                ("port", scrub, las, block_from_reads, OverlapConfig(MIN_LEN),
                 ScrubConfig(), {"device": "cpu"})):
            r = {}
            full = lasm.read_las(f"{w}/cut.las")
            stitched, needs = mod.stitch_las(full, fuzz=scfg.stitch_fuzz)
            lasm.write_las(f"{w}/{tag}.stitched.las", stitched)
            r["needs"] = needs
            h = stitched.columns.headers
            bids = np.unique(h[needs, H_BREAD])
            absent = int(bids[len(bids) // 2])
            bids = bids[bids != absent]
            r["absent"] = absent
            blk_a = blk_of(reads, ids=np.arange(len(reads)))
            blk_b = blk_of([reads[i] for i in bids], ids=bids)
            retr = ref_ov.retrace_rows if tag == "ref" else ov.retrace_rows
            r["dropped"] = retr(stitched, needs, blk_a, blk_b, cfg, **dev)
            lasm.write_las(f"{w}/{tag}.retraced.las", stitched)
            r["qual"], r["trim"] = mod.q_and_trim(stitched, rlen_of, scfg)

            def seqs_of(i, comp):
                s = reads[i]
                return (3 - s[::-1]).astype(np.uint8) if comp else s
            r["fixed"] = mod.fix_reads(stitched, seqs_of, rlen_of, r["qual"],
                                       scfg)
            r["breaks"] = mod.gap_breaks(stitched, rlen_of, scfg)
            r["gtrim"] = mod.gap_trim(r["trim"], r["breaks"], ts=100)
            idx = {i: i for i in rlen_of}
            trk = ref_tracks if tag == "ref" else tracks
            db = f"{w}/{tag}.db"
            trk.write_track(db, mod.q_track(r["qual"], len(reads), idx))
            trk.write_track(db, mod.trim_track(r["gtrim"], len(reads), idx))
            r["clipped"] = mod.clip_las_to_trim(stitched, rlen_of, r["gtrim"])
            lasm.write_las(f"{w}/{tag}.clipped.las", r["clipped"])
            out[tag] = r
    finally:
        mp.undo()
    return w, out


def same_file(w, name):
    return filecmp.cmp(f"{w}/ref.{name}", f"{w}/port.{name}", shallow=False)


def test_stitch_las(chain):
    w, out = chain
    np.testing.assert_array_equal(out["port"]["needs"], out["ref"]["needs"])
    assert same_file(w, "stitched.las")
    st = las.read_las(f"{w}/port.stitched.las")
    h = st.columns.headers
    stitched = (h[:, H_FLAGS] & 0x40) != 0
    # chains of both kinds: bridged (a trace) and needing a retrace
    assert (stitched & (h[:, H_TLEN] > 0)).sum() > 5
    assert len(out["port"]["needs"]) > 5


def test_retrace_rows(pile, chain):
    _, reads, _ = pile
    w, out = chain
    assert out["port"]["dropped"] == out["ref"]["dropped"] >= 1
    assert same_file(w, "retraced.las")
    st = las.read_las(f"{w}/port.retraced.las")
    h = st.columns.headers[out["port"]["needs"]]
    comp = (h[:, H_FLAGS] & OVL_COMP) != 0
    ok = (h[:, H_FLAGS] & OVL_DISCARD) == 0
    assert (ok & comp).any() and (ok & ~comp).any()     # both orientations
    gone = h[:, H_BREAD] == out["port"]["absent"]
    assert gone.any() and not ok[gone].any()
    assert (h[gone, H_TLEN] == 0).all()
    live = (st.columns.headers[:, H_FLAGS] & OVL_DISCARD) == 0
    sub = LasFile(st.tspace, columns=st.columns.permute(np.nonzero(live)[0]))
    assert las.check_las(sub, [len(r) for r in reads]) == []


def test_q_and_trim(chain):
    _, out = chain
    r, p = out["ref"], out["port"]
    assert p["trim"] == r["trim"]
    assert sorted(p["qual"]) == sorted(r["qual"])
    for k in r["qual"]:
        np.testing.assert_array_equal(p["qual"][k], r["qual"][k])


def test_fix_reads(chain):
    _, out = chain
    r, p = out["ref"]["fixed"], out["port"]["fixed"]
    assert len(p) == len(r) > 0
    for x, y in zip(p, r):
        assert (x.src_read, x.part, x.src_interval) == \
            (y.src_read, y.part, y.src_interval)
        np.testing.assert_array_equal(x.seq, y.seq)


def test_gap_breaks_and_trim(chain):
    _, out = chain
    assert out["port"]["breaks"] == out["ref"]["breaks"]
    assert sum(len(v) for v in out["port"]["breaks"].values()) > 0
    assert out["port"]["gtrim"] == out["ref"]["gtrim"]
    assert out["port"]["gtrim"] != out["port"]["trim"]


@pytest.mark.parametrize("name", ["q.anno", "q.data", "trim.anno",
                                  "trim.data"])
def test_q_and_trim_tracks(chain, name):
    w, _ = chain
    assert filecmp.cmp(f"{w}/.ref.{name}", f"{w}/.port.{name}",
                       shallow=False)


def test_clip_las_to_trim(chain):
    w, out = chain
    assert same_file(w, "clipped.las")
    assert 0 < out["port"]["clipped"].novl


@pytest.mark.parametrize("repeats,trimmed,best_n", [
    (False, False, 0), (True, False, 0), (True, True, 0), (True, True, 2)])
def test_filter_las(chain, tmp_path, repeats, trimmed, best_n):
    _, out = chain
    res = []
    for tag, mod, lasm, cfg in (
            ("ref", ref_scrub, ref_las,
             RefScrubConfig(filter_min_len=MIN_LEN, filter_best_n=best_n)),
            ("port", scrub, las,
             ScrubConfig(filter_min_len=MIN_LEN, filter_best_n=best_n))):
        r = out[tag]
        clipped = r["clipped"]
        trim = r["gtrim"]
        rl = {i: max(te - tb, 0) for i, (tb, te) in trim.items()}
        rep = None
        if repeats:
            h = clipped.columns.headers
            # every read's A-interval covered by >= 4 records
            from damar_tpu_torch.pipeline.masking import _coverage_data
            data = _coverage_data(h[:, H_AREAD].astype(np.int64),
                                  h[:, H_ABPOS], h[:, H_AEPOS],
                                  np.array([rl[i] for i in range(len(rl))]),
                                  len(rl), 4)
            rep = {i: d for i, d in enumerate(data)}
        f = mod.filter_las(clipped, rl, cfg, rep,
                           trim_of=trim if trimmed else None)
        lasm.write_las(str(tmp_path / f"{tag}.las"), f)
        res.append(f)
    assert filecmp.cmp(tmp_path / "ref.las", tmp_path / "port.las",
                       shallow=False)
    h = res[1].columns.headers
    disc = (h[:, H_FLAGS] & OVL_DISCARD) != 0
    assert disc.any() and not disc.all()
    if repeats:
        assert ((h[:, H_FLAGS] & 0x200) != 0).any()          # OVL_REPEAT
