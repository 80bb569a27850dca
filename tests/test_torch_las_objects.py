"""Port vs reference for the .las object API (formats/las.py: Overlap,
the object-backed LasFile, show_las, reconstruct_alignment;
formats/oflags.py flag_str) and the object forms of the tools that read
it: build_graph, full_layout, correct_reads, polish_read, stitch_las,
q_and_trim, filter_las, the repeat tracks, classify and retrace_las.

The pile is damar_tpu's own overlap of a small DB (40 kbp genome with
repeats, 12x, chimeric reads; its native host kernels, which write its
device route's files) and fuzz records made from a seed.  Every object
form is held against the reference's object form and against the port's
columnar form: .las bytes, track arrays, graphml text, reads.  The
reference's retrace runs on its device route (native.available ->
False); its pile aligner is its host C band_align, which K4's plain
version follows (fault 3j).  Tolerance: exact equality."""
import filecmp

import numpy as np
import pytest
import torch

from damar_tpu import native
from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.core.config import ScrubConfig as RefScrubConfig
from damar_tpu.formats import dazzdb as ref_db
from damar_tpu.formats import las as ref_las
from damar_tpu.formats import oflags as ref_oflags
from damar_tpu.pipeline import consensus as ref_cons
from damar_tpu.pipeline import graph as ref_graph
from damar_tpu.pipeline import masking as ref_masking
from damar_tpu.pipeline import overlap as ref_ov
from damar_tpu.pipeline import scrub as ref_scrub
from damar_tpu.pipeline.planner import run_overlap_plan as ref_plan
from damar_tpu.utils.sim import make_genome, sample_reads, write_sim_fasta
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig, ScrubConfig
from damar_tpu_torch.formats import las, oflags
from damar_tpu_torch.formats.fasta import revcomp
from damar_tpu_torch.pipeline import consensus, graph, masking, scrub
from damar_tpu_torch.pipeline import overlap as ov

torch.set_num_threads(2)
MIN_LEN = 500


@pytest.fixture(scope="module")
def pile(tmp_path_factory):
    """(workdir, the merged .las path, reads, read lengths by id)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DAMAR_BP", "native")
    w = tmp_path_factory.mktemp("lasobj")
    g = make_genome(40_000, seed=3, n_repeats=3)
    sim = sample_reads(g, coverage=12.0, mean_len=3000, err=0.14, seed=4,
                       chimera_frac=0.1)
    write_sim_fasta(f"{w}/r.fasta", sim)
    ref_db.create_db(f"{w}/E.db", [f"{w}/r.fasta"])
    db = ref_db.db_split(f"{w}/E.db", size_mb=1, cutoff=MIN_LEN)
    try:
        ref_plan(f"{w}/E.db", RefConfig(min_len=MIN_LEN), verbose=False)
    finally:
        mp.undo()
    reads = [db.read_seq(i) for i in range(db.ureads)]
    return str(w), f"{w}/E.1.las", reads, {i: len(r) for i, r in
                                           enumerate(reads)}


def seqs_of_fn(reads):
    def seqs_of(i, comp):
        return revcomp(reads[i]) if comp else reads[i]
    return seqs_of


def objects(path):
    """The port's file, object-backed."""
    f = las.read_las(path)
    f.overlaps
    return f


def fuzz_records(rng, n: int, tspace: int) -> list:
    """Random consistent records (A span, segments on the tspace grid,
    per-segment diffs >= |aspan - bspan|)."""
    out = []
    for _ in range(n):
        ab = int(rng.integers(0, 3000))
        ae = ab + int(rng.integers(1, 2500))
        segs = []
        a0 = ab
        while a0 < ae:
            a1 = min((a0 // tspace + 1) * tspace, ae)
            bs = max(0, (a1 - a0) + int(rng.integers(-8, 9)))
            segs.append((abs((a1 - a0) - bs) + int(rng.integers(0, 30)), bs))
            a0 = a1
        tr = np.array(segs, np.int32)
        bb = int(rng.integers(0, 500))
        out.append(dict(aread=int(rng.integers(0, 50)),
                        bread=int(rng.integers(0, 50)),
                        flags=int(rng.integers(0, 1 << 13)), abpos=ab,
                        aepos=ae, bbpos=bb, bepos=bb + int(tr[:, 1].sum()),
                        diffs=int(tr[:, 0].sum()), trace=tr))
    return out


def test_flag_str_and_names():
    assert oflags.FLAG_NAMES == ref_oflags.FLAG_NAMES
    for f in (0, 1, 5, 0x40 | 0x4, 0x1FFF, 0x2000):
        assert oflags.flag_str(f) == ref_oflags.flag_str(f)


@pytest.mark.parametrize("tspace", [100, 200])
def test_overlap_objects_and_write(tmp_path, tspace):
    """Overlap's fields, repr, comp/alen/blen; an object-backed file
    writes the reference's bytes (u8 traces at tspace 100, i16 at 200);
    reading it back and materializing gives the same objects."""
    rng = np.random.default_rng(tspace)
    recs = fuzz_records(rng, 40, tspace)
    got = [las.Overlap(**r) for r in recs]
    want = [ref_las.Overlap(**r) for r in recs]
    for g, w in zip(got, want):
        assert repr(g) == repr(w)
        assert (g.comp, g.alen(), g.blen()) == (w.comp, w.alen(), w.blen())
    pf, rf = las.LasFile(tspace, got), ref_las.LasFile(tspace, want)
    assert pf.columns is None and pf.novl == 40
    assert np.array_equal(pf.a_spans(), rf.a_spans())
    las.write_las(str(tmp_path / "p.las"), pf)
    ref_las.write_las(str(tmp_path / "r.las"), rf)
    assert filecmp.cmp(tmp_path / "p.las", tmp_path / "r.las",
                       shallow=False)
    back = las.read_las(str(tmp_path / "p.las"))
    assert back.columns is not None
    ob = back.overlaps
    assert back.columns is None          # materialized: the columns drop
    assert back.overlaps is ob
    assert [repr(o) for o in ob] == [repr(o) for o in got]
    for a, b in zip(ob, got):
        assert np.array_equal(a.trace, b.trace)
    # the object-backed file is checked through its columns: the problems
    # of the same records read from the file (the reference's object walk
    # words them otherwise, and finds a problem exactly when it does)
    rlen = np.full(50, 9000)
    problems = las.check_las(back, rlen)
    assert problems and problems == ref_las.check_las(
        ref_las.read_las(str(tmp_path / "r.las")), rlen)
    assert bool(ref_las.check_las(rf, rlen))
    pf.sort()
    rf.sort()
    assert las.check_las(pf, rlen) == ref_las.check_las(rf, rlen) == []
    las.write_las(str(tmp_path / "p2.las"), pf)
    ref_las.write_las(str(tmp_path / "r2.las"), rf)
    assert filecmp.cmp(tmp_path / "p2.las", tmp_path / "r2.las",
                       shallow=False)


def test_concat_mixed_parts(pile, tmp_path):
    """concat of a columnar part and an object-backed one gives objects
    (materializing the columnar part), of columnar parts columns; both
    write the reference's bytes."""
    _, path, _, _ = pile
    for mixed in (True, False):
        ps = [las.read_las(path), las.read_las(path)]
        rs = [ref_las.read_las(path), ref_las.read_las(path)]
        if mixed:
            ps[1].overlaps
            rs[1].overlaps
        p, r = las.LasFile.concat(ps), ref_las.LasFile.concat(rs)
        assert (p.columns is None) == (r.columns is None) == mixed
        assert ps[0].columns is None if mixed else ps[0].columns is not None
        p.sort()
        r.sort()
        las.write_las(str(tmp_path / "p.las"), p)
        ref_las.write_las(str(tmp_path / "r.las"), r)
        assert filecmp.cmp(tmp_path / "p.las", tmp_path / "r.las",
                           shallow=False)


def test_show_las_and_reconstruct_alignment(pile):
    """show_las text; reconstruct_alignment text with every segment of
    the records in one call of K4's plain version, against the
    reference's per-segment host C alignments."""
    _, path, reads, _ = pile
    pf, rf = las.read_las(path), ref_las.read_las(path)
    assert las.show_las(pf, limit=40) == ref_las.show_las(rf, limit=40)
    assert las.show_las(pf) == ref_las.show_las(rf)
    assert native.available()
    shown = pf.overlaps[:6] + [o for o in pf.overlaps if o.comp][:4]
    recs = [(o, reads[o.aread],
             revcomp(reads[o.bread]) if o.comp else reads[o.bread])
            for o in shown]
    got = las.reconstruct_alignments(recs, pf.tspace, device="cpu")
    for (o, a, b), g in zip(recs, got):
        assert g == ref_las.reconstruct_alignment(o, a, b, pf.tspace)
        assert "|" in g
    assert las.reconstruct_alignment(*recs[0], pf.tspace,
                                     device="cpu") == got[0]


def test_build_graph_objects(pile):
    _, path, _, rlen_of = pile
    pf, rf = objects(path), ref_las.read_las(path)
    rf.overlaps
    cols = las.read_las(path)
    texts = []
    for lf, mod in ((pf, graph), (cols, graph), (rf, ref_graph)):
        g = mod.build_graph(lf, rlen_of, fuzz=40, min_dovetail=1000)
        mod.transitive_reduction(g)
        texts.append(mod.graphml(g))
    assert texts[0] == texts[1] == texts[2]
    assert texts[0].count("<edge") > 10


def test_full_layout_objects(pile):
    _, path, _, rlen_of = pile
    pf, rf = objects(path), ref_las.read_las(path)
    rf.overlaps
    lay = [(r, r % 2, 1000 * r) for r in range(0, 60, 3)]
    got = consensus.full_layout(lay, pf, rlen_of)
    assert got == ref_cons.full_layout(lay, rf, rlen_of)
    assert got == consensus.full_layout(lay, las.read_las(path), rlen_of)
    assert len(got) > len(lay)


def test_correct_and_polish_read_objects(pile):
    """correct_reads over objects equals the reference's and the port's
    columnar form; polish_read of a read equals correct_reads(reads=[r])
    (the pile has no discarded record) and the reference's."""
    _, path, reads, rlen_of = pile
    seqs_of = seqs_of_fn(reads)
    pf, rf = objects(path), ref_las.read_las(path)
    rf.overlaps
    want_reads = [3, 17]
    got = consensus.correct_reads(pf, seqs_of, rlen_of, reads=want_reads,
                                  device="cpu")
    want = ref_cons.correct_reads(rf, seqs_of, rlen_of, reads=want_reads)
    cols = consensus.correct_reads(las.read_las(path), seqs_of, rlen_of,
                                   reads=want_reads, device="cpu")
    assert got.keys() == want.keys() == cols.keys() == set(want_reads)
    for r in want_reads:
        assert np.array_equal(got[r], want[r])
        assert np.array_equal(got[r], cols[r])
    r = want_reads[0]
    pr = consensus.polish_read(r, pf, seqs_of, rlen_of[r], device="cpu")
    assert np.array_equal(pr, got[r])
    assert np.array_equal(pr, ref_cons.polish_read(r, rf, seqs_of,
                                                   rlen_of[r]))


def test_scrub_tools_objects(pile, tmp_path):
    """stitch_las, q_and_trim and filter_las over objects: the reference's
    results and the port's columnar ones."""
    _, path, _, rlen_of = pile
    res = {}
    for tag, lf, mod, scfg in (
            ("obj", objects(path), scrub, ScrubConfig()),
            ("cols", las.read_las(path), scrub, ScrubConfig()),
            ("ref", ref_las.read_las(path), ref_scrub, RefScrubConfig())):
        if tag == "ref":
            lf.overlaps
        lasm = ref_las if tag == "ref" else las
        st, needs = mod.stitch_las(lf, fuzz=scfg.stitch_fuzz)
        lasm.write_las(str(tmp_path / f"{tag}.st.las"), st)
        q, t = mod.q_and_trim(lf, rlen_of, scfg)
        f = mod.filter_las(lf, rlen_of, scfg, None)
        lasm.write_las(str(tmp_path / f"{tag}.f.las"), f)
        res[tag] = (list(needs), q, t)
    for tag in ("obj", "cols"):
        for name in ("st", "f"):
            assert filecmp.cmp(tmp_path / f"{tag}.{name}.las",
                               tmp_path / f"ref.{name}.las", shallow=False)
        needs, q, t = res[tag]
        assert needs == res["ref"][0]
        assert t == res["ref"][2]
        assert q.keys() == res["ref"][1].keys()
        assert all(np.array_equal(q[k], res["ref"][1][k]) for k in q)


def test_repeat_tracks_objects(pile):
    _, path, reads, _ = pile
    rlen = np.array([len(r) for r in reads])
    idx = {i: i for i in range(len(reads))}
    pf, rf = objects(path), ref_las.read_las(path)
    rf.overlaps
    for fn in ("repeat_track_coverage", "repeat_track_relative"):
        args = (rlen, idx, len(reads)) + ((6,) if "coverage" in fn else ())
        got = getattr(masking, fn)(pf, *args)
        want = getattr(ref_masking, fn)(rf, *args)
        cols = getattr(masking, fn)(las.read_las(path), *args)
        assert got.name == want.name
        assert all(np.array_equal(a, b) and np.array_equal(a, c)
                   for a, b, c in zip(got.data, want.data, cols.data))


def test_classify():
    rng = np.random.default_rng(9)
    for r in fuzz_records(rng, 300, 100):
        for alen, blen in ((r["aepos"] + int(rng.integers(0, 60)),
                            r["bepos"] + int(rng.integers(0, 60))),):
            for fuzz in (0, 25, 200):
                assert scrub.classify(las.Overlap(**r), alen, blen, fuzz) == \
                    ref_scrub.classify(ref_las.Overlap(**r), alen, blen,
                                       fuzz)


def test_retrace_las(pile):
    """retrace_las over objects whose traces were cleared: the reference's
    traces, diffs, flags and drop count (records with a B span moved off
    their alignment fail the trace checks and are flagged, keeping their
    trace); `only` retraces a subset; a read missing from the blocks
    raises KeyError in both."""
    _, path, reads, _ = pile
    rng = np.random.default_rng(12)
    src = las.read_las(path).overlaps
    pick = rng.choice(len(src), 40, replace=False)
    recs = []
    for k, i in enumerate(pick):
        o = src[i]
        d = dict(aread=o.aread, bread=o.bread, flags=o.flags, abpos=o.abpos,
                 aepos=o.aepos, bbpos=o.bbpos, bepos=o.bepos, diffs=0,
                 trace=np.zeros((1, 2), np.int32))
        if k % 10 == 0:                    # off its alignment
            sh = min(700, len(reads[o.bread]) - o.bepos)
            d["bbpos"] += sh
            d["bepos"] += sh
        recs.append(d)
    ids = np.arange(len(reads))
    cfg, rcfg = OverlapConfig(MIN_LEN), RefConfig(MIN_LEN)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    mp.setenv("DAMAR_BP", "jax")
    try:
        pf = las.LasFile(100, [las.Overlap(**r) for r in recs])
        rf = ref_las.LasFile(100, [ref_las.Overlap(**r) for r in recs])
        only_p, only_r = pf.overlaps[5:25], rf.overlaps[5:25]
        got = ov.retrace_las(pf, block_from_reads(reads, ids=ids),
                             block_from_reads(reads, ids=ids), cfg,
                             only=only_p, device="cpu")
        want = ref_ov.retrace_las(rf, ref_block(reads, ids=ids),
                                  ref_block(reads, ids=ids), rcfg,
                                  only=only_r)
        with pytest.raises(KeyError):
            ov.retrace_las(pf, block_from_reads(reads[:3], ids=ids[:3]),
                           block_from_reads(reads, ids=ids), cfg,
                           device="cpu")
        with pytest.raises(KeyError):
            ref_ov.retrace_las(rf, ref_block(reads[:3], ids=ids[:3]),
                               ref_block(reads, ids=ids), rcfg)
    finally:
        mp.undo()
    assert got == want >= 1
    for a, b in zip(pf.overlaps, rf.overlaps):
        assert (a.flags, a.diffs) == (b.flags, b.diffs)
        assert np.array_equal(a.trace, b.trace)
    assert sum(o.trace[:, 1].sum() > 0 for o in only_p) >= 15
    assert all(o.diffs == 0 for o in pf.overlaps[:5] + pf.overlaps[25:])


@pytest.mark.parametrize("semiglobal", [True, False])
def test_banded_align_path(semiglobal):
    """banded_align_path on K4's plain version gives the reference's
    path (its host C band_align, the aligner its pipeline runs)."""
    rng = np.random.default_rng(31 + semiglobal)
    from damar_tpu_torch.utils.sim import mutate
    assert native.available()
    for _ in range(12):
        a = rng.integers(0, 4, int(rng.integers(50, 400))).astype(np.uint8)
        b = mutate(a, 0.12, rng)
        if semiglobal:
            b = np.concatenate([rng.integers(0, 4, 30).astype(np.uint8), b])
        band = int(rng.choice([32, 64, 96]))
        got = consensus.banded_align_path(a, b, band, semiglobal,
                                          device="cpu")
        assert got == ref_cons.banded_align_path(a, b, band, semiglobal)
        assert sum(op != 2 for op, _, _ in got) == len(a)


def test_recruit_layout_and_finish_polish_raw(pile):
    """The single-contig recruit_layout and finish_polish_raw: the
    reference's layout and polished draft."""
    _, _, reads, _ = pile
    seqs_of = seqs_of_fn(reads)
    from damar_tpu_torch.utils.sim import mutate
    draft = mutate(np.concatenate(reads[:3])[:6000],
                   0.02, np.random.default_rng(8))
    for circ in (False, True):
        lay = consensus.recruit_layout(draft, len(reads), seqs_of,
                                       circular=circ)
        assert lay == ref_cons.recruit_layout(draft, len(reads), seqs_of,
                                              circular=circ)
    got = consensus.finish_polish_raw(draft, len(reads), seqs_of, rounds=2,
                                      device="cpu")
    want = ref_cons.finish_polish_raw(draft, len(reads), seqs_of, rounds=2)
    assert np.array_equal(got, want) and len(got) > 5000
