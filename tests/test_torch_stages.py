"""Port vs reference for damar_tpu/pipeline/run.py's phases 1-6 from a
DB on disk: ingest (FASTA -> DB -> 3 blocks), mask (dust and tandem
tracks), overlap1 with those masks, patch (LAstitch -> retrace -> LAq ->
LAfix per block, then FIX.fasta -> FIX DB), overlap2 on the FIX DB and
scrub (merge -> sort -> stitch -> retrace -> LAq -> LAgap -> q/trim
tracks -> clip to trim -> LArepeat -> LAfilter), composed here as
run.py composes them, once through each package.  Every track, .las
file and FIX.fasta must be byte-equal.  One config for both, with its
length thresholds lowered to fit reads of <= 1,300 bp.

The reference runs on its all-device route (DAMAR_BP=jax from conftest,
damar_tpu.native.available -> False).  Its datander search is called
with a hit cap that holds every hit (asserted, with every seed): under
its default cap it truncates the hit buffer of a 1 Mbp block (fault 3g,
ROADMAP.md; tests/test_torch_masking.py shows it), and the port does
not copy that."""
import filecmp
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import damar_tpu.ops.seeding as ref_seeding
from damar_tpu.core import blocks as ref_blocks
from damar_tpu.core import config as ref_config
from damar_tpu.formats import dazzdb as ref_dazzdb
from damar_tpu.formats import fasta as ref_fasta
from damar_tpu.formats import las as ref_las
from damar_tpu.formats import tracks as ref_tracks
from damar_tpu.pipeline import masking as ref_masking
from damar_tpu.pipeline import overlap as ref_overlap
from damar_tpu.pipeline import planner as ref_planner
from damar_tpu.pipeline import run as ref_run
from damar_tpu.pipeline import scrub as ref_scrub
from damar_tpu_torch.core import blocks, config
from damar_tpu_torch.formats import dazzdb, fasta, las, tracks
from damar_tpu_torch.formats.las import H_FLAGS
from damar_tpu_torch.formats.oflags import OVL_DISCARD
from damar_tpu_torch.pipeline import masking, overlap, planner, run, scrub
from damar_tpu_torch.utils import sim

torch.set_num_threads(2)

REF = SimpleNamespace(blocks=ref_blocks, config=ref_config, db=ref_dazzdb,
                      fasta=ref_fasta, las=ref_las, tracks=ref_tracks,
                      masking=ref_masking, overlap=ref_overlap,
                      planner=ref_planner, run=ref_run, scrub=ref_scrub,
                      dev={})
PORT = SimpleNamespace(blocks=blocks, config=config, db=dazzdb, fasta=fasta,
                       las=las, tracks=tracks, masking=masking,
                       overlap=overlap, planner=planner, run=run,
                       scrub=scrub, dev={"device": "cpu"})
BLOCK_MB, MIN_READ = 1, 500


def stage_reads():
    """~2.05 Mbp of reads of 500-1,300 bp over a 600 kbp genome with 8
    planted tandems and 4 repeat copies: blocks of 1.0, 1.0 and 0.05
    Mbp."""
    g = sim.make_genome(600_000, seed=31, n_repeats=4, tandem=8)
    s = sim.sample_reads(g, coverage=6.4, mean_len=900, err=0.10, seed=32)
    keep = [i for i, r in enumerate(s.reads) if len(r) <= 1300]
    cum = np.cumsum([len(s.reads[i]) for i in keep])
    keep = [i for i, c in zip(keep, cum) if c <= 2_050_000]
    return sim.SimReads(g, [s.reads[i] for i in keep], s.start[keep],
                        s.end[keep], s.strand[keep], s.err)


def cfgs(pkg):
    c = pkg.config
    return (c.OverlapConfig(min_len=500), c.MaskConfig(tan_min_len=300),
            c.ScrubConfig(min_trim_len=500, filter_min_len=500,
                          anchor_min=200))


def run_stages(pkg, w: str, reads) -> dict:
    """run.py's phases 1-6 (pipeline/run.py:60-227) through one package
    in directory w; returns counts per phase."""
    ocfg, mcfg, scfg = cfgs(pkg)
    dev = pkg.dev
    out = {}
    os.makedirs(w)
    # 1. ingest
    sim.write_sim_fasta(f"{w}/reads.fasta", reads)
    raw_db = f"{w}/RAW.db"
    pkg.db.create_db(raw_db, [f"{w}/reads.fasta"])
    pkg.db.db_split(raw_db, size_mb=BLOCK_MB, cutoff=MIN_READ)
    db = pkg.db.DazzDB.open(raw_db)
    out["blocks"] = db.nblocks
    # 2. mask
    seqs = [db.read_seq(i) for i in range(db.ureads)]
    pkg.tracks.write_track(raw_db, pkg.masking.dust_track(seqs, mcfg))
    data = [np.zeros(0, np.int32)] * db.ureads
    for b in range(1, db.nblocks + 1):
        blk = pkg.blocks.block_from_db(db, b)
        t = pkg.masking.tandem_track(blk, ocfg, mcfg, **dev)
        for j, rid in enumerate(blk.ids):
            data[int(rid)] = t.data[j]
    pkg.tracks.write_track(raw_db, pkg.tracks.Track("tan", data))
    out["tan_bp"] = pkg.tracks.read_track(raw_db, "tan").masked_bp()
    # 3. overlap1
    pkg.planner.run_overlap_plan(raw_db, ocfg, verbose=False,
                                 mask_names=["dust", "tan"], **dev)
    # 4. patch
    rlen_of = {i: int(db.reads["rlen"][i]) for i in range(db.ureads)}

    def seqs_of_raw(i, comp):
        s = db.read_seq(i)
        return pkg.fasta.revcomp(s) if comp else s

    parts, needs_n = [], []
    for b in range(1, db.nblocks + 1):
        full = pkg.las.read_las(f"{w}/RAW.{b}.las")
        stitched, needs = pkg.scrub.stitch_las(full,
                                               fuzz=scfg.stitch_fuzz)
        needs_n.append(len(needs))
        if len(needs):
            pkg.overlap.retrace_rows(
                stitched, needs, pkg.blocks.block_from_db(db, b),
                pkg.run._reads_subset_block(db, stitched, needs, side="b"),
                ocfg, **dev)
        qual, _ = pkg.scrub.q_and_trim(stitched, rlen_of, scfg)
        parts.extend(pkg.scrub.fix_reads(stitched, seqs_of_raw, rlen_of,
                                         qual, scfg))
    out["patch_needs"] = needs_n
    fix_db = f"{w}/FIX.db"
    pkg.fasta.write_fasta(f"{w}/FIX.fasta",
                          [f"fixed/{p.src_read}/{p.part}_{len(p.seq)}"
                           for p in parts], [p.seq for p in parts])
    pkg.db.create_db(fix_db, [f"{w}/FIX.fasta"])
    pkg.db.db_split(fix_db, size_mb=BLOCK_MB, cutoff=MIN_READ)
    fdb = pkg.db.DazzDB.open(fix_db)
    out["fixed_reads"] = fdb.ureads
    # 5. overlap2
    pkg.planner.run_overlap_plan(fix_db, ocfg, verbose=False, **dev)
    # 6. scrub
    frlen = {i: int(fdb.reads["rlen"][i]) for i in range(fdb.ureads)}
    pkg.las.merge_las([f"{w}/FIX.{b}.las" for b in range(1, fdb.nblocks + 1)],
                      f"{w}/FIX.merged.las")
    full = pkg.las.read_las(f"{w}/FIX.merged.las")
    full.sort()
    stitched, needs = pkg.scrub.stitch_las(full, fuzz=scfg.stitch_fuzz)
    out["scrub_needs"] = len(needs)
    if len(needs):
        sub = pkg.run._reads_subset_block
        out["scrub_dropped"] = pkg.overlap.retrace_rows(
            stitched, needs, sub(fdb, stitched, needs, side="a"),
            sub(fdb, stitched, needs, side="b"), ocfg, **dev)
    idx = {i: i for i in range(fdb.ureads)}
    qual, trim = pkg.scrub.q_and_trim(stitched, frlen, scfg)
    breaks = pkg.scrub.gap_breaks(stitched, frlen, scfg)
    out["breaks"] = sum(len(v) for v in breaks.values())
    trim = pkg.scrub.gap_trim(trim, breaks, ts=ocfg.tspace)
    pkg.tracks.write_track(fix_db, pkg.scrub.q_track(qual, fdb.ureads, idx))
    pkg.tracks.write_track(fix_db,
                           pkg.scrub.trim_track(trim, fdb.ureads, idx))
    stitched = pkg.scrub.clip_las_to_trim(stitched, frlen, trim)
    pkg.las.write_las(f"{w}/FIX.scrubbed.las", stitched)
    trlen = np.array([max(trim.get(i, (0, frlen[i]))[1]
                          - trim.get(i, (0, frlen[i]))[0], 0)
                      for i in range(fdb.ureads)], np.int64)
    rep = pkg.masking.repeat_track_relative(stitched, trlen, idx, fdb.ureads,
                                            mcfg.rep_low, mcfg.rep_high)
    rep.name = "repeats"
    pkg.tracks.write_track(fix_db, rep)
    filt = pkg.scrub.filter_las(stitched,
                                {i: int(trlen[i]) for i in range(fdb.ureads)},
                                scfg, {i: rep.data[i]
                                       for i in range(fdb.ureads)})
    pkg.las.write_las(f"{w}/FIX.filtered.las", filt)
    out["filtered"] = filt.novl
    out["kept"] = int(((filt.columns.headers[:, H_FLAGS]
                        & OVL_DISCARD) == 0).sum())
    return out


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    from damar_tpu import native
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    mp.setenv("DAMAR_BP", "jax")
    seen = []
    real = ref_seeding.find_tandem_seeds

    def uncapped(*a, **kw):
        s = real(*a, **dict(kw, hit_cap=1 << 24))
        seen.append((s["nhits"], s["total_hits"], s["nseeds"],
                     s["total_seeds"]))
        return s
    mp.setattr(ref_seeding, "find_tandem_seeds", uncapped)
    base = tmp_path_factory.mktemp("stages")
    reads = stage_reads()
    # the port runs beside the reference (most of whose time is XLA
    # compiles); neither package reads the other's state
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(run_stages, PORT, str(base / "port"), reads)
        try:
            want = run_stages(REF, str(base / "ref"), reads)
        finally:
            mp.undo()
        got = port.result()
    return str(base / "ref"), str(base / "port"), want, got, seen


def test_reference_search_held_every_hit(stages):
    *_, seen = stages
    assert len(seen) == 3
    for nhits, total_hits, nseeds, total_seeds in seen:
        assert nhits == total_hits and nseeds == total_seeds


def test_phase_counts_equal(stages):
    _, _, want, got, _ = stages
    assert got == want
    assert got["blocks"] == 3 and got["tan_bp"] > 0
    assert got["fixed_reads"] > 0 and got["kept"] > 0


@pytest.mark.parametrize("name", [
    ".RAW.dust.anno", ".RAW.dust.data", ".RAW.tan.anno", ".RAW.tan.data",
    "RAW.1.las", "RAW.2.las", "RAW.3.las", "FIX.fasta",
    "FIX.1.las", "FIX.merged.las", ".FIX.q.anno", ".FIX.q.data",
    ".FIX.trim.anno", ".FIX.trim.data", ".FIX.repeats.anno",
    ".FIX.repeats.data",
    "FIX.scrubbed.las", "FIX.filtered.las"])
def test_files_byte_equal(stages, name):
    rw, pw, *_ = stages
    assert os.path.exists(f"{rw}/{name}")
    assert filecmp.cmp(f"{rw}/{name}", f"{pw}/{name}", shallow=False), name


def test_every_las_checks_clean(stages):
    _, pw, *_ = stages
    for db, names in (("RAW", ["RAW.1.las", "RAW.2.las", "RAW.3.las"]),
                      ("FIX", ["FIX.merged.las", "FIX.scrubbed.las",
                               "FIX.filtered.las"])):
        d = dazzdb.DazzDB.open(f"{pw}/{db}.db")
        for n in names:
            # the scrubbed and filtered files are in trimmed coordinates
            assert las.check_las(las.read_las(f"{pw}/{n}"),
                                 d.reads["rlen"]) == [], n
