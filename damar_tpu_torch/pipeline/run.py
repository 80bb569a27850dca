"""The full assembly pipeline: the port of damar_tpu/pipeline/run.py, one
idempotent in-process run of the planner-script workflow.

Phases (each file-checkpointed; a rerun resumes):
  1. ingest   : FASTA -> DB -> split
  2. mask     : DUST + tandem tracks
  3. overlap1 : all-vs-all with soft masks -> per-block .las
  4. patch    : stitch -> q/trim -> LAfix -> FIX DB
  5. overlap2 : all-vs-all on the fixed DB
  6. scrub    : stitch -> q/trim -> repeat track -> filter
  7. assemble : string graph -> tour -> contigs (+ optional polish)

The kernels run on `device` ("cuda", the default, or "cpu" for their
plain versions): the tandem search and the overlap rounds on K1-K3, the
retraces on K3, the pile alignments of read correction and polish on
K4.  The seeding buffers are sized from their counts, so no pair is cut
short.  Every file is the reference's, byte for byte, and report.json
holds the reference's keys.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from damar_tpu_torch.core.blocks import block_from_db, block_from_reads
from damar_tpu_torch.core.config import PipelineConfig
from damar_tpu_torch.formats import dazzdb, las as lasmod, tracks
from damar_tpu_torch.formats.fasta import revcomp, write_fasta
from damar_tpu_torch.formats.las import H_AREAD, H_BREAD, H_FLAGS
from damar_tpu_torch.formats.oflags import OVL_DISCARD


def _reads_subset_block(db, las, rows, side: str):
    """A ReadBlock holding exactly the reads the given columnar rows
    reference on one side ("a" or "b"): the retrace of merged piles
    whose B (or A) reads span blocks, without loading the whole DB."""
    col = H_AREAD if side == "a" else H_BREAD
    ids = np.unique(las.columns.headers[np.asarray(rows), col])
    return block_from_reads([db.read_seq(int(r)) for r in ids], ids=ids)


def run_pipeline(fasta: str, workdir: str, cfg: PipelineConfig | None = None,
                 polish: bool = True, verbose: bool = True, *,
                 device: str = "cuda") -> dict:
    """FASTA -> CONTIGS.fasta and report.json in `workdir` (see the
    module docstring).  device: "cuda" (the default; raises without a
    card) or "cpu".  Returns the report written to report.json."""
    from damar_tpu_torch.pipeline import masking, scrub
    from damar_tpu_torch.pipeline.consensus import (
        correct_reads, finish_polish_raw_multi, full_layout, polish_rounds)
    from damar_tpu_torch.pipeline.overlap import retrace_rows
    from damar_tpu_torch.pipeline.planner import run_overlap_plan
    from damar_tpu_torch.pipeline.touring import (assemble,
                                                  dedupe_contained_contigs,
                                                  tour_layout)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_pipeline: device cuda but no CUDA device "
                           "is available (pass device=\"cpu\" for the "
                           "plain kernel versions)")
    dev = {"device": device}
    cfg = cfg or PipelineConfig()
    os.makedirs(workdir, exist_ok=True)
    report: dict = {"phases": {}}
    t_all = time.time()

    def log(msg):
        if verbose:
            print(f"# {msg}", flush=True)

    def phase(name):
        t0 = time.time()

        def done(**info):
            report["phases"][name] = {"wall_s": round(time.time() - t0, 2),
                                      **info}
            log(f"{name}: {report['phases'][name]}")
        return done

    def plan_stats(st):
        # the reference's keys (the port's per-pair stats stay out)
        return {k: v for k, v in st.items() if k != "pair_stats"}

    # ---- 1. ingest --------------------------------------------------------
    raw_db = os.path.join(workdir, "RAW.db")
    d = phase("ingest")
    if not os.path.exists(raw_db):
        dazzdb.create_db(raw_db, [fasta])
        dazzdb.db_split(raw_db, size_mb=cfg.block_mb,
                        cutoff=cfg.min_read_len)
    db = dazzdb.DazzDB.open(raw_db)
    d(reads=db.ureads, bp=db.totlen, blocks=db.nblocks)

    # ---- 2. mask ----------------------------------------------------------
    d = phase("mask")
    if not tracks.track_exists(raw_db, "dust"):
        seqs = [db.read_seq(i) for i in range(db.ureads)]
        tracks.write_track(raw_db, masking.dust_track(seqs, cfg.mask))
    if not tracks.track_exists(raw_db, "tan"):
        data = [np.zeros(0, np.int32)] * db.ureads
        for b in range(1, max(db.nblocks, 1) + 1):
            blk = block_from_db(db, b)
            t = masking.tandem_track(blk, cfg.overlap, cfg.mask, **dev)
            for j, rid in enumerate(blk.ids):
                data[int(rid)] = t.data[j]
        tracks.write_track(raw_db, tracks.Track("tan", data))
    dust = tracks.read_track(raw_db, "dust")
    tan = tracks.read_track(raw_db, "tan")
    d(dust_bp=dust.masked_bp(), tan_bp=tan.masked_bp())

    # ---- 3. overlap round 1 ----------------------------------------------
    d = phase("overlap1")
    st = run_overlap_plan(raw_db, cfg.overlap, verbose=False,
                          mask_names=["dust", "tan"], **dev)
    d(**plan_stats(st))

    # ---- 4. patch ---------------------------------------------------------
    d = phase("patch")
    fix_db = os.path.join(workdir, "FIX.db")
    fix_fasta = os.path.join(workdir, "FIX.fasta")
    rlen_of = {i: int(db.reads["rlen"][i]) for i in range(db.ureads)}

    def seqs_of_raw(i, comp):
        s = db.read_seq(i)
        return revcomp(s) if comp else s

    if not os.path.exists(fix_db):
        parts = []
        for b in range(1, max(db.nblocks, 1) + 1):
            p = os.path.join(workdir, f"RAW.{b}.las")
            full = lasmod.read_las(p)
            stitched, needs = scrub.stitch_las(full,
                                               fuzz=cfg.scrub.stitch_fuzz)
            if len(needs):
                blk = block_from_db(db, b)
                # B-reads of a block pile span the whole DB: retrace
                # against a subset block of exactly the needed reads
                retrace_rows(stitched, needs, blk,
                             _reads_subset_block(
                                 db, stitched, needs, side="b"),
                             cfg.overlap, **dev)
            qual, trim = scrub.q_and_trim(stitched, rlen_of, cfg.scrub)
            patched = scrub.fix_reads(stitched, seqs_of_raw, rlen_of,
                                      qual, cfg.scrub)
            parts.extend(patched)
        write_fasta(fix_fasta,
                    [f"fixed/{p.src_read}/{p.part}_{len(p.seq)}"
                     for p in parts],
                    [p.seq for p in parts])
        dazzdb.create_db(fix_db, [fix_fasta])
        dazzdb.db_split(fix_db, size_mb=cfg.block_mb,
                        cutoff=cfg.min_read_len)
    fdb = dazzdb.DazzDB.open(fix_db)
    d(fixed_reads=fdb.ureads, fixed_bp=fdb.totlen)

    # ---- 5. overlap round 2 ----------------------------------------------
    d = phase("overlap2")
    st = run_overlap_plan(fix_db, cfg.overlap, verbose=False, **dev)
    d(**plan_stats(st))

    # ---- 6. scrub ---------------------------------------------------------
    d = phase("scrub")
    frlen = {i: int(fdb.reads["rlen"][i]) for i in range(fdb.ureads)}

    filt_path = os.path.join(workdir, "FIX.filtered.las")
    if not os.path.exists(filt_path):
        parts = [p for b in range(1, max(fdb.nblocks, 1) + 1)
                 if os.path.exists(p := os.path.join(workdir,
                                                     f"FIX.{b}.las"))]
        merged_path = os.path.join(workdir, "FIX.merged.las")
        if parts:
            lasmod.merge_las(parts, merged_path)
            full = lasmod.read_las(merged_path)
        else:
            full = lasmod.LasFile(cfg.overlap.tspace)
        full.sort()
        stitched, needs = scrub.stitch_las(full, fuzz=cfg.scrub.stitch_fuzz)
        if len(needs):
            retrace_rows(
                stitched, needs,
                _reads_subset_block(fdb, stitched, needs, side="a"),
                _reads_subset_block(fdb, stitched, needs, side="b"),
                cfg.overlap, **dev)
        idx = {i: i for i in range(fdb.ureads)}
        # LAq + LAgap on the fixed DB: trim to the good interval, cut
        # chimeric junctions, persist q/trim tracks, then clip every
        # record into trimmed coordinates so the graph stage works on
        # the trimmed read universe
        qual, trim = scrub.q_and_trim(stitched, frlen, cfg.scrub)
        breaks = scrub.gap_breaks(stitched, frlen, cfg.scrub)
        trim = scrub.gap_trim(trim, breaks, ts=cfg.overlap.tspace)
        tracks.write_track(fix_db, scrub.q_track(qual, fdb.ureads, idx))
        tracks.write_track(fix_db,
                           scrub.trim_track(trim, fdb.ureads, idx))
        stitched = scrub.clip_las_to_trim(stitched, frlen, trim)
        # the full scrubbed piles feed the read corrector (graph
        # filtering drops records that still carry sequence evidence)
        lasmod.write_las(os.path.join(workdir, "FIX.scrubbed.las"),
                         stitched)
        trlen_arr = np.array([max(trim.get(i, (0, frlen[i]))[1]
                                  - trim.get(i, (0, frlen[i]))[0], 0)
                              for i in range(fdb.ureads)], np.int64)
        rep = masking.repeat_track_relative(
            stitched, trlen_arr, idx, fdb.ureads,
            cfg.mask.rep_low, cfg.mask.rep_high)
        filt = scrub.filter_las(
            stitched, {i: int(trlen_arr[i]) for i in range(fdb.ureads)},
            cfg.scrub,
            {i: rep.data[i] for i in range(fdb.ureads)})
        lasmod.write_las(filt_path, filt)
    filt = lasmod.read_las(filt_path)
    # trimmed read universe for the graph stage (resume-safe: the trim
    # track is on disk before the filtered .las exists)
    trim_tr = tracks.read_track(fix_db, "trim") \
        if tracks.track_exists(fix_db, "trim") else None

    def trim_of_read(i):
        if trim_tr is not None and len(trim_tr.data[i]) == 2:
            return int(trim_tr.data[i][0]), int(trim_tr.data[i][1])
        return 0, frlen[i]

    trim_bounds = {i: trim_of_read(i) for i in range(fdb.ureads)}
    trlen = {i: max(te - tb, 0) for i, (tb, te) in trim_bounds.items()}

    def seqs_of_trimmed(i, comp):
        tb, te = trim_bounds[i]
        s = fdb.read_seq(i)[tb:te]
        return revcomp(s) if comp else s
    kept = int(((filt.columns.headers[:, H_FLAGS] & OVL_DISCARD) == 0).sum())
    d(records=filt.novl, kept=kept)

    # ---- 7. assemble ------------------------------------------------------
    d = phase("assemble")
    contigs, tours, graph = assemble(
        filt, trlen, seqs_of_trimmed, fuzz=cfg.scrub.filter_fuzz,
        min_dovetail=cfg.tour.min_dovetail,
        spur_len=cfg.tour.spur_len, bubble_max=cfg.tour.bubble_max)
    if polish:
        # corrector pass: consensus-correct every read from its full
        # scrubbed pile first, so contig windows where raw coverage
        # dips vote with corrected covers
        scr_path = os.path.join(workdir, "FIX.scrubbed.las")
        pile_las = lasmod.read_las(scr_path) \
            if os.path.exists(scr_path) else filt
        corrected = correct_reads(pile_las, seqs_of_trimmed, trlen,
                                  rounds=cfg.tour.corrector_rounds, **dev)

        def seqs_of_pol(i, comp):
            s = corrected.get(i)
            if s is None:
                return seqs_of_trimmed(i, comp)
            return revcomp(s) if comp else s

        out = []
        for c, t in zip(contigs, tours):
            tlay = tour_layout(t, seqs_of_trimmed)
            lay = full_layout(tlay, filt, trlen)
            # junction positions let polish collapse residual cut-error
            # duplications that votes cannot (copies split the calls)
            juncs = [s for _, _, s in tlay[1:] if 0 <= s < len(c)]
            out.append(polish_rounds(c, lay, seqs_of_pol,
                                     circular=t.circular,
                                     rounds=cfg.tour.polish_rounds,
                                     junctions=juncs,
                                     seq_of_raw=seqs_of_trimmed, **dev))
        # polished contigs expose duplicate repeat-branch walks
        contigs, tours = dedupe_contained_contigs(out, tours)
        if cfg.tour.finish_raw_rounds > 0:
            # raw-read finishing pass: recruiting the original reads
            # restores the evidence that scrubbing truncates where
            # coverage is thin
            contigs = finish_polish_raw_multi(
                contigs, [t.circular for t in tours], db.ureads,
                seqs_of_raw, rounds=cfg.tour.finish_raw_rounds, **dev)
    contig_path = os.path.join(workdir, "CONTIGS.fasta")
    write_fasta(contig_path,
                [f"contig_{k} len={len(c)} reads={t.nreads()} "
                 f"circular={t.circular}"
                 for k, (c, t) in enumerate(zip(contigs, tours))],
                contigs)
    d(contigs=len(contigs),
      lengths=[int(len(c)) for c in contigs[:10]],
      circular=[bool(t.circular) for t in tours[:10]])

    report["total_wall_s"] = round(time.time() - t_all, 2)
    report["contig_fasta"] = contig_path
    with open(os.path.join(workdir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report
