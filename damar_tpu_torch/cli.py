"""Command-line toolbox: the port of damar_tpu.cli, the lineage's
per-tool CLI surface as subcommands of one entry point.

    python -m damar_tpu_torch.cli <tool> [args...]

Tool names follow the lineage (fasta2db ~ fasta2DB/FA2db, daligner,
lasort/lamerge/lashow/lacheck, datander+tanmask, repmask, larepeat,
tkmerge/tkcombine/tkshow, lastitch/laq/lafix/lagap/lafilter,
ogbuild/ogtour/tour2fasta, hpc-plan, dbstats/dbshow/dbsplit/dbdust),
with damar_tpu's flags, defaults and output.

The kernels run on the card: DAMAR_PLATFORM unset or "cuda" selects it
(and a missing card is an error), DAMAR_PLATFORM=cpu the plain torch
versions on the CPU; any other value is an error.  The tools that run
kernels are daligner, overlap-all and datander (K1-K3), lastitch (K3),
lashow -a and assemble --polish (K4) and pipeline (all four).

One departure from damar_tpu: `datander -b B` writes block B's own tan
track (.{db}.{B}.tan.*), which `tkmerge tan` merges, as render_script's
masking phase expects; damar_tpu writes the DB-wide track with every
other block's reads empty, so a per-block loop keeps only the last
block.  `datander` without -b writes the DB-wide track as damar_tpu does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

PROG = "damar_tpu_torch"


def _db(path):
    from damar_tpu_torch.formats.dazzdb import DazzDB
    return DazzDB.open(path)


def _rlen_map(db):
    return {i: int(db.reads["rlen"][i]) for i in range(db.ureads)}


def _ocfg(args):
    from damar_tpu_torch.core.config import OverlapConfig
    kw = {}
    for field in ("kmer", "band_shift", "hit_min", "min_len", "tspace",
                  "max_kmer_count", "err", "identity", "bias"):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    return OverlapConfig(**kw)


# --- DB tools ---------------------------------------------------------------

def cmd_fasta2db(args):
    from damar_tpu_torch.formats.dazzdb import create_db
    db = create_db(args.db, args.fasta)
    print(f"{args.db}: {db.ureads} reads, {db.totlen} bp")


def cmd_db2fasta(args):
    from damar_tpu_torch.formats.fasta import decode_seq
    db = _db(args.db)
    w = args.width
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for i in range(db.ureads):
        out.write(f">read/{i}/0_{int(db.reads['rlen'][i])}\n")
        txt = decode_seq(db.read_seq(i))
        for k in range(0, len(txt), w):
            out.write(txt[k:k + w] + "\n")


def cmd_dbsplit(args):
    from damar_tpu_torch.formats.dazzdb import db_split
    db = db_split(args.db, size_mb=args.size, cutoff=args.cutoff)
    print(f"{args.db}: {db.nblocks} blocks "
          f"(-s{args.size} -x{args.cutoff})")


def cmd_dbstats(args):
    from damar_tpu_torch.formats.dazzdb import db_stats
    print(json.dumps(db_stats(args.db), indent=2))


def cmd_dbshow(args):
    from damar_tpu_torch.formats.fasta import decode_seq
    db = _db(args.db)
    for i in args.reads:
        s = decode_seq(db.read_seq(i))
        print(f">read {i} len {len(s)}")
        print(s[:args.limit] + ("..." if len(s) > args.limit else ""))


def cmd_dbdust(args):
    from damar_tpu_torch.core.config import MaskConfig
    from damar_tpu_torch.formats.tracks import write_track
    from damar_tpu_torch.pipeline.masking import dust_track
    db = _db(args.db)
    seqs = [db.read_seq(i) for i in range(db.ureads)]
    t = dust_track(seqs, MaskConfig(dust_window=args.window,
                                    dust_thresh=args.thresh))
    write_track(args.db, t)
    print(f"dust: {t.masked_bp()} bp masked over {db.ureads} reads")


def cmd_dbrm(args):
    from damar_tpu_torch.formats.dazzdb import _root, stub_path, idx_path, bps_path
    d, r = _root(args.db)
    removed = []
    for p in (stub_path(args.db), idx_path(args.db), bps_path(args.db)):
        if os.path.exists(p):
            os.remove(p)
            removed.append(p)
    for fn in os.listdir(d):
        if fn.startswith(f".{r}.") and (fn.endswith(".anno")
                                        or fn.endswith(".data")):
            os.remove(os.path.join(d, fn))
            removed.append(fn)
    print(f"removed {len(removed)} files")


# --- overlap ----------------------------------------------------------------

# the counts a pair's stats hold beyond damar_tpu's (the sized seeding
# buffers' totals, runs and path; the reverse-complement twins made):
# left out of what the tools print, so their output is damar_tpu's
_PORT_STATS = ("seed_runs", "seed_overflow", "seed_path", "seed_slices",
               "total_hits", "total_seeds", "rc_dev_built")


def _ref_stats(stats: dict) -> dict:
    """A pair's stats with damar_tpu's keys only (the walls, t_*, are
    each package's own)."""
    return {k: v for k, v in stats.items() if k not in _PORT_STATS}


def cmd_daligner(args):
    from damar_tpu_torch.core.blocks import block_from_db
    from damar_tpu_torch.formats.las import LasFile, write_las
    from damar_tpu_torch.pipeline.overlap import overlap_block_pair
    db = _db(args.db)
    cfg = _ocfg(args)
    blk_a = block_from_db(db, args.a_block)
    blk_b = blk_a if args.b_block == args.a_block \
        else block_from_db(db, args.b_block)
    self_block = args.b_block == args.a_block
    la, lb, st = overlap_block_pair(blk_a, blk_b, cfg,
                                    self_block=self_block,
                                    device=args.device)
    st = _ref_stats(st)
    from damar_tpu_torch.formats.dazzdb import _root
    _, root = _root(args.db)
    out_a = args.out or f"{root}.{args.a_block}.{root}.{args.b_block}.las"
    if self_block:
        both = LasFile.concat([la, lb])
        both.sort()
        write_las(out_a, both)
        print(f"{out_a}: {both.novl} records {st}")
    else:
        write_las(out_a, la)
        out_b = f"{root}.{args.b_block}.{root}.{args.a_block}.las"
        write_las(out_b, lb)
        print(f"{out_a}: {la.novl} + {out_b}: {lb.novl} records {st}")


def cmd_hpc_plan(args):
    from damar_tpu_torch.pipeline.planner import plan_block_pairs, render_script
    db = _db(args.db)
    from damar_tpu_torch.formats.dazzdb import _root
    _, root = _root(args.db)
    sys.stdout.write(render_script(
        plan_block_pairs(root, max(db.nblocks, 1)), db_root=root))


def cmd_overlap_all(args):
    from damar_tpu_torch.parallel.distributed import (init_multihost,
                                                      num_hosts)
    from damar_tpu_torch.pipeline.planner import run_overlap_plan
    nhosts = args.nhosts
    if args.host >= 0:
        host = args.host
    else:
        host = init_multihost()
        # launcher-env mode: the host count comes from the same
        # contract as the host index, or every rank > 0 would be out
        # of range of the default nhosts=1
        if nhosts == 1:
            nhosts = num_hosts()
    st = run_overlap_plan(args.db, _ocfg(args),
                          mask_names=args.mask or None,
                          nhosts=nhosts, host_id=host, device=args.device,
                          shown_stats=_ref_stats)
    st.pop("pair_stats", None)      # the port's own: each pair's stats
    print(json.dumps(st))


# --- las tools --------------------------------------------------------------

def cmd_lasort(args):
    from damar_tpu_torch.formats.las import sort_las_file
    for p in args.las:
        sort_las_file(p)
        print(f"sorted {p}")


def cmd_lamerge(args):
    from damar_tpu_torch.formats.las import merge_las
    merge_las(args.inputs, args.out)
    print(f"merged {len(args.inputs)} -> {args.out}")


def cmd_lacat(args):
    from damar_tpu_torch.formats.las import cat_las
    cat_las(args.inputs, args.out)


def cmd_lashow(args):
    from damar_tpu_torch.formats.las import (read_las,
                                             reconstruct_alignments,
                                             show_las)
    las = read_las(args.las)
    print(f"# {args.las}: {las.novl} records, tspace {las.tspace}")
    if not args.align:
        print(show_las(las, limit=args.limit))
        return
    from damar_tpu_torch.formats.fasta import revcomp
    db = _db(args.db)
    shown = las.overlaps[:args.limit]
    # every segment of every record shown in one pile-aligner call
    recs = [(o, db.read_seq(o.aread),
             revcomp(db.read_seq(o.bread)) if o.comp
             else db.read_seq(o.bread)) for o in shown]
    for o, text in zip(shown, reconstruct_alignments(
            recs, las.tspace, device=args.device)):
        c = "c" if o.comp else "n"
        print(f"{o.aread:7d} {o.bread:7d} {c} "
              f"[{o.abpos:7d}..{o.aepos:7d}] x "
              f"[{o.bbpos:7d}..{o.bepos:7d}] ({o.diffs} diffs)")
        print(text)


def cmd_lacheck(args):
    from damar_tpu_torch.formats.las import check_las, read_las
    db = _db(args.db)
    rlen = db.reads["rlen"]
    bad = 0
    for p in args.las:
        errs = check_las(read_las(p), rlen)
        if errs:
            bad += 1
            print(f"{p}: {len(errs)} problems")
            for e in errs[:args.limit]:
                print("  " + e)
        else:
            print(f"{p}: OK")
    sys.exit(1 if bad else 0)


def cmd_lasplit(args):
    """Split one .las into per-A-block files by the DB block table."""
    from damar_tpu_torch.formats.las import LasFile, read_las, write_las
    db = _db(args.db)
    las = read_las(args.las)
    from damar_tpu_torch.formats.dazzdb import _root
    d, root = _root(args.db)
    for b in range(1, db.nblocks + 1):
        lo, hi = db.block_range(b)
        sel = [o for o in las.overlaps if lo <= o.aread < hi]
        write_las(os.path.join(d, f"{root}.{b}.las"),
                  LasFile(las.tspace, sel))
        print(f"{root}.{b}.las: {len(sel)}")


# --- masking ----------------------------------------------------------------

def cmd_datander(args):
    from damar_tpu_torch.core.blocks import block_from_db
    from damar_tpu_torch.core.config import MaskConfig
    from damar_tpu_torch.formats.tracks import write_track
    from damar_tpu_torch.pipeline.masking import tandem_track
    from damar_tpu_torch.formats.tracks import Track
    db = _db(args.db)
    blocks = range(1, max(db.nblocks, 1) + 1) if args.block == 0 \
        else [args.block]
    data = [np.zeros(0, np.int32)] * db.ureads
    for b in blocks:
        blk = block_from_db(db, b)
        t = tandem_track(blk, _ocfg(args), MaskConfig(),
                         max_period=args.max_period, device=args.device)
        for j, rid in enumerate(blk.ids):
            data[int(rid)] = t.data[j]
        print(f"block {b}: tan {t.masked_bp()} bp")
    if args.block:
        # one block's own track, over its untrimmed read range, for
        # tkmerge to assemble
        lo, hi = db.block_range(args.block)
        part = Track(name="tan", data=data[lo:hi])
        write_track(args.db, part, block=args.block)
        print(f"tan track of block {args.block}: {part.masked_bp()} bp")
        return
    full = Track(name="tan", data=data)
    write_track(args.db, full)
    print(f"tan track: {full.masked_bp()} bp total")


def cmd_repmask(args):
    from damar_tpu_torch.formats.las import read_las
    from damar_tpu_torch.formats.tracks import write_track
    from damar_tpu_torch.pipeline.masking import (repeat_track_coverage,
                                            repeat_track_relative)
    db = _db(args.db)
    las = read_las(args.las)
    rlen = db.reads["rlen"]
    idx = {i: i for i in range(db.ureads)}
    if args.cov:
        t = repeat_track_coverage(las, rlen, idx, db.ureads, args.cov)
    else:
        t = repeat_track_relative(las, rlen, idx, db.ureads,
                                  args.low, args.high)
    write_track(args.db, t)
    print(f"{t.name}: {t.masked_bp()} bp masked")


def cmd_tkmerge(args):
    from damar_tpu_torch.formats.dazzdb import DazzDB
    from damar_tpu_torch.formats.tracks import merge_block_tracks
    db = _db(args.db)
    ranges = [db.block_range(b) for b in range(1, db.nblocks + 1)]
    t = merge_block_tracks(args.db, args.track, db.nblocks, ranges,
                           db.ureads)
    print(f"{args.track}: merged {db.nblocks} blocks, "
          f"{t.masked_bp()} bp")


def cmd_tkcombine(args):
    from damar_tpu_torch.formats.tracks import (combine_tracks, read_track,
                                          write_track)
    ts = [read_track(args.db, n) for n in args.tracks]
    t = combine_tracks(ts, args.out, mode=args.mode)
    write_track(args.db, t)
    print(f"{args.out}: {t.masked_bp()} bp ({args.mode} of "
          f"{','.join(args.tracks)})")


def cmd_tkshow(args):
    from damar_tpu_torch.formats.tracks import read_track
    t = read_track(args.db, args.track)
    for i in args.reads:
        print(f"read {i}: {t.data[i].reshape(-1, 2).tolist()}")


# --- scrubbing --------------------------------------------------------------

def cmd_lastitch(args):
    from damar_tpu_torch.core.blocks import block_from_db
    from damar_tpu_torch.formats.las import read_las, write_las
    from damar_tpu_torch.pipeline.overlap import retrace_rows
    from damar_tpu_torch.pipeline.scrub import stitch_las
    db = _db(args.db)
    las = read_las(args.las)
    stitched, needs = stitch_las(las, fuzz=args.fuzz)
    if len(needs):
        from damar_tpu_torch.pipeline.run import _reads_subset_block
        blk = block_from_db(db, args.block)
        retrace_rows(stitched, needs, blk,
                     _reads_subset_block(db, stitched, needs, side="b"),
                     _ocfg(args), device=args.device)
    write_las(args.out or args.las, stitched)
    print(f"stitched {len(needs)} merges -> {stitched.novl} records")


def cmd_laq(args):
    from damar_tpu_torch.formats.las import read_las
    from damar_tpu_torch.formats.tracks import write_track
    from damar_tpu_torch.core.config import ScrubConfig
    from damar_tpu_torch.pipeline.scrub import q_and_trim, q_track, trim_track
    db = _db(args.db)
    las = read_las(args.las)
    rlen_of = _rlen_map(db)
    qual, trim = q_and_trim(las, rlen_of, ScrubConfig())
    idx = {i: i for i in range(db.ureads)}
    write_track(args.db, q_track(qual, db.ureads, idx))
    write_track(args.db, trim_track(trim, db.ureads, idx))
    tbp = sum(te - tb for tb, te in trim.values())
    print(f"q+trim tracks written; kept {tbp} bp of "
          f"{sum(rlen_of.values())}")


def cmd_lafix(args):
    from damar_tpu_torch.formats.fasta import revcomp, write_fasta
    from damar_tpu_torch.formats.las import read_las
    from damar_tpu_torch.core.config import ScrubConfig
    from damar_tpu_torch.pipeline.scrub import fix_reads, q_and_trim
    db = _db(args.db)
    las = read_las(args.las)
    rlen_of = _rlen_map(db)
    scfg = ScrubConfig()
    qual, trim = q_and_trim(las, rlen_of, scfg)

    def seqs_of(i, comp):
        s = db.read_seq(i)
        return revcomp(s) if comp else s

    patched = fix_reads(las, seqs_of, rlen_of, qual, scfg)
    write_fasta(args.out,
                [f"fixed/{p.src_read}/{p.part}_{len(p.seq)} "
                 f"src={p.src_interval[0]}-{p.src_interval[1]}"
                 for p in patched],
                [p.seq for p in patched])
    print(f"{args.out}: {len(patched)} patched read parts, "
          f"{sum(len(p.seq) for p in patched)} bp")


def cmd_lagap(args):
    from damar_tpu_torch.formats.las import read_las
    from damar_tpu_torch.core.config import ScrubConfig
    from damar_tpu_torch.pipeline.scrub import gap_breaks
    db = _db(args.db)
    br = gap_breaks(read_las(args.las), _rlen_map(db), ScrubConfig())
    for r, positions in sorted(br.items()):
        print(f"read {r}: breaks at {positions}")
    print(f"# {len(br)} reads with pile gaps")


def cmd_lafilter(args):
    from damar_tpu_torch.formats.las import read_las, write_las
    from damar_tpu_torch.formats.tracks import read_track, track_exists
    from damar_tpu_torch.core.config import ScrubConfig
    from damar_tpu_torch.pipeline.scrub import filter_las
    from damar_tpu_torch.formats.oflags import OVL_DISCARD
    db = _db(args.db)
    las = read_las(args.las)
    rep = None
    if args.repeat_track and track_exists(args.db, args.repeat_track):
        t = read_track(args.db, args.repeat_track)
        rep = {i: t.data[i] for i in range(t.nreads)}
    out = filter_las(las, _rlen_map(db), ScrubConfig(), rep)
    if args.purge:
        out.overlaps = [o for o in out.overlaps
                        if not o.flags & OVL_DISCARD]
    write_las(args.out or args.las, out)
    kept = sum(1 for o in out.overlaps if not o.flags & OVL_DISCARD)
    print(f"{kept}/{las.novl} records kept")


# --- graph / touring --------------------------------------------------------

def cmd_ogbuild(args):
    from damar_tpu_torch.formats.las import read_las
    from damar_tpu_torch.pipeline.graph import (build_graph, graphml,
                                          transitive_reduction)
    db = _db(args.db)
    las = read_las(args.las)
    g = build_graph(las, _rlen_map(db), fuzz=args.fuzz,
                    min_dovetail=args.min_dovetail)
    nred = transitive_reduction(g)
    with open(args.out, "w") as f:
        f.write(graphml(g))
    print(f"{args.out}: {g.n_edges()} edges ({nred} reduced, "
          f"{len(g.contained)} contained reads)")


def cmd_oglayout(args):
    """OGlayout equivalent: graph with embedded x/y coordinates
    (+ optional SVG render)."""
    from damar_tpu_torch.formats.las import read_las
    from damar_tpu_torch.pipeline.graph import (build_graph, graphml,
                                          layout_coords, layout_svg,
                                          transitive_reduction)
    db = _db(args.db)
    las = read_las(args.las)
    g = build_graph(las, _rlen_map(db), fuzz=args.fuzz,
                    min_dovetail=args.min_dovetail)
    transitive_reduction(g)
    coords = layout_coords(g)
    with open(args.out, "w") as f:
        f.write(graphml(g, coords=coords))
    if args.svg:
        with open(args.svg, "w") as f:
            f.write(layout_svg(g, coords))
    print(f"{args.out}: {len(coords)} nodes laid out"
          + (f"; svg -> {args.svg}" if args.svg else ""))


def cmd_assemble(args):
    """ogbuild+ogtour+tour2fasta in one step (the common path);
    --polish runs pile consensus over each contig (L7)."""
    from damar_tpu_torch.formats.fasta import revcomp
    from damar_tpu_torch.formats.las import read_las
    from damar_tpu_torch.pipeline.touring import assemble, tour_layout
    db = _db(args.db)
    las = read_las(args.las)
    rlen_of = _rlen_map(db)

    def seq_of(i, d):
        s = db.read_seq(i)
        return revcomp(s) if d else s

    contigs, tours, g = assemble(las, rlen_of, seq_of,
                                 fuzz=args.fuzz,
                                 min_dovetail=args.min_dovetail)
    if args.polish:
        from damar_tpu_torch.pipeline.consensus import full_layout, polish_contig
        polished = []
        for c, t in zip(contigs, tours):
            lay = full_layout(tour_layout(t, seq_of), las, rlen_of)
            polished.append(polish_contig(c, lay, seq_of,
                                          device=args.device))
        contigs = polished
    _emit_contigs(args.out, contigs, tours,
                  note=" (polished)" if args.polish else "")


def _emit_contigs(path, contigs, tours, note: str = ""):
    """Shared contig FASTA emission (assemble / tour2fasta)."""
    from damar_tpu_torch.formats.fasta import write_fasta
    write_fasta(path,
                [f"contig_{k} len={len(c)} reads={t.nreads()} "
                 f"circular={t.circular}"
                 for k, (c, t) in enumerate(zip(contigs, tours))],
                contigs)
    print(f"{path}: {len(contigs)} contigs, "
          f"lengths {[len(c) for c in contigs[:10]]}{note}")


def cmd_ogtour(args):
    """Standalone touring stage (OGtour equivalent, upstream
    touring/OGtour ⟨VERIFY⟩): db + filtered .las -> tours JSON
    checkpoint (graph -> transitive reduction -> spur/bubble cleanup
    -> unbranched walks).  tour2fasta consumes the JSON."""
    from damar_tpu_torch.formats.las import read_las
    from damar_tpu_torch.pipeline.touring import tour_las
    db = _db(args.db)
    las = read_las(args.las)
    tours, _ = tour_las(las, _rlen_map(db), fuzz=args.fuzz,
                        min_dovetail=args.min_dovetail,
                        spur_len=args.spur_len,
                        bubble_max=args.bubble_max)
    doc = {"tours": [{"circular": t.circular,
                      "ends": t.ends,
                      "steps": [[v.read, v.dir, cut]
                                for v, cut in t.steps]}
                     for t in tours]}
    with open(args.out, "w") as f:
        json.dump(doc, f)
    print(f"{args.out}: {len(tours)} tours, "
          f"reads {[len(t.steps) for t in tours[:10]]}")


def cmd_tour2fasta(args):
    """Standalone contig emission (tour2fasta equivalent): db + tours
    JSON -> contig FASTA via the junction-stitching layout."""
    from damar_tpu_torch.formats.fasta import revcomp
    from damar_tpu_torch.pipeline.graph import Vertex
    from damar_tpu_torch.pipeline.touring import Tour, tour_to_seq
    db = _db(args.db)
    with open(args.tours) as f:
        doc = json.load(f)

    def seq_of(i, d):
        s = db.read_seq(i)
        return revcomp(s) if d else s

    tours = [Tour(steps=[(Vertex(r, d), cut) for r, d, cut
                         in t["steps"]], circular=t["circular"],
                  ends=t.get("ends"))
             for t in doc["tours"]]
    contigs = [tour_to_seq(t, seq_of) for t in tours]
    order = np.argsort([-len(c) for c in contigs])
    _emit_contigs(args.out, [contigs[i] for i in order],
                  [tours[i] for i in order])


def cmd_ctanalyze(args):
    """Contig post-analysis (CT* equivalent): per-contig coverage/
    support/termination + assembly N50 stats."""
    from damar_tpu_torch.formats.fasta import read_fasta, revcomp
    from damar_tpu_torch.formats.las import read_las
    from damar_tpu_torch.pipeline.contigs import assembly_stats, analyze_contig
    from damar_tpu_torch.pipeline.touring import assemble, tour_layout
    from damar_tpu_torch.pipeline.consensus import full_layout
    db = _db(args.db)
    las = read_las(args.las)
    rlen_of = _rlen_map(db)

    def seq_of(i, d):
        s = db.read_seq(i)
        return revcomp(s) if d else s

    contigs, tours, g = assemble(las, rlen_of, seq_of, fuzz=args.fuzz,
                                 min_dovetail=args.min_dovetail)
    report = []
    for c, t in zip(contigs, tours):
        lay = full_layout(tour_layout(t, seq_of), las, rlen_of)
        report.append(analyze_contig(c, t, lay, seq_of))
    stats = assembly_stats([len(c) for c in contigs],
                           genome_size=args.genome_size or None)
    print(json.dumps({"assembly": stats, "contigs": report}, indent=2))


def cmd_pipeline(args):
    """Full assembly: mask -> overlap -> patch -> re-overlap -> scrub
    -> assemble (the reference's planner-script workflow)."""
    from damar_tpu_torch.core.config import PipelineConfig
    from damar_tpu_torch.pipeline.run import run_pipeline
    cfg = PipelineConfig(block_mb=args.block_size,
                         min_read_len=args.cutoff)
    rep = run_pipeline(args.fasta, args.workdir, cfg,
                       polish=not args.no_polish, device=args.device)
    print(json.dumps({"contigs": rep["phases"]["assemble"],
                      "total_wall_s": rep["total_wall_s"]}))


# --- argparse wiring --------------------------------------------------------

def build_parser():
    p = argparse.ArgumentParser(
        prog=PROG,
        description="GPU long-read overlap + assembly toolbox (the "
                    "PyTorch/CUDA port of damar_tpu)")
    sub = p.add_subparsers(dest="tool", required=True)

    def tool(name, fn, *specs, **kw):
        sp = sub.add_parser(name, **kw)
        for spec in specs:
            flags, skw = spec
            sp.add_argument(*flags, **skw)
        sp.set_defaults(fn=fn)
        return sp

    A = lambda *flags, **kw: (flags, kw)
    ocfg_args = [
        A("-k", "--kmer", type=int, default=None),
        A("-w", "--band-shift", type=int, default=None, dest="band_shift"),
        A("-h2", "--hit-min", type=int, default=None, dest="hit_min"),
        A("-l", "--min-len", type=int, default=None, dest="min_len"),
        A("-s", "--tspace", type=int, default=None),
        A("-t", "--max-kmer-count", type=int, default=None,
          dest="max_kmer_count"),
        A("-e", "--err", type=float, default=None),
        A("-I", "--identity", action="store_const", const=True,
          default=None, help="report self-overlaps of a read"),
        A("--bias", action="store_const", const=True,
          default=None,
          help="daligner -b: biased-composition seeding "
               "(information-weighted band coverage)"),
    ]

    tool("fasta2db", cmd_fasta2db, A("db"), A("fasta", nargs="+"))
    tool("db2fasta", cmd_db2fasta, A("db"), A("-o", "--out", default="-"),
         A("--width", type=int, default=80))
    tool("dbsplit", cmd_dbsplit, A("db"),
         A("-s", "--size", type=int, default=200),
         A("-x", "--cutoff", type=int, default=0))
    tool("dbstats", cmd_dbstats, A("db"))
    tool("dbshow", cmd_dbshow, A("db"),
         A("reads", type=int, nargs="+"),
         A("--limit", type=int, default=200))
    tool("dbdust", cmd_dbdust, A("db"),
         A("--window", type=int, default=64),
         A("--thresh", type=float, default=2.0))
    tool("dbrm", cmd_dbrm, A("db"))

    tool("daligner", cmd_daligner, A("db"),
         A("a_block", type=int), A("b_block", type=int),
         A("-o", "--out", default=None), *ocfg_args)
    tool("hpc-plan", cmd_hpc_plan, A("db"))
    tool("overlap-all", cmd_overlap_all, A("db"),
         A("-m", "--mask", action="append", default=[]),
         A("--nhosts", type=int, default=1),
         A("--host", type=int, default=-1,
           help="host index; -1 = from launcher env (init_multihost)"),
         *ocfg_args)

    tool("lasort", cmd_lasort, A("las", nargs="+"))
    tool("lamerge", cmd_lamerge, A("out"), A("inputs", nargs="+"))
    tool("lacat", cmd_lacat, A("out"), A("inputs", nargs="+"))
    tool("lashow", cmd_lashow, A("las"),
         A("--limit", type=int, default=30),
         A("-a", "--align", action="store_true"),
         A("--db", default=None))
    tool("lacheck", cmd_lacheck, A("db"), A("las", nargs="+"),
         A("--limit", type=int, default=10))
    tool("lasplit", cmd_lasplit, A("db"), A("las"))

    tool("datander", cmd_datander, A("db"),
         A("-b", "--block", type=int, default=0),
         A("--max-period", type=int, default=2000), *ocfg_args)
    tool("repmask", cmd_repmask, A("db"), A("las"),
         A("-c", "--cov", type=int, default=0),
         A("--low", type=float, default=1.5),
         A("--high", type=float, default=2.0))
    tool("tkmerge", cmd_tkmerge, A("db"), A("track"))
    tool("tkcombine", cmd_tkcombine, A("db"), A("out"),
         A("tracks", nargs="+"),
         A("--mode", choices=["union", "intersect"], default="union"))
    tool("tkshow", cmd_tkshow, A("db"), A("track"),
         A("reads", type=int, nargs="+"))

    tool("lastitch", cmd_lastitch, A("db"), A("las"),
         A("-b", "--block", type=int, default=1),
         A("-f", "--fuzz", type=int, default=100),
         A("-o", "--out", default=None), *ocfg_args)
    tool("laq", cmd_laq, A("db"), A("las"))
    tool("lafix", cmd_lafix, A("db"), A("las"), A("out"))
    tool("lagap", cmd_lagap, A("db"), A("las"))
    tool("lafilter", cmd_lafilter, A("db"), A("las"),
         A("-o", "--out", default=None),
         A("-p", "--purge", action="store_true"),
         A("--repeat-track", default="repeats"))

    tool("ogbuild", cmd_ogbuild, A("db"), A("las"), A("out"),
         A("--fuzz", type=int, default=40),
         A("--min-dovetail", type=int, default=1000))
    tool("oglayout", cmd_oglayout, A("db"), A("las"), A("out"),
         A("--svg", default=None),
         A("--fuzz", type=int, default=40),
         A("--min-dovetail", type=int, default=1000))
    tool("ogtour", cmd_ogtour, A("db"), A("las"), A("out"),
         A("--fuzz", type=int, default=40),
         A("--min-dovetail", type=int, default=1000),
         A("--spur-len", type=int, default=3, dest="spur_len"),
         A("--bubble-max", type=int, default=8, dest="bubble_max"))
    tool("tour2fasta", cmd_tour2fasta, A("db"), A("tours"), A("out"))
    tool("ctanalyze", cmd_ctanalyze, A("db"), A("las"),
         A("--fuzz", type=int, default=40),
         A("--min-dovetail", type=int, default=1000),
         A("--genome-size", type=int, default=0, dest="genome_size"))
    tool("pipeline", cmd_pipeline, A("fasta"), A("workdir"),
         A("-s", "--block-size", type=int, default=200,
           dest="block_size"),
         A("-x", "--cutoff", type=int, default=500),
         A("--no-polish", action="store_true"))
    tool("assemble", cmd_assemble, A("db"), A("las"), A("out"),
         A("--fuzz", type=int, default=40),
         A("--min-dovetail", type=int, default=1000),
         A("--polish", action="store_true"))
    return p


def _device() -> str:
    """The kernels' device from DAMAR_PLATFORM: unset or "cuda" the card
    (an error without one: there is no silent CPU path), "cpu" the plain
    versions; any other value is an error."""
    plat = os.environ.get("DAMAR_PLATFORM") or "cuda"
    if plat == "cpu":
        return "cpu"
    if plat != "cuda":
        raise ValueError(f"DAMAR_PLATFORM={plat!r}: expected cuda or cpu")
    import torch
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device (torch.cuda.is_available() is "
                         "False); set DAMAR_PLATFORM=cpu for the CPU path")
    return "cuda"


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        args.device = _device()
        args.fn(args)
    except (FileNotFoundError, ValueError) as e:
        print(f"{PROG} {args.tool}: error: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
