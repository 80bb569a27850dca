#!/usr/bin/env python3
"""Smoke run of damar_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout
    python3 chip_smoke.py --passes 5 --profile out/profile.txt

Phases (any failure exits non-zero before the last line is printed):
  1. require a CUDA device and print the card's name and power limit;
  2. build the CUDA kernels from damar_tpu_torch/csrc (nvcc, sm_90a, one
     process per source), print ptxas's registers and spills, and count
     each kernel's instructions per DP row in its built code (see
     `sass_ops_per_row`);
  3. hold every kernel against its plain torch version on fuzz batches
     on the card (exact equality: integer outputs), among them one K1
     launch of units from 1 to ~20,000 rows, odd unit counts, windows
     past both pool edges, K2 starts off word boundaries and a bucket at
     its segment cap, the wide trace (K3) on extents of 1 to ~20,000
     rows with drifting commits, the d >= INF_I commit, alim = 0 rows
     and an overflowing max_segs, K3's chunk form in both modes, and the
     pile aligner (K4) on ragged batches of ~1,000 pairs (templates of
     0-1,300 codes, bands 64, 96 and 700, covers with margins, shorter
     ones with n - m negative and odd, unrelated and empty ones, both
     modes), on each of its classes alone (narrow pairs a warp each;
     wide pairs on 2 to 6 warps, codes in shared memory; the widest band
     with codes in global scratch) and on a polish window's mixed
     launch; the reverse-complement twin's kernel (revcomp_kernel)
     against revcomp_plain on random blocks (reads of 1-900 bases,
     1-base reads among them, padding past nbases, a last read ending at
     cap, an empty block), each aligned and at an odd offset;
  4. run the main path, overlap_block_pair on the large-50Mbp unit (2.5
     Mbp genome, 20x, mean 6 kb, 14% error, seeds 2024/2025, one block
     self-compared): a cold pass, which also builds what the block
     caches keep (uploads, the A-side index, the reverse-complement
     twin, the trace pool), then --passes warm passes that reuse them,
     each with every launch counter reset just before it; check_las
     must be clean.  Before each warm pass the twin's device bases are
     dropped, as a B block met anew has none (the pair cell's every
     pair), so each pass makes them on the card: one revcomp_kernel
     launch a pass, checked.  Then one more warm pass under torch.profiler, with
     a spy that keeps every kernel launch's arguments and outputs: the
     profiler gives each kernel's device time, the work the launches did
     gives its bound (see `bound`); --profile PATH writes that pass's
     tables to PATH;
  5. hold each main-path kernel against its plain version on the
     arguments of its first main-path launch (capped at CAP work items),
     and time both: the kernel by its device time under the profiler,
     the plain version with CUDA events; revcomp_kernel's launch of the
     profiled pass byte for byte against revcomp_plain on the same device
     inputs at the block's whole cap, and again alone, timed, its bound
     its bytes (6 a real base, 2 a padding position); hold every other
     wide_trace_kernel launch of the pass (each segment bucket, capped
     at CAP extents) against trace_wave_plain too; K3's chunk form
     (dp_rows_kernel) the same way on its first launch of the wide route
     (phase 6, which runs before this one) and, in trace mode, on fuzz
     shapes; then run the profiled pass's wide retries again
     through the earlier route (trace_wave_steps: one dp_rows_kernel
     launch per segment step) and through wide_trace_kernel, hold both
     against the plain outputs, and print each route's device time,
     launches and wall;
  6. the wide route: one self pair with dp_kernel="wide" at the quick
     size (500 kbp genome at 20x, ~10 Mbp of reads; smaller than the
     main unit because this route steps every unit 128 int32 lanes a row
     through a host loop, one dp_rows_kernel launch per 128 rows): a
     cold pass, a counted warm pass (dp_rows_kernel and
     wide_trace_kernel must both launch; check_las clean), then a
     profiled pass whose every dp_rows_kernel launch is counted for the
     bound and whose sampled launches are held against dp_rows_plain,
     and whose every wide_trace_kernel launch (the main trace here, all
     extents; capped at CAP) is held against trace_wave_plain;
     a small self pair with dp_kernel="wide" on the card must give the
     CPU path's .las columns;
  7. a small self pair and a distinct pair (emit_mirrors on) on the card
     must give the same .las columns as the CPU path (the plain versions,
     which the CPU tests hold byte-equal to damar_tpu);
  8. the block sweep at full width: a 10 Mbp genome at 20x (~200 Mbp of
     reads, the main unit's parameters scaled 4x) written as FASTA, made
     into a DB and split into 4 blocks of ~50 Mbp; run_overlap_plan
     over its 10 pairs on the card (pipelined pairs, size hints, the
     resident-block LRU, prefetch, the manifest, per-block merges), then
     a plain loop of overlap_block_pair over A-block 1's row of the same
     blocks (plain_sweep over PLAIN_ROWS: the self pair, three distinct
     pairs and merged file S.1.las): each of its files must be
     byte-equal to the sweep's (--sweep-rounds N runs both forms, the
     plain loop over every row, N times in turns, sweep, plain, plain,
     sweep, ..., every run byte-equal to the first, and prints the
     walls' medians: host-clock walls on a shared host spread by tens
     of percent, so only turns within one call compare the forms);
     check_las clean and sorted on every merged file; every record must
     have its mirror; a second run_overlap_plan must find every job
     done.  Walls, Gbp-aligned/s, per-pair phase times and peak memory
     are printed for both.  Then two pairs again as host 0 of 5 with
     DAMAR_RESIDENT_BLOCKS=1, so that blocks' device
     buffers are released while the pair before is still in its emit on
     the worker's stream: the same bytes.  Then one distinct pair (B !=
     A, mirrors on) with every launch kept: its files must be the plain
     loop's, and its first launches of K1, K2 and K3 (PAIR_HELD; capped
     at CAP items) and both of its twins' revcomp_kernel launches
     (whole) must equal their plain versions, so the sweep is held
     against the plain versions at its own shapes and not only against
     itself;
  9. the stages from a DB on disk (damar_tpu/pipeline/run.py's phases
     2-6, composed here as run.py composes them; run_stages): the main
     unit's reads with 20 repeat copies and 20 tandems planted, written
     as FASTA, made into a DB and split with cutoff 500 into 2 blocks of
     ~25 Mbp; with MaskConfig(), ScrubConfig(), OverlapConfig() and the
     sweep's caps: the dust track, the tan track per block (the datander
     search and K1), overlap1 with both masks, the patch round (per
     block LAstitch, the retrace of the needed rows on K3 against a
     subset block of their B reads, LAq, LAfix; FIX.fasta -> FIX DB),
     overlap2, and the scrub round (merge, sort, LAstitch, retrace, LAq,
     LAgap, q/trim tracks, clip to trim, LArepeat, LAfilter).  Prints
     each stage's wall and counts (dust and tan bp, the tandem search's
     hits and seeds, retrace needs and drops, fixed reads and bp,
     scrubbed, filtered and kept records) and the launches of the
     phase; check_las clean on every .las it writes, every track
     interval in its read and sorted; prints the filtered file's kept
     records whose mirror is discarded; holds block 1's first K1 launch
     of the tandem search and the scrub retrace's first two
     wide_trace_kernel launches (capped at CAP items) against their
     plain versions; runs the tandem search again under damar_tpu's
     buffer caps and prints what they drop (fault 3g); and runs the
     stages on a small DB of short reads on the card and on the CPU
     path: every .las, track file and FIX.fasta byte-equal;
 10. the assembly (run.py's phase 7, and run_pipeline whole):
     a. run_pipeline(polish=False) on phase 9's workdir, which holds
        run.py's own files, so it resumes at phase 7: the string graph
        (vertices, edges, the edges whose mirror record was discarded,
        fault 3i, and those left without a twin), the tour, contigs and
        N50, the phase's wall; a contig, and contigs summing to >= 85%
        of the genome;
     b. run_pipeline(polish=True) from FASTA: a 300 kbp genome at 20x
        (mean read 6 kb, 14% error, repeats, two tandem arrays, 6%
        chimeric reads), split into 2 blocks, every other setting the
        default: each phase's wall, the assemble wall split into
        correct_reads, the polish rounds and the finishing rounds (host
        timers around the port's functions), K4's launches, device time
        (CUDA events around each launch), bound, and per class (narrow,
        wide) its pairs, DP cells and blocks; its first launch (capped at
        CAP pairs) held against band_align_plain and timed under
        torch.profiler, and its first launch with wide pairs held against
        band_align_plain; contigs summing
        to >= 85% of the genome and the longest one's k-mer hit rate
        > 0.45;
     c. run_pipeline(polish=True) on the 12 kbp genome of the CPU tests,
        on the card and on the CPU path: CONTIGS.fasta, every .las, track
        and FIX.fasta byte-equal, report.json equal but for its walls;
 11. the pipeline's default block (PipelineConfig.block_mb = 200 Mbp),
     the legacy payload path and -b, every default (no caps):
     a. the sweep unit's reads (its genome from the same seed with 80
        tandem arrays planted) split at 200 Mbp into 2 blocks; the dust
        track, and the tan track of each block: block 1's datander
        search (split into ranges of reads above 2^27 hits) with its
        hits, seeds, peak memory and wall, its first K1 launch held
        against its plain version;
     b. run.py's overlap1 there: run_overlap_plan over the 3 pairs with
        both masks; the 200 Mbp self pair must be seeded by slices:
        each pair's path, slices, hits, seeds, phase times, the plan's
        wall, Gbp-aligned/s and peak memory; check_las clean and sorted,
        every record with its mirror, a second run skipping every pair,
        the self pair's first PAIR_HELD launches equal to their plain
        versions;
     c. (the unsliced rerun of that pair's seeding was cut from the
        smoke's depth; tests/test_torch_seed_sliced.py holds sliced ==
        unsliced, damar_tpu_torch/tools/seed_peaks.py times both);
     d, e. large-50Mbp cold, then warm with OverlapConfig(bias=True),
        then a self pair of its reads and 8 reads of 150 kbp (a payload
        of 33 bits: the legacy path); check_las clean, counts side by
        side, the first K1, K2 and K3 launches of the -b and the legacy
        pass equal to their plain versions;
     f. small pairs of phase 7's reads over a 30 kbp genome with the
        sliced path forced and with the legacy path forced, and of reads
        over an AT-rich genome with -b: card == CPU path;
 12. the command-line toolbox (damar_tpu_torch.cli.main in this process,
     DAMAR_PLATFORM unset: the card):
     a. after 10a, on a copy of phase 9's DB: dbstats, hpc-plan, dbdust,
        datander, overlap-all -m dust -m tan, lacheck on every merged
        file, lashow --limit 50, lashow -a --limit 20 (every segment in
        one K4 launch), lastitch -b 1, laq, lagap, lafilter; then
        ogbuild, ogtour, tour2fasta and assemble on phase 9's FIX DB and
        filtered file: the tracks and every pair's and merged .las file
        byte-equal to phase 9's (the same settings; phase 9's explicit
        caps change no byte), lacheck clean, tour2fasta's contigs
        assemble's; each tool's wall and the launches, the first K1, K2
        and K3 launches and lashow -a's K4 launch held against their
        plain versions (capped at CAP items);
     b. after 10b, on its DB and filtered file: assemble --polish, K4's
        launches and device time, its first launch held against its
        plain version (capped at CAP items), the longest polished
        contig's k-mer hit rate against the genome above 10b's gate;
     c. after 10c: the pipeline tool on the 12 kbp genome, CONTIGS.fasta
        byte-equal to phase 10c's run_pipeline on the card;
     d. a rendered hpc-plan daligner line run as-is by a shell in a
        directory holding a copy of phase 10c's DB, as fresh processes:
        with DAMAR_PLATFORM unset it writes the in-process daligner's
        file, with no card visible it exits non-zero naming the missing
        card, with DAMAR_PLATFORM=cpu it writes the same bytes;
 13. the ring sweep (damar_tpu_torch.parallel.distributed):
     a. after phase 8, on its DB (4 blocks of ~50 Mbp at one common
        cap): distributed_overlap_las as a ring of one rank on the card,
        16 one-rotation sweeps; every shard check_las clean and sorted,
        for i < j shard i's records of B-block j byte-equal to
        overlap_block_pair's A side with mirrors off and holding the
        sweep's pair file S.i.S.j.las (mirrors on, so a record whose mirror
        failed its trace is not there), the ring's first K1, K2 and K3 launches
        (capped at CAP items) equal to their plain versions; the wall of
        each program (overlap ring, dedupe, trace ring, checks with wide
        retries and emit), Gbp-aligned/s/gpu, records, retries, peak
        memory and the ring's launches;
     b. then 4 ranks spawned over gloo, each on the card with the blocks
        staged through host memory, on tests/test_parallel.py's 12-block
        spread DB (3 x 3 super-sweeps): every shard byte-equal to a ring
        of one rank on the card and to the CPU run; two ranks asked for
        NCCL on the one card must refuse;
     c. the ring's options (port fault 4), on two blocks of AT-rich reads
        with tests/test_overlap.py's tandem-bearing reads in the first
        (on a uniform genome -b's weights are all 256 and change no seed,
        and reads without tandems have no self records): a ring of one
        rank on the card with bias=True, and again with identity=True,
        each byte-equal to the same ring on the CPU and unlike the ring
        without the option; -b's part (0, 1) byte-equal to the pair
        driver's A side (mirrors off, bias=True), -I's read-vs-itself
        records those of the pair driver's self pair (identity=True);
        dp_kernel="wide" raises before the ring starts;
 14. the bench twin: `python -m damar_tpu_torch.tools.bench --quick` as a
     child process (BENCH_TIMEOUT), from this checkout; it must exit 0 and
     its last line must parse with provenance "measured-on-gpu", the
     card's name and count, config quick-10Mbp, a value above 0 and the
     main path's kernels launched in its timed pass; its value is printed;
then print one JSON line of per-kernel results (`stage_launches`: each
kernel's launches in phase 9, `assembly_launches` in phase 10b,
`default_block_launches` per path of phase 11, `cli_launches` over
phase 12's in-process tools, `ring_launches` in 13a,
`ring_option_launches` in 13c's ring with bias=True, `bench_launches` in
a timed pass of phase 14's bench; K4's row holds phase 10b's launches
and device time) and, last, the device line.
"""
import argparse
import contextlib
import filecmp
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from damar_tpu_torch.core.blocks import block_from_db, block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats import dazzdb
from damar_tpu_torch.formats import las as lasmod
from damar_tpu_torch.formats.las import check_las
from damar_tpu_torch.ops import (_cuda, band_align, revcomp, wave_bp,
                                 wave_wide)
from damar_tpu_torch.ops.words import pack_bases
from damar_tpu_torch.parallel import distributed as ring
from damar_tpu_torch.parallel.distributed import block_pair_matrix
from damar_tpu_torch.pipeline import overlap as ov
from damar_tpu_torch.pipeline.planner import run_overlap_plan
from damar_tpu_torch.utils.sim import (align_pairs_batch, band_batch,
                                       edge_units, make_genome, mutate,
                                       polish_window_pairs, sample_reads,
                                       unit_batch, wide_trace_batch,
                                       write_sim_fasta)

GENOME, COVERAGE, MEAN_LEN, ERR, SEED = 2_500_000, 20.0, 6_000, 0.14, 2024
HIT_CAP, SEED_CAP = 1 << 27, 1 << 21
CAP = 16_384          # work items of a first launch held against plain
# the sweep's pass with one resident block runs host 0's pairs of this many
EVICT_HOSTS = 5
# the plain loop's A-block rows (one run, --sweep-rounds 1): row 1 is the
# self pair, three distinct pairs and merged file S.1.las; --sweep-rounds
# N > 1 runs every row, so the walls in turns compare whole sweeps
PLAIN_ROWS = (1,)
# the wide route's unit: the quick size of the reference's bench
GENOME_QUICK, QUICK_HIT_CAP, QUICK_SEED_CAP = 500_000, 1 << 25, 1 << 19
# the sweep's unit: the main unit's genome scaled 4x, split into 4 blocks
GENOME_SWEEP, SWEEP_BLOCKS = 10_000_000, 4
# the stages' unit: the main unit's reads with repeats and tandems
# planted, split into 2 blocks; the launches of its spied calls held
# against the plain versions (the datander search's first K1 launch, the
# scrub retrace's first two wide trace launches)
STAGE_REPEATS, STAGE_TANDEMS, STAGE_BLOCKS = 20, 20, 2
STAGE_HELD = {"tan": ("bp_extend_kernel", 1),
              "scrub_retrace": ("wide_trace_kernel", 2)}
# the whole assembly's unit (phase 10b): a 300 kbp genome at the main
# unit's coverage, read length and error, with repeats, two tandem arrays
# and chimeric reads planted as tests/test_hard_assembly.py plants them,
# split into 2 blocks; the genome is cut from the 2 Mbp of the reference's
# polish measurement by this script's time limit
ASM_GENOME, ASM_SEED, ASM_REPEATS, ASM_TANDEMS = 300_000, 4040, 5, 2

# Bounds: the least time the card could take for a launch's work, the
# larger of its int32 operations over the INT32 rate and its bytes (each
# input read once, each output written once) over the HBM rate (3.35
# TB/s, H100 SXM data sheet).  The INT32 rate is the card's issue rate
# of integer lane-ops, 132 SMs x 4 schedulers x 32 lanes x 1.98
# GHz boost = 33.5 T/s (the Hopper white paper's INT32 peak).  The 64
# lanes of an SM's INT32 pipes alone (16.7 T/s, this file's rate until
# the wide route ran) are no ceiling: the compiler moves integer adds
# and moves onto the FMA pipes (IMAD), and dp_rows_kernel's first
# wide-route launch ran 22.9 T lane-ops/s by its SASS count.
# Operations per DP row (K3: per lane-row): the
# smaller of the built kernel's count (`sass_ops_per_row`) and an
# estimate of what a row needs with sm_90's three-input instructions
# (LOP3, IADD3, funnel shifts): ~60 for K1, ~50 for K2.  K3's warp row
# (csrc/dp_rows.cu, four lanes a thread) needs per lane ~12 (validity 3,
# sub 2, u 3, scan 2, write-back 2) and per thread ~20 more (the chars 5,
# the neighbour and the 5-step shuffle scan 15), so (4 x 12 + 20) / 4 =
# 17 per lane-row; the chunk form adds a char load a lane (~18), and
# with track_best the score and its four trackers (~9 more).  Chunk
# tails and commits are left out.
INT32_OPS_PER_S = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
OPS_ESTIMATE = {"bp_extend_kernel": 60, "bp_trace_kernel": 50,
                "wide_trace_kernel": 17, "dp_rows_kernel": 18}
TRACK_OPS = 9
# global loads per thread and DP row in a kernel's row loop: K1, K2 and
# the wide trace load one word of A and one of B per 16 rows; the chunk
# form one char of A and one of B for each of a thread's 4 lanes
LOADS_PER_ROW = {"bp_extend_kernel": 1 / 8, "bp_trace_kernel": 1 / 8,
                 "wide_trace_kernel": 1 / 8, "dp_rows_kernel": 5}
# band lanes a thread holds (K3), so SASS per thread-row / lanes = per
# lane-row
LANES = {"wide_trace_kernel": 4, "dp_rows_kernel": 4}
# the kernels each driven path must launch: the large-50Mbp pair and the
# sweep run the bit-parallel route, the wide route K3 in both forms
MAIN_PATH = ("bp_extend_kernel", "bp_trace_kernel", "wide_trace_kernel")
# the reverse-complement twin's kernel: every overlap path makes its
# twins with it on the card; the large-50Mbp pair and the sweep must
# launch it, the pair's once a warm pass
RC = "revcomp_kernel"
# the launches of the sweep's spied pair that are held against the plain
# versions: K1's forward extension in both phases and its
# reverse-complement one in the first, K2's and K3's first two segment
# buckets (every bucket mixes both orientations and the mirrored roles).
# The plain versions step through every row of a launch's longest item
# in Python: a second-phase K1 launch took 36 s, the later buckets 12-34
# s each, all 14 launches 211 s on an H100
PAIR_HELD = {"bp_extend_kernel": 3, "bp_trace_kernel": 2,
             "wide_trace_kernel": 2, RC: 2}
WIDE_PATH = ("dp_rows_kernel", "wide_trace_kernel")
# the TPU kernels' ports (K1-K3); K4, the pile aligner, is the port of
# damar_tpu's host C band_align and runs on the assembly's path (phase 10)
TPU_KERNELS = ("bp_extend_kernel", "bp_trace_kernel", "wide_trace_kernel",
               "dp_rows_kernel")
K4 = "band_align_kernel"
# K4's int32 operations per DP cell, estimated from csrc/band_align.cu:
# the char load and compare 4, the three candidates and their minimum 6,
# the prefix minimum and its clamps 5, the three traceback tests and the
# 2-bit code 10, loop and address work ~5; the SASS count (per cell of
# the row loop) is taken where it is smaller
K4_OPS_PER_CELL = 30
# DP cells a thread holds in K4's row loop (csrc/band_align.cu C)
K4_CELLS = 8
# K4's classes in the fuzz phase, (bands, longest template): narrow pairs
# (bands <= 127, a warp each); wide pairs on 2, 3, 4, 5 and 6 warps with
# widths on both sides of each warp edge, templates short enough that
# their 2-bit codes sit in shared memory; the widest band with templates
# whose codes go to global scratch (the staged walk)
K4_FUZZ = (((64, 96, 127), 1300), ((128, 255), 500), ((256, 383), 500),
           ((384, 500), 500), ((600, 639), 500), ((640, 696, 767), 500),
           ((767,), 1300))

# kernel name -> (wrapper whose `launches` counts it, module, launch fn,
# plain torch version with the same contract, source, replaced TPU kernel)
KERNELS = {
    "bp_extend_kernel": (wave_bp.extend_wave_bp, wave_bp,
                         "extend_bp_kernel", wave_bp.extend_bp_plain,
                         "damar_tpu_torch/csrc/wave_bp.cu",
                         "damar_tpu/ops/wave_bp_pallas.py:228"),
    "bp_trace_kernel": (wave_bp.trace_wave_bp, wave_bp, "trace_bp_kernel",
                        wave_bp.trace_bp_plain,
                        "damar_tpu_torch/csrc/wave_bp.cu",
                        "damar_tpu/ops/wave_bp_pallas.py:420"),
    "wide_trace_kernel": (wave_wide.trace_wave, wave_wide,
                          "trace_wide_kernel", wave_wide.trace_wave_plain,
                          "damar_tpu_torch/csrc/dp_rows.cu",
                          "damar_tpu/ops/wave_pallas.py:43 (as trace_wave_pl"
                          " :411 drives it)"),
    "dp_rows_kernel": (wave_wide.dp_rows, wave_wide, "dp_rows_kernel",
                       wave_wide.dp_rows_plain,
                       "damar_tpu_torch/csrc/dp_rows.cu",
                       "damar_tpu/ops/wave_pallas.py:43"),
    K4: (band_align.band_align, band_align, "band_align_kernel",
         band_align.band_align_plain, "damar_tpu_torch/csrc/band_align.cu",
         "damar_tpu/native/damar_native.c:218 band_align, :322 "
         "band_align_batch (port of damar_tpu/native band_align, not a TPU "
         "kernel)"),
    RC: (revcomp.revcomp_bases, revcomp, "revcomp_kernel",
         revcomp.revcomp_plain, "damar_tpu_torch/csrc/revcomp.cu",
         "none: damar_tpu makes this twin on the host "
         "(damar_tpu/core/blocks.py:115 revcomp_block)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a, b) -> int:
    """Largest |kernel - plain| over all outputs (a tuple, or one
    tensor); raises on a shape or dtype mismatch."""
    if torch.is_tensor(a):
        a, b = (a,), (b,)
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != "
                                 f"{tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.to(torch.int64)
                                - y.to(torch.int64)).abs().max()))
    return err


def fuzz_checks(dev) -> dict:
    """Phase 3: each kernel vs its plain version on fuzz batches."""
    errs = {k: 0 for k in KERNELS}
    rng = np.random.default_rng(7)
    T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731

    def ext(batch, max_rows, rv=None):
        A, B, ao, bo, alim, blim, rev = batch
        args = (pack_bases(T(A)), pack_bases(T(B)), T(ao), T(bo), T(alim),
                T(blim), T(rev) if rv is None else rv, 128, max_rows, 5, 60)
        e = max_abs_err(wave_bp.extend_bp_kernel(*args),
                        wave_bp.extend_bp_plain(*args))
        errs["bp_extend_kernel"] = max(errs["bp_extend_kernel"], e)

    batch = unit_batch(rng, 3000)
    for max_rows in (65536, 128):
        for dirs in ("mixed", "fwd", "rev"):
            ext(batch, max_rows, rv=None if dirs == "mixed" else torch.full(
                (3000,), dirs == "rev", dtype=torch.bool, device=dev))
    # one launch of units from 1 to ~20,000 rows
    ext(unit_batch(rng, 700, min_len=1, max_len=20_000), 65536)
    for S in (1, 33, 1031):
        ext(unit_batch(rng, S), 65536)
    ext(edge_units(rng, 64), 65536)

    def trace(S, tspace, max_segs, offsets, **kw):
        A, B, ao, bo, alim, blim, _ = unit_batch(rng, S, **kw)
        ta = np.minimum(alim, len(A) - ao).astype(np.int32)
        tb = np.minimum(blim, len(B) - bo).astype(np.int32)
        abp, bbp = ao, bo
        if offsets:     # starts and offsets off word boundaries
            abp = np.minimum(rng.integers(1, 90, S), ao).astype(np.int32)
            bbp = np.minimum(rng.integers(1, 90, S), bo).astype(np.int32)
        args = (pack_bases(T(A)), pack_bases(T(B)), T(ao - abp),
                T(bo - bbp), T(abp), T(bbp), T(ta), T(tb), tspace, max_segs)
        e = max_abs_err(wave_bp.trace_bp_kernel(*args),
                        wave_bp.trace_bp_plain(*args))
        errs["bp_trace_kernel"] = max(errs["bp_trace_kernel"], e)

    for tspace, max_segs in ((100, 32), (126, 24)):
        trace(3000, tspace, max_segs, False)
    for tspace, max_segs, S in ((100, 64, 517), (126, 48, 33),
                                (250, 24, 1), (100, 6, 400)):
        trace(S, tspace, max_segs, True, max_len=6000)

    for tspace, max_segs, S, max_len in (
            (100, 64, 1, 2500), (126, 48, 33, 2500), (100, 64, 1031, 2500),
            (126, 256, 300, 20_000), (100, 6, 400, 6000)):
        A, B, *vecs = wide_trace_batch(rng, S, max_len=max_len)
        args = (pack_bases(T(A)), pack_bases(T(B)), *map(T, vecs), tspace,
                max_segs)
        e = max_abs_err(wave_wide.trace_wide_kernel(*args),
                        wave_wide.trace_wave_plain(*args))
        errs["wide_trace_kernel"] = max(errs["wide_trace_kernel"], e)

    for track, recenter in ((False, False), (True, True)):
        args, kw = dp_rows_batch(rng, 4000, track, recenter)
        e = max_abs_err(wave_wide.dp_rows_kernel(*args, **kw),
                        wave_wide.dp_rows_plain(*args, **kw))
        errs["dp_rows_kernel"] = max(errs["dp_rows_kernel"], e)

    # K4: a ragged batch of ~1,000 pairs, templates of 0-1,300 codes,
    # bands 64, 96 and 700 mixed, covers with margins, shorter (n - m
    # negative, odd among them), unrelated and empty; global mode; then
    # each class alone (K4_FUZZ: narrow; wide on 2 to 6 warps with the
    # codes in shared memory; the widest band with codes in global
    # scratch) in both modes, and a polish window's mixed launch
    # the process's first K4 launch: one wide pair (band 128, m = 500)
    # whose codes, 40,080 bytes, fit 48 KB but not 48 KB less the
    # kernel's static shared memory, so this launch itself must raise the
    # kernel's dynamic shared memory limit
    r128 = np.random.default_rng(128)
    tmpl = r128.integers(0, 4, 500).astype(np.uint8)
    args = band_align.pack_pairs([(tmpl, mutate(tmpl, 0.12, r128), 128)],
                                 dev)
    e = max_abs_err(band_align.band_align_kernel(*args, True),
                    band_align.band_align_plain(*args, True))
    errs[K4] = max(errs[K4], e)
    cases = [(True, (64, 96, 700), 1000, 1300),
             (False, (64, 96, 700), 300, 1300)]
    cases += [(semi, bands, 150, max_len) for bands, max_len in K4_FUZZ
              for semi in (True, False)]
    for semi, bands, P, max_len in cases:
        args = band_align.pack_pairs(
            align_pairs_batch(rng, P, bands=bands, semiglobal=semi,
                              max_len=max_len), dev)
        e = max_abs_err(band_align.band_align_kernel(*args, semi),
                        band_align.band_align_plain(*args, semi))
        errs[K4] = max(errs[K4], e)
    args = band_align.pack_pairs(polish_window_pairs(rng), dev)
    e = max_abs_err(band_align.band_align_kernel(*args, True),
                    band_align.band_align_plain(*args, True))
    errs[K4] = max(errs[K4], e)

    # the twin's kernel: reads of 1-900 bases (every 17th cut to 1),
    # padded to their bucket; a last read ending at cap; an empty block;
    # each also at an odd offset (the position-by-position form)
    reads = [rng.integers(0, 4, int(k), dtype=np.uint8)
             for k in rng.integers(1, 900, 3000)]
    for i in range(0, len(reads), 17):
        reads[i] = reads[i][:1]
    at_cap = reads[:41]
    for blk in (block_from_reads(reads),
                block_from_reads(at_cap, cap=sum(len(r) for r in at_cap)),
                block_from_reads([])):
        for offset in (0, 1):
            a = rc_args(blk, dev, offset)
            e = max_abs_err(revcomp.revcomp_kernel(*a),
                            revcomp.revcomp_plain(*a))
            errs[RC] = max(errs[RC], e)
    torch.cuda.synchronize()
    return errs


def rc_args(blk, dev, offset: int = 0) -> tuple:
    """A block's bases, read ids and starts on dev as revcomp_bases takes
    them, and its nbases; offset > 0 puts the bases and read ids that
    many elements into their allocations (off 16-byte alignment)."""
    out = []
    for x in (blk.bases, blk.read_id):
        t = torch.empty(len(x) + offset, dtype=torch.from_numpy(x).dtype,
                        device=dev)[offset:]
        t.copy_(torch.from_numpy(x))
        out.append(t)
    return (*out, torch.as_tensor(blk.starts.astype(np.int64), device=dev),
            blk.nbases)


def dp_rows_batch(rng, S: int, track: bool, recenter: bool,
                  R: int = 100):
    """Arguments of one dp_rows_kernel launch over S random bands on the
    card (utils.sim.band_batch)."""
    *vals, cont = (torch.as_tensor(x, device="cuda")
                   for x in band_batch(rng, S, track, R))
    return vals, dict(R=R, W=128, diff_cost=5, xdrop=60, track_best=track,
                      recenter=recenter, cont=cont)


INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def _row_loop(insns: list, labels: dict,
              most_loads: bool = False) -> tuple[int, int]:
    """(instructions, global loads) of the smallest loop that holds a
    global load: the row loop, whose body is straight-line code over
    one or more 16-row groups (K1/K2) or rows (K3).  most_loads: the
    loop with the most global loads instead (K4's row loop loads the
    template char and a thread's next cover char; its staged walk one
    16-byte word a lane)."""
    ends = {}
    for addr, text in insns:
        op = text.split()
        op = op[1] if op[0].startswith("@") else op[0]
        if op.startswith("BRA"):
            m = TARGET.search(text)
            if m is None:                      # no direct target
                continue
            tgt = labels[m.group(1)] if m.group(1) else int(m.group(2), 16)
            if tgt <= addr:                    # backward: a loop
                ends[tgt] = max(ends.get(tgt, addr), addr)
    best = None
    for lo, hi in ends.items():
        body = [t for a, t in insns if lo <= a <= hi
                and not t.split()[-1].startswith("NOP")]
        n_ld = sum(1 for t in body
                   if any(w.startswith("LDG") for w in t.split()[:2]))
        if not n_ld or best is None:
            better = bool(n_ld)
        elif most_loads:
            better = n_ld > best[1]
        else:
            better = len(body) < best[0]
        if better:
            best = (len(body), n_ld)
    if best is None:
        raise SystemExit("chip_smoke: no row loop found in the SASS")
    return best


def sass_ops_per_row(lib_path: Path) -> dict:
    """Per kernel function (mangled name): SASS instructions per DP row
    (K3: per lane-row) of its row loop, from `cuobjdump -sass`: the
    loop's instructions over the rows it covers (its global loads over
    LOADS_PER_ROW) and, for K3, over the lanes a thread holds."""
    exe = Path(_cuda._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(exe), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs, cur, pending = {}, None, []
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), ([], {}))
            continue
        if cur is None:
            continue
        lab = LABEL.match(ln)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = INSN.match(ln)
        if ins:
            addr = int(ins.group(1), 16)
            cur[0].append((addr, ins.group(2).strip()))
            for lb in pending:
                cur[1][lb] = addr
            pending = []
    out = {}
    for fn, (insns, labels) in funcs.items():
        kern = next((k for k in KERNELS if k in fn), None)
        if kern is None or kern == RC:      # no DP rows: bound by bytes
            continue
        if kern == K4:
            # the row loop: the template char and the thread's next cover
            # char, over its K4_CELLS cells
            n_insn, n_ld = _row_loop(insns, labels, most_loads=True)
            if n_ld >= 2:
                out[fn] = dict(kernel=kern, insns=n_insn, loads=n_ld,
                               rows=1, lanes=K4_CELLS,
                               per_row=n_insn / K4_CELLS)
            continue
        n_insn, n_ld = _row_loop(insns, labels)
        rows = n_ld / LOADS_PER_ROW[kern]
        lanes = LANES.get(kern, 1)
        out[fn] = dict(kernel=kern, insns=n_insn, loads=n_ld, rows=rows,
                       lanes=lanes, per_row=n_insn / rows / lanes)
    missing = set(TPU_KERNELS) - {v["kernel"] for v in out.values()}
    if missing:
        raise SystemExit(f"chip_smoke: no SASS for {sorted(missing)}")
    return out


def k4_ops_per_cell(sass: dict) -> float:
    """K4's operations per DP cell: the smaller of the estimate and the
    largest SASS count per cell of its row loop (8 cells a thread)."""
    counts = [v["per_row"] for v in sass.values() if v["kernel"] == K4]
    return min([K4_OPS_PER_CELL] + ([max(counts)] if counts else []))


def ops_per_row(name: str, kw, sass: dict) -> float:
    """Operations per DP row that the bound of this launch counts: the
    smaller of the SASS count of the function it runs and the
    estimate."""
    tag, est = name, OPS_ESTIMATE[name]
    if name == "dp_rows_kernel":            # the template instance
        tag += (f"ILb{int(kw.get('track_best', True))}"
                f"ELb{int(kw.get('recenter', False))}E")
        est += TRACK_OPS if kw.get("track_best", True) else 0
    counts = [v["per_row"] for fn, v in sass.items() if tag in fn]
    if len(counts) != 1:
        raise SystemExit(f"chip_smoke: {len(counts)} SASS functions "
                         f"match {tag}")
    return min(counts[0], est)


def work(name: str, a, kw, out, sass: dict,
         full_rows: int | None = None) -> tuple[int, float, int]:
    """(rows, int32 ops, bytes) of one launch.  K1: the rows its outputs
    prove were needed, sum(bva); given full_rows (the full depth), a
    launch to a smaller depth leaves out its active units, which a
    later full-depth launch re-runs from row 0 and counts, so each unit
    counts once per pass.  K2: sum(alim) of its extents; the wide trace
    128 lanes times sum(alim); the chunk form the rows of its live seeds
    times 128 lanes.  K4: the DP cells, (m+1) x (2 band + 1) a pair."""
    nb = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                        for t in ts if torch.is_tensor(t))
    if name == RC:
        # positions; bytes: a real base reads its read id (4) and its
        # source base (1) and writes 1, a padding position reads and
        # writes 1; the read starts once
        cap, n = a[0].shape[0], int(a[3])
        return cap, 0, 6 * n + 2 * (cap - n) + nb(a[2:3])
    if name == K4:
        # cells (m+1) x (2 band + 1) of each pair; bytes: the inputs, the
        # 2-bit codes and the ops each once
        m = (a[1][1:] - a[1][:-1]).to(torch.int64)
        cells = int(((m + 1) * (2 * a[4].to(torch.int64) + 1)).sum())
        return cells, cells * k4_ops_per_cell(sass), nb(a[:5]) + \
            cells // 4 + nb(out)
    if name == "bp_extend_kernel":
        bva = out[1].to(torch.int64)
        if full_rows is not None and a[8] < full_rows:
            bva = torch.where(out[3] != 0, 0, bva)
        rows = int(bva.sum())
        byts = nb(a[2:7]) + nb(out)
    elif name == "bp_trace_kernel":
        rows = int(a[6].to(torch.int64).sum())
        byts = nb(a[2:8]) + nb(out[1:]) + 8 * int(out[1].sum())
    elif name == "wide_trace_kernel":
        alim = a[6].to(torch.int64).clamp(min=0)
        rows = 128 * int(alim.sum())
        segs = int(out[1].to(torch.int64).clamp(max=a[9]).sum())
        byts = (nb(a[2:8]) + nb(out[1:]) + 8 * segs
                + int(alim.sum()) // 2)                 # 2-bit chars
    else:
        R = kw["R"]
        live = (a[7] != 0) & (a[6] > 0)
        rows = 128 * int(torch.where(live, a[6].clamp(max=R), 0).sum())
        byts = nb(a[:12]) + nb(out)
    if name in ("bp_extend_kernel", "bp_trace_kernel"):
        byts += rows // 2                                # 2-bit chars
    return rows, rows * ops_per_row(name, kw, sass), byts


def bound(ops: int, byts: int) -> tuple[float, str]:
    """(least ms, what bounds it) for the given work."""
    t_ops, t_bytes = ops / INT32_OPS_PER_S, byts / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# torch.profiler (torch 2.11 on the H100 machines) loses the first
# device records of a profile, by count: about one more for every 20 s
# since the process's first profile, whatever idle time comes before
# them (damar_tpu_torch/tools/profile_window.py).  So every profile here
# opens with LEAD_RECORDS one-element negations, which take the loss and
# which no count or time below includes.
LEAD_RECORDS, LEAD_KEY = 256, "neg_kernel"

# how often a profile that lost launch records is taken again before the
# run gives up (two in a row were lost late in a run that passed)
PROFILE_TRIES = 6

# every time a profile still held fewer launch records of a kernel than
# its wrapper counted (the profile is then taken again); printed in the
# kernels line, so a recurrence shows in every run's output
LOST_LAUNCHES: list = []


def lead_records() -> None:
    """The records a profile opens with (see LEAD_RECORDS)."""
    x = torch.empty(1, device="cuda")
    for _ in range(LEAD_RECORDS):
        x.neg_()
    torch.cuda.synchronize()


def device_events(prof) -> list:
    """The profile's device-side events (kernels, copies), the lead
    records left out; a host op's device time repeats that of the
    kernels it launched, so host ops are left out too."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and LEAD_KEY not in e.key]


class LostLaunches(Exception):
    """The profiler's records miss launches that ran."""


def lost_launches(where: str, counted: dict, profiled: dict) -> list:
    """The kernels whose profiled launch count differs from the count
    of their wrappers; each is logged and kept in LOST_LAUNCHES."""
    bad = [dict(where=where, kernel=k, counted=counted[k],
                profiled=profiled[k])
           for k in counted if counted[k] != profiled[k]]
    for b in bad:
        log(f"profiler lost launches: {b}")
    LOST_LAUNCHES.extend(bad)
    return bad


class Spy:
    """While the main path runs: keeps the arguments and outputs of
    each kernel launch function's calls that launched (its wrapper's
    count moved; a call with no work launches nothing), or with `keep`
    (kernel name -> n) only the first n of each kernel's.  The launches
    go through unchanged."""

    def __init__(self, keep: dict | None = None):
        self.calls = {k: [] for k in KERNELS}
        self.orig = {}
        self.keep = keep

    def __enter__(self):
        for name, (wrapper, mod, attr, *_rest) in KERNELS.items():
            fn = getattr(mod, attr)
            self.orig[name] = (mod, attr, fn)

            def spy(*a, _fn=fn, _name=name, _w=wrapper, **kw):
                n0 = _w.launches
                out = _fn(*a, **kw)
                if _w.launches != n0 and (
                        self.keep is None or len(self.calls[_name])
                        < self.keep.get(_name, 0)):
                    self.calls[_name].append((a, kw, out))
                return out
            setattr(mod, attr, spy)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.orig.values():
            setattr(mod, attr, fn)
        return False

    def summary(self, prof, sass: dict, full_rows: int) -> dict:
        """Per kernel: launches, device ms (from the profile `prof` of
        the spied pass), rows, bound ms and its kind, summed over the
        pass."""
        dev_ms, dev_n = device_ms(prof)
        if lost_launches("profiled pass",
                         {k: len(c) for k, c in self.calls.items()}, dev_n):
            raise LostLaunches
        out = {}
        for name, calls in self.calls.items():
            rows = ops = byts = 0
            for a, kw, res in calls:
                r, o, b = work(name, a, kw, res, sass, full_rows)
                rows, ops, byts = rows + r, ops + o, byts + b
            bms, by = bound(ops, byts)
            out[name] = dict(launches=len(calls), pass_ms=dev_ms[name],
                             rows=rows, pass_bound_ms=bms, bound_by=by)
        return out


def device_ms(prof) -> tuple[dict, dict]:
    """Per kernel: its self device time (ms) and launch count in the
    profile `prof`."""
    ms, n = {k: 0.0 for k in KERNELS}, {k: 0 for k in KERNELS}
    for e in device_events(prof):
        for k in KERNELS:
            if k in e.key:
                ms[k] += e.self_device_time_total / 1e3
                n[k] += e.count
    return ms, n


def kernel_ms(name: str, fn, reps: int,
              tries: int = PROFILE_TRIES) -> float:
    """Device time of one launch of kernel `name` by fn(), the mean of
    `reps` launches under the profiler.  A profile that lost launch
    records all the same is logged and taken again, up to `tries`
    times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_records()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms, n = device_ms(prof)
        if not lost_launches(f"{name} timing, profile {t + 1} of {tries}",
                             {name: reps}, n):
            return ms[name] / reps
    raise SystemExit(f"chip_smoke: {name}: the profiler kept losing "
                     "launches")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def capped(name: str, a, kw):
    """The first CAP work items of a launch, as a launch of their own
    (the twin's kernel: the whole launch, a block's twin at its cap)."""
    if name == RC:
        return tuple(a), dict(kw)
    if name == K4:
        ta, ao, tb, bo, band = a[:5]
        P = min(CAP, band.shape[0])
        return (ta[:int(ao[P])], ao[:P + 1], tb[:int(bo[P])], bo[:P + 1],
                band[:P], *a[5:]), dict(kw)
    if name == "bp_extend_kernel":
        sel = wave_bp.longest_first(a[4], a[5])[:CAP]
        return (*a[:2], *[x[sel] for x in a[2:7]], *a[7:]), dict(kw)
    if name in ("bp_trace_kernel", "wide_trace_kernel"):
        return (*a[:2], *[x[:CAP] for x in a[2:8]], *a[8:]), dict(kw)
    S = a[0].shape[0]
    cut = lambda x: x[:CAP] if torch.is_tensor(x) and x.shape[0] == S \
        else x  # noqa: E731
    return tuple(cut(x) for x in a), {k: cut(v) for k, v in kw.items()}


def route_times(fn, kernel: str) -> tuple[float, float, float]:
    """(device ms of kernels named `kernel`, device ms of everything,
    host wall s) of one run of fn(): the wall without the profiler, the
    device times from a second run under it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_records()
        fn()
        torch.cuda.synchronize()
    ev = device_events(prof)
    kern = sum(e.self_device_time_total for e in ev if kernel in e.key)
    return kern / 1e3, sum(e.self_device_time_total for e in ev) / 1e3, wall


def compare_wide_routes(jobs: list, want: list, card: str) -> dict:
    """The profiled pass's wide retries (every wide_trace_kernel launch's
    arguments) again through the earlier route, trace_wave_steps over
    dp_rows_kernel (one launch per segment step, the gathers and commit
    as torch ops), and through wide_trace_kernel, once each (the route
    question is answered, PERF.md §6: one turn keeps the holds and a
    time).  Each route's outputs must equal `want`, the plain
    version's on the same arguments.  Also the longest extent alone
    (CUDA events over three launches): the serial row chain's floor."""
    def steps():
        return [wave_wide.trace_wave_steps(*a, wave_wide.dp_rows_kernel)
                for a in jobs]

    def wide():
        return [wave_wide.trace_wide_kernel(*a) for a in jobs]
    routes = {"steps over dp_rows_kernel": (steps, "dp_rows_kernel",
                                            wave_wide.dp_rows),
              "wide_trace_kernel": (wide, "wide_trace_kernel",
                                    wave_wide.trace_wave)}
    res = {}
    for name, (fn, kern, counted) in routes.items():
        n0 = counted.launches
        err = max(max_abs_err(x, y) for x, y in zip(fn(), want))
        res[name] = dict(equal=err == 0, launches=counted.launches - n0)
    for name, (fn, kern, _) in routes.items():
        res[name].update(zip(("kernel_ms", "device_ms", "wall_s"),
                             route_times(fn, kern)))
    for name, r in res.items():
        log(f"wide retries via {name}: outputs equal {r['equal']}, "
            f"{r['launches']} kernel launches, kernel {r['kernel_ms']:.4f} "
            f"ms and all device work {r['device_ms']:.4f} ms device time, "
            f"wall {r['wall_s']:.4f} s on {card}")
    if not all(r["equal"] for r in res.values()):
        raise SystemExit("chip_smoke: the wide retry routes disagree")
    alim = torch.cat([a[6] for a in jobs]).to(torch.int64).clamp(min=0)
    j, i = max(((j, int(a[6].argmax())) for j, a in enumerate(jobs)),
               key=lambda ji: int(jobs[ji[0]][6][ji[1]]))
    one = (*jobs[j][:2], *[x[i:i + 1] for x in jobs[j][2:8]], *jobs[j][8:])
    # CUDA events: the launches queue back to back
    ms = cuda_ms(lambda: wave_wide.trace_wide_kernel(*one), 3)
    res["longest alone"] = dict(rows=int(alim.max()), kernel_ms=ms,
                                ns_per_row=1e6 * ms / max(int(alim.max()), 1))
    res["extents"] = dict(n=int(alim.numel()), sum_alim=int(alim.sum()),
                          max_alim=int(alim.max()))
    # the launches run one after another, each at least as long as its
    # longest extent's row chain
    longest = [int(a[6].max()) for a in jobs]
    res["chain_floor_ms"] = (res["longest alone"]["ns_per_row"]
                             * sum(longest) / 1e6)
    log(f"wide retries: {res['extents']}; per launch (extents, longest): "
        f"{[(int(a[6].numel()), m) for a, m in zip(jobs, longest)]}; "
        f"longest alone {res['longest alone']}; the launches' "
        f"serial-chain floor (sum of their longest extents x ns a row) "
        f"{res['chain_floor_ms']:.4f} ms on {card}")
    return res


def same_las(x, y) -> bool:
    return (x.tspace == y.tspace
            and np.array_equal(x.columns.headers, y.columns.headers)
            and np.array_equal(x.columns.trace, y.columns.trace)
            and np.array_equal(x.columns.offsets, y.columns.offsets))


def reset_launches() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {k: v[0].launches for k, v in KERNELS.items()}


def hold_launches(where: str, calls: dict) -> None:
    """Each launch in `calls` (kernel name -> [(args, kwargs)], as
    `capped` returns them) again on the card, held against the kernel's
    plain version on the same arguments; exits on any difference."""
    for name, launches in calls.items():
        _, mod, attr, plain, *_rest = KERNELS[name]
        for i, (a, k) in enumerate(launches):
            t0 = time.time()
            e = max_abs_err(getattr(mod, attr)(*a, **k), plain(*a, **k))
            items = a[0].shape[0] if name == RC else a[2].shape[0]
            log(f"{name}, {where} launch {i}: {items} items, "
                f"max_abs_err {e} (plain {time.time() - t0:.1f} s)")
            if e:
                raise SystemExit(f"chip_smoke: {name} disagrees with its "
                                 f"plain version on the {where}")


def small_reads(genome=None) -> list:
    """Phase 7's reads: a 60 kbp genome (or `genome`) at 10x, mean 4 kb,
    14% error."""
    if genome is None:
        genome = make_genome(60_000, seed=11)
    return sample_reads(genome, coverage=10.0, mean_len=4000, err=0.14,
                        seed=12).reads


def card_equals_cpu(dev, reads: list, cfg: OverlapConfig, pairs=None,
                    path: str | None = None, what: str = "") -> dict:
    """A self pair of `reads` and a distinct pair of its halves (pairs:
    a subset of "self", "distinct"), emit_mirrors on, on the card and on
    the CPU path: the same .las columns, check_las clean, and with
    `path` each seeding on that path.  Returns records per pair."""
    h = len(reads) // 2
    blk_a = block_from_reads(reads[:h], ids=np.arange(h))
    blk_b = block_from_reads(reads[h:], ids=np.arange(h, len(reads)))
    whole = block_from_reads(reads)
    rlen = np.array([len(r) for r in reads])
    todo = {"self": (whole, whole, True), "distinct": (blk_a, blk_b, False)}
    out = {}
    for label in pairs or todo:
        x, y, selfb = todo[label]
        outs = {}
        for d in (dev, "cpu"):
            outs[str(d)] = ov.overlap_block_pair(x, y, cfg, selfb,
                                                 emit_mirrors=True, device=d)
        gpu, cpu = outs[str(dev)], outs["cpu"]
        label = f"{what}{label}"
        for i in (0, 1):
            problems = check_las(gpu[i], rlen)
            if problems:
                raise SystemExit(f"chip_smoke: {label} pair check_las: "
                                 f"{problems[:5]}")
            if not same_las(gpu[i], cpu[i]):
                raise SystemExit(f"chip_smoke: {label} pair: card and CPU "
                                 f"paths differ (las_{'ab'[i]})")
        taken = {o[2]["seed_path"] for o in (gpu, cpu)}
        if path is not None and taken != {path}:
            raise SystemExit(f"chip_smoke: {label} pair: seeding took "
                             f"{taken}, wanted {path}")
        log(f"{label} pair, emit_mirrors: {gpu[0].novl} + {gpu[1].novl} "
            f"records, card == CPU path, check_las clean, seeding "
            f"{gpu[2]['seed_path']}")
        out[label] = gpu[0].novl + gpu[1].novl
    return out


def build_db(workdir: str, genome_bp: int, nblocks: int):
    """Simulated reads (the main unit's parameters) -> workdir/reads.fasta
    -> workdir/S.db, split into nblocks blocks.  Returns (db, reads,
    total bp, seconds for the reads, seconds for FASTA + DB + split)."""
    t0 = time.time()
    sim = sample_reads(make_genome(genome_bp, seed=SEED), coverage=COVERAGE,
                       mean_len=MEAN_LEN, err=ERR, seed=SEED + 1)
    nreads, total_bp = len(sim.reads), sum(len(r) for r in sim.reads)
    t_sim = time.time() - t0
    write_sim_fasta(f"{workdir}/reads.fasta", sim)
    del sim
    dazzdb.create_db(f"{workdir}/S.db", [f"{workdir}/reads.fasta"])
    size_mb = max(1, -(-total_bp // (nblocks * 1_000_000)))
    db = dazzdb.db_split(f"{workdir}/S.db", size_mb=size_mb, cutoff=0)
    return db, nreads, total_bp, t_sim, time.time() - t0 - t_sim


def write_pair(las_dir: str, i: int, j: int, la, lb) -> None:
    """A pair's files, as run_overlap_plan names and fills them."""
    out_a = f"{las_dir}/S.{i}.S.{j}.las"
    if i != j:
        lasmod.write_las(out_a, la)
        lasmod.write_las(f"{las_dir}/S.{j}.S.{i}.las", lb)
    else:
        both = lasmod.LasFile.concat([la, lb])
        both.sort()
        lasmod.write_las(out_a, both)


def plain_sweep(db, cfg: OverlapConfig, las_dir: str, device,
                rows=None) -> None:
    """The sweep's files by a plain loop: every pair of the DB's blocks
    (of the A-block rows `rows`, None: all) through overlap_block_pair,
    then one merge per A block of those rows.  No pipelining, hints,
    LRU, prefetch or manifest; a block's caches are cleared when its row
    is done, as the sweep does."""
    n = db.nblocks
    rows = range(1, n + 1) if rows is None else rows
    blocks = {}
    for i, j in block_pair_matrix(n):
        if i not in rows:
            continue
        for b in (i, j):
            if b not in blocks:
                blocks[b] = block_from_db(db, b)
        la, lb, _ = ov.overlap_block_pair(blocks[i], blocks[j], cfg, i == j,
                                          hit_cap=HIT_CAP, seed_cap=SEED_CAP,
                                          device=device)
        write_pair(las_dir, i, j, la, lb)
        if j == n:
            blocks[i].cache.clear()
    for i in rows:
        lasmod.merge_las([f"{las_dir}/S.{i}.S.{j}.las"
                          for j in range(1, n + 1)], f"{las_dir}/S.{i}.las")


def same_files(a: str, b: str, names: list | None = None) -> str | None:
    """The first .las file of directory `a` (or of `names`) that `b`
    lacks or holds with other bytes; None when all are equal."""
    if names is None:
        names = sorted(f for f in os.listdir(a) if f.endswith(".las"))
        if names != sorted(f for f in os.listdir(b) if f.endswith(".las")):
            return "(the file lists differ)"
    for f in names:
        if not (os.path.exists(f"{b}/{f}") and filecmp.cmp(
                f"{a}/{f}", f"{b}/{f}", shallow=False)):
            return f
    return None


class ChunkSpy:
    """While the wide route runs: the work (rows, ops, bytes) of every
    dp_rows_kernel launch, summed for the bound, and the arguments of
    the sampled launches (the first two, then every `every`-th), capped
    at CAP bands and copied, to hold against dp_rows_plain afterwards;
    and the arguments of every wide_trace_kernel launch (this route's
    main trace), capped at CAP extents, to hold against trace_wave_plain.
    The launches go through unchanged."""

    def __init__(self, sass: dict, every: int = 25):
        self.sass, self.every = sass, every
        self.n = self.rows = self.ops = self.byts = 0
        self.kept = []
        self.traces = []

    def __enter__(self):
        self.fn = wave_wide.dp_rows_kernel
        self.trace_fn = wave_wide.trace_wide_kernel

        def trace_spy(*a, **kw):
            n0 = wave_wide.trace_wave.launches
            out = self.trace_fn(*a, **kw)
            if wave_wide.trace_wave.launches != n0:
                self.traces.append(capped("wide_trace_kernel", a, kw))
            return out
        wave_wide.trace_wide_kernel = trace_spy

        def spy(*a, **kw):
            n0 = wave_wide.dp_rows.launches
            out = self.fn(*a, **kw)
            if wave_wide.dp_rows.launches == n0:
                return out
            r, o, b = work("dp_rows_kernel", a, kw, out, self.sass)
            self.rows, self.ops, self.byts = (self.rows + r, self.ops + o,
                                              self.byts + b)
            if self.n < 2 or self.n % self.every == 0:
                ca, ck = capped("dp_rows_kernel", a, kw)
                cl = lambda x: x.clone() if torch.is_tensor(x) else x  # noqa
                self.kept.append((self.n, tuple(cl(x) for x in ca),
                                  {k: cl(v) for k, v in ck.items()}))
            self.n += 1
            return out
        wave_wide.dp_rows_kernel = spy
        return self

    def __exit__(self, *exc):
        wave_wide.dp_rows_kernel = self.fn
        wave_wide.trace_wide_kernel = self.trace_fn
        return False


def wide_route(dev, card: str, sass: dict) -> dict:
    """Phase 6 (see the module docstring).  Returns the dp_rows_kernel
    numbers of the route's passes and the kept launches."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time()
    g = make_genome(GENOME_QUICK, seed=SEED)
    sim = sample_reads(g, coverage=COVERAGE, mean_len=MEAN_LEN, err=ERR,
                       seed=SEED + 1)
    blk = block_from_reads(sim.reads)
    log(f"wide route, quick-10Mbp: {len(sim.reads)} reads, "
        f"{sum(len(r) for r in sim.reads)} bp, block cap {blk.cap}, setup "
        f"{time.time() - t0:.1f} s")
    cfg = OverlapConfig(dp_kernel="wide")
    kw = dict(self_block=True, hit_cap=QUICK_HIT_CAP,
              seed_cap=QUICK_SEED_CAP, emit_mirrors=False, device=dev)

    def one_pass():
        torch.cuda.synchronize()
        t0 = time.time()
        las_a, _, stats = ov.overlap_block_pair(blk, blk, cfg, **kw)
        torch.cuda.synchronize()
        return las_a, stats, time.time() - t0

    las_c, _, wall = one_pass()
    log(f"wide route, cold pass: wall {wall:.4f} s, overlaps {las_c.novl}")
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    las_a, stats, wall = one_pass()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    aligned = int(las_a.a_spans().sum())
    log(f"wide route, warm pass: overlaps {las_a.novl}, aligned bp "
        f"{aligned}, wall {wall:.4f} s, {aligned / wall / 1e9:.4f} "
        f"Gbp-aligned/s on {card}")
    log(f"wide route stats: {json.dumps(stats, default=int)}")
    log(f"wide route launches in the pass: {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} B)")
    problems = check_las(las_a, blk.rlen)
    if problems:
        raise SystemExit(f"chip_smoke: wide route check_las: {problems[:5]}")
    if las_a.novl <= 0 or las_a.novl != las_c.novl:
        raise SystemExit("chip_smoke: wide route: no overlaps, or the warm "
                         "pass gave other records than the cold one")
    if stats.get("seed_overflow"):
        raise SystemExit("chip_smoke: wide route: seeding buffers overflowed")
    missing = [k for k in WIDE_PATH if launches[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels not launched by the wide "
                         f"route: {missing}")
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with ChunkSpy(sass) as spy, profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            lead_records()
            las_s, _, wall_p = one_pass()
        ms, n = device_ms(prof)
        if not lost_launches(f"wide route, profile {attempt + 1} of "
                             f"{PROFILE_TRIES}",
                             {"dp_rows_kernel": spy.n,
                              "wide_trace_kernel": len(spy.traces)}, n):
            break
    else:
        raise SystemExit("chip_smoke: the profiler kept losing launches")
    if (las_s.novl != las_a.novl or spy.n != launches["dp_rows_kernel"]
            or len(spy.traces) != launches["wide_trace_kernel"]):
        raise SystemExit("chip_smoke: the spied wide pass differs from the "
                         "counted one")
    bms, by = bound(spy.ops, spy.byts)
    log(f"dp_rows_kernel in one wide-route pass: {spy.n} launches, "
        f"{ms['dp_rows_kernel']:.4f} ms device time, {spy.rows} lane-rows, "
        f"bound {bms:.4f} ms ({by}), share of bound "
        f"{bms / ms['dp_rows_kernel']:.3f}; the pass's wall {wall_p:.4f} s "
        f"(profiler and spy on), wide_trace_kernel "
        f"{ms['wide_trace_kernel']:.4f} ms in {n['wide_trace_kernel']} "
        f"launches, on {card}")
    t0 = time.time()
    err = 0
    for i, a, k in spy.kept:
        e = max_abs_err(wave_wide.dp_rows_kernel(*a, **k),
                        wave_wide.dp_rows_plain(*a, **k))
        if e:
            log(f"dp_rows_kernel, wide-route launch {i}: max_abs_err {e}")
        err = max(err, e)
    log(f"dp_rows_kernel vs plain on {len(spy.kept)} sampled wide-route "
        f"launches (of {spy.n}; bands {[a[0].shape[0] for _, a, _ in spy.kept][:8]}"
        f"...): max_abs_err {err} ({time.time() - t0:.1f} s)")
    if err:
        raise SystemExit("chip_smoke: dp_rows_kernel disagrees with its "
                         "plain version on the wide route")
    hold_launches("wide route", {"wide_trace_kernel": spy.traces})
    # a small self pair: card == CPU path under dp_kernel="wide"
    t0 = time.time()
    small = sample_reads(make_genome(20_000, seed=11), coverage=6.0,
                         mean_len=2000, err=0.14, seed=12).reads
    sb = block_from_reads(small)
    outs = [ov.overlap_block_pair(sb, sb, cfg, True, emit_mirrors=True,
                                  device=d) for d in (dev, "cpu")]
    for i in (0, 1):
        problems = check_las(outs[0][i], sb.rlen)
        if problems or not same_las(outs[0][i], outs[1][i]):
            raise SystemExit(f"chip_smoke: wide small pair: card and CPU "
                             f"paths differ or check_las failed "
                             f"(las_{'ab'[i]}): {problems[:5]}")
    if outs[0][0].novl <= 0:
        raise SystemExit("chip_smoke: wide small pair: no overlaps")
    log(f"wide small self pair: {outs[0][0].novl} + {outs[0][1].novl} "
        f"records, card == CPU path, check_las clean "
        f"({time.time() - t0:.1f} s)")
    return dict(launches=launches["dp_rows_kernel"],
                pass_ms=ms["dp_rows_kernel"], pass_bound_ms=bms, bound_by=by,
                rows=spy.rows, wall_s=wall, overlaps=las_a.novl,
                aligned_bp=aligned, sampled=len(spy.kept), kept=spy.kept,
                wide_trace_launches=launches["wide_trace_kernel"])


def mirrors_missing(merged: list, rlen: np.ndarray) -> int:
    """How many records of the merged files lack their mirror (the same
    alignment with the reads' roles swapped; a comp record's mirror has
    both intervals counted from the reads' other ends)."""
    h = np.concatenate([m.columns.headers for m in merged]).astype(np.int64)
    ar, br, comp = h[:, 7], h[:, 8], h[:, 6] & 1
    abp, aep, bbp, bep = h[:, 2], h[:, 4], h[:, 3], h[:, 5]
    la, lb = rlen[ar].astype(np.int64), rlen[br].astype(np.int64)
    own = np.stack([ar, br, comp, abp, aep, bbp, bep], axis=1)
    mir = np.stack([br, ar, comp,
                    np.where(comp == 1, lb - bep, bbp),
                    np.where(comp == 1, lb - bbp, bep),
                    np.where(comp == 1, la - aep, abp),
                    np.where(comp == 1, la - abp, aep)], axis=1)
    own = own[np.lexsort(own.T[::-1])]
    mir = mir[np.lexsort(mir.T[::-1])]
    return int((own != mir).any(axis=1).sum())


def sweep_phase(dev, card: str, rounds: int, then=None) -> dict:
    """Phase 8 (see the module docstring).  Returns the sweep's numbers
    and the launches of each kernel in it; then(workdir, db), when
    given, runs on its DB and files before they go (phase 13a), its
    result under "then"."""
    cfg = OverlapConfig()
    w = tempfile.mkdtemp(prefix="damar_smoke_sweep_")
    try:
        db, nreads, total_bp, t_sim, t_db = build_db(w, GENOME_SWEEP,
                                                     SWEEP_BLOCKS)
        n = db.nblocks
        pairs = block_pair_matrix(n)
        rlen = db.reads["rlen"]
        log(f"sweep: {nreads} reads, {total_bp} bp in {n} blocks of <= "
            f"{db.block_size_mb} Mbp ({len(pairs)} pairs); reads "
            f"{t_sim:.1f} s, FASTA + DB + split {t_db:.1f} s")
        if n != SWEEP_BLOCKS:
            raise SystemExit(f"chip_smoke: sweep: {n} blocks, wanted "
                             f"{SWEEP_BLOCKS}")

        def plan(las_dir, **kw):
            return run_overlap_plan(f"{w}/S.db", cfg, las_dir=las_dir,
                                    verbose=False, hit_cap=HIT_CAP,
                                    seed_cap=SEED_CAP, device=dev, **kw)

        # one run: the plain loop over PLAIN_ROWS; in turns: every row
        rows = None if rounds > 1 else PLAIN_ROWS
        n_plain = sum(1 for i, _ in pairs if rows is None or i in rows)

        def run(form, out):
            """One run of the sweep or of the plain loop into the new
            directory `out`: (wall, peak device memory, stats)."""
            os.makedirs(out)
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.time()
            stats = (plan(out) if form == "sweep"
                     else plain_sweep(db, cfg, out, dev, rows))
            torch.cuda.synchronize()
            return (time.time() - t0, torch.cuda.max_memory_allocated(dev),
                    stats)

        # ---- the sweep (run_overlap_plan), then the plain loop ----
        reset_launches()
        wall, peak, stats = run("sweep", f"{w}/sweep")
        launches = read_launches()
        pair_stats = stats.pop("pair_stats")
        if stats["pairs"] != len(pairs) or stats["skipped"]:
            raise SystemExit(f"chip_smoke: sweep ran {stats}")
        if any(p.get("seed_overflow") for p in pair_stats):
            raise SystemExit("chip_smoke: sweep: seeding buffers overflowed")
        missing = [k for k in MAIN_PATH + (RC,) if launches[k] <= 0]
        if missing:
            raise SystemExit(f"chip_smoke: kernels not launched by the "
                             f"sweep: {missing}")
        for p in pair_stats:
            log(f"  {p['pair']}: " + ", ".join(
                f"{k} {p[k]}" for k in ("t_seed", "t_extend", "t_dedupe",
                                        "t_pool", "t_trace", "kept",
                                        "trace_retries", "dropped_trace")
                if k in p))
        wall_plain, peak_plain, _ = run("plain", f"{w}/plain")

        # ---- (a) every file of the plain loop byte-equal ----
        names = sorted(f for f in os.listdir(f"{w}/plain")
                       if f.endswith(".las"))
        nrows = n if rows is None else len(rows)
        want = nrows * (2 * n - nrows) + nrows
        bad = same_files(f"{w}/plain", f"{w}/sweep", names)
        if len(names) != want or bad:
            raise SystemExit(f"chip_smoke: sweep: {bad} differs from the "
                             f"plain loop's, or other files: {names}")
        # ---- more rounds of both forms, in turns ----
        walls = {"sweep": [wall], "plain": [wall_plain]}
        for r in range(1, rounds):
            for form in (("plain", "sweep") if r % 2 else
                         ("sweep", "plain")):
                t, _, _ = run(form, f"{w}/again")
                walls[form].append(t)
                bad = same_files(f"{w}/plain", f"{w}/again")
                if bad:
                    raise SystemExit(f"chip_smoke: sweep round {r} ({form}): "
                                     f"{bad} differs from the first run's")
                shutil.rmtree(f"{w}/again")
        # ---- (b), (c): merged files ----
        t0 = time.time()
        merged = [lasmod.read_las(f"{w}/sweep/S.{i}.las")
                  for i in range(1, n + 1)]
        for i, m in enumerate(merged, 1):
            problems = check_las(m, rlen)
            if problems:
                raise SystemExit(f"chip_smoke: sweep: check_las S.{i}.las: "
                                 f"{problems[:5]}")
        novl = sum(m.novl for m in merged)
        spans = sum(int(m.a_spans().sum()) for m in merged)
        lost = mirrors_missing(merged, rlen)
        if novl <= 0 or novl % 2 or lost:
            raise SystemExit(f"chip_smoke: sweep: {novl} merged records, "
                             f"{lost} without their mirror")
        aligned = spans // 2
        t_check = time.time() - t0
        del merged
        # ---- (d) a second run finds every job done ----
        again = plan(f"{w}/sweep")
        if again["pairs"] or again["skipped"] != len(pairs):
            raise SystemExit(f"chip_smoke: sweep: the second run recomputed "
                             f"pairs: {again}")
        log(f"sweep: the plain loop's {len(names)} files ({n_plain} "
            f"pairs) byte-equal to the sweep's; "
            f"merged files check_las clean and sorted, {novl} records, each "
            f"with its mirror (checks {t_check:.1f} s); second run skipped "
            f"{again['skipped']} pairs, ran {again['pairs']}")
        log(f"sweep (run_overlap_plan): wall {wall:.4f} s, "
            f"{len(pairs) / wall:.4f} pairs/s, aligned bp {aligned} "
            f"(merged A spans {spans} / 2), {aligned / wall / 1e9:.4f} "
            f"Gbp-aligned/s/gpu, peak device memory {peak / 2**30:.2f} GiB "
            f"({peak} B) on {card}")
        log(f"plain loop (overlap_block_pair, same blocks, same call, "
            f"{n_plain} of {len(pairs)} pairs): wall {wall_plain:.4f} s, "
            f"{wall_plain / n_plain:.4f} s a pair against the sweep's "
            f"{wall / len(pairs):.4f}, peak device memory "
            f"{peak_plain / 2**30:.2f} GiB ({peak_plain} B) on {card}")
        if rounds > 1:
            med = {f: float(np.median(v)) for f, v in walls.items()}
            log(f"in turns, {rounds} rounds: sweep walls "
                f"{[round(x, 4) for x in walls['sweep']]} s, median "
                f"{med['sweep']:.4f} s; plain loop walls "
                f"{[round(x, 4) for x in walls['plain']]} s, median "
                f"{med['plain']:.4f} s; sweep / plain "
                f"{med['sweep'] / med['plain']:.3f}; every run's files "
                f"byte-equal; on {card}")
        log(f"launches in the sweep: {launches}")

        # ---- (e) two pairs again (host 0 of 5) with one
        # resident block: every B block's device buffers are released,
        # and every A block's when its row ends, while the pair before is
        # still in its emit on the worker's stream ----
        released = []
        real = ov.release_device_buffers
        ov.release_device_buffers = lambda b: released.append(1) or real(b)
        os.environ["DAMAR_RESIDENT_BLOCKS"] = "1"
        os.makedirs(f"{w}/evict")
        try:
            t0 = time.time()
            half = plan(f"{w}/evict", nhosts=EVICT_HOSTS, host_id=0)
            t_half = time.time() - t0
        finally:
            ov.release_device_buffers = real
            del os.environ["DAMAR_RESIDENT_BLOCKS"]
        mine = [f for f in sorted(os.listdir(f"{w}/evict"))
                if f.endswith(".las")]
        bad = same_files(f"{w}/evict", f"{w}/sweep", mine)
        half.pop("pair_stats", None)
        if (not released or bad
                or half["pairs"] != len(pairs[::EVICT_HOSTS])
                or half.get("merges_deferred") != n):
            raise SystemExit(f"chip_smoke: sweep with one resident block: "
                             f"{len(released)} releases, {bad} differs, "
                             f"stats {half}")
        log(f"sweep, host 0 of {EVICT_HOSTS}, DAMAR_RESIDENT_BLOCKS=1: "
            f"{half['pairs']} "
            f"pairs, {len(released)} blocks released under pending emits, "
            f"{len(mine)} files byte-equal to the sweep's ({t_half:.1f} s)")

        # ---- one distinct pair (mirrors on: B != A, the rc blocks'
        # pool offsets, swapped roles), every launch kept: its records
        # must be the plain loop's files, and its first PAIR_HELD
        # launches of each kernel (capped at CAP items) must equal their
        # plain versions ----
        t0 = time.time()
        b1, b2 = block_from_db(db, 1), block_from_db(db, 2)
        with Spy() as spy:
            la, lb, _ = ov.overlap_block_pair(b1, b2, cfg, False,
                                              hit_cap=HIT_CAP,
                                              seed_cap=SEED_CAP, device=dev)
        os.makedirs(f"{w}/pair")
        write_pair(f"{w}/pair", 1, 2, la, lb)
        bad = same_files(f"{w}/pair", f"{w}/plain",
                         ["S.1.S.2.las", "S.2.S.1.las"])
        if bad or lb.novl <= 0:
            raise SystemExit(f"chip_smoke: sweep: the spied pair 1, 2 wrote "
                             f"other bytes than the plain loop ({bad})")
        del la, lb
        held = {k: [capped(k, a, kw) for a, kw, _ in spy.calls[k][:m]]
                for k, m in PAIR_HELD.items()}
        del spy
        n_held = {k: len(v) for k, v in held.items()}
        if not all(n_held.values()):
            raise SystemExit(f"chip_smoke: sweep: the spied pair launched "
                             f"{n_held}")
        hold_launches("sweep pair 1, 2", held)
        log(f"sweep pair 1, 2 (distinct, mirrors): files byte-equal to the "
            f"plain loop's; launches {n_held} equal to their plain versions "
            f"({time.time() - t0:.1f} s)")
        out = dict(launches=launches, wall_s=wall, wall_plain_s=wall_plain,
                   plain_pairs=n_plain,
                   aligned_bp=aligned, records=novl, peak_bytes=peak,
                   peak_plain_bytes=peak_plain, pairs=len(pairs),
                   total_bp=total_bp, released_one_resident=len(released),
                   pair_launches_held=n_held)
        if then is not None:
            out["then"] = then(w, db)
        return out
    finally:
        shutil.rmtree(w, ignore_errors=True)


# the ring's first launch of each kernel held against its plain version
RING_HELD = {"bp_extend_kernel": 1, "bp_trace_kernel": 1,
             "wide_trace_kernel": 1}
# phase 13b: ranks spawned over gloo on the one card, and the spread DB
# they sweep (tests/test_parallel.py's 12-block DB: reads dealt to blocks
# by genome position, so 3 x 3 super-sweeps of 4 ranks)
RING_RANKS, RING_SPREAD_BLOCKS, RING_TIMEOUT = 4, 12, 300.0


def ring_shard_bytes(las: dict, d: str, tag: str) -> dict:
    """{i: bytes} of a ring's shards, each written with write_las."""
    out = {}
    for i, lf in las.items():
        lasmod.write_las(f"{d}/{tag}.{i}.las", lf)
        with open(f"{d}/{tag}.{i}.las", "rb") as f:
            out[i] = f.read()
    return out


def ring_full(dev, card: str, w: str, db) -> dict:
    """Phase 13a: the ring sweep at full width on one card, a ring of one
    rank over phase 8's 4 blocks of ~50 Mbp (their cap made common): 16
    one-rotation sweeps cover the 16 ordered pairs.  Every shard
    check_las clean and sorted; for i < j, shard i's records of B-block
    j byte-equal to overlap_block_pair's A side with mirrors off, and a
    superset of phase 8's sweep pair file S.i.S.j.las (mirrors on: a record
    whose mirror fails its trace is dropped with it); the ring's first
    K1, K2 and K3 launches (capped at CAP items) equal to their plain
    versions."""
    n = db.nblocks
    caps = [block_from_db(db, b).cap for b in range(1, n + 1)]
    blocks = [block_from_db(db, b, cap=max(caps)) for b in range(1, n + 1)]
    cfg = OverlapConfig()
    timings, stats = {}, {}
    with Spy(keep=RING_HELD) as spy:
        (las, counts, total), wall, peak = timed(
            dev, lambda: ring.distributed_overlap_las(
                blocks, cfg, timings=timings, stats=stats, device=dev))
    launches = read_launches()
    log(f"ring (13a) ran: wall {wall:.4f} s, {timings}, {stats}, totals "
        f"{total.tolist()}, launches {launches}")
    missing = [k for k in RING_HELD if launches[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: ring: kernels not launched: {missing}"
                         f" (launches {launches})")
    rlen = db.reads["rlen"]
    d = f"{w}/ring"
    os.makedirs(d)
    t0 = time.time()
    novl = spans = 0
    names, extra = [], {}
    for i in range(n):
        shard = las[i]
        problems = check_las(shard, rlen, rlen, sorted_order=True)
        if problems:
            raise SystemExit(f"chip_smoke: ring: check_las shard {i}: "
                             f"{problems[:5]}")
        novl += shard.novl
        spans += int(shard.a_spans().sum())
        bread = shard.columns.headers[:, 8]
        for j in range(i + 1, n):
            name = f"S.{i + 1}.S.{j + 1}.las"
            rows = np.nonzero(np.isin(bread, blocks[j].ids))[0]
            part = lasmod.LasFile(shard.tspace,
                                  columns=shard.columns.permute(rows))
            lasmod.write_las(f"{d}/{name}", part)
            # the pair driver's A side with mirrors off (the reference's
            # own ring test compares that): the same bytes
            la, _, _ = ov.overlap_block_pair(blocks[i], blocks[j], cfg,
                                             False, emit_mirrors=False,
                                             device=dev)
            lasmod.write_las(f"{d}/pair.{name}", la)
            if not filecmp.cmp(f"{d}/{name}", f"{d}/pair.{name}",
                               shallow=False) or not len(rows):
                raise SystemExit(f"chip_smoke: ring: {name}: {len(rows)} "
                                 f"records, the pair driver's {la.novl}, "
                                 f"other bytes")
            # phase 8's pair file (mirrors on) holds a subset: a record
            # whose mirror failed its trace goes with it
            ring_h = {tuple(x) for x in part.columns.headers.tolist()}
            sweep = lasmod.read_las(f"{w}/sweep/{name}")
            sweep_h = [tuple(x) for x in sweep.columns.headers.tolist()]
            if not all(x in ring_h for x in sweep_h):
                raise SystemExit(f"chip_smoke: ring: phase 8's {name} holds "
                                 f"records the ring lacks")
            extra[name] = part.novl - sweep.novl
            names.append(name)
        ov.release_device_buffers(blocks[i])
    t_check = time.time() - t0
    held = hold_first("ring", spy, RING_HELD)
    del spy
    aligned = spans // 2
    log(f"ring (13a), 1 rank, {n} blocks of cap {max(caps)}: wall "
        f"{wall:.4f} s (overlap ring {timings['overlap_ring']:.4f}, dedupe "
        f"{timings['dedupe']:.4f}, trace ring {timings['trace_ring']:.4f}, "
        f"checks, wide retries and emit {timings['retry_emit']:.4f}), "
        f"{novl} records, aligned bp {aligned} (A spans {spans} / 2), "
        f"{aligned / wall / 1e9:.4f} Gbp-aligned/s/gpu, seeds {total[0]}, "
        f"extents {total[1]}, hits {total[2]}, trace_retries "
        f"{stats['trace_retries']}, dropped_trace {stats['dropped_trace']}, "
        f"peak device memory {peak / 2**30:.2f} GiB ({peak} B), launches "
        f"{launches} on {card}")
    log(f"ring (13a): shards check_las clean and sorted; {len(names)} pair "
        f"parts byte-equal to the pair driver's A side (mirrors off), and "
        f"each holds phase 8's pair file (mirrors on) and {extra} records "
        f"more, whose mirror failed its trace there (checks {t_check:.1f} "
        f"s); first launches {held} equal to their plain versions")
    for b in blocks:
        ov.release_device_buffers(b)
    return dict(launches=launches, wall_s=wall, timings_s=timings,
                records=novl, aligned_bp=aligned,
                gbp_aligned_per_s=aligned / wall / 1e9,
                seeds=int(total[0]), extents=int(total[1]),
                hits=int(total[2]), peak_bytes=peak, **stats, held=held,
                beyond_sweep_files=extra)


def ring_spread_blocks() -> list:
    """Phase 13b's DB: tests/test_parallel.py's 12-block spread DB (a 40
    kbp genome at 3x, reads of >= 1.5 kb dealt by position)."""
    g = make_genome(40_000, seed=83)
    r = sample_reads(g, coverage=3.0, mean_len=3000, err=0.12, seed=84,
                     min_len=1500, circular=False)
    order = np.argsort(r.start)
    k = RING_SPREAD_BLOCKS
    return [block_from_reads([r.reads[i] for i in order[d::k]],
                             ids=np.asarray(order[d::k], np.int64),
                             cap=1 << 16) for d in range(k)]


def ring_ranks(dev, card: str) -> dict:
    """Phase 13b: the rotation itself on one card.  RING_RANKS ranks
    spawned over gloo, each running its kernels on the card, the blocks
    staged through host memory, sweep the 12-block spread DB (3 x 3
    super-sweeps); every shard byte-equal to a ring of one rank on the
    card and to the port's CPU run.  Then two ranks asked for NCCL on the
    one card must both refuse, naming it."""
    blocks = ring_spread_blocks()
    cfg = OverlapConfig(min_len=900, max_read_len=16384)
    d = tempfile.mkdtemp(prefix="damar_smoke_ring_")
    try:
        walls = {}
        t0 = time.time()
        one = ring_shard_bytes(ring.distributed_overlap_las(
            blocks, cfg, device=dev)[0], d, "card")
        walls["one_rank_card"] = time.time() - t0
        t0 = time.time()
        cpu = ring_shard_bytes(ring.distributed_overlap_las(
            blocks, cfg, device="cpu")[0], d, "cpu")
        walls["one_rank_cpu"] = time.time() - t0
        t0 = time.time()
        ring.spawn_ranks(ring.ring_to_dir, RING_RANKS,
                         ([("spread", blocks, cfg, {}, "las")], d,
                          str(dev)), backend="gloo", timeout=RING_TIMEOUT)
        walls["ranks"] = time.time() - t0
        with open(f"{d}/spread/rank0.json") as f:
            info = json.load(f)
        got = {}
        for i in range(len(blocks)):
            with open(f"{d}/spread/shard.{i}.las", "rb") as f:
                got[i] = f.read()
        records = sum(lasmod.read_las(f"{d}/card.{i}.las").novl
                      for i in one)
        if got != one or cpu != one or records <= 0:
            raise SystemExit(f"chip_smoke: ring ranks: shards differ (ranks "
                             f"== card {got == one}, CPU == card "
                             f"{cpu == one}, {records} records)")
        if (info["backend"], info["staged"]) != ("gloo", True):
            raise SystemExit(f"chip_smoke: ring ranks ran {info}")
        t0 = time.time()
        try:
            ring.spawn_ranks(ring.ring_to_dir, 2, ([], d, str(dev)),
                             backend="nccl", timeout=120.0)
        except Exception as e:      # each rank raises; the first is reported
            refused = "two ranks on one card" in str(e)
        else:
            refused = False
        if not refused:
            raise SystemExit("chip_smoke: NCCL with two ranks on one card "
                             "did not refuse")
        walls["nccl_refusal"] = time.time() - t0
        log(f"ring ranks (13b): {RING_RANKS} ranks over {info['backend']}, "
            f"each on {info['device']}, blocks staged through host memory "
            f"({info['staged']}), {len(blocks)} blocks "
            f"({(len(blocks) // RING_RANKS) ** 2} super-sweeps): {records} "
            f"records, every shard byte-equal to one rank on the card and to "
            f"the CPU run; rank 0's walls {info['timings']}; NCCL with two "
            f"ranks on {dev} refused; walls {walls} on {card}")
        return dict(ranks=RING_RANKS, backend=info["backend"],
                    staged=info["staged"], records=records,
                    rank0_timings_s=info["timings"], walls_s=walls)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def ring_option_blocks() -> list:
    """Phase 13c's DB (tests/test_torch_ring_options.py's small_blocks):
    two blocks of reads over an AT-rich 30 kbp genome (40% A, 10% C,
    10% G, 40% T; 4x, mean 2.5 kb, 12% error), dealt alternately, the
    first with the tandem-bearing reads of tests/test_overlap.py's
    identity test (three 5%-error copies of a 900 bp unit, three
    unrelated 2 kbp reads) appended."""
    g = np.random.default_rng(91).choice(
        np.arange(4, dtype=np.uint8), size=30_000, p=[0.4, 0.1, 0.1, 0.4])
    s = sample_reads(g, coverage=4, mean_len=2500, err=0.12, seed=92,
                     min_len=1000)
    n = len(s.reads)
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 900).astype(np.uint8)
    tandem = [np.concatenate([mutate(unit, 0.05, rng) for _ in range(3)])]
    tandem += [rng.integers(0, 4, 2000).astype(np.uint8) for _ in range(3)]
    return [block_from_reads([s.reads[i] for i in range(0, n, 2)] + tandem,
                             ids=np.concatenate([np.arange(0, n, 2),
                                                 n + np.arange(4)]),
                             cap=1 << 17),
            block_from_reads([s.reads[i] for i in range(1, n, 2)],
                             ids=np.arange(1, n, 2), cap=1 << 17)]


def records(las, which: str, ids=None) -> "lasmod.LasFile":
    """The records of `las` whose B read is one of `ids` (which "b"), or
    of a read against itself (which "self")."""
    h = las.columns.headers
    keep = np.isin(h[:, 8], ids) if which == "b" else h[:, 7] == h[:, 8]
    return lasmod.LasFile(las.tspace,
                          columns=las.columns.permute(np.nonzero(keep)[0]))


def ring_options(dev, card: str) -> dict:
    """Phase 13c (see the module docstring)."""
    blocks = ring_option_blocks()
    d = tempfile.mkdtemp(prefix="damar_smoke_ring_options_")
    try:
        t0 = time.time()
        base = ring_shard_bytes(ring.distributed_overlap_las(
            blocks, OverlapConfig(min_len=500), device=dev)[0], d, "base")
        out = {}
        for opt in ("bias", "identity"):
            cfg = OverlapConfig(min_len=500, **{opt: True})
            reset_launches()
            las = ring.distributed_overlap_las(blocks, cfg, device=dev)[0]
            launches = read_launches()
            got = ring_shard_bytes(las, d, opt)
            cpu = ring_shard_bytes(ring.distributed_overlap_las(
                blocks, cfg, device="cpu")[0], d, f"{opt}.cpu")
            if opt == "bias":
                mine = records(las[0], "b", blocks[1].ids)
                pair = ov.overlap_block_pair(blocks[0], blocks[1], cfg,
                                             False, emit_mirrors=False,
                                             device=dev)[0]
            else:
                mine = records(las[0], "self")
                pair = records(ov.overlap_block_pair(
                    blocks[0], blocks[0], cfg, True, emit_mirrors=False,
                    device=dev)[0], "self")
            same_pair = (ring_shard_bytes({0: mine}, d, f"{opt}.ring")
                         == ring_shard_bytes({0: pair}, d, f"{opt}.pair"))
            missing = [k for k in MAIN_PATH[:2] if launches[k] <= 0]
            if got != cpu or got == base or not same_pair or not pair.novl \
                    or missing:
                raise SystemExit(
                    f"chip_smoke: ring with {opt}=True: card == CPU "
                    f"{got == cpu}, unlike the ring without it "
                    f"{got != base}, the pair driver's records {same_pair} "
                    f"({pair.novl}), kernels not launched {missing}")
            out[opt] = dict(records=sum(x.novl for x in las.values()),
                            compared=pair.novl, launches={
                                k: v for k, v in launches.items() if v})
        try:
            ring.distributed_overlap_las(
                blocks, OverlapConfig(min_len=500, dp_kernel="wide"),
                device=dev)
        except ValueError as e:
            refused = "no wide route" in str(e)
        else:
            refused = False
        if not refused:
            raise SystemExit("chip_smoke: the ring ran dp_kernel='wide'")
        out["wall_s"] = time.time() - t0
        log(f"ring options (13c): bias=True and identity=True, one rank on "
            f"the card == the CPU run, unlike the ring without them; -b's "
            f"part (0, 1) ({out['bias']['compared']} records) the pair "
            f"driver's A side, -I's {out['identity']['compared']} "
            f"read-vs-itself records the self pair's; dp_kernel='wide' "
            f"refused; {out} on {card}")
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def report_profile(prof, wall: float, path: str | None) -> None:
    """Prints the profiled pass's device time, busy share, the host's
    stream syncs and kernel launches; writes the full tables to `path`
    when given."""
    ka = prof.key_averages()
    on_dev = device_events(prof)
    dev_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    log(f"profiled pass: wall {wall:.4f} s (profiler on), device time "
        f"{dev_s:.4f} s, busy share {dev_s / wall:.3f}")
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:10]
    log("device time by name: " + ", ".join(
        f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms "
        f"({e.count})" for e in top))
    # the pass's own calls: the lead records add LEAD_RECORDS launches
    for name, lead in (("cudaStreamSynchronize", 0),
                       ("cudaLaunchKernel", LEAD_RECORDS)):
        e = [x for x in ka if x.key == name]
        if e:
            log(f"{name}: {e[0].count - lead} calls in the pass "
                f"({e[0].cpu_time_total / 1e3:.1f} ms host time, the lead "
                f"records' included)")
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(
            ka.table(sort_by="self_cuda_time_total", row_limit=30,
                     max_name_column_width=60) + "\n"
            + ka.table(sort_by="cpu_time_total", row_limit=25,
                       max_name_column_width=60) + "\n")
        log(f"profile tables: {path}")


def tracks_bad(track, rlen, empty_ok: bool = False) -> int:
    """Reads whose track intervals leave the read or are not sorted (each
    interval nonempty, or with empty_ok at least not reversed, and the
    next starting at or after its end)."""
    bad = 0
    for i, d in enumerate(track.data):
        iv = np.asarray(d, np.int64).reshape(-1, 2)
        if len(iv) and ((iv[:, 0] < 0).any() or (iv[:, 1] > rlen[i]).any()
                        or (iv[:, 0] > iv[:, 1] - (0 if empty_ok else 1)
                            ).any()
                        or (iv[1:, 0] < iv[:-1, 1]).any()):
            bad += 1
    return bad


def kept_with_discarded_mirror(las) -> tuple[int, int]:
    """(kept records whose mirror is discarded, kept records with no
    mirror) of a filtered file.  A record's mirrors are the records of
    its read pair with the roles swapped (same orientation): clipping to
    the trim windows cuts each on its own A read's segment grid, so the
    coordinates of a record and its mirror no longer reflect exactly."""
    h = las.columns.headers.astype(np.int64)
    ar, br, comp = h[:, 7], h[:, 8], h[:, 6] & 1
    live = (h[:, 6] & 0x4) == 0
    key = (ar << 33) | (br << 1) | comp
    mkey = (br << 33) | (ar << 1) | comp
    any_rec = set(key.tolist())
    any_live = set(key[live].tolist())
    m = mkey[live].tolist()
    n_none = sum(k not in any_rec for k in m)
    n_disc = sum(k in any_rec and k not in any_live for k in m)
    return n_disc, n_none


def run_stages(w: str, cfgs: tuple, dev, caps: dict, spy: dict | None = None,
               log_walls: bool = True) -> dict:
    """damar_tpu/pipeline/run.py's phases 2-6 on the split DB w/RAW.db,
    as run.py composes them: dust and tandem tracks, overlap1 with those
    masks, the patch round (per block: LAstitch -> retrace of the needed
    rows against a subset block of their B reads -> LAq -> LAfix, then
    FIX.fasta -> FIX DB split as RAW), overlap2, and scrub (merge ->
    sort -> LAstitch -> retrace -> LAq -> LAgap -> q/trim tracks -> clip
    to trim -> LArepeat -> LAfilter).  spy: a dict that receives, for
    the tandem searches ("tan"), the patch retraces ("patch_retrace")
    and the scrub retrace ("scrub_retrace"), each kernel's launches and
    device ms under torch.profiler, and the launches (Spy.calls) of the
    first tandem search and of the scrub retrace.  Returns the counts
    and walls."""
    from damar_tpu_torch.formats import tracks
    from damar_tpu_torch.formats.fasta import revcomp, write_fasta
    from damar_tpu_torch.pipeline import masking, scrub
    from damar_tpu_torch.pipeline.run import _reads_subset_block
    ocfg, mcfg, scfg = cfgs
    raw_db, fix_db = f"{w}/RAW.db", f"{w}/FIX.db"
    db = dazzdb.DazzDB.open(raw_db)
    size_mb, cutoff = db.block_size_mb, db.cutoff
    out = {"walls": {}}
    t_stage = [time.time()]

    def call(key, fn):
        """fn(), and with spy its launches and device time under key."""
        if spy is None:
            return fn()
        from torch.profiler import ProfilerActivity, profile
        before = read_launches()
        with Spy() as sp, profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_records()
            res = fn()
            torch.cuda.synchronize()
        ms, n = device_ms(prof)
        acc = spy.setdefault(key, dict(launches=dict.fromkeys(ms, 0),
                                       profiled=dict.fromkeys(ms, 0),
                                       ms=dict.fromkeys(ms, 0.0),
                                       calls=sp.calls))
        after = read_launches()
        for k in ms:
            acc["launches"][k] += after[k] - before[k]
            acc["profiled"][k] += n[k]
            acc["ms"][k] += ms[k]
        return res

    def done(stage, **info):
        t = time.time()
        if dev != "cpu":
            torch.cuda.synchronize()
            t = time.time()
        out["walls"][stage] = round(t - t_stage[0], 4)
        out.update(info)
        if log_walls:
            log(f"stage {stage}: wall {out['walls'][stage]:.4f} s; "
                + ", ".join(f"{k} {v}" for k, v in info.items()))
        t_stage[0] = time.time()

    seqs = [db.read_seq(i) for i in range(db.ureads)]
    tracks.write_track(raw_db, masking.dust_track(seqs, mcfg))
    del seqs
    dust = tracks.read_track(raw_db, "dust")
    done("dust", dust_bp=dust.masked_bp())
    data = [np.zeros(0, np.int32)] * db.ureads
    out["tan_search"] = []
    for b in range(1, db.nblocks + 1):
        blk = block_from_db(db, b)
        st = {}
        t = call("tan", lambda: masking.tandem_track(blk, ocfg, mcfg,
                                                      stats=st, device=dev))
        st["tan_bp"] = t.masked_bp()
        out["tan_search"].append(st)
        for j, rid in enumerate(blk.ids):
            data[int(rid)] = t.data[j]
        del blk
    tracks.write_track(raw_db, tracks.Track("tan", data))
    tan = tracks.read_track(raw_db, "tan")
    done("tan", tan_bp=tan.masked_bp(), tan_search=out["tan_search"])
    st = run_overlap_plan(raw_db, ocfg, verbose=False,
                          mask_names=["dust", "tan"], device=dev, **caps)
    st.pop("pair_stats", None)
    done("overlap1", overlap1=st)
    rlen_of = {i: int(db.reads["rlen"][i]) for i in range(db.ureads)}

    def seqs_of_raw(i, comp):
        s_ = db.read_seq(i)
        return revcomp(s_) if comp else s_

    parts, rt = [], []
    for b in range(1, db.nblocks + 1):
        full = lasmod.read_las(f"{w}/RAW.{b}.las")
        stitched, needs = scrub.stitch_las(full, fuzz=scfg.stitch_fuzz)
        dropped = 0
        if len(needs):
            sub_b = _reads_subset_block(db, stitched, needs, side="b")
            dropped = call("patch_retrace", lambda: ov.retrace_rows(
                stitched, needs, block_from_db(db, b), sub_b, ocfg,
                device=dev))
        rt.append((len(needs), dropped))
        qual, _ = scrub.q_and_trim(stitched, rlen_of, scfg)
        parts.extend(scrub.fix_reads(stitched, seqs_of_raw, rlen_of, qual,
                                     scfg))
        del full, stitched
    write_fasta(f"{w}/FIX.fasta", [f"fixed/{p.src_read}/{p.part}_{len(p.seq)}"
                                   for p in parts], [p.seq for p in parts])
    del parts
    dazzdb.create_db(fix_db, [f"{w}/FIX.fasta"])
    fdb = dazzdb.db_split(fix_db, size_mb=size_mb, cutoff=cutoff)
    done("patch", patch_retrace_needs_dropped=rt, fixed_reads=fdb.ureads,
         fixed_bp=fdb.totlen, fix_blocks=fdb.nblocks)
    st = run_overlap_plan(fix_db, ocfg, verbose=False, device=dev, **caps)
    st.pop("pair_stats", None)
    done("overlap2", overlap2=st)
    frlen = {i: int(fdb.reads["rlen"][i]) for i in range(fdb.ureads)}
    lasmod.merge_las([f"{w}/FIX.{b}.las" for b in range(1, fdb.nblocks + 1)],
                     f"{w}/FIX.merged.las")
    full = lasmod.read_las(f"{w}/FIX.merged.las")
    full.sort()
    stitched, needs = scrub.stitch_las(full, fuzz=scfg.stitch_fuzz)
    del full
    dropped = 0
    if len(needs):
        sub_a = _reads_subset_block(fdb, stitched, needs, side="a")
        sub_b = _reads_subset_block(fdb, stitched, needs, side="b")
        dropped = call("scrub_retrace", lambda: ov.retrace_rows(
            stitched, needs, sub_a, sub_b, ocfg, device=dev))
    idx = {i: i for i in range(fdb.ureads)}
    qual, trim = scrub.q_and_trim(stitched, frlen, scfg)
    breaks = scrub.gap_breaks(stitched, frlen, scfg)
    trim = scrub.gap_trim(trim, breaks, ts=ocfg.tspace)
    tracks.write_track(fix_db, scrub.q_track(qual, fdb.ureads, idx))
    tracks.write_track(fix_db, scrub.trim_track(trim, fdb.ureads, idx))
    stitched = scrub.clip_las_to_trim(stitched, frlen, trim)
    lasmod.write_las(f"{w}/FIX.scrubbed.las", stitched)
    trlen = np.array([max(trim.get(i, (0, frlen[i]))[1]
                          - trim.get(i, (0, frlen[i]))[0], 0)
                      for i in range(fdb.ureads)], np.int64)
    rep = masking.repeat_track_relative(stitched, trlen, idx, fdb.ureads,
                                        mcfg.rep_low, mcfg.rep_high)
    tracks.write_track(fix_db, rep)
    filt = scrub.filter_las(stitched,
                            {i: int(trlen[i]) for i in range(fdb.ureads)},
                            scfg, {i: rep.data[i] for i in range(fdb.ureads)})
    lasmod.write_las(f"{w}/FIX.filtered.las", filt)
    kept = int(((filt.columns.headers[:, 6] & 0x4) == 0).sum())
    done("scrub", scrub_retrace_needs=len(needs),
         scrub_retrace_dropped=dropped, breaks=sum(len(v) for v in breaks.values()),
         scrubbed_records=stitched.novl, filtered_records=filt.novl,
         kept_records=kept, repeats_bp=rep.masked_bp())
    out.update(trlen=trlen, fdb=fdb, db=db)
    return out


def stage_files(w: str) -> list:
    """The files a stage run writes that the card and CPU runs compare."""
    return sorted(f for f in os.listdir(w)
                  if f.endswith((".las", ".anno", ".data", ".fasta"))
                  and not f.startswith("reads"))


def stages_phase(dev, card: str, w: str) -> dict:
    """Phase 9 (see the module docstring) in the empty directory w, which
    the caller removes (phase 10 assembles there first).  Returns the
    phase's numbers and the launches of each kernel in it."""
    from damar_tpu_torch.core.config import MaskConfig, ScrubConfig
    from damar_tpu_torch.formats import tracks
    from damar_tpu_torch.ops.seeding import (REF_TANDEM_HIT_CAP,
                                             REF_TANDEM_SEED_CAP)
    from damar_tpu_torch.pipeline import masking
    t0 = time.time()
    genome = make_genome(GENOME, seed=SEED, n_repeats=STAGE_REPEATS,
                         tandem=STAGE_TANDEMS)
    sim = sample_reads(genome, coverage=COVERAGE, mean_len=MEAN_LEN,
                       err=ERR, seed=SEED + 1)
    total_bp = sum(len(r) for r in sim.reads)
    write_sim_fasta(f"{w}/reads.fasta", sim)
    del sim
    dazzdb.create_db(f"{w}/RAW.db", [f"{w}/reads.fasta"])
    size_mb = -(-total_bp // (STAGE_BLOCKS * 1_000_000))
    db = dazzdb.db_split(f"{w}/RAW.db", size_mb=size_mb, cutoff=500)
    split = [int(db.reads["rlen"][db.block_reads(b)].sum())
             for b in range(1, db.nblocks + 1)]
    log(f"stages: {db.ureads} reads, {total_bp} bp, split at {size_mb} "
        f"Mbp with cutoff 500 into {db.nblocks} blocks of {split} bp; "
        f"reads, FASTA, DB and split {time.time() - t0:.1f} s")
    if db.nblocks != STAGE_BLOCKS:
        raise SystemExit(f"chip_smoke: stages: {db.nblocks} blocks")
    cfgs = (OverlapConfig(), MaskConfig(), ScrubConfig())
    caps = dict(hit_cap=HIT_CAP, seed_cap=SEED_CAP)
    spy = {}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    res = run_stages(w, cfgs, dev, caps, spy=spy)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    missing = [k for k in MAIN_PATH if launches[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels not launched by the "
                         f"stages: {missing}")
    log(f"stages (phases 2-6): wall {wall:.4f} s on {card}; launches "
        f"{launches}")
    # ---- checks: check_las, tracks, mirrors ----
    t0 = time.time()
    db, fdb, trlen = res["db"], res["fdb"], res["trlen"]
    rl, frl = db.reads["rlen"], fdb.reads["rlen"]
    n_las = 0
    for f in sorted(os.listdir(w)):
        if not f.endswith(".las"):
            continue
        lens = trlen if f in ("FIX.scrubbed.las", "FIX.filtered.las") \
            else (rl if f.startswith("RAW") else frl)
        problems = check_las(lasmod.read_las(f"{w}/{f}"), lens)
        if problems:
            raise SystemExit(f"chip_smoke: stages: check_las {f}: "
                             f"{problems[:5]}")
        n_las += 1
    bad = {name: tracks_bad(tracks.read_track(f"{w}/{d}.db", name), L)
           for d, name, L in (("RAW", "dust", rl), ("RAW", "tan", rl),
                              ("FIX", "repeats", trlen))}
    bad["trim"] = tracks_bad(tracks.read_track(f"{w}/FIX.db", "trim"),
                             frl, empty_ok=True)
    if any(bad.values()):
        raise SystemExit(f"chip_smoke: stages: reads with track "
                         f"intervals out of their read or unsorted: "
                         f"{bad}")
    filt = lasmod.read_las(f"{w}/FIX.filtered.las")
    mirror_disc, mirror_none = kept_with_discarded_mirror(filt)
    log(f"stages: check_las clean on {n_las} files; dust, tan, trim and "
        f"repeats intervals in their reads and sorted; filtered file: "
        f"{mirror_disc} kept records whose mirror is discarded, "
        f"{mirror_none} with no mirror ({time.time() - t0:.1f} s)")
    # ---- the spied launches against the plain versions ----
    t0 = time.time()
    paths = {}
    for what, name in (("tan", "bp_extend_kernel"),
                       ("patch_retrace", "wide_trace_kernel"),
                       ("scrub_retrace", "wide_trace_kernel")):
        acc = spy.get(what)
        if acc is None:
            raise SystemExit(f"chip_smoke: stages: no {what} ran")
        paths[what] = dict(kernel=name, launches=acc["launches"][name],
                           ms=round(acc["ms"][name], 4),
                           profiled_launches=acc["profiled"][name])
        log(f"stages, {what}: {name} {acc['launches'][name]} launches "
            f"({acc['profiled'][name]} in the profile), "
            f"{acc['ms'][name]:.4f} ms device time on {card}")
    held = {}
    for what, (name, m) in STAGE_HELD.items():
        calls = spy[what]["calls"].get(name, [])[:m]
        if len(calls) < m:
            raise SystemExit(f"chip_smoke: stages: {what} launched "
                             f"{name} {len(calls)} times")
        held.setdefault(name, []).extend(
            capped(name, a, kw) for a, kw, _ in calls)
    del spy
    hold_launches("stages", held)
    log(f"stages: launches {{name: n}} held equal to their plain "
        f"versions: { {k: len(v) for k, v in held.items()} } "
        f"({time.time() - t0:.1f} s)")
    # ---- fault 3g: the search again under damar_tpu's caps ----
    t0 = time.time()
    ocfg, mcfg, _ = cfgs
    for b in range(1, db.nblocks + 1):
        blk = block_from_db(db, b)
        st = {}
        t = masking.tandem_track(blk, ocfg, mcfg,
                                 hit_cap=REF_TANDEM_HIT_CAP,
                                 seed_cap=REF_TANDEM_SEED_CAP, stats=st,
                                 device=dev)
        sized = res["tan_search"][b - 1]
        log(f"fault 3g, block {b}: sized buffers: total_hits "
            f"{sized['total_hits']}, nhits {sized['nhits']}, seeds "
            f"{sized['nseeds']} of {sized['total_seeds']}, tan bp "
            f"{sized['tan_bp']}; damar_tpu's caps (hit_cap "
            f"{REF_TANDEM_HIT_CAP}, seed_cap {REF_TANDEM_SEED_CAP}): "
            f"nhits {st['nhits']} of "
            f"{st['total_hits']}, seeds {st['nseeds']} of "
            f"{st['total_seeds']}, tan bp {t.masked_bp()}")
        del blk
    log(f"fault 3g runs: {time.time() - t0:.1f} s")
    # ---- a small DB: card == CPU path, file by file ----
    t0 = time.time()
    small = stage_small(dev)
    log(f"stages, small DB: {small} ({time.time() - t0:.1f} s)")
    return dict(launches=launches, wall_s=wall, walls=res["walls"],
                tan_bp=res["tan_bp"], dust_bp=res["dust_bp"],
                kept_records=res["kept_records"],
                filtered_records=res["filtered_records"],
                mirror_discarded=mirror_disc, paths=paths, small=small,
                genome_bp=len(genome))


def stage_small(dev) -> dict:
    """The stages on a small DB of short reads (<= 1,300 bp, 2 blocks of
    1 Mbp), with the length thresholds lowered to fit them, on the card
    and on the CPU path: every .las, track file and FIX.fasta byte-equal.
    """
    from damar_tpu_torch.core.config import MaskConfig, ScrubConfig
    from damar_tpu_torch.formats.fasta import write_fasta
    g = make_genome(400_000, seed=31, n_repeats=4, tandem=8)
    s = sample_reads(g, coverage=6.4, mean_len=900, err=0.10, seed=32)
    reads = [r for r in s.reads if len(r) <= 1300]
    cum = np.cumsum([len(r) for r in reads])
    reads = [r for r, c in zip(reads, cum) if c <= 1_500_000]
    cfgs = (OverlapConfig(min_len=500), MaskConfig(tan_min_len=300),
            ScrubConfig(min_trim_len=500, filter_min_len=500, anchor_min=200))
    dirs = {}
    base = tempfile.mkdtemp(prefix="damar_smoke_small_stages_")
    try:
        for d in (dev, "cpu"):
            w = f"{base}/{'card' if d != 'cpu' else 'cpu'}"
            os.makedirs(w)
            write_fasta(f"{w}/reads.fasta",
                        [f"r{i}" for i in range(len(reads))], reads)
            dazzdb.create_db(f"{w}/RAW.db", [f"{w}/reads.fasta"])
            dazzdb.db_split(f"{w}/RAW.db", size_mb=1, cutoff=500)
            dirs[str(d)] = (w, run_stages(w, cfgs, d, {}, log_walls=False))
        (wc, rc), (wp, rp) = dirs[str(dev)], dirs["cpu"]
        names = stage_files(wc)
        if names != stage_files(wp):
            raise SystemExit("chip_smoke: small stages: the file lists "
                             "differ")
        for f in names:
            if not filecmp.cmp(f"{wc}/{f}", f"{wp}/{f}", shallow=False):
                raise SystemExit(f"chip_smoke: small stages: {f} differs "
                                 f"between the card and the CPU path")
        if rc["tan_bp"] <= 0 or rc["kept_records"] <= 0:
            raise SystemExit(f"chip_smoke: small stages: tan bp "
                             f"{rc['tan_bp']}, kept {rc['kept_records']}")
        return dict(files=len(names), blocks=rc["db"].nblocks,
                    tan_bp=rc["tan_bp"], kept=rc["kept_records"],
                    card_s=sum(rc["walls"].values()),
                    cpu_s=sum(rp["walls"].values()))
    finally:
        shutil.rmtree(base, ignore_errors=True)


def read_contigs(w: str) -> list:
    from damar_tpu_torch.formats.fasta import read_fasta
    return read_fasta(os.path.join(w, "CONTIGS.fasta"))[1]


def edges_by_mirror(g, las) -> tuple[int, int]:
    """(edges with no twin, edges whose read pair has a kept record one
    way and none the other: their mirror record was discarded, fault
    3i), over the live and reduced edges of a string graph built from
    the filtered file `las`.  The graph synthesizes each edge's twin
    from the same record, so the first count stays 0 where the second
    does not."""
    h = las.columns.headers
    live = (h[:, lasmod.H_FLAGS] & 0x4) == 0
    kept = set(zip(h[live, lasmod.H_AREAD].tolist(),
                   h[live, lasmod.H_BREAD].tolist()))
    edges = [e for v in list(g.edges) for e in g.edges[v]]
    no_twin = sum(1 for e in edges if g.twin_of(e) is None)
    gone = sum(1 for e in edges
               if ((e.src.read, e.dst.read) in kept)
               != ((e.dst.read, e.src.read) in kept))
    return no_twin, gone


def assemble_stages(w: str, dev, card: str, genome_bp: int) -> dict:
    """Phase 10a: run_pipeline(polish=False) on phase 9's workdir, which
    holds run.py's own files, so it resumes at phase 7 (the string graph
    and the tour).  Gate: a contig, and contigs summing to >= 85% of the
    genome."""
    from damar_tpu_torch.pipeline import touring
    from damar_tpu_torch.pipeline.contigs import assembly_stats
    from damar_tpu_torch.pipeline.run import run_pipeline
    seen = {}
    real = touring.assemble

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen["graph"] = out[2]
        return out
    touring.assemble = spy
    try:
        t0 = time.time()
        rep = run_pipeline(f"{w}/reads.fasta", w, polish=False,
                           verbose=False, device=dev)
        wall = time.time() - t0
    finally:
        touring.assemble = real
    g = seen["graph"]
    sided = edges_by_mirror(g, lasmod.read_las(f"{w}/FIX.filtered.las"))
    verts = {x for es in g.edges.values() for e in es
             for x in (e.src, e.dst)}
    n_all = sum(len(es) for es in g.edges.values())
    lens = [len(c) for c in read_contigs(w)]
    stats = assembly_stats(lens, genome_bp)
    ph = rep["phases"]
    out = dict(vertices=len(verts), edges=n_all, live_edges=g.n_edges(),
               one_sided_edges=sided[0], edges_mirror_discarded=sided[1],
               contained_reads=len(g.contained), contigs=len(lens),
               lengths=lens[:10], stats=stats,
               phase7_wall_s=ph["assemble"]["wall_s"], wall_s=wall,
               skipped=[ph["overlap1"]["skipped"], ph["overlap2"]["skipped"]])
    log(f"phase 10a, phase 7 on the stages unit: {out} on {card}")
    if not lens or stats["total_bp"] < 0.85 * genome_bp:
        raise SystemExit(f"chip_smoke: phase 10a: contigs {lens[:10]} "
                         f"sum to {stats['total_bp']} of {genome_bp} bp")
    if ph["overlap1"]["pairs"] or ph["overlap2"]["pairs"]:
        raise SystemExit("chip_smoke: phase 10a did not resume at phase 7")
    return out


class FirstLaunch:
    """While a path runs: K4's launches, the DP cells of all of them (for
    the bound), each one's device time (a pair of CUDA events around the
    kernel alone), per class (narrow pairs a warp each, wide pairs a block
    each) the pairs, cells and blocks from each launch's host plan, and
    the arguments of the first launch and of the first launch with wide
    pairs, each capped at CAP pairs; the launches go through unchanged.
    (A torch.profiler window over the whole assembly took ~140 s to read
    back on the H100's host, more than the assembly's own phase 7.)"""

    def __init__(self):
        self.first = self.first_wide = None
        self.cells = self.calls = 0
        self.classes = {c: dict(pairs=0, cells=0, blocks=0)
                        for c in ("narrow", "wide")}

    def __enter__(self):
        self.orig = band_align._launch
        self.events = []
        band_align.band_align.events = self.events

        def spy(*a, **kw):
            n0 = band_align.band_align.launches
            out = self.orig(*a, **kw)
            if band_align.band_align.launches != n0:
                plan, semi = a[5], a[7]
                self.cells += int(plan.cells.sum())
                self.calls += 1
                for c, sel, nb in (("narrow", ~plan.wide, plan.blocks[0]),
                                   ("wide", plan.wide, plan.blocks[1])):
                    k = self.classes[c]
                    k["pairs"] += int(sel.sum())
                    k["cells"] += int(plan.cells[sel].sum())
                    k["blocks"] += nb
                args = ((*a[:5], semi), {})
                if self.first is None:
                    self.first = capped(K4, *args)
                if self.first_wide is None and plan.n_wide:
                    self.first_wide = capped(K4, *args)
            return out
        band_align._launch = spy
        return self

    def __exit__(self, *exc):
        band_align._launch = self.orig
        band_align.band_align.events = None
        return False

    def device_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in self.events)


class HostTimers:
    """Host wall of each call of the named functions of a module while
    the block runs (summed per name)."""

    def __init__(self, mod, names):
        self.mod, self.names, self.s = mod, names, {n: 0.0 for n in names}

    def __enter__(self):
        self.orig = {n: getattr(self.mod, n) for n in self.names}
        for n, fn in self.orig.items():
            def timed(*a, _fn=fn, _n=n, **kw):
                t0 = time.time()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.s[_n] += time.time() - t0
            setattr(self.mod, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)
        return False


def assembly_phase(dev, card: str, sass: dict) -> dict:
    """Phase 10b: the whole pipeline with polish, from FASTA (see the
    module docstring).  Returns the phase's numbers, each kernel's
    launches in it and K4's first launch (capped) for the timing row."""
    from damar_tpu_torch.core.config import PipelineConfig
    from damar_tpu_torch.pipeline import consensus
    from damar_tpu_torch.pipeline.contigs import assembly_stats
    from damar_tpu_torch.pipeline.run import run_pipeline
    from damar_tpu_torch.utils.sim import kmer_hit_rate
    w = tempfile.mkdtemp(prefix="damar_smoke_assembly_")
    try:
        t0 = time.time()
        genome = make_genome(ASM_GENOME, seed=ASM_SEED,
                             n_repeats=ASM_REPEATS, repeat_len=1500,
                             tandem=ASM_TANDEMS, tandem_period=90,
                             tandem_len=1800)
        sim = sample_reads(genome, coverage=COVERAGE, mean_len=MEAN_LEN,
                           err=ERR, seed=ASM_SEED + 1, chimera_frac=0.06)
        total_bp = sum(len(r) for r in sim.reads)
        write_sim_fasta(f"{w}/reads.fasta", sim)
        n_chim = int(sim.chimeric.sum())
        del sim
        block_mb = -(-total_bp // 2_000_000)
        cfg = PipelineConfig(block_mb=block_mb)
        log(f"assembly: {len(genome)} bp genome, {total_bp} bp of reads "
            f"({n_chim} chimeric), block_mb {block_mb}; setup "
            f"{time.time() - t0:.1f} s")
        reset_launches()
        torch.cuda.synchronize()
        with FirstLaunch() as k4, HostTimers(consensus, (
                "correct_reads", "polish_rounds",
                "finish_polish_raw_multi")) as timers:
            t0 = time.time()
            rep = run_pipeline(f"{w}/reads.fasta", w, cfg, polish=True,
                               verbose=False, device=dev)
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = read_launches()
        k4_ms = k4.device_ms()
        if len(k4.events) != launches[K4]:
            raise SystemExit(f"chip_smoke: {len(k4.events)} K4 launches "
                             f"timed, {launches[K4]} counted")
        contigs = read_contigs(w)
        lens = [len(c) for c in contigs]
        longest = max(contigs, key=len) if contigs else np.zeros(0)
        hit = kmer_hit_rate(genome, longest)
        stats = assembly_stats(lens, len(genome))
        ph = rep["phases"]
        walls = {k: v["wall_s"] for k, v in ph.items()}
        bms, by = bound(k4.cells * k4_ops_per_cell(sass), k4.cells // 4)
        mean_k4 = k4_ms / max(launches[K4], 1)
        out = dict(genome_bp=len(genome), reads_bp=total_bp,
                   blocks=ph["ingest"]["blocks"], block_mb=block_mb,
                   wall_s=wall, phase_walls=walls,
                   assemble_split_s={k: round(v, 4)
                                     for k, v in timers.s.items()},
                   contigs=len(lens), lengths=lens[:10], stats=stats,
                   longest_kmer_hit_rate=hit, chimeric_reads=n_chim,
                   k4=dict(launches=launches[K4], device_ms=k4_ms,
                           mean_launch_ms=mean_k4, cells=k4.cells,
                           bound_ms=bms, bound_by=by,
                           bound_share=bms / k4_ms if k4_ms else None,
                           classes=k4.classes))
        log(f"phase 10b, the whole pipeline with polish: {out} on {card}")
        missing = [k for k in MAIN_PATH + (K4,) if launches[k] <= 0]
        if missing:
            raise SystemExit(f"chip_smoke: kernels not launched by the "
                             f"assembly: {missing}")
        if not lens or stats["total_bp"] < 0.85 * len(genome):
            raise SystemExit(f"chip_smoke: phase 10b: contigs {lens[:10]} "
                             f"sum to {stats['total_bp']} of {len(genome)}")
        if hit <= 0.45:
            raise SystemExit(f"chip_smoke: phase 10b: the longest contig's "
                             f"k-mer hit rate {hit:.4f} <= 0.45")
        t0 = time.time()
        polished = cli_polish(w, genome, card)
        log(f"phase 12b: {time.time() - t0:.1f} s")
        return dict(out, launches=launches, first=k4.first,
                    first_wide=k4.first_wide, cli_polish=polished)
    finally:
        shutil.rmtree(w, ignore_errors=True)


def assembly_tiny(dev) -> dict:
    """Phase 10c: run_pipeline(polish=True) on the 12 kbp genome of the
    CPU tests, on the card and on the CPU path: CONTIGS.fasta, every .las,
    track and FIX.fasta byte-equal, report.json equal but for its walls
    and paths.  Then phases 12c and 12d there (the `pipeline` tool, and a
    rendered line in fresh processes); their numbers under "cli"."""
    from damar_tpu_torch.core.config import PipelineConfig
    from damar_tpu_torch.pipeline.run import run_pipeline
    g = make_genome(12_000, seed=81)
    sim = sample_reads(g, coverage=10, mean_len=2500, err=0.13, seed=82)
    cfg = PipelineConfig(block_mb=1, min_read_len=500)
    base = tempfile.mkdtemp(prefix="damar_smoke_tiny_asm_")
    try:
        reps, walls = {}, {}
        for d in (dev, "cpu"):
            w = f"{base}/{'card' if d != 'cpu' else 'cpu'}"
            os.makedirs(w)
            write_sim_fasta(f"{w}/reads.fasta", sim)
            t0 = time.time()
            reps[w] = run_pipeline(f"{w}/reads.fasta", w, cfg, polish=True,
                                   verbose=False, device=d)
            walls[str(d)] = time.time() - t0
        (wc, rc), (wp, rp) = reps.items()
        names = stage_files(wc)
        if names != stage_files(wp) or "CONTIGS.fasta" not in names:
            raise SystemExit("chip_smoke: tiny assembly: the file lists "
                             "differ")
        for f in names:
            if not filecmp.cmp(f"{wc}/{f}", f"{wp}/{f}", shallow=False):
                raise SystemExit(f"chip_smoke: tiny assembly: {f} differs "
                                 f"between the card and the CPU path")

        def strip(r):
            r = json.loads(json.dumps(r))
            r.pop("total_wall_s")
            r.pop("contig_fasta")
            for v in r["phases"].values():
                v.pop("wall_s")
            return r
        if strip(rc) != strip(rp):
            raise SystemExit("chip_smoke: tiny assembly: report.json "
                             "differs between the card and the CPU path")
        t0 = time.time()
        piped = cli_pipeline(base, wc)
        log(f"phase 12c: {time.time() - t0:.1f} s")
        t0 = time.time()
        fresh = cli_fresh(base, wc)
        log(f"phase 12d: {time.time() - t0:.1f} s")
        return dict(cli=dict(pipeline=piped, fresh=fresh), files=len(names),
                    contigs=rc["phases"]["assemble"]["contigs"],
                    lengths=rc["phases"]["assemble"]["lengths"],
                    card_s=walls[str(dev)], cpu_s=walls["cpu"])
    finally:
        shutil.rmtree(base, ignore_errors=True)


def k4_row(asm: dict, errs: dict, sass: dict, card: str) -> tuple:
    """K4's row of the kernels line from phase 10b's results: its first
    launch there (capped) held against band_align_plain and timed, its
    launches, device time and bound over the assembly.  Pops the first
    launch, K4's numbers and the launches from asm; returns (row, each
    kernel's launches in the assembly)."""
    first, first_wide = asm.pop("first"), asm.pop("first_wide")
    if first is None or first_wide is None:
        raise SystemExit("chip_smoke: no K4 launch (or none with wide "
                         "pairs) was kept")
    # the first launch with wide pairs (a polish window), held against
    # plain; then the first launch (correct_reads: narrow pairs), held
    # and timed
    a, k = first_wide
    e = max_abs_err(band_align.band_align_kernel(*a, **k),
                    band_align.band_align_plain(*a, **k))
    errs[K4] = max(errs[K4], e)
    log(f"{K4}, first assembly launch with wide pairs ({a[4].shape[0]} "
        f"pairs, bands {sorted(set(a[4].tolist()))}): max_abs_err {e}")
    a, k = first
    out = band_align.band_align_kernel(*a, **k)
    e = max_abs_err(out, band_align.band_align_plain(*a, **k))
    errs[K4] = max(errs[K4], e)
    bms, by = bound(*work(K4, a, k, out, sass)[1:])
    ms = kernel_ms(K4, lambda: band_align.band_align_kernel(*a, **k), 5)
    plain_ms = cuda_ms(lambda: band_align.band_align_plain(*a, **k), 1)
    log(f"{K4}, first assembly launch ({a[4].shape[0]} pairs): kernel "
        f"{ms:.4f} ms device time, bound {bms:.4f} ms ({by}), plain "
        f"{plain_ms:.4f} ms, max_abs_err {e} on {card}")
    if errs[K4]:
        raise SystemExit("chip_smoke: K4 disagrees with its plain version "
                         "at the assembly's shapes")
    k4 = asm.pop("k4")
    launches = asm.pop("launches")
    row = dict(
        name=K4, route="cuda", source=KERNELS[K4][4],
        replaces=KERNELS[K4][5], launches=k4["launches"],
        max_abs_err=errs[K4], ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        bound_ms=round(bms, 4), bound_by=by, library_ms=None,
        library="none: no PyTorch call computes a banded edit alignment "
                "with traceback",
        pass_ms=round(k4["device_ms"], 4),
        pass_bound_ms=round(k4["bound_ms"], 4), pass_bound_by=k4["bound_by"],
        bound_share=(round(k4["bound_share"], 4) if k4["bound_share"]
                     else None),
        pass_rows=k4["cells"], sweep_launches=0, stage_launches=0,
        assembly_launches=launches[K4], assembly_classes=k4["classes"],
        note="launches, pass_ms, pass_bound_ms and bound_share are the "
             "whole assembly of phase 10b (pass_rows: its DP cells; "
             "pass_ms by CUDA events around each launch; "
             "assembly_classes: pairs, DP cells and blocks per class); "
             "ms, plain_ms, bound_ms its first launch there, capped (ms "
             "under torch.profiler)")
    return row, launches


# ---------------------------------------------------------------------------
# Phase 11: the pipeline's default block (PipelineConfig.block_mb = 200 Mbp)
# ---------------------------------------------------------------------------

# the default-block DB: the sweep unit's reads split at block_mb, a block of
# ~200 Mbp and one of ~2.8 Mbp; its genome from the same seed with tandem
# arrays planted at the stages' density (20 in 2.5 Mbp), so that the
# datander search finds seeds (the reads keep their lengths and the split)
DEFAULT_BLOCKS, DEFAULT_TANDEMS = 2, 80
# the legacy unit: large-50Mbp's reads and LEGACY_LONG reads of
# LEGACY_LONG_BP cut from its genome and mutated at its error (seed
# LEGACY_SEED): 14 read bits + 18 position bits + the strand = 33 bits
LEGACY_LONG, LEGACY_LONG_BP, LEGACY_SEED = 8, 150_000, 2026
# the first launch of each kernel held against its plain version on the
# legacy and -b passes
FIRST_HELD = {"bp_extend_kernel": 1, "bp_trace_kernel": 1,
              "wide_trace_kernel": 1}
# the seeding's slice threshold set in-process below the small pairs'
# hits (11f's forced slices)
FORCE_SLICING = 1 << 10
# phase 11f's genome: half of phase 7's, so that the CPU path's runs of
# its three settings (6 pairs) fit the script's time limit
FORCED_GENOME = 30_000


def hold_first(where: str, spy: Spy, keep: dict) -> dict:
    """The first keep[k] launches of each kernel k that `spy` kept,
    capped at CAP items, held against their plain versions."""
    held = {k: [capped(k, a, kw) for a, kw, _ in spy.calls[k][:m]]
            for k, m in keep.items()}
    n = {k: len(v) for k, v in held.items()}
    if any(n[k] < m for k, m in keep.items()):
        raise SystemExit(f"chip_smoke: {where}: launched {n}, wanted {keep}")
    hold_launches(where, held)
    return n


def timed(dev, fn):
    """(fn(), wall s, peak device bytes) of fn() with the counts at 0 and
    the peak reset just before it; `read_launches()` after is its
    launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, torch.cuda.max_memory_allocated(dev)


def default_tracks(w: str, db, dev, card: str) -> dict:
    """Phase 11a: the dust track of the default-block DB and the tan
    track of each block (the datander search at every default, its
    buffers sized from the counts); block 1's search numbers and its
    first K1 launch held against extend_bp_plain."""
    from damar_tpu_torch.core.config import MaskConfig
    from damar_tpu_torch.formats import tracks
    from damar_tpu_torch.pipeline import masking
    ocfg, mcfg, path = OverlapConfig(), MaskConfig(), f"{w}/D.db"
    t0 = time.time()
    seqs = [db.read_seq(i) for i in range(db.ureads)]
    tracks.write_track(path, masking.dust_track(seqs, mcfg))
    del seqs
    out = dict(dust_s=round(time.time() - t0, 4),
               dust_bp=tracks.read_track(path, "dust").masked_bp())
    log(f"default block: dust track of {db.ureads} reads {out['dust_s']} s "
        f"(host), {out['dust_bp']} bp")
    data = [np.zeros(0, np.int32)] * db.ureads
    for b in range(1, db.nblocks + 1):
        blk = block_from_db(db, b)
        st = {}
        with Spy(keep={"bp_extend_kernel": 1}) as spy:
            trk, wall, peak = timed(dev, lambda: masking.tandem_track(
                blk, ocfg, mcfg, stats=st, device=dev))
        launches = read_launches()
        for j, rid in enumerate(blk.ids):
            data[int(rid)] = trk.data[j]
        log(f"default block {b} ({blk.nbases} bp, cap {blk.cap}): tan search "
            f"wall {wall:.4f} s, total_hits {st['total_hits']} in "
            f"{st['pieces']} range(s) of reads ({'split' if st['pieces'] > 1 else 'unsplit'}, "
            f"largest hit buffer {st['hit_buffer']}), seeds {st['nseeds']} "
            f"of {st['total_seeds']}, extents {st['extents']}, tan bp "
            f"{trk.masked_bp()}, peak device memory {peak / 2**30:.2f} GiB "
            f"({peak} B), launches {launches} on {card}")
        if b == 1:
            out.update(tan_wall_s=round(wall, 4), tan_peak_bytes=peak,
                       tan_launches=launches, tan_split=st["pieces"] > 1,
                       **{f"tan_{k}": v for k, v in st.items()})
            if launches["bp_extend_kernel"] <= 0:
                raise SystemExit("chip_smoke: default block 1's tandem "
                                 "search launched no K1")
            hold_first("default block 1 tandem search", spy,
                       {"bp_extend_kernel": 1})
        del blk, spy
    tracks.write_track(path, tracks.Track("tan", data))
    bad = tracks_bad(tracks.read_track(path, "tan"), db.reads["rlen"])
    if bad:
        raise SystemExit(f"chip_smoke: default block: {bad} reads with tan "
                         f"intervals out of their read or unsorted")
    out["tan_bp"] = tracks.read_track(path, "tan").masked_bp()
    return out


def default_plan(w: str, db, dev, card: str) -> dict:
    """Phase 11b: run.py's overlap1 on the default-block DB, composed as
    run_stages composes it: run_overlap_plan over its 3 pairs with the
    dust and tan masks, every default (hit_cap and seed_cap None).  The
    self pair of block 1 must be seeded by slices; check_las clean and
    sorted on the merged files, every record with its mirror, a second
    run skipping every pair, the self pair's first PAIR_HELD launches
    equal to their plain versions.  Returns the numbers."""
    ocfg, rlen = OverlapConfig(), db.reads["rlen"]
    with Spy(keep=PAIR_HELD) as spy:
        stats, wall, peak = timed(dev, lambda: run_overlap_plan(
            f"{w}/D.db", ocfg, verbose=False, mask_names=["dust", "tan"],
            device=dev))
    launches = read_launches()
    pair_stats = stats.pop("pair_stats")
    if stats["pairs"] != 3 or stats["skipped"]:
        raise SystemExit(f"chip_smoke: default block plan ran {stats}")
    missing = [k for k in MAIN_PATH if launches[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels not launched by the default "
                         f"block plan: {missing}")
    first = pair_stats[0]
    if first["pair"] != "overlap.1.1" or first["seed_path"] != "sliced":
        raise SystemExit(f"chip_smoke: default block: the first pair "
                         f"{first['pair']} was seeded on the "
                         f"{first['seed_path']} path, not by slices")
    keys = ("seed_path", "seed_slices", "seed_runs", "total_hits",
            "total_seeds", "seeds", "extents", "kept", "t_seed", "t_extend",
            "t_dedupe", "t_pool", "t_trace", "t_trace_main",
            "t_trace_retry", "t_trace_final", "trace_retries",
            "dropped_trace")
    for p in pair_stats:
        log(f"  {p['pair']}: " + ", ".join(f"{k} {p[k]}" for k in keys
                                           if k in p))
    merged = [lasmod.read_las(f"{w}/D.{i}.las")
              for i in range(1, db.nblocks + 1)]
    for i, m in enumerate(merged, 1):
        problems = check_las(m, rlen)
        if problems:
            raise SystemExit(f"chip_smoke: default block: check_las "
                             f"D.{i}.las: {problems[:5]}")
    novl = sum(m.novl for m in merged)
    spans = sum(int(m.a_spans().sum()) for m in merged)
    lost = mirrors_missing(merged, rlen)
    del merged
    if novl <= 0 or novl % 2 or lost:
        raise SystemExit(f"chip_smoke: default block: {novl} merged "
                         f"records, {lost} without their mirror")
    again = run_overlap_plan(f"{w}/D.db", ocfg, verbose=False,
                             mask_names=["dust", "tan"], device=dev)
    if again["pairs"] or again["skipped"] != 3:
        raise SystemExit(f"chip_smoke: default block: the second run "
                         f"recomputed pairs: {again}")
    aligned = spans // 2
    log(f"default block plan (run_overlap_plan, 3 pairs, dust + tan "
        f"masks, every default): wall {wall:.4f} s, aligned bp {aligned}, "
        f"{aligned / wall / 1e9:.4f} Gbp-aligned/s/gpu, {novl} merged "
        f"records (check_las clean and sorted, each with its mirror; "
        f"second run skipped {again['skipped']}), peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} B), launches {launches} on {card}")
    held = hold_first("default block self pair", spy, PAIR_HELD)
    del spy
    return dict(wall_s=round(wall, 4), aligned_bp=aligned, records=novl,
                peak_bytes=peak, launches=launches, pairs=[
                    {k: p[k] for k in ("pair",) + keys if k in p}
                    for p in pair_stats], held=held)


def legacy_and_bias(dev, card: str) -> dict:
    """Phases 11d and 11e on large-50Mbp: a cold unbiased pass (the
    packed path's counts), a warm pass with OverlapConfig(bias=True)
    (-b), then the legacy unit's self pair (LEGACY_LONG reads of
    LEGACY_LONG_BP added: a 33-bit payload), each with check_las clean
    and its first K1, K2 and K3 launches held against their plain
    versions.  Returns the numbers."""
    from damar_tpu_torch.ops import seeding
    g = make_genome(GENOME, seed=SEED)
    reads = sample_reads(g, coverage=COVERAGE, mean_len=MEAN_LEN, err=ERR,
                         seed=SEED + 1).reads
    blk = block_from_reads(reads)
    out = {}

    def one(label, b, cfg, spy=None):
        (la, _, st), wall, peak = timed(dev, lambda: ov.overlap_block_pair(
            b, b, cfg, True, emit_mirrors=False, device=dev))
        launches = read_launches()
        problems = check_las(la, b.rlen)
        if problems or la.novl <= 0:
            raise SystemExit(f"chip_smoke: {label}: {la.novl} records, "
                             f"check_las {problems[:5]}")
        aligned = int(la.a_spans().sum())
        r = dict(path=st["seed_path"], total_hits=st["total_hits"],
                 total_seeds=st["total_seeds"], seeds=st["seeds"],
                 overlaps=la.novl, aligned_bp=aligned, wall_s=round(wall, 4),
                 peak_bytes=peak, t_seed=st["t_seed"],
                 seed_runs=st["seed_runs"], launches=launches)
        log(f"{label}: " + ", ".join(f"{k} {v}" for k, v in r.items())
            + f"; check_las clean on {card}")
        return r

    out["packed"] = one("large-50Mbp, cold, unbiased", blk, OverlapConfig())
    with Spy(keep=FIRST_HELD) as spy:
        out["bias"] = one("large-50Mbp, warm, -b (bias=True)", blk,
                          OverlapConfig(bias=True))
    out["bias_equals_unbiased"] = all(
        out["bias"][k] == out["packed"][k]
        for k in ("total_seeds", "seeds", "overlaps", "aligned_bp"))
    out["bias_held"] = hold_first("large-50Mbp -b pass", spy, FIRST_HELD)
    del spy
    rng = np.random.default_rng(LEGACY_SEED)
    starts = rng.integers(0, len(g) - LEGACY_LONG_BP, LEGACY_LONG)
    long = [mutate(g[s:s + LEGACY_LONG_BP], ERR, rng) for s in starts]
    lblk = block_from_reads(list(reads) + long)
    bits = seeding.payload_bits(lblk)
    if sum(bits) + 1 <= 32:
        raise SystemExit(f"chip_smoke: legacy unit payload {bits}")
    with Spy(keep=FIRST_HELD) as spy:
        out["legacy"] = one(f"legacy-50Mbp ({lblk.nreads} reads, the "
                            f"longest {int(lblk.rlen.max())} bp, payload "
                            f"{bits[0]} + {bits[1]} + 1 bits), cold", lblk,
                            OverlapConfig())
    if out["legacy"]["path"] != "legacy" or out["packed"]["path"] != "packed":
        raise SystemExit(f"chip_smoke: the legacy unit was seeded on the "
                         f"{out['legacy']['path']} path, large-50Mbp on the "
                         f"{out['packed']['path']} path")
    out["legacy_held"] = hold_first("legacy-50Mbp pair", spy, FIRST_HELD)
    return out


def forced_small_pairs(dev) -> dict:
    """Phase 11f: small pairs (phase 7's reads over a genome of
    FORCED_GENOME) on the card == the CPU path with the sliced path
    forced (_SLICE_CAP lowered) and with the legacy path forced
    (packed_payload_host returning None), and with -b on reads over an
    AT-rich genome (40% A, 10% C, 10% G, 40% T), where the weights differ
    from one base to another (on a uniform genome they are all 256 and
    change no seed)."""
    from damar_tpu_torch.ops import seeding
    reads = small_reads(make_genome(FORCED_GENOME, seed=11))
    at = np.random.default_rng(77).choice(
        4, FORCED_GENOME, p=[0.4, 0.1, 0.1, 0.4]).astype(np.uint8)
    out = {"bias_at_rich": card_equals_cpu(
        dev, small_reads(at), OverlapConfig(bias=True), what="-b AT-rich ")}
    old_cap, old_payload = seeding._SLICE_CAP, seeding.packed_payload_host
    try:
        seeding._SLICE_CAP = FORCE_SLICING
        out["sliced"] = card_equals_cpu(dev, reads, OverlapConfig(),
                                        path="sliced", what="forced sliced ")
        seeding._SLICE_CAP = old_cap
        seeding.packed_payload_host = lambda blk: None
        out["legacy"] = card_equals_cpu(dev, reads, OverlapConfig(),
                                        path="legacy", what="forced legacy ")
    finally:
        seeding._SLICE_CAP, seeding.packed_payload_host = (old_cap,
                                                           old_payload)
    return out


def default_block_phase(dev, card: str) -> dict:
    """Phase 11 (see the module docstring).  Returns its numbers and the
    launches of each kernel per path (tan, plan, bias, legacy)."""
    from damar_tpu_torch.core.config import PipelineConfig
    w = tempfile.mkdtemp(prefix="damar_smoke_default_block_")
    try:
        t0 = time.time()
        sim = sample_reads(make_genome(GENOME_SWEEP, seed=SEED,
                                       tandem=DEFAULT_TANDEMS),
                           coverage=COVERAGE, mean_len=MEAN_LEN, err=ERR,
                           seed=SEED + 1)
        write_sim_fasta(f"{w}/reads.fasta", sim)
        del sim
        dazzdb.create_db(f"{w}/D.db", [f"{w}/reads.fasta"])
        db = dazzdb.db_split(f"{w}/D.db", size_mb=PipelineConfig().block_mb,
                             cutoff=0)
        split = [int(db.reads["rlen"][db.block_reads(b)].sum())
                 for b in range(1, db.nblocks + 1)]
        log(f"default block: {db.ureads} reads split at "
            f"{PipelineConfig().block_mb} Mbp into {db.nblocks} blocks of "
            f"{split} bp, the longest read {int(db.reads['rlen'].max())} bp; "
            f"reads, FASTA, DB and split {time.time() - t0:.1f} s")
        if db.nblocks != DEFAULT_BLOCKS:
            raise SystemExit(f"chip_smoke: default block: {db.nblocks} "
                             f"blocks")
        t0 = time.time()
        res = dict(blocks_bp=split, tracks=default_tracks(w, db, dev, card))
        log(f"phase 11a: {time.time() - t0:.1f} s")
        t0 = time.time()
        res["plan"] = default_plan(w, db, dev, card)
        log(f"phase 11b: {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(w, ignore_errors=True)
    t0 = time.time()
    res["passes"] = legacy_and_bias(dev, card)
    log(f"phases 11d, 11e: {time.time() - t0:.1f} s")
    t0 = time.time()
    res["small_pairs"] = forced_small_pairs(dev)
    log(f"phase 11f: {time.time() - t0:.1f} s")
    res["launches"] = dict(tan=res["tracks"].pop("tan_launches"),
                           plan=res["plan"].pop("launches"),
                           bias=res["passes"]["bias"].pop("launches"),
                           legacy=res["passes"]["legacy"].pop("launches"))
    return res


# ---------------------------------------------------------------------------
# Phase 14: the bench twin's quick config as a child process, run as a user
# runs it; the kernel library is already built, so it is loaded, not built
# ---------------------------------------------------------------------------
BENCH_TIMEOUT = 300


def bench_phase(card: str) -> dict:
    """Phase 14 (see the module docstring): the bench twin's value,
    process wall and the launches of its timed pass."""
    argv = [sys.executable, "-m", "damar_tpu_torch.tools.bench", "--quick"]
    t0 = time.time()
    try:
        r = subprocess.run(argv, cwd=Path(__file__).resolve().parent,
                           capture_output=True, text=True,
                           timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise SystemExit(f"chip_smoke: phase 14: the bench ran past "
                         f"{BENCH_TIMEOUT} s")
    wall = time.time() - t0
    for ln in r.stderr.splitlines():
        if ln.startswith("# ["):
            log(f"  {ln}")
    if r.returncode:
        raise SystemExit(f"chip_smoke: phase 14: the bench exited "
                         f"{r.returncode}: {r.stderr[-2000:]}")
    try:
        rec = json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        raise SystemExit(f"chip_smoke: phase 14: the bench's last line is "
                         f"no JSON object: {r.stdout[-400:]!r}")
    dev = rec.get("device") or {}
    launches = rec.get("launches") or {}
    bad = [k for k, ok in (
        ("provenance", rec.get("provenance") == "measured-on-gpu"),
        ("device name", dev.get("name") == card.split(",")[0].strip()),
        ("device count", dev.get("count") == torch.cuda.device_count()),
        ("config", rec.get("config") == "quick-10Mbp"),
        ("value", (rec.get("value") or 0) > 0),
        ("launches", all(launches.get(k, 0) > 0 for k in MAIN_PATH)))
        if not ok]
    if bad:
        raise SystemExit(f"chip_smoke: phase 14: the bench's line fails "
                         f"{bad}: {rec}")
    log(f"phase 14, the bench twin ({' '.join(argv[1:])}): "
        f"{rec['value']:.4f} Gbp-aligned/s/gpu ({rec['config']}), process "
        f"{wall:.1f} s, launches in a timed pass {launches} on {card}")
    return dict(value=rec["value"], wall_s=round(wall, 1),
                launches=launches, line=rec)


# ---------------------------------------------------------------------------
# Phase 12: the command-line toolbox (damar_tpu_torch.cli), in-process with
# DAMAR_PLATFORM unset (the card), then as fresh processes
# ---------------------------------------------------------------------------

# the first launch of each kernel in phase 12a held against its plain
# version (K4's, lashow -a's one launch, through FirstLaunch)
CLI_HELD = {"bp_extend_kernel": 1, "bp_trace_kernel": 1,
            "wide_trace_kernel": 1}


def cli_same_as_stages(nblocks: int) -> list:
    """The files phase 12a's dbdust, datander and overlap-all write that
    phase 9 wrote through the API with the same settings (the tools'
    defaults are phase 9's MaskConfig() and OverlapConfig(); phase 9's
    explicit seeding caps change no byte, port fault 2): the tracks, every
    pair's file and every merged file."""
    r = range(1, nblocks + 1)
    return ([f".RAW.{t}.{e}" for t in ("dust", "tan") for e in ("anno",
                                                                 "data")]
            + [f"RAW.{i}.RAW.{j}.las" for i in r for j in r]
            + [f"RAW.{i}.las" for i in r])


def cli(argv: list, walls: dict, name: str | None = None) -> str:
    """damar_tpu_torch.cli.main(argv) in this process: returns its stdout
    and puts its wall in walls[name or argv[0]]; exits unless the tool
    returned 0."""
    from damar_tpu_torch import cli as cli_mod
    buf = io.StringIO()
    code = 0
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        try:
            cli_mod.main([str(a) for a in argv])
        except SystemExit as e:
            code = e.code or 0
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    walls[name or argv[0]] = round(time.time() - t0, 4)
    if code:
        raise SystemExit(f"chip_smoke: phase 12: `{' '.join(argv)}` exited "
                         f"{code}: {buf.getvalue()[-400:]}")
    return buf.getvalue()


def same_contigs(a: str, b: str) -> bool:
    """The same contig sequences in two FASTA files, in any order."""
    from damar_tpu_torch.formats.fasta import read_fasta
    key = lambda p: sorted(s.tobytes() for s in read_fasta(p)[1])  # noqa: E731
    return key(a) == key(b)


def cli_stages(w: str, card: str) -> dict:
    """Phase 12a: the README's sequence of tools and more on a copy of
    phase 9's DB (w/RAW.db: dbstats, hpc-plan, dbdust, datander, overlap-all
    -m dust -m tan, lacheck on every merged file, lashow, lashow -a,
    lastitch -b 1, laq, lagap, lafilter), then ogbuild, ogtour, tour2fasta
    and assemble on phase 9's FIX DB and filtered file.  The tracks and
    .las files equal phase 9's; lacheck clean; tour2fasta's contigs
    assemble's; every kernel of the path launched, the first K1, K2 and
    K3 launches and lashow -a's one K4 launch held against their plain
    versions.  Returns each tool's wall and the launches."""
    c = f"{w}/cli"
    os.makedirs(c)
    for f in ("RAW.db", ".RAW.idx", ".RAW.bps"):
        shutil.copy(f"{w}/{f}", c)
    db, fdb, flas = f"{c}/RAW.db", f"{w}/FIX.db", f"{w}/FIX.filtered.las"
    nblocks = dazzdb.DazzDB.open(db).nblocks
    merged = [f"{c}/RAW.{b}.las" for b in range(1, nblocks + 1)]
    walls, k4_launches = {}, {}
    reset_launches()
    t0 = time.time()
    with Spy(keep=CLI_HELD) as spy, FirstLaunch() as k4:
        reads = json.loads(cli(["dbstats", db], walls))["ureads"]
        plan = cli(["hpc-plan", db], walls)
        cli(["dbdust", db], walls)
        cli(["datander", db], walls)
        cli(["overlap-all", db, "-m", "dust", "-m", "tan"], walls)
        checked = cli(["lacheck", db, *merged], walls)
        shown = cli(["lashow", f"{c}/RAW.1.las", "--limit", "50"], walls)
        k4_launches["before"] = band_align.band_align.launches
        aligned = cli(["lashow", f"{c}/RAW.1.las", "-a", "--limit", "20",
                       "--db", db], walls, "lashow -a")
        k4_launches["lashow -a"] = (band_align.band_align.launches
                                    - k4_launches.pop("before"))
        stitched = cli(["lastitch", db, f"{c}/RAW.1.las", "-b", "1", "-o",
                        f"{c}/stitched.las"], walls)
        cli(["laq", db, f"{c}/stitched.las"], walls)
        gaps = cli(["lagap", db, f"{c}/stitched.las"], walls)
        kept = cli(["lafilter", db, f"{c}/stitched.las", "-o",
                    f"{c}/filtered.las"], walls)
        cli(["ogbuild", fdb, flas, f"{c}/graph.graphml"], walls)
        cli(["ogtour", fdb, flas, f"{c}/tours.json"], walls)
        cli(["tour2fasta", fdb, f"{c}/tours.json", f"{c}/tours.fasta"],
            walls)
        asm = cli(["assemble", fdb, flas, f"{c}/contigs.fasta"], walls)
    wall = time.time() - t0
    launches = read_launches()
    log(f"phase 12a, the command line on the stages unit ({reads} reads): "
        f"wall {wall:.4f} s; each tool's wall {walls}; launches {launches} "
        f"on {card}")
    log(f"phase 12a outputs: lacheck {checked.split()}; lashow "
        f"{len(shown.splitlines())} lines, lashow -a {len(aligned)} bytes; "
        f"lastitch: {stitched.strip()}; lagap: "
        f"{gaps.strip().splitlines()[-1]}; lafilter: {kept.strip()}; "
        f"assemble: {asm.strip()}")
    same = cli_same_as_stages(nblocks)
    differ = [f for f in same
              if not filecmp.cmp(f"{c}/{f}", f"{w}/{f}", shallow=False)]
    if differ:
        raise SystemExit(f"chip_smoke: phase 12a: {differ} differ from "
                         f"phase 9's files")
    if [ln.rsplit(": ", 1)[-1] for ln in checked.splitlines()] != \
            ["OK"] * nblocks:
        raise SystemExit(f"chip_smoke: phase 12a: lacheck: {checked}")
    if f"python -m damar_tpu_torch.cli daligner RAW 1 {nblocks}\n" \
            not in plan:
        raise SystemExit(f"chip_smoke: phase 12a: hpc-plan rendered no "
                         f"daligner line for pair 1, {nblocks}")
    if "|" not in aligned or k4_launches["lashow -a"] != 1:
        raise SystemExit(f"chip_smoke: phase 12a: lashow -a took "
                         f"{k4_launches['lashow -a']} K4 launches")
    if not same_contigs(f"{c}/tours.fasta", f"{c}/contigs.fasta"):
        raise SystemExit("chip_smoke: phase 12a: tour2fasta's contigs are "
                         "not assemble's")
    missing = [k for k in MAIN_PATH + (K4,) if launches[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels not launched by the command "
                         f"line: {missing}")
    log(f"phase 12a: {len(same)} files byte-equal to phase 9's (no "
        f"setting differs: the tools' defaults are phase 9's MaskConfig() "
        f"and OverlapConfig(); phase 9's explicit caps ({HIT_CAP}, "
        f"{SEED_CAP}) against overlap-all's sized buffers), lacheck clean, "
        f"tour2fasta == assemble, lashow -a in one K4 launch")
    held = hold_first("command line (12a)", spy, CLI_HELD)
    hold_launches("command line (12a), lashow -a", {K4: [k4.first]})
    return dict(wall_s=round(wall, 4), tool_walls=walls,
                launches=launches, held=dict(held, **{K4: 1}),
                same_as_stages=len(same))


def cli_polish(w: str, genome: np.ndarray, card: str) -> dict:
    """Phase 12b: `assemble --polish` on phase 10b's DB and filtered file:
    K4's launches and device time (CUDA events around each launch), its
    first launch there (capped) held against its plain version, and the
    longest polished contig's k-mer hit rate against the genome above
    phase 10b's gate (an unpolished contig of these 14%-error reads
    scores far below it)."""
    from damar_tpu_torch.formats.fasta import read_fasta
    from damar_tpu_torch.utils.sim import kmer_hit_rate
    walls = {}
    reset_launches()
    with FirstLaunch() as k4:
        out = cli(["assemble", f"{w}/FIX.db", f"{w}/FIX.filtered.las",
                   f"{w}/cli_polished.fasta", "--polish"], walls)
        k4_ms = k4.device_ms()
    launches = read_launches()
    contigs = read_fasta(f"{w}/cli_polished.fasta")[1]
    lens = [len(x) for x in contigs]
    hit = kmer_hit_rate(genome, max(contigs, key=len)) if contigs else 0.0
    res = dict(wall_s=walls["assemble"], launches=launches,
               k4_launches=launches[K4], k4_device_ms=round(k4_ms, 4),
               contigs=len(lens), total_bp=sum(lens), lengths=lens[:10],
               longest_kmer_hit_rate=hit)
    log(f"phase 12b, assemble --polish on the 300 kbp assembly: {res}; "
        f"{out.strip()} on {card}")
    if launches[K4] <= 0 or k4.first is None:
        raise SystemExit(f"chip_smoke: phase 12b: {launches[K4]} K4 "
                         f"launches")
    hold_launches("command line (12b), assemble --polish", {K4: [k4.first]})
    if hit <= 0.45:
        raise SystemExit(f"chip_smoke: phase 12b: the longest polished "
                         f"contig's k-mer hit rate {hit:.4f} <= 0.45")
    return dict(res, held={K4: 1})


def cli_pipeline(base: str, card_w: str) -> dict:
    """Phase 12c: the `pipeline` tool on the 12 kbp genome (phase 10c's
    reads and settings): CONTIGS.fasta byte-equal to phase 10c's
    run_pipeline on the card."""
    walls = {}
    reset_launches()
    out = cli(["pipeline", f"{card_w}/reads.fasta", f"{base}/cli", "-s",
               "1", "-x", "500"], walls)
    launches = read_launches()
    if not filecmp.cmp(f"{base}/cli/CONTIGS.fasta",
                       f"{card_w}/CONTIGS.fasta", shallow=False):
        raise SystemExit("chip_smoke: phase 12c: the pipeline tool's "
                         "CONTIGS.fasta differs from run_pipeline's")
    res = dict(wall_s=walls["pipeline"], launches=launches,
               contigs=json.loads(out.splitlines()[-1])["contigs"])
    log(f"phase 12c, the pipeline tool on the 12 kbp genome: {res}; "
        f"CONTIGS.fasta byte-equal to phase 10c's")
    return res


def cli_fresh(base: str, card_w: str) -> dict:
    """Phase 12d: a rendered hpc-plan daligner line run as-is by a shell,
    as a fresh process, in a directory holding a copy of phase 10c's DB:
    with DAMAR_PLATFORM unset it writes the in-process daligner's file;
    with no card visible (CUDA_VISIBLE_DEVICES empty) it exits non-zero
    and names the missing card, writing nothing; with DAMAR_PLATFORM=cpu
    it writes the same bytes.  The three processes run at once, each in
    a copy of the directory, and each wall is taken from their common
    start."""
    d = f"{base}/plan"
    os.makedirs(d)
    for f in ("RAW.db", ".RAW.idx", ".RAW.bps"):
        shutil.copy(f"{card_w}/{f}", d)
    walls = {}
    reset_launches()
    cli(["daligner", f"{d}/RAW.db", "1", "1", "-o", f"{base}/inproc.las"],
        walls)
    launches = read_launches()
    lines = cli(["hpc-plan", f"{d}/RAW.db"], walls).splitlines()
    script = "\n".join([lines[1], next(
        ln for ln in lines
        if ln.startswith("python -m damar_tpu_torch.cli daligner ")
        and "#" not in ln)]) + "\n"
    # the rendered line calls `python`: here, the interpreter running this
    # script (a wrapper that execs it by its own path, so a virtual
    # environment's packages stay found)
    bindir = f"{base}/bin"
    os.makedirs(bindir)
    with open(f"{bindir}/python", "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(f"{bindir}/python", 0o755)
    env0 = {k: v for k, v in os.environ.items()
            if k not in ("DAMAR_PLATFORM", "PYTHONPATH")}
    env0["PATH"] = f"{bindir}:{env0.get('PATH', '')}"
    runs = {}
    for k, (label, extra) in enumerate((
            ("card", {}), ("no card", {"CUDA_VISIBLE_DEVICES": ""}),
            ("cpu", {"DAMAR_PLATFORM": "cpu"}))):
        dk = f"{base}/fresh{k}"
        os.makedirs(dk)
        for f in ("RAW.db", ".RAW.idx", ".RAW.bps"):
            shutil.copy(f"{d}/{f}", dk)
        runs[label] = dk, extra
    t0 = time.time()
    procs = {label: subprocess.Popen(
        ["bash", "-c", script], cwd=dk, env=dict(env0, **extra),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for label, (dk, extra) in runs.items()}
    res = {}
    try:
        for label, p in procs.items():
            _, err = p.communicate(timeout=600)
            res[label] = dict(rc=p.returncode,
                              wall_s=round(time.time() - t0, 4))
            out = f"{runs[label][0]}/RAW.1.RAW.1.las"
            if label == "no card":
                if (p.returncode == 0 or "no CUDA device" not in err
                        or os.path.exists(out)):
                    raise SystemExit(f"chip_smoke: phase 12d: with no card "
                                     f"visible the line gave rc "
                                     f"{p.returncode}: {err[-400:]}")
                res[label]["stderr"] = err.strip().splitlines()[-1]
            elif p.returncode or not filecmp.cmp(
                    out, f"{base}/inproc.las", shallow=False):
                raise SystemExit(f"chip_smoke: phase 12d: the rendered line "
                                 f"({label}) gave rc {p.returncode} or "
                                 f"another file: {err[-400:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"phase 12d, the rendered line `{script.splitlines()[-1]}` in a "
        f"fresh process: {res}; the card's and the CPU's file byte-equal "
        f"to the in-process daligner's")
    return dict(fresh=res, launches=launches, inproc_wall_s=walls["daligner"])


def drop_twin_bases(blk) -> None:
    """Drop the device bases (and packed words) of blk's cached
    reverse-complement twin, so that the next pass makes them again on
    the card, as it does for a B block met anew."""
    blk.cache["rc_block"].cache.pop("dev_arrs", None)


def rc_row(spy: Spy, per: dict, launches: dict, errs: dict,
           card: str) -> dict:
    """revcomp_kernel's row of the kernels line: its one launch in the
    profiled main-path pass, whose output and a launch again on the same
    device inputs (the block's whole cap) are held byte for byte against
    revcomp_plain, then timed alone (the kernel under the profiler, the
    plain version with CUDA events) against its bytes' bound."""
    _, mod, attr, plain, src, replaces = KERNELS[RC]
    if len(spy.calls[RC]) != 1:
        raise SystemExit(f"chip_smoke: {len(spy.calls[RC])} {RC} launches "
                         f"in the profiled pass, wanted 1")
    a, k, out = spy.calls[RC][0]
    launch = getattr(mod, attr)
    want = plain(*a, **k)
    e = max(max_abs_err(out, want), max_abs_err(launch(*a, **k), want))
    errs[RC] = max(errs[RC], e)
    bms, by = bound(*work(RC, a, k, out, {})[1:])
    ms = kernel_ms(RC, lambda: launch(*a, **k), 5)
    plain_ms = cuda_ms(lambda: plain(*a, **k), 1)
    cap, nbases = a[0].shape[0], int(a[3])
    log(f"{RC}, main path, whole block (cap {cap}, nbases {nbases}, "
        f"{a[2].shape[0] - 1} reads): kernel {ms:.4f} ms device time, bound "
        f"{bms:.4f} ms ({by}), share of bound {bms / ms:.3f}, plain "
        f"{plain_ms:.4f} ms, max_abs_err {e} on {card}")
    p = per[RC]
    return dict(
        name=RC, route="cuda", source=src, replaces=replaces,
        launches=launches[RC], max_abs_err=errs[RC], ms=round(ms, 4),
        plain_ms=round(plain_ms, 4), bound_ms=round(bms, 4), bound_by=by,
        library_ms=None,
        library="none: no PyTorch call reverses each read of a block",
        pass_ms=round(p["pass_ms"], 4),
        pass_bound_ms=round(p["pass_bound_ms"], 4),
        pass_bound_by=p["bound_by"],
        bound_share=round(p["pass_bound_ms"] / p["pass_ms"], 4),
        pass_rows=p["rows"], cap=cap, nbases=nbases,
        note="rows are positions; the bound counts bytes only")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=1,
                    help="warm main-path passes to time (default 1)")
    ap.add_argument("--profile", metavar="PATH",
                    help="write the profiled warm pass's tables to PATH")
    ap.add_argument("--sweep-rounds", type=int, default=1,
                    help="runs of the sweep and of the plain loop, in "
                         "turns (default 1 of each)")
    args = ap.parse_args(argv)
    if args.passes < 1 or args.sweep_rounds < 1:
        ap.error("--passes and --sweep-rounds must be at least 1")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # phase 12's tools take the card when DAMAR_PLATFORM is unset
    os.environ.pop("DAMAR_PLATFORM", None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    lib_path = _cuda.build()
    _cuda.lib()
    log(f"build: {lib_path.name} in {time.time() - t0:.1f} s "
        f"(nvcc {_cuda.last_build_seconds or 0:.1f} s)")
    for ln in _cuda.build_log:
        log(f"  {ln}")
    sass = sass_ops_per_row(lib_path)
    for fn, v in sass.items():
        log(f"SASS {fn[:60]}: row loop {v['insns']} instructions, "
            f"{v['loads']} global loads = {v['rows']:g} rows, "
            f"{v['per_row']:.2f} per row (estimate "
            f"{OPS_ESTIMATE.get(v['kernel'], K4_OPS_PER_CELL)})")

    t0 = time.time()
    errs = fuzz_checks(dev)
    log(f"fuzz checks vs plain: max_abs_err {errs} "
        f"({time.time() - t0:.1f} s)")
    if any(errs.values()):
        raise SystemExit("chip_smoke: a kernel disagrees with its plain "
                         "version on fuzz batches")

    # ---- main path: large-50Mbp self pair ----
    t0 = time.time()
    g = make_genome(GENOME, seed=SEED)
    sim = sample_reads(g, coverage=COVERAGE, mean_len=MEAN_LEN, err=ERR,
                       seed=SEED + 1)
    blk = block_from_reads(sim.reads)
    total_bp = sum(len(r) for r in sim.reads)
    log(f"large-50Mbp: {len(sim.reads)} reads, {total_bp} bp, block cap "
        f"{blk.cap}, setup {time.time() - t0:.1f} s")
    cfg = OverlapConfig()
    kw = dict(self_block=True, hit_cap=HIT_CAP, seed_cap=SEED_CAP,
              emit_mirrors=False, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    las_a, _, stats = ov.overlap_block_pair(blk, blk, cfg, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    aligned = int(las_a.a_spans().sum())
    log(f"cold pass (adds the uploads, A-side index build, rc twin and "
        f"trace pool that warm passes reuse): wall {wall:.4f} s, "
        f"{aligned / wall / 1e9:.4f} Gbp-aligned/s, overlaps "
        f"{las_a.novl}; stats {json.dumps(stats, default=int)}")
    walls = []
    for i in range(args.passes):
        drop_twin_bases(blk)
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.time()
        las_a, _, stats = ov.overlap_block_pair(blk, blk, cfg, **kw)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        aligned = int(las_a.a_spans().sum())
        errs_las = check_las(las_a, blk.rlen)
        log(f"warm pass {i}: overlaps {las_a.novl}, aligned bp {aligned}, "
            f"wall {walls[-1]:.4f} s, "
            f"{aligned / walls[-1] / 1e9:.4f} Gbp-aligned/s on {card}")
        log(f"stats: {json.dumps(stats, default=int)}")
        log(f"trace_retries {stats.get('trace_retries', 0)}, "
            f"trace_retries_wide {stats.get('trace_retries_wide', 0)}, "
            f"dropped_trace {stats.get('dropped_trace', 0)}")
        log(f"launches in the pass: {launches}")
        log(f"peak device memory: {peak / 2**30:.2f} GiB ({peak} B)")
        if errs_las:
            raise SystemExit(f"chip_smoke: check_las failed: "
                             f"{errs_las[:5]}")
        if las_a.novl <= 0:
            raise SystemExit("chip_smoke: no overlaps")
        if stats.get("seed_overflow"):
            raise SystemExit("chip_smoke: seeding buffers overflowed")
        missing = [k for k in MAIN_PATH if launches[k] <= 0]
        if missing:
            raise SystemExit(f"chip_smoke: kernels not launched by the "
                             f"main path: {missing}")
        if launches[RC] != 1:
            raise SystemExit(f"chip_smoke: {launches[RC]} {RC} launches "
                             f"in a warm pass, wanted 1 (the twin's bases)")
    med = float(np.median(walls))
    log(f"warm passes: walls {[round(w, 4) for w in walls]} s, median "
        f"{med:.4f} s = {aligned / med / 1e9:.4f} Gbp-aligned/s on {card}")

    # ---- one more warm pass, profiled, with every launch kept (taken
    # again if the profile lost launch records) ----
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_TRIES):
        drop_twin_bases(blk)
        torch.cuda.synchronize()
        with Spy() as spy, profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead_records()
            t0 = time.time()
            las_s, _, _ = ov.overlap_block_pair(blk, blk, cfg, **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
        try:
            per = spy.summary(prof, sass, cfg.max_read_len)
            break
        except LostLaunches:
            log(f"profiled pass {attempt + 1} of {PROFILE_TRIES} lost launch "
                f"records")
    else:
        raise SystemExit("chip_smoke: the profiler kept losing launches")
    report_profile(prof, wall, args.profile)
    if las_s.novl != las_a.novl:
        raise SystemExit("chip_smoke: the spied pass gave other records")
    for name in MAIN_PATH + (RC,):
        p = per[name]
        log(f"{name} in one warm pass: {p['launches']} launches, "
            f"{p['pass_ms']:.4f} ms device time, {p['rows']} rows, bound "
            f"{p['pass_bound_ms']:.4f} ms ({p['bound_by']}), share of "
            f"bound {p['pass_bound_ms'] / p['pass_ms']:.3f} on {card}")
    k12 = sum(per[k]["pass_ms"] for k in ("bp_extend_kernel",
                                          "bp_trace_kernel"))
    log(f"K1 + K2 per warm pass: {k12:.4f} ms device time")

    # ---- every wide trace launch of the pass (one per segment bucket,
    # capped at CAP extents) vs plain; the retry routes must give the
    # plain outputs too ----
    jobs, want = [], []
    for i, (a, k, _) in enumerate(spy.calls["wide_trace_kernel"]):
        a, k = capped("wide_trace_kernel", a, k)
        t0 = time.time()
        ref = wave_wide.trace_wave_plain(*a, **k)
        e = max_abs_err(wave_wide.trace_wide_kernel(*a, **k), ref)
        errs["wide_trace_kernel"] = max(errs["wide_trace_kernel"], e)
        log(f"wide_trace_kernel, main-path launch {i}: {a[6].numel()} "
            f"extents, longest {int(a[6].max())} rows, max_abs_err {e} "
            f"(plain {time.time() - t0:.1f} s)")
        jobs.append(a)
        want.append(ref)

    # ---- the wide route: K3's chunk form on a path ----
    t0 = time.time()
    wide = wide_route(dev, card, sass)
    launches["dp_rows_kernel"] = wide["launches"]
    log(f"wide route: {time.time() - t0:.1f} s")

    # ---- each kernel vs plain at its first main-path launch, timed ----
    rows = []
    for name in TPU_KERNELS:
        _, mod, attr, plain, src, replaces = KERNELS[name]
        launch = getattr(mod, attr)
        if name in MAIN_PATH:
            if not spy.calls[name]:
                raise SystemExit(f"chip_smoke: no spied launch of {name}")
            cases = {"main path": capped(name, *spy.calls[name][0][:2])}
        else:       # the chunk form: its first wide-route launch (track +
            # recenter), then trace mode, which only the per-step retry
            # route below takes, on fuzz shapes
            cases = {"wide route": wide["kept"][0][1:],
                     "trace": dp_rows_batch(np.random.default_rng(13), CAP,
                                            False, False)}
        timed = {}
        for case, (a, k) in cases.items():
            out = launch(*a, **k)
            e = max_abs_err(out, plain(*a, **k))
            errs[name] = max(errs[name], e)
            bms, by = bound(*work(name, a, k, out, sass)[1:])
            shapes = [tuple(x.shape) for x in a if torch.is_tensor(x)][:4]
            ms = kernel_ms(name, lambda: launch(*a, **k), 5)
            plain_ms = cuda_ms(lambda: plain(*a, **k), 1)
            log(f"{name}, {case}, first {CAP} items {shapes}: kernel "
                f"{ms:.4f} ms device time, bound {bms:.4f} ms ({by}), plain "
                f"{plain_ms:.4f} ms, max_abs_err {e}")
            timed[case] = dict(ms=round(ms, 4), plain_ms=round(plain_ms, 4),
                               bound_ms=round(bms, 4), bound_by=by,
                               max_abs_err=e)
        first = next(iter(timed.values()))
        row = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name],
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=None,
            library="none: no PyTorch call computes this banded DP")
        p = per[name] if name in MAIN_PATH else wide
        row.update(pass_ms=round(p["pass_ms"], 4),
                   pass_bound_ms=round(p["pass_bound_ms"], 4),
                   pass_bound_by=p["bound_by"],
                   bound_share=round(p["pass_bound_ms"] / p["pass_ms"], 4),
                   pass_rows=p["rows"])
        if name not in MAIN_PATH:
            row.update(modes=timed, sampled_launches_vs_plain=wide["sampled"],
                       note="launches, pass_ms, pass_bound_ms and bound_share "
                            "are one wide-route pass (quick-10Mbp, "
                            "dp_kernel=wide); ms, plain_ms, bound_ms its "
                            "first launch there, capped; trace mode on fuzz "
                            "shapes under modes")
        rows.append(row)
    rows.append(rc_row(spy, per, launches, errs, card))
    if any(r["max_abs_err"] for r in rows):
        raise SystemExit("chip_smoke: a kernel disagrees with its plain "
                         "version at main-path shapes")

    routes = compare_wide_routes(jobs, want, card)
    del spy, jobs, want
    wide.pop("kept")

    # ---- small pairs: card == CPU path (== damar_tpu, per the tests) ----
    t0 = time.time()
    card_equals_cpu(dev, small_reads(), cfg)
    log(f"small pairs: {time.time() - t0:.1f} s")

    # ---- the block sweep from a DB on disk ----
    del blk, las_a, las_s
    torch.cuda.empty_cache()
    t0 = time.time()
    t_ring = {}

    def ring_phase(w, db):
        t1 = time.time()
        out = ring_full(dev, card, w, db)
        t_ring["a"] = time.time() - t1
        log(f"phase 13a: {t_ring['a']:.1f} s")
        return out
    swept = sweep_phase(dev, card, args.sweep_rounds, then=ring_phase)
    ringed = {"full": swept.pop("then")}
    log(f"sweep phase: {time.time() - t0 - t_ring['a']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    ringed["ranks"] = ring_ranks(dev, card)
    log(f"phase 13b: {time.time() - t0:.1f} s")
    t0 = time.time()
    ringed["options"] = ring_options(dev, card)
    log(f"phase 13c: {time.time() - t0:.1f} s")
    ring_launches = ringed["full"].pop("launches")
    for r in rows:
        r["sweep_launches"] = swept["launches"][r["name"]]
        r["ring_launches"] = ring_launches[r["name"]]
    by_name = {r["name"]: r for r in rows}
    by_name["wide_trace_kernel"]["wide_route_launches"] = wide[
        "wide_trace_launches"]
    by_name["dp_rows_kernel"]["wide_route_launches"] = wide["launches"]
    swept.pop("launches")
    if any(r["launches"] <= 0 for r in rows):
        raise SystemExit("chip_smoke: a kernel was launched on no path")

    # ---- the stages from a DB on disk: masking, patch, scrub; then
    # phase 7 there ----
    torch.cuda.empty_cache()
    t0 = time.time()
    w = tempfile.mkdtemp(prefix="damar_smoke_stages_")
    try:
        staged = stages_phase(dev, card, w)
        log(f"stages phase: {time.time() - t0:.1f} s")
        t0 = time.time()
        staged["phase7"] = assemble_stages(w, dev, card,
                                           staged.pop("genome_bp"))
        log(f"phase 10a: {time.time() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.time()
        cli_run = {"stages": cli_stages(w, card)}
        log(f"phase 12a: {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(w, ignore_errors=True)
    for r in rows:
        r["stage_launches"] = staged["launches"][r["name"]]
    staged.pop("launches")

    # ---- the whole assembly from FASTA, with polish ----
    torch.cuda.empty_cache()
    t0 = time.time()
    asm = assembly_phase(dev, card, sass)
    log(f"phase 10b: {time.time() - t0:.1f} s")
    cli_run["polish"] = asm.pop("cli_polish")
    row, launches_asm = k4_row(asm, errs, sass, card)
    for r in rows:
        r["assembly_launches"] = launches_asm[r["name"]]
    row["ring_launches"] = ring_launches[K4]
    rows.append(row)
    for r in rows:
        r["ring_option_launches"] = ringed["options"]["bias"][
            "launches"].get(r["name"], 0)

    # ---- a tiny assembly on the card and on the CPU path ----
    t0 = time.time()
    asm["tiny"] = assembly_tiny(dev)
    cli_run.update(asm["tiny"].pop("cli"))
    log(f"phases 10c, 12c, 12d: {asm['tiny']} ({time.time() - t0:.1f} s)")
    # each kernel's launches over phase 12's in-process tools
    cli_launches = {k: sum(cli_run[p]["launches"][k] for p in (
        "stages", "polish", "pipeline")) + cli_run["fresh"]["launches"][k]
        for k in KERNELS}
    for r in rows:
        r["cli_launches"] = cli_launches[r["name"]]
    for p in ("stages", "polish", "pipeline", "fresh"):
        cli_run[p]["launches"] = {k: v for k, v in
                                  cli_run[p]["launches"].items() if v}

    # ---- the pipeline's default 200 Mbp block, the legacy payload path
    # and -b ----
    torch.cuda.empty_cache()
    t0 = time.time()
    default = default_block_phase(dev, card)
    log(f"phase 11: {time.time() - t0:.1f} s")
    per_path = default.pop("launches")
    for r in rows:
        r["default_block_launches"] = {k: v[r["name"]]
                                       for k, v in per_path.items()}

    # ---- the bench twin, as a user runs it ----
    t0 = time.time()
    benched = bench_phase(card)
    log(f"phase 14: {time.time() - t0:.1f} s")
    for r in rows:
        r["bench_launches"] = benched["launches"].get(r["name"], 0)

    print(json.dumps({"kernels": rows, "wide_retry_routes": routes,
                      "wide_route": wide, "sweep": swept, "stages": staged,
                      "assembly": asm, "default_block": default,
                      "cli": cli_run, "ring": ringed, "bench": benched,
                      "profiler_lost_launches": LOST_LAUNCHES}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
