"""The overlap bench of damar_tpu_torch (the twin of bench.py).

    python -m damar_tpu_torch.tools.bench [--quick] [--profile [DIR]] [--cpu]

Runs the single-device overlap pipeline (seeding -> extension -> dedupe
-> trace -> .las records) on bench.py's simulated PacBio-like data and
reports aligned Gbp/s: the A spans of the emitted primary records over
the wall of a warm pass (the kernels' build, the first uploads and the
block caches' fill fall in the warmups).  The configs, caps, passes and
seeds are bench.py's:

- small-2Mbp: a 100 kbp genome at 20x (mean 6 kb, 14% error, seeds
  2024/2025), caps 1<<22 / 1<<17, 2 warmups, best of 3 rounds;
- large-50Mbp, the headline: a 2.5 Mbp genome, caps 1<<27 / 1<<21, 1
  warmup, best of 2 rounds, then 6 pairs through overlap_pairs_pipelined
  (the value is the larger of the two rates);
- sweep-4x12Mbp: large-50Mbp's reads as FASTA, a DB split into 4 blocks,
  run_overlap_plan cold, then warm on fresh files (aligned bp: the merged
  files' A spans / 2);
- --quick: quick-10Mbp alone (500 kbp, caps 1<<25 / 1<<19, 1 warmup,
  best of 2);
- --cpu: small-2Mbp alone (or quick-10Mbp with --quick) on the plain
  kernel versions, provenance "cpu-requested".

The value is bench.py's best of N; stderr also gives every round's wall,
their median, the pass's phase walls and its kernel launches.  A timed
pass whose seeding overflowed its caps is not the workload: the run
raises.  --profile [DIR] runs large-50Mbp's timed rounds under
torch.profiler (CPU and CUDA), writes its Chrome trace into DIR (default
damar_profile in the temporary directory) and prints the kernels with the
most device time.

The last line of stdout is one JSON object with bench.py's keys (metric,
value, unit "Gbp-aligned/s/gpu", vs_baseline, config, small_gbp_s,
sweep_gbp_s, provenance "measured-on-gpu" or "cpu-requested") plus the
device (nvidia-smi's name and power limit and the card count, or the
CPU), the torch and CUDA versions, the commit (null outside a git
checkout) and the headline pass's kernel launches.  A run on the card
appends its line to chiprun_out/bench_history.jsonl under the checkout
(git ignores the directory).

Without a card and without --cpu it raises before it builds any data.
bench.py's JAX probe, its retries, its inner process under a wall
budget, its silent fallback to the CPU, its re-emission of a stale TPU
line and its TPU stamp have no counterpart here, and the twin never
touches .bench_history.jsonl or .bench_last_tpu.json, which hold the
JAX package's TPU runs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HISTORY = os.path.join(ROOT, "chiprun_out", "bench_history.jsonl")
PROFILE_DIR = os.path.join(tempfile.gettempdir(), "damar_profile")

# bench.py:27, provisional: a daligner-class C socket's aligned Gbp/s
# (BASELINE.md), an order-of-magnitude anchor, not a measured number
REF_CPU_GBP_S = 0.050
GENOME = 100_000
GENOME_QUICK = 500_000
GENOME_LARGE = 2_500_000
COVERAGE = 20.0
MEAN_LEN = 6_000
ERR = 0.14
SEED = 2024                   # the genome's; the reads' is SEED + 1
PIPELINED_PAIRS = 6           # bench.py:264
# (hit_cap, seed_cap) of each config, bench.py's
CAPS_SMALL = (1 << 22, 1 << 17)
CAPS_QUICK = (1 << 25, 1 << 19)
CAPS_LARGE = (1 << 27, 1 << 21)
# the phase walls and seeding facts printed for each config
SHOWN_STATS = ("seed_path", "seed_overflow", "t_seed", "t_extend",
               "t_dedupe", "t_pool", "t_trace")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def simulate(genome_bp: int, coverage: float, mean_len: int, err: float):
    """bench.py's reads: the genome from SEED, the reads from SEED + 1."""
    from damar_tpu_torch.utils.sim import make_genome, sample_reads
    g = make_genome(genome_bp, seed=SEED)
    return sample_reads(g, coverage=coverage, mean_len=mean_len, err=err,
                        seed=SEED + 1)


def run_config(genome_bp: int, hit_cap: int, seed_cap: int, warmups: int,
               rounds: int, label: str, pipelined: bool = False, *, device,
               coverage: float = COVERAGE, mean_len: int = MEAN_LEN,
               err: float = ERR, cfg=None, profile_dir: str | None = None,
               on_pass=None) -> dict:
    """One self-pair config (bench.py:217-277): `warmups` passes, then
    `rounds` timed passes of overlap_block_pair on one resident block
    with shared size_hints; with `pipelined`, PIPELINED_PAIRS more pairs
    through overlap_pairs_pipelined.  cfg: the OverlapConfig (default
    OverlapConfig()).  profile_dir: run the timed rounds under
    torch.profiler and write its Chrome trace there.  on_pass(k, wall,
    las_a, stats) is called after the k-th timed round.  A timed round
    whose seeding overflowed its caps raises.  Returns gbp_s (best round,
    or the pipelined rate if larger), walls, las (the last round's
    las_a), aligned_bp, stats and launches (of the last round)."""
    from damar_tpu_torch.core.blocks import block_from_reads
    from damar_tpu_torch.core.config import OverlapConfig
    from damar_tpu_torch.pipeline.overlap import (overlap_block_pair,
                                                  overlap_pairs_pipelined)
    from damar_tpu_torch.tools._card import read_launches, reset_launches
    t0 = time.time()
    sim = simulate(genome_bp, coverage, mean_len, err)
    blk = block_from_reads(sim.reads)
    cfg = OverlapConfig() if cfg is None else cfg
    total_bp = sum(len(r) for r in sim.reads)
    log(f"# bench[{label}]: {len(sim.reads)} reads, {total_bp} bp, block "
        f"cap {blk.cap}, bp_chunk {cfg.bp_chunk}, caps {hit_cap} / "
        f"{seed_cap}, setup {time.time() - t0:.1f}s")
    hints: dict = {}
    kw = dict(self_block=True, hit_cap=hit_cap, seed_cap=seed_cap,
              emit_mirrors=False, size_hints=hints, device=device)
    if warmups:
        t0 = time.time()
        for _ in range(warmups):
            overlap_block_pair(blk, blk, cfg, **kw)
        sync(device)
        log(f"# warmup(+build): {time.time() - t0:.1f}s")

    ctx = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        ctx = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
    walls = []
    with ctx as prof:
        for k in range(rounds):
            reset_launches()
            sync(device)
            t0 = time.time()
            las_a, _, stats = overlap_block_pair(blk, blk, cfg, **kw)
            sync(device)
            walls.append(time.time() - t0)
            launches = read_launches()
            if on_pass is not None:
                on_pass(k, walls[-1], las_a, stats)
            if stats["seed_overflow"]:
                raise RuntimeError(
                    f"bench[{label}]: a timed pass's seeding overflowed its "
                    f"caps (hits {stats['total_hits']}, seeds "
                    f"{stats['total_seeds']}): the pass is cut, not the "
                    f"workload")
    if profile_dir:
        report_profile(prof, profile_dir, sum(walls))
    wall = min(walls)
    aligned = int(las_a.a_spans().sum())
    gbp_s = aligned / wall / 1e9
    shown = {k: stats.get(k) for k in SHOWN_STATS}
    log(f"# [{label}] overlaps {las_a.novl}, aligned bp {aligned}, wall "
        f"{wall:.4f}s, {gbp_s:.4f} Gbp/s, stats {json.dumps(shown)}")
    log(f"# [{label}] round walls {[round(w, 4) for w in walls]}s, median "
        f"{float(np.median(walls)):.4f}s = "
        f"{aligned / float(np.median(walls)) / 1e9:.4f} Gbp/s; launches "
        f"per pass {launches}")
    out = dict(gbp_s=gbp_s, walls=walls, las=las_a, aligned_bp=aligned,
               stats=stats, launches=launches)
    if not pipelined:
        return out
    jobs = [dict(tag=k, blk_a=blk, blk_b=blk, self_block=True,
                 hit_cap=hit_cap, seed_cap=seed_cap, emit_mirrors=False,
                 size_hints=hints) for k in range(PIPELINED_PAIRS)]
    sync(device)
    t0 = time.time()
    outs = list(overlap_pairs_pipelined(jobs, cfg, device=device))
    sync(device)
    pwall = time.time() - t0
    pal = sum(int(la.a_spans().sum()) for _, la, _, _ in outs)
    pgbp = pal / pwall / 1e9
    log(f"# [{label}] pipelined x{PIPELINED_PAIRS}: wall {pwall:.4f}s "
        f"({pwall / PIPELINED_PAIRS:.4f}s/pass), {pgbp:.4f} Gbp/s")
    out.update(gbp_s=max(gbp_s, pgbp), pipelined_gbp_s=pgbp)
    return out


def run_sweep_config(genome_bp: int, nblocks: int, label: str, *, device,
                     coverage: float = COVERAGE, mean_len: int = MEAN_LEN,
                     err: float = ERR) -> dict:
    """The distinct-pair sweep (bench.py:279-341): the config's reads as
    FASTA, create_db, db_split into ~nblocks blocks, run_overlap_plan cold
    (the builds and first uploads), the .las files and manifest removed,
    then the timed warm run.  Returns gbp_s, wall, aligned_bp (the merged
    files' A spans / 2: every alignment is there as primary and mirror),
    blocks and pairs."""
    from damar_tpu_torch.core.config import OverlapConfig
    from damar_tpu_torch.formats import dazzdb, las as lasmod
    from damar_tpu_torch.pipeline.planner import run_overlap_plan
    from damar_tpu_torch.utils.sim import write_sim_fasta
    t0 = time.time()
    sim = simulate(genome_bp, coverage, mean_len, err)
    total_bp = sum(len(r) for r in sim.reads)
    wdir = tempfile.mkdtemp(prefix="damar_bench_sweep_")
    try:
        write_sim_fasta(f"{wdir}/reads.fasta", sim)
        dazzdb.create_db(f"{wdir}/S.db", [f"{wdir}/reads.fasta"])
        size_mb = max(1, int(total_bp / nblocks / 1e6))
        dazzdb.db_split(f"{wdir}/S.db", size_mb=size_mb, cutoff=0)
        n = dazzdb.DazzDB.open(f"{wdir}/S.db").nblocks
        npairs = n * (n + 1) // 2
        log(f"# bench[{label}]: {len(sim.reads)} reads, {total_bp} bp in "
            f"{n} blocks ({npairs} pairs), setup {time.time() - t0:.1f}s")
        cfg = OverlapConfig()

        def one_run():
            sync(device)
            t0 = time.time()
            run_overlap_plan(f"{wdir}/S.db", cfg, verbose=False,
                             device=device)
            sync(device)
            wall = time.time() - t0
            aligned = sum(int(lasmod.read_las(f"{wdir}/S.{i}.las")
                              .a_spans().sum()) for i in range(1, n + 1))
            return wall, aligned // 2

        w0, _ = one_run()
        log(f"# [{label}] cold run (+build): {w0:.1f}s")
        for f in os.listdir(wdir):
            if f.endswith(".las") or ".overlap.manifest" in f:
                os.remove(os.path.join(wdir, f))
        wall, aligned = one_run()
        gbp = aligned / wall / 1e9
        log(f"# [{label}] warm sweep: {wall:.4f}s over {npairs} pairs, "
            f"{aligned} aligned bp = {gbp:.4f} Gbp/s")
        return dict(gbp_s=gbp, wall=wall, aligned_bp=aligned, blocks=n,
                    pairs=npairs)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)


def report_profile(prof, profile_dir: str, wall: float) -> None:
    """Writes the profile's Chrome trace into profile_dir and prints the
    device time, its share of the profiled wall and the kernels with the
    most device time."""
    from torch.autograd import DeviceType
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    log(f"# profile trace: {path}; device time {dev_s:.4f}s over "
        f"{wall:.4f}s of timed rounds (profiler on), busy share "
        f"{dev_s / wall if wall else 0.0:.3f}")
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        log(f"#   {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x "
            f"{e.key[:90]}")


def device_info(device: str) -> dict:
    """The card's name and power limit (nvidia-smi) and the card count,
    or the CPU's name."""
    if device == "cpu":
        return {"platform": "cpu",
                "name": platform.processor() or platform.machine(),
                "power_limit": None, "count": 1}
    from damar_tpu_torch.tools._card import card_line
    name, power = (s.strip() for s in card_line().split(",", 1))
    return {"platform": "gpu", "name": name, "power_limit": power,
            "count": torch.cuda.device_count()}


def git_commit() -> str | None:
    """HEAD of the checkout this file lies in, or None outside one."""
    try:
        r = subprocess.run(["git", "-C", ROOT, "rev-parse", "--show-toplevel",
                            "--short", "HEAD"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = r.stdout.split()
    if r.returncode or len(lines) != 2 or \
            os.path.realpath(lines[0]) != os.path.realpath(ROOT):
        return None
    return lines[1]


def append_history(rec: dict, path: str = HISTORY) -> None:
    """Appends a card run's line, stamped with the time, to the port's own
    history file."""
    rec = dict(rec, measured_at=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                              time.gmtime()))
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError as e:
        log(f"# WARNING: could not append to {path}: {e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="Runs on the CUDA card (raises without one) unless --cpu.")
    ap.add_argument("--quick", action="store_true",
                    help="quick-10Mbp alone")
    ap.add_argument("--profile", nargs="?", const=PROFILE_DIR, metavar="DIR",
                    help="profile large-50Mbp's timed rounds, Chrome trace "
                         f"into DIR (default {PROFILE_DIR})")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain kernel versions on the CPU")
    args = ap.parse_args(argv)
    if args.profile and (args.quick or args.cpu):
        ap.error("--profile wraps large-50Mbp, which --quick and --cpu do "
                 "not run")
    from damar_tpu_torch.tools._card import pick_device
    device = pick_device(args.cpu)
    rec = {"metric": "overlap_aligned_throughput", "value": None,
           "unit": "Gbp-aligned/s/gpu", "vs_baseline": None, "config": None,
           "small_gbp_s": None, "sweep_gbp_s": None,
           "provenance": "cpu-requested" if args.cpu else "measured-on-gpu"}
    if args.quick:
        head = run_config(GENOME_QUICK, *CAPS_QUICK, warmups=1, rounds=2,
                          label="quick-10Mbp", device=device)
        rec["config"] = "quick-10Mbp"
    else:
        head = run_config(GENOME, *CAPS_SMALL, warmups=2, rounds=3,
                          label="small-2Mbp", device=device)
        rec.update(config="small-2Mbp", small_gbp_s=head["gbp_s"])
        if not args.cpu:
            head = run_config(GENOME_LARGE, *CAPS_LARGE, warmups=1,
                              rounds=2, label="large-50Mbp", pipelined=True,
                              device=device, profile_dir=args.profile)
            rec["config"] = "large-50Mbp"
            rec["sweep_gbp_s"] = run_sweep_config(
                GENOME_LARGE, 4, "sweep-4x12Mbp", device=device)["gbp_s"]
    rec.update(value=head["gbp_s"],
               vs_baseline=head["gbp_s"] / REF_CPU_GBP_S,
               device=device_info(device), torch=torch.__version__,
               cuda=torch.version.cuda, commit=git_commit(),
               launches=head["launches"])
    if not args.cpu:
        append_history(rec)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
