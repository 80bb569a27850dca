"""Per-phase wall profile of one overlap pass (the twin of
scripts/profile_overlap.py).

    python -m damar_tpu_torch.tools.profile_overlap [--genome N]
        [--bp-chunk R] [--hit-cap H] [--seed-cap S] [--cpu]

The workload is bench.py's: a genome of N bp (default 100,000, seed 2024)
at 20x, mean read 6 kb, 14% error (reads' seed 2025), one block compared
with itself.  Four passes of overlap_block_pair (warmup1, warmup2, run1,
run2) on that resident block, with shared size_hints, taken as the
timed rounds of bench.run_config (tools/bench.py); for each, on
stderr: the pass's wall (ending in a device synchronise) and the phase
walls overlap_block_pair records in its stats (t_seed, t_extend,
t_dedupe, t_pool, t_trace with its parts t_trace_setup, t_trace_main,
t_trace_retry, t_trace_final), then seeds, kept extents, aligned bp and
Gbp/s.  Caps: the script's, large-50Mbp's 1<<27 / 1<<21 above a 1 Mbp
genome, else small-2Mbp's 1<<22 / 1<<17.  A pass whose seeding
overflowed its caps raises after its line (the script warns and goes
on): its phase walls are not the workload's.  --bp-chunk defaults to
OverlapConfig's (128), bench's setting; the script's default of 64
predates that config default.
--seed-batch has no counterpart: the port's OverlapConfig has no launch
widths (K1 runs one launch a phase over every unit), so the flag is
refused.

Each phase wall is a host-clock span that ends where the host has waited
for the device (PHASE_END): t_seed and t_pool at a synchronise of the
pass's stream, t_extend at the blocking download of the extents (after
every K1 launch of the pass), t_trace_main and t_trace_retry at the
blocking downloads of their traces; t_dedupe, t_trace_setup and
t_trace_final queue no device work.  The script's anchor-dedupe column
("dd") has no twin: the port dedupes anchors on the device inside the
extension phase (pipeline/overlap.py _prep_units_dev, called by
_extend_all_dev), so that work is in t_extend.

Runs on the CUDA card (raises without one, before it builds any data)
unless --cpu, which runs the plain kernel versions.
"""
from __future__ import annotations

import argparse
import sys

from damar_tpu_torch.tools.bench import (CAPS_LARGE, CAPS_SMALL, COVERAGE,
                                         MEAN_LEN, log, run_config)

GENOME = 100_000
PHASES = ("t_seed", "t_extend", "t_dedupe", "t_pool", "t_trace")
TRACE_PARTS = ("t_trace_setup", "t_trace_main", "t_trace_retry",
               "t_trace_final")
# where each phase wall stops (see the module docstring)
PHASE_END = {"t_seed": "stream sync", "t_extend": "extent download",
             "t_dedupe": "host only", "t_pool": "stream sync",
             "t_trace": "trace downloads", "t_trace_setup": "host only",
             "t_trace_main": "trace download",
             "t_trace_retry": "trace download", "t_trace_final": "host only"}
LABELS = ("warmup1", "warmup2", "run1", "run2")


def profile(genome_bp: int = GENOME, *, device, bp_chunk: int | None = None,
            hit_cap: int | None = None, seed_cap: int | None = None,
            coverage: float = COVERAGE, mean_len: int = MEAN_LEN
            ) -> list[dict]:
    """Runs the passes LABELS as bench.run_config's timed rounds (no
    warmup) and prints each one's line; returns their stats, each with
    wall, aligned_bp and the pass's las_a."""
    from damar_tpu_torch.core.config import OverlapConfig
    hc, sc = CAPS_LARGE if genome_bp > 1_000_000 else CAPS_SMALL
    cfg = OverlapConfig() if bp_chunk is None else OverlapConfig(
        bp_chunk=bp_chunk)
    log(f"# device={device}; phase walls end at: " + ", ".join(
        f"{k} {v}" for k, v in PHASE_END.items()))
    out = []

    def on_pass(k, wall, las_a, st):
        aligned = int(las_a.a_spans().sum())
        phases = " ".join(f"{p} {st[p]:.3f}" for p in PHASES)
        parts = " ".join(f"{p} {st[p]:.3f}" for p in TRACE_PARTS)
        log(f"{LABELS[k]}: total {wall:.3f}s | {phases} ({parts}) | seeds "
            f"{st['seeds']} kept {st['kept']} overlaps {las_a.novl} aligned "
            f"{aligned / 1e6:.1f} Mbp ({aligned} bp) -> "
            f"{aligned / wall / 1e9:.4f} Gbp/s")
        out.append(dict(st, wall=wall, aligned_bp=aligned, las=las_a))

    run_config(genome_bp, hit_cap or hc, seed_cap or sc, warmups=0,
               rounds=len(LABELS), label=f"profile-{genome_bp}",
               device=device, coverage=coverage, mean_len=mean_len, cfg=cfg,
               on_pass=on_pass)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="--seed-batch (the script's launch width) has no counterpart: "
               "the port's OverlapConfig has no launch widths.  Runs on the "
               "CUDA card (raises without one) unless --cpu.")
    ap.add_argument("--genome", type=int, default=GENOME)
    ap.add_argument("--bp-chunk", type=int, default=None,
                    help="bp extension rows between recenters (default "
                         "OverlapConfig's)")
    ap.add_argument("--hit-cap", type=int, default=None)
    ap.add_argument("--seed-cap", type=int, default=None)
    ap.add_argument("--seed-batch", type=int, default=None,
                    help="refused: no counterpart in the port")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain kernel versions on the CPU")
    args = ap.parse_args(argv)
    if args.seed_batch is not None:
        ap.error("--seed-batch has no counterpart: the port's OverlapConfig "
                 "has no launch widths")
    from damar_tpu_torch.tools._card import pick_device
    device = pick_device(args.cpu)
    profile(args.genome, device=device, bp_chunk=args.bp_chunk,
            hit_cap=args.hit_cap, seed_cap=args.seed_cap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
