"""The 1 Mbp assembly soak of damar_tpu_torch (the twin of
scripts/soak.py): a repeat-rich circular genome (4 repeats of 1.8 kbp, 2
tandem arrays), 14x reads of mean 8 kb at 13% error, the full pipeline
with polish, and the longest contig's identity against the truth.

    python -m damar_tpu_torch.tools.soak [--genome-bp 1000000]
        [--coverage 14] [--err 0.13] [--seed 11] [--finish-raw N]
        [--workdir DIR] [--cpu]

Runs on the CUDA card (raises without one) unless --cpu, which runs the
plain kernel versions.  Prints the soak's contigs and summary lines,
then the contigs file's sha256, the per-phase walls and, on the card,
the card and each kernel's launches.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-bp", type=int, default=1_000_000)
    ap.add_argument("--coverage", type=float, default=14.0)
    ap.add_argument("--err", type=float, default=0.13)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--finish-raw", type=int, default=None,
                    help="override TourConfig.finish_raw_rounds")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain kernel versions on the CPU")
    args = ap.parse_args()

    from damar_tpu_torch.core.config import PipelineConfig
    from damar_tpu_torch.formats.fasta import read_fasta
    from damar_tpu_torch.pipeline.run import run_pipeline
    from damar_tpu_torch.tools.assembly_report import (pick_device,
                                                       print_extras, run)
    from damar_tpu_torch.utils.sim import (kmer_hit_rate, make_genome,
                                           sample_reads, write_sim_fasta)

    device = pick_device(args.cpu)
    w = args.workdir or tempfile.mkdtemp(prefix="damar_soak_")
    os.makedirs(w, exist_ok=True)
    g = make_genome(args.genome_bp, seed=args.seed, n_repeats=4,
                    repeat_len=1800, tandem=2)
    sim = sample_reads(g, coverage=args.coverage, mean_len=8000,
                       err=args.err, seed=args.seed + 1)
    fa = os.path.join(w, "reads.fasta")
    write_sim_fasta(fa, sim)
    print(f"== soak workdir {w}: {len(sim.reads)} reads, "
          f"{sum(len(r) for r in sim.reads)} bp", flush=True)
    cfg = PipelineConfig()
    if args.finish_raw is not None:
        cfg = dataclasses.replace(
            cfg, tour=dataclasses.replace(
                cfg.tour, finish_raw_rounds=args.finish_raw))
    t0 = time.time()
    rep, launches = run(run_pipeline, fa, w, device, cfg=cfg, polish=True,
                        verbose=True)
    names, seqs = read_fasta(rep["contig_fasta"])
    total = sum(len(s) for s in seqs)
    best = max(seqs, key=len) if seqs else np.zeros(0, np.uint8)
    hit = kmer_hit_rate(g, best) if len(best) else 0.0
    contigs = [(n.split()[0], len(s)) for n, s in zip(names, seqs)]
    print(f"== contigs {contigs}")
    print(f"== span {total / len(g):.2%}  longest {len(best)}  "
          f"k16 {hit:.4f}  ~identity {hit ** (1 / 16):.5f}  "
          f"wall {time.time() - t0:.0f}s")
    print_extras(rep, device, launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
