"""The worked example of damar_tpu_torch (the twin of examples/do.py):
simulate a small PacBio-like dataset with ground truth, run the
complete pipeline (mask -> overlap -> patch -> re-overlap -> scrub ->
assemble -> polish) and hold the contigs against the truth genome.

    python -m damar_tpu_torch.tools.do [workdir] [--genome-bp 50000]
        [--coverage 12] [--err 0.13] [--seed 7] [--cpu]

Runs on the CUDA card (raises without one) unless --cpu, which runs the
plain kernel versions.  The genome, reads and PASS rule are the
example's: a 50 kbp genome at 12x of 4 kbp reads at 13% error; PASS
when the contigs span more than 85% of the genome and the longest
one's exact k16 hit rate against it passes 0.6 (exit 1 otherwise).
Besides the example's lines it prints the contigs file's sha256, the
per-phase walls and, on the card, the card and each kernel's launches.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--genome-bp", type=int, default=50_000)
    ap.add_argument("--coverage", type=float, default=12.0)
    ap.add_argument("--err", type=float, default=0.13)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain kernel versions on the CPU")
    args = ap.parse_args()

    from damar_tpu_torch.formats.fasta import read_fasta
    from damar_tpu_torch.pipeline.run import run_pipeline
    from damar_tpu_torch.tools._card import pick_device
    from damar_tpu_torch.tools.assembly_report import print_extras, run
    from damar_tpu_torch.utils.sim import (kmer_hit_rate, make_genome,
                                           sample_reads, write_sim_fasta)

    device = pick_device(args.cpu)
    w = args.workdir or tempfile.mkdtemp(prefix="damar_example_")
    os.makedirs(w, exist_ok=True)
    print(f"== workdir {w}")
    g = make_genome(args.genome_bp, seed=args.seed)
    sim = sample_reads(g, coverage=args.coverage, mean_len=4000,
                       err=args.err, seed=args.seed + 1)
    fa = os.path.join(w, "reads.fasta")
    write_sim_fasta(fa, sim)
    print(f"== simulated {len(sim.reads)} reads, "
          f"{sum(len(r) for r in sim.reads)} bp at {args.err:.0%} error")

    rep, launches = run(run_pipeline, fa, w, device, polish=True,
                        verbose=True)
    names, seqs = read_fasta(rep["contig_fasta"])
    total = sum(len(s) for s in seqs)
    contigs = [(n.split()[0], len(s)) for n, s in zip(names, seqs)]
    print(f"== contigs: {contigs}")

    # identity oracle: exact k-mer hit rate of the longest contig
    # against the truth genome (both strands)
    best = max(seqs, key=len)
    hit = kmer_hit_rate(g, best)
    print(f"== longest contig {len(best)} bp vs {len(g)} bp genome; "
          f"k16 hit-rate {hit:.3f} (~identity {hit ** (1 / 16):.4f})")
    print_extras(rep, device, launches)
    ok = total > 0.85 * len(g) and hit > 0.6
    print("== PASS" if ok else "== FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
