"""What the worked example (tools/do.py) and the soak (tools/soak.py)
print beside their own lines: the contigs file's sha256, report.json's
per-phase walls, on the card its name and power limit, and each kernel's
launches over the run.  Both call run_pipeline through `run`."""
from __future__ import annotations

import hashlib

from damar_tpu_torch.tools._card import card_line, read_launches, \
    reset_launches


def run(run_pipeline, fasta: str, workdir: str, device: str,
        **kw) -> tuple[dict, dict]:
    """run_pipeline(fasta, workdir, device=device, **kw) with every
    kernel's launch count reset just before; returns (report, launches
    per kernel over the run)."""
    reset_launches()
    rep = run_pipeline(fasta, workdir, device=device, **kw)
    return rep, read_launches()


def print_extras(rep: dict, device: str, launches: dict) -> None:
    with open(rep["contig_fasta"], "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    print(f"== CONTIGS.fasta sha256 {digest}")
    walls = {k: v["wall_s"] for k, v in rep["phases"].items()}
    print(f"== phase walls (s) {walls}")
    if device == "cuda":
        print(f"== card {card_line()}")
        print(f"== kernel launches {launches}")
    else:
        print("== kernel launches: none (--cpu runs the plain versions)")
