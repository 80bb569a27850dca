"""What the worked example (tools/do.py) and the soak (tools/soak.py)
print beside their own lines: the contigs file's sha256, report.json's
per-phase walls, on the card its name and power limit, and each kernel's
launches over the run.  Both call run_pipeline through `run`."""
from __future__ import annotations

import hashlib
import subprocess

import torch

from damar_tpu_torch.ops import band_align, wave_bp, wave_wide

# kernel name -> the wrapper whose `launches` counts its launches
WRAPPERS = {
    "bp_extend_kernel": wave_bp.extend_wave_bp,
    "bp_trace_kernel": wave_bp.trace_wave_bp,
    "wide_trace_kernel": wave_wide.trace_wave,
    "dp_rows_kernel": wave_wide.dp_rows,
    "band_align_kernel": band_align.band_align,
}


def pick_device(cpu: bool) -> str:
    """"cpu" under --cpu (the plain kernel versions), else "cuda", which
    raises here when there is no card."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass --cpu to run "
                           "the plain kernel versions")
    return "cuda"


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    for card 0."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def run(run_pipeline, fasta: str, workdir: str, device: str,
        **kw) -> tuple[dict, dict]:
    """run_pipeline(fasta, workdir, device=device, **kw) with every
    kernel's launch count reset just before; returns (report, launches
    per kernel over the run)."""
    for w in WRAPPERS.values():
        w.launches = 0
    rep = run_pipeline(fasta, workdir, device=device, **kw)
    return rep, {k: w.launches for k, w in WRAPPERS.items()}


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
