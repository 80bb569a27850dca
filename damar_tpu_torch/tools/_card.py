"""What the tools that run on the card share: the device a tool's --cpu
flag picks, the card's name and power limit, and each kernel's launch
count (the wrappers' `launches`), reset and read around a run."""
from __future__ import annotations

import subprocess

import torch

from damar_tpu_torch.ops import band_align, revcomp, wave_bp, wave_wide

# kernel name -> the wrapper whose `launches` counts its launches
WRAPPERS = {
    "bp_extend_kernel": wave_bp.extend_wave_bp,
    "bp_trace_kernel": wave_bp.trace_wave_bp,
    "wide_trace_kernel": wave_wide.trace_wave,
    "dp_rows_kernel": wave_wide.dp_rows,
    "band_align_kernel": band_align.band_align,
    "revcomp_kernel": revcomp.revcomp_bases,
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


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def read_launches() -> dict:
    return {k: w.launches for k, w in WRAPPERS.items()}
