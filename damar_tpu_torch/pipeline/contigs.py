"""Contig post-analysis (CT*-equivalent): the port of
damar_tpu/pipeline/contigs.py.

Per contig: length, read support, coverage profile (from the read
layout), low-coverage intervals, repeat-masked fraction, terminal state
(circular/linear).  Assembly level: N50/NG50, total span, contig count.
"""
from __future__ import annotations

import numpy as np


def coverage_profile(contig_len: int, layout, seq_of,
                     bin_size: int = 200) -> np.ndarray:
    """Read coverage per bin from the contig layout."""
    nb = -(-contig_len // bin_size)
    cov = np.zeros(nb + 1, np.int32)
    for read, d, start in layout:
        L = len(seq_of(read, d))
        lo = max(0, start) // bin_size
        hi = min(contig_len, start + L) // bin_size
        if hi > lo:
            cov[lo] += 1
            cov[hi] -= 1
    return np.cumsum(cov)[:nb]


def analyze_contig(contig: np.ndarray, tour, layout, seq_of,
                   repeat_iv: dict | None = None,
                   bin_size: int = 200) -> dict:
    cov = coverage_profile(len(contig), layout, seq_of, bin_size)
    low = cov < max(2, int(np.median(cov) * 0.25)) if len(cov) else \
        np.zeros(0, bool)
    low_iv = []
    i = 0
    while i < len(low):
        if low[i]:
            j = i
            while j < len(low) and low[j]:
                j += 1
            low_iv.append((i * bin_size, min(j * bin_size, len(contig))))
            i = j
        else:
            i += 1
    rep_bp = 0
    if repeat_iv:
        for read, d, start in layout:
            iv = repeat_iv.get(read)
            if iv is None or not len(iv):
                continue
            p = iv.reshape(-1, 2)
            rep_bp += int((p[:, 1] - p[:, 0]).sum())
    return {
        "length": int(len(contig)),
        "n_reads": len(layout),
        "circular": bool(tour.circular),
        "mean_coverage": float(cov.mean()) if len(cov) else 0.0,
        "min_coverage": int(cov.min()) if len(cov) else 0,
        "low_coverage_intervals": low_iv[:20],
        "repeat_read_bp": rep_bp,
    }


def assembly_stats(contig_lengths: list[int],
                   genome_size: int | None = None) -> dict:
    ls = sorted(contig_lengths, reverse=True)
    total = sum(ls)
    out = {
        "n_contigs": len(ls),
        "total_bp": total,
        "max": ls[0] if ls else 0,
        "n50": 0,
        "l50": 0,
    }
    half = total / 2
    acc = 0
    for i, x in enumerate(ls):
        acc += x
        if acc >= half:
            out["n50"] = x
            out["l50"] = i + 1
            break
    if genome_size:
        out["ng50"] = 0
        acc = 0
        for x in ls:
            acc += x
            if acc >= genome_size / 2:
                out["ng50"] = x
                break
    return out
