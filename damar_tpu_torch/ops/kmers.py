"""K-mer codes over a block's base array (torch port of
damar_tpu/ops/kmers.py: kmer_codes, the forward codes the datander
search indexes, and kmer_codes_canonical).

A k-mer starting at position i is valid iff its window lies within one
read (read_id[i] == read_id[i+k-1]), its start is a real base, and no
soft mask covers the start.  Codes are held in int64 (2k <= 30 bits).
"""
from __future__ import annotations

import numpy as np
import torch


def invalid_code(k: int) -> int:
    """Sentinel code for invalid windows: 4**k, one past the largest
    valid code, so it sorts last."""
    return 1 << (2 * k)


def _valid_windows(bases, read_id, k: int, mask):
    n = bases.shape[0]
    valid = read_id == torch.roll(read_id, -(k - 1))
    valid &= torch.arange(n, device=bases.device) <= n - k
    valid &= bases < 4
    if mask is not None:
        valid &= ~mask
    return valid


def kmer_codes(bases: torch.Tensor, read_id: torch.Tensor, k: int,
               mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward (non-canonical) codes per window.  Returns (codes
    int64[N], valid bool[N]); invalid windows get invalid_code(k)."""
    b = bases.to(torch.int64) & 3
    code = torch.zeros(bases.shape[0], dtype=torch.int64,
                       device=bases.device)
    for j in range(k):
        code = ((code << 2) | torch.roll(b, -j)) & 0xFFFFFFFF
    valid = _valid_windows(bases, read_id, k, mask)
    return torch.where(valid, code, invalid_code(k)), valid


def kmer_codes_canonical(bases: torch.Tensor, read_id: torch.Tensor,
                         k: int, mask: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical codes min(code, revcomp code) per window plus the
    strand bit (True = the reverse complement was smaller).  A match
    between windows whose strand bits differ is a comp-orientation hit.
    Returns (codes int64[N], strand bool[N]); invalid windows get
    invalid_code(k) and strand False."""
    n = bases.shape[0]
    b = bases.to(torch.int64) & 3
    code = torch.zeros(n, dtype=torch.int64, device=bases.device)
    rc = torch.zeros_like(code)
    for j in range(k):
        bj = torch.roll(b, -j)
        code = ((code << 2) | bj) & 0xFFFFFFFF
        rc = rc | ((3 - bj) << (2 * j))
    rc = rc & 0xFFFFFFFF
    valid = _valid_windows(bases, read_id, k, mask)
    strand = valid & (rc < code)
    canon = torch.minimum(code, rc)
    codes = torch.where(valid, canon, torch.full_like(canon,
                                                      invalid_code(k)))
    return codes, strand


def mask_vector_from_track(track_data: list[np.ndarray],
                           starts: np.ndarray, cap: int) -> np.ndarray:
    """Host side: expand per-read mask intervals (flat [b, e, ...] lists,
    read-local coordinates, clipped to the read) into a block's bool[cap]
    suppression vector (the daligner -m soft-mask input)."""
    out = np.zeros(cap, dtype=bool)
    for j, iv in enumerate(track_data):
        if len(iv) == 0:
            continue
        s = int(starts[j])
        e = int(starts[j + 1])
        for b, t in iv.reshape(-1, 2):
            out[min(s + int(b), e):min(s + int(t), e)] = True
    return out
