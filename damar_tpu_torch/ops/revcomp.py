"""Per-read reverse complement of a block's bases on its device: the
bases of the COMP orientation's twin (core.blocks.revcomp_block's bytes)
made from the block's device-resident forward arrays.

On a CUDA tensor revcomp_bases launches csrc/revcomp.cu's revcomp_kernel
(built and loaded through ctypes, see ops/_cuda.py) or raises; on a CPU
tensor it runs revcomp_plain, the same gather in torch.  `launches` on
revcomp_bases counts kernel launches.
"""
from __future__ import annotations

import torch

from damar_tpu_torch.ops import _cuda


def revcomp_plain(bases, read_id, starts, nbases: int):
    """out[p] = 3 - bases[starts[r] + starts[r + 1] - 1 - p] for p <
    nbases (r = read_id[p]), bases[p] past it: uint8 [cap]."""
    out = bases.clone()
    if nbases:
        p = torch.arange(nbases, device=bases.device)
        r = read_id[:nbases].to(torch.int64)
        src = starts[r] + starts[r + 1] - 1 - p
        out[:nbases] = 3 - bases[src]
    return out


def revcomp_kernel(bases, read_id, starts, nbases: int):
    """Launch revcomp_kernel on the current CUDA stream: the twin's
    uint8 [cap] bases, the only tensor it allocates.  bases uint8 [cap],
    read_id int32 [cap] and starts int64 [nreads + 1] are taken as they
    are (a conversion would allocate a copy of the block): other types,
    shapes or devices raise."""
    cap = bases.shape[0]
    for t, dt in ((bases, torch.uint8), (read_id, torch.int32),
                  (starts, torch.int64)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"revcomp_kernel: want contiguous 1-d {dt}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != bases.device:
            raise ValueError("revcomp_kernel: all tensors must share one "
                             "CUDA device")
    if read_id.shape[0] != cap or not 0 <= nbases <= cap:
        raise ValueError(f"revcomp_kernel: read_id of {read_id.shape[0]} "
                         f"and nbases {nbases} for a block of {cap}")
    out = torch.empty_like(bases)
    err = _cuda.lib().revcomp_launch(
        bases.data_ptr(), out.data_ptr(), read_id.data_ptr(),
        starts.data_ptr(), nbases, cap, _cuda.stream_ptr(bases))
    _cuda.check(err, "revcomp_kernel")
    _cuda.count_launch(revcomp_bases, cap)
    return out


def revcomp_bases(bases, read_id, starts, nbases: int):
    """The reverse-complement twin's bases of a block on bases' device
    (revcomp_kernel on a card, revcomp_plain on the CPU)."""
    if bases.device.type == "cuda":
        return revcomp_kernel(bases, read_id, starts, nbases)
    if bases.device.type == "cpu":
        return revcomp_plain(bases, read_id, starts, nbases)
    raise ValueError(f"unsupported device {bases.device}")


revcomp_bases.launches = 0
