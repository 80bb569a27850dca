"""Stable sorts and sorted-stream helpers (torch port of the parts of
damar_tpu/ops/sort.py that the seeding, the overlap pipeline and the
pile tools call).

Sort keys are int64 tensors holding unsigned values below 2**32 (one
packed word) or below 2**63.  Multi-word keys sort least-significant
word first with stable torch.sort passes, so every sort here is stable
and returns the reference's order exactly.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def host_lexsort(keys) -> np.ndarray:
    """np.lexsort on the host (LAST key primary, stable): the order of
    damar_tpu's host_lexsort, which is np.lexsort or a native radix
    giving the same permutation."""
    return np.lexsort(tuple(keys))


def pack_fields(fields, widths):
    """Bit-concatenate nonnegative integer fields (LSB-first list, each
    < 2**w) into a tuple of uint32 words held in int64 (word 0 = least
    significant)."""
    total = sum(widths)
    nw = -(-total // 32)
    words = [torch.zeros_like(fields[0], dtype=torch.int64)
             for _ in range(nw)]
    off = 0
    for f, w in zip(fields, widths):
        f = f.to(torch.int64) & M32
        wi, bi = off // 32, off % 32
        words[wi] = (words[wi] | (f << bi)) & M32   # bits >= 32 drop out
        if bi + w > 32:
            words[wi + 1] = words[wi + 1] | (f >> (32 - bi))
        off += w
    return tuple(words)


def unpack_field(words, offset: int, width: int) -> torch.Tensor:
    """Extract a field packed by pack_fields (int64)."""
    mask = (1 << width) - 1
    wi, bi = offset // 32, offset % 32
    v = words[wi] >> bi
    if bi + width > 32:
        v = v | (words[wi + 1] << (32 - bi))
    return v & mask


def _permute(order, arrays):
    return tuple(a[order] for a in arrays)


def radix_sort_bits(key: torch.Tensor, payloads):
    """Stable ascending sort of `key` carrying payloads.  Returns
    (key_sorted, payloads_sorted)."""
    ks, order = torch.sort(key, stable=True)
    return ks, _permute(order, payloads)


def radix_sort_packed(words, payloads, total_bits: int):
    """Stable sort by a multi-word key from pack_fields (word 0 least
    significant): one stable pass per word, least significant first.
    Returns (words_sorted, payloads_sorted)."""
    arrays = tuple(words) + tuple(payloads)
    nw = len(words)
    order = None
    for wi in range(nw):
        key = words[wi] if order is None else words[wi][order]
        _, o = torch.sort(key, stable=True)
        order = o if order is None else order[o]
    out = _permute(order, arrays)
    return out[:nw], out[nw:]


def radix_sort_multi(keys, payloads, bits_list: tuple):
    """Stable lexicographic sort by several integer keys, MOST
    significant first (bits_list[i]: the significant bits of keys[i], as
    the reference takes them; a stable pass per key needs no widths).
    Returns (keys_sorted tuple, payloads_sorted tuple)."""
    order = None
    for key in reversed(tuple(keys)):
        k = key if order is None else key[order]
        _, o = torch.sort(k, stable=True)
        order = o if order is None else order[o]
    nk = len(keys)
    out = _permute(order, tuple(keys) + tuple(payloads))
    return out[:nk], out[nk:]


def merge_ranks(a_codes, b_codes, bits: int):
    """For sorted a_codes and sorted b_codes: per b element, lo (the
    count of a codes below it: searchsorted left) and count (the a codes
    equal to it), in b's order.  Codes must be < 2**bits (bits <= 31, the
    reference's merge-key limit)."""
    assert bits <= 31, "merge key must fit 32 bits"
    lo = torch.searchsorted(a_codes, b_codes, right=False)
    return lo, torch.searchsorted(a_codes, b_codes, right=True) - lo


def compact_flagged(live: torch.Tensor, arrays, out_cap: int,
                    fill: int = -1):
    """Compact elements where live is True into a prefix buffer of
    out_cap, preserving their order.  Returns (arrays_out [out_cap],
    n, total): n = min(total, out_cap) valid rows, rows >= n are
    `fill`."""
    sel = torch.nonzero(live).flatten()
    total = int(sel.shape[0])
    n = min(total, out_cap)
    sel = sel[:n]
    out = []
    for a in arrays:
        o = torch.full((out_cap,), fill, dtype=a.dtype, device=a.device)
        o[:n] = a[sel]
        out.append(o)
    return tuple(out), n, total


def seg_starts_from_first(first: torch.Tensor) -> torch.Tensor:
    """Per-element index of its segment's first element, given the
    run-break flags of a sorted stream (first[0] must be True)."""
    idx = torch.arange(first.shape[0], device=first.device)
    return torch.cummax(torch.where(first, idx, 0), 0).values


def seg_last_from_first(first: torch.Tensor) -> torch.Tensor:
    """Per-element index of its segment's LAST element."""
    n = first.shape[0]
    idx = torch.arange(n, device=first.device)
    nxt = torch.where(first, idx, n)
    shifted = torch.cat([nxt[1:], nxt.new_full((1,), n)])
    return torch.cummin(shifted.flip(0), 0).values.flip(0) - 1


def segment_sum_to_elements(values: torch.Tensor, first: torch.Tensor
                            ) -> torch.Tensor:
    """Per-element total of its segment in a sorted stream with run-break
    flags `first` (first[0] True) over nonnegative values: the inclusive
    cumsum at the segment's last element less the one before its first,
    each spread over the segment by a running max (min) of the
    nondecreasing cumsum."""
    cum = torch.cumsum(values, 0)
    cum_prev = torch.cat([cum.new_zeros(1), cum[:-1]])
    base = torch.cummax(torch.where(first, cum_prev, 0), 0).values
    is_last = torch.cat([first[1:], first.new_ones(1)])
    big = torch.iinfo(cum.dtype).max
    cum_last = torch.cummin(torch.where(is_last, cum, big).flip(0),
                            0).values.flip(0)
    return cum_last - base
