"""DUST-style low-complexity masking (the DBdust equivalent; port of
damar_tpu/utils/dust.py, numpy on the host).

A window of `window` bases holds w = window - 2 triplets; its score is
sum_t c_t*(c_t-1)/2 / (w-1) over the window's triplet counts c_t, and
windows scoring above the threshold are masked (window starts expanded
to base intervals and merged).  The reference counts c_t with a one-hot
[m+1, 64] prefix per read (256 bytes streamed per base).  Here
sum_t c_t*(c_t-1)/2 is counted as what it is, the pairs of equal
triplets inside the window: with B[j] (F[i]) the pairs (i, j) of equal
triplets at distance j - i < w ending at j (starting at i), the window
at start s holds sum(B[:s+w]) - sum(F[:s]) pairs.  B and F take one
pass over a group of reads per distance (w - 1 passes of a byte
compare) instead of 64 counters per base, and every window of the group
is scored at once.  The intervals
are the reference's exactly (tests/test_torch_masking.py).  damar_tpu
first tries its native C replica (dust_batch), which gives the same
intervals; the port has no native layer.
"""
from __future__ import annotations

import numpy as np

# triplets per group of reads scored together (bounds the pass arrays)
GROUP_TRIPLETS = 1 << 23


def triplet_codes(codes: np.ndarray) -> np.ndarray:
    if len(codes) < 3:
        return np.zeros(0, np.int32)
    c = codes.astype(np.int32)
    return (c[:-2] << 4) | (c[1:-1] << 2) | c[2:]


def _dust_group(seqs: list[np.ndarray], window: int, thresh: float
                ) -> list[np.ndarray]:
    """dust intervals of reads that each hold >= window triplets."""
    w = window - 2
    m = np.array([len(s) - 2 for s in seqs], np.int64)
    # each read's triplets, then w separator codes 64 .. 64 + w - 1: no
    # separator equals a triplet or another separator closer than w.
    # Bytes while the separators fit in one (w <= 192).
    po = np.concatenate([[0], np.cumsum(m + w)])
    t = np.concatenate([np.concatenate([triplet_codes(s),
                                        64 + np.arange(w)])
                        for s in seqs]).astype(
        np.uint8 if 64 + w <= 256 else np.int32)
    # B[j] pairs (i, j) and F[i] pairs (i, j) of equal triplets at
    # distance d = j - i < w, one pass per distance; each is at most
    # w - 1, which int8 holds while w <= 128
    cnt = np.int8 if w <= 128 else np.int32
    B = np.zeros(len(t), cnt)
    F = np.zeros(len(t), cnt)
    for d in range(1, w):
        eq = t[d:] == t[:-d]
        B[d:] += eq
        F[:-d] += eq
    # pairs in the window at start g: those ending by g + w - 1 less
    # those starting before g (which all end by then)
    cb = np.concatenate([[0], np.cumsum(B, dtype=np.int64)])
    cf = np.concatenate([[0], np.cumsum(F, dtype=np.int64)])
    g = np.arange(len(t) - w + 1)
    rid = np.repeat(np.arange(len(seqs)), m + w)[:len(g)]
    start = g - po[rid]                      # window start in its read
    hot = (start <= m[rid] - w) & ((cb[g + w] - cf[g]).astype(np.float64)
                                   / max(w - 1, 1) > thresh)
    hs, hr = start[hot], rid[hot]
    first = np.ones(len(hs), bool)
    first[1:] = (hr[1:] != hr[:-1]) | (np.diff(hs) > window)
    last = np.ones(len(hs), bool)
    last[:-1] = first[1:]
    n = m + 2                                # read lengths
    iv = np.empty(2 * int(first.sum()), np.int64)
    iv[0::2] = hs[first]
    iv[1::2] = np.minimum(hs[last] + window, n[hr[last]])
    cuts = 2 * np.searchsorted(hr[first], np.arange(1, len(seqs)))
    return [x.astype(np.int32) for x in np.split(iv, cuts)]


def dust_block(seqs: list[np.ndarray], window: int = 64,
               thresh: float = 2.0) -> list[np.ndarray]:
    """Flat [b,e,...] mask intervals for each read (int32)."""
    out = [np.zeros(0, np.int32) for _ in seqs]
    todo = [k for k, s in enumerate(seqs) if len(s) - 2 >= window]
    lo = 0
    while lo < len(todo):
        hi, n = lo, 0
        while hi < len(todo) and (hi == lo or n + len(seqs[todo[hi]])
                                  <= GROUP_TRIPLETS):
            n += len(seqs[todo[hi]])
            hi += 1
        grp = todo[lo:hi]
        for k, iv in zip(grp, _dust_group([seqs[k] for k in grp], window,
                                          thresh)):
            out[k] = iv
        lo = hi
    return out


def dust_read(codes: np.ndarray, window: int = 64,
              thresh: float = 2.0) -> np.ndarray:
    """Flat [b,e,...] mask intervals for one read."""
    return dust_block([codes], window, thresh)[0]
