"""Masking (port of damar_tpu/pipeline/masking.py): DUST low-complexity,
tandem (datander/TANmask) and repeat (REPmask/LArepeat) tracks.

All tracks are per-read flat [b,e,...] interval lists in read-local
coordinates, stored via formats.tracks; they feed back into seeding as
soft masks (k-mers starting inside masked intervals are suppressed, the
daligner -m path).  The tandem track runs on the device: the datander
search (ops.seeding.find_tandem_seeds) and K1 (extend_seeds); the rest
is host numpy, as in the reference.  repeat_track_relative ignores
low_mult as the reference does (fault 3d in ROADMAP.md), for parity.
"""
from __future__ import annotations

import numpy as np

from damar_tpu_torch.core.blocks import ReadBlock
from damar_tpu_torch.core.config import MaskConfig, OverlapConfig
from damar_tpu_torch.formats.las import (H_ABPOS, H_AEPOS, H_AREAD,
                                         LasFile, columns_of)
from damar_tpu_torch.formats.tracks import Track
from damar_tpu_torch.ops.seeding import find_tandem_seeds
from damar_tpu_torch.pipeline.overlap import extend_seeds
from damar_tpu_torch.utils.dust import dust_block



def _local_index(aread: np.ndarray, read_index: dict[int, int]
                 ) -> np.ndarray:
    """Vectorized read_index lookup: absolute aread -> local track
    index, -1 where absent."""
    if not read_index:
        return np.full(len(aread), -1, np.int64)
    keys = np.fromiter(read_index.keys(), np.int64, len(read_index))
    vals = np.fromiter(read_index.values(), np.int64, len(read_index))
    o = np.argsort(keys)
    keys, vals = keys[o], vals[o]
    pos = np.searchsorted(keys, aread)
    pos_c = np.minimum(pos, len(keys) - 1)
    ok = keys[pos_c] == aread
    return np.where(ok, vals[pos_c], -1)


def _split_by_read(j: np.ndarray, flat_pairs: np.ndarray,
                   nreads: int) -> list[np.ndarray]:
    """Per-read flat [b0,e0,...] int32 arrays from read-sorted interval
    rows (j ascending, flat_pairs = interleaved starts/ends)."""
    counts = np.bincount(j, minlength=nreads) if len(j) else \
        np.zeros(nreads, np.int64)
    cuts = 2 * np.cumsum(counts)[:-1]
    return [np.ascontiguousarray(seg, np.int32)
            for seg in np.split(flat_pairs, cuts)]


def _coverage_data(j: np.ndarray, b: np.ndarray, e: np.ndarray,
                   rlen_of: np.ndarray, nreads: int,
                   threshold: int) -> list[np.ndarray]:
    """Columnar coverage_intervals over ALL reads at once: one global
    event scatter + sort + cumsum (no per-record Python objects —
    MARVEL scrub/LArepeat.c's per-pile sweep, vectorized).  Bit-equal
    to coverage_intervals per read (differentially tested)."""
    m = len(j)
    if m == 0:
        return [np.zeros(0, np.int32) for _ in range(nreads)]
    jj = np.concatenate([j, j]).astype(np.int64)
    pos = np.concatenate([b, e]).astype(np.int64)
    d = np.concatenate([np.ones(m, np.int64), -np.ones(m, np.int64)])
    # event order matches the scalar sweep: (read, pos, delta) with
    # -1 before +1 at equal positions
    key = (jj << 34) | (pos << 1) | (d > 0)
    o = np.argsort(key, kind="stable")
    jj, pos, d = jj[o], pos[o], d[o]
    # each read's deltas sum to zero, so a single global cumsum is the
    # per-read running coverage (it returns to 0 at every boundary)
    cum = np.cumsum(d)
    above = cum >= threshold
    prev = np.empty(len(jj), bool)
    prev[0] = False
    prev[1:] = above[:-1]
    first = np.empty(len(jj), bool)
    first[0] = True
    first[1:] = jj[1:] != jj[:-1]
    prev[first] = False
    starts_m = above & ~prev
    ends_m = ~above & prev
    sj, sp = jj[starts_m], pos[starts_m]
    ej, ep = jj[ends_m], pos[ends_m]
    rlen64 = np.asarray(rlen_of).astype(np.int64)
    # a start can stay open through the last event only when the
    # threshold is <= 0 (coverage ends at 0): close it at rlen, and
    # exempt such tail pairs from the zero-length filter (scalar
    # semantics)
    tail = np.zeros(len(ej), bool)
    s_cnt = np.bincount(sj, minlength=nreads)
    e_cnt = np.bincount(ej, minlength=nreads)
    open_reads = np.nonzero(s_cnt > e_cnt)[0]
    if len(open_reads):
        ej = np.concatenate([ej, open_reads])
        ep = np.concatenate([ep, rlen64[open_reads]])
        tail = np.concatenate([tail, np.ones(len(open_reads), bool)])
        o2 = np.lexsort((tail, ep, ej))
        ej, ep, tail = ej[o2], ep[o2], tail[o2]
    keep = (ep > sp) | tail
    sj, sp, ep = sj[keep], sp[keep], np.minimum(ep, rlen64[sj])[keep]
    flat = np.empty(2 * len(sp), np.int64)
    flat[0::2] = sp
    flat[1::2] = ep
    return _split_by_read(sj, flat, nreads)


def dust_track(seqs: list[np.ndarray], cfg: MaskConfig) -> Track:
    """DBdust equivalent over a list of read sequences."""
    return Track(name="dust",
                 data=dust_block(seqs, cfg.dust_window, cfg.dust_thresh))


def tandem_track(blk: ReadBlock, ocfg: OverlapConfig, cfg: MaskConfig,
                 max_period: int = 2000, hit_cap: int | None = None,
                 seed_cap: int | None = None, stats: dict | None = None, *,
                 device) -> Track:
    """datander + TANmask equivalent for one block.

    Self-seeds on positive diagonals are extended with K1 (extend_seeds);
    each alignment of a read against itself at offset p covers the
    tandem interval [bbpos, aepos) (the union of the two copies).
    Intervals >= tan_min_len are merged per read.  hit_cap/seed_cap:
    find_tandem_seeds' hard caps (None: buffers sized from the counts).
    stats: a dict to fill with the seeding's counts and the extents.
    device (keyword-only, no default): where the search runs.
    """
    seeds = find_tandem_seeds(blk, ocfg, max_period=max_period,
                              hit_cap=hit_cap, seed_cap=seed_cap,
                              device=device)
    exts = extend_seeds(blk, blk, seeds, ocfg, device=device)
    if stats is not None:
        stats.update({k: seeds[k] for k in (
            "nhits", "total_hits", "nseeds", "total_seeds", "hit_buffer",
            "seed_buffer", "pieces")}, extents=exts["n"])
    sel = np.nonzero(exts["aread"] == exts["bread"])[0]
    j = exts["aread"][sel].astype(np.int64)
    lo = np.minimum(exts["abpos"][sel], exts["bbpos"][sel]).astype(np.int64)
    hi = np.maximum(exts["aepos"][sel], exts["bepos"][sel]).astype(np.int64)
    keep = hi - lo >= cfg.tan_min_len
    j, lo, hi = j[keep], lo[keep], hi[keep]
    data = _merge_intervals_by_read(j, lo, hi, blk.nreads)
    return Track(name="tan", data=data)


def _merge_intervals_by_read(j: np.ndarray, lo: np.ndarray,
                             hi: np.ndarray, nreads: int
                             ) -> list[np.ndarray]:
    """Union of intervals per read in ONE sorted-array pass (the
    per-read merge_interval_lists loop, vectorized).  Intervals with
    lo <= running max end of the current group merge (tracks.py
    merge rule)."""
    if len(j) == 0:
        return [np.zeros(0, np.int32) for _ in range(nreads)]
    o = np.lexsort((hi, lo, j))
    j, lo, hi = j[o], lo[o], hi[o]
    # per-read frames via a big per-read offset: a plain running max
    # then never crosses read boundaries, and within a read it equals
    # the current GROUP's running end (a new group only starts past it)
    big = int(max(hi.max(), lo.max()) + 2)
    loo = lo + j * big
    run = np.maximum.accumulate(hi + j * big)
    newgrp = np.empty(len(loo), bool)
    newgrp[0] = True
    newgrp[1:] = loo[1:] > run[:-1]
    last = np.empty(len(loo), bool)
    last[:-1] = newgrp[1:]
    last[-1] = True
    gj = j[newgrp]
    glo = lo[newgrp]
    ghi = run[last] - gj * big
    flat = np.empty(2 * len(glo), np.int64)
    flat[0::2] = glo
    flat[1::2] = ghi
    return _split_by_read(gj, flat, nreads)


def coverage_intervals(events: list[tuple[int, int]], rlen: int,
                       threshold: int) -> np.ndarray:
    """Intervals of a read where alignment coverage >= threshold, from
    (abpos, aepos) event pairs."""
    if not events:
        return np.zeros(0, np.int32)
    pts = []
    for b, e in events:
        pts.append((b, 1))
        pts.append((e, -1))
    pts.sort()
    out = []
    cov = 0
    start = None
    for x, d in pts:
        cov += d
        if cov >= threshold and start is None:
            start = x
        elif cov < threshold and start is not None:
            if x > start:
                out.append((start, min(x, rlen)))
            start = None
    if start is not None:
        out.append((start, rlen))
    return np.array(out, np.int32).reshape(-1)


def repeat_track_coverage(las: LasFile, rlen_of: np.ndarray,
                          read_index: dict[int, int], nreads: int,
                          cov: int, name: str = "rep") -> Track:
    """REPmask equivalent: A-read intervals covered by >= cov
    alignments become repeat intervals.

    read_index maps absolute read id -> local track index.
    """
    h = columns_of(las).headers
    j = _local_index(h[:, H_AREAD], read_index)
    sel = j >= 0
    data = _coverage_data(j[sel], h[sel, H_ABPOS], h[sel, H_AEPOS],
                          rlen_of, nreads, cov)
    return Track(name=name, data=data)


def repeat_track_relative(las: LasFile, rlen_of: np.ndarray,
                          read_index: dict[int, int], nreads: int,
                          low_mult: float = 1.5, high_mult: float = 2.0,
                          name: str = "repeats") -> Track:
    """LArepeat equivalent: repeat threshold relative to the dataset's
    expected coverage (estimated as the median per-base coverage of
    reads with any alignment)."""
    h = columns_of(las).headers
    j = _local_index(h[:, H_AREAD], read_index)
    sel = j >= 0
    jj = j[sel]
    b = h[sel, H_ABPOS].astype(np.int64)
    e = h[sel, H_AEPOS].astype(np.int64)
    tot = np.bincount(jj, weights=(e - b).astype(np.float64),
                      minlength=nreads)
    has = np.bincount(jj, minlength=nreads) > 0
    rl = np.asarray(rlen_of).astype(np.int64)
    ok = has & (rl > 0)
    est = float(np.median(tot[ok] / rl[ok])) if ok.any() else 0.0
    thr = max(2, int(round(est * high_mult)))
    data = _coverage_data(jj, b, e, rlen_of, nreads, thr)
    t = Track(name=name, data=data)
    t.expected_coverage = est  # type: ignore[attr-defined]
    return t
