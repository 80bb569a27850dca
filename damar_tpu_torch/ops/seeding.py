"""Seed hit detection: canonical k-mer index merge + diagonal banding.

Torch port of damar_tpu/ops/seeding.py: find_seeds_canonical_dev with
every path it takes, and the datander search.  The reference's sorts and
scans are XLA-level array code, so they stay torch ops here; seeds and
their order equal the reference's.

The packed path (a block's payload fits 32 bits):
  1. index: canonical k-mer codes of the A block, stably sorted with a
     packed u32 payload  mp = rid << (1 + rpos_bits) | rpos << 1 | strand;
  2. count: per-B-tuple matching A runs (match_count, or the per-run
     rank trick of match_count_self for a self pair);
  3. fill: hits materialized into a hit buffer by run expansion
     (match_fill_packed);
  4. banding: hits sorted by (ar, br, strand, bucket, arpos), novel
     k-mer coverage summed per band, each band scored with its
     predecessor band, and the first hit of every band reaching hit_min
     kept as its anchor seed (diagonal_filter_packed).
Above _SLICE_CAP hits the fill and the banding run per slice of B reads
(_find_seeds_sliced), which gives the same seeds in the same order.

The legacy path (read ordinal, read position and strand need more than
32 bits, as in a block of ~32,800 reads holding a read of 32,768 bp or
more): block positions with the strand bit as
payload (build_index_canonical), the positional fill (match_fill), and
the double-bucketed banding with the strand in the key
(diagonal_filter_comp).  -b (bias_lut) weights each band's novel
coverage by the A block's base composition on every path.

The datander search (find_tandem_seeds) runs the forward, unpacked
form of the same stages: a forward k-mer index with block positions as
payload (build_index), the self merge (match_count), the B-tuple-major
fill (match_fill) and the double-bucketed banding restricted to one
read and a diagonal window (diagonal_filter).  Its buffers are sized
from the counts, not capped as the reference's are (fault 3g in
ROADMAP.md; explicit caps reproduce the reference's truncation); above
_SLICE_CAP hits it runs by ranges of reads.

The reference's plain API (one orientation, forward codes, block
positions: match_hits, compact_hits, compact_hits_packed,
find_seeds_dev, find_seeds) is here too, on no pipeline path.  The ring
sweep seeds with find_seeds_canonical_dev, given both indexes
(b_index: B's travels the ring) and, on the rotation that pairs a
block with itself, suppress_equal (or equal_upper under -I).

Out-of-range gathers: JAX clamps gather indices; every index below is
clipped where the reference clips, explicitly or implicitly.
"""
from __future__ import annotations

import numpy as np
import torch

from damar_tpu_torch.ops.kmers import (invalid_code, kmer_codes,
                                       kmer_codes_canonical)
from damar_tpu_torch.ops.sort import (M32, compact_flagged, pack_fields,
                                      radix_sort_bits, radix_sort_packed,
                                      seg_last_from_first,
                                      seg_starts_from_first,
                                      segment_sum_to_elements, unpack_field)

_SLICE_CAP = 1 << 27     # hit buffers above this are filled by slices
_SLICE_CHUNK = 1 << 26   # tuples compacted at a time in the sliced path
DEAD_MP = 0xFFFFFFFF     # payload of a dead hit row
# damar_tpu's find_tandem_seeds buffer caps (ops/seeding.py:422); passed
# explicitly they reproduce its truncation
REF_TANDEM_HIT_CAP = 1 << 20
REF_TANDEM_SEED_CAP = 1 << 15


def quantize_bits(n: int, step: int = 4) -> int:
    """Bit width for values in [0, n], rounded up to a multiple of
    `step` (the reference's sort-shape bucketing)."""
    b = max(int(n).bit_length(), 1)
    return -(-b // step) * step


def payload_bits(blk) -> tuple[int, int]:
    """(rid_bits, rpos_bits) of a block's packed payload."""
    rid_bits = max(int(blk.nreads).bit_length(), 1)
    max_rlen = int(blk.rlen.max()) if blk.nreads else 1
    rpos_bits = max(int(max_rlen).bit_length(), 1)
    return rid_bits, rpos_bits


def packed_payload_base(read_id, starts, nreads: int, cap: int,
                        rid_bits: int, rpos_bits: int) -> np.ndarray:
    """u32[cap] packed payload base (strand bit clear).  Padding tail
    positions are clamped into the rpos field; their k-mers are invalid
    and never produce hits."""
    rid = read_id.astype(np.uint32)
    starts64 = np.asarray(starts, dtype=np.int64)
    rpos = (np.arange(cap, dtype=np.int64)
            - starts64[np.minimum(read_id, nreads)])
    rpos = np.clip(rpos, 0, (1 << rpos_bits) - 1).astype(np.uint32)
    return (rid << np.uint32(1 + rpos_bits)) | (rpos << np.uint32(1))


def packed_payload_host(blk):
    """Per-position packed payload base of a block, cached on it.
    Returns (mp_base, rid_bits, rpos_bits), or None when the fields
    exceed 32 bits (the block then takes the legacy path)."""
    if "mp_base" in blk.cache:
        return blk.cache["mp_base"]
    rid_bits, rpos_bits = payload_bits(blk)
    if rid_bits + rpos_bits + 1 > 32:
        blk.cache["mp_base"] = None
        return None
    mp = packed_payload_base(blk.read_id, blk.starts, blk.nreads,
                             blk.cap, rid_bits, rpos_bits)
    res = (mp, rid_bits, rpos_bits)
    blk.cache["mp_base"] = res
    return res


def build_index_canonical_packed(bases, read_id, mp_base, k: int,
                                 mask=None):
    """Sorted canonical k-mer index with the packed payload: the stable
    sort keeps each code run in block-position order."""
    codes, strand = kmer_codes_canonical(bases, read_id, k, mask)
    codes_s, (mp_s,) = radix_sort_bits(codes,
                                       (mp_base | strand.to(torch.int64),))
    return codes_s, mp_s


def build_index_canonical(bases, read_id, k: int, mask=None):
    """Sorted canonical k-mer index of the legacy path: the payload is
    the block position with the strand bit below it, pos << 1 | strand
    (monotone in pos, so each code run stays in block-position order).
    Returns (codes_sorted, pos2_sorted)."""
    codes, strand = kmer_codes_canonical(bases, read_id, k, mask)
    pos2 = ((torch.arange(bases.shape[0], device=bases.device) << 1)
            | strand.to(torch.int64))
    codes_s, (pos2_s,) = radix_sort_bits(codes, (pos2,))
    return codes_s, pos2_s


def _payload_tensor(mp_base: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(mp_base.astype(np.int64), device=device)


def canonical_index_dev(bases_d, rid_d, blk, k: int, mask=None):
    """Device canonical index of a block: the packed payload when it
    fits 32 bits, else the legacy one.  Returns (tag, index), tag
    ("packed", rid_bits, rpos_bits) or "legacy"; find_seeds_canonical_dev
    takes the pair as a_index."""
    p = packed_payload_host(blk)
    if p is None:
        return "legacy", build_index_canonical(bases_d, rid_d, k, mask)
    mp_base, rid_bits, rpos_bits = p
    idx = build_index_canonical_packed(
        bases_d, rid_d, _payload_tensor(mp_base, bases_d.device), k, mask)
    return ("packed", rid_bits, rpos_bits), idx


def match_count(a_codes, b_codes, k: int, max_count: int = 128):
    """Count phase of the sorted-index merge: per-B-tuple matching A run
    start and length (runs longer than max_count on either side are
    suppressed: the -t cutoff).  Returns (lo, c, cum, total).  The
    reference's positional form takes the payloads too and reads none of
    them, so this serves every path."""
    assert 2 * k + 2 <= 32, "merge key must fit 32 bits (k <= 15)"
    lo = torch.searchsorted(a_codes, b_codes, right=False)
    count_a = torch.searchsorted(a_codes, b_codes, right=True) - lo
    first = torch.cat([torch.ones(1, dtype=torch.bool,
                                  device=b_codes.device),
                       b_codes[1:] != b_codes[:-1]])
    count_b = seg_last_from_first(first) - seg_starts_from_first(first) + 1
    ok = (b_codes != invalid_code(k)) & (count_a <= max_count) \
        & (count_b <= max_count)
    c = torch.where(ok, count_a, 0)
    cum = torch.cumsum(c, 0)
    return lo, c, cum, cum[-1]


def match_count_self(codes, k: int, max_count: int = 128):
    """Count phase for a block against itself: each tuple's matching
    run is its own code segment, and emitting only the [lo, lo+rank)
    prefix yields exactly the upper-triangle hits (apos < bpos) with the
    trivial self-diagonal excluded.  Same returns as match_count."""
    n = codes.shape[0]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=codes.device),
                       codes[1:] != codes[:-1]])
    lo = seg_starts_from_first(first)
    cnt = seg_last_from_first(first) - lo + 1
    rank = torch.arange(n, device=codes.device) - lo
    ok = (codes != invalid_code(k)) & (cnt <= max_count)
    c = torch.where(ok, rank, 0)
    cum = torch.cumsum(c, 0)
    return lo, c, cum, cum[-1]


def _pow2_cap(want: int, cap: int, floor: int = 1 << 17) -> int:
    """Smallest quarter-power-of-two buffer >= want, floored and
    capped (the reference's buffer sizing, so caps and truncation
    behaviour match)."""
    c = floor
    while c < want and c < cap:
        c *= 2
    if c > floor:
        q = c // 4
        c = max(min(-(-want // q) * q, c), floor)
    return min(c, cap)


def _hit_buffer(total: int, hit_cap: int | None,
                raw_hint: int | None) -> int:
    """The hit buffer of a pair whose count phase found `total` hits:
    sized from the total when hit_cap is None (raw_hint is then not
    read), else the reference's capped buffer."""
    if hit_cap is None:
        return _pow2_cap(total, max(total, _SLICE_CAP))
    return _pow2_cap(min(total if raw_hint is None else raw_hint, hit_cap),
                     hit_cap)


def match_fill_packed(a_mp, b_mp, lo, c, cum, hit_cap: int,
                      tcap: int | None = None):
    """Materialize packed (A payload, B payload) hit pairs from a
    match_count result, B-tuple-major, into a hit_cap buffer.

    The reference's v5 form: the emitting tuples (c > 0) are compacted
    to the front in order and cut to tcap; each per-tuple value expands
    to its run by scattering the telescoping difference v[t] - v[t-1]
    at the run start and prefix-summing (runs tile the buffer, so this
    equals the run expansion; runs starting at or past hit_cap land in
    the excluded slot).  Two expansions: the A-index shift (lo - start)
    and the B payload; the A payload is gathered at the clipped A index.
    Returns (ap_mp, bp_mp, nhits, total, n_emit); dead rows DEAD_MP."""
    total = int(cum[-1]) if cum.numel() else 0
    starts = cum - c
    nz = c > 0
    n_emit = int(nz.sum())
    if tcap is None:
        tcap = hit_cap
    sel = torch.nonzero(nz).flatten()[:tcap]
    s0c = torch.clamp(starts[sel], max=hit_cap)

    def expand(vc):
        d = vc - torch.cat([vc.new_zeros(1), vc[:-1]])
        w = torch.zeros(hit_cap + 1, dtype=torch.int64, device=vc.device)
        w.index_add_(0, s0c, d)
        return torch.cumsum(w[:hit_cap], 0)

    shift = expand((lo - starts)[sel])
    e_bmp = expand(b_mp[sel])
    del sel, s0c
    hit0 = torch.arange(hit_cap, device=a_mp.device)
    ap_mp = a_mp[(hit0 + shift).clamp(0, a_mp.shape[0] - 1)]
    del shift
    nhits = min(total, hit_cap)
    live = hit0 < nhits
    del hit0
    return (torch.where(live, ap_mp, DEAD_MP),
            torch.where(live, e_bmp & M32, DEAD_MP), nhits, total, n_emit)


def bias_weight_lut(bases) -> np.ndarray:
    """daligner -b: per-base information weights (x256 fixed point) from
    the block's composition: a base contributes -log2(freq)/2 bases of
    band coverage, clipped to [32, 1024]; uniform composition gives 256
    a base.  Host numpy, as the reference computes it."""
    b = np.asarray(bases)
    cnt = np.bincount(b[b < 4], minlength=4).astype(np.float64)
    f = cnt / max(cnt.sum(), 1.0)
    w = np.round(256.0 * (-np.log2(np.maximum(f, 1e-9)) / 2.0))
    return np.clip(w, 32, 1024).astype(np.uint32)


def _bias_prefix_dev(bases, lut) -> torch.Tensor:
    """Prefix [cap + 1] of the per-base weights of `lut` (padding bases
    weigh 0).  The reference's is a u32 prefix that wraps mod 2^32; this
    one is int64 and does not wrap, and the short-range differences the
    banding takes are the same."""
    b = bases.to(torch.int64)
    lut_t = torch.as_tensor(np.asarray(lut, dtype=np.int64),
                            device=bases.device)
    w = torch.where(b < 4, lut_t[b.clamp(max=3)], 0)
    return torch.cat([w.new_zeros(1), torch.cumsum(w, 0)])


def _novel_cov(pos_s, first, kmer: int, wprefix=None):
    """Per hit of a band-sorted stream (`first` marks each band's first
    hit): the bases its k-mer adds to its band's coverage, min(pos -
    previous pos, kmer) and kmer for a band's first hit.  With wprefix
    (-b; pos_s then block positions) the weighted bases of the new
    interval [max(prev + kmer, pos), pos + kmer) instead."""
    prev = torch.cat([pos_s[:1], pos_s[:-1]])
    if wprefix is None:
        cov = torch.where(first, kmer, torch.clamp(pos_s - prev, max=kmer))
    else:
        hi = (pos_s + kmer).clamp(max=wprefix.shape[0] - 1)
        lo = torch.where(first, pos_s, torch.maximum(prev + kmer, pos_s))
        lo = torch.minimum(lo.clamp(min=0), hi)
        cov = wprefix[hi] - wprefix[lo]
    return cov.clamp(min=0)


def diagonal_filter_packed(ap_mp, bp_mp, nhits: int,
                           a_rid_bits: int, a_rpos_bits: int,
                           b_rid_bits: int, b_rpos_bits: int,
                           read_bits: int, band_shift: int,
                           hit_min: int, kmer: int, seed_cap: int,
                           upper_only: bool, include_self: bool = False,
                           wprefix=None, a_starts=None,
                           suppress_equal: bool = False,
                           equal_upper: bool = False):
    """Single-bucket banding over packed hits: sort by the packed
    (arpos, bucket, strand, br, ar) key (arpos least significant), sum
    novel k-mer coverage per band, score each band as cov(band-1) +
    cov(band), and keep the first hit of every band reaching hit_min.
    wprefix (-b, with a_starts): the coverage is weighted over block
    positions (a_starts[ar] + arpos) and the threshold is hit_min * 256.
    suppress_equal: drop hits of a read against itself (the ring's
    rotation that pairs a block with itself, where upper_only is off).
    equal_upper: keep a read against itself only where arpos < brpos,
    the pairs a self merge gives (the same rotation under -I: no
    trivial diagonal, no transposed copies).
    Returns (ar, br, arpos, brpos, score, comp, nseeds, total_seeds) in
    read-local coordinates (dead rows -1, score/comp 0)."""
    n = ap_mp.shape[0]
    dev = ap_mp.device
    a_mask = (1 << a_rpos_bits) - 1
    b_mask = (1 << b_rpos_bits) - 1
    ar = ap_mp >> (1 + a_rpos_bits)
    arp = (ap_mp >> 1) & a_mask
    br = bp_mp >> (1 + b_rpos_bits)
    brp = (bp_mp >> 1) & b_mask
    strand = (ap_mp ^ bp_mp) & 1
    live = torch.arange(n, device=dev) < nhits
    if upper_only:
        live &= (ar <= br) if include_self else (ar < br)
    if suppress_equal:
        live &= ar != br
    if equal_upper:
        live &= (ar != br) | (arp < brp)
    rpb = max(a_rpos_bits, b_rpos_bits)
    # fwd diagonal arpos - brpos (offset nonnegative); comp ANTI-diagonal
    # arpos + brpos: both constant along an overlap line
    diag = torch.where(strand == 1, arp + brp, arp - brp + (1 << rpb))
    bucket = diag >> band_shift
    del diag
    bucket_bits = rpb + 2 - band_shift
    dead_read = (1 << read_bits) - 1
    ar_k = torch.where(live, ar, dead_read)
    br_k = torch.where(live, br, dead_read)
    del ar, br, live
    widths = (a_rpos_bits, bucket_bits, 1, read_bits, read_bits)
    words = pack_fields((arp, bucket, strand, br_k, ar_k), widths)
    del arp, bucket, strand, br_k, ar_k
    assert len(words) <= 2, "band key exceeds 64 bits"
    words_s, (brp_s,) = radix_sort_packed(words, (brp,), sum(widths))
    del words, brp
    arp_s = unpack_field(words_s, 0, a_rpos_bits)
    off = a_rpos_bits + bucket_bits + 1
    ar_s = unpack_field(words_s, off + read_bits, read_bits)
    # band identity = the key bits above the arpos field, as u32 halves
    if len(words_s) == 1:
        B_lo = words_s[0] >> a_rpos_bits
        B_hi = torch.zeros_like(B_lo)
    else:
        B_lo = ((words_s[0] >> a_rpos_bits)
                | (words_s[1] << (32 - a_rpos_bits))) & M32
        B_hi = words_s[1] >> a_rpos_bits
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, (B_lo[1:] != B_lo[:-1])
                       | (B_hi[1:] != B_hi[:-1])])
    if wprefix is None:
        cov = _novel_cov(arp_s, first, kmer)
        thresh = hit_min
    else:
        ab = a_starts[ar_s.clamp(max=a_starts.shape[0] - 1)] + arp_s
        cov = _novel_cov(ab, first, kmer, wprefix)
        thresh = hit_min * 256
        del ab
    del arp_s
    seg_sum = segment_sum_to_elements(cov, first)
    del cov
    # adjacent-band window = (previous band, this band): at a segment's
    # first element the previous segment's sum and band id sit one
    # element back
    p_lo = torch.cat([B_lo.new_full((1,), M32), B_lo[:-1]])
    p_hi = torch.cat([B_hi.new_full((1,), M32), B_hi[:-1]])
    p_sum = torch.cat([seg_sum.new_zeros(1), seg_sum[:-1]])
    adj = (((p_lo + 1) & M32) == B_lo) & (p_hi == B_hi)
    del p_lo, p_hi, B_lo, B_hi
    score = seg_sum + torch.where(adj, p_sum, 0)
    del p_sum, adj, seg_sum
    rep = first & (score >= thresh) & (ar_s != dead_read)
    del first, ar_s
    comp, nseeds, total_seeds = compact_flagged(
        rep, tuple(words_s) + (brp_s, score), out_cap=seed_cap, fill=0)
    w_out, brp_out, score_out = comp[:-2], comp[-2], comp[-1]
    keep = torch.arange(seed_cap, device=dev) < nseeds

    def mark(x):
        return torch.where(keep, x, -1)

    out_arp = mark(unpack_field(w_out, 0, a_rpos_bits))
    out_str = torch.where(keep, unpack_field(w_out, a_rpos_bits
                                             + bucket_bits, 1), 0)
    out_br = mark(unpack_field(w_out, off, read_bits))
    out_ar = mark(unpack_field(w_out, off + read_bits, read_bits))
    return (out_ar, out_br, out_arp, mark(brp_out),
            torch.where(keep, score_out, 0), out_str, nseeds, total_seeds)


def seeds_to_block_coords(ar, br, arp, brp, comp, a_starts, b_starts,
                          kmer: int):
    """Read-local seed anchors -> block coordinates (comp seeds' bpos in
    the B read's reverse-complement frame, the extension convention)."""
    dead = ar < 0
    arc = ar.clamp(0, a_starts.shape[0] - 2)
    brc = br.clamp(0, b_starts.shape[0] - 2)
    sap = a_starts[arc] + arp
    blen = b_starts[brc + 1] - b_starts[brc]
    sbp = torch.where(comp == 1, b_starts[brc] + blen - brp - kmer,
                      b_starts[brc] + brp)
    return torch.where(dead, -1, sap), torch.where(dead, -1, sbp)


def starts_tensor(blk, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(blk.starts, dtype=np.int64),
                           device=device)


# ---------------------------------------------------------------------------
# The sliced path (200 Mbp-class pairs): the emitting tuples are
# compacted chunk by chunk, split by B read into two slices (a band never
# crosses a B read, so each slice bands exactly), each slice is filled
# and banded on its own, and one sort of the seeds by their band keys
# restores the unsliced order.  Unlike the reference's, the slices are
# taken exactly (its clamped window duplicates rows on a skewed split:
# fault 3a), a table that is no multiple of the chunk is fine (3b), and
# each slice's buffer is sized from its own hits while an explicit
# hit_cap bounds the pair's total (3c).
# ---------------------------------------------------------------------------

def _compact_emitting_chunked(lo, c, b_mp, chunk: int):
    """The emitting tuples (c > 0) of the tuple table, in order, as
    (lo, c, b_mp) of their own; one chunk of the table at a time, the
    last chunk whatever is left."""
    parts = ([], [], [])
    for s in range(0, c.shape[0], chunk):
        sel = torch.nonzero(c[s:s + chunk] > 0).flatten() + s
        for p, x in zip(parts, (lo, c, b_mp)):
            p.append(x[sel])
    return tuple(torch.cat(p) for p in parts)


def _partition_slices(lo_s, c_s, b_s, br_mid: int, b_rpos_bits: int):
    """Stable two-way partition of the compacted tuples: slice 0 (B read
    < br_mid), then slice 1, each in its original order, so a slice's
    fill sees the unsliced hit order restricted to it.  Returns the
    partitioned (lo, c, b_mp) and n0, slice 0's tuple count."""
    in1 = (b_s >> (1 + b_rpos_bits)) >= br_mid
    order = torch.cat([torch.nonzero(~in1).flatten(),
                       torch.nonzero(in1).flatten()])
    n0 = int(order.shape[0] - in1.sum())
    return lo_s[order], c_s[order], b_s[order], n0


def _sliced_counts(c_s, n0: int) -> tuple[int, int, int, int]:
    """(n0, n1, t0, t1): each slice's tuples and hits in a partitioned
    stream; the hits size the slices' buffers."""
    return (n0, c_s.shape[0] - n0, int(c_s[:n0].sum()),
            int(c_s[n0:].sum()))


def _fill_slice(lo_s, c_s, b_s, a_mp, start: int, n_h: int, cap_h: int):
    """The fill of one slice: rows [start, start + n_h) of the
    partitioned stream expanded into a cap_h buffer, as
    match_fill_packed does.  Returns (ap_mp, bp_mp, nhits)."""
    lo_h, c_h, b_h = (x[start:start + n_h] for x in (lo_s, c_s, b_s))
    ap_mp, bp_mp, nhits, _, _ = match_fill_packed(
        a_mp, b_h, lo_h, c_h, torch.cumsum(c_h, 0), hit_cap=cap_h)
    return ap_mp, bp_mp, nhits


def _merge_seed_slices(parts, a_rpos_bits: int, b_rpos_bits: int,
                       bucket_bits: int, read_bits: int, band_shift: int,
                       seed_cap: int):
    """The slices' seed buffers in the unsliced order: each seed's band
    key rebuilt as diagonal_filter_packed builds it (dead rows all
    ones), one sort, the first seed_cap rows.  Band keys are unique per
    seed, so the sort has no ties."""
    ar, br, arp, brp, score, comp = (torch.cat(x) for x in zip(*parts))
    rpb = max(a_rpos_bits, b_rpos_bits)
    diag = torch.where(comp == 1, arp + brp, arp - brp + (1 << rpb))
    dead = ar < 0
    widths = (a_rpos_bits, bucket_bits, 1, read_bits, read_bits)
    fields = [torch.where(dead, (1 << w) - 1, f) for f, w in
              zip((arp, diag >> band_shift, comp, br, ar), widths)]
    _, pays = radix_sort_packed(pack_fields(fields, widths),
                                (ar, br, arp, brp, score, comp), sum(widths))
    return tuple(p[:seed_cap] for p in pays)


def _find_seeds_sliced(amp, bmp, lo_cnt: list, *, blk_a, blk_b, cfg,
                       hit_cap: int | None, seed_cap: int,
                       a_rid_bits: int, a_rpos_bits: int,
                       b_rid_bits: int, b_rpos_bits: int,
                       upper_only: bool, include_self: bool,
                       a_starts, b_starts, wprefix=None,
                       suppress_equal: bool = False,
                       equal_upper: bool = False) -> dict:
    """The fill and banding of find_seeds_canonical_dev by two slices of
    B reads; the same seeds in the same order.  lo_cnt: [lo, cnt], a
    list this function empties, so the table-scale tensors go as soon as
    the compaction has read them (the caller keeps no reference).
    hit_cap None sizes each slice's buffer from its hits; an explicit
    hit_cap bounds the pair's hits, and more than that is an overflow."""
    lo, cnt = lo_cnt
    lo_cnt.clear()
    stream = _compact_emitting_chunked(lo, cnt, bmp, _SLICE_CHUNK)
    del lo, cnt
    br_mid = max(blk_b.nreads // 2, 1)
    lc, cc, bc, n0 = _partition_slices(*stream, br_mid, b_rpos_bits)
    del stream
    n0, n1, t0, t1 = _sliced_counts(cc, n0)
    if hit_cap is None:
        caps = [t0, t1]
    else:
        caps = [min(t0, hit_cap)]
        caps.append(min(t1, hit_cap - caps[0]))
    caps = [max(x, 1) for x in caps]
    read_bits = quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1)
    parts, nseeds, total_seeds = [], 0, 0
    for start, n_h, cap_h in ((0, n0, caps[0]), (n0, n1, caps[1])):
        ap_mp, bp_mp, nhits = _fill_slice(lc, cc, bc, amp, start, n_h,
                                          cap_h)
        ar, br, arp, brp, score, scomp, ns, ts = diagonal_filter_packed(
            ap_mp, bp_mp, nhits, a_rid_bits=a_rid_bits,
            a_rpos_bits=a_rpos_bits, b_rid_bits=b_rid_bits,
            b_rpos_bits=b_rpos_bits, read_bits=read_bits,
            band_shift=cfg.band_shift, hit_min=cfg.hit_min, kmer=cfg.kmer,
            seed_cap=seed_cap, upper_only=upper_only,
            include_self=include_self, wprefix=wprefix, a_starts=a_starts,
            suppress_equal=suppress_equal, equal_upper=equal_upper)
        del ap_mp, bp_mp
        parts.append((ar, br, arp, brp, score, scomp))
        nseeds, total_seeds = nseeds + ns, total_seeds + ts
    del lc, cc, bc
    rpb = max(a_rpos_bits, b_rpos_bits)
    ar, br, arp, brp, score, scomp = _merge_seed_slices(
        parts, a_rpos_bits=a_rpos_bits, b_rpos_bits=b_rpos_bits,
        bucket_bits=rpb + 2 - cfg.band_shift, read_bits=read_bits,
        band_shift=cfg.band_shift, seed_cap=seed_cap)
    sap, sbp = seeds_to_block_coords(ar, br, arp, brp, scomp, a_starts,
                                     b_starts, cfg.kmer)
    total = t0 + t1
    return {
        "path": "sliced", "aread": ar, "bread": br, "apos": sap,
        "bpos": sbp, "cov": score, "comp": scomp,
        "nseeds": min(nseeds, seed_cap), "total_seeds": total_seeds,
        "total_hits": total, "total_compact": total,
        "total_emit": n0 + n1, "tcap": n0 + n1,
        "overflow": bool(total_seeds > seed_cap
                         or (hit_cap is not None and total > hit_cap)),
        "raw_cap": total if hit_cap is None else hit_cap,
        "compact_cap": max(caps),
        "slices": [dict(tuples=n, hits=t, buffer=c)
                   for n, t, c in ((n0, t0, caps[0]), (n1, t1, caps[1]))],
    }


# ---------------------------------------------------------------------------
# Block positions as payload: the legacy canonical path and the datander
# search share the positional fill and the double-bucketed banding.
# ---------------------------------------------------------------------------

def match_fill(a_pos, b_pos, lo, c, cum, hit_cap: int):
    """Materialize (apos, bpos) hit pairs from a match_count result into
    a buffer of hit_cap, B-tuple-major: each emitting tuple marks its run
    start, a running max gives every hit slot its tuple.  Returns (apos,
    bpos, nhits, total): nhits = min(total, hit_cap) live rows, the
    others -1; total > hit_cap means the buffer truncated the hits."""
    dev = a_pos.device
    total = int(cum[-1])
    starts = cum - c
    put = torch.nonzero((c > 0) & (starts < hit_cap)).flatten()
    mark = torch.zeros(hit_cap, dtype=torch.int64, device=dev)
    mark[starts[put]] = put            # run starts of emitting tuples
    bidx = torch.cummax(mark, 0).values
    del mark, put
    slot = torch.arange(hit_cap, device=dev)
    off = slot - starts[bidx]
    apos = a_pos[(lo[bidx] + off).clamp(0, a_pos.shape[0] - 1)]
    del off
    bpos = b_pos[bidx]
    del bidx
    nhits = min(total, hit_cap)
    live = slot < nhits
    return (torch.where(live, apos, -1), torch.where(live, bpos, -1),
            nhits, total)


def _pos_bits(*caps: int) -> int:
    return max(int(c - 1).bit_length() for c in caps)


def _diag_filter_impl(apos, bpos, nhits: int, a_read_id, b_read_id,
                      pos_bits: int, read_bits: int, band_shift: int,
                      hit_min: int, kmer: int, seed_cap: int,
                      upper_only: bool = False, include_self: bool = False,
                      self_only: bool = False, min_diag=None,
                      max_diag=None, strand=None, wprefix=None,
                      suppress_equal: bool = False, keep=None):
    """The double-bucketed banding over block positions: each hit is
    counted in its band (ar, br, strand, (apos - bpos + B cap) >>
    band_shift) and in the next one up, so a seed straddling a band edge
    is whole in one of them; the band key is sorted with apos least
    significant, novel k-mer coverage summed per band (weighted by
    wprefix for -b, threshold hit_min * 256), and the first hit of every
    band reaching the threshold kept as its seed.  strand: optional comp
    bit per hit, carried in the key.  suppress_equal: drop hits of a read
    against itself.  keep: an optional bool per hit, False drops it.
    self_only (the datander search):
    only a read against itself, keyed by one read field (br equals ar on
    every live row, so the order is the reference's (br, ar) key's).
    Returns (ar, br, apos, bpos, cov[, strand], nseeds, total_seeds),
    tensors of seed_cap (dead rows -1, cov and strand 0)."""
    n = apos.shape[0]
    dev = apos.device
    ar = a_read_id.to(torch.int64)[apos.clamp(min=0)]
    br = b_read_id.to(torch.int64)[bpos.clamp(min=0)]
    diag = apos - bpos
    live = torch.arange(n, device=dev) < nhits
    if upper_only:
        live &= (ar <= br) if include_self else (ar < br)
    if self_only:
        live &= ar == br
    if suppress_equal:
        live &= ar != br
    if keep is not None:
        live &= keep
    if min_diag is not None:
        live &= diag >= min_diag
    if max_diag is not None:
        live &= diag <= max_diag
    dead_read = (1 << read_bits) - 1
    bucket = (diag + b_read_id.shape[0]) >> band_shift
    del diag
    bucket_bits = pos_bits + 2 - band_shift
    twice = lambda x: torch.cat([x, x])  # noqa: E731
    fields = [twice(apos.clamp(min=0)), torch.cat([bucket, bucket + 1])]
    widths = [pos_bits, bucket_bits]
    del bucket
    if strand is not None:
        fields.append(twice(strand.to(torch.int64)))
        widths.append(1)
    if not self_only:
        fields.append(twice(torch.where(live, br, dead_read)))
        widths.append(read_bits)
    fields.append(twice(torch.where(live, ar, dead_read)))
    widths.append(read_bits)
    del ar, br, live
    words = pack_fields(fields, widths)
    del fields
    words_s, (bpos_s,) = radix_sort_packed(words, (twice(bpos),),
                                           sum(widths))
    del words
    apos_s = unpack_field(words_s, 0, pos_bits)
    # band identity = every key field above the apos field
    off, brk = pos_bits, None
    for w in widths[1:]:
        f = unpack_field(words_s, off, w)
        d = f[1:] != f[:-1]
        brk = d if brk is None else brk | d
        off += w
    ar_s = f
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), brk])
    del brk, d
    cov = _novel_cov(apos_s, first, kmer, wprefix)
    thresh = hit_min if wprefix is None else hit_min * 256
    del apos_s
    seg_sum = segment_sum_to_elements(cov, first)
    del cov
    rep = first & (seg_sum >= thresh) & (ar_s != dead_read)
    del first, ar_s, f
    comp, nseeds, total_seeds = compact_flagged(
        rep, tuple(words_s) + (bpos_s, seg_sum), out_cap=seed_cap, fill=0)
    w_out, bp_out, cov_out = comp[:-2], comp[-2], comp[-1]
    keep = torch.arange(seed_cap, device=dev) < nseeds

    def mark(x):
        return torch.where(keep, x, -1)

    off = pos_bits + bucket_bits
    out_str = ()
    if strand is not None:
        out_str = (torch.where(keep, unpack_field(w_out, off, 1), 0),)
        off += 1
    if self_only:
        out_ar = mark(unpack_field(w_out, off, read_bits))
        out_br = out_ar.clone()
    else:
        out_br = mark(unpack_field(w_out, off, read_bits))
        out_ar = mark(unpack_field(w_out, off + read_bits, read_bits))
    return (out_ar, out_br, mark(unpack_field(w_out, 0, pos_bits)),
            mark(bp_out), torch.where(keep, cov_out, 0)) + out_str + (
        nseeds, total_seeds)


def diagonal_filter(apos, bpos, nhits: int, read_id, pos_bits: int,
                    read_bits: int, band_shift: int, hit_min: int,
                    kmer: int, seed_cap: int, min_diag: int,
                    max_diag: int):
    """The datander search's banding: a block's self hits (block
    positions) of a read against itself with min_diag <= apos - bpos <=
    max_diag.  Returns (aread, bread, apos, bpos, cov, nseeds,
    total_seeds)."""
    return _diag_filter_impl(
        apos, bpos, nhits, read_id, read_id, pos_bits, read_bits,
        band_shift, hit_min, kmer, seed_cap, self_only=True,
        min_diag=min_diag, max_diag=max_diag)


def diagonal_filter_comp(apos, bpos, comp, nhits: int, a_read_id,
                         b_read_id, pos_bits: int, read_bits: int,
                         band_shift: int, hit_min: int, kmer: int,
                         seed_cap: int, upper_only: bool,
                         include_self: bool = False, wprefix=None,
                         suppress_equal: bool = False, keep=None):
    """The legacy path's banding over a mixed-orientation hit stream:
    `comp`, the per-hit orientation bit, is carried in the band key, so
    forward and comp hits band apart in one sort; wprefix: -b; keep: an
    optional bool per hit, False drops it.  Returns (ar, br, apos, bpos,
    cov, comp, nseeds, total_seeds)."""
    return _diag_filter_impl(
        apos, bpos, nhits, a_read_id, b_read_id, pos_bits, read_bits,
        band_shift, hit_min, kmer, seed_cap, upper_only=upper_only,
        include_self=include_self, strand=comp, wprefix=wprefix,
        suppress_equal=suppress_equal, keep=keep)


def _split_strand_hits(ap2, bp2, b_rid, b_starts, k: int):
    """Decode legacy (pos << 1 | strand) hit pairs: comp = strand_a XOR
    strand_b, and a comp hit's bpos goes to the B read's reverse-
    complement coordinate start + end - pos - k (the rc block keeps each
    read in place).  Dead rows (payload < 0) stay -1."""
    dead = ap2 < 0
    apos = torch.where(dead, -1, ap2 >> 1)
    bposf = torch.where(dead, 0, bp2 >> 1)
    comp = (((ap2 ^ bp2) & 1) == 1) & ~dead
    r = b_rid.to(torch.int64)[bposf].clamp(0, b_starts.shape[0] - 2)
    bpos = torch.where(comp, b_starts[r] + b_starts[r + 1] - bposf - k,
                       bposf)
    return apos, torch.where(dead, -1, bpos), comp


def _find_seeds_canonical_dev_legacy(blk_a, blk_b, cfg, arrays, mask_a,
                                     mask_b, upper_only: bool,
                                     hit_cap: int | None, seed_cap: int,
                                     a_idx, raw_hint: int | None,
                                     self_pair: bool, bias_lut,
                                     suppress_equal: bool = False,
                                     equal_upper: bool = False) -> dict:
    """The canonical seeding of a pair whose payload exceeds 32 bits:
    block positions through the merge and the fill, the strand split,
    and the double-bucketed banding with the strand in its key.  Its
    hit buffer is sized as the packed path's (not the reference's
    2^21-capped guess, which cuts in silence: fault 3h)."""
    a_bases, a_rid, b_bases, b_rid = arrays
    dev = a_bases.device
    k = cfg.kmer
    ac, ap2 = (a_idx if a_idx is not None
               else build_index_canonical(a_bases, a_rid, k, mask_a))
    t = cfg.max_kmer_count or 128
    if self_pair:
        bp2 = ap2
        lo, cnt, cum, total = match_count_self(ac, k=k, max_count=t)
    else:
        bc, bp2 = build_index_canonical(b_bases, b_rid, k, mask_b)
        lo, cnt, cum, total = match_count(ac, bc, k=k, max_count=t)
        del bc
    total = int(total)     # the tensor is a view that keeps cum alive
    cap = _hit_buffer(total, hit_cap, raw_hint)
    n_emit = int((cnt > 0).sum())
    ap2v, bp2v, nhits, total_hits = match_fill(ap2, bp2, lo, cnt, cum,
                                               hit_cap=cap)
    del lo, cnt, cum
    keep = None
    if equal_upper:
        # forward block positions, before a comp hit's B side is moved
        fa, fb = (ap2v >> 1).clamp(min=0), (bp2v >> 1).clamp(min=0)
        keep = (a_rid[fa] != b_rid[fb]) | (fa < fb)
        del fa, fb
    apos, bpos, comp = _split_strand_hits(ap2v, bp2v, b_rid,
                                          starts_tensor(blk_b, dev), k)
    del ap2v, bp2v
    wprefix = (_bias_prefix_dev(a_bases, bias_lut) if bias_lut is not None
               else None)
    ar, br, sap, sbp, cov, scomp, nseeds, total_seeds = \
        diagonal_filter_comp(
            apos, bpos, comp, nhits, a_rid, b_rid,
            pos_bits=_pos_bits(blk_a.cap, blk_b.cap),
            read_bits=quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1),
            band_shift=cfg.band_shift, hit_min=cfg.hit_min, kmer=k,
            seed_cap=seed_cap, upper_only=bool(self_pair and upper_only),
            include_self=bool(getattr(cfg, "identity", False)),
            wprefix=wprefix, suppress_equal=suppress_equal, keep=keep)
    return {
        "path": "legacy", "aread": ar, "bread": br, "apos": sap,
        "bpos": sbp, "cov": cov, "comp": scomp, "nseeds": nseeds,
        "total_seeds": total_seeds, "total_hits": total_hits,
        "total_compact": total_hits, "total_emit": n_emit, "tcap": cap,
        "overflow": bool(total_hits > cap or total_seeds > seed_cap),
        "raw_cap": cap, "compact_cap": cap,
    }


def find_seeds_canonical_dev(blk_a, blk_b, cfg, mask_a=None, mask_b=None,
                             upper_only: bool = False,
                             hit_cap: int | None = None,
                             seed_cap: int = 1 << 17, a_index=None,
                             dev_arrays=None, raw_hint: int | None = None,
                             self_pair: bool = False, bias_lut=None,
                             emit_hint: int | None = None, *,
                             device=None, b_index=None, starts=None,
                             suppress_equal: bool = False,
                             equal_upper: bool = False):
    """Device canonical seeding of one block pair: one index merge and
    one banding sort give the seeds of BOTH orientations (comp bit per
    seed; comp seeds carry bpos in per-read reverse-complement
    coordinates).  self_pair: A and B are the same block (the merge
    collapses to match_count_self).  dev_arrays: (a_bases, a_rid,
    b_bases, b_rid) tensors already on the device, which is then theirs;
    without them `device` (keyword-only) names where the blocks go, and
    leaving out both raises TypeError.  mask_a/mask_b: optional bool
    tensors on that device.  bias_lut: -b weights (bias_weight_lut of
    the A block).  Returns a dict of seed tensors [seed_cap] and host
    ints (nseeds, total_seeds, total_hits, total_compact, total_emit,
    tcap, overflow, raw_cap, compact_cap), and "path": "packed",
    "sliced" (with "slices": each slice's tuples, hits and buffer) or
    "legacy".

    b_index: the B block's (tag, index) as canonical_index_dev returns
    it, built elsewhere (the ring sweep's B index travels with its
    block); with a_index it sets both payloads' widths, which need not
    be the blocks' own.  starts: (a_starts, b_starts) int64 tensors on
    the device (a received block's), else built from the blocks.
    suppress_equal: drop hits of a read against itself (the ring's
    rotation that pairs a block with itself, upper_only off).
    equal_upper: on that rotation under -I (cfg.identity), keep a read
    against itself only at the hits a self merge gives (A position
    below B position: no trivial diagonal, no transposed copies), so
    the read's self records are the self pair's.

    Paths: a pair whose payload exceeds 32 bits (or an a_index tagged
    "legacy") takes the legacy path; else the packed path, by slices of
    B reads when the hit buffer would pass _SLICE_CAP.  hit_cap None
    sizes the buffers from the count phase's exact total (raw_hint is
    then not read), so the hits are never truncated.  An explicit
    hit_cap is a hard cap, as in damar_tpu, and a truncated fill sets
    "overflow"."""
    if dev_arrays is not None:
        a_bases, a_rid, b_bases, b_rid = dev_arrays
        if device is not None and torch.device(device) != a_bases.device:
            raise ValueError(f"device {device} but dev_arrays are on "
                             f"{a_bases.device}")
    elif device is None:
        raise TypeError("find_seeds_canonical_dev: pass device= (or "
                        "dev_arrays): there is no default device")
    else:
        a_bases = torch.as_tensor(blk_a.bases, device=device)
        a_rid = torch.as_tensor(blk_a.read_id, device=device)
        b_bases = torch.as_tensor(blk_b.bases, device=device)
        b_rid = torch.as_tensor(blk_b.read_id, device=device)
    tag, idx = a_index if a_index is not None else (None, None)
    btag, bidx = b_index if b_index is not None else (None, None)
    if tag is not None and btag is not None and "legacy" not in (tag,
                                                                 btag):
        pa = pb = True      # both indexes given: their tags hold the widths
    else:
        pa = packed_payload_host(blk_a)
        pb = pa if (self_pair or blk_b is blk_a) else packed_payload_host(
            blk_b)
    if tag == "legacy" or pa is None or pb is None:
        return _find_seeds_canonical_dev_legacy(
            blk_a, blk_b, cfg, (a_bases, a_rid, b_bases, b_rid), mask_a,
            mask_b, upper_only, hit_cap, seed_cap,
            idx if tag == "legacy" else None, raw_hint, self_pair, bias_lut,
            suppress_equal, equal_upper)
    dev = a_bases.device
    if idx is None:
        tag, idx = canonical_index_dev(a_bases, a_rid, blk_a, cfg.kmer,
                                       mask_a)
    _, a_rid_bits, a_rpos_bits = tag
    ac, amp = idx
    t = cfg.max_kmer_count or 128
    if self_pair:
        bmp = amp
        b_rid_bits, b_rpos_bits = a_rid_bits, a_rpos_bits
        lo, cnt, cum, total = match_count_self(ac, k=cfg.kmer, max_count=t)
    else:
        if bidx is not None:
            (_, b_rid_bits, b_rpos_bits), (bc, bmp) = btag, bidx
        else:
            mpb, b_rid_bits, b_rpos_bits = pb
            bc, bmp = build_index_canonical_packed(
                b_bases, b_rid, _payload_tensor(mpb, dev), cfg.kmer, mask_b)
        lo, cnt, cum, total = match_count(ac, bc, k=cfg.kmer, max_count=t)
        del bc
    total = int(total)     # the tensor is a view that keeps cum alive
    cap = _hit_buffer(total, hit_cap, raw_hint)
    if starts is not None:
        a_starts, b_starts = starts
    else:
        a_starts = starts_tensor(blk_a, dev)
        b_starts = a_starts if blk_b is blk_a else starts_tensor(blk_b, dev)
    wprefix = (_bias_prefix_dev(a_bases, bias_lut) if bias_lut is not None
               else None)
    band_kw = dict(a_rid_bits=a_rid_bits, a_rpos_bits=a_rpos_bits,
                   b_rid_bits=b_rid_bits, b_rpos_bits=b_rpos_bits,
                   upper_only=bool(self_pair and upper_only),
                   include_self=bool(getattr(cfg, "identity", False)),
                   suppress_equal=suppress_equal, equal_upper=equal_upper)
    if cap > _SLICE_CAP:
        lo_cnt = [lo, cnt]
        del lo, cnt, cum
        return _find_seeds_sliced(
            amp, bmp, lo_cnt, blk_a=blk_a, blk_b=blk_b, cfg=cfg,
            hit_cap=hit_cap, seed_cap=seed_cap, a_starts=a_starts,
            b_starts=b_starts, wprefix=wprefix, **band_kw)
    tcap = cap if emit_hint is None else _pow2_cap(min(emit_hint, cap),
                                                   cap)
    ap_mp, bp_mp, nhits, total_hits, n_emit = match_fill_packed(
        amp, bmp, lo, cnt, cum, hit_cap=cap, tcap=tcap)
    del lo, cnt, cum
    ar, br, arp, brp, score, scomp, nseeds, total_seeds = \
        diagonal_filter_packed(
            ap_mp, bp_mp, nhits,
            read_bits=quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1),
            band_shift=cfg.band_shift, hit_min=cfg.hit_min,
            kmer=cfg.kmer, seed_cap=seed_cap, wprefix=wprefix,
            a_starts=a_starts, **band_kw)
    sap, sbp = seeds_to_block_coords(ar, br, arp, brp, scomp,
                                     a_starts, b_starts, cfg.kmer)
    return {
        "path": "packed", "aread": ar, "bread": br, "apos": sap,
        "bpos": sbp, "cov": score, "comp": scomp, "nseeds": nseeds,
        "total_seeds": total_seeds, "total_hits": total_hits,
        "total_compact": total_hits,
        "total_emit": n_emit, "tcap": tcap,
        # overflow covers every fixed buffer: truncated seeds silently
        # lose overlaps just like truncated hits
        "overflow": bool((total_hits > cap) | (total_seeds > seed_cap)
                         | (n_emit > tcap)),
        "raw_cap": cap,
        "compact_cap": cap,
    }


# ---------------------------------------------------------------------------
# The datander search: forward codes, block positions as payload.
# ---------------------------------------------------------------------------

def build_index(bases, read_id, k: int, mask=None):
    """Sorted forward k-mer index of a block: (codes_sorted, pos_sorted),
    the stable sort keeping each code run in block-position order."""
    codes, _ = kmer_codes(bases, read_id, k, mask)
    pos = torch.arange(bases.shape[0], device=bases.device)
    codes_s, (pos_s,) = radix_sort_bits(codes, (pos,))
    return codes_s, pos_s


def _read_ranges(cnt, tuple_read, nreads: int, per: int) -> list:
    """Ranges [r0, r1) of reads whose self-merge hits (cnt summed by
    each tuple's read) stay within `per`, a read with more on its own."""
    hits = torch.zeros(nreads + 1, dtype=torch.int64, device=cnt.device)
    hits.index_add_(0, tuple_read, cnt)
    cum = np.cumsum(hits.cpu().numpy())
    out, r0 = [], 0
    while r0 <= nreads:
        base = int(cum[r0 - 1]) if r0 else 0
        r1 = max(int(np.searchsorted(cum, base + per, side="right")),
                 r0 + 1)
        out.append((r0, min(r1, nreads + 1)))
        r0 = r1
    return out


def find_tandem_seeds(blk, cfg, min_period: int = 8,
                      max_period: int = 2000, hit_cap: int | None = None,
                      seed_cap: int | None = None, *, device):
    """Self-comparison seeds on a near-diagonal band (the datander
    search): a read matching itself at offset p in [min_period,
    max_period] (apos - bpos, block positions) has tandem period p.

    The self merge pairs every k-mer with each k-mer of its code run,
    itself included, so a block of N bases gives well over N hits.  The
    buffers are sized from the counts: the hit buffer from the count
    phase's total, the seed buffer (REF_TANDEM_SEED_CAP at first) grown
    to hold total_seeds by one more banding.  Above _SLICE_CAP hits the
    fill and the banding run once per range of reads (B tuples by their
    read, each range's hits within _SLICE_CAP): a seed needs a read
    against itself and the band key leads with the read, so the ranges'
    seeds in turn are the unsplit search's.  An explicit hit_cap or
    seed_cap is a hard cap instead, as in damar_tpu, which truncates the
    B-tuple-major fill there (its defaults: REF_TANDEM_HIT_CAP,
    REF_TANDEM_SEED_CAP).  device (keyword-only, no default) is where
    the block goes.  Returns tensors of the seed buffer (aread, bread,
    apos, bpos, cov) and host ints (nseeds, total_seeds, nhits,
    total_hits, hit_buffer: the largest range's, seed_buffer, pieces:
    the ranges of reads)."""
    bases = torch.as_tensor(blk.bases, device=device)
    rid = torch.as_tensor(blk.read_id, device=device)
    c, p = build_index(bases, rid, cfg.kmer)
    t = cfg.max_kmer_count or 128
    lo, cnt, cum, total = match_count(c, c, k=cfg.kmer, max_count=t)
    del c
    total = int(total)
    if hit_cap is None and total > _SLICE_CAP:
        tuple_read = rid.to(torch.int64)[p]
        ranges = _read_ranges(cnt, tuple_read, blk.nreads, _SLICE_CAP)
    else:
        ranges = [None]

    def band(apos, bpos, nhits, cap):
        return diagonal_filter(
            apos, bpos, nhits, rid, pos_bits=_pos_bits(blk.cap),
            read_bits=quantize_bits(blk.nreads + 1),
            band_shift=cfg.band_shift, hit_min=cfg.hit_min, kmer=cfg.kmer,
            seed_cap=cap, min_diag=min_period, max_diag=max_period)

    parts, nhits, hit_buffer, total_seeds = [], 0, 0, 0
    for rng in ranges:
        if rng is None:
            c_h, cum_h = cnt, cum
            cap = max(total if hit_cap is None else min(total, hit_cap), 1)
        else:
            inside = (tuple_read >= rng[0]) & (tuple_read < rng[1])
            c_h = torch.where(inside, cnt, 0)
            del inside
            cum_h = torch.cumsum(c_h, 0)
            cap = max(int(cum_h[-1]), 1)
        apos, bpos, n_h, _ = match_fill(p, p, lo, c_h, cum_h, hit_cap=cap)
        del c_h, cum_h
        sc = REF_TANDEM_SEED_CAP if seed_cap is None else seed_cap
        out = band(apos, bpos, n_h, sc)
        if seed_cap is None and out[-1] > sc:
            while sc < out[-1]:
                sc *= 2
            out = band(apos, bpos, n_h, sc)
        del apos, bpos
        ns = out[-2]
        parts.append(tuple(x[:ns] for x in out[:5]))
        nhits, total_seeds = nhits + n_h, total_seeds + out[-1]
        hit_buffer = max(hit_buffer, cap)
    sc = REF_TANDEM_SEED_CAP if seed_cap is None else seed_cap
    while seed_cap is None and sc < total_seeds:
        sc *= 2
    nseeds = min(total_seeds, sc)
    cols = []
    for j, x in enumerate(zip(*parts)):
        col = torch.full((sc,), 0 if j == 4 else -1, dtype=torch.int64,
                         device=bases.device)
        col[:nseeds] = torch.cat(x)[:nseeds]
        cols.append(col)
    ar, br, sap, sbp, cov = cols
    return {"aread": ar, "bread": br, "apos": sap, "bpos": sbp, "cov": cov,
            "nseeds": nseeds, "total_seeds": total_seeds, "nhits": nhits,
            "total_hits": total, "hit_buffer": hit_buffer,
            "seed_buffer": sc, "pieces": len(ranges)}


# ---------------------------------------------------------------------------
# The reference's plain seeding API: one orientation of B, forward k-mer
# codes and block positions as payload (the pipeline seeds canonically;
# these serve callers written against damar_tpu's plain functions).
# ---------------------------------------------------------------------------

def _pair_arrays(blk_a, blk_b, dev_arrays, device, who: str):
    """(a_bases, a_rid, b_bases, b_rid) on the device: dev_arrays as
    given, else the blocks uploaded to `device`; neither raises."""
    if dev_arrays is not None:
        return dev_arrays
    if device is None:
        raise TypeError(f"{who}: pass device= (or dev_arrays): there is no "
                        f"default device")
    return tuple(torch.as_tensor(x, device=device) for x in (
        blk_a.bases, blk_a.read_id, blk_b.bases, blk_b.read_id))


def _mask_tensor(mask, device):
    if mask is None or torch.is_tensor(mask):
        return mask
    return torch.as_tensor(np.asarray(mask, dtype=bool), device=device)


def match_hits(a_codes, a_pos, b_codes, b_pos, k: int, hit_cap: int,
               max_count: int = 128):
    """Merge two sorted forward k-mer indexes into (apos, bpos) hit pairs
    in one buffer of hit_cap: match_count, then match_fill.  Returns
    (apos, bpos, nhits, total)."""
    lo, c, cum, _ = match_count(a_codes, b_codes, k=k, max_count=max_count)
    return match_fill(a_pos, b_pos, lo, c, cum, hit_cap=hit_cap)


def compact_hits(apos, bpos, nhits: int, a_rid, b_rid, out_cap: int,
                 upper_only: bool, suppress_equal: bool = False,
                 include_self: bool = False):
    """Drop the pair-filtered hits (a read against itself under
    suppress_equal, the lower triangle under upper_only; include_self
    keeps a read against itself there) and compact the rest, in order,
    into a buffer of out_cap (dead rows -1).  Returns (apos, bpos, n,
    total); total > out_cap means the buffer truncated them."""
    live = torch.arange(apos.shape[0], device=apos.device) < nhits
    ar = a_rid.to(torch.int64)[apos.clamp(min=0)]
    br = b_rid.to(torch.int64)[bpos.clamp(min=0)]
    if upper_only:
        live &= (ar <= br) if include_self else (ar < br)
    if suppress_equal:
        live &= ar != br
    (oa, ob), n, total = compact_flagged(live, (apos, bpos), out_cap=out_cap)
    return oa, ob, n, total


def compact_hits_packed(ap_mp, bp_mp, nhits: int, a_rpos_bits: int,
                        b_rpos_bits: int, out_cap: int, upper_only: bool,
                        suppress_equal: bool = False,
                        include_self: bool = False):
    """compact_hits over packed hits: the read ordinals come from the
    payloads; dead rows DEAD_MP.  Returns (ap_mp, bp_mp, n, total)."""
    live = torch.arange(ap_mp.shape[0], device=ap_mp.device) < nhits
    ar = ap_mp >> (1 + a_rpos_bits)
    br = bp_mp >> (1 + b_rpos_bits)
    if upper_only:
        live &= (ar <= br) if include_self else (ar < br)
    if suppress_equal:
        live &= ar != br
    (oa, ob), n, total = compact_flagged(live, (ap_mp, bp_mp),
                                         out_cap=out_cap, fill=DEAD_MP)
    return oa, ob, n, total


def _plain_band(apos, bpos, nhits: int, a_rid, b_rid, blk_a, blk_b, cfg,
                seed_cap: int, upper_only: bool):
    """The double-bucketed banding of the plain API over block
    positions (damar_tpu diagonal_filter with no strand)."""
    return _diag_filter_impl(
        apos, bpos, nhits, a_rid, b_rid,
        pos_bits=_pos_bits(blk_a.cap, blk_b.cap),
        read_bits=quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1),
        band_shift=cfg.band_shift, hit_min=cfg.hit_min, kmer=cfg.kmer,
        seed_cap=seed_cap, upper_only=upper_only,
        include_self=bool(getattr(cfg, "identity", False)))


def find_seeds_dev(blk_a, blk_b, cfg, mask_a=None, mask_b=None,
                   upper_only: bool = False, hit_cap: int = 1 << 20,
                   seed_cap: int = 1 << 16, a_index=None, dev_arrays=None,
                   raw_hint: int | None = None,
                   compact_cap: int | None = None, self_pair: bool = False,
                   *, device=None) -> dict:
    """Seeding of one (A block, B orientation) with a hit buffer sized
    without reading the count (damar_tpu find_seeds_dev): from raw_hint,
    else from B's capacity (half of it for a self pair, whose merge
    emits the upper triangle only; twice it otherwise), capped at
    hit_cap.  A distinct pair's hits pass compact_hits first when
    upper_only or compact_cap asks for it.  dev_arrays: (a_bases, a_rid,
    b_bases, b_rid) on the device, else `device` (keyword-only, no
    default) names where the blocks go.  a_index: (codes, pos) of
    build_index.  Returns the seed tensors [seed_cap] (aread, bread,
    apos, bpos, cov) and host ints nseeds, total_seeds, total_hits,
    total_compact, overflow, raw_cap, compact_cap; overflow: a buffer
    was too small (retry with raw_hint / compact_cap at the totals)."""
    a_bases, a_rid, b_bases, b_rid = _pair_arrays(
        blk_a, blk_b, dev_arrays, device, "find_seeds_dev")
    dev = a_bases.device
    k = cfg.kmer
    ac, ap = a_index if a_index is not None else build_index(
        a_bases, a_rid, k, _mask_tensor(mask_a, dev))
    t = cfg.max_kmer_count or 128
    nb = b_bases.shape[0]
    if self_pair:
        bp = ap
        lo, cnt, cum, _ = match_count_self(ac, k=k, max_count=t)
        want_raw = min(raw_hint or nb // 2, hit_cap)
    else:
        bc, bp = build_index(b_bases, b_rid, k, _mask_tensor(mask_b, dev))
        lo, cnt, cum, _ = match_count(ac, bc, k=k, max_count=t)
        want_raw = min(raw_hint or 2 * nb, hit_cap)
    cap = _pow2_cap(want_raw, hit_cap)
    apos, bpos, nhits, total_hits = match_fill(ap, bp, lo, cnt, cum,
                                               hit_cap=cap)
    include_self = bool(getattr(cfg, "identity", False))
    if not self_pair and (upper_only or bool(compact_cap)):
        ccap = _pow2_cap(min(compact_cap or max(nb // 4, 1 << 17), hit_cap),
                         hit_cap)
        apos, bpos, nhits, total_c = compact_hits(
            apos, bpos, nhits, a_rid, b_rid, out_cap=ccap,
            upper_only=upper_only, include_self=include_self)
        overflow = total_hits > cap or total_c > ccap
    else:
        ccap, total_c = cap, total_hits
        overflow = total_hits > cap
    ar, br, sap, sbp, cov, nseeds, total_seeds = _plain_band(
        apos, bpos, nhits, a_rid, b_rid, blk_a, blk_b, cfg, seed_cap,
        upper_only=bool(self_pair and upper_only))
    return {"aread": ar, "bread": br, "apos": sap, "bpos": sbp, "cov": cov,
            "nseeds": nseeds, "total_seeds": total_seeds,
            "total_hits": total_hits, "total_compact": total_c,
            "overflow": bool(overflow or total_seeds > seed_cap),
            "raw_cap": cap, "compact_cap": ccap}


def find_seeds(blk_a, blk_b, cfg, mask_a=None, mask_b=None,
               upper_only: bool = False, hit_cap: int = 1 << 20,
               seed_cap: int = 1 << 16, a_index=None, *, device) -> dict:
    """Seeding of one (A block, B orientation; B already reverse
    complemented for the comp pass) with the count read first (damar_tpu
    find_seeds): the hit buffer is the smallest power of two from 2^17
    holding the total, capped at hit_cap.  device (keyword-only, no
    default): where the blocks go.  a_index: (codes, pos) of build_index
    on that device.  Returns numpy seed arrays [seed_cap] (aread, bread,
    apos, bpos, cov) and ints nseeds, total_seeds, nhits, total_hits."""
    a_bases, a_rid, b_bases, b_rid = _pair_arrays(blk_a, blk_b, None, device,
                                                  "find_seeds")
    dev = a_bases.device
    k = cfg.kmer
    ac, ap = a_index if a_index is not None else build_index(
        a_bases, a_rid, k, _mask_tensor(mask_a, dev))
    bc, bp = build_index(b_bases, b_rid, k, _mask_tensor(mask_b, dev))
    lo, cnt, cum, total = match_count(ac, bc, k=k,
                                      max_count=cfg.max_kmer_count or 128)
    cap = 1 << 17
    while cap < int(total) and cap < hit_cap:
        cap *= 2
    apos, bpos, nhits, total_hits = match_fill(ap, bp, lo, cnt, cum,
                                               hit_cap=min(cap, hit_cap))
    ar, br, sap, sbp, cov, nseeds, total_seeds = _plain_band(
        apos, bpos, nhits, a_rid, b_rid, blk_a, blk_b, cfg, seed_cap,
        upper_only)
    out = {key: x.cpu().numpy() for key, x in zip(
        ("aread", "bread", "apos", "bpos", "cov"), (ar, br, sap, sbp, cov))}
    out.update(nseeds=nseeds, total_seeds=total_seeds, nhits=nhits,
               total_hits=total_hits)
    return out
