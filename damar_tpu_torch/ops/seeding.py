"""Seed hit detection: canonical k-mer index merge + diagonal banding.

Torch port of the unsliced, packed-payload canonical path of
damar_tpu/ops/seeding.py (find_seeds_canonical_dev and what it calls).
The reference's sorts and scans are XLA-level array code, so they stay
torch ops here; seeds and their order equal the reference's.

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

The datander search (find_tandem_seeds) runs the forward, unpacked
form of the same stages: a forward k-mer index with block positions as
payload (build_index), the self merge (match_count), the B-tuple-major
fill (match_fill) and the double-bucketed banding restricted to one
read and a diagonal window (diagonal_filter).  Its buffers are sized
from the counts, not capped as the reference's are (fault 3g in
ROADMAP.md; explicit caps reproduce the reference's truncation).

Not ported (the wrapper raises NotImplementedError): the sliced path
for hit buffers above _SLICE_CAP, the legacy block-absolute payload for
blocks whose payload exceeds 32 bits, and -b (cfg.bias).

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

_SLICE_CAP = 1 << 27     # hit buffers above this need the sliced path
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
    exceed 32 bits."""
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


def _payload_tensor(mp_base: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(mp_base.astype(np.int64), device=device)


def canonical_index_dev(bases_d, rid_d, blk, k: int, mask=None):
    """Device canonical index of a block with the packed payload.
    Returns (("packed", rid_bits, rpos_bits), (codes, mp))."""
    p = packed_payload_host(blk)
    if p is None:
        raise NotImplementedError(
            "block payload exceeds 32 bits: the legacy block-absolute "
            "seeding path is not ported")
    mp_base, rid_bits, rpos_bits = p
    idx = build_index_canonical_packed(
        bases_d, rid_d, _payload_tensor(mp_base, bases_d.device), k, mask)
    return ("packed", rid_bits, rpos_bits), idx


def match_count(a_codes, b_codes, k: int, max_count: int = 128):
    """Count phase of the sorted-index merge: per-B-tuple matching A run
    start and length (runs longer than max_count on either side are
    suppressed: the -t cutoff).  Returns (lo, c, cum, total)."""
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
    total = int(cum[-1])
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
    hit0 = torch.arange(hit_cap, device=a_mp.device)
    aidx = hit0 + shift
    ap_mp = a_mp[aidx.clamp(0, a_mp.shape[0] - 1)]
    nhits = min(total, hit_cap)
    live = hit0 < nhits
    dead = torch.full_like(ap_mp, DEAD_MP)
    return (torch.where(live, ap_mp, dead),
            torch.where(live, e_bmp & M32, dead), nhits, total, n_emit)


def diagonal_filter_packed(ap_mp, bp_mp, nhits: int,
                           a_rid_bits: int, a_rpos_bits: int,
                           b_rid_bits: int, b_rpos_bits: int,
                           read_bits: int, band_shift: int,
                           hit_min: int, kmer: int, seed_cap: int,
                           upper_only: bool, include_self: bool = False):
    """Single-bucket banding over packed hits: sort by the packed
    (arpos, bucket, strand, br, ar) key (arpos least significant), sum
    novel k-mer coverage per band, score each band as cov(band-1) +
    cov(band), and keep the first hit of every band reaching hit_min.
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
    rpb = max(a_rpos_bits, b_rpos_bits)
    # fwd diagonal arpos - brpos (offset nonnegative); comp ANTI-diagonal
    # arpos + brpos: both constant along an overlap line
    diag = torch.where(strand == 1, arp + brp, arp - brp + (1 << rpb))
    bucket = diag >> band_shift
    bucket_bits = rpb + 2 - band_shift
    dead_read = (1 << read_bits) - 1
    ar_k = torch.where(live, ar, dead_read)
    br_k = torch.where(live, br, dead_read)
    widths = (a_rpos_bits, bucket_bits, 1, read_bits, read_bits)
    words = pack_fields((arp, bucket, strand, br_k, ar_k), widths)
    assert len(words) <= 2, "band key exceeds 64 bits"
    words_s, (brp_s,) = radix_sort_packed(words, (brp,), sum(widths))
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
    prev_arp = torch.cat([arp_s[:1], arp_s[:-1]])
    cov = torch.where(first, kmer, torch.clamp(arp_s - prev_arp, max=kmer))
    seg_sum = segment_sum_to_elements(torch.clamp(cov, min=0), first)
    # adjacent-band window = (previous band, this band): at a segment's
    # first element the previous segment's sum and band id sit one
    # element back
    p_lo = torch.cat([B_lo.new_full((1,), M32), B_lo[:-1]])
    p_hi = torch.cat([B_hi.new_full((1,), M32), B_hi[:-1]])
    p_sum = torch.cat([seg_sum.new_zeros(1), seg_sum[:-1]])
    adj = (((p_lo + 1) & M32) == B_lo) & (p_hi == B_hi)
    score = seg_sum + torch.where(adj, p_sum, 0)
    rep = first & (score >= hit_min) & (ar_s != dead_read)
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


def find_seeds_canonical_dev(blk_a, blk_b, cfg, mask_a=None, mask_b=None,
                             upper_only: bool = False,
                             hit_cap: int | None = None,
                             seed_cap: int = 1 << 17, a_index=None,
                             dev_arrays=None, raw_hint: int | None = None,
                             self_pair: bool = False, bias_lut=None,
                             emit_hint: int | None = None, *,
                             device=None):
    """Device canonical seeding of one block pair: one index merge and
    one banding sort give the seeds of BOTH orientations (comp bit per
    seed; comp seeds carry bpos in per-read reverse-complement
    coordinates).  self_pair: A and B are the same block (the merge
    collapses to match_count_self).  dev_arrays: (a_bases, a_rid,
    b_bases, b_rid) tensors already on the device, which is then theirs;
    without them `device` (keyword-only) names where the blocks go, and
    leaving out both raises TypeError.  mask_a/mask_b: optional bool
    tensors on that device.  Returns a dict of seed
    tensors [seed_cap] and host ints (nseeds, total_seeds, total_hits,
    total_compact, total_emit, tcap, overflow, raw_cap, compact_cap).

    hit_cap None sizes the hit buffer from the count phase's exact total
    (raw_hint is then not read), so the hits are never truncated; a
    total above _SLICE_CAP raises NotImplementedError (the sliced path
    is not ported).  An explicit hit_cap is a hard cap, as in damar_tpu,
    and a truncated fill sets "overflow"."""
    if getattr(cfg, "bias", False) or bias_lut is not None:
        raise NotImplementedError("-b (biased-composition seeding) is "
                                  "not ported")
    pa = packed_payload_host(blk_a)
    pb = pa if (self_pair or blk_b is blk_a) else packed_payload_host(blk_b)
    tag, idx = a_index if a_index is not None else (None, None)
    if tag == "legacy" or pa is None or pb is None:
        raise NotImplementedError(
            "block payload exceeds 32 bits: the legacy block-absolute "
            "seeding path is not ported")
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
        mpb, b_rid_bits, b_rpos_bits = pb
        bc, bmp = build_index_canonical_packed(
            b_bases, b_rid, _payload_tensor(mpb, dev), cfg.kmer, mask_b)
        lo, cnt, cum, total = match_count(ac, bc, k=cfg.kmer, max_count=t)
    if hit_cap is None:
        total = int(total)
        if total > _SLICE_CAP:
            raise NotImplementedError(
                f"{total} hits > {_SLICE_CAP}: the sliced seeding path is "
                "not ported")
        cap = _pow2_cap(total, _SLICE_CAP)
    else:
        cap = _pow2_cap(min(int(total) if raw_hint is None else raw_hint,
                            hit_cap), hit_cap)
    if cap > _SLICE_CAP:
        raise NotImplementedError(
            f"hit buffer {cap} > {_SLICE_CAP}: the sliced seeding path "
            "is not ported")
    tcap = cap if emit_hint is None else _pow2_cap(min(emit_hint, cap),
                                                   cap)
    ap_mp, bp_mp, nhits, total_hits, n_emit = match_fill_packed(
        amp, bmp, lo, cnt, cum, hit_cap=cap, tcap=tcap)
    del lo, cnt, cum
    a_starts = starts_tensor(blk_a, dev)
    b_starts = a_starts if blk_b is blk_a else starts_tensor(blk_b, dev)
    ar, br, arp, brp, score, scomp, nseeds, total_seeds = \
        diagonal_filter_packed(
            ap_mp, bp_mp, nhits,
            a_rid_bits=a_rid_bits, a_rpos_bits=a_rpos_bits,
            b_rid_bits=b_rid_bits, b_rpos_bits=b_rpos_bits,
            read_bits=quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1),
            band_shift=cfg.band_shift, hit_min=cfg.hit_min,
            kmer=cfg.kmer, seed_cap=seed_cap,
            upper_only=bool(self_pair and upper_only),
            include_self=bool(getattr(cfg, "identity", False)))
    sap, sbp = seeds_to_block_coords(ar, br, arp, brp, scomp,
                                     a_starts, b_starts, cfg.kmer)
    return {
        "aread": ar, "bread": br, "apos": sap, "bpos": sbp,
        "cov": score, "comp": scomp, "nseeds": nseeds,
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
    slot = torch.arange(hit_cap, device=dev)
    off = slot - starts[bidx]
    apos = a_pos[(lo[bidx] + off).clamp(0, a_pos.shape[0] - 1)]
    bpos = b_pos[bidx]
    nhits = min(total, hit_cap)
    live = slot < nhits
    return (torch.where(live, apos, -1), torch.where(live, bpos, -1),
            nhits, total)


def _pos_bits(*caps: int) -> int:
    return max(int(c - 1).bit_length() for c in caps)


def diagonal_filter(apos, bpos, nhits: int, read_id, pos_bits: int,
                    read_bits: int, band_shift: int, hit_min: int,
                    kmer: int, seed_cap: int, min_diag: int,
                    max_diag: int):
    """Band a block's self hits (block positions) by (read, diagonal >>
    band_shift) and keep the first hit of every band whose novel k-mer
    coverage reaches hit_min.  Only hits of a read against itself with
    min_diag <= apos - bpos <= max_diag are kept (the datander band).
    Each hit is counted in its band and the next one up (double
    bucketing), so a seed straddling a band edge is whole in one of
    them.  Returns (aread, bread, apos, bpos, cov) tensors of seed_cap
    (dead rows -1, cov 0) and host ints (nseeds, total_seeds)."""
    n = apos.shape[0]
    dev = apos.device
    ar = read_id.to(torch.int64)[apos.clamp(min=0)]
    diag = apos - bpos
    live = ((torch.arange(n, device=dev) < nhits)
            & (ar == read_id.to(torch.int64)[bpos.clamp(min=0)])
            & (diag >= min_diag) & (diag <= max_diag))
    dead_read = (1 << read_bits) - 1
    ar_k = torch.where(live, ar, dead_read)
    bucket = (diag + read_id.shape[0]) >> band_shift
    bucket_bits = pos_bits + 2 - band_shift
    # double bucketing: every hit in its band and in the next one up
    widths = (pos_bits, bucket_bits, read_bits)
    words = pack_fields((torch.cat([apos, apos]).clamp(min=0),
                         torch.cat([bucket, bucket + 1]),
                         torch.cat([ar_k, ar_k])), widths)
    words_s, (bpos_s,) = radix_sort_packed(words, (torch.cat([bpos, bpos]),),
                                           sum(widths))
    apos_s = unpack_field(words_s, 0, pos_bits)
    # band identity = every key bit above the apos field
    bucket_s = unpack_field(words_s, pos_bits, bucket_bits)
    ar_s = unpack_field(words_s, pos_bits + bucket_bits, read_bits)
    brk = (ar_s[1:] != ar_s[:-1]) | (bucket_s[1:] != bucket_s[:-1])
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), brk])
    prev_apos = torch.cat([apos_s[:1], apos_s[:-1]])
    cov = torch.where(first, kmer, torch.clamp(apos_s - prev_apos,
                                               max=kmer)).clamp(min=0)
    seg_sum = segment_sum_to_elements(cov, first)
    rep = first & (seg_sum >= hit_min) & (ar_s != dead_read)
    comp, nseeds, total_seeds = compact_flagged(
        rep, tuple(words_s) + (bpos_s, seg_sum), out_cap=seed_cap, fill=0)
    w_out, bp_out, cov_out = comp[:-2], comp[-2], comp[-1]
    keep = torch.arange(seed_cap, device=dev) < nseeds

    def mark(x):
        return torch.where(keep, x, -1)

    read = mark(unpack_field(w_out, pos_bits + bucket_bits, read_bits))
    return (read, read.clone(), mark(unpack_field(w_out, 0, pos_bits)),
            mark(bp_out),
            torch.where(keep, cov_out, 0), nseeds, total_seeds)


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
    to hold total_seeds by one more banding.  An explicit hit_cap or
    seed_cap is a hard cap instead, as in damar_tpu, which truncates the
    B-tuple-major fill there (its defaults: REF_TANDEM_HIT_CAP,
    REF_TANDEM_SEED_CAP).  A hit buffer above _SLICE_CAP raises
    NotImplementedError (the sliced path is not ported).  device (keyword-only, no default) is where
    the block goes.  Returns tensors of the seed buffer (aread, bread,
    apos, bpos, cov) and host ints (nseeds, total_seeds, nhits,
    total_hits, hit_buffer, seed_buffer)."""
    bases = torch.as_tensor(blk.bases, device=device)
    rid = torch.as_tensor(blk.read_id, device=device)
    c, p = build_index(bases, rid, cfg.kmer)
    t = cfg.max_kmer_count or 128
    lo, cnt, cum, total = match_count(c, c, k=cfg.kmer, max_count=t)
    total = int(total)
    cap = max(total if hit_cap is None else min(total, hit_cap), 1)
    if cap > _SLICE_CAP:
        raise NotImplementedError(
            f"hit buffer {cap} > {_SLICE_CAP}: the sliced seeding path "
            "is not ported")
    apos, bpos, nhits, total_hits = match_fill(p, p, lo, cnt, cum,
                                               hit_cap=cap)
    del c, lo, cnt, cum

    def band(cap):
        return diagonal_filter(
            apos, bpos, nhits, rid, pos_bits=_pos_bits(blk.cap),
            read_bits=quantize_bits(blk.nreads + 1),
            band_shift=cfg.band_shift, hit_min=cfg.hit_min, kmer=cfg.kmer,
            seed_cap=cap, min_diag=min_period, max_diag=max_period)

    sc = REF_TANDEM_SEED_CAP if seed_cap is None else seed_cap
    out = band(sc)
    if seed_cap is None and out[-1] > sc:
        while sc < out[-1]:
            sc *= 2
        out = band(sc)
    ar, br, sap, sbp, cov, nseeds, total_seeds = out
    return {"aread": ar, "bread": br, "apos": sap, "bpos": sbp, "cov": cov,
            "nseeds": nseeds, "total_seeds": total_seeds, "nhits": nhits,
            "total_hits": total_hits, "hit_buffer": int(apos.shape[0]),
            "seed_buffer": sc}
