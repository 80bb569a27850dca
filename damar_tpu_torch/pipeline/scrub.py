"""Scrubbing (port of damar_tpu/pipeline/scrub.py, MARVEL lineage:
LAstitch/LAq/LAfix/LAgap/LAfilter), host numpy on columnar piles.

Piles (all alignments with the same A-read) are processed as columns.
Quality is segment-granular: segment s of read r is the A interval
[s*tspace, (s+1)*tspace), and every covering alignment contributes its
trace diffs for exactly that absolute segment (the trace kernels commit
at absolute tspace boundaries).

Patching (LAfix) replaces bad-quality segments with the spanning
sequence of the best covering B read, mapped through trace points, and
splits reads at uncovered gaps.  Stitched chains that need a real
trace go to pipeline.overlap.retrace_rows (K3 on the device).

An object-backed LasFile is read through its columns, built in one pass
(formats.las.columns_of), so every tool takes either form.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from damar_tpu_torch.core.config import ScrubConfig
from damar_tpu_torch.formats.las import (H_ABPOS, H_AEPOS, H_AREAD,
                                         H_BBPOS, H_BEPOS, H_BREAD,
                                         H_DIFFS, H_FLAGS, H_TLEN,
                                         LasColumns, LasFile, Overlap,
                                         _decode_trace, columns_of,
                                         encode_trace_columns)
from damar_tpu_torch.formats.oflags import (
    OVL_COMP, OVL_CONT, OVL_DISCARD, OVL_GAP, OVL_LOCAL, OVL_REPEAT,
    OVL_STITCH, OVL_SYMDISCARD)
from damar_tpu_torch.formats.tracks import Track
from damar_tpu_torch.ops.sort import host_lexsort

Q_NOCOV = 255  # quality value for uncovered segments


# --- LAstitch ---------------------------------------------------------------

def stitch_las(las: LasFile, fuzz: int = 100
               ) -> tuple[LasFile, np.ndarray]:
    """Merge fragments of the same (a, b, comp) pair separated by a
    small unaligned gap (alignment broken at a noisy patch).

    Columnar: records sort by (aread, bread, comp, abpos); a chain is
    a maximal run of consecutive rows where each extends the previous
    within fuzz.

    Merged traces are BRIDGED from the fragments' exact traces
    (upstream MARVEL/scrub/LAstitch.c behavior — mount empty): member
    segments land on the merged record's absolute segment grid
    unchanged, and each junction's unaligned gap is charged into the
    segments it spans (diffs = its a-span + proportional b-share —
    the worst-case edit cost of the gap).  Bridging needs no DP and
    cannot fail the way a re-trace through the noisy junction can
    (the band loses the path and the record is dropped).  Chains with
    NEGATIVE junction gaps (overlapping fragments) or a bridged
    segment overflowing the trace encoding still need a real retrace:
    their rows are returned in `needs` for
    pipeline.overlap.retrace_rows.
    """
    cols = columns_of(las)
    n = cols.n
    if n == 0:
        return LasFile(tspace=las.tspace,
                       columns=LasColumns.empty()), np.zeros(0, np.int64)
    h0 = cols.headers
    order = host_lexsort((h0[:, H_ABPOS], h0[:, H_FLAGS] & 1,
                        h0[:, H_BREAD], h0[:, H_AREAD]))
    c = cols.permute(order)
    h = c.headers
    same = ((h[1:, H_AREAD] == h[:-1, H_AREAD])
            & (h[1:, H_BREAD] == h[:-1, H_BREAD])
            & ((h[1:, H_FLAGS] & 1) == (h[:-1, H_FLAGS] & 1)))
    agap = h[1:, H_ABPOS] - h[:-1, H_AEPOS]
    bgap = h[1:, H_BBPOS] - h[:-1, H_BEPOS]
    chain = (same & (agap >= -fuzz) & (agap <= fuzz)
             & (bgap >= -fuzz) & (bgap <= fuzz)
             & (h[1:, H_AEPOS] > h[:-1, H_AEPOS])
             & (h[1:, H_BEPOS] > h[:-1, H_BEPOS]))
    new_chain = np.concatenate([[True], ~chain])
    cid = np.cumsum(new_chain) - 1
    nch = int(cid[-1]) + 1
    first = np.nonzero(new_chain)[0]
    last = np.concatenate([first[1:] - 1, [n - 1]])
    size = last - first + 1
    out_h = np.zeros((nch, 10), np.int32)
    out_h[:, H_AREAD] = h[first, H_AREAD]
    out_h[:, H_BREAD] = h[first, H_BREAD]
    out_h[:, H_ABPOS] = h[first, H_ABPOS]
    out_h[:, H_BBPOS] = h[first, H_BBPOS]
    out_h[:, H_AEPOS] = h[last, H_AEPOS]
    out_h[:, H_BEPOS] = h[last, H_BEPOS]
    # diffs: sum over the chain + junction gap penalties
    pen = (np.abs(agap) + np.abs(bgap)).astype(np.int64)
    dsum = np.add.reduceat(h[:, H_DIFFS].astype(np.int64), first)
    dsum += np.bincount(cid[1:][chain], pen[chain], minlength=nch) \
        .astype(np.int64)
    out_h[:, H_DIFFS] = dsum
    merged = size > 1
    out_h[:, H_FLAGS] = np.where(
        merged,
        (h[first, H_FLAGS].view(np.uint32) | OVL_STITCH)
        .view(np.int32),
        h[first, H_FLAGS])

    # ---- bridge merged traces ----
    small = las.small
    enc_max = 255 if small else 32767
    width = 2 if small else 4
    ts = las.tspace
    jidx = np.nonzero(chain)[0]          # junction joins rows j, j+1
    jcid = cid[jidx]
    jag = agap[jidx].astype(np.int64)
    jbg = bgap[jidx].astype(np.int64)
    ja_end = h[jidx, H_AEPOS].astype(np.int64)
    ja_sta = h[jidx + 1, H_ABPOS].astype(np.int64)
    neg = np.zeros(nch, bool)
    np.logical_or.at(neg, jcid, (jag < 0) | (jbg < 0))
    k0 = out_h[:, H_ABPOS].astype(np.int64) // ts
    k1 = (out_h[:, H_AEPOS].astype(np.int64) - 1) // ts
    nseg_ch = np.where(out_h[:, H_AEPOS] > out_h[:, H_ABPOS],
                       k1 - k0 + 1, 0)
    bridge = merged & ~neg
    bsel = np.nonzero(bridge)[0]
    bmap = np.full(nch, -1, np.int64)
    bmap[bsel] = np.arange(len(bsel))
    blens = nseg_ch[bsel]
    boff = np.zeros(len(bsel) + 1, np.int64)
    np.cumsum(blens, out=boff[1:])
    Bn = int(boff[-1])
    dif_f = np.zeros(Bn, np.int64)
    bsp_f = np.zeros(Bn, np.int64)
    bad_ch = np.zeros(len(bsel), bool)
    if Bn:
        # (a) member segments land 1:1 on the merged absolute grid
        rows_dec = _decode_trace(c.trace, small)
        seg_off = c.offsets // width
        lens_r = np.diff(seg_off)
        rid = np.repeat(np.arange(n), lens_r)
        kk = (np.arange(rows_dec.shape[0], dtype=np.int64)
              - np.repeat(seg_off[:-1], lens_r))
        bc = bmap[cid[rid]]
        selm = np.nonzero(bc >= 0)[0]
        seg_abs = (h[rid[selm], H_ABPOS].astype(np.int64) // ts
                   + kk[selm])
        tgt = boff[bc[selm]] + (seg_abs - k0[cid[rid[selm]]])
        np.add.at(dif_f, tgt, rows_dec[selm, 0])
        np.add.at(bsp_f, tgt, rows_dec[selm, 1])
        # (b) junction gaps: worst-case edit (a-span + b-share) charged
        # to the segments the gap spans; b-share proportional with the
        # remainder on the last gap segment so totals stay exact
        sel_j = np.nonzero(bmap[jcid] >= 0)[0]
        if len(sel_j):
            g_lo = ja_end[sel_j]
            g_hi = ja_sta[sel_j]
            ag = jag[sel_j]
            bg = jbg[sel_j]
            ks = g_lo // ts
            ke = np.where(ag > 0, (g_hi - 1) // ts, ks)
            cnt = (ke - ks + 1).astype(np.int64)
            coff = np.cumsum(cnt) - cnt
            rep = np.repeat(np.arange(len(sel_j)), cnt)
            kk2 = np.arange(int(cnt.sum()), dtype=np.int64) \
                - np.repeat(coff, cnt)
            kabs = ks[rep] + kk2
            s0 = np.maximum(g_lo[rep], kabs * ts)
            s1 = np.minimum(g_hi[rep], (kabs + 1) * ts)
            olap = np.where(ag[rep] > 0, s1 - s0, 0)
            share = np.where(ag[rep] > 0,
                             (bg[rep] * olap) // np.maximum(ag[rep], 1),
                             0)
            tot_sh = np.bincount(rep, share,
                                 minlength=len(sel_j)).astype(np.int64)
            is_last = kk2 == (cnt[rep] - 1)
            share = share + np.where(is_last, (bg - tot_sh)[rep], 0)
            cidj = jcid[sel_j][rep]
            tgt2 = boff[bmap[cidj]] + (kabs - k0[cidj])
            np.add.at(dif_f, tgt2, olap + share)
            np.add.at(bsp_f, tgt2, share)
        overf = (dif_f > enc_max) | (bsp_f > enc_max) | (bsp_f < 0)
        if overf.any():
            np.logical_or.at(
                bad_ch, np.repeat(np.arange(len(bsel)), blens), overf)
    brid_ok = np.zeros(nch, bool)
    brid_ok[bsel] = ~bad_ch

    out_h[:, H_TLEN] = np.where(
        merged, np.where(brid_ok, 2 * nseg_ch, 0), h[first, H_TLEN])
    # payload: singles keep their raw bytes, bridged rows encode the
    # accumulated segment grid, failed/negative chains stay empty
    lens = np.diff(c.offsets)
    byte_lens = np.where(
        merged, np.where(brid_ok, nseg_ch * width, 0), lens[first])
    offs = np.zeros(nch + 1, np.int64)
    np.cumsum(byte_lens, out=offs[1:])
    total = int(offs[-1])
    buf = np.zeros(total, np.uint8)
    # scatter singles
    sing_rows = np.nonzero(~merged)[0]
    sl = byte_lens[sing_rows]
    so = np.cumsum(sl) - sl
    within = np.arange(int(sl.sum()), dtype=np.int64) \
        - np.repeat(so, sl)
    buf[np.repeat(offs[:-1][sing_rows], sl) + within] = \
        c.trace[np.repeat(c.offsets[:-1][first[sing_rows]], sl)
                + within]
    # scatter bridged
    ok_rows = np.nonzero(merged & brid_ok)[0]
    if len(ok_rows):
        okb = bmap[ok_rows]
        nsego = blens[okb]
        cum = np.cumsum(nsego) - nsego
        rows_sel = (np.repeat(boff[okb], nsego)
                    + np.arange(int(nsego.sum()), dtype=np.int64)
                    - np.repeat(cum, nsego))
        rows_ok = np.stack([dif_f[rows_sel], bsp_f[rows_sel]],
                           axis=1).astype(np.int32)
        noff = np.zeros(len(ok_rows) + 1, np.int64)
        np.cumsum(blens[okb], out=noff[1:])
        payload_b, _ = encode_trace_columns(rows_ok, noff, small)
        bl = byte_lens[ok_rows]
        bo = np.cumsum(bl) - bl
        w2 = np.arange(int(bl.sum()), dtype=np.int64) \
            - np.repeat(bo, bl)
        buf[np.repeat(offs[:-1][ok_rows], bl) + w2] = payload_b
    out = LasColumns(out_h, buf, offs)
    res = LasFile(tspace=las.tspace, columns=out)
    res.sort()
    # sorting permutes rows: recover merged-row indices from flags+tlen
    hh = res.columns.headers
    needs = np.nonzero((hh[:, H_FLAGS].view(np.uint32) & OVL_STITCH
                        ).astype(bool) & (hh[:, H_TLEN] == 0))[0]
    return res, needs


# --- LAq --------------------------------------------------------------------

def q_and_trim(las: LasFile, rlen_of: dict[int, int], cfg: ScrubConfig
               ) -> tuple[dict[int, np.ndarray], dict[int, tuple[int, int]]]:
    """Per-read segment quality + trim interval (LAq equivalent).

    quality[seg] = min diffs over alignments whose trace covers the
    FULL absolute segment (partial first/last segments don't count);
    Q_NOCOV where no alignment covers.  trim = widest interval whose
    first/last segments are good (q <= q_good), in bases.
    """
    ts = las.tspace
    # flat per-read segment layout: read r owns qflat[off[r]:off[r+1]]
    reads = sorted(rlen_of)
    nseg_of = np.array([(rlen_of[a] + ts - 1) // ts for a in reads],
                       np.int64)
    off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(nseg_of, out=off[1:])
    qflat = np.full(int(off[-1]), Q_NOCOV, np.int64)

    cols = columns_of(las)
    if cols.n and reads:
        # int32 throughout: the expansion is 10^7-10^8 trace segments
        # at block scale and the elementwise passes are memory-bound
        h = cols.headers
        rows = _decode_trace(cols.trace, las.small)
        seg_off = (cols.offsets // (2 if las.small else 4)).astype(
            np.int32)
        lens = np.diff(seg_off)
        rid = np.repeat(np.arange(cols.n, dtype=np.int32), lens)
        k = np.arange(rows.shape[0], dtype=np.int32) \
            - np.repeat(seg_off[:-1], lens)
        # 1D gathers (contiguous column then take) — 2D fancy
        # indexing on the [n, 10] header block is several-fold slower
        abp = np.ascontiguousarray(h[:, H_ABPOS])[rid]
        seg = abp // ts + k
        # segment fully covered <=> [seg*ts, (seg+1)*ts) inside
        # [abpos, aepos) — computed directly, no lo/hi temporaries
        s0 = seg * ts
        lut = np.full(max(reads) + 2, -1, np.int32)
        lut[np.array(reads)] = np.arange(len(reads), dtype=np.int32)
        aidx = lut[np.clip(h[:, H_AREAD], 0, len(lut) - 1)][rid]
        full = (s0 >= abp) \
            & (s0 + ts <= np.ascontiguousarray(h[:, H_AEPOS])[rid]) \
            & (aidx >= 0)
        dkey = (off[np.maximum(aidx[full], 0)]
                + seg[full]).astype(np.uint64)
        dval = rows[full, 0]
        if dkey.size:
            # scatter-min via sort + reduceat (ufunc.at is slow)
            order = np.argsort(dkey, kind="stable")
            ks = dkey[order].astype(np.int64)
            vs = dval[order].astype(np.int64)
            starts = np.concatenate([[True], ks[1:] != ks[:-1]])
            sidx = np.nonzero(starts)[0]
            qflat[ks[sidx]] = np.minimum(
                qflat[ks[sidx]], np.minimum.reduceat(vs, sidx))
    qual: dict[int, np.ndarray] = {
        a: qflat[off[i]:off[i + 1]].astype(np.int32)
        for i, a in enumerate(reads)}
    # trim: widest interval whose first/last segments are good
    good_idx = np.nonzero(qflat <= cfg.q_good)[0]
    lo = np.searchsorted(good_idx, off[:-1], side="left")
    hi = np.searchsorted(good_idx, off[1:], side="left")
    trim: dict[int, tuple[int, int]] = {}
    for i, a in enumerate(reads):
        if lo[i] >= hi[i]:
            trim[a] = (0, 0)
        else:
            tb = int(good_idx[lo[i]] - off[i]) * ts
            te = min(int(good_idx[hi[i] - 1] - off[i] + 1) * ts,
                     rlen_of[a])
            trim[a] = (tb, te)
    return qual, trim


def q_track(qual: dict[int, np.ndarray], nreads: int,
            index_of: dict[int, int]) -> Track:
    data = [np.zeros(0, np.int32)] * nreads
    for aread, q in qual.items():
        data[index_of[aread]] = q.astype(np.int32)
    return Track(name="q", data=data)


def trim_track(trim: dict[int, tuple[int, int]], nreads: int,
               index_of: dict[int, int]) -> Track:
    data = [np.zeros(0, np.int32)] * nreads
    for aread, (tb, te) in trim.items():
        data[index_of[aread]] = np.array([tb, te], np.int32)
    return Track(name="trim", data=data)


# --- LAfix (patch) ----------------------------------------------------------

@dataclass
class PatchedRead:
    src_read: int
    part: int
    seq: np.ndarray
    src_interval: tuple[int, int]   # A interval the part came from


def _best_covers(las: LasFile, ts: int):
    """Per (aread, absolute segment) best covering alignment, fully
    vectorized over the columnar trace tensor.

    Returns dict aread -> dict seg -> (diffs, bread, comp, b_lo, b_hi)
    where [b_lo, b_hi) is the B interval spanned by that segment of
    the winning alignment (via cumulative trace b-spans)."""
    cols = columns_of(las)
    if cols.n == 0:
        return {}
    h = cols.headers
    small = las.small
    rows = _decode_trace(cols.trace, small)
    if rows.shape[0] == 0:       # only empty traces (placeholders)
        return {}
    seg_off = cols.offsets // (2 if small else 4)
    lens = np.diff(seg_off)
    rid = np.repeat(np.arange(cols.n), lens)
    k = np.arange(rows.shape[0]) - np.repeat(seg_off[:-1], lens)
    abp = h[rid, H_ABPOS].astype(np.int64)
    aep = h[rid, H_AEPOS].astype(np.int64)
    seg = abp // ts + k
    a_lo = np.maximum(abp, seg * ts)
    a_hi = np.minimum(aep, (seg + 1) * ts)
    full = a_hi - a_lo == ts
    # cumulative b-span within each record -> segment B interval
    cum = np.cumsum(rows[:, 1].astype(np.int64))
    s0 = np.minimum(seg_off[:-1], max(rows.shape[0] - 1, 0))
    base = np.repeat(cum[s0] - rows[s0, 1], lens)
    cum_before = cum - rows[:, 1] - base
    b_lo = h[rid, H_BBPOS].astype(np.int64) + cum_before
    b_hi = b_lo + rows[:, 1]
    aread = h[rid, H_AREAD].astype(np.int64)
    # best (min diffs) per (aread, seg): sort and take group heads
    sel = np.nonzero(full)[0]
    if not len(sel):
        return {}
    key_r = aread[sel]
    key_s = seg[sel]
    d = rows[sel, 0].astype(np.int64)
    order = host_lexsort((d, key_s, key_r))
    sr, ss = key_r[order], key_s[order]
    head = np.concatenate([[True], (sr[1:] != sr[:-1])
                           | (ss[1:] != ss[:-1])])
    out: dict = {}
    for g in np.nonzero(head)[0]:
        i = sel[order[g]]
        r = int(aread[i])
        out.setdefault(r, {})[int(seg[i])] = (
            int(rows[i, 0]), int(h[rid[i], H_BREAD]),
            bool(np.uint32(h[rid[i], H_FLAGS]) & OVL_COMP),
            int(b_lo[i]), int(b_hi[i]))
    return out


def fix_reads(las: LasFile, seqs_of, rlen_of: dict[int, int],
              qual: dict[int, np.ndarray], cfg: ScrubConfig,
              reads_to_fix: list[int] | None = None) -> list[PatchedRead]:
    """Patch each read's bad segments from its best covering alignment
    (LAfix equivalent) and split at uncovered gaps.

    seqs_of(read_id, comp) -> base codes of that read (comp: reverse
    complement, used because COMP alignments express B in complement
    coordinates).  Returns patched read parts within trim intervals.
    Best-cover selection is one vectorized pass over the columnar
    trace tensor (_best_covers); only the output assembly walks
    per-read segments.
    """
    ts = las.tspace
    best_all = _best_covers(las, ts)
    out: list[PatchedRead] = []
    targets = reads_to_fix if reads_to_fix is not None else sorted(qual)
    for aread in targets:
        q = qual[aread]
        rl = rlen_of[aread]
        aseq = seqs_of(aread, False)
        nseg = len(q)
        best = best_all.get(aread, {})
        # build patched sequence segment by segment; split at gaps
        cur: list[np.ndarray] = []
        cur_lo = None
        last_seg_end = 0

        def flush(endpos):
            nonlocal cur, cur_lo
            if cur:
                seq = np.concatenate(cur)
                if len(seq) >= cfg.min_trim_len:
                    out.append(PatchedRead(
                        src_read=aread, part=len([
                            p for p in out if p.src_read == aread]),
                        seq=seq, src_interval=(cur_lo, endpos)))
            cur, cur_lo = [], None

        for seg in range(nseg):
            a_lo = seg * ts
            a_hi = min((seg + 1) * ts, rl)
            b = best.get(seg)
            if q[seg] == Q_NOCOV and b is None:
                # uncovered: break the read here
                flush(a_lo)
                continue
            if cur_lo is None:
                cur_lo = a_lo
            if q[seg] > cfg.q_bad and b is not None:
                _, bread, comp, blo, bhi = b
                bseq = seqs_of(bread, comp)
                cur.append(bseq[blo:bhi])
            else:
                cur.append(aseq[a_lo:a_hi])
            last_seg_end = a_hi
        flush(last_seg_end)
    return out


# --- LAgap ------------------------------------------------------------------

def gap_breaks(las: LasFile, rlen_of: dict[int, int], cfg: ScrubConfig
               ) -> dict[int, list[int]]:
    """Detect consistent pile breaks (chimeric junctions / missed
    adapters): positions where alignment coverage drops below
    gap_min_cov while both sides are covered (LAgap equivalent).
    Returns per-read break positions.  Columnar: one global event sort
    (aread, pos, delta) and a grouped coverage prefix replace the
    per-pile sweeps."""
    cols = columns_of(las)
    if cols.n == 0 or not rlen_of:
        return {}
    h = cols.headers
    ar = h[:, H_AREAD].astype(np.int64)
    lut = np.full(max(rlen_of) + 2, -1, np.int64)
    for a, rl in rlen_of.items():
        lut[a] = rl
    pos = np.concatenate([h[:, H_ABPOS], h[:, H_AEPOS]]).astype(np.int64)
    dl = np.concatenate([np.ones(cols.n, np.int64),
                         -np.ones(cols.n, np.int64)])
    ar2 = np.concatenate([ar, ar])
    order = np.lexsort((dl, pos, ar2))   # ends before starts at a tie
    ar_s, pos_s, dl_s = ar2[order], pos[order], dl[order]
    new_g = np.concatenate([[True], ar_s[1:] != ar_s[:-1]])
    cum = np.cumsum(dl_s)
    gstart = np.nonzero(new_g)[0]
    gid = np.cumsum(new_g) - 1
    gbase = np.where(gstart > 0, cum[np.maximum(gstart - 1, 0)], 0)
    prefix = cum - gbase[gid]            # coverage AFTER each event
    rl_s = lut[np.clip(ar_s, 0, len(lut) - 1)]
    # interval between events j-1 and j has coverage prefix[j-1]
    low = ((~new_g[1:]) & (prefix[:-1] < cfg.gap_min_cov)
           & (pos_s[:-1] > 0) & (pos_s[1:] > pos_s[:-1])
           & (rl_s[1:] >= 0)
           & (pos_s[:-1] > rl_s[1:] * 0.05)
           & (pos_s[1:] < rl_s[1:] * 0.95))
    breaks: dict[int, list[int]] = {}
    for idx in np.nonzero(low)[0]:
        a = int(ar_s[idx + 1])
        breaks.setdefault(a, []).append(
            int((pos_s[idx] + pos_s[idx + 1]) // 2))
    return breaks


def gap_trim(trim: dict[int, tuple[int, int]],
             breaks: dict[int, list[int]], ts: int | None = None
             ) -> dict[int, tuple[int, int]]:
    """LAgap's trim update: a read with consistent pile breaks keeps
    only its LONGEST good sub-interval between breaks (the reference
    trims/splits chimeric reads; downstream consumers see the trim
    track, so keeping one side is equivalent to a split whose shorter
    parts are dropped — upstream MARVEL/scrub/LAgap.c, mount empty).

    ts: snap interior cut positions to tspace boundaries so trimmed
    coordinates keep trace segments phase-aligned (clip_las_to_trim
    requires ts-aligned trim starts)."""
    out = dict(trim)
    for a, bs in breaks.items():
        tb, te = out.get(a, (0, 0))
        if te <= tb:
            continue
        cuts = [tb] + sorted(p for p in bs if tb < p < te) + [te]
        k = int(np.argmax(np.diff(cuts)))
        lo, hi = cuts[k], cuts[k + 1]
        if ts:
            if lo != tb:
                lo = -(-lo // ts) * ts          # ceil to boundary
            if hi != te:
                hi = (hi // ts) * ts            # floor to boundary
        out[a] = (lo, hi) if hi > lo else (0, 0)
    return out


def clip_las_to_trim(las: LasFile, rlen_of: dict[int, int],
                     trim_of: dict[int, tuple[int, int]]) -> LasFile:
    """Rewrite every record into TRIMMED coordinates (OGbuild -t
    parity; upstream MARVEL/touring/OGbuild.c trim handling, mount
    empty): alignments are clipped to the trim windows of both reads
    at trace-segment granularity, coordinates shift so that position 0
    is the trim start, and records with no surviving segment (or on an
    empty-trim read) are dropped.  Downstream stages (filter, graph,
    touring, polish) then operate on the trimmed read universe
    unchanged — read r's sequence is seq[tb:te] and its length te-tb.

    Requires trim starts at tspace boundaries (q_and_trim emits them
    that way; gap_trim snaps its cuts with ts=) so the absolute-
    boundary trace invariant survives the shift.  Fully columnar: one
    pass over the trace tensor, no per-record objects."""
    cols = columns_of(las)
    ts = las.tspace
    small = las.small
    n = cols.n
    if n == 0:
        return LasFile(tspace=ts, columns=LasColumns.empty())
    h = cols.headers
    rows = _decode_trace(cols.trace, small)
    seg_off = (cols.offsets // (2 if small else 4)).astype(np.int64)
    lens = np.diff(seg_off)
    m = rows.shape[0]
    rid = np.repeat(np.arange(n, dtype=np.int64), lens)
    k = np.arange(m, dtype=np.int64) - np.repeat(seg_off[:-1], lens)
    abp = h[:, H_ABPOS].astype(np.int64)
    aep = h[:, H_AEPOS].astype(np.int64)
    bbp = h[:, H_BBPOS].astype(np.int64)
    ar = h[:, H_AREAD].astype(np.int64)
    br = h[:, H_BREAD].astype(np.int64)
    comp = (h[:, H_FLAGS] & OVL_COMP) != 0
    size = int(max(ar.max(), br.max())) + 1
    lo_t, hi_t = trim_luts(rlen_of, trim_of, size)
    rl = np.zeros(size, np.int64)
    for r, L in rlen_of.items():
        if 0 <= r < size:
            rl[r] = L
    wa0, wa1 = lo_t[ar], hi_t[ar]
    wb0 = np.where(comp, rl[br] - hi_t[br], lo_t[br])
    wb1 = np.where(comp, rl[br] - lo_t[br], hi_t[br])
    # per-segment a/b intervals (absolute-boundary trace convention)
    a0 = np.maximum(abp[rid], (abp[rid] // ts + k) * ts)
    a1 = np.minimum(aep[rid], (abp[rid] // ts + k + 1) * ts)
    bspan = rows[:, 1].astype(np.int64)
    cum = np.cumsum(bspan)
    s0 = np.minimum(seg_off[:-1], max(m - 1, 0))
    base = np.repeat(cum[s0] - bspan[s0], lens)
    b0 = bbp[rid] + (cum - bspan - base)
    b1 = b0 + bspan
    keep = ((a0 >= wa0[rid]) & (a1 <= wa1[rid])
            & (b0 >= wb0[rid]) & (b1 <= wb1[rid]))
    kidx = np.nonzero(keep)[0]
    krid = rid[kidx]
    first = np.searchsorted(krid, np.arange(n), "left")
    last = np.searchsorted(krid, np.arange(n), "right")
    has = last > first
    hidx = np.nonzero(has)[0]
    if not len(hidx):
        return LasFile(tspace=ts, columns=LasColumns.empty())
    fk = kidx[first[hidx]]                 # first kept segment row
    lk = kidx[last[hidx] - 1]              # last kept segment row
    # keep the contiguous [fk, lk] run (b intervals are monotonic, so
    # interior segments of the run always satisfy the window tests)
    dec = np.zeros(m + 1, np.int64)
    np.add.at(dec, lk + 1, 1)
    inc = np.zeros(m + 1, np.int64)
    np.add.at(inc, fk, 1)
    cover = np.cumsum(inc[:-1] - dec[:-1]) > 0
    new_rows = rows[cover]
    new_lens = lk - fk + 1
    cumd = np.cumsum(rows[:, 0].astype(np.int64))
    diffs = cumd[lk] - cumd[fk] + rows[fk, 0]
    hdr = h[hidx].copy()
    hdr[:, H_ABPOS] = (a0[fk] - wa0[hidx]).astype(np.int32)
    hdr[:, H_AEPOS] = (a1[lk] - wa0[hidx]).astype(np.int32)
    hdr[:, H_BBPOS] = (b0[fk] - wb0[hidx]).astype(np.int32)
    hdr[:, H_BEPOS] = (b1[lk] - wb0[hidx]).astype(np.int32)
    hdr[:, H_DIFFS] = diffs.astype(np.int32)
    hdr[:, H_TLEN] = (2 * new_lens).astype(np.int32)
    new_off = np.zeros(len(hidx) + 1, np.int64)
    np.cumsum(new_lens, out=new_off[1:])
    payload, boffs = encode_trace_columns(new_rows, new_off, small)
    res = LasFile(tspace=ts, columns=LasColumns(hdr, payload, boffs))
    res.sort()
    return res


def trim_luts(rlen_of: dict[int, int],
              trim_of: dict[int, tuple[int, int]] | None,
              size: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-read-id effective (lo, hi) coordinate bound LUTs: the trim
    interval when present, else the full read (OGbuild -t semantics).
    Built once per call over reads (not records) and gathered by the
    columnar consumers."""
    lo = np.zeros(size, np.int64)
    hi = np.zeros(size, np.int64)
    for r, rl in rlen_of.items():
        if 0 <= r < size:
            hi[r] = rl
    if trim_of:
        for r, (tb, te) in trim_of.items():
            if 0 <= r < size:
                lo[r], hi[r] = tb, te
    return lo, hi


# --- LAfilter ---------------------------------------------------------------

def classify(o: Overlap, alen: int, blen: int, fuzz: int = 25) -> str:
    """Dovetail classification in trimmed coordinates."""
    a_l = o.abpos <= fuzz
    a_r = o.aepos >= alen - fuzz
    b_l = o.bbpos <= fuzz
    b_r = o.bepos >= blen - fuzz
    if a_l and a_r:
        return "a_contained"
    if b_l and b_r:
        return "b_contained"
    if (a_r and b_l) or (a_l and b_r):
        return "dovetail"
    if a_l or a_r or b_l or b_r:
        return "partial"
    return "local"


def filter_las(las: LasFile, rlen_of: dict[int, int],
               cfg: ScrubConfig, repeat_iv: dict[int, np.ndarray] | None
               = None, trim_of: dict[int, tuple[int, int]] | None = None
               ) -> LasFile:
    """LAfilter equivalent: flag discard on local, short, high-error,
    and repeat-only alignments; keep dovetails + containments.
    Columnar: every rule is an elementwise predicate on the record
    headers.

    trim_of: per-read usable interval (LAq/LAgap trim track).  When
    given, dovetail/containment classification runs against the trim
    boundaries instead of the raw read ends, alignments entirely
    outside a trim interval are discarded, and reads with an empty
    trim lose all their records (the reference's LAfilter -t /
    OGbuild -t contract — upstream-path citation, mount empty)."""
    cols = columns_of(las)
    n = cols.n
    if n == 0:
        return LasFile(tspace=las.tspace,
                       columns=LasColumns.empty())
    h = cols.headers
    ids = np.unique(np.concatenate([h[:, H_AREAD], h[:, H_BREAD]]))
    lut = np.full(int(ids.max()) + 2 if len(ids) else 1, -1, np.int64)
    for a, rl in rlen_of.items():
        if 0 <= a < len(lut):
            lut[a] = rl
    ai = np.clip(h[:, H_AREAD], 0, len(lut) - 1)
    bi = np.clip(h[:, H_BREAD], 0, len(lut) - 1)
    alen = lut[ai]
    blen = lut[bi]
    keep = (alen >= 0) & (blen >= 0)

    abp, aep = h[:, H_ABPOS], h[:, H_AEPOS]
    bbp, bep = h[:, H_BBPOS], h[:, H_BEPOS]
    fuzz = cfg.filter_fuzz
    comp = (h[:, H_FLAGS] & OVL_COMP) != 0
    lo_t, hi_t = trim_luts(rlen_of, trim_of, len(lut))
    a_lo, a_hi = lo_t[ai], hi_t[ai]
    # COMP records carry b coordinates in the flipped frame: the trim
    # interval [lo, hi) maps to [blen - hi, blen - lo)
    b_lo = np.where(comp, blen - hi_t[bi], lo_t[bi])
    b_hi = np.where(comp, blen - lo_t[bi], hi_t[bi])
    if trim_of is not None:
        # record must overlap both trim windows; empty-trim reads die
        keep &= (np.minimum(aep, a_hi) - np.maximum(abp, a_lo) > 0) \
            & (np.minimum(bep, b_hi) - np.maximum(bbp, b_lo) > 0)
    a_l = abp <= a_lo + fuzz
    a_r = aep >= a_hi - fuzz
    b_l = bbp <= b_lo + fuzz
    b_r = bep >= b_hi - fuzz
    a_cont = a_l & a_r
    b_cont = ~a_cont & b_l & b_r
    dove = ~a_cont & ~b_cont & ((a_r & b_l) | (a_l & b_r))
    partial = ~a_cont & ~b_cont & ~dove & (a_l | a_r | b_l | b_r)
    local = ~(a_cont | b_cont | dove | partial)

    flags = h[:, H_FLAGS].astype(np.int64)
    olen = (aep - abp).astype(np.int64)
    flags |= np.where(olen < cfg.filter_min_len, OVL_DISCARD, 0)
    flags |= np.where(h[:, H_DIFFS] > cfg.filter_max_diff * olen,
                      OVL_DISCARD, 0)
    flags |= np.where(local, OVL_LOCAL | OVL_DISCARD, 0)
    flags |= np.where(partial, OVL_DISCARD | OVL_GAP, 0)
    flags |= np.where(a_cont | b_cont, OVL_CONT, 0)
    if repeat_iv is not None:
        # chain-aware unique-anchor rule (LAfilterChains analogue,
        # SURVEY.md §2.6 ⟨VERIFY⟩): an alignment must be anchored by
        # at least anchor_min bases OUTSIDE repeat intervals — a
        # repeat sitting at a read end turns copy-vs-copy alignments
        # into plausible dovetails that branch (and break) the graph.
        # Group rows by aread ONCE (a scan per repeat-read would be
        # O(reads x records) on block-scale inputs).
        covered = np.zeros(n, np.int64)
        order = np.argsort(h[:, H_AREAD], kind="stable")
        ar_s = h[order, H_AREAD]
        g_start = np.concatenate([[0], np.nonzero(
            ar_s[1:] != ar_s[:-1])[0] + 1])
        g_end = np.concatenate([g_start[1:], [n]])
        for s_, e_ in zip(g_start, g_end):
            iv = repeat_iv.get(int(ar_s[s_]))
            if iv is None or not len(iv):
                continue
            sel = order[s_:e_]
            p = np.asarray(iv).reshape(-1, 2)
            covered[sel] = np.clip(
                np.minimum(aep[sel, None], p[None, :, 1])
                - np.maximum(abp[sel, None], p[None, :, 0]),
                0, None).sum(axis=1)
        unique = olen - covered
        flags |= np.where((covered > 0) & (unique < cfg.anchor_min),
                          OVL_REPEAT | OVL_DISCARD, 0)

    # ---- mirror symmetry (LAfilter's symmetric-discard contract,
    # upstream MARVEL/scrub/LAfilter.c + lib/oflags.h OVL_SYMDISCARD
    # ⟨VERIFY⟩): a record and its mirror must both survive or neither.
    # Records are matched to their mirrors by a canonical pair key
    # (reflected coordinates for COMP records); any discard propagates
    # to the partner, which is marked OVL_SYMDISCARD.  The asymmetric
    # rules above (A-span min_len/max_diff, the A-side unique-anchor
    # repeat rule) become symmetric through this pass. ----
    a64 = h[:, H_AREAD].astype(np.int64)
    b64 = h[:, H_BREAD].astype(np.int64)
    abp64, aep64 = abp.astype(np.int64), aep.astype(np.int64)
    bbp64, bep64 = bbp.astype(np.int64), bep.astype(np.int64)
    t_own = (a64, b64, abp64, aep64, bbp64, bep64)
    m_abp = np.where(comp, blen - bep64, bbp64)
    m_aep = np.where(comp, blen - bbp64, bep64)
    m_bbp = np.where(comp, alen - aep64, abp64)
    m_bep = np.where(comp, alen - abp64, aep64)
    t_mir = (b64, a64, m_abp, m_aep, m_bbp, m_bep)
    less = np.zeros(n, bool)
    eq = np.ones(n, bool)
    for x, y in zip(t_mir, t_own):
        less |= eq & (x < y)
        eq &= x == y
    use_mir = less
    kc = [np.where(use_mir, m, o) for o, m in zip(t_own, t_mir)]
    kc.append(comp.astype(np.int64))
    order = np.lexsort(tuple(reversed(kc)))
    ks = [c[order] for c in kc]
    same = np.ones(n, bool)
    same[0] = False
    for c in ks:
        same[1:] &= c[1:] == c[:-1]
    gid = np.cumsum(~same) - 1

    if getattr(cfg, "filter_best_n", 0) and n:
        # best-n per read end over live dovetails: rank by span desc,
        # ties by diffs asc; a record is dropped only when BOTH its
        # ends rank out (its own a-end here, its mirror's a-end via
        # the pair group), keeping the selection mirror-symmetric
        nb = int(cfg.filter_best_n)
        live0 = (flags & OVL_DISCARD) == 0
        is_dove = dove & live0
        endk = ((h[:, H_AREAD].astype(np.int64) << 1)
                | (a_r & b_l).astype(np.int64))
        dd = h[:, H_DIFFS].astype(np.int64)
        omax = int(olen.max()) + 1 if n else 1
        eo = np.lexsort((dd, omax - olen, np.where(is_dove, endk, -1)))
        ek = np.where(is_dove, endk, -1)[eo]
        estart = np.concatenate([[0], np.nonzero(
            ek[1:] != ek[:-1])[0] + 1])
        erank = np.arange(n) - estart[np.cumsum(np.concatenate(
            [[True], ek[1:] != ek[:-1]])) - 1]
        cand = np.zeros(n, bool)
        cand[eo] = (ek >= 0) & (erank >= nb)
        # pair-AND: discard iff candidate on every end of the pair
        cand_s = cand[order]
        grp_min = np.minimum.reduceat(
            cand_s.astype(np.int64), np.nonzero(~same)[0])
        both = grp_min[gid].astype(bool) & cand_s
        upd = order[both]
        flags[upd] |= OVL_DISCARD | OVL_SYMDISCARD

    if n:
        disc_s = (flags[order] & OVL_DISCARD) != 0
        grp_any = np.maximum.reduceat(
            disc_s.astype(np.int64), np.nonzero(~same)[0])
        prop = grp_any[gid].astype(bool) & ~disc_s
        upd = order[prop]
        flags[upd] |= OVL_DISCARD | OVL_SYMDISCARD

    hdr = h.copy()
    hdr[:, H_FLAGS] = flags.astype(np.uint32).view(np.int32)
    new = LasColumns(hdr, cols.trace, cols.offsets)
    kidx = np.nonzero(keep)[0]
    if len(kidx) != n:
        new = new.permute(kidx)
    res = LasFile(tspace=las.tspace, columns=new)
    res.sort()
    return res
