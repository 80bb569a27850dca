"""The plain reference that decides `correct`: numpy and plain torch
only, importing nothing of the program.

It judges the .las records that the timed window produced against what
the configuration states (daligner -k -w -h -e -l -s, every overlap with
its mirror, the Dazzler file layout and sort order) and against the
generator's ground truth, from the same reads that the program was given:

- `format_faults`: records that break the layout or a stated guarantee:
  read ids outside the compared blocks, coordinates outside the reads,
  an alignment under -l on both reads (a mirror's A span is its
  primary's B span), a trace whose segment count is not the -s grid's,
  whose B spans do not sum to the B interval or whose diffs do not sum
  to the record's, a flag other than the complement bit, a record out of
  (aread, bread, comp, abpos, aepos, bbpos) order, an exact duplicate,
  and a record whose mirror (the same alignment seen from the B read) is
  missing.  Exact: the limit is 0.
- `segment_faults`: over a sample of records drawn from the seed, with
  the longest in it, trace segments whose recorded diffs are fewer than
  the edit distance between the segment's A bases and its B bases (B
  reverse-complemented for a complement record): no alignment of the
  two has fewer differences.  Exact: the limit is 0.
- `missed_true_pct`: over a sample of A reads drawn from the seed, the
  share of B reads whose genome span overlaps theirs by at least
  `true_min_bp` (the generator's ground truth) for which no record of
  that read pair, in the true orientation, was emitted.
- `misplaced_pct`: the share of all records whose alignment does not
  lie at one place of the genome (the generator's truth): its A start
  and B start, and its A end and B end, mapped through each read's start,
  strand and span, fall more than `slack_bp` apart, unless both lie at
  the same offset of two planted repeat copies; for the sampled records
  every trace point is held to the same rule.  A record between reads
  that share no genome, or one that runs past the reads' true overlap
  (whose ends are read ends), breaks it.
- `over_e_pct`: the share of all records whose diffs exceed daligner's
  -e bound, (1 - e) x the mean of the A and B spans.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic import seed_words, true_overlap

COMP = 0x1
RECORD = 40            # bytes of a record's header
TRACE_XOVR = 125       # tspace above which trace values are int16


# --- the .las layout --------------------------------------------------------

def parse_las(path: str):
    """A .las file as (tspace, headers [n, 10] int32, trace pairs
    [m, 2] int32, segment offsets [n + 1]).  Raises ValueError on a
    file that does not parse whole."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size < 12:
        raise ValueError(f"{path}: no header")
    novl = int(raw[:8].view("<i8")[0])
    tspace = int(raw[8:12].view("<i4")[0])
    if novl < 0 or 12 + RECORD * novl > raw.size:
        raise ValueError(f"{path}: header claims {novl} records")
    width = 1 if tspace <= TRACE_XOVR else 2
    words = memoryview(raw)
    rec = np.zeros(novl, np.int64)
    lens = np.zeros(novl, np.int64)
    pos, end = 12, raw.size
    for i in range(novl):
        if pos + RECORD > end:
            raise ValueError(f"{path}: truncated record {i}")
        t = int.from_bytes(words[pos:pos + 4], "little", signed=True)
        tb = t * width
        if tb < 0 or pos + RECORD + tb > end:
            raise ValueError(f"{path}: truncated trace of record {i}")
        rec[i] = pos
        lens[i] = tb
        pos += RECORD + tb
    if pos != end:
        raise ValueError(f"{path}: {end - pos} trailing bytes")
    headers = raw[rec[:, None] + np.arange(RECORD)].view("<i4").reshape(
        novl, 10).copy()
    offs = np.zeros(novl + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    idx = (np.repeat(rec + RECORD - offs[:-1], lens)
           + np.arange(int(offs[-1])))
    payload = raw[idx]
    return (tspace, headers) + decode_trace(payload, offs, tspace)


def decode_trace(payload: np.ndarray, byte_offsets: np.ndarray,
                 tspace: int):
    """File-encoded trace bytes -> (pairs [m, 2] int32, segment offsets)."""
    if tspace <= TRACE_XOVR:
        vals = payload.astype(np.int32)
        per = 2
    else:
        vals = payload.view("<i2").astype(np.int32)
        per = 4
    if vals.size % 2:
        raise ValueError("odd trace length")
    return vals.reshape(-1, 2), np.asarray(byte_offsets, np.int64) // per


# --- checks -----------------------------------------------------------------

def _lex_nondecreasing(cols: list[np.ndarray]) -> np.ndarray:
    """bool[n - 1]: row i + 1 sorts before row i under the key columns."""
    n = len(cols[0])
    after = np.zeros(max(n - 1, 0), bool)
    viol = np.zeros(max(n - 1, 0), bool)
    for c in cols:
        c = c.astype(np.int64)
        viol |= ~after & (c[1:] < c[:-1])
        after |= c[1:] > c[:-1]
    return viol


def _row_keys(a: np.ndarray) -> np.ndarray:
    """Rows of an int64 matrix as one sortable structured key."""
    a = np.ascontiguousarray(a.astype(np.int64))
    return a.view([("", np.int64)] * a.shape[1]).ravel()


def mirror_of(h: np.ndarray, rlen: np.ndarray) -> np.ndarray:
    """[n, 7] (aread, bread, comp, abpos, aepos, bbpos, bepos) of each
    record's mirror: B's view of the same alignment, in B's complement
    space when the record is a complement one."""
    ar, br = h[:, 7].astype(np.int64), h[:, 8].astype(np.int64)
    comp = (h[:, 6] & COMP).astype(np.int64)
    abp, aep = h[:, 2].astype(np.int64), h[:, 4].astype(np.int64)
    bbp, bep = h[:, 3].astype(np.int64), h[:, 5].astype(np.int64)
    la, lb = rlen[ar], rlen[br]
    m_abp = np.where(comp == 1, lb - bep, bbp)
    m_aep = np.where(comp == 1, lb - bbp, bep)
    m_bbp = np.where(comp == 1, la - aep, abp)
    m_bep = np.where(comp == 1, la - abp, aep)
    return np.stack([br, ar, comp, m_abp, m_aep, m_bbp, m_bep], 1)


def identity_of(h: np.ndarray) -> np.ndarray:
    return np.stack([h[:, 7], h[:, 8], h[:, 6] & COMP, h[:, 2], h[:, 4],
                     h[:, 3], h[:, 5]], 1).astype(np.int64)


def format_faults(files: list[tuple], rlen: np.ndarray, a_ids: np.ndarray,
                  b_ids: np.ndarray, cfg: dict, mirrors: str) -> dict:
    """Per-record layout and guarantee checks over every record.

    files: one or two parsed files (tspace, headers, pairs, seg_offsets).
    mirrors: "within" (one file holds each record and its mirror, a self
    pair's merged file) or "across" (files[0]'s mirrors are files[1]'s
    records, a distinct pair).  Returns counts by kind and `total`."""
    out: dict[str, int] = {}
    tspace_want = int(cfg["tspace"])
    min_len = int(cfg["min_len"])
    ident = []
    for k, (tspace, h, pairs, soff) in enumerate(files):
        n = h.shape[0]
        if tspace != tspace_want:
            out["tspace"] = out.get("tspace", 0) + max(n, 1)
        ar, br = h[:, 7].astype(np.int64), h[:, 8].astype(np.int64)
        a_set, b_set = (a_ids, b_ids) if k == 0 else (b_ids, a_ids)
        ids_ok = (np.isin(ar, a_set) & np.isin(br, b_set)
                  & (ar >= 0) & (br >= 0) & (ar < len(rlen))
                  & (br < len(rlen)))
        bad = ~ids_ok
        out["read_ids"] = out.get("read_ids", 0) + int(bad.sum())
        arc, brc = np.where(ids_ok, ar, 0), np.where(ids_ok, br, 0)
        abp, aep = h[:, 2].astype(np.int64), h[:, 4].astype(np.int64)
        bbp, bep = h[:, 3].astype(np.int64), h[:, 5].astype(np.int64)
        coords = ((abp < 0) | (abp >= aep) | (aep > rlen[arc])
                  | (bbp < 0) | (bbp >= bep) | (bep > rlen[brc])) & ids_ok
        out["coordinates"] = out.get("coordinates", 0) + int(coords.sum())
        short = np.maximum(aep - abp, bep - bbp) < min_len
        out["under_min_len"] = out.get("under_min_len", 0) + int(short.sum())
        flags = (h[:, 6].astype(np.int64) & ~COMP) != 0
        out["flags"] = out.get("flags", 0) + int(flags.sum())
        tlen = h[:, 0].astype(np.int64)
        nseg_got = soff[1:] - soff[:-1]
        grid = np.where(aep > abp,
                        (aep - 1) // tspace_want - abp // tspace_want + 1, 0)
        nseg_bad = (tlen != 2 * nseg_got) | (nseg_got != grid)
        out["trace_segments"] = out.get("trace_segments", 0) + int(
            nseg_bad.sum())
        bsum = np.zeros(n, np.int64)
        dsum = np.zeros(n, np.int64)
        nz = nseg_got > 0
        if pairs.shape[0]:
            bsum[nz] = np.add.reduceat(pairs[:, 1].astype(np.int64),
                                       soff[:-1][nz])
            dsum[nz] = np.add.reduceat(pairs[:, 0].astype(np.int64),
                                       soff[:-1][nz])
        sums = (bsum != bep - bbp) | (dsum != h[:, 1])
        out["trace_sums"] = out.get("trace_sums", 0) + int(sums.sum())
        viol = _lex_nondecreasing([ar, br, h[:, 6] & COMP, abp, aep, bbp])
        out["sort_order"] = out.get("sort_order", 0) + int(viol.sum())
        key = identity_of(h)
        _, counts = np.unique(_row_keys(key), return_counts=True)
        out["duplicates"] = out.get("duplicates", 0) + int(
            (counts - 1).sum())
        ident.append((key, h, ids_ok))
    # mirrors: the multiset of mirror images equals the multiset of
    # records on the other side
    if mirrors == "within":
        (key, h, ok), = ident
        mir = mirror_of(h[ok], rlen)
        missing = _missing(mir, key[ok])
    else:
        (ka, ha, oka), (kb, hb, okb) = ident
        missing = (_missing(mirror_of(ha[oka], rlen), kb[okb])
                   + _missing(mirror_of(hb[okb], rlen), ka[oka]))
    out["mirrors"] = missing
    out["total"] = int(sum(v for k, v in out.items()))
    return out


def _missing(want: np.ndarray, have: np.ndarray) -> int:
    """Rows of `want` that `have` lacks (as multisets), plus rows of
    `have` that no row of `want` accounts for."""
    kw, cw = np.unique(_row_keys(want), return_counts=True)
    kh, ch = np.unique(_row_keys(have), return_counts=True)
    common, iw, ih = np.intersect1d(kw, kh, return_indices=True)
    matched = np.minimum(cw[iw], ch[ih]).sum()
    return int(cw.sum() - matched + ch.sum() - matched)


def edit_distances(a_segs: list[np.ndarray], b_segs: list[np.ndarray],
                   device, batch: int = 1 << 15) -> np.ndarray:
    """Global (end to end) edit distance of each pair of code arrays, by
    the row-by-row DP with unit costs, over batches of pairs at once:
    D[r][j] = min(D[r-1][j] + 1, D[r-1][j-1] + (a_r != b_j), D[r][j-1] + 1),
    the last term as a running minimum along the row."""
    n = len(a_segs)
    out = np.zeros(n, np.int64)
    for lo in range(0, n, batch):
        A = a_segs[lo:lo + batch]
        B = b_segs[lo:lo + batch]
        la = np.array([len(x) for x in A], np.int64)
        lb = np.array([len(x) for x in B], np.int64)
        ra, wb = int(la.max(initial=0)), int(lb.max(initial=0))
        S = len(A)
        am = np.full((S, max(ra, 1)), 9, np.int16)
        bm = np.full((S, wb + 1), 8, np.int16)
        for i, (x, y) in enumerate(zip(A, B)):
            am[i, :len(x)] = x
            bm[i, 1:len(y) + 1] = y
        a_t = torch.as_tensor(am, device=device)
        b_t = torch.as_tensor(bm, device=device)
        la_t = torch.as_tensor(la, device=device)
        lb_t = torch.as_tensor(lb, device=device)
        j = torch.arange(wb + 1, device=device, dtype=torch.int32)
        D = j.repeat(S, 1)
        res = torch.where(la_t == 0, lb_t, 0).to(torch.int32)
        for r in range(1, ra + 1):
            mism = (b_t != a_t[:, r - 1:r]).to(torch.int32)
            T = D + 1
            T[:, 1:] = torch.minimum(T[:, 1:], D[:, :-1] + mism[:, 1:])
            T[:, 0] = r
            D = torch.cummin(T - j, dim=1).values + j
            hit = la_t == r
            if bool(hit.any()):
                res = torch.where(hit, D.gather(1, lb_t[:, None]).squeeze(1)
                                  .to(torch.int32), res)
        out[lo:lo + S] = res.cpu().numpy()
    return out


def _segments_of(tspace: int, h: np.ndarray, pairs: np.ndarray,
                 soff: np.ndarray, rows: np.ndarray, seq_of):
    """The (A bases, B bases, recorded diffs) of every trace segment of
    the records `rows`."""
    a_s, b_s, d = [], [], []
    for r in rows.tolist():
        ar, br = int(h[r, 7]), int(h[r, 8])
        comp = bool(h[r, 6] & COMP)
        abp, aep, bbp = int(h[r, 2]), int(h[r, 4]), int(h[r, 3])
        aseq = seq_of(ar)
        bseq = seq_of(br)
        if comp:
            bseq = (3 - bseq[::-1]).astype(np.uint8)
        tr = pairs[soff[r]:soff[r + 1]]
        a0, b0 = abp, bbp
        for k in range(tr.shape[0]):
            a1 = min((a0 // tspace + 1) * tspace, aep)
            b1 = b0 + int(tr[k, 1])
            a_s.append(aseq[a0:a1])
            b_s.append(bseq[b0:b1])
            d.append(int(tr[k, 0]))
            a0, b0 = a1, b1
    return a_s, b_s, np.array(d, np.int64)


def segment_faults(parsed: tuple, rows: np.ndarray, seq_of, device) -> dict:
    """Trace segments of the sampled records whose recorded diffs are
    below their edit distance; also the segments checked and the
    recorded diffs above the distance (the band's cost), for the log."""
    tspace, h, pairs, soff = parsed
    a_s, b_s, d = _segments_of(tspace, h, pairs, soff, rows, seq_of)
    if not len(d):
        return dict(segment_faults=0, segments=0, excess=0)
    ed = edit_distances(a_s, b_s, device)
    return dict(segment_faults=int((d < ed).sum()), segments=len(d),
                excess=int((d - ed).clip(min=0).sum()))


def sample_records(h: np.ndarray, rng: np.random.Generator, k: int,
                   longest: int) -> np.ndarray:
    """k records drawn at random and the `longest` longest by A span."""
    n = h.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    span = h[:, 4].astype(np.int64) - h[:, 2]
    top = np.argsort(-span, kind="stable")[:longest]
    pick = rng.choice(n, size=min(k, n), replace=False)
    return np.unique(np.concatenate([top, pick]))


def missed_true(h_all: np.ndarray, truth, a_ids: np.ndarray,
                b_ids: np.ndarray, rng: np.random.Generator, k: int,
                min_bp: int, self_pair: bool,
                also_bp: tuple = (2000,)) -> dict:
    """Over k A reads drawn at random: the true partners among the B
    reads (genome overlap >= min_bp) and how many have no record in the
    true orientation.  h_all: the headers of every record whose A read
    is in the A block.  truth(i, j) -> (overlap bp, comp) arrays.  The
    shares at the thresholds `also_bp` go to the log (`missed_by_bp`)."""
    picks = rng.choice(a_ids, size=min(k, len(a_ids)), replace=False)
    have = set()
    sel = np.isin(h_all[:, 7], picks)
    for ar, br, c in zip(h_all[sel, 7].tolist(), h_all[sel, 8].tolist(),
                         (h_all[sel, 6] & COMP).tolist()):
        have.add((ar, br, c))
    ths = sorted({int(min_bp), *map(int, also_bp)})
    want = dict.fromkeys(ths, 0)
    missed = dict.fromkeys(ths, 0)
    for i in picks.tolist():
        ov, comp = truth(i, b_ids)
        keep = ov >= ths[0]
        if self_pair:
            keep &= b_ids != i
        for j, c, o in zip(b_ids[keep].tolist(), comp[keep].tolist(),
                           ov[keep].tolist()):
            miss = (i, j, int(c)) not in have
            for t in ths:
                if o >= t:
                    want[t] += 1
                    missed[t] += miss
    return dict(true_pairs=want[min_bp], missed=missed[min_bp],
                missed_true_pct=100.0 * missed[min_bp] / max(want[min_bp], 1),
                missed_by_bp={t: round(100.0 * missed[t] / max(want[t], 1), 4)
                              for t in ths})


# --- the generator's truth -------------------------------------------------

def genome_at(reads, ids: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The genome coordinate (forward strand, on the circle) of boundary
    `pos` of each read `ids`: the read's start plus pos scaled by its
    span over its length (its indels drift the true place by some tens
    of bases), counted back from the span's end on the reverse strand."""
    ids = np.asarray(ids, np.int64)
    lens = np.maximum(reads.lengths[ids], 1).astype(np.float64)
    span = reads.span[ids].astype(np.float64)
    f = np.asarray(pos, np.float64) * span / lens
    start = reads.start[ids].astype(np.float64)
    g = np.where(reads.strand[ids] == 1, start + span - f, start + f)
    return np.mod(g, reads.genome_bp)


def same_place(reads, x: np.ndarray, y: np.ndarray,
               slack: float) -> np.ndarray:
    """bool: genome coordinates x and y lie within `slack` on the circle,
    or at offsets within `slack` of each other in two planted repeat
    copies (each copy widened by `slack`)."""
    G = reads.genome_bp
    d = np.abs(x - y)
    ok = np.minimum(d, G - d) <= slack
    c = np.asarray(reads.repeat_starts, np.float64)
    rest = np.nonzero(~ok)[0]
    if len(c) and len(rest):
        R = reads.repeat_bp

        def offsets(v):
            o = v[rest, None] - c[None, :]
            return np.where((o >= -slack) & (o < R + slack), o, np.nan)
        ox, oy = offsets(x), offsets(y)
        hit = np.zeros(len(rest), bool)
        for z in range(len(c)):
            hit |= (np.abs(ox[:, z:z + 1] - oy) <= slack).any(axis=1)
        ok[rest] = hit
    return ok


def _b_forward(h: np.ndarray, reads, q: np.ndarray) -> np.ndarray:
    """B coordinates of records as boundaries of the B read's forward
    sequence (a complement record counts in B's reverse complement)."""
    lb = reads.lengths[h[:, 8].astype(np.int64)]
    return np.where(h[:, 6] & COMP, lb - q, q)


def misplaced(parsed: tuple, reads, slack: float,
              rows: np.ndarray) -> np.ndarray:
    """bool per record: the alignment is not at one place of the genome.
    Every record is held at its two ends (A start with B start, A end
    with B end); the records `rows` also at every trace point.  Records
    whose read ids lie outside the reads are left to format_faults."""
    tspace, h, pairs, soff = parsed
    n = h.shape[0]
    bad = np.zeros(n, bool)
    if n == 0:
        return bad
    ar, br = h[:, 7].astype(np.int64), h[:, 8].astype(np.int64)
    ok_ids = (ar >= 0) & (ar < reads.n) & (br >= 0) & (br < reads.n)
    ix = np.nonzero(ok_ids)[0]
    hv = h[ix].astype(np.int64)
    a_ids, b_ids = hv[:, 7], hv[:, 8]
    for ap, bp in ((2, 3), (4, 5)):
        ga = genome_at(reads, a_ids, hv[:, ap])
        gb = genome_at(reads, b_ids, _b_forward(hv, reads, hv[:, bp]))
        bad[ix] |= ~same_place(reads, ga, gb, slack)
    for r in rows.tolist():
        if not ok_ids[r] or bad[r]:
            continue
        abp, aep, bbp = int(h[r, 2]), int(h[r, 4]), int(h[r, 3])
        tr = pairs[soff[r]:soff[r + 1]]
        grid = np.arange((abp // tspace + 1) * tspace, aep, tspace)
        a_pts = np.concatenate([[abp], grid, [aep]])[:len(tr) + 1]
        b_pts = bbp + np.concatenate([[0], np.cumsum(tr[:, 1])])
        m = len(a_pts) if len(a_pts) == len(b_pts) else 0
        if not m:
            continue
        one = h[r:r + 1].astype(np.int64).repeat(m, 0)
        ga = genome_at(reads, one[:, 7], a_pts)
        gb = genome_at(reads, one[:, 8], _b_forward(one, reads, b_pts))
        bad[r] = not same_place(reads, ga, gb, slack).all()
    return bad


def over_e(h: np.ndarray, err: float) -> np.ndarray:
    """bool per record: diffs above (1 - e) x the mean of its spans."""
    span = ((h[:, 4].astype(np.int64) - h[:, 2])
            + (h[:, 5].astype(np.int64) - h[:, 3])) / 2.0
    return h[:, 1] > (1.0 - float(err)) * np.maximum(span, 1)


def judge(files: list[tuple], reads, a_ids: np.ndarray, b_ids: np.ndarray,
          cfg: dict, check: dict, seed: int, device) -> dict:
    """Every number `correct` compares, for the records of one unit of
    work.  files: one parsed file (self pair, mirrors within) or two
    (distinct pair: A's records, then B's).  reads: the generator's
    Reads; a read's id is its index there.  check: the cell's sample
    sizes (records, longest, a_reads, true_min_bp) and slack_bp."""
    rng = np.random.default_rng(seed_words(seed, 0x6A75))
    rlen = reads.lengths
    mirrors = "within" if len(files) == 1 else "across"
    fmt = format_faults(files, rlen, a_ids, b_ids, cfg, mirrors)
    seq_of = reads.read
    seg = {"segment_faults": 0, "segments": 0, "excess": 0}
    n_rec = n_mis = n_over = 0
    for parsed in files:
        rows = sample_records(parsed[1], rng, int(check["records"]),
                              int(check["longest"]))
        s = segment_faults(parsed, rows, seq_of, device)
        for k in seg:
            seg[k] += s[k]
        n_rec += parsed[1].shape[0]
        n_mis += int(misplaced(parsed, reads, float(check["slack_bp"]),
                               rows).sum())
        n_over += int(over_e(parsed[1], cfg["err"]).sum())
    strand = reads.strand.astype(np.int64)

    def truth(i, js):
        ov = true_overlap(reads, np.full(len(js), i), js)
        return ov, (strand[i] != strand[js]).astype(np.int64)

    rec = missed_true(files[0][1], truth, a_ids, b_ids, rng,
                      int(check["a_reads"]), int(check["true_min_bp"]),
                      self_pair=len(files) == 1)
    share = 100.0 / max(n_rec, 1)
    return dict(format_faults=fmt["total"], format=fmt, **seg, **rec,
                records=n_rec, misplaced=n_mis,
                misplaced_pct=n_mis * share, over_e=n_over,
                over_e_pct=n_over * share)
