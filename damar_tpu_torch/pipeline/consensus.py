"""Pile consensus and polishing: the port of
damar_tpu/pipeline/consensus.py (MARVEL corrector/ + msa/ equivalent).

Template-anchored consensus: every covering sequence is aligned to the
template window (banded edit DP with full traceback), alignments are
decomposed into per-template-column votes (match/sub base, deletion,
insertions after the column), and the majority column calls produce the
polished sequence.

Used two ways, as in the reference:
  * polish_contig: after touring, each tour step records where its read
    landed in the contig, so read windows map to contig windows with no
    extra alignment search;
  * correct_reads: a read pile from .las records maps B windows through
    trace points.

The votes, calls and layouts are the reference's host numpy, kept as
written (float64 np.interp, the stable sorts, dict insertion orders).
The alignments run on the pile aligner K4 (ops/band_align.py) on
`device`: one launch for all the covers of a polish window, and one for
all the (sub-template, cover) pairs of a read in correct_reads (a read's
windows do not depend on each other's alignments); on the CPU its plain
version.  Nothing falls back to numpy or host C.
"""
from __future__ import annotations

import os

import numpy as np

from damar_tpu_torch.formats.fasta import revcomp
from damar_tpu_torch.formats.las import (H_ABPOS, H_AEPOS, H_AREAD, H_BBPOS,
                                         H_BEPOS, H_BREAD, H_FLAGS,
                                         _decode_trace, columns_of)
from damar_tpu_torch.formats.oflags import OVL_COMP, OVL_DISCARD
from damar_tpu_torch.ops.band_align import align_pairs
from damar_tpu_torch.pipeline.poa import poa_consensus

# correct_reads: the (sub-template, cover) pairs of one K4 launch, about
# (whole reads are gathered until a group reaches it)
CORRECT_PAIRS = 4096


def _ops_to_path(ops: np.ndarray, jstart: int
                 ) -> list[tuple[int, int, int]]:
    path = []
    i, j = 0, jstart
    for op in ops:
        if op == 0:
            path.append((0, i, j))
            i += 1
            j += 1
        elif op == 1:
            path.append((1, i, j))
            i += 1
        else:
            path.append((2, i, j))
            j += 1
    return path


def banded_align_path(a: np.ndarray, b: np.ndarray, band: int = 64,
                      semiglobal: bool = True, *, device
                      ) -> list[tuple[int, int, int]]:
    """Banded edit alignment of a (template) vs b; returns the path as
    (op, i, j) triples: 0 = match/sub consuming a[i], b[j]; 1 = del
    consuming a[i]; 2 = ins consuming b[j].

    semiglobal: leading/trailing b overhangs are free (b may extend past
    the template on both sides without cost), so the path covers all of a
    but only the aligned span of b.  One pair through the pile aligner
    (K4 on a CUDA device, its plain version on the CPU), which gives
    damar_tpu's host C band_align's path, the aligner its pipeline runs."""
    (ops, jstart), = align_pairs([(a, b, band)], semiglobal, device=device)
    return _ops_to_path(ops, jstart)


def _new_votes(m: int) -> tuple[np.ndarray, list[dict]]:
    return np.zeros((m, 5), np.int32), [dict() for _ in range(m + 1)]


def _vote_ops_multi(votes: np.ndarray, ins_votes: list[dict],
                    items: list[tuple[np.ndarray, int, np.ndarray]]
                    ) -> None:
    """Register many covers' votes in ONE vectorized pass (the
    per-cover numpy calls were overhead-bound at ~600-element ops
    arrays).  items: [(ops, jstart, c)] in cover order — identical
    votes and identical ins-dict insertion order to calling _vote_ops
    per cover (op value 3 separates covers: consumes nothing, is not
    an insertion, so runs cannot cross covers)."""
    if not items:
        return
    # items: (ops, jstart, c[, template-offset of this cover's votes])
    items = [(it[0], it[1], it[2], it[3] if len(it) > 3 else 0)
             for it in items]
    sep = np.array([3], np.uint8)
    cat = np.concatenate(
        [x for ops, _, _, _ in items for x in (ops, sep)])
    lens = np.array([len(ops) + 1 for ops, _, _, _ in items])
    starts = np.cumsum(lens) - lens
    cov_id = np.repeat(np.arange(len(items)), lens)
    consume_a = (cat == 0) | (cat == 1)
    consume_b = (cat == 0) | (cat == 2)
    cum_a = np.cumsum(consume_a) - consume_a
    cum_b = np.cumsum(consume_b) - consume_b
    c_lens = np.array([len(c) for _, _, c, _ in items])
    c_offs = np.cumsum(c_lens) - c_lens
    j0s = np.array([j0 for _, j0, _, _ in items])
    ioffs = np.array([io for _, _, _, io in items])
    i_arr = cum_a - cum_a[starts][cov_id] + ioffs[cov_id]
    j_arr = cum_b - cum_b[starts][cov_id] + (j0s + c_offs)[cov_id]
    c_cat = np.concatenate([c for _, _, c, _ in items])
    m0 = cat == 0
    if m0.any():
        np.add.at(votes, (i_arr[m0], c_cat[j_arr[m0]]), 1)
    d1 = cat == 1
    if d1.any():
        np.add.at(votes[:, 4], i_arr[d1], 1)
    ins = cat == 2
    if ins.any():
        prev = np.concatenate([[False], ins[:-1]])
        nxt = np.concatenate([ins[1:], [False]])
        for s_, e_ in zip(np.nonzero(ins & ~prev)[0],
                          np.nonzero(ins & ~nxt)[0]):
            key = c_cat[j_arr[s_]:j_arr[e_] + 1].tobytes()
            iv = ins_votes[int(i_arr[s_])]
            iv[key] = iv.get(key, 0) + 1


def _consensus_calls(template: np.ndarray, votes: np.ndarray,
                     ins_votes: list[dict], n_cov: int, min_cov: int,
                     template_prior: bool = False) -> np.ndarray:
    if n_cov < min_cov:
        return template.copy()
    # NOTE: the template does NOT vote.  In contig polishing the
    # window's source read is always among the covers (it was laid
    # out), so a template vote would double-count its errors; votes
    # are a clean majority over the covering reads.
    m = len(template)
    # insertion calls use a PLURALITY threshold (0.35x coverage, >= 2):
    # a template deletion is real, but the covers' own errors split its
    # insertion votes across adjacent columns and key variants, so a
    # strict majority misses roughly half of true deletions (measured:
    # 0.981 -> 0.986 two-round identity on 13%-error 12x simulations);
    # chance agreement of 2+ covers on (column, string) is ~1e-3
    need = max(2.0, 0.35 * n_cov)
    # vectorized base calls (the per-position loop dominated polish):
    # tot == 0 keeps the template char; call 4 (deletion) emits
    # nothing; otherwise the winning base — but only a STRICT MAJORITY
    # of covers may override the template.  Plurality-without-majority
    # at thin-coverage columns is a coin flip biased to base 0, and in
    # later rounds it REGRESSES settled consensus (the template then
    # carries the aggregated evidence of every earlier round).  The
    # template itself still does not vote (its source read is among
    # the covers).
    tot = votes.sum(axis=1)
    if template_prior:
        # rounds >= 2: the template carries every earlier round's
        # aggregated evidence — it votes once and wins ties, so
        # plurality-without-majority noise at thin columns cannot
        # regress settled consensus.  Round 1's template is a raw
        # read and gets no prior.
        tcol = np.minimum(template, 3)
        v2 = votes.copy()
        v2[np.arange(m), tcol] += 1
        calls = np.argmax(v2, axis=1)
        tmax = v2[np.arange(m), tcol] == np.max(v2, axis=1)
        calls = np.where(tmax, tcol, calls)
    else:
        calls = np.argmax(votes, axis=1)
    keep = (tot == 0) | (calls != 4)
    base = np.where(tot == 0, template,
                    np.minimum(calls, 3)).astype(np.uint8)
    emit = base[keep]
    cum_keep = np.concatenate([[0], np.cumsum(keep)])
    parts: list[np.ndarray] = []
    prev = 0
    for i in range(m + 1):
        ins = ins_votes[i]
        if not ins:
            continue
        key, cnt = max(ins.items(), key=lambda kv: kv[1])
        if cnt < need:
            continue
        b = int(cum_keep[i])
        parts.append(emit[prev:b])
        parts.append(np.frombuffer(key, np.uint8)
                     if isinstance(key, bytes)
                     else np.array(key, np.uint8))
        prev = b
    parts.append(emit[prev:])
    return np.concatenate(parts) if len(parts) > 1 else emit.copy()


def _msa_window_calls(template: np.ndarray, items: list,
                      prior: int = 0) -> np.ndarray:
    """Expanded-column MSA consensus of one window — the msa/-grade
    upgrade of _consensus_calls (MARVEL msa/): covers' insertions become
    REAL columns
    that every spanning cover votes on (gap or base), so indel
    evidence accumulates per position instead of splitting across
    byte-exact insertion variants; deletions are explicit gap votes.

    items: [(ops, j0, c, ioff)] exactly as _vote_ops_multi takes.
    prior > 0: the template votes `prior` at its own columns (base)
    and nothing at insertion columns; ties break toward bases over
    gap (argmax order), matching the harness that validated this on
    the do.py 4-5x trough.  Fully vectorized (np.add.at) — the
    per-op Python walk was 50x slower at window scale."""
    m = len(template)
    live = [(o, j, c, io) for o, j, c, io in
            ((it[0], it[1], it[2], it[3] if len(it) > 3 else 0)
             for it in items) if len(o)]
    if not live:
        return template.copy()
    sep = np.array([3], np.uint8)
    cat = np.concatenate([x for ops, _, _, _ in live
                          for x in (ops, sep)])
    lens = np.array([len(ops) + 1 for ops, _, _, _ in live])
    starts = np.cumsum(lens) - lens
    ends = starts + lens - 1                   # separator positions
    cov_id = np.repeat(np.arange(len(live)), lens)
    consume_a = (cat == 0) | (cat == 1)
    consume_b = (cat == 0) | (cat == 2)
    cum_a = np.cumsum(consume_a) - consume_a
    cum_b = np.cumsum(consume_b) - consume_b
    c_lens = np.array([len(c) for _, _, c, _ in live])
    c_offs = np.cumsum(c_lens) - c_lens
    j0s = np.array([j0 for _, j0, _, _ in live])
    ioffs = np.array([io for _, _, _, io in live])
    i_arr = cum_a - cum_a[starts][cov_id] + ioffs[cov_id]
    j_arr = cum_b - cum_b[starts][cov_id] + (j0s + c_offs)[cov_id]
    c_cat = np.concatenate([c for _, _, c, _ in live])
    pos = np.arange(len(cat))
    ins = cat == 2
    run_start = ins & ~np.concatenate([[False], ins[:-1]])
    last_start = np.maximum.accumulate(np.where(run_start, pos, -1))
    q_arr = np.where(ins, pos - last_start, 0)
    ins_i = np.clip(i_arr[ins], 0, m)
    ins_q = q_arr[ins]
    ins_max = np.zeros(m + 1, np.int64)
    if ins_i.size:
        np.maximum.at(ins_max, ins_i, ins_q + 1)
    col_of_t = np.cumsum(ins_max + 1) - 1      # column of template pos
    ncols = int(col_of_t[m])
    votes = np.zeros((ncols + 1, 5), np.int32)
    # per-cover span gap-fill: a cover votes gap everywhere it aligns
    # THROUGH, including other covers' insertion columns
    t1s = ioffs + (cum_a[ends] - cum_a[starts])
    c0s = col_of_t[np.clip(ioffs, 0, m)]
    c1s = col_of_t[np.clip(t1s, 0, m)]
    gfill = np.zeros(ncols + 2, np.int64)
    np.add.at(gfill, np.minimum(c0s, ncols), 1)
    np.add.at(gfill, np.minimum(c1s, ncols), -1)
    votes[:ncols, 4] = np.cumsum(gfill)[:ncols]
    # op votes replace the gap default at their columns (only inside
    # the op's own cover span — leading/trailing insertions outside
    # it must not drive the shared gap count negative)
    c0_op = c0s[cov_id]
    c1_op = c1s[cov_id]
    m0 = cat == 0
    if m0.any():
        cm = col_of_t[np.clip(i_arr[m0], 0, m)]
        base = c_cat[np.clip(j_arr[m0], 0, len(c_cat) - 1)]
        np.add.at(votes, (cm, base), 1)
        inside = (cm >= c0_op[m0]) & (cm < c1_op[m0])
        np.add.at(votes[:, 4], cm[inside], -1)
    if ins_i.size:
        ci = col_of_t[ins_i] - ins_max[ins_i] + ins_q
        ci = np.clip(ci, 0, ncols)
        basei = c_cat[np.clip(j_arr[ins], 0, len(c_cat) - 1)]
        np.add.at(votes, (ci, basei), 1)
        inside = (ci >= c0_op[ins]) & (ci < c1_op[ins])
        np.add.at(votes[:, 4], ci[inside], -1)
    votes = np.maximum(votes[:ncols], 0)
    tcols = col_of_t[:m]
    pri = np.zeros((ncols, 5), np.int32)
    if prior:
        pri[:, 4] = prior
        pri[tcols, 4] = 0
        pri[tcols, np.minimum(template, 3)] = prior
    tot = votes.sum(axis=1)
    calls = np.argmax(votes + pri, axis=1)
    tdef = np.full(ncols, 4, np.int64)
    tdef[tcols] = np.minimum(template, 3)
    calls = np.where(tot == 0, tdef, calls)
    out = calls[calls != 4].astype(np.uint8)
    return out


def recruit_layout(contig: np.ndarray, nreads: int, seq_of,
                   k: int = 16, min_hits: int = 15, bin_: int = 64,
                   circular: bool = False
                   ) -> list[tuple[int, int, int]]:
    """recruit_layout_multi for one contig: every read placed on the
    draft by exact-k-mer modal diagonal voting, no .las needed."""
    return recruit_layout_multi([contig], nreads, seq_of, k=k,
                                min_hits=min_hits, bin_=bin_,
                                circulars=[circular])[0]


def recruit_layout_multi(contigs: list[np.ndarray], nreads: int,
                         seq_of, k: int = 16, min_hits: int = 15,
                         bin_: int = 64,
                         circulars: list[bool] | None = None
                         ) -> list[list[tuple[int, int, int]]]:
    """Place every read on the polished drafts by exact-k-mer modal
    diagonal voting, no .las needed (the racon-style remap): at ~1%
    draft error a 13%-error read still lands a clean 16-mer every ~9 bp,
    so the modal diagonal is unambiguous.  Deterministic: first-
    occurrence k-mer index, stable read order, median offset.

    All contigs at once: each read is scanned once (one k-mer build and
    one searchsorted per orientation against a combined index) and
    assigned to the single contig where it lands the most hits, so a
    read sharing a repeat across contigs votes on its best placement
    only.  circulars: offsets of a circular contig live on the mod-L
    ring and near-seam placements go negative (a seam-spanning read
    covers contiguously); on a linear contig they are plain integers.
    Returns one layout per contig."""
    if circulars is None:
        circulars = [False] * len(contigs)
    nc = len(contigs)
    layouts: list[list[tuple[int, int, int]]] = [[] for _ in range(nc)]
    # combined coordinate space: contig c occupies
    # [cstart[c], cstart[c] + L_c)
    cstart = np.zeros(nc + 1, np.int64)
    for c, ct in enumerate(contigs):
        cstart[c + 1] = cstart[c] + len(ct)
    keys_parts, pos_parts = [], []
    for c, ct in enumerate(contigs):
        L = len(ct)
        if L < k + bin_:
            continue
        ck = _kmer_ints(ct, k)
        keys_parts.append(ck)
        pos_parts.append(np.arange(len(ck), dtype=np.int64)
                         + cstart[c])
    if not keys_parts:
        return layouts
    allk = np.concatenate(keys_parts)
    allp = np.concatenate(pos_parts)
    order = np.lexsort((allp, allk))       # ties -> smallest position
    ck_sorted = allk[order]
    pos_sorted = allp[order]
    # first GLOBAL position of each distinct k-mer (deterministic:
    # smallest combined coordinate — for one contig, exactly the old
    # first-occurrence rule)
    uniq_mask = np.concatenate([[True], ck_sorted[1:] != ck_sorted[:-1]])
    keys = ck_sorted[uniq_mask]
    first_pos = pos_sorted[uniq_mask]
    for r in range(nreads):
        best = None
        for d in (0, 1):
            s = seq_of(r, d)
            if len(s) < k + bin_:
                continue
            sk = _kmer_ints(np.asarray(s, np.uint8), k)
            loc = np.searchsorted(keys, sk)
            loc_c = np.minimum(loc, len(keys) - 1)
            hit = keys[loc_c] == sk
            if int(hit.sum()) < min_hits:
                continue
            gp = first_pos[loc_c[hit]]
            rp = np.nonzero(hit)[0]
            # candidate contig: the one holding the most hits
            # (deterministic argmax -> lowest id on ties)
            cid = np.searchsorted(cstart, gp, side="right") - 1
            c = int(np.bincount(cid, minlength=nc).argmax())
            inc = cid == c
            L = len(contigs[c])
            offs = (gp[inc] - cstart[c]) - rp[inc]
            if circulars[c]:
                offs = offs % L
            # linear: offsets can be slightly negative (read overhangs
            # the left end); bias the histogram, not the offsets
            bias = 0 if circulars[c] else len(s)
            hist = np.bincount((offs + bias) // bin_,
                               minlength=(L + bias) // bin_ + 2)
            b = int(hist.argmax())
            cnt = int(hist[max(b - 1, 0):b + 2].sum())
            if cnt < min_hits:
                continue
            sel = offs[np.abs((offs + bias) // bin_ - b) <= 1]
            start = int(np.median(sel))
            if best is None or cnt > best[0]:
                best = (cnt, c, d, start)
        if best is not None:
            cnt, c, d, start = best
            if circulars[c] and start > len(contigs[c]) // 2:
                start -= len(contigs[c])   # near-seam: negative
            layouts[c].append((r, d, start))
    for lay in layouts:
        lay.sort(key=lambda x: x[2])
    return layouts


def _kmer_ints(codes: np.ndarray, k: int) -> np.ndarray:
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    out = np.zeros(n, np.int64)
    c64 = codes.astype(np.int64)
    for j in range(k):
        out = out * 4 + c64[j:j + n]
    return out


def finish_polish_raw(contig: np.ndarray, nreads: int, seq_of,
                      circular: bool = False, window: int = 500,
                      margin: int = 80, band: int = 96,
                      min_cov: int = 2, rounds: int = 4, *,
                      device) -> np.ndarray:
    """finish_polish_raw_multi for one contig: recruit the original reads
    onto the polished draft (recruit_layout) and run the MSA-called vote
    rounds, their alignments on `device`."""
    cur = contig
    if not len(cur) or rounds <= 0:
        return cur
    lay = recruit_layout(cur, nreads, seq_of, circular=circular)
    return _finish_rounds(cur, lay, seq_of, circular, window, margin,
                          band, min_cov, rounds, device)


def finish_polish_raw_multi(contigs: list[np.ndarray],
                            circulars: list[bool], nreads: int,
                            seq_of, window: int = 500,
                            margin: int = 80, band: int = 96,
                            min_cov: int = 2, rounds: int = 4, *,
                            device) -> list[np.ndarray]:
    """Raw-read finishing polish over a whole assembly: recruit the
    ORIGINAL (pre-patch) reads onto the polished drafts and run
    MSA-called vote rounds.  The .las polish layout is built from
    patched and trimmed reads, which the scrub phases truncate exactly
    where coverage is thin; recruiting the raw reads restores that
    evidence.  One global recruitment pass assigns each read to its best
    contig (recruit_layout_multi), then the per-contig vote rounds run
    on disjoint read sets; rounds 3+ restore the template prior so
    settled columns cannot regress."""
    if rounds <= 0 or not contigs:
        return list(contigs)
    lays = recruit_layout_multi(contigs, nreads, seq_of,
                                circulars=circulars)
    return [_finish_rounds(c, lay, seq_of, circ, window, margin,
                           band, min_cov, rounds, device)
            for c, circ, lay in zip(contigs, circulars, lays)]


def _finish_rounds(cur, lay, seq_of, circular, window, margin, band,
                   min_cov, rounds, device):
    if not lay:
        return cur
    wins = [window, max(window - 80, 120), max(window - 160, 120)]
    poa_thin = int(os.environ.get("DAMAR_POA_THIN", "0"))
    msa_iter = int(os.environ.get("DAMAR_MSA_ITER", "0"))

    def caller(tmpl, items, n_cov, template_prior):
        if poa_thin and 2 <= len(items) <= poa_thin \
                and not template_prior:
            return poa_consensus(tmpl, [it[2] for it in items])
        out = _msa_window_calls(tmpl, items,
                                prior=1 if template_prior else 0)
        if msa_iter and 2 <= len(items) <= msa_iter \
                and not template_prior and len(out):
            # realign covers to the first call and re-vote: breaks the
            # original template's frame bias for indel columns (the
            # window's covers in one launch)
            cs = [it[2] for it in items if len(it[2])]
            items2 = [(ops, j0, c, 0) for (ops, j0), c in zip(
                align_pairs([(out, c, 96) for c in cs], device=device), cs)]
            out = _msa_window_calls(out, items2, prior=0)
        return out

    for it in range(rounds):
        w_ = wins[it % len(wins)]
        lay2 = _wrap_layout(lay, len(cur)) if circular else lay
        cur, cmap = polish_contig(cur, lay2, seq_of, window=w_,
                                  margin=margin, band=band,
                                  min_cov=min_cov, return_map=True,
                                  reject=0.45,
                                  template_prior=it >= 2,
                                  caller=caller, device=device)
        lay = remap_layout(lay, cmap, w_)
        if circular:
            n0 = len(cur)
            cur = _close_circular(cur)
            if len(cur) != n0:
                L2 = len(cur)
                lay = [(rd, d, s if s < L2 else s - L2)
                       for rd, d, s in lay]
            if it < rounds - 1:
                sh = max(1, len(cur) // 3)
                cur = np.roll(cur, sh)
                lay = [(rd, d, s + sh) for rd, d, s in lay]
    return cur


def consensus_window(template: np.ndarray, covers: list[np.ndarray],
                     band: int = 64, min_cov: int = 2, *, device
                     ) -> np.ndarray:
    """Majority-vote consensus of sequences aligned to one template
    window (the covers through one K4 launch)."""
    votes, ins_votes = _new_votes(len(template))
    live = [c for c in covers if len(c)]
    if live:
        aligned = align_pairs([(template, c, band) for c in live],
                              device=device)
        _vote_ops_multi(votes, ins_votes,
                        [(ops, j0, c) for (ops, j0), c
                         in zip(aligned, live)])
    return _consensus_calls(template, votes, ins_votes, len(live),
                            min_cov)


def full_layout(tour_lay: list[tuple[int, int, int]], las,
                rlen_of: dict[int, int]) -> list[tuple[int, int, int]]:
    """Extend a tour layout with every read overlapping a tour read
    (contained reads carry most of the coverage): each extra read is
    placed at the contig position implied by its best (longest)
    overlap record with a tour read.  Positions are approximate to
    within alignment indel drift — polish margins absorb that.  An
    object-backed file is read through its columns (one build pass)."""
    pos = {(r, d): p for r, d, p in tour_lay}
    placed = {r for r, _, _ in tour_lay}
    cols = columns_of(las)
    rows = ()
    if cols.n:
        # columnar pre-filter: only records pairing an unplaced bread
        # with a placed aread survive to the Python placement loop
        h = cols.headers
        ar = h[:, H_AREAD]
        br = h[:, H_BREAD]
        hi = int(max(ar.max(), br.max(),
                     max(placed) if placed else 0)) + 1
        pm = np.zeros(hi, bool)
        pm[list(placed)] = True
        idx = np.flatnonzero(pm[ar] & ~pm[br])
        rows = ((int(ar[i]), int(br[i]),
                 int(h[i, H_ABPOS]), int(h[i, H_AEPOS]),
                 int(h[i, H_BBPOS]), int(h[i, H_BEPOS]),
                 1 if h[i, H_FLAGS] & OVL_COMP else 0) for i in idx)
    best: dict[int, tuple[int, int, int]] = {}
    for aread, bread, abpos, aepos, bbpos, bepos, comp in rows:
        alen = rlen_of[aread]
        blen = rlen_of[bread]
        for d_t in (0, 1):
            p_t = pos.get((aread, d_t))
            if p_t is None:
                continue
            if d_t == 0:
                start = p_t + abpos - bbpos
                d_b = comp
            else:
                # A reversed in contig: A-coord x -> p_t + alen - x;
                # B' runs antiparallel to its record orientation
                start = p_t + (alen - aepos) - (blen - bepos)
                d_b = 1 - comp
            olen = aepos - abpos
            cur = best.get(bread)
            if cur is None or olen > cur[2]:
                best[bread] = (d_b, start, olen)
    out = list(tour_lay)
    for r, (d_b, start, _) in best.items():
        out.append((r, d_b, start))
    return out


def polish_contig(contig: np.ndarray, layout: list[tuple[int, int, int]],
                  seq_of, window: int = 500, margin: int = 80,
                  band: int = 96, min_cov: int = 2,
                  return_map: bool = False, reject: float = 0.45,
                  template_prior: bool = False,
                  stats: dict | None = None, caller=None, *, device):
    """Polish a toured contig with its own reads.

    layout: [(read, dir, contig_start)] from touring.tour_layout —
    read r (oriented) aligns to contig[start : start + len(read)].

    Reads are walked window by window with a CHAINED cursor: each
    window alignment's endpoint anchors where the next window starts
    in the read.  Linear placement (start + offset) drifts by the
    read's accumulated indel skew — ~0.1x read length at raw PacBio
    error, far beyond any fixed margin — which silently turns the
    consensus covers into misaligned noise; chaining keeps every
    window anchored to within one window's own drift.

    return_map: also return new_start [nwin+1], the polished-contig
    coordinate of each input window boundary — callers remap layout
    starts with it to iterate polishing on the updated draft.
    caller: optional window-call override caller(template, items,
    n_cov, template_prior) -> consensus (e.g. _msa_window_calls);
    per-window cover items are retained and handed to it in place of
    the _vote_ops_multi/_consensus_calls pair.
    device: where the window alignments run (K4 on a CUDA device).
    """
    n = len(contig)
    nwin = -(-n // window) if n else 0
    votes: list = [None] * nwin
    ivs: list = [None] * nwin
    wit: list = [None] * nwin
    ncov = np.zeros(nwin, np.int64)
    # WINDOW-MAJOR walk (same chained-cursor semantics as a read-major
    # loop, same per-window cover order = layout order): every cover of
    # a window, with its own template slice and band, goes through one
    # K4 launch.
    enter: list[list] = [[] for _ in range(max(nwin, 1))]
    # MIN_PART: smallest partial-window template span worth a vote —
    # below it the banded alignment anchors poorly and the cover
    # mostly votes its own errors
    MIN_PART = 120
    for li, (read, d, start) in enumerate(layout):
        # FLOOR, not ceil: a read starting mid-window enters at that
        # window and votes the PARTIAL template it covers (offset
        # votes).  At tour closures many reads start within a window
        # or two — the old ceil-entry discarded 1-2 of the 2-4 covers
        # available exactly where coverage is thinnest.
        w_first = max(0, start // window)
        if w_first >= nwin:      # placement past the contig (e.g. a
            continue             # +length wrap copy): no window, and
                                 # no seq_of() materialization either
        # state: [s(lazy), cursor, first, read, dir, layout idx]
        # cursor = read position corresponding to contig w0 (negative
        # while the read starts inside the window)
        enter[w_first].append([None, w_first * window - start,
                               True, read, d, li])
    active: list[list] = []
    for w in range(nwin):
        for st in enter[w]:
            st[0] = seq_of(st[3], st[4])
            active.append(st)
        enter[w] = []            # release: a dropped read's sequence
                                 # must not be pinned for the whole
                                 # contig (50 Mbp x 30x would pin GBs)
        # per-window cover order must stay LAYOUT order (the original
        # read-major walk's order): insertion-vote ties break on dict
        # insertion order, so processing order is output-visible
        active.sort(key=lambda st: st[5])
        w0 = w * window
        w1 = min(w0 + window, n)
        wlen = w1 - w0
        tmpl = contig[w0:w1]
        live: list[tuple] = []     # (state, lo, hi, mg, ioff, tl)
        keep: list[list] = []      # walk on without voting this window
        for st in active:
            s, cursor, first = st[0], st[1], st[2]
            # the first window of a read must absorb the FULL
            # placement error of its layout start — up to the read's
            # indel skew for wrapped/approximately-placed reads;
            # later windows only intra-window drift
            mg = margin + (min(600, max(200, len(s) // 8))
                           if first else 0)
            ioff = max(0, -cursor)        # partial entry offset
            tl = wlen - ioff              # template span to cover
            if tl < MIN_PART:             # sliver entry: advance the
                st[1] = cursor + wlen     # linear cursor, vote next
                keep.append(st)           # window with full margin
                continue
            lo = max(0, cursor + ioff - mg)
            hi = min(len(s), cursor + wlen + mg)
            # full cover exactly when the pre-partial walk kept the
            # read live (slice holds a window's worth of chars, with
            # the margin slack counted — original condition)
            partial_exit = hi - lo < tl
            if partial_exit:
                # read ends inside the window: vote the confident
                # prefix (its estimated span minus the drift margin)
                rem = len(s) - (cursor + ioff)
                tl = min(tl, rem - mg)
                if tl < MIN_PART:
                    continue              # exhausted (drops below)
                hi = len(s)
            live.append((st, lo, hi, mg, ioff, tl, partial_exit))
        # align: the window's covers in one launch; non-first full-window
        # covers share band max(band, margin+16) and the whole template,
        # first and partial covers have their own margins and template
        # slices (the alignments do not depend on each other)
        results = align_pairs(
            [(tmpl[ioff:ioff + tl], st[0][lo:hi], max(band, mg + 16))
             for st, lo, hi, mg, ioff, tl, _px in live], device=device)
        if live and votes[w] is None:
            votes[w], ivs[w] = _new_votes(w1 - w0)
        items = []
        nxt_active: list[list] = keep
        for k, (st, lo, hi, mg, ioff, tl, partial_exit) in \
                enumerate(live):
            s, cursor = st[0], st[1]
            c = s[lo:hi]
            ops, j0 = results[k]
            tsub = tmpl[ioff:ioff + tl]
            # cover outlier rejection: a misplaced/wrong-strand read
            # (full_layout places by ONE overlap record) aligns at
            # near-random cost and poisons every vote it touches —
            # true covers cost <= ~2x the pair error rate, random
            # sequence ~0.5x window
            if len(ops):
                ca = (ops == 0) | (ops == 1)
                cb = (ops == 0) | (ops == 2)
                i_ix = np.cumsum(ca) - ca
                j_ix = j0 + np.cumsum(cb) - cb
                m0 = ops == 0
                nmatch = int((tsub[np.minimum(i_ix[m0], len(tsub) - 1)]
                              == c[np.minimum(j_ix[m0],
                                              len(c) - 1)]).sum())
                if len(ops) - nmatch > reject * len(tsub):
                    ops = ops[:0]            # walk on, vote nothing
                    if stats is not None:
                        stats.setdefault("rej", []).append(
                            (w, st[3], int(nmatch)))
                elif stats is not None:
                    stats.setdefault("cov", []).append(
                        (w, st[3], ioff, tl, len(ops) - nmatch))
            items.append((ops, j0, c, ioff))
            ncov[w] += 1
            if partial_exit:
                continue          # tail voted; read is exhausted
            nb = int((ops != 1).sum())        # cover chars consumed
            nxt = lo + (j0 + nb if len(ops)
                        else cursor + wlen - lo)
            ref = cursor + wlen
            if abs(nxt - ref) > mg:      # distrust a wild alignment
                nxt = ref
            st[1] = nxt
            st[2] = False
            nxt_active.append(st)
        if items:
            if caller is not None:
                wit[w] = items
            else:
                _vote_ops_multi(votes[w], ivs[w], items)
        # restore layout order after the keep/live split
        nxt_active.sort(key=lambda st: st[5])
        active = nxt_active
    parts: list[np.ndarray] = []
    for w in range(nwin):
        w0 = w * window
        w1 = min(w0 + window, n)
        tmpl = contig[w0:w1]
        if votes[w] is None:
            parts.append(tmpl.copy())
        elif caller is not None:
            parts.append(tmpl.copy() if int(ncov[w]) < min_cov
                         else caller(tmpl, wit[w] or [], int(ncov[w]),
                                     template_prior))
        else:
            parts.append(_consensus_calls(tmpl, votes[w], ivs[w],
                                          int(ncov[w]), min_cov,
                                          template_prior=template_prior))
    out = np.concatenate(parts) if parts else contig
    if stats is not None:
        stats["ncov"] = ncov
    if not return_map:
        return out
    new_start = np.zeros(nwin + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=new_start[1:])
    return out, new_start


def remap_layout(layout: list[tuple[int, int, int]],
                 new_start: np.ndarray, window: int
                 ) -> list[tuple[int, int, int]]:
    """Translate layout starts through a polish coordinate map (the
    window-boundary positions polish_contig returned) so a second
    polish round anchors against the UPDATED draft coordinates."""
    nwin = len(new_start) - 1
    out = []
    for read, d, start in layout:
        w = min(max(start // window, 0), max(nwin - 1, 0))
        out.append((read, d, int(new_start[w] + (start - w * window))))
    return out


def _wrap_layout(layout: list[tuple[int, int, int]], clen: int
                 ) -> list[tuple[int, int, int]]:
    """Add +-contig-length copies of each placement: windows near both
    ends of a CIRCULAR contig then see every read that spans the seam
    (a copy whose span misses the contig entirely costs nothing — its
    window walk breaks on entry)."""
    return (layout
            + [(r, d, s - clen) for r, d, s in layout]
            + [(r, d, s + clen) for r, d, s in layout])


def _close_circular(seq: np.ndarray, max_dup: int = 800,
                    k: int = 16, min_votes: int = 3) -> np.ndarray:
    """Trim the residual closure DUPLICATION of a circular contig:
    touring's closure cut is exact only to the closing record's
    alignment drift, and a leftover tandem copy at the seam can never
    be voted out (covers split their deletion calls between the two
    copies).  Detect the duplication by matching the tail's k-mers
    against the head (run after a polish round, when the draft is at
    ~1% error and exact k-mers land), take the modal offset, trim."""
    L = len(seq)
    W = min(max_dup + 200, L // 4)
    if W < k + 8:
        return seq
    head = {bytes(seq[j:j + k]): j for j in range(W - k, -1, -1)}
    votes: dict[int, int] = {}
    for i in range(L - W, L - k):
        j = head.get(bytes(seq[i:i + k]))
        if j is not None:
            d = L - i + j
            if 1 <= d <= max_dup:
                votes[d] = votes.get(d, 0) + 1
    if not votes:
        return seq
    d, cnt = max(votes.items(), key=lambda kv: kv[1])
    # only the duplicated stretch itself can match: expect ~d - k
    # k-mer votes for a d-base duplication (chance matches are ~0)
    if d <= k or cnt < max(min_votes, (d - k) // 3):
        return seq
    return seq[:L - d]


def _collapse_junction_dups(seq: np.ndarray, junctions: list[int],
                            k: int = 16, max_dup: int = 400,
                            win: int = 600) -> np.ndarray:
    """Collapse small tandem DUPLICATIONS at tour junctions: a
    junction cut that is off by d bases duplicates d bases of sequence
    there, and consensus can never vote it out — covers split their
    deletion calls between the two copies.  Detection mirrors
    _close_circular but is anchored to the KNOWN junction positions
    (a genuine genomic tandem repeat away from any junction is never
    touched; one under a junction is indistinguishable from a cut
    error by any consumer of the same evidence).  Run on a polished
    draft (~1% error) where exact k-mers land."""
    cuts: list[tuple[int, int]] = []
    L = len(seq)
    for p in sorted(set(junctions)):
        lo = max(0, p - win)
        hi = min(L, p + win)
        if hi - lo < 2 * k + 8:
            continue
        head: dict[bytes, int] = {}
        for j in range(min(p, hi - k) - k, lo - 1, -1):
            if j >= 0:
                head[bytes(seq[j:j + k])] = j
        votes: dict[int, int] = {}
        first_i: dict[int, int] = {}
        for i in range(max(p - k, lo), hi - k):
            j = head.get(bytes(seq[i:i + k]))
            if j is not None:
                d = i - j
                if k < d <= max_dup:
                    votes[d] = votes.get(d, 0) + 1
                    first_i.setdefault(d, i)
        if not votes:
            continue
        d, cnt = max(votes.items(), key=lambda kv: kv[1])
        if cnt < max(3, (d - k) // 3):
            continue
        x0 = first_i[d]
        # the duplicated copies must straddle the junction
        if not (x0 - d - k <= p <= x0 + d + k):
            continue
        cuts.append((x0, d))
    if not cuts:
        return seq
    cuts.sort()
    parts = []
    pos = 0
    for x0, d in cuts:
        if x0 < pos:
            continue
        parts.append(seq[pos:x0])
        pos = x0 + d
    parts.append(seq[pos:])
    return np.concatenate(parts)


def polish_rounds(contig: np.ndarray, layout: list[tuple[int, int, int]],
                  seq_of, circular: bool = False, window: int = 500,
                  margin: int = 80, band: int = 96, min_cov: int = 2,
                  rounds: int = 2,
                  junctions: list[int] | None = None,
                  seq_of_raw=None, *, device) -> np.ndarray:
    """Iterated consensus with staggered window grids (each round
    re-anchors against the previous draft; the shifted boundaries
    re-call the columns earlier rounds split across windows).
    Circular contigs polish with seam-wrapped layouts.

    seq_of_raw: when given, the FINAL round votes with these (raw,
    uncorrected) covers instead of seq_of.  Corrected covers at a
    low-coverage locus are CORRELATED — each was consensus-voted from
    the same few reads, so they agree on their mistakes and the contig
    consensus can never outvote them (measured: a 4-5x sampling trough
    pinned ~2 kb at ~92-95%% identity through every round, covers
    costing 1-2%% against a template 5%% wrong vs truth).  Raw reads'
    errors are independent; with the template prior holding settled
    columns, a raw-majority final pass breaks the shared errors."""
    cur = contig
    lay_base = layout
    w = window
    for r in range(rounds):
        lay = _wrap_layout(lay_base, len(cur)) if circular else lay_base
        final_raw = seq_of_raw is not None and r == rounds - 1
        # later rounds anchor against a converged (~1% error) draft:
        # true covers cost ~the read error, so the outlier bar drops —
        # except the raw final pass, whose covers cost the raw error
        cur, cmap = polish_contig(cur, lay,
                                  seq_of_raw if final_raw else seq_of,
                                  window=w,
                                  margin=margin, band=band,
                                  min_cov=min_cov, return_map=True,
                                  reject=0.45 if (r == 0 or final_raw)
                                  else 0.35,
                                  template_prior=r > 0, device=device)
        lay_base = remap_layout(lay_base, cmap, w)
        if junctions:
            nwin_m = len(cmap) - 1
            junctions = [int(cmap[min(max(p // w, 0),
                                      max(nwin_m - 1, 0))]
                             + (p - (p // w) * w)) for p in junctions]
            n0 = len(cur)
            cur = _collapse_junction_dups(cur, junctions)
            if len(cur) != n0:
                junctions = [p for p in junctions if p < len(cur)]
        if circular:
            n0 = len(cur)
            cur = _close_circular(cur)
            if len(cur) != n0:
                # the trim shortened the tail: clamp any layout starts
                # past the new end into the wrap copies' range
                L2 = len(cur)
                lay_base = [(rd, d, s if s < L2 else s - L2)
                            for rd, d, s in lay_base]
        if circular and r < rounds - 1:
            if junctions:
                junctions = [(p + len(cur) // 2) % max(len(cur), 1)
                             for p in junctions]
            # rotate the draft 1/rounds of a turn: covers spanning the
            # seam enter their first window MID-READ, where the linear
            # cursor is off by the read's accumulated indel skew (far
            # beyond any margin) — they fail the outlier bar and the
            # seam region polishes coverage-starved.  Rotating a
            # DIFFERENT fraction each round keeps every round's seam
            # at a distinct region (len//2 with 3 rounds returns to
            # the start, leaving that region only one effective
            # round).  A rotation of a circular contig is the same
            # contig.
            sh = max(1, len(cur) // max(rounds, 2))
            cur = np.roll(cur, sh)
            lay_base = [(rd, d, s + sh) for rd, d, s in lay_base]
        # stagger the grid so column calls split at one round's window
        # boundary are re-voted whole in the next
        w = max(w - 80, window // 2, 120)
    return cur


def _correct_plan(template: np.ndarray, pile: list, seqs_of, rlen: int,
                  ts: int, window: int, band: int, coord_of=None,
                  rlen_of=None) -> tuple[list, list]:
    """The alignments that correct one read given its pile rows
    [(bread, comp, abpos, aepos, bbpos, cum_bspans)]: per window
    (w0, w1, [(cover, offset of its sub-template in the window)]), and
    the (sub-template, cover, band) pairs in that order.

    PARTIAL covers participate too (aligned against the sub-template
    they span, votes offset accordingly): thin piles, exactly the reads
    that need correction most, rarely have alignments spanning a whole
    window.

    coord_of(bread) -> (raw_bounds, corr_bounds) | None: when the
    covers come from an EARLIER correction pass, the pile's trace
    coordinates still index the RAW b read: the window-boundary map
    translates each slice into corrected coordinates (the alignment
    band absorbs the within-window interpolation error).

    A window's covers and sub-templates come from the pile and the
    template alone, never from another window's alignments (nor from
    another read's), so the pairs of many reads can go through one K4
    launch."""
    wins = []
    pairs = []
    for w0 in range(0, rlen, window):
        w1 = min(w0 + window, rlen)
        covers = []
        for bread, comp, abpos, aepos, bbpos, cum in pile:
            lo_a = max(abpos, w0)
            hi_a = min(aepos, w1)
            if hi_a - lo_a < min(w1 - w0, 200):
                continue
            s0 = abpos // ts
            seg_lo = lo_a // ts
            seg_hi = (hi_a + ts - 1) // ts
            lo = bbpos + int(cum[min(max(0, seg_lo - s0),
                                     len(cum) - 1)])
            hi = bbpos + int(cum[min(max(0, seg_hi - s0),
                                     len(cum) - 1)])
            b = seqs_of(bread, bool(comp))
            mp = coord_of(bread) if coord_of is not None else None
            if mp is not None:
                # oriented raw [lo,hi) -> forward raw -> forward
                # corrected -> oriented corrected, +slack for the
                # interpolation error (absorbed by the band)
                raw_b, cor_b = mp
                rl_raw = rlen_of[bread]
                flo, fhi = ((rl_raw - hi, rl_raw - lo) if comp
                            else (lo, hi))
                nlo = float(np.interp(flo, raw_b, cor_b))
                nhi = float(np.interp(fhi, raw_b, cor_b))
                if comp:
                    nlo, nhi = len(b) - nhi, len(b) - nlo
                lo = max(0, int(nlo) - 24)
                hi = min(len(b), int(nhi) + 24)
            c = b[lo:hi]
            if not len(c):
                continue
            # trace segments snap outward to ts boundaries: align
            # against the sub-template those segments span, offset
            # the votes to window coordinates
            sub_lo = max(seg_lo * ts, w0)
            sub_hi = min(seg_hi * ts, w1)
            sub = template[sub_lo:sub_hi]
            if not len(sub):
                continue
            covers.append((c, sub_lo - w0))
            pairs.append((sub, c, band))
        wins.append((w0, w1, covers))
    return wins, pairs


def _correct_vote(template: np.ndarray, wins: list, aligned, rlen: int,
                  window: int, min_cov: int, return_map: bool = False):
    """Consensus-correct one read from its plan (_correct_plan) and the
    plan's alignments, an iterator of (ops, jstart) in the plan's order:
    the votes run window by window in the reference's order.
    return_map: also return this read's window-boundary map, feeding
    the next pass."""
    parts = []
    for w0, w1, covers in wins:
        votes, ins_votes = _new_votes(w1 - w0)
        items = [(*next(aligned), c, ioff) for c, ioff in covers]
        if items:
            _vote_ops_multi(votes, ins_votes, items)
        parts.append(_consensus_calls(template[w0:w1], votes,
                                      ins_votes, len(items), min_cov))
    out = np.concatenate(parts) if parts else template
    if not return_map:
        return out
    nwin = len(parts)
    raw_b = np.minimum(np.arange(nwin + 1) * window, rlen)
    cor_b = np.zeros(nwin + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=cor_b[1:])
    return out, (raw_b.astype(np.float64), cor_b.astype(np.float64))


def _piles(las, want, discarded: bool) -> dict[int, list]:
    """The pile of each A read of `las` (all, or those in `want`): its
    records' (bread, comp, abpos, aepos, bbpos, cumulative B span at each
    trace point) in file order, with or without the discarded records.
    One pass over the columns (an object-backed file's: one build
    pass)."""
    cols = columns_of(las)
    piles: dict[int, list] = {}
    if not cols.n:
        return piles
    h = cols.headers
    rows_t = _decode_trace(cols.trace, las.small)
    seg_off = cols.offsets // (2 if las.small else 4)
    keep = np.ones(cols.n, bool) if discarded else \
        (h[:, H_FLAGS] & OVL_DISCARD) == 0
    if want is not None:
        keep &= np.isin(h[:, H_AREAD], np.fromiter(want, np.int64))
    idx = np.flatnonzero(keep)
    for i in idx[np.argsort(h[idx, H_AREAD], kind="stable")]:
        tr = rows_t[seg_off[i]:seg_off[i + 1]]
        cum = np.concatenate([[0], np.cumsum(tr[:, 1])])
        piles.setdefault(int(h[i, H_AREAD]), []).append(
            (int(h[i, H_BREAD]), bool(h[i, H_FLAGS] & OVL_COMP),
             int(h[i, H_ABPOS]), int(h[i, H_AEPOS]),
             int(h[i, H_BBPOS]), cum))
    return piles


def polish_read(aread: int, las, seqs_of, rlen: int, window: int = 500,
                band: int = 96, min_cov: int = 2, *, device) -> np.ndarray:
    """Correct one read from its pile (corrector equivalent): the
    covering B windows are located through trace points, then
    consensus-voted against the read as template.  The pile is every
    record of `aread` in las (discarded ones too, as in damar_tpu); its
    alignments go through one K4 launch on `device`."""
    template = seqs_of(aread, False)
    pile = _piles(las, {aread}, discarded=True).get(aread, [])
    wins, pairs = _correct_plan(template, pile, seqs_of, rlen, las.tspace,
                                window, band)
    return _correct_vote(template, wins,
                         iter(align_pairs(pairs, device=device)), rlen,
                         window, min_cov)


def correct_reads(las, seqs_of, rlen_of: dict[int, int],
                  reads: list[int] | None = None, window: int = 500,
                  band: int = 96, min_cov: int = 2, rounds: int = 1, *,
                  device) -> dict[int, np.ndarray]:
    """Batched read correction from piles (MARVEL corrector/ + msa/
    equivalent): every read is consensus-voted against its covering
    alignments, turning ~13%% CLR error into ~1%% before the contig
    polish.

    rounds > 1 iterates: pass n corrects each read against the PASS
    n-1 CORRECTED covers (template stays the raw read, so the pile's
    a-side trace coordinates stay valid; b-side slices translate
    through each cover's window-boundary map).

    Columnar pile construction (_piles): one pass over the las groups
    rows by aread (no per-record objects)."""
    ts = las.tspace
    piles = _piles(las, None if reads is None else set(reads),
                   discarded=False)
    targets = sorted(piles) if reads is None else \
        [r for r in reads if r in piles]
    out: dict[int, np.ndarray] = {}
    maps: dict[int, tuple] = {}
    for rnd in range(max(rounds, 1)):
        last = rnd == max(rounds, 1) - 1
        if rnd == 0:
            sof, cof = seqs_of, None
        else:
            prev_out, prev_maps = dict(out), dict(maps)

            def sof(i, comp, _po=prev_out):
                s = _po.get(i)
                if s is None:
                    return seqs_of(i, comp)
                return revcomp(s) if comp else s

            def cof(i, _pm=prev_maps):
                return _pm.get(i)
        # the reads of a round do not depend on each other: their
        # alignments go through K4 in groups of about CORRECT_PAIRS
        # pairs, then each read votes
        nxt_out: dict[int, np.ndarray] = {}
        nxt_maps: dict[int, tuple] = {}
        group: list = []

        def flush():
            aligned = iter(align_pairs(
                [p for *_, pairs in group for p in pairs], device=device))
            for a, tmpl, wins, _ in group:
                r = _correct_vote(tmpl, wins, aligned, rlen_of[a], window,
                                  min_cov, return_map=not last)
                if last:
                    nxt_out[a] = r
                else:
                    nxt_out[a], nxt_maps[a] = r
            group.clear()

        npairs = 0
        for a in targets:
            tmpl = seqs_of(a, False)
            wins, pairs = _correct_plan(tmpl, piles[a], sof, rlen_of[a], ts,
                                        window, band, coord_of=cof,
                                        rlen_of=rlen_of)
            group.append((a, tmpl, wins, pairs))
            npairs += len(pairs)
            if npairs >= CORRECT_PAIRS:
                flush()
                npairs = 0
        flush()
        out, maps = nxt_out, nxt_maps
    return out
