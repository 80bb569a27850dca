"""The control and the planted faults that `correct` must catch, each a
context manager that breaks the timed path underneath a run.  None of
them runs in the benchmark's own runs: benchmark/control.py reads them
on the card at a cell's own size, and benchmark/tests/ at a small size
on the CPU.

- control `weaker_settings`: the program seeding with 15-mers and a
  band threshold of 100 bases where the configuration states -k14 -h35
  (paths it has: OverlapConfig.kmer, hit_min), which breaks the stated
  sensitivity and cuts the random k-mer hits, and so seeding's time,
  about fourfold: the step that would tempt a later change, seeding
  being the largest device phase.
- `mirrors_off`: the program with its mirror pass switched off
  (emit_mirrors=False, a path it has), which breaks the stated guarantee
  that every alignment is reported from both of its reads, and halves
  the trace's work.
- `half_left_out`: half of every unit's records left out (those whose A
  read has an odd id, and their mirrors), the rest as computed.
- `answer_altered`: each record's first trace segment reports one
  difference fewer than it found (the record's diffs lowered to match),
  where the record is produced.
- `state_unchanged`: a unit that hands back no records, as a step that
  returns without doing its work.
- `over_extended`: every alignment run on past its end by up to
  OVER_BP bases on each read (as far as the read goes), the record and
  its mirror with traces over the longer box (B spans in proportion,
  diffs a quarter of each segment), as where a trace runs past the true
  overlap.
- `made_up`: one record in MADE_UP_EVERY gains a twin against another
  read of the B side that is long enough (B's interval moved to its
  start), with its mirror, their traces' diffs the longer side of each
  segment (never below the edit distance), as where an alignment is
  reported for the wrong read.
"""
from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(mod, name: str, make):
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _las(cols, tspace):
    from damar_tpu_torch.formats.las import LasFile
    return LasFile(tspace=tspace, columns=cols)


def _cols(las):
    from damar_tpu_torch.formats.las import columns_of
    return columns_of(las)


def _on_emit(edit):
    """Patch overlap_pair_emit so that edit(las_a, las_b, state) ->
    (las_a, las_b) rewrites what each pair hands back."""
    from damar_tpu_torch.pipeline import overlap

    def make(orig):
        def emit(state, stream=None):
            la, lb, st = orig(state, stream)
            la, lb = edit(la, lb, state)
            return la, lb, st
        return emit
    return _patched(overlap, "overlap_pair_emit", make)


def _keep(las, rows):
    return _las(_cols(las).permute(np.asarray(rows, np.int64)), las.tspace)


@contextlib.contextmanager
def mirrors_off():
    from damar_tpu_torch.pipeline import overlap

    def make(orig):
        def device(*a, **kw):
            kw["emit_mirrors"] = False
            return orig(*a, **kw)
        return device
    with _patched(overlap, "overlap_pair_device", make):
        yield


@contextlib.contextmanager
def weaker_settings():
    import dataclasses

    from damar_tpu_torch.pipeline import overlap

    def make(orig):
        def device(blk_a, blk_b, cfg, *a, **kw):
            return orig(blk_a, blk_b,
                        dataclasses.replace(cfg, **WEAKER),
                        *a, **kw)
        return device
    with _patched(overlap, "overlap_pair_device", make):
        yield


@contextlib.contextmanager
def half_left_out():
    def edit(la, lb, state):
        ha, hb = _cols(la).headers, _cols(lb).headers
        return (_keep(la, np.nonzero(ha[:, 7] % 2 == 0)[0]),
                _keep(lb, np.nonzero(hb[:, 8] % 2 == 0)[0]))
    with _on_emit(edit):
        yield


def _lower_first_segment(las):
    from damar_tpu_torch.formats.las import LasColumns
    c = _cols(las)
    h = c.headers.copy()
    trace = c.trace.copy()
    small = las.tspace <= 125
    width = 2 if small else 4
    for i in range(c.n):
        o = int(c.offsets[i])
        if c.offsets[i + 1] - o < width:
            continue
        if small:
            d = int(trace[o])
        else:
            d = int(trace[o:o + 2].view("<i2")[0])
        if d > 0:
            if small:
                trace[o] = d - 1
            else:
                trace[o:o + 2] = np.array([d - 1], "<i2").view(np.uint8)
            h[i, 1] -= 1
    return _las(LasColumns(h, trace, c.offsets.copy()), las.tspace)


@contextlib.contextmanager
def answer_altered():
    with _on_emit(lambda la, lb, state: (_lower_first_segment(la),
                                         _lower_first_segment(lb))):
        yield


@contextlib.contextmanager
def state_unchanged():
    with _on_emit(lambda la, lb, state: (_keep(la, []), _keep(lb, []))):
        yield


def _lengths(state) -> np.ndarray:
    """Read length by read id (the .las numbering) over both blocks."""
    blks = (state["blk_a"], state["blk_b"])
    out = np.zeros(max(int(b.ids.max(initial=0)) for b in blks) + 1,
                   np.int64)
    for b in blks:
        out[b.ids] = b.rlen
    return out


def _records(boxes: np.ndarray, tspace: int, rate: float):
    """(LasColumns, ok) of boxes [n, 7] (aread, bread, comp, abp, aep,
    bbp, bep) with made traces: one segment a point of A's tspace grid,
    B spans in proportion, diffs `rate` x each segment's longer side,
    rounded up.  ok[i] is false where a box's trace would not fit the
    one-byte encoding; those boxes are left out of the columns."""
    from damar_tpu_torch.formats.las import LasColumns
    if tspace > 125:
        raise ValueError("the made traces use the one-byte encoding")
    bx = np.asarray(boxes, np.int64).reshape(-1, 7)
    abp, aep, bbp, bep = bx[:, 3], bx[:, 4], bx[:, 5], bx[:, 6]
    nseg = (aep - 1) // tspace - abp // tspace + 1
    first = np.zeros(len(bx) + 1, np.int64)
    np.cumsum(nseg + 1, out=first[1:])
    rid = np.repeat(np.arange(len(bx)), nseg + 1)
    k = np.arange(int(first[-1])) - first[:-1][rid]
    a_pts = np.where(k == 0, abp[rid],
                     np.where(k == nseg[rid], aep[rid],
                              (abp[rid] // tspace + k) * tspace))
    b_pts = bbp[rid] + np.round(
        (a_pts - abp[rid]) * (bep - bbp)[rid]
        / np.maximum(aep - abp, 1)[rid]).astype(np.int64)
    b_pts = np.where(k == nseg[rid], bep[rid], b_pts)
    seg = np.nonzero(k > 0)[0]
    da, db = a_pts[seg] - a_pts[seg - 1], b_pts[seg] - b_pts[seg - 1]
    d = np.ceil(rate * np.maximum(da, db)).astype(np.int64)
    srid = rid[seg]
    fits = (d <= 255) & (db >= 0) & (db <= 255)
    ok = np.ones(len(bx), bool)
    ok[srid[~fits]] = False
    keep = ok[srid]
    dsum = np.zeros(len(bx), np.int64)
    np.add.at(dsum, srid, d)
    h = np.stack([2 * nseg, dsum, abp, bbp, aep, bep, bx[:, 2], bx[:, 0],
                  bx[:, 1], np.zeros(len(bx), np.int64)], 1)[ok]
    offs = np.zeros(int(ok.sum()) + 1, np.int64)
    np.cumsum(2 * nseg[ok], out=offs[1:])
    trace = np.stack([d[keep], db[keep]], 1).astype(np.uint8).ravel()
    return LasColumns(h.astype(np.int32), trace, offs), ok


def _mirrors(bx: np.ndarray, rlen: np.ndarray) -> np.ndarray:
    """Boxes of the same alignments seen from their B reads."""
    ar, br, comp = bx[:, 0], bx[:, 1], bx[:, 2]
    abp, aep, bbp, bep = bx[:, 3], bx[:, 4], bx[:, 5], bx[:, 6]
    la, lb = rlen[ar], rlen[br]
    c = comp == 1
    return np.stack([br, ar, comp, np.where(c, lb - bep, bbp),
                     np.where(c, lb - bbp, bep), np.where(c, la - aep, abp),
                     np.where(c, la - abp, aep)], 1)


def _sorted(las, parts):
    from damar_tpu_torch.formats.las import LasColumns
    f = _las(LasColumns.concat(parts), las.tspace)
    f.sort()
    return f


def _replace(la, lb, rows, boxes, rlen, rate):
    """las_a with its records `rows` replaced by `boxes`, and las_b with
    their mirrors replaced by the boxes' mirrors; records whose box
    cannot be encoded stay as they were."""
    from benchmark import reference
    ca, cb = _cols(la), _cols(lb)
    mine, ok_a = _records(boxes, la.tspace, rate)
    theirs, ok_b = _records(_mirrors(boxes, rlen), la.tspace, rate)
    both = ok_a & ok_b
    mine = mine.permute(np.nonzero(both[ok_a])[0])
    theirs = theirs.permute(np.nonzero(both[ok_b])[0])
    rows = np.asarray(rows)[both]
    keep_a = np.ones(ca.n, bool)
    keep_a[rows] = False
    keep_b = np.ones(cb.n, bool)
    hb_keys = reference._row_keys(reference.identity_of(cb.headers))
    old = reference._row_keys(reference.mirror_of(ca.headers[rows], rlen))
    keep_b[np.isin(hb_keys, old)] = False
    return (_sorted(la, [ca.permute(np.nonzero(keep_a)[0]), mine]),
            _sorted(lb, [cb.permute(np.nonzero(keep_b)[0]), theirs]))


def _add(la, lb, boxes, rlen, rate):
    """las_a with `boxes` added and las_b with their mirrors."""
    mine, ok_a = _records(boxes, la.tspace, rate)
    theirs, ok_b = _records(_mirrors(boxes, rlen), la.tspace, rate)
    both = ok_a & ok_b
    return (_sorted(la, [_cols(la), mine.permute(
                np.nonzero(both[ok_a])[0])]),
            _sorted(lb, [_cols(lb), theirs.permute(
                np.nonzero(both[ok_b])[0])]))


def _boxes(h: np.ndarray) -> np.ndarray:
    """(aread, bread, comp, abpos, aepos, bbpos, bepos) of header rows."""
    return np.stack([h[:, 7], h[:, 8], h[:, 6] & 1, h[:, 2], h[:, 4],
                     h[:, 3], h[:, 5]], 1).astype(np.int64)


@contextlib.contextmanager
def over_extended():
    def edit(la, lb, state):
        rlen = _lengths(state)
        bx = _boxes(_cols(la).headers)
        aep = np.minimum(bx[:, 4] + OVER_BP, rlen[bx[:, 0]])
        bep = np.minimum(bx[:, 6] + OVER_BP, rlen[bx[:, 1]])
        rows = np.nonzero((aep != bx[:, 4]) | (bep != bx[:, 6]))[0]
        bx[:, 4], bx[:, 6] = aep, bep
        return _replace(la, lb, rows, bx[rows], rlen, 0.25)
    with _on_emit(edit):
        yield


@contextlib.contextmanager
def made_up():
    def edit(la, lb, state):
        rlen = _lengths(state)
        b_ids = np.sort(state["blk_b"].ids.astype(np.int64))
        boxes = []
        for ar, br, _, abp, aep, bbp, bep in _boxes(
                _cols(la).headers)[::MADE_UP_EVERY].tolist():
            at = int(np.searchsorted(b_ids, br))
            for step in range(1, 17):
                other = int(b_ids[(at + 7919 * step) % len(b_ids)])
                if other not in (ar, br) and rlen[other] >= bep - bbp:
                    boxes.append((ar, other, 0, abp, aep, 0, bep - bbp))
                    break
        return _add(la, lb, np.array(boxes, np.int64).reshape(-1, 7),
                    rlen, 1.0)
    with _on_emit(edit):
        yield


WEAKER = {"kmer": 15, "hit_min": 100}
OVER_BP = 1000
MADE_UP_EVERY = 100
CONTROL = "weaker_settings"
BREAKERS = {"weaker_settings": weaker_settings, "mirrors_off": mirrors_off,
            "half_left_out": half_left_out,
            "answer_altered": answer_altered,
            "state_unchanged": state_unchanged,
            "over_extended": over_extended, "made_up": made_up}
