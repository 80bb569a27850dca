"""Local-alignment (.las) file codec, columnar and numpy only.

Layout follows the Dazzler lineage (dalign/align.h Write_Overlap):

  header:  int64 novl;  int32 tspace;
  record:  40 bytes LE: tlen,diffs,abpos,bbpos,aepos,bepos (i32 x6),
           flags (u32), aread (i32), bread (i32), 4 pad bytes;
           followed by the trace array: tlen bytes (u8) if
           tspace <= TRACE_XOVR(=125), else tlen int16s.

The trace array holds one (diffs, b_bases_spanned) pair per trace-point
segment; segments are delimited by absolute multiples of tspace in A.
Records are sorted by (aread, bread, COMP bit, abpos, aepos, bbpos).

This is the columnar subset of damar_tpu.formats.las that the overlap
pipeline, the block sweep, masking and scrub emit, read, merge and check;
it writes the same bytes.  The per-record Overlap objects,
reconstruct_alignment and show_las are not ported yet (no ported stage
needs them).
"""
from __future__ import annotations

import os
import struct

import numpy as np

from damar_tpu_torch.formats.oflags import OVL_COMP

TRACE_XOVR = 125

# header column indices (int32 view of the 40-byte record)
H_TLEN, H_DIFFS, H_ABPOS, H_BBPOS, H_AEPOS, H_BEPOS = range(6)
H_FLAGS, H_AREAD, H_BREAD, H_PAD = 6, 7, 8, 9


def _gather_ragged(trace: np.ndarray, starts: np.ndarray,
                   lens: np.ndarray, chunk_bytes: int = 1 << 25
                   ) -> np.ndarray:
    """Gather ragged byte runs trace[starts[i]:starts[i]+lens[i]] into
    one contiguous buffer, in bounded record chunks (the arange+repeat
    index arrays are int64, 8x the payload)."""
    out_off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=out_off[1:])
    out = np.empty(int(out_off[-1]), np.uint8)
    n = len(lens)
    lo = 0
    while lo < n:
        hi = int(np.searchsorted(out_off, out_off[lo] + chunk_bytes,
                                 side="left"))
        hi = min(max(hi, lo + 1), n)
        ls = lens[lo:hi]
        total = int(out_off[hi] - out_off[lo])
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(out_off[lo:hi] - out_off[lo], ls)
               + np.repeat(starts[lo:hi], ls))
        out[out_off[lo]:out_off[hi]] = trace[pos]
        lo = hi
    return out


class LasColumns:
    """Columnar .las payload.

    headers:  [n, 10] int32, file record order (tlen, diffs, abpos,
              bbpos, aepos, bepos, flags, aread, bread, pad)
    trace:    raw trace payload bytes in FILE encoding (u8 pairs when
              small, <i2 pairs otherwise), all records concatenated
    offsets:  [n+1] int64 BYTE offsets of each record's payload
    """
    __slots__ = ("headers", "trace", "offsets")

    def __init__(self, headers: np.ndarray, trace: np.ndarray,
                 offsets: np.ndarray):
        self.headers = np.ascontiguousarray(headers, dtype=np.int32)
        self.trace = np.ascontiguousarray(trace, dtype=np.uint8)
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)

    @classmethod
    def empty(cls) -> "LasColumns":
        return cls(np.zeros((0, 10), np.int32), np.zeros(0, np.uint8),
                   np.zeros(1, np.int64))

    @property
    def n(self) -> int:
        return self.headers.shape[0]

    def sort_order(self) -> np.ndarray:
        """LAsort order: (aread, bread, comp, abpos, aepos, bbpos)."""
        h = self.headers
        return np.lexsort((h[:, H_BBPOS], h[:, H_AEPOS], h[:, H_ABPOS],
                           h[:, H_FLAGS] & 1, h[:, H_BREAD],
                           h[:, H_AREAD]))

    def permute(self, order: np.ndarray) -> "LasColumns":
        lens = np.diff(self.offsets)
        starts = self.offsets[:-1][order]
        lens_o = lens[order]
        new_off = np.zeros(len(order) + 1, np.int64)
        np.cumsum(lens_o, out=new_off[1:])
        return LasColumns(self.headers[order],
                          _gather_ragged(self.trace, starts, lens_o),
                          new_off)

    @staticmethod
    def concat(parts: list["LasColumns"]) -> "LasColumns":
        parts = [p for p in parts if p.n]
        if not parts:
            return LasColumns.empty()
        headers = np.concatenate([p.headers for p in parts])
        trace = np.concatenate([p.trace for p in parts])
        offs = np.zeros(headers.shape[0] + 1, np.int64)
        np.cumsum(np.concatenate([np.diff(p.offsets) for p in parts]),
                  out=offs[1:])
        return LasColumns(headers, trace, offs)

    def a_spans(self) -> np.ndarray:
        return self.headers[:, H_AEPOS] - self.headers[:, H_ABPOS]


def encode_trace_columns(trace_rows: np.ndarray, seg_offsets: np.ndarray,
                         small: bool) -> tuple[np.ndarray, np.ndarray]:
    """Encode [total_segs, 2] int32 trace pairs (record i owns segment
    rows seg_offsets[i]:seg_offsets[i+1]) into file bytes + BYTE
    offsets, rejecting values the file encoding cannot hold."""
    flat = np.ascontiguousarray(trace_rows, dtype=np.int32)
    if flat.size:
        lo = int(flat.min())
        if lo < 0:
            raise ValueError(f"negative trace value {lo}")
        hi = int(flat.max())
        if small and hi > 255:
            raise ValueError(f"trace value {hi} exceeds u8")
        if not small and hi > 32767:
            raise ValueError(f"trace value {hi} exceeds i16")
    width = 2 if small else 4
    if small:
        payload = flat.astype(np.uint8).reshape(-1)
    else:
        payload = flat.astype("<i2").reshape(-1).view(np.uint8)
    return payload, np.asarray(seg_offsets, dtype=np.int64) * width


def _decode_trace(raw: np.ndarray, small: bool) -> np.ndarray:
    if small:
        return raw.astype(np.int32).reshape(-1, 2)
    return raw.view("<i2").astype(np.int32).reshape(-1, 2)


class LasFile:
    """A set of .las records in columnar form."""

    def __init__(self, tspace: int, columns: LasColumns | None = None):
        self.tspace = int(tspace)
        self.columns = columns if columns is not None \
            else LasColumns.empty()

    @property
    def small(self) -> bool:
        return self.tspace <= TRACE_XOVR

    @property
    def novl(self) -> int:
        return self.columns.n

    def a_spans(self) -> np.ndarray:
        """A-interval lengths per record."""
        return self.columns.a_spans()

    def sort(self) -> None:
        """LAsort order: (aread, bread, comp, abpos, aepos, bbpos)."""
        self.columns = self.columns.permute(self.columns.sort_order())

    @staticmethod
    def concat(parts: list["LasFile"]) -> "LasFile":
        """Concatenate record sets in the order given."""
        if not parts:
            return LasFile(tspace=100)
        ts = {p.tspace for p in parts if p.novl} or {parts[0].tspace}
        if len(ts) != 1:
            raise ValueError(f"mixed tspace values {ts}")
        return LasFile(ts.pop(), columns=LasColumns.concat(
            [p.columns for p in parts]))


def n_segments(abpos: int, aepos: int, tspace: int) -> int:
    """Number of trace-point segments of A-interval [abpos, aepos)."""
    if aepos <= abpos:
        return 0
    return (aepos - 1) // tspace - abpos // tspace + 1


def write_las(path: str, las: LasFile, _chunk: int = 1 << 25) -> None:
    """Bulk columnar writer: assembles the file image in bounded record
    chunks (interleaved header/payload scatter per chunk)."""
    cols = las.columns
    n = cols.n
    lens = np.diff(cols.offsets)
    hdr = np.ascontiguousarray(cols.headers).view(np.uint8) \
        .reshape(max(n, 1), 40) if n else None
    with open(path, "wb") as f:
        f.write(np.int64(n).tobytes())
        f.write(np.int32(las.tspace).tobytes())
        lo = 0
        while lo < n:
            hi = int(np.searchsorted(cols.offsets,
                                     cols.offsets[lo] + _chunk,
                                     side="left"))
            hi = min(max(hi, lo + 1), n)
            k = hi - lo
            pay = int(cols.offsets[hi] - cols.offsets[lo])
            buf = np.empty(40 * k + pay, np.uint8)
            rec_starts = (40 * np.arange(k, dtype=np.int64)
                          + cols.offsets[lo:hi] - cols.offsets[lo])
            dst = (rec_starts[:, None]
                   + np.arange(40, dtype=np.int64)).reshape(-1)
            buf[dst] = hdr[lo:hi].reshape(-1)
            if pay:
                ls = lens[lo:hi]
                shift = rec_starts + 40 - (cols.offsets[lo:hi]
                                           - cols.offsets[lo])
                tp = (np.arange(pay, dtype=np.int64)
                      + np.repeat(shift, ls))
                buf[tp] = cols.trace[cols.offsets[lo]:cols.offsets[hi]]
            buf.tofile(f)
            lo = hi


def read_las_columns(path: str) -> tuple[int, LasColumns]:
    """Read a .las into columnar form: one walk over the record starts
    (each record's length is in its own header), then bulk gathers of
    the headers and the trace payload."""
    head = np.fromfile(path, dtype=np.uint8, count=12)
    if head.size < 12:
        raise ValueError(f"{path}: truncated header")
    novl = int(head[:8].view("<i8")[0])
    tspace = int(head[8:12].view("<i4")[0])
    # validate the record-count claim BEFORE any allocation sized by it
    size = os.path.getsize(path)
    if novl < 0 or 12 + 40 * novl > size:
        raise ValueError(
            f"{path}: header claims {novl} records but the file holds "
            f"{size} bytes (corrupt or truncated)")
    width = 1 if tspace <= TRACE_XOVR else 2
    raw = np.fromfile(path, dtype=np.uint8)
    buf = memoryview(raw)
    end = len(raw)
    rec = np.zeros(novl, np.int64)          # byte offset of each record
    lens = np.zeros(novl, np.int64)         # its trace payload's bytes
    tlen_at = struct.Struct("<i").unpack_from
    pos = 12
    for i in range(novl):
        if pos + 40 > end:
            raise ValueError(f"{path}: truncated record {i}")
        tb = tlen_at(buf, pos)[0] * width
        if tb < 0 or pos + 40 + tb > end:
            raise ValueError(f"{path}: truncated trace of record {i}")
        rec[i] = pos
        lens[i] = tb
        pos += 40 + tb
    if pos != end:
        raise ValueError(f"{path}: {end - pos} trailing bytes")
    headers = raw[rec[:, None] + np.arange(40)].view("<i4").reshape(novl, 10)
    offs = np.zeros(novl + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return tspace, LasColumns(headers, _gather_ragged(raw, rec + 40, lens),
                              offs)


def read_las(path: str) -> LasFile:
    tspace, cols = read_las_columns(path)
    return LasFile(tspace=tspace, columns=cols)


def check_las(las: LasFile, rlen_a, rlen_b=None, sorted_order: bool = True,
              max_report: int = 20) -> list[str]:
    """Structural validation of a .las against read lengths (LAcheck):
    coordinate bounds, trace segment count, trace b-span and diffs
    consistency, per-segment diffs >= |aspan - bspan|, sort order.
    rlen_a/rlen_b map absolute read id -> length (b defaults to a).
    Returns a list of problem strings (empty = clean)."""
    if rlen_b is None:
        rlen_b = rlen_a
    cols = las.columns
    tspace = las.tspace
    errs: list[str] = []
    h = cols.headers
    n = cols.n
    if n == 0:
        return errs
    small = tspace <= TRACE_XOVR
    rlen_a = np.asarray(rlen_a)
    rlen_b = np.asarray(rlen_b)
    abp, aep = h[:, H_ABPOS], h[:, H_AEPOS]
    bbp, bep = h[:, H_BBPOS], h[:, H_BEPOS]
    ids_ok = ((h[:, H_AREAD] >= 0) & (h[:, H_AREAD] < len(rlen_a))
              & (h[:, H_BREAD] >= 0) & (h[:, H_BREAD] < len(rlen_b)))
    for i in np.nonzero(~ids_ok)[0][:max_report]:
        errs.append(f"[{i}] read id out of range")
    if not ids_ok.all():
        return errs
    la = rlen_a[h[:, H_AREAD]]
    lb = rlen_b[h[:, H_BREAD]]

    def report(mask, what):
        for i in np.nonzero(mask)[0][:max_report]:
            errs.append(f"[{i}] {what(i)}")
        return mask

    bad_a = report((abp < 0) | (abp >= aep) | (aep > la),
                   lambda i: f"bad A interval {abp[i]},{aep[i]} "
                             f"(len {la[i]})")
    bad_b = report((bbp < 0) | (bbp >= bep) | (bep > lb),
                   lambda i: f"bad B interval {bbp[i]},{bep[i]} "
                             f"(len {lb[i]})")
    skip = bad_a | bad_b
    nseg_exp = np.where(aep > abp,
                        (aep - 1) // tspace - abp // tspace + 1, 0)
    nseg_got = h[:, H_TLEN] // 2
    bad_n = report(~skip & (nseg_got != nseg_exp),
                   lambda i: f"trace has {nseg_got[i]} segments, "
                             f"expect {nseg_exp[i]}")
    skip |= bad_n
    rows = _decode_trace(cols.trace, small)
    seg_off = cols.offsets // (2 if small else 4)
    nz = seg_off[:-1] < seg_off[1:]
    bsum = np.zeros(n, np.int64)
    dsum = np.zeros(n, np.int64)
    if rows.shape[0]:
        bsum[nz] = np.add.reduceat(rows[:, 1], seg_off[:-1][nz])
        dsum[nz] = np.add.reduceat(rows[:, 0], seg_off[:-1][nz])
    report(~skip & (bsum != (bep - bbp).astype(np.int64)),
           lambda i: f"trace b-span {bsum[i]} != {bep[i] - bbp[i]}")
    report(~skip & (dsum != h[:, H_DIFFS]),
           lambda i: f"trace diffs {dsum[i]} != record diffs "
                     f"{h[:, H_DIFFS][i]}")
    if rows.shape[0]:
        lens = np.diff(seg_off)
        rid = np.repeat(np.arange(n), lens)
        k = np.arange(rows.shape[0]) - np.repeat(seg_off[:-1], lens)
        base = abp[rid].astype(np.int64) // tspace + k
        a0 = np.maximum(abp[rid], base * tspace)
        a1 = np.minimum((base + 1) * tspace, aep[rid])
        segbad = (~skip[rid]) & (rows[:, 0]
                                 < np.abs((a1 - a0) - rows[:, 1]))
        for g in np.nonzero(segbad)[0][:max_report]:
            errs.append(f"[{rid[g]}] seg {k[g]}: diffs {rows[g, 0]} < "
                        f"|aspan-bspan| {abs((a1[g]-a0[g]) - rows[g,1])}")
    if sorted_order and n > 1:
        keys = (h[:, H_AREAD], h[:, H_BREAD], h[:, H_FLAGS] & OVL_COMP,
                h[:, H_ABPOS])
        after = np.zeros(n - 1, bool)   # strictly greater so far
        viol = np.zeros(n - 1, bool)
        for kcol in keys:
            viol |= ~after & (kcol[1:] < kcol[:-1])
            after |= kcol[1:] > kcol[:-1]
        for i in np.nonzero(viol)[0][:max_report]:
            errs.append(f"[{i + 1}] sort order violation")
    return errs


# --- merge / sort / cat (LAsort, LAmerge, LAcat equivalents) ---------------

def sort_las_file(path: str, out: str | None = None) -> None:
    las = read_las(path)
    las.sort()
    write_las(out or path, las)


def merge_las(paths: list[str], out: str) -> None:
    """Merge sorted .las files into one sorted file: concatenate the
    columns in the order given and sort (stable, so equal keys keep the
    order of `paths`, as a k-way merge would)."""
    las = LasFile.concat([read_las(p) for p in paths])
    las.sort()
    write_las(out, las)


def cat_las(paths: list[str], out: str) -> None:
    write_las(out, LasFile.concat([read_las(p) for p in paths]))
