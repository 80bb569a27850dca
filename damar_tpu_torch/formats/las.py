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

Two representations coexist, as in damar_tpu.formats.las, and write the
same bytes:

  * `Overlap` objects (one per record), the API the command-line tools
    and the object forms of the pile tools read and mutate;
  * `LasColumns`, a struct-of-arrays form (headers [n,10] int32 in file
    record order, the raw file-encoded trace bytes and byte offsets), used
    by the block-scale paths (overlap emission, sort, merge, file IO).

`LasFile` holds either: a columnar file materializes Overlap objects on
first `.overlaps` access and drops the columns (the objects may then be
mutated).  reconstruct_alignments renders the base-level alignment of
records (LAshow -a) with every trace segment of every record aligned in
one pile-aligner call (K4 on the card).
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from damar_tpu_torch.formats.oflags import OVL_COMP, flag_str

TRACE_XOVR = 125

# header column indices (int32 view of the 40-byte record)
H_TLEN, H_DIFFS, H_ABPOS, H_BBPOS, H_AEPOS, H_BEPOS = range(6)
H_FLAGS, H_AREAD, H_BREAD, H_PAD = 6, 7, 8, 9


@dataclass
class Overlap:
    aread: int
    bread: int
    flags: int
    abpos: int
    aepos: int
    bbpos: int
    bepos: int
    diffs: int
    trace: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.int32))
    # trace: (nseg, 2) int array of (diffs, bspan) per segment

    @property
    def comp(self) -> bool:
        return bool(self.flags & OVL_COMP)

    def alen(self) -> int:
        return self.aepos - self.abpos

    def blen(self) -> int:
        return self.bepos - self.bbpos

    def __repr__(self):
        return (f"Overlap(a={self.aread} b={self.bread}"
                f"{'c' if self.comp else 'n'} "
                f"A[{self.abpos},{self.aepos}) B[{self.bbpos},{self.bepos}) "
                f"d={self.diffs} [{flag_str(self.flags)}])")


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


def _columns_to_overlaps(cols: LasColumns, small: bool) -> list[Overlap]:
    h = cols.headers
    offs = cols.offsets
    tr = cols.trace
    return [Overlap(
        aread=int(h[i, H_AREAD]), bread=int(h[i, H_BREAD]),
        flags=int(np.uint32(h[i, H_FLAGS])),
        abpos=int(h[i, H_ABPOS]), aepos=int(h[i, H_AEPOS]),
        bbpos=int(h[i, H_BBPOS]), bepos=int(h[i, H_BEPOS]),
        diffs=int(h[i, H_DIFFS]),
        trace=_decode_trace(tr[offs[i]:offs[i + 1]], small))
        for i in range(cols.n)]


def _overlaps_to_columns(ovls: list[Overlap], small: bool) -> LasColumns:
    n = len(ovls)
    headers = np.zeros((n, 10), np.int32)
    lens = np.zeros(n, np.int64)
    traces = []
    for i, o in enumerate(ovls):
        t = np.asarray(o.trace, dtype=np.int32).reshape(-1, 2)
        traces.append(t)
        lens[i] = t.shape[0]
        headers[i, :9] = (2 * t.shape[0], o.diffs, o.abpos, o.bbpos,
                          o.aepos, o.bepos,
                          np.uint32(o.flags).view(np.int32),
                          o.aread, o.bread)
    rows = (np.concatenate(traces) if traces
            else np.zeros((0, 2), np.int32))
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=seg_off[1:])
    payload, offs = encode_trace_columns(rows, seg_off, small)
    return LasColumns(headers, payload, offs)


class LasFile:
    """A set of .las records: columnar or object-backed.

    Construct with `overlaps=` (a list of Overlap) or `columns=`
    (LasColumns).  `.overlaps` materializes objects from the columns on
    first access and drops the columns (the objects may be mutated);
    `.columns` is the columnar form while it is authoritative, else
    None."""

    def __init__(self, tspace: int, overlaps: list[Overlap] | None = None,
                 columns: LasColumns | None = None):
        self.tspace = int(tspace)
        if overlaps is None and columns is None:
            overlaps = []
        self._overlaps = overlaps
        self._columns = columns if overlaps is None else None

    @property
    def small(self) -> bool:
        return self.tspace <= TRACE_XOVR

    @property
    def columns(self) -> LasColumns | None:
        return self._columns

    @property
    def overlaps(self) -> list[Overlap]:
        if self._overlaps is None:
            self._overlaps = _columns_to_overlaps(self._columns, self.small)
            self._columns = None
        return self._overlaps

    @overlaps.setter
    def overlaps(self, v: list[Overlap]) -> None:
        self._overlaps = v
        self._columns = None

    @property
    def novl(self) -> int:
        if self._columns is not None:
            return self._columns.n
        return len(self._overlaps)

    def a_spans(self) -> np.ndarray:
        """A-interval lengths per record (no materialization)."""
        if self._columns is not None:
            return self._columns.a_spans()
        return np.array([o.aepos - o.abpos for o in self._overlaps],
                        np.int64)

    def sort(self) -> None:
        """LAsort order: (aread, bread, comp, abpos, aepos, bbpos)."""
        if self._columns is not None:
            self._columns = self._columns.permute(
                self._columns.sort_order())
            return
        self._overlaps.sort(
            key=lambda o: (o.aread, o.bread, o.flags & OVL_COMP, o.abpos,
                           o.aepos, o.bbpos))

    @staticmethod
    def concat(parts: list["LasFile"]) -> "LasFile":
        """Concatenate record sets in the order given: columnar when every
        part with records still is, else objects (which materializes the
        columnar parts)."""
        if not parts:
            return LasFile(tspace=100, overlaps=[])
        ts = {p.tspace for p in parts if p.novl} or {parts[0].tspace}
        if len(ts) != 1:
            raise ValueError(f"mixed tspace values {ts}")
        tspace = ts.pop()
        if all(p._columns is not None or not p.novl for p in parts):
            return LasFile(tspace, columns=LasColumns.concat(
                [p._columns for p in parts if p._columns is not None]))
        allov: list[Overlap] = []
        for p in parts:
            allov.extend(p.overlaps)
        return LasFile(tspace, overlaps=allov)


def columns_of(las: LasFile) -> LasColumns:
    """The columns of a las: its own, or one build pass over its objects
    (the file stays object-backed)."""
    c = las.columns
    if c is None:
        c = _overlaps_to_columns(las.overlaps, las.small)
    return c


def n_segments(abpos: int, aepos: int, tspace: int) -> int:
    """Number of trace-point segments of A-interval [abpos, aepos)."""
    if aepos <= abpos:
        return 0
    return (aepos - 1) // tspace - abpos // tspace + 1


def write_las(path: str, las: LasFile, _chunk: int = 1 << 25) -> None:
    """Bulk columnar writer: assembles the file image in bounded record
    chunks (interleaved header/payload scatter per chunk); an
    object-backed file is encoded to columns first."""
    cols = columns_of(las)
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
    Returns a list of problem strings (empty = clean).  Validation is
    vectorized over the columns; an object-backed file is checked through
    its columns (one build pass, which raises ValueError on a trace
    value the file cannot hold, as write_las does), so its problems read
    as those of the same records read from a file."""
    if rlen_b is None:
        rlen_b = rlen_a
    cols = columns_of(las)
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


# --- display (LAshow equivalents) -------------------------------------------

def reconstruct_alignments(records: list, tspace: int, width: int = 80, *,
                           device) -> list[str]:
    """Render the base-level alignment of each record from its trace
    points (LAshow -a): each trace segment is aligned again, globally,
    with a band of max(32, diffs + 8) (the trace gives the spans and the
    diffs).  records: [(Overlap, aseq, bseq)], the A read's codes and the
    B read's, already complemented when the record has the COMP flag.
    Every segment of every record goes through one pile-aligner call
    (ops.band_align.align_pairs: K4 on a CUDA device, its plain version
    on the CPU); each pair is aligned on its own, so the paths are those
    of one call per segment."""
    from damar_tpu_torch.formats.fasta import decode_seq
    from damar_tpu_torch.ops.band_align import align_pairs
    segs, pairs = [], []
    for o, aseq, bseq in records:
        a0, b0 = o.abpos, o.bbpos
        rs = []
        for d, bspan in np.asarray(o.trace, dtype=np.int64):
            a1 = min((a0 // tspace + 1) * tspace, o.aepos)
            aw, bw = aseq[a0:a1], bseq[b0:b0 + bspan]
            rs.append((aw, bw))
            pairs.append((aw, bw, max(32, int(d) + 8)))
            a0, b0 = a1, b0 + int(bspan)
        segs.append(rs)
    aligned = iter(align_pairs(pairs, semiglobal=False, device=device))
    out = []
    for rs in segs:
        top, mid, bot = [], [], []
        for aw, bw in rs:
            ops, j = next(aligned)
            i = 0
            for op in ops:
                if op == 0:
                    top.append(decode_seq(aw[i:i + 1]))
                    bot.append(decode_seq(bw[j:j + 1]))
                    mid.append("|" if aw[i] == bw[j] else "*")
                    i += 1
                    j += 1
                elif op == 1:
                    top.append(decode_seq(aw[i:i + 1]))
                    bot.append("-")
                    mid.append(" ")
                    i += 1
                else:
                    top.append("-")
                    bot.append(decode_seq(bw[j:j + 1]))
                    mid.append(" ")
                    j += 1
        lines = []
        t, m, b = "".join(top), "".join(mid), "".join(bot)
        for k in range(0, len(t), width):
            lines.append(f"  A {t[k:k + width]}")
            lines.append(f"    {m[k:k + width]}")
            lines.append(f"  B {b[k:k + width]}")
            lines.append("")
        out.append("\n".join(lines))
    return out


def reconstruct_alignment(o: Overlap, aseq, bseq, tspace: int,
                          width: int = 80, *, device) -> str:
    """reconstruct_alignments of one record."""
    return reconstruct_alignments([(o, aseq, bseq)], tspace, width,
                                  device=device)[0]


def show_las(las: LasFile, limit: int | None = None) -> str:
    """Human-readable dump (LAshow header lines)."""
    lines = []
    for o in las.overlaps[:limit]:
        c = "c" if o.comp else "n"
        lines.append(
            f"{o.aread:7d} {o.bread:7d} {c} "
            f"[{o.abpos:7d}..{o.aepos:7d}] x [{o.bbpos:7d}..{o.bepos:7d}] "
            f"( {o.diffs} diffs, {len(o.trace)} tps )")
    return "\n".join(lines)
