"""Dazzler read-database codec: .db stub + hidden .idx/.bps files
(numpy only; it writes the same bytes as damar_tpu.formats.dazzdb).

  foo.db        text stub: source FASTA list, block table, split params
  .foo.idx      binary: HITS_DB header struct + HITS_READ[nreads] array
  .foo.bps      2-bit packed bases, 4 bases/byte, MSB-first, each read
                byte-aligned (read r starts at byte reads[r].boff)

Binary structs follow the C layout of a 64-bit little-endian build of
the DAZZ_DB lineage (db/DB.h; pointer fields serialized as zeros), so
databases are interchangeable with that toolchain.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

# --- binary layouts (64-bit C struct layouts, little-endian) ---------------

# HITS_DB / DAZZ_DB header as fwritten by the reference (112 bytes).
HITS_DB_DTYPE = np.dtype({
    "names": ["ureads", "treads", "cutoff", "allflag", "freq",
              "maxlen", "totlen", "nreads", "trimmed", "part",
              "ufirst", "tfirst", "path_ptr", "loaded",
              "bases_ptr", "reads_ptr", "tracks_ptr"],
    "formats": ["<i4", "<i4", "<i4", "<i4", ("<f4", (4,)),
                "<i4", "<i8", "<i4", "<i4", "<i4",
                "<i4", "<i4", "<i8", "<i4",
                "<i8", "<i8", "<i8"],
    "offsets": [0, 4, 8, 12, 16,
                32, 40, 48, 52, 56,
                60, 64, 72, 80,
                88, 96, 104],
    "itemsize": 112,
})

# HITS_READ / DAZZ_READ record (40 bytes).
HITS_READ_DTYPE = np.dtype({
    "names": ["origin", "rlen", "fpulse", "boff", "coff", "flags"],
    "formats": ["<i4", "<i4", "<i4", "<i8", "<i8", "<i4"],
    "offsets": [0, 4, 8, 16, 24, 32],
    "itemsize": 40,
})

# read flags (DB.h lineage)
DB_QV = 0x03FF
DB_CSS = 0x0400
DB_BEST = 0x0800

DEFAULT_BLOCK_MB = 200  # DBsplit -s default in the lineage


# --- 2-bit packing ---------------------------------------------------------

def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 base codes (0..3) -> packed bytes, 4/byte, MSB-first.  A
    trailing partial byte is padded with code 0 ('a'), as the lineage's
    Compress_Read pads it."""
    codes = np.asarray(codes, dtype=np.uint8)
    pad = (-len(codes)) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    q = codes.reshape(-1, 4)
    return (q[:, 0] << 6 | q[:, 1] << 4 | q[:, 2] << 2
            | q[:, 3]).astype(np.uint8)


def unpack_2bit(packed: np.ndarray, length: int) -> np.ndarray:
    """Packed bytes -> uint8 base codes (0..3), truncated to `length`."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty((len(packed), 4), dtype=np.uint8)
    out[:, 0] = packed >> 6
    out[:, 1] = (packed >> 4) & 3
    out[:, 2] = (packed >> 2) & 3
    out[:, 3] = packed & 3
    return out.reshape(-1)[:length]


# --- stub paths ------------------------------------------------------------

def _root(path: str) -> tuple[str, str]:
    """db path -> (directory, root name without .db)."""
    d, b = os.path.split(os.path.abspath(path))
    if b.endswith(".db"):
        b = b[:-3]
    return d, b


def stub_path(path: str) -> str:
    d, r = _root(path)
    return os.path.join(d, r + ".db")


def idx_path(path: str) -> str:
    d, r = _root(path)
    return os.path.join(d, "." + r + ".idx")


def bps_path(path: str) -> str:
    d, r = _root(path)
    return os.path.join(d, "." + r + ".bps")


# --- DB object -------------------------------------------------------------

@dataclass
class DazzDB:
    """An open read database (untrimmed view + trim parameters).

    `reads` is the HITS_READ structured array for ALL reads; the trimmed
    view (reads passing the length cutoff) is what block ranges and the
    compute pipeline use, mirroring Trim_DB in the lineage.
    """
    path: str
    ureads: int
    cutoff: int
    allflag: int
    freq: np.ndarray
    maxlen: int
    totlen: int
    reads: np.ndarray               # HITS_READ_DTYPE[ureads]
    files: list[tuple[int, str, str]] = field(default_factory=list)
    # block table: cumulative (ufirst, tfirst) boundaries, len nblocks+1
    block_u: np.ndarray | None = None
    block_t: np.ndarray | None = None
    block_size_mb: int = DEFAULT_BLOCK_MB
    _bps: np.ndarray | None = None

    # -- opening ------------------------------------------------------------

    @classmethod
    def open(cls, path: str) -> "DazzDB":
        spath = stub_path(path)
        files: list[tuple[int, str, str]] = []
        block_u = block_t = None
        size_mb, cutoff_s, all_s = DEFAULT_BLOCK_MB, 0, 1
        with open(spath) as f:
            lines = [ln.rstrip("\n") for ln in f]
        i = 0
        nfiles = int(lines[i].split("=")[1])
        i += 1
        for _ in range(nfiles):
            parts = lines[i].split()
            files.append((int(parts[0]), parts[1], parts[2] if len(parts) > 2 else ""))
            i += 1
        if i < len(lines) and lines[i].startswith("blocks"):
            nblocks = int(lines[i].split("=")[1])
            i += 1
            sp = lines[i].replace("=", " ").split()
            # "size = S cutoff = C all = A"
            size_mb, cutoff_s, all_s = int(sp[1]), int(sp[3]), int(sp[5])
            i += 1
            bu, bt = [], []
            for _ in range(nblocks + 1):
                a, b = lines[i].split()
                bu.append(int(a)); bt.append(int(b))
                i += 1
            block_u = np.array(bu, dtype=np.int64)
            block_t = np.array(bt, dtype=np.int64)

        raw = np.fromfile(idx_path(path), dtype=np.uint8)
        hdr = raw[:HITS_DB_DTYPE.itemsize].view(HITS_DB_DTYPE)[0]
        reads = raw[HITS_DB_DTYPE.itemsize:].view(HITS_READ_DTYPE).copy()
        assert len(reads) == hdr["ureads"], \
            f"idx read count {len(reads)} != header ureads {hdr['ureads']}"
        return cls(
            path=spath, ureads=int(hdr["ureads"]), cutoff=int(cutoff_s),
            allflag=int(all_s), freq=np.array(hdr["freq"]),
            maxlen=int(hdr["maxlen"]), totlen=int(hdr["totlen"]),
            reads=reads, files=files, block_u=block_u, block_t=block_t,
            block_size_mb=size_mb,
        )

    # -- basic access --------------------------------------------------------

    @property
    def nblocks(self) -> int:
        return 0 if self.block_u is None else len(self.block_u) - 1

    def _load_bps(self) -> np.ndarray:
        if self._bps is None:
            bps = np.fromfile(bps_path(self.path), dtype=np.uint8)
            # validate against the index before any read: a truncated
            # .bps would otherwise unpack short (silent garbage bases)
            if len(self.reads):
                need = int((self.reads["boff"].astype(np.int64)
                            + (self.reads["rlen"].astype(np.int64)
                               + 3) // 4).max())
                if len(bps) < need:
                    raise ValueError(
                        f"{bps_path(self.path)}: {len(bps)} bytes but "
                        f"the index addresses {need} (truncated .bps)")
            self._bps = bps
        return self._bps

    def read_seq(self, i: int) -> np.ndarray:
        """Base codes (0..3) of untrimmed read index i."""
        bps = self._load_bps()
        r = self.reads[i]
        nb = (int(r["rlen"]) + 3) // 4
        off = int(r["boff"])
        return unpack_2bit(bps[off:off + nb], int(r["rlen"]))

    # -- trimmed view --------------------------------------------------------

    def trimmed_index(self) -> np.ndarray:
        """Untrimmed indices of reads passing the cutoff (Trim_DB)."""
        keep = self.reads["rlen"] >= self.cutoff
        if not self.allflag:
            keep &= (self.reads["flags"] & DB_BEST) != 0
        return np.nonzero(keep)[0]

    def block_range(self, b: int) -> tuple[int, int]:
        """Untrimmed read index range [lo, hi) of 1-based block b."""
        if self.block_u is None:
            if b != 1:
                raise ValueError("DB is not split; only block 1 exists")
            return 0, self.ureads
        if not 1 <= b <= self.nblocks:
            raise ValueError(
                f"block {b} out of range (DB has {self.nblocks} blocks)")
        return int(self.block_u[b - 1]), int(self.block_u[b])

    def block_reads(self, b: int) -> np.ndarray:
        """Trimmed (cutoff-passing) untrimmed-indices within block b."""
        lo, hi = self.block_range(b)
        idx = np.arange(lo, hi)
        keep = self.reads["rlen"][lo:hi] >= self.cutoff
        if not self.allflag:
            keep &= (self.reads["flags"][lo:hi] & DB_BEST) != 0
        return idx[keep]

    def block_seqs(self, b: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Concatenated base codes + offsets + untrimmed ids for block b.

        Returns (bases, starts, read_ids): bases is the concatenation of
        all trimmed reads in the block; starts has len(read_ids)+1 with
        starts[j]..starts[j+1] spanning read j.
        """
        ids = self.block_reads(b)
        lens = self.reads["rlen"][ids].astype(np.int64)
        starts = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        bases = np.empty(int(starts[-1]), dtype=np.uint8)
        bps = self._load_bps()
        for j, i in enumerate(ids):
            r = self.reads[i]
            nb = (int(r["rlen"]) + 3) // 4
            off = int(r["boff"])
            bases[starts[j]:starts[j + 1]] = unpack_2bit(
                bps[off:off + nb], int(r["rlen"]))
        return bases, starts, ids


# --- creation (fasta2DB equivalent) ----------------------------------------

def create_db(path: str, fasta_paths: list[str]) -> DazzDB:
    """FASTA file(s) -> .db stub + .idx + .bps (fasta2DB equivalent).

    Reads are appended in file order; origin = well/ordinal within file,
    fpulse = 0 (no pulse metadata for plain FASTA).  FASTQ files
    (.fastq/.fq, optionally gzipped) may be mixed in: when any read has
    qualities, they go to the .qvs file (formats.qv.fastq_to_qvs; a FASTA
    read's stream is empty).
    """
    from damar_tpu_torch.formats.fasta import iter_fasta, iter_fastq

    def records_of(fp):
        if fp.endswith((".fastq", ".fq", ".fastq.gz", ".fq.gz")):
            for h, codes, q in iter_fastq(fp):
                yield h, codes, q
        else:
            for h, codes in iter_fasta(fp):
                yield h, codes, None

    quals: list = []
    any_quals = False
    recs = []
    files: list[tuple[int, str, str]] = []
    bps_chunks: list[np.ndarray] = []
    boff = 0
    counts = np.zeros(4, dtype=np.int64)
    maxlen, totlen = 0, 0
    nreads = 0
    for fp in fasta_paths:
        prolog = ""
        n_in_file = 0
        for header, codes, q in records_of(fp):
            quals.append(q if q is not None else np.zeros(0, np.uint8))
            any_quals = any_quals or q is not None
            if not prolog:
                prolog = header.split()[0]
            rlen = len(codes)
            recs.append((n_in_file, rlen, 0, boff, 0, 0))
            packed = pack_2bit(codes)
            bps_chunks.append(packed)
            boff += len(packed)
            c = np.bincount(codes, minlength=4)
            counts += c
            maxlen = max(maxlen, rlen)
            totlen += rlen
            nreads += 1
            n_in_file += 1
        base = os.path.basename(fp)
        for suf in (".gz", ".fasta", ".fa"):
            if base.endswith(suf):
                base = base[: -len(suf)]
        files.append((nreads, base, prolog or base))

    reads = np.zeros(nreads, dtype=HITS_READ_DTYPE)
    for j, (origin, rlen, fpulse, bo, co, fl) in enumerate(recs):
        reads[j] = (origin, rlen, fpulse, bo, co, fl)

    hdr = np.zeros(1, dtype=HITS_DB_DTYPE)
    hdr["ureads"] = nreads
    hdr["treads"] = nreads
    hdr["cutoff"] = -1
    hdr["allflag"] = 0
    hdr["freq"] = (counts / max(1, totlen)).astype(np.float32)
    hdr["maxlen"] = maxlen
    hdr["totlen"] = totlen
    hdr["nreads"] = nreads

    with open(idx_path(path), "wb") as f:
        f.write(hdr.tobytes())
        f.write(reads.tobytes())
    with open(bps_path(path), "wb") as f:
        for ch in bps_chunks:
            f.write(ch.tobytes())
    _write_stub(path, files, None, None, DEFAULT_BLOCK_MB, 0, 1)
    if any_quals:
        from damar_tpu_torch.formats.qv import fastq_to_qvs
        fastq_to_qvs(path, quals)
    return DazzDB.open(path)


def _write_stub(path, files, block_u, block_t, size_mb, cutoff, allflag):
    with open(stub_path(path), "w") as f:
        f.write(f"files = {len(files):9d}\n")
        for cum, name, prolog in files:
            f.write(f"  {cum:9d} {name} {prolog}\n")
        if block_u is not None:
            f.write(f"blocks = {len(block_u) - 1:9d}\n")
            f.write(f"size = {size_mb:9d} cutoff = {cutoff:9d} all = {allflag}\n")
            for u, t in zip(block_u, block_t):
                f.write(f"  {u:9d} {t:9d}\n")


def db_split(path: str, size_mb: int = DEFAULT_BLOCK_MB, cutoff: int = 0,
             allflag: int = 1) -> DazzDB:
    """Partition the DB into blocks of <= size_mb Mbp of trimmed bases
    (DBsplit equivalent).  Blocks are contiguous untrimmed read ranges;
    a read whose addition would exceed the budget starts the next block.
    """
    db = DazzDB.open(path)
    limit = size_mb * 1_000_000
    rlens = db.reads["rlen"].astype(np.int64)
    keep = rlens >= cutoff
    block_u = [0]
    block_t = [0]
    acc = 0
    tcount = 0
    for i in range(db.ureads):
        if keep[i]:
            if acc + rlens[i] > limit and acc > 0:
                block_u.append(i)
                block_t.append(tcount)
                acc = 0
            acc += rlens[i]
            tcount += 1
    block_u.append(db.ureads)
    block_t.append(tcount)
    _write_stub(path, db.files, np.array(block_u), np.array(block_t),
                size_mb, cutoff, allflag)
    return DazzDB.open(path)


def db_stats(path: str) -> dict:
    """Summary statistics (DBstats equivalent): counts, bp, N50, histogram."""
    db = DazzDB.open(path)
    idx = db.trimmed_index()
    lens = np.sort(db.reads["rlen"][idx].astype(np.int64))[::-1]
    total = int(lens.sum())
    half = total / 2
    csum = np.cumsum(lens)
    n50 = int(lens[np.searchsorted(csum, half)]) if total else 0
    return {
        "ureads": db.ureads,
        "treads": len(idx),
        "total_bp": total,
        "maxlen": int(lens[0]) if len(lens) else 0,
        "mean": float(lens.mean()) if len(lens) else 0.0,
        "n50": n50,
        "nblocks": db.nblocks,
        "freq": db.freq.tolist(),
    }
