"""Block layout of a DB block: padded read arrays (numpy, host side).

  bases    uint8[cap]      concatenated 2-bit codes (0..3), padded with 4
  starts   int32[nr+1]     read start offsets into `bases`
  read_id  int32[cap]      position -> local read ordinal (nr at padding)
  rlen     int32[nr]       read lengths
  ids      int32[nr]       local ordinal -> absolute (untrimmed) read id

The same layout and capacity buckets as damar_tpu.core.blocks, so a
block built here is byte-equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

PAD_BASE = 4  # sentinel base code; matches nothing (valid codes are 0..3)


@dataclass
class ReadBlock:
    """Host-side staging of one DB block.  bases is None for a
    reverse-complement twin whose bases live on a card only
    (pipeline.overlap._rc_cached)."""
    bases: np.ndarray | None  # uint8[cap]
    starts: np.ndarray    # int32[nr+1]
    read_id: np.ndarray   # int32[cap]
    rlen: np.ndarray      # int32[nr]
    ids: np.ndarray       # int32[nr] absolute read ids
    nbases: int           # real base count (before padding)
    # memo of the overlap pipeline: device uploads, the A-side index and
    # the reverse-complement twin live as long as the block object
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def nreads(self) -> int:
        return len(self.rlen)

    @property
    def cap(self) -> int:
        return len(self.read_id)


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def capacity_bucket(n: int, quantum: int = 1 << 20) -> int:
    """Round a base count up to the next power-of-two quantum multiple,
    refined to quarters (waste <= 25%)."""
    n = max(n, quantum)
    b = quantum
    while b < n:
        b *= 2
    q = b // 4
    return round_up(n, q)


def build_block(bases: np.ndarray, starts: np.ndarray, ids: np.ndarray,
                cap: int | None = None) -> ReadBlock:
    """Assemble a ReadBlock from concatenated codes + offsets."""
    n = int(starts[-1])
    if cap is None:
        cap = capacity_bucket(n)
    nr = len(starts) - 1
    out = np.full(cap, PAD_BASE, dtype=np.uint8)
    out[:n] = bases[:n]
    rlen = np.diff(starts).astype(np.int32)
    read_id = np.full(cap, nr, dtype=np.int32)
    read_id[:n] = np.repeat(np.arange(nr, dtype=np.int32), rlen)
    return ReadBlock(
        bases=out, starts=starts.astype(np.int32),
        read_id=read_id, rlen=rlen,
        ids=ids.astype(np.int32), nbases=n,
    )


def block_from_db(db, b: int, cap: int | None = None) -> ReadBlock:
    """Block b (1-based) of an open formats.dazzdb.DazzDB: its trimmed
    reads, with their untrimmed DB indices as ids."""
    bases, starts, ids = db.block_seqs(b)
    return build_block(bases, starts, ids, cap=cap)


def block_from_reads(reads: list[np.ndarray], ids: np.ndarray | None = None,
                     cap: int | None = None) -> ReadBlock:
    """Build a block directly from a list of code arrays (tests/sim)."""
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    starts = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    bases = np.concatenate(reads) if reads else np.zeros(0, np.uint8)
    if ids is None:
        ids = np.arange(len(reads))
    return build_block(bases, starts, np.asarray(ids), cap=cap)


def revcomp_block(blk: ReadBlock) -> ReadBlock:
    """Per-read reverse-complemented copy of a block (for the COMP
    orientation pass): read order preserved, each read's bases reversed
    and complemented in place, padding untouched."""
    bases = blk.bases.copy()
    n = blk.nbases
    if n:
        starts = blk.starts.astype(np.int64)
        rid = blk.read_id[:n].astype(np.int64)
        rev_idx = starts[rid] + starts[rid + 1] - 1 - np.arange(n)
        bases[:n] = 3 - blk.bases[rev_idx]
    return ReadBlock(bases=bases, starts=blk.starts, read_id=blk.read_id,
                     rlen=blk.rlen, ids=blk.ids, nbases=blk.nbases)
