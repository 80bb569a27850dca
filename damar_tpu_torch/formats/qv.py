"""Quality-value storage (.qvs), the port of damar_tpu.formats.qv (the
lineage's QV codec, db/QV.c), host numpy as there; the same bytes.

Five per-read streams (deletion QV, deletion char, insertion QV, merge
QV, substitution QV) are written in the Huffman layout of
formats.qv_huff (DQH1: canonical-Huffman tables in the header, delQV
run-length coded); the round-1 zlib container (DQV1) is still read.  The
assembly pipeline never reads QVs (LAq derives quality from the piles),
so the codec is an interchange surface; plain FASTQ qualities land in
the insertion-QV stream.

Legacy DQV1 layout (.{root}.qvs):
  int32 magic 'DQV1'; int32 nreads;
  per read: int32 rlen; 5 x (int32 comp_len; bytes zlib-stream)
  (empty streams have comp_len 0)
"""
from __future__ import annotations

import os
import zlib

import numpy as np

from damar_tpu_torch.formats.dazzdb import _root

MAGIC = 0x31565144  # 'DQV1' little-endian

STREAMS = ("del_qv", "del_char", "ins_qv", "mrg_qv", "sub_qv")


def qvs_path(db_path: str) -> str:
    d, r = _root(db_path)
    return os.path.join(d, "." + r + ".qvs")


def write_qvs(db_path: str, reads_streams: list[dict]) -> None:
    """reads_streams[i]: dict stream-name -> uint8 array (may be
    missing/empty); plain FASTQ qualities go under 'ins_qv'.  Written
    in the QV.c-family Huffman layout (formats.qv_huff)."""
    from damar_tpu_torch.formats.qv_huff import encode_qvs
    with open(qvs_path(db_path), "wb") as f:
        f.write(encode_qvs(reads_streams))


def read_qvs(db_path: str) -> list[dict]:
    raw = open(qvs_path(db_path), "rb").read()
    magic = int(np.frombuffer(raw, "<i4", 1, 0)[0])
    if magic != MAGIC:
        from damar_tpu_torch.formats.qv_huff import MAGIC as HMAGIC, decode_qvs
        if magic == HMAGIC:
            return decode_qvs(raw)
        raise ValueError("not a .qvs file (unknown magic)")
    pos = 4

    def i32():
        nonlocal pos
        v = int(np.frombuffer(raw, "<i4", 1, pos)[0])
        pos += 4
        return v

    n = i32()
    out = []
    for _ in range(n):
        rlen = i32()
        st = {}
        for name in STREAMS:
            clen = i32()
            if clen:
                st[name] = np.frombuffer(
                    zlib.decompress(raw[pos:pos + clen]), np.uint8).copy()
                pos += clen
        out.append(st)
    return out


def fastq_to_qvs(db_path: str, quals: list[np.ndarray]) -> None:
    """Store plain FASTQ qualities (phred+33 already stripped) as the
    insertion-QV stream, the slot the lineage reads FASTQ quality
    into."""
    write_qvs(db_path, [{"ins_qv": q} for q in quals])
