"""Minimal FASTA/FASTQ reader and writer (numpy only; the same records
and bytes as damar_tpu.formats.fasta).

Reads arbitrary-width FASTA (optionally gzipped); sequences are returned
as numpy uint8 arrays of 2-bit base codes (a=0, c=1, g=2, t=3).
Non-ACGT characters are mapped to 'a' (code 0), matching the lineage's
behavior of packing unknowns into the 2-bit alphabet.
"""
from __future__ import annotations

import gzip
import io
from typing import Iterator

import numpy as np

# ASCII -> 2-bit code lookup; unknowns -> 0.
_CODE = np.zeros(256, dtype=np.uint8)
for _ch, _v in (("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _CODE[ord(_ch)] = _v
    _CODE[ord(_ch.upper())] = _v

_BASE = np.frombuffer(b"acgt", dtype=np.uint8)


def encode_seq(s: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..3)."""
    if isinstance(s, str):
        s = s.encode()
    return _CODE[np.frombuffer(s, dtype=np.uint8)]


def decode_seq(codes: np.ndarray, upper: bool = False) -> str:
    """uint8 codes (0..3) -> ASCII sequence."""
    s = _BASE[codes].tobytes().decode()
    return s.upper() if upper else s


def _open(path: str):
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def iter_fasta(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (header, codes) per record. Header excludes '>' and newline."""
    header = None
    chunks: list[str] = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    yield header, encode_seq("".join(chunks))
                header = line[1:]
                chunks = []
            else:
                chunks.append(line)
        if header is not None:
            yield header, encode_seq("".join(chunks))


def read_fasta(path: str) -> tuple[list[str], list[np.ndarray]]:
    headers, seqs = [], []
    for h, s in iter_fasta(path):
        headers.append(h)
        seqs.append(s)
    return headers, seqs


def write_fasta(path: str, headers: list[str], seqs: list[np.ndarray],
                width: int = 80) -> None:
    with open(path, "w") as f:
        for h, s in zip(headers, seqs):
            f.write(f">{h}\n")
            txt = decode_seq(np.asarray(s, dtype=np.uint8))
            for i in range(0, len(txt), width):
                f.write(txt[i:i + width] + "\n")


def iter_fastq(path: str):
    """Yield (header, codes, qual_u8) per FASTQ record (phred+33)."""
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            seq = f.readline().rstrip()
            f.readline()                      # '+'
            q = f.readline().rstrip()
            yield (h.rstrip()[1:], encode_seq(seq),
                   np.frombuffer(q.encode(), dtype=np.uint8) - 33)


def read_fastq(path: str):
    hs, ss, qs = [], [], []
    for h, s_, q in iter_fastq(path):
        hs.append(h)
        ss.append(s_)
        qs.append(q)
    return hs, ss, qs


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in 2-bit code space (complement = 3 - code)."""
    return (3 - codes[::-1]).astype(np.uint8)
