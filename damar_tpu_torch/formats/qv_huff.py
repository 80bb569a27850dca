"""Huffman QV codec, the port of damar_tpu.formats.qv_huff (the QV.c
coding family: per-stream canonical Huffman over byte symbols with
run-length coding of the dominant deletion-QV symbol, scheme tables in
the file header), host numpy as there; the same bytes.

One Huffman scheme per stream is built over the whole DB, the
most-frequent delQV symbol is run-length coded, and each read is one
block per stream:

  header:  u32 magic 'DQH1'; u8 nstreams=5; u8 rle_stream (index of
           the RLE'd stream or 255); u8 rle_sym; u8 pad
           per stream: u8[256] code lengths (canonical Huffman; all
           zero = raw bytes / empty)
  reads:   u32 nreads; per read: u32 rlen;
           per stream: u32 nbits (0xFFFFFFFF = absent);
           ceil(nbits/8) bytes

Decode tables are rebuilt from the code lengths exactly as encode built
them (canonical order: length-major, symbol-minor), so encode -> decode
round-trips bit-exactly.
"""
from __future__ import annotations

import heapq

import numpy as np

MAGIC = 0x31485144  # 'DQH1' little-endian
STREAMS = ("del_qv", "del_char", "ins_qv", "mrg_qv", "sub_qv")
RLE_STREAM = 0          # delQV: dominant symbol is run-length coded
MAX_CODE_LEN = 15


def _histogram(chunks: list[np.ndarray]) -> np.ndarray:
    h = np.zeros(256, np.int64)
    for c in chunks:
        if len(c):
            h += np.bincount(c, minlength=256)
    return h


def _code_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths (package-merge-free: plain Huffman tree,
    then lengths clamped by rebuilding with flattened frequencies if
    any exceeds MAX_CODE_LEN — rare for byte streams)."""
    sym = np.nonzero(freq)[0]
    if len(sym) == 0:
        return np.zeros(256, np.uint8)
    if len(sym) == 1:
        out = np.zeros(256, np.uint8)
        out[sym[0]] = 1
        return out
    f = freq.astype(np.float64)
    for _ in range(32):
        # Huffman merge carrying per-symbol depths
        heap = [(float(f[s]), int(s), {int(s): 0}) for s in sym]
        heapq.heapify(heap)
        cnt = 256
        while len(heap) > 1:
            fa, _, da = heapq.heappop(heap)
            fb, _, db = heapq.heappop(heap)
            merged = {k: v + 1 for k, v in da.items()}
            merged.update({k: v + 1 for k, v in db.items()})
            heapq.heappush(heap, (fa + fb, cnt, merged))
            cnt += 1
        depth = np.zeros(256, np.uint8)
        for s, d in heap[0][2].items():
            depth[s] = max(d, 1)
        if depth.max() <= MAX_CODE_LEN:
            return depth
        f = np.ceil(f / 2)          # flatten and retry
        f[sym] = np.maximum(f[sym], 1)
    raise ValueError("could not bound Huffman code lengths")


def _canonical_codes(lengths: np.ndarray):
    """(codes u32[256], lengths) in canonical order: shorter codes
    first, ties by symbol value."""
    codes = np.zeros(256, np.uint32)
    order = sorted((int(l), s) for s, l in enumerate(lengths) if l)
    code = 0
    prev_len = 0
    for l, s in order:
        code <<= (l - prev_len)
        codes[s] = code
        code += 1
        prev_len = l
    return codes


def _bit_pack(symbols: np.ndarray, codes: np.ndarray,
              lengths: np.ndarray) -> tuple[bytes, int]:
    """Vectorized MSB-first bit packing of a symbol stream."""
    if len(symbols) == 0:
        return b"", 0
    ls = lengths[symbols].astype(np.int64)
    cs = codes[symbols].astype(np.int64)
    ends = np.cumsum(ls)
    nbits = int(ends[-1])
    starts = ends - ls
    # expand each code's bits (MSB first): symbol i's bits land at
    # starts[i]..ends[i]-1, which tile the output contiguously
    total = nbits
    j = np.arange(total) - np.repeat(starts, ls)
    shift = np.repeat(ls, ls) - 1 - j
    bits = (np.repeat(cs, ls) >> shift) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes(), nbits


def _rle_encode(v: np.ndarray, sym: int) -> np.ndarray:
    """Replace runs of `sym` with (sym, runlen-1) pairs; run lengths
    cap at 255 (longer runs split).  Output is a byte stream whose
    Huffman coding includes the length bytes."""
    if len(v) == 0:
        return v
    out = []
    i = 0
    n = len(v)
    is_s = v == sym
    while i < n:
        if is_s[i]:
            j = i
            while j < n and is_s[j] and j - i < 255:
                j += 1
            out.append(np.array([sym, j - i - 1], np.uint8))
            i = j
        else:
            j = i
            while j < n and not is_s[j]:
                j += 1
            out.append(v[i:j])
            i = j
    return np.concatenate(out)


def _rle_decode(v: np.ndarray, sym: int, rlen: int) -> np.ndarray:
    out = np.empty(rlen, np.uint8)
    i = 0
    k = 0
    n = len(v)
    while i < n and k < rlen:
        c = v[i]
        if c == sym:
            run = int(v[i + 1]) + 1
            out[k:k + run] = sym
            k += run
            i += 2
        else:
            out[k] = c
            k += 1
            i += 1
    if k != rlen:
        raise ValueError("RLE stream length mismatch")
    return out


def encode_qvs(reads_streams: list[dict]) -> bytes:
    """Encode per-read stream dicts (see formats.qv.STREAMS) into the
    DQH1 byte layout: one Huffman scheme per stream over the whole
    set (QV.c samples the DB the same way), delQV RLE'd on its modal
    symbol."""
    # choose the RLE symbol = modal delQV byte
    del_hist = _histogram([st.get(STREAMS[RLE_STREAM], np.zeros(0, np.uint8))
                           for st in reads_streams])
    rle_sym = int(del_hist.argmax()) if del_hist.sum() else 255
    # transform + histogram per stream
    transformed: list[list[np.ndarray]] = [[] for _ in STREAMS]
    for st in reads_streams:
        for si, name in enumerate(STREAMS):
            v = np.asarray(st.get(name, np.zeros(0, np.uint8)), np.uint8)
            if si == RLE_STREAM and len(v):
                v = _rle_encode(v, rle_sym)
            transformed[si].append(v)
    schemes = []
    for si in range(len(STREAMS)):
        freq = _histogram(transformed[si])
        lengths = _code_lengths(freq)
        schemes.append((lengths, _canonical_codes(lengths)))
    parts = [np.uint32(MAGIC).tobytes(),
             bytes([len(STREAMS), RLE_STREAM if del_hist.sum() else 255,
                    rle_sym & 0xFF, 0])]
    for lengths, _ in schemes:
        parts.append(lengths.astype(np.uint8).tobytes())
    parts.append(np.uint32(len(reads_streams)).tobytes())
    for ri, st in enumerate(reads_streams):
        rlen = max((len(np.asarray(v)) for v in st.values()), default=0)
        parts.append(np.uint32(rlen).tobytes())
        for si, name in enumerate(STREAMS):
            v = transformed[si][ri]
            if len(v) == 0 and name not in st:
                parts.append(np.uint32(0xFFFFFFFF).tobytes())
                continue
            lengths, codes = schemes[si]
            blob, nbits = _bit_pack(v, codes, lengths)
            parts.append(np.uint32(nbits).tobytes())
            parts.append(blob)
    return b"".join(parts)


def decode_qvs(raw: bytes) -> list[dict]:
    pos = 0

    def u32():
        nonlocal pos
        v = int(np.frombuffer(raw, "<u4", 1, pos)[0])
        pos += 4
        return v

    if u32() != MAGIC:
        raise ValueError("not a DQH1 stream")
    ns, rle_stream, rle_sym, _ = raw[pos:pos + 4]
    pos += 4
    assert ns == len(STREAMS)
    schemes = []
    for _ in range(ns):
        lengths = np.frombuffer(raw, np.uint8, 256, pos).copy()
        pos += 256
        schemes.append(lengths)
    n = u32()
    out = []
    for _ in range(n):
        rlen = u32()
        st = {}
        for si, name in enumerate(STREAMS):
            nbits = u32()
            if nbits == 0xFFFFFFFF:
                continue
            nbytes = (nbits + 7) // 8
            blob = raw[pos:pos + nbytes]
            pos += nbytes
            # symbol count: walk bits (unknown upfront for RLE'd
            # streams) — decode by bit budget
            v = _decode_by_bits(blob, nbits, schemes[si])
            if si == rle_stream:
                v = _rle_decode(v, rle_sym, rlen)
            st[name] = v
        out.append(st)
    return out


def _decode_by_bits(blob: bytes, nbits: int,
                    lengths: np.ndarray) -> np.ndarray:
    """Decode symbols until the bit budget is exhausted."""
    if nbits == 0:
        return np.zeros(0, np.uint8)
    bits = np.unpackbits(np.frombuffer(blob, np.uint8))[:nbits]
    order = sorted((int(l), s) for s, l in enumerate(lengths) if l)
    syms_by_len: dict[int, list[int]] = {}
    for l, s in order:
        syms_by_len.setdefault(l, []).append(s)
    first_code = {}
    code = 0
    prev_len = 0
    for l in sorted(syms_by_len):
        code <<= (l - prev_len)
        first_code[l] = code
        code += len(syms_by_len[l])
        prev_len = l
    out = []
    pos = 0
    while pos < nbits:
        acc = 0
        for l in range(1, MAX_CODE_LEN + 1):
            acc = (acc << 1) | int(bits[pos])
            pos += 1
            if l in syms_by_len:
                fc = first_code[l]
                idx = acc - fc
                if 0 <= idx < len(syms_by_len[l]):
                    out.append(syms_by_len[l][idx])
                    break
        else:
            raise ValueError("invalid Huffman stream")
    return np.array(out, np.uint8)
