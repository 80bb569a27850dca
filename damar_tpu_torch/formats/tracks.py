"""Interval/value track codec (.anno/.data pairs) and track algebra
(numpy only; the same files as damar_tpu.formats.tracks).

Dazzler/MARVEL tracks annotate each read with a variable-length int32
array — interval tracks (dust, tan, rep, trim) hold (beg,end) pairs,
value tracks (q) hold one value per trace segment.  On disk
(upstream db/DB.c Load_Track / MARVEL lib/tracks.c):

  .{root}.{track}.anno : int32 tracklen (= nreads), int32 size (= 8),
                         then (nreads+1) int64 offsets into .data
  .{root}.{track}.data : int32 payload, offsets index BYTES

Track algebra (TKmerge/TKcombine equivalents): per-block tracks merge by
concatenation over read ranges; interval tracks union/intersect/subtract.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from damar_tpu_torch.formats.dazzdb import _root


def track_paths(db_path: str, name: str, block: int | None = None
                ) -> tuple[str, str]:
    d, r = _root(db_path)
    blk = f".{block}" if block else ""
    return (os.path.join(d, f".{r}{blk}.{name}.anno"),
            os.path.join(d, f".{r}{blk}.{name}.data"))


@dataclass
class Track:
    """Per-read variable-length int32 annotation arrays."""
    name: str
    data: list[np.ndarray]  # one int32 array per read (untrimmed index)

    @property
    def nreads(self) -> int:
        return len(self.data)

    def intervals(self, i: int) -> np.ndarray:
        """Read i's annotation as an (n,2) interval array."""
        return self.data[i].reshape(-1, 2)

    def masked_bp(self) -> int:
        return sum(int((iv[1::2] - iv[::2]).sum()) for iv in self.data
                   if len(iv))


def write_track(db_path: str, track: Track, block: int | None = None) -> None:
    anno_p, data_p = track_paths(db_path, track.name, block)
    n = track.nreads
    lens = np.array([len(d) for d in track.data], dtype=np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens * 4, out=offsets[1:])  # byte offsets
    with open(anno_p, "wb") as f:
        f.write(np.int32(n).tobytes())
        f.write(np.int32(8).tobytes())
        f.write(offsets.tobytes())
    with open(data_p, "wb") as f:
        for d in track.data:
            f.write(np.asarray(d, dtype=np.int32).tobytes())


def read_track(db_path: str, name: str, block: int | None = None) -> Track:
    anno_p, data_p = track_paths(db_path, name, block)
    raw = np.fromfile(anno_p, dtype=np.uint8)
    n = int(raw[:4].view("<i4")[0])
    size = int(raw[4:8].view("<i4")[0])
    if size != 8:
        raise ValueError(f"track {name}: unsupported anno size {size}")
    offsets = raw[8:8 + 8 * (n + 1)].view("<i8")
    payload = np.fromfile(data_p, dtype="<i4") if os.path.exists(data_p) \
        else np.zeros(0, np.int32)
    data = [payload[int(offsets[i]) // 4:int(offsets[i + 1]) // 4].copy()
            for i in range(n)]
    return Track(name=name, data=data)


def track_exists(db_path: str, name: str, block: int | None = None) -> bool:
    return os.path.exists(track_paths(db_path, name, block)[0])


# --- algebra ----------------------------------------------------------------

def merge_interval_lists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted interval lists (flat [b0,e0,b1,e1,...])."""
    ivs = np.concatenate([a, b]).reshape(-1, 2)
    if len(ivs) == 0:
        return np.zeros(0, dtype=np.int32)
    ivs = ivs[np.argsort(ivs[:, 0], kind="stable")]
    out = [list(ivs[0])]
    for b0, e0 in ivs[1:]:
        if b0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([b0, e0])
    return np.array(out, dtype=np.int32).reshape(-1)


def intersect_interval_lists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two sorted interval lists (flat pairs)."""
    A, B = a.reshape(-1, 2), b.reshape(-1, 2)
    out = []
    i = j = 0
    while i < len(A) and j < len(B):
        lo = max(A[i, 0], B[j, 0])
        hi = min(A[i, 1], B[j, 1])
        if lo < hi:
            out.append((lo, hi))
        if A[i, 1] < B[j, 1]:
            i += 1
        else:
            j += 1
    return np.array(out, dtype=np.int32).reshape(-1)


def combine_tracks(tracks: list[Track], name: str, mode: str = "union"
                   ) -> Track:
    """TKcombine equivalent: elementwise union/intersection of interval
    tracks over the same read set."""
    n = tracks[0].nreads
    assert all(t.nreads == n for t in tracks)
    op = merge_interval_lists if mode == "union" else intersect_interval_lists
    data = []
    for i in range(n):
        acc = tracks[0].data[i]
        for t in tracks[1:]:
            acc = op(acc, t.data[i])
        data.append(acc)
    return Track(name=name, data=data)


def merge_block_tracks(db_path: str, name: str, nblocks: int,
                       block_ranges: list[tuple[int, int]], nreads: int
                       ) -> Track:
    """TKmerge equivalent: assemble per-block tracks (each covering its
    untrimmed read range) into one DB-wide track and write it."""
    data: list[np.ndarray] = [np.zeros(0, np.int32)] * nreads
    for b in range(1, nblocks + 1):
        t = read_track(db_path, name, block=b)
        lo, hi = block_ranges[b - 1]
        assert t.nreads == hi - lo, \
            f"block {b} track has {t.nreads} reads, range is {hi - lo}"
        for j in range(t.nreads):
            data[lo + j] = t.data[j]
    track = Track(name=name, data=data)
    write_track(db_path, track)
    return track


def clip_intervals_to_len(iv: np.ndarray, rlen: int) -> np.ndarray:
    """Clip a flat interval list to [0, rlen), dropping empties."""
    p = iv.reshape(-1, 2).astype(np.int64)
    p[:, 0] = np.clip(p[:, 0], 0, rlen)
    p[:, 1] = np.clip(p[:, 1], 0, rlen)
    p = p[p[:, 1] > p[:, 0]]
    return p.astype(np.int32).reshape(-1)
