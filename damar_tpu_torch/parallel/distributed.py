"""Distributed overlap: A-blocks resident, B-blocks passed around a ring.

Torch port of damar_tpu/parallel/distributed.py.  One rank per device
(torch.distributed, one process each) holds its A-blocks resident while
the B-blocks travel a ring of point-to-point sends, so every (A, B)
block pair meets on some rank after D rotations of a D-rank ring.  A
rotating block carries its canonical k-mer index (codes and packed
payloads) with its bases, read ordinals and read starts, so each
block's index is built once, by the rank that owns it.  Seeding is the
pair path's canonical seeding (ops.seeding.find_seeds_canonical_dev,
given both indexes); extension and trace are the pair path's
extend_bidir and trace_launch (the bit-parallel kernels K1 and K2,
their plain versions for CPU tensors), over pools of a rank's blocks.

Two ring programs cover the overlap:
  1. the seed and extend ring (ring_overlap_step): per rotation, the
     extents of the resident pair with their diffs;
  2. the trace ring (ring_trace_step): the B-blocks again past the
     deduped extents, trace points per record.
Between and after them, host numpy on each rank over its own A-blocks:
the columnar dedupe, the trace checks, the wide-band retry of failed
records (K3, the pair path's retry helper) and the .las columns.

With more blocks than ranks, the block matrix is covered by ceil(n/D)^2
sweeps of a super-row of A-blocks against a super-row of B-blocks
(padded with empty blocks): rank d owns blocks r*D + d of every super
row r, and at rotation j of sweep (ra, rb) it holds B-block
rb*D + (d - j) % D.

Every decision that more than one rank takes (a grow-retry, which
sweeps to run, a raise) comes from data all ranks hold after an
all-reduce over a gloo group, so no rank waits on a send another rank
skipped.  Under NCCL each rank needs a card of its own; under gloo,
CUDA tensors go through host memory (ranks may share one card).  The
module also keeps the job-matrix helpers of a multi-host sweep and the
launcher contract that gives a host its index.
"""
from __future__ import annotations

import datetime
import json
import os
import shutil
import socket
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.formats.las import LasColumns, LasFile, write_las
from damar_tpu_torch.ops.seeding import (build_index_canonical_packed,
                                         find_seeds_canonical_dev,
                                         packed_payload_base)
from damar_tpu_torch.ops.words import pack_bases
from damar_tpu_torch.pipeline.overlap import (SEED_CAP_START,
                                              TRACE_BUF_BYTES,
                                              dedupe_extents, extend_bidir,
                                              grow_seeds, las_columns,
                                              release_device_buffers,
                                              trace_harvest_all,
                                              trace_launch, wide_retry)

EXT_COLS = 8  # aread, bread, comp, abpos, aepos, bbpos, bepos, diffs
# the reference's grow ladder: doublings of an explicit cap
GROW_STEPS = 5
# the most bases one pool of a K1 or K2 launch holds (the A-blocks', or
# the B-blocks' in both orientations): the kernels take int32 positions
# into it.  A super-row meeting more launches more often.
RING_POOL_BYTES = (1 << 31) - 1


# --- the ring ---------------------------------------------------------------

@dataclass(frozen=True)
class Ring:
    """A ring of `size` ranks over a process group (None: one rank, no
    collective).  right/left: the global ranks of the neighbours this
    rank sends to and receives from; meta: a gloo group for host-side
    collectives (the group itself under gloo)."""
    rank: int
    size: int
    device: torch.device
    group: object = None
    meta: object = None
    backend: str | None = None
    right: int = 0
    left: int = 0

    @property
    def staged(self) -> bool:
        """CUDA tensors under gloo go through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _default_device(rank: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the ring runs on CUDA devices and none is "
                           "available: pass device='cpu' to run the plain "
                           "kernel versions")
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else rank
    return torch.device("cuda", idx % torch.cuda.device_count())


def check_devices(backend: str, places: list) -> None:
    """Raise when NCCL is asked for two ranks on one card.  places: per
    rank (host name, device type, device index)."""
    if backend != "nccl":
        return
    seen: dict = {}
    for r, p in enumerate(places):
        if p[1] != "cuda":
            raise ValueError(f"NCCL needs a CUDA device: rank {r} is on "
                             f"{p[1]}")
        if p in seen:
            raise ValueError(
                f"NCCL cannot run two ranks on one card: ranks {seen[p]} "
                f"and {r} are both on {p[0]} cuda:{p[2]}; give each rank "
                f"its own card, or use the gloo backend (blocks staged "
                f"through host memory)")
        seen[p] = r


def make_mesh(group=None, *, device=None, meta=None) -> Ring:
    """The ring of a process group: this rank, the world size and the
    device (the counterpart of damar_tpu make_mesh).  group None: a ring
    of one rank.  device None: a CUDA device (LOCAL_RANK's, else the
    rank's modulo the cards), which must exist; device="cpu" runs the
    plain kernel versions (gloo only).  A CUDA device becomes this
    thread's current device: the kernels launch on the current one.

    meta: a gloo group over the same ranks for the host-side
    collectives.  Under gloo it is the group itself.  Under NCCL it is
    made here for the world group; for a smaller group, pass one that
    every rank of the world created (dist.new_group is collective over
    the world), else this raises."""
    if group is None:
        rank, size, backend = 0, 1, None
    else:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        backend = str(dist.get_backend(group))
        if backend == "gloo":
            meta = group
        elif meta is None and size != dist.get_world_size():
            raise ValueError(
                f"a {backend} ring over {size} of the world's "
                f"{dist.get_world_size()} ranks needs meta=, a gloo group "
                f"over its ranks that every rank of the world created")
    dev = (_default_device(rank) if device is None
           else torch.device(device))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if group is None:
        return Ring(0, 1, dev)
    if meta is None:
        meta = dist.new_group(dist.get_process_group_ranks(group),
                              backend="gloo")
    places: list = [None] * size
    dist.all_gather_object(places, (socket.gethostname(), dev.type,
                                    dev.index), group=meta)
    check_devices(backend, places)
    glob = dist.get_process_group_ranks(group)
    return Ring(rank, size, dev, group, meta, backend,
                right=glob[(rank + 1) % size], left=glob[(rank - 1) % size])


def _rotate(ring: Ring, tensors: list) -> list:
    """Send `tensors` to the right neighbour and receive the left one's
    (same shapes and dtypes) with one batch of point-to-point ops."""
    if ring.size == 1:
        return list(tensors)
    send = [t.cpu() if ring.staged else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = ([dist.P2POp(dist.isend, t, ring.right, ring.group) for t in send]
           + [dist.P2POp(dist.irecv, t, ring.left, ring.group)
              for t in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [t.to(ring.device) for t in recv] if ring.staged else recv


def _sum_ranks(ring: Ring, arr: np.ndarray) -> np.ndarray:
    """Elementwise sum of an int64 array over the ring's ranks (each
    rank fills its own entries, zeros elsewhere)."""
    if ring.size == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64))
    dist.all_reduce(t, group=ring.meta)
    return t.numpy()


# --- blocks on the ring -----------------------------------------------------

def payload_widths(blocks: list) -> tuple[int, int]:
    """Common packed-payload field widths of a set of blocks (every
    rotation decodes every block's payload with them).  Raises when
    rid + rpos + strand exceed 32 bits: split the DB into smaller
    blocks."""
    nr = max(max((b.nreads for b in blocks), default=1), 1)
    ml = max(max((int(b.rlen.max()) for b in blocks if b.nreads),
                 default=1), 1)
    rid_bits = max(int(nr).bit_length(), 1)
    rpos_bits = max(int(ml).bit_length(), 1)
    if rid_bits + rpos_bits + 1 > 32:
        raise ValueError(
            f"packed seed payload needs {rid_bits}+{rpos_bits}+1 bits "
            "> 32; split the DB into smaller blocks")
    return rid_bits, rpos_bits


def _empty_block(cap: int):
    return block_from_reads([], ids=np.zeros(0, np.int64), cap=cap)


def _pad_blocks(blocks: list, D: int) -> list:
    """blocks padded with empty blocks of their cap to a multiple of D."""
    k = -(-len(blocks) // D)
    return list(blocks) + [_empty_block(blocks[0].cap)
                           for _ in range(k * D - len(blocks))]


def shard_blocks(ring: Ring, blocks: list, cfg,
                 widths: tuple[int, int] | None = None) -> dict:
    """This rank's blocks on its device (the counterpart of damar_tpu
    shard_blocks): {b: [bases, read_id, starts, codes, payloads]} for
    every block index b = r*D + rank of the padded list.  Blocks must
    share one cap; starts are padded to the most reads of any block + 1
    (so every rotating block has the same shapes), and a block in both
    orientations must fit one pool (RING_POOL_BYTES); codes and payloads
    are the block's canonical k-mer index with the common payload
    widths."""
    cap = blocks[0].cap
    if any(b.cap != cap for b in blocks):
        raise ValueError("the ring's blocks must share one capacity: "
                         f"{sorted({b.cap for b in blocks})}")
    if 2 * cap > RING_POOL_BYTES:
        raise ValueError(f"a block of {cap} bases in both orientations "
                         f"passes the ring's pool of {RING_POOL_BYTES}: "
                         f"split the DB into smaller blocks")
    padded = _pad_blocks(blocks, ring.size)
    rid_bits, rpos_bits = widths or payload_widths(padded)
    nr = max(max(b.nreads for b in padded), 1)
    dev = ring.device
    out = {}
    for b in range(ring.rank, len(padded), ring.size):
        blk = padded[b]
        starts = np.empty(nr + 1, np.int64)
        s = blk.starts.astype(np.int64)
        starts[:len(s)] = s
        starts[len(s):] = s[-1]
        bases = torch.as_tensor(blk.bases, device=dev)
        rid = torch.as_tensor(blk.read_id, device=dev)
        mpb = packed_payload_base(blk.read_id, blk.starts, blk.nreads, cap,
                                  rid_bits, rpos_bits)
        codes, mp = build_index_canonical_packed(
            bases, rid, torch.as_tensor(mpb.astype(np.int64), device=dev),
            cfg.kmer)
        out[b] = [bases, rid, torch.as_tensor(starts, device=dev), codes, mp]
    return out


def _revcomp_device(bases, read_id, starts):
    """Per-read reverse complement of a padded block on its device: the
    complement of position p of read r goes to starts[r] + starts[r+1] -
    1 - p (read layout kept, padding untouched)."""
    n = bases.shape[0]
    p = torch.arange(n, device=bases.device)
    r = read_id.to(torch.int64).clamp(0, starts.shape[0] - 2)
    lo, hi = starts[r], starts[r + 1]
    src = (lo + hi - 1 - p).clamp(0, n - 1)
    inside = (p >= lo) & (p < hi)
    return torch.where(inside, 3 - bases[src].to(torch.int64),
                       bases.to(torch.int64)).to(bases.dtype)


# --- ring program 1: seed and extend ----------------------------------------

class _Pool:
    """Blocks' bases one after another in one pool, for one kernel
    launch over extents of many pairs (each pair's A and B read at their
    offsets).  K1 and K2 mask every B char outside an extent's read and
    score no row past its A read, so the neighbours in a pool change no
    result."""

    def __init__(self):
        self.parts: list = []
        self.size = 0
        self.at: dict = {}

    def add(self, key, make) -> list:
        """The offsets of the tensors make() returns under `key`,
        appended on the key's first use."""
        if key not in self.at:
            offs = []
            for t in make():
                offs.append(self.size)
                self.parts.append(t)
                self.size += t.shape[0]
            self.at[key] = offs
        return self.at[key]

    def fits(self, key, size: int) -> bool:
        """Whether `size` more bases under `key` stay within
        RING_POOL_BYTES."""
        return key in self.at or self.size + size <= RING_POOL_BYTES

    def words(self):
        return pack_bases(torch.cat(self.parts))


def _both_strands(b: list) -> list:
    return [b[0], _revcomp_device(b[0], b[1], b[2])]


class _Batch:
    """A rank's pending work for one kernel launch over pools of its
    A-blocks and B-blocks (B in both orientations, the reverse
    complement made on the device).  Before a pair's blocks join the
    pools, the pending work is launched when either pool would pass
    RING_POOL_BYTES; the rest is launched by flush()."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.out: dict = {}
        self._reset()

    def _reset(self):
        self.apool, self.bpool = _Pool(), _Pool()
        self.pend: list = []

    def _offsets(self, key, a: list, b: list) -> tuple:
        """(A's offset, B's [forward, reverse] offsets) in the pools."""
        na, nb = a[0].shape[0], 2 * b[0].shape[0]
        if not (self.apool.fits(key[0], na) and self.bpool.fits(key[1], nb)):
            self.flush()
        return (self.apool.add(key[0], lambda: [a[0]])[0],
                self.bpool.add(key[1], lambda: _both_strands(b)))

    def flush(self) -> None:
        raise NotImplementedError


def _seed_pair(blk_a, blk_b, a, b, cfg, *, seed_cap: int | None,
               hit_cap: int | None, widths: tuple, self_rot: bool) -> dict:
    """Canonical both-orientation seeding of one resident pair (the
    pair path's, with both indexes given: A's resident, B's received).
    seed_cap None: from the pair path's first seed buffer, grown to the
    banding's total by one more run (grow_seeds)."""
    tag = ("packed",) + tuple(widths)
    run = lambda kw: find_seeds_canonical_dev(  # noqa: E731
        blk_a, blk_b, cfg, upper_only=False, a_index=(tag, (a[3], a[4])),
        b_index=(tag, (b[3], b[4])), dev_arrays=(a[0], a[1], b[0], b[1]),
        starts=(a[2], b[2]), suppress_equal=self_rot, **kw)
    # an explicit seed_cap is the reference's fixed buffer: no growth
    return grow_seeds(run, dict(
        hit_cap=hit_cap,
        seed_cap=SEED_CAP_START if seed_cap is None else seed_cap),
        hit_cap, seed_cap)[0]


class _ExtendBatch(_Batch):
    """K1's work on one rank: the seeds of every pair it met since the
    last launch, extended by extend_bidir (one launch per phase) over
    the pools.  `out` collects {(i, j): (ext, counts)} as the
    reference's local_pair gives them: ext [rows, 8] int32 over the
    pair's seed slots (rows: an explicit seed_cap, else its seeds), -1
    where a seed's extension is shorter than min_len; counts (nseeds,
    ok_n, total_hits)."""

    def __init__(self, cfg, seed_cap: int | None):
        super().__init__(cfg)
        self.seed_cap = seed_cap

    def add(self, key, sd: dict, a: list, b: list) -> None:
        n = sd["nseeds"]
        rows = self.seed_cap if self.seed_cap is not None else n
        if n == 0:
            self.out[key] = (np.full((rows, EXT_COLS), -1, np.int32),
                             (0, 0, int(sd["total_hits"])))
            return
        aoff, boff = self._offsets(key, a, b)
        ar, br = sd["aread"][:n], sd["bread"][:n]
        comp = sd["comp"][:n]
        sap = sd["apos"][:n].clamp(min=0)
        sbp = sd["bpos"][:n].clamp(min=0)
        a0, b0 = a[2][ar], b[2][br]
        self.pend.append(dict(
            key=key, n=n, rows=rows, hits=int(sd["total_hits"]), ar=ar,
            br=br, comp=comp, aorg=sap + aoff,
            borg=sbp + torch.where(comp == 1, boff[1], boff[0]),
            ap_l=sap - a0, bp_l=sbp - b0, alen=a[2][ar + 1] - a0,
            blen=b[2][br + 1] - b0))

    def flush(self) -> None:
        if not self.pend:
            return
        cfg, pend = self.cfg, self.pend
        cat = {k: torch.cat([p[k] for p in pend]) for k in (
            "ar", "br", "comp", "aorg", "borg", "ap_l", "bp_l", "alen",
            "blen")}
        e = extend_bidir(self.apool.words(), self.bpool.words(),
                         *(cat[k] for k in ("aorg", "borg", "ap_l", "bp_l",
                                            "alen", "blen")), cfg)
        rec = torch.cat([torch.stack([cat["ar"], cat["br"], cat["comp"]]),
                         e]).T
        rec = torch.where(((e[1] - e[0]) >= cfg.min_len)[:, None], rec, -1)
        rec = rec.cpu().numpy().astype(np.int32)
        at = 0
        for p in pend:
            ext = np.full((p["rows"], EXT_COLS), -1, np.int32)
            ext[:p["n"]] = rec[at:at + p["n"]]
            at += p["n"]
            self.out[p["key"]] = (ext, (p["n"], int((ext[:, 0] >= 0).sum()),
                                        p["hits"]))
        self._reset()


def ring_overlap_step(ring: Ring, cfg, blocks: list, shards: dict,
                      ra: int, rb: int, batch: _ExtendBatch, *,
                      seed_cap: int | None, hit_cap: int | None,
                      widths: tuple) -> None:
    """One sweep of super-row ra of A-blocks against super-row rb of
    B-blocks on this rank: its A-block ra*D + rank stays, the B-blocks
    (bases, read ordinals, starts, codes, payloads) rotate D times, sent
    right and received from the left; the rotation that pairs a block
    with itself (ra == rb, rotation 0) drops a read against itself, with
    upper_only off.  No send follows the last rotation.  Each real
    pair's seeds go to `batch` (padding blocks compute nothing but
    still travel)."""
    D, d, n = ring.size, ring.rank, len(blocks)
    i = ra * D + d
    b = shards[rb * D + d]
    for j in range(D):
        bblk = rb * D + (d - j) % D
        if i < n and bblk < n:
            sd = _seed_pair(blocks[i], blocks[bblk], shards[i], b, cfg,
                            seed_cap=seed_cap, hit_cap=hit_cap,
                            widths=widths, self_rot=(ra == rb and j == 0))
            batch.add((i, bblk), sd, shards[i], b)
        if j < D - 1:
            b = _rotate(ring, b)


def distributed_overlap(blocks: list, cfg, ring: Ring | None = None,
                        seed_cap: int | None = None,
                        hit_cap: int | None = None,
                        pairs: "set[tuple[int, int]] | None" = None,
                        timings: dict | None = None, *, device=None,
                        _shards: dict | None = None):
    """All-vs-all overlap of the blocks over the ring: ceil(n/D)^2
    sweeps.  ring None: a ring of one rank on `device` (None: a CUDA
    device, which must exist).  Returns (exts, counts, total): exts
    {(i, j): ext} for this rank's A-blocks i (0-based) against every
    block j, ext the [rows, 8] extent rows (aread, bread, comp, abpos,
    aepos, bbpos, bepos, diffs; -1 marks an empty slot), rows the seed
    buffer (seed_cap when given, as the reference's, else the pair's
    seeds); counts [n, n, 3] (seeds, extents, total_hits) of every pair
    on every rank; total their sum.

    seed_cap/hit_cap None size each pair's buffers from its own counts,
    so nothing is truncated; explicit caps are the reference's fixed
    buffers (seeds >= seed_cap or total_hits > hit_cap: a pair to run
    again bigger).  pairs: the (super-row, super-col) sweeps to run
    (None: all).  K1 runs once on each rank over the seeds of all its
    pairs (more often only when the pooled blocks pass
    RING_POOL_BYTES).
    timings: adds "overlap_ring" seconds."""
    ring = ring or make_mesh(device=device)
    n, D = len(blocks), ring.size
    k = -(-n // D)
    widths = payload_widths(_pad_blocks(blocks, D))
    shards = _shards if _shards is not None else shard_blocks(
        ring, blocks, cfg, widths)
    t0 = time.time()
    exts: dict = {}
    counts = np.zeros((n, n, 3), np.int64)
    batch = _ExtendBatch(cfg, seed_cap)
    for ra in range(k):
        for rb in range(k):
            if pairs is None or (ra, rb) in pairs:
                ring_overlap_step(ring, cfg, blocks, shards, ra, rb, batch,
                                  seed_cap=seed_cap, hit_cap=hit_cap,
                                  widths=widths)
    batch.flush()
    for key, (e, c) in batch.out.items():
        exts[key] = e
        counts[key] = c
    counts = _sum_ranks(ring, counts)
    if timings is not None:
        timings["overlap_ring"] = (timings.get("overlap_ring", 0.0)
                                   + time.time() - t0)
    return exts, counts, counts.sum((0, 1))


# --- host: the columnar dedupe ----------------------------------------------

def dedupe_keys(ii: np.ndarray, jj: np.ndarray, rows: np.ndarray):
    """int64 keys of the columnar dedupe: (A-block, aread) and (B-block,
    comp, bread), ordered as the tuples are, for block indexes below
    2^30 and read ordinals below 2^32.  (The reference packs them into
    int32, which wraps from B-block 1,024 on: fault 3m.)"""
    a_key = (ii.astype(np.int64) << 32) | rows[:, 0].astype(np.int64)
    b_key = ((jj.astype(np.int64) << 33) | (rows[:, 2].astype(np.int64)
                                            << 32)
             | rows[:, 1].astype(np.int64))
    return a_key, b_key


def split_keys(a_key: np.ndarray, b_key: np.ndarray):
    """(i, aread, j, comp, bread) of dedupe_keys' keys."""
    m = 0xFFFFFFFF
    return a_key >> 32, a_key & m, b_key >> 33, (b_key >> 32) & 1, b_key & m


def _dedupe(exts: dict, n: int, cfg) -> dict:
    """One columnar dedupe over this rank's extent rows: groups by (A
    block, aread, B block, comp, bread), kept rows per pair in the
    reference's order.  Returns {(i, j): rows [m, 8] int32}."""
    parts_i, parts_j, parts_r = [], [], []
    for (i, j) in sorted(exts):
        e = exts[(i, j)]
        e = e[e[:, 0] >= 0]
        if len(e):
            parts_i.append(np.full(len(e), i, np.int64))
            parts_j.append(np.full(len(e), j, np.int64))
            parts_r.append(e)
    if not parts_r:
        return {}
    rows = np.concatenate(parts_r)
    a_key, b_key = dedupe_keys(np.concatenate(parts_i),
                               np.concatenate(parts_j), rows)
    # a group's ordinal in (a_key, b_key) order stands in for the pair
    # of keys: the groups and their order are the same
    order = np.lexsort((b_key, a_key))
    ak, bk = a_key[order], b_key[order]
    new = np.concatenate([[True], (ak[1:] != ak[:-1]) | (bk[1:] != bk[:-1])])
    group = np.empty(len(rows), np.int64)
    group[order] = np.cumsum(new) - 1
    uniq = np.stack([ak[new], bk[new]], axis=1)
    del order, ak, bk, new
    kept = dedupe_extents(
        {"aread": group, "bread": np.zeros(len(rows), np.int64),
         "abpos": rows[:, 3], "aepos": rows[:, 4], "bbpos": rows[:, 5],
         "bepos": rows[:, 6], "diffs": rows[:, 7], "n": len(rows)},
        cfg.min_len, max_err=1.0 - cfg.err)
    if not kept["n"]:
        return {}
    g = uniq[kept["aread"]]
    i, ar, j, comp, br = split_keys(g[:, 0], g[:, 1])
    kr = np.stack([ar, br, comp, kept["abpos"], kept["aepos"],
                   kept["bbpos"], kept["bepos"], kept["diffs"]],
                  axis=1).astype(np.int32)
    pair = i * n + j
    order = np.argsort(pair, kind="stable")
    kr, pair = kr[order], pair[order]
    cut = np.nonzero(np.concatenate([[True], pair[1:] != pair[:-1],
                                     [True]]))[0]
    return {(int(pair[s] // n), int(pair[s] % n)): kr[s:e]
            for s, e in zip(cut[:-1], cut[1:])}


# --- ring program 2: trace --------------------------------------------------

class _TraceBatch(_Batch):
    """K2's work on one rank: the deduped rows of every pair it met
    since the last launch, traced over the pools (trace_launch, split
    where the [S, max_segs, 2] buffer would pass the pair path's
    TRACE_BUF_BYTES), longest first.  `out` collects {(i, j): (ok
    bool[m], dsum [m], traces: a list of [nseg, 2])} in the order of
    the pair's rows."""

    def __init__(self, cfg, max_segs: int):
        super().__init__(cfg)
        self.max_segs = max_segs

    def add(self, key, kr: np.ndarray, a_starts: np.ndarray,
            b_starts: np.ndarray, a: list, b: list) -> None:
        """kr: the pair's kept rows; a_starts/b_starts: its blocks' read
        starts (host)."""
        aoff, boff = self._offsets(key, a, b)
        ast = aoff + a_starts.astype(np.int64)[kr[:, 0]]
        bst = (np.where(kr[:, 2] == 1, boff[1], boff[0])
               + b_starts.astype(np.int64)[kr[:, 1]])
        self.pend.append((key, kr, ast, bst))

    def flush(self) -> None:
        if not self.pend:
            return
        cfg = self.cfg
        kr = np.concatenate([p[1] for p in self.pend])
        ast = np.concatenate([p[2] for p in self.pend])
        bst = np.concatenate([p[3] for p in self.pend])
        order = np.argsort(kr[:, 3] - kr[:, 4], kind="stable")
        per = max(1, TRACE_BUF_BYTES // (self.max_segs * 8))
        a_words, b_words = self.apool.words(), self.bpool.words()
        sels = [order[s:s + per] for s in range(0, len(order), per)]
        pend = [trace_launch(a_words, dict(
            abp=kr[sel, 3], aep=kr[sel, 4], bbp=kr[sel, 5], bep=kr[sel, 6],
            ast=ast[sel], bst=bst[sel]), cfg, b_words=b_words,
            max_segs=self.max_segs) for sel in sels]
        del a_words, b_words
        ok_all = np.zeros(len(kr), bool)
        ds_all = np.zeros(len(kr), np.int64)
        tr_all: list = [None] * len(kr)
        for sel, (offs, ok, packed, dsum) in zip(
                sels, trace_harvest_all(pend, cfg)):
            ok_all[sel] = ok
            ds_all[sel] = dsum
            for q, r in enumerate(sel):
                tr_all[r] = packed[offs[q]:offs[q + 1]]
        at = 0
        for key, rows, _, _ in self.pend:
            m = len(rows)
            self.out[key] = (ok_all[at:at + m], ds_all[at:at + m],
                             tr_all[at:at + m])
            at += m
        self._reset()


def ring_trace_step(ring: Ring, blocks: list, shards: dict, kept: dict,
                    ra: int, rb: int, batch: _TraceBatch) -> None:
    """The trace sweep of super-row ra against super-row rb on this
    rank: the B-blocks (bases, read ordinals, starts) rotate as in
    ring_overlap_step past this rank's deduped rows, which go to
    `batch` pair by pair."""
    D, d, n = ring.size, ring.rank, len(blocks)
    i = ra * D + d
    b = shards[rb * D + d][:3]
    for j in range(D):
        bblk = rb * D + (d - j) % D
        kr = kept.get((i, bblk)) if i < n and bblk < n else None
        if kr is not None:
            batch.add((i, bblk), kr, blocks[i].starts, blocks[bblk].starts,
                      shards[i], b)
        if j < D - 1:
            b = _rotate(ring, b)


# --- host: checks, wide retries, .las ---------------------------------------

def _emit_shard(i: int, blocks: list, kept: dict, traces: dict, cfg,
                device, stats: dict):
    """The sorted LasFile of A-block i: each pair's records that passed
    the trace checks, then its failed ones retried on the wide band (K3
    through the pair path's wide_retry; those failing again dropped), in
    the reference's order."""
    parts = []
    for j in range(len(blocks)):
        kr = kept.get((i, j))
        if kr is None:
            continue
        ok, ds, trs = traces[(i, j)]
        tr_rows = [trs[r] for r in np.nonzero(ok)[0]]
        rows_ok, ds_ok = [kr[ok]], [ds[ok]]
        bad = np.nonzero(~ok)[0]
        stats["trace_retries"] += len(bad)
        if len(bad):
            res = wide_retry(blocks[i], blocks[j], dict(
                ar=kr[bad, 0], br=kr[bad, 1], comp=kr[bad, 2] == 1,
                abp=kr[bad, 3], aep=kr[bad, 4], bbp=kr[bad, 5],
                bep=kr[bad, 6], row=bad), cfg, device)
            release_device_buffers(blocks[i])
            release_device_buffers(blocks[j])
            # the reference's order: the forward orientation's, then the
            # comp one's
            for r in np.concatenate([bad[kr[bad, 2] == 0],
                                     bad[kr[bad, 2] == 1]]):
                tr, dd = res[int(r)]
                if tr is None:
                    stats["dropped_trace"] += 1
                    continue
                tr_rows.append(tr)
                rows_ok.append(kr[r:r + 1])
                ds_ok.append(np.array([dd]))
        rows_ok = np.concatenate(rows_ok)
        if not len(rows_ok):
            continue
        parts.append(las_columns(
            dict(abp=rows_ok[:, 3], aep=rows_ok[:, 4], bbp=rows_ok[:, 5],
                 bep=rows_ok[:, 6], comp=rows_ok[:, 2],
                 hdr_ar=blocks[i].ids[rows_ok[:, 0]],
                 hdr_br=blocks[j].ids[rows_ok[:, 1]],
                 dsum=np.concatenate(ds_ok)),
            np.array([len(t) for t in tr_rows], np.int64),
            np.concatenate(tr_rows).astype(np.int32), cfg.tspace))
    las = LasFile(cfg.tspace, columns=LasColumns.concat(parts))
    las.sort()
    return las


def _grow_to_fit(blocks, cfg, ring, shards, exts, counts, seed_cap,
                 hit_cap, timings):
    """The reference's grow ladder for explicit caps: the sweeps holding
    a saturated pair run again with the saturated cap doubled, up to
    GROW_STEPS times.  Unlike the reference (fault 3l: its fifth result
    is never checked), the result of the last doubling is checked
    before anything raises.  Returns (exts, counts, seed_cap)."""
    D, n = ring.size, len(blocks)
    s_cap, h_cap = seed_cap, hit_cap
    for step in range(GROW_STEPS + 1):
        sat_s = (counts[:, :, 0] >= s_cap if s_cap is not None
                 else np.zeros((n, n), bool))
        sat_h = (counts[:, :, 2] > h_cap if h_cap is not None
                 else np.zeros((n, n), bool))
        sat = sat_s | sat_h
        if not sat.any():
            return exts, counts, s_cap
        if step == GROW_STEPS:
            raise ValueError(
                f"ring sweep still saturates seed_cap={s_cap}/"
                f"hit_cap={h_cap} after {GROW_STEPS} doublings; raise the "
                f"caps (or leave them None) or shrink the blocks")
        sup = {(int(i) // D, int(j) // D) for i, j in np.argwhere(sat)}
        if sat_s.any():
            s_cap *= 2
        if sat_h.any():
            h_cap *= 2
        e2, c2, _ = distributed_overlap(blocks, cfg, ring, s_cap, h_cap,
                                        pairs=sup, timings=timings,
                                        _shards=shards)
        for ra, rb in sup:
            i0, i1 = ra * D, min((ra + 1) * D, n)
            j0, j1 = rb * D, min((rb + 1) * D, n)
            counts[i0:i1, j0:j1] = c2[i0:i1, j0:j1]
        exts.update(e2)
    raise AssertionError("unreachable")


def distributed_overlap_las(blocks: list, cfg, ring: Ring | None = None,
                            seed_cap: int | None = None,
                            hit_cap: int | None = None,
                            max_segs: int | None = None,
                            timings: dict | None = None,
                            stats: dict | None = None, *, device=None):
    """The whole ring overlap to .las (the counterpart of damar_tpu
    distributed_overlap_las): the seed and extend ring, the columnar
    dedupe of this rank's extents, the trace ring, then the trace
    checks, the wide-band retry of failed records and the .las columns
    on the host.  ring None: a ring of one rank on `device` (None: a
    CUDA device, which must exist).

    seed_cap/hit_cap None: each pair's buffers sized from its counts.
    Explicit caps are the reference's: the sweeps of saturated pairs run
    again with doubled caps, up to GROW_STEPS times, and a ring that
    still saturates raises (on every rank: the counts are all-gathered).

    Returns (las, counts, total): las {i: the sorted LasFile of A-block
    i against every block} for this rank's A-blocks (0-based; the
    per-rank .las shards, merged on the host by formats.las.merge_las),
    counts [n, n, 3] and total as distributed_overlap's.  timings adds
    seconds under overlap_ring, dedupe, trace_ring, retry_emit; stats
    (when given) gets trace_retries and dropped_trace."""
    ring = ring or make_mesh(device=device)
    n, D = len(blocks), ring.size
    k = -(-n // D)
    timings = {} if timings is None else timings
    stats = {} if stats is None else stats
    stats.setdefault("trace_retries", 0)
    stats.setdefault("dropped_trace", 0)
    shards = shard_blocks(ring, blocks, cfg,
                          payload_widths(_pad_blocks(blocks, D)))
    exts, counts, _ = distributed_overlap(blocks, cfg, ring, seed_cap,
                                          hit_cap, timings=timings,
                                          _shards=shards)
    if seed_cap is not None or hit_cap is not None:
        exts, counts, _ = _grow_to_fit(blocks, cfg, ring, shards, exts,
                                       counts, seed_cap, hit_cap, timings)
    t0 = time.time()
    kept = _dedupe(exts, n, cfg)
    del exts
    nkept = np.zeros((n, n), np.int64)
    for key, kr in kept.items():
        nkept[key] = len(kr)
    nkept = _sum_ranks(ring, nkept)
    timings["dedupe"] = timings.get("dedupe", 0.0) + time.time() - t0

    t0 = time.time()
    if max_segs is None:
        longest = max(int(b.rlen.max()) if b.nreads else 0 for b in blocks)
        max_segs = max(8, longest // cfg.tspace + 2)
    batch = _TraceBatch(cfg, max_segs)
    for ra in range(k):
        for rb in range(k):
            if nkept[ra * D:(ra + 1) * D, rb * D:(rb + 1) * D].any():
                ring_trace_step(ring, blocks, shards, kept, ra, rb, batch)
    batch.flush()
    traces = batch.out
    del shards
    timings["trace_ring"] = timings.get("trace_ring", 0.0) + time.time() - t0

    t0 = time.time()
    out = {i: _emit_shard(i, blocks, kept, traces, cfg, ring.device, stats)
           for i in range(ring.rank, n, D)}
    timings["retry_emit"] = timings.get("retry_emit", 0.0) + time.time() - t0
    return out, counts, counts.sum((0, 1))


# --- a local launcher -------------------------------------------------------

def _rank_main(rank: int, nprocs: int, init: str, backend: str,
               timeout: float, target, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=nprocs,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        target(dist.group.WORLD, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, nprocs: int, args: tuple = (), *,
                backend: str = "gloo", timeout: float = 600.0) -> None:
    """Run target(group, *args) in nprocs fresh processes (the spawn
    start method: CUDA cannot live in forked children), each rank of one
    process group over a file:// rendezvous in a temporary directory.
    Collectives time out after `timeout` seconds.  Returns when every
    rank has returned; raises when a rank raised or died, or when the
    ranks outlive the timeout, after terminating every rank left."""
    tmp = tempfile.mkdtemp(prefix="damar_ring_")
    ctx = mp.start_processes(
        _rank_main, args=(nprocs, f"file://{tmp}/rendezvous", backend,
                          timeout, target, args),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                raise TimeoutError(f"ring ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def ring_to_dir(group, cases: list, out_dir: str, device=None) -> None:
    """A rank's part of a spawned ring (a spawn_ranks target): for each
    case (name, blocks, cfg, kwargs, what), the ring on this rank's
    device (None: a CUDA device), its results in out_dir/name/.  what
    "las": distributed_overlap_las, each own A-block's shard as
    shard.{i}.las (0-based i); "extents": distributed_overlap, the own
    extent buffers as ext.{i}.{j}.npy.  Rank 0 also writes counts.npy
    and rank0.json (walls, stats, backend, staging, device)."""
    ring = make_mesh(group, device=device)
    for name, blocks, cfg, kwargs, what in cases:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        timings, stats = {}, {}
        if what == "las":
            las, counts, _ = distributed_overlap_las(
                blocks, cfg, ring, timings=timings, stats=stats, **kwargs)
            for i, lf in las.items():
                write_las(f"{d}/shard.{i}.las", lf)
        else:
            exts, counts, _ = distributed_overlap(
                blocks, cfg, ring, timings=timings, **kwargs)
            for (i, j), e in exts.items():
                np.save(f"{d}/ext.{i}.{j}.npy", e)
        if ring.rank == 0:
            np.save(f"{d}/counts.npy", counts)
            with open(f"{d}/rank0.json", "w") as f:
                json.dump({"timings": timings, "stats": stats,
                           "backend": ring.backend, "staged": ring.staged,
                           "device": str(ring.device)}, f)


# --- multi-host scale-out of the block sweep --------------------------------

def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> int:
    """This host's index in a multi-host run, from the launcher contract
    of a SLURM-style array: JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
    JAX_PROCESS_ID when the arguments are omitted (the variables
    damar_tpu reads, so one array script serves both packages).  Returns
    0 when no coordinator is set, so callers can be launcher-agnostic.

    No collective is initialized: the block sweep's hosts meet only
    through the shared filesystem (host_pair_slice), so the index is all
    they need.  num_hosts gives the count from the same contract.  The
    ring sweep takes a process group that its caller set up (torchrun's
    env://, or spawn_ranks)."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return 0
    n = num_hosts(num_processes)
    pid = int(process_id if process_id is not None
              else os.environ.get("JAX_PROCESS_ID", "0"))
    if not 0 <= pid < n:
        raise ValueError(f"process id {pid} not in [0, {n})")
    return pid


def num_hosts(num_processes: int | None = None) -> int:
    """The host count of the launcher contract (JAX_NUM_PROCESSES,
    default 1)."""
    return int(num_processes or os.environ.get("JAX_NUM_PROCESSES", "1"))


def block_pair_matrix(nblocks: int) -> list[tuple[int, int]]:
    """The HPC.daligner job matrix: all unordered block pairs (i <= j),
    i.e. N(N+1)/2 comparisons."""
    return [(i, j) for i in range(1, nblocks + 1)
            for j in range(i, nblocks + 1)]


def host_pair_slice(nblocks: int, nhosts: int, host_id: int
                    ) -> list[tuple[int, int]]:
    """Deterministic partition of the block-pair matrix across hosts:
    pairs are dealt round-robin in matrix order, so every host gets an
    equal mix of self and distinct pairs.  The union over hosts is the
    full matrix and the slices are disjoint.  The shared filesystem is
    the only rendezvous: each host writes its pairs' .las files and marks
    the manifest, and any host (or a later rerun) merges once every pair
    of a block is done."""
    if not (0 <= host_id < nhosts):
        raise ValueError(f"host_id {host_id} not in [0, {nhosts})")
    return block_pair_matrix(nblocks)[host_id::nhosts]
