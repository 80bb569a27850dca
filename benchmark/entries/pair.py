"""Unit of work `pair`: one distinct block pair (A, B) with mirrors, as a
sweep's planner submits it to the program's pipelined pair driver (pair
N's trace and emit run beside pair N + 1's seeding and extension).

Set-up builds the two blocks from the reads of the first two DBsplit
blocks (the program's block_from_reads, read ids as a DB numbers them).
Before each job, B's device buffers and its whole cache are dropped, as
for a B block met for the first time in a row of the sweep; A keeps its
cache (uploads, k-mer index, reverse-complement twin), as within one row.
One stream of jobs runs from the warm-up through the window, so the
window measures the pipeline in its steady state.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np

from benchmark import reference, work

SPANS = {
    "device_phases": ("damar_tpu_torch.pipeline.overlap",
                      "overlap_pair_device"),
    "emit": ("damar_tpu_torch.pipeline.overlap", "overlap_pair_emit"),
    "prefetch": ("damar_tpu_torch.pipeline.overlap", "_prefetch"),
}


def _columns(las):
    from damar_tpu_torch.formats.las import columns_of
    c = columns_of(las)
    return c.headers, c.trace, c.offsets


class Pair:
    def __init__(self, ctx):
        from damar_tpu_torch.core.blocks import block_from_reads
        from damar_tpu_torch.core.config import OverlapConfig
        self.ctx = ctx
        if len(ctx.blocks) < 2:
            raise ValueError("the pair entry needs two blocks of reads")
        r = ctx.reads
        self.blk = []
        for lo, hi in ctx.blocks[:2]:
            reads = [r.read(i) for i in range(lo, hi)]
            self.blk.append(block_from_reads(reads, ids=np.arange(lo, hi)))
        self.ocfg = OverlapConfig(**ctx.overlap_args)
        self._stop = False
        self._stream = None

    def _jobs(self):
        """The pair again and again until told to stop, B's caches
        dropped before each job."""
        from damar_tpu_torch.pipeline.overlap import release_device_buffers
        a, b = self.blk
        k = 0
        while not self._stop:
            release_device_buffers(b)
            b.cache.clear()
            yield dict(tag=k, blk_a=a, blk_b=b, self_block=False,
                       emit_mirrors=True)
            k += 1

    def warm(self) -> None:
        """Start the pipelined stream of pairs and take its first pair:
        the kernels are built and warm, A's caches full, and the next
        pair's device phases done, so the window sees the pipeline in
        its steady state."""
        next(self._started())
        self.ctx.sync()

    def _started(self):
        from damar_tpu_torch.pipeline.overlap import overlap_pairs_pipelined
        if self._stream is None:
            self._stop = False
            self._stream = overlap_pairs_pipelined(
                self._jobs(), self.ocfg, device=self.ctx.device)
        return self._stream

    def run(self, seconds: float) -> tuple[float, list[dict]]:
        """Pairs from the running stream until `seconds` have passed
        since the window opened; returns (start, units), each unit ending
        when the driver hands its records back, which it holds.  In the
        steady pipeline each unit spans one period (its emit beside the
        next pair's device phases); the pairs still in flight when the
        window closes are drained by finish(), outside it."""
        sync = self.ctx.sync
        units = []
        sync()
        t0 = time.perf_counter()
        last = t0
        for _, la, lb, st in self._started():
            sync()
            t_end = time.perf_counter()
            ha, ta, oa = _columns(la)
            hb, tb, ob = _columns(lb)
            units.append(dict(t_start=last, t_end=t_end, wall=t_end - last,
                              pairs=[dict(st)],
                              files=[(self.ocfg.tspace, ha, ta, oa),
                                     (self.ocfg.tspace, hb, tb, ob)]))
            last = t_end
            if t_end - t0 >= seconds:
                break
        self._stop = True
        return t0, units

    def finish(self) -> None:
        """Drain the pairs still in flight (outside the window)."""
        self._stop = True
        for _ in self._stream or ():
            pass

    def records(self, unit: dict) -> tuple[list[tuple], str]:
        """las_a's records, then las_b's, the mirrors of las_a's."""
        return [(ts, h) + reference.decode_trace(t, o, ts)
                for ts, h, t, o in unit["files"]], "across"

    def read_sets(self) -> tuple[np.ndarray, np.ndarray]:
        (la, ha), (lb, hb) = self.ctx.blocks[:2]
        return np.arange(la, ha), np.arange(lb, hb)

    def end_to_end(self, recs: list, t0: float, t_end: float) -> dict:
        return {"overlap_gbp_s": work.gbp_per_s(
            [work.aligned_bp(*r) for r in recs], t0, t_end)}

    def digest(self, unit: dict) -> str:
        d = hashlib.sha256()
        for _, h, t, o in unit["files"]:
            for x in (h, t, o):
                d.update(np.ascontiguousarray(x).tobytes())
        return d.hexdigest()

    def release(self) -> None:
        """Drop the blocks and their device caches."""
        from damar_tpu_torch.pipeline.overlap import release_device_buffers
        for b in self.blk:
            release_device_buffers(b)
            b.cache.clear()
        self.blk = []

    def cleanup(self) -> None:
        self._stream = None


def make(ctx):
    return Pair(ctx)
