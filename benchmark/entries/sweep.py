"""Unit of work `sweep`: one whole block sweep of a DB on disk, as a
daligner job runs it (HPC.daligner's matrix through the program's
planner): load the blocks, overlap every block pair with mirrors, write
the pair files, merge per A block.

Set-up writes the reads as FASTA, builds the DB (fasta2DB) and splits it
(DBsplit -s block_mb -x min_read_bp) with the program's own DB writer,
as a user would before a sweep; the DB is one block, so the sweep is its
self pair.  Between units the pair file and the planner's manifest are
removed, so every unit redoes the whole sweep; the merged file is moved
aside under the unit's number and judged after the window.
"""
from __future__ import annotations

import glob
import hashlib
import os
import time

import numpy as np
import torch

from benchmark import reference, work
from benchmark.tracing import UNIT

# the program's calls a traced run wraps in spans: span -> (module, name)
SPANS = {
    "load": ("damar_tpu_torch.core.blocks", "block_from_db"),
    "device_phases": ("damar_tpu_torch.pipeline.overlap",
                      "overlap_pair_device"),
    "emit": ("damar_tpu_torch.pipeline.overlap", "overlap_pair_emit"),
    "write": ("damar_tpu_torch.formats.las", "write_las"),
    "merge": ("damar_tpu_torch.formats.las", "merge_las"),
}

_B = np.frombuffer(b"acgt", np.uint8)


def write_fasta(path: str, reads) -> None:
    """One record a read, its sequence on one line."""
    seq = _B[reads.bases]
    with open(path, "wb") as f:
        for i in range(reads.n):
            f.write(b">sim/%d/0_%d\n" % (i, reads.offsets[i + 1]
                                         - reads.offsets[i]))
            f.write(seq[reads.offsets[i]:reads.offsets[i + 1]].tobytes())
            f.write(b"\n")


class Sweep:
    def __init__(self, ctx):
        from damar_tpu_torch.core.config import OverlapConfig
        from damar_tpu_torch.formats import dazzdb
        self.ctx = ctx
        cfg = ctx.config
        self.dir = os.path.join(ctx.workdir, "sweep")
        os.makedirs(self.dir, exist_ok=True)
        fasta = os.path.join(self.dir, "reads.fasta")
        write_fasta(fasta, ctx.reads)
        self.db = os.path.join(self.dir, "S.db")
        dazzdb.create_db(self.db, [fasta])
        os.remove(fasta)
        db = dazzdb.db_split(self.db, size_mb=int(cfg["block_mb"]),
                             cutoff=int(cfg["reads"]["min_bp"]))
        if db.nblocks != 1 or len(ctx.blocks) != 1:
            raise ValueError("the sweep entry runs one-block DBs (its "
                             "records are judged as one self pair); this "
                             f"one has {db.nblocks} blocks")
        self.ocfg = OverlapConfig(**ctx.overlap_args)
        self.units: list[dict] = []

    def _clear(self) -> None:
        for p in glob.glob(os.path.join(self.dir, "S.*.las")) + glob.glob(
                os.path.join(self.dir, ".S.overlap.manifest*")):
            os.remove(p)

    def warm(self) -> None:
        """One sweep, its files deleted: builds and warms every kernel."""
        self._sweeps(0, keep=False)

    def run(self, seconds: float) -> tuple[float, list[dict]]:
        """Sweeps back to back until `seconds` have passed since the
        first began; returns (start, units), each unit's merged file moved
        aside for the judge."""
        return self._sweeps(seconds, keep=True)

    def finish(self) -> None:
        """Nothing runs past a sweep."""

    def _sweeps(self, seconds: float, keep: bool):
        from damar_tpu_torch.pipeline.planner import run_overlap_plan
        sync = self.ctx.sync
        units = []
        self._clear()
        sync()
        t0 = time.perf_counter()
        while True:
            t_u = time.perf_counter()
            with torch.profiler.record_function(UNIT):
                st = run_overlap_plan(self.db, self.ocfg, verbose=False,
                                      device=self.ctx.device)
                sync()
            t_end = time.perf_counter()
            merged = os.path.join(
                self.dir, f"unit{len(self.units) + len(units)}.keep")
            if keep:
                os.replace(os.path.join(self.dir, "S.1.las"), merged)
            self._clear()
            units.append(dict(t_start=t_u, t_end=t_end, wall=t_end - t_u,
                              pairs=st.get("pair_stats", []),
                              merged=merged))
            if t_end - t0 >= seconds:
                break
        if keep:
            self.units += units
        return t0, units

    def records(self, unit: dict) -> tuple[list[tuple], str]:
        """The unit's merged file, parsed by the reference's reader; each
        record's mirror lies in the same file."""
        return [reference.parse_las(unit["merged"])], "within"

    def read_sets(self) -> tuple[np.ndarray, np.ndarray]:
        """Read ids of the A and B sides: one block, its self pair."""
        lo, hi = self.ctx.blocks[0]
        return np.arange(lo, hi), np.arange(lo, hi)

    def end_to_end(self, recs: list, t0: float, t_end: float) -> dict:
        return {"overlap_gbp_s": work.gbp_per_s(
            [work.aligned_bp(*r) for r in recs], t0, t_end)}

    def digest(self, unit: dict) -> str:
        d = hashlib.sha256()
        with open(unit["merged"], "rb") as f:
            for blk in iter(lambda: f.read(1 << 24), b""):
                d.update(blk)
        return d.hexdigest()

    def release(self) -> None:
        """Nothing outlives a sweep call: its blocks are its own."""

    def cleanup(self) -> None:
        for u in self.units:
            if os.path.exists(u["merged"]):
                os.remove(u["merged"])
        self._clear()


def make(ctx):
    return Sweep(ctx)
