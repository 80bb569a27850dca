"""Port vs reference for the block sweep from a DB on disk: every pair
file X.i.X.j.las and merged file X.i.las that damar_tpu_torch's
run_overlap_plan writes for a 3-block DB must equal damar_tpu's, and a
resumed run must rewrite the same bytes.  Tolerance: byte equality.  The reference is forced onto its
all-device route (DAMAR_BP=jax from conftest, native.available ->
False); on the CPU backend its run_overlap_plan then runs the sequential
device route.  Reads are kept short (<= 1,300 bp) because both sides'
CPU forms step through a Python or XLA loop per DP chunk.

tests/test_torch_sweep_masked.py runs the same comparison with a
soft-mask track; tests/test_torch_sweep_pipeline.py holds the port's
other sweep forms (two hosts, one resident block, the threaded pipeline)
against the single-host run checked here."""
import filecmp
import glob
import os

import numpy as np
import pytest
import torch

from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.formats import dazzdb as ref_db
from damar_tpu.formats import tracks as ref_tracks
from damar_tpu.pipeline.planner import run_overlap_plan as ref_plan
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats import dazzdb, las, tracks
from damar_tpu_torch.pipeline.planner import run_overlap_plan
from damar_tpu_torch.utils import sim

torch.set_num_threads(2)
MIN_LEN = 500


def sweep_reads():
    """~2.5 Mbp of reads of 500-1,300 bp over a 600 kbp genome: three
    1 Mbp blocks, a few hundred overlaps a pair."""
    g = sim.make_genome(600_000, seed=31)
    s = sim.sample_reads(g, coverage=6.4, mean_len=900, err=0.10, seed=32)
    keep = [i for i, r in enumerate(s.reads) if len(r) <= 1300]
    return sim.SimReads(g, [s.reads[i] for i in keep], s.start[keep],
                        s.end[keep], s.strand[keep], s.err)


def make_db(w, reads, dbmod=dazzdb):
    """FASTA -> DB -> 1 Mbp blocks in directory w; returns the open DB."""
    os.makedirs(w, exist_ok=True)
    sim.write_sim_fasta(f"{w}/r.fasta", reads)
    dbmod.create_db(f"{w}/E.db", [f"{w}/r.fasta"])
    return dbmod.db_split(f"{w}/E.db", size_mb=1, cutoff=500)


def las_files(w):
    return sorted(os.path.basename(p) for p in glob.glob(f"{w}/E.*.las"))


def assert_same_sweep(want_dir, got_dir):
    names = las_files(want_dir)
    assert names == las_files(got_dir)
    assert sum(n.count(".") == 2 for n in names) >= 3      # merged files
    for n in names:
        assert filecmp.cmp(f"{want_dir}/{n}", f"{got_dir}/{n}",
                           shallow=False), n


@pytest.fixture(scope="module")
def reads():
    return sweep_reads()


@pytest.fixture()
def device_route(monkeypatch):
    from damar_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("DAMAR_BP", "jax")


def run_both(reads, tmp_path, mask_data=None):
    """The sweep through both packages in tmp_path/ref and tmp_path/port
    (with the intervals mask_data as track "rep" when given); checks the
    counts, every file's bytes and check_las on the merged files.
    Returns (ref dir, port dir, the port's DB)."""
    rw, pw = str(tmp_path / "ref"), str(tmp_path / "port")
    rdb = make_db(rw, reads, ref_db)
    pdb = make_db(pw, reads)
    assert pdb.nblocks == rdb.nblocks >= 3
    names = None
    if mask_data is not None:
        names = ["rep", "absent"]           # a missing track is skipped
        data = mask_data(pdb)
        tracks.write_track(f"{pw}/E.db", tracks.Track("rep", data))
        ref_tracks.write_track(f"{rw}/E.db", ref_tracks.Track("rep", data))
    want = ref_plan(f"{rw}/E.db", RefConfig(min_len=MIN_LEN), verbose=False,
                    mask_names=names)
    got = run_overlap_plan(f"{pw}/E.db", OverlapConfig(min_len=MIN_LEN),
                           verbose=False, mask_names=names, device="cpu")
    n = pdb.nblocks
    assert got["pairs"] == want["pairs"] == n * (n + 1) // 2
    assert got["overlaps"] == want["overlaps"] > 0
    assert_same_sweep(rw, pw)
    rlen = pdb.reads["rlen"]
    for i in range(1, n + 1):
        merged = las.read_las(f"{pw}/E.{i}.las")
        assert las.check_las(merged, rlen) == []
    return rw, pw, pdb


def test_sweep_files_byte_equal(reads, device_route, tmp_path):
    rw, pw, pdb = run_both(reads, tmp_path)
    n = pdb.nblocks
    # resume: one pair's file and manifest line gone; the rerun computes
    # that pair alone and writes the same bytes
    victim = f"{pw}/E.1.E.2.las"
    before = open(victim, "rb").read()
    os.remove(victim)
    mpath = f"{pw}/.E.overlap.manifest"
    lines = open(mpath).read().splitlines(keepends=True)
    open(mpath, "w").writelines(ln for ln in lines
                                if '"overlap.1.2"' not in ln)
    again = run_overlap_plan(f"{pw}/E.db", OverlapConfig(min_len=MIN_LEN),
                             verbose=False, device="cpu")
    assert (again["pairs"], again["skipped"]) == (1, n * (n + 1) // 2 - 1)
    assert open(victim, "rb").read() == before
    assert_same_sweep(rw, pw)
    # and a third run finds everything done
    third = run_overlap_plan(f"{pw}/E.db", OverlapConfig(min_len=MIN_LEN),
                             verbose=False, device="cpu")
    assert (third["pairs"], third["skipped"]) == (0, n * (n + 1) // 2)


def test_device_has_no_default(tmp_path):
    with pytest.raises(TypeError, match="device"):
        run_overlap_plan(str(tmp_path / "E.db"), OverlapConfig())
