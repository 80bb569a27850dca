"""Fault 3k of the reference (ROADMAP.md §3), in damar_tpu.cli and beside
it the port's command-line result, on a 2-block DB (a 60 kbp genome with
6 planted tandems at 18x, `dbsplit -s 1 -x 1000`).

damar_tpu's `datander -b B` (damar_tpu/cli.py:253-264) writes the
whole-DB tan track with every other block's reads empty, so the
per-block loop of render_script's masking phase (planner.py:167-169)
keeps only the last block's intervals, and its `tkmerge tan`
(planner.py:170-172) finds no block track.  The port's `datander -b B`
writes block B's track (.T.B.tan.*), and `tkmerge tan` assembles the
track of a whole-DB `datander`, byte for byte the reference's.

The reference's datander search runs with a hit buffer large enough for
every hit (its default of 1 << 20 cuts a 1 Mbp block short in silence,
fault 3g; the port sizes its buffer from the count).  The port runs in a
fresh process beside it with DAMAR_PLATFORM=cpu.  Tolerance: exact
equality."""
import contextlib
import filecmp
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from damar_tpu import cli as ref_cli
from damar_tpu import native
from damar_tpu.formats.dazzdb import DazzDB
from damar_tpu.formats.tracks import read_track
from damar_tpu.ops import seeding as ref_seeding
from damar_tpu.utils.sim import make_genome, sample_reads, write_sim_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's commands: per-block datander and tkmerge, then a whole-DB
# datander on a copy of the DB
PORT = """
import shutil, sys
from damar_tpu_torch import cli
d = sys.argv[1]
cli.main(["fasta2db", f"{d}/T.db", f"{d}/../tandem.fasta"])
cli.main(["dbsplit", f"{d}/T.db", "-s", "1", "-x", "1000"])
shutil.copytree(d, d + "_whole")
for b in ("1", "2"):
    cli.main(["datander", f"{d}/T.db", "-b", b])
cli.main(["tkmerge", f"{d}/T.db", "tan"])
cli.main(["datander", f"{d}_whole/T.db"])
"""


def _run(argv):
    try:
        ref_cli.main(argv)
    except SystemExit as e:
        return e.code or 0
    return 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("fault3k")
    g = make_genome(60_000, seed=5, tandem=6)
    write_sim_fasta(str(base / "tandem.fasta"), sample_reads(
        g, coverage=18, mean_len=4000, err=0.12, seed=6, min_len=1500))
    p, r = str(base / "port"), str(base / "ref")
    os.makedirs(p)
    os.makedirs(r)
    env = dict(os.environ, DAMAR_PLATFORM="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="2")
    port = subprocess.Popen([sys.executable, "-c", PORT, p], env=env,
                            cwd=str(base), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    real = ref_seeding.find_tandem_seeds
    totals = []

    def uncapped(*a, **kw):
        s = real(*a, **dict(kw, hit_cap=1 << 23))
        totals.append(int(s["total_hits"]))
        return s
    mp.setattr(ref_seeding, "find_tandem_seeds", uncapped)
    err = io.StringIO()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _run(["fasta2db", f"{r}/T.db", str(base / "tandem.fasta")])
            _run(["dbsplit", f"{r}/T.db", "-s", "1", "-x", "1000"])
            _run(["datander", f"{r}/T.db"])
            whole = read_track(f"{r}/T.db", "tan")
            for ext in ("anno", "data"):
                shutil.copy(f"{r}/.T.tan.{ext}", f"{base}/ref_whole.{ext}")
            for b in ("1", "2"):
                _run(["datander", f"{r}/T.db", "-b", b])
            looped = read_track(f"{r}/T.db", "tan")
            with contextlib.redirect_stderr(err):
                merge_rc = _run(["tkmerge", f"{r}/T.db", "tan"])
    finally:
        mp.undo()
    out, perr = port.communicate(timeout=600)
    assert port.returncode == 0, perr
    assert totals and max(totals) <= 1 << 23
    db = DazzDB.open(f"{r}/T.db")
    assert db.nblocks == 2
    return dict(base=str(base), p=p, whole=whole, looped=looped,
                merge_rc=merge_rc, merge_err=err.getvalue(),
                ranges=[db.block_range(b) for b in (1, 2)])


def _bp(track, lo: int, hi: int) -> int:
    return sum(int(np.diff(track.data[i].reshape(-1, 2), axis=1).sum())
               for i in range(lo, hi))


def test_reference_fault_3k_datander_per_block(runs):
    """The reference's per-block datander loop leaves only the last
    block's intervals, and its tkmerge has no block track to read."""
    (lo1, hi1), (lo2, hi2) = runs["ranges"]
    whole, looped = runs["whole"], runs["looped"]
    assert _bp(whole, lo1, hi1) > 0 and _bp(whole, lo2, hi2) > 0
    assert _bp(looped, lo1, hi1) == 0
    assert _bp(looped, lo2, hi2) == _bp(whole, lo2, hi2)
    assert runs["merge_rc"] == 1
    assert "No such file" in runs["merge_err"]


@pytest.mark.parametrize("ext", ["anno", "data"])
def test_port_datander_per_block_merges_to_whole(runs, ext):
    """The port writes each block's track; tkmerge of them and the
    port's whole-DB datander both give the reference's whole-DB track,
    byte for byte."""
    p = runs["p"]
    for b in ("1", "2"):
        assert os.path.getsize(f"{p}/.T.{b}.tan.{ext}") > 0
    want = f"{runs['base']}/ref_whole.{ext}"
    for got in (f"{p}/.T.tan.{ext}", f"{p}_whole/.T.tan.{ext}"):
        assert filecmp.cmp(got, want, shallow=False)
