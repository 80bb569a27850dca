"""Port vs reference for the command-line toolbox, continued: the
`pipeline` tool (tests/test_torch_cli.py holds the other 32) on the 12
kbp genome of tests/test_torch_run.py (-s 1 -x 500 --no-polish).  The
port's is typed as a user types it, `python -m damar_tpu_torch.cli
pipeline ...` in a fresh process with DAMAR_PLATFORM=cpu, beside the
reference's in-process run (its device route, native.available ->
False for its retrace): CONTIGS.fasta and every .las, track and
FIX.fasta byte-equal, report.json equal but for its walls and paths,
stdout equal but for the walls.  Tolerance: exact equality."""
import contextlib
import filecmp
import io
import json
import os
import re
import subprocess
import sys

import pytest

from damar_tpu import cli as ref_cli
from damar_tpu import native
from damar_tpu.utils.sim import make_genome, sample_reads, write_sim_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPELINE = ["-s", "1", "-x", "500", "--no-polish"]
PIPELINE_FILES = [
    "CONTIGS.fasta", "RAW.1.las", ".RAW.dust.anno", ".RAW.dust.data",
    ".RAW.tan.anno", ".RAW.tan.data", "FIX.fasta", "FIX.1.las",
    "FIX.merged.las", ".FIX.q.anno", ".FIX.q.data", ".FIX.trim.anno",
    ".FIX.trim.data", "FIX.scrubbed.las", "FIX.filtered.las"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("clipipe")
    g = make_genome(12_000, seed=81)
    write_sim_fasta(str(base / "reads.fasta"), sample_reads(
        g, coverage=10, mean_len=2500, err=0.13, seed=82))
    env = dict(os.environ, DAMAR_PLATFORM="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="2")
    pw, rw = str(base / "port"), str(base / "ref")
    port = subprocess.Popen(
        [sys.executable, "-m", "damar_tpu_torch.cli", "pipeline",
         str(base / "reads.fasta"), pw] + PIPELINE, env=env,
        cwd=str(base), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            ref_cli.main(["pipeline", str(base / "reads.fasta"), rw]
                         + PIPELINE)
    finally:
        mp.undo()
    out, err_p = port.communicate(timeout=600)
    assert port.returncode == 0, err_p
    return dict(base=str(base), pw=pw, rw=rw, ref_out=buf.getvalue(),
                port_out=out)


@pytest.mark.parametrize("name", PIPELINE_FILES)
def test_pipeline_files_byte_equal(runs, name):
    assert filecmp.cmp(f"{runs['pw']}/{name}", f"{runs['rw']}/{name}",
                       shallow=False)


def test_pipeline_report_and_stdout(runs):
    def strip(d):
        with open(f"{d}/report.json") as f:
            rep = json.load(f)
        rep.pop("total_wall_s")
        assert rep.pop("contig_fasta") == os.path.join(d, "CONTIGS.fasta")
        for ph in rep["phases"].values():
            ph.pop("wall_s")
        return rep
    assert strip(runs["pw"]) == strip(runs["rw"])
    norm = lambda t: re.sub(  # noqa: E731
        r"""("total_wall_s"|'wall_s'|"wall_s"): [0-9.e-]+""", "W", t)
    assert norm(runs["port_out"]) == norm(runs["ref_out"])
    last = json.loads(runs["port_out"].splitlines()[-1])
    assert last["contigs"]["contigs"] >= 1
