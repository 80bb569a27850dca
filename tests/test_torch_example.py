"""The port's twins of the worked example and the soak against the
reference's scripts, each side in a fresh process, on the CPU (--cpu:
the plain kernel versions).

- tools/do.py against examples/do.py at a 8 kbp genome (the example's
  seeds, coverage, read length and error): the same CONTIGS.fasta bytes,
  the same simulated, contigs, identity and verdict lines, the same exit
  code.
- tools/soak.py against scripts/soak.py (whose assembly is damar_tpu's
  run_pipeline) at a 10 kbp genome, the smallest that holds the soak's
  planted shapes (4 repeats of 1.8 kbp, 2 tandem arrays of 2 kbp) with
  its 14x of 8 kb reads: the same reads.fasta and CONTIGS.fasta bytes,
  the same contigs line, and summary lines that parse to the same span,
  longest contig, k16 hit rate and identity.
The reference runs its own default route on the CPU (DAMAR_BP unset),
as a user runs it.  The genomes are cut from 50 kbp and 1 Mbp so that
the port's plain versions finish here in about a minute each.
Tolerance: byte equality of the files, string equality of the lines."""
import hashlib
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600


def start(args: list) -> subprocess.Popen:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("DAMAR_BP", None)
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(p: subprocess.Popen) -> tuple[int, list]:
    out, err = p.communicate(timeout=TIMEOUT)
    lines = [ln for ln in out.splitlines() if ln.startswith("== ")]
    assert lines, f"rc {p.returncode}; stderr tail:\n{err[-3000:]}"
    return p.returncode, lines


def line(lines: list, prefix: str) -> str:
    got = [ln for ln in lines if ln.startswith(prefix)]
    assert len(got) == 1, (prefix, lines)
    return got[0]


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_do_twin_gives_the_examples_contigs(tmp_path):
    args = ["--genome-bp", "8000", "--cpu"]
    port = start(["-m", "damar_tpu_torch.tools.do", str(tmp_path / "port"),
                  *args])
    ref = start(["examples/do.py", str(tmp_path / "ref"), *args])
    (rc_p, got), (rc_r, want) = finish(port), finish(ref)
    assert rc_p == rc_r == 0
    for prefix in ("== simulated", "== contigs:", "== longest contig",
                   "== PASS"):
        assert line(got, prefix) == line(want, prefix)
    contigs = read(tmp_path / "port" / "CONTIGS.fasta")
    assert contigs == read(tmp_path / "ref" / "CONTIGS.fasta")
    assert line(got, "== CONTIGS.fasta sha256") == (
        f"== CONTIGS.fasta sha256 {hashlib.sha256(contigs).hexdigest()}")
    assert "'assemble'" in line(got, "== phase walls")


SUMMARY = re.compile(r"== span ([\d.]+)%  longest (\d+)  k16 ([\d.]+)  "
                     r"~identity ([\d.]+)  wall (\d+)s$")


def test_soak_twin_gives_run_pipelines_contigs(tmp_path):
    args = ["--genome-bp", "10000"]
    port = start(["-m", "damar_tpu_torch.tools.soak", "--workdir",
                  str(tmp_path / "port"), *args, "--cpu"])
    ref = start(["scripts/soak.py", "--workdir", str(tmp_path / "ref"),
                 *args])
    (rc_p, got), (rc_r, want) = finish(port), finish(ref)
    assert rc_p == rc_r == 0
    for name in ("reads.fasta", "CONTIGS.fasta"):
        assert read(tmp_path / "port" / name) == read(tmp_path / "ref" / name)
    assert line(got, "== contigs") == line(want, "== contigs")
    summary = [SUMMARY.match(line(x, "== span")) for x in (got, want)]
    assert all(summary), (got, want)
    assert summary[0].groups()[:4] == summary[1].groups()[:4]
    assert float(summary[0].group(1)) > 85.0


def test_twins_need_a_card_without_cpu(tmp_path):
    """Without --cpu both twins take the card, and without one they
    raise before simulating anything (this box has no CUDA device)."""
    import torch
    assert not torch.cuda.is_available()
    for args in (["damar_tpu_torch.tools.do", str(tmp_path / "do")],
                 ["damar_tpu_torch.tools.soak", "--workdir",
                  str(tmp_path / "soak")]):
        p = start(["-m", *args])
        out, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode != 0 and "no CUDA device" in err, (out, err)
        assert not os.path.exists(args[-1])
