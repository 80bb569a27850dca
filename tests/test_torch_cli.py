"""Port vs reference for the command-line toolbox: every tool of
damar_tpu.cli through damar_tpu_torch.cli.main (DAMAR_PLATFORM=cpu, the
plain kernel versions) and damar_tpu.cli.main, in two directories, on one
small DB: tests/test_cli.py's data (a 30 kbp genome at 8x, mean read 3
kb, 12% error, seeds 81/82), `dbsplit -s 1 -x 1000`.

Every file a tool writes is byte-equal (.db/.idx/.bps, tracks, .las,
FASTA, graphml, SVG, tours JSON; the manifest but for its walls), and
each tool's stdout is equal once the program name is read as the other
package's and the walls (t_* stats, "(1.2s)", total_wall_s) are dropped.
The reference's retrace runs with native.available -> False (else it
takes its host C wide trace); its pile aligner (lashow -a, assemble
--polish) is its host C band_align, which K4 follows (fault 3j).  The
port side runs in a fresh process beside the reference (its stdout per
step written to a file).  Fault 3k: the reference's `datander -b B`
writes the whole-DB track, so its rendered per-block masking keeps only
the last block and `tkmerge tan` finds no block track; the port writes
block B's track.  Tolerance: exact equality."""
import contextlib
import filecmp
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from damar_tpu import cli as ref_cli
from damar_tpu import native
from damar_tpu.utils.sim import make_genome, sample_reads, write_sim_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCFG = ["-l", "800"]

# (name, argv with {d} for the tool's directory, reference needs its
# native C): run in this order in both directories
STEPS = [
    ("fasta2db", ["fasta2db", "{d}/E.db", "{d}/../reads.fasta"], False),
    ("dbsplit", ["dbsplit", "{d}/E.db", "-s", "1", "-x", "1000"], False),
    ("dbstats", ["dbstats", "{d}/E.db"], False),
    ("dbshow", ["dbshow", "{d}/E.db", "0", "3", "--limit", "50"], False),
    ("db2fasta", ["db2fasta", "{d}/E.db", "-o", "{d}/back.fasta",
                  "--width", "70"], False),
    ("dbdust", ["dbdust", "{d}/E.db"], False),
    ("datander", ["datander", "{d}/E.db"], False),
    ("daligner", ["daligner", "{d}/E.db", "1", "1", "-o", "{d}/dal.las"],
     False),
    ("hpc-plan", ["hpc-plan", "{d}/E.db"], False),
    ("overlap-all", ["overlap-all", "{d}/E.db", "-m", "dust", "-m", "tan"]
     + OCFG, False),
    ("lacheck", ["lacheck", "{d}/E.db", "{d}/E.1.las", "{d}/dal.las"],
     False),
    ("lasort", ["lasort", "{d}/cat.las"], False),
    ("lamerge", ["lamerge", "{d}/merged.las", "{d}/E.1.las",
                 "{d}/dal.las"], False),
    ("lashow", ["lashow", "{d}/E.1.las", "--limit", "12"], False),
    ("lashow-a", ["lashow", "{d}/E.1.las", "--limit", "3", "-a", "--db",
                  "{d}/E.db"], True),
    ("repmask", ["repmask", "{d}/E.db", "{d}/E.1.las"], False),
    ("repmask-c", ["repmask", "{d}/E.db", "{d}/E.1.las", "-c", "6"],
     False),
    ("tkmerge", ["tkmerge", "{d}/E.db", "dust"], False),
    ("tkcombine", ["tkcombine", "{d}/E.db", "mask", "dust", "tan",
                   "--mode", "union"], False),
    ("tkshow", ["tkshow", "{d}/E.db", "mask", "0", "1", "2"], False),
    ("lastitch", ["lastitch", "{d}/E.db", "{d}/E.1.las", "-b", "1", "-o",
                  "{d}/st.las"], False),
    ("laq", ["laq", "{d}/E.db", "{d}/st.las"], False),
    ("lafix", ["lafix", "{d}/E.db", "{d}/st.las", "{d}/fix.fasta"], False),
    ("lagap", ["lagap", "{d}/E.db", "{d}/st.las"], False),
    ("lafilter", ["lafilter", "{d}/E.db", "{d}/st.las", "-o",
                  "{d}/filt.las"], False),
    ("lafilter-p", ["lafilter", "{d}/E.db", "{d}/st.las", "-p", "-o",
                    "{d}/purged.las", "--repeat-track", "rep"], False),
    ("lasplit", ["lasplit", "{d}/E.db", "{d}/filt.las"], False),
    ("ogbuild", ["ogbuild", "{d}/E.db", "{d}/filt.las", "{d}/g.graphml"],
     False),
    ("oglayout", ["oglayout", "{d}/E.db", "{d}/filt.las",
                  "{d}/l.graphml", "--svg", "{d}/l.svg"], False),
    ("ogtour", ["ogtour", "{d}/E.db", "{d}/filt.las", "{d}/tours.json"],
     False),
    ("tour2fasta", ["tour2fasta", "{d}/E.db", "{d}/tours.json",
                    "{d}/tours.fasta"], False),
    ("assemble", ["assemble", "{d}/E.db", "{d}/filt.las", "{d}/asm.fasta"],
     False),
    ("assemble-polish", ["assemble", "{d}/E.db", "{d}/filt.las",
                         "{d}/asmp.fasta", "--polish"], True),
    ("ctanalyze", ["ctanalyze", "{d}/E.db", "{d}/filt.las",
                   "--genome-size", "30000"], False),
    ("lacat", ["lacat", "{d}/cat2.las", "{d}/E.1.las", "{d}/dal.las"],
     False),
    ("dbrm", ["dbrm", "{d}/E.db"], False),
]
TOOLS = sorted({s[1][0] for s in STEPS} | {"pipeline"})

# what runs before a step, in both directories: lasort sorts a cat of two
# files, tkmerge merges the dust track copied as block 1's
PRE = """
def pre(name, d, cli):
    if name == "lasort":
        cli.main(["lacat", f"{d}/cat.las", f"{d}/dal.las", f"{d}/E.1.las"])
    if name == "tkmerge":
        for ext in ("anno", "data"):
            shutil.copy(f"{d}/.E.dust.{ext}", f"{d}/.E.1.dust.{ext}")
"""
exec(PRE)

# the port's side: the steps in a fresh process, each step's stdout (and
# exit code) saved as JSON
PORT_RUNNER = """
import contextlib, io, json, os, shutil, sys
import torch
torch.set_num_threads(2)
from damar_tpu_torch import cli
steps, d, out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
res = {}
""" + PRE + """
for name, argv in steps:
    pre(name, d, cli)
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main([a.format(d=d) for a in argv])
        except SystemExit as e:
            code = e.code or 0
    res[name] = [buf.getvalue(), code]
    if name == "lacat":         # the files before dbrm removes some
        shutil.copytree(d, d + "_snap")
with open(out, "w") as f:
    json.dump(res, f)
"""


def _norm(text: str, prog: str, d: str) -> str:
    """stdout with the program name read as the other package's, the
    tool's directory as {d} and the walls dropped."""
    text = text.replace(d, "{d}")
    text = text.replace(f"{prog}.cli", "PROG.cli").replace(
        f"# {prog} job", "# PROG job")
    text = re.sub(r"'t_[a-z0-9_]+': [0-9.e-]+,? ?", "", text)
    text = re.sub(r"\(\d+\.\ds\)", "(WALL)", text)
    text = re.sub(r'"total_wall_s": [0-9.e-]+', '"total_wall_s": W', text)
    return text


def _files(d: str) -> list[str]:
    return sorted(os.listdir(d))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    g = make_genome(30_000, seed=81)
    sim = sample_reads(g, coverage=8, mean_len=3000, err=0.12, seed=82,
                       min_len=1500)
    write_sim_fasta(str(base / "reads.fasta"), sim)
    rd, pd = str(base / "ref"), str(base / "port")
    os.makedirs(rd)
    os.makedirs(pd)
    env = dict(os.environ, DAMAR_PLATFORM="cpu", PYTHONPATH=REPO)
    port = subprocess.Popen(
        [sys.executable, "-c", PORT_RUNNER,
         json.dumps([(n, a) for n, a, _ in STEPS]), pd,
         str(base / "port.json")], env=env, cwd=str(base))
    ref_out = {}
    mp = pytest.MonkeyPatch()
    real = native.available
    try:
        for name, argv, with_native in STEPS:
            mp.setattr(native, "available",
                       real if with_native else (lambda: False))
            pre(name, rd, ref_cli)  # noqa: F821 (exec'd from PRE)
            buf = io.StringIO()
            code = 0
            with contextlib.redirect_stdout(buf):
                try:
                    ref_cli.main([a.format(d=rd) for a in argv])
                except SystemExit as e:
                    code = e.code or 0
            ref_out[name] = [buf.getvalue(), code]
            if name == "lacat":      # the files before dbrm removes some
                shutil.copytree(rd, rd + "_snap")
    finally:
        mp.undo()
    assert port.wait(timeout=600) == 0
    with open(base / "port.json") as f:
        port_out = json.load(f)
    return dict(base=str(base), rd=rd, pd=pd, ref=ref_out, port=port_out)


def test_every_tool_is_ported():
    from damar_tpu_torch import cli
    names = lambda c: sorted(a for a in c.build_parser()._subparsers  # noqa: E731
                             ._group_actions[0].choices)
    assert names(cli) == names(ref_cli) == TOOLS and len(TOOLS) == 33


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_stdout_equal(runs, name):
    got, want = runs["port"][name], runs["ref"][name]
    assert got[1] == want[1]
    assert _norm(got[0], "damar_tpu_torch", runs["pd"]) == \
        _norm(want[0], "damar_tpu", runs["rd"])


# the files of the whole run, in both directories, before dbrm
SNAP_FILES = [
    "E.db", ".E.idx", ".E.bps", "back.fasta", ".E.dust.anno",
    ".E.dust.data", ".E.tan.anno", ".E.tan.data", "dal.las", "E.1.E.1.las",
    "E.1.las", "cat.las", "merged.las", ".E.repeats.anno",
    ".E.repeats.data", ".E.rep.anno", ".E.rep.data", ".E.mask.anno",
    ".E.mask.data", "st.las", ".E.q.anno", ".E.q.data", ".E.trim.anno",
    ".E.trim.data", "fix.fasta", "filt.las", "purged.las", "g.graphml",
    "l.graphml", "l.svg", "tours.json", "tours.fasta", "asm.fasta",
    "asmp.fasta", "cat2.las"]


@pytest.mark.parametrize("name", SNAP_FILES)
def test_files_byte_equal(runs, name):
    assert filecmp.cmp(f"{runs['rd']}_snap/{name}",
                       f"{runs['pd']}_snap/{name}", shallow=False)


def test_same_files_and_manifest(runs):
    """The same files in both directories (each DB's files gone after
    dbrm), and the overlap manifest equal but for its walls."""
    for d in ("", "_snap"):
        assert _files(runs["rd"] + d) == _files(runs["pd"] + d)
    assert set(SNAP_FILES) <= set(_files(runs["rd"] + "_snap"))
    assert not {"E.db", ".E.idx", ".E.bps"} & set(_files(runs["pd"]))

    def strip(d):
        with open(f"{d}/.E.overlap.manifest") as f:
            return re.sub(r'"wall": [0-9.e-]+', '"wall": 0', f.read())
    assert strip(runs["rd"]) == strip(runs["pd"])
    assert '"name": "merge.1"' in strip(runs["rd"])


def _plan_line(runs, tool: str) -> str:
    """The prologue and the first rendered `tool` line of the port's
    hpc-plan output."""
    lines = runs["port"]["hpc-plan"][0].splitlines()
    assert lines[0] == "# damar_tpu_torch job plan"
    assert lines[1] == f'export PYTHONPATH="{REPO}:$PYTHONPATH"'
    first = next(ln for ln in lines
                 if ln.startswith(f"python -m damar_tpu_torch.cli {tool} ")
                 and "#" not in ln)
    return lines[1] + "\n" + first + "\n"


def _plan_dir(runs, name: str) -> str:
    """A directory holding only the port's DB, away from the repo."""
    w = os.path.join(runs["base"], name)
    os.makedirs(w)
    for f in ("E.db", ".E.idx", ".E.bps"):
        shutil.copy(f"{runs['pd']}_snap/{f}", w)
    return w


def test_rendered_line_runs_as_is(runs):
    """A rendered daligner line, run as-is by a shell in another working
    directory with DAMAR_PLATFORM=cpu, writes the in-process daligner's
    file."""
    w = _plan_dir(runs, "plan_cpu")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["DAMAR_PLATFORM"] = "cpu"
    r = subprocess.run(["bash", "-c", _plan_line(runs, "daligner")],
                       cwd=w, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert filecmp.cmp(f"{w}/E.1.E.1.las", f"{runs['pd']}_snap/dal.las",
                       shallow=False)


def test_no_card_no_platform_exits_non_zero(runs):
    """Without a card and without DAMAR_PLATFORM the tool refuses to run
    (there is no silent CPU path); an unknown DAMAR_PLATFORM too."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    w = _plan_dir(runs, "plan_nocard")
    for plat in (None, "tpu"):
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "DAMAR_PLATFORM")}
        if plat:
            env["DAMAR_PLATFORM"] = plat
        r = subprocess.run(["bash", "-c", _plan_line(runs, "daligner")],
                           cwd=w, env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 1
        want = "no CUDA device" if plat is None else "DAMAR_PLATFORM='tpu'"
        assert "damar_tpu_torch daligner: error:" in r.stderr
        assert want in r.stderr
        assert not os.path.exists(f"{w}/E.1.E.1.las")


@pytest.mark.parametrize("nblocks", [1, 2, 3, 5])
@pytest.mark.parametrize("with_masking", [True, False])
def test_render_script(nblocks, with_masking):
    """render_script's text is damar_tpu's with the package name read as
    the port's, its PYTHONPATH prologue naming the same checkout."""
    from damar_tpu.pipeline import planner as ref_planner
    from damar_tpu_torch.pipeline import planner
    got = planner.render_script(planner.plan_block_pairs("E", nblocks),
                                db_root="E", with_masking=with_masking)
    want = ref_planner.render_script(
        ref_planner.plan_block_pairs("E", nblocks), db_root="E",
        with_masking=with_masking)
    assert got == want.replace("damar_tpu", "damar_tpu_torch")
    assert f'export PYTHONPATH="{REPO}:$PYTHONPATH"' in got


def test_init_multihost_launcher_contract(monkeypatch):
    """The launcher's variables give the host index and count with no
    collective; without a coordinator the host is 0, as in damar_tpu."""
    from damar_tpu.parallel import distributed as ref_dist
    from damar_tpu_torch.parallel import distributed as dist
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert dist.init_multihost() == ref_dist.init_multihost() == 0
    assert dist.num_hosts() == 1
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    assert dist.init_multihost() == 2 and dist.num_hosts() == 3
    assert dist.init_multihost(process_id=1) == 1
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    with pytest.raises(ValueError):
        dist.init_multihost()
