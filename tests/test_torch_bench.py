"""The port's twins of bench.py and scripts/profile_overlap.py
(damar_tpu_torch/tools/bench.py, tools/profile_overlap.py) on the CPU
(the plain kernel versions), against damar_tpu on its all-device route
(DAMAR_BP=jax from conftest, native.available -> False).  Tolerance:
byte equality of the .las records, equality of the aligned bp.

The twins' sim parameters are cut to short reads (a 20 kbp genome at 6x
of mean 1 kb for the pair; 2.2 Mbp of reads of mean 600 bp for the
3-block sweep, the least that db_split's 1 Mbp floor splits into 3
blocks) so that both packages' CPU forms finish in seconds; the configs'
caps, passes and OverlapConfig() are the bench's."""
import concurrent.futures
import hashlib
import json
import os
import re

import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.formats import dazzdb as ref_db
from damar_tpu.formats import las as ref_las
from damar_tpu.pipeline import overlap as ref_ov
from damar_tpu.pipeline.planner import run_overlap_plan as ref_plan
from damar_tpu.utils import sim as ref_sim
from damar_tpu_torch.formats.las import write_las
from damar_tpu_torch.pipeline import planner
from damar_tpu_torch.tools import bench, profile_overlap

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = dict(coverage=6.0, mean_len=1000)      # the pair's short reads
PAIR_GENOME = 20_000
CAPS = (1 << 22, 1 << 17)                     # small-2Mbp's, the script's
SWEEP = dict(coverage=3.1, mean_len=600)
SWEEP_GENOME = 700_000
# bench.py's keys, and what the twin adds
REF_KEYS = {"metric", "value", "unit", "vs_baseline", "config",
            "small_gbp_s", "sweep_gbp_s", "provenance"}
ADDED_KEYS = {"device", "torch", "cuda", "commit"}
TPU_FILES = (".bench_history.jsonl", ".bench_last_tpu.json")


@pytest.fixture()
def device_route(monkeypatch):
    from damar_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("DAMAR_BP", "jax")


def ref_reads(genome_bp, coverage, mean_len):
    g = ref_sim.make_genome(genome_bp, seed=bench.SEED)
    return ref_sim.sample_reads(g, coverage=coverage, mean_len=mean_len,
                                err=bench.ERR, seed=bench.SEED + 1)


@pytest.fixture(scope="module")
def ref_pair():
    """damar_tpu's self pair of the pair's reads on its device route, at
    the small config's caps, mirrors off."""
    from damar_tpu import native
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setenv("DAMAR_BP", "jax")
        blk = ref_block(ref_reads(PAIR_GENOME, **PAIR).reads)
        st = ref_ov.overlap_pair_device(blk, blk, RefConfig(), True,
                                        hit_cap=CAPS[0], seed_cap=CAPS[1],
                                        emit_mirrors=False)
        las_a, _, stats = ref_ov.overlap_pair_emit(st, trace_host=False)
    return las_a, stats


def digests() -> dict:
    out = {}
    for f in TPU_FILES + (bench.HISTORY,):
        p = os.path.join(ROOT, f)
        out[f] = (hashlib.sha256(open(p, "rb").read()).hexdigest()
                  if os.path.exists(p) else None)
    return out


def test_pair_pass_equals_reference(ref_pair, monkeypatch, tmp_path):
    """(a) run_config's timed pass: the reference's .las bytes and aligned
    bp; the pipelined pairs run too (two of them here: a CPU pass takes
    ~1.5 s at any size, its plain K1/K2 stepping row by row) and the
    value is the larger rate."""
    want, want_stats = ref_pair
    monkeypatch.setattr(bench, "PIPELINED_PAIRS", 2)
    got = bench.run_config(PAIR_GENOME, *CAPS, warmups=0, rounds=1,
                           label="pair", pipelined=True, device="cpu",
                           **PAIR)
    assert got["las"].novl == want.novl > 0
    assert got["aligned_bp"] == int(want.a_spans().sum())
    ref_las.write_las(str(tmp_path / "ref.las"), want)
    write_las(str(tmp_path / "port.las"), got["las"])
    assert (tmp_path / "port.las").read_bytes() == \
        (tmp_path / "ref.las").read_bytes()
    for k in ("seeds", "extents", "kept", "dropped_trace"):
        assert got["stats"][k] == want_stats[k], k
    assert got["gbp_s"] == max(got["pipelined_gbp_s"],
                               got["aligned_bp"] / got["walls"][0] / 1e9)


def test_sweep_equals_reference(device_route, monkeypatch, tmp_path):
    """(b) run_sweep_config at 3 blocks: the reference's aligned bp over
    the same DB split, and no .las file or manifest left when the warm
    run starts.  The port runs in a thread beside the reference."""
    seen = []
    real = planner.run_overlap_plan

    def spy(db_path, *a, **kw):
        d = os.path.dirname(db_path)
        seen.append(sorted(f for f in os.listdir(d) if f.endswith(".las")
                           or ".overlap.manifest" in f))
        return real(db_path, *a, **kw)
    monkeypatch.setattr(planner, "run_overlap_plan", spy)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(bench.run_sweep_config, SWEEP_GENOME, 3, "sweep",
                        device="cpu", **SWEEP)
        sim = ref_reads(SWEEP_GENOME, **SWEEP)
        w = str(tmp_path)
        ref_sim.write_sim_fasta(f"{w}/reads.fasta", sim)
        ref_db.create_db(f"{w}/S.db", [f"{w}/reads.fasta"])
        total = sum(len(r) for r in sim.reads)
        ref_db.db_split(f"{w}/S.db", size_mb=max(1, int(total / 3 / 1e6)),
                        cutoff=0)
        ref_plan(f"{w}/S.db", RefConfig(), verbose=False)
        n = ref_db.DazzDB.open(f"{w}/S.db").nblocks
        want = sum(int(ref_las.read_las(f"{w}/S.{i}.las").a_spans().sum())
                   for i in range(1, n + 1)) // 2
        got = fut.result()
    assert n == got["blocks"] == 3 and got["pairs"] == 6
    assert got["aligned_bp"] == want > 0
    assert seen == [[], []]


@pytest.mark.parametrize("argv", [["--cpu"], ["--cpu", "--quick"]],
                         ids=["small", "quick"])
def test_json_line(argv, monkeypatch, capsys):
    """(c) The last line: bench.py's keys plus device, torch, cuda and
    commit, provenance "cpu-requested", the CPU named; (e) the JAX
    package's TPU files and the port's history file are untouched by a
    --cpu run."""
    before = digests()
    monkeypatch.setattr(bench, "GENOME", PAIR_GENOME)
    monkeypatch.setattr(bench, "GENOME_QUICK", PAIR_GENOME)
    real = bench.run_config

    def one_pass(*a, **kw):      # the line's keys need no warmup or best-of
        return real(*a, **dict(kw, warmups=0, rounds=1, **PAIR))
    monkeypatch.setattr(bench, "run_config", one_pass)
    assert bench.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert REF_KEYS | ADDED_KEYS <= set(rec)
    assert rec["metric"] == "overlap_aligned_throughput"
    assert rec["unit"] == "Gbp-aligned/s/gpu"
    assert rec["provenance"] == "cpu-requested"
    assert rec["config"] == ("quick-10Mbp" if "--quick" in argv
                             else "small-2Mbp")
    assert rec["value"] > 0
    assert rec["vs_baseline"] == rec["value"] / bench.REF_CPU_GBP_S
    assert rec["small_gbp_s"] == (None if "--quick" in argv
                                  else rec["value"])
    assert rec["sweep_gbp_s"] is None
    assert rec["device"]["platform"] == "cpu" and rec["device"]["name"]
    assert rec["torch"] == torch.__version__
    assert rec["commit"] is None or len(rec["commit"]) >= 7
    assert sum(rec["launches"].values()) == 0      # plain versions only
    assert digests() == before


def test_history_is_the_ports_own(tmp_path):
    """(e) A card run's line goes to the port's history file, in a
    directory git ignores, never to the JAX package's TPU files."""
    before = digests()
    assert os.path.dirname(bench.HISTORY) == os.path.join(ROOT,
                                                          "chiprun_out")
    assert "chiprun_out/" in open(os.path.join(ROOT, ".gitignore")).read()
    path = str(tmp_path / "h" / "history.jsonl")
    for v in (1.0, 2.0):
        bench.append_history({"value": v}, path)
    lines = [json.loads(ln) for ln in open(path)]
    assert [ln["value"] for ln in lines] == [1.0, 2.0]
    assert all("measured_at" in ln for ln in lines)
    assert digests() == before


@pytest.mark.parametrize("twin", [bench, profile_overlap],
                         ids=["bench", "profile_overlap"])
def test_no_card_raises_before_any_data(twin, monkeypatch):
    """(d) Without a card and without --cpu: an error naming the missing
    card, before the reads are simulated."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_sim(*a, **kw):
        raise AssertionError("simulated data without a device")
    monkeypatch.setattr(bench, "simulate", no_sim)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main([])


@pytest.mark.parametrize("twin,argv", [
    (bench, ["--profile", "--cpu"]), (bench, ["--profile", "--quick"]),
    (profile_overlap, ["--seed-batch", "1024", "--cpu"])],
    ids=["profile_cpu", "profile_quick", "seed_batch"])
def test_refused_flags(twin, argv, capsys):
    """--profile wraps large-50Mbp, which --cpu and --quick skip;
    --seed-batch has no counterpart in the port."""
    with pytest.raises(SystemExit) as e:
        twin.main(argv)
    assert e.value.code == 2
    assert "--" in capsys.readouterr().err


def test_profile_prints_every_phase(ref_pair, capsys):
    """(f) Each of the four passes prints the pass wall, every phase wall
    overlap_block_pair records and the reference's aligned bp."""
    want = int(ref_pair[0].a_spans().sum())
    out = profile_overlap.profile(PAIR_GENOME, device="cpu", **PAIR)
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if not ln.startswith("#")]
    assert [ln.split(":")[0] for ln in lines] == list(profile_overlap.LABELS)
    for ln, st in zip(lines, out):
        for k in profile_overlap.PHASES + profile_overlap.TRACE_PARTS:
            assert re.search(rf"[ (]{k} [0-9.]+[ )]", ln), (k, ln)
        assert f"({want} bp)" in ln
        assert st["aligned_bp"] == want
    assert all(k in err for k in profile_overlap.PHASE_END)
