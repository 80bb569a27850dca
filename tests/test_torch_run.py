"""Port vs reference for the whole pipeline, run_pipeline (damar_tpu/
pipeline/run.py): FASTA -> DB -> masks -> overlap -> patch -> overlap ->
scrub -> graph, tour, read correction, polish and the raw-read finishing
rounds -> CONTIGS.fasta and report.json, with polish, on the 12 kbp
genome of tests/test_pipeline_extras.py, through both packages from the
same FASTA.  CONTIGS.fasta and every .las, track and FIX.fasta are
byte-equal, report.json equal but for its walls and paths; a second run
of the port resumes (both overlap rounds skipped).

The reference runs on its all-device route (DAMAR_BP=jax from conftest,
native.available -> False for its retrace), with its default seeding
caps: every pair's hits and the tandem search's stay under them (checked
on the port's side), so neither run is cut short (fault 3h of the
reference does not show).  Its pile aligner is its host C band_align;
the port's is K4's plain version.  The port runs in a thread beside the
reference.  Tolerance: exact equality."""
import filecmp
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from damar_tpu import native
from damar_tpu.core.config import PipelineConfig as RefPipelineConfig
from damar_tpu.pipeline.run import run_pipeline as ref_run_pipeline
from damar_tpu_torch.core.config import PipelineConfig
from damar_tpu_torch.ops import seeding
from damar_tpu_torch.pipeline import masking, overlap
from damar_tpu_torch.pipeline.run import run_pipeline
from damar_tpu_torch.utils import sim

torch.set_num_threads(2)
REF_HIT_CAP, REF_TANDEM_HIT_CAP = 1 << 21, seeding.REF_TANDEM_HIT_CAP


def _reads():
    g = sim.make_genome(12_000, seed=81)
    return g, sim.sample_reads(g, coverage=10, mean_len=2500, err=0.13,
                               seed=82)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("run")
    g, reads = _reads()
    fa = str(base / "reads.fasta")
    sim.write_sim_fasta(fa, reads)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    mp.setenv("DAMAR_BP", "jax")
    hits, tandem = [], []
    real_seeds, real_tandem = overlap.find_seeds_canonical_dev, \
        masking.find_tandem_seeds

    def seeds_spy(*a, **kw):
        s = real_seeds(*a, **kw)
        hits.append(int(s["total_hits"]))
        return s

    def tandem_spy(*a, **kw):
        s = real_tandem(*a, **kw)
        tandem.append(int(s["total_hits"]))
        return s
    mp.setattr(overlap, "find_seeds_canonical_dev", seeds_spy)
    mp.setattr(masking, "find_tandem_seeds", tandem_spy)
    cfg = PipelineConfig(block_mb=1, min_read_len=500)
    ref_cfg = RefPipelineConfig(block_mb=1, min_read_len=500)
    pw, rw = str(base / "port"), str(base / "ref")
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(run_pipeline, fa, pw, cfg, polish=True,
                              verbose=False, device="cpu")
            want = ref_run_pipeline(fa, rw, ref_cfg, polish=True,
                                    verbose=False)
            got = fut.result()
    finally:
        mp.undo()
    # the rerun resumes in a copy (it rewrites CONTIGS.fasta and
    # report.json)
    aw = str(base / "again")
    shutil.copytree(pw, aw)
    again = run_pipeline(fa, aw, cfg, polish=False, verbose=False,
                         device="cpu")
    return dict(pw=pw, rw=rw, got=got, want=want, again=again, hits=hits,
                tandem=tandem, genome=g)


def _strip(report, path):
    """report.json without walls and paths."""
    out = json.loads(json.dumps(report))
    out.pop("total_wall_s")
    assert out.pop("contig_fasta") == os.path.join(path, "CONTIGS.fasta")
    for ph in out["phases"].values():
        ph.pop("wall_s")
    return out


def test_contigs_byte_equal(runs):
    assert filecmp.cmp(f"{runs['pw']}/CONTIGS.fasta",
                       f"{runs['rw']}/CONTIGS.fasta", shallow=False)
    a = runs["got"]["phases"]["assemble"]
    assert a["contigs"] >= 1 and a["lengths"][0] > 0.8 * len(runs["genome"])


def test_report_equal_but_walls(runs):
    for r, w in ((runs["got"], runs["pw"]), (runs["want"], runs["rw"])):
        with open(f"{w}/report.json") as f:
            assert json.load(f) == json.loads(json.dumps(r))
    assert _strip(runs["got"], runs["pw"]) == _strip(runs["want"],
                                                     runs["rw"])


@pytest.mark.parametrize("name", [
    "RAW.1.las", ".RAW.dust.anno", ".RAW.dust.data", ".RAW.tan.anno",
    ".RAW.tan.data", "FIX.fasta", "FIX.1.las", "FIX.merged.las",
    ".FIX.q.anno", ".FIX.q.data", ".FIX.trim.anno", ".FIX.trim.data",
    "FIX.scrubbed.las", "FIX.filtered.las"])
def test_files_byte_equal(runs, name):
    assert os.path.exists(f"{runs['rw']}/{name}")
    assert filecmp.cmp(f"{runs['pw']}/{name}", f"{runs['rw']}/{name}",
                       shallow=False), name


def test_no_run_was_cut_short(runs):
    """Both runs in the regime where the reference's caps do not cut:
    every pair's hits under 2^21 (its overlap default) and the tandem
    search's under 2^20."""
    assert len(runs["hits"]) == 2 and len(runs["tandem"]) == 1
    assert max(runs["hits"]) < REF_HIT_CAP
    assert max(runs["tandem"]) < REF_TANDEM_HIT_CAP


def test_rerun_resumes(runs):
    ph = runs["again"]["phases"]
    for name in ("overlap1", "overlap2"):
        assert ph[name]["pairs"] == 0 and ph[name]["skipped"] == 1
    assert ph["assemble"]["contigs"] >= 1
    assert ph["scrub"] == {**runs["got"]["phases"]["scrub"],
                           "wall_s": ph["scrub"]["wall_s"]}


def test_device_defaults_to_the_card(tmp_path):
    """run_pipeline's device is the card unless the caller asks for the
    CPU; without a card it raises before touching the workdir."""
    import inspect
    assert inspect.signature(run_pipeline).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline("reads.fasta", str(tmp_path / "w"), verbose=False)
    assert not os.path.exists(tmp_path / "w")


def test_hard_genome_phase7_resumes(tmp_path):
    """Phase 7 alone on a copy of damar_tpu's workdir of the hard-assembly
    genome (tests/test_hard_assembly.py: repeats, a tandem array, 6%
    chimeric reads; made with its native host kernels, the same files as
    its device route): with CONTIGS.fasta and report.json deleted, the
    port resumes there (every earlier phase finds its files) and writes
    the reference's contigs.  Polish off: K4's plain version takes
    minutes for this genome's polish on a CPU, so the polish is held here
    on the 12 kbp genome above and by tests/test_torch_consensus.py."""
    g = sim.make_genome(60_000, seed=41, n_repeats=3, repeat_len=1500,
                        tandem=1, tandem_period=90, tandem_len=1800)
    reads = sim.sample_reads(g, coverage=14, mean_len=4500, err=0.13,
                             seed=42, chimera_frac=0.06)
    rw, pw = str(tmp_path / "ref"), str(tmp_path / "port")
    os.makedirs(rw)
    fa = os.path.join(rw, "reads.fasta")
    sim.write_sim_fasta(fa, reads)
    mp = pytest.MonkeyPatch()
    mp.setenv("DAMAR_BP", "native")
    try:
        want = ref_run_pipeline(fa, rw, polish=False, verbose=False)
    finally:
        mp.undo()
    shutil.copytree(rw, pw)
    for f in ("CONTIGS.fasta", "report.json"):
        os.remove(os.path.join(pw, f))
    got = run_pipeline(fa, pw, polish=False, verbose=False, device="cpu")
    assert filecmp.cmp(f"{pw}/CONTIGS.fasta", f"{rw}/CONTIGS.fasta",
                       shallow=False)
    ph, rph = got["phases"], want["phases"]
    for name in ("overlap1", "overlap2"):
        assert ph[name]["pairs"] == 0 and ph[name]["skipped"] == 1
    for name in ("ingest", "mask", "patch", "scrub", "assemble"):
        assert {k: v for k, v in ph[name].items() if k != "wall_s"} == \
            {k: v for k, v in rph[name].items() if k != "wall_s"}, name
    assert ph["assemble"]["circular"] == [True]
