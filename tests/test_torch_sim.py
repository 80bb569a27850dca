"""Port vs reference for the host layer: the simulator gives the same
reads from the same seed, blocks are byte-equal, the .las writer and
reader round-trip, and importing damar_tpu_torch loads neither jax nor
damar_tpu.  Tolerance: exact equality."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.blocks import revcomp_block as ref_revcomp
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.formats.las import read_las as ref_read_las
from damar_tpu.utils import sim as ref_sim
from damar_tpu_torch.core.blocks import block_from_reads, revcomp_block
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import (LasColumns, LasFile, check_las,
                                         encode_trace_columns,
                                         read_las_columns, write_las)
from damar_tpu_torch.utils import sim

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("genome,cov,mean,seed,chim", [
    (30_000, 6.0, 3000, 4, 0.0), (12_000, 10.0, 1500, 9, 0.1)])
def test_same_reads_from_same_seed(genome, cov, mean, seed, chim):
    g_ref = ref_sim.make_genome(genome, seed=seed, n_repeats=2, tandem=1)
    g = sim.make_genome(genome, seed=seed, n_repeats=2, tandem=1)
    np.testing.assert_array_equal(g, g_ref)
    ref = ref_sim.sample_reads(g_ref, coverage=cov, mean_len=mean,
                               err=0.14, seed=seed + 1, chimera_frac=chim)
    got = sim.sample_reads(g, coverage=cov, mean_len=mean, err=0.14,
                           seed=seed + 1, chimera_frac=chim)
    assert len(got.reads) == len(ref.reads)
    for a, b in zip(got.reads, ref.reads):
        np.testing.assert_array_equal(a, b)
    for k in ("start", "end", "strand", "chimeric"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))


def test_unit_batch_matches_reference_fuzz_helper():
    from test_native_bp import _unit_batch
    for a, b in zip(sim.unit_batch(np.random.default_rng(5), 20),
                    _unit_batch(np.random.default_rng(5), 20)):
        np.testing.assert_array_equal(a, b)


def test_blocks_byte_equal():
    reads = ref_sim.sample_reads(ref_sim.make_genome(20_000, seed=2), 5.0,
                                 2000, seed=3).reads
    ids = np.arange(100, 100 + len(reads))
    for ours, ref in ((block_from_reads(reads, ids=ids),
                       ref_block(reads, ids=ids)),):
        for k in ("bases", "starts", "read_id", "rlen", "ids"):
            np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
        np.testing.assert_array_equal(revcomp_block(ours).bases,
                                      ref_revcomp(ref).bases)


def test_config_defaults_match():
    """Every field of the port's config is the reference's, with the same
    default (dp_kernel among them: "bp", with "wide" the other legal
    value); the reference's extra fields are launch widths and the
    Pallas switch, which have no counterpart in the port."""
    from dataclasses import asdict
    ours, ref = asdict(OverlapConfig()), asdict(RefConfig())
    assert ours == {k: ref[k] for k in ours}
    assert set(ref) - set(ours) == {"seed_batch", "seed_batch_dev",
                                    "use_pallas"}
    assert ours["dp_kernel"] == "bp"


def _small_las(tspace=100):
    """Two well-formed records: each trace segment spans its A segment
    exactly in B with 2 diffs."""
    recs = [(0, 1, 0, 50, 230, 10), (1, 0, 1, 160, 300, 0)]
    h = np.zeros((len(recs), 10), np.int32)
    rows, offs = [], [0]
    for i, (ar, br, comp, ab, ae, bb) in enumerate(recs):
        cuts = list(range((ab // tspace + 1) * tspace, ae, tspace))
        edges = [ab] + cuts + [ae]
        seg = [(2, e1 - e0) for e0, e1 in zip(edges[:-1], edges[1:])]
        rows += seg
        offs.append(len(rows))
        h[i, :9] = (2 * len(seg), 2 * len(seg), ab, bb, ae,
                    bb + ae - ab, comp, ar, br)
    payload, boffs = encode_trace_columns(np.array(rows, np.int32),
                                          np.array(offs), tspace <= 125)
    return LasFile(tspace, columns=LasColumns(h, payload, boffs))


@pytest.mark.parametrize("tspace", [100, 200])
def test_las_roundtrip_readable_by_reference(tmp_path, tspace):
    las = _small_las(tspace)
    rlen = np.array([400, 400])
    assert check_las(las, rlen) == []
    p = tmp_path / "x.las"
    write_las(str(p), las)
    ts, cols = read_las_columns(str(p))
    assert ts == tspace
    np.testing.assert_array_equal(cols.headers, las.columns.headers)
    np.testing.assert_array_equal(cols.trace, las.columns.trace)
    ref = ref_read_las(str(p))
    np.testing.assert_array_equal(ref.columns.headers, cols.headers)


def test_check_las_reports_faults(tmp_path):
    las = _small_las()
    las.columns.headers[0, 5] = 500           # bepos past the read
    assert any("bad B interval" in e for e in check_las(las, [400, 400]))
    p = tmp_path / "t.las"
    write_las(str(p), _small_las())
    p.write_bytes(p.read_bytes()[:-3])
    with pytest.raises(ValueError):
        read_las_columns(str(p))


# every module of the port that holds code; the import check below must
# have walked each of them
PORT_MODULES = [f"damar_tpu_torch.{m}" for m in (
    "cli", "core.blocks", "core.config", "formats.dazzdb", "formats.fasta",
    "formats.las", "formats.oflags", "formats.qv", "formats.qv_huff",
    "formats.tracks", "ops._cuda",
    "ops.band_align", "ops.kmers", "ops.seeding", "ops.sort",
    "ops.wave_bp", "ops.wave_wide", "ops.words", "parallel.distributed",
    "pipeline.consensus", "pipeline.contigs", "pipeline.graph",
    "pipeline.masking", "pipeline.overlap", "pipeline.planner",
    "pipeline.poa", "pipeline.run", "pipeline.scrub", "pipeline.touring",
    "tools._card", "tools.assembly_report", "tools.bench",
    "tools.compare_wave_bp", "tools.do", "tools.profile_overlap",
    "tools.profile_window", "tools.seed_peaks", "tools.soak", "utils.dust",
    "utils.sim")]


def test_port_imports_no_jax():
    """Run in a subprocess: this test process already imported jax.  Every
    module is imported, the command line prints its help (the whole and
    a tool's), so do the worked example's and the soak's twins
    (tools/do.py, tools/soak.py) and the bench's and the pair profile's
    (tools/bench.py, tools/profile_overlap.py), and the ring sweep runs
    one rank on two small blocks (its lazy imports: torch.distributed,
    seeding, K1/K2's plain versions, the pair path's trace and retry
    helpers), without importing jax or damar_tpu."""
    code = (
        "import sys\n"
        "pre = set(sys.modules)\n"
        "import pkgutil, importlib, damar_tpu_torch\n"
        "seen = set()\n"
        "for m in pkgutil.walk_packages(damar_tpu_torch.__path__, "
        "'damar_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    seen.add(m.name)\n"
        f"missing = sorted(set({PORT_MODULES!r}) - seen)\n"
        "assert not missing, missing\n"
        "import contextlib, io\n"
        "from damar_tpu_torch import cli\n"
        "for argv in (['--help'], ['daligner', '--help']):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            cli.main(argv)\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, e.code\n"
        "    assert 'damar_tpu_torch' in buf.getvalue()\n"
        "from damar_tpu_torch.tools import do, soak\n"
        "for twin in (do, soak):\n"
        "    sys.argv = [twin.__name__, '--help']\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            twin.main()\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, e.code\n"
        "    assert '--cpu' in buf.getvalue()\n"
        "from damar_tpu_torch.tools import bench, profile_overlap\n"
        "for twin in (bench, profile_overlap):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            twin.main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, e.code\n"
        "    assert '--cpu' in buf.getvalue()\n"
        "import numpy as np, torch.distributed\n"
        "from damar_tpu_torch.core.blocks import block_from_reads\n"
        "from damar_tpu_torch.core.config import OverlapConfig\n"
        "from damar_tpu_torch.parallel import distributed as dd\n"
        "g = np.random.default_rng(3).integers(0, 4, 3000).astype(np.uint8)\n"
        "blocks = [block_from_reads([g[o:o + 1500]], cap=1 << 12)\n"
        "          for o in (0, 1000)]\n"
        "las, _, _ = dd.distributed_overlap_las(\n"
        "    blocks, OverlapConfig(min_len=300), device='cpu')\n"
        "assert las[0].novl == 1 and las[1].novl == 1\n"
        "bad = sorted(k for k in set(sys.modules) - pre if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'damar_tpu.')) or k == 'damar_tpu')\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"


def test_tour_and_pipeline_config_defaults_match():
    """TourConfig is the reference's, field for field; PipelineConfig has
    its phases' configs and the same block size and read cutoff."""
    from dataclasses import asdict
    from damar_tpu.core.config import PipelineConfig as RefPipe
    from damar_tpu.core.config import TourConfig as RefTour
    from damar_tpu_torch.core.config import PipelineConfig, TourConfig
    assert asdict(TourConfig()) == asdict(RefTour())
    ours, ref = asdict(PipelineConfig()), asdict(RefPipe())
    assert set(ours) == set(ref)
    for k in ("mask", "scrub", "tour", "block_mb", "min_read_len"):
        assert ours[k] == ref[k], k
    assert ours["overlap"] == {k: ref["overlap"][k] for k in ours["overlap"]}


def test_kmer_hit_rate_matches():
    from damar_tpu.utils.sim import kmer_hit_rate as ref_rate
    from damar_tpu_torch.utils.sim import kmer_hit_rate, make_genome, mutate
    rng = np.random.default_rng(4)
    g = make_genome(5000, seed=5)
    for contig in (mutate(g[100:3000], 0.02, rng),
                   (g[::-1] ^ 3)[:2000].copy(), g[:10], g[:17]):
        assert kmer_hit_rate(g, contig) == ref_rate(g, contig)
