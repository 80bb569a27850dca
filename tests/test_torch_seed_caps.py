"""Port fault 2, repaired: seeding that overflows its buffers is never cut
short in silence.

damar_tpu's overlap_pair_device stops growing its hit buffer at hit_cap
(default 2^21) and its seed buffer at 4 x seed_cap, then carries on with
what it kept: fewer overlaps and no word (its fault 3h; the first test
shows it on a small self block).  The port sizes both buffers from the
count phase's exact totals when the caps are left out (the default of
overlap_block_pair, run_overlap_plan and run_pipeline), so its seeding is
never cut; an explicit cap still reproduces the reference's buffers, and
run_overlap_plan refuses a pair that such a cap cut short: it raises,
naming the pair and its totals, and writes and marks nothing of it."""
import filecmp
import os

import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.pipeline import overlap as ref_overlap
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats import dazzdb, las
from damar_tpu_torch.pipeline import overlap
from damar_tpu_torch.pipeline.planner import Manifest, run_overlap_plan
from damar_tpu_torch.utils import sim

torch.set_num_threads(2)
SMALL_HIT_CAP = 1 << 12


def _reads():
    """~105 kbp of reads (31) over a 20 kbp genome: one self block of
    ~7,500 hits."""
    g = sim.make_genome(20_000, seed=5)
    return sim.sample_reads(g, coverage=5, mean_len=3000, err=0.13,
                            seed=6)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    w = tmp_path_factory.mktemp("caps")
    sim.write_sim_fasta(str(w / "reads.fasta"), _reads())
    dazzdb.create_db(str(w / "E.db"), [str(w / "reads.fasta")])
    dazzdb.db_split(str(w / "E.db"), size_mb=1, cutoff=500)
    return w


def test_reference_cuts_short_in_silence(monkeypatch):
    """Fault 3h: damar_tpu at a small hit_cap returns fewer overlaps than
    at a large one, and says nothing."""
    monkeypatch.setenv("DAMAR_BP", "native")
    reads = _reads().reads
    n = {cap: ref_overlap.overlap_block_pair(
        ref_block(reads), ref_block(reads), RefConfig(), True,
        hit_cap=cap)[0].novl for cap in (SMALL_HIT_CAP, 1 << 24)}
    assert 0 < n[SMALL_HIT_CAP] < n[1 << 24]


def test_sized_buffers_hold_every_hit(db):
    """No caps: the sweep's file is the bytes of a large explicit cap,
    and the pair's seeding did not overflow (its hits exceed the small
    cap below, so that cap cuts)."""
    got = run_overlap_plan(str(db / "E.db"), OverlapConfig(), verbose=False,
                           device="cpu")
    st = got["pair_stats"][0]
    assert not st["seed_overflow"] and st["total_hits"] > SMALL_HIT_CAP
    blk = block_from_reads(_reads().reads)
    la, lb, st2 = overlap.overlap_block_pair(blk, blk, OverlapConfig(), True,
                                             hit_cap=1 << 24, device="cpu")
    assert not st2["seed_overflow"]
    both = las.LasFile.concat([la, lb])
    both.sort()
    las.write_las(str(db / "big_cap.las"), both)
    assert filecmp.cmp(str(db / "E.1.E.1.las"), str(db / "big_cap.las"),
                       shallow=False)


@pytest.mark.parametrize("caps", [dict(hit_cap=SMALL_HIT_CAP),
                                  dict(seed_cap=16)])
def test_a_cap_that_cuts_raises(tmp_path, caps):
    """An explicit cap that cuts the seeding: run_overlap_plan raises with
    the pair's totals; no file of the pair, no manifest mark."""
    sim.write_sim_fasta(str(tmp_path / "reads.fasta"), _reads())
    dazzdb.create_db(str(tmp_path / "E.db"), [str(tmp_path / "reads.fasta")])
    dazzdb.db_split(str(tmp_path / "E.db"), size_mb=1, cutoff=500)
    with pytest.raises(RuntimeError, match=r"overlap\.1\.1: seeding cut "
                       r"short .* total_hits \d+, total_seeds \d+"):
        run_overlap_plan(str(tmp_path / "E.db"), OverlapConfig(),
                         verbose=False, device="cpu", **caps)
    assert not os.path.exists(tmp_path / "E.1.E.1.las")
    assert not os.path.exists(tmp_path / "E.1.las")
    m = Manifest(str(tmp_path / ".E.overlap.manifest"))
    assert not m.is_done("overlap.1.1")


def test_overflow_with_sized_buffers_cannot_happen(monkeypatch):
    """With both caps None the retry loop ends with every buffer at least
    its total; a seeding that still reported overflow raises instead of
    going on."""
    real = overlap.find_seeds_canonical_dev

    def always_over(*a, **kw):
        s = real(*a, **kw)
        return dict(s, overflow=True)
    monkeypatch.setattr(overlap, "find_seeds_canonical_dev", always_over)
    blk = block_from_reads(_reads().reads[:6])
    with pytest.raises(RuntimeError, match="sized buffers"):
        overlap.overlap_pair_device(blk, blk, OverlapConfig(), True,
                                    device="cpu")
