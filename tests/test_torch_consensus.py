"""Port vs reference for pipeline/consensus.py, poa.py and contigs.py:
read correction, layouts, contig polish (linear and circular, with
junctions and the raw final pass), the raw-read finishing rounds over
several contigs (with the POA caller under DAMAR_POA_THIN and the
realigning MSA caller under DAMAR_MSA_ITER), one consensus window, POA
itself, and the contig statistics.

The reference aligns with its host C aligner (damar_tpu/native), the
port with K4's plain version (ops/band_align.py) on the CPU; the votes
and calls are the same numpy in both.  Inputs: the hard-assembly
genome's scrubbed and filtered piles from a damar_tpu run_pipeline
workdir (made with its native host kernels), cut to a few reads where
the plain aligner would take minutes, and seeded simulations.
Tolerance: exact equality of every sequence, layout and statistic."""
import os

import numpy as np
import pytest
import torch

from damar_tpu import native
from damar_tpu.formats import las as ref_las
from damar_tpu.pipeline import consensus as ref_cs
from damar_tpu.pipeline import contigs as ref_contigs
from damar_tpu.pipeline import poa as ref_poa
from damar_tpu.pipeline import touring as ref_touring
from damar_tpu.pipeline.run import run_pipeline as ref_run_pipeline
from damar_tpu_torch.formats import dazzdb, las, tracks
from damar_tpu_torch.formats.fasta import revcomp
from damar_tpu_torch.pipeline import consensus as cs
from damar_tpu_torch.pipeline import contigs, poa, touring
from damar_tpu_torch.utils import sim

torch.set_num_threads(2)
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def need_native():
    if not native.available():
        pytest.skip("needs damar_tpu's native library (a C compiler)")


@pytest.fixture(scope="module")
def hard(tmp_path_factory):
    """The hard-assembly genome's workdir (polish off): piles, trimmed
    read universe and the toured contig."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DAMAR_BP", "native")
    w = str(tmp_path_factory.mktemp("consensus"))
    g = sim.make_genome(60_000, seed=41, n_repeats=3, repeat_len=1500,
                        tandem=1, tandem_period=90, tandem_len=1800)
    reads = sim.sample_reads(g, coverage=14, mean_len=4500, err=0.13,
                             seed=42, chimera_frac=0.06)
    sim.write_sim_fasta(os.path.join(w, "reads.fasta"), reads)
    try:
        ref_run_pipeline(os.path.join(w, "reads.fasta"), w, polish=False,
                         verbose=False)
    finally:
        mp.undo()
    fdb = dazzdb.DazzDB.open(os.path.join(w, "FIX.db"))
    trim = tracks.read_track(os.path.join(w, "FIX.db"), "trim")
    bounds = {i: ((int(trim.data[i][0]), int(trim.data[i][1]))
                  if len(trim.data[i]) == 2
                  else (0, int(fdb.reads["rlen"][i])))
              for i in range(fdb.ureads)}
    trlen = {i: max(e - b, 0) for i, (b, e) in bounds.items()}

    def seq_of(i, comp):
        b, e = bounds[i]
        s = fdb.read_seq(i)[b:e]
        return revcomp(s) if comp else s
    filt = os.path.join(w, "FIX.filtered.las")
    contigs_, tours, _ = ref_touring.assemble(
        ref_las.read_las(filt), trlen, seq_of, fuzz=40)
    return dict(w=w, trlen=trlen, seq_of=seq_of, genome=g,
                scrubbed=os.path.join(w, "FIX.scrubbed.las"), filt=filt,
                contig=contigs_[0], tour=tours[0])


def test_correct_reads_two_rounds(hard):
    """Both passes (the second through the first's window maps and
    corrected covers) for a few reads of the scrubbed pile."""
    reads = [3, 40, 41, 120, 7]
    kw = dict(reads=reads, rounds=2)
    got = cs.correct_reads(las.read_las(hard["scrubbed"]), hard["seq_of"],
                           hard["trlen"], **kw, **CPU)
    want = ref_cs.correct_reads(ref_las.read_las(hard["scrubbed"]),
                                hard["seq_of"], hard["trlen"], **kw)
    assert list(got) == list(want) and len(got) >= 4
    for r in want:
        assert np.array_equal(got[r], want[r])


def test_full_layout_and_layout_polish(hard):
    """full_layout on the toured contig's layout; then polish_rounds over
    the first 6 kbp of the contig with the reads placed there (contained
    reads included), junctions and the raw final pass."""
    tlay = ref_touring.tour_layout(hard["tour"], hard["seq_of"])
    got = cs.full_layout(tlay, las.read_las(hard["filt"]), hard["trlen"])
    want = ref_cs.full_layout(tlay, ref_las.read_las(hard["filt"]),
                              hard["trlen"])
    assert got == want and len(got) > len(tlay)
    L = 6000
    c = hard["contig"][:L].copy()
    lay = [x for x in want if 0 <= x[2] < L - 1500][:14]
    juncs = [s for _, _, s in tlay[1:] if 0 <= s < L]
    kw = dict(rounds=2, junctions=juncs, seq_of_raw=hard["seq_of"])
    out = cs.polish_rounds(c, lay, hard["seq_of"], **kw, **CPU)
    ref = ref_cs.polish_rounds(c, lay, hard["seq_of"], **kw)
    assert np.array_equal(out, ref)


def _circular_case(seed: int):
    """A 5 kbp circular genome, 16 reads of 1.6 kbp at 13% error placed
    around it (some across the seam), and a draft: the genome with 2%
    errors."""
    rng = np.random.default_rng(seed)
    g = sim.make_genome(5000, seed=seed)
    gg = np.concatenate([g, g])
    starts = [int(s) for s in np.linspace(0, 5000, 16, endpoint=False)]
    reads = [sim.mutate(gg[s:s + 1600], 0.13, rng) for s in starts]
    draft = sim.mutate(g, 0.02, rng)
    return g, reads, starts, draft


def test_circular_polish(hard):
    g, reads, starts, draft = _circular_case(11)
    lay = [(i, 0, s) for i, s in enumerate(starts)]
    seq_of = lambda i, d: revcomp(reads[i]) if d else reads[i]  # noqa: E731
    kw = dict(circular=True, rounds=3)
    out = cs.polish_rounds(draft, lay, seq_of, **kw, **CPU)
    assert np.array_equal(out, ref_cs.polish_rounds(draft, lay, seq_of,
                                                    **kw))


@pytest.mark.parametrize("env", [{}, {"DAMAR_POA_THIN": "6"},
                                 {"DAMAR_MSA_ITER": "4"}])
def test_finish_polish_raw_multi(monkeypatch, env):
    """Recruitment of raw reads over two contigs (one circular) and the
    finishing rounds; the POA caller and the realigning MSA caller take
    the thin windows under their switches."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    g1, reads1, _, draft1 = _circular_case(12)
    rng = np.random.default_rng(13)
    g2 = sim.make_genome(4000, seed=14)
    reads2 = [sim.mutate(g2[s:s + 1500], 0.13, rng)
              for s in range(0, 2500, 500)]
    reads = reads1[:10] + reads2 + [revcomp(r) for r in reads2[:2]]
    seq_of = lambda i, d: revcomp(reads[i]) if d else reads[i]  # noqa: E731
    draft2 = sim.mutate(g2, 0.02, rng)
    kw = dict(rounds=2)
    got = cs.finish_polish_raw_multi([draft1, draft2], [True, False],
                                     len(reads), seq_of, **kw, **CPU)
    want = ref_cs.finish_polish_raw_multi([draft1, draft2], [True, False],
                                          len(reads), seq_of, **kw)
    assert len(got) == len(want) == 2
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    lay = cs.recruit_layout_multi([draft1, draft2], len(reads), seq_of,
                                  circulars=[True, False])
    assert lay == ref_cs.recruit_layout_multi([draft1, draft2], len(reads),
                                              seq_of, circulars=[True, False])


def test_consensus_window_and_poa():
    rng = np.random.default_rng(15)
    t = sim.make_genome(500, seed=16)
    covers = [sim.mutate(t, 0.13, rng) for _ in range(6)] + [
        np.zeros(0, np.uint8)]
    covers[2] = np.concatenate([rng.integers(0, 4, 60).astype(np.uint8),
                                covers[2]])
    got = cs.consensus_window(t, covers, band=64, **CPU)
    assert np.array_equal(got, ref_cs.consensus_window(t, covers, band=64))
    for k in (2, 4, 6):
        assert np.array_equal(poa.poa_consensus(t, covers[:k]),
                              ref_poa.poa_consensus(t, covers[:k]))


def test_contig_statistics(hard):
    tlay = ref_touring.tour_layout(hard["tour"], hard["seq_of"])
    c = hard["contig"]
    rep = {r: np.array([10, 400, 900, 1200], np.int32) for r, _, _ in tlay[:5]}
    for bin_size in (200, 500):
        assert np.array_equal(
            contigs.coverage_profile(len(c), tlay, hard["seq_of"], bin_size),
            ref_contigs.coverage_profile(len(c), tlay, hard["seq_of"],
                                         bin_size))
        assert contigs.analyze_contig(c, hard["tour"], tlay, hard["seq_of"],
                                      rep, bin_size) == \
            ref_contigs.analyze_contig(c, hard["tour"], tlay,
                                       hard["seq_of"], rep, bin_size)
    for lens, gs in (([len(c), 4000, 12000, 300], None), ([], 60000),
                     ([5, 5, 5], 30)):
        assert contigs.assembly_stats(lens, gs) == \
            ref_contigs.assembly_stats(lens, gs)


def test_object_backed_las_is_refused(hard):
    """Records as objects (no columns) were refused until the .las object
    API was ported; correct_reads, full_layout and polish_read now read
    them as the reference does."""
    rl = ref_las.read_las(hard["filt"])
    obj = las.LasFile(rl.tspace, overlaps=rl.overlaps)
    reads = sorted({o.aread for o in rl.overlaps})[:2]
    got = cs.correct_reads(obj, hard["seq_of"], hard["trlen"], reads=reads,
                           **CPU)
    want = ref_cs.correct_reads(rl, hard["seq_of"], hard["trlen"],
                                reads=reads)
    assert got.keys() == want.keys() == set(reads)
    assert all(np.array_equal(got[r], want[r]) for r in reads)
    lay = [(r, 0, 3000 * k) for k, r in enumerate(reads)]
    assert cs.full_layout(lay, obj, hard["trlen"]) == \
        ref_cs.full_layout(lay, rl, hard["trlen"])
    r = reads[0]
    assert np.array_equal(
        cs.polish_read(r, obj, hard["seq_of"], hard["trlen"][r], **CPU),
        ref_cs.polish_read(r, rl, hard["seq_of"], hard["trlen"][r]))
