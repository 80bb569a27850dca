"""Port vs reference for the host layer of the block sweep: FASTA/FASTQ
records, the read database files (.db, .idx, .bps) and its block views,
block_from_db, interval tracks and the mask vector, the .las file API
(read, sort, merge, cat), the pair matrix and the job plan.  Inputs come
from the simulator or a numpy seed; tolerance: byte or array equality.
The reference's native C codecs are switched off, so both sides run
their numpy forms (the C forms are held equal to those by the
reference's own tests)."""
import filecmp
import gzip
import os

import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_db as ref_block_from_db
from damar_tpu.formats import dazzdb as ref_db
from damar_tpu.formats import fasta as ref_fasta
from damar_tpu.formats import las as ref_las
from damar_tpu.formats import tracks as ref_tracks
from damar_tpu.ops.kmers import mask_vector_from_track as ref_mask_vector
from damar_tpu.parallel import distributed as ref_dist
from damar_tpu.pipeline import planner as ref_planner
from damar_tpu.utils import sim as ref_sim
from damar_tpu_torch.core.blocks import block_from_db, block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats import dazzdb, fasta, las, tracks
from damar_tpu_torch.ops.kmers import mask_vector_from_track
from damar_tpu_torch.parallel import distributed as dist
from damar_tpu_torch.pipeline import overlap as ov
from damar_tpu_torch.pipeline import planner
from damar_tpu_torch.utils import sim
from test_torch_sim import _small_las

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    from damar_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)


def same_file(a, b):
    assert os.path.getsize(a) == os.path.getsize(b), (a, b)
    assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.fixture(scope="module")
def reads():
    g = sim.make_genome(60_000, seed=41)
    return sim.sample_reads(g, coverage=40.0, mean_len=2500, err=0.12,
                            seed=42)


@pytest.fixture(scope="module")
def dbs(reads, tmp_path_factory):
    """The same two FASTA files through both packages' create_db and
    db_split (1 Mbp blocks, cutoff 900: some reads are trimmed)."""
    out = {}
    half = len(reads.reads) // 2
    for side, simmod, dbmod in (("ref", ref_sim, ref_db),
                                ("port", sim, dazzdb)):
        w = tmp_path_factory.mktemp(side)
        parts = []
        for tag, sl in (("a", slice(0, half)), ("b", slice(half, None))):
            part = simmod.SimReads(reads.genome, reads.reads[sl],
                                   reads.start[sl], reads.end[sl],
                                   reads.strand[sl], reads.err)
            simmod.write_sim_fasta(f"{w}/{tag}.fasta", part)
            parts.append(f"{w}/{tag}.fasta")
        dbmod.create_db(f"{w}/E.db", parts)
        unsplit = open(f"{w}/E.db").read()
        db = dbmod.db_split(f"{w}/E.db", size_mb=1, cutoff=900)
        out[side] = (str(w), db, unsplit)
    return out


def test_fasta_and_db_files_byte_equal(dbs):
    (rw, rdb, r_unsplit), (pw, pdb, p_unsplit) = dbs["ref"], dbs["port"]
    assert pdb.nblocks >= 2
    assert p_unsplit == r_unsplit
    for f in ("a.fasta", "b.fasta", "E.db", ".E.idx", ".E.bps"):
        same_file(f"{rw}/{f}", f"{pw}/{f}")


def test_db_views_equal(dbs):
    rdb, pdb = dbs["ref"][1], dbs["port"][1]
    for k in ("ureads", "cutoff", "allflag", "maxlen", "totlen", "files",
              "block_size_mb", "nblocks"):
        assert getattr(pdb, k) == getattr(rdb, k), k
    np.testing.assert_array_equal(pdb.freq, rdb.freq)
    np.testing.assert_array_equal(pdb.reads, rdb.reads)
    np.testing.assert_array_equal(pdb.trimmed_index(), rdb.trimmed_index())
    for b in range(1, pdb.nblocks + 1):
        assert pdb.block_range(b) == rdb.block_range(b)
        np.testing.assert_array_equal(pdb.block_reads(b), rdb.block_reads(b))
        for x, y in zip(pdb.block_seqs(b), rdb.block_seqs(b)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(pdb.read_seq(3), rdb.read_seq(3))
    assert dazzdb.db_stats(dbs["port"][0] + "/E.db") == \
        ref_db.db_stats(dbs["ref"][0] + "/E.db")
    with pytest.raises(ValueError, match="out of range"):
        pdb.block_range(pdb.nblocks + 1)


def test_block_from_db_equal(dbs, reads):
    rdb, pdb = dbs["ref"][1], dbs["port"][1]
    for b in range(1, pdb.nblocks + 1):
        ours, ref = block_from_db(pdb, b), ref_block_from_db(rdb, b)
        for k in ("bases", "starts", "read_id", "rlen", "ids"):
            np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
        assert ours.nbases == ref.nbases
    # a block's reads are the simulator's, by their DB ids
    blk = block_from_db(pdb, 1)
    j = 5
    np.testing.assert_array_equal(
        blk.bases[blk.starts[j]:blk.starts[j + 1]],
        reads.reads[int(blk.ids[j])])


def test_pack_2bit_roundtrip_equal():
    rng = np.random.default_rng(3)
    for n in (0, 1, 4, 7, 1001):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        packed = dazzdb.pack_2bit(codes)
        np.testing.assert_array_equal(packed, ref_db._pack_2bit_np(codes))
        np.testing.assert_array_equal(dazzdb.unpack_2bit(packed, n), codes)


def test_truncated_bps_raises(dbs, tmp_path):
    import shutil
    w = tmp_path / "cut"
    shutil.copytree(dbs["port"][0], w)
    raw = (w / ".E.bps").read_bytes()
    (w / ".E.bps").write_bytes(raw[:len(raw) // 2])
    with pytest.raises(ValueError, match="truncated"):
        dazzdb.DazzDB.open(str(w / "E.db")).block_seqs(1)


def test_fasta_records_equal(tmp_path):
    text = ">r1 first\nACGTNacgtn\nGGxTT\n\n>r2\nTTTT\n>empty\n"
    p = tmp_path / "x.fasta"
    p.write_text(text)
    gz = tmp_path / "x.fasta.gz"
    gz.write_bytes(gzip.compress(text.encode()))
    for path in (p, gz):
        hs, ss = fasta.read_fasta(str(path))
        rhs, rss = ref_fasta.read_fasta(str(path))
        assert hs == rhs == ["r1 first", "r2", "empty"]
        for a, b in zip(ss, rss):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fasta.revcomp(ss[0]),
                                  ref_fasta.revcomp(ss[0]))
    assert fasta.decode_seq(ss[0], upper=True) == "ACGTAACGTAGGATT"
    fq = tmp_path / "x.fastq"
    fq.write_text("@q1\nACGT\n+\nII5!\n@q2\nGG\n+\n##\n")
    got, want = fasta.read_fastq(str(fq)), ref_fasta.read_fastq(str(fq))
    assert got[0] == want[0] == ["q1", "q2"]
    for k in (1, 2):
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)
    # the qualities go to the .qvs file, as the reference writes it
    dazzdb.create_db(str(tmp_path / "Q.db"), [str(fq)])
    ref_db.create_db(str(tmp_path / "R.db"), [str(fq)])
    for f in ("{}.db", ".{}.idx", ".{}.bps", ".{}.qvs"):
        assert filecmp.cmp(tmp_path / f.format("Q"), tmp_path / f.format("R"),
                           shallow=False)


def _intervals(rng, nreads, rlen):
    data = []
    for i in range(nreads):
        k = int(rng.integers(0, 4))
        cuts = np.sort(rng.integers(0, rlen[i] + 200, 2 * k))
        data.append(cuts.astype(np.int32))
    return data


def test_tracks_and_mask_vector_equal(dbs):
    (rw, rdb, _), (pw, pdb, _) = dbs["ref"], dbs["port"]
    rng = np.random.default_rng(9)
    rlen = pdb.reads["rlen"]
    for name in ("dust", "tan"):
        data = _intervals(rng, pdb.ureads, rlen)
        tracks.write_track(f"{pw}/E.db", tracks.Track(name, data))
        ref_tracks.write_track(f"{rw}/E.db", ref_tracks.Track(name, data))
        for ext in ("anno", "data"):
            same_file(f"{rw}/.E.{name}.{ext}", f"{pw}/.E.{name}.{ext}")
        back = tracks.read_track(f"{pw}/E.db", name)
        assert back.nreads == pdb.ureads
        for a, b in zip(back.data, data):
            np.testing.assert_array_equal(a, b)
        assert back.masked_bp() == ref_tracks.read_track(
            f"{rw}/E.db", name).masked_bp()
    assert tracks.track_exists(f"{pw}/E.db", "dust")
    assert not tracks.track_exists(f"{pw}/E.db", "rep")
    dust = tracks.read_track(f"{pw}/E.db", "dust")
    tan = tracks.read_track(f"{pw}/E.db", "tan")
    for mode in ("union", "intersect"):
        got = tracks.combine_tracks([dust, tan], "m", mode)
        want = ref_tracks.combine_tracks([dust, tan], "m", mode)
        for a, b in zip(got.data, want.data):
            np.testing.assert_array_equal(a, b)
    blk = block_from_db(pdb, 1)
    per_read = [tracks.merge_interval_lists(dust.data[int(r)],
                                            tan.data[int(r)])
                for r in blk.ids]
    got = mask_vector_from_track(per_read, blk.starts, blk.cap)
    want = ref_mask_vector(per_read, blk.starts, blk.cap)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < blk.nbases
    np.testing.assert_array_equal(
        tracks.clip_intervals_to_len(per_read[0], 1000),
        ref_tracks.clip_intervals_to_len(per_read[0], 1000))


@pytest.fixture(scope="module")
def pair_las(tmp_path_factory):
    """las_a and las_b of one small distinct pair of the port (the slice
    tests hold such files byte-equal to the reference's)."""
    g = sim.make_genome(15_000, seed=7)
    rs = sim.sample_reads(g, coverage=8.0, mean_len=2000, err=0.14,
                          seed=8).reads
    h = len(rs) // 2
    a = block_from_reads(rs[:h], ids=np.arange(h))
    b = block_from_reads(rs[h:], ids=np.arange(h, len(rs)))
    la, lb, _ = ov.overlap_block_pair(a, b, OverlapConfig(), False,
                                      device="cpu")
    w = tmp_path_factory.mktemp("las")
    las.write_las(f"{w}/a.las", la)
    las.write_las(f"{w}/b.las", lb)
    assert la.novl > 20 and lb.novl == la.novl
    return str(w)


def test_las_read_sort_merge_cat_bytes_equal(pair_las, tmp_path):
    w = pair_las
    ins = [f"{w}/a.las", f"{w}/b.las"]
    for p in ins:
        got, want = las.read_las(p), ref_las.read_las(p)
        assert got.tspace == want.tspace and got.novl == want.novl
        for k in ("headers", "trace", "offsets"):
            np.testing.assert_array_equal(getattr(got.columns, k),
                                          getattr(want.columns, k))
        las.write_las(str(tmp_path / "again.las"), got)
        same_file(p, str(tmp_path / "again.las"))
    for fn, rfn, name in ((las.merge_las, ref_las.merge_las, "merge"),
                          (las.cat_las, ref_las.cat_las, "cat")):
        fn(ins[::-1], str(tmp_path / f"{name}_port.las"))
        rfn(ins[::-1], str(tmp_path / f"{name}_ref.las"))
        same_file(str(tmp_path / f"{name}_ref.las"),
                  str(tmp_path / f"{name}_port.las"))
    # the cat is unsorted (b before a); sorting it gives the merge
    las.sort_las_file(str(tmp_path / "cat_port.las"),
                      str(tmp_path / "sorted_port.las"))
    ref_las.sort_las_file(str(tmp_path / "cat_ref.las"),
                          str(tmp_path / "sorted_ref.las"))
    same_file(str(tmp_path / "sorted_ref.las"),
              str(tmp_path / "sorted_port.las"))
    same_file(str(tmp_path / "merge_port.las"),
              str(tmp_path / "sorted_port.las"))
    merged = las.read_las(str(tmp_path / "merge_port.las"))
    assert las.check_las(merged, np.full(200, 100_000)) == []


@pytest.mark.parametrize("tspace", [100, 200])
def test_las_concat_both_trace_widths(tmp_path, tspace):
    """read_las_columns round-trips u8 and int16 traces; concat and merge
    keep them; mixed tspace values refuse to merge."""
    one = _small_las(tspace)
    p = str(tmp_path / "one.las")
    las.write_las(p, one)
    las.merge_las([p, p], str(tmp_path / "two.las"))
    ref_las.merge_las([p, p], str(tmp_path / "two_ref.las"))
    same_file(str(tmp_path / "two_ref.las"), str(tmp_path / "two.las"))
    two = las.read_las(str(tmp_path / "two.las"))
    assert two.novl == 2 * one.novl and two.tspace == tspace
    assert las.check_las(two, [400, 400]) == []
    other = str(tmp_path / "other.las")
    las.write_las(other, _small_las(300 - tspace))
    with pytest.raises(ValueError, match="mixed tspace"):
        las.merge_las([p, other], str(tmp_path / "bad.las"))
    assert las.LasFile.concat([]).novl == 0


def test_pair_matrix_and_plan_equal():
    for n, h in ((1, 1), (5, 2), (7, 3), (10, 4)):
        assert dist.block_pair_matrix(n) == ref_dist.block_pair_matrix(n)
        for k in range(h):
            assert dist.host_pair_slice(n, h, k) == \
                ref_dist.host_pair_slice(n, h, k)
    with pytest.raises(ValueError, match="host_id"):
        dist.host_pair_slice(3, 2, 2)
    from dataclasses import asdict
    got = planner.plan_block_pairs("E", 3, las_dir="out")
    want = ref_planner.plan_block_pairs("E", 3, las_dir="out")
    assert [asdict(j) for j in got] == [asdict(j) for j in want]


def test_manifest_mark_reload_claim(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = planner.Manifest(path)
    assert not m.is_done("overlap.1.1")
    m.mark("overlap.1.1", novl=3)
    with open(path, "a") as f:
        f.write("{torn line\n\n")
    m.mark("overlap.1.2", novl=0)
    other = planner.Manifest(path)              # a second host's view
    assert other.is_done("overlap.1.1") and other.is_done("overlap.1.2")
    assert other.done["overlap.1.1"]["novl"] == 3
    ref = ref_planner.Manifest(path)            # same file format
    assert ref.done == other.done
    assert m.claim("merge.1") and not other.claim("merge.1")
    old = os.path.getmtime(f"{path}.merge.1.lock") - 7200
    os.utime(f"{path}.merge.1.lock", (old, old))
    assert other.claim("merge.1")               # stale lock broken
