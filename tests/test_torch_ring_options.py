"""Port fault 4: the ring sweep honours -b (cfg.bias) and -I
(cfg.identity) as the pair path does, and refuses dp_kernel="wide",
for which it has no route, before any rank sends.

- -b: on a 3-block DB made as tests/test_torch_ring_sweep.py makes its
  own (reads of 500-1,300 bp, db_split at 1 Mbp, one common cap), each
  ring shard's part i < j must be the bytes of overlap_block_pair's A
  side with mirrors off and bias=True, at 1 rank in this process and at
  3 ranks spawned over gloo.  The genome is AT-rich (40% A, 10% C, 10%
  G, 40% T): on a uniform one every weight of bias_weight_lut is 256
  and -b changes no seed, so the test would hold nothing.  The same
  holds on the sliced seeding path (forced by a lowered _SLICE_CAP).
- -I: on the tandem-bearing block of tests/test_overlap.py
  (test_identity_reports_self_overlaps), the ring's self part must be
  the bytes of the pair driver's self pair (mirrors off) with
  identity=True, a read-vs-itself record among them.  The ring seeds a
  block against itself in full, so under -I it keeps a read against
  itself only at the hits the self merge gives (equal_upper: no trivial
  diagonal, no transposed copies), on the packed, sliced and legacy
  bandings alike.
- Reference fault 3o: damar_tpu's ring with both options on gives the
  bytes of the port's ring with both off.
Tolerance: byte equality."""
import os
import tempfile

import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block_from_reads
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu_torch.core.blocks import block_from_db, block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import LasFile, read_las
from damar_tpu_torch.ops import seeding
from damar_tpu_torch.parallel import distributed as dd
from damar_tpu_torch.pipeline import overlap
from damar_tpu_torch.pipeline.overlap import overlap_block_pair
from damar_tpu_torch.utils import sim
from test_torch_ring import las_bytes, port_runs, reference_ring
from test_torch_sweep import MIN_LEN, make_db

torch.set_num_threads(2)
AT_RICH = [0.40, 0.10, 0.10, 0.40]


def at_rich_reads():
    """test_torch_sweep.py's sweep reads (500-1,300 bp, 6.4x, 10% error)
    over an AT-rich 600 kbp genome: three 1 Mbp blocks."""
    g = np.random.default_rng(91).choice(
        np.arange(4, dtype=np.uint8), size=600_000, p=AT_RICH)
    s = sim.sample_reads(g, coverage=6.4, mean_len=900, err=0.10, seed=32)
    keep = [i for i, r in enumerate(s.reads) if len(r) <= 1300]
    return sim.SimReads(g, [s.reads[i] for i in keep], s.start[keep],
                        s.end[keep], s.strand[keep], s.err)


def tandem_reads(mutate):
    """test_identity_reports_self_overlaps' reads: three copies of a
    900 bp unit at 5% error, then three unrelated 2 kbp reads."""
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 900).astype(np.uint8)
    tandem = np.concatenate([mutate(unit, 0.05, rng) for _ in range(3)])
    return [tandem] + [rng.integers(0, 4, 2000).astype(np.uint8)
                       for _ in range(3)]


def small_blocks(make, mutate):
    """Two blocks of AT-rich reads of ~2.5 kbp, the tandem reads in the
    first: both options change records here."""
    g = np.random.default_rng(91).choice(
        np.arange(4, dtype=np.uint8), size=30_000, p=AT_RICH)
    s = sim.sample_reads(g, coverage=4, mean_len=2500, err=0.12, seed=92,
                         min_len=1000)
    n = len(s.reads)
    t = tandem_reads(mutate)
    return [make([s.reads[i] for i in range(0, n, 2)] + t,
                 ids=np.concatenate([np.arange(0, n, 2),
                                     n + np.arange(len(t))]), cap=1 << 17),
            make([s.reads[i] for i in range(1, n, 2)],
                 ids=np.arange(1, n, 2), cap=1 << 17)]


def part(shard: LasFile, ids) -> LasFile:
    """The records of a shard whose B read is one of `ids`."""
    rows = np.nonzero(np.isin(shard.columns.headers[:, 8], ids))[0]
    return LasFile(shard.tspace, columns=shard.columns.permute(rows))


def raw(las: LasFile) -> bytes:
    """A LasFile's bytes as write_las writes them."""
    with tempfile.TemporaryDirectory() as d:
        return las_bytes(las, os.path.join(d, "x.las"))


def ring_las(blocks, cfg):
    las, _, _ = dd.distributed_overlap_las(blocks, cfg, device="cpu")
    return las


@pytest.fixture(scope="module")
def bias_runs(tmp_path_factory):
    w = str(tmp_path_factory.mktemp("ringbias"))
    db = make_db(w, at_rich_reads())
    caps = [block_from_db(db, b).cap for b in range(1, db.nblocks + 1)]
    blocks = [block_from_db(db, b, cap=max(caps))
              for b in range(1, db.nblocks + 1)]
    cfg = OverlapConfig(min_len=MIN_LEN, bias=True)
    port = port_runs(f"{w}/ring", [("bias", blocks, cfg, {}, "las")],
                     worlds=(1, 3))
    pairs = {}
    for i in range(len(blocks)):
        for j in range(i + 1, len(blocks)):
            la, _, _ = overlap_block_pair(blocks[i], blocks[j], cfg, False,
                                          emit_mirrors=False, device="cpu")
            pairs[(i, j)] = las_bytes(la, f"{w}/pair.{i}.{j}.las")
    return w, blocks, port, pairs


@pytest.mark.parametrize("world", (1, 3))
def test_ring_bias_parts_equal_the_pair_driver(bias_runs, world):
    w, blocks, port, pairs = bias_runs
    assert len(blocks) == 3
    for i in range(3):
        path = f"{w}/ring.{world}.{i}.las"
        with open(path, "wb") as f:
            f.write(port[(world, "bias")]["shards"][i])
        shard = read_las(path)
        for j in range(i + 1, 3):
            got = las_bytes(part(shard, blocks[j].ids),
                            f"{w}/part.{world}.{i}.{j}.las")
            assert len(got) > 1000 and got == pairs[(i, j)], (i, j)


def test_ring_bias_on_the_sliced_path(monkeypatch):
    """The same on the sliced path; and -b changes the records of these
    AT-rich reads."""
    blocks = small_blocks(block_from_reads, sim.mutate)
    cfg = OverlapConfig(min_len=MIN_LEN, bias=True)
    pair = lambda c: overlap_block_pair(  # noqa: E731
        blocks[0], blocks[1], c, False, emit_mirrors=False, device="cpu")
    full = raw(pair(cfg)[0])
    assert full != raw(pair(OverlapConfig(min_len=MIN_LEN))[0])
    monkeypatch.setattr(seeding, "_SLICE_CAP", 1 << 10)
    want, _, st = pair(cfg)
    assert st["seed_path"] == "sliced"
    got = part(ring_las(blocks, cfg)[0], blocks[1].ids)
    assert want.novl > 10
    assert raw(got) == raw(want) == full


def test_ring_identity_self_records_equal_the_self_pair():
    blk = block_from_reads(tandem_reads(sim.mutate))
    for ident in (False, True):
        cfg = OverlapConfig(min_len=500, identity=ident)
        la, _, _ = overlap_block_pair(blk, blk, cfg, True,
                                      emit_mirrors=False, device="cpu")
        ring = ring_las([blk], cfg)[0]
        h = ring.columns.headers
        selfs = int((h[:, 7] == h[:, 8]).sum()) if len(h) else 0
        assert (selfs > 0) == ident, (ident, selfs)
        assert raw(ring) == raw(la)


@pytest.mark.parametrize("path", ("packed", "sliced", "legacy"))
def test_equal_upper_gives_the_self_merges_seeds(monkeypatch, path):
    """A block seeded against itself in full with equal_upper has, for
    a read against itself, the self pair's seeds, on each banding."""
    blk = block_from_reads(tandem_reads(sim.mutate))
    cfg = OverlapConfig(min_len=500, identity=True)
    if path == "sliced":
        monkeypatch.setattr(seeding, "_SLICE_CAP", 1 << 6)
    if path == "legacy":
        monkeypatch.setattr(seeding, "packed_payload_host", lambda b: None)

    def seeds(**kw):
        sd = seeding.find_seeds_canonical_dev(
            blk, blk, cfg, hit_cap=None, seed_cap=1 << 14, device="cpu",
            **kw)
        assert sd["path"] == path and not sd["overflow"]
        n = sd["nseeds"]
        cols = [sd[k][:n].numpy() for k in ("aread", "bread", "apos",
                                            "bpos", "comp")]
        same = cols[0] == cols[1]
        return [c[same] for c in cols]

    want = seeds(upper_only=True, self_pair=True)
    got = seeds(upper_only=False, equal_upper=True)
    assert len(want[0]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_reference_ring_ignores_bias_and_identity(tmp_path):
    """Fault 3o: damar_tpu's ring reads neither option, so its shards
    with both on are the port's with both off, which the options
    change."""
    from damar_tpu.utils.sim import mutate as ref_mutate
    on = dict(min_len=MIN_LEN, bias=True, identity=True)
    ref = reference_ring(str(tmp_path), small_blocks(ref_block_from_reads,
                                                     ref_mutate),
                         RefConfig(**on))
    blocks = small_blocks(block_from_reads, sim.mutate)
    off = ring_las(blocks, OverlapConfig(min_len=MIN_LEN))
    honoured = ring_las(blocks, OverlapConfig(**on))
    for i, want in enumerate(ref["shards"]):
        assert raw(off[i]) == want
    assert any(raw(honoured[i]) != w for i, w in enumerate(ref["shards"]))


@pytest.mark.parametrize("kernel", ("wide", "banded"))
@pytest.mark.parametrize("entry", ("distributed_overlap",
                                   "distributed_overlap_las"))
def test_dp_kernel_raises_before_any_send(monkeypatch, kernel, entry):
    def no_send(*a, **k):
        raise AssertionError("the ring staged or sent a block")

    monkeypatch.setattr(dd, "_rotate", no_send)
    monkeypatch.setattr(dd, "shard_blocks", no_send)
    blk = block_from_reads(tandem_reads(sim.mutate))
    cfg = OverlapConfig(min_len=500, dp_kernel=kernel)
    ring = dd.Ring(rank=0, size=2, device=torch.device("cpu"))
    if kernel == "wide":
        match = "the ring sweep has no wide route"
    else:
        with pytest.raises(ValueError) as pair:
            overlap._dp_kernel(cfg)
        match = str(pair.value)
    with pytest.raises(ValueError) as got:
        getattr(dd, entry)([blk, blk], cfg, ring)
    assert match in str(got.value)
