"""The ring sweep of damar_tpu_torch.parallel.distributed against
damar_tpu's on its virtual 8-device CPU mesh, on the spread 8-block DB of
tests/test_parallel.py (TestRingByteEquality: reads dealt to blocks by
genome position) and on the extents shape of its tiny_sharded fixture.

The port runs as 1 rank in this process, and as 3 and 4 ranks spawned
over gloo (3 ranks pad 8 blocks to 9).  Tolerance: byte equality of
every .las shard written with write_las, equality of the counts and of
the extent buffers.  The reference runs once per module, on its device
route (native.available -> False: its wide retries would take its host
C otherwise); the port's runs once per world size.  The other
tests/test_torch_ring_*.py files hold the 12-block multi-round DB, the
non-spread DB, the grow ladder and faults 3l and 3m, the launcher, and
the ring against the block sweep's pair files."""
import json
import os

import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block_from_reads
from damar_tpu.core.blocks import round_up
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.formats.las import write_las as ref_write_las
from damar_tpu.parallel import distributed as ref_dd
from damar_tpu.utils import sim as ref_sim
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import write_las
from damar_tpu_torch.parallel import distributed as dd
from damar_tpu_torch.utils import sim

torch.set_num_threads(2)
WORLDS = (1, 3, 4)
SPAWN_TIMEOUT = 300.0


def spread_blocks(nblocks: int, seed: int, genome: int = 40_000,
                  cov: float = 3.0, ref: bool = False) -> list:
    """test_parallel.py's _spread_blocks, built by either package."""
    s, mk = (ref_sim, ref_block_from_reads) if ref else (sim,
                                                         block_from_reads)
    g = s.make_genome(genome, seed=seed)
    r = s.sample_reads(g, coverage=cov, mean_len=3000, err=0.12,
                       seed=seed + 1, min_len=1500, circular=False)
    order = np.argsort(r.start)
    return [mk([r.reads[i] for i in order[d::nblocks]],
               ids=np.asarray(order[d::nblocks], np.int64), cap=1 << 16)
            for d in range(nblocks)]


def las_bytes(las, path: str, writer=write_las) -> bytes:
    writer(path, las)
    with open(path, "rb") as f:
        return f.read()


def reference_ring(tmp: str, blocks: list, cfg, **kw) -> dict:
    """damar_tpu's distributed_overlap_las on its 8-device mesh, on its
    device route: {"shards": [bytes per A-block], "counts"}."""
    from damar_tpu import native
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        las, counts, _ = ref_dd.distributed_overlap_las(
            blocks, cfg, mesh=ref_dd.make_mesh(8), **kw)
    return {"shards": [las_bytes(x, f"{tmp}/ref.{i}.las", ref_write_las)
                       for i, x in enumerate(las)],
            "counts": np.asarray(counts, np.int64)}


def port_runs(tmp: str, cases: list, worlds=WORLDS) -> dict:
    """The port's ring on each case (name, blocks, cfg, kwargs, what) at
    each world size: 1 in this process, more spawned over gloo (one
    spawn per size runs every case).  Returns {(world, name): {"shards":
    {i: bytes}, "exts": {(i, j): array}, "counts", "stats": rank 0's}}."""
    out = {}
    os.makedirs(tmp, exist_ok=True)
    for w in worlds:
        if w == 1:
            for name, blocks, cfg, kw, what in cases:
                if what == "las":
                    stats = {}
                    las, counts, _ = dd.distributed_overlap_las(
                        blocks, cfg, device="cpu", stats=stats, **kw)
                    out[(1, name)] = {"shards": {
                        i: las_bytes(x, f"{tmp}/{name}.w1.{i}.las")
                        for i, x in las.items()}, "counts": counts,
                        "stats": stats}
                else:
                    exts, counts, _ = dd.distributed_overlap(
                        blocks, cfg, device="cpu", **kw)
                    out[(1, name)] = {"exts": exts, "counts": counts}
            continue
        d = f"{tmp}/w{w}"
        os.makedirs(d)
        dd.spawn_ranks(dd.ring_to_dir, w, (cases, d, "cpu"),
                       timeout=SPAWN_TIMEOUT)
        for name, blocks, _, _, what in cases:
            res = {"counts": np.load(f"{d}/{name}/counts.npy")}
            with open(f"{d}/{name}/rank0.json") as f:
                res["stats"] = json.load(f)["stats"]
            files = os.listdir(f"{d}/{name}")
            if what == "las":
                res["shards"] = {}
                for i in range(len(blocks)):
                    with open(f"{d}/{name}/shard.{i}.las", "rb") as f:
                        res["shards"][i] = f.read()
            else:
                res["exts"] = {
                    tuple(int(x) for x in f.split(".")[1:3]):
                    np.load(f"{d}/{name}/{f}")
                    for f in files if f.startswith("ext.")}
            out[(w, name)] = res
    return out


def assert_same_shards(ref: dict, port: dict) -> None:
    assert sorted(port["shards"]) == list(range(len(ref["shards"])))
    assert sum(len(b) for b in ref["shards"]) > 16 * len(ref["shards"])
    for i, want in enumerate(ref["shards"]):
        assert port["shards"][i] == want, f"shard {i} differs"
    np.testing.assert_array_equal(port["counts"], ref["counts"])


def tiny_sharded(ref: bool) -> list:
    """test_parallel.py's tiny_sharded blocks."""
    s, mk = (ref_sim, ref_block_from_reads) if ref else (sim,
                                                         block_from_reads)
    g = s.make_genome(6000, seed=0)
    r = s.sample_reads(g, coverage=3.0, mean_len=1200, err=0.12, seed=1,
                       min_len=600)
    n = len(r.reads)
    per = -(-n // 8)
    groups = [np.arange(d * per, min((d + 1) * per, n)) for d in range(8)]
    cap = round_up(max(sum(len(r.reads[i]) for i in ids) for ids in groups)
                   + 4, 4096)
    return [mk([r.reads[i] for i in ids], ids=ids, cap=cap)
            for ids in groups]


EXT_CAPS = dict(seed_cap=512, hit_cap=1 << 14)
SPREAD_CFG = dict(min_len=900, max_read_len=16384)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ring"))
    ref = {"eq8": reference_ring(tmp, spread_blocks(8, 81, ref=True),
                                 RefConfig(seed_batch=256, **SPREAD_CFG),
                                 seed_cap=1024, hit_cap=1 << 16)}
    e, c, t = ref_dd.distributed_overlap(
        tiny_sharded(True), RefConfig(seed_batch=128, min_len=500,
                                      max_read_len=8192),
        mesh=ref_dd.make_mesh(8), **EXT_CAPS)
    ref["ext"] = {"exts": np.asarray(e), "counts": np.asarray(c, np.int64),
                  "total": np.asarray(t, np.int64)}
    cases = [("eq8", spread_blocks(8, 81), OverlapConfig(**SPREAD_CFG), {},
              "las"),
             ("ext", tiny_sharded(False),
              OverlapConfig(min_len=500, max_read_len=8192), EXT_CAPS,
              "extents")]
    return ref, port_runs(tmp, cases)


@pytest.mark.parametrize("world", WORLDS)
def test_spread_8_blocks_byte_equal(runs, world):
    """distributed_overlap_las shards (the port's sized buffers, the
    reference's caps 1024/2^16) byte-equal at every world size."""
    ref, port = runs
    assert_same_shards(ref["eq8"], port[(world, "eq8")])


@pytest.mark.parametrize("world", WORLDS)
def test_extents_and_counts_equal(runs, world):
    """distributed_overlap with the reference's explicit caps: every
    pair's [seed_cap, 8] extent buffer (its live rows in slot order
    among them) and its (seeds, extents, total_hits) equal."""
    ref, port = runs
    got = port[(world, "ext")]
    n = ref["ext"]["exts"].shape[0]
    assert sorted(got["exts"]) == [(i, j) for i in range(n)
                                   for j in range(n)]
    live = 0
    for (i, j), e in got["exts"].items():
        np.testing.assert_array_equal(e, ref["ext"]["exts"][i, j],
                                      err_msg=f"pair {i}, {j}")
        live += int((e[:, 0] >= 0).sum())
    np.testing.assert_array_equal(got["counts"], ref["ext"]["counts"])
    np.testing.assert_array_equal(got["counts"].sum((0, 1)),
                                  ref["ext"]["total"])
    assert live == int(ref["ext"]["total"][1]) > 0


def test_diagonal_rotation_drops_reads_against_themselves(runs):
    """The rotation pairing a block with itself keeps both (a, b) and
    (b, a) of two reads and never a read against itself."""
    _, port = runs
    ext = port[(1, "ext")]["exts"]
    n = max(i for i, _ in ext) + 1
    diag = np.concatenate([ext[(i, i)][ext[(i, i)][:, 0] >= 0]
                           for i in range(n)])
    assert len(diag) and not (diag[:, 0] == diag[:, 1]).any()
    pairs = {(int(a), int(b)) for a, b in diag[:, :2]}
    assert any((b, a) in pairs for a, b in pairs)
