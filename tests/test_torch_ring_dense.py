"""The port's ring sweep on tests/test_parallel.py's non-spread 8-block
DB (test_ring_las_matches_pair_driver): reads dealt to blocks in id
order, so reads of one block overlap and the rotation that pairs a block
with itself gives records (both (a, b) and (b, a), never a read against
itself), and one record fails the bit-parallel trace and is retried on
the wide band.  Against damar_tpu's ring on its 8-device mesh; the port
at 1 rank in this process and 3 and 4 ranks spawned over gloo.
Tolerance: byte equality of every .las shard, and the counts equal.
tests/test_torch_ring_retry.py forces many wide retries on this DB."""
import numpy as np
import pytest

from damar_tpu.core.blocks import block_from_reads as ref_block_from_reads
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.utils import sim as ref_sim
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import check_las, read_las
from damar_tpu_torch.utils import sim
from test_torch_ring import (WORLDS, assert_same_shards, port_runs,
                             reference_ring)

CFG = dict(min_len=900, max_read_len=16384)


def dense_blocks(ref: bool = False):
    s, mk = (ref_sim, ref_block_from_reads) if ref else (sim,
                                                         block_from_reads)
    g = s.make_genome(24_000, seed=61)
    reads = s.sample_reads(g, coverage=6, mean_len=2500, err=0.12, seed=62,
                           min_len=1200).reads
    per = -(-len(reads) // 8)
    blocks = []
    for d in range(8):
        ids = list(range(d * per, min((d + 1) * per, len(reads)))) or [0]
        blocks.append(mk([reads[i] for i in ids], cap=1 << 17))
    return blocks, reads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ringd"))
    rblocks, _ = dense_blocks(ref=True)
    rcfg = RefConfig(seed_batch=256, **CFG)
    caps = dict(seed_cap=1024, hit_cap=1 << 16)
    ref = {"dense": reference_ring(tmp, rblocks, rcfg, **caps)}
    blocks, _ = dense_blocks()
    port = port_runs(tmp, [("dense", blocks, OverlapConfig(**CFG), {},
                            "las")])
    return ref, port, tmp


@pytest.mark.parametrize("world", WORLDS)
def test_dense_8_blocks_byte_equal(runs, world):
    ref, port, _ = runs
    assert_same_shards(ref["dense"], port[(world, "dense")])


def test_diagonal_records_and_check_las(runs):
    """Every shard check_las clean and sorted (B lengths bounded by the
    longest read: the blocks' read ids are local), and the pairs of a
    block with itself give extents."""
    _, port, tmp = runs
    blocks, reads = dense_blocks()
    longest = np.full(max(b.nreads for b in blocks) + 1,
                      max(len(r) for r in reads))
    for i, data in port[(1, "dense")]["shards"].items():
        path = f"{tmp}/check.{i}.las"
        with open(path, "wb") as f:
            f.write(data)
        las = read_las(path)
        assert las.novl > 0
        assert not check_las(las, blocks[i].rlen, longest,
                             sorted_order=True)
    counts = port[(1, "dense")]["counts"]
    assert np.diagonal(counts[:, :, 1]).sum() > 0
