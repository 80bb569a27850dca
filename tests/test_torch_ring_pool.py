"""The ring's pools of one kernel launch: a pool (the A-blocks', or the
B-blocks' in both orientations) never passes RING_POOL_BYTES, the
kernels' int32 positions into it.  With the limit patched down to a few
block capacities the pending work is launched before a B-block that
would pass it joins, and the shards are the same bytes as with the limit at 2^31 - 1;
a block that alone passes the limit raises.  Port only, on the CPU (the
kernels' plain versions), a ring of one rank over 4 small blocks."""
import numpy as np
import pytest
import torch

from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import write_las
from damar_tpu_torch.parallel import distributed as dd
from damar_tpu_torch.utils import sim

torch.set_num_threads(2)
CFG = OverlapConfig(min_len=500, max_read_len=8192)
NBLOCKS = 4


def small_blocks() -> list:
    g = sim.make_genome(6000, seed=0)
    r = sim.sample_reads(g, coverage=3.0, mean_len=1200, err=0.12, seed=1,
                         min_len=600)
    ids = np.arange(len(r.reads))
    return [block_from_reads([r.reads[i] for i in ids[d::NBLOCKS]],
                             ids=ids[d::NBLOCKS], cap=1 << 13)
            for d in range(NBLOCKS)]


def shard_bytes(tmp, tag: str) -> dict:
    las, _, total = dd.distributed_overlap_las(small_blocks(), CFG,
                                               device="cpu")
    assert total[1] > 0
    out = {}
    for i, lf in las.items():
        write_las(f"{tmp}/{tag}.{i}.las", lf)
        with open(f"{tmp}/{tag}.{i}.las", "rb") as f:
            out[i] = f.read()
    return out


@pytest.fixture(scope="module")
def want(tmp_path_factory):
    return shard_bytes(tmp_path_factory.mktemp("pool"), "full")


@pytest.mark.parametrize("caps", [2, 5])
def test_pools_stay_within_the_limit(want, tmp_path, monkeypatch, caps):
    """At 2 caps one B-block (both orientations) fills the B pool; at 5
    the third B-block would pass it while the A pool is still small."""
    limit = caps * (1 << 13)
    monkeypatch.setattr(dd, "RING_POOL_BYTES", limit)
    sizes, flushes = [], []
    add, flush_e, flush_t = (dd._Pool.add, dd._ExtendBatch.flush,
                             dd._TraceBatch.flush)

    def spy_add(self, key, make):
        offs = add(self, key, make)
        sizes.append(self.size)
        return offs

    def spy(fn, name):
        def wrapped(self):
            if self.pend:
                flushes.append(name)
            return fn(self)
        return wrapped

    monkeypatch.setattr(dd._Pool, "add", spy_add)
    monkeypatch.setattr(dd._ExtendBatch, "flush", spy(flush_e, "extend"))
    monkeypatch.setattr(dd._TraceBatch, "flush", spy(flush_t, "trace"))
    got = shard_bytes(tmp_path, "cut")
    assert got == want
    assert max(sizes) <= limit
    # a launch at least every other B-block: more than one per A-block
    assert (flushes.count("extend") > NBLOCKS
            and flushes.count("trace") > NBLOCKS)


def test_a_block_past_the_limit_raises(monkeypatch):
    monkeypatch.setattr(dd, "RING_POOL_BYTES", (1 << 13) + 1)
    with pytest.raises(ValueError, match="passes the ring's pool"):
        dd.distributed_overlap(small_blocks(), CFG, device="cpu")
