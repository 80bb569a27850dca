"""The port's ring sweep with the reference's explicit caps on
tests/test_parallel.py's seed_cap=8 grow case (test_seed_cap_grow_retry:
the spread 8-block DB of seed 85 at 4x): pairs holding more seeds than 8
saturate, their sweeps run again with the seed cap doubled, and the
result is the same as with buffers large enough from the start.  Against
damar_tpu's ring on its 8-device mesh with the same caps; the port at 1
rank in this process and 3 and 4 ranks spawned over gloo, its counts
the reference's after the ladder.  Tolerance: byte equality of every
.las shard, and the counts equal."""
import pytest

from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu_torch.core.config import OverlapConfig
from test_torch_ring import (SPREAD_CFG, WORLDS, assert_same_shards,
                             port_runs, reference_ring, spread_blocks)

CAPS = dict(seed_cap=8, hit_cap=1 << 16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ringg"))
    ref = reference_ring(tmp, spread_blocks(8, 85, cov=4.0, ref=True),
                         RefConfig(seed_batch=256, **SPREAD_CFG), **CAPS)
    port = port_runs(tmp, [("grow", spread_blocks(8, 85, cov=4.0),
                            OverlapConfig(**SPREAD_CFG), CAPS, "las")])
    return ref, port


@pytest.mark.parametrize("world", WORLDS)
def test_seed_cap_grow_byte_equal(runs, world):
    ref, port = runs
    assert ref["counts"][:, :, 0].max() > CAPS["seed_cap"]
    assert_same_shards(ref, port[(world, "grow")])
