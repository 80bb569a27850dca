"""The port's ring sweep on tests/test_parallel.py's 12-block spread DB
(test_byte_equality_multiround_12_blocks): more blocks than ranks, so
ceil(12/D)^2 sweeps of super-rows against super-rows, against damar_tpu's
2 x 2 sweeps on its 8-device mesh (12 blocks padded to 16).  The port
runs with the reference's explicit caps (1024 seeds, 2^16 hits: a pair
that saturates one runs again bigger) at 1 rank in this process and 3
and 4 ranks spawned over gloo.  Tolerance: byte equality of every .las
shard, and the counts equal."""
import pytest

from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu_torch.core.config import OverlapConfig
from test_torch_ring import (SPREAD_CFG, WORLDS, assert_same_shards,
                             port_runs, reference_ring, spread_blocks)

CAPS = dict(seed_cap=1024, hit_cap=1 << 16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ring12"))
    ref = reference_ring(tmp, spread_blocks(12, 83, ref=True),
                         RefConfig(seed_batch=256, **SPREAD_CFG), **CAPS)
    port = port_runs(tmp, [("eq12", spread_blocks(12, 83),
                            OverlapConfig(**SPREAD_CFG), CAPS, "las")])
    return ref, port


@pytest.mark.parametrize("world", WORLDS)
def test_multiround_12_blocks_byte_equal(runs, world):
    ref, port = runs
    assert_same_shards(ref, port[(world, "eq12")])
