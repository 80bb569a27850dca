"""The port's ring sweep with many wide-band retries: the non-spread
8-block DB of tests/test_torch_ring_dense.py with max_segs cut to 28, so
every record of more than 28 trace segments fails the bit-parallel
trace's checks and is retried on the wide band (K3's plain version here,
through the pair path's wide_retry; the reference's pure-JAX
trace_wave), appended after the pair's passing records in the
reference's order.  Against damar_tpu's ring on its 8-device mesh with
the same max_segs; the port as 4 ranks spawned over gloo.  Tolerance:
byte equality of every .las shard, and the counts equal."""
import pytest

from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu_torch.core.config import OverlapConfig
from test_torch_ring import assert_same_shards, port_runs, reference_ring
from test_torch_ring_dense import CFG, dense_blocks

RETRY_SEGS = 28


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ringr"))
    ref = reference_ring(tmp, dense_blocks(ref=True)[0],
                         RefConfig(seed_batch=256, **CFG),
                         max_segs=RETRY_SEGS, seed_cap=1024,
                         hit_cap=1 << 16)
    port = port_runs(tmp, [("retry", dense_blocks()[0], OverlapConfig(**CFG),
                            {"max_segs": RETRY_SEGS}, "las")], worlds=(4,))
    return ref, port


def test_forced_wide_retries_byte_equal(runs):
    ref, port = runs
    assert_same_shards(ref, port[(4, "retry")])
    assert port[(4, "retry")]["stats"]["trace_retries"] >= 10
