"""Port vs reference: damar_tpu_torch.ops.seeding.find_seeds_canonical_dev
must give damar_tpu's seeds in damar_tpu's order (the pipeline's anchor
dedupe keeps the first of each group, so order is part of the result),
with the same counts, for a self pair and a distinct pair, masked and
unmasked.  Tolerance: exact equality.  Inputs from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.ops.seeding import find_seeds_canonical_dev as ref_seeds
from damar_tpu.utils.sim import make_genome, sample_reads
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.ops import seeding

torch.set_num_threads(2)
COLS = ("aread", "bread", "apos", "bpos", "cov", "comp")


@pytest.fixture(scope="module")
def reads():
    g = make_genome(24_000, seed=31)
    return sample_reads(g, coverage=8.0, mean_len=2500, err=0.14,
                        seed=32).reads


def _mask(cap, seed):
    """Soft-mask runs over ~10% of positions."""
    rng = np.random.default_rng(seed)
    m = np.zeros(cap, bool)
    for s in rng.integers(0, cap, cap // 2000):
        m[s:s + int(rng.integers(50, 400))] = True
    return m


def _compare(ref, got):
    for k in ("nseeds", "total_seeds", "total_hits", "total_emit",
              "raw_cap", "tcap"):
        assert int(ref[k]) == int(got[k]), k
    assert bool(ref["overflow"]) == got["overflow"]
    n = int(ref["nseeds"])
    assert n > 0
    for k in COLS:
        np.testing.assert_array_equal(
            np.asarray(ref[k])[:n], got[k][:n].numpy(), err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_self_pair(reads, masked):
    rb, pb = ref_block(reads), block_from_reads(reads)
    ma = _mask(rb.cap, 5) if masked else None
    kw = dict(upper_only=True, hit_cap=1 << 22, seed_cap=1 << 15,
              self_pair=True)
    ref = ref_seeds(rb, rb, RefConfig(), mask_a=None if ma is None
                    else jnp.asarray(ma), **kw)
    got = seeding.find_seeds_canonical_dev(
        pb, pb, OverlapConfig(), mask_a=None if ma is None
        else torch.as_tensor(ma), device="cpu", **kw)
    _compare(ref, got)


@pytest.mark.parametrize("masked", [False, True])
def test_distinct_pair(reads, masked):
    h = len(reads) // 2
    ra, rb = ref_block(reads[:h]), ref_block(reads[h:])
    pa, pb = block_from_reads(reads[:h]), block_from_reads(reads[h:])
    ma = _mask(ra.cap, 6) if masked else None
    mb = _mask(rb.cap, 7) if masked else None
    kw = dict(upper_only=False, hit_cap=1 << 22, seed_cap=1 << 15)
    j = lambda m: None if m is None else jnp.asarray(m)  # noqa: E731
    t = lambda m: None if m is None else torch.as_tensor(m)  # noqa: E731
    ref = ref_seeds(ra, rb, RefConfig(), mask_a=j(ma), mask_b=j(mb), **kw)
    got = seeding.find_seeds_canonical_dev(pa, pb, OverlapConfig(),
                                           mask_a=t(ma), mask_b=t(mb),
                                           device="cpu", **kw)
    _compare(ref, got)


def test_truncated_buffers_match(reads):
    """Undersized hit and seed buffers overflow the same way (the pipeline
    retries on the flag; the truncated contents still agree)."""
    rb, pb = ref_block(reads), block_from_reads(reads)
    kw = dict(upper_only=True, hit_cap=1 << 17, seed_cap=64,
              self_pair=True, raw_hint=1 << 17)
    ref = ref_seeds(rb, rb, RefConfig(), **kw)
    got = seeding.find_seeds_canonical_dev(pb, pb, OverlapConfig(),
                                           device="cpu", **kw)
    assert got["overflow"]
    _compare(ref, got)


def test_device_has_no_default(reads):
    """Without dev_arrays the caller names the device: leaving it out
    raises instead of running on the host; dev_arrays carry their own
    device, and a device that contradicts them raises."""
    pb = block_from_reads(reads[:6])
    with pytest.raises(TypeError, match="device"):
        seeding.find_seeds_canonical_dev(pb, pb, OverlapConfig(),
                                         self_pair=True)
    with pytest.raises(TypeError):   # keyword-only
        seeding.find_seeds_canonical_dev(pb, pb, OverlapConfig(), None,
                                         None, True, 1 << 22, 1 << 15,
                                         None, None, None, True, None,
                                         None, "cpu")
    arrs = tuple(torch.as_tensor(x) for x in (pb.bases, pb.read_id,
                                              pb.bases, pb.read_id))
    got = seeding.find_seeds_canonical_dev(pb, pb, OverlapConfig(),
                                           self_pair=True, dev_arrays=arrs)
    assert got["aread"].device.type == "cpu"
    with pytest.raises(ValueError, match="dev_arrays"):
        seeding.find_seeds_canonical_dev(pb, pb, OverlapConfig(),
                                         self_pair=True, dev_arrays=arrs,
                                         device="meta")
