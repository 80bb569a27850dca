"""Port vs reference: the legacy canonical seeding path (block positions
with the strand bit as payload, the double-bucketed banding with the
strand in its key), which a block takes when its packed payload passes
32 bits, and -b (biased-composition seeding: band coverage weighted by
the A block's base composition) on the packed, legacy and sliced paths.
Tolerance: exact equality (integers); the .las bytes of both paths end
to end are in tests/test_torch_seed_las.py.

The legacy path is forced in both packages as the reference's own
condition takes it: packed_payload_host returns None.  The reads of the
-b cases come from an AT-rich genome, so the weights change the seeds.
The reference runs its legacy path with a buffer from its own guess
(fault 3h); the caps passed here hold every hit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.ops import seeding as ref_seeding
from damar_tpu.utils.sim import make_genome, sample_reads
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.ops import seeding

torch.set_num_threads(2)
COLS = ("aread", "bread", "apos", "bpos", "cov", "comp")
HIT_CAP, SEED_CAP = 1 << 22, 1 << 15


@pytest.fixture(scope="module")
def reads():
    g = make_genome(30_000, seed=71)
    return sample_reads(g, coverage=8.0, mean_len=3000, err=0.13,
                        seed=72).reads


@pytest.fixture(scope="module")
def at_rich():
    """Reads over a genome of 40% A, 10% C, 10% G, 40% T."""
    g = np.random.default_rng(73).choice(
        4, 30_000, p=[0.4, 0.1, 0.1, 0.4]).astype(np.uint8)
    return sample_reads(g, coverage=8.0, mean_len=3000, err=0.13,
                        seed=74).reads


def _mask(cap, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros(cap, bool)
    for s in rng.integers(0, cap, cap // 2000):
        m[s:s + int(rng.integers(50, 400))] = True
    return m


def _legacy(monkeypatch):
    for mod in (seeding, ref_seeding):
        monkeypatch.setattr(mod, "packed_payload_host", lambda blk: None)


def _blocks(reads, self_pair):
    if self_pair:
        return ref_block(reads), ref_block(reads), \
            block_from_reads(reads), block_from_reads(reads)
    h = len(reads) // 2
    ia, ib = np.arange(h), np.arange(h, len(reads))
    return (ref_block(reads[:h], ids=ia), ref_block(reads[h:], ids=ib),
            block_from_reads(reads[:h], ids=ia),
            block_from_reads(reads[h:], ids=ib))


def _seeds(ra, rb, pa, pb, self_pair, ma=None, mb=None, ref_fn=None,
           **kw):
    """(reference, port) seeds of one pair, same arguments."""
    kw = dict(upper_only=self_pair, self_pair=self_pair, hit_cap=HIT_CAP,
              seed_cap=SEED_CAP, **kw)
    j = lambda m: None if m is None else jnp.asarray(m)  # noqa: E731
    t = lambda m: None if m is None else torch.as_tensor(m)  # noqa: E731
    ref_fn = ref_fn or ref_seeding.find_seeds_canonical_dev
    want = ref_fn(ra, rb, RefConfig(), mask_a=j(ma), mask_b=j(mb), **kw)
    got = seeding.find_seeds_canonical_dev(pa, pb, OverlapConfig(),
                                           mask_a=t(ma), mask_b=t(mb),
                                           device="cpu", **kw)
    return want, got


def _same(want, got):
    for k in ("nseeds", "total_seeds", "total_hits"):
        assert int(want[k]) == int(got[k]), k
    assert bool(want["overflow"]) == got["overflow"]
    n = int(want["nseeds"])
    assert n > 100
    for k in COLS:
        np.testing.assert_array_equal(got[k][:n].numpy(),
                                      np.asarray(want[k])[:n], err_msg=k)


@pytest.mark.parametrize("self_pair,masked", [(True, False), (True, True),
                                              (False, True)])
def test_legacy_equals_reference(reads, monkeypatch, self_pair, masked):
    ra, rb, pa, pb = _blocks(reads, self_pair)
    ma = _mask(pa.cap, 5) if masked else None
    mb = _mask(pb.cap, 6) if masked and not self_pair else None
    _legacy(monkeypatch)
    want, got = _seeds(ra, rb, pa, pb, self_pair, ma, mb,
                       ref_fn=ref_seeding._find_seeds_canonical_dev_legacy)
    assert got["path"] == "legacy"
    _same(want, got)


def test_legacy_index_of_a_33_bit_block():
    """A block of 8,192 short reads and one of 2^18 bp: 14 + 19 + 1 = 34
    payload bits, so both packages build the legacy index (block
    positions, pos << 1 | strand), and the two indexes are equal."""
    rng = np.random.default_rng(75)
    reads = [rng.integers(0, 4, 100).astype(np.uint8)
             for _ in range(8192)] + [rng.integers(0, 4, 1 << 18)
                                      .astype(np.uint8)]
    rb, pb = ref_block(reads), block_from_reads(reads)
    assert seeding.payload_bits(pb) == (14, 19)
    assert seeding.packed_payload_host(pb) is None
    tag, (codes, pos2) = seeding.canonical_index_dev(
        torch.as_tensor(pb.bases), torch.as_tensor(pb.read_id), pb, 14)
    rtag, (rcodes, rpos2) = ref_seeding.canonical_index_dev(
        jnp.asarray(rb.bases), jnp.asarray(rb.read_id), rb, 14)
    assert tag == rtag == "legacy"
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rcodes))
    np.testing.assert_array_equal(pos2.numpy(), np.asarray(rpos2))


@pytest.mark.parametrize("path", ["packed", "legacy", "sliced"])
def test_bias_seeds(at_rich, monkeypatch, path):
    """-b on each path: the seeds of find_seeds_canonical_dev(bias_lut=)
    equal the reference's, and differ from the unweighted ones."""
    ra, rb, pa, pb = _blocks(at_rich, True)
    lut = seeding.bias_weight_lut(pa.bases)
    np.testing.assert_array_equal(lut, ref_seeding.bias_weight_lut(ra.bases))
    assert lut.min() < 256 < lut.max()
    if path == "legacy":
        _legacy(monkeypatch)
    if path == "sliced":
        for mod in (seeding, ref_seeding):
            monkeypatch.setattr(mod, "_SLICE_CAP", 1 << 10)
            monkeypatch.setattr(mod, "_SLICE_CHUNK", 1 << 19)
    want, got = _seeds(ra, rb, pa, pb, True, bias_lut=lut)
    assert got["path"] == path
    _same(want, got)
    plain = seeding.find_seeds_canonical_dev(
        pa, pb, OverlapConfig(), upper_only=True, self_pair=True,
        hit_cap=HIT_CAP, seed_cap=SEED_CAP, device="cpu")
    assert plain["total_seeds"] != got["total_seeds"]
