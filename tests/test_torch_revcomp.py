"""The reverse-complement twin made on the device (ops/revcomp.py and
csrc/revcomp.cu's revcomp_kernel) against core.blocks.revcomp_block,
which is held against damar_tpu's revcomp_block: the plain torch form,
the kernel's device code compiled as host C++ (skips with a reason
without g++), and a device twin run through the pair pipeline on the
CPU, whose .las bytes must equal the host twin's.  Blocks: random reads
with padding past nbases, 1-base reads, a read ending at cap, and an
empty block.  Tolerance: exact equality."""
import ctypes

import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.blocks import revcomp_block as ref_revcomp
from damar_tpu_torch.core.blocks import (ReadBlock, block_from_reads,
                                         build_block, revcomp_block)
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.ops.revcomp import revcomp_bases, revcomp_plain
from damar_tpu_torch.pipeline import overlap as ov
from damar_tpu_torch.utils.sim import make_genome, sample_reads
from test_torch_wave_bp_host import HOST_PRELUDE, build_host

torch.set_num_threads(2)


def _random_reads(rng, n, lo=1, hi=900):
    return [rng.integers(0, 4, int(k), dtype=np.uint8)
            for k in rng.integers(lo, hi, n)]


def _blocks():
    """name -> (reads, cap) of each test block (cap None: the bucket)."""
    rng = np.random.default_rng(7)
    ones = [rng.integers(0, 4, 1, dtype=np.uint8) for _ in range(37)]
    mixed = _random_reads(rng, 300)
    for i in range(0, 300, 17):                       # 1-base reads inside
        mixed[i] = mixed[i][:1]
    at_cap = _random_reads(rng, 41, 2, 3000)
    return {
        "random_padded": (_random_reads(rng, 500), None),
        "one_base_reads": (ones, None),
        "mixed_lengths": (mixed, None),
        "read_ends_at_cap": (at_cap, int(sum(len(r) for r in at_cap))),
        "odd_cap": (_random_reads(rng, 9), 4099),
        "empty": ([], None),
    }


BLOCKS = _blocks()


def _block(name):
    reads, cap = BLOCKS[name]
    return block_from_reads(reads, cap=cap), reads, cap


def _dev_args(blk):
    return (torch.as_tensor(blk.bases), torch.as_tensor(blk.read_id),
            torch.as_tensor(blk.starts.astype(np.int64)), blk.nbases)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_port_revcomp_block_matches_reference(name):
    blk, reads, cap = _block(name)
    ref = ref_block(reads, cap=cap)
    np.testing.assert_array_equal(blk.bases, ref.bases)
    want = ref_revcomp(ref).bases
    got = revcomp_block(blk).bases
    np.testing.assert_array_equal(got, want)
    if name == "read_ends_at_cap":
        assert blk.nbases == blk.cap
    elif name != "empty":
        assert blk.nbases < blk.cap and (got[blk.nbases:] == 4).all()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_plain_form_matches_revcomp_block(name):
    blk, _, _ = _block(name)
    got = revcomp_bases(*_dev_args(blk))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), revcomp_block(blk).bases)


def test_codes_past_three_wrap_as_revcomp_block():
    """3 - code in uint8 arithmetic, as revcomp_block computes it, for a
    code of 4 inside a read."""
    bases = np.array([0, 4, 2, 1, 3, 4, 4], np.uint8)
    blk = build_block(bases[:5], np.array([0, 2, 5]), np.arange(2), cap=7)
    blk.bases[:] = bases
    want = revcomp_block(blk).bases
    assert want[0] == 255
    np.testing.assert_array_equal(revcomp_plain(*_dev_args(blk)).numpy(),
                                  want)


# --- the kernel's device code as host C++ ----------------------------------

HOST_SHIM = HOST_PRELUDE + r"""
#include "revcomp.cu"

extern "C" void host_revcomp(const uint8_t* in, uint8_t* out,
                             const int32_t* read_id, const long long* starts,
                             long long nbases, long long cap, int vec) {
  const RcArgs a{in, out, read_id, starts, nbases, cap};
  for (int64_t q = 0; q < (cap + 3) / 4; ++q) rc_quad(a, q, vec != 0);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build_host(tmp_path_factory, "revcomp_host", HOST_SHIM)


def _aligned(a: np.ndarray) -> np.ndarray:
    """A copy of `a` at a 16-byte aligned address."""
    buf = np.zeros(a.nbytes + 16, np.uint8)
    off = (-buf.ctypes.data) % 16
    out = buf[off:off + a.nbytes].view(a.dtype)
    out[:] = a
    return out


def host_revcomp(lib, blk, vec: bool):
    bases = _aligned(blk.bases)
    rid = _aligned(blk.read_id.astype(np.int32))
    starts = np.ascontiguousarray(blk.starts, dtype=np.int64)
    out = _aligned(np.full(blk.cap, 9, np.uint8))
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.host_revcomp(ptr(bases), ptr(out), ptr(rid), ptr(starts),
                     ctypes.c_longlong(blk.nbases), ctypes.c_longlong(blk.cap),
                     ctypes.c_int(int(vec)))
    return out


@pytest.mark.parametrize("vec", [True, False], ids=["quads", "positions"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_kernel_device_code_matches_revcomp_block(host, name, vec):
    blk, _, _ = _block(name)
    np.testing.assert_array_equal(host_revcomp(host, blk, vec),
                                  revcomp_block(blk).bases)


# --- the device twin in the pair pipeline ------------------------------------

CFG = OverlapConfig(min_len=500)


def _pair_blocks():
    reads = sample_reads(make_genome(24_000, seed=3), coverage=8.0,
                         mean_len=2500, err=0.14, seed=4).reads
    h = len(reads) // 2
    return (block_from_reads(reads[:h], ids=np.arange(h)),
            block_from_reads(reads[h:], ids=np.arange(h, len(reads))))


def _same_las(x, y):
    assert x.novl == y.novl
    for k in ("headers", "trace", "offsets"):
        np.testing.assert_array_equal(getattr(x.columns, k),
                                      getattr(y.columns, k))


def _with_device_twins(*blks):
    for b in blks:
        b.cache["rc_block"] = ov._device_twin(b)


@pytest.mark.parametrize("self_pair", [True, False], ids=["self", "distinct"])
def test_device_twin_gives_host_twin_las(self_pair):
    """A device twin (bases made by revcomp_bases at first use; here its
    plain form) gives the host twin's records, counted as device builds:
    one a pair for a self pair's shared twin, A's and B's for a distinct
    pair with mirrors, and none once they are made."""
    a, b = _pair_blocks()
    if self_pair:
        b = a
    want = ov.overlap_block_pair(a, b, CFG, self_pair, device="cpu")
    assert want[2]["rc_dev_built"] == 0
    for blk in (a, b):
        assert blk.cache["rc_block"].bases is not None
    a2, b2 = _pair_blocks()
    if self_pair:
        b2 = a2
    _with_device_twins(a2, b2)
    for rnd in range(2):
        got = ov.overlap_block_pair(a2, b2, CFG, self_pair, device="cpu")
        _same_las(got[0], want[0])
        _same_las(got[1], want[1])
        assert got[0].novl > 0
        st = got[2]
        assert st["rc_dev_built"] == ((1 if self_pair else 2) if rnd == 0
                                      else 0)
    for blk in (a2, b2):
        assert blk.cache["rc_block"].bases is None
    # released: the twin is kept, made again at its next use
    ov.release_device_buffers(b2)
    assert "dev_arrs" not in b2.cache["rc_block"].cache
    got = ov.overlap_block_pair(a2, b2, CFG, self_pair, device="cpu")
    _same_las(got[0], want[0])
    assert got[2]["rc_dev_built"] == 1
    assert b2.cache["rc_block"].bases is None


def test_device_twin_build_is_spanned_in_t_rc():
    """A device twin's build is the span rc.build, inside the phase that
    first uses the twin's bases (pair.extend for B's, pair.pool for A's),
    one a build; t_rc is the pair's pair.rc_twin and rc.build spans."""
    from torch.profiler import ProfilerActivity, profile

    from damar_tpu_torch.utils.trace import PREFIX
    a, b = _pair_blocks()
    _with_device_twins(a, b)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = ov.overlap_block_pair(a, b, CFG, False, device="cpu")[2]
    spans = [(e.name()[len(PREFIX):], e.start_ns(),
              e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(PREFIX)]
    builds = [(s, e) for n, s, e in spans if n == "rc.build"]
    assert len(builds) == st["rc_dev_built"] == 2
    for phase in ("pair.extend", "pair.pool"):
        ps, pe = next((s, e) for n, s, e in spans if n == phase)
        assert sum(ps <= s and e <= pe for s, e in builds) == 1, phase
    timed = sum(e - s for n, s, e in spans
                if n in ("pair.rc_twin", "rc.build")) / 1e9
    assert abs(st["t_rc"] - timed) < 2e-3


@pytest.mark.parametrize("device_twin", [False, True],
                         ids=["host_twin", "device_twin"])
def test_blocks_with_their_caches_pickle(device_twin):
    """Blocks that have run a pair (twin and trace pool in their caches)
    pickle, as spawn_ranks sends them to its ranks; the loaded copies
    give the same records, a loaded device twin refers to its loaded
    forward block, and the pool is made again for the loaded blocks."""
    import pickle
    a, b = _pair_blocks()
    if device_twin:
        _with_device_twins(a, b)
    want = ov.overlap_block_pair(a, b, CFG, False, device="cpu")
    a2, b2 = pickle.loads(pickle.dumps([a, b]))
    for x, x2 in ((a, a2), (b, b2)):
        rc2 = x2.cache["rc_block"]
        assert (rc2.bases is None) == device_twin
        if device_twin:
            assert rc2.cache["rc_of"]() is x2
            rc2.cache.pop("dev_arrs")
    got = ov.overlap_block_pair(a2, b2, CFG, False, device="cpu")
    _same_las(got[0], want[0])
    _same_las(got[1], want[1])
    assert got[2]["rc_dev_built"] == (2 if device_twin else 0)
    assert [r() for r in a2.cache["trace_pool"][1]] == [
        a2, b2, b2.cache["rc_block"], a2.cache["rc_block"]]


def test_trace_pool_dedupes_a_self_pairs_shared_twin():
    """A self pair's pool is [A fwd | A rc]: one part per block object,
    offsets from the blocks' caps, whether the twin is on the host or a
    device twin."""
    for device_twin in (False, True):
        a, _ = _pair_blocks()
        if device_twin:
            _with_device_twins(a)
        rc = ov._rc_cached(a, "cpu")
        assert (rc.bases is None) == device_twin
        words, oa, obf, obc, oar = ov._trace_pool(a, a, rc, rc, True, "cpu")
        assert (oa, obf, obc, oar) == (0, 0, a.cap, a.cap)
        assert words.shape[0] == 2 * a.cap // 16
        assert ov._trace_pool(a, a, rc, rc, True, "cpu")[0] is words
        np.testing.assert_array_equal(
            ov._dev_arr(rc, "bases", "cpu").numpy(), revcomp_block(a).bases)


def test_device_twin_shares_its_forward_arrays():
    a, _ = _pair_blocks()
    twin = ov._device_twin(a)
    assert isinstance(twin, ReadBlock) and twin.cap == a.cap
    assert twin.read_id is a.read_id and twin.starts is a.starts
    stats = {}
    ov._dev_arr(twin, "bases", "cpu", stats)
    ov._dev_arr(twin, "bases", "cpu", stats)
    assert stats["rc_dev_built"] == 1 and stats.keys() == {"rc_dev_built",
                                                            "t_rc"}
    del a
    import gc
    gc.collect()
    twin.cache.pop("dev_arrs")
    with pytest.raises(RuntimeError, match="outlived"):
        ov._dev_arr(twin, "bases", "cpu")
