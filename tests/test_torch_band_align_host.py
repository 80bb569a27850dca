"""K4's own device code (damar_tpu_torch/csrc/band_align.cu), compiled as
host C++, against damar_tpu's host C band_align and the plain torch
version on the CPU.

band_align.cu writes its per-pair function (align_pair: the rows in the
threads' cells, the shuffle scans, the cross-warp exchange of a wide
pair, the 2-bit codes, the start column and the walk) over a
lane-exchange policy: warp shuffles and a named barrier on the card,
and here HostGroup, which runs a group's W warps of 32 lanes in lockstep
over arrays, the warps' slots in shared memory included.  So each pair
runs here on its own group, narrow (one warp) or wide (2 to 6 warps),
with its codes in "shared memory" (a buffer the size the launch would
give) or in global scratch through the staged walk, and is held against
band_align_plain and the reference's C (damar_tpu.native), which
tests/test_torch_band_align.py holds band_align_plain against.  The card
test (test_torch_cuda.py) then adds the shuffles and the launch.
Tolerance: exact equality.  Needs g++; skips with a reason without it."""
import ctypes

import numpy as np
import pytest
import torch

from damar_tpu import native
from damar_tpu_torch.ops import band_align as ba
from damar_tpu_torch.utils.sim import align_pairs_batch
from test_torch_wave_bp_host import HOST_PRELUDE, build_host

torch.set_num_threads(2)

SHIM = HOST_PRELUDE + r"""
#include <vector>
#include "band_align.cu"

// every pair on its own group (W warps by its band), as the launch runs
// it; c_off[p] < 0: the pair's codes in a buffer of smem_bytes
extern "C" void host_band_align(
    const uint8_t* a, const int64_t* a_off, const uint8_t* b,
    const int64_t* b_off, const int32_t* band, int P, const int64_t* c_off,
    int semiglobal, uint8_t* codes, int smem_bytes, uint8_t* ops,
    const int64_t* o_end, int32_t* len, int32_t* jstart) {
  const AlignIO io{a, a_off, b, b_off, band, codes, c_off, ops, o_end, len,
                   jstart, semiglobal};
  std::vector<uint8_t> smem(smem_bytes + 16), stage(MAX_WARPS * STAGE_BYTES);
  Xchg xs;
  for (int p = 0; p < P; ++p) {
    const int W = group_warps(band[p]);
    align_pair(HostGroup{W}, io, p, smem.data(), stage.data(),
               W > 1 ? MAX_WARPS * STAGE_BYTES : STAGE_BYTES, &xs);
  }
}
"""

# widths on both sides of every warp boundary (256 cells a warp), the
# polish's first-cover band (696) and the largest band (767)
WIDE_BANDS = (127, 128, 255, 256, 383, 384, 696, 767)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build_host(tmp_path_factory, "band_align_host", SHIM)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def host_align(lib, pairs, semi: bool, codes: str = "plan"):
    """The pairs through align_pair on the host: [(ops, jstart)], or None
    for a pair whose walk left the band.  codes: "plan" puts each pair's
    codes where plan_launch does (a wide pair's in shared memory when
    they fit), "global" every pair's in global scratch (staged walk)."""
    a, a_off, b, b_off, band = ba._host_pairs(pairs)
    plan = ba.plan_launch(np.diff(a_off), np.diff(b_off), band)
    c_off, smem = plan.c_off, plan.smem
    if codes == "global":
        width = 2 * plan.band + 1
        cb = (plan.m + 1) * (16 * -(-width // 64))
        c_off, smem = np.cumsum(cb) - cb, 0
        nbytes = int(cb.sum())
    else:
        nbytes = plan.code_bytes
    scratch = np.zeros(nbytes + 16, np.uint8)
    ops = np.zeros(plan.ops_bytes + 1, np.uint8)
    ln = np.zeros(len(pairs), np.int32)
    js = np.zeros(len(pairs), np.int32)
    a, b = (np.concatenate([x, np.zeros(1, np.uint8)]) for x in (a, b))
    c_off = np.ascontiguousarray(c_off, np.int64)
    lib.host_band_align(_ptr(a), _ptr(a_off), _ptr(b), _ptr(b_off),
                        _ptr(band), ctypes.c_int(len(pairs)), _ptr(c_off),
                        ctypes.c_int(int(semi)), _ptr(scratch),
                        ctypes.c_int(smem), _ptr(ops), _ptr(plan.o_end),
                        _ptr(ln), _ptr(js))
    o_end = plan.o_end
    return [None if ln[p] < 0 else
            (ops[o_end[p] - ln[p]:o_end[p]], int(js[p]))
            for p in range(len(pairs))]


def _same(got, want):
    return all(g is not None and np.array_equal(g[0], o) and g[1] == j
               for g, (o, j) in zip(got, want))


@pytest.mark.parametrize("bands,semi,seed", [
    ((64, 96), True, 1), ((64, 96), False, 2), ((200,), True, 3),
    ((200, 64), False, 4), ((700, 96), True, 5), ((700,), False, 6)])
def test_align_pair_matches_plain(host, bands, semi, seed):
    """Ragged fuzz batches, narrow and wide pairs mixed, both modes, both
    placements of the codes: every pair's ops and jstart equal
    band_align_plain's."""
    rng = np.random.default_rng(seed)
    pairs = align_pairs_batch(rng, 24, bands=bands, semiglobal=semi,
                              max_len=900)
    want = ba.align_pairs(pairs, semi, device="cpu")
    for codes in ("plan", "global"):
        assert _same(host_align(host, pairs, semi, codes), want)


def _native(pairs, semi):
    out = []
    for a, b, band in pairs:
        ops, offs, jst = native.band_align_paths(a, [b], band, semi)
        out.append((ops[:offs[1]], int(jst[0])))
    return out


@pytest.mark.parametrize("band", WIDE_BANDS)
@pytest.mark.parametrize("semi", [True, False])
def test_groups_across_warp_edges(host, band, semi):
    """Each band on both sides of a warp boundary (1 to 6 warps), fuzz
    pairs with margins, shorter covers (n - m negative, odd ones among
    them), unrelated and empty covers, mixed with band-64 pairs in one
    launch: the group's cross-warp scan, the up term and left neighbour
    at warp edges, the 2-bit codes and both walks equal the reference's
    C and band_align_plain, pair by pair."""
    if not native.available():
        pytest.skip("needs damar_tpu's native library (a C compiler)")
    rng = np.random.default_rng(band * 2 + semi)
    pairs = align_pairs_batch(rng, 10, bands=(band, band, 64),
                              semiglobal=semi, max_len=700)
    # an empty cover, and a cover shorter by an odd count at the band
    m = band // 2 if not semi else 301
    t = rng.integers(0, 4, m).astype(np.uint8)
    pairs += [(t, np.zeros(0, np.uint8), band), (t, t[:m - 2 * (m // 4) - 1]
                                                 if semi else t[1:], band)]
    want = _native(pairs, semi)
    assert _same([(o, j) for o, j in ba.align_pairs(pairs, semi,
                                                     device="cpu")], want)
    for codes in ("plan", "global"):
        assert _same(host_align(host, pairs, semi, codes), want)


def test_band_edges_and_global_walk_out_of_band(host):
    """Tiny bands with n - m across both band edges (every parity), and a
    global pair whose end column lies outside the band: the host code
    marks it (length -1) where the plain version raises."""
    rng = np.random.default_rng(7)
    pairs = []
    for band in range(1, 7):
        for d in range(-2 * band - 3, 2 * band + 4):
            m = int(rng.integers(0, 14))
            pairs.append((rng.integers(0, 4, m).astype(np.uint8),
                          rng.integers(0, 4, max(0, m + d)).astype(np.uint8),
                          band))
    want = ba.align_pairs(pairs, True, device="cpu")
    assert _same(host_align(host, pairs, True), want)
    far = [(np.zeros(50, np.uint8), np.zeros(10, np.uint8), 8),
           (np.zeros(700, np.uint8), np.zeros(0, np.uint8), 300)]
    assert host_align(host, far, False) == [None, None]
    for p in far:
        with pytest.raises(ValueError, match="band"):
            ba.align_pairs([p], False, device="cpu")


def test_plan_classes_order_and_placement():
    """plan_launch: narrow pairs (bands <= 127) first, then wide ones,
    each class longest first, fewer narrow pairs a block than six where
    the launch would not fill the card's SMs; a wide pair's codes in shared memory when
    they fit SMEM_CAP, sized to the largest such pair; narrow pairs' and
    too-large pairs' codes in 16-byte aligned global scratch; a call of
    only narrow pairs takes no dynamic shared memory; bands above
    MAX_BAND and negative bands raise."""
    m = np.array([500, 10, 0, 1300, 400, 90])
    n = np.array([600, 3, 5, 1400, 380, 0])
    band = np.array([96, 696, 200, 767, 127, 128])
    p = ba.plan_launch(m, n, band)
    # few pairs: a narrow pair a block; enough to fill 132 SMs: up to 6
    assert (p.n_narrow, p.n_wide, p.per_block, p.blocks) == (2, 4, 1, (2, 4))
    assert ba.plan_launch(*[np.repeat(x, 150) for x in (m[:1], n[:1],
                                                        band[:1])]
                          ).per_block == 2
    assert ba.plan_launch(*[np.repeat(x, 400) for x in (m, n, band)]
                          ).per_block == 6
    assert p.order.tolist() == [4, 0, 3, 5, 1, 2]
    stride = 16 * -(-(2 * band + 1) // 64)
    cb = (m + 1) * stride
    assert (stride % 16 == 0).all() and cb[3] > ba.SMEM_CAP
    assert p.c_off.tolist()[1:3] == [-1, -1] and p.c_off[5] == -1
    glob = [0, 3, 4]
    assert sorted(p.c_off[glob].tolist()) == p.c_off[glob].tolist()
    assert p.code_bytes == int(cb[glob].sum())
    assert p.smem == int(max(cb[1], cb[2], cb[5]))
    assert p.o_end.tolist() == np.cumsum(m + n).tolist()
    assert ba.plan_launch(m[[0, 4]], n[[0, 4]], band[[0, 4]]).smem == 0
    for bad in (ba.MAX_BAND + 1, -1):
        with pytest.raises(ValueError, match="band"):
            ba.plan_launch([5], [5], [bad])
