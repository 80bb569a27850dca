"""K4's own device code (damar_tpu_torch/csrc/band_align.cu), compiled as
host C++, against the plain torch version on the CPU.

band_align.cu writes its per-pair function (align_pair: the rows in the
lanes' cells, the shuffle scans, the flag bytes, the start column and
the walk) over a lane-exchange policy: warp shuffles on the card, and
here HostGroup, which runs the warp's 32 lanes in lockstep over arrays.
So the whole pair runs here, at each of the three cells-a-lane widths
the launch picks by band, and is held against band_align_plain, which
tests/test_torch_band_align.py holds against damar_tpu's aligners.  The
card test (test_torch_cuda.py) then adds the shuffles and the launch.
Tolerance: exact equality.  Needs g++; skips with a reason without it."""
import ctypes

import numpy as np
import pytest
import torch

from damar_tpu_torch.ops import band_align as ba
from damar_tpu_torch.utils.sim import align_pairs_batch
from test_torch_wave_bp_host import HOST_PRELUDE, build_host

torch.set_num_threads(2)

SHIM = HOST_PRELUDE + r"""
#include "band_align.cu"

// cells a lane: 8, 16 or 48 (the launch picks the smallest that holds
// its largest band)
extern "C" void host_band_align(
    const uint8_t* a, const int64_t* a_off, const uint8_t* b,
    const int64_t* b_off, const int32_t* band, int P, int cells,
    int semiglobal, uint8_t* flags, const int64_t* f_off, uint8_t* ops,
    const int64_t* o_end, int32_t* len, int32_t* jstart) {
  const AlignIO io{a, a_off, b, b_off, band, flags, f_off, ops, o_end, len,
                   jstart, semiglobal};
  const HostGroup x{};
  for (int p = 0; p < P; ++p) {
    if (cells == 8) align_pair<8>(x, io, p);
    else if (cells == 16) align_pair<16>(x, io, p);
    else align_pair<48>(x, io, p);
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build_host(tmp_path_factory, "band_align_host", SHIM)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def host_align(lib, pairs, semi: bool, cells: int):
    """The pairs through align_pair on the host: [(ops, jstart)], or None
    for a pair whose walk left the band."""
    m = np.array([len(p[0]) for p in pairs], np.int64)
    n = np.array([len(p[1]) for p in pairs], np.int64)
    band = np.array([p[2] for p in pairs], np.int32)
    cat = lambda xs: np.ascontiguousarray(  # noqa: E731
        np.concatenate([np.asarray(x, np.uint8) for x in xs] + [
            np.zeros(1, np.uint8)]))
    offs = lambda L: np.concatenate(  # noqa: E731
        [[0], np.cumsum(L)]).astype(np.int64)
    fsz = (m + 1) * (2 * band.astype(np.int64) + 1)
    f_off = (np.cumsum(fsz) - fsz).astype(np.int64)
    o_end = np.cumsum(m + n).astype(np.int64)
    flags = np.zeros(int(fsz.sum()) + 1, np.uint8)
    ops = np.zeros(int(o_end[-1]) + 1, np.uint8)
    ln = np.zeros(len(pairs), np.int32)
    js = np.zeros(len(pairs), np.int32)
    a, ao = cat([p[0] for p in pairs]), offs(m)
    b, bo = cat([p[1] for p in pairs]), offs(n)
    lib.host_band_align(_ptr(a), _ptr(ao), _ptr(b), _ptr(bo), _ptr(band),
                        ctypes.c_int(len(pairs)), ctypes.c_int(cells),
                        ctypes.c_int(int(semi)), _ptr(flags), _ptr(f_off),
                        _ptr(ops), _ptr(o_end), _ptr(ln), _ptr(js))
    return [None if ln[p] < 0 else
            (ops[o_end[p] - ln[p]:o_end[p]], int(js[p]))
            for p in range(len(pairs))]


def _cells(bands) -> int:
    w = 2 * max(bands) + 1
    return 8 if w <= 256 else 16 if w <= 512 else 48


@pytest.mark.parametrize("bands,semi,seed", [
    ((64, 96), True, 1), ((64, 96), False, 2), ((200,), True, 3),
    ((200, 64), False, 4), ((700, 96), True, 5), ((700,), False, 6)])
def test_align_pair_matches_plain(host, bands, semi, seed):
    """Ragged fuzz batches at each cells-a-lane width (8, 16, 48), both
    modes: every pair's ops and jstart equal band_align_plain's."""
    rng = np.random.default_rng(seed)
    pairs = align_pairs_batch(rng, 24, bands=bands, semiglobal=semi,
                              max_len=900)
    got = host_align(host, pairs, semi, _cells(bands))
    want = ba.align_pairs(pairs, semi, device="cpu")
    for g, (o, j) in zip(got, want):
        assert g is not None
        assert np.array_equal(g[0], o) and g[1] == j


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
    got = host_align(host, pairs, True, 8)
    want = ba.align_pairs(pairs, True, device="cpu")
    assert all(np.array_equal(g[0], o) and g[1] == j
               for g, (o, j) in zip(got, want))
    far = [(np.zeros(50, np.uint8), np.zeros(10, np.uint8), 8)]
    assert host_align(host, far, False, 8) == [None]
    with pytest.raises(ValueError):
        ba.align_pairs(far, False, device="cpu")
