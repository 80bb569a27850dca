"""K3's own device code (damar_tpu_torch/csrc/dp_rows.cu), compiled as
host C++, against the plain torch versions on the CPU.

dp_rows.cu writes its per-band functions over a lane-exchange policy:
warp shuffles on the card, and here HostGroup, which runs a group's
threads in lockstep over arrays.  So the whole per-extent trace
(wide_trace_extent: char streams, the warp row, the first-min reduction,
the commit) and the chunk-form band (dp_rows_band, both modes) run here
and are held against trace_wave_plain and dp_rows_plain, which
tests/test_torch_wave_wide.py holds against the Pallas kernel.  The
scalar parts are checked on their own too: the B-window char read by the
clip rule, the segment length and the end column.  The card tests
(test_torch_cuda.py) then add the shuffles and the launch.  Tolerance:
exact equality.  Needs g++; skips with a reason without it."""
import ctypes

import numpy as np
import pytest
import torch

from damar_tpu_torch.ops import wave_wide
from damar_tpu_torch.ops.words import gather_packed, pack_bases
from damar_tpu_torch.utils.sim import wide_trace_batch
from test_torch_cuda import _dp_inputs
from test_torch_wave_bp_host import HOST_PRELUDE, build_host

torch.set_num_threads(2)
T = torch.as_tensor

SHIM = HOST_PRELUDE + r"""
#include "dp_rows.cu"

extern "C" int host_char_at(const uint32_t* w, int n, int p) {
  CharStream c;
  c.start(w, n, p, false);
  return static_cast<int>(c.next16() & 3u);
}

extern "C" int host_segment_rows(int abp, int done, int alim, int TS) {
  return segment_rows(abp, done, alim, TS);
}

extern "C" int host_end_column(int blim, int va, int boff) {
  return end_column(blim, va, boff);
}

extern "C" void host_wide_trace(
    const uint32_t* aw, int na, const uint32_t* bw, int nb,
    const int32_t* ast, const int32_t* bst, const int32_t* abp,
    const int32_t* bbp, const int32_t* alim, const int32_t* blim, int S,
    int TS, int max_segs, int2* trace, int32_t* nseg, int32_t* dsum) {
  const WideParams P{aw, bw, na, nb, TS, max_segs};
  for (int s = 0; s < S; ++s)
    wide_trace_extent(HostGroup{}, P, abp[s], ast[s] + abp[s],
                      bst[s] + bbp[s], alim[s], blim[s],
                      trace + static_cast<size_t>(s) * max_segs, nseg[s],
                      dsum[s]);
}

extern "C" void host_dp_rows(
    const int32_t* D_in, const int32_t* a, int Ra, const int32_t* b, int Wb,
    const int32_t* vbb, const int32_t* pb, const int32_t* blim,
    const int32_t* rows, const int32_t* act, const int32_t* cont,
    const int32_t* bs, const int32_t* bva, const int32_t* bvb,
    const int32_t* bd, int32_t* D_out, int32_t* act_out, int32_t* bs_out,
    int32_t* bva_out, int32_t* bvb_out, int32_t* bd_out, int32_t* drift_out,
    int S, int R, int dc, int xd, int track, int recenter) {
  const RowsParams P{Ra, Wb, R, dc, xd};
  const RowsIO io{D_in, a, b, vbb, pb, blim, rows, act, cont, bs, bva, bvb,
                  bd, D_out, act_out, bs_out, bva_out, bvb_out, bd_out,
                  drift_out};
  const HostGroup x{};
  for (int s = 0; s < S; ++s) {
    if (track && recenter) dp_rows_band<true, true>(x, P, io, s);
    else if (track) dp_rows_band<true, false>(x, P, io, s);
    else if (recenter) dp_rows_band<false, true>(x, P, io, s);
    else dp_rows_band<false, false>(x, P, io, s);
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build_host(tmp_path_factory, "dp_rows_host", SHIM)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _i32(*xs):
    return [np.ascontiguousarray(x, dtype=np.int32) for x in xs]


def test_char_read_follows_clip_rule(host):
    """The char at every pool position, before, inside and past the pool:
    (words[clip(p >> 4, 0, n-1)] >> 2*(p & 15)) & 3, as the window gather
    reads it."""
    rng = np.random.default_rng(5)
    n = 37
    words = rng.integers(-2**31, 2**31, n).astype(np.int32)
    ps = np.arange(-70, 16 * n + 70)
    want = (words.view(np.uint32)[np.clip(ps >> 4, 0, n - 1)].astype(np.int64)
            >> (2 * (ps & 15))) & 3
    got = np.array([host.host_char_at(_ptr(words), n, int(p)) for p in ps])
    np.testing.assert_array_equal(got, want)
    gathered = gather_packed(T(words), T(ps), torch.zeros(len(ps)), 1,
                             False)[:, 0]
    np.testing.assert_array_equal(gathered.numpy(), want)


def test_segment_rows_and_end_column(host):
    """Segment length to the next absolute tspace boundary (floored for
    negative starts) and the last segment's end column (clipped max then
    min), against the plain algebra."""
    rng = np.random.default_rng(6)
    for _ in range(2000):
        abp, done = (int(v) for v in rng.integers(-300, 5000, 2))
        alim = done + int(rng.integers(1, 400))
        ts = int(rng.choice([100, 126, 250]))
        a = abp + done
        want = min((a // ts + 1) * ts - a, alim - done)
        assert host.host_segment_rows(abp, done, alim, ts) == want
        blim, va, boff = (int(v) for v in rng.integers(-400, 400, 3))
        want = min(max(blim - va + 64 - boff, 0), 127)
        assert host.host_end_column(blim, va, boff) == want


def host_wide_trace(lib, A, B, ast, bst, abp, bbp, alim, blim, tspace,
                    max_segs):
    S = len(abp)
    trace = np.zeros((S, max_segs, 2), np.int32)
    nseg, dsum = np.zeros(S, np.int32), np.zeros(S, np.int32)
    aw, bw = _i32(pack_bases(T(A)).numpy(), pack_bases(T(B)).numpy())
    ins = _i32(ast, bst, abp, bbp, alim, blim)
    lib.host_wide_trace(_ptr(aw), ctypes.c_int(len(aw)), _ptr(bw),
                        ctypes.c_int(len(bw)), *map(_ptr, ins),
                        *map(ctypes.c_int, (S, tspace, max_segs)),
                        _ptr(trace), _ptr(nseg), _ptr(dsum))
    return trace, nseg, dsum


@pytest.mark.parametrize("tspace,max_segs,S", [(100, 64, 40), (126, 48, 33),
                                              (100, 6, 24), (126, 32, 40),
                                              (250, 24, 1)])
def test_wide_trace_extent_matches_plain(host, tspace, max_segs, S):
    """Every extent kind of wide_trace_batch (off-word starts, windows
    past both pool edges, drifting commits, the d >= INF_I branch,
    alim = 0); max_segs 6 overflows its last slot."""
    batch = wide_trace_batch(np.random.default_rng(tspace + S), S)
    A, B, *vecs = batch
    want = wave_wide.trace_wave_plain(pack_bases(T(A)), pack_bases(T(B)),
                                      *map(T, vecs), tspace, max_segs)
    got = host_wide_trace(host, A, B, *vecs, tspace, max_segs)
    for n, x, y in zip(("trace", "nseg", "dsum"), got, want):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=n)
    alim, blim = vecs[4], vecs[5]
    if S >= 24:
        assert (want[1].numpy()[alim == 0] == 0).all() and (alim == 0).any()
        assert (want[0][..., 0].numpy()
                == (alim + blim)[:, None]).any(), "no d >= INF_I commit"
    if max_segs == 6:
        assert int((want[1] > max_segs).sum()) > S // 4


@pytest.mark.parametrize("track,recenter", [(False, False), (True, True),
                                            (True, False), (False, True)])
def test_dp_rows_band_matches_plain(host, track, recenter):
    """The chunk-form band in all four modes, values above INF_I in D."""
    args, cont = _dp_inputs(8, 300, 100, track)
    kw = dict(R=100, W=128, diff_cost=5, xdrop=60, track_best=track,
              recenter=recenter)
    want = wave_wide.dp_rows_plain(*args, cont=cont, **kw)
    ins = _i32(*(x.numpy() for x in args), cont.numpy())
    D, a, b, vbb, pb, blim, rows, act, bs, bva, bvb, bd, cn = ins
    S = D.shape[0]
    outs = [np.zeros_like(D), np.zeros(S, np.int32),
            *[np.zeros_like(bs) for _ in range(4)], np.zeros(S, np.int32)]
    host.host_dp_rows(_ptr(D), _ptr(a), ctypes.c_int(a.shape[1]), _ptr(b),
                      ctypes.c_int(b.shape[1]),
                      *map(_ptr, (vbb, pb, blim, rows, act, cn, bs, bva, bvb,
                                  bd)),
                      *map(_ptr, outs),
                      *map(ctypes.c_int, (S, 100, 5, 60, int(track),
                                          int(recenter))))
    names = "D act bs bva bvb bd drift".split()
    for n, x, y in zip(names, outs, want):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=n)
