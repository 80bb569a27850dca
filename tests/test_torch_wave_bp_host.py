"""K1 and K2's own device code, compiled as host C++, against their plain
torch versions on the CPU.

damar_tpu_torch/csrc/wave_bp.cu keeps everything CUDA-only (kernels,
launches, the work queue) under __CUDACC__; the per-unit functions
extend_unit and trace_extent, with the word streams, plane building and
row loops they call, compile with g++ once the few intrinsics they use
have host definitions (below).  This holds the kernels' arithmetic
(char reads by word across the pool clip, init_planes by bit
compaction, the row-range tests) against the plain versions, which
tests/test_torch_wave_bp.py holds against the Pallas kernels; the card
tests (test_torch_cuda.py) then add the launch machinery.  Tolerance:
exact equality.  Needs g++; skips with a reason without it."""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from damar_tpu_torch.ops import wave_bp
from damar_tpu_torch.ops.words import pack_bases
from damar_tpu_torch.utils.sim import edge_units, unit_batch

torch.set_num_threads(2)
SRC = (Path(__file__).resolve().parent.parent / "damar_tpu_torch" / "csrc"
       / "wave_bp.cu")

# host definitions of the CUDA qualifiers and intrinsics the device code
# uses (shared with tests/test_torch_dp_rows_host.py)
HOST_PRELUDE = r"""
#include <algorithm>
#include <cstdint>
#define __device__
#define __forceinline__ inline
using std::min;
struct int2 { int x, y; };
inline int2 make_int2(int a, int b) { return int2{a, b}; }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo)
                               >> (sh & 31));
}
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
"""

HOST_SHIM = HOST_PRELUDE + r"""
#include "wave_bp.cu"

extern "C" void host_extend(
    const uint32_t* aw, int na, const uint32_t* bw, int nb, const int32_t* ao,
    const int32_t* bo, const int32_t* alim, const int32_t* blim,
    const uint8_t* dirs, int S, int R, int max_rows, int dc, int xd,
    int32_t* bs, int32_t* bva, int32_t* bvb, int32_t* act) {
  ExtParams P{aw, bw, na, nb, R, max_rows, dc, xd};
  for (int s = 0; s < S; ++s) {
    bool a;
    extend_unit(P, ao[s], bo[s], alim[s], blim[s], dirs[s] != 0, bs[s],
                bva[s], bvb[s], a);
    act[s] = a;
  }
}

extern "C" void host_trace(
    const uint32_t* aw, int na, const uint32_t* bw, int nb,
    const int32_t* ast, const int32_t* bst, const int32_t* abp,
    const int32_t* bbp, const int32_t* alim, const int32_t* blim, int S,
    int TS, int max_segs, int2* trace, int32_t* nseg, int32_t* dsum) {
  TraceParams P{aw, bw, na, nb, TS, max_segs};
  for (int s = 0; s < S; ++s)
    trace_extent(P, abp[s], ast[s] + abp[s], bst[s] + bbp[s], alim[s],
                 blim[s], trace + static_cast<size_t>(s) * max_segs, nseg[s],
                 dsum[s]);
}
"""


def build_host(tmp_path_factory, name: str, source: str) -> ctypes.CDLL:
    """Compile `source` (a shim that includes a csrc/ file) with g++ into a
    shared library and load it; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' device code as host "
                    "C++")
    d = tmp_path_factory.mktemp(name)
    (d / "host.cpp").write_text(source)
    lib = d / f"lib{name}.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{SRC.parent}", "-o", str(lib), str(d / "host.cpp")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build_host(tmp_path_factory, "wave_bp_host", HOST_SHIM)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _i32(*xs):
    return [np.ascontiguousarray(x, dtype=np.int32) for x in xs]


def host_extend(lib, aw, bw, ao, bo, alim, blim, rv, R, max_rows):
    S = len(ao)
    outs = [np.zeros(S, np.int32) for _ in range(4)]
    aw, bw = _i32(aw.numpy(), bw.numpy())
    ins = _i32(ao, bo, alim, blim)
    dirs = np.ascontiguousarray(rv, dtype=np.uint8)
    lib.host_extend(_ptr(aw), ctypes.c_int(len(aw)), _ptr(bw),
                    ctypes.c_int(len(bw)), *map(_ptr, ins), _ptr(dirs),
                    *map(ctypes.c_int, (S, R, max_rows, 5, 60)),
                    *map(_ptr, outs))
    return outs


def host_trace(lib, aw, bw, ast, bst, abp, bbp, alim, blim, tspace,
               max_segs):
    S = len(abp)
    trace = np.zeros((S, max_segs, 2), np.int32)
    nseg, dsum = np.zeros(S, np.int32), np.zeros(S, np.int32)
    aw, bw = _i32(aw.numpy(), bw.numpy())
    ins = _i32(ast, bst, abp, bbp, alim, blim)
    lib.host_trace(_ptr(aw), ctypes.c_int(len(aw)), _ptr(bw),
                   ctypes.c_int(len(bw)), *map(_ptr, ins),
                   *map(ctypes.c_int, (S, tspace, max_segs)), _ptr(trace),
                   _ptr(nseg), _ptr(dsum))
    return trace, nseg, dsum


def _eq(got, want):
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy())


def _check_extend(lib, batch, R=128, max_rows=65536):
    A, B, ao, bo, alim, blim, rv = batch
    T = torch.as_tensor
    aw, bw = pack_bases(T(A)), pack_bases(T(B))
    want = wave_bp.extend_bp_plain(aw, bw, T(ao), T(bo), T(alim), T(blim),
                                   T(rv), R, max_rows, 5, 60)
    _eq(host_extend(lib, aw, bw, ao, bo, alim, blim, rv, R, max_rows), want)


@pytest.mark.parametrize("max_rows", [65536, 128])
def test_extend_unit_matches_plain(host, max_rows):
    _check_extend(host, unit_batch(np.random.default_rng(max_rows), 300),
                  max_rows=max_rows)


@pytest.mark.parametrize("S", [1, 33])
def test_extend_unit_mixed_lengths(host, S):
    """Units of 1 to ~12,000 rows (many chunks, recenters, x-drops)."""
    _check_extend(host, unit_batch(np.random.default_rng(S), S, min_len=1,
                                   max_len=12_000))


@pytest.mark.parametrize("R", [128, 64, 16])
def test_extend_unit_windows_past_pool_edges(host, R):
    """Forward and reverse word streams that start and run past both ends
    of the pool, at several chunk heights."""
    _check_extend(host, edge_units(np.random.default_rng(R), 40), R=R)


@pytest.mark.parametrize("tspace,max_segs,S", [(100, 32, 200),
                                               (126, 24, 33),
                                               (250, 12, 1),
                                               (100, 6, 150)])
def test_trace_extent_matches_plain(host, tspace, max_segs, S):
    """Starts split off word boundaries into start + offset; the last
    case stops most extents at max_segs."""
    rng = np.random.default_rng(tspace + S)
    A, B, ao, bo, alim, blim, _ = unit_batch(rng, S, max_len=6000)
    alim = np.minimum(alim, len(A) - ao).astype(np.int32)
    blim = np.minimum(blim, len(B) - bo).astype(np.int32)
    abp = np.minimum(rng.integers(1, 90, S), ao).astype(np.int32)
    bbp = np.minimum(rng.integers(1, 90, S), bo).astype(np.int32)
    T = torch.as_tensor
    aw, bw = pack_bases(T(A)), pack_bases(T(B))
    args = (ao - abp, bo - bbp, abp, bbp, alim, blim)
    want = wave_bp.trace_bp_plain(aw, bw, *map(T, args), tspace, max_segs)
    _eq(host_trace(host, aw, bw, *args, tspace, max_segs), want)
    if max_segs == 6:
        assert int((want[1] == max_segs).sum()) > S // 2
