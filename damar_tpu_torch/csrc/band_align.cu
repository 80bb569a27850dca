// Banded edit alignment with traceback (K4), for the H100 (sm_90a).
//
// band_align_kernel aligns a ragged batch of (template a, cover b) pairs:
// the pile aligner of the consensus and polish phase.  It is the port's
// counterpart of damar_tpu's host C band_align and band_align_batch
// (damar_tpu/native/damar_native.c:218, :322), which the reference's
// consensus (damar_tpu/pipeline/consensus.py:153-180) calls; it is not a
// TPU kernel.  Its outputs equal the C's for both modes: the ops of each
// pair's path (0 = match/sub, 1 = del, 2 = ins) in forward order, their
// count, and jstart, the first cover column of the path.
//
// The DP, as the C evaluates it: band frame width = 2*band+1, off =
// floor((n-m)/2), j(i,k) = i + k - band + off; cells with j outside [0, n]
// hold BA_INF; row 0 holds 0 (semiglobal) or j; a cell of row i is
//   min(BA_INF, D[i-1][k] + sub (j >= 1), D[i-1][k+1] + 1, D[i][k-1] + 1)
// with the left term only for j >= 1.  Every finite value is at most m+n,
// so BA_INF + 1 never wins a min and the C's "< BA_INF" guards change
// nothing.  The left (insertion) chain is a prefix minimum:
//   D[i][k] = min(BA_INF, k + cummin_{k' <= k}(best[k'] - k')),
// with cells outside [0, n] entering as BA_INF.
//
// Design: one warp per pair; the row's cells lie in C contiguous cells a
// lane (C = 8, 16 or 48 by the launch's largest band), in registers.  The
// up term of a lane's last cell is one __shfl_down_sync, the prefix minimum
// a sequential scan over the lane's cells, a 5-step __shfl_up_sync scan of
// the lane totals and a combine.  Each cell writes one flag byte into a
// scratch buffer of (m+1) x width bytes a pair: its three traceback tests
// (diag-equal, up-equal, left-equal), each with the C's exact expression.
// The last row gives the start column (semiglobal: the first minimum below
// BA_INF, else column 0; global: the column of j = n).  Lane 0 then walks
// the flags back in the C's order of preference (diag, up, left, the
// semiglobal stop at i == 0, the band-edge fallback) and writes the ops
// backwards from the end of the pair's region of m+n bytes, so they land in
// forward order.  A walk that would leave the band (possible only in
// global mode) marks the pair with length -1; the wrapper raises.
//
// What bounds it: (m+1) x width cells a pair of int32 work (~30 ops a
// cell: the char, three candidates, the scan, the three flag tests and
// the flag byte) at the card's issue rate; the flag bytes it writes,
// (m+1) x width a pair, take a third of that time at 3.35 TB/s.  In
// practice a launch takes its widest pair's serial row chain (every pair
// of a launch runs at the cells a lane of the launch's largest band) and
// then that pair's walk, one chain of dependent loads (m+n steps): a
// polish window whose first covers carry bands of ~700 takes ~2 ms
// (PERF.md).
//
// The per-pair function (align_pair) takes a lane-exchange policy:
// WarpGroup on the card (one lane per thread, shuffles), HostGroup on the
// host (the 32 lanes in lockstep over arrays), so it compiles as host C++
// (tests/test_torch_band_align_host.py) with the CUDA-only parts under
// __CUDACC__.
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int BA_INF = 0x3FFFFFFF;
constexpr int BIG = 0x7FFFFFFF;
constexpr int LANES = 32;
constexpr int THREADS = 128;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

struct AlignIO {
  const uint8_t* a;        // templates, concatenated
  const int64_t* a_off;    // [P + 1]
  const uint8_t* b;        // covers, concatenated
  const int64_t* b_off;    // [P + 1]
  const int32_t* band;     // [P]
  uint8_t* flags;          // scratch: (m+1) x width bytes a pair
  const int64_t* f_off;    // [P]
  uint8_t* ops;            // m+n bytes a pair, ending at o_end[p]
  const int64_t* o_end;    // [P]
  int32_t* len;            // [P]: ops of the path, -1 out of band
  int32_t* jstart;         // [P]
  int semiglobal;
};

#ifdef __CUDACC__
struct WarpGroup {
  static constexpr int NT = 1;
  static constexpr unsigned mask = 0xFFFFFFFFu;
  int g;
  __device__ __forceinline__ int lane(int) const { return g; }
  __device__ __forceinline__ bool leader() const { return g == 0; }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  // o = v of lane + 1 (own v for the last lane)
  __device__ __forceinline__ void down1(int (&o)[1], const int (&v)[1]) const {
    o[0] = __shfl_down_sync(mask, v[0], 1);
  }
  // o = v of lane - s (own v for lanes below s)
  __device__ __forceinline__ void up(int (&o)[1], const int (&v)[1],
                                     int s) const {
    o[0] = __shfl_up_sync(mask, v[0], s);
  }
  // (key, index) of the first minimum over the lanes
  __device__ __forceinline__ void argmin_all(int key, int idx, int& k,
                                             int& i) const {
    k = key;
    i = idx;
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) {
      const int k2 = __shfl_xor_sync(mask, k, o);
      const int i2 = __shfl_xor_sync(mask, i, o);
      if (k2 < k || (k2 == k && i2 < i)) {
        k = k2;
        i = i2;
      }
    }
  }
};
#else
struct HostGroup {
  static constexpr int NT = LANES;
  int lane(int q) const { return q; }
  bool leader() const { return true; }
  void sync() const {}
  void down1(int (&o)[LANES], const int (&v)[LANES]) const {
    for (int q = 0; q < LANES; ++q) o[q] = v[q + 1 < LANES ? q + 1 : q];
  }
  void up(int (&o)[LANES], const int (&v)[LANES], int s) const {
    for (int q = 0; q < LANES; ++q) o[q] = v[q >= s ? q - s : q];
  }
};
#endif  // __CUDACC__

// The lanes' keys and indices reduced to the first minimum (the host form
// takes arrays, the card's one value a thread).
#ifndef __CUDACC__
inline void argmin_lanes(const HostGroup&, const int (&key)[LANES],
                         const int (&idx)[LANES], int& k, int& i) {
  k = key[0];
  i = idx[0];
  for (int q = 1; q < LANES; ++q)
    if (key[q] < k || (key[q] == k && idx[q] < i)) {
      k = key[q];
      i = idx[q];
    }
}
#else
__device__ __forceinline__ void argmin_lanes(const WarpGroup& x,
                                             const int (&key)[1],
                                             const int (&idx)[1], int& k,
                                             int& i) {
  x.argmin_all(key[0], idx[0], k, i);
}
#endif

// One pair: the DP rows with their flag bytes, the start column, the walk.
template <int C, class X>
__device__ void align_pair(const X& x, const AlignIO& io, int p) {
  constexpr int NT = X::NT;
  const int64_t a0 = io.a_off[p], b0 = io.b_off[p];
  const int m = static_cast<int>(io.a_off[p + 1] - a0);
  const int n = static_cast<int>(io.b_off[p + 1] - b0);
  const uint8_t* __restrict__ a = io.a + a0;
  const uint8_t* __restrict__ b = io.b + b0;
  const int band = io.band[p];
  const int width = 2 * band + 1;
  const int nm = n - m;
  const int off = nm >= 0 ? nm / 2 : -((-nm + 1) / 2);   // floor division
  const int base = off - band;                           // j(0, 0)
  const bool semi = io.semiglobal != 0;
  uint8_t* __restrict__ fl = io.flags + io.f_off[p];

  int D[NT][C];
  // row 0: 0 (semiglobal) or j inside [0, n], BA_INF outside; its flags
  // hold the left test only
  {
    int last[NT], prevlast[NT];
    for (int q = 0; q < NT; ++q) {
      const int k0 = x.lane(q) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c, j = k + base;
        D[q][c] = (k < width && j >= 0 && j <= n) ? (semi ? 0 : j) : BA_INF;
      }
      last[q] = D[q][C - 1];
    }
    x.up(prevlast, last, 1);
    for (int q = 0; q < NT; ++q) {
      const int k0 = x.lane(q) * C;
      int left = x.lane(q) > 0 ? prevlast[q] : BA_INF;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c, j = k + base;
        if (k < width)
          fl[k] = (j > 0 && k >= 1 && left + 1 == D[q][c]) ? 4 : 0;
        left = D[q][c];
      }
    }
  }
  for (int i = 1; i <= m; ++i) {
    const int ai = a[i - 1];
    int first[NT], nxt[NT], up_last[NT], tot[NT];
    uint64_t subm[NT];                 // bit c: cell c's char mismatches
    int best[NT][C];
    for (int q = 0; q < NT; ++q) first[q] = D[q][0];
    x.down1(nxt, first);
    for (int q = 0; q < NT; ++q) {
      const int k0 = x.lane(q) * C;
      up_last[q] = (x.lane(q) + 1 < LANES && k0 + C < width) ? nxt[q] : BA_INF;
      subm[q] = 0;
      int run = BIG;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c, j = i + k + base;
        const bool valid = k < width && j >= 0 && j <= n;
        const int s = (j >= 1 && j <= n) ? (__ldg(b + j - 1) != ai) : 0;
        const int up = c + 1 < C ? D[q][c + 1] : up_last[q];
        int v = BA_INF;
        if (valid) {
          if (j >= 1) v = imin(v, D[q][c] + s);
          v = imin(v, up + 1);
        }
        subm[q] |= static_cast<uint64_t>(s) << c;
        run = imin(run, valid ? v - k : BIG);
        best[q][c] = run;               // in-lane inclusive prefix minimum
      }
      tot[q] = run;
    }
    // inclusive scan of the lane totals, then each lane's exclusive prefix
    for (int s = 1; s < LANES; s <<= 1) {
      int t[NT];
      x.up(t, tot, s);
      for (int q = 0; q < NT; ++q)
        if (x.lane(q) >= s) tot[q] = imin(tot[q], t[q]);
    }
    int excl[NT], last[NT], prevlast[NT];
    x.up(excl, tot, 1);
    for (int q = 0; q < NT; ++q) {
      const int k0 = x.lane(q) * C;
      const int e = x.lane(q) > 0 ? excl[q] : BIG;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c, j = i + k + base;
        const bool valid = k < width && j >= 0 && j <= n;
        // a valid cell's own term keeps the minimum finite
        best[q][c] = valid ? imin(BA_INF, k + imin(e, best[q][c])) : BA_INF;
      }
      last[q] = best[q][C - 1];
    }
    x.up(prevlast, last, 1);
    uint8_t* __restrict__ row = fl + static_cast<int64_t>(i) * width;
    for (int q = 0; q < NT; ++q) {
      const int k0 = x.lane(q) * C;
      int left = x.lane(q) > 0 ? prevlast[q] : BA_INF;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c, j = i + k + base;
        const int cur = best[q][c];
        if (k < width) {
          const int s = static_cast<int>((subm[q] >> c) & 1u);
          const int up = c + 1 < C ? D[q][c + 1] : up_last[q];
          const bool dg = j > 0 && j <= n && D[q][c] + s == cur;
          const bool uq = k + 1 < width && up + 1 == cur;
          const bool lf = j > 0 && k >= 1 && left + 1 == cur;
          row[k] = static_cast<uint8_t>(dg | (uq << 1) | (lf << 2));
        }
        left = cur;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) D[q][c] = best[q][c];
    }
  }
  // the start column
  int kstart = 0;
  if (semi) {
    int key[NT], idx[NT];
    for (int q = 0; q < NT; ++q) {
      const int k0 = x.lane(q) * C;
      key[q] = BA_INF;
      idx[q] = 0;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (D[q][c] < key[q]) {   // padding and out-of-[0, n] cells hold
          key[q] = D[q][c];       // BA_INF and never count
          idx[q] = k0 + c;
        }
    }
    int kv, ki;
    argmin_lanes(x, key, idx, kv, ki);
    kstart = kv < BA_INF ? ki : 0;
  } else {
    kstart = n - m + band - off;
  }
  x.sync();   // the warp's flag bytes, before lane 0 reads them
  if (!x.leader()) return;
  uint8_t* __restrict__ out = io.ops + io.o_end[p];
  int i = m, k = kstart, t = 0;
  bool bad = !semi && (k < 0 || k >= width);
  while (!bad && (i > 0 || (!semi && i + k + base > 0))) {
    if (k < 0 || k >= width || t >= m + n) {
      bad = true;
      break;
    }
    const int f = fl[static_cast<int64_t>(i) * width + k];
    int op;
    if (f & 1) {
      op = 0;
      --i;
    } else if (f & 2) {
      op = 1;
      --i;
      ++k;
    } else if (f & 4) {
      op = 2;
      --k;
    } else if (semi && i == 0) {
      break;
    } else if (i > 0) {
      op = 1;
      --i;
    } else {
      op = 2;
      --k;
    }
    out[-1 - t] = static_cast<uint8_t>(op);
    ++t;
  }
  io.len[p] = bad ? -1 : t;
  io.jstart[p] = i + k + base;
}

#ifdef __CUDACC__
template <int C>
__global__ void __launch_bounds__(THREADS) band_align_kernel(AlignIO io,
                                                             int P) {
  const int p = static_cast<int>(blockIdx.x) * (THREADS / LANES) +
                static_cast<int>(threadIdx.x) / LANES;
  if (p >= P) return;   // the whole warp
  align_pair<C>(WarpGroup{static_cast<int>(threadIdx.x) & (LANES - 1)}, io,
                p);
}
#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__
// Cells a lane for a launch whose largest band is max_band (0: too wide).
static int cells_for(int max_band) {
  const int width = 2 * max_band + 1;
  if (width <= 8 * LANES) return 8;
  if (width <= 16 * LANES) return 16;
  if (width <= 48 * LANES) return 48;
  return 0;
}

extern "C" int band_align_launch(
    const void* a, const void* a_off, const void* b, const void* b_off,
    const void* band, int P, int max_band, int semiglobal, void* flags,
    const void* f_off, void* ops, const void* o_end, void* len,
    void* jstart, void* stream) {
  const int C = cells_for(max_band);
  if (C == 0 || max_band < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  const AlignIO io{static_cast<const uint8_t*>(a),
                   static_cast<const int64_t*>(a_off),
                   static_cast<const uint8_t*>(b),
                   static_cast<const int64_t*>(b_off),
                   static_cast<const int32_t*>(band),
                   static_cast<uint8_t*>(flags),
                   static_cast<const int64_t*>(f_off),
                   static_cast<uint8_t*>(ops),
                   static_cast<const int64_t*>(o_end),
                   static_cast<int32_t*>(len),
                   static_cast<int32_t*>(jstart),
                   semiglobal};
  constexpr int per_block = THREADS / LANES;
  const int grid = (P + per_block - 1) / per_block;
  const auto s = static_cast<cudaStream_t>(stream);
  if (C == 8) band_align_kernel<8><<<grid, THREADS, 0, s>>>(io, P);
  else if (C == 16) band_align_kernel<16><<<grid, THREADS, 0, s>>>(io, P);
  else band_align_kernel<48><<<grid, THREADS, 0, s>>>(io, P);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
