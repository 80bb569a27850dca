// Wide banded edit DP (K3), W = 128 diagonals per band, for the H100
// (sm_90a).  Two kernels share one DP row:
//
//  wide_trace_kernel  the whole wide-band trace pass: every tspace
//     segment of every extent, with the per-segment commit, in one
//     launch.  Replaces _dp_rows_kernel (damar_tpu/ops/wave_pallas.py:43)
//     as trace_wave_pl (:411) drives it, one launch per segment step.
//  dp_rows_kernel     R rows of a batch of bands, both template modes of
//     _dp_rows_kernel (trace; track_best + recenter for the wide
//     extension), the chunk form that wrapper keeps.
// Both are bit-identical to the plain torch versions in
// damar_tpu_torch/ops/wave_wide.py and to the Pallas kernel.
//
// Design: one warp holds one band, LPT = 4 lanes a thread in registers.
// A row is
//   u_j = min(D_j + sub_j, D_{j+1} + 1) - j,  D_j = min(INF_I, u_0..u_j) + j
// (lanes outside [0, blim] get INF_I), kept as D'_j = D_j - j so the
// lane offsets cancel: u_j = min(D'_j + sub_j, D'_{j+1} + 2).  D'_{j+1}
// of a thread's last lane is one __shfl_down_sync; the prefix-min is a
// sequential scan over the thread's lanes, a 5-step __shfl_up_sync
// min-scan of the thread totals and a combine: no shared memory and no
// barrier in the row.  The closed form min(INF_I, cummin(u)) equals the
// reference's 7-step scan with its INF fill lane for lane, values above
// INF_I included (lane 127's clip is a no-op: u_127 < INF_I always).
//
// wide_trace_kernel reads its chars by word (CharStream, common.cuh):
// every thread streams the A chars of the segment and the B chars from
// its own first lane on, one load per 16 rows each, so a row takes its
// chars with constant shifts.  Streams restart at each segment; the clip
// rule holds char for char.  At a segment end the warp finds the first
// minimum column by a shuffle reduction, commits (diffs, bspan) with one
// 8-byte store and resets the band.  The grid is persistent (occupancy
// sized); each warp takes the next extent from a device counter, in
// the order the driver lays them out (longest first).
//
// What bounds it: the work is 128 x sum(alim) lane-rows of int32 ops
// (chip_smoke.py counts ops per lane-row from the built code), but a
// band's rows are a serial chain of 7 shuffles and the integer ops
// between them (chip_smoke.py's "longest alone" times it), so a launch
// takes at least its longest extent's rows x that latency, and the
// driver's bucket launches, which run one after another, the sum of
// theirs.  Bytes are no bound.  Four lanes a thread beat eight (two
// bands a warp) on the H100, 1.17x (PERF.md), and taking the right
// neighbour's shuffle off the chain (it can be issued before the scan for
// the next row) cost more instructions a row than the shuffle it saved.
//
// The per-band functions (band_row, wide_trace_extent, dp_rows_band)
// take a lane-exchange policy: WarpGroup on the card (NT = 1 thread per
// context, shuffles), HostGroup on the host (a warp's 32 threads in
// lockstep over arrays), so they compile as host C++ with the CUDA-only
// parts under __CUDACC__ (tests/test_torch_dp_rows_host.py).
#include "common.cuh"

namespace {

constexpr int W = 128;
constexpr int CTR = W / 2;
constexpr int THREADS = 128;
constexpr int LPT = 4;        // band lanes a thread holds
constexpr int G = W / LPT;    // threads a band: one warp
static_assert(G == WARP, "one warp holds one band");

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// First minimum of (key, index) pairs: ties go to the lower index.
__device__ __forceinline__ void first_min(int& k, int& i, int k2, int i2) {
  if (k2 < k || (k2 == k && i2 < i)) {
    k = k2;
    i = i2;
  }
}

#ifdef __CUDACC__
// The warp of a band, this thread its lane g.
struct WarpGroup {
  static constexpr int NT = 1;
  static constexpr unsigned mask = 0xFFFFFFFFu;
  int g;
  __device__ __forceinline__ int lane(int) const { return g; }
  __device__ __forceinline__ bool leader() const { return g == 0; }
  // o = v of thread g + 1 (its own v for the last thread)
  __device__ __forceinline__ void down1(int (&o)[1],
                                        const int (&v)[1]) const {
    o[0] = __shfl_down_sync(mask, v[0], 1, G);
  }
  // o = v of thread g - s (its own v for g < s)
  __device__ __forceinline__ void up(int (&o)[1], const int (&v)[1],
                                     int s) const {
    o[0] = __shfl_up_sync(mask, v[0], s, G);
  }
  // o = v of thread src
  __device__ __forceinline__ void from(int (&o)[1], const int (&v)[1],
                                       const int (&src)[1]) const {
    o[0] = __shfl_sync(mask, v[0], src[0], G);
  }
  __device__ __forceinline__ int max_all(const int (&v)[1]) const {
    int m = v[0];
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      m = imax(m, __shfl_xor_sync(mask, m, o, G));
    return m;
  }
  __device__ __forceinline__ void argmin_all(const int (&key)[1],
                                             const int (&idx)[1], int& k,
                                             int& i) const {
    k = key[0];
    i = idx[0];
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      first_min(k, i, __shfl_xor_sync(mask, k, o, G),
                __shfl_xor_sync(mask, i, o, G));
  }
};
#else
// All G threads of a warp, run in lockstep over arrays (host C++).
struct HostGroup {
  static constexpr int NT = G;
  int lane(int q) const { return q; }
  bool leader() const { return true; }
  void down1(int (&o)[G], const int (&v)[G]) const {
    for (int q = 0; q < G; ++q) o[q] = v[q + 1 < G ? q + 1 : q];
  }
  void up(int (&o)[G], const int (&v)[G], int s) const {
    for (int q = 0; q < G; ++q) o[q] = v[q >= s ? q - s : q];
  }
  void from(int (&o)[G], const int (&v)[G], const int (&src)[G]) const {
    for (int q = 0; q < G; ++q) o[q] = v[src[q]];
  }
  int max_all(const int (&v)[G]) const {
    int m = v[0];
    for (int q = 1; q < G; ++q) m = imax(m, v[q]);
    return m;
  }
  void argmin_all(const int (&key)[G], const int (&idx)[G], int& k,
                  int& i) const {
    k = key[0];
    i = idx[0];
    for (int q = 1; q < G; ++q) first_min(k, i, key[q], idx[q]);
  }
};
#endif  // __CUDACC__

// One DP row of a band (the row algebra of _dp_rows_kernel): D' = D - lane
// in and out; sub in {0, 1, INF_I}; valid: the lane's v_b in [0, blim].
template <class X>
__device__ __forceinline__ void band_row(const X& x, int (&Dp)[X::NT][LPT],
                                         const int (&sub)[X::NT][LPT],
                                         const bool (&valid)[X::NT][LPT]) {
  constexpr int NT = X::NT;
  int first[NT], right[NT], incl[NT], t[NT], E[NT];
  int p[NT][LPT];
#pragma unroll
  for (int q = 0; q < NT; ++q) first[q] = Dp[q][0];
  x.down1(right, first);
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    // D'_128 = INF_I - 128, so lane 127 sees D_128 + 1 - 127 = INF_I - 126
    if (x.lane(q) == G - 1) right[q] = INF_I - W;
    int m = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int r = k + 1 < LPT ? Dp[q][k + 1] : right[q];
      const int u = imin(Dp[q][k] + sub[q][k], r + 2);
      m = k ? imin(m, u) : u;
      p[q][k] = m;
    }
    incl[q] = imin(m, INF_I);
  }
#pragma unroll
  for (int s = 1; s < G; s <<= 1) {
    x.up(t, incl, s);
#pragma unroll
    for (int q = 0; q < NT; ++q) incl[q] = imin(incl[q], t[q]);
  }
  x.up(E, incl, 1);
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int g = x.lane(q);
    const int e = g == 0 ? INF_I : E[q];
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      Dp[q][k] = valid[q][k] ? imin(e, p[q][k]) : INF_I - (LPT * g + k);
  }
}

// The band after a reset: D_j = j - CTR for j >= CTR, else INF_I.
template <class X>
__device__ __forceinline__ void band_reset(const X& x,
                                           int (&Dp)[X::NT][LPT]) {
#pragma unroll
  for (int q = 0; q < X::NT; ++q)
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = LPT * x.lane(q) + k;
      Dp[q][k] = j >= CTR ? -CTR : INF_I - j;
    }
}

// D_j of column j (uniform across the group) to every thread.
template <class X>
__device__ __forceinline__ int band_at(const X& x,
                                       const int (&Dp)[X::NT][LPT], int j) {
  constexpr int NT = X::NT;
  int v[NT], src[NT], o[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    v[q] = Dp[q][0];
#pragma unroll
    for (int k = 1; k < LPT; ++k)
      if ((j & (LPT - 1)) == k) v[q] = Dp[q][k];
    src[q] = j / LPT;
  }
  x.from(o, v, src);
  return o[0] + j;
}

// ---------------------------------------------------------------------------
// wide_trace_kernel's per-extent parts

struct WideParams {
  const uint32_t* aw;
  const uint32_t* bw;
  int na, nb, TS, max_segs;
};

// Rows of the segment that starts at row `done`: to the next absolute
// tspace boundary of the A read, or to the extent's end.
__device__ __forceinline__ int segment_rows(int abp, int done, int alim,
                                            int TS) {
  const int a = abp + done;
  const int nxt = (floordiv(a, TS) + 1) * TS - a;
  return nxt < alim - done ? nxt : alim - done;
}

// The committed column of the extent's last segment: its known end.
__device__ __forceinline__ int end_column(int blim, int va, int boff) {
  return clampi(blim - va + CTR - boff, 0, W - 1);
}

// 16 rows (with GUARD, the first n) of a segment.  ga: the rows' A chars;
// gb0 | gb1: each thread's B chars from its first lane at row r0 on; vt:
// v_b of each thread's first lane at row r0; lanes with 0 <= v_b <= blim
// are valid (bl1 = max(blim + 1, 0)), with 1 <= v_b <= blim take a diagonal
// (bl0 = max(blim, 0)).
template <bool GUARD, class X>
__device__ __forceinline__ void wide_rows16(
    const X& x, int (&Dp)[X::NT][LPT], uint32_t ga,
    const uint32_t (&gb0)[X::NT], const uint32_t (&gb1)[X::NT],
    const int (&vt)[X::NT], uint32_t bl1, uint32_t bl0, int n) {
  constexpr int NT = X::NT;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (!GUARD || i < n) {
      const uint32_t xr = ((ga >> (2 * i)) & 3u) * 0x5555u;
      int sub[NT][LPT];
      bool valid[NT][LPT];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const uint32_t c = __funnelshift_r(gb0[q], gb1[q], 2 * i) ^ xr;
        const uint32_t ne = (c | (c >> 1)) & 0x5555u;  // bit 2k: lane k
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const int vb = vt[q] + i + k;
          valid[q][k] = static_cast<uint32_t>(vb) < bl1;
          sub[q][k] = static_cast<uint32_t>(vb - 1) < bl0
                          ? static_cast<int>((ne >> (2 * k)) & 1u)
                          : INF_I;
        }
      }
      band_row(x, Dp, sub, valid);
    }
  }
}

// The wide trace of one extent (trace_wave_pl on one seed): tspace
// segments to alim, each committed at its first minimum column (the end
// column for the last) into out[min(k, max_segs - 1)].
template <class X>
__device__ void wide_trace_extent(const X& x, const WideParams& P, int abp,
                                  int ao, int bo, int alim, int blim,
                                  int2* __restrict__ out, int32_t& nseg_o,
                                  int32_t& dsum_o) {
  constexpr int NT = X::NT;
  const uint32_t bl1 = static_cast<uint32_t>(imax(blim + 1, 0));
  const uint32_t bl0 = static_cast<uint32_t>(imax(blim, 0));
  int Dp[NT][LPT];
  band_reset(x, Dp);
  int done = 0, boff = 0, nseg = 0, prev_vb = 0, dsum = 0;
  while (done < alim) {
    const int seg_rows = segment_rows(abp, done, alim, P.TS);
    const int vbb = done + 1 - CTR + boff;  // v_b of lane 0 at row 0
    CharStream A;
    A.start(P.aw, P.na, ao + done, false);
    CharStream B[NT];
    uint32_t gb0[NT], gb1[NT];
    int vt[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int j0 = LPT * x.lane(q);
      B[q].start(P.bw, P.nb, bo + vbb - 1 + j0, false);
      gb0[q] = B[q].next16();
      vt[q] = vbb + j0;
    }
    int r0 = 0;
    for (; r0 + 16 <= seg_rows; r0 += 16) {
      const uint32_t ga = A.next16();
#pragma unroll
      for (int q = 0; q < NT; ++q) gb1[q] = B[q].next16();
      wide_rows16<false>(x, Dp, ga, gb0, gb1, vt, bl1, bl0, 16);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        gb0[q] = gb1[q];
        vt[q] += 16;
      }
    }
    if (r0 < seg_rows) {
      const uint32_t ga = A.next16();
#pragma unroll
      for (int q = 0; q < NT; ++q) gb1[q] = B[q].next16();
      wide_rows16<true>(x, Dp, ga, gb0, gb1, vt, bl1, bl0, seg_rows - r0);
    }
    // commit: the first minimum over the valid columns, or the end
    const int va = done + seg_rows;
    const int vfin = va - CTR + boff;  // v_b of lane 0 at the last row
    int key[NT], idx[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      key[q] = 0x7FFFFFFF;
      idx[q] = W;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = LPT * x.lane(q) + k;
        const int Dm = static_cast<uint32_t>(vfin + j) < bl1 ? Dp[q][k] + j
                                                             : INF_I;
        if (Dm < key[q]) {
          key[q] = Dm;
          idx[q] = j;
        }
      }
    }
    int dmin, jmin;
    x.argmin_all(key, idx, dmin, jmin);
    const int j_com = va == alim ? end_column(blim, va, boff) : jmin;
    int d_com = band_at(x, Dp, j_com);
    if (d_com >= INF_I) d_com = alim + blim;
    const int vb_com = vfin + j_com;
    if (x.leader())
      out[nseg < P.max_segs - 1 ? nseg : P.max_segs - 1] =
          make_int2(d_com, vb_com - prev_vb);
    band_reset(x, Dp);
    boff += j_com - CTR;
    done = va;
    nseg += 1;
    prev_vb = vb_com;
    dsum += d_com;
  }
  nseg_o = nseg;
  dsum_o = dsum;
}

// ---------------------------------------------------------------------------
// dp_rows_kernel's per-band part

struct RowsParams {
  int Ra, Wb, R, diff_cost, xdrop;
};

struct RowsIO {
  const int32_t *D_in, *a_chars, *b_tile, *vbb, *pb, *blim, *rows, *act,
      *cont, *bs_in, *bva_in, *bvb_in, *bd_in;
  int32_t *D_out, *act_out, *bs_out, *bva_out, *bvb_out, *bd_out,
      *drift_out;
};

// R rows of band s (dp_rows on one seed); TRACK keeps per-lane best
// trackers and applies the chunk x-drop, RECENTER shifts the band onto
// its first minimum column for continuing seeds.
template <bool TRACK, bool RECENTER, class X>
__device__ void dp_rows_band(const X& x, const RowsParams& P,
                             const RowsIO& io, int s) {
  constexpr int NT = X::NT;
  constexpr int TL = TRACK ? LPT : 1;
  const size_t row0 = static_cast<size_t>(s) * W;
  const int32_t* a = io.a_chars + static_cast<size_t>(s) * P.Ra;
  const int32_t* b = io.b_tile + static_cast<size_t>(s) * P.Wb;
  const int vbb = io.vbb[s], pb = io.pb[s], blim = io.blim[s];
  const int rows = io.rows[s];
  const bool act_in = io.act[s] != 0;
  int Dp[NT][LPT];
  int bs[NT][TL], bva[NT][TL], bvb[NT][TL], bd[NT][TL];
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = LPT * x.lane(q) + k;
      Dp[q][k] = io.D_in[row0 + j] - j;
      if (TRACK) {
        bs[q][k % TL] = io.bs_in[row0 + j];
        bva[q][k % TL] = io.bva_in[row0 + j];
        bvb[q][k % TL] = io.bvb_in[row0 + j];
        bd[q][k % TL] = io.bd_in[row0 + j];
      }
    }
  const int nrows = act_in ? imin(rows, P.R) : 0;
  for (int r = 0; r < nrows; ++r) {
    const int xa = a[r];
    int sub[NT][LPT];
    bool valid[NT][LPT];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = LPT * x.lane(q) + k;
        const int v_b = vbb + r + j;
        valid[q][k] = v_b >= 0 && v_b <= blim;
        sub[q][k] = valid[q][k] && v_b >= 1 ? (b[r + j] == xa ? 0 : 1)
                                            : INF_I;
      }
    band_row(x, Dp, sub, valid);
    if (TRACK) {
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const int j = LPT * x.lane(q) + k;
          const int D = Dp[q][k] + j, v_b = vbb + r + j;
          const int score = valid[q][k] && D < INF_I
                                ? (pb + r) + v_b - P.diff_cost * D
                                : -INF_I;
          if (score > bs[q][k % TL]) {
            bs[q][k % TL] = score;
            bva[q][k % TL] = pb + r;
            bvb[q][k % TL] = v_b;
            bd[q][k % TL] = D;
          }
        }
    }
  }
  bool act = act_in;
  if (TRACK) {
    // x-drop at chunk granularity: final-row best vs all-time best
    int sf[NT], bm[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      sf[q] = bm[q] = -0x7FFFFFFF;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = LPT * x.lane(q) + k;
        const int D = Dp[q][k] + j, v_b = vbb + (rows - 1) + j;
        const bool ok = v_b >= 0 && v_b <= blim && D < INF_I;
        sf[q] = imax(sf[q], ok ? (pb + rows - 1) + v_b - P.diff_cost * D
                               : -INF_I);
        bm[q] = imax(bm[q], bs[q][k % TL]);
      }
    }
    const int smax = x.max_all(sf);
    act = act && smax >= x.max_all(bm) - P.xdrop;
  }
  int drift = 0;
  if (RECENTER) {
    // the first minimum column over all lanes
    int key[NT], idx[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      key[q] = 0x7FFFFFFF;
      idx[q] = W;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = LPT * x.lane(q) + k;
        if (Dp[q][k] + j < key[q]) {
          key[q] = Dp[q][k] + j;
          idx[q] = j;
        }
      }
    }
    int m, jmin;
    x.argmin_all(key, idx, m, jmin);
    const bool go = act && io.cont[s] != 0 && m < INF_I;
    drift = go ? jmin - CTR : 0;
    // lane j takes D of lane j + drift (INF_I past the band)
    int Dn[NT][LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int e = (k + drift) & (LPT - 1);  // its source's slot
      const int dt = floordiv(k + drift, LPT);  // its source's offset
      int v[NT], src[NT], o[NT];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        v[q] = Dp[q][0] + LPT * x.lane(q);
#pragma unroll
        for (int kk = 1; kk < LPT; ++kk)
          if (e == kk) v[q] = Dp[q][kk] + LPT * x.lane(q) + kk;
        src[q] = clampi(x.lane(q) + dt, 0, G - 1);
      }
      x.from(o, v, src);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int sj = LPT * x.lane(q) + k + drift;
        Dn[q][k] = sj >= 0 && sj < W ? o[q] : INF_I;
      }
    }
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int k = 0; k < LPT; ++k)
        Dp[q][k] = Dn[q][k] - (LPT * x.lane(q) + k);
  }
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = LPT * x.lane(q) + k;
      io.D_out[row0 + j] = Dp[q][k] + j;
      if (TRACK) {
        io.bs_out[row0 + j] = bs[q][k % TL];
        io.bva_out[row0 + j] = bva[q][k % TL];
        io.bvb_out[row0 + j] = bvb[q][k % TL];
        io.bd_out[row0 + j] = bd[q][k % TL];
      }
    }
  if (x.leader()) {
    if (!TRACK) {  // [S] pass-throughs
      io.bs_out[s] = io.bs_in[s];
      io.bva_out[s] = io.bva_in[s];
      io.bvb_out[s] = io.bvb_in[s];
      io.bd_out[s] = io.bd_in[s];
    }
    io.act_out[s] = act ? 1 : 0;
    io.drift_out[s] = drift;
  }
}

#ifdef __CUDACC__
__device__ __forceinline__ WarpGroup this_warp() {
  return WarpGroup{static_cast<int>(threadIdx.x) & (WARP - 1)};
}

__global__ void __launch_bounds__(THREADS) wide_trace_kernel(
    WideParams P, const int32_t* __restrict__ astart,
    const int32_t* __restrict__ bstart, const int32_t* __restrict__ abpos,
    const int32_t* __restrict__ bbpos, const int32_t* __restrict__ alim_,
    const int32_t* __restrict__ blim_, int S, int* counter,
    int2* __restrict__ trace, int32_t* __restrict__ nseg_o,
    int32_t* __restrict__ dsum_o) {
  const WarpGroup x = this_warp();
  for (;;) {
    int s = 0;
    if (x.leader()) s = atomicAdd(counter, 1);
    s = __shfl_sync(x.mask, s, 0);
    if (s >= S) return;
    const int abp = abpos[s];
    int32_t nseg, dsum;
    wide_trace_extent(x, P, abp, astart[s] + abp, bstart[s] + bbpos[s],
                      alim_[s], blim_[s],
                      trace + static_cast<size_t>(s) * P.max_segs, nseg,
                      dsum);
    if (x.leader()) {
      nseg_o[s] = nseg;
      dsum_o[s] = dsum;
    }
  }
}

template <bool TRACK, bool RECENTER>
__global__ void __launch_bounds__(THREADS) dp_rows_kernel(
    RowsParams P, RowsIO io, int S) {
  const int s = static_cast<int>(blockIdx.x) * (THREADS / G) +
                static_cast<int>(threadIdx.x) / G;
  if (s >= S) return;  // the whole warp
  dp_rows_band<TRACK, RECENTER>(this_warp(), P, io, s);
}
#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__
extern "C" int wide_trace_launch(
    const void* aw, int na, const void* bw, int nb, const void* astart,
    const void* bstart, const void* abpos, const void* bbpos,
    const void* alim, const void* blim, int S, int tspace, int max_segs,
    void* counter, void* trace, void* nseg, void* dsum, void* stream) {
  if (tspace <= 0 || max_segs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    const WideParams P{static_cast<const uint32_t*>(aw),
                       static_cast<const uint32_t*>(bw), na, nb, tspace,
                       max_segs};
    const int need = static_cast<int>(
        (static_cast<int64_t>(S) * G + THREADS - 1) / THREADS);
    const int grid = grid_for<wide_trace_kernel>(THREADS, need);
    wide_trace_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        P, static_cast<const int32_t*>(astart),
        static_cast<const int32_t*>(bstart),
        static_cast<const int32_t*>(abpos), static_cast<const int32_t*>(bbpos),
        static_cast<const int32_t*>(alim), static_cast<const int32_t*>(blim),
        S, static_cast<int*>(counter), static_cast<int2*>(trace),
        static_cast<int32_t*>(nseg), static_cast<int32_t*>(dsum));
  }
  return static_cast<int>(cudaGetLastError());
}
extern "C" int dp_rows_launch(
    const void* D_in, const void* a_chars, int Ra, const void* b_tile,
    int Wb, const void* vbb, const void* pb, const void* blim,
    const void* rows, const void* act, const void* cont, const void* bs,
    const void* bva, const void* bvb, const void* bd, void* D_out,
    void* act_out, void* bs_out, void* bva_out, void* bvb_out,
    void* bd_out, void* drift_out, int S, int R, int width, int diff_cost,
    int xdrop, int track_best, int recenter, void* stream) {
  if (width != W) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const auto in = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto o = [](void* p) { return static_cast<int32_t*>(p); };
  const RowsParams P{Ra, Wb, R, diff_cost, xdrop};
  const RowsIO io{in(D_in), in(a_chars), in(b_tile), in(vbb), in(pb),
                  in(blim), in(rows), in(act), in(cont), in(bs), in(bva),
                  in(bvb), in(bd), o(D_out), o(act_out), o(bs_out),
                  o(bva_out), o(bvb_out), o(bd_out), o(drift_out)};
  auto* k = &dp_rows_kernel<false, false>;
  if (track_best && recenter) k = &dp_rows_kernel<true, true>;
  else if (track_best) k = &dp_rows_kernel<true, false>;
  else if (recenter) k = &dp_rows_kernel<false, true>;
  constexpr int per_block = THREADS / G;
  k<<<(S + per_block - 1) / per_block, THREADS, 0,
      static_cast<cudaStream_t>(stream)>>>(P, io, S);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
