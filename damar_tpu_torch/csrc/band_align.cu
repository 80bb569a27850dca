// Banded edit alignment with traceback (K4), for the H100 (sm_90a).
//
// band_align_kernel aligns a ragged batch of (template a, cover b) pairs:
// the pile aligner of the consensus and polish phase.  It replaces
// damar_tpu's host C band_align and band_align_batch
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
// What bounds it: (m+1) x width cells a pair of int32 work, ~30 operations
// a cell (the char, three candidates, the prefix minimum, the three
// traceback tests and the code; the built row loop has ~51 instructions a
// cell) at the card's 33.5 T int32 ops/s; the codes it writes, a quarter
// byte a cell, at 3.35 TB/s take a small fraction of that.  A launch's
// time is its longest pair's serial row chain plus its walk, so the
// design cuts both:
//
// 1. Each pair at its own width, in one launch.  A thread holds C = 8
//    cells of a row in registers, a warp 256.  The wrapper sorts the pairs
//    into two classes: narrow (width <= 256: bands up to 127) run a warp a
//    pair, up to six pairs in a block of six warps (fewer where the
//    launch has fewer pairs than the card has SMs, so that a window's few
//    pairs each get an SM's schedulers to themselves); wide (width 257 to
//    1,535) run one pair a block on W = ceil(width / 256) <= 6 warps.  So a
//    narrow pair no longer runs at the cells a lane of the widest pair of
//    its launch, and a wide pair's row is W warps' work in parallel, not
//    one warp's serial walk over 48 cells a lane.  Within a warp the
//    insertion chain is a 5-step shuffle scan of the lanes' totals; across
//    warps each warp puts its total, and its first cell's own term, in
//    shared memory (slots by row parity), and one named barrier a row
//    (bar.sync 1, 32 W: the idle warps of a wide block have left) lets
//    every warp take the minimum of the totals before it.  The up term of
//    a warp's last cell (the next warp's first cell of the row before) is
//    computed from the same slots, and so is the left neighbour of a
//    warp's first cell, so one barrier a row is all the exchange needs.
// 2. 2-bit traceback codes instead of a flag byte.  A cell stores the
//    first true test in the C's order: diag (0), up (1), left (2), or 3 for
//    none, which the walk resolves with the C's fallback (the semiglobal
//    stop at i = 0, a deletion for i > 0, else an insertion).  Rows are
//    16-byte aligned (stride = 16 ceil(width / 64) bytes), a thread writing
//    its 8 cells as one 16-bit word.  A wide pair whose (m+1) x stride
//    bytes fit the launch's dynamic shared memory keeps them there (the
//    wrapper sizes it from the call's largest such pair, so a call of only
//    narrow pairs runs with none and keeps many blocks on an SM); every
//    other pair writes them to global scratch, and the walking warp stages
//    the rows ahead of the walker into shared memory (coalesced 16-byte
//    loads, 2 KB a narrow warp, 12 KB a wide block) instead of its lane 0
//    loading byte by byte at L2 latency.
// 3. One sync a call (ops/band_align.py align_pairs): the wrapper plans
//    the launch from the host arrays, sends the inputs up in one copy and
//    takes ops, lengths and jstart back in one.
//
// The last row gives the start column (semiglobal: the first minimum below
// BA_INF, else column 0; global: the column of j = n).  Lane 0 of the first
// warp walks the codes back and writes the ops backwards from the end of
// the pair's region of m+n bytes, so they land in forward order.  A walk
// that would leave the band (possible only in global mode) marks the pair
// with length -1; the wrapper raises.
//
// The per-pair function (align_pair) takes a lane-exchange policy:
// WarpGroup on the card (one lane per thread, shuffles, the named
// barrier), HostGroup on the host (a group's W x 32 threads in lockstep
// over arrays), so it compiles as host C++
// (tests/test_torch_band_align_host.py) with the CUDA-only parts under
// __CUDACC__.
#include <cstdint>
#include <cstring>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int BA_INF = 0x3FFFFFFF;
constexpr int BIG = 0x7FFFFFFF;
constexpr int LANES = 32;
constexpr int C = 8;                       // cells a thread
constexpr int WARP_CELLS = C * LANES;      // cells a warp
constexpr int MAX_WARPS = 6;               // warps a block
constexpr int THREADS = MAX_WARPS * LANES;
constexpr int STAGE_BYTES = 2048;          // a warp's share of the stage

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Warps of a pair's group (1: narrow) and bytes of one row of its codes.
__device__ __forceinline__ int group_warps(int band) {
  return (2 * band + 1 + WARP_CELLS - 1) / WARP_CELLS;
}
__device__ __forceinline__ int code_stride(int band) {
  return 16 * ((2 * band + 1 + 63) / 64);
}

struct AlignIO {
  const uint8_t* a;        // templates, concatenated
  const int64_t* a_off;    // [P + 1]
  const uint8_t* b;        // covers, concatenated
  const int64_t* b_off;    // [P + 1]
  const int32_t* band;     // [P]
  uint8_t* codes;          // global scratch: (m+1) x stride bytes a pair
  const int64_t* c_off;    // [P]: a pair's codes in it, -1 in shared memory
  uint8_t* ops;            // m+n bytes a pair, ending at o_end[p]
  const int64_t* o_end;    // [P]
  int32_t* len;            // [P]: ops of the path, -1 out of band
  int32_t* jstart;         // [P]
  int semiglobal;
};

// The slots of a wide pair's warps in shared memory.
struct Xchg {
  int tot[2][MAX_WARPS];   // each warp's prefix-minimum total, by row parity
  int r0[2][MAX_WARPS];    // each warp's first cell's own term (BIG: none)
  int key[MAX_WARPS];      // each warp's first minimum of the last row
  int idx[MAX_WARPS];
};

#ifdef __CUDACC__
struct WarpGroup {
  static constexpr int NT = 1;
  static constexpr unsigned mask = 0xFFFFFFFFu;
  int l, w, W;             // lane, warp in the group, warps of the group
  __device__ __forceinline__ int count() const { return 1; }
  __device__ __forceinline__ int lane(int) const { return l; }
  __device__ __forceinline__ int warp(int) const { return w; }
  __device__ __forceinline__ bool leader() const { return l == 0; }
  __device__ __forceinline__ void syncwarp() const { __syncwarp(mask); }
  // the group's W warps (named barrier 1; only a wide group calls it)
  __device__ __forceinline__ void bar() const {
    asm volatile("bar.sync 1, %0;" ::"r"(W * LANES) : "memory");
  }
  // o = v of lane + 1 (own v for the last lane)
  __device__ __forceinline__ void down1(int (&o)[1], const int (&v)[1]) const {
    o[0] = __shfl_down_sync(mask, v[0], 1);
  }
  // o = v of lane - s (own v for lanes below s)
  __device__ __forceinline__ void up(int (&o)[1], const int (&v)[1],
                                     int s) const {
    o[0] = __shfl_up_sync(mask, v[0], s);
  }
  __device__ __forceinline__ int bcast(int v) const {
    return __shfl_sync(mask, v, 0);
  }
  // (key, index) of the warp's first minimum, in every lane
  __device__ __forceinline__ void argmin_warp(const int (&key)[1],
                                              const int (&idx)[1],
                                              int (&k)[1], int (&i)[1]) const {
    k[0] = key[0];
    i[0] = idx[0];
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) {
      const int k2 = __shfl_xor_sync(mask, k[0], o);
      const int i2 = __shfl_xor_sync(mask, i[0], o);
      if (k2 < k[0] || (k2 == k[0] && i2 < i[0])) {
        k[0] = k2;
        i[0] = i2;
      }
    }
  }
  // bytes (a multiple of 16, both ends 16-byte aligned) from src to dst
  __device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src,
                                         int bytes) const {
    for (int o = 16 * l; o < bytes; o += 16 * LANES)
      *reinterpret_cast<uint4*>(dst + o) =
          *reinterpret_cast<const uint4*>(src + o);
  }
};
#else
struct HostGroup {
  static constexpr int NT = LANES * MAX_WARPS;
  int W;
  int count() const { return LANES * W; }
  int lane(int q) const { return q % LANES; }
  int warp(int q) const { return q / LANES; }
  bool leader() const { return true; }
  void syncwarp() const {}
  void bar() const {}
  void down1(int (&o)[NT], const int (&v)[NT]) const {
    for (int q = 0; q < count(); ++q)
      o[q] = lane(q) + 1 < LANES ? v[q + 1] : v[q];
  }
  void up(int (&o)[NT], const int (&v)[NT], int s) const {
    for (int q = 0; q < count(); ++q) o[q] = lane(q) >= s ? v[q - s] : v[q];
  }
  int bcast(int v) const { return v; }
  void argmin_warp(const int (&key)[NT], const int (&idx)[NT], int (&k)[NT],
                   int (&i)[NT]) const {
    for (int w = 0; w < W; ++w) {
      int kv = key[w * LANES], ki = idx[w * LANES];
      for (int q = w * LANES + 1; q < (w + 1) * LANES; ++q)
        if (key[q] < kv || (key[q] == kv && idx[q] < ki)) {
          kv = key[q];
          ki = idx[q];
        }
      for (int q = w * LANES; q < (w + 1) * LANES; ++q) {
        k[q] = kv;
        i[q] = ki;
      }
    }
  }
  void copy16(uint8_t* dst, const uint8_t* src, int bytes) const {
    std::memcpy(dst, src, bytes);
  }
};
#endif  // __CUDACC__

__device__ __forceinline__ void store_code(uint8_t* codes, int i, int stride,
                                           int t, uint32_t code) {
  const uint16_t v = static_cast<uint16_t>(code);
#ifdef __CUDACC__
  *reinterpret_cast<uint16_t*>(codes + static_cast<int64_t>(i) * stride +
                               2 * t) = v;
#else
  std::memcpy(codes + static_cast<int64_t>(i) * stride + 2 * t, &v, 2);
#endif
}

// One pair on its group of warps: the DP rows with their codes, the start
// column, the walk (on the group's first warp).
template <class X>
__device__ void align_pair(const X& x, const AlignIO& io, int p,
                           uint8_t* smem_codes, uint8_t* stage,
                           int stage_bytes, Xchg* xs) {
  constexpr int NT = X::NT;
  const int NQ = x.count();
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
  const bool multi = group_warps(band) > 1;
  const int stride = code_stride(band);
  const int64_t coff = io.c_off[p];
  uint8_t* __restrict__ codes = coff < 0 ? smem_codes : io.codes + coff;
  // D[0][k]: 0 (semiglobal) or j inside the band and [0, n], else BA_INF
  auto row0 = [&](int k) {
    const int j = k + base;
    return (k >= 0 && k < width && j >= 0 && j <= n) ? (semi ? 0 : j)
                                                      : BA_INF;
  };

  // The rows are kept as E = D - k (as the plain version keeps them), so
  // the insertion chain is a plain prefix minimum and a cell's tests need
  // no +k: diag E_prev[k] + sub == E, up E_prev[k+1] + 2 == E, left
  // E[k-1] == E; a cell outside the band or [0, n] holds BA_INF - k.
  int E[NT][C];
  int upe[NT];   // E[i-1][k0 + C]: the up term of the thread's last cell
  // row 0; its codes hold the left test only (the C's diag and up tests
  // need i > 0)
  for (int q = 0; q < NQ; ++q) {
    const int t = x.warp(q) * LANES + x.lane(q), k0 = t * C;
    uint32_t code = 0;
    int left = row0(k0 - 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + c, j = k + base;
      const int d = row0(k);
      const bool lf = j > 0 && k >= 1 && left + 1 == d;
      code |= (lf ? 2u : 3u) << (2 * c);
      left = d;
      E[q][c] = d - k;
    }
    upe[q] = row0(k0 + C) - (k0 + C);
    if (k0 < width) store_code(codes, 0, stride, t, code);
  }
  // the cover chars of a thread's cells slide one place a row: cell c of
  // row i reads b[i + k0 + c + base - 1] (4 outside the cover), so a row
  // loads one new char a thread, the next row's, ahead of its use
  auto bchar = [&](int idx) {
    return (idx >= 0 && idx < n) ? static_cast<int>(__ldg(b + idx)) : 4;
  };
  int bw[NT][C];
  for (int q = 0; q < NQ; ++q) {
    const int k0 = (x.warp(q) * LANES + x.lane(q)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) bw[q][c] = bchar(k0 + c + base);
  }
  // The cells of a row that are valid (k < width, 0 <= j <= n) are one
  // run of k; the rest hold BA_INF - k.  A cell left of the run (j < 0)
  // needs no test: its candidates come from such cells of the row before
  // and are never below its own BA_INF - k, so the prefix minimum carries
  // nothing below any later cell's cap.  Only the cells right of the run
  // are forced to their cap (the prefix of the valid cells would reach
  // them), with one comparison of c against the run's end, and the
  // traceback tests keep the C's own ranges (diag 1 <= j <= n, up
  // k + 1 < width, left j >= 1 and k >= 1) as thresholds on c.
  int ai = m > 0 ? a[0] : 0;
  for (int i = 1; i <= m; ++i) {
    const int par = i & 1;
    const int ai_next = i < m ? a[i] : 0;
    int first[NT], nxt[NT], upl[NT], tot[NT], r0[NT], Ew[NT], bnext[NT];
    int best[NT][C];
    for (int q = 0; q < NQ; ++q) {
      const int k0 = (x.warp(q) * LANES + x.lane(q)) * C;
      bnext[q] = bchar(i + k0 + base + C - 1);
      first[q] = E[q][0];
    }
    x.down1(nxt, first);
    for (int q = 0; q < NQ; ++q) {
      upl[q] = x.lane(q) + 1 < LANES ? nxt[q] : upe[q];
      int run = BIG;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int s = bw[q][c] != ai;
        const int up = (c + 1 < C ? E[q][c + 1] : upl[q]) + 2;
        run = imin(run, imin(E[q][c] + s, up));
        best[q][c] = run;               // in-lane inclusive prefix minimum
      }
      tot[q] = run;
      r0[q] = best[q][0];
    }
    // inclusive scan of the lane totals within each warp
    for (int s = 1; s < LANES; s <<= 1) {
      int t[NT];
      x.up(t, tot, s);
      for (int q = 0; q < NQ; ++q)
        if (x.lane(q) >= s) tot[q] = imin(tot[q], t[q]);
    }
    int excl[NT];
    x.up(excl, tot, 1);
    if (multi) {
      // the warps' totals and first own terms, then the prefix of the
      // warps before each one; lane 31 takes the next warp's first cell
      // of this row, the up term of its last cell in the next row
      for (int q = 0; q < NQ; ++q) {
        if (x.lane(q) == LANES - 1) xs->tot[par][x.warp(q)] = tot[q];
        if (x.lane(q) == 0) xs->r0[par][x.warp(q)] = r0[q];
      }
      x.bar();
      for (int q = 0; q < NQ; ++q) {
        const int w = x.warp(q);
        int e = BIG;
        for (int v = 0; v < w; ++v) e = imin(e, xs->tot[par][v]);
        Ew[q] = e;
        if (x.lane(q) == LANES - 1) {
          const int kn = (w + 1) * WARP_CELLS, jn = i + kn + base;
          const int cap = BA_INF - kn;
          upe[q] = w + 1 < group_warps(band) && kn < width && jn >= 0 &&
                           jn <= n
                       ? imin(cap, imin(imin(e, xs->tot[par][w]),
                                        xs->r0[par][w + 1]))
                       : cap;
        }
      }
    } else {
      for (int q = 0; q < NQ; ++q) Ew[q] = BIG;
    }
    // the row's values (the prefix minimum through k, capped at
    // BA_INF - k) and their codes; the left neighbour of a thread's first
    // cell, E[i][k0 - 1], is the prefix minimum before the thread
    for (int q = 0; q < NQ; ++q) {
      const int t = x.warp(q) * LANES + x.lane(q), k0 = t * C;
      const int j0 = i + k0 + base;
      const int e = imin(Ew[q], x.lane(q) > 0 ? excl[q] : BIG);
      const int vhi = imin(width - 1 - k0, n - j0);   // valid: c <= vhi
      const int jlo = 1 - j0, jhi = n - j0;           // 1 <= j <= n
      const int uhi = width - 2 - k0;                 // k + 1 < width
      const int llo = j0 < k0 ? 1 - j0 : 1 - k0;      // j, k >= 1
      int left = BA_INF - (k0 - 1);
      if (k0 > 0 && 0 <= vhi + 1) left = imin(left, e);
      uint32_t code = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int cap = BA_INF - (k0 + c);
        const int cur = c <= vhi ? imin(cap, imin(e, best[q][c])) : cap;
        const int s = bw[q][c] != ai;
        const int up = (c + 1 < C ? E[q][c + 1] : upl[q]) + 2;
        const bool dg = c >= jlo && c <= jhi && E[q][c] + s == cur;
        const bool uq = c <= uhi && up == cur;
        const bool lf = c >= llo && left == cur;
        code |= (dg ? 0u : uq ? 1u : lf ? 2u : 3u) << (2 * c);
        best[q][c] = cur;
        left = cur;
      }
      if (k0 < width) store_code(codes, i, stride, t, code);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        E[q][c] = best[q][c];
        bw[q][c] = c + 1 < C ? bw[q][c + 1] : bnext[q];
      }
    }
    ai = ai_next;
  }
  // the start column; the barrier (or the warp sync) also makes every
  // warp's codes visible to the walking warp
  int kstart = 0;
  if (semi) {
    int key[NT], idx[NT], wk[NT], wi[NT];
    for (int q = 0; q < NQ; ++q) {
      const int k0 = (x.warp(q) * LANES + x.lane(q)) * C;
      key[q] = BA_INF;
      idx[q] = 0;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (E[q][c] + k0 + c < key[q]) {   // padding and out-of-[0, n]
          key[q] = E[q][c] + k0 + c;       // cells hold BA_INF and never
          idx[q] = k0 + c;                 // count
        }
    }
    x.argmin_warp(key, idx, wk, wi);
    int kv = wk[0], ki = wi[0];
    if (multi) {
      for (int q = 0; q < NQ; ++q)
        if (x.lane(q) == 0) {
          xs->key[x.warp(q)] = wk[q];
          xs->idx[x.warp(q)] = wi[q];
        }
      x.bar();
      kv = xs->key[0];
      ki = xs->idx[0];
      for (int v = 1; v < group_warps(band); ++v)
        if (xs->key[v] < kv) {    // a later warp's columns are larger
          kv = xs->key[v];
          ki = xs->idx[v];
        }
    }
    kstart = kv < BA_INF ? ki : 0;
  } else {
    kstart = n - m + band - off;
    if (multi) x.bar();
  }
  if (!multi) x.syncwarp();
  if (x.warp(0) != 0) return;
  // the walk: lane 0 of the first warp, in the C's order of preference;
  // codes in global scratch come through the stage, rows [lo, i] at a time
  uint8_t* __restrict__ out = io.ops + io.o_end[p];
  const bool staged = coff >= 0;
  const int R = staged ? stage_bytes / stride : m + 1;
  int i = m, k = kstart, t = 0;
  int bad = !semi && (k < 0 || k >= width);
  int done = bad;
  while (!done) {
    const int lo = staged && i - R + 1 > 0 ? i - R + 1 : 0;
    const uint8_t* rows = codes;
    if (staged) {
      x.syncwarp();
      x.copy16(stage, codes + static_cast<int64_t>(lo) * stride,
               (i - lo + 1) * stride);
      x.syncwarp();
      rows = stage;
    }
    if (x.leader()) {
      for (;;) {
        if (!(i > 0 || (!semi && i + k + base > 0))) {
          done = 1;
          break;
        }
        if (i < lo) break;             // the stage's rows are used up
        if (k < 0 || k >= width || t >= m + n) {
          bad = done = 1;
          break;
        }
        const int f = (rows[static_cast<int64_t>(i - lo) * stride + (k >> 2)]
                       >> (2 * (k & 3))) & 3;
        int op;
        if (f == 0) {
          op = 0;
          --i;
        } else if (f == 1) {
          op = 1;
          --i;
          ++k;
        } else if (f == 2) {
          op = 2;
          --k;
        } else if (semi && i == 0) {
          done = 1;
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
    }
    i = x.bcast(i);
    k = x.bcast(k);
    t = x.bcast(t);
    bad = x.bcast(bad);
    done = x.bcast(done);
  }
  if (x.leader()) {
    io.len[p] = bad ? -1 : t;
    io.jstart[p] = i + k + base;
  }
}

#ifdef __CUDACC__
// Blocks [0, narrow_blocks): per_block <= 6 narrow pairs, a warp each
// (order[per_block b + warp]); the rest one wide pair each on its W warps
// (order[n_narrow + b - narrow_blocks]).
__global__ void __launch_bounds__(THREADS) band_align_kernel(
    AlignIO io, const int32_t* __restrict__ order, int n_narrow,
    int per_block, int narrow_blocks) {
  __shared__ __align__(16) uint8_t stage[MAX_WARPS * STAGE_BYTES];
  __shared__ Xchg xs;
  extern __shared__ __align__(16) uint8_t dyn[];
  const int w = static_cast<int>(threadIdx.x) / LANES;
  const int l = static_cast<int>(threadIdx.x) % LANES;
  const int blk = static_cast<int>(blockIdx.x);
  int p, gw, W, sbytes;
  uint8_t* stg;
  if (blk < narrow_blocks) {
    const int s = blk * per_block + w;
    if (w >= per_block || s >= n_narrow) return;   // the whole warp
    p = order[s];
    gw = 0;
    W = 1;
    stg = stage + w * STAGE_BYTES;
    sbytes = STAGE_BYTES;
  } else {
    p = order[n_narrow + blk - narrow_blocks];
    W = group_warps(io.band[p]);
    if (w >= W) return;               // not in the named barrier
    gw = w;
    stg = stage;
    sbytes = MAX_WARPS * STAGE_BYTES;
  }
  align_pair(WarpGroup{l, gw, W}, io, p, dyn, stg, sbytes, &xs);
}
#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__
// One launch over n_narrow + n_wide pairs in the order `order` (narrow
// first, per_block narrow pairs a block); smem_bytes of dynamic shared
// memory a block for the codes of the pairs whose c_off is -1.
extern "C" int band_align_launch(
    const void* a, const void* a_off, const void* b, const void* b_off,
    const void* band, const void* order, const void* c_off,
    const void* o_end, int n_narrow, int per_block, int n_wide,
    int semiglobal, int smem_bytes, void* codes, void* ops, void* len,
    void* jstart, void* stream) {
  if (n_narrow < 0 || n_wide < 0 || smem_bytes < 0 || per_block < 1 ||
      per_block > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int narrow_blocks = (n_narrow + per_block - 1) / per_block;
  const int grid = narrow_blocks + n_wide;
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  // the kernel's dynamic shared memory limit on each device, read from
  // the function's attributes at its first launch there (48 KB less the
  // kernel's static shared memory until raised) and raised only when a
  // launch needs more than any before it (launches come from one host
  // thread)
  constexpr int MAX_DEVICES = 64;
  static int smem_limit[MAX_DEVICES] = {};
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (d < 0 || d >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_limit[d] == 0) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, band_align_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_limit[d] = attr.maxDynamicSharedSizeBytes;
    if (smem_limit[d] > 48 * 1024 - static_cast<int>(attr.sharedSizeBytes))
      smem_limit[d] = 48 * 1024 - static_cast<int>(attr.sharedSizeBytes);
  }
  if (smem_bytes > smem_limit[d]) {
    e = cudaFuncSetAttribute(band_align_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_limit[d] = smem_bytes;
  }
  const AlignIO io{static_cast<const uint8_t*>(a),
                   static_cast<const int64_t*>(a_off),
                   static_cast<const uint8_t*>(b),
                   static_cast<const int64_t*>(b_off),
                   static_cast<const int32_t*>(band),
                   static_cast<uint8_t*>(codes),
                   static_cast<const int64_t*>(c_off),
                   static_cast<uint8_t*>(ops),
                   static_cast<const int64_t*>(o_end),
                   static_cast<int32_t*>(len),
                   static_cast<int32_t*>(jstart),
                   semiglobal};
  band_align_kernel<<<grid, THREADS, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      io, static_cast<const int32_t*>(order), n_narrow, per_block,
      narrow_blocks);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
