// Bit-parallel 32-diagonal band kernels: seed extension (K1) and
// trace-point segmentation (K2), designed for the H100 (sm_90a).
//
// K1 bp_extend_kernel replaces _ext_chunk_kernel (damar_tpu/ops/
//    wave_bp_pallas.py:228, driven by extend_wave_bp_pl);
// K2 bp_trace_kernel  replaces _trace_chunk_kernel (wave_bp_pallas.py:420,
//    driven by trace_wave_bp_pl).
// Both are bit-identical to them and to their plain torch versions in
// damar_tpu_torch/ops/wave_bp.py.
//
// What bounds them on this card: integer operations.  A DP row of one
// unit is a chain of dependent int32 ops on registers.  Built for
// sm_90a, the 16-row loop takes 892 SASS instructions in K1 (55.75 a
// row: row step, match planes, char extraction, plane shift-in, best
// and x-drop tracking) and 630 in K2 (39.4 a row: no tracking, no
// centre counter); chip_smoke.py counts them from the built code at
// every run.  The work is the rows the outputs need: K1 sum(bva) over
// its units, once per unit, K2 sum(alim) over its extents.  At the
// card's issue rate of 132 SMs x 128 lanes x 1.98 GHz = 33.5 T int32
// lane-ops/s the large-50Mbp pass needs ~1.3 ms of K1 and ~0.7
// ms of K2.  Bytes are no bound: a unit
// reads 21 bytes of arguments, writes 16 (K1) or 8 per segment (K2), and
// reads its chars at 2 bits each.
//
// What the design does about it:
//  * One launch covers every unit of a phase (K1) or every extent of a
//    segment-count bucket (K2).  The grid is persistent, sized by the
//    occupancy API to fill every SM; each warp takes the next 32 work
//    items from a device counter (one atomic per 32 items), longest
//    first (K1 through the `order` its wrapper sorts, K2 in the input
//    order the driver lays out so), so a warp's lanes have similar
//    lengths and the shortest items fill the tail.  Units are
//    independent, so the order changes no output.
//  * Characters come by word, ahead of use.  A CharStream (common.cuh,
//    shared with dp_rows.cu) holds the next pool words in registers,
//    issues each load two 16-char groups (32 rows) before it is
//    needed, and hands out 16 chars at a time
//    aligned to the rows (a funnel shift of two words, then a 2-bit
//    group reversal for reverse units), so a row extracts its char with
//    a constant shift.  The Peq planes of a chunk or segment are built
//    from two such groups by bit compaction.  The clip rule stays char
//    for char: the char at pool position p is
//    (words[clip(p >> 4, 0, n-1)] >> 2*(p & 15)) & 3, with an arithmetic
//    shift that floors negative p (each word of a funnel pair is clipped
//    on its own).
//  * K2 writes each segment as one 8-byte store into a buffer the
//    wrapper zeroed; the kernels allocate nothing.
// Exactness points kept: first-min and first-max ties, u32 wraparound,
// the guarded 32-bit shift in low_mask, jnp.clip's max-then-min order.
//
// The per-unit functions (extend_unit, trace_extent and what they call,
// with common.cuh) also compile as host C++ when the intrinsics are given host
// definitions: everything CUDA-only is under __CUDACC__.
// tests/test_torch_wave_bp_host.py builds them so and holds them against
// the plain versions on the CPU.
#include "common.cuh"

namespace {

constexpr int BW = 32;
constexpr int CTR = 16;
constexpr int NEG_I = -(1 << 20);
constexpr uint32_t NOT1 = 0xFFFFFFFEu;
constexpr uint32_t VN0 = (1u << (CTR + 1)) - 1u;
constexpr uint32_t VP0 = 0xFFFFFFFFu ^ VN0;
constexpr int THREADS = 128;

// Bits 0, 2, ..., 30 of x packed into bits 0..15.
__device__ __forceinline__ uint32_t even_bits(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

__device__ __forceinline__ uint32_t low_mask(int m) {
  return m >= 32 ? 0xFFFFFFFFu : (1u << m) - 1u;
}

// Peq planes of the 32 chars of g0 | g1 << 32, at v-indices v0b + j
// (valid iff 0 <= v0b + j < blim).
__device__ __forceinline__ void init_planes(uint32_t g0, uint32_t g1,
                                            int v0b, int blim, uint32_t& PH,
                                            uint32_t& PL, uint32_t& PV) {
  PL = even_bits(g0) | (even_bits(g1) << 16);
  PH = even_bits(g0 >> 1) | (even_bits(g1 >> 1) << 16);
  const int lo = clampi(-v0b, 0, BW);
  const int hi = clampi(blim - v0b, 0, BW);
  PV = hi > lo ? (low_mask(hi) & ~low_mask(lo)) : 0u;
}

__device__ __forceinline__ uint32_t eq_bits(uint32_t PH, uint32_t PL,
                                            uint32_t PV, int x) {
  uint32_t xh = static_cast<uint32_t>(x >> 1);
  uint32_t xl = static_cast<uint32_t>(x & 1);
  return (PH ^ (xh - 1u)) & (PL ^ (xl - 1u)) & PV;
}

// One DP row, the algebra of ops.wave_bp._row_step.
__device__ __forceinline__ void row_step(uint32_t& VP, uint32_t& VN,
                                         int& Db, int& Dc, uint32_t Eq) {
  uint32_t X = Eq | (VN >> 1);
  uint32_t seed = (X << 1) & VP;
  uint32_t G0 = X | (VP & (seed | ((seed + VP) ^ VP)));
  uint32_t g = ~G0;
  uint32_t gp = g << 1;
  uint32_t d = g ^ gp;
  uint32_t nd = ~d;
  uint32_t Z = ~(VP | VN);
  uint32_t VPn = (VP & nd) | (Z & g & ~gp);
  uint32_t VNn = (VN & nd) | (Z & gp & G0);
  Db = Db + 1 + static_cast<int>(VP & 1u) - static_cast<int>(VN & 1u);
  Dc = Dc + 1 - static_cast<int>((G0 >> CTR) & 1u);
  VP = VPn & NOT1;
  VN = (VNn & NOT1) | (G0 & 1u);
}

__device__ __forceinline__ void shift_planes(uint32_t& PH, uint32_t& PL,
                                             uint32_t& PV, int nb,
                                             bool nvalid) {
  PH = (PH >> 1) | (static_cast<uint32_t>((nb >> 1) & 1) << (BW - 1));
  PL = (PL >> 1) | (static_cast<uint32_t>(nb & 1) << (BW - 1));
  PV = (PV >> 1) | (static_cast<uint32_t>(nvalid) << (BW - 1));
}

// Recenter the delta words by `drift` (ops.wave_bp_pallas._recenter).
__device__ __forceinline__ void recenter(uint32_t& VP, uint32_t& VN,
                                         int& Db, int& Dc, int d) {
  uint32_t VPn, VNn;
  if (d >= 0) {
    uint32_t du = static_cast<uint32_t>(d);
    VPn = (VP >> du) | ~(0xFFFFFFFFu >> du);
    VNn = (VN >> du) & (0xFFFFFFFFu >> du);
  } else {
    uint32_t mu = static_cast<uint32_t>(-d);
    VPn = VP << mu;
    VNn = (VN << mu) | ((2u << mu) - 2u);
  }
  int neg = d < 0 ? -d : 0;
  uint32_t mask0 = low_mask(clampi(d, 0, BW - 1) + 1);
  int D0 = Db + __popc(VP & mask0) - __popc(VN & mask0) + neg;
  int idxc = clampi(CTR + d, 0, BW - 1);
  uint32_t maskc = low_mask(idxc + 1);
  int over = CTR + d - idxc;
  int Dcn = Db + __popc(VP & maskc) - __popc(VN & maskc)
            + (over < 0 ? -over : over);
  VP = VPn | 1u;
  VN = VNn & NOT1;
  Db = D0 - 1;
  Dc = Dcn;
}

struct ExtParams {
  const uint32_t* aw;
  const uint32_t* bw;
  int na, nb, R, max_rows, diff_cost, xdrop;
};

// K1 on one unit: R-row chunks until the unit dies or max_rows.
__device__ void extend_unit(const ExtParams& P, int ao, int bo, int alim,
                            int blim, bool rv, int& bs_o, int& bva_o,
                            int& bvb_o, bool& act_o) {
  CharStream A, B;
  // v-space index v -> pool position: forward origin + v, reverse
  // origin - 1 - v
  A.start(P.aw, P.na, rv ? ao - 1 : ao, rv);
  uint32_t VP = VP0, VN = VN0;
  int Db = CTR + 1, Dc = 0;
  int vbb = 1 - CTR;
  bool active = alim > 0;
  int bs = 0, bva = 0, bvb = 0;
  const int dlim = P.xdrop + P.diff_cost;
  for (int rtot = 0; active && rtot < P.max_rows; rtot += P.R) {
    B.start(P.bw, P.nb, rv ? bo - vbb : bo + vbb - 1, rv);
    uint32_t PH, PL, PV;
    {
      const uint32_t g0 = B.next16();
      const uint32_t g1 = B.next16();
      init_planes(g0, g1, vbb - 1, blim, PH, PL, PV);
    }
    // row r of the chunk: in range (t <= alim, 0 <= vc <= blim) iff
    // rlo <= r <= rhi; its shift-in char valid iff vlo <= r < vhi
    const int rlo = -vbb - CTR;
    const int rhi = min(alim - rtot - 1, blim - vbb - CTR);
    const int vlo = -(vbb + BW - 1);
    const int vhi = blim - (vbb + BW - 1);
    const int s0 = rtot + 1 + vbb + CTR;  // t + vc at r = 0
    bool died = false;
    for (int r0 = 0; r0 < P.R; r0 += 16) {
      const uint32_t ga = A.next16();
      const uint32_t gb = B.next16();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = r0 + i;
        const int x = static_cast<int>((ga >> (2 * i)) & 3u);
        row_step(VP, VN, Db, Dc, eq_bits(PH, PL, PV, x));
        const int sc = s0 + 2 * r - P.diff_cost * Dc;
        const bool ok = r >= rlo && r <= rhi;
        if (ok && sc > bs) {
          bs = sc;
          bva = rtot + r + 1;
          bvb = vbb + r + CTR;
        }
        died = died || (ok && sc < bs - dlim);
        shift_planes(PH, PL, PV, static_cast<int>((gb >> (2 * i)) & 3u),
                     r >= vlo && r < vhi);
      }
    }
    // chunk tail: band-wide score max (first max), first-min column
    const int t = rtot + P.R;
    const int vbb_t = vbb + P.R - 1;
    const bool extra = t <= alim;
    int D = Db, smax = NEG_I, jbest = 0, dmin = 1 << 30, jmin = 0;
#pragma unroll 8
    for (int j = 0; j < BW; ++j) {
      D += static_cast<int>((VP >> j) & 1u) - static_cast<int>((VN >> j) & 1u);
      const int vb = vbb_t + j;
      const bool in_b = vb >= 0 && vb <= blim;
      const int sc = (in_b && extra) ? vb - P.diff_cost * D : NEG_I;
      if (sc > smax) {
        smax = sc;
        jbest = j;
      }
      const int Dm = in_b ? D : INF_I;
      if (Dm < dmin) {
        dmin = Dm;
        jmin = j;
      }
    }
    if (smax > NEG_I) smax += t;
    if (smax > bs) {
      bs = smax;
      bva = t;
      bvb = vbb_t + jbest;
    }
    const bool act = (smax >= bs - P.xdrop) && (t < alim) && !died;
    const int drift = act ? jmin - CTR : 0;
    recenter(VP, VN, Db, Dc, drift);
    vbb = vbb_t + 1 + drift;
    active = act;
  }
  bs_o = bs;
  bva_o = bva;
  bvb_o = bvb;
  act_o = active;
}

// 16 (or, with GUARD, the first n) rows of a K2 segment.
template <bool GUARD>
__device__ __forceinline__ void trace_rows16(
    uint32_t ga, uint32_t gb, int r0, int n, int vlo, int vhi, uint32_t& VP,
    uint32_t& VN, int& Db, uint32_t& PH, uint32_t& PL, uint32_t& PV) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (!GUARD || i < n) {
      int Dc = 0;  // the centre counter is dead in the trace
      const int r = r0 + i;
      row_step(VP, VN, Db, Dc,
               eq_bits(PH, PL, PV, static_cast<int>((ga >> (2 * i)) & 3u)));
      shift_planes(PH, PL, PV, static_cast<int>((gb >> (2 * i)) & 3u),
                   r >= vlo && r < vhi);
    }
  }
}

struct TraceParams {
  const uint32_t* aw;
  const uint32_t* bw;
  int na, nb, TS, max_segs;
};

// K2 on one extent: tspace segments until alim or max_segs; segment k
// goes to out[k], the counts to nseg_o/dsum_o.
__device__ void trace_extent(const TraceParams& P, int abp, int ao, int bo,
                             int alim, int blim, int2* __restrict__ out,
                             int32_t& nseg_o, int32_t& dsum_o) {
  uint32_t VP = VP0, VN = VN0;
  int Db = CTR + 1;
  int vbb = 1 - CTR;
  int done = 0, nseg = 0, prev_vb = 0, dsum = 0;
  for (int k = 0; k < P.max_segs && done < alim; ++k) {
    const int a = abp + done;
    const int nxt = (floordiv(a, P.TS) + 1) * P.TS - a;
    const int seg_rows = nxt < alim - done ? nxt : alim - done;
    CharStream A, B;
    A.start(P.aw, P.na, ao + done, false);
    B.start(P.bw, P.nb, bo + vbb - 1, false);
    uint32_t PH, PL, PV;
    {
      const uint32_t g0 = B.next16();
      const uint32_t g1 = B.next16();
      init_planes(g0, g1, vbb - 1, blim, PH, PL, PV);
    }
    const int vlo = -(vbb + BW - 1);
    const int vhi = blim - (vbb + BW - 1);
    int r0 = 0;
    for (; r0 + 16 <= seg_rows; r0 += 16) {
      const uint32_t ga = A.next16();
      trace_rows16<false>(ga, B.next16(), r0, 16, vlo, vhi, VP, VN, Db,
                          PH, PL, PV);
    }
    if (r0 < seg_rows) {
      const uint32_t ga = A.next16();
      trace_rows16<true>(ga, B.next16(), r0, seg_rows - r0, vlo, vhi, VP,
                         VN, Db, PH, PL, PV);
    }
    // commit point: first min over valid columns past prev_vb, or the
    // end column at the last segment
    const int va = done + seg_rows;
    const bool at_end = va == alim;
    const int vbb_end = vbb + seg_rows - 1;
    const int j_end = clampi(blim - vbb_end, 0, BW - 1);
    int D = Db, dmin = 1 << 30, jmin = 0, dsel = 0, dend = 0;
#pragma unroll 8
    for (int j = 0; j < BW; ++j) {
      D += static_cast<int>((VP >> j) & 1u) -
           static_cast<int>((VN >> j) & 1u);
      const int vb = vbb_end + j;
      const bool mvalid = vb >= 0 && vb <= blim && vb > prev_vb;
      const int Dm = mvalid ? D : INF_I;
      if (Dm < dmin) {
        dmin = Dm;
        jmin = j;
        dsel = D;
      }
      if (j == j_end) dend = D;
    }
    const int j_com = at_end ? j_end : jmin;
    const int vb_com = clampi(vbb_end + j_com, prev_vb, blim);
    int d_com = at_end ? dend : dsel;
    if (d_com >= INF_I) d_com = alim + blim;
    // fresh V-shaped band at the committed column
    VP = VP0;
    VN = VN0;
    Db = CTR + 1;
    vbb = vb_com - CTR + 1;
    out[k] = make_int2(d_com, vb_com - prev_vb);
    done += seg_rows;
    nseg += 1;
    prev_vb = vb_com;
    dsum += d_com;
  }
  nseg_o = nseg;
  dsum_o = dsum;
}

#ifdef __CUDACC__
// The next 32 work items of this warp from the launch's counter, as the
// first item's index (warp-uniform).
__device__ __forceinline__ int take_run(int* counter) {
  int base = 0;
  if ((threadIdx.x & (WARP - 1)) == 0) base = atomicAdd(counter, WARP);
  return __shfl_sync(0xFFFFFFFFu, base, 0);
}

__global__ void __launch_bounds__(THREADS) bp_extend_kernel(
    ExtParams P, const int32_t* __restrict__ aorigin,
    const int32_t* __restrict__ borigin, const int32_t* __restrict__ alim_,
    const int32_t* __restrict__ blim_, const uint8_t* __restrict__ dirs,
    const int32_t* __restrict__ order, int S, int* counter,
    int32_t* __restrict__ bs_o, int32_t* __restrict__ bva_o,
    int32_t* __restrict__ bvb_o, int32_t* __restrict__ act_o) {
  for (;;) {
    const int base = take_run(counter);
    if (base >= S) return;
    const int i = base + static_cast<int>(threadIdx.x & (WARP - 1));
    if (i < S) {
      const int s = order[i];
      int bs, bva, bvb;
      bool act;
      extend_unit(P, aorigin[s], borigin[s], alim_[s], blim_[s],
                  dirs[s] != 0, bs, bva, bvb, act);
      bs_o[s] = bs;
      bva_o[s] = bva;
      bvb_o[s] = bvb;
      act_o[s] = act ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(THREADS) bp_trace_kernel(
    TraceParams P, const int32_t* __restrict__ astart,
    const int32_t* __restrict__ bstart, const int32_t* __restrict__ abpos,
    const int32_t* __restrict__ bbpos, const int32_t* __restrict__ alim_,
    const int32_t* __restrict__ blim_, int S, int* counter,
    int2* __restrict__ trace, int32_t* __restrict__ nseg_o,
    int32_t* __restrict__ dsum_o) {
  for (;;) {
    const int base = take_run(counter);
    if (base >= S) return;
    const int s = base + static_cast<int>(threadIdx.x & (WARP - 1));
    if (s < S) {
      const int abp = abpos[s];
      trace_extent(P, abp, astart[s] + abp, bstart[s] + bbpos[s], alim_[s],
                   blim_[s], trace + static_cast<size_t>(s) * P.max_segs,
                   nseg_o[s], dsum_o[s]);
    }
  }
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__
extern "C" int bp_extend_launch(
    const void* aw, int na, const void* bw, int nb, const void* aorigin,
    const void* borigin, const void* alim, const void* blim,
    const void* dirs, const void* order, int S, int R, int max_rows,
    int diff_cost, int xdrop, void* counter, void* bs, void* bva, void* bvb,
    void* act, void* stream) {
  if (R <= 0 || R % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    ExtParams P{static_cast<const uint32_t*>(aw),
                static_cast<const uint32_t*>(bw), na, nb, R, max_rows,
                diff_cost, xdrop};
    const int grid = grid_for<bp_extend_kernel>(THREADS,
                                                (S + THREADS - 1) / THREADS);
    bp_extend_kernel<<<grid, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        P, static_cast<const int32_t*>(aorigin),
        static_cast<const int32_t*>(borigin),
        static_cast<const int32_t*>(alim), static_cast<const int32_t*>(blim),
        static_cast<const uint8_t*>(dirs),
        static_cast<const int32_t*>(order), S, static_cast<int*>(counter),
        static_cast<int32_t*>(bs), static_cast<int32_t*>(bva),
        static_cast<int32_t*>(bvb), static_cast<int32_t*>(act));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_trace_launch(
    const void* aw, int na, const void* bw, int nb, const void* astart,
    const void* bstart, const void* abpos, const void* bbpos,
    const void* alim, const void* blim, int S, int tspace, int max_segs,
    void* counter, void* trace, void* nseg, void* dsum, void* stream) {
  if (S > 0) {
    TraceParams P{static_cast<const uint32_t*>(aw),
                  static_cast<const uint32_t*>(bw), na, nb, tspace, max_segs};
    const int grid = grid_for<bp_trace_kernel>(THREADS,
                                               (S + THREADS - 1) / THREADS);
    bp_trace_kernel<<<grid, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        P, static_cast<const int32_t*>(astart),
        static_cast<const int32_t*>(bstart),
        static_cast<const int32_t*>(abpos), static_cast<const int32_t*>(bbpos),
        static_cast<const int32_t*>(alim), static_cast<const int32_t*>(blim),
        S, static_cast<int*>(counter),
        static_cast<int2*>(trace), static_cast<int32_t*>(nseg),
        static_cast<int32_t*>(dsum));
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
