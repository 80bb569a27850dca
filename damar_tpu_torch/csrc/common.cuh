// Helpers shared by the port's kernels (wave_bp.cu, dp_rows.cu): the
// pool clip rule, the packed-word char stream, and the persistent grid.
//
// Everything outside __CUDACC__ also compiles as host C++ once the few
// intrinsics it uses have host definitions (tests/test_torch_*_host.py).
#pragma once
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int INF_I = 1 << 20;
constexpr int WARP = 32;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  // jnp.clip order: max first, then min
  x = x > lo ? x : lo;
  return x < hi ? x : hi;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ w,
                                              int n, int i) {
  return __ldg(w + clampi(i, 0, n - 1));
}

// Reverse the 16 2-bit groups of a word.
__device__ __forceinline__ uint32_t rev16(uint32_t g) {
  g = __brev(g);
  return ((g >> 1) & 0x55555555u) | ((g & 0x55555555u) << 1);
}

// The chars at pool positions p, p+1, ... (forward) or p, p-1, ...
// (reverse), 16 per call with stream char k at bits [2k, 2k+2).  The
// clip rule holds char for char: the char at pool position q is
// (words[clip(q >> 4, 0, n-1)] >> 2*(q & 15)) & 3 with a flooring shift,
// because each word of a funnel pair is clipped on its own.
struct CharStream {
  const uint32_t* w;
  int n, fi, step;
  uint32_t sh, carry, q0, q1;
  bool rev;

  __device__ __forceinline__ void start(const uint32_t* words, int nwords,
                                        int p, bool reverse) {
    w = words;
    n = nwords;
    rev = reverse;
    step = reverse ? -1 : 1;
    const int lo = reverse ? p - 15 : p;  // lowest position of group 0
    const int wi = lo >> 4;               // arithmetic: floors
    sh = 2u * static_cast<uint32_t>(lo & 15);
    // group j reads words wi + step*j and wi + step*j + 1: one is shared
    // with group j - 1 (carry), one is new (q0, loaded ahead as q1)
    carry = load_word(w, n, reverse ? wi + 1 : wi);
    fi = reverse ? wi : wi + 1;
    q0 = load_word(w, n, fi);
    q1 = load_word(w, n, fi + step);
  }

  __device__ __forceinline__ uint32_t next16() {
    const uint32_t nw = q0;
    q0 = q1;
    q1 = load_word(w, n, fi + 2 * step);
    fi += step;
    const uint32_t lo = rev ? nw : carry;
    const uint32_t hi = rev ? carry : nw;
    carry = nw;
    const uint32_t g = __funnelshift_r(lo, hi, sh);
    return rev ? rev16(g) : g;
  }
};

#ifdef __CUDACC__
// Persistent grid: as many blocks of `threads` as fit on the card at
// once, but no more than `needed`.  The fit is fixed per kernel and
// device, so it is asked once (the occupancy query costs host time on
// every launch otherwise, while the stream may stand idle).  Two host
// threads may launch at once (a sweep's emit thread and its caller): both
// would then compute and store the same value, an aligned int, so the
// cache needs no lock.
template <auto Kernel>
int grid_for(int threads, int needed) {
  static int fit_of[64] = {0};  // per device ordinal
  int dev = 0;
  cudaGetDevice(&dev);
  int& fit = fit_of[dev & 63];
  if (fit == 0) {
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads,
                                                  0);
    fit = sms * (per_sm > 0 ? per_sm : 1);
  }
  return fit < needed ? fit : needed;
}
#endif  // __CUDACC__

}  // namespace
