// Per-read reverse complement of a block's bases, made on the card:
// revcomp_kernel, for the H100 (sm_90a).
//
// Replaces no TPU kernel.  damar_tpu makes this twin on the host
// (damar_tpu/core/blocks.py revcomp_block: its native C routine or a
// numpy gather) and hands it to the device as a fresh array; the port
// made it so too, then uploaded it.  The block's forward bases, read ids
// and read starts are on the card by then (seeding reads them), so the
// twin is made there from them: out[p] = 3 - in[starts[r] + starts[r+1]
// - 1 - p] for every position p < nbases of read r = read_id[p], and
// out[p] = in[p] for the padding at and past nbases.  The bytes equal
// revcomp_block's, 3 - code in uint8 arithmetic included.
//
// What bounds it on this card: bytes.  A base reads its read id (4
// bytes) and its source base (1) and writes one byte; the read starts
// (8 bytes each) are shared by every position of a read and come from
// the cache.  About 6 bytes a base: 0.63 GB for a 100 Mbp block's
// capacity, 0.19 ms at 3.35 TB/s.  No arithmetic to speak of.
//
// What the design does about it:
//  * A thread takes 4 consecutive positions (a quad): one 16-byte load
//    of their read ids and one 4-byte store of their bases, so a warp
//    reads 512 and writes 128 contiguous bytes a step.  The 4 source
//    bytes of a quad inside one read lie at 4 consecutive descending
//    addresses, so a warp's source reads are contiguous as well.  A
//    quad that straddles two reads, the block's tail, or arrays that
//    are not 16-byte aligned take the position-by-position form.
//  * A grid-stride loop over the quads on a grid that fills the card
//    once (grid_for): no shared memory, nothing allocated; the wrapper
//    allocates the output.
//
// rc_quad, with the position rule rc_base, also compiles as host C++:
// everything CUDA-only is under __CUDACC__.
// tests/test_torch_revcomp.py builds it so and holds it against
// core.blocks.revcomp_block on the CPU.
#include "common.cuh"

namespace {

struct RcArgs {
  const uint8_t* in;        // forward bases [cap]
  uint8_t* out;             // twin bases [cap]
  const int32_t* read_id;   // [cap]: position -> read ordinal
  const long long* starts;  // [nreads + 1]
  int64_t nbases;           // real bases; padding follows up to cap
  int64_t cap;
};

#ifdef __CUDACC__
struct __align__(16) Rid4 { int32_t x, y, z, w; };
struct __align__(4) Base4 { uint8_t x, y, z, w; };
#else
struct alignas(16) Rid4 { int32_t x, y, z, w; };
struct alignas(4) Base4 { uint8_t x, y, z, w; };
#endif

// the twin's base at a real position p of read r
__device__ __forceinline__ uint8_t rc_base(const RcArgs& a, int64_t p,
                                           int32_t r) {
  const int64_t src = __ldg(a.starts + r) + __ldg(a.starts + r + 1) - 1 - p;
  return static_cast<uint8_t>(3 - a.in[src]);
}

// positions 4q .. 4q + 3 of the twin (those below cap); vec: the arrays
// are aligned for the quad's 16-byte and 4-byte accesses
__device__ __forceinline__ void rc_quad(const RcArgs& a, int64_t q,
                                        bool vec) {
  const int64_t p0 = 4 * q;
  if (vec && p0 + 4 <= a.cap) {
    if (p0 >= a.nbases) {  // padding, copied
      *reinterpret_cast<Base4*>(a.out + p0) =
          *reinterpret_cast<const Base4*>(a.in + p0);
      return;
    }
    if (p0 + 4 <= a.nbases) {
      const Rid4 r = *reinterpret_cast<const Rid4*>(a.read_id + p0);
      if (r.x == r.w) {  // one read: 4 descending source bytes
        const int64_t s = __ldg(a.starts + r.x) + __ldg(a.starts + r.x + 1)
                          - 1 - p0;
        Base4 o;
        o.x = static_cast<uint8_t>(3 - a.in[s]);
        o.y = static_cast<uint8_t>(3 - a.in[s - 1]);
        o.z = static_cast<uint8_t>(3 - a.in[s - 2]);
        o.w = static_cast<uint8_t>(3 - a.in[s - 3]);
        *reinterpret_cast<Base4*>(a.out + p0) = o;
        return;
      }
    }
  }
  for (int64_t p = p0; p < p0 + 4 && p < a.cap; ++p)
    a.out[p] = p < a.nbases ? rc_base(a, p, a.read_id[p]) : a.in[p];
}

#ifdef __CUDACC__
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
revcomp_kernel(RcArgs a, int64_t nquads, bool vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       q < nquads; q += stride)
    rc_quad(a, q, vec);
}
#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__
extern "C" int revcomp_launch(const void* in, void* out, const void* read_id,
                              const void* starts, long long nbases,
                              long long cap, void* stream) {
  if (nbases < 0 || nbases > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nquads = (cap + 3) / 4;
  if (nquads > 0) {
    const RcArgs a{static_cast<const uint8_t*>(in),
                   static_cast<uint8_t*>(out),
                   static_cast<const int32_t*>(read_id),
                   static_cast<const long long*>(starts), nbases, cap};
    const bool vec = ((reinterpret_cast<uintptr_t>(in)
                       | reinterpret_cast<uintptr_t>(out)
                       | reinterpret_cast<uintptr_t>(read_id)) & 15) == 0;
    const int64_t blocks = (nquads + THREADS - 1) / THREADS;
    const int grid = grid_for<revcomp_kernel>(
        THREADS, blocks < (1 << 30) ? static_cast<int>(blocks) : (1 << 30));
    revcomp_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, nquads, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
