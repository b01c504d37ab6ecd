// K1 — SBM sweep: per-endpoint report counts over the lex-sorted stream.
//
// Replaces the Pallas kernel `_sweep_kernel` of the JAX package
// (src/repro/kernels/sbm_sweep.py:28).  For endpoint i of the sorted
// stream, with flags is_lo[i], is_upd[i] in {0, 1}:
//
//   d_upd[i] = is_upd * (2*is_lo - 1)       d_sub[i] = (1-is_upd) * (same)
//   upd_active[i], sub_active[i] = inclusive prefix sums of d_upd, d_sub
//   out[i] = (1-is_lo) * ((1-is_upd) * upd_active[i] + is_upd * sub_active[i])
//
// Bound on the card: bytes.  Each endpoint is two int32 flags in and one
// int32 count out, 12 B; the work per endpoint is a handful of integer
// operations, far below the H100's rate.  So the design reads each flag
// once and writes each count once, in coalesced 16-byte vectors.
//
// Why one pass.  The TPU kernel carried the two running totals in SMEM
// from one grid step to the next, which is legal only because a TPU grid
// runs in order; a grid on Hopper runs in no order, and SMEM does not
// outlive a CTA, so that carried total has no counterpart here.  A scan
// in three launches (tile sums, one CTA scanning them, a rescan) reads
// the flags twice and leaves 131 SMs idle in its middle launch.  This is
// instead the single-pass scan with decoupled look-back (Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016), one launch:
//   1. each CTA takes the next tile index from a counter in the scratch
//      (atomicAdd), so every tile below it belongs to a CTA that has
//      already started and a wait on it cannot deadlock;
//   2. it loads its tile's flags, each warp a contiguous span, each load
//      instruction 32 lanes x 16 contiguous bytes, and keeps every
//      endpoint as a 3-bit code (is_lo, is_upd, inside n) in registers;
//   3. one scan of the tile: per lane and vector, a warp scan by
//      shuffles of the vectors' sums, then the warp totals through shared
//      memory; the two deltas ride in one int32 (upd + sub * 2^16), exact
//      while a tile's sums stay within +-2^15;
//   4. warp 0 publishes the tile's aggregate, then looks back over its
//      predecessors' descriptors 32 tiles a step (a lane a tile), adding
//      aggregates until it meets a tile that has published its
//      inclusive prefix; then it publishes its own prefix;
//   5. every thread writes its counts, 16-byte stores in the load order.
// Three barriers a tile (tile index, warp totals, tile prefix).
//
// Descriptors: a packing whose every field fits, so no read can be torn
// and no ordering between words is needed.  Per tile three 64-bit words,
// each single-copy atomic (cuda::atomic_ref, relaxed): A = VALID |
// agg_upd (16 bits) | agg_sub (16 bits), whose fields fit because a
// tile's sums lie within +-TILE <= 2^14; P_upd = VALID | pre_upd (32
// bits) and P_sub = VALID | pre_sub (32 bits), whose fields hold any
// prefix of n < 2^31 endpoints, +-n included.  A tile has published its
// prefix when both P words carry VALID, its aggregate when A does; a
// look-back step is one round of three loads a lane.
//
// Scratch: the counter in the first 8 bytes, then the A, P_upd and P_sub
// words, ntiles each (2 + 6 * ntiles int32, 8-byte aligned).  The launch
// function zeroes all of it with one cudaMemsetAsync on the same stream
// before the kernel; the kernel allocates nothing.
//
// Edges.  The ragged tail is masked in the kernel (its codes say
// "outside n": zero deltas, no store); nothing is padded.  Inputs or an
// output that do not start on 16 bytes (a view such as x[1:]) take the
// instance with scalar loads and stores at the same positions, the same
// arithmetic in the same order.
#include <cuda_runtime.h>
#include <cuda/atomic>
#include <cstdint>

#ifndef SBM_SWEEP_BLOCK
#define SBM_SWEEP_BLOCK 256
#endif
#ifndef SBM_SWEEP_ITEMS
#define SBM_SWEEP_ITEMS 16
#endif

namespace {

constexpr int BLOCK = SBM_SWEEP_BLOCK;    // threads a CTA
constexpr int WARPS = BLOCK / 32;
constexpr int ITEMS = SBM_SWEEP_ITEMS;    // endpoints a thread
constexpr int VECS = ITEMS / 4;           // int4 vectors a thread
constexpr int TILE = BLOCK * ITEMS;       // endpoints a CTA
static_assert(BLOCK % 32 == 0 && ITEMS % 4 == 0, "whole warps and int4s");
static_assert(TILE <= (1 << 14), "a tile's sums must fit 16-bit fields");

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long VALID = 1ull << 32;
using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

struct Descriptors {
  unsigned long long* agg;
  unsigned long long* pre_upd;
  unsigned long long* pre_sub;
};

__device__ __forceinline__ Descriptors descriptors(int* scratch, int ntiles) {
  unsigned long long* w = reinterpret_cast<unsigned long long*>(scratch + 2);
  return {w, w + ntiles, w + 2 * ntiles};
}

// (upd, sub) packed as upd + sub * 2^16: sums of packed pairs are the
// packed sums while both stay within +-2^15
__device__ __forceinline__ int2 unpack(int v) {
  const int upd = static_cast<short>(v & 0xffff);
  return make_int2(upd, (v - upd) >> 16);
}

__device__ __forceinline__ int2 add2(int2 a, int2 b) {
  return make_int2(a.x + b.x, a.y + b.y);
}

// endpoint code: bit 0 is_lo, bit 1 is_upd, bit 2 inside n
__device__ __forceinline__ int packed_delta(unsigned c) {
  const int sign = 2 * static_cast<int>(c & 1u) - 1;
  return (c & 4u) ? ((c & 2u) ? sign : sign * 65536) : 0;
}

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += a;
  }
  return v;
}

__device__ __forceinline__ int2 warp_sum(int2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(FULL, v.x, o);
    v.y += __shfl_xor_sync(FULL, v.y, o);
  }
  return v;
}

// Warp 0 of tile `tile` > 0: the sums of the deltas of every tile below
// it.  Lane l reads the descriptors of tile base - l; the window waits
// until each of its tiles has published something, then adds the
// aggregates of the tiles above the nearest published prefix and that
// prefix, or all 32 aggregates and steps 32 tiles down.
__device__ int2 look_back(const Descriptors& d, int tile, int lane) {
  int2 prefix = make_int2(0, 0);
  for (int base = tile - 1;; base -= 32) {
    const int p = base - lane;
    bool is_prefix, is_agg;
    int2 v;
    do {   // below tile 0 reads as a prefix of zero
      is_prefix = p < 0;
      is_agg = false;
      v = make_int2(0, 0);
      if (p >= 0) {
        const unsigned long long pu =
            Word(d.pre_upd[p]).load(cuda::memory_order_relaxed);
        const unsigned long long ps =
            Word(d.pre_sub[p]).load(cuda::memory_order_relaxed);
        const unsigned long long a =
            Word(d.agg[p]).load(cuda::memory_order_relaxed);
        is_prefix = (pu & ps & VALID) != 0;
        is_agg = (a & VALID) != 0;
        v = is_prefix ? make_int2(static_cast<int>(pu), static_cast<int>(ps))
                      : make_int2(static_cast<short>(a >> 16),
                                  static_cast<short>(a));
      }
    } while (__any_sync(FULL, !is_prefix && !is_agg));
    const unsigned done = __ballot_sync(FULL, is_prefix);
    const int stop = done ? __ffs(done) - 1 : 32;
    prefix = add2(prefix, warp_sum(lane <= stop ? v : make_int2(0, 0)));
    if (done) return prefix;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(BLOCK)
sbm_sweep_kernel(const int* __restrict__ is_lo, const int* __restrict__ is_upd,
                 int* __restrict__ out, int* __restrict__ scratch, long long n,
                 int ntiles) {
  __shared__ int s_tile;
  __shared__ int s_warp[WARPS];
  __shared__ int2 s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(scratch, 1);
  __syncthreads();
  const int tile = s_tile;

  // vector q of this lane: endpoints at + 128 q .. + 128 q + 3
  const long long at = (long long)tile * TILE + (long long)warp * 32 * ITEMS
                       + 4 * lane;
  unsigned code[VECS];     // four endpoint codes a word, a byte each
  int part[VECS];          // packed delta sum of each vector
#pragma unroll
  for (int q = 0; q < VECS; ++q) {
    const long long i = at + 128 * q;
    int lo[4], up[4], in[4];
    if (VEC && i + 4 <= n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(is_lo + i));
      const int4 b = __ldg(reinterpret_cast<const int4*>(is_upd + i));
      lo[0] = a.x; lo[1] = a.y; lo[2] = a.z; lo[3] = a.w;
      up[0] = b.x; up[1] = b.y; up[2] = b.z; up[3] = b.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) in[e] = 1;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        in[e] = i + e < n;
        lo[e] = in[e] ? __ldg(is_lo + i + e) : 0;
        up[e] = in[e] ? __ldg(is_upd + i + e) : 0;
      }
    }
    code[q] = 0;
    part[q] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned c = static_cast<unsigned>(lo[e] | (up[e] << 1) | (in[e] << 2));
      code[q] |= c << (8 * e);
      part[q] += packed_delta(c);
    }
  }

  // exclusive offset of each vector within the warp's span, and the
  // warp's total (packed)
  int warp_total = 0;
#pragma unroll
  for (int q = 0; q < VECS; ++q) {
    const int incl = warp_inclusive(part[q], lane);
    part[q] = warp_total + incl - part[q];
    warp_total += __shfl_sync(FULL, incl, 31);
  }
  if (lane == 0) s_warp[warp] = warp_total;
  __syncthreads();
  int before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int v = s_warp[w];
    if (w < warp) before += v;
    agg += v;
  }

  if (warp == 0) {
    const Descriptors d = descriptors(scratch, ntiles);
    const int2 a = unpack(agg);
    int2 prefix = make_int2(0, 0);
    if (tile > 0) {
      if (lane == 0)
        Word(d.agg[tile]).store(
            VALID | (static_cast<unsigned long long>(a.x & 0xffff) << 16) |
                static_cast<unsigned long long>(a.y & 0xffff),
            cuda::memory_order_relaxed);
      prefix = look_back(d, tile, lane);
    }
    if (lane == 0) {
      const int2 inc = add2(prefix, a);
      Word(d.pre_upd[tile]).store(VALID | static_cast<unsigned>(inc.x),
                                  cuda::memory_order_relaxed);
      Word(d.pre_sub[tile]).store(VALID | static_cast<unsigned>(inc.y),
                                  cuda::memory_order_relaxed);
      s_prefix = prefix;
    }
  }
  __syncthreads();

  const int2 tile_prefix = s_prefix;
#pragma unroll
  for (int q = 0; q < VECS; ++q) {
    // running active counts just before this vector's first endpoint
    int2 run = add2(tile_prefix, unpack(before + part[q]));
    int res[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned c = (code[q] >> (8 * e)) & 0xffu;
      const int d = packed_delta(c);
      const int2 dd = unpack(d);
      run = add2(run, dd);
      res[e] = (c & 1u) ? 0 : ((c & 2u) ? run.y : run.x);
    }
    const long long i = at + 128 * q;
    if (VEC && i + 4 <= n) {
      *reinterpret_cast<int4*>(out + i) = make_int4(res[0], res[1], res[2],
                                                    res[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i + e < n) out[i + e] = res[e];
    }
  }
}

}  // namespace

extern "C" {

int sbm_sweep_tile() { return TILE; }

const char* sbm_sweep_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// is_lo, is_upd, out: int32 (n,) on the device; scratch: int32
// (2 + 6 * ceil(n / TILE),), 8-byte aligned, any contents.  Zeroes the
// scratch, then launches the one kernel, both on `stream`; the vector
// instance when all three arrays start on 16 bytes.  Returns the first
// CUDA error, 0 on success.
int sbm_sweep_launch(const int* is_lo, const int* is_upd, int* out,
                     int* scratch, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(scratch) & 7)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (2 + 6 * ntiles) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = ((reinterpret_cast<uintptr_t>(is_lo) |
                     reinterpret_cast<uintptr_t>(is_upd) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec)
    sbm_sweep_kernel<true><<<(unsigned)ntiles, BLOCK, 0, s>>>(
        is_lo, is_upd, out, scratch, n, (int)ntiles);
  else
    sbm_sweep_kernel<false><<<(unsigned)ntiles, BLOCK, 0, s>>>(
        is_lo, is_upd, out, scratch, n, (int)ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
