// K1 — SBM sweep: per-endpoint report counts over the lex-sorted stream.
//
// Replaces the Pallas kernel `_sweep_kernel` of the JAX package
// (src/repro/kernels/sbm_sweep.py:28).  For endpoint i of the sorted
// stream, with flags is_lo[i], is_upd[i] in {0, 1}:
//
//   d_upd[i] = is_upd * (is_lo ? +1 : -1)      d_sub[i] = (1-is_upd) * (same)
//   upd_active[i], sub_active[i] = inclusive prefix sums of d_upd, d_sub
//   out[i] = (1-is_lo) * ((1-is_upd) * upd_active[i] + is_upd * sub_active[i])
//
// The TPU kernel carried the two running totals in SMEM from one grid
// step to the next, which is legal only because a TPU grid runs in order.
// CTAs on Hopper run in no order, so the scan is three launches on the
// current stream (the paper's Alg. 7, one level down):
//   1. sweep_tile_sums:  each CTA reduces its TILE endpoints to (Σd_upd, Σd_sub);
//   2. sweep_tile_scan:  one CTA turns the tile sums into exclusive carries;
//   3. sweep_contribs:   each CTA rescans its tile seeded with its carry
//                        and writes the counts.
// The ragged tail is masked (zero deltas, no store); nothing is padded.
//
// Bound on the card: bytes.  Each endpoint is read as two int32 flags and
// written as one int32 (12 B); phase 1 reads the flags a second time, so
// the kernel moves 20 B per endpoint against the function's 12 B.  The
// per-endpoint work is a handful of integer operations, far below the
// H100's rate.  Loads and stores are coalesced: thread t of a CTA touches
// element base + r*BLOCK + t in round r.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;            // threads per CTA (8 warps)
constexpr int ROUNDS = 8;             // block-wide scan rounds per CTA
constexpr int TILE = BLOCK * ROUNDS;  // endpoints per CTA
constexpr int SCAN_BLOCK = 1024;      // threads of the single-CTA carry scan

__device__ __forceinline__ int2 add2(int2 a, int2 b) {
  return make_int2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ int2 warp_inclusive(int2 v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, v.x, o);
    const int b = __shfl_up_sync(0xffffffffu, v.y, o);
    if (lane >= o) { v.x += a; v.y += b; }
  }
  return v;
}

// Inclusive scan of v across the CTA; *total gets the CTA-wide sum.
// Every thread of the CTA must call it (it synchronises), and it ends
// with a barrier so the shared buffer can be reused by the next call.
__device__ int2 block_inclusive(int2 v, int2* total) {
  __shared__ int2 warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_inclusive(v);
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int2 s = lane < nwarps ? warp_sums[lane] : make_int2(0, 0);
    warp_sums[lane] = warp_inclusive(s);
  }
  __syncthreads();
  const int2 before = warp > 0 ? warp_sums[warp - 1] : make_int2(0, 0);
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return add2(v, before);
}

__device__ __forceinline__ int2 deltas(const int* __restrict__ is_lo,
                                       const int* __restrict__ is_upd,
                                       long long i, long long n) {
  if (i >= n) return make_int2(0, 0);
  const int sign = 2 * is_lo[i] - 1;
  const int up = is_upd[i];
  return make_int2(up * sign, (1 - up) * sign);
}

__global__ void __launch_bounds__(BLOCK)
sweep_tile_sums(const int* __restrict__ is_lo, const int* __restrict__ is_upd,
                long long n, int2* __restrict__ tile_sums) {
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x;
  int2 acc = make_int2(0, 0);
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r)
    acc = add2(acc, deltas(is_lo, is_upd, base + r * BLOCK, n));
  int2 total;
  block_inclusive(acc, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_BLOCK)
sweep_tile_scan(int2* __restrict__ tile_sums, int ntiles) {
  int2 carry = make_int2(0, 0);
  for (int base = 0; base < ntiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int2 v = i < ntiles ? tile_sums[i] : make_int2(0, 0);
    int2 total;
    const int2 incl = block_inclusive(v, &total);
    if (i < ntiles)
      tile_sums[i] = make_int2(carry.x + incl.x - v.x, carry.y + incl.y - v.y);
    carry = add2(carry, total);
  }
}

__global__ void __launch_bounds__(BLOCK)
sweep_contribs(const int* __restrict__ is_lo, const int* __restrict__ is_upd,
               long long n, const int2* __restrict__ tile_carry,
               int* __restrict__ out) {
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x;
  int2 run = tile_carry[blockIdx.x];
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + r * BLOCK;
    int2 total;
    const int2 incl =
        block_inclusive(deltas(is_lo, is_upd, i, n), &total);
    if (i < n) {
      const int lo = is_lo[i];
      const int up = is_upd[i];
      const int upd_active = run.x + incl.x;
      const int sub_active = run.y + incl.y;
      out[i] = (1 - lo) * ((1 - up) * upd_active + up * sub_active);
    }
    run = add2(run, total);
  }
}

}  // namespace

extern "C" {

int sbm_sweep_tile() { return TILE; }

const char* sbm_sweep_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// is_lo, is_upd, out: int32 (n,) on the device; tile_sums: int32
// (2 * ceil(n / TILE),) scratch.  Returns the first CUDA error, 0 on success.
int sbm_sweep_launch(const int* is_lo, const int* is_upd, int* out,
                     int* tile_sums, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* sums = reinterpret_cast<int2*>(tile_sums);
  sweep_tile_sums<<<(unsigned)ntiles, BLOCK, 0, s>>>(is_lo, is_upd, n, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_tile_scan<<<1, SCAN_BLOCK, 0, s>>>(sums, (int)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_contribs<<<(unsigned)ntiles, BLOCK, 0, s>>>(is_lo, is_upd, n, sums,
                                                    out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
