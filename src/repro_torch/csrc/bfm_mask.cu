// K4 — brute-force overlap mask (the paper's Algorithm 2, every pair).
//
// Replaces the Pallas kernel `_mask_kernel` of the JAX package
// (src/repro/kernels/bfm.py:43).  Writes the full (n, m) bool mask
//
//   out[i, j] = AND over k of  s_lo[i,k] < u_hi[j,k]  &&  u_lo[j,k] < s_hi[i,k]
//
// for float32 (n, d) / (m, d) row-major bounds, any n, m, d >= 1, one byte
// per pair, contiguous: the ragged edge is masked here, nothing is padded
// or trimmed.  No fast-math flag is used, so ±inf and subnormal bounds
// compare exactly.
//
// Bound on the card: bytes — n*m written; at the mask phase's size
// (n = m = 4e4) 1.6 GB, about 0.48 ms at 3.35 TB/s.  The compares cost
// about 0.2 ms of issue there, so the write path is what limits it.
//
// Design.  Persistent CTAs of 256 threads, as many as fit on the SMs,
// walk work items (column block, row tile) in a grid-stride loop over a
// 1-D grid, so no grid dimension meets the 65535 limit.  A column block
// is COLS = 4096 columns; each thread owns 16 of them and keeps their
// bounds in registers, dimension 0 (d == 1) or dimensions 0 and 1
// (d >= 2), loaded once per column block; dimensions 2 and up (d >= 3,
// only in tests) are read per row through L1.  A row tile is ROWS = 32
// rows; its S bounds (the register dimensions) are staged once per tile
// in shared memory, double-buffered so that one barrier a tile suffices,
// and no thread loads a bound from device memory per row.  Thread t's 16
// columns are interleaved in chunks of V bytes, V the largest of 16, 8,
// 4, 2, 1 that divides m (so every store is aligned): chunk q holds
// columns q*256*V + t*V ... + V - 1 of the block, and a warp writes 32*V
// contiguous bytes of a row with one V-byte store per thread, its
// predicates packed four to a 32-bit word.
//
// What the H100 chose (PERF.md): a variant that packed 8-row tiles
// into shared memory and stored them row by row with cp.async.bulk, so
// that the copy engine and not the threads wrote the mask, was slower at
// the mask phase's shape at d = 1 and d = 2 (its 96 KB ring allows 2 CTAs
// an SM, and its second barrier a tile stalls the compares).  Of the
// direct-store variants timed, 32-row tiles with plain write-back stores
// were the fastest: smaller tiles were slower at d = 2, and streaming
// stores (st.global.cs) were within 1 % at d = 1 but 1.3x slower at d = 2.
//
// Columns at or past m get non-matching bounds (lo = +inf, hi = -inf) and
// are not stored; rows at or past n are not stored.  Offsets are 64-bit:
// n*m may pass 2^31.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int CPT = 16;                     // columns per thread
constexpr int COLS = THREADS * CPT;         // columns per block, 4096
constexpr int ROWS = 32;                    // rows per tile

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t pack4(const bool* ok) {
  return (uint32_t)ok[0] | (uint32_t)ok[1] << 8 | (uint32_t)ok[2] << 16 |
         (uint32_t)ok[3] << 24;
}

// one aligned V-byte store of V adjacent mask bytes
template <int V>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const bool* ok) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack4(ok), pack4(ok + 4), pack4(ok + 8), pack4(ok + 12));
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack4(ok), pack4(ok + 4));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(dst) = pack4(ok);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        (uint16_t)((uint32_t)ok[0] | (uint32_t)ok[1] << 8);
  } else {
    *dst = ok[0];
  }
}

// V: bytes a store writes; NREG: the dimensions held in registers,
// min(d, 2).
template <int V, int NREG>
__global__ void __launch_bounds__(THREADS, 2)
bfm_mask_kernel(const float* __restrict__ s_lo, const float* __restrict__ s_hi,
                const float* __restrict__ u_lo, const float* __restrict__ u_hi,
                long long n, long long m, int d, long long col_blocks,
                long long nitems, uint8_t* __restrict__ out) {
  static_assert(2 * NREG * ROWS <= THREADS, "one thread stages one bound");
  __shared__ float s_b[2][2 * NREG][ROWS];   // [parity][lo, hi per dim][row]
  const int tid = threadIdx.x;
  // column of register slot c: chunk c / V at q * 256 * V + tid * V
  auto col_of = [&](int c) {
    return (long long)(c / V) * (THREADS * V) + tid * V + (c % V);
  };
  float ua[NREG][CPT], ub[NREG][CPT];   // this thread's U lo, hi
  long long cur_cb = -1;
  int parity = 0;
  for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
    const long long cb = item % col_blocks, rt = item / col_blocks;
    const long long c_base = cb * COLS;
    if (cb != cur_cb) {   // CTA-uniform; registers only, no barrier
      cur_cb = cb;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const long long j = c_base + col_of(c);
#pragma unroll
        for (int k = 0; k < NREG; ++k) {
          ua[k][c] = j < m ? u_lo[j * d + k] : inf_f();
          ub[k][c] = j < m ? u_hi[j * d + k] : -inf_f();
        }
      }
    }
    const long long r0 = rt * ROWS;
    const int rows = (int)(n - r0 < ROWS ? n - r0 : ROWS);
    // stage this tile's S bounds into the buffer the previous tile did
    // not read; that tile's barrier orders every read of this buffer
    // (two tiles back) before these writes
    if (tid < 2 * NREG * ROWS) {
      const int r = tid % ROWS, x = tid / ROWS, k = x >> 1;
      const float* src = (x & 1) ? s_hi : s_lo;
      s_b[parity][x][r] = r < rows ? src[(r0 + r) * d + k] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      bool ok[CPT];
      const float lo0 = s_b[parity][0][r], hi0 = s_b[parity][1][r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) ok[c] = (lo0 < ub[0][c]) & (ua[0][c] < hi0);
      if constexpr (NREG == 2) {
        const float lo1 = s_b[parity][2][r], hi1 = s_b[parity][3][r];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          ok[c] = ok[c] & (lo1 < ub[1][c]) & (ua[1][c] < hi1);
        for (int k = 2; k < d; ++k) {   // d >= 3: through L1
          const float lo_k = s_lo[(r0 + r) * d + k];
          const float hi_k = s_hi[(r0 + r) * d + k];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const long long j = c_base + col_of(c);
            if (j < m)
              ok[c] = ok[c] & (lo_k < u_hi[j * d + k]) & (u_lo[j * d + k] < hi_k);
          }
        }
      }
      uint8_t* row = out + (r0 + r) * m + c_base;
#pragma unroll
      for (int q = 0; q < CPT / V; ++q) {
        const long long j = (long long)q * (THREADS * V) + tid * V;
        if (c_base + j < m) store_bytes<V>(row + j, ok + q * V);  // V | m
      }
    }
    parity ^= 1;
  }
}

template <int V, int NREG>
int launch(const float* s_lo, const float* s_hi, const float* u_lo,
           const float* u_hi, long long n, long long m, int d, uint8_t* out,
           cudaStream_t stream) {
  const auto kernel = bfm_mask_kernel<V, NREG>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long col_blocks = (m + COLS - 1) / COLS;
  const long long nitems = col_blocks * ((n + ROWS - 1) / ROWS);
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  // a multiple of col_blocks keeps each CTA on one column block, so it
  // loads its U bounds once
  if (col_blocks <= grid) grid -= grid % col_blocks;
  if (grid > nitems) grid = nitems;
  kernel<<<(unsigned)grid, THREADS, 0, stream>>>(
      s_lo, s_hi, u_lo, u_hi, n, m, d, col_blocks, nitems, out);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_d(const float* s_lo, const float* s_hi, const float* u_lo,
             const float* u_hi, long long n, long long m, int d, uint8_t* out,
             cudaStream_t st) {
  return d == 1 ? launch<V, 1>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st)
                : launch<V, 2>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
}

}  // namespace

extern "C" {

const char* bfm_mask_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4.  Inputs (n, d) and (m, d) float32, any n, m, d >= 1; out bool (n, m),
// 16-byte aligned.  Returns the CUDA error, 0 on success.
int bfm_mask_launch(const float* s_lo, const float* s_hi, const float* u_lo,
                    const float* u_hi, long long n, long long m, int d,
                    unsigned char* out, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m % 16 == 0) return launch_d<16>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
  if (m % 8 == 0) return launch_d<8>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
  if (m % 4 == 0) return launch_d<4>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
  if (m % 2 == 0) return launch_d<2>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
  return launch_d<1>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
}

}  // extern "C"
