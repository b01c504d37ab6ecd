// K3 and K4 — brute-force matching (the paper's Algorithm 2) as tiles.
//
// K3 replaces the Pallas kernel `_count_kernel` of the JAX package
// (src/repro/kernels/bfm.py:30), K4 its `_mask_kernel` (:43).  Both test
// the d-dimensional half-open overlap predicate
//
//   ok(i, j) = AND over k of  s_lo[i,k] < u_hi[j,k]  &&  u_lo[j,k] < s_hi[i,k]
//
// on float32 (n, d) / (m, d) row-major region bounds.
//
// K3 (bfm_tile_counts) writes the int32 count of every (ts x tu) tile,
// out[ti * (m/tu) + tj], for inputs the wrapper padded to tile multiples
// with non-matching sentinel regions (lo = +inf, hi = -inf: every compare
// against them is false; no fast-math flag is used, so that holds).  One
// CTA per tile, in a grid-stride loop over a 1-D grid, so no grid
// dimension meets the 65535 limit (fig. 9 has 1954 x 1954 tiles).  The CTA
// stages its S and U slices dimension-major in shared memory, each thread
// owns CT adjacent U columns (held in registers when d == 1) and walks a
// share of the S rows, and the CTA reduces its counts to one int32 (a
// tile count is at most ts * tu).  Bound on the card: operations — n*m*2d
// float32 compares; at fig. 9 (n = m = 5e5, d = 1) that is 5e11, about
// 7.5 ms at the 67 TFLOP/s CUDA-core rate.  The bytes (the regions, once)
// are negligible.
//
// K4 (bfm_mask) writes the full (n, m) bool mask, one byte per pair, for
// any n and m: the ragged edge is masked here, so nothing is padded or
// trimmed and the mask comes out contiguous.  A CTA covers MASK_ROWS rows
// and MASK_TX * V columns; each thread keeps V adjacent columns' dimension-0
// bounds in registers and writes V bytes of a row as one V-byte store (V
// is the largest of 16, 8, 4, 2, 1 that divides m, so every store is
// aligned), so a warp writes 32 * V contiguous bytes of a row.  Bound on
// the card: bytes — n*m written; at the mask phase's size (n = m = 4e4)
// that is 1.6 GB, about 0.48 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;     // K3 threads per CTA
constexpr int CT = 4;          // K3 U columns per thread item
constexpr int MASK_TX = 64;    // K4 column threads
constexpr int MASK_TY = 4;     // K4 row threads
constexpr int MASK_ROWS = 64;  // K4 rows per CTA
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 226 * 1024;  // 227 KB less the static part

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__global__ void __launch_bounds__(BLOCK)
bfm_tile_counts_kernel(const float* __restrict__ s_lo,
                       const float* __restrict__ s_hi,
                       const float* __restrict__ u_lo,
                       const float* __restrict__ u_hi, int d, int ts, int tu,
                       long long ntu, long long ntiles,
                       int* __restrict__ out) {
  extern __shared__ float smem[];
  float* sl = smem;                       // [d][ts]
  float* sh = sl + (size_t)d * ts;        // [d][ts]
  float* ul = sh + (size_t)d * ts;        // [d][tu]
  float* uh = ul + (size_t)d * tu;        // [d][tu]
  __shared__ int warp_sums[BLOCK / 32];

  const int groups = (tu + CT - 1) / CT;
  const int phases = groups >= BLOCK ? 1 : BLOCK / groups;
  const int items = phases * groups;
  const int s_elems = ts * d, u_elems = tu * d;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long ti = tile / ntu, tj = tile % ntu;
    const float* gsl = s_lo + ti * s_elems;
    const float* gsh = s_hi + ti * s_elems;
    const float* gul = u_lo + tj * u_elems;
    const float* guh = u_hi + tj * u_elems;
    __syncthreads();  // the previous tile's shared reads are done
    for (int x = threadIdx.x; x < s_elems; x += BLOCK) {
      const int i = x / d, k = x - i * d;
      sl[k * ts + i] = gsl[x];
      sh[k * ts + i] = gsh[x];
    }
    for (int x = threadIdx.x; x < u_elems; x += BLOCK) {
      const int j = x / d, k = x - j * d;
      ul[k * tu + j] = gul[x];
      uh[k * tu + j] = guh[x];
    }
    __syncthreads();

    int cnt = 0;
    for (int it = threadIdx.x; it < items; it += BLOCK) {
      const int g = it % groups, p = it / groups;
      const int j0 = g * CT;
      if (d == 1) {
        float a[CT], b[CT];  // this item's U columns, lo and hi
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const bool in = j0 + c < tu;
          a[c] = in ? ul[j0 + c] : inf_f();
          b[c] = in ? uh[j0 + c] : -inf_f();
        }
        for (int i = p; i < ts; i += phases) {
          const float lo = sl[i], hi = sh[i];
#pragma unroll
          for (int c = 0; c < CT; ++c) cnt += (lo < b[c]) & (a[c] < hi);
        }
      } else {
        for (int i = p; i < ts; i += phases) {
          bool ok[CT];
#pragma unroll
          for (int c = 0; c < CT; ++c) ok[c] = j0 + c < tu;
          for (int k = 0; k < d; ++k) {
            const float lo = sl[k * ts + i], hi = sh[k * ts + i];
#pragma unroll
            for (int c = 0; c < CT; ++c) {
              if (j0 + c < tu) {
                const int j = k * tu + j0 + c;
                ok[c] = ok[c] & (lo < uh[j]) & (ul[j] < hi);
              }
            }
          }
#pragma unroll
          for (int c = 0; c < CT; ++c) cnt += ok[c];
        }
      }
    }

    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = cnt;
    __syncthreads();
    if (threadIdx.x < 32) {
      int v = threadIdx.x < BLOCK / 32 ? warp_sums[threadIdx.x] : 0;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (threadIdx.x == 0) out[tile] = v;
    }
  }
}

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

template <int V>
__global__ void __launch_bounds__(MASK_TX * MASK_TY)
bfm_mask_kernel(const float* __restrict__ s_lo, const float* __restrict__ s_hi,
                const float* __restrict__ u_lo, const float* __restrict__ u_hi,
                long long n, long long m, int d, long long row_tiles,
                uint8_t* __restrict__ out) {
  const long long c0 = ((long long)blockIdx.x * MASK_TX + threadIdx.x) * V;
  if (c0 >= m) return;  // no barrier below
  float a[V], b[V];     // dimension 0 of this thread's V columns
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool in = c0 + v < m;
    a[v] = in ? u_lo[(c0 + v) * d] : inf_f();
    b[v] = in ? u_hi[(c0 + v) * d] : -inf_f();
  }
  for (long long rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    for (int i = threadIdx.y; i < MASK_ROWS; i += MASK_TY) {
      const long long r = rt * MASK_ROWS + i;
      if (r >= n) break;
      const float lo = s_lo[r * d], hi = s_hi[r * d];
      bool ok[V];
#pragma unroll
      for (int v = 0; v < V; ++v) ok[v] = (lo < b[v]) & (a[v] < hi);
      for (int k = 1; k < d; ++k) {
        const float lo_k = s_lo[r * d + k], hi_k = s_hi[r * d + k];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (c0 + v < m) {
            const long long x = (c0 + v) * d + k;
            ok[v] = ok[v] & (lo_k < u_hi[x]) & (u_lo[x] < hi_k);
          }
        }
      }
      uint8_t* dst = out + r * m + c0;
      if (c0 + V <= m) {
        store_bytes<V>(dst, ok);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (c0 + v < m) dst[v] = ok[v];
      }
    }
  }
}

template <int V>
int launch_mask(const float* s_lo, const float* s_hi, const float* u_lo,
                const float* u_hi, long long n, long long m, int d,
                uint8_t* out, cudaStream_t stream) {
  const long long col_blocks = (m + (long long)MASK_TX * V - 1) /
                               ((long long)MASK_TX * V);
  const long long row_tiles = (n + MASK_ROWS - 1) / MASK_ROWS;
  if (col_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)col_blocks,
                  (unsigned)(row_tiles < 65535 ? row_tiles : 65535));
  bfm_mask_kernel<V><<<grid, dim3(MASK_TX, MASK_TY), 0, stream>>>(
      s_lo, s_hi, u_lo, u_hi, n, m, d, row_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* bfm_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory a K3 CTA needs for (ts, tu, d); 0 past the card's limit.
long long bfm_tile_counts_smem(int ts, int tu, int d) {
  const size_t bytes = 2 * sizeof(float) * (size_t)d * ((size_t)ts + tu);
  return bytes <= SMEM_MAX ? (long long)bytes : 0;
}

// K3.  Inputs (n, d) and (m, d) float32 with n % ts == m % tu == 0 (the
// wrapper pads); out int32 (n/ts, m/tu).  Returns the CUDA error, 0 on
// success.
int bfm_tile_counts_launch(const float* s_lo, const float* s_hi,
                           const float* u_lo, const float* u_hi, long long n,
                           long long m, int d, int ts, int tu, int* out,
                           void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || ts <= 0 || tu <= 0 || n % ts || m % tu)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = bfm_tile_counts_smem(ts, tu, d);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((size_t)smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        bfm_tile_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long ntu = m / tu;
  const long long ntiles = (n / ts) * ntu;
  const long long grid = ntiles < (1LL << 22) ? ntiles : (1LL << 22);
  bfm_tile_counts_kernel<<<(unsigned)grid, BLOCK, (size_t)smem,
                           static_cast<cudaStream_t>(stream)>>>(
      s_lo, s_hi, u_lo, u_hi, d, ts, tu, ntu, ntiles, out);
  return static_cast<int>(cudaGetLastError());
}

// K4.  Inputs (n, d) and (m, d) float32, any n, m >= 1; out bool (n, m).
int bfm_mask_launch(const float* s_lo, const float* s_hi, const float* u_lo,
                    const float* u_hi, long long n, long long m, int d,
                    unsigned char* out, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m % 16 == 0) return launch_mask<16>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
  if (m % 8 == 0) return launch_mask<8>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
  if (m % 4 == 0) return launch_mask<4>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
  if (m % 2 == 0) return launch_mask<2>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
  return launch_mask<1>(s_lo, s_hi, u_lo, u_hi, n, m, d, out, st);
}

}  // extern "C"
