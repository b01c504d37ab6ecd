// K3 — brute-force matching (the paper's Algorithm 2) as tile counts.
//
// K3 replaces the Pallas kernel `_count_kernel` of the JAX package
// (src/repro/kernels/bfm.py:30); K4, its mask, is in bfm_mask.cu.  It
// tests the d-dimensional half-open overlap predicate
//
//   ok(i, j) = AND over k of  s_lo[i,k] < u_hi[j,k]  &&  u_lo[j,k] < s_hi[i,k]
//
// on float32 (n, d) / (m, d) row-major region bounds.
//
// K3 (bfm_tile_counts) writes the int32 count of every (ts x tu) tile,
// out[ti * (m/tu) + tj], for inputs the wrapper padded to tile multiples
// with non-matching sentinel regions (lo = +inf, hi = -inf: every compare
// against them is false; no fast-math flag is used, so that holds).  It
// stays brute force: every pair is tested.  Bound on the card: operations
// — n*m*2d float32 compares; at fig. 9 (n = m = 5e5, d = 1) that is 5e11,
// about 7.5 ms at the 67 TFLOP/s CUDA-core rate.  The bytes (the regions,
// once) are negligible.  What really limits it is instruction issue and
// the pipes behind it: each pair costs two compares and an add, three
// instructions, and an H100 issues about 3.3e13 lane-instructions/s (one
// a cycle per scheduler), about 23 ms at fig. 9; compares (FSETP) run on
// the ALU pipe, which cannot take one every cycle.  Two paths:
//
// * d1 (bfm_tile_counts_d1_kernel): d == 1, tu in {16, 32, ..., 512} (a
//   power-of-two multiple of C = 16), ts <= 4096.  fig. 9 and Koln
//   (ts = tu = 256) take it.  Each thread holds C adjacent U columns'
//   bounds in registers; a CTA of 256 threads covers a chunk of 4096 U
//   columns and keeps one S tile resident in shared memory, one 16-byte
//   broadcast load per row, so a shared load feeds C pairs.  Each pair is
//   three instructions: an FSETP form on the ALU pipe and an exact
//   saturating-FMA form on the FMA pipe, 10 of a thread's 16 columns in
//   the second, so both pipes work; the FMA form needs the bounds'
//   exponents within a range that the wrapper checks
//   (kernels/bfm.py:fma_scale), and without it all 16 columns take the
//   FSETP form.  The U chunk goes straight from L2 into registers: a
//   chunk is ~12k instructions of compare work per warp, which hides its
//   load.  A CTA walks a
//   contiguous run of (S tile, U chunk) items, S-tile major, so it
//   restages its S strip only when the S tile changes.  The tu / C
//   threads of one tile reduce their counts with shuffles and one of
//   them writes the tile's count: no atomics, no shared-memory reduction.
// * general (bfm_tile_counts_kernel): every other shape (d > 1, tu not
//   of that form or smaller than one register block, ts > 4096).  One CTA
//   per tile in a grid-stride loop over a 1-D grid, so no grid dimension
//   meets the 65535 limit (fig. 9 has 1954 x 1954 tiles).  The CTA stages
//   its S and U slices dimension-major in shared memory, each thread owns
//   CT adjacent U columns (held in registers when d == 1) and walks a
//   share of the S rows, and the CTA reduces its counts to one int32 (a
//   tile count is at most ts * tu).
//
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;     // K3 general path: threads per CTA
constexpr int CT = 4;          // K3 general path: U columns per thread item
constexpr int D1_THREADS = 256;                // K3 d1 path: threads per CTA
constexpr int D1_C = 16;                       // U columns per thread
constexpr int D1_CHUNK = D1_THREADS * D1_C;    // U columns per CTA pass
constexpr int D1_MAX_TS = 4096;                // S strip <= 64 KB of shared memory
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 226 * 1024;  // 227 KB less the static part

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// K3, the general path.
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

// K3, d == 1.  Each S row v = (s_lo, -s_lo·K, s_hi, 0) meets the thread's
// D1_C U columns at three instructions a pair, in two forms.  FSETP form,
// columns (a, b) = (u_lo, u_hi): setp, setp.and, predicated add — inline
// PTX, so the compiler cannot widen it into a select; its compares run on
// the ALU pipe.  FMA form, columns (a, b) = (-u_lo·K, u_hi):
// sat(u_hi·K - s_lo·K) is exactly [s_lo < u_hi] (1 at a gap of
// K·(u_hi - s_lo) >= 1, 0 at or below 0, and NaN — inf - inf — saturates
// to 0, as the compare is false), the same for [u_lo < s_hi], and a third
// FMA adds their product: all on the FMA pipe.  K = 2^k comes from the
// wrapper (kernels/bfm.py:fma_scale), which checks, with one read back to
// the host a call, that the bounds' exponents make every such product
// exact.  Either form alone is held at fig. 9 by its own pipe, so the MIXED
// instance puts the first NF = 10 of 16 columns in the FMA form and the
// rest in the FSETP form, and both pipes work at once (of the splits timed
// on the H100, 10 of 16 was the fastest); the other instance, all FSETP,
// runs where the wrapper finds no K.  Counts stay exact in float32 (a
// column counts at most ts <= 4096 pairs).  ptxas schedules this code with
// each add well behind the compares that feed it; rewrites that looked
// equivalent (each pair's FMAs as separate statements, K read from device
// memory into a uniform register, no minimum of 1 CTA per SM in the launch
// bounds) led it to place the add 1-3 instructions behind them, and the
// loop timed slower.  Check the SASS before changing the loop.
//
// Items are (S tile ti, U chunk cj), ti-major; CTA b walks items
// [b * per_cta, (b + 1) * per_cta).
template <bool MIXED>
__global__ void __launch_bounds__(D1_THREADS, 1)
bfm_tile_counts_d1_kernel(const float* __restrict__ s_lo,
                          const float* __restrict__ s_hi,
                          const float* __restrict__ u_lo,
                          const float* __restrict__ u_hi, int ts, int tu,
                          long long m, long long nchunks, long long nitems,
                          long long per_cta, float K,
                          int* __restrict__ out) {
  constexpr int NF = MIXED ? 10 : 0;
  extern __shared__ float4 strip[];   // S rows as (lo, -lo·K, hi, 0)
  const int group = tu / D1_C;        // threads of one U tile, 1..32
  const long long ntu = m / tu;
  const int tid = threadIdx.x;
  long long item = (long long)blockIdx.x * per_cta;
  const long long stop = min(item + per_cta, nitems);
  long long cur_ti = -1;
  for (; item < stop; ++item) {
    const long long ti = item / nchunks, cj = item - ti * nchunks;
    if (ti != cur_ti) {   // CTA-uniform
      __syncthreads();    // the previous strip's reads are done
      for (int i = tid; i < ts; i += D1_THREADS) {
        const float lo = s_lo[ti * ts + i];
        strip[i] = make_float4(lo, -lo * K, s_hi[ti * ts + i], 0.f);
      }
      __syncthreads();
      cur_ti = ti;
    }
    const long long j0 = cj * D1_CHUNK + (long long)tid * D1_C;
    // a warp covers 512 columns, whole tiles (tu divides 512, m % tu == 0):
    // a warp wholly past m has no tile to count
    if (j0 - (tid & 31) * D1_C >= m) continue;
    const bool in = j0 < m;   // else sentinel columns: nothing matches
    float a[D1_C], b[D1_C], acc[D1_C];
    int cnt[D1_C];
#pragma unroll
    for (int c = 0; c < D1_C; ++c) {
      const float lo = in ? u_lo[j0 + c] : inf_f();
      b[c] = in ? u_hi[j0 + c] : -inf_f();
      a[c] = c < NF ? (in ? -lo * K : -inf_f()) : lo;
      acc[c] = 0.f;
      cnt[c] = 0;
    }
#pragma unroll 8
    for (int r = 0; r < ts; ++r) {
      const float4 v = strip[r];
#pragma unroll
      for (int c = 0; c < D1_C; ++c) {
        if (c < NF) {
          asm("{\n\t.reg .f32 t, w;\n\t"
              "fma.rn.sat.f32 t, %1, %5, %2;\n\t"
              "fma.rn.sat.f32 w, %3, %5, %4;\n\t"
              "fma.rn.f32 %0, t, w, %0;\n\t}"
              : "+f"(acc[c])
              : "f"(b[c]), "f"(v.y), "f"(v.z), "f"(a[c]), "f"(K));
        } else {
          asm("{\n\t.reg .pred p;\n\t"
              "setp.lt.f32 p, %1, %2;\n\t"
              "setp.lt.and.f32 p, %3, %4, p;\n\t"
              "@p add.s32 %0, %0, 1;\n\t}"
              : "+r"(cnt[c])
              : "f"(v.x), "f"(b[c]), "f"(a[c]), "f"(v.z));
        }
      }
    }
    int total = 0;
#pragma unroll
    for (int c = 0; c < D1_C; ++c) total += cnt[c] + (int)acc[c];
    for (int o = group >> 1; o > 0; o >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, o);
    if (in && (tid & (group - 1)) == 0) out[ti * ntu + j0 / tu] = total;
  }
}

}  // namespace

extern "C" {

const char* bfm_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory a K3 CTA of the general path needs for (ts, tu, d); 0
// past the card's limit.
long long bfm_tile_counts_smem(int ts, int tu, int d) {
  const size_t bytes = 2 * sizeof(float) * (size_t)d * ((size_t)ts + tu);
  return bytes <= SMEM_MAX ? (long long)bytes : 0;
}

// 1 when (ts, tu, d) takes K3's d1 path, else 0: d == 1,
// tu = 16 * 2^k <= 512, ts <= 4096.
int bfm_tile_counts_d1_path(int ts, int tu, int d) {
  const int group = tu / D1_C;
  return d == 1 && ts >= 1 && ts <= D1_MAX_TS && tu % D1_C == 0 &&
         group >= 1 && group <= 32 && (group & (group - 1)) == 0;
}

// K3.  Inputs (n, d) and (m, d) float32 with n % ts == m % tu == 0 (the
// wrapper pads); out int32 (n/ts, m/tu); K the d1 path's FMA scale, 0 for
// its all-FSETP loop (the general path ignores it).  Returns the CUDA
// error, 0 on success.
int bfm_tile_counts_launch(const float* s_lo, const float* s_hi,
                           const float* u_lo, const float* u_hi, long long n,
                           long long m, int d, int ts, int tu, int* out,
                           float K, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || ts <= 0 || tu <= 0 || n % ts || m % tu)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bfm_tile_counts_d1_path(ts, tu, d)) {
    const auto kernel = K != 0.f ? bfm_tile_counts_d1_kernel<true>
                                 : bfm_tile_counts_d1_kernel<false>;
    const size_t smem = sizeof(float4) * (size_t)ts;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaSuccess;
    if (smem > SMEM_DEFAULT)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          D1_THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long nchunks = (m + D1_CHUNK - 1) / D1_CHUNK;
    const long long nitems = (n / ts) * nchunks;
    long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > nitems) grid = nitems;
    const long long per_cta = (nitems + grid - 1) / grid;
    grid = (nitems + per_cta - 1) / per_cta;
    kernel<<<(unsigned)grid, D1_THREADS, smem, st>>>(
        s_lo, s_hi, u_lo, u_hi, ts, tu, m, nchunks, nitems, per_cta, K, out);
    return static_cast<int>(cudaGetLastError());
  }
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
  bfm_tile_counts_kernel<<<(unsigned)grid, BLOCK, (size_t)smem, st>>>(
      s_lo, s_hi, u_lo, u_hi, d, ts, tu, ntu, ntiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
