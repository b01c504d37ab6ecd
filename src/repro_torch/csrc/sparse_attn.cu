// K7 — DDM-planned block-sparse causal flash attention.
//
// Replaces the Pallas kernel `_kernel` of the JAX package
// (src/repro/kernels/sparse_attn.py:31, launched by `_sparse_attn_bh`).
// Inputs, for BH = batch·head slices:
//   q      (BH, Sq, dh)  float32 or bfloat16
//   k, v   (BH, Skv, dh) the same type
//   starts, ends int32 (Sq / bq,)  per-q-block kv window from the DDM
//          planner, shared by every head
// Query block i walks the sink_end / bkv sink blocks [0, bkv), [bkv, 2bkv),
// ..., then the window blocks from max(start, sink_end) / bkv · bkv up to
// `end`, in bkv steps.  A walked key counts when kv <= q and kv < end;
// otherwise it scores the finite sentinel -1e30 (never -inf: -inf - -inf
// is NaN, and the sentinel is what gives the reference's "mean of v" rows
// when a row meets no allowed key).  Keys at or past Skv are not there at
// all: their loads are masked and their weight is 0.  The softmax is
// online, in float32; the output is written in q's type.  The result is
// that of the plain version, repro_torch.kernels.ref.sparse_attn_bh.
//
// Bound on the card: operations.  Each allowed (query, key) pair (kv <= q,
// kv < end, in a walked block) costs 4 · dh FLOP per head (the two
// products); at Zamba2-2.7B's attention (32 heads, dh 80, S 32768, window
// 4096) that is ~1.3e12 FLOP, ~1.3 ms at the bf16 tensor-core rate, against
// ~0.67 GB of q/k/v/out (~0.2 ms at 3.35 TB/s).
//
// Design.  This first kernel runs on the CUDA cores in float32, so it sits
// far above that bound; tensor cores (mma.sync / wgmma) and TMA are later
// work.  The TPU kernel took its q-block index as a blocked input because
// its grid prefix varied; here blockIdx gives it, and nothing carries
// between CTAs.  The grid is (nq · ceil(bq / 64), BH): each CTA owns up to
// 64 rows of one q block, holds them (scaled) in shared memory, and streams
// the walked keys in tiles of 64 rows of K and V, converted to float32 in
// shared memory.  The tile size is the kernel's own, not bkv: the walk
// visits the same keys in the same order, and cutting it finer changes no
// result (a sentinel-only tile adds weight 1 per key only while the running
// max is still the sentinel, and the first real score zeroes all of it).
// 256 threads as 16 × 16: thread (ty, tx) keeps rows ty + 16a (a < 4), the
// score columns tx + 16b (b < 4) and the output columns tx + 16e
// (e < ceil(dh / 16)); a row's max and sum reduce over 16 lanes of one warp
// by shuffles.  Row strides of dh + 4 floats keep the 16-byte shared loads
// of K free of bank conflicts for every dh that is a multiple of 8.  All
// tensor offsets are 64-bit (B·H·S·dh passes 2^31 at real batch sizes).
// Shared memory is (3 · 64 · (dh + 4) + 64 · 80) · 4 bytes, 83 KB at dh 80
// and 215 KB at dh 256 (of the 227 KB a CTA may have), allowed by
// cudaFuncSetAttribute before each launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int BR = 64;          // q rows per CTA
constexpr int BC = 64;          // kv rows per tile
constexpr int PLD = BC + 16;    // row stride of the P tile (two half-warps
                                // land 16 banks apart)
constexpr int THREADS = 256;
constexpr int MAX_DH = 256;
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* starts;
  const int* ends;
  void* out;
  long long Sq, Skv;
  int dh, bq, bkv, sink_end, sub;  // sub: CTAs per q block
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float reduce16_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float reduce16_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NE>
__global__ void __launch_bounds__(THREADS)
sparse_attn_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int dh = p.dh;
  const int ld = dh + 4;
  const int d4 = dh >> 2;
  float* Qs = smem;             // BR x ld, pre-scaled q rows
  float* Ks = Qs + BR * ld;     // BC x ld
  float* Vs = Ks + BC * ld;     // BC x ld
  float* Ps = Vs + BC * ld;     // BR x PLD, this tile's weights
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  const int i = blockIdx.x / p.sub;                 // q block
  const int r0 = (blockIdx.x - i * p.sub) * BR;     // first row in it
  const int rows = min(BR, p.bq - r0);
  const long long bh = blockIdx.y;
  const T* q = static_cast<const T*>(p.q) + bh * p.Sq * dh;
  const T* k = static_cast<const T*>(p.k) + bh * p.Skv * dh;
  const T* v = static_cast<const T*>(p.v) + bh * p.Skv * dh;
  T* out = static_cast<T*>(p.out) + bh * p.Sq * dh;
  const long long q0 = (long long)i * p.bq + r0;    // position of row 0

  for (int e = tid; e < BR * d4; e += THREADS) {
    const int r = e / d4, c = (e - r * d4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      x = load4(q + (q0 + r) * dh + c);
      x.x *= p.scale; x.y *= p.scale; x.z *= p.scale; x.w *= p.scale;
    }
    *reinterpret_cast<float4*>(Qs + r * ld + c) = x;
  }

  const int end = p.ends[i];
  const long long bkv = p.bkv;
  const long long first = max(p.starts[i], p.sink_end) / p.bkv;
  long long nblk = ((long long)end - first * bkv + bkv - 1) / bkv;
  if (nblk < 0) nblk = 0;

  float m[4], l[4], acc[4][NE];
  long long qpos[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
    qpos[a] = q0 + ty + 16 * a;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[a][e] = 0.f;
  }

  // the sink blocks, then the window's blocks
  for (int part = 0; part < 2; ++part) {
    const long long lo = part == 0 ? 0 : first * bkv;
    long long hi = part == 0 ? (long long)(p.sink_end / p.bkv) * bkv
                             : lo + nblk * bkv;
    if (hi > p.Skv) hi = p.Skv;
    for (long long t0 = lo; t0 < hi; t0 += BC) {
      const int n = (int)min((long long)BC, hi - t0);   // walked keys
      __syncthreads();   // the previous tile's K, V and P are consumed
      for (int e = tid; e < BC * d4; e += THREADS) {
        const int r = e / d4, c = (e - r * d4) * 4;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (r < n) {
          kx = load4(k + (t0 + r) * dh + c);
          vx = load4(v + (t0 + r) * dh + c);
        }
        *reinterpret_cast<float4*>(Ks + r * ld + c) = kx;
        *reinterpret_cast<float4*>(Vs + r * ld + c) = vx;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
      for (int d = 0; d < dh; d += 4) {
        float4 qa[4], kb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          qa[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * ld + d);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          kb[b] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * b) * ld + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            s[a][b] = fmaf(qa[a].x, kb[b].x, s[a][b]);
            s[a][b] = fmaf(qa[a].y, kb[b].y, s[a][b]);
            s[a][b] = fmaf(qa[a].z, kb[b].z, s[a][b]);
            s[a][b] = fmaf(qa[a].w, kb[b].w, s[a][b]);
          }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float mx = NEG_INF;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = tx + 16 * b;
          const long long kv = t0 + c;
          const bool ok = c < n && kv <= qpos[a] && kv < end;
          if (!ok) s[a][b] = NEG_INF;
          mx = fmaxf(mx, s[a][b]);
        }
        const float mnew = fmaxf(m[a], reduce16_max(mx));
        const float alpha = expf(m[a] - mnew);
        float ps = 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = tx + 16 * b;
          const float w = c < n ? expf(s[a][b] - mnew) : 0.f;
          Ps[(ty + 16 * a) * PLD + c] = w;
          ps += w;
        }
        l[a] = l[a] * alpha + reduce16_sum(ps);
        m[a] = mnew;
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[a][e] *= alpha;
      }
      __syncwarp();   // a row's P is written and read by one half-warp

      for (int c = 0; c < n; ++c) {
        float pa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty + 16 * a) * PLD + c];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int d = tx + 16 * e;
          if (d < dh) {
            const float vv = Vs[c * ld + d];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][e] = fmaf(pa[a], vv, acc[a][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= rows) continue;
    const float inv = 1.f / (l[a] > 0.f ? l[a] : 1.f);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = tx + 16 * e;
      if (d < dh) store1(out + (q0 + r) * dh + d, acc[a][e] * inv);
    }
  }
}

template <typename T, int NE>
cudaError_t launch_typed(const Params& p, dim3 grid, int smem,
                         cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      sparse_attn_kernel<T, NE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  sparse_attn_kernel<T, NE><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, dim3 grid, int smem,
                      cudaStream_t stream) {
  switch ((p.dh + 15) / 16) {
    case 1: return launch_typed<T, 1>(p, grid, smem, stream);
    case 2: return launch_typed<T, 2>(p, grid, smem, stream);
    case 3: return launch_typed<T, 3>(p, grid, smem, stream);
    case 4: return launch_typed<T, 4>(p, grid, smem, stream);
    case 5: return launch_typed<T, 5>(p, grid, smem, stream);
    case 6: return launch_typed<T, 6>(p, grid, smem, stream);
    case 7: return launch_typed<T, 7>(p, grid, smem, stream);
    case 8: return launch_typed<T, 8>(p, grid, smem, stream);
    case 9: return launch_typed<T, 9>(p, grid, smem, stream);
    case 10: return launch_typed<T, 10>(p, grid, smem, stream);
    case 11: return launch_typed<T, 11>(p, grid, smem, stream);
    case 12: return launch_typed<T, 12>(p, grid, smem, stream);
    case 13: return launch_typed<T, 13>(p, grid, smem, stream);
    case 14: return launch_typed<T, 14>(p, grid, smem, stream);
    case 15: return launch_typed<T, 15>(p, grid, smem, stream);
    case 16: return launch_typed<T, 16>(p, grid, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* sparse_attn_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike).  Returns the CUDA
// error, 0 on success; shapes the kernel does not take (dh not a multiple
// of 8 in [8, 256], Sq not a multiple of bq, BH past gridDim.y) return
// cudaErrorInvalidValue without a launch.  Pointers are 16-byte aligned.
int sparse_attn_launch(const void* q, const void* k, const void* v,
                       const int* starts, const int* ends, void* out,
                       int dtype, long long BH, long long Sq, long long Skv,
                       int dh, int bq, int bkv, int sink_end, float scale,
                       void* stream) {
  if (dh < 8 || dh > MAX_DH || dh % 8 || bq < 1 || bkv < 1 ||
      sink_end < 0 || BH < 0 || BH > 65535 || Sq < 0 || Skv < 0 ||
      Sq > INT_MAX || Skv > INT_MAX || Sq % bq || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub = (bq + BR - 1) / BR;
  const long long gx = Sq / bq * sub;
  if (gx > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (gx == 0 || BH == 0) return 0;
  Params p{q, k, v, starts, ends, out, Sq, Skv, dh, bq, bkv, sink_end, sub,
           scale};
  const int smem =
      (int)(((BR + 2 * BC) * (dh + 4) + BR * PLD) * sizeof(float));
  const dim3 grid((unsigned)gx, (unsigned)BH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch_dh<float>(p, grid, smem, s)
                                   : launch_dh<__nv_bfloat16>(p, grid, smem, s);
  return static_cast<int>(e);
}

}  // extern "C"
