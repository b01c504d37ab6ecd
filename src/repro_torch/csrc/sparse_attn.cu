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
// Both kernels take the q-block index from blockIdx (the TPU kernel took
// it as a blocked input because its grid prefix varied); nothing carries
// between CTAs.  The grid is (nq · ceil(bq / 64), BH): each CTA owns up to
// 64 rows of one q block and streams the walked keys in tiles of 64.  The
// tile size is the kernel's own, not bkv: the walk visits the same keys in
// the same order, and cutting it finer changes no result (a sentinel-only
// tile adds weight 1 per key only while the running max is still the
// sentinel, and the first real score zeroes all of it).  All tensor
// offsets are 64-bit (B·H·S·dh passes 2^31 at real batch sizes).  Shared
// memory above 48 KB is allowed by cudaFuncSetAttribute before each launch.
//
// bfloat16: sparse_attn_tc_kernel, on the tensor cores (mma.sync
// m16n8k16, bf16 in, float32 accumulate — the FlashAttention-2 shape).
// Four warps own 16 q rows each.  K and V tiles come by cp.async into a
// two-stage ring, the next tile in flight while this one is used; ldmatrix
// feeds K (for S = Q·Kᵀ) and V transposed (.trans, for P·V) to the
// products.  Q's fragments stay in registers for dh <= 128 and are read
// from shared memory per k-step above that.  dh is zero-padded to D16, a
// multiple of 16, in shared memory (exact: the pad adds 0 to every score),
// and rows are D16 + 8 elements apart so the eight 16-byte rows of each
// ldmatrix land in distinct banks (dh 80: 88).  The scores are scaled in
// float32 after the product, into the exp2 domain; the -1e30 sentinel and
// the absent keys' weight 0 (score -inf, only ever subtracted from a
// finite max) are applied only in tiles that straddle the diagonal, `end`,
// or the end of the walked range; interior tiles skip the mask.  P is
// rounded to bf16 for P·V, as FlashAttention's and SDPA's kernels do: the
// row sums stay in float32 and unrounded, so the output moves by at most
// 2^-8 · (sum of p·|v|) / l (bf16's unit roundoff) from the plain
// version's, which the tests hold.  Output rows are staged in shared memory and written 16 bytes at
// a time.
//
// float32: sparse_attn_kernel, on the CUDA cores (TF32 would change
// float32 results past the 2e-5 the tests hold).  256 threads as 16 × 16:
// thread (ty, tx) keeps rows ty + 16a (a < 4), the score columns tx + 16b
// (b < 4) and the output columns tx + 16e (e < ceil(dh / 16)); q is
// pre-scaled in shared memory; a row's max and sum reduce over 16 lanes of
// one warp by shuffles.  Row strides of dh + 4 floats keep the 16-byte
// shared loads of K free of bank conflicts for every dh that is a multiple
// of 8.  Shared memory is (3 · 64 · (dh + 4) + 64 · 80) · 4 bytes, 83 KB at
// dh 80 and 215 KB at dh 256.
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

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

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

// ---- bfloat16: tensor cores ------------------------------------------------

namespace tc {

constexpr int BR = 64;       // q rows per CTA, 16 per warp
constexpr int BC = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !in (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a · b, a 16x16 (row), b 16x8 (col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, the first in the low half (round to nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Tile j of the walk: sink tiles cover [0, hi0), window tiles [lo1, hi1);
// t0 is its first key and n the keys of the walk in it (<= BC).
struct Walk {
  long long hi0, lo1, hi1;
  int t_sink, tiles;
  __device__ void at(int j, long long& t0, int& n) const {
    const long long top = j < t_sink ? hi0 : hi1;
    t0 = j < t_sink ? (long long)j * BC : lo1 + (long long)(j - t_sink) * BC;
    n = (int)min((long long)BC, top - t0);
  }
};

template <int D16>
__global__ void __launch_bounds__(THREADS)
sparse_attn_tc_kernel(const Params p) {
  constexpr int LD = D16 + 8;      // shared row stride, in bf16
  constexpr int KT = D16 / 16;     // k-steps of Q·Kᵀ
  constexpr int NT = D16 / 8;      // 8-column tiles of the output
  constexpr bool QREG = D16 <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // BR x LD
  bf16* Ks = Qs + BR * LD;                         // 2 stages x BC x LD
  bf16* Vs = Ks + 2 * BC * LD;                     // 2 stages x BC x LD
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int dh = p.dh, c8 = dh >> 3;   // 16-byte chunks of a row

  const int i = blockIdx.x / p.sub;                 // q block
  const int r0 = (blockIdx.x - i * p.sub) * BR;     // first row in it
  const int rows = min(BR, p.bq - r0);
  const long long bh = blockIdx.y;
  const bf16* q = static_cast<const bf16*>(p.q) + bh * p.Sq * dh;
  const bf16* k = static_cast<const bf16*>(p.k) + bh * p.Skv * dh;
  const bf16* v = static_cast<const bf16*>(p.v) + bh * p.Skv * dh;
  bf16* out = static_cast<bf16*>(p.out) + bh * p.Sq * dh;
  const long long q0 = (long long)i * p.bq + r0;    // position of row 0

  // the pad columns [dh, D16) of every row, never written by cp.async
  if (dh < D16) {
    const int padc = (D16 - dh) >> 3;
    for (int e = tid; e < (BR + 4 * BC) * padc; e += THREADS) {
      const int r = e / padc, c = dh + (e - r * padc) * 8;
      *reinterpret_cast<uint4*>(Qs + r * LD + c) = make_uint4(0, 0, 0, 0);
    }
  }
  for (int e = tid; e < BR * c8; e += THREADS) {
    const int r = e / c8, c = (e - r * c8) * 8;
    const bool in = r < rows;
    cp_async16(smem_addr(Qs + r * LD + c), in ? q + (q0 + r) * dh + c : q,
               in);
  }
  cp_async_commit();

  const int end = p.ends[i];
  const long long bkv = p.bkv;
  const long long first = max(p.starts[i], p.sink_end) / p.bkv;
  long long nblk = ((long long)end - first * bkv + bkv - 1) / bkv;
  if (nblk < 0) nblk = 0;
  Walk w;
  w.hi0 = min((long long)(p.sink_end / p.bkv) * bkv, p.Skv);
  w.lo1 = first * bkv;
  w.hi1 = min(w.lo1 + nblk * bkv, p.Skv);
  w.t_sink = (int)((w.hi0 + BC - 1) / BC);
  w.tiles = w.t_sink + (w.hi1 > w.lo1 ? (int)((w.hi1 - w.lo1 + BC - 1) / BC)
                                      : 0);

  auto load_kv = [&](int j) {
    long long t0;
    int n;
    w.at(j, t0, n);
    bf16* kd = Ks + (j & 1) * BC * LD;
    bf16* vd = Vs + (j & 1) * BC * LD;
    for (int e = tid; e < BC * c8; e += THREADS) {
      const int r = e / c8, c = (e - r * c8) * 8;
      const bool in = r < n;
      const long long off = in ? (t0 + r) * dh + c : 0;
      cp_async16(smem_addr(kd + r * LD + c), k + off, in);
      cp_async16(smem_addr(vd + r * LD + c), v + off, in);
    }
  };

  const float sl2 = p.scale * LOG2E;
  const int wrow = warp * 16;      // this warp's first row in the CTA
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  uint32_t qf[QREG ? KT : 1][4];

  if (w.tiles > 0) load_kv(0);
  cp_async_commit();
  for (int j = 0; j < w.tiles; ++j) {
    if (j + 1 < w.tiles) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();   // Q and tile j have landed
    __syncthreads();
    const bf16* kb = Ks + (j & 1) * BC * LD;
    const bf16* vb = Vs + (j & 1) * BC * LD;
    const uint32_t qa = smem_addr(Qs + (wrow + (lane & 15)) * LD +
                                  (lane >> 4) * 8);
    if (QREG && j == 0) {
#pragma unroll
      for (int kt = 0; kt < (QREG ? KT : 1); ++kt)
        ldsm_x4(qf[kt], qa + kt * 32);
    }

    // S = Q·Kᵀ: eight 8-key tiles, rows g and g + 8 of the warp's 16
    float s[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
    const uint32_t ka = smem_addr(kb + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = qf[kt][x];
      } else {
        ldsm_x4(a, qa + kt * 32);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, ka + (jp * 16 * LD + kt * 16) * 2);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }

    long long t0;
    int n;
    w.at(j, t0, n);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] *= sl2;
    if (n < BC || t0 + n - 1 > q0 || t0 + n > end) {   // CTA-uniform
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = jn * 8 + 2 * t4 + (e & 1);
          const long long kv = t0 + c;
          const long long qpos = q0 + wrow + g + (e >> 1) * 8;
          if (c >= n)
            s[jn][e] = -__int_as_float(0x7f800000);   // -inf: not there, weight 0
          else if (kv > qpos || kv >= end)
            s[jn][e] = NEG_INF;
        }
    }

    // online softmax, rows g (h = 0) and g + 8 (h = 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        mx = fmaxf(mx, fmaxf(s[jn][2 * h], s[jn][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m_r[h], mx);
      const float alpha = exp2f(m_r[h] - mnew);
      m_r[h] = mnew;
      float ps = 0.f;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        s[jn][2 * h] = exp2f(s[jn][2 * h] - mnew);
        s[jn][2 * h + 1] = exp2f(s[jn][2 * h + 1] - mnew);
        ps += s[jn][2 * h] + s[jn][2 * h + 1];
      }
      l_r[h] = l_r[h] * alpha + ps;   // this thread's columns; summed at the end
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][2 * h] *= alpha;
        o[nt][2 * h + 1] *= alpha;
      }
    }

    // O += P·V, P from the score registers as bf16 A fragments
    const uint32_t va = smem_addr(vb + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, va + (kk * 16 * LD + np * 16) * 2);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // stage j & 1 is consumed before tile j + 2 lands in it
  }
  cp_async_wait<0>();
  __syncthreads();     // no copy into Qs is pending

  // out = O / l, staged in the warp's own rows of Qs, then 16-byte stores
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / (l > 0.f ? l : 1.f);
    bf16* row = Qs + (wrow + g + 8 * h) * LD + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(row + nt * 8) =
          pack_bf16(o[nt][2 * h] * inv, o[nt][2 * h + 1] * inv);
  }
  __syncwarp();
  for (int e = lane; e < 16 * c8; e += 32) {
    const int r = e / c8, c = (e - r * c8) * 8;
    if (wrow + r < rows)
      *reinterpret_cast<uint4*>(out + (q0 + wrow + r) * dh + c) =
          *reinterpret_cast<const uint4*>(Qs + (wrow + r) * LD + c);
  }
}

template <int D16>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  const int smem = (BR + 4 * BC) * (D16 + 8) * (int)sizeof(bf16);
  const cudaError_t e = cudaFuncSetAttribute(
      sparse_attn_tc_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  sparse_attn_tc_kernel<D16><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_dh(const Params& p, dim3 grid, cudaStream_t stream) {
  switch ((p.dh + 15) / 16) {
    case 1: return launch<16>(p, grid, stream);
    case 2: return launch<32>(p, grid, stream);
    case 3: return launch<48>(p, grid, stream);
    case 4: return launch<64>(p, grid, stream);
    case 5: return launch<80>(p, grid, stream);
    case 6: return launch<96>(p, grid, stream);
    case 7: return launch<112>(p, grid, stream);
    case 8: return launch<128>(p, grid, stream);
    case 9: return launch<144>(p, grid, stream);
    case 10: return launch<160>(p, grid, stream);
    case 11: return launch<176>(p, grid, stream);
    case 12: return launch<192>(p, grid, stream);
    case 13: return launch<208>(p, grid, stream);
    case 14: return launch<224>(p, grid, stream);
    case 15: return launch<240>(p, grid, stream);
    case 16: return launch<256>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

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
  const dim3 grid((unsigned)gx, (unsigned)BH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(tc::launch_dh(p, grid, s));
  const int smem =
      (int)(((BR + 2 * BC) * (dh + 4) + BR * PLD) * sizeof(float));
  return static_cast<int>(launch_dh<float>(p, grid, smem, s));
}

}  // extern "C"
