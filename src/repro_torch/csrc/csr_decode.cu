// K6 — CSR decode: any window of the dense pass-2 buffer, on demand.
//
// Replaces the Pallas kernel `_csr_decode_kernel` of the JAX package
// (src/repro/kernels/emit.py:423).  The CSR emit route keeps only pass 1's
// compacted packed table (int32 (4, e_pad), rows: saturated slot offset,
// count, start rank, original emitter id; pads carry offset INT32_MAX) and
// the two lo-sort permutations: O(n + m) words, never the O(K) buffer.
// This kernel writes slots [w0, w0 + nslots) of the dense buffer:
//
//   k = the last table entry with offs[k] <= t (0 if none),  j = t - offs[k]
//   0 <= j < count[k]:  (e, perm_u[start + j]) for a class-A entry e < n,
//                       (perm_s[start + j], e - n) for a class-B entry;
//   else (-1, -1),
//
// bit-identical to the same slice of K2's buffer.  w0 and nslots are
// runtime arguments: no window needs a build of its own.
//
// The offsets never decrease (compacted offsets rise strictly below
// saturation; entries past max_pairs share the offset max_pairs; pads
// sit at INT32_MAX), so the T consecutive slots of a tile [t0, t0 + T)
// select entries k0..k1 only, k0 the owner of t0 and k1 the owner of its
// last slot, and below saturation k1 - k0 <= T.  One CTA per tile of
// TILE = 2048 slots, as the TPU kernel took one table window per tile:
//
// 1. Warps 0 and 1 find k0 and k1 at once, each by a 32-ary search of the
//    offsets in device memory: the 32 lanes load 32 evenly spaced offsets
//    and a ballot narrows the range 32-fold, about 5 dependent loads for
//    e_pad ~ 2e6 instead of 21 per slot.
// 2. Staged tiles (k1 - k0 + 1 <= WMAX = TILE + 1 entries, every tile
//    below saturation): the four table rows of [k0, k1] go into shared
//    memory (16 B an entry).  Each staged entry k > k0 starts its run at
//    slot offs[k] in (t0, t0 + T): it writes k - k0 into owner[offs[k] -
//    t0] by atomicMax, so of a run of equal offsets the last entry wins,
//    as the search rule asks.  owner starts at 0 (entry k0).  A block-wide
//    inclusive max-scan over owner[0, T) then gives every slot its entry
//    in O(1): the load-balanced search of segmented expansion, and the
//    counterpart of the TPU kernel's ascending run copies.
// 3. Per-slot tiles (more than WMAX entries: only where offsets repeat,
//    in a tile that reaches max_pairs from below, t0 < max_pairs <= last
//    slot): each slot binary-searches [k0, k1] in device memory.
// 4. Output: each thread decodes two adjacent slots at a time, gathers
//    their partners (slots of one entry read consecutive perm words), and
//    writes both as one 16-byte store; a warp writes 512 contiguous bytes.
//
// Slot ids fit int32 (w0 + nslots <= INT32_MAX, checked at the launch);
// tile bounds are computed in 64 bits, since t0 + TILE may pass it.
//
// Bound on the card: bytes — 8 B written per slot and one 4-byte partner
// read, plus the table entries the tiles select; nslots * 12 B at least.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;
constexpr int TILE = 2048;            // slots per CTA
constexpr int PER = TILE / BLOCK;     // owner entries a thread scans
constexpr int WMAX = TILE + 1;        // table entries a tile may stage
constexpr unsigned FULL = 0xffffffffu;

// The last k in [lo, hi] with offs[k] <= t, or lo if there is none; one
// warp, every lane gets the result.  offs never decreases, so the lanes
// whose sample is <= t form a prefix of the warp.
__device__ long long search_warp(const int* __restrict__ offs, long long lo,
                                 long long hi, int t, int lane) {
  for (;;) {
    const long long span = hi - lo + 1;
    const long long stride = span <= 32 ? 1 : (span + 31) / 32;
    const long long p = lo + lane * stride;
    const unsigned le = __ballot_sync(FULL, p <= hi && __ldg(offs + p) <= t);
    if (le == 0) return lo;    // only at the first level: offs[lo] > t
    const long long last = lo + (31 - __clz(le)) * stride;
    if (stride == 1) return last;
    lo = last;
    hi = min(last + stride - 1, hi);
  }
}

// The last k in [lo, hi] with offs[k] <= t, or lo if there is none; one
// thread.
__device__ long long search_thread(const int* __restrict__ offs, long long lo,
                                   long long hi, int t) {
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (__ldg(offs + mid) <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int2 slot_pair(int t, int off, int cnt, int start,
                                          int e, int n,
                                          const int* __restrict__ perm_s,
                                          const int* __restrict__ perm_u) {
  const long long j = (long long)t - off;   // < 0 only when no entry <= t
  if (j < 0 || j >= cnt) return make_int2(-1, -1);
  const int r = start + (int)j;
  return e < n ? make_int2(e, __ldg(perm_u + r))
               : make_int2(__ldg(perm_s + r), e - n);
}

__global__ void __launch_bounds__(BLOCK)
csr_decode_kernel(const int* __restrict__ tab, long long e_pad,
                  const int* __restrict__ perm_s,
                  const int* __restrict__ perm_u, int n, long long w0,
                  long long nslots, int2* __restrict__ out) {
  __shared__ int s_win[4][WMAX];                   // offs, count, start, id
  __shared__ __align__(16) int s_owner[TILE];      // entry - k0 per slot
  __shared__ long long s_k[2];
  __shared__ int s_warp[BLOCK / 32];
  const int* offs = tab;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i0 = (long long)blockIdx.x * TILE;   // first slot - w0
  const int nt = (int)min((long long)TILE, nslots - i0);
  const long long t0 = w0 + i0;

  if (warp < 2) {
    const int t = (int)(t0 + (warp == 0 ? 0 : nt - 1));
    const long long k = search_warp(offs, 0, e_pad - 1, t, lane);
    if (lane == 0) s_k[warp] = k;
  }
  __syncthreads();
  const long long k0 = s_k[0], k1 = s_k[1];
  const long long W = k1 - k0 + 1;
  int2* dst = out + i0;

  if (W <= WMAX) {   // CTA-uniform: staged tile
    const int w = (int)W;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      for (int x = tid; x < w; x += BLOCK)
        s_win[r][x] = __ldg(tab + r * e_pad + k0 + x);
    for (int p = tid; p < TILE; p += BLOCK) s_owner[p] = 0;
    __syncthreads();
    for (int x = 1 + tid; x < w; x += BLOCK)   // offs in (t0, t0 + nt)
      atomicMax(&s_owner[(int)(s_win[0][x] - t0)], x);
    __syncthreads();
    // inclusive max-scan of owner: PER entries a thread, then the warp,
    // then the block
    int v[PER];
    const int4* own4 = reinterpret_cast<const int4*>(s_owner + tid * PER);
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const int4 a = own4[q];
      v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
    }
#pragma unroll
    for (int q = 1; q < PER; ++q) v[q] = max(v[q], v[q - 1]);
    int run = v[PER - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, run, o);
      if (lane >= o) run = max(run, y);
    }
    if (lane == 31) s_warp[warp] = run;
    int before = __shfl_up_sync(FULL, run, 1);
    if (lane == 0) before = 0;
    __syncthreads();   // s_warp written; every owner read done
    for (int x = 0; x < warp; ++x) before = max(before, s_warp[x]);
    int4* own4w = reinterpret_cast<int4*>(s_owner + tid * PER);
#pragma unroll
    for (int q = 0; q < PER / 4; ++q)
      own4w[q] = make_int4(max(v[4 * q], before), max(v[4 * q + 1], before),
                           max(v[4 * q + 2], before), max(v[4 * q + 3], before));
    __syncthreads();
    for (int p = 2 * tid; p < nt; p += 2 * BLOCK) {
      int2 pr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = s_owner[min(p + h, nt - 1)];
        pr[h] = slot_pair((int)(t0 + p + h), s_win[0][x], s_win[1][x],
                          s_win[2][x], s_win[3][x], n, perm_s, perm_u);
      }
      if (p + 1 < nt)
        *reinterpret_cast<int4*>(dst + p) =
            make_int4(pr[0].x, pr[0].y, pr[1].x, pr[1].y);
      else
        dst[p] = pr[0];
    }
  } else {   // per-slot tile: offsets repeat past max_pairs
    const int* counts = tab + e_pad;
    const int* starts = tab + 2 * e_pad;
    const int* ids = tab + 3 * e_pad;
    for (int p = 2 * tid; p < nt; p += 2 * BLOCK) {
      int2 pr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = (int)(t0 + min(p + h, nt - 1));
        const long long k = search_thread(offs, k0, k1, t);
        pr[h] = slot_pair(t, __ldg(offs + k), __ldg(counts + k),
                          __ldg(starts + k), __ldg(ids + k), n, perm_s,
                          perm_u);
      }
      if (p + 1 < nt)
        *reinterpret_cast<int4*>(dst + p) =
            make_int4(pr[0].x, pr[0].y, pr[1].x, pr[1].y);
      else
        dst[p] = pr[0];
    }
  }
}

}  // namespace

extern "C" {

const char* csr_decode_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Slots per CTA tile and the most table entries a tile stages (tiles
// that select more take the per-slot search).
int csr_decode_tile() { return TILE; }
int csr_decode_wmax() { return WMAX; }

// tab: int32 (4, e_pad) with non-decreasing offsets; out: int32
// (nslots, 2), 16-byte aligned.  Returns the CUDA error, 0 on success;
// nslots == 0 launches nothing.
int csr_decode_launch(const int* tab, long long e_pad, const int* perm_s,
                      const int* perm_u, int n, int m, long long w0,
                      long long nslots, int* out, void* stream) {
  if (nslots <= 0) return 0;
  if (w0 < 0 || w0 + nslots > 0x7fffffffLL || n <= 0 || m <= 0 ||
      e_pad <= 0 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (nslots + TILE - 1) / TILE;   // <= 2^20
  csr_decode_kernel<<<(unsigned)tiles, BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, e_pad, perm_s, perm_u, n, w0, nslots, reinterpret_cast<int2*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
