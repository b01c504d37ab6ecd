// The tile decode of pass 2, shared by K2 (csrc/emit.cu) and K5
// (csrc/emit_stream.cu).
//
// Both kernels write the (max_pairs, 2) pass-2 buffer: slot t belongs to
// the last table entry k with offs[k] <= t, its rank is j = t - offs[k],
// and the entry's (count, start, id) give the pair:
//   0 <= j < count:  (id, perm_u[start + j]) for a class-A id < n,
//                    (perm_s[start + j], id - n) for a class-B id;
//   else (-1, -1).
// They differ only in the table they read, which a table type (below)
// hides: K2 the uncompacted pass-1 tables (offs (E+1,), counts and starts
// (E,), the entry index is the emitter id; entry E is the sentinel at
// offset min(K, max_pairs) with count 0), K5 the compacted packed table
// (4, e_pad) of kernels/emit.py:pack_emitter_tables.
//
// The offsets never decrease, so the T consecutive slots of a tile
// [t0, t0 + nt) select only the entries k0..k1, k0 the owner of t0 and k1
// the owner of t0 + nt - 1.  One CTA of 256 threads decodes one tile:
//
// 1. Search.  Warps 0 and 1 find k0 and k1 at once, each by a 32-ary
//    search of the offsets in device memory (search_warp): 32 lanes load
//    32 evenly spaced offsets and a ballot narrows the range 32-fold,
//    about 4 dependent loads a tile for E ~ 1e6, instead of ~20 a slot.
//    (Four or eight loads a lane and level, a 128- or 256-ary search with
//    fewer levels, timed slower.)
// 2. Scatter.  Of a run of equal offsets (zero-count emitters share their
//    successor's offset; the sentinel shares the last offset) only the
//    run's last entry owns slots.  Each entry k in (k0, k1] that ends its
//    run writes k - k0 into owner[offs[k] - t0], a slot in (t0, t0 + nt);
//    run ends have distinct offsets, so each owner cell is written at
//    most once, by a plain store.  The offsets are read in coalesced
//    chunks of the block's width, so a tile may span many entries: the
//    uncompacted tables keep their zero-count emitters (about 42 entries
//    a 2048-slot tile at fig. 9, 4,200 at overlap degree 1).
// 3. Scan.  An inclusive max-scan over owner[0, nt) gives every slot its
//    entry in O(1): 8 cells a thread in registers, then the warp by
//    shuffles, then the block, 2048 cells a pass.
// 4. Decode and store.  Each thread decodes two adjacent slots and writes
//    them as one 16-byte store, so a warp writes 512 contiguous bytes.
//    The owner's (offset, count, start, id) come from shared memory when
//    the tile spans at most WMAX = 257 entries (staged before step 2),
//    else through __ldg (L1 serves neighbouring slots, which share
//    owners).  Every tile at fig. 9 and on Koln is staged.
//
// A tile that spans more than 16·T entries (long runs of zero-count
// emitters: one tile at overlap degree 0.01 spans half of a 1e6-entry
// table) skips steps 2-3: each slot binary-searches [k0, k1] in device
// memory, two slots a thread interleaved: streaming such a span through
// one CTA serialises it.
//
// Occupancy is what the kernel lives on: it is latency-bound (dependent
// search loads, then gathers, then stores), so __launch_bounds__ holds it
// to 32 registers for 8 CTAs (64 warps) an SM, and the window is capped
// at 257 entries so that 8 CTAs fit in shared memory at T = 4096.  A
// window of T + 1 entries, or the 48-56 registers ptxas picks unbounded,
// allowed 5-6 CTAs an SM and timed slower at fig. 9, as did a persistent
// variant whose warps 0-1 searched tile i + 1 while the other six
// decoded tile i.
//
// Slot ids fit int32 (max_pairs <= INT32_MAX, checked at the launch);
// tile bounds are computed in 64 bits, since t0 + T may pass it.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace emit_tile {

constexpr int BLOCK = 256;
constexpr int SEARCH_WARPS = 2;   // warps 0 and 1 search
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int PER = 8;            // owner cells a thread scans in registers
constexpr int WMAX = 257;         // the most entries a tile stages
constexpr int PERSLOT_SPAN = 16;  // spans over 16·T entries: per slot
constexpr int MIN_CTAS = 8;       // CTAs an SM (__launch_bounds__)

struct Entry {
  int off, cnt, start, id;
};

// K2's tables: offs (E+1,), counts and starts (E,); entry k is emitter k,
// entry E the sentinel (count 0).
struct Uncompacted {
  static constexpr int ROWS = 3;   // offs, counts, starts (the id is k)
  const int* __restrict__ offs;
  const int* __restrict__ counts;
  const int* __restrict__ starts;
  int E;

  __device__ long long size() const { return (long long)E + 1; }
  __device__ int off(long long k) const { return __ldg(offs + k); }
  __device__ int row(int r, long long k) const {
    if (r == 0) return __ldg(offs + k);
    if (k >= E) return 0;
    return __ldg((r == 1 ? counts : starts) + k);
  }
  __device__ Entry load(long long k) const {
    return {row(0, k), row(1, k), row(2, k), (int)k};
  }
  __device__ Entry staged(const int* w, int stride, int x,
                          long long k0) const {
    return {w[x], w[stride + x], w[2 * stride + x], (int)(k0 + x)};
  }
};

// K5's packed table: int32 (4, e_pad), rows offset, count, start, id.
struct Packed {
  static constexpr int ROWS = 4;
  const int* __restrict__ tab;
  long long e_pad;

  __device__ long long size() const { return e_pad; }
  __device__ int off(long long k) const { return __ldg(tab + k); }
  __device__ int row(int r, long long k) const {
    return __ldg(tab + r * e_pad + k);
  }
  __device__ Entry load(long long k) const {
    return {row(0, k), row(1, k), row(2, k), row(3, k)};
  }
  __device__ Entry staged(const int* w, int stride, int x,
                          long long) const {
    return {w[x], w[stride + x], w[2 * stride + x], w[3 * stride + x]};
  }
};

// The last k in [lo, hi] with off(k) <= t, or lo if there is none; one
// warp, every lane gets the result.  The offsets never decrease, so the
// lanes whose sample is <= t form a prefix of the warp.
template <class Tab>
__device__ long long search_warp(const Tab& tb, long long lo, long long hi,
                                 int t, int lane) {
  for (;;) {
    const long long span = hi - lo + 1;
    const long long stride = span <= 32 ? 1 : (span + 31) / 32;
    const long long p = lo + lane * stride;
    const unsigned le = __ballot_sync(FULL, p <= hi && tb.off(p) <= t);
    if (le == 0) return lo;    // only at the first level: off(lo) > t
    const long long last = lo + (31 - __clz(le)) * stride;
    if (stride == 1) return last;
    lo = last;
    hi = min(last + stride - 1, hi);
  }
}

__device__ __forceinline__ int2 slot_pair(int t, const Entry& e, int n,
                                          const int* __restrict__ perm_s,
                                          const int* __restrict__ perm_u) {
  const long long j = (long long)t - e.off;   // < 0 only if no entry <= t
  if (j < 0 || j >= e.cnt) return make_int2(-1, -1);
  const int r = e.start + (int)j;
  return e.id < n ? make_int2(e.id, __ldg(perm_u + r))
                  : make_int2(__ldg(perm_s + r), e.id - n);
}

// Dynamic shared memory of one CTA for tiles of T slots: the owner array
// and the staged window.
template <class Tab>
constexpr long long smem_bytes(long long T) {
  return 4 * T + 4LL * Tab::ROWS * WMAX;
}

// Slots [0, max_pairs) in tiles of T, one CTA per tile.
template <class Tab>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
emit_tiles_kernel(Tab tb, const int* __restrict__ perm_s,
                  const int* __restrict__ perm_u, int n, long long max_pairs,
                  int T, int2* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  int* s_owner = smem;          // [T]
  int* s_win = smem + T;        // [ROWS][WMAX]
  __shared__ long long s_k[2];
  __shared__ int s_wmax[BLOCK / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * T;
  const int nt = (int)min((long long)T, max_pairs - t0);

  // 1. warps 0 and 1 find the owners of the tile's first and last slot
  if (warp < SEARCH_WARPS) {
    const int t = (int)(t0 + (warp == 0 ? 0 : nt - 1));
    const long long k = search_warp(tb, 0, tb.size() - 1, t, lane);
    if (lane == 0) s_k[warp] = k;
  }
  __syncthreads();
  const long long k0 = s_k[0], k1 = s_k[1];
  const long long W = k1 - k0 + 1;
  const bool staged = W <= WMAX;   // CTA-uniform

  if (W > (long long)PERSLOT_SPAN * T) {   // CTA-uniform: per-slot search
    int2* dst = out + t0;
    for (int p = 2 * tid; p < nt; p += 2 * BLOCK) {
      const int ta = (int)(t0 + p), tb1 = (int)(t0 + min(p + 1, nt - 1));
      long long alo = k0, ahi = k1, blo = k0, bhi = k1;
      while (alo < ahi || blo < bhi) {   // two searches interleaved
        if (alo < ahi) {
          const long long mid = (alo + ahi + 1) >> 1;
          if (tb.off(mid) <= ta) alo = mid; else ahi = mid - 1;
        }
        if (blo < bhi) {
          const long long mid = (blo + bhi + 1) >> 1;
          if (tb.off(mid) <= tb1) blo = mid; else bhi = mid - 1;
        }
      }
      const int2 a = slot_pair(ta, tb.load(alo), n, perm_s, perm_u);
      const int2 b = slot_pair(tb1, tb.load(blo), n, perm_s, perm_u);
      if (p + 1 < nt)
        *reinterpret_cast<int4*>(dst + p) = make_int4(a.x, a.y, b.x, b.y);
      else
        dst[p] = a;
    }
    return;
  }

  for (int p = tid; p < nt; p += BLOCK) s_owner[p] = 0;
  if (staged) {
    const int w = (int)W;
    for (int r = 0; r < Tab::ROWS; ++r)
      for (int x = tid; x < w; x += BLOCK)
        s_win[r * WMAX + x] = tb.row(r, k0 + x);
  }
  __syncthreads();

  // 2. scatter: the last entry of each run marks the run's first slot
  if (staged) {
    const int w = (int)W;
    for (int x = 1 + tid; x < w; x += BLOCK) {
      const int o = s_win[x];
      if (x == w - 1 || s_win[x + 1] != o) s_owner[(int)(o - t0)] = x;
    }
  } else {
    for (long long x = 1 + tid; x < W; x += BLOCK) {
      const int o = tb.off(k0 + x);
      if (x == W - 1 || tb.off(k0 + x + 1) != o)
        s_owner[(int)(o - t0)] = (int)x;
    }
  }
  __syncthreads();

  // 3. inclusive max-scan of owner[0, nt): PER cells a thread in
  // registers, then the warp by shuffles, then the block; BLOCK * PER
  // cells a pass.  T is a multiple of PER, so a thread's cells lie all
  // inside the owner array or all past it; cells past nt (stale) only
  // raise cells past nt, which nothing reads.
  int carry = 0;
  for (int c0 = 0; c0 < nt; c0 += BLOCK * PER) {
    const int lo = c0 + tid * PER;
    const bool mine = lo < T;
    int v[PER];
#pragma unroll
    for (int q = 0; q < PER; q += 4) {
      const int4 a = mine ? *reinterpret_cast<const int4*>(s_owner + lo + q)
                          : make_int4(0, 0, 0, 0);
      v[q] = a.x; v[q + 1] = a.y; v[q + 2] = a.z; v[q + 3] = a.w;
    }
#pragma unroll
    for (int q = 1; q < PER; ++q) v[q] = max(v[q], v[q - 1]);
    int run = v[PER - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, run, o);
      if (lane >= o) run = max(run, y);
    }
    if (lane == 31) s_wmax[warp] = run;
    int before = __shfl_up_sync(FULL, run, 1);
    if (lane == 0) before = 0;
    __syncthreads();
    for (int x = 0; x < warp; ++x) before = max(before, s_wmax[x]);
    before = max(before, carry);
    if (mine) {
#pragma unroll
      for (int q = 0; q < PER; q += 4)
        *reinterpret_cast<int4*>(s_owner + lo + q) =
            make_int4(max(v[q], before), max(v[q + 1], before),
                      max(v[q + 2], before), max(v[q + 3], before));
    }
    for (int x = 0; x < BLOCK / 32; ++x) carry = max(carry, s_wmax[x]);
    __syncthreads();
  }

  // 4. decode two adjacent slots a thread, one 16-byte store
  int2* dst = out + t0;
  for (int p = 2 * tid; p < nt; p += 2 * BLOCK) {
    int2 pr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = min(p + h, nt - 1);
      const int x = s_owner[q];
      const Entry e = staged ? tb.staged(s_win, WMAX, x, k0)
                             : tb.load(k0 + x);
      pr[h] = slot_pair((int)(t0 + q), e, n, perm_s, perm_u);
    }
    if (p + 1 < nt)
      *reinterpret_cast<int4*>(dst + p) =
          make_int4(pr[0].x, pr[0].y, pr[1].x, pr[1].y);
    else
      dst[p] = pr[0];
  }
}

// Launch the decode of slots [0, max_pairs) in tiles of T slots (T a
// multiple of 8, out 16-byte aligned).  Returns the CUDA error,
// cudaErrorInvalidValue for arguments the kernel does not take.
template <class Tab>
cudaError_t launch(const Tab& tb, const int* perm_s, const int* perm_u,
                   int n, long long max_pairs, int T, int* out,
                   cudaStream_t stream) {
  if (T <= 0 || T % PER || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  const long long smem = smem_bytes<Tab>(T);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const long long tiles = (max_pairs + T - 1) / T;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        emit_tiles_kernel<Tab>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  emit_tiles_kernel<Tab><<<(unsigned)tiles, BLOCK, (size_t)smem, stream>>>(
      tb, perm_s, perm_u, n, max_pairs, T, reinterpret_cast<int2*>(out));
  return cudaGetLastError();
}

}  // namespace emit_tile
