// K5 — streaming two-pass emit: K2's output, read from the compacted table.
//
// Replaces the Pallas kernel `_emit_stream_kernel` of the JAX package
// (src/repro/kernels/emit.py:307).  The wrapper compacts pass 1's emitter
// tables to the emitters with a non-zero count and packs them into one
// int32 (4, e_pad) table, rows: saturated slot offset, count, start rank
// into the partner permutation, original emitter id.  Pad entries carry
// offset INT32_MAX (above every slot id, so the table stays sorted even
// when offsets saturate at max_pairs = INT32_MAX), count 0 and id n + m.
//
// Zero-count emitters share their offset with a successor, so dropping
// them changes no slot's owner, and compacted offsets rise strictly below
// saturation: the bl slots of one tile select at most bl + 1 consecutive
// table entries.  The wrapper finds each tile's first entry with one
// library searchsorted and aligns it down to 128; the window of
// win = bl + 256 entries from that base covers every entry the tile can
// select.
//
// One CTA per tile of bl output slots: it stages the four rows of its
// window in shared memory (16 B per entry, 12 KB at bl = 512),
// binary-searches each slot's owner there (about 10 steps instead of K2's
// 20 over device memory), and gathers the partner from perm_s / perm_u in
// device memory.  Slot t belongs to the last entry k with offs[k] <= t;
// rank j = t - offs[k]; a class-A entry (id e < n) writes (e, perm_u[start
// + j]), a class-B entry (e, n + u) writes (perm_s[start + j], e - n);
// ranks at or past the count write (-1, -1).  Output is bit-identical to
// K2 and to the plain pass 2 (repro_torch.core.sbm._twopass_slots).
//
// The TPU kernel double-buffered the windows through VMEM with async DMA
// because its tables did not fit; here one cooperative load per CTA
// stages the window, and TMA or cp.async are later work.
//
// Bound on the card: bytes — every slot writes 8 B (one int2 store); the
// packed table is read once (16 B per entry) and each pair gathers one
// 4-byte partner.  At fig. 9 (K ~ 5e7) about 0.12 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;

__global__ void __launch_bounds__(BLOCK)
emit_stream_kernel(const int* __restrict__ tab, long long e_pad,
                   const int* __restrict__ base,
                   const int* __restrict__ perm_s,
                   const int* __restrict__ perm_u, int n, long long max_pairs,
                   int bl, int win, int2* __restrict__ out) {
  extern __shared__ int sw[];  // [4][win]: offsets, counts, starts, ids
  const long long tile = blockIdx.x;
  const long long b = base[tile];
  for (int x = threadIdx.x; x < win; x += BLOCK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) sw[r * win + x] = __ldg(tab + r * e_pad + b + x);
  }
  __syncthreads();
  const int* offs_w = sw;
  const int* cnt_w = sw + win;
  const int* start_w = sw + 2 * win;
  const int* id_w = sw + 3 * win;
  const long long t0 = tile * bl;
  for (int i = threadIdx.x; i < bl; i += BLOCK) {
    const long long slot = t0 + i;
    if (slot >= max_pairs) break;
    const int t = static_cast<int>(slot);  // max_pairs <= INT32_MAX
    // largest k in [0, win) with offs_w[k] <= t (0 if none)
    int lo = 0, hi = win - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (offs_w[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const int j = t - offs_w[lo];  // no overflow: t >= 0, offs <= INT32_MAX
    int2 pair = make_int2(-1, -1);
    if (j >= 0 && j < cnt_w[lo]) {
      const int r = start_w[lo] + j;
      const int e = id_w[lo];
      pair = e < n ? make_int2(e, __ldg(perm_u + r))
                   : make_int2(__ldg(perm_s + r), e - n);
    }
    out[slot] = pair;
  }
}

}  // namespace

extern "C" {

const char* emit_stream_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tab: int32 (4, e_pad); base: int32 (ceil(max_pairs / bl),) window bases
// with base + win <= e_pad; out: int32 (max_pairs, 2).  Returns the CUDA
// error, 0 on success; max_pairs == 0 launches nothing.
int emit_stream_launch(const int* tab, long long e_pad, const int* base,
                       const int* perm_s, const int* perm_u, int n, int m,
                       long long max_pairs, int bl, int win, int* out,
                       void* stream) {
  if (max_pairs <= 0) return 0;
  if (max_pairs > 0x7fffffffLL || n <= 0 || m <= 0 || bl <= 0 || win <= bl ||
      e_pad < win)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4LL * sizeof(int) * win;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        emit_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = (max_pairs + bl - 1) / bl;
  emit_stream_kernel<<<(unsigned)tiles, BLOCK, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      tab, e_pad, base, perm_s, perm_u, n, max_pairs, bl, win,
      reinterpret_cast<int2*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
