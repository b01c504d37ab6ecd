// K6 — CSR decode: any window of the dense pass-2 buffer, on demand.
//
// Replaces the Pallas kernel `_csr_decode_kernel` of the JAX package
// (src/repro/kernels/emit.py:423).  The CSR emit route keeps only pass 1's
// compacted packed table (int32 (4, e_pad), rows: saturated slot offset,
// count, start rank, original emitter id; pads carry offset INT32_MAX) and
// the two lo-sort permutations: O(n + m) words, never the O(K) buffer.
// This kernel writes slots [w0, w0 + nslots) of the dense buffer:
//
//   k = the last table entry with offs[k] <= t,  j = t - offs[k]
//   j < count[k]:  (e, perm_u[start + j]) for a class-A entry e < n,
//                  (perm_s[start + j], e - n) for a class-B entry;
//   else (-1, -1),
//
// bit-identical to the same slice of K2's buffer.  One thread per slot in
// a grid-stride loop; the search runs over the whole table in device
// memory, so every level below the cached top of the search path is a
// dependent load.  w0 and nslots are runtime arguments: no window needs a
// build of its own.
//
// The TPU kernel copied one fixed-length permutation run per selected
// emitter by DMA, in ascending order so the slot's owner wrote last, and
// needed the permutations padded for the over-read.  A per-slot gather
// needs neither.
//
// The pad offset must exceed every slot id.  The reference pads with
// 1 << 30; once real offsets pass 2^30 (pass 1 saturates at max_pairs,
// which may be INT32_MAX) the table is no longer sorted and the search
// lands in the pads for slots >= 2^30.  INT32_MAX keeps it sorted.
//
// Bound on the card: bytes — 8 B written per slot, plus the table entries
// and partners read; nslots * 8 B at least.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
csr_decode_kernel(const int* __restrict__ tab, long long e_pad,
                  const int* __restrict__ perm_s,
                  const int* __restrict__ perm_u, int n, long long w0,
                  long long nslots, int2* __restrict__ out) {
  const int* offs = tab;
  const int* counts = tab + e_pad;
  const int* starts = tab + 2 * e_pad;
  const int* ids = tab + 3 * e_pad;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nslots; i += stride) {
    const int t = static_cast<int>(w0 + i);  // w0 + nslots <= INT32_MAX
    long long lo = 0, hi = e_pad - 1;
    while (lo < hi) {
      const long long mid = (lo + hi + 1) >> 1;
      if (__ldg(offs + mid) <= t) lo = mid; else hi = mid - 1;
    }
    const int j = t - __ldg(offs + lo);
    int2 pair = make_int2(-1, -1);
    if (j >= 0 && j < __ldg(counts + lo)) {
      const int r = __ldg(starts + lo) + j;
      const int e = __ldg(ids + lo);
      pair = e < n ? make_int2(e, __ldg(perm_u + r))
                   : make_int2(__ldg(perm_s + r), e - n);
    }
    out[i] = pair;
  }
}

}  // namespace

extern "C" {

const char* csr_decode_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tab: int32 (4, e_pad); out: int32 (nslots, 2).  Returns the CUDA error,
// 0 on success; nslots == 0 launches nothing.
int csr_decode_launch(const int* tab, long long e_pad, const int* perm_s,
                      const int* perm_u, int n, int m, long long w0,
                      long long nslots, int* out, void* stream) {
  if (nslots <= 0) return 0;
  if (w0 < 0 || w0 + nslots > 0x7fffffffLL || n <= 0 || m <= 0 || e_pad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (nslots + BLOCK - 1) / BLOCK;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  csr_decode_kernel<<<(unsigned)blocks, BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, e_pad, perm_s, perm_u, n, w0, nslots, reinterpret_cast<int2*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
