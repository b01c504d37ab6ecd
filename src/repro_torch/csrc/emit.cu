// K2 — two-pass emit, pass 2: write every output slot's (s, u) pair.
//
// Replaces the resident Pallas kernel `_emit_kernel` of the JAX package
// (src/repro/kernels/emit.py:185).  Pass 1 (sorts, searchsorted, the
// saturated offset scan) stays in library calls; this kernel takes its
// tables:
//   offs   int32 (E+1,)  exclusive slot offsets, saturated at max_pairs
//   counts int32 (E,)    unclipped per-emitter pair counts
//   starts int32 (E,)    per-emitter start rank into the partner permutation
//   perm_s int32 (n,), perm_u int32 (m,)   lo-sort permutations, E = n + m
// Slot t belongs to the last emitter e with offs[e] <= t; its rank is
// j = t - offs[e].  A class-A emitter (e < n) owns subscription e and reads
// its update from perm_u[starts[e] + j]; a class-B emitter owns update
// e - n and reads its subscription from perm_s[starts[e] + j].  A slot
// whose rank is at or past the emitter's count (the saturated tail, or
// t past K) gets the (-1, -1) pad.  Output is bit-identical to the plain
// pass 2 (repro_torch.core.sbm._twopass_slots).
//
// The TPU kernel held all five tables in VMEM for the whole grid, which
// capped it at ~5e5 regions under its 8 MiB budget.  Here the tables stay
// in device memory and go through the L2 (50 MB): at N = 1e6 they are
// ~16 MB, so the binary-search probes of neighbouring slots, which walk
// the same path, hit in L2/L1.
//
// Bound on the card: bytes.  Every slot writes 8 B, one int2 store straight
// into the (max_pairs, 2) buffer; at the paper's fig. 9 size (K ~ 5e7)
// that is 400 MB, ~0.12 ms at 3.35 TB/s, against ~16 MB of tables read.
// One thread per slot in a grid-stride loop with 64-bit slot arithmetic.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
twopass_emit_kernel(const int* __restrict__ offs,
                    const int* __restrict__ counts,
                    const int* __restrict__ starts,
                    const int* __restrict__ perm_s,
                    const int* __restrict__ perm_u, int n, int m,
                    long long max_pairs, int2* __restrict__ out) {
  const int E = n + m;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long slot = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       slot < max_pairs; slot += stride) {
    const int t = static_cast<int>(slot);  // max_pairs <= INT32_MAX
    // largest e in [0, E] with offs[e] <= t (offs[0] == 0 <= t)
    int lo = 0, hi = E;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(offs + mid) <= t) lo = mid; else hi = mid - 1;
    }
    const int e = lo;
    const int j = t - __ldg(offs + e);
    const int cnt = e < E ? __ldg(counts + e) : 0;
    int2 pair = make_int2(-1, -1);
    if (j >= 0 && j < cnt) {
      const int r = __ldg(starts + e) + j;
      pair = e < n ? make_int2(e, __ldg(perm_u + r))
                   : make_int2(__ldg(perm_s + r), e - n);
    }
    out[slot] = pair;
  }
}

}  // namespace

extern "C" {

const char* twopass_emit_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out: int32 (max_pairs, 2) on the device.  Returns the CUDA error, 0 on
// success.  max_pairs == 0 launches nothing.
int twopass_emit_launch(const int* offs, const int* counts, const int* starts,
                        const int* perm_s, const int* perm_u, int n, int m,
                        long long max_pairs, int* out, void* stream) {
  if (max_pairs <= 0) return 0;
  if (max_pairs > 0x7fffffffLL || n <= 0 || m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (max_pairs + BLOCK - 1) / BLOCK;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  twopass_emit_kernel<<<(unsigned)blocks, BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      offs, counts, starts, perm_s, perm_u, n, m, max_pairs,
      reinterpret_cast<int2*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
