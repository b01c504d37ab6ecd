// K8 — the interval tree walk (paper §3, Alg. 5: "for all u in parallel").
//
// The JAX package has no Pallas kernel for it: its tree walk is a
// lax.while_loop vmapped over the queries (src/repro/core/itm.py:113,152),
// which XLA compiles into one loop on the device.  PyTorch has no vmapped
// while-loop; the port's plain version (repro_torch.core.itm._lockstep)
// steps every query's stack machine in lock-step from Python, one pop of
// the slowest query per step.  This kernel runs the same machine with one
// thread per query, in one launch.
//
// The tree is the reference's implicit Eytzinger tree: five arrays of
// length M+1 = 2^h, 1-indexed, node k's children 2k and 2k+1, padded with
// sentinels (lo = +inf, hi = -inf, id = -1).  For the query [a, b) a
// thread keeps an explicit stack of h+2 node indices, starting with the
// root, and per pop:
//   prune  = maxupper[k] <= a || minlower[k] >= b
//   hit    = !prune && lo[k] < b && a < hi[k] && ids[k] >= 0
//   push 2k    if !prune && 2k <= M
//   push 2k+1  if that and b > lo[k]
// so the right subtree is visited first and hits come in the reference's
// DFS order.  The count goes on past cap; the pairs instance writes the
// first cap hit ids into its row of a (b, cap) buffer that the wrapper
// prefills with -1.  No fast-math flag is used, so the +-inf sentinels
// and NaN compare exactly as in the reference.
//
// Bound on the card: operations, about 20 a node visit (two loads and two
// compares to prune, three more loads and compares to hit, the pushes and
// the loop), for the visits this data needs; the bytes (the tree once,
// 8 B a query in, 4 B a count out, and for the pairs instance 4*cap B a
// query) are smaller at fig. 9.  In practice each visit is a dependent
// read of a node, served from L2 (the 5*(M+1)*4 B tree, 10.5 MB at fig. 9,
// stays resident in the 50 MB L2), and a warp runs until its slowest lane
// is done.  So the lanes of a warp should walk the same nodes: thread t
// takes query order[t], where the wrapper passes the queries' argsort by
// lo.  Neighbouring lanes then share most of their paths and their loads
// fall in the same sectors (8.5x faster than index order at fig. 9 on an
// H100; PERF.md).  Each query still writes its own row and count, so the
// result does not depend on the order.  The stack lives in local memory
// (dynamic indexing), cached in L1.
//
// Offsets: node indices are unsigned 32-bit (M < 2^31, so 2k+1 fits);
// row offsets q*cap are 64-bit, since b*cap passes 2^31 at cap 8192 with
// b >= 262,144.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_H = 31;                 // M + 1 = 2^h <= 2^31

template <bool IDS>
__global__ void __launch_bounds__(THREADS)
itm_walk_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                const float* __restrict__ minlower,
                const float* __restrict__ maxupper,
                const int* __restrict__ ids, unsigned M,
                const float* __restrict__ q_lo,
                const float* __restrict__ q_hi, long long q_stride,
                const int* __restrict__ order, long long b, int cap,
                int* __restrict__ out_ids, int* __restrict__ counts) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= b) return;
  const long long q = order[t];
  const float a = q_lo[q * q_stride];
  const float e = q_hi[q * q_stride];
  int* row = IDS ? out_ids + q * (long long)cap : nullptr;
  unsigned stack[MAX_H + 2];
  stack[0] = 1;
  int sp = 1;
  int cnt = 0;
  while (sp > 0) {
    const unsigned k = stack[--sp];
    if (maxupper[k] <= a || minlower[k] >= e) continue;     // prune
    const float node_lo = lo[k];
    if (node_lo < e && a < hi[k]) {
      const int id = ids[k];
      if (id >= 0) {
        if (IDS && cnt < cap) row[cnt] = id;
        ++cnt;
      }
    }
    if (2u * k <= M) {
      stack[sp++] = 2u * k;
      // the right subtree holds lo >= node lo: skip it if e <= node lo
      if (e > node_lo) stack[sp++] = 2u * k + 1u;
    }
  }
  counts[q] = cnt;
}

}  // namespace

extern "C" {

const char* itm_walk_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K8.  Tree arrays float32/int32 of length M+1 (a power of two, M < 2^31);
// queries float32, element i at q_lo[i * q_stride]; order: int32 (b,), a
// permutation of [0, b) giving thread t query order[t], required when
// b > 0; counts int32 (b,).  out_ids == nullptr: the count instance.
// Otherwise int32 (b, cap), cap >= 1, prefilled with -1 by the caller.
// b == 0 launches nothing.  Returns the CUDA error, 0 on success.
int itm_walk_launch(const float* lo, const float* hi, const float* minlower,
                    const float* maxupper, const int* ids, long long M,
                    const float* q_lo, const float* q_hi, long long q_stride,
                    const int* order, long long b, int cap, int* out_ids,
                    int* counts, void* stream) {
  if (b < 0 || b > 0x7fffffffLL || M < 1 || M >= (1LL << MAX_H) ||
      ((M + 1) & M) != 0 || q_stride < 1 || (b > 0 && order == nullptr) ||
      (out_ids != nullptr && cap < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const long long blocks = (b + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_ids == nullptr)
    itm_walk_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
        lo, hi, minlower, maxupper, ids, (unsigned)M, q_lo, q_hi, q_stride,
        order, b, 0, nullptr, counts);
  else
    itm_walk_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
        lo, hi, minlower, maxupper, ids, (unsigned)M, q_lo, q_hi, q_stride,
        order, b, cap, out_ids, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
