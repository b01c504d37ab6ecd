// K8 — the interval tree walk (paper §3, Alg. 5: "for all u in parallel").
//
// The JAX package has no Pallas kernel for it: its tree walk is a
// lax.while_loop vmapped over the queries (src/repro/core/itm.py:113,152),
// which XLA compiles into one loop on the device.  PyTorch has no vmapped
// while-loop; the port's plain version (repro_torch.core.itm._lockstep)
// steps every query's stack machine in lock-step from Python.
//
// The function.  The tree is the reference's implicit Eytzinger tree: five
// arrays of length M+1 = 2^h, 1-indexed, node k's children 2k and 2k+1,
// complete (every leaf at depth h-1), padded with sentinels (lo = +inf,
// hi = -inf, id = -1).  For the query [a, e) the reference pops node k from
// a stack that starts with the root, and
//   prune  = maxupper[k] <= a || minlower[k] >= e
//   hit    = !prune && lo[k] < e && a < hi[k] && ids[k] >= 0
//   push 2k    if !prune && 2k <= M
//   push 2k+1  if that and e > lo[k]
// so it visits nodes in right-first pre-order (k, then the subtree at 2k+1
// if pushed, then the subtree at 2k), and writes hits in that order.  The
// count goes on past cap; the pairs instance writes the first cap hit ids
// into its row of a (b, cap) buffer that the wrapper prefills with -1.  No
// fast-math flag is used, so the +-inf sentinels and NaN compare as in the
// reference.
//
// The stackless walk (walk() below).  The tree is complete, so where a walk
// goes after a finished subtree follows from k's bits alone.  A subtree is
// finished when its root was pruned, is a leaf, or both of its children's
// subtrees are finished.  Right-first, the subtree after a finished right
// child 2p+1 is its sibling 2p, which the stack walk always pushed with it
// (2p is pushed whenever p was live and not a leaf, 2p+1 only then); a
// finished left child 2p finishes p.  So strip k's trailing zero bits
// (finish the parents of left children), j = k >> ctz(k): j == 1 is the
// root, and the walk is done; else j is a right child and the walk goes on
// at j - 1.  Descending goes to 2k+1 when e > lo[k] and to 2k otherwise:
// the top of the stack walk's stack in both cases.  By induction on the
// pops this visits exactly the nodes the stack visits, in the same order,
// with no local memory.  For the subtree at r of depth dr, the same rule
// with k's bits below r: the walk is done when those bits are all zero.
//
// Bound on the card.  Operations: about 20 a node visit (two loads and two
// compares to prune, three more loads and compares to hit, the step and the
// loop) for the visits this data needs; the bytes (the tree once, 8 B a
// query in, 4 B a count out, and for the pairs instance 4*cap B a query)
// are smaller at fig. 9.  In practice each visit is a dependent read of a
// node from L2 (the 5*(M+1)*4 B tree, 10.5 MB at fig. 9, stays in the 50 MB
// L2), so the walk is bound by latency: a chain of dependent reads as long
// as the walk.  The two regimes attack that chain in two ways.
//
// Regime rule (kernels/itm.py:regime): a CTA per query when b <= the card's
// SM count, so that every query has an SM of its own in one wave; a thread
// per query otherwise.  The wrapper reads the SM count at run time.
//
// Thread regime (walk_per_thread; large b: fig. 9's 500,000 queries, Koln,
// a service tick's 20,000 boxes).  One thread walks one query, thread t
// query order[t], where the wrapper passes the queries' argsort by lo: the
// lanes of a warp then walk neighbouring queries, which share most of their
// paths, and their loads fall in the same sectors.  Latency is hidden by
// the many warps in flight; per visit the prune pair is read first, lo and
// hi only for a live node, and ids only on a hit, its load left in flight
// while the next node's prune pair loads.  The pairs instance stages each
// lane's hits in shared memory and writes its row as whole aligned 32-byte
// sectors (two 16-byte stores), the row's ragged head and tail element by
// element: a warp's store no longer puts 4 bytes into each of 32 sectors.
//
// CTA regime (walk_per_cta; small b: serving's batch of 64 boxes, the
// distributed query's rows).  One thread a query would leave the card idle
// and walk each query's thousands of nodes as one chain.  Instead the CTA
// expands the tree level by level across its threads: a list of entries,
// each an open node (visited, not yet looked at) or a closed hit (its id),
// kept in right-first pre-order.  Each level reads every open entry's node
// (five loads issued together: a level waits on its slowest entry) and
// replaces it by [its hit] [2k+1 if pushed] [2k if pushed]; one CTA scan of
// the output counts places them, so the list stays in pre-order without a
// sort (the pre-order rank of a node of depth d in a tree of height h:
// rank(2k+1) = rank(k) + 1, rank(2k) = rank(k) + 2^(h-d-1); children
// replace their parent in that order).  The expansion stops when no open
// entry is left or the next list would pass LIST_CAP entries; the open
// entries left are then walked, strided over the threads, with the
// stackless walk of their subtrees.  Each entry's count (1 for a hit) goes
// into shared memory; a CTA scan gives each entry its first slot.  The
// count instance sums; the pairs instance writes each hit at its slot
// (consecutive entries, consecutive slots: coalesced) and walks each open
// entry again, writing from its slot until cap.  Depth floor: h levels,
// each at least one dependent L2 read.
//
// Offsets: node indices are unsigned 32-bit (M < 2^31, so 2k+1 fits);
// row offsets q*cap are 64-bit, since b*cap passes 2^31 at cap 8192 with
// b >= 262,144.
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int MAX_H = 31;                  // M + 1 = 2^h <= 2^31
constexpr int THREADS = 256;               // thread regime: queries a CTA
constexpr int CTA_THREADS = 512;           // CTA regime: threads a query
constexpr int CTA_WARPS = CTA_THREADS / 32;
constexpr int LIST_CAP = 12288;            // CTA regime: entries a list
constexpr unsigned CLOSED = 0x80000000u;   // a list entry that holds a hit id
// two lists, the entries' counts or slots, their output flags, scan sums
constexpr size_t CTA_SMEM =
    LIST_CAP * (4 + 4 + 4 + 1) + (CTA_WARPS + 1) * 4;

struct Tree {
  const float* lo;
  const float* hi;
  const float* minlower;
  const float* maxupper;
  const int* ids;
  unsigned M;
};

// The right-first pre-order walk of the subtree at r, stackless (see the
// header).  hit(i, id) is called for the i-th hit; the walk stops after
// `limit` hits.  Returns the hits found.
template <class Hit>
__device__ __forceinline__ int walk(const Tree& t, unsigned r, float a,
                                    float e, int limit, Hit&& hit) {
  const int dr = 31 - __clz(r);
  unsigned k = r;
  int d = dr;
  int n = 0;
  bool pend = false;        // a hit whose id is still loading
  int pend_id = 0;
  for (;;) {
    const float mu = __ldg(t.maxupper + k);
    const float ml = __ldg(t.minlower + k);
    if (pend) {             // the last visit's id, read while this one loads
      pend = false;
      if (pend_id >= 0) {
        hit(n, pend_id);
        if (++n == limit) return n;
      }
    }
    if (!(mu <= a || ml >= e)) {
      const float nlo = __ldg(t.lo + k);
      const float nhi = __ldg(t.hi + k);
      if (nlo < e && a < nhi) {
        pend_id = __ldg(t.ids + k);
        pend = true;
      }
      if (2u * k <= t.M) {
        k = 2u * k + (e > nlo ? 1u : 0u);
        ++d;
        continue;
      }
    }
    // the subtree at k is finished: k's bits below r give the next node
    const unsigned low = k & ((1u << (d - dr)) - 1u);
    if (low == 0u) break;
    const int z = __ffs(low) - 1;
    k = (k >> z) - 1u;
    d -= z;
  }
  if (pend && pend_id >= 0) {
    hit(n, pend_id);
    ++n;
  }
  return n;
}

template <bool IDS>
__global__ void __launch_bounds__(THREADS)
walk_per_thread(Tree t, const float* __restrict__ q_lo,
                const float* __restrict__ q_hi, long long q_stride,
                const int* __restrict__ order, long long b, int cap,
                int* __restrict__ out_ids, int* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= b) return;
  const long long q = order[i];
  const float a = q_lo[q * q_stride];
  const float e = q_hi[q * q_stride];
  if constexpr (!IDS) {
    counts[q] = walk(t, 1u, a, e, INT_MAX, [](int, int) {});
  } else {
    // stage[s][lane]: the lane's hit for slot s of its current sector
    __shared__ int stage[8][THREADS];
    const int tid = threadIdx.x;
    int* row = out_ids + q * (long long)cap;
    // the row's first element sits at slot `head` of its 32-byte sector
    const int head =
        static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 7u);
    // write the staged hits of the sector that holds element j, up to j
    auto flush = [&](int j) {
      const int s0 = j - ((head + j) & 7);
      if (s0 >= 0 && ((head + j) & 7) == 7) {       // a whole sector
        int4* p = reinterpret_cast<int4*>(row + s0);
        p[0] = make_int4(stage[0][tid], stage[1][tid], stage[2][tid],
                         stage[3][tid]);
        p[1] = make_int4(stage[4][tid], stage[5][tid], stage[6][tid],
                         stage[7][tid]);
      } else {                                      // the head or the tail
        for (int x = s0 < 0 ? 0 : s0; x <= j; ++x)
          row[x] = stage[(head + x) & 7][tid];
      }
    };
    const int n = walk(t, 1u, a, e, INT_MAX, [&](int j, int id) {
      if (j >= cap) return;
      const int s = (head + j) & 7;
      stage[s][tid] = id;
      if (s == 7 || j == cap - 1) flush(j);
    });
    const int last = (n < cap ? n : cap) - 1;
    if (last >= 0 && ((head + last) & 7) != 7 && last != cap - 1)
      flush(last);
    counts[q] = n;
  }
}

__device__ __forceinline__ int warp_inclusive(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The exclusive prefix of v over the CTA's threads in thread order; *total
// gets the sum.  Every thread calls it; wsum holds CTA_WARPS + 1 ints.
__device__ int cta_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int x = warp_inclusive(v);
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    const int s = lane < CTA_WARPS ? wsum[lane] : 0;
    const int si = warp_inclusive(s);
    if (lane < CTA_WARPS) wsum[lane] = si - s;
    if (lane == 31) wsum[CTA_WARPS] = si;
  }
  __syncthreads();
  const int out = wsum[w] + x - v;
  *total = wsum[CTA_WARPS];
  __syncthreads();
  return out;
}

template <bool IDS>
__global__ void __launch_bounds__(CTA_THREADS)
walk_per_cta(Tree t, const float* __restrict__ q_lo,
             const float* __restrict__ q_hi, long long q_stride, int cap,
             int* __restrict__ out_ids, int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* cur = reinterpret_cast<unsigned*>(smem);
  unsigned* nxt = cur + LIST_CAP;
  int* aux = reinterpret_cast<int*>(nxt + LIST_CAP);
  unsigned char* flags = reinterpret_cast<unsigned char*>(aux + LIST_CAP);
  int* wsum = reinterpret_cast<int*>(flags + LIST_CAP);
  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  const float a = q_lo[q * q_stride];
  const float e = q_hi[q * q_stride];

  // -- expand level by level, the list in right-first pre-order ------------
  if (tid == 0) cur[0] = 1u;
  int E = 1;
  __syncthreads();
  for (;;) {
    const int per = (E + CTA_THREADS - 1) / CTA_THREADS;
    const int i0 = min(tid * per, E);
    const int i1 = min(i0 + per, E);
    int outs = 0;
    int opens = 0;
    // flags: 1 the entry's hit (aux), 2 its right child, 4 its left child
    for (int i = i0; i < i1; i += 4) {
      unsigned v[4];
      float mu[4], ml[4], nl[4], nh[4];
      int id[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // every load of the batch in flight
        v[j] = i + j < i1 ? cur[i + j] : CLOSED;
        const unsigned k = (v[j] & CLOSED) ? 1u : v[j];
        mu[j] = __ldg(t.maxupper + k);
        ml[j] = __ldg(t.minlower + k);
        nl[j] = __ldg(t.lo + k);
        nh[j] = __ldg(t.hi + k);
        id[j] = __ldg(t.ids + k);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j >= i1) break;
        unsigned f = 0u;
        unsigned val = v[j];
        if (v[j] & CLOSED) {
          f = 1u;
        } else if (!(mu[j] <= a || ml[j] >= e)) {
          if (nl[j] < e && a < nh[j] && id[j] >= 0) {
            f = 1u;
            val = CLOSED | static_cast<unsigned>(id[j]);
          }
          if (2u * v[j] <= t.M) f |= (e > nl[j] ? 2u : 0u) | 4u;
        }
        flags[i + j] = static_cast<unsigned char>(f);
        aux[i + j] = static_cast<int>(val);
        outs += __popc(f);
        opens += __popc(f & 6u);
      }
    }
    int total;
    int base = cta_scan(outs, wsum, &total);
    const bool more = __syncthreads_or(opens) != 0;
    if (total > LIST_CAP) break;     // cur stays; its open entries are walked
    for (int i = i0; i < i1; ++i) {
      const unsigned f = flags[i];
      const unsigned k = cur[i];
      if (f & 1u) nxt[base++] = static_cast<unsigned>(aux[i]);
      if (f & 2u) nxt[base++] = 2u * k + 1u;
      if (f & 4u) nxt[base++] = 2u * k;
    }
    unsigned* done = cur;
    cur = nxt;
    nxt = done;
    E = total;
    __syncthreads();
    if (!more) break;
  }

  // -- each entry's count: 1 for a hit, the walk of an open subtree ---------
  int* cnt = reinterpret_cast<int*>(nxt);   // the spare list
  int mine = 0;
  for (int i = tid; i < E; i += CTA_THREADS) {
    const unsigned v = cur[i];
    const int c = (v & CLOSED) ? 1 : walk(t, v, a, e, INT_MAX,
                                          [](int, int) {});
    if (IDS) cnt[i] = c;
    mine += c;
  }
  if constexpr (!IDS) {
    int total;
    cta_scan(mine, wsum, &total);
    if (tid == 0) counts[q] = total;
  } else {
    __syncthreads();
    // each entry's first slot: a CTA scan over the counts, in list order
    const int per = (E + CTA_THREADS - 1) / CTA_THREADS;
    const int i0 = min(tid * per, E);
    const int i1 = min(i0 + per, E);
    int s = 0;
    for (int i = i0; i < i1; ++i) s += cnt[i];
    int total;
    int slot = cta_scan(s, wsum, &total);
    for (int i = i0; i < i1; ++i) {
      aux[i] = slot;
      slot += cnt[i];
    }
    __syncthreads();
    int* row = out_ids + q * (long long)cap;
    for (int i = tid; i < E; i += CTA_THREADS) {
      const int s0 = aux[i];
      const int c = cnt[i];
      if (c == 0 || s0 >= cap) continue;
      const unsigned v = cur[i];
      if (v & CLOSED) {
        row[s0] = static_cast<int>(v & ~CLOSED);
      } else {
        walk(t, v, a, e, min(c, cap - s0),
             [&](int j, int id) { row[s0 + j] = id; });
      }
    }
    if (tid == 0) counts[q] = total;
  }
}

// One thread follows next[] from 0 for `steps` dependent reads through L2
// (ld.global.cg, not cached in L1): steps * the L2 hit latency, when next
// is a cycle over a buffer larger than L1 and smaller than L2.
__global__ void chase_kernel(const unsigned* __restrict__ next,
                             long long steps, unsigned* __restrict__ out) {
  unsigned p = 0;
  for (long long s = 0; s < steps; ++s) p = __ldcg(next + p);
  *out = p;
}

// Lets both CTA-regime instances take CTA_SMEM bytes of dynamic shared
// memory on the current device (once a device).
cudaError_t cta_smem_ready() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (ready.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(walk_per_cta<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(CTA_SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(walk_per_cta<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(CTA_SMEM));
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

}  // namespace

extern "C" {

const char* itm_walk_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K8.  Tree arrays float32/int32 of length M+1 (a power of two, M < 2^31);
// queries float32, element i at q_lo[i * q_stride]; counts int32 (b,).
// out_ids == nullptr: the count instance.  Otherwise int32 (b, cap),
// cap >= 1, prefilled with -1 by the caller.  per_cta 0: the thread regime,
// which needs order, int32 (b,), a permutation of [0, b) giving thread t
// query order[t]; per_cta 1: the CTA regime (CTA q walks query q; order is
// not read).  b == 0 launches nothing.  Returns the CUDA error, 0 on
// success.
int itm_walk_launch(const float* lo, const float* hi, const float* minlower,
                    const float* maxupper, const int* ids, long long M,
                    const float* q_lo, const float* q_hi, long long q_stride,
                    const int* order, long long b, int cap, int* out_ids,
                    int* counts, int per_cta, void* stream) {
  if (b < 0 || b > 0x7fffffffLL || M < 1 || M >= (1LL << MAX_H) ||
      ((M + 1) & M) != 0 || q_stride < 1 || (per_cta != 0 && per_cta != 1) ||
      (b > 0 && per_cta == 0 && order == nullptr) ||
      (out_ids != nullptr && cap < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const Tree t{lo, hi, minlower, maxupper, ids, static_cast<unsigned>(M)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per_cta) {
    const cudaError_t err = cta_smem_ready();
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned grid = static_cast<unsigned>(b);
    if (out_ids == nullptr)
      walk_per_cta<false><<<grid, CTA_THREADS, CTA_SMEM, st>>>(
          t, q_lo, q_hi, q_stride, 0, nullptr, counts);
    else
      walk_per_cta<true><<<grid, CTA_THREADS, CTA_SMEM, st>>>(
          t, q_lo, q_hi, q_stride, cap, out_ids, counts);
  } else {
    const unsigned blocks = static_cast<unsigned>((b + THREADS - 1) / THREADS);
    if (out_ids == nullptr)
      walk_per_thread<false><<<blocks, THREADS, 0, st>>>(
          t, q_lo, q_hi, q_stride, order, b, 0, nullptr, counts);
    else
      walk_per_thread<true><<<blocks, THREADS, 0, st>>>(
          t, q_lo, q_hi, q_stride, order, b, cap, out_ids, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

// The L2 pointer chase behind the CTA regime's depth floor: `steps`
// dependent reads of next (unsigned, a cycle through index 0), the last
// index into *out.  Returns the CUDA error, 0 on success.
int itm_walk_chase_launch(const unsigned* next, long long steps,
                          unsigned* out, void* stream) {
  if (next == nullptr || out == nullptr || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, steps,
                                                              out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
