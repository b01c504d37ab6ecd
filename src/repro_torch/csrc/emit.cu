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
// t past K, which the sentinel entry E with count 0 owns) gets the
// (-1, -1) pad.  Output is bit-identical to the plain pass 2
// (repro_torch.core.sbm._twopass_slots).
//
// The TPU kernel held all five tables in VMEM for the whole grid, which
// capped it at ~5e5 regions under its 8 MiB budget.  Here the tables stay
// in device memory, and the slots are decoded a tile at a time by the
// tile decode of emit_tile.cuh: two 32-ary warp searches a tile find its
// first and last owner, the tile's offsets are read once to mark each
// run's first slot, and a max-scan gives every slot its owner.  The
// uncompacted tables keep their zero-count emitters, so a tile may span
// many entries (about 82 a 4096-slot tile at fig. 9, 1,000 a 512-slot
// tile at overlap degree 1; spans past 16 tiles, as at degree 0.01, take
// the decode's per-slot search).
//
// The tile is the largest of 4096, 2048, ..., 256 slots that still gives
// 4 CTAs an SM (pick_tile): 4096 at fig. 9 (K ~ 5e7, 12,207 tiles),
// where fewer searches a slot pay; smaller tiles when K is small (512 at
// overlap degree 1, K = 489,667), where a 4096-slot grid would leave SMs
// idle.
//
// Bound on the card: bytes.  Every slot writes 8 B and gathers one 4-byte
// partner; at the paper's fig. 9 size (K ~ 5e7) the 400 MB written take
// ~0.12 ms at 3.35 TB/s, against ~16 MB of tables read.
#include "emit_tile.cuh"

namespace {

constexpr int TILE_MAX = 4096;
constexpr int TILE_MIN = 256;
constexpr int CTAS_PER_SM = 4;

// The largest tile, in slots, whose grid still gives every SM
// CTAS_PER_SM CTAs (TILE_MIN if none does).
cudaError_t pick_tile(long long max_pairs, int* tile) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int T = TILE_MAX;
  while (T > TILE_MIN && (max_pairs + T - 1) / T < (long long)CTAS_PER_SM * sms)
    T /= 2;
  *tile = T;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* twopass_emit_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tile twopass_emit_launch takes for max_pairs slots on the current
// device, or 0 on a CUDA error.
int twopass_emit_tile(long long max_pairs) {
  int T = 0;
  return pick_tile(max_pairs, &T) == cudaSuccess ? T : 0;
}

// out: int32 (max_pairs, 2) on the device, 16-byte aligned.  Returns the
// CUDA error, 0 on success.  max_pairs == 0 launches nothing.
int twopass_emit_launch(const int* offs, const int* counts, const int* starts,
                        const int* perm_s, const int* perm_u, int n, int m,
                        long long max_pairs, int* out, void* stream) {
  if (max_pairs <= 0) return 0;
  if (max_pairs > 0x7fffffffLL || n <= 0 || m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int T = 0;
  const cudaError_t err = pick_tile(max_pairs, &T);
  if (err != cudaSuccess) return static_cast<int>(err);
  const emit_tile::Uncompacted tb{offs, counts, starts, n + m};
  return static_cast<int>(emit_tile::launch(
      tb, perm_s, perm_u, n, max_pairs, T, out,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
