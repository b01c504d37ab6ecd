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
// Slot t belongs to the last entry k with offs[k] <= t; rank j = t -
// offs[k]; a class-A entry (id e < n) writes (e, perm_u[start + j]), a
// class-B entry (e, n + u) writes (perm_s[start + j], e - n); ranks at or
// past the count write (-1, -1).  Output is bit-identical to K2 and to
// the plain pass 2 (repro_torch.core.sbm._twopass_slots).
//
// The slots are decoded a tile of bl (the wrapper's `block`) at a time by
// the tile decode of emit_tile.cuh, K2's design on the packed table:
// compacted offsets rise strictly below saturation, entries past
// max_pairs share the offset max_pairs and pads sit at INT32_MAX, so the
// bl slots of a tile (all below max_pairs) select at most bl + 1
// consecutive entries, and a tile is staged when it selects at most 257
// (every tile at fig. 9 and on Koln at bl = 4096).  Each CTA finds its
// own tile's first and last entries by two warp searches, so the wrapper
// computes no window bases.  Dynamic shared memory 4·bl + 4,112 bytes;
// above 48 KB (bl > 11,260) after cudaFuncSetAttribute, up to 227 KB
// (bl <= 57,084).  The wrapper's default is 4096, the fastest of the
// tiles chip_smoke.py times at fig. 9 (fewer searches a slot).
//
// The TPU kernel double-buffered table windows through VMEM with async
// DMA because its tables did not fit; here each tile reads its entries
// once, and the two permutations are gathered from device memory.
//
// Bound on the card: bytes — every slot writes 8 B (one int2 store); the
// packed table is read once (16 B per entry) and each pair gathers one
// 4-byte partner.  At fig. 9 (K ~ 5e7) about 0.12 ms at 3.35 TB/s.
#include "emit_tile.cuh"

extern "C" {

const char* emit_stream_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tab: int32 (4, e_pad) with non-decreasing offsets; out: int32
// (max_pairs, 2), 16-byte aligned; bl: slots per CTA tile (a multiple of
// 8).  Returns the CUDA error, 0 on success; max_pairs == 0 launches nothing.
int emit_stream_launch(const int* tab, long long e_pad, const int* perm_s,
                       const int* perm_u, int n, int m, long long max_pairs,
                       int bl, int* out, void* stream) {
  if (max_pairs <= 0) return 0;
  if (max_pairs > 0x7fffffffLL || n <= 0 || m <= 0 || e_pad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const emit_tile::Packed tb{tab, e_pad};
  return static_cast<int>(emit_tile::launch(
      tb, perm_s, perm_u, n, max_pairs, bl, out,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
