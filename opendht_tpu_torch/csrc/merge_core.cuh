// The per-row tail of a lookup round, shared by K1 (merge_round.cu) and
// K2 (fused_round.cu) so the two cannot drift — the counterpart of
// _merge_core in opendht_tpu/ops/pallas_kernels.py.
//
// One warp owns one lookup row.  merge_row() stages the row's W = S + C
// entries in the warp's shared-memory slice (the caller's `entry`
// functor supplies entry j: frontier slots first, then responses — the
// input ordinal), drops responses that repeat an earlier valid entry
// (first copy wins) and empties, ranks every entry by (effective d0,
// idx as u32, ordinal) with duplicates' and empties' d0 forced to
// all-ones, places each survivor whose rank is below out_w straight in
// its output slot (ranks are unique, so no two writes collide), stores
// the row with coalesced writes and votes
//   done = (quorum head all queried and non-empty) | (nothing unqueried).
// The O(W^2) rank scan runs on the CUDA cores; every lane reads the same
// shared word at a time (a broadcast).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace merge_core {

constexpr unsigned kMax = 0xFFFFFFFFu;

struct RowSmem {
  unsigned* idx;      // [W] idx as u32
  unsigned* d0;       // [W] d0, all-ones where idx < 0
  unsigned* eff;      // [W] d0, all-ones for duplicates and empties
  unsigned char* q;   // [W] queried (responses: 0)
  unsigned char* dup; // [W] duplicate or empty
  int* o_idx;         // [out_w]
  unsigned* o_d0;     // [out_w]
  unsigned char* o_q; // [out_w]
};

__host__ __device__ inline size_t align8(size_t x) {
  return (x + 7) & ~size_t(7);
}

// Shared-memory bytes of one warp's row slice.
__host__ __device__ inline size_t row_smem_bytes(int w, int out_w) {
  return align8(size_t(w) * 4) * 3 + align8(w) * 2 +
         align8(size_t(out_w) * 4) * 2 + align8(out_w);
}

__device__ inline RowSmem carve(unsigned char* base, int w, int out_w) {
  RowSmem r;
  unsigned char* p = base;
  r.idx = reinterpret_cast<unsigned*>(p); p += align8(size_t(w) * 4);
  r.d0 = reinterpret_cast<unsigned*>(p); p += align8(size_t(w) * 4);
  r.eff = reinterpret_cast<unsigned*>(p); p += align8(size_t(w) * 4);
  r.q = p; p += align8(w);
  r.dup = p; p += align8(w);
  r.o_idx = reinterpret_cast<int*>(p); p += align8(size_t(out_w) * 4);
  r.o_d0 = reinterpret_cast<unsigned*>(p); p += align8(size_t(out_w) * 4);
  r.o_q = p;
  return r;
}

// `entry(j, id, d0, q)` writes entry j's index (int, < 0 = empty), its
// first-limb distance (u32) and its queried flag.  Called by the whole
// warp; `row` indexes the [rows, out_w] outputs and `done`.
template <typename Entry>
__device__ inline void merge_row(const RowSmem& r, int lane, int s, int w,
                                 int out_w, int quorum, long long row,
                                 Entry entry, int* __restrict__ o_idx,
                                 long long* __restrict__ o_d0,
                                 bool* __restrict__ o_q,
                                 bool* __restrict__ done) {
  // Stage the row.
  for (int j = lane; j < w; j += 32) {
    int id;
    unsigned d;
    unsigned char q;
    entry(j, id, d, q);
    r.idx[j] = (unsigned)id;
    r.d0[j] = id < 0 ? kMax : d;
    r.q[j] = q;
  }
  for (int k = lane; k < out_w; k += 32) {
    r.o_idx[k] = -1;
    r.o_d0[k] = kMax;
    r.o_q[k] = 0;
  }
  __syncwarp();

  // Dedup: a response repeats any earlier entry with its index (an
  // equal valid index implies the earlier entry is valid too).
  for (int j = lane; j < w; j += 32) {
    const unsigned id = r.idx[j];
    bool dup = (int)id < 0;
    if (!dup && j >= s) {
      for (int i = 0; i < j; ++i) {
        if (r.idx[i] == id) { dup = true; break; }
      }
    }
    r.dup[j] = dup ? 1 : 0;
    r.eff[j] = dup ? kMax : r.d0[j];
  }
  __syncwarp();

  // Rank = entries strictly before under (eff, idx_u, ordinal).
  for (int j = lane; j < w; j += 32) {
    if (r.dup[j]) continue;
    const unsigned ej = r.eff[j], ij = r.idx[j];
    int rank = 0;
    for (int i = 0; i < w; ++i) {
      const unsigned ei = r.eff[i], ii = r.idx[i];
      rank += (ei < ej) || (ei == ej && (ii < ij || (ii == ij && i < j)));
    }
    if (rank < out_w) {
      r.o_idx[rank] = (int)ij;
      r.o_d0[rank] = r.d0[j];
      r.o_q[rank] = r.q[j];
    }
  }
  __syncwarp();

  bool head_valid = false, head_unq = false, any_unq = false;
  for (int k = lane; k < out_w; k += 32) {
    const int id = r.o_idx[k];
    const bool q = r.o_q[k] != 0;
    o_idx[row * out_w + k] = id;
    o_d0[row * out_w + k] = (long long)r.o_d0[k];
    o_q[row * out_w + k] = q;
    if (id >= 0 && !q) any_unq = true;
    if (k < quorum && id >= 0) {
      head_valid = true;
      if (!q) head_unq = true;
    }
  }
  const bool synced = __any_sync(0xFFFFFFFFu, head_valid) &&
                      !__any_sync(0xFFFFFFFFu, head_unq);
  const bool exhausted = !__any_sync(0xFFFFFFFFu, any_unq);
  if (lane == 0) done[row] = synced || exhausted;
}

}  // namespace merge_core
