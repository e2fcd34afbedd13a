// K1: one lookup round's merge — dedup + rank merge + quorum check.
//
// Replaces merge_round_pallas / _merge_round_kernel / _merge_core in
// opendht_tpu/ops/pallas_kernels.py.  Per lookup row it joins the
// frontier [S] (idx i32, d0 u32 held in i64, queried) with the round's
// responses [C] (idx, d0), drops responses that repeat a valid frontier
// entry or an earlier response (first copy wins), ranks every entry by
// (effective d0, idx as u32, input ordinal) with duplicates' and
// empties' d0 forced to all-ones, writes each survivor whose rank is
// below out_w = min(keep, S+C) to that slot, and emits
// done = (quorum head all queried and non-empty) | (nothing unqueried).
//
// What bounds it on an H100: memory.  A row moves S*13 + C*12 +
// out_w*13 + 1 bytes (i32 idx, i64 d0, bool queried; about 1.1 KB at
// S=14, C=64) and does about (S+C)^2 = 6k 32-bit compares — far below
// the card's compare rate per byte moved.  Rows are independent, so the
// design gives each row one warp (8 rows per 256-thread block): the
// warp stages its row's W = S+C entries in shared memory with coalesced
// loads, each lane takes entries lane, lane+32, ... and counts the
// entries strictly before them by scanning the row in shared memory
// (every lane reads the same word, a broadcast), survivors land
// straight in their slot of a shared-memory output row (ranks are
// unique, so no two writes collide), and after a __syncwarp the row is
// stored with coalesced writes and `done` is one warp vote.  Nothing
// is carried between rows and no sort network is needed.  This is the
// simple form: the O(W^2) scan runs on the CUDA cores, which keeps it
// above the memory bound for now.  The per-row tail is
// merge_core::merge_row (merge_core.cuh), which K2 shares.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_core.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

__global__ void __launch_bounds__(kRowsPerBlock * 32)
merge_round_kernel(const int* __restrict__ fr_idx,
                   const long long* __restrict__ fr_d0,
                   const bool* __restrict__ fr_q,
                   const int* __restrict__ resp_idx,
                   const long long* __restrict__ resp_d0,
                   int* __restrict__ o_idx, long long* __restrict__ o_d0,
                   bool* __restrict__ o_q, bool* __restrict__ done,
                   long long n_rows, int s, int c, int out_w, int quorum) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= n_rows) return;
  const int w = s + c;
  const merge_core::RowSmem r = merge_core::carve(
      smem + merge_core::row_smem_bytes(w, out_w) * warp, w, out_w);
  // Entry j: the frontier, then the responses (the input ordinal).
  auto entry = [&](int j, int& id, unsigned& d, unsigned char& q) {
    if (j < s) {
      id = fr_idx[row * s + j];
      d = (unsigned)(fr_d0[row * s + j] & 0xFFFFFFFFll);
      q = fr_q[row * s + j] ? 1 : 0;
    } else {
      id = resp_idx[row * c + (j - s)];
      d = (unsigned)(resp_d0[row * c + (j - s)] & 0xFFFFFFFFll);
      q = 0;
    }
  };
  merge_core::merge_row(r, lane, s, w, out_w, quorum, row, entry, o_idx,
                        o_d0, o_q, done);
}

}  // namespace

extern "C" int merge_round_launch(const void* fr_idx, const void* fr_d0,
                                  const void* fr_q, const void* resp_idx,
                                  const void* resp_d0, void* o_idx,
                                  void* o_d0, void* o_q, void* done,
                                  long long n_rows, int s, int c, int out_w,
                                  int quorum, void* stream) {
  const size_t smem =
      merge_core::row_smem_bytes(s + c, out_w) * kRowsPerBlock;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        merge_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  merge_round_kernel<<<(unsigned)blocks, kRowsPerBlock * 32, smem,
                       (cudaStream_t)stream>>>(
      (const int*)fr_idx, (const long long*)fr_d0, (const bool*)fr_q,
      (const int*)resp_idx, (const long long*)resp_d0, (int*)o_idx,
      (long long*)o_d0, (bool*)o_q, (bool*)done, n_rows, s, c, out_w,
      quorum);
  return (int)cudaGetLastError();
}
