// K2: one whole lookup round per row — window gather, member decode,
// queried/evict update, rank merge and quorum check in one kernel.
//
// Replaces fused_round_pallas / _fused_round_kernel / _pl_window_d0 in
// opendht_tpu/ops/pallas_kernels.py.  Inputs per lookup row: the
// augmented routing table [N, row_w] u16 (left in device memory), the
// target's first limb, the frontier [S] (idx i32, d0 u32 held in i64,
// queried) and the prelude's α solicitations [A]: the solicited row
// (clipped to [0, N-1]), its own d0, its shortlist slot (-1 = none),
// the bucket-pair window start w0, q_hit (answered -> queried) and
// e_hit (dead -> evicted).  For each solicitation the row's bucket-pair
// window [w0*3K, w0*3K + 6K) is read (window 0 when w0 lies outside
// [1, b_total-2], as the Pallas select chain does, though the decode
// still uses the raw w0 + r), its 2K members are decoded into (idx,
// d0) — 0xFFFF halves decode to idx -1 — and masked by q_hit; the
// frontier takes the queried/evict one-hots at sel_pos; then the shared
// round tail merge_core::merge_row (merge_core.cuh, also K1's) merges
// S + 2·K·A entries into out_w = min(keep, S + 2KA) and votes `done`.
//
// What bounds it on an H100: memory.  A row needs its α windows
// (4 × 96 B at K = 8), its frontier and prelude (≈270 B) and writes
// ≈180 B; the O(W^2) rank scan of the merge (W = 78) is the same CUDA-
// core work K1 does.  The design keeps K1's one warp per lookup row (8
// rows per 256-thread block): lanes 0..A-1 load the row's prelude into
// shared memory, then the warp reads only the windows it needs — 16-byte
// loads when K is a multiple of 8 (a window starts at w0·3K·2 bytes of a
// row whose width is a multiple of 8 u16, so 16-byte aligned), skipping
// solicitations with q_hit false, whose members are all masked — into
// shared memory, and the merge core decodes each member straight from
// there as it stages the row.  Table offsets are 64-bit: sel·row_w
// reaches 5.1e9 elements at 10M nodes.  Every left shift is on a u32
// with a count below 32, so it wraps to 32 bits as the TPU's does.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_core.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
using merge_core::kMax;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// One warp's shared-memory slice: the merge row, the α windows, the
// prelude.
struct Layout {
  size_t merge, window, params, total;
};

__host__ __device__ inline Layout layout(int w, int out_w, int a, int k) {
  Layout l;
  l.merge = align16(merge_core::row_smem_bytes(w, out_w));
  l.window = align16(size_t(a) * 6 * k * 2);
  l.params = align16(size_t(a) * (8 + 4 + 4 + 4 + 1 + 1));
  l.total = l.merge + l.window + l.params;
  return l;
}

__device__ inline long long clampll(long long x, long long lo,
                                    long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// _pl_window_d0: the first-limb distance rebuilt from a member's 16-bit
// window at depth wr — bits above the window from the solicited node's
// own distance, the window's 16 bits next, zeros below.
__device__ inline unsigned window_d0(unsigned s16, int wr, unsigned tg,
                                     unsigned nid_d0) {
  const long long w = wr;
  const unsigned t16 = (tg << (int)clampll(w, 0, 31)) >> 16;
  const unsigned d16 = s16 ^ t16;
  const unsigned placed = w <= 16 ? d16 << (int)clampll(16 - w, 0, 16)
                                  : d16 >> (int)clampll(w - 16, 0, 16);
  const unsigned hm = w > 0 ? kMax << (int)clampll(32 - w, 0, 31) : 0u;
  return (nid_d0 & hm) | placed;
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
fused_round_kernel(const unsigned short* __restrict__ tables,
                   long long n_nodes, int row_w,
                   const long long* __restrict__ targets0,
                   const int* __restrict__ fr_idx,
                   const long long* __restrict__ fr_d0,
                   const bool* __restrict__ fr_q,
                   const int* __restrict__ safe_sel,
                   const long long* __restrict__ sel_d0,
                   const int* __restrict__ sel_pos,
                   const int* __restrict__ w0,
                   const bool* __restrict__ q_hit,
                   const bool* __restrict__ e_hit,
                   int* __restrict__ o_idx, long long* __restrict__ o_d0,
                   bool* __restrict__ o_q, bool* __restrict__ done,
                   long long n_rows, int s, int a, int k, int out_w,
                   int quorum, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= n_rows) return;
  const int w3 = 3 * k;
  const int win_w = 2 * w3;               // u16 of one bucket-pair window
  const int w = s + 2 * k * a;
  const int b_total = row_w / w3;
  const Layout lay = layout(w, out_w, a, k);
  unsigned char* base = smem + lay.total * warp;
  const merge_core::RowSmem r = merge_core::carve(base, w, out_w);
  unsigned short* win = reinterpret_cast<unsigned short*>(base + lay.merge);
  unsigned char* pp = base + lay.merge + lay.window;
  long long* p_start = reinterpret_cast<long long*>(pp);
  unsigned* p_d0 = reinterpret_cast<unsigned*>(pp + size_t(a) * 8);
  int* p_pos = reinterpret_cast<int*>(pp + size_t(a) * 12);
  int* p_w0 = reinterpret_cast<int*>(pp + size_t(a) * 16);
  unsigned char* p_qh = pp + size_t(a) * 20;
  unsigned char* p_eh = pp + size_t(a) * 21;

  // The row's prelude, one solicitation per lane.
  if (lane < a) {
    const long long i = row * a + lane;
    const long long sel = clampll(safe_sel[i], 0, n_nodes - 1);
    const int w0v = w0[i];
    const int wsel = (w0v >= 1 && w0v <= b_total - 2) ? w0v : 0;
    p_start[lane] = sel * row_w + (long long)wsel * w3;
    p_d0[lane] = (unsigned)(sel_d0[i] & 0xFFFFFFFFll);
    p_pos[lane] = sel_pos[i];
    p_w0[lane] = w0v;
    p_qh[lane] = q_hit[i] ? 1 : 0;
    p_eh[lane] = e_hit[i] ? 1 : 0;
  }
  __syncwarp();

  // The windows that answered, into shared memory.
  if (vec) {
    const int per = win_w / 8;            // 16-byte pieces per window
    for (int t = lane; t < a * per; t += 32) {
      const int ai = t / per, part = t - ai * per;
      if (!p_qh[ai]) continue;
      const uint4* src =
          reinterpret_cast<const uint4*>(tables + p_start[ai]) + part;
      reinterpret_cast<uint4*>(win + ai * win_w)[part] = __ldg(src);
    }
  } else {
    for (int t = lane; t < a * win_w; t += 32) {
      const int ai = t / win_w;
      if (p_qh[ai]) win[t] = tables[p_start[ai] + (t - ai * win_w)];
    }
  }
  __syncwarp();

  const unsigned tg = (unsigned)(targets0[row] & 0xFFFFFFFFll);
  // Entry j: the updated frontier, then the decoded responses in
  // (solicitation, bucket of the pair, member) order.
  auto entry = [&](int j, int& id, unsigned& d, unsigned char& q) {
    if (j < s) {
      const long long i = row * s + j;
      bool queried = fr_q[i], evict = false;
      for (int ai = 0; ai < a; ++ai) {
        if (p_pos[ai] == j) {
          queried = queried || p_qh[ai];
          evict = evict || p_eh[ai];
        }
      }
      id = evict ? -1 : fr_idx[i];
      d = evict ? kMax : (unsigned)(fr_d0[i] & 0xFFFFFFFFll);
      q = queried ? 1 : 0;
    } else {
      const int jj = j - s;
      const int ai = jj / (2 * k), rm = jj - ai * 2 * k;
      const int rr = rm / k, m = rm - rr * k;
      const unsigned short* bw = win + ai * win_w + rr * w3;
      const unsigned idu = (unsigned)bw[m] | ((unsigned)bw[k + m] << 16);
      const bool valid = p_qh[ai] && (int)idu >= 0;
      id = valid ? (int)idu : -1;
      d = valid ? window_d0(bw[2 * k + m], p_w0[ai] + rr, tg, p_d0[ai])
                : kMax;
      q = 0;
    }
  };
  merge_core::merge_row(r, lane, s, w, out_w, quorum, row, entry, o_idx,
                        o_d0, o_q, done);
}

}  // namespace

extern "C" int fused_round_launch(
    const void* tables, long long n_nodes, int row_w, const void* targets0,
    const void* fr_idx, const void* fr_d0, const void* fr_q,
    const void* safe_sel, const void* sel_d0, const void* sel_pos,
    const void* w0, const void* q_hit, const void* e_hit, void* o_idx,
    void* o_d0, void* o_q, void* done, long long n_rows, int s, int a, int k,
    int out_w, int quorum, int vec, void* stream) {
  const size_t smem =
      layout(s + 2 * k * a, out_w, a, k).total * kRowsPerBlock;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  fused_round_kernel<<<(unsigned)blocks, kRowsPerBlock * 32, smem,
                       (cudaStream_t)stream>>>(
      (const unsigned short*)tables, n_nodes, row_w,
      (const long long*)targets0, (const int*)fr_idx,
      (const long long*)fr_d0, (const bool*)fr_q, (const int*)safe_sel,
      (const long long*)sel_d0, (const int*)sel_pos, (const int*)w0,
      (const bool*)q_hit, (const bool*)e_hit, (int*)o_idx, (long long*)o_d0,
      (bool*)o_q, (bool*)done, n_rows, s, a, k, out_w, quorum, vec);
  return (int)cudaGetLastError();
}
