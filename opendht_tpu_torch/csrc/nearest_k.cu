// K3: exact k XOR-nearest valid rows per target.
//
// Replaces nearest_k_ids / _nearest_k_kernel / _extract_rounds in
// opendht_tpu/ops/pallas_kernels.py.  For ids [N,5] (u32 limbs held in
// i64), targets [L,5] and an optional valid mask [N], it returns the k
// valid rows nearest each target by the full 160-bit XOR distance, ties
// by index, -1 in places past the valid rows.  Nothing is assumed of
// the ids: sorted or not, unique or not.
//
// What bounds it on an H100: operations.  An exact scan cannot do less
// than the XOR and the compare of the first distance limb for every
// (target, valid node) pair: 2·L·N 32-bit operations, 0.153 ms at
// L = 512, N = 10M against the 67 T/s float32 lane rate, above the
// 0.122 ms the id matrix and mask take to read (41 B a row at 3.35
// TB/s; both rates from the H100 SXM data sheet, 700 W).  Hopper
// issues 32-bit integer operations on 64 lanes an SM a clock, half that
// rate, so two such operations a pair are nearer 0.6 ms.  The design
// makes a pair cost about one operation and nothing that depends on
// the order of the ids:
//
//   1. seed launch (grid: target groups x sample chunks): every 32nd
//      node, compacted to the valid ones, is staged in shared memory;
//      each thread keeps, for each of its four targets, the minimum
//      first distance limb d0 of M = max(K, 4) disjoint groups of those
//      nodes (an XOR and a min a pair, no branch).  Group minima come
//      from distinct nodes, so the K-th smallest of them over all
//      sample chunks bounds the d0 of the target's true K-th nearest
//      from above (inclusively).  A bound launch (a warp a target)
//      takes that K-th smallest.
//   2. main launch (grid: target groups of 512 x chunks of N, one
//      wave): each 1024-node tile of the chunk is staged with its valid
//      nodes only (a warp ballot and a prefix count), so the scan has
//      no mask.  A thread holds four targets.  Two 16-byte broadcast
//      loads, issued a step ahead, give eight nodes' d0 top halves,
//      stored twice in a word; XORed with two targets' top halves and
//      reduced by Hopper's 16x2 three-way min (VIMNMX3), eight nodes are
//      rejected for two targets by 8 XORs, 4 minima and one test
//      against min(bound, the list's worst d0).  The bound sits near
//      the sample's K-th nearest, about the (32·K)-th of all, so a
//      target lets through on the order of 32·K nodes of the whole
//      scan, in sorted or shuffled order alike; only for a step that
//      passes is d0 tested exactly and the node shift-inserted into
//      the target's sorted top-K list of (d0, row) in registers, a d0
//      tie settled by the other four limbs read back from the ids.
//      Each list's rows are appended (an atomic count a target) to a
//      candidate buffer.
//   3. merge launch (a warp a target): the candidates' full keys are
//      rebuilt from the ids, each lane keeps a top-K, and K rounds of
//      warp minima (a reduce per key word) give the answer in order.
//
// Every true top-K node lies within the bound, beats any full list of
// its chunk it meets, and so reaches the candidates; the merge is an
// exact top-K of them.  The order key is (d0, d1, d2, d3, d4, idx as
// u32) with an empty slot all-ones: no 64-bit surrogate and no margin,
// unlike the TPU kernel.  K is a compile-time power of two (1..16) so
// the lists stay in registers; the wrapper asks for the smallest one
// >= k and keeps the first k.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // threads a scan block
constexpr int kWarps = kThreads / 32;
constexpr int kT = 4;                // targets a thread
constexpr int kGroup = kThreads * kT;  // targets a scan block
constexpr int kTile = 1024;          // nodes staged in shared memory at once
constexpr int kIters = kTile / kThreads;
constexpr int kStep = 8;             // nodes a step of the main scan
constexpr int kSampleStride = 32;    // the seed scans every 32nd node
constexpr int kMergeWarps = 4;       // targets a bound / merge block
constexpr unsigned kMax = 0xFFFFFFFFu;
static_assert(kIters * kWarps == 32, "one warp scans the tile's counts");

// Group minima a target in the seed.
template <int K>
__host__ __device__ constexpr int seed_groups() { return K < 4 ? 4 : K; }

// The merge's full order key.
struct Key {
  unsigned d[5];
  unsigned idx;
};

__device__ inline bool key_less(const Key& a, const Key& b) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (a.d[i] != b.d[i]) return a.d[i] < b.d[i];
  }
  return a.idx < b.idx;
}

__device__ inline void set_empty(Key& k) {
#pragma unroll
  for (int i = 0; i < 5; ++i) k.d[i] = kMax;
  k.idx = kMax;
}

// The main scan's list entry: the first distance limb and the row.
struct Near {
  unsigned d0, idx;
};

__device__ inline void set_empty(Near& k) { k.d0 = k.idx = kMax; }

// Full-key order of rows ia and ib for a target whose first distance
// limbs tie (rare: duplicate ids, or ids that share 32 bits): limbs 1-4
// are read back from the ids.  ib may be empty (kMax); ia is a row.
__device__ __noinline__ bool row_less(const long long* __restrict__ ids,
                                      const long long* __restrict__ tgt,
                                      unsigned ia, unsigned ib) {
  if (ib == kMax) return true;
  const long long* ra = ids + (long long)ia * 5;
  const long long* rb = ids + (long long)ib * 5;
#pragma unroll
  for (int q = 1; q < 5; ++q) {
    const unsigned t = (unsigned)tgt[q];
    const unsigned da = t ^ (unsigned)ra[q], db = t ^ (unsigned)rb[q];
    if (da != db) return da < db;
  }
  return ia < ib;
}

// An ascending top-K in registers (every index static): shift-insert
// under the order `less`, and pop of the head.
template <int K, typename E>
struct TopK {
  E e[K];

  __device__ inline void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) set_empty(e[j]);
  }

  template <typename Less>
  __device__ inline void insert(const E& c, Less less) {
    bool lt[K];
#pragma unroll
    for (int j = 0; j < K; ++j) lt[j] = less(c, e[j]);
#pragma unroll
    for (int j = K - 1; j >= 1; --j) {
      if (lt[j]) e[j] = lt[j - 1] ? e[j - 1] : c;
    }
    if (lt[0]) e[0] = c;
  }

  __device__ inline void pop_front() {
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) e[j] = e[j + 1];
    set_empty(e[K - 1]);
  }
};

struct Stage {
  unsigned d0[kTile];        // limb 0
  unsigned hi2[kTile];       // limb 0's top 16 bits, in both halves
  unsigned idx[kTile];       // the row
  int count[33];
};

// Stage the valid rows among first + j*stride, j in [j0, min(j0 + kTile,
// j_end)), compacted in row order: limb 0 into s.d0 and, for the main
// scan (kMain), its top half twice into s.hi2 and the row into s.idx.
// Returns how many.  Every thread of the block calls it.
template <bool kMain>
__device__ int stage(const long long* __restrict__ ids,
                     const bool* __restrict__ valid, long long first,
                     long long stride, long long j0, long long j_end,
                     Stage& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned bal[kIters];
  __syncthreads();                  // the previous tile is scanned
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const long long j = j0 + it * kThreads + threadIdx.x;
    const bool ok = j < j_end &&
                    (valid == nullptr || valid[first + j * stride]);
    bal[it] = __ballot_sync(0xFFFFFFFFu, ok);
    if (lane == 0) s.count[it * kWarps + warp] = __popc(bal[it]);
  }
  __syncthreads();
  if (warp == 0) {                  // exclusive scan, in row order
    const int c = s.count[lane];
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    s.count[lane] = incl - c;
    if (lane == 31) s.count[32] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    if (bal[it] >> lane & 1u) {
      const int pos = s.count[it * kWarps + warp] + __popc(bal[it] & below);
      const long long row = first + (j0 + it * kThreads + threadIdx.x) * stride;
      const unsigned d0 = (unsigned)ids[row * 5];
      s.d0[pos] = d0;
      if (kMain) {
        s.hi2[pos] = (d0 >> 16) * 0x10001u;
        s.idx[pos] = (unsigned)row;
      }
    }
  }
  __syncthreads();
  return s.count[32];
}

__device__ inline uint4 ld4(const unsigned* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The block's targets: group blockIdx.x, thread slot i < kT takes
// target group * kGroup + i * kThreads + threadIdx.x.
__device__ inline long long target_of(int i) {
  return (long long)blockIdx.x * kGroup + (long long)i * kThreads + threadIdx.x;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
nearest_k_seed(const long long* __restrict__ ids,
               const long long* __restrict__ targets,
               const bool* __restrict__ valid, long long l,
               long long n_sample, long long seed_chunk,
               unsigned* __restrict__ seed_out) {
  constexpr int M = seed_groups<K>();
  __shared__ __align__(16) Stage s;
  unsigned t0[kT], gmin[kT][M];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long long t = target_of(i);
    t0[i] = t < l ? (unsigned)targets[t * 5] : 0u;
#pragma unroll
    for (int g = 0; g < M; ++g) gmin[i][g] = kMax;
  }
  const long long lo = (long long)blockIdx.y * seed_chunk;
  const long long hi = min(n_sample, lo + seed_chunk);
  for (long long j0 = lo; j0 < hi; j0 += kTile) {
    const int m = stage<false>(ids, valid, 0, kSampleStride, j0, hi, s);
    int p = 0;
    for (; p + M <= m; p += M) {
#pragma unroll
      for (int u = 0; u < M / 4; ++u) {
        const uint4 v = ld4(s.d0 + p + 4 * u);
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          gmin[i][4 * u + 0] = min(gmin[i][4 * u + 0], t0[i] ^ v.x);
          gmin[i][4 * u + 1] = min(gmin[i][4 * u + 1], t0[i] ^ v.y);
          gmin[i][4 * u + 2] = min(gmin[i][4 * u + 2], t0[i] ^ v.z);
          gmin[i][4 * u + 3] = min(gmin[i][4 * u + 3], t0[i] ^ v.w);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < M; ++g) {   // the tail: positions past m are stale
      if (p + g < m) {
        const unsigned x = s.d0[p + g];
#pragma unroll
        for (int i = 0; i < kT; ++i) gmin[i][g] = min(gmin[i][g], t0[i] ^ x);
      }
    }
  }
  const long long width = (long long)gridDim.y * M;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long long t = target_of(i);
    if (t >= l) continue;
    unsigned* dst = seed_out + t * width + (long long)blockIdx.y * M;
#pragma unroll
    for (int g = 0; g < M; ++g) dst[g] = gmin[i][g];
  }
}

// bound0[t] = the K-th smallest of seed_out[t, :width] (a warp a target).
template <int K>
__global__ void __launch_bounds__(kMergeWarps * 32)
nearest_k_bound(const unsigned* __restrict__ seed_out, long long l,
                long long width, unsigned* __restrict__ bound0) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (t >= l) return;                 // whole warps leave together
  unsigned a[K];
#pragma unroll
  for (int j = 0; j < K; ++j) a[j] = kMax;
  const unsigned* src = seed_out + t * width;
  for (long long e = lane; e < width; e += 32) {
    const unsigned x = src[e];
    if (x < a[K - 1]) {
#pragma unroll
      for (int j = K - 1; j >= 1; --j) {
        if (x < a[j]) a[j] = x < a[j - 1] ? a[j - 1] : x;
      }
      if (x < a[0]) a[0] = x;
    }
  }
  unsigned kth = kMax;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    kth = __reduce_min_sync(0xFFFFFFFFu, a[0]);
    const unsigned win = __ballot_sync(0xFFFFFFFFu, a[0] == kth);
    if (lane == __ffs(win) - 1) {
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) a[j] = a[j + 1];
      a[K - 1] = kMax;
    }
  }
  if (lane == 0) bound0[t] = kth;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
nearest_k_main(const long long* __restrict__ ids,
               const long long* __restrict__ targets,
               const bool* __restrict__ valid, long long n, long long l,
               long long chunk, const unsigned* __restrict__ bound0,
               int* __restrict__ cnt, int* __restrict__ part, long long cap) {
  __shared__ __align__(16) Stage s;
  constexpr int P = kT / 2;            // targets paired in 16-bit halves
  unsigned t0[kT], bnd[kT], thr0[kT], tp[P], wp[P];
  bool open;                           // some target takes every node
  TopK<K, Near> best[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long long t = target_of(i);
    t0[i] = t < l ? (unsigned)targets[t * 5] : 0u;
    bnd[i] = t < l ? bound0[t] : 0u;
    thr0[i] = bnd[i];
    best[i].clear();
  }
  // The filter's halves: a pair of targets' top 16 bits, and for each
  // the least top 16 bits of d0 it rejects.
  auto refresh = [&]() {
    open = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      unsigned w = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned w16 = thr0[2 * p + h] >> 16;
        open |= w16 == 0xFFFFu;
        w |= ((w16 + 1) & 0xFFFFu) << (16 * h);
      }
      wp[p] = w;
    }
  };
#pragma unroll
  for (int p = 0; p < P; ++p)
    tp[p] = (t0[2 * p] >> 16) | (t0[2 * p + 1] & 0xFFFF0000u);
  refresh();
  const long long lo = (long long)blockIdx.y * chunk;
  const long long hi = min(n, lo + chunk);
  for (long long base = lo; base < hi; base += kTile) {
    const int m = stage<true>(ids, valid, base, 1, 0, hi - base, s);
    // Eight nodes a step, filtered on the top 16 bits of d0 for two
    // targets at once: an XOR of the pair's halves, then 16x2 minima
    // (Hopper's three-way min), one test against the pair's rejects.
    // The eight are loaded (two 16-byte broadcasts) a step ahead, so
    // the loads' latency hides behind the work.
    uint4 a = ld4(s.hi2), b = ld4(s.hi2 + 4);
    for (int p = 0; p < m; p += kStep) {
      const uint4 ca = a, cb = b;
      const int next = min(p + kStep, kTile - kStep);
      a = ld4(s.hi2 + next);
      b = ld4(s.hi2 + next + 4);
      bool hit = open;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const unsigned q = tp[i];
        unsigned x = __vimin3_u16x2(ca.x ^ q, ca.y ^ q, ca.z ^ q);
        x = __vimin3_u16x2(x, ca.w ^ q, cb.x ^ q);
        x = __vimin3_u16x2(x, cb.y ^ q, cb.z ^ q);
        x = __vimin3_u16x2(x, cb.w ^ q, wp[i]);
        hit |= x != wp[i];
      }
      if (!hit) continue;
      // Rare: the exact test of d0, then an insert where the node beats
      // the list's K-th.  Positions past m are stale and skipped.
#pragma unroll 1
      for (int g = 0; g < kStep && p + g < m; ++g) {
        const unsigned s0 = s.d0[p + g], row = s.idx[p + g];
        bool changed = false;
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          const Near c = {t0[i] ^ s0, row};
          const long long t = target_of(i);
          if (c.d0 > thr0[i] || t >= l) continue;
          const long long* tgt = targets + t * 5;
          auto less = [&](const Near& x, const Near& y) {
            return x.d0 != y.d0 ? x.d0 < y.d0 : row_less(ids, tgt, x.idx, y.idx);
          };
          if (less(c, best[i].e[K - 1])) {
            best[i].insert(c, less);
            thr0[i] = min(bnd[i], best[i].e[K - 1].d0);
            changed = true;
          }
        }
        if (changed) refresh();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long long t = target_of(i);
    if (t >= l) continue;
    int nv = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) nv += best[i].e[j].idx != kMax;
    if (nv == 0) continue;
    int* dst = part + t * cap + atomicAdd(cnt + t, nv);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < nv) dst[j] = (int)best[i].e[j].idx;
    }
  }
}

// The k nearest of each target's candidates (a warp a target).
template <int K>
__global__ void __launch_bounds__(kMergeWarps * 32)
nearest_k_merge(const long long* __restrict__ ids,
                const long long* __restrict__ targets, long long l,
                const int* __restrict__ part, const int* __restrict__ cnt,
                long long cap, int k, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (t >= l) return;                 // whole warps leave together
  unsigned tg[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) tg[q] = (unsigned)targets[t * 5 + q];
  TopK<K, Key> best;
  best.clear();
  const int* src = part + t * cap;
  const int nc = cnt[t];
  for (int e = lane; e < nc; e += 32) {
    const int idx = src[e];
    const long long* row = ids + (long long)idx * 5;
    Key c;
#pragma unroll
    for (int q = 0; q < 5; ++q) c.d[q] = tg[q] ^ (unsigned)row[q];
    c.idx = (unsigned)idx;
    if (key_less(c, best.e[K - 1])) {
      best.insert(c, [](const Key& x, const Key& y) { return key_less(x, y); });
    }
  }
  for (int r = 0; r < k; ++r) {
    // The warp's least head key, one word at a time.
    const Key& h = best.e[0];
    bool tie = true;
    unsigned w = kMax;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const unsigned x = q < 5 ? h.d[q] : h.idx;
      w = __reduce_min_sync(0xFFFFFFFFu, tie ? x : kMax);
      tie = tie && x == w;
    }
    if (lane == 0) out[t * k + r] = (int)w;        // empty: -1
    if (lane == __ffs(__ballot_sync(0xFFFFFFFFu, tie)) - 1) best.pop_front();
  }
}

struct Plan {
  long long groups, n_sample, seed_chunk, seed_chunks, chunk, chunks;
  long long seed_width, cap;
};

// Blocks of one full wave of `kernel` on the current device.
template <typename F>
long long wave_blocks(F kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

// Split `len` items into chunks (multiples of the tile) so that `groups`
// target groups make at most one wave of `blocks` blocks.
inline void split(long long len, long long groups, long long blocks,
                  long long& chunk, long long& chunks) {
  long long want = blocks / groups;
  if (want < 1) want = 1;
  const long long tiles = (len + kTile - 1) / kTile;
  if (want > tiles) want = tiles;
  if (want > 65535) want = 65535;                  // chunks ride grid.y
  chunk = (len + want - 1) / want;
  chunk = (chunk + kTile - 1) / kTile * kTile;
  chunks = (len + chunk - 1) / chunk;
}

template <int K>
Plan make_plan(long long n, long long l) {
  Plan p;
  p.groups = (l + kGroup - 1) / kGroup;
  p.n_sample = (n + kSampleStride - 1) / kSampleStride;
  split(p.n_sample, p.groups, wave_blocks(nearest_k_seed<K>),
        p.seed_chunk, p.seed_chunks);
  split(n, p.groups, wave_blocks(nearest_k_main<K>), p.chunk, p.chunks);
  p.seed_width = p.seed_chunks * seed_groups<K>();
  p.cap = p.chunks * K;
  return p;
}

// Scratch: seed minima [L, seed_width] u32, bound [L] u32, counts [L]
// i32, candidates [L, cap] i32.
inline long long scratch_words(const Plan& p, long long l) {
  return l * (p.seed_width + 2 + p.cap);
}

template <int K>
int launch(const long long* ids, const long long* targets, const bool* valid,
           long long n, long long l, int k, void* scratch, long long words,
           int* out, cudaStream_t stream) {
  const Plan p = make_plan<K>(n, l);
  if (scratch_words(p, l) > words) return (int)cudaErrorInvalidValue;
  unsigned* seed_out = (unsigned*)scratch;
  unsigned* bound0 = seed_out + l * p.seed_width;
  int* cnt = (int*)(bound0 + l);
  int* part = cnt + l;
  cudaError_t e = cudaMemsetAsync(cnt, 0, l * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  nearest_k_seed<K><<<dim3((unsigned)p.groups, (unsigned)p.seed_chunks),
                         kThreads, 0, stream>>>(
      ids, targets, valid, l, p.n_sample, p.seed_chunk, seed_out);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const unsigned per_target = (unsigned)((l + kMergeWarps - 1) / kMergeWarps);
  nearest_k_bound<K><<<per_target, kMergeWarps * 32, 0, stream>>>(
      seed_out, l, p.seed_width, bound0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  nearest_k_main<K><<<dim3((unsigned)p.groups, (unsigned)p.chunks),
                         kThreads, 0, stream>>>(
      ids, targets, valid, n, l, p.chunk, bound0, cnt, part, p.cap);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  nearest_k_merge<K><<<per_target, kMergeWarps * 32, 0, stream>>>(
      ids, targets, l, part, cnt, p.cap, k, out);
  return (int)cudaGetLastError();
}

template <int K>
long long words_for(long long n, long long l) {
  return scratch_words(make_plan<K>(n, l), l);
}

}  // namespace

// 32-bit words of scratch nearest_k_launch needs for these sizes on the
// current device (-1 for k outside 1..16).
extern "C" long long nearest_k_scratch_words(long long n, long long l, int k) {
  if (k < 1) return -1;
  if (k <= 1) return words_for<1>(n, l);
  if (k <= 2) return words_for<2>(n, l);
  if (k <= 4) return words_for<4>(n, l);
  if (k <= 8) return words_for<8>(n, l);
  if (k <= 16) return words_for<16>(n, l);
  return -1;
}

extern "C" int nearest_k_launch(const void* ids, const void* targets,
                                const void* valid, long long n, long long l,
                                int k, void* scratch, long long words,
                                void* out, void* stream) {
  const long long* i = (const long long*)ids;
  const long long* t = (const long long*)targets;
  const bool* v = (const bool*)valid;
  int* o = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || l < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (k <= 1) return launch<1>(i, t, v, n, l, k, scratch, words, o, s);
  if (k <= 2) return launch<2>(i, t, v, n, l, k, scratch, words, o, s);
  if (k <= 4) return launch<4>(i, t, v, n, l, k, scratch, words, o, s);
  if (k <= 8) return launch<8>(i, t, v, n, l, k, scratch, words, o, s);
  if (k <= 16) return launch<16>(i, t, v, n, l, k, scratch, words, o, s);
  return (int)cudaErrorInvalidValue;
}
