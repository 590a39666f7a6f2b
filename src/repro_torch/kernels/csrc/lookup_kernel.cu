// Legacy narrow-key lookup kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lookup.py::lookup_kernel_call
// (body _lookup_kernel, lookup.py:45-113), the search stage of the
// explicitly requested "pallas" backend.  One CTA per tile of q_tile
// queries; the tile's window is the two w_tile blocks of slot keys
// starting at block tile_block[i].  For each query q:
//
//   seg   = clip(count(seg_first_key <= q) - 1, 0, Kpad - 1)
//   pred  = slope[seg] * (q - seg_first_key[seg]) + icept[seg]
//   rank  = count(window <= q),  slot = base + rank - 1
//   found = some window key == q
//   fb    = (rank == 0 && base > 0) || rank == 2 * w_tile
//
// The TPU kernel computes both counts as chunked masked sums over the
// whole table and the whole window, which it DMAs into VMEM per tile.
// Here each count is an upper-bound search: the segment first keys are
// sorted (+inf padded) and the slot keys non-decreasing (a gap carries
// its right neighbour's key; the padding is +inf), so the keys <= q
// form a prefix whose length is the count, and some window key equals
// q exactly when the last key of that prefix does.  The plain torch
// version counts literally, so holding the two equal on the card
// checks this argument on real data.
//
// What bounds it on this card: bytes through L2 and the latency of
// dependent reads.  At the main shape (2^20 sorted queries, q_tile
// 128, w_tile 2048, 9.19M slots) the tiles' 8,192 windows hold 134 MB
// of keys, 3.6x what the queries need: a tile's queries span about
// 1,120 of its 4,096 window slots.  The earlier design copied every
// window whole into 16 KiB of shared memory behind one barrier, and
// bisected a global segment table per query.
//
// The design: both counts are monotone in q, so every query of a tile
// has its rank in [rank(q_min), rank(q_max)] and its count of segment
// first keys in [count(q_min), count(q_max)], where q_min and q_max are
// the tile's least and greatest query, taken by a reduction (not the
// first and last: an unsorted tile gets the same answers).
//
//   1. The CTA reads its queries (coalesced) and reduces q_min, q_max.
//   2. Four warps bracket at once, each by a warp-cooperative 32-ary
//      search in global memory: 32 lanes probe evenly spaced keys, and
//      __ballot_sync + __popc narrow the range 32x per round.  The two
//      window searches stop once their range is 128 keys or less (one
//      dependent round for a 4,096-key window, where a bisect takes
//      12): every query's rank then lies in [r_lo, r_hi], from the low
//      end of q_min's range to the high end of q_max's.  The two
//      segment searches run to the exact counts (2 rounds for a
//      512-row table that L2 holds).
//   3. The CTA stages only the slice [max(r_lo - 1, 0), r_hi) of the
//      window in shared memory: a median of 1,280 keys at the main
//      shape (the tile's span and the two brackets' slack), so the
//      buffer is 8 KiB (2,048 keys) and no CTA holds a 16 KiB window.  Each
//      thread issues all its 16-byte loads (where aligned) before its
//      first store to shared memory, as evict-first (__ldcs) loads: a
//      slice is read once.  A wider slice is not staged; that tile
//      searches the same bracket in global memory instead, which gives
//      the same answer.
//   4. Each query bisects its rank inside the bracket (the slice) and
//      its segment inside the table bracket, which is no search at all
//      when the tile lies in one segment (the usual case: a segment
//      holds about 31,000 keys); found reads the staged key at rank - 1.
//      A thread keeps its first query in a register from step 1, and
//      slot and pred go out as streaming (__stcs) stores.
//
// On the card (NVIDIA H100 80GB HBM3, 700 W) the staging copy set the
// time: issuing a thread's loads together and marking them evict-first
// each paid, while a persistent CTA that double-buffers slices with
// cp.async (the next tile's copy in flight during this tile's search)
// was no faster than one tile a CTA, and was left out (PERF.md).
//
// A query outside [q_min, q_max] (only a NaN can be) is searched over
// the whole window and the whole table, as the earlier design did.
// A tile of +inf padding needs no special case: its bracket holds
// rank(+inf), and it stages a few keys.  Static shared memory only
// (8 KiB plus a few words), so no attribute is set at launch, and any
// w_tile runs.
//
// Numerics: compile with -fmad=false, and pred is spelled
// __fsub_rn / __fmul_rn / __fadd_rn besides, so the product is rounded
// before the sum, as the plain torch version's separate ops round it.
// The block index is clamped to [0, Mpad / w_tile - 2], the range the
// pipeline's tile schedule already clips it to, so the window never
// leaves the padded slot keys.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSliceCap = 2048;   // staged window keys (8 KiB)
constexpr int kRankSlack = 128;   // window brackets stop this wide
constexpr int kMaxWarps = 8;      // 256 threads

struct Args {
  const float* q;           // (Qpad,) +inf padded
  const int* tile_block;    // (Qpad / q_tile,)
  const float* segk;        // (Kpad,) +inf padded
  const float* slope;       // (Kpad,)
  const float* icept;       // (Kpad,)
  const float* sk;          // (Mpad,) +inf padded
  int* slot;
  float* pred;
  uint8_t* found;
  uint8_t* fb;
  int q_tile;
  int w_tile;
  int k_pad;
  int max_block;            // Mpad / w_tile - 2
};

// Narrows the range [lo, hi] = [0, n] that holds count(a[i] <= v) over
// the non-decreasing a[0, n), by one full warp, until it is at most
// `slack` wide: each round the lanes probe the last key of 32 equal
// strides of the open range, and the ballot's popcount keeps the stride
// that holds the boundary.  Every lane returns the same range; slack 0
// gives the count itself (0 for a NaN v).
__device__ __forceinline__ int2 warp_bracket(const float* __restrict__ a,
                                             int n, float v, int lane,
                                             int slack) {
  int lo = 0, hi = n;
  while (hi - lo > slack) {
    const int s = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * s - 1;
    const bool le = p < hi && __ldg(a + p) <= v;
    const int c = __popc(__ballot_sync(kFull, le));
    hi = min(hi, lo + (c + 1) * s - 1);
    lo += c * s;
  }
  return make_int2(lo, hi);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
lookup_kernel(Args a) {
  __shared__ __align__(16) float slice[kSliceCap];
  __shared__ float red_min[kMaxWarps], red_max[kMaxWarps];
  __shared__ int bracket[4];   // rank lo, rank hi, segment counts
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int two_w = 2 * a.w_tile;
  const int blk = min(max(__ldg(a.tile_block + blockIdx.x), 0),
                      a.max_block);
  const int base = blk * a.w_tile;
  const float* __restrict__ win = a.sk + base;
  const size_t q0 = static_cast<size_t>(blockIdx.x) * a.q_tile;
  const float* __restrict__ q = a.q + q0;

  // 1. the tile's least and greatest query (fminf/fmaxf skip a NaN)
  float mn = INFINITY, mx = -INFINITY;
  const float q_own = tid < a.q_tile ? __ldg(q + tid) : 0.0f;
  for (int j = tid; j < a.q_tile; j += kThreads) {
    const float v = j == tid ? q_own : __ldg(q + j);
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  if (lane == 0) {
    red_min[warp] = mn;
    red_max[warp] = mx;
  }
  __syncthreads();
  float q_min = red_min[0], q_max = red_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    q_min = fminf(q_min, red_min[w]);
    q_max = fmaxf(q_max, red_max[w]);
  }

  // 2. the brackets, one warp each: the window ranks of q_min and q_max
  // to within kRankSlack (every query's rank lies in [r_lo, r_hi]), the
  // segment counts exactly
  for (int k = warp; k < 4; k += kThreads / 32) {
    const float v = (k & 1) ? q_max : q_min;
    const int2 b = k < 2 ? warp_bracket(win, two_w, v, lane, kRankSlack)
                         : warp_bracket(a.segk, a.k_pad, v, lane, 0);
    if (lane == 0) bracket[k] = (k & 1) ? b.y : b.x;
  }
  __syncthreads();
  const int r_lo = bracket[0], r_hi = bracket[1];
  const int c_lo = bracket[2], c_hi = bracket[3];

  // 3. stage the slice [s0, r_hi), widened to 16-byte bounds when the
  // window is aligned; a slice wider than the buffer stays in place
  const int s0 = max(r_lo - 1, 0);
  const bool vec = (reinterpret_cast<uintptr_t>(win) & 15) == 0
                   && (two_w & 3) == 0;
  const int a0 = vec ? (s0 & ~3) : s0;
  const int a1 = max(vec ? ((r_hi + 3) & ~3) : r_hi, a0);
  const bool staged = a1 - a0 <= kSliceCap;
  if (staged) {
    if (vec) {
      // every load in flight before the first store
      constexpr int kLoads = kSliceCap / 4 / kThreads;
      const float4* src = reinterpret_cast<const float4*>(win + a0);
      float4* dst = reinterpret_cast<float4*>(slice);
      const int n4 = (a1 - a0) >> 2;
      float4 r[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int t = tid + k * kThreads;
        if (t < n4) r[k] = __ldcs(src + t);
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int t = tid + k * kThreads;
        if (t < n4) dst[t] = r[k];
      }
    } else {
      for (int t = tid; t < a1 - a0; t += kThreads) {
        slice[t] = __ldg(win + a0 + t);
      }
    }
  }
  __syncthreads();

  // 4. each query inside its brackets
  for (int j = tid; j < a.q_tile; j += kThreads) {
    const float v = j == tid ? q_own : __ldg(q + j);
    const bool in = v >= q_min && v <= q_max;

    int lo = in ? c_lo : 0, hi = in ? c_hi : a.k_pad;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(a.segk + mid) <= v) lo = mid + 1; else hi = mid;
    }
    const int seg = min(max(lo - 1, 0), a.k_pad - 1);
    const float dx = __fsub_rn(v, __ldg(a.segk + seg));
    const float y = __fadd_rn(__fmul_rn(__ldg(a.slope + seg), dx),
                              __ldg(a.icept + seg));

    int rank;
    bool found;
    if (in && staged) {
      lo = r_lo;
      hi = r_hi;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (slice[mid - a0] <= v) lo = mid + 1; else hi = mid;
      }
      rank = lo;
      found = rank > 0 && slice[rank - 1 - a0] == v;
    } else {
      lo = in ? r_lo : 0;
      hi = in ? r_hi : two_w;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(win + mid) <= v) lo = mid + 1; else hi = mid;
      }
      rank = lo;
      found = rank > 0 && __ldg(win + rank - 1) == v;
    }

    const size_t i = q0 + j;
    __stcs(a.slot + i, base + rank - 1);
    __stcs(a.pred + i, y);
    a.found[i] = found ? 1 : 0;
    a.fb[i] = ((rank == 0 && base > 0) || rank == two_w) ? 1 : 0;
  }
}

}  // namespace

extern "C" int lookup_kernel_launch(const void* q, const void* tile_block,
                                    const void* segk, const void* slope,
                                    const void* icept, const void* sk,
                                    void* slot, void* found, void* fb,
                                    void* pred, int num_tiles, int q_tile,
                                    int w_tile, int k_pad, int m_pad,
                                    void* stream) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.tile_block = static_cast<const int*>(tile_block);
  a.segk = static_cast<const float*>(segk);
  a.slope = static_cast<const float*>(slope);
  a.icept = static_cast<const float*>(icept);
  a.sk = static_cast<const float*>(sk);
  a.slot = static_cast<int*>(slot);
  a.found = static_cast<uint8_t*>(found);
  a.fb = static_cast<uint8_t*>(fb);
  a.pred = static_cast<float*>(pred);
  a.q_tile = q_tile;
  a.w_tile = w_tile;
  a.k_pad = k_pad;
  a.max_block = m_pad / w_tile - 2;
  if (num_tiles > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (q_tile <= 128) {
      lookup_kernel<128><<<num_tiles, 128, 0, s>>>(a);
    } else {
      lookup_kernel<256><<<num_tiles, 256, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
