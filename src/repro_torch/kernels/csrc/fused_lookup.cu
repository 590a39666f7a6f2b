// Fused learned-index lookup for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lookup.py::fused_lookup_call
// (body _fused_kernel, lookup.py:215-412): one launch per batch carries
// each sorted query from raw key to payload.
//
//   1. radix route to a segment: one multiply + one table gather;
//   2. window base lo0 = floor(slope * dx + icept_fold), clipped;
//   3. flat mode (flat_w > 0): rank = count of the flat_w + 1 slot keys
//      from lo0 (inside the tile's window) that are <= q; whole-window
//      mode (flat_w == 0): rank over all 2 * w_tile slot keys of the
//      tile's window;
//   4. found + payload gather (i32, or an i32 hi/lo pair when wide);
//   5. CSR chain bisect of bit_length(max_chain) trips;
//   6. escape flags and the per-tile compaction into fb_loc / fb_cnt.
//
// Compares are lexicographic on f32 (hi, lo) pairs when key_wide.
//
// fused_lookup64_kernel (entry fused_lookup64_launch) is the same
// function over the 64-bit image: ordered int64 keys (the unsigned key
// with its top bit flipped, so signed order is key order), compared
// exactly in one op, and float64 segment lines.  The radix bucket and
// the window base are taken from the exact difference q - k as
// (q_hi - k_hi) * 2^32 + (q_lo - k_lo), two exact doubles summed, so
// rounded once (exact_dx, as core/keys64.py computes it on the host).
// Its flat rank is the coalesced count above on whole keys (a tie needs
// no second load); whole-window mode bisects the window in place.
// Queries equal to the no-key sentinel (INT64_MAX) are padding.  The
// two kernels share their epilogue and compaction (the templates
// epilogue and compact, over a key policy: F32Keys, I64Keys).
//
// What bounds it on this card: the latency of dependent DRAM gathers,
// and the bytes of the windows.  A query waits on a chain of reads
// (radix table -> segment tables -> window keys -> payload or CSR
// offsets -> link keys), each a DRAM round trip at 36.75M slots; and
// at 2^20 sorted queries the flat windows together cover most of the
// slot keys, so the kernel streams nearly the whole key array as well.
// The L1 request rate of a per-thread window scan is not what limits
// it: on the H100 a coalesced count at the same register count ran no
// faster than the one-thread-per-query scan; more resident warps and
// fewer bytes did (PERF.md).  What the design does about it:
//
//   * 32 registers a thread, eight 256-thread CTAs an SM: 64 resident
//     warps (the earlier kernel had 32) to overlap the round trips.
//   * Several tiles per CTA.  With q_tile 32 a CTA runs up to 8 tiles,
//     one warp each; a small batch keeps one tile per CTA so its few
//     tiles spread over the SMs (lookup.fused_launch_shape picks).  A
//     one-warp tile compacts its escapes by ballot alone, with no CTA
//     barrier; a larger tile still takes a prefix over its warps.  Each
//     tile writes its own fb_loc / fb_cnt.
//   * Coalesced flat rank on the hi halves.  For each of a warp's 32
//     queries in turn (broadcast by shuffle) the lanes read 32
//     consecutive hi keys and __ballot_sync + __popc count those below
//     q, in (flat_w + 1) / 32 full rounds; the (flat_w + 1) % 32 keys
//     past them each thread reads for its own query.  A key whose hi
//     half equals q's (a tie) is decided by its lo half, which only the
//     ties load, so the lo array is mostly not read.  The count equals
//     the plain version's literal count.
//   * found from the count: with the window unclipped on the left and
//     1 <= rank <= flat_w the key at slot is the last counted one, and
//     it equals q exactly when some counted key does, because the slot
//     keys are non-decreasing (a gap carries its right neighbour's key,
//     the padding is +inf); other cases read the key at slot.
//   * Whole-window mode stages the tile's 2 * w_tile window (hi, and lo
//     when key_wide) in shared memory once, with 16-B loads where
//     aligned, and each query bisects it for the upper bound, which is
//     the literal count for non-decreasing keys.  A window too large
//     for shared memory is bisected in place.
//   * The payload gather and the chain bisect stay in global memory;
//     the payload is read only when found, the chain only when not.
//
// Numerics: compile with -fmad=false; lo0 and the radix bucket are
// written with __fmul_rn/__fadd_rn/__fsub_rn besides, so no product is
// contracted into an FMA and the result equals torch's separate mul and
// add bit for bit.  Wide keys keep the reference's order of operations:
// (q - rv0) + (ql - rv1) and (q - segk) + (ql - segk_lo).  Clips come
// first, then a C cast truncates, as astype(int32) does.  A NaN (only
// possible for +inf padding queries) clips to 0, as the plain torch
// version's nan_to_num does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;           // 1,024 threads
constexpr int kSmallCta = 256;          // up to 8 tiles of 32 queries
constexpr int kSmallCtaPerSm = 8;       // -> 32 registers a thread

struct Args {
  const float* q;           // (Qpad,) sorted, +inf padded
  const float* ql;          // (Qpad,) when key_wide
  const int* tile_block;    // (Qpad / q_tile,)
  const int* radix_table;   // (r_size,)
  const float* radix_scale; // (3,) [kmin_hi, kmin_lo, scale]
  const float* segk;        // (Kpad,)
  const float* segkl;       // (Kpad,) when key_wide
  const float* slope;       // (Kpad,)
  const float* iclo;        // (Kpad,) icept + err_lo - 1
  const float* sk;          // (Mpad,)
  const float* skl;         // (Mpad,) when key_wide
  const int* pay;           // (Mpad,)
  const int* payhi;         // (Mpad,) when wide
  const int* off;           // (Mpad + w_tile,)
  const float* lk;          // (Lpad,)
  const float* lkl;         // (Lpad,) when key_wide
  const int* lp;            // (Lpad,)
  const int* lph;           // (Lpad,) when wide
  int* slot;
  int* res;
  int* out;
  int* outhi;
  uint8_t* fb;
  int* fbloc;
  int* fbcnt;
  int num_tiles;
  int q_tile;
  int tiles_per_cta;
  int stage_window;         // whole-window mode: window in shared memory
  int r_size;
  int l_size;
  int w_tile;
  int flat_w;
  int trips;                // chain bisect trips, 0 without links
  float slot_hi;            // f32(n_slots - 1), the clip bound
  int key_wide;
  int wide;
};

__device__ __forceinline__ float clip_f(float v, float hi) {
  // fmaxf maps NaN to 0; torch.clamp + nan_to_num does the same
  return fminf(fmaxf(v, 0.0f), hi);
}

__device__ __forceinline__ bool ple(float kh, float kl, float qh, float ql,
                                    int key_wide) {
  return key_wide ? (kh < qh) || (kh == qh && kl <= ql) : kh <= qh;
}

// Copy n floats from src (global) to dst (shared) with the q_tile
// threads of one tile; 16-B loads when both ends allow.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int t, int nt) {
  if (((reinterpret_cast<uintptr_t>(src) & 15) == 0) && (n & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = t; k < (n >> 2); k += nt) d4[k] = __ldg(s4 + k);
  } else {
    for (int k = t; k < n; k += nt) dst[k] = __ldg(src + k);
  }
}

// The keys the epilogue compares, one policy per image: f32 keys (an f32
// (hi, lo) pair when key_wide; the window may sit in shared memory) ...
struct F32Keys {
  const float* wh;          // the tile's window: hi (or only) halves
  const float* wl;          // lo halves when key_wide
  const float* lk;
  const float* lkl;
  float q, ql;
  int key_wide;
  __device__ __forceinline__ bool window_eq(int s) const {
    return wh[s] == q && (!key_wide || wl[s] == ql);
  }
  __device__ __forceinline__ bool link_le(int m) const {
    return ple(__ldg(lk + m), key_wide ? __ldg(lkl + m) : 0.0f, q, ql,
               key_wide);
  }
  __device__ __forceinline__ bool link_eq(int m) const {
    return __ldg(lk + m) == q && (!key_wide || __ldg(lkl + m) == ql);
  }
};

// ... and ordered int64 keys (the 64-bit image), compared in one op.
struct I64Keys {
  const long long* wk;      // the tile's window
  const long long* lk;
  long long q;
  __device__ __forceinline__ bool window_eq(int s) const {
    return __ldg(wk + s) == q;
  }
  __device__ __forceinline__ bool link_le(int m) const {
    return __ldg(lk + m) <= q;
  }
  __device__ __forceinline__ bool link_eq(int m) const {
    return __ldg(lk + m) == q;
  }
};

// Both kernels' epilogue for query i of a live tile: found (from the
// flat count when found_known, else the key at slot), payload, the CSR
// chain bisect of a.trips trips when not found, and the five outputs.
template <class A, class K>
__device__ __forceinline__ void epilogue(const A& a, const K& k, int i,
                                         int base, int slot, bool fb,
                                         bool found_known, bool found_flat) {
  const int two_w = 2 * a.w_tile;
  const int sloc = slot - base;
  const bool okx = slot >= 0 && sloc >= 0 && sloc < two_w;
  const int slc = min(max(sloc, 0), two_w - 1);
  const bool found = found_known ? okx && found_flat
                                 : okx && k.window_eq(slc);
  int out = found ? __ldg(a.pay + base + slc) : -1;
  int out_hi = (a.wide && found) ? __ldg(a.payhi + base + slc) : -1;
  bool resolved = found;
  if (a.trips > 0 && okx && !found) {
    const int start = __ldg(a.off + base + slc);
    const int end = __ldg(a.off + base + slc + 1);
    if (end > start) {
      const int l_max = a.l_size - 1;
      int lo = start - 1, hi = end - 1;
      for (int trip = 0; trip < a.trips && lo < hi; ++trip) {
        const int mid = (lo + hi + 1) >> 1;
        if (k.link_le(min(max(mid, 0), l_max))) lo = mid; else hi = mid - 1;
      }
      const int locc = min(max(lo, 0), l_max);
      if (lo >= start && k.link_eq(locc)) {
        out = __ldg(a.lp + locc);
        if (a.wide) out_hi = __ldg(a.lph + locc);
        resolved = true;
      }
    }
  }
  a.slot[i] = slot;
  a.res[i] = resolved ? 1 : 0;
  a.out[i] = out;
  if (a.wide) a.outhi[i] = out_hi;
  a.fb[i] = fb ? 1 : 0;
}

// Both kernels' per-tile compaction of the escape flags into fb_loc /
// fb_cnt: ballot + prefix over the tile's warps (a one-warp tile by
// ballot alone, with no CTA barrier).  Every thread of the CTA calls it.
template <class A>
__device__ __forceinline__ void compact(const A& a, int* warp_cnt, int t,
                                        int tl, int loc, int tile, bool live,
                                        bool fb) {
  const int qt = a.q_tile;
  const int lane = t & 31;
  const unsigned mask = __ballot_sync(kFull, fb);
  if (qt == 32) {                           // one warp, no barrier
    if (!live) return;
    int* tile_loc = a.fbloc + static_cast<size_t>(tile) * 32;
    const int count = __popc(mask);
    if (fb) tile_loc[__popc(mask & ((1u << lane) - 1u))] = loc;
    if (loc >= count) tile_loc[loc] = 32;
    if (loc == 0) a.fbcnt[tile] = count;
    return;
  }
  const int warp = t >> 5;
  if (lane == 0) warp_cnt[warp] = __popc(mask);
  __syncthreads();
  if (!live) return;
  const int w0 = (tl * qt) >> 5;            // the tile's first warp
  const int n_warps = qt >> 5;
  int before = 0, count = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = warp_cnt[w0 + w];
    before += (w0 + w < warp) ? c : 0;
    count += c;
  }
  int* tile_loc = a.fbloc + static_cast<size_t>(tile) * qt;
  if (fb) tile_loc[before + __popc(mask & ((1u << lane) - 1u))] = loc;
  if (loc >= count) tile_loc[loc] = qt;
  if (loc == 0) a.fbcnt[tile] = count;
}

template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
fused_lookup_kernel(Args a) {
  extern __shared__ float4 win_raw[];       // 16-B aligned
  __shared__ int warp_cnt[kMaxWarps];
  float* win_smem = reinterpret_cast<float*>(win_raw);
  const int qt = a.q_tile;
  const int t = threadIdx.x;
  const int tl = t / qt;                    // tile within the CTA
  const int loc = t - tl * qt;              // query within the tile
  const int tile = blockIdx.x * a.tiles_per_cta + tl;
  const bool live = tile < a.num_tiles;     // whole warps live or not
  const int lane = t & 31;
  const int two_w = 2 * a.w_tile;
  const int base = live ? __ldg(a.tile_block + tile) * a.w_tile : 0;

  // the tile's window keys: staged in shared memory (whole-window
  // mode) or read in place
  const float* wh = a.sk + base;
  const float* wl = a.key_wide ? a.skl + base : nullptr;
  if (a.stage_window) {
    float* sh = win_smem + static_cast<size_t>(tl) * two_w
        * (a.key_wide ? 2 : 1);
    if (live) {
      stage(sh, wh, two_w, loc, qt);
      if (a.key_wide) stage(sh + two_w, wl, two_w, loc, qt);
    }
    wh = sh;
    if (a.key_wide) wl = sh + two_w;
  }
  if (a.stage_window) __syncthreads();

  const int i = tile * qt + loc;
  int slot = 0;
  bool fb = false;
  bool found_known = false, found_flat = false;
  if (live) {
    const float q = __ldg(a.q + i);
    const float ql = a.key_wide ? __ldg(a.ql + i) : 0.0f;
    const bool finite = isfinite(q);

    if (a.flat_w > 0) {
      const float rv0 = __ldg(a.radix_scale);
      const float rv1 = __ldg(a.radix_scale + 1);
      const float rv2 = __ldg(a.radix_scale + 2);
      float x = __fsub_rn(q, rv0);
      if (a.key_wide) x = __fadd_rn(x, __fsub_rn(ql, rv1));
      const int bkt = (int)clip_f(__fmul_rn(x, rv2), (float)(a.r_size - 1));
      const int seg = __ldg(a.radix_table + bkt);
      float dx = __fsub_rn(q, __ldg(a.segk + seg));
      if (a.key_wide) dx = __fadd_rn(dx, __fsub_rn(ql, __ldg(a.segkl + seg)));
      const float v = floorf(
          __fadd_rn(__fmul_rn(__ldg(a.slope + seg), dx), __ldg(a.iclo + seg)));
      const int lo0 = (int)clip_f(v, a.slot_hi);
      const int loc0 = lo0 - base;

      // rank = the count of window keys <= q, taken on the hi halves
      // first: a key whose hi half is below q's counts, one whose hi
      // half equals q's (a tie) is decided by its lo half, which only
      // ties load.  Full rounds: the warp counts one query's 32
      // consecutive keys at a time.
      int rank = 0;
      bool anyeq = false;                   // some counted key == q
      const int full = (a.flat_w + 1) >> 5;
      for (int r = 0; r < full; ++r) {
        unsigned mytie = 0;
#pragma unroll 2
        for (int s = 0; s < 32; ++s) {
          const float qs = __shfl_sync(kFull, q, s);
          const int idx = __shfl_sync(kFull, loc0, s) + (r << 5) + lane;
          const bool inb = idx >= 0 && idx < two_w;
          const float kh = inb ? __ldg(wh + idx) : 0.0f;
          const bool lt = inb && (a.key_wide ? kh < qs : kh <= qs);
          const bool tie = inb && kh == qs;
          const int c = __popc(__ballot_sync(kFull, lt));
          const unsigned tm = __ballot_sync(kFull, tie);
          if (lane == s) {
            rank += c;
            mytie = tm;
          }
        }
        // this thread's query: its ties in round r (narrow keys: its
        // equal keys, already counted)
        while (mytie) {
          const int b = __ffs(mytie) - 1;
          mytie &= mytie - 1u;
          if (a.key_wide) {
            const float kl = __ldg(wl + loc0 + (r << 5) + b);
            rank += kl <= ql ? 1 : 0;
            anyeq = anyeq || kl == ql;
          } else {
            anyeq = true;
          }
        }
      }
      // the keys past the full rounds: each thread for its own query
      for (int j = full << 5; j <= a.flat_w; ++j) {
        const int idx = loc0 + j;
        if (idx >= 0 && idx < two_w) {
          const float kh = __ldg(wh + idx);
          if (a.key_wide ? kh < q : kh <= q) {
            ++rank;
            anyeq = anyeq || kh == q;       // narrow keys only
          } else if (a.key_wide && kh == q) {
            const float kl = __ldg(wl + idx);
            rank += kl <= ql ? 1 : 0;
            anyeq = anyeq || kl == ql;
          }
        }
      }
      slot = lo0 - 1 + min(rank, a.flat_w);
      const bool window_ok = loc0 >= 0 && loc0 + a.flat_w + 1 <= two_w;
      fb = (rank == 0 && lo0 > 0) || rank == a.flat_w + 1 || !window_ok;
      // with the window unclipped on the left and 1 <= rank <= flat_w,
      // the key at slot is the last one counted, which equals q exactly
      // when some counted key does (the keys are non-decreasing)
      found_known = loc0 >= 0 && rank >= 1 && rank <= a.flat_w;
      found_flat = anyeq;
    } else {
      // upper bound over the non-decreasing window keys
      int lo = 0, hi = two_w;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const float kl = a.key_wide ? wl[mid] : 0.0f;
        if (ple(wh[mid], kl, q, ql, a.key_wide)) lo = mid + 1; else hi = mid;
      }
      const int rank = lo;
      slot = base + rank - 1;
      fb = (rank == 0 && base > 0) || rank == two_w;
    }
    fb = fb && finite;
    const F32Keys k{wh, wl, a.lk, a.lkl, q, ql, a.key_wide};
    epilogue(a, k, i, base, slot, fb, found_known, found_flat);
  }
  compact(a, warp_cnt, t, tl, loc, tile, live, fb);
}

}  // namespace

// ``outs`` is one int32 buffer: slot, res, out, fb_loc (n_q each),
// fb_cnt (num_tiles), then out_hi (n_q) when wide; ``fb`` is n_q bytes.
// ``smem`` is the dynamic shared memory of whole-window staging (0: the
// window is read in place).
extern "C" int fused_lookup_launch(
    const void* q, const void* ql, const void* tile_block,
    const void* radix_table, const void* radix_scale, const void* segk,
    const void* segkl, const void* slope, const void* iclo, const void* sk,
    const void* skl, const void* pay, const void* payhi, const void* off,
    const void* lk, const void* lkl, const void* lp, const void* lph,
    void* outs, void* fb, int num_tiles, int q_tile, int tiles_per_cta,
    int smem, int r_size, int l_size, int w_tile, int flat_w, int trips,
    float slot_hi, int key_wide, int wide, void* stream) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.ql = static_cast<const float*>(ql);
  a.tile_block = static_cast<const int*>(tile_block);
  a.radix_table = static_cast<const int*>(radix_table);
  a.radix_scale = static_cast<const float*>(radix_scale);
  a.segk = static_cast<const float*>(segk);
  a.segkl = static_cast<const float*>(segkl);
  a.slope = static_cast<const float*>(slope);
  a.iclo = static_cast<const float*>(iclo);
  a.sk = static_cast<const float*>(sk);
  a.skl = static_cast<const float*>(skl);
  a.pay = static_cast<const int*>(pay);
  a.payhi = static_cast<const int*>(payhi);
  a.off = static_cast<const int*>(off);
  a.lk = static_cast<const float*>(lk);
  a.lkl = static_cast<const float*>(lkl);
  a.lp = static_cast<const int*>(lp);
  a.lph = static_cast<const int*>(lph);
  const size_t n = static_cast<size_t>(num_tiles) * q_tile;
  int* o = static_cast<int*>(outs);
  a.slot = o;
  a.res = o + n;
  a.out = o + 2 * n;
  a.fbloc = o + 3 * n;
  a.fbcnt = o + 4 * n;
  a.outhi = o + 4 * n + num_tiles;
  a.fb = static_cast<uint8_t*>(fb);
  a.num_tiles = num_tiles;
  a.q_tile = q_tile;
  a.tiles_per_cta = tiles_per_cta;
  a.stage_window = smem > 0 && flat_w == 0 ? 1 : 0;
  a.r_size = r_size;
  a.l_size = l_size;
  a.w_tile = w_tile;
  a.flat_w = flat_w;
  a.trips = trips;
  a.slot_hi = slot_hi;
  a.key_wide = key_wide;
  a.wide = wide;
  // up to 256 threads: 32 registers, eight CTAs (64 warps) an SM; more
  // (q_tile 512, 1,024): one tile a CTA at the compiler's register count
  const int threads = tiles_per_cta * q_tile;
  void (*kernel)(Args) = threads <= kSmallCta
      ? fused_lookup_kernel<kSmallCta, kSmallCtaPerSm>
      : fused_lookup_kernel<kMaxWarps * 32, 1>;
  // static and dynamic shared memory together past 48 KiB need the
  // opt-in
  if (smem + kMaxWarps * static_cast<int>(sizeof(int)) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles > 0) {
    const int ctas = (num_tiles + tiles_per_cta - 1) / tiles_per_cta;
    kernel<<<ctas, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The 64-bit image: ordered int64 keys, float64 segment lines.
// ---------------------------------------------------------------------

namespace {

constexpr long long kNoKey = 0x7fffffffffffffffLL;

struct Args64 {
  const long long* q;         // (Qpad,) sorted, kNoKey padded
  const int* tile_block;      // (Qpad / q_tile,)
  const int* radix_table;     // (r_size,)
  const long long* radix_key; // (1,) kmin
  const double* radix_scale;  // (1,)
  const long long* segk;      // (Kpad,)
  const double* slope;        // (Kpad,)
  const double* iclo;         // (Kpad,) icept + err_lo - 1
  const long long* sk;        // (Mpad,)
  const int* pay;             // (Mpad,)
  const int* payhi;           // (Mpad,) when wide
  const int* off;             // (Mpad + w_tile,)
  const long long* lk;        // (Lpad,)
  const int* lp;              // (Lpad,)
  const int* lph;             // (Lpad,) when wide
  int* slot;
  int* res;
  int* out;
  int* outhi;
  uint8_t* fb;
  int* fbloc;
  int* fbcnt;
  int num_tiles;
  int q_tile;
  int tiles_per_cta;
  int r_size;
  int l_size;
  int w_tile;
  int flat_w;
  int trips;
  int slot_hi;                // n_slots - 1, the clip bound
  int wide;
};

// float64(a - b), rounded once (see the header)
__device__ __forceinline__ double exact_dx(long long a, long long b) {
  const double hi = (double)((a >> 32) - (b >> 32));
  const double lo = (double)((a & 0xffffffffLL) - (b & 0xffffffffLL));
  return __dadd_rn(__dmul_rn(hi, 4294967296.0), lo);
}

__device__ __forceinline__ double clip_d(double v, double hi) {
  // fmax maps NaN to 0, as torch.clamp + nan_to_num does
  return fmin(fmax(v, 0.0), hi);
}

template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
fused_lookup64_kernel(Args64 a) {
  __shared__ int warp_cnt[kMaxWarps];
  const int qt = a.q_tile;
  const int t = threadIdx.x;
  const int tl = t / qt;
  const int loc = t - tl * qt;
  const int tile = blockIdx.x * a.tiles_per_cta + tl;
  const bool live = tile < a.num_tiles;
  const int lane = t & 31;
  const int two_w = 2 * a.w_tile;
  const int base = live ? __ldg(a.tile_block + tile) * a.w_tile : 0;
  const long long* wk = a.sk + base;

  const int i = tile * qt + loc;
  int slot = 0;
  bool fb = false;
  bool found_known = false, found_flat = false;
  if (live) {
    const long long q = __ldg(a.q + i);
    const bool real = q != kNoKey;

    if (a.flat_w > 0) {
      const double x = exact_dx(q, __ldg(a.radix_key));
      const int bkt = (int)clip_d(__dmul_rn(x, __ldg(a.radix_scale)),
                                  (double)(a.r_size - 1));
      const int seg = __ldg(a.radix_table + bkt);
      const double v = floor(__dadd_rn(
          __dmul_rn(__ldg(a.slope + seg), exact_dx(q, __ldg(a.segk + seg))),
          __ldg(a.iclo + seg)));
      const int lo0 = (int)clip_d(v, (double)a.slot_hi);
      const int loc0 = lo0 - base;

      // rank = the count of window keys <= q: full rounds count one
      // query's 32 consecutive keys at a time across the warp
      int rank = 0;
      bool anyeq = false;
      const int full = (a.flat_w + 1) >> 5;
      for (int r = 0; r < full; ++r) {
#pragma unroll 2
        for (int s = 0; s < 32; ++s) {
          const long long qs = __shfl_sync(kFull, q, s);
          const int idx = __shfl_sync(kFull, loc0, s) + (r << 5) + lane;
          const bool inb = idx >= 0 && idx < two_w;
          const long long kv = inb ? __ldg(wk + idx) : 0;
          const int c = __popc(__ballot_sync(kFull, inb && kv <= qs));
          const unsigned eq = __ballot_sync(kFull, inb && kv == qs);
          if (lane == s) {
            rank += c;
            anyeq = anyeq || eq != 0u;
          }
        }
      }
      for (int j = full << 5; j <= a.flat_w; ++j) {
        const int idx = loc0 + j;
        if (idx >= 0 && idx < two_w) {
          const long long kv = __ldg(wk + idx);
          if (kv <= q) {
            ++rank;
            anyeq = anyeq || kv == q;
          }
        }
      }
      slot = lo0 - 1 + min(rank, a.flat_w);
      const bool window_ok = loc0 >= 0 && loc0 + a.flat_w + 1 <= two_w;
      fb = (rank == 0 && lo0 > 0) || rank == a.flat_w + 1 || !window_ok;
      found_known = loc0 >= 0 && rank >= 1 && rank <= a.flat_w;
      found_flat = anyeq;
    } else {
      int lo = 0, hi = two_w;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(wk + mid) <= q) lo = mid + 1; else hi = mid;
      }
      slot = base + lo - 1;
      fb = (lo == 0 && base > 0) || lo == two_w;
    }
    fb = fb && real;
    const I64Keys k{wk, a.lk, q};
    epilogue(a, k, i, base, slot, fb, found_known, found_flat);
  }
  compact(a, warp_cnt, t, tl, loc, tile, live, fb);
}

}  // namespace

// The 64-bit image's launch: ``outs`` and ``fb`` as fused_lookup_launch
// lays them out; no shared memory beyond the warp counts.
extern "C" int fused_lookup64_launch(
    const void* q, const void* tile_block, const void* radix_table,
    const void* radix_key, const void* radix_scale, const void* segk,
    const void* slope, const void* iclo, const void* sk, const void* pay,
    const void* payhi, const void* off, const void* lk, const void* lp,
    const void* lph, void* outs, void* fb, int num_tiles, int q_tile,
    int tiles_per_cta, int r_size, int l_size, int w_tile, int flat_w,
    int trips, int slot_hi, int wide, void* stream) {
  Args64 a;
  a.q = static_cast<const long long*>(q);
  a.tile_block = static_cast<const int*>(tile_block);
  a.radix_table = static_cast<const int*>(radix_table);
  a.radix_key = static_cast<const long long*>(radix_key);
  a.radix_scale = static_cast<const double*>(radix_scale);
  a.segk = static_cast<const long long*>(segk);
  a.slope = static_cast<const double*>(slope);
  a.iclo = static_cast<const double*>(iclo);
  a.sk = static_cast<const long long*>(sk);
  a.pay = static_cast<const int*>(pay);
  a.payhi = static_cast<const int*>(payhi);
  a.off = static_cast<const int*>(off);
  a.lk = static_cast<const long long*>(lk);
  a.lp = static_cast<const int*>(lp);
  a.lph = static_cast<const int*>(lph);
  const size_t n = static_cast<size_t>(num_tiles) * q_tile;
  int* o = static_cast<int*>(outs);
  a.slot = o;
  a.res = o + n;
  a.out = o + 2 * n;
  a.fbloc = o + 3 * n;
  a.fbcnt = o + 4 * n;
  a.outhi = o + 4 * n + num_tiles;
  a.fb = static_cast<uint8_t*>(fb);
  a.num_tiles = num_tiles;
  a.q_tile = q_tile;
  a.tiles_per_cta = tiles_per_cta;
  a.r_size = r_size;
  a.l_size = l_size;
  a.w_tile = w_tile;
  a.flat_w = flat_w;
  a.trips = trips;
  a.slot_hi = slot_hi;
  a.wide = wide;
  const int threads = tiles_per_cta * q_tile;
  void (*kernel)(Args64) = threads <= kSmallCta
      ? fused_lookup64_kernel<kSmallCta, kSmallCtaPerSm>
      : fused_lookup64_kernel<kMaxWarps * 32, 1>;
  if (num_tiles > 0) {
    const int ctas = (num_tiles + tiles_per_cta - 1) / tiles_per_cta;
    kernel<<<ctas, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
