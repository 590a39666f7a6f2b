// Fused learned-index lookup for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lookup.py::fused_lookup_call
// (body _fused_kernel, lookup.py:215-412): one launch per batch carries
// each sorted query from raw key to payload.
//
//   1. radix route to a segment: one multiply + one table gather;
//   2. window base lo0 = floor(slope * dx + icept_fold), clipped;
//   3. flat mode (flat_w > 0): rank over the flat_w + 1 slot keys from
//      lo0; whole-window mode (flat_w == 0): rank over all 2 * w_tile
//      slot keys of the tile's window;
//   4. found + payload gather (i32, or an i32 hi/lo pair when wide);
//   5. CSR chain bisect of bit_length(max_chain) trips;
//   6. escape flags and the per-tile compaction into fb_loc / fb_cnt.
//
// Compares are lexicographic on f32 (hi, lo) pairs when key_wide.
//
// What bounds it on this card: bytes.  Per query it does a few dozen
// compares against dependent gathers (radix table -> segment tables ->
// slot keys -> payload -> CSR offsets -> link keys), so it is a
// memory-bound gather and compare with an arithmetic intensity far
// below the H100's ridge point.  What the design does about it: one CTA
// per query tile of sorted queries and one thread per query, so the
// tile's queries read neighbouring slot keys and their gathers fall on
// the same cache lines (the window is the tile's two w_tile blocks,
// 16 KiB of keys at w_tile = 2048, which L1/L2 hold); every read goes
// through the read-only path (__ldg); the TPU's (q_tile x q_tile)
// one-hot compaction matrices become one warp ballot and a block prefix
// sum.  Shared-memory staging of the window and cp.async/TMA are left
// for later work.
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

__global__ void fused_lookup_kernel(Args a) {
  __shared__ int warp_cnt[32];
  const int tile = blockIdx.x;
  const int qt = blockDim.x;
  const int t = threadIdx.x;
  const int i = tile * qt + t;
  const int two_w = 2 * a.w_tile;
  const int base = __ldg(a.tile_block + tile) * a.w_tile;

  const float q = __ldg(a.q + i);
  const float ql = a.key_wide ? __ldg(a.ql + i) : 0.0f;
  const bool finite = isfinite(q);

  int slot;
  bool fb;
  if (a.flat_w > 0) {
    const float rv0 = __ldg(a.radix_scale);
    const float rv1 = __ldg(a.radix_scale + 1);
    const float rv2 = __ldg(a.radix_scale + 2);
    float x = __fsub_rn(q, rv0);
    if (a.key_wide) x = __fadd_rn(x, __fsub_rn(ql, rv1));
    int bkt = (int)clip_f(__fmul_rn(x, rv2), (float)(a.r_size - 1));
    const int seg = __ldg(a.radix_table + bkt);
    float dx = __fsub_rn(q, __ldg(a.segk + seg));
    if (a.key_wide) dx = __fadd_rn(dx, __fsub_rn(ql, __ldg(a.segkl + seg)));
    const float v = floorf(
        __fadd_rn(__fmul_rn(__ldg(a.slope + seg), dx), __ldg(a.iclo + seg)));
    const int lo0 = (int)clip_f(v, a.slot_hi);
    const int loc0 = lo0 - base;
    int rank = 0;
    for (int j = 0; j <= a.flat_w; ++j) {
      const int idx = loc0 + j;
      const bool inb = idx >= 0 && idx < two_w;
      const int idxc = min(max(idx, 0), two_w - 1);
      const float kh = __ldg(a.sk + base + idxc);
      const float kl = a.key_wide ? __ldg(a.skl + base + idxc) : 0.0f;
      rank += (inb && ple(kh, kl, q, ql, a.key_wide)) ? 1 : 0;
    }
    slot = lo0 - 1 + min(rank, a.flat_w);
    const bool window_ok = loc0 >= 0 && loc0 + a.flat_w + 1 <= two_w;
    fb = (rank == 0 && lo0 > 0) || rank == a.flat_w + 1 || !window_ok;
  } else {
    int rank = 0;
    for (int k = 0; k < two_w; ++k) {
      const float kh = __ldg(a.sk + base + k);
      const float kl = a.key_wide ? __ldg(a.skl + base + k) : 0.0f;
      rank += ple(kh, kl, q, ql, a.key_wide) ? 1 : 0;
    }
    slot = base + rank - 1;
    fb = (rank == 0 && base > 0) || rank == two_w;
  }
  fb = fb && finite;

  // ---- epilogue: found + payload + CSR chain bisect ------------------
  const int sloc = slot - base;
  const bool okx = slot >= 0 && sloc >= 0 && sloc < two_w;
  const int slc = min(max(sloc, 0), two_w - 1);
  bool found = okx && __ldg(a.sk + base + slc) == q;
  if (a.key_wide) found = found && __ldg(a.skl + base + slc) == ql;
  int out = found ? __ldg(a.pay + base + slc) : -1;
  int out_hi = (a.wide && found) ? __ldg(a.payhi + base + slc) : -1;
  bool resolved = found;
  if (a.trips > 0) {
    const int start = __ldg(a.off + base + slc);
    const int end = __ldg(a.off + base + slc + 1);
    const bool scan = okx && !found && end > start;
    const int l_max = a.l_size - 1;
    int lo = start - 1, hi = end - 1;
    for (int trip = 0; trip < a.trips; ++trip) {
      const bool upd = lo < hi;
      const int mid = (lo + hi + 1) >> 1;
      const int midc = min(max(mid, 0), l_max);
      const float kh = __ldg(a.lk + midc);
      const float kl = a.key_wide ? __ldg(a.lkl + midc) : 0.0f;
      const bool go = ple(kh, kl, q, ql, a.key_wide);
      if (upd) {
        if (go) lo = mid; else hi = mid - 1;
      }
    }
    const int locc = min(max(lo, 0), l_max);
    bool eq = __ldg(a.lk + locc) == q;
    if (a.key_wide) eq = eq && __ldg(a.lkl + locc) == ql;
    const bool hit = scan && lo >= start && eq;
    if (hit) {
      out = __ldg(a.lp + locc);
      if (a.wide) out_hi = __ldg(a.lph + locc);
    }
    resolved = resolved || hit;
  }

  a.slot[i] = slot;
  a.res[i] = resolved ? 1 : 0;
  a.out[i] = out;
  if (a.wide) a.outhi[i] = out_hi;
  a.fb[i] = fb ? 1 : 0;

  // ---- per-tile compaction: ballot + block prefix sum -----------------
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = qt >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, fb);
  if (lane == 0) warp_cnt[warp] = __popc(mask);
  __syncthreads();
  int before = 0, count = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = warp_cnt[w];
    before += (w < warp) ? c : 0;
    count += c;
  }
  int* tile_loc = a.fbloc + tile * qt;
  if (fb) tile_loc[before + __popc(mask & ((1u << lane) - 1u))] = t;
  if (t >= count) tile_loc[t] = qt;
  if (t == 0) a.fbcnt[tile] = count;
}

}  // namespace

extern "C" int fused_lookup_launch(
    const void* q, const void* ql, const void* tile_block,
    const void* radix_table, const void* radix_scale, const void* segk,
    const void* segkl, const void* slope, const void* iclo, const void* sk,
    const void* skl, const void* pay, const void* payhi, const void* off,
    const void* lk, const void* lkl, const void* lp, const void* lph,
    void* slot, void* res, void* out, void* outhi, void* fb, void* fbloc,
    void* fbcnt, int num_tiles, int q_tile, int r_size, int l_size,
    int w_tile, int flat_w, int trips, float slot_hi, int key_wide,
    int wide, void* stream) {
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
  a.slot = static_cast<int*>(slot);
  a.res = static_cast<int*>(res);
  a.out = static_cast<int*>(out);
  a.outhi = static_cast<int*>(outhi);
  a.fb = static_cast<uint8_t*>(fb);
  a.fbloc = static_cast<int*>(fbloc);
  a.fbcnt = static_cast<int*>(fbcnt);
  a.r_size = r_size;
  a.l_size = l_size;
  a.w_tile = w_tile;
  a.flat_w = flat_w;
  a.trips = trips;
  a.slot_hi = slot_hi;
  a.key_wide = key_wide;
  a.wide = wide;
  if (num_tiles > 0) {
    fused_lookup_kernel<<<num_tiles, q_tile, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
