// §5.3 ingest placement primitives for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gap_place.py::ingest_place_call
// (body _ingest_place_kernel -> ingest_place_body, gap_place.py:134-237,
// 307-341, 616-653).  For each insert key x (an f32 hi/lo pair):
//
//   1. segment route: rightmost segment first key <= x (pair order);
//   2. predicted slot p = clip(rint(slope * (x - seg_key) + icept)) in
//      double-f32 (Dekker/Knuth two_sum / two_prod), with a +-1 step
//      from the low half and an escape flag for predictions inside the
//      band (|sl*dx| + |ic| + 4) * 2e-9 around .5, a non-finite
//      prediction, or a rounding near either clip edge;
//   3. free: the slot key at p equals its right neighbour's (carried
//      keys);
//   4. ub: rightmost slot key <= x; pv: rightmost slot key < key[p];
//   5. bracket: free, left boundary key (raised to its CSR chain max)
//      < x < key[p].
//
// Outputs p, pv, ub and flags = free | 2*bracket | 4*escape (all i32).
//
// What bounds it on this card: the latency of dependent loads.  Per key
// it moves a few dozen bytes and does ~100 flops, far below both the
// memory rate and the ridge point; what takes the time is the chain of
// reads each key waits on.  The slot arrays (67 MB each at 16.65M
// slots) exceed the 50 MB L2, so every step of a search that leaves
// the lines already fetched is a DRAM round trip.  What the design does
// about it:
//
//   * Search from the prediction.  The slot keys are non-decreasing in
//     pair order over [0, Mpad) (a gap carries its right neighbour's
//     key, the tail and the padding are +inf), so "key <= x" and
//     "key < key[p]" each hold on a prefix, and the rightmost index of
//     that prefix is unique.  ub is found by an exponential search from
//     p (right when key[p] <= x, else left), then a bisect inside the
//     bracket; pv by an exponential search left from p (key[p] < key[p]
//     is false).  The two searches advance in lockstep, so their loads
//     are in flight together.  Both array ends are read first (lines
//     every key shares): a key below the first slot gets ub = -1, one
//     at or above the last (the +inf padding rows) ub = Mpad - 1, and
//     pv = -1 when key[0] already equals key[p], without a walk.  A key
//     whose answer lies d slots from p costs about 2 log2(d) probes,
//     most of them in the one or two 128-B lines around p, in place of
//     two 24-level bisects over the whole array.  The plain torch
//     version keeps the whole-array bisects, so every comparison on the
//     card checks this argument on real data.
//   * Route from shared memory.  The segment first keys (hi/lo) are
//     staged once per CTA, with 16-B loads where the tables allow, and
//     bisected there.  Up to kSegStage keys are staged whole; a larger
//     table stages every 2^k-th key (the top levels) and finishes the
//     bisect over the 2^k keys in global memory, with the same result.
//   * Fill the card.  64 threads per CTA: 16,384 keys make 256 CTAs, two
//     on nearly every one of the 132 SMs (256-thread CTAs left 68 SMs
//     idle).  Latency-bound work wants every SM busy.
//
// Numerics: compile with -fmad=false, and every product and sum of the
// pair arithmetic is spelled __fmul_rn / __fadd_rn / __fsub_rn besides,
// so nothing is contracted into an FMA and each step equals the plain
// torch version's separate op.  rintf rounds half to even (jnp.round);
// the clip runs fmaxf then fminf, so a NaN prediction clips to -1, as
// the plain version's isnan branch does; a C cast then truncates, as
// astype(int32) does.  n_slots meets the f32 operands as (float)n_slots;
// the band scale 2e-9f is the f32 nearest 2e-9, as jnp.float32(2e-9).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSplitter = 4097.0f;  // 2^12 + 1, Veltkamp split for f32
constexpr float kTolScale = 2e-9f;
constexpr int kThreads = 64;
constexpr int kSegStage = 2048;       // staged segment keys (16 KiB hi+lo)

struct Args {
  const float* x_hi;     // (B,)
  const float* x_lo;     // (B,)
  const float* segk;     // (Kpad,)
  const float* segkl;    // (Kpad,) when seg_lo, else read as 0
  const float* slope;    // (Kpad,)
  const float* slopel;   // (Kpad,)
  const float* icept;    // (Kpad,)
  const float* iceptl;   // (Kpad,)
  const float* sk;       // (Mpad,)
  const float* skl;      // (Mpad,) when slot_lo
  const int* off;        // (>= Mpad + 1,)
  const float* lk;       // (Lpad,)
  const float* lkl;      // (Lpad,) when link_lo
  int* p;
  int* pv;
  int* ub;
  int* flags;
  int n;
  int k_pad;
  int m_pad;
  int l_pad;
  int n_slots;
  int seg_lo;
  int slot_lo;
  int link_lo;
  int seg_shift;         // staged key j is segk[j << seg_shift]
};

struct Pair {
  float h, l;
};

__device__ __forceinline__ Pair two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  const float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return {s, e};
}

__device__ __forceinline__ Pair two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  const float ca = __fmul_rn(kSplitter, a);
  const float ah = __fsub_rn(ca, __fsub_rn(ca, a));
  const float al = __fsub_rn(a, ah);
  const float cb = __fmul_rn(kSplitter, b);
  const float bh = __fsub_rn(cb, __fsub_rn(cb, b));
  const float bl = __fsub_rn(b, bh);
  // ((ah*bh - p) + ah*bl + al*bh) + al*bl, left to right
  float e = __fsub_rn(__fmul_rn(ah, bh), p);
  e = __fadd_rn(e, __fmul_rn(ah, bl));
  e = __fadd_rn(e, __fmul_rn(al, bh));
  e = __fadd_rn(e, __fmul_rn(al, bl));
  return {p, e};
}

__device__ __forceinline__ Pair dd_add2(float ah, float al, float bh,
                                        float bl) {
  const Pair s = two_sum(ah, bh);
  const float e = __fadd_rn(s.l, __fadd_rn(al, bl));
  return two_sum(s.h, e);
}

__device__ __forceinline__ Pair dd_mul(float ah, float al, float bh,
                                       float bl) {
  const Pair p = two_prod(ah, bh);
  const float e = __fadd_rn(p.l, __fadd_rn(__fmul_rn(ah, bl),
                                           __fmul_rn(al, bh)));
  return two_sum(p.h, e);
}

__device__ __forceinline__ bool p_le(float kh, float kl, float qh, float ql) {
  return kh < qh || (kh == qh && kl <= ql);
}

__device__ __forceinline__ bool p_lt(float kh, float kl, float qh, float ql) {
  return kh < qh || (kh == qh && kl < ql);
}

__device__ __forceinline__ float ld(const float* t, int i, int has) {
  return has ? __ldg(t + i) : 0.0f;
}

// The rightmost true index of a predicate that holds on a prefix, kept
// as a bracket [lo, hi] (lo = -1: none known true).  g > 0 gallops:
// up from a true lo in steps 1, 2, 4, ..., or down below a false hi + 1
// in steps 1, 2, 4, ...; g == 0 bisects.  The first probe that turns
// the gallop ends it, and the bracket then holds the answer.
struct Search {
  int lo, hi, g;
  bool up;

  __device__ __forceinline__ bool open() const { return lo < hi; }

  __device__ __forceinline__ int probe() const {
    if (g == 0) return (lo + hi + 1) >> 1;
    const int s = min(g, hi - lo);   // stays inside the bracket
    return up ? lo + s : hi + 1 - s;
  }

  // true: lo = i (an upward gallop doubles, a downward one turns);
  // false: hi = i - 1 (a downward gallop doubles, an upward one turns).
  // A step clamped to the bracket closes it or turns the gallop, so g
  // never doubles past twice the bracket.
  __device__ __forceinline__ void step(int i, bool pred) {
    if (pred) {
      lo = i;
      g = up ? g << 1 : 0;
    } else {
      hi = i - 1;
      g = up ? 0 : g << 1;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
ingest_place_kernel(Args a) {
  __shared__ float seg_h[kSegStage];
  __shared__ float seg_l[kSegStage];

  // --- stage the segment first keys (every 2^seg_shift-th) -----------
  const int n_stage = ((a.k_pad - 1) >> a.seg_shift) + 1;
  const bool vec = a.seg_shift == 0 && (n_stage & 3) == 0
      && ((reinterpret_cast<uintptr_t>(a.segk)
           | (a.seg_lo ? reinterpret_cast<uintptr_t>(a.segkl) : 0)) & 15)
          == 0;
  if (vec) {
    const float4* h4 = reinterpret_cast<const float4*>(a.segk);
    const float4* l4 = reinterpret_cast<const float4*>(a.segkl);
    for (int j = threadIdx.x; j < (n_stage >> 2); j += kThreads) {
      reinterpret_cast<float4*>(seg_h)[j] = __ldg(h4 + j);
      reinterpret_cast<float4*>(seg_l)[j] =
          a.seg_lo ? __ldg(l4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int j = threadIdx.x; j < n_stage; j += kThreads) {
      seg_h[j] = __ldg(a.segk + (j << a.seg_shift));
      seg_l[j] = ld(a.segkl, j << a.seg_shift, a.seg_lo);
    }
  }
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float xh = __ldg(a.x_hi + i);
  const float xl = __ldg(a.x_lo + i);

  // the array ends every key shares (one line each, cached)
  const int last = a.m_pad - 1;
  const float s0_h = __ldg(a.sk);
  const float s0_l = ld(a.skl, 0, a.slot_lo);
  const float sn_h = __ldg(a.sk + last);
  const float sn_l = ld(a.skl, last, a.slot_lo);

  // --- segment routing: bisect the staged keys, then the stride -----
  int lo = -1, hi = n_stage - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p_le(seg_h[mid], seg_l[mid], xh, xl)) lo = mid; else hi = mid - 1;
  }
  if (a.seg_shift > 0 && lo >= 0) {
    lo <<= a.seg_shift;   // segk[lo] <= x is known
    hi = min(lo + (1 << a.seg_shift) - 1, a.k_pad - 1);
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      const bool go = p_le(__ldg(a.segk + mid), ld(a.segkl, mid, a.seg_lo),
                           xh, xl);
      if (go) lo = mid; else hi = mid - 1;
    }
  }
  const int seg = min(max(lo, 0), a.k_pad - 1);

  // --- double-f32 prediction + rint with escape band -----------------
  const float fk_h = __ldg(a.segk + seg);
  const float fk_l = ld(a.segkl, seg, a.seg_lo);
  const Pair dx = dd_add2(xh, xl, -fk_h, -fk_l);
  const float sl_h = __ldg(a.slope + seg);
  const float ic_h = __ldg(a.icept + seg);
  const Pair m = dd_mul(sl_h, __ldg(a.slopel + seg), dx.h, dx.l);
  const Pair y = dd_add2(m.h, m.l, ic_h, __ldg(a.iceptl + seg));
  const float rh = rintf(y.h);
  const float d = __fadd_rn(__fsub_rn(y.h, rh), y.l);
  const int step = d > 0.5f ? 1 : (d < -0.5f ? -1 : 0);
  const float nf = (float)a.n_slots;
  const float rh_c = fminf(fmaxf(rh, -1.0f), nf);  // NaN -> -1
  const int p = min(max((int)rh_c + step, 0), a.n_slots - 1);
  const float tol = __fmul_rn(
      __fadd_rn(__fadd_rn(fabsf(__fmul_rn(sl_h, dx.h)), fabsf(ic_h)), 4.0f),
      kTolScale);
  const float ad = fabsf(d);
  bool escape = fabsf(__fsub_rn(ad, 0.5f)) < tol;
  escape = escape || !isfinite(y.h);
  escape = escape || (rh <= 0.0f && ad > 0.4f);
  escape = escape || (rh >= (float)(a.n_slots - 1) && ad > 0.4f);

  // --- occupancy from the carried-key construction -------------------
  const float nx_h = __ldg(a.sk + p);
  const float nx_l = ld(a.skl, p, a.slot_lo);
  const bool r_valid = p + 1 < a.m_pad;
  const int r_i = min(p + 1, last);
  const float r_h = r_valid ? __ldg(a.sk + r_i) : __int_as_float(0x7f800000);
  const float r_l = r_valid ? ld(a.skl, r_i, a.slot_lo) : 0.0f;
  const bool free = nx_h == r_h && nx_l == r_l;

  // --- run boundaries from p: key-run ub, slot-run pv -----------------
  // ub: rightmost key <= x.  pv: rightmost key < key[p]; pm is the key
  // at max(pv, 0), which the bracket reads.
  Search u, v;
  if (!p_le(s0_h, s0_l, xh, xl)) {
    u = {-1, -1, 0, true};
  } else if (p_le(sn_h, sn_l, xh, xl)) {
    u = {last, last, 0, true};
  } else if (p_le(nx_h, nx_l, xh, xl)) {
    u = {p, last - 1, 1, true};   // key[last] > x
  } else {
    u = {0, p - 1, 1, false};     // key[0] <= x < key[p]
  }
  float pm_h = s0_h, pm_l = s0_l;
  if (p_lt(s0_h, s0_l, nx_h, nx_l)) {
    v = {0, p - 1, 1, false};     // key[0] < key[p], so p > 0
  } else {
    v = {-1, -1, 0, false};
  }
  while (u.open() || v.open()) {
    const bool uo = u.open(), vo = v.open();
    const int ui = uo ? u.probe() : 0;
    const int vi = vo ? v.probe() : 0;
    float uh = 0.f, ul = 0.f, vh = 0.f, vl = 0.f;
    if (uo) {
      uh = __ldg(a.sk + ui);
      ul = ld(a.skl, ui, a.slot_lo);
    }
    if (vo) {
      vh = __ldg(a.sk + vi);
      vl = ld(a.skl, vi, a.slot_lo);
    }
    if (uo) u.step(ui, p_le(uh, ul, xh, xl));
    if (vo) {
      const bool lt = p_lt(vh, vl, nx_h, nx_l);
      if (lt) {
        pm_h = vh;
        pm_l = vl;
      }
      v.step(vi, lt);
    }
  }
  const int ub = u.lo;
  const int pv = v.lo;

  // --- bracket: prev boundary key (incl. chain max) < key < next -----
  const int pv_safe = max(pv, 0);
  const int s0 = __ldg(a.off + pv_safe);
  const int e0 = __ldg(a.off + pv_safe + 1);
  if (a.l_pad > 0) {
    const int ci = min(max(e0 - 1, 0), a.l_pad - 1);
    const float cm_h = __ldg(a.lk + ci);
    const float cm_l = ld(a.lkl, ci, a.link_lo);
    if (e0 > s0 && p_lt(pm_h, pm_l, cm_h, cm_l)) {
      pm_h = cm_h;
      pm_l = cm_l;
    }
  }
  const bool prev_ok = pv < 0 || p_lt(pm_h, pm_l, xh, xl);
  const bool bracket = free && prev_ok && p_lt(xh, xl, nx_h, nx_l);

  a.p[i] = p;
  a.pv[i] = pv;
  a.ub[i] = ub;
  a.flags[i] = (free ? 1 : 0) + (bracket ? 2 : 0) + (escape ? 4 : 0);
}

}  // namespace

// Every pointer is one contiguous device array; ``outs`` is one int32
// buffer of 4 * n (p, pv, ub, flags in turn).
extern "C" int ingest_place_launch(
    const void* x_hi, const void* x_lo, const void* segk, const void* segkl,
    const void* slope, const void* slopel, const void* icept,
    const void* iceptl, const void* sk, const void* skl, const void* off,
    const void* lk, const void* lkl, void* outs, int n, int k_pad,
    int m_pad, int l_pad, int n_slots, int seg_lo, int slot_lo,
    int link_lo, void* stream) {
  Args a;
  a.x_hi = static_cast<const float*>(x_hi);
  a.x_lo = static_cast<const float*>(x_lo);
  a.segk = static_cast<const float*>(segk);
  a.segkl = static_cast<const float*>(segkl);
  a.slope = static_cast<const float*>(slope);
  a.slopel = static_cast<const float*>(slopel);
  a.icept = static_cast<const float*>(icept);
  a.iceptl = static_cast<const float*>(iceptl);
  a.sk = static_cast<const float*>(sk);
  a.skl = static_cast<const float*>(skl);
  a.off = static_cast<const int*>(off);
  a.lk = static_cast<const float*>(lk);
  a.lkl = static_cast<const float*>(lkl);
  int* o = static_cast<int*>(outs);
  a.p = o;
  a.pv = o + n;
  a.ub = o + 2 * static_cast<size_t>(n);
  a.flags = o + 3 * static_cast<size_t>(n);
  a.n = n;
  a.k_pad = k_pad;
  a.m_pad = m_pad;
  a.l_pad = l_pad;
  a.n_slots = n_slots;
  a.seg_lo = seg_lo;
  a.slot_lo = slot_lo;
  a.link_lo = link_lo;
  int shift = 0;
  while (((k_pad - 1) >> shift) + 1 > kSegStage) ++shift;
  a.seg_shift = shift;
  if (n > 0) {
    ingest_place_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
