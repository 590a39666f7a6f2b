// §5.3 ingest placement primitives for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gap_place.py::ingest_place_call
// (body _ingest_place_kernel -> ingest_place_body, gap_place.py:134-237,
// 307-341, 616-653).  For each insert key x (an f32 hi/lo pair):
//
//   1. segment route: pair bisect over the segment first keys;
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
// What bounds it on this card: bytes, and the latency of dependent
// loads.  Each key runs three bisects over whole tables (segments,
// then the slot keys twice: about 2 * log2(Mpad) + log2(Kpad) dependent
// 4- or 8-byte reads) plus a few gathers, with a few dozen flops; that
// is far below the H100's ridge point.  What the design does about it:
// one thread per key, the tables stay whole in global memory and every
// read goes through the read-only path (__ldg); the top levels of each
// bisect are shared by all keys and stay in L1/L2.  Sorting the keys
// first (neighbouring threads on neighbouring slots) and staging the
// top bisect levels in shared memory are left for later work.
//
// Numerics: compile with -fmad=false, and every product and sum of the
// pair arithmetic is spelled __fmul_rn / __fadd_rn / __fsub_rn besides,
// so nothing is contracted into an FMA and each step equals the plain
// torch version's separate op.  rintf rounds half to even (jnp.round);
// the clip runs fmaxf then fminf, so a NaN prediction clips to -1, as
// the plain version's isnan branch does; a C cast then truncates, as
// astype(int32) does.  n_slots meets the f32 operands as (float)n_slots;
// the band scale 2e-9f is the f32 nearest 2e-9, as jnp.float32(2e-9).
// A bisect stops when its bracket closes, which returns the index the
// reference's fixed trip count returns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSplitter = 4097.0f;  // 2^12 + 1, Veltkamp split for f32
constexpr float kTolScale = 2e-9f;

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

// Rightmost index in [0, n) with pair(key) {<, <=} pair(q); -1 when none.
__device__ __forceinline__ int bisect(const float* kh, const float* kl,
                                      int has_lo, int n, float qh, float ql,
                                      bool strict) {
  int lo = -1, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    const float h = __ldg(kh + mid);
    const float l = ld(kl, mid, has_lo);
    const bool go = strict ? p_lt(h, l, qh, ql) : p_le(h, l, qh, ql);
    if (go) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void ingest_place_kernel(Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float xh = __ldg(a.x_hi + i);
  const float xl = __ldg(a.x_lo + i);

  // --- segment routing ---------------------------------------------------
  int seg = bisect(a.segk, a.segkl, a.seg_lo, a.k_pad, xh, xl, false);
  seg = min(max(seg, 0), a.k_pad - 1);

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
  const int r_i = min(p + 1, a.m_pad - 1);
  const float r_h = r_valid ? __ldg(a.sk + r_i) : __int_as_float(0x7f800000);
  const float r_l = r_valid ? ld(a.skl, r_i, a.slot_lo) : 0.0f;
  const bool free = nx_h == r_h && nx_l == r_l;

  // --- run boundaries: key-run ub, slot-run pv -----------------------
  const int ub = bisect(a.sk, a.skl, a.slot_lo, a.m_pad, xh, xl, false);
  const int pv = bisect(a.sk, a.skl, a.slot_lo, a.m_pad, nx_h, nx_l, true);

  // --- bracket: prev boundary key (incl. chain max) < key < next -----
  const int pv_safe = max(pv, 0);
  float pm_h = __ldg(a.sk + pv_safe);
  float pm_l = ld(a.skl, pv_safe, a.slot_lo);
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

extern "C" int ingest_place_launch(
    const void* x_hi, const void* x_lo, const void* segk, const void* segkl,
    const void* slope, const void* slopel, const void* icept,
    const void* iceptl, const void* sk, const void* skl, const void* off,
    const void* lk, const void* lkl, void* p, void* pv, void* ub,
    void* flags, int n, int k_pad, int m_pad, int l_pad, int n_slots,
    int seg_lo, int slot_lo, int link_lo, void* stream) {
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
  a.p = static_cast<int*>(p);
  a.pv = static_cast<int*>(pv);
  a.ub = static_cast<int*>(ub);
  a.flags = static_cast<int*>(flags);
  a.n = n;
  a.k_pad = k_pad;
  a.m_pad = m_pad;
  a.l_pad = l_pad;
  a.n_slots = n_slots;
  a.seg_lo = seg_lo;
  a.slot_lo = slot_lo;
  a.link_lo = link_lo;
  const int threads = 256;
  if (n > 0) {
    ingest_place_kernel<<<(n + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
