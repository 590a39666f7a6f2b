// Eq. 3 gap placement on the device for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gap_place.py::gap_place_call
// (body _gap_place_kernel, gap_place.py:240-263).  For each key x of
// the +inf padded batch:
//
//   seg = clip(count(seg_first_key <= x) - 1, 0, Kpad - 1)
//   y   = base[seg] + (x - x0[seg]) * scale[seg]
//
// The tables are the per-segment folds of Eq. 3 that
// repro_torch.kernels.ops_gap.prepare_gap_tables builds on the host
// (first key, base position, anchor key, scale), +inf / 0 padded.
//
// The TPU kernel counts the segment first keys <= x with a chunked
// masked sum over the whole table.  Here the count is an upper-bound
// search: the f32 table is non-decreasing (the model's first keys are
// sorted, rounding to f32 keeps that order, and the padding is +inf),
// so the keys <= x form a prefix and its length is the count.  A
// padding row (x = +inf) routes to the last table row; inf - x0 is
// inf, and inf * 0 or inf - inf give NaN, as in the reference.
//
// What bounds it on this card: bytes (each key 4 bytes in, 4 out; 256
// MB at 32M keys) -- if enough of them are in flight.  The earlier
// design ran one thread per key, and each key waited on an 11-step
// dependent bisect of the 2,048-row table and three gathers behind one
// 4-byte load: 14 dependent reads for 8 streamed bytes, too few bytes
// in flight to stream, so it reached a third of its bound.  Yet the
// bisect is almost always redundant: the keys arrive sorted, and 32M
// keys over ~1,770 segments is ~18,000 keys a segment.
//
// The design: each CTA takes a chunk of 4,096 consecutive keys, 16 a
// thread as four 16-byte loads (coalesced), all issued before any
// routing.  The count is monotone in x, so every key of the chunk has
// its count in [count(x_min), count(x_max)], where x_min and x_max are
// the chunk's least and greatest key, taken by a reduction (not the
// first and last: unsorted input gets the same answers).  Two warps
// find those two counts at once, each by a warp-cooperative 32-ary
// search (32 lanes probe, __ballot_sync + __popc keep the stride with
// the boundary: 3 dependent rounds for 2,048 rows).  The table rows
// the bracket can route to (at most 256) are staged in shared memory,
// four tables, and each key bisects only inside the bracket: no search
// at all when the chunk lies in one segment, the usual case.  A wider
// bracket (shuffled keys, or a chunk running into the +inf padding) is
// searched in the same range of the global tables instead, which gives
// the same answer.  A key outside [x_min, x_max] -- only a NaN can be
// -- is routed by the whole-table bisect of the earlier design.  The
// outputs go back as four 16-byte stores a thread.  Keys and outputs
// are touched once, so the loads are evict-first (__ldcs) and the
// stores streaming (__stcs).  Unaligned arrays and a ragged last chunk
// take 4-byte loads and stores.
//
// Numerics: compile with -fmad=false, and the line is spelled
// __fsub_rn / __fmul_rn / __fadd_rn besides, so the product is rounded
// before the sum, as the plain torch version's separate ops round it.
// (XLA on the CPU contracts the reference's line into an FMA; the two
// then differ by at most one f32 rounding.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kVecs = 4;                          // float4 a thread
constexpr int kChunk = kThreads * kVecs * 4;      // 4,096 keys a CTA
constexpr int kRowCap = 256;                      // staged table rows

// count(a[i] <= v) over the non-decreasing a[0, n), by one full warp:
// each round the lanes probe the last key of 32 equal strides of the
// open range and the ballot's popcount keeps the stride holding the
// boundary.  Every lane returns the count (0 for a NaN v).
__device__ __forceinline__ int warp_count_le(const float* __restrict__ a,
                                             int n, float v, int lane) {
  int lo = 0, hi = n;       // the count lies in [lo, hi]
  while (lo < hi) {
    const int s = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * s - 1;
    const bool le = p < hi && __ldg(a + p) <= v;
    const int c = __popc(__ballot_sync(kFull, le));
    hi = min(hi, lo + (c + 1) * s - 1);
    lo += c * s;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads, 6)
gap_place_kernel(const float* __restrict__ x,
                 const float* __restrict__ segk,
                 const float* __restrict__ base,
                 const float* __restrict__ x0,
                 const float* __restrict__ scale,
                 float* __restrict__ out, long long n, int k_pad) {
  __shared__ float s_segk[kRowCap], s_base[kRowCap], s_x0[kRowCap],
      s_scale[kRowCap];
  __shared__ float red_min[kThreads / 32], red_max[kThreads / 32];
  __shared__ int bracket[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const bool vec = ((reinterpret_cast<uintptr_t>(x)
                     | reinterpret_cast<uintptr_t>(out)) & 15) == 0;

  // the chunk's keys, loaded first; a missing key reads as NaN, which
  // fminf / fmaxf skip and nothing stores
  float v[kVecs * 4];
  float mn = INFINITY, mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = c0 + (static_cast<long long>(k) * kThreads + tid) * 4;
    if (vec && i + 4 <= n) {
      const float4 f = __ldcs(reinterpret_cast<const float4*>(x + i));
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[4 * k + e] = i + e < n ? __ldg(x + i + e) : NAN;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kVecs * 4; ++e) {
    mn = fminf(mn, v[e]);
    mx = fmaxf(mx, v[e]);
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
  float x_min = red_min[0], x_max = red_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    x_min = fminf(x_min, red_min[w]);
    x_max = fmaxf(x_max, red_max[w]);
  }

  // the bracket [count(x_min), count(x_max)], one warp each
  if (warp < 2) {
    const int c = warp_count_le(segk, k_pad, warp ? x_max : x_min, lane);
    if (lane == 0) bracket[warp] = c;
  }
  __syncthreads();
  const int c_lo = bracket[0], c_hi = bracket[1];

  // rows [r0, r1] hold every first key the bracket's search reads and
  // every row it can route to
  const int r0 = max(c_lo - 1, 0);
  const int r1 = min(c_hi, k_pad - 1);
  const bool staged = x_min <= x_max && r1 - r0 < kRowCap;
  if (staged) {
    for (int r = tid; r <= r1 - r0; r += kThreads) {
      s_segk[r] = __ldg(segk + r0 + r);
      s_base[r] = __ldg(base + r0 + r);
      s_x0[r] = __ldg(x0 + r0 + r);
      s_scale[r] = __ldg(scale + r0 + r);
    }
  }
  __syncthreads();

#pragma unroll
  for (int e = 0; e < kVecs * 4; ++e) {
    const float xi = v[e];
    const bool in = xi >= x_min && xi <= x_max;
    int lo = in ? c_lo : 0, hi = in ? c_hi : k_pad;
    float b, a0, sc;
    if (in && staged) {
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_segk[mid - r0] <= xi) lo = mid + 1; else hi = mid;
      }
      const int r = min(max(lo - 1, 0), k_pad - 1) - r0;
      b = s_base[r];
      a0 = s_x0[r];
      sc = s_scale[r];
    } else {
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(segk + mid) <= xi) lo = mid + 1; else hi = mid;
      }
      const int seg = min(max(lo - 1, 0), k_pad - 1);
      b = __ldg(base + seg);
      a0 = __ldg(x0 + seg);
      sc = __ldg(scale + seg);
    }
    v[e] = __fadd_rn(b, __fmul_rn(__fsub_rn(xi, a0), sc));
  }

#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = c0 + (static_cast<long long>(k) * kThreads + tid) * 4;
    if (vec && i + 4 <= n) {
      __stcs(reinterpret_cast<float4*>(out + i),
             make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < n) out[i + e] = v[4 * k + e];
      }
    }
  }
}

}  // namespace

extern "C" int gap_place_launch(const void* x, const void* segk,
                                const void* base, const void* x0,
                                const void* scale, void* out, int n,
                                int k_pad, void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<long long>(n) + kChunk - 1) / kChunk);
    gap_place_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(segk),
        static_cast<const float*>(base), static_cast<const float*>(x0),
        static_cast<const float*>(scale), static_cast<float*>(out), n,
        k_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
