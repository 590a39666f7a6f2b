// Eq. 3 gap placement on the device for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gap_place.py::gap_place_call
// (body _gap_place_kernel, gap_place.py:240-299).  For each key x of
// the sorted, +inf padded batch:
//
//   seg = clip(count(seg_first_key <= x) - 1, 0, Kpad - 1)
//   y   = base[seg] + (x - x0[seg]) * scale[seg]
//
// The tables are the per-segment folds of Eq. 3 that
// repro_torch.kernels.ops_gap.prepare_gap_tables builds on the host
// (first key, base position, anchor key, scale), +inf / 0 padded.
//
// The TPU kernel counts the segment first keys <= x with a chunked
// masked sum over the whole table.  Here each thread runs an
// upper-bound bisect instead: the f32 table is non-decreasing (the
// model's first keys are sorted, rounding to f32 keeps that order, and
// the padding is +inf), so the keys <= x form a prefix and its length
// is the count.  A padding row (x = +inf) routes to the last table row;
// inf - x0 is inf, and inf * 0 or inf - inf give NaN, as in the
// reference.
//
// What bounds it on this card: bytes.  Each key is 4 bytes in and 4
// bytes out; the table bisect is log2(Kpad) dependent reads of a table
// of a few KiB that all threads share, so it stays in L1/L2.  The
// design is one thread per key with coalesced loads and stores; the
// table reads go through the read-only path (__ldg).  Staging the
// table in shared memory is left for later work.
//
// Numerics: compile with -fmad=false, and the line is spelled
// __fsub_rn / __fmul_rn / __fadd_rn besides, so the product is rounded
// before the sum, as the plain torch version's separate ops round it.
// (XLA on the CPU contracts the reference's line into an FMA; the two
// then differ by at most one f32 rounding.)

#include <cuda_runtime.h>

namespace {

__global__ void gap_place_kernel(const float* __restrict__ x,
                                 const float* __restrict__ segk,
                                 const float* __restrict__ base,
                                 const float* __restrict__ x0,
                                 const float* __restrict__ scale,
                                 float* __restrict__ out, int n, int k_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = __ldg(x + i);
  // upper bound: the first row with segk > x (k_pad when none)
  int lo = 0, hi = k_pad;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(segk + mid) <= xi) lo = mid + 1; else hi = mid;
  }
  const int seg = min(max(lo - 1, 0), k_pad - 1);
  const float dx = __fsub_rn(xi, __ldg(x0 + seg));
  out[i] = __fadd_rn(__ldg(base + seg), __fmul_rn(dx, __ldg(scale + seg)));
}

}  // namespace

extern "C" int gap_place_launch(const void* x, const void* segk,
                                const void* base, const void* x0,
                                const void* scale, void* out, int n,
                                int k_pad, void* stream) {
  const int threads = 256;
  if (n > 0) {
    gap_place_kernel<<<(n + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(segk),
        static_cast<const float*>(base), static_cast<const float*>(x0),
        static_cast<const float*>(scale), static_cast<float*>(out), n,
        k_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
