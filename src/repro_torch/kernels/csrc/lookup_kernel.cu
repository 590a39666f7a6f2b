// Legacy narrow-key lookup kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lookup.py::lookup_kernel_call
// (body _lookup_kernel, lookup.py:45-175), the search stage of the
// explicitly requested "pallas" backend.  One CTA per tile of q_tile
// sorted queries; the tile's window is the two w_tile blocks of slot
// keys starting at block tile_block[i].  For each query q:
//
//   seg   = clip(count(seg_first_key <= q) - 1, 0, Kpad - 1)
//   pred  = slope[seg] * (q - seg_first_key[seg]) + icept[seg]
//   rank  = count(window <= q),  slot = base + rank - 1
//   found = some window key == q
//   fb    = (rank == 0 && base > 0) || rank == 2 * w_tile
//
// The TPU kernel computes both counts as chunked masked sums.  Here
// each is an upper-bound bisect: the segment first keys are sorted
// (+inf padded), and the slot keys are non-decreasing (a gap carries
// its right neighbour's key; the padding is +inf), so the keys <= q
// form a prefix whose length is the count, and some window key equals
// q exactly when the last key of that prefix does.  The plain torch
// version computes the counts literally, so holding the two equal on
// the card checks this argument on real data.
//
// What bounds it on this card: the latency of dependent reads, not
// bytes.  The TPU kernel DMAs the two blocks into VMEM once per tile;
// here the CTA stages them into shared memory once (2 * w_tile keys of
// 4 bytes: 16 KiB at w_tile 2048), and every query of the tile bisects
// there in log2(2 * w_tile) steps.  The segment bisect reads a table
// of a few KiB that every CTA shares, through the read-only path
// (__ldg), so it stays in L1/L2.  Each query costs 4 bytes in and 10
// bytes out.  Loading the window with cp.async/TMA and overlapping it
// with the previous tile's search are left for later work.
//
// Numerics: compile with -fmad=false, and pred is spelled
// __fsub_rn / __fmul_rn / __fadd_rn besides, so the product is rounded
// before the sum, as the plain torch version's separate ops round it.
// The block index is clamped to [0, Mpad / w_tile - 2], the range the
// pipeline's tile schedule already clips it to, so the window never
// leaves the padded slot keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const float* q;           // (Qpad,) sorted, +inf padded
  const int* tile_block;    // (Qpad / q_tile,)
  const float* segk;        // (Kpad,) +inf padded
  const float* slope;       // (Kpad,)
  const float* icept;       // (Kpad,)
  const float* sk;          // (Mpad,) +inf padded
  int* slot;
  uint8_t* found;
  uint8_t* fb;
  float* pred;
  int q_tile;
  int w_tile;
  int k_pad;
  int max_block;            // Mpad / w_tile - 2
};

__global__ void lookup_kernel(Args a) {
  extern __shared__ float win[];
  const int two_w = 2 * a.w_tile;
  const int blk = min(max(__ldg(a.tile_block + blockIdx.x), 0),
                      a.max_block);
  const int base = blk * a.w_tile;
  const float* src = a.sk + base;
  for (int t = threadIdx.x; t < two_w; t += blockDim.x) {
    win[t] = __ldg(src + t);
  }
  __syncthreads();

  const int q0 = blockIdx.x * a.q_tile;
  for (int j = threadIdx.x; j < a.q_tile; j += blockDim.x) {
    const int i = q0 + j;
    const float q = __ldg(a.q + i);

    // segment routing: upper bound over the first keys
    int lo = 0, hi = a.k_pad;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(a.segk + mid) <= q) lo = mid + 1; else hi = mid;
    }
    const int seg = min(max(lo - 1, 0), a.k_pad - 1);
    const float dx = __fsub_rn(q, __ldg(a.segk + seg));
    const float y = __fadd_rn(__fmul_rn(__ldg(a.slope + seg), dx),
                              __ldg(a.icept + seg));

    // window rank: upper bound over the staged slot keys
    lo = 0;
    hi = two_w;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (win[mid] <= q) lo = mid + 1; else hi = mid;
    }
    const int rank = lo;

    a.slot[i] = base + rank - 1;
    a.found[i] = (rank > 0 && win[rank - 1] == q) ? 1 : 0;
    a.fb[i] = ((rank == 0 && base > 0) || rank == two_w) ? 1 : 0;
    a.pred[i] = y;
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
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(w_tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = q_tile < 256 ? ((q_tile + 31) / 32) * 32 : 256;
  if (num_tiles > 0) {
    lookup_kernel<<<num_tiles, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
