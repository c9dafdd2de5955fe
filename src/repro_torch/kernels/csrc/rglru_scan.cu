// K5: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/rglru_scan.py:rglru_scan
// (_kernel) and computes what repro/kernels/ref.py:rglru_scan defines:
// a and b (B,S,L) fp32, contiguous; h (B,S,L) fp32 holds every step's
// state and hf (B,L) fp32 the last one.  Unlike the Pallas kernel, which
// starts from zero (the model folds a carried state in as a virtual step
// 0), this one starts from h0 (B,L) fp32, or from zero where h0 is null.
//
// What bounds it on the serving path (H100 SXM, 3.35 TB/s): one
// recurrentgemma-2b admission call (B 1, S 256, L 2560) reads a and b and
// writes h, 3 x 256 x 2560 x 4 B = 7.9 MB, ~2.3 us; its 0.66 M
// multiply-adds are nothing beside that, so the bound is bytes.  A walk
// of all S steps per lane would give one chain of S dependent steps and,
// at B 1, only L / 256 blocks.
//
// Design: a segmented scan.  One block of SEGMENTS = 8 warps owns 32
// lanes of one batch row; warp w owns segment w of len = ceil(S / 8)
// consecutive steps (a split that depends on S alone), so the grid is
// ceil(L / 32) x B: 80 blocks at the admission shape.  Lane l of a warp
// owns one lane of the state, so every load of a and b and every store of
// h is one coalesced 128-byte row per step.  Pass 1: each thread loads its
// segment's a and b, TILE steps at a time into registers (all loads of a
// tile issued before the first step), and folds them from zero into the
// segment's pair (A = prod a, B_seg = the recurrence's value from zero).
// The pairs go through shared memory; warp w's carry-in folds h0 through
// the pairs of segments 0..w-1 in ascending order.  Pass 2 walks the
// segment again from the carry-in (from registers where the segment fits
// one tile, S <= 256) and stores h; the thread of step S - 1 stores hf.
//
// Exactness: each step is __fadd_rn(__fmul_rn(a, h), b), a product and a
// sum each rounded once, with no fused multiply-add, in the order of
// rglru_scan_ref (kernels/rglru_scan.py: the same segments, folds and
// re-walk, each op a separate PyTorch op), so kernel and plain version
// agree bit for bit in fp32, and a row's result never depends on the batch.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int SEGMENTS = 8;             // warps a block, segments of S
constexpr int THREADS = 32 * SEGMENTS;
constexpr int TILE = 32;                // steps each thread holds in registers

__device__ __forceinline__ void fetch(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float (&ar)[TILE], float (&br)[TILE],
                                      long long base, int n, int L,
                                      bool live) {
#pragma unroll
  for (int t = 0; t < TILE; ++t) {
    const bool in = live && t < n;
    const long long off = base + (long long)t * L;
    ar[t] = in ? a[off] : 0.f;
    br[t] = in ? b[off] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      float* __restrict__ hf, int S, int L) {
  __shared__ float seg_a[SEGMENTS][32], seg_b[SEGMENTS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = blockIdx.x * 32 + lane;
  const bool live = l < L;
  const int len = (S + SEGMENTS - 1) / SEGMENTS;
  const int t0 = warp * len;                   // this segment's first step
  const int n = max(0, min(len, S - t0));      // and its length
  const long long base = ((long long)blockIdx.y * S + t0) * L + l;
  float ar[TILE], br[TILE];

  // pass 1: the segment's pair from zero
  float pa = 1.f, pb = 0.f;
  for (int s = 0; s < n; s += TILE) {
    fetch(a, b, ar, br, base + (long long)s * L, n - s, L, live);
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      if (s + t < n) {
        pa = __fmul_rn(ar[t], pa);
        pb = __fadd_rn(__fmul_rn(ar[t], pb), br[t]);
      }
    }
  }
  seg_a[warp][lane] = pa;
  seg_b[warp][lane] = pb;
  __syncthreads();

  // carry-in: h0 through the pairs of the segments before this one
  float state = (h0 != nullptr && live) ? h0[(long long)blockIdx.y * L + l]
                                        : 0.f;
  for (int k = 0; k < warp; ++k)
    state = __fadd_rn(__fmul_rn(seg_a[k][lane], state), seg_b[k][lane]);

  // pass 2: the segment again from the carry-in
  for (int s = 0; s < n; s += TILE) {
    if (n > TILE) fetch(a, b, ar, br, base + (long long)s * L, n - s, L, live);
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      if (s + t < n) {
        state = __fadd_rn(__fmul_rn(ar[t], state), br[t]);
        if (live) h[base + (long long)(s + t) * L] = state;
      }
    }
  }
  if (live && n > 0 && t0 + n == S) hf[(long long)blockIdx.y * L + l] = state;
}

}  // namespace

extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* h, void* hf, int B, int S, int L,
                                void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || L <= 0) return cudaErrorInvalidValue;
  const dim3 grid((L + 31) / 32, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(hf), S, L);
  return cudaGetLastError();
}
