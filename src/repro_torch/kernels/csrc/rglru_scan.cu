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
// Design: one thread owns one (batch, lane) and walks S in order with its
// state in a register; neighbouring threads own neighbouring lanes, so
// every load of a and b and every store of h is coalesced across the
// warp.  The steps are fetched TILE at a time into registers (compile-time
// trip count), and the next tile's loads are issued before the current
// tile is computed, so the memory latency of one tile hides behind the
// arithmetic of the last, the register-prefetch idiom of matmul.cu.  A
// ragged S and L are masked here (the Pallas kernel asserts
// S % chunk == 0 and L % block_l == 0).
//
// Exactness: each step is __fadd_rn(__fmul_rn(a, h), b), a product and a
// sum each rounded once, with no fused multiply-add, the order of
// rglru_scan_ref (two separate PyTorch ops), so kernel and plain version
// agree bit for bit in fp32 and a row's result never depends on the batch.
//
// What bounds it on the serving path (H100 SXM, 3.35 TB/s): one
// recurrentgemma-2b admission call (B 1, S 256, L 2560) reads a and b and
// writes h, 3 x 256 x 2560 x 4 B = 7.9 MB, ~2.3 us; its 0.66 M
// multiply-adds are nothing beside that, so the bound is bytes.  The
// sequential walk over S is the design's limit: at B 1 and L 2560 the grid
// has only 10 blocks of 256 threads on the card's 132 SMs, and each thread
// carries a chain of S dependent steps.  A chunked two-pass scan (chunk
// carries, then their prefix) would fill the card; that is later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 16;  // steps each thread holds in registers

__device__ __forceinline__ void fetch(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float (&ar)[TILE], float (&br)[TILE],
                                      long long base, int s0, int S, int L) {
#pragma unroll
  for (int t = 0; t < TILE; ++t) {
    const bool in = s0 + t < S;
    const long long off = base + (long long)(s0 + t) * L;
    ar[t] = in ? a[off] : 0.f;
    br[t] = in ? b[off] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      float* __restrict__ hf, int S, int L) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  const long long row = (long long)blockIdx.y * L + l;  // (batch, lane)
  const long long base = (long long)blockIdx.y * S * L + l;
  float state = (h0 != nullptr) ? h0[row] : 0.f;
  float ar[TILE], br[TILE], an[TILE], bn[TILE];
  fetch(a, b, ar, br, base, 0, S, L);
  for (int s0 = 0; s0 < S; s0 += TILE) {
    if (s0 + TILE < S) fetch(a, b, an, bn, base, s0 + TILE, S, L);
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      if (s0 + t < S) {
        state = __fadd_rn(__fmul_rn(ar[t], state), br[t]);
        h[base + (long long)(s0 + t) * L] = state;
      }
    }
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      ar[t] = an[t];
      br[t] = bn[t];
    }
  }
  hf[row] = state;
}

}  // namespace

extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* h, void* hf, int B, int S, int L,
                                void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || L <= 0) return cudaErrorInvalidValue;
  const dim3 grid((L + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(hf), S, L);
  return cudaGetLastError();
}
