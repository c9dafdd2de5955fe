// K5's backward: the adjoint of the RG-LRU recurrence h_t = a_t h_{t-1} +
// b_t for Hopper (sm_90a).
//
// The reference has no kernel for it: JAX differentiates the model's
// associative scan (repro/models/hybrid.py:rglru_scan).  Given a (B,S,L)
// fp32, the forward's output h (B,S,L), its start h0 (B,L) or null (zero),
// the output gradient dh (B,S,L) and the final state's gradient dhf (B,L)
// or null (zero), all contiguous, the adjoint runs backwards in time:
//
//   lam_{S-1} = dh_{S-1} + dhf,   lam_t = dh_t + a_{t+1} lam_{t+1},
//
// and the kernel writes db_t = lam_t, da_t = lam_t h_{t-1} (h_{-1} = h0,
// zero where h0 is null) and dh0 = a_0 lam_0, each once, with no atomics.
// Written with the coefficient c_t = a_{t+1} (c_{S-1} = 1) and the start
// dhf, the adjoint is the forward's recurrence walked from the last step:
// lam_t = c_t lam_{t+1} + dh_t.
//
// What bounds it at recurrentgemma-2b's training shape (B 4, S 1024,
// L 2560; H100 SXM, 3.35 TB/s): it reads a, h and dh and writes da and db,
// 5 x 41.9 MB = 210 MB, 0.063 ms; its 3 B S L operations are nothing
// beside that, so the bound is bytes.  Pass 1 reads a and dh once more
// where a segment is longer than one register tile (S > 256).
//
// Design: the forward kernel's (csrc/rglru_scan.cu) segmented scan,
// mirrored in time.  One block of SEGMENTS = 8 warps owns 32 lanes of one
// batch row; warp w owns segment w of len = ceil(S / 8) consecutive steps
// (a split that depends on S alone), so the grid is ceil(L / 32) x B.
// Lane l of a warp owns one lane of the state, so every load and store is
// one coalesced 128-byte row per step.  Pass 1: each thread loads its
// segment's c and dh, TILE steps at a time from its last step down, and
// folds them from zero into the segment's pair (A = prod c, B_seg = the
// adjoint's value from zero).  The pairs go through shared memory; warp
// w's carry folds dhf through the pairs of segments 7..w+1 in descending
// order (the coefficient that carries lam into a segment's last step is
// the next segment's first a).  Pass 2 walks the segment down again from
// its carry (from registers where the segment fits one tile, S <= 256),
// loads h_{t-1} and stores db and da; the thread of step 0 stores dh0.
//
// Exactness: each step of the adjoint is __fadd_rn(__fmul_rn(c, lam), dh)
// and da and dh0 one __fmul_rn each, with no fused multiply-add, in the
// order of rglru_scan_bwd_ref (kernels/rglru_scan.py: the same segments,
// folds and re-walk, each op a separate PyTorch op), so kernel and plain
// version agree bit for bit in fp32, and a row's result never depends on
// the batch.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int SEGMENTS = 8;             // warps a block, segments of S
constexpr int THREADS = 32 * SEGMENTS;
constexpr int TILE = 32;                // steps each thread holds in registers

// c_t = a_{t+1} (1 at t = S - 1) and dh_t for the steps hi, hi - 1, ...,
// hi - n + 1 of one lane (row offsets from ``row``, the lane's (b, 0, l))
__device__ __forceinline__ void fetch(const float* __restrict__ a,
                                      const float* __restrict__ dh,
                                      float (&cr)[TILE], float (&dr)[TILE],
                                      long long row, int hi, int n, int S,
                                      int L, bool live) {
#pragma unroll
  for (int t = 0; t < TILE; ++t) {
    const bool in = live && t < n;
    const int step = hi - t;
    cr[t] = in ? (step + 1 < S ? a[row + (long long)(step + 1) * L] : 1.f)
               : 0.f;
    dr[t] = in ? dh[row + (long long)step * L] : 0.f;
  }
}

// h_{t-1} for the same steps (h0's lane, or zero, at t = 0)
__device__ __forceinline__ void fetch_prev(const float* __restrict__ h,
                                           float first, float (&hr)[TILE],
                                           long long row, int hi, int n,
                                           int L, bool live) {
#pragma unroll
  for (int t = 0; t < TILE; ++t) {
    const bool in = live && t < n;
    const int step = hi - t;
    hr[t] = in ? (step > 0 ? h[row + (long long)(step - 1) * L] : first)
               : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
    rglru_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ h,
                          const float* __restrict__ h0,
                          const float* __restrict__ dh,
                          const float* __restrict__ dhf,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dh0, int S, int L) {
  __shared__ float seg_a[SEGMENTS][32], seg_b[SEGMENTS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = blockIdx.x * 32 + lane;
  const bool live = l < L;
  const int len = (S + SEGMENTS - 1) / SEGMENTS;
  const int t0 = warp * len;                   // this segment's first step
  const int n = max(0, min(len, S - t0));      // and its length
  const int last = t0 + n - 1;                 // its last step
  const long long state_off = (long long)blockIdx.y * L + l;
  const long long row = (long long)blockIdx.y * S * L + l;
  float cr[TILE], dr[TILE], hr[TILE];

  // pass 1: the segment's pair from zero, from its last step down
  float pa = 1.f, pb = 0.f;
  for (int s = 0; s < n; s += TILE) {
    fetch(a, dh, cr, dr, row, last - s, n - s, S, L, live);
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      if (s + t < n) {
        pa = __fmul_rn(cr[t], pa);
        pb = __fadd_rn(__fmul_rn(cr[t], pb), dr[t]);
      }
    }
  }
  seg_a[warp][lane] = pa;
  seg_b[warp][lane] = pb;
  __syncthreads();

  // carry: dhf through the pairs of the segments after this one
  float lam = (dhf != nullptr && live) ? dhf[state_off] : 0.f;
  for (int k = SEGMENTS - 1; k > warp; --k)
    lam = __fadd_rn(__fmul_rn(seg_a[k][lane], lam), seg_b[k][lane]);

  // pass 2: the segment down again from the carry; db and da
  const float first = (h0 != nullptr && live) ? h0[state_off] : 0.f;
  for (int s = 0; s < n; s += TILE) {
    if (n > TILE) fetch(a, dh, cr, dr, row, last - s, n - s, S, L, live);
    fetch_prev(h, first, hr, row, last - s, n - s, L, live);
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      if (s + t < n) {
        lam = __fadd_rn(__fmul_rn(cr[t], lam), dr[t]);
        if (live) {
          const long long off = row + (long long)(last - s - t) * L;
          db[off] = lam;
          da[off] = __fmul_rn(lam, hr[t]);
        }
      }
    }
  }
  if (live && n > 0 && t0 == 0) dh0[state_off] = __fmul_rn(a[row], lam);
}

}  // namespace

extern "C" int repro_rglru_scan_bwd(const void* a, const void* h,
                                    const void* h0, const void* dh,
                                    const void* dhf, void* da, void* db,
                                    void* dh0, int B, int S, int L,
                                    void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || L <= 0) return cudaErrorInvalidValue;
  const dim3 grid((L + 31) / 32, B);
  rglru_scan_bwd_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(dh),
      static_cast<const float*>(dhf), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, L);
  return cudaGetLastError();
}
