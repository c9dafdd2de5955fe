// K2: tiled matrix product (M,K) @ (K,N) -> (M,N) for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/matmul.py:matmul (_kernel).  As
// there, an fp32 accumulator stays resident across the whole K loop and the
// output tile is written once, in x's dtype.
//
// Design: one block of 256 threads owns a 64x64 output tile; each thread
// holds a 4x4 fp32 micro-tile in registers.  K advances in steps of 32:
// the x tile (64x32) and the w tile (32x64) are staged in shared memory as
// fp32, zero-filled past the ragged edges of M, N and K, so any shape is
// taken.  The next step's tiles are fetched into registers while the
// current step is multiplied, so loads overlap math instead of waiting one
// by one.  w is read through its strides: row-major (K,N) weights load
// with n fastest, and a K-contiguous view (the tied LM head reads the
// (V,d) embedding table in place as (d,V)) loads with k fastest, so both
// layouts coalesce and no transposed copy is ever made.
//
// Batch invariance: every output element sums its K products in the same
// fixed order (k = 0, 1, ..., K-1, one fused multiply-add each), whatever M
// is and whichever tile the row falls in.  There is no split-K and no
// atomic, so a batch-4 decode and a batch-1 reference decode give the same
// bits per row; the serving engine's token-exactness rests on this.
//
// What bounds it on the serving path (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16):
// at decode M equals the batch (4), so the products stream their weights
// once and do ~4 FLOP per weight: the bound is bytes.  The tied head alone
// streams 1024 x 153,600 x 2 B = 315 MB (~94 us); one decode step streams
// all ~1.2 GB of weights (~0.36 ms).  At prefill (M = 256) a projection is
// ~1 GFLOP and sits near the ridge.  This first version uses CUDA-core FMAs
// and a 64-row tile, so at M = 4 most of each tile is idle and a 1024-wide
// projection launches only 16 blocks: on the H100 a decode step's products
// take ~30 ms against the 0.36 ms bound (PERF.md).  wgmma, TMA and a
// small-M schedule are later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int XPT = BM * BK / THREADS;  // x elements each thread stages
constexpr int WPT = BK * BN / THREADS;  // w elements each thread stages

// Fetch the (m0, k0) x tile and the (k0, n0) w tile into registers, zero
// past the ragged edges.  Compile-time trip counts let every load issue
// before the first one returns.
template <typename T, bool W_K_CONTIG>
__device__ __forceinline__ void fetch(const T* __restrict__ x,
                                      const T* __restrict__ w, float (&xr)[XPT],
                                      float (&wr)[WPT], int tid, int m0,
                                      int n0, int k0, int M, int N, int K,
                                      long long sxm, long long swk,
                                      long long swn) {
#pragma unroll
  for (int t = 0; t < XPT; ++t) {
    const int i = tid + t * THREADS;
    const int gm = m0 + i / BK, gk = k0 + i % BK;
    xr[t] = (gm < M && gk < K) ? repro::to_f32(x[(long long)gm * sxm + gk])
                               : 0.f;
  }
#pragma unroll
  for (int t = 0; t < WPT; ++t) {
    const int i = tid + t * THREADS;
    // W_K_CONTIG: neighbouring threads walk k; else they walk n
    const int r = W_K_CONTIG ? i % BK : i / BN;  // k within the tile
    const int c = W_K_CONTIG ? i / BK : i % BN;  // n within the tile
    const int gk = k0 + r, gn = n0 + c;
    wr[t] = (gk < K && gn < N)
                ? repro::to_f32(w[(long long)gk * swk + (long long)gn * swn])
                : 0.f;
  }
}

template <typename T, bool W_K_CONTIG>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, int M, int N, int K, long long sxm,
                  long long swk, long long swn, long long som) {
  __shared__ float xs[BK][BM + 4];  // x tile, stored k-major
  __shared__ float ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tm = (tid / 16) * 4;
  const int tn = (tid % 16) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float xr[XPT], wr[WPT];
  fetch<T, W_K_CONTIG>(x, w, xr, wr, tid, m0, n0, 0, M, N, K, sxm, swk, swn);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int t = 0; t < XPT; ++t) {
      const int i = tid + t * THREADS;
      xs[i % BK][i / BK] = xr[t];
    }
#pragma unroll
    for (int t = 0; t < WPT; ++t) {
      const int i = tid + t * THREADS;
      if (W_K_CONTIG)
        ws[i % BK][i / BK] = wr[t];
      else
        ws[i / BN][i % BN] = wr[t];
    }
    __syncthreads();
    // the next tiles load while this one is multiplied
    if (k0 + BK < K)
      fetch<T, W_K_CONTIG>(x, w, xr, wr, tid, m0, n0, k0 + BK, M, N, K, sxm,
                           swk, swn);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][tm + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tn + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tm + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tn + j;
      if (gn < N) out[(long long)gm * som + gn] = repro::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, long long sxm, long long swk, long long swn,
                   long long som, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (swn == 1) {
    matmul_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), M, N, K, sxm, swk, swn, som);
  } else if (swk == 1) {
    matmul_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), M, N, K, sxm, swk, swn, som);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_matmul(const void* x, const void* w, void* out, int M,
                            int N, int K, long long sxm, long long swk,
                            long long swn, long long som, int dtype,
                            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, w, out, M, N, K, sxm, swk, swn, som, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, w, out, M, N, K, sxm, swk, swn, som, s);
    default:
      return cudaErrorInvalidValue;
  }
}
