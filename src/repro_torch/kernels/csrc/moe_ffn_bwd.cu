// K3's backward: the gradients of the grouped expert SwiGLU FFN with
// respect to its token rows and its three expert weights, for Hopper
// (sm_90a).
//
// The Pallas kernel repro/kernels/moe_dispatch.py:moe_ffn has no backward
// of its own; the reference trains through its plain einsum FFN
// (repro/models/moe.py).  The port's MoE layer runs K3 on the card, so its
// gradient needs a kernel too.  It computes what
// kernels/moe_dispatch.py:moe_ffn_bwd_ref defines: with the forward's
// buf X (E,C,d), w1 and w3 (E,d,f), w2 (E,f,d), the output gradient dY
// (E,C,d) and, per expert, the live rows c < counts[e],
//   G = X W1,  U = X W3,  dH = dY W2^T                (recomputed, fp32)
//   H = silu(G) U,  dG = dH U s (1 + G (1 - s)),  dU = dH silu(G)
//                   (s = sigmoid(G); each rounded to the operand dtype)
//   dX = dG W1^T + dU W3^T      (rows past counts[e] written as zeros)
//   dW1 = X^T dG,  dW3 = X^T dU,  dW2 = H^T dY    (over the live rows)
// Nothing beyond the forward's inputs is saved: G and U are recomputed.
//
// What bounds it (H100 SXM, 989 TFLOP/s bf16, 67 TFLOP/s fp32 on the CUDA
// cores, 3.35 TB/s): 16 E C d f operations over the live rows (the
// recompute 4, dH 2, dX 4, the weight gradients 6) against ~3 E d f reads
// and ~3 E d f writes of weights and gradients.  At olmoe-1b-7b's training
// shape (E 64, C 640, d 2048, f 1024, ~512 live rows an expert) that is
// ~1.1 TFLOP over ~0.8 GB: the operations bound it (~1.1 ms on the tensor
// cores).  This first kernel runs on the CUDA cores in fp32, so its own
// ceiling is the 67 TFLOP/s of fp32 FMA; putting it on the tensor cores is
// later work.
//
// Design: three launches on one stream, no atomics, and every output
// element summed in ascending order by one thread, so two runs give the
// same bits.  Each launch is a tiled SIMT product of 64 x 64 output tiles,
// 256 threads a block, 4 x 4 outputs a thread (rows 4 ty + i, columns
// 4 tx + j), over k steps of 32 staged through shared memory as fp32
// [32][68] tiles: a thread reads its four values of a row in one 16-byte
// load, and the padding spreads the transposing stores over 8 banks.  No
// block holds a whole hidden row, so d and f are unbounded (the forward's
// SIMT route stops at f 3,600).
//   1. block (f tile, expert, row tile): G, U over d from X, W1, W3 and dH
//      over d from dY, W2 (three accumulators, one pass over d); writes H,
//      dG, dU to (E, C, f) scratch in the operand dtype for its live rows.
//      A tile with no live row does nothing.
//   2. block (d tile, expert, row tile): dX = dG W1^T + dU W3^T over f (one
//      accumulator, both products in one pass over f); rows past the
//      count, and tiles with none live, are written as zeros.
//   3. block (d tile, f tile, expert): dW1 and dW3 of the (d, f) tile and
//      dW2 of the transposed (f, d) tile, over the expert's live rows in
//      ascending order (no block splits C).  An expert without rows writes
//      zeros and reads nothing.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace moe_bwd {

constexpr int THREADS = 256;
constexpr int TT = 64;        // output tile rows and columns
constexpr int TK = 32;        // reduction step
constexpr int R = 4;          // outputs a thread along each side
constexpr int LD = TT + R;    // padded row of a staged tile (16-byte rows)

using Tile = float[TK][LD];

// a TK x TT tile whose element (k, n) is at src[k * ld + n] (n contiguous),
// element (k, n) -> dst[k][n]; k >= k_lim or n >= n_lim read as zero
template <typename T>
__device__ __forceinline__ void load_n(Tile& dst, const T* __restrict__ src,
                                       long long ld, int k_lim, int n_lim) {
#pragma unroll
  for (int r = 0; r < TK * TT / THREADS; ++r) {
    const int i = threadIdx.x + r * THREADS;
    const int k = i / TT, n = i % TT;
    dst[k][n] = (k < k_lim && n < n_lim)
                    ? repro::to_f32(src[(long long)k * ld + n])
                    : 0.f;
  }
}

// a TK x TT tile whose element (k, m) is at src[m * ld + k] (k contiguous),
// element (k, m) -> dst[k][m]; k >= k_lim or m >= m_lim read as zero
template <typename T>
__device__ __forceinline__ void load_k(Tile& dst, const T* __restrict__ src,
                                       long long ld, int k_lim, int m_lim) {
#pragma unroll
  for (int r = 0; r < TK * TT / THREADS; ++r) {
    const int i = threadIdx.x + r * THREADS;
    const int m = i / TK, k = i % TK;
    dst[k][m] = (k < k_lim && m < m_lim)
                    ? repro::to_f32(src[(long long)m * ld + k])
                    : 0.f;
  }
}

// the R values of row k of a staged tile from column c (a multiple of R),
// one 16-byte shared-memory load
__device__ __forceinline__ void row4(const Tile& t, int k, int c,
                                     float (&v)[R]) {
  const float4 q = *reinterpret_cast<const float4*>(&t[k][c]);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// acc[i][j] += sum_k a[k][R ty + i] * b[k][R tx + j], k ascending
__device__ __forceinline__ void mac(const Tile& a, const Tile& b,
                                    float (&acc)[R][R]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int k = 0; k < TK; ++k) {
    float av[R], bv[R];
    row4(a, k, R * ty, av);
    row4(b, k, R * tx, bv);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// mac of one a against two b tiles, reading a once: acc1 += a b1, acc2 +=
// a b2, each summed over k ascending
__device__ __forceinline__ void mac2(const Tile& a, const Tile& b1,
                                     const Tile& b2, float (&acc1)[R][R],
                                     float (&acc2)[R][R]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int k = 0; k < TK; ++k) {
    float av[R], b1v[R], b2v[R];
    row4(a, k, R * ty, av);
    row4(b1, k, R * tx, b1v);
    row4(b2, k, R * tx, b2v);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc1[i][j] = fmaf(av[i], b1v[j], acc1[i][j]);
        acc2[i][j] = fmaf(av[i], b2v[j], acc2[i][j]);
      }
  }
}

__device__ __forceinline__ int live_rows(const int* counts, int e, int C) {
  return counts ? max(0, min(C, counts[e])) : C;
}

__device__ __forceinline__ void zero_acc(float (&acc)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
}

// pass 1: H, dG, dU of rows [r0, r0 + 64) and hidden columns [j0, j0 + 64)
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    hidden_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ w3, const T* __restrict__ w2,
                  const T* __restrict__ dy, const int* __restrict__ counts,
                  T* __restrict__ h, T* __restrict__ dg, T* __restrict__ du,
                  int C, int D, int F) {
  __shared__ __align__(16) Tile xs, dys, w1s, w3s, w2s;
  const int j0 = blockIdx.x * TT, e = blockIdx.y, r0 = blockIdx.z * TT;
  const int live = live_rows(counts, e, C);
  if (r0 >= live) return;                    // never read: no live row
  const int rows = min(TT, live - r0), cols = min(TT, F - j0);
  const long long ex = (long long)e * C * D + (long long)r0 * D;
  const long long ew = (long long)e * D * F;
  float g[R][R], u[R][R], dh[R][R];
  zero_acc(g);
  zero_acc(u);
  zero_acc(dh);
  for (int k0 = 0; k0 < D; k0 += TK) {
    const int kl = min(TK, D - k0);
    load_k(xs, x + ex + k0, D, kl, rows);                 // X[r, k]
    load_k(dys, dy + ex + k0, D, kl, rows);               // dY[r, k]
    load_n(w1s, w1 + ew + (long long)k0 * F + j0, F, kl, cols);  // W1[k, j]
    load_n(w3s, w3 + ew + (long long)k0 * F + j0, F, kl, cols);
    load_k(w2s, w2 + ew + (long long)j0 * D + k0, D, kl, cols);  // W2[j, k]
    __syncthreads();
    mac2(xs, w1s, w3s, g, u);
    mac(dys, w2s, dh);
    __syncthreads();
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
    if (r >= rows) continue;
    const long long row = ((long long)e * C + r0 + r) * F + j0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = R * tx + j;
      if (c >= cols) continue;
      const float gv = g[i][j], uv = u[i][j], dhv = dh[i][j];
      const float s = 1.f / (1.f + expf(-gv));
      const float silu = gv * s;
      h[row + c] = repro::from_f32<T>(silu * uv);
      dg[row + c] =
          repro::from_f32<T>(dhv * uv * (s * (1.f + gv * (1.f - s))));
      du[row + c] = repro::from_f32<T>(dhv * silu);
    }
  }
}

// pass 2: dX of rows [r0, r0 + 64) and columns [n0, n0 + 64) of d
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    dx_kernel(const T* __restrict__ dg, const T* __restrict__ du,
              const T* __restrict__ w1, const T* __restrict__ w3,
              const int* __restrict__ counts, T* __restrict__ dx, int C,
              int D, int F) {
  __shared__ __align__(16) Tile dgs, dus, w1s, w3s;
  const int n0 = blockIdx.x * TT, e = blockIdx.y, r0 = blockIdx.z * TT;
  const int live = live_rows(counts, e, C);
  const int rows = max(0, min(TT, live - r0));
  const int tile_rows = min(TT, C - r0), cols = min(TT, D - n0);
  const long long eh = (long long)e * C * F + (long long)r0 * F;
  const long long ew = (long long)e * D * F;
  float acc[R][R];
  zero_acc(acc);
  if (rows > 0) {
    for (int k0 = 0; k0 < F; k0 += TK) {
      const int kl = min(TK, F - k0);
      load_k(dgs, dg + eh + k0, F, kl, rows);             // dG[r, j]
      load_k(dus, du + eh + k0, F, kl, rows);
      load_k(w1s, w1 + ew + (long long)n0 * F + k0, F, kl, cols);  // W1[n, j]
      load_k(w3s, w3 + ew + (long long)n0 * F + k0, F, kl, cols);
      __syncthreads();
      mac(dgs, w1s, acc);
      mac(dus, w3s, acc);
      __syncthreads();
    }
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
    if (r >= tile_rows) continue;
    T* out = dx + ((long long)e * C + r0 + r) * D + n0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = R * tx + j;
      if (c < cols) out[c] = repro::from_f32<T>(r < rows ? acc[i][j] : 0.f);
    }
  }
}

// pass 3: dW1, dW3 of rows [i0, i0 + 64) of d and columns [j0, j0 + 64) of
// f, and dW2 of the transposed tile, over the expert's live rows
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const T* __restrict__ h, const T* __restrict__ dg,
              const T* __restrict__ du, const int* __restrict__ counts,
              T* __restrict__ dw1, T* __restrict__ dw3, T* __restrict__ dw2,
              int C, int D, int F) {
  __shared__ __align__(16) Tile xs, dys, hs, dgs, dus;
  const int i0 = blockIdx.x * TT, j0 = blockIdx.y * TT, e = blockIdx.z;
  const int live = live_rows(counts, e, C);
  const int di = min(TT, D - i0), fj = min(TT, F - j0);
  const long long ex = (long long)e * C * D, eh = (long long)e * C * F;
  float a1[R][R], a3[R][R], a2[R][R];
  zero_acc(a1);
  zero_acc(a3);
  zero_acc(a2);
  for (int k0 = 0; k0 < live; k0 += TK) {
    const int kl = min(TK, live - k0);
    load_n(xs, x + ex + (long long)k0 * D + i0, D, kl, di);    // X[c, i]
    load_n(dys, dy + ex + (long long)k0 * D + i0, D, kl, di);  // dY[c, i]
    load_n(hs, h + eh + (long long)k0 * F + j0, F, kl, fj);    // H[c, j]
    load_n(dgs, dg + eh + (long long)k0 * F + j0, F, kl, fj);
    load_n(dus, du + eh + (long long)k0 * F + j0, F, kl, fj);
    __syncthreads();
    mac2(xs, dgs, dus, a1, a3);   // dW1[i, j], dW3[i, j]
    mac(hs, dys, a2);             // dW2[j, i]
    __syncthreads();
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long ew = (long long)e * D * F;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = R * tx + j;
      if (r < di && c < fj) {
        const long long at = ew + (long long)(i0 + r) * F + j0 + c;
        dw1[at] = repro::from_f32<T>(a1[i][j]);
        dw3[at] = repro::from_f32<T>(a3[i][j]);
      }
      if (r < fj && c < di)
        dw2[ew + (long long)(j0 + r) * D + i0 + c] =
            repro::from_f32<T>(a2[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* w3,
                   const void* w2, const int* counts, const void* dy,
                   void* h, void* dg, void* du, void* dx, void* dw1,
                   void* dw3, void* dw2, int E, int C, int D, int F,
                   cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  const auto* w1t = static_cast<const T*>(w1);
  const auto* w3t = static_cast<const T*>(w3);
  const auto* w2t = static_cast<const T*>(w2);
  const auto* dyt = static_cast<const T*>(dy);
  auto* ht = static_cast<T*>(h);
  auto* dgt = static_cast<T*>(dg);
  auto* dut = static_cast<T*>(du);
  const int rt = (C + TT - 1) / TT, dt = (D + TT - 1) / TT,
            ft = (F + TT - 1) / TT;
  hidden_kernel<T><<<dim3(ft, E, rt), THREADS, 0, s>>>(
      xt, w1t, w3t, w2t, dyt, counts, ht, dgt, dut, C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dx_kernel<T><<<dim3(dt, E, rt), THREADS, 0, s>>>(
      dgt, dut, w1t, w3t, counts, static_cast<T*>(dx), C, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_kernel<T><<<dim3(dt, ft, E), THREADS, 0, s>>>(
      xt, dyt, ht, dgt, dut, counts, static_cast<T*>(dw1),
      static_cast<T*>(dw3), static_cast<T*>(dw2), C, D, F);
  return cudaGetLastError();
}

}  // namespace moe_bwd

// K3's gradient (kernels/moe_dispatch.py:moe_ffn_bwd): buf, w1, w3, w2 and
// dy as the forward's operands and output; counts (E,) int32 live rows per
// expert, or null (every row is live); h, dg and du (E, C, f) scratch of the
// operand dtype; dx (E, C, d), dw1 and dw3 (E, d, f), dw2 (E, f, d).  Three
// launches on ``stream``.
extern "C" int repro_moe_ffn_bwd(const void* buf, const void* w1,
                                 const void* w3, const void* w2,
                                 const void* counts, const void* dy, void* h,
                                 void* dg, void* du, void* dx, void* dw1,
                                 void* dw3, void* dw2, int E, int C, int D,
                                 int F, int dtype, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0 ||
      (C + 63) / 64 > 65535 || (F + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* n = static_cast<const int*>(counts);
  switch (dtype) {
    case repro::kFloat32:
      return moe_bwd::launch<float>(buf, w1, w3, w2, n, dy, h, dg, du, dx,
                                    dw1, dw3, dw2, E, C, D, F, s);
    case repro::kBFloat16:
      return moe_bwd::launch<__nv_bfloat16>(buf, w1, w3, w2, n, dy, h, dg,
                                            du, dx, dw1, dw3, dw2, E, C, D,
                                            F, s);
    default:
      return cudaErrorInvalidValue;
  }
}
