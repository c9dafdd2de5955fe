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
// What bounds it (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): 16 E C d f
// operations over the live rows (the recompute 4, dH 2, dX 4, the weight
// gradients 6) against ~3 E d f reads and ~3 E d f writes of weights and
// gradients.  At olmoe-1b-7b's training shape (E 64, C 640, d 2048, f 1024,
// 32,768 live rows) that is ~1.1 TFLOP over ~0.8 GB: the operations bound
// it, 1.112 ms on the tensor cores.  At qwen3-moe-30b-a3b's (E 128, C 320,
// f 768) the bytes do, 0.851 ms.
//
// Both routes take three launches on one stream, no atomics, one writer
// per output element and no split of d, f or C across blocks, so two runs
// give the same bits:
//   1. hidden: G, U over d from X, W1, W3 and dH over d from dY, W2; H,
//      dG, dU to (E, C, f) scratch for the live rows (the wgmma route also
//      writes zeros from the count to its row tile's end); a tile with no
//      live row does nothing;
//   2. dX = dG W1^T + dU W3^T over f, one accumulator, both products in
//      one pass; rows past the count, and tiles with none live, written
//      as zeros;
//   3. dW1 and dW3 of a (d, f) tile and dW2 of the transposed (f, d) tile,
//      over the expert's live rows in ascending order; an expert without
//      rows writes zeros and reads nothing.
// Rows at or past counts[e] hold anything: the dispatch leaves X's rows
// there unspecified and dY's are the caller's, and 0 x NaN is NaN.  No
// route reads them into a sum over rows: passes 1 and 2 never mix rows
// (each output row is its own row's products, masked on the way out), and
// pass 3 stops at the count.
//
// bf16 with d and f multiples of 64 (every olmoe-1b-7b and qwen3-moe-30b-a3b
//   training call; kernels/moe_dispatch.py:bwd_route "bwd_wgmma"): wgmma fed
//   by TMA, kernels *_kernel_wgmma.  Each block has one producer warp that
//   keeps a ring of three stages full (3-D tensor maps, experts outermost,
//   so a box never crosses an expert and rows past C read as zero) and two
//   or three consumer warpgroups with one fp32 accumulator of 64 x 128
//   each (64 registers a thread, no spills; no setmaxnreg needed).
//   1. block (64 hidden columns, 128 token rows, expert), three consumer
//      warpgroups, one product each, over d in slabs of 64: G = W1 slab .
//      X, U = W3 slab . X, dH = W2 slab . dY.  The weights are wgmma's A
//      and the token rows its n128 B, as the forward (swap AB): W1 and W3
//      (d, f) slabs are MN-major A, W2's rows are hidden columns with d
//      contiguous, a K-major A, and X and dY rows are K-major B.  The three
//      accumulators share one fragment layout, so the SwiGLU gradient is
//      elementwise: the warpgroups swap their fp32 fragments through the
//      (then idle) ring, each computes one of H, dU, dG in fp32 exactly as
//      moe_ffn_bwd_ref, rounds it once and stages it; rows leave in 16-byte
//      stores.
//   2. block (128 columns of d, 128 token rows, expert), two consumer
//      warpgroups of 64 columns each, over f in slabs of 64: acc += W1 rows
//      . dG rows, then += W3 rows . dU rows (all K-major, n128).
//   3. block (128 hidden columns, 64 columns of d, expert), three consumer
//      warpgroups, one gradient each, over the live rows in chunks of 64:
//      C is the reduction, so every operand is MN-major (X and H as A, dG,
//      dU and dY as B through the instruction's B transpose), n64 per
//      64-column box.  The last chunk's rows from the count to the box's
//      end are zeroed in shared memory before its products (TMA reads
//      whole boxes).
//   The grids take the expert as their slowest index, so one expert's X,
//   dY, H, dG and dU (~9 MB at olmoe's shape) stay in L2 while its tiles
//   run.  Scratch rows that pass 1 leaves unwritten (tiles past the
//   count) are never read: pass 2 skips those tiles and pass 3 stops at
//   the count.
//   Numerics: every sum is fp32, but the tensor cores take G, U and dH in
//   another order than a plain fp32 product, so a few of H, dG and dU
//   (0.21%, 0.32% and 0.21% at olmoe's shape) round to the other bf16
//   neighbour of the plain version's value, and dW sums such a step over
//   hundreds of rows.  chip_smoke.py phase 31 (a) holds the route to
//   exactly that (k3_backward_contract: the share of them off the plain
//   version's, dW normwise, and a control that rounds dH to bf16 must
//   fail both).
//
// fp32, and shapes the wgmma route does not take ("bwd_simt"): the CUDA
//   cores, in fp32, kernels hidden_kernel, dx_kernel and dw_kernel; their
//   own ceiling is the 67 TFLOP/s of fp32 FMA.  Each launch is a tiled
//   SIMT product of 64 x 64 output tiles, 256 threads a block, 4 x 4
//   outputs a thread (rows 4 ty + i, columns 4 tx + j), over k steps of 32
//   staged through shared memory as fp32 [32][68] tiles: a thread reads
//   its four values of a row in one 16-byte load, and the padding spreads
//   the transposing stores over 8 banks.  No block holds a whole hidden
//   row, so d and f are unbounded.  Pass 1's block is (f tile, expert, row
//   tile), pass 2's (d tile, expert, row tile), pass 3's (d tile, f tile,
//   expert).  X and dY rows past the count are masked as they are staged.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// the bf16 tensor-core route ("bwd_wgmma"): the header's design
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BK = 64;                 // k a slab or chunk: 128 bytes of bf16
constexpr int WG = 128;                // threads of a consumer warpgroup
constexpr int ROWS = 128;              // token rows a block of passes 1, 2
constexpr uint32_t BOX = 64 * 64 * 2;  // one 64 x 64 bf16 box: 8 KB
constexpr int STAGES = 3;              // slabs or chunks in flight
constexpr int HS = 64 + 8;             // staging row of 64 columns, padded
constexpr int XS = 128 + 8;            // staging row of 128 columns, padded
enum Pass { kHidden = 0, kDx = 1, kDw = 2 };

// consumer warpgroups of a pass
__host__ __device__ constexpr int consumers(int pass) {
  return pass == kDx ? 2 : 3;
}

// one stage of the ring: hidden, three 64 x 64 weight slabs and 128 rows
// of X and dY (two boxes each); dx, 128 rows of W1 and W3 and 128 rows of
// dG and dU; dw, 64 rows of X and dY and 64 x 128 of H, dG and dU
__host__ __device__ constexpr uint32_t stage_bytes(int pass) {
  return pass == kHidden ? 7 * BOX : 8 * BOX;
}

// dynamic shared memory of a pass: the ring, full and empty barriers, and
// room to align the ring to 1024 bytes (the swizzle atom).  The epilogues
// reuse the ring once every product is done.
__host__ __device__ constexpr uint32_t smem_bytes(int pass) {
  return STAGES * stage_bytes(pass) + 16 * STAGES + 1024;
}

static_assert(smem_bytes(kHidden) <= 232448 && smem_bytes(kDx) <= 232448 &&
                  smem_bytes(kDw) <= 232448,
              "each ring fits one block's shared memory");
// pass 1's epilogue: three fp32 fragments and three staged bf16 tiles
static_assert(3 * 64 * WG * 4 + 3 * ROWS * HS * 2 <=
                  STAGES * stage_bytes(kHidden),
              "pass 1's epilogue fits its ring");
static_assert(ROWS * XS * 2 <= STAGES * stage_bytes(kDx),
              "pass 2's epilogue fits its ring");
static_assert(2 * 64 * XS * 2 + 128 * HS * 2 <= STAGES * stage_bytes(kDw),
              "pass 3's epilogue fits its ring");

template <int N>
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// make this thread's shared-memory stores visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the ring of a pass: stages from a 1024-byte aligned base, then STAGES
// full barriers (the producer's expect_tx) and STAGES empty ones (every
// consumer thread arrives)
struct Ring {
  uint32_t base, full, empty;
  uint8_t* ptr;  // base as a generic pointer
};

template <int PASS>
__device__ __forceinline__ Ring ring_init(uint8_t* raw) {
  Ring r;
  const uint32_t s = smem_u32(raw);
  r.base = (s + 1023) & ~1023u;
  r.full = r.base + STAGES * stage_bytes(PASS);
  r.empty = r.full + 8 * STAGES;
  r.ptr = raw + (r.base - s);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(r.full + 8 * i, 1);
      mbar_init(r.empty + 8 * i, consumers(PASS) * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int N>
__device__ __forceinline__ void zero_frag(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// rows x cols zeros (cols a multiple of 8) of a bf16 tile at out, row
// pitch ld, by the whole block
__device__ __forceinline__ void store_zeros(__nv_bfloat16* out, long long ld,
                                            int rows, int cols) {
  const int q = cols / 8;
  for (int i = threadIdx.x; i < rows * q; i += blockDim.x)
    reinterpret_cast<uint4*>(out + (long long)(i / q) * ld)[i % q] =
        make_uint4(0, 0, 0, 0);
}

// rows x cols of a staged bf16 tile (row pitch sp) to out (row pitch ld)
// in 16-byte stores, by the NC consumer threads
template <int NC>
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, long long ld,
                                           const __nv_bfloat16* stg, int sp,
                                           int rows, int cols) {
  const int q = cols / 8;
  for (int i = threadIdx.x; i < rows * q; i += NC)
    reinterpret_cast<uint4*>(out + (long long)(i / q) * ld)[i % q] =
        reinterpret_cast<const uint4*>(stg + (i / q) * sp)[i % q];
}

// pass 1's products over d: acc (64 hidden columns x 128 token rows) +=
// A . B slab after slab, A at a_off of each stage (TRANS_A 1: a (d, f)
// slab, MN-major, a k16 step 16 rows of d, 2048 bytes; 0: W2's rows,
// K-major, 32 bytes along them), B the token rows at b_off (K-major)
template <int TRANS_A>
__device__ __forceinline__ void hidden_products(float (&acc)[64],
                                                const Ring& rg,
                                                uint32_t a_off,
                                                uint32_t b_off, int slabs) {
  Pipe p;
  int prev = -1;
  for (int kb = 0; kb < slabs; ++kb) {
    mbar_wait(rg.full + 8 * p.stage, p.phase);
    const uint32_t st = rg.base + p.stage * stage_bytes(kHidden);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = TRANS_A
                              ? desc(st + a_off + 2048 * kk, 1024, 1024)
                              : desc(st + a_off + 32 * kk, 16, 1024);
      wgmma_ss<128, TRANS_A>(acc, da, desc(st + b_off + 32 * kk, 16, 1024),
                             (kb > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    fence_regs(acc);
    // the previous slab's products are done: hand its stage back
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(rg.empty + 8 * prev);
    prev = p.stage;
    p.next();
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

}  // namespace tc

// pass 1 on the tensor cores: H, dG and dU of hidden columns [j0, j0 + 64)
// and token rows [r0, r0 + 128) of expert e.  Warpgroup 0 accumulates
// G^T, 1 U^T, 2 dH^T (64 hidden columns x 128 rows, fp32) over d.
__global__ void __launch_bounds__(3 * tc::WG + 32, 1)
    hidden_kernel_wgmma(const __grid_constant__ CUtensorMap map_w1,
                        const __grid_constant__ CUtensorMap map_w3,
                        const __grid_constant__ CUtensorMap map_w2,
                        const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_dy,
                        const int* __restrict__ counts,
                        __nv_bfloat16* __restrict__ h,
                        __nv_bfloat16* __restrict__ dg,
                        __nv_bfloat16* __restrict__ du, int C, int D, int F) {
  using namespace tc;
  constexpr int NC = 3 * WG;
  constexpr uint32_t STAGE = stage_bytes(kHidden);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * 64, r0 = blockIdx.y * ROWS, e = blockIdx.z;
  const int live = live_rows(counts, e, C);
  if (r0 >= live) return;  // no live row: its scratch is never read
  const int tile_rows = min(ROWS, C - r0);
  const int rows = min(tile_rows, live - r0);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Ring rg = ring_init<kHidden>(smem_raw);
  const int slabs = D / BK;

  if (tid >= NC) {
    // producer: one thread, slab after slab of d
    if (tid == NC) {
      Pipe p;
      for (int kb = 0; kb < slabs; ++kb, p.next()) {
        const uint32_t st = rg.base + p.stage * STAGE;
        const uint32_t bar = rg.full + 8 * p.stage;
        mbar_wait(rg.empty + 8 * p.stage, p.phase ^ 1);
        mbar_expect_tx(bar, STAGE);
        tma_load(st, &map_w1, j0, kb * BK, e, bar);            // W1[d, j]
        tma_load(st + BOX, &map_w3, j0, kb * BK, e, bar);      // W3[d, j]
        tma_load(st + 2 * BOX, &map_w2, kb * BK, j0, e, bar);  // W2[j, d]
        tma_load(st + 3 * BOX, &map_x, kb * BK, r0, e, bar);   // X[r, d]
        tma_load(st + 5 * BOX, &map_dy, kb * BK, r0, e, bar);  // dY[r, d]
      }
    }
    return;
  }

  const int wg = tid / WG;
  float acc[64];
  zero_frag(acc);
  // G^T or U^T: the (d, f) slab is MN-major A; dH^T: W2's rows are hidden
  // columns with d contiguous, a K-major A.  One loop each, so no wgmma
  // sits in a branch of the pipeline
  if (wg < 2)
    hidden_products<1>(acc, rg, wg * BOX, 3 * BOX, slabs);
  else
    hidden_products<0>(acc, rg, 2 * BOX, 5 * BOX, slabs);

  // every product is done and the ring idle: the three fp32 fragments go
  // to shared memory, slot [i][t] (a warp's stores are consecutive), and
  // warpgroup 0 computes H, 1 dU, 2 dG from them, as moe_ffn_bwd_ref
  bar_consumers<NC>();
  float* xch = reinterpret_cast<float*>(rg.ptr);
  const int t = tid % WG;
#pragma unroll
  for (int i = 0; i < 64; ++i) xch[(wg * 64 + i) * WG + t] = acc[i];
  bar_consumers<NC>();
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(xch + 3 * 64 * WG);
  __nv_bfloat16* mine = stg + wg * ROWS * HS;
  const int warp = t / 32, lane = t % 32;
  // value 4c + r of the fragment: hidden column warp*16 + lane/4 (+8 for
  // r >= 2), token row 8c + 2(lane%4) (+1 for odd r)
#pragma unroll 4
  for (int i = 0; i < 64; ++i) {
    const int c = i / 4, r = i % 4;
    const int col = warp * 16 + (lane >> 2) + 8 * (r >> 1);
    const int row = 8 * c + 2 * (lane & 3) + (r & 1);
    const float g = xch[i * WG + t], u = xch[(64 + i) * WG + t];
    const float dh = xch[(128 + i) * WG + t];
    const float s = 1.f / (1.f + expf(-g));
    const float silu = g * s;
    const float v = wg == 0   ? silu * u
                    : wg == 1 ? dh * silu
                              : dh * u * (s * (1.f + g * (1.f - s)));
    // rows from the count to the tile's end are written as zeros
    mine[row * HS + col] = __float2bfloat16_rn(row < rows ? v : 0.f);
  }
  bar_consumers<NC>();
  const long long at = ((long long)e * C + r0) * F + j0;
  store_tile<NC>(h + at, F, stg, HS, tile_rows, 64);
  store_tile<NC>(du + at, F, stg + ROWS * HS, HS, tile_rows, 64);
  store_tile<NC>(dg + at, F, stg + 2 * ROWS * HS, HS, tile_rows, 64);
}

// pass 2 on the tensor cores: dX of columns [n0, n0 + 128) of d and token
// rows [r0, r0 + 128) of expert e.  Warpgroup w accumulates dX^T of
// columns n0 + 64w.. (64 x 128 rows, fp32) over f.
__global__ void __launch_bounds__(2 * tc::WG + 32, 1)
    dx_kernel_wgmma(const __grid_constant__ CUtensorMap map_w1,
                    const __grid_constant__ CUtensorMap map_w3,
                    const __grid_constant__ CUtensorMap map_dg,
                    const __grid_constant__ CUtensorMap map_du,
                    const int* __restrict__ counts,
                    __nv_bfloat16* __restrict__ dx, int C, int D, int F) {
  using namespace tc;
  constexpr int NC = 2 * WG;
  constexpr uint32_t STAGE = stage_bytes(kDx);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * 128, r0 = blockIdx.y * ROWS, e = blockIdx.z;
  const int live = live_rows(counts, e, C);
  const int tile_rows = min(ROWS, C - r0);
  const int rows = max(0, min(tile_rows, live - r0));
  const int cols = min(128, D - n0);
  __nv_bfloat16* ob = dx + ((long long)e * C + r0) * D + n0;
  if (rows == 0) {  // no live row: zeros, and no read of the scratch
    store_zeros(ob, D, tile_rows, cols);
    return;
  }
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Ring rg = ring_init<kDx>(smem_raw);
  const int slabs = F / BK;

  if (tid >= NC) {
    if (tid == NC) {
      Pipe p;
      for (int kb = 0; kb < slabs; ++kb, p.next()) {
        const uint32_t st = rg.base + p.stage * STAGE;
        const uint32_t bar = rg.full + 8 * p.stage;
        mbar_wait(rg.empty + 8 * p.stage, p.phase ^ 1);
        mbar_expect_tx(bar, STAGE);
        tma_load(st, &map_w1, kb * BK, n0, e, bar);            // W1[n, j]
        tma_load(st + 2 * BOX, &map_w3, kb * BK, n0, e, bar);  // W3[n, j]
        tma_load(st + 4 * BOX, &map_dg, kb * BK, r0, e, bar);  // dG[r, j]
        tma_load(st + 6 * BOX, &map_du, kb * BK, r0, e, bar);  // dU[r, j]
      }
    }
    return;
  }

  const int wg = tid / WG;
  float acc[64];
  zero_frag(acc);
  Pipe p;
  int prev = -1;
  for (int kb = 0; kb < slabs; ++kb) {
    mbar_wait(rg.full + 8 * p.stage, p.phase);
    const uint32_t st = rg.base + p.stage * STAGE;
    fence_regs(acc);
    wgmma_fence();
    // every operand K-major (f contiguous): the W1 then the W3 rows of the
    // warpgroup's 64 columns of d as A, the dG then the dU rows as n128 B
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<128, 0>(acc, desc(st + wg * BOX + 32 * kk, 16, 1024),
                       desc(st + 4 * BOX + 32 * kk, 16, 1024),
                       (kb > 0 || kk > 0) ? 1 : 0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<128, 0>(acc, desc(st + (2 + wg) * BOX + 32 * kk, 16, 1024),
                       desc(st + 6 * BOX + 32 * kk, 16, 1024), 1);
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(rg.empty + 8 * prev);
    prev = p.stage;
    p.next();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue through the idle ring, transposed to token rows, zeros past
  // the count; rows leave in 16-byte stores
  bar_consumers<NC>();
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(rg.ptr);
  const int t = tid % WG, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int c = i / 4, r = i % 4;
    const int col = 64 * wg + warp * 16 + (lane >> 2) + 8 * (r >> 1);
    const int row = 8 * c + 2 * (lane & 3) + (r & 1);
    stg[row * XS + col] = __float2bfloat16_rn(row < rows ? acc[i] : 0.f);
  }
  bar_consumers<NC>();
  store_tile<NC>(ob, D, stg, XS, tile_rows, cols);
}

// pass 3 on the tensor cores: dW1 and dW3 of rows [i0, i0 + 64) of d and
// hidden columns [j0, j0 + 128), and dW2 of the transposed tile, of expert
// e, over its live rows in chunks of 64, ascending.  Warpgroup 0
// accumulates dW1, 1 dW3, 2 dW2, each as two 64 x 64 fp32 pieces.
__global__ void __launch_bounds__(3 * tc::WG + 32, 1)
    dw_kernel_wgmma(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_dy,
                    const __grid_constant__ CUtensorMap map_h,
                    const __grid_constant__ CUtensorMap map_dg,
                    const __grid_constant__ CUtensorMap map_du,
                    const int* __restrict__ counts,
                    __nv_bfloat16* __restrict__ dw1,
                    __nv_bfloat16* __restrict__ dw3,
                    __nv_bfloat16* __restrict__ dw2, int C, int D, int F) {
  using namespace tc;
  constexpr int NC = 3 * WG;
  constexpr uint32_t STAGE = stage_bytes(kDw);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * 128, i0 = blockIdx.y * 64, e = blockIdx.z;
  const int live = live_rows(counts, e, C);
  const int fcols = min(128, F - j0);
  const long long ew = (long long)e * D * F;
  __nv_bfloat16* o1 = dw1 + ew + (long long)i0 * F + j0;
  __nv_bfloat16* o3 = dw3 + ew + (long long)i0 * F + j0;
  __nv_bfloat16* o2 = dw2 + ew + (long long)j0 * D + i0;
  if (live == 0) {  // an expert without rows: zeros, nothing read
    store_zeros(o1, F, 64, fcols);
    store_zeros(o3, F, 64, fcols);
    store_zeros(o2, D, fcols, 64);
    return;
  }
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Ring rg = ring_init<kDw>(smem_raw);
  const int chunks = (live + BK - 1) / BK;

  if (tid >= NC) {
    if (tid == NC) {
      Pipe p;
      for (int kc = 0; kc < chunks; ++kc, p.next()) {
        const uint32_t st = rg.base + p.stage * STAGE;
        const uint32_t bar = rg.full + 8 * p.stage;
        const int c0 = kc * BK;
        mbar_wait(rg.empty + 8 * p.stage, p.phase ^ 1);
        mbar_expect_tx(bar, STAGE);
        tma_load(st, &map_x, i0, c0, e, bar);         // X[c, i]
        tma_load(st + BOX, &map_dy, i0, c0, e, bar);  // dY[c, i]
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          tma_load(st + (2 + b) * BOX, &map_h, j0 + 64 * b, c0, e, bar);
          tma_load(st + (4 + b) * BOX, &map_dg, j0 + 64 * b, c0, e, bar);
          tma_load(st + (6 + b) * BOX, &map_du, j0 + 64 * b, c0, e, bar);
        }
      }
    }
    return;
  }

  // C is the reduction, so every box is MN-major (a k16 step is 16 of its
  // rows, 2048 bytes) and B takes the instruction's transpose.  Piece b of
  // warpgroup 0 (1): X as A (64 columns of d) . box b of dG (dU) as B;
  // of warpgroup 2: box b of H as A (64 hidden columns) . dY as B
  const int wg = tid / WG;
  const uint32_t a_off[2] = {wg < 2 ? 0u : 2 * BOX, wg < 2 ? 0u : 3 * BOX};
  const uint32_t b_off[2] = {wg < 2 ? (4 + 2 * wg) * BOX : BOX,
                             wg < 2 ? (5 + 2 * wg) * BOX : BOX};
  float acc[2][32];
  zero_frag(acc[0]);
  zero_frag(acc[1]);
  Pipe p;
  int prev = -1;
  for (int kc = 0; kc < chunks; ++kc) {
    mbar_wait(rg.full + 8 * p.stage, p.phase);
    const uint32_t st = rg.base + p.stage * STAGE;
    const int past = live - kc * BK;  // live rows of this chunk
    if (past < BK) {
      // the last chunk: rows [past, 64) of its eight boxes may hold
      // anything (X and dY past the count), and 0 x NaN is NaN, so they
      // become zeros before any product.  The 128-byte swizzle moves
      // 16-byte pieces within a row only: a whole row is bytes
      // [128 row, 128 row + 128) of its box.
      const int per_box = (BK - past) * 8;
      for (int i = tid; i < 8 * per_box; i += NC) {
        const int b = i / per_box, q = i % per_box;
        *reinterpret_cast<uint4*>(rg.ptr + (st - rg.base) + b * BOX +
                                  (past + q / 8) * 128 + (q % 8) * 16) =
            make_uint4(0, 0, 0, 0);
      }
      fence_async_smem();
      bar_consumers<NC>();
    }
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wgmma_ss<64, 1, 1>(acc[b], desc(st + a_off[b] + 2048 * kk, 1024, 1024),
                           desc(st + b_off[b] + 2048 * kk, 1024, 1024),
                           (kc > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(rg.empty + 8 * prev);
    prev = p.stage;
    p.next();
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // epilogue through the idle ring: dW1 and dW3 as 64 rows of 128
  // columns, dW2 as 128 rows of 64.  Value 4c + r of piece b is row
  // warp*16 + lane/4 (+8 for r >= 2) and column 64b + 8c + 2(lane%4) (+1
  // for odd r) of its tile (dW2: row 64b + warp*16 + ..., column 8c + ...)
  bar_consumers<NC>();
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(rg.ptr);
  __nv_bfloat16* s2 = stg + 2 * 64 * XS;
  const int t = tid % WG, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int m = warp * 16 + (lane >> 2) + 8 * hi;
        const int n = 8 * c + 2 * (lane & 3);
        __nv_bfloat16* at = wg < 2 ? stg + (wg * 64 + m) * XS + 64 * b + n
                                   : s2 + (64 * b + m) * HS + n;
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(
            acc[b][4 * c + 2 * hi], acc[b][4 * c + 2 * hi + 1]);
      }
  bar_consumers<NC>();
  store_tile<NC>(o1, F, stg, XS, 64, fcols);
  store_tile<NC>(o3, F, stg + 64 * XS, XS, 64, fcols);
  store_tile<NC>(o2, D, s2, HS, fcols, 64);
}

// the three wgmma passes on one stream
static cudaError_t launch_wgmma(const void* x, const void* w1,
                                const void* w3, const void* w2,
                                const int* counts, const void* dy, void* h,
                                void* dg, void* du, void* dx, void* dw1,
                                void* dw3, void* dw2, int E, int C, int D,
                                int F, cudaStream_t s) {
  using namespace tc;
  if (encoder() == nullptr)
    return refuse("cuTensorMapEncodeTiled not found in the driver");
  // pass 1: weight slabs of 64 x 64 and 128 token rows; pass 2: 128 rows
  // of W1, W3, dG and dU; pass 3: 64 rows of X, dY, H, dG and dU
  Map w1s, w3s, w2s, xr, dyr, w1r, w3r, dgr, dur, xc, dyc, hc, dgc, duc;
  if (!map_stack(&w1s.m, w1, E, D, F, 64) ||
      !map_stack(&w3s.m, w3, E, D, F, 64) ||
      !map_stack(&w2s.m, w2, E, F, D, 64) ||
      !map_stack(&xr.m, x, E, C, D, ROWS) ||
      !map_stack(&dyr.m, dy, E, C, D, ROWS) ||
      !map_stack(&w1r.m, w1, E, D, F, 128) ||
      !map_stack(&w3r.m, w3, E, D, F, 128) ||
      !map_stack(&dgr.m, dg, E, C, F, ROWS) ||
      !map_stack(&dur.m, du, E, C, F, ROWS) ||
      !map_stack(&xc.m, x, E, C, D, BK) ||
      !map_stack(&dyc.m, dy, E, C, D, BK) ||
      !map_stack(&hc.m, h, E, C, F, BK) ||
      !map_stack(&dgc.m, dg, E, C, F, BK) ||
      !map_stack(&duc.m, du, E, C, F, BK))
    return refuse("cuTensorMapEncodeTiled refused an operand");
  static bool ready[3][64] = {};
  const int row_tiles = (C + ROWS - 1) / ROWS;
  cudaError_t err = opt_in_smem((const void*)hidden_kernel_wgmma,
                                smem_bytes(kHidden), ready[kHidden]);
  if (err != cudaSuccess) return err;
  hidden_kernel_wgmma<<<dim3(F / 64, row_tiles, E), 3 * WG + 32,
                        smem_bytes(kHidden), s>>>(
      w1s.m, w3s.m, w2s.m, xr.m, dyr.m, counts,
      static_cast<__nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(dg),
      static_cast<__nv_bfloat16*>(du), C, D, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = opt_in_smem((const void*)dx_kernel_wgmma, smem_bytes(kDx),
                    ready[kDx]);
  if (err != cudaSuccess) return err;
  dx_kernel_wgmma<<<dim3((D + 127) / 128, row_tiles, E), 2 * WG + 32,
                    smem_bytes(kDx), s>>>(
      w1r.m, w3r.m, dgr.m, dur.m, counts, static_cast<__nv_bfloat16*>(dx),
      C, D, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = opt_in_smem((const void*)dw_kernel_wgmma, smem_bytes(kDw),
                    ready[kDw]);
  if (err != cudaSuccess) return err;
  dw_kernel_wgmma<<<dim3((F + 127) / 128, D / 64, E), 3 * WG + 32,
                    smem_bytes(kDw), s>>>(
      xc.m, dyc.m, hc.m, dgc.m, duc.m, counts,
      static_cast<__nv_bfloat16*>(dw1), static_cast<__nv_bfloat16*>(dw3),
      static_cast<__nv_bfloat16*>(dw2), C, D, F);
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

// the bf16 wgmma route (kernels/moe_dispatch.py:bwd_route "bwd_wgmma"): the
// operands of repro_moe_ffn_bwd in bf16, d and f multiples of 64, every
// pointer 16-byte aligned.  Three launches on ``stream``.
extern "C" int repro_moe_ffn_bwd_wgmma(const void* buf, const void* w1,
                                       const void* w3, const void* w2,
                                       const void* counts, const void* dy,
                                       void* h, void* dg, void* du, void* dx,
                                       void* dw1, void* dw3, void* dw2, int E,
                                       int C, int D, int F, void* stream) {
  hopper::refusal() = "";
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0 || D % 64 ||
      F % 64 || (C + 127) / 128 > 65535 || D / 64 > 65535)
    return hopper::refuse("shapes: 0 < E <= 65535, C > 0, d and f "
                          "multiples of 64");
  uintptr_t ptrs = 0;
  for (const void* q : {buf, w1, w3, w2, dy, (const void*)h, (const void*)dg,
                        (const void*)du, (const void*)dx, (const void*)dw1,
                        (const void*)dw3, (const void*)dw2})
    ptrs |= reinterpret_cast<uintptr_t>(q);
  if (ptrs % 16)
    return hopper::refuse("TMA and the 16-byte stores need 16-byte aligned "
                          "operands");
  return moe_bwd::launch_wgmma(buf, w1, w3, w2,
                               static_cast<const int*>(counts), dy, h, dg,
                               du, dx, dw1, dw3, dw2, E, C, D, F,
                               static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of a wgmma-route block of pass ``pass`` (0 hidden,
// 1 dx, 2 dw; 0 bytes for another)
extern "C" int repro_moe_ffn_bwd_wgmma_smem(int pass) {
  return pass >= 0 && pass <= 2 ? (int)moe_bwd::tc::smem_bytes(pass) : 0;
}
