// K2: matrix product (M,K) @ (K,N) -> (M,N) for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/matmul.py:matmul (_kernel, its
// pl.pallas_call at :54): an fp32 accumulator over K, one output write in
// x's dtype.  Two routes, chosen by dtype in repro_matmul:
//
// bf16 (every served product): wgmma fed by TMA.
//   What bounds it (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at decode M is
//   the batch (4), each weight byte carries 4 FLOP, far under the ridge of
//   ~295 FLOP per byte, so a product costs its weight bytes (qwen3-0.6b's
//   tied head streams 315 MB, ~94 us; a recurrentgemma-2b step ~5.3 GB,
//   ~1.6 ms).  At admission (M = 256) a projection carries 256 FLOP per
//   weight byte, near the ridge: bytes and tensor cores both bound it.
//   Design, "swap AB": a block computes a tile of out^T (N,M) = W^T (N,K)
//   x^T (K,M), so the weights are wgmma's A operand (64 weight columns, the
//   instruction's m64) and the x rows its n: at M = 4 an n64 instruction
//   carries 4 live columns where a 64-row tile of x would carry 60 zero
//   rows.  A producer warp keeps a ring of slabs (64 of K) in flight with
//   TMA into 128-byte-swizzled shared memory, guarded by full/empty
//   mbarriers; one consumer warpgroup runs 4 wgmma k16 steps per slab, the
//   sums in fp32 registers, one slab's group still in flight while the
//   next is issued.  Row-major (K,N) weights are MN-major for A (wgmma
//   transposes 16-bit A); the tied head's (V,d) table viewed as (d,V) is
//   K-major; x (M,K) is K-major for B.  TMA zero-fills the ragged edges of
//   M, N and K; stores are masked.  Tensor maps are encoded through the
//   driver entry point (no -lcuda) and cached by what they encode; the
//   barrier, TMA, wgmma and tensor-map helpers live in hopper.cuh, shared
//   with K1 and K3.
//   Split of K: kernels/matmul.py:plan(k, n, dtype) cuts the slabs into S
//   segments, segment s = [s*slabs/S, (s+1)*slabs/S), S a function of
//   (K, N, dtype) alone, chosen so that ceil(N/64) x S blocks fill the 132
//   SMs about twice at decode.  Each segment sums its k16 steps in order
//   from zero into p_s; the output is ((p_0 + p_1) + ...) + p_{S-1} in
//   fp32, rounded once to bf16.  The wrapper picks the route
//   (matmul.py:route).  Up to SMALL_M = 64 rows every segment is its own
//   block (grid z = S): the blocks write p_s to an fp32 workspace (S,M,N),
//   count their arrival on the tile's int32 counter, and the last to
//   arrive adds the S partials in segment order, writes bf16 and resets the
//   counter.  Above 64 rows one block walks all S segments and adds them in
//   registers in the same order, over x tiles of 128 rows (ring of 8) where
//   that gives every SM a block, else of 64 (ring of 4).  Atomics count
//   arrivals only and never add values.
//   M-invariance: a row's bits depend on K, N and the dtype, never on M.
//   Every M up to the threshold SMALL_M = 64 takes one path (an n64
//   instruction over one 64-row x tile, the same segments, the same
//   combine), so the engine's batch-4 decode rows equal the reference's
//   batch-1 rows bit for bit.  Above 64 the same sums are added in the same
//   order; they equal the small-M rows as long as the tensor cores round an
//   element alike at n64 and n128 (on the H100 they do: chip_smoke.py
//   phase 3 checks M = 37 and 256 too).
//   Operands must suit TMA: 16-byte aligned bases and row strides that are
//   multiples of 16 bytes; the wrapper raises on a weight that does not,
//   and the C entry refuses one (repro_refusal says why).  There is
//   no fallback.
//
// fp32 (the reduced parity runs): CUDA-core FMAs, unchanged since it was
//   first written.  One block of 256 threads owns a 64x64 output tile, each
//   thread a 4x4 fp32 micro-tile; K advances in steps of 32 through fp32
//   copies in shared memory, zero past the ragged edges, the next step's
//   tiles fetched into registers while the current one is multiplied.  w
//   is read through its strides (n-fastest or k-fastest loads).  Every
//   output element sums k = 0, 1, ..., K-1 in one fixed order whatever M
//   is.  (wgmma has no fp32 path without TF32, which the port turns off.)
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cuda_core {


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

}  // namespace cuda_core

namespace tc {

using namespace hopper;

constexpr int BN = 64;        // weight columns per block: wgmma's m
constexpr int BK = 64;        // K per slab: one 128-byte swizzle row of bf16
constexpr int CONSUMERS = 128;             // one warpgroup
constexpr int THREADS = CONSUMERS + 32;    // + one producer warp
constexpr uint32_t A_BYTES = BN * BK * 2;  // one weight slab

// slabs in flight.  x tiles of 64 rows: 4 (66 KB: three blocks share an
// SM, each streaming its own weights at decode).  Of 128 rows: 8 (193 KB:
// the block's ~200 registers a thread leave room for one block an SM
// anyway, so its own ring has to cover the load latency)
template <int NT>
__host__ __device__ constexpr int stages() {
  return NT == 64 ? 4 : 8;
}

template <int NT>
__host__ __device__ constexpr uint32_t smem_bytes() {
  // ring of A and B slabs, full and empty barriers, the last-block flag,
  // and room to align the ring to 1024 bytes (the 128-byte swizzle atom)
  return stages<NT>() * (A_BYTES + NT * BK * 2) + 16 * stages<NT>() + 16 +
         1024;
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) = (x tile of NT rows, weight
// tile of BN columns, segment when split).  W_KMAJOR: the weight map is over
// a K-contiguous (d,V) view, coordinates (k, n); else over row-major (K,N),
// coordinates (n, k).  x's map is over (M,K), coordinates (k, m).
template <int NT, bool W_KMAJOR>
__global__ void __launch_bounds__(THREADS)
    wgmma_matmul_kernel(const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_x,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ counters,
                        int M, int N, int slabs, int segments, long long som,
                        int split) {
  constexpr uint32_t B_BYTES = NT * BK * 2;
  constexpr int NREG = NT / 2;
  constexpr int STAGES = stages<NT>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + STAGES * A_BYTES;
  const uint32_t full = b_ring + STAGES * B_BYTES;  // STAGES x 8 bytes
  const uint32_t empty = full + 8 * STAGES;         // STAGES x 8 bytes
  int* last_flag = reinterpret_cast<int*>(
      smem_raw + (empty + 8 * STAGES - raw));

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * NT;
  const int n0 = blockIdx.y * BN;
  const int seg_lo = split ? blockIdx.z : 0;
  const int seg_hi = split ? blockIdx.z + 1 : segments;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one thread keeps the ring full, slab after slab
    if (tid == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = seg_lo * slabs / segments;
           kb < seg_hi * slabs / segments; ++kb) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, A_BYTES + B_BYTES);
        if (W_KMAJOR)
          tma_load(a_ring + stage * A_BYTES, &map_w, kb * BK, n0,
                   full + 8 * stage);
        else
          tma_load(a_ring + stage * A_BYTES, &map_w, n0, kb * BK,
                   full + 8 * stage);
        tma_load(b_ring + stage * B_BYTES, &map_x, kb * BK, m0,
                 full + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: one warpgroup, D (64 weight columns x NT x rows) in fp32
  float acc[NREG], total[NREG];
#pragma unroll
  for (int i = 0; i < NREG; ++i) acc[i] = total[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int seg = seg_lo; seg < seg_hi; ++seg) {
    // segment seg covers slabs [seg * slabs / S, (seg + 1) * slabs / S)
    const int k_lo = seg * slabs / segments;
    const int k_hi = (seg + 1) * slabs / segments;
    int prev = -1;
    for (int kb = k_lo; kb < k_hi; ++kb) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a = a_ring + stage * A_BYTES;
      const uint32_t b = b_ring + stage * B_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major tiles step 32 bytes along their swizzled rows; the
        // MN-major weight tile steps two 8-row (1024-byte) groups of k, the
        // stride between k groups (its only stride that m64 uses) given
        // in both offset fields
        const uint64_t da = W_KMAJOR ? desc(a + 32 * kk, 16, 1024)
                                     : desc(a + 2048 * kk, 1024, 1024);
        const uint64_t db = desc(b + 32 * kk, 16, 1024);
        wgmma_ss<NT, W_KMAJOR ? 0 : 1>(acc, da, db,
                                      (kb > k_lo || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      fence_regs(acc);
      // the previous slab's products are done: hand its stage back
      wgmma_wait<1>();
      if (prev >= 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0) mbar_arrive(empty + 8 * prev);
    // segments are added in order, p_0 first: ((p_0 + p_1) + p_2) ...
#pragma unroll
    for (int i = 0; i < NREG; ++i)
      total[i] = seg == seg_lo ? acc[i] : __fadd_rn(total[i], acc[i]);
  }

  // accumulator fragment: value 4c + r of thread (warp w, lane l) is weight
  // column w*16 + l/4 (+8 for r >= 2) and x row 8c + 2(l%4) (+1 for odd r)
  const int warp = tid / 32, lane = tid % 32;
  const int n_base = n0 + warp * 16 + (lane >> 2);
  const int m_base = m0 + 2 * (lane & 3);
  if (!split) {
#pragma unroll
    for (int c = 0; c < NT / 8; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = n_base + (r >> 1) * 8, m = m_base + 8 * c + (r & 1);
        if (m < M && n < N)
          out[(long long)m * som + n] = __float2bfloat16_rn(total[4 * c + r]);
      }
    return;
  }
  float* part = ws + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int c = 0; c < NT / 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n_base + (r >> 1) * 8, m = m_base + 8 * c + (r & 1);
      if (m < M && n < N) part[(long long)m * N + n] = total[4 * c + r];
    }
  __threadfence();
  bar_consumers();
  if (tid == 0) {
    int* cnt = counters + blockIdx.y;
    const int last = atomicAdd(cnt, 1) == segments - 1;
    if (last) *cnt = 0;  // ready for the next launch
    *last_flag = last;
  }
  bar_consumers();
  if (!*last_flag) return;
  __threadfence();
  // the last block of the tile adds the S partials in segment order
  const int rows = min(NT, M - m0);
  for (int i = tid; i < rows * BN; i += CONSUMERS) {
    const int m = m0 + i / BN, n = n0 + i % BN;
    if (n >= N) continue;
    const float* p = ws + (long long)m * N + n;
    float s = __ldcg(p);
    for (int seg = 1; seg < segments; ++seg)
      s = __fadd_rn(s, __ldcg(p + (long long)seg * M * N));
    out[(long long)m * som + n] = __float2bfloat16_rn(s);
  }
}

// a bf16 (outer, inner) map with row stride ``stride`` bytes and boxes of
// (box_outer, 64): 128 bytes of the inner dimension, swizzled; out-of-range
// elements read as zero
bool map_2d(CUtensorMap* out, const void* ptr, uint64_t inner, uint64_t outer,
            uint64_t stride, uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint32_t box[2] = {static_cast<uint32_t>(BK), box_outer};
  return tensor_map(out, ptr, 2, dims, &stride, box);
}

template <int NT, bool W_KMAJOR>
cudaError_t launch_kernel(const CUtensorMap& mw, const CUtensorMap& mx,
                          void* out, void* ws, void* counters, int M, int N,
                          int slabs, int segments, long long som, bool split,
                          cudaStream_t stream) {
  constexpr uint32_t smem = smem_bytes<NT>();
  // the opt-in above 48 KB of shared memory, once per device
  static bool ready[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(wgmma_matmul_kernel<NT, W_KMAJOR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const dim3 grid((M + NT - 1) / NT, (N + BN - 1) / BN, split ? segments : 1);
  wgmma_matmul_kernel<NT, W_KMAJOR><<<grid, THREADS, smem, stream>>>(
      mw, mx, static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), M, N, slabs, segments, som, split ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, long long sxm, long long swk, long long swn,
                   long long som, void* ws, void* counters, int segments,
                   int nt, cudaStream_t stream) {
  refusal() = "";
  // TMA's rules: 16-byte aligned bases, row strides in multiples of 16 bytes
  // (row-major (K,N) weights are read n-fastest, a K-contiguous view k-fastest)
  const bool w_kmajor = swn != 1;
  const long long w_row = w_kmajor ? swn : swk;
  if ((w_kmajor && swk != 1) || w_row < (w_kmajor ? K : N) || sxm < K)
    return refuse("w is neither row-major nor K-contiguous, or x overlaps");
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 ||
      (sxm * 2) % 16 || (w_row * 2) % 16)
    return refuse("TMA needs 16-byte aligned bases and row strides");
  const int slabs = (K + BK - 1) / BK;
  if (segments <= 0 || segments > slabs)
    return refuse("segments must number 1 to the slabs of K");
  // split: each segment its own block, over a single x tile of nt rows
  const bool split = ws != nullptr;
  if ((nt != 64 && nt != 128) || (split && (counters == nullptr || M > nt)))
    return refuse("x tile rows must be 64 or 128, a split one tile");
  const bool small = nt == 64;
  // boxes of 64 elements inner (128 bytes) by: nt x rows; 64 weight
  // columns of a K-contiguous view; 64 k of a row-major weight
  Map mx, mw;
  if (encoder() == nullptr)
    return refuse("cuTensorMapEncodeTiled not found in the driver");
  if (!map_2d(&mx.m, x, K, M, sxm * 2, nt))
    return refuse("cuTensorMapEncodeTiled refused x");
  if (!(w_kmajor ? map_2d(&mw.m, w, K, N, w_row * 2, BN)
                 : map_2d(&mw.m, w, N, K, w_row * 2, BK)))
    return refuse("cuTensorMapEncodeTiled refused w");
  if (small)
    return w_kmajor
               ? launch_kernel<64, true>(mw.m, mx.m, out, ws, counters, M, N,
                                         slabs, segments, som, split,
                                         stream)
               : launch_kernel<64, false>(mw.m, mx.m, out, ws, counters, M, N,
                                          slabs, segments, som, split,
                                          stream);
  return w_kmajor
             ? launch_kernel<128, true>(mw.m, mx.m, out, ws, counters, M, N,
                                        slabs, segments, som, split,
                                        stream)
             : launch_kernel<128, false>(mw.m, mx.m, out, ws, counters, M, N,
                                         slabs, segments, som, split,
                                         stream);
}

}  // namespace tc

extern "C" int repro_matmul(const void* x, const void* w, void* out, int M,
                            int N, int K, long long sxm, long long swk,
                            long long swn, long long som, int dtype, void* ws,
                            void* counters, int segments, int nt,
                            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      if ((M + cuda_core::BM - 1) / cuda_core::BM > 65535)
        return cudaErrorInvalidValue;
      return cuda_core::launch<float>(x, w, out, M, N, K, sxm, swk, swn, som,
                                      s);
    case repro::kBFloat16:
      if ((N + tc::BN - 1) / tc::BN > 65535) return cudaErrorInvalidValue;
      return tc::launch(x, w, out, M, N, K, sxm, swk, swn, som, ws, counters,
                        segments, nt, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// why the last call of a tensor-core route (K1, K2 or K3 in bf16) returned
// cudaErrorInvalidValue ("" otherwise)
extern "C" const char* repro_refusal() { return hopper::refusal(); }

// dynamic shared memory of the bf16 kernel for x tiles of nt rows (64, 128)
extern "C" int repro_matmul_smem_bytes(int nt) {
  return nt == 64 ? static_cast<int>(tc::smem_bytes<64>())
                  : static_cast<int>(tc::smem_bytes<128>());
}
