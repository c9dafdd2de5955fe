// K3: grouped expert SwiGLU FFN of the MoE layer for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/moe_dispatch.py:moe_ffn
// (_kernel) and computes what it computes: for every expert e and buffer
// row c, out[e,c] = (silu(buf[e,c] @ w1[e]) * (buf[e,c] @ w3[e])) @ w2[e],
// with buf (E,C,d), w1 and w3 (E,d,f), w2 (E,f,d) and out (E,C,d) in buf's
// dtype.  As there, both products accumulate in fp32, silu and the product
// are taken in fp32, and the hidden is rounded to the input dtype before
// the w2 product.  With per-expert row counts (optional), rows past an
// expert's count are written as zeros and a tile with no live row reads no
// weights.  Two routes, chosen by the wrapper before launch
// (kernels/moe_dispatch.py:route):
//
// bf16 with d and f multiples of 64 (every olmoe-1b-7b and qwen3-moe-30b-a3b
//   call): wgmma fed by TMA, in two launches on one stream.
//   What bounds it (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): olmoe-1b-7b has
//   64 experts of d 2048, f 1024, 12.6 MB of weights each.  A decode call
//   (batch 4, top-8, C = 4) reads the ~25 live experts' weights, ~313 MB,
//   0.094 ms at 3.35 TB/s, and does ~0.4 GFLOP; an admission call (C = 40,
//   ~33 live experts) ~420 MB, 0.131 ms, and ~16 GFLOP.  Both are bound by
//   bytes: the kernel must keep every SM streaming weights.
//   Design: the weights are wgmma's A operand (64 weight columns, the
//   instruction's m64; row-major (d,f) and (f,d) stacks are MN-major) and
//   the expert's token rows its n ("swap AB", as K2), so C = 4 rows take an
//   n8 instruction instead of a 64-row tile of zeros.  Pass A, grid (f/64,
//   E, row tiles): a block streams a 64-column slab of w1[e] and of w3[e]
//   over all of d through a TMA ring (3-D tensor maps, so a box never
//   crosses an expert and rows past C read as zero), two fp32 accumulators,
//   and writes h = bf16(silu(g) * u) to an (E, C, f) scratch (0.5 MB at
//   decode, 5.2 MB at admission: it stays in L2).  Pass B, grid (d/64, E,
//   row tiles): a 64-column slab of w2[e] over all of f against h's rows,
//   one fp32 accumulator, bf16 out, zeros past counts[e].  Each live expert
//   is spread over f/64 + d/64 = 48 blocks; at decode ~25 live experts give
//   ~1,200 blocks of weight streams for 132 SMs, where one block per expert
//   used to stream 12.6 MB alone.  A producer warp keeps 4 (pass A) or 6
//   (pass B) slabs in flight; one consumer warpgroup runs the k16 steps;
//   the epilogue goes through shared memory so rows leave in 16-byte
//   stores.  A block whose expert or row tile has no live row exits before
//   touching the weights (pass B writes its zeros).
//   Token rows a block: NT = 8, 16, 32, 48 or 64, the least that holds C,
//   64 above (kernels/moe_dispatch.py:tile_rows): a function of C alone.
//
// fp32, and shapes the wgmma route does not take: CUDA cores, the first
//   kernel, unchanged.  One block of 256 threads owns one (expert, tile of
//   R rows), computes the tile's whole (R x f) hidden into shared memory
//   and then its output; d, f and C are masked where ragged.  One SM
//   streams each expert alone (0.6 ms per olmoe decode call on the H100,
//   PERF.md).
//
// Fixed order, both routes: every output element sums its d products and
// then its f products in ascending order inside one block, whatever C or
// the row's place in the buffer.  There is no split of d or f across blocks
// and no atomic.  On the wgmma route the tensor cores compute each output
// element from its own row and column, and the instruction (its n) depends
// on C alone, so a token's expert output has the same bits whoever shares
// the buffer with it; at decode the engine's batch-4 and batch-1 runs both
// have C = 4 (models/moe.py floors capacity at 4).  The serving engine's
// batch-4 streams equal its batch-1 reference because of this.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 32;                  // d step of phase 1
constexpr size_t kMaxSmem = 232448;     // dynamic shared memory per block

// V neighbouring elements of a row as fp32; p is aligned to V elements
// whenever V > 1 (the launcher checks).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[V]) {
  if constexpr (V == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (V == 4 && sizeof(T) == 2) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = repro::to_f32(p[v]);
  }
}

// One d index of phase 1: g += x * w1 row, u += x * w3 row, for R rows
// and V columns, one fused multiply-add each.
template <typename T, int R, int V>
__device__ __forceinline__ void gate_up_step(const T* __restrict__ w1row,
                                             const T* __restrict__ w3row,
                                             const float* x, float (&g)[R][V],
                                             float (&u)[R][V]) {
  float a[V], b[V];
  load_vec<T, V>(w1row, a);
  load_vec<T, V>(w3row, b);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float xr = x[r];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      g[r][v] = fmaf(xr, a[v], g[r][v]);
      u[r][v] = fmaf(xr, b[v], u[r][v]);
    }
  }
}

template <typename T, int R, int V>
__global__ void __launch_bounds__(THREADS)
    moe_ffn_kernel(const T* __restrict__ buf, const T* __restrict__ w1,
                   const T* __restrict__ w3, const T* __restrict__ w2,
                   const int* __restrict__ counts, T* __restrict__ out, int C,
                   int D, int F) {
  extern __shared__ float smem[];
  float* xs = smem;           // [BK][R] x tile, k-major
  float* hs = smem + BK * R;  // [F][R] hidden, rounded through T
  const int e = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int tile_rows = min(R, C - r0);
  const int live = counts ? max(0, min(C, counts[e])) : C;
  const int rows = max(0, min(tile_rows, live - r0));
  const long long row0 = (long long)e * C + r0;
  const T* xb = buf + row0 * D;
  T* ob = out + row0 * D;
  const T zero = repro::from_f32<T>(0.f);

  if (rows == 0) {  // an empty tile reads no weights
    for (long long i = tid; i < (long long)tile_rows * D; i += THREADS)
      ob[i] = zero;
    return;
  }
  const T* w1e = w1 + (long long)e * D * F;
  const T* w3e = w3 + (long long)e * D * F;
  const T* w2e = w2 + (long long)e * F * D;

  // phase 1: hidden = silu(x @ w1) * (x @ w3), into shared memory
  for (int f0 = 0; f0 < F; f0 += THREADS * V) {
    const int col = f0 + tid * V;  // V > 1 only when F % V == 0
    const bool active = col < F;
    float g[R][V], u[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) g[r][v] = u[r][v] = 0.f;
    for (int k0 = 0; k0 < D; k0 += BK) {
      const int kn = min(BK, D - k0);
      __syncthreads();  // the previous x tile is consumed
      for (int i = tid; i < BK * R; i += THREADS) {
        const int r = i / BK, kk = i % BK;
        xs[kk * R + r] = (r < rows && kk < kn)
                             ? repro::to_f32(xb[(long long)r * D + k0 + kk])
                             : 0.f;
      }
      __syncthreads();
      if (!active) continue;
      const T* a = w1e + (long long)k0 * F + col;
      const T* b = w3e + (long long)k0 * F + col;
      if (kn == BK) {
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk)
          gate_up_step<T, R, V>(a + (long long)kk * F, b + (long long)kk * F,
                                xs + kk * R, g, u);
      } else {
        for (int kk = 0; kk < kn; ++kk)
          gate_up_step<T, R, V>(a + (long long)kk * F, b + (long long)kk * F,
                                xs + kk * R, g, u);
      }
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float gv = g[r][v];
          hs[(col + v) * R + r] =
              repro::round_through<T>(gv / (1.f + expf(-gv)) * u[r][v]);
        }
    }
  }
  __syncthreads();

  // phase 2: out = hidden @ w2, the hidden read from shared memory
  for (int d0 = 0; d0 < D; d0 += THREADS * V) {
    const int col = d0 + tid * V;  // V > 1 only when D % V == 0
    if (col >= D) continue;
    float acc[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
#pragma unroll 4
    for (int j = 0; j < F; ++j) {
      float w[V];
      load_vec<T, V>(w2e + (long long)j * D + col, w);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float h = hs[j * R + r];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(h, w[v], acc[r][v]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= tile_rows) break;
#pragma unroll
      for (int v = 0; v < V; ++v)
        ob[(long long)r * D + col + v] =
            r < rows ? repro::from_f32<T>(acc[r][v]) : zero;
    }
  }
}

template <typename T, int R, int V>
cudaError_t launch_tile(const void* buf, const void* w1, const void* w3,
                        const void* w2, const int* counts, void* out, int E,
                        int C, int D, int F, cudaStream_t stream) {
  const size_t smem = (size_t)(BK + F) * R * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = moe_ffn_kernel<T, R, V>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + R - 1) / R, E);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(w1),
      static_cast<const T*>(w3), static_cast<const T*>(w2), counts,
      static_cast<T*>(out), C, D, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* buf, const void* w1, const void* w3,
                   const void* w2, const int* counts, void* out, int E, int C,
                   int D, int F, cudaStream_t stream) {
  if (C > 4)
    return launch_tile<T, 16, 1>(buf, w1, w3, w2, counts, out, E, C, D, F,
                                 stream);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(w1) |
                         reinterpret_cast<uintptr_t>(w3) |
                         reinterpret_cast<uintptr_t>(w2);
  if (F % 4 == 0 && D % 4 == 0 && ptrs % (4 * sizeof(T)) == 0)
    return launch_tile<T, 4, 4>(buf, w1, w3, w2, counts, out, E, C, D, F,
                                stream);
  return launch_tile<T, 4, 1>(buf, w1, w3, w2, counts, out, E, C, D, F,
                              stream);
}

}  // namespace

namespace moe_tc {

using namespace hopper;

constexpr int BT = 64;                     // weight columns a block: wgmma's m
constexpr int BK = 64;                     // k per slab: 128 bytes of bf16
constexpr int CONSUMERS = 128;             // one warpgroup
constexpr int THREADS = CONSUMERS + 32;    // + one producer warp
constexpr uint32_t W_BYTES = BT * BK * 2;  // one weight slab, 8 KB
constexpr int STG = BT + 8;                // staging row, padded: 144 bytes

// slabs in flight: gate/up stages carry two weight slabs (16 KB), down
// stages one (8 KB); with the token rows that is ~70-100 KB of ring either
// way, two or three blocks an SM, ~200 KB of weights in flight per SM
template <bool GATE_UP>
__host__ __device__ constexpr int stages() {
  return GATE_UP ? 4 : 6;
}

template <bool GATE_UP, int NT>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (GATE_UP ? 2 : 1) * W_BYTES + NT * BK * 2;
}

template <bool GATE_UP, int NT>
__host__ __device__ constexpr uint32_t smem_bytes() {
  // the ring, the bf16 staging tile of the epilogue, full and empty
  // barriers, and room to align the ring to 1024 bytes (the swizzle atom)
  return stages<GATE_UP>() * stage_bytes<GATE_UP, NT>() + NT * STG * 2 +
         16 * stages<GATE_UP>() + 1024;
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) = (64 output columns, expert,
// NT token rows).  GATE_UP: h[e, rows, cols] = bf16(silu(x w1) * (x w3)),
// the products over d (slabs = d / 64), w1 and w3 read through map_wa and
// map_wb, the rows of buf through map_x, out = h (n_out = f).  Else:
// out[e, rows, cols] = bf16(h w2) over f (slabs = f / 64), w2 through
// map_wa, the rows of h through map_x, zeros for rows at or past counts[e].
template <bool GATE_UP, int NT>
__global__ void __launch_bounds__(THREADS)
    moe_ffn_kernel_wgmma(const __grid_constant__ CUtensorMap map_wa,
                         const __grid_constant__ CUtensorMap map_wb,
                         const __grid_constant__ CUtensorMap map_x,
                         const int* __restrict__ counts,
                         __nv_bfloat16* __restrict__ out, int C, int n_out,
                         int slabs) {
  constexpr int STAGES = stages<GATE_UP>();
  constexpr int NW = GATE_UP ? 2 : 1;
  constexpr uint32_t STAGE = stage_bytes<GATE_UP, NT>();
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BT;
  const int e = blockIdx.y;
  const int r0 = blockIdx.z * NT;
  const int rows = min(NT, C - r0);
  const int live = counts ? max(0, min(C, counts[e])) : C;
  const int live_rows = max(0, min(rows, live - r0));
  __nv_bfloat16* ob = out + ((long long)e * C + r0) * n_out + n0;
  if (live_rows == 0) {
    // an empty tile reads no weights; its output rows are zeros (its
    // hidden rows are never read)
    if constexpr (!GATE_UP)
      for (int i = tid; i < rows * 8; i += THREADS)
        reinterpret_cast<uint4*>(ob + (long long)(i / 8) * n_out)[i % 8] =
            make_uint4(0, 0, 0, 0);
    return;
  }

  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t stg = ring + STAGES * STAGE;
  const uint32_t full = stg + NT * STG * 2;  // STAGES x 8 bytes
  const uint32_t empty = full + 8 * STAGES;  // STAGES x 8 bytes
  __nv_bfloat16* stg_p =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (stg - raw));

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
      for (int kb = 0; kb < slabs; ++kb) {
        const uint32_t st = ring + stage * STAGE;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, STAGE);
        tma_load(st, &map_wa, n0, kb * BK, e, full + 8 * stage);
        if constexpr (GATE_UP)
          tma_load(st + W_BYTES, &map_wb, n0, kb * BK, e, full + 8 * stage);
        tma_load(st + NW * W_BYTES, &map_x, kb * BK, r0, e, full + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: one warpgroup, D (64 weight columns x NT token rows) in
  // fp32, summed over k in ascending k16 steps
  float acc[NW][NT / 2];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[w][i] = 0.f;
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int kb = 0; kb < slabs; ++kb) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t st = ring + stage * STAGE;
#pragma unroll
    for (int w = 0; w < NW; ++w) fence_regs(acc[w]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the row-major weight slab is MN-major: a k16 step is two 8-row
      // groups of k (2048 bytes); the token rows are K-major: 32 bytes
      // along their swizzled rows
      const uint64_t db = desc(st + NW * W_BYTES + 32 * kk, 16, 1024);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        wgmma_ss<NT, 1>(acc[w],
                        desc(st + w * W_BYTES + 2048 * kk, 1024, 1024), db,
                        (kb > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
#pragma unroll
    for (int w = 0; w < NW; ++w) fence_regs(acc[w]);
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
#pragma unroll
  for (int w = 0; w < NW; ++w) fence_regs(acc[w]);

  // epilogue through shared memory, so each row leaves in 16-byte stores:
  // value 4c + r of thread (warp, lane) is weight column warp*16 + lane/4
  // (+8 for r >= 2) and token row 8c + 2(lane%4) (+1 for odd r)
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int c = 0; c < NT / 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = warp * 16 + (lane >> 2) + 8 * (r >> 1);
      const int row = 8 * c + 2 * (lane & 3) + (r & 1);
      float v;
      if constexpr (GATE_UP) {
        // silu and the product in fp32, as the reference
        const float g = acc[0][4 * c + r];
        v = g / (1.f + expf(-g)) * acc[1][4 * c + r];
      } else {
        v = row < live_rows ? acc[0][4 * c + r] : 0.f;
      }
      stg_p[row * STG + col] = __float2bfloat16_rn(v);
    }
  bar_consumers();
  for (int i = tid; i < rows * 8; i += CONSUMERS)
    reinterpret_cast<uint4*>(ob + (long long)(i / 8) * n_out)[i % 8] =
        reinterpret_cast<const uint4*>(stg_p + (i / 8) * STG)[i % 8];
}

template <bool GATE_UP, int NT>
cudaError_t launch_pass(const CUtensorMap& wa, const CUtensorMap& wb,
                        const CUtensorMap& x, const int* counts, void* out,
                        int E, int C, int n_out, int slabs,
                        cudaStream_t stream) {
  constexpr uint32_t smem = smem_bytes<GATE_UP, NT>();
  static_assert(smem <= 232448, "ring fits one block's shared memory");
  static bool ready[64] = {};
  const cudaError_t err = opt_in_smem(
      (const void*)moe_ffn_kernel_wgmma<GATE_UP, NT>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_out / BT, E, (C + NT - 1) / NT);
  moe_ffn_kernel_wgmma<GATE_UP, NT><<<grid, THREADS, smem, stream>>>(
      wa, wb, x, counts, static_cast<__nv_bfloat16*>(out), C, n_out, slabs);
  return cudaGetLastError();
}

// pass A (gate/up) into h, then pass B (down) into out, on one stream
template <int NT>
cudaError_t launch(const void* buf, const void* w1, const void* w3,
                   const void* w2, const int* counts, void* h, void* out,
                   int E, int C, int D, int F, cudaStream_t stream) {
  Map m1, m3, m2, mx, mh;
  if (encoder() == nullptr)
    return refuse("cuTensorMapEncodeTiled not found in the driver");
  if (!map_stack(&m1.m, w1, E, D, F, BK) ||
      !map_stack(&m3.m, w3, E, D, F, BK) ||
      !map_stack(&m2.m, w2, E, F, D, BK) ||
      !map_stack(&mx.m, buf, E, C, D, NT) ||
      !map_stack(&mh.m, h, E, C, F, NT))
    return refuse("cuTensorMapEncodeTiled refused an operand");
  const cudaError_t err = launch_pass<true, NT>(m1.m, m3.m, mx.m, counts, h,
                                                E, C, F, D / BK, stream);
  if (err != cudaSuccess) return err;
  return launch_pass<false, NT>(m2.m, m2.m, mh.m, counts, out, E, C, D,
                                F / BK, stream);
}

}  // namespace moe_tc

// counts: (E,) int32 live rows per expert, or null (every row is live).
extern "C" int repro_moe_ffn(const void* buf, const void* w1, const void* w3,
                             const void* w2, const void* counts, void* out,
                             int E, int C, int D, int F, int dtype,
                             void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* n = static_cast<const int*>(counts);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(buf, w1, w3, w2, n, out, E, C, D, F, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(buf, w1, w3, w2, n, out, E, C, D, F, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// the bf16 wgmma route (kernels/moe_dispatch.py:route): d and f multiples
// of 64, 16-byte aligned operands, h an (E, C, f) bf16 scratch; nt, the
// token rows a block (8, 16, 32, 48 or 64), is kernels/moe_dispatch.py:
// tile_rows(C).  Two launches on ``stream``.
extern "C" int repro_moe_ffn_wgmma(const void* buf, const void* w1,
                                   const void* w3, const void* w2,
                                   const void* counts, void* h, void* out,
                                   int E, int C, int D, int F, int nt,
                                   void* stream) {
  hopper::refusal() = "";
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0 || D % 64 ||
      F % 64 || (C + nt - 1) / nt > 65535)
    return hopper::refuse("shapes: 0 < E <= 65535, C > 0, d and f "
                          "multiples of 64");
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(buf) | reinterpret_cast<uintptr_t>(w1) |
      reinterpret_cast<uintptr_t>(w3) | reinterpret_cast<uintptr_t>(w2) |
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  if (ptrs % 16)
    return hopper::refuse("TMA and the 16-byte stores need 16-byte aligned "
                          "operands");
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* n = static_cast<const int*>(counts);
  switch (nt) {
    case 8:
      return moe_tc::launch<8>(buf, w1, w3, w2, n, h, out, E, C, D, F, s);
    case 16:
      return moe_tc::launch<16>(buf, w1, w3, w2, n, h, out, E, C, D, F, s);
    case 32:
      return moe_tc::launch<32>(buf, w1, w3, w2, n, h, out, E, C, D, F, s);
    case 48:
      return moe_tc::launch<48>(buf, w1, w3, w2, n, h, out, E, C, D, F, s);
    case 64:
      return moe_tc::launch<64>(buf, w1, w3, w2, n, h, out, E, C, D, F, s);
    default:
      return hopper::refuse("token rows a block must be 8, 16, 32, 48 or 64");
  }
}


// dynamic shared memory of a wgmma-route block: gate_up 1 (pass A) or 0
// (pass B), nt token rows (0 for another nt)
extern "C" int repro_moe_ffn_wgmma_smem(int gate_up, int nt) {
  using namespace moe_tc;
  switch (nt) {
    case 8:
      return gate_up ? smem_bytes<true, 8>() : smem_bytes<false, 8>();
    case 16:
      return gate_up ? smem_bytes<true, 16>() : smem_bytes<false, 16>();
    case 32:
      return gate_up ? smem_bytes<true, 32>() : smem_bytes<false, 32>();
    case 48:
      return gate_up ? smem_bytes<true, 48>() : smem_bytes<false, 48>();
    case 64:
      return gate_up ? smem_bytes<true, 64>() : smem_bytes<false, 64>();
    default:
      return 0;
  }
}
