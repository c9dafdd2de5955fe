// K3: grouped expert SwiGLU FFN of the MoE layer for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/moe_dispatch.py:moe_ffn
// (_kernel) and computes what it computes: for every expert e and buffer
// row c, out[e,c] = (silu(buf[e,c] @ w1[e]) * (buf[e,c] @ w3[e])) @ w2[e],
// with buf (E,C,d), w1 and w3 (E,d,f), w2 (E,f,d) and out (E,C,d) in buf's
// dtype.  As there, both products accumulate in fp32, silu and the product
// are taken in fp32, the hidden is rounded to the input dtype before the w2
// product, and the hidden never goes to device memory.
//
// Design: one block of 256 threads owns one (expert, tile of R rows).
// Phase 1 computes the tile's whole (R x f) hidden into shared memory
// (fp32 values already rounded through the input dtype):
// each thread owns V neighbouring f columns and walks d in steps of 32,
// the x tile staged in shared memory as fp32 and the w1/w3 rows read
// straight from device memory (neighbouring threads on neighbouring
// columns, V at a time).  Phase 2 walks d in the same way, each thread
// owning V output columns and summing over the whole hidden.  Ragged C, d
// and f are masked here (the Pallas kernel asserts C % block_c == 0).
// With per-expert row counts (optional), rows past an expert's count are
// written as zeros, and a tile with no live row reads no weights.
//
// Fixed order: every output element sums its d products, and then its f
// products, one fused multiply-add at a time in ascending index, whatever
// C, R or the row's place in the buffer.  There is no split of d or f
// across blocks and no atomic, so a token's expert output is the same bits
// whoever shares the buffer with it; the serving engine's batch-4 streams
// equal its batch-1 reference because of this.
//
// What bounds it on the serving path (H100 SXM, 3.35 TB/s, 989 TFLOP/s
// bf16): olmoe-1b-7b has 64 experts of d 2048, f 1024 in bf16, 12.6 MB of
// weights each, 805 MB per layer if every expert is read.  At decode
// (batch 4, top-8, C = 4) a layer does ~0.4 GFLOP over those bytes: the
// bound is bytes, ~0.24 ms per layer, and at most 32 experts have a row,
// so reading only those halves it.  The counts do that: empty experts cost
// one block that writes zeros.  At one admission (S = 256, C = 40) up to
// every expert is live and a layer is at most ~32 GFLOP, still under the
// ridge of the tensor cores.  This first version multiplies on CUDA cores
// with R = 4 rows at decode (each thread loading 4 columns at once) and
// R = 16 at prefill, and one SM streams each expert alone: on the H100 a
// decode call takes ~0.6 ms against a ~0.09 ms bound (PERF.md).  wgmma
// tiles, TMA and spreading one expert over several SMs are later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
