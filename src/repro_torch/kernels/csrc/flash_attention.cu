// K1: flash attention with online softmax, causal and sliding-window masks
// and grouped-query heads, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (_kernel) and computes what repro/kernels/ref.py:flash_attention defines:
// q (BH,Sq,D), k and v (BHk,Sk,D), out (BH,Sq,D) in q's dtype.  Queries are
// right-aligned against the keys (query i sits at absolute position
// Sk - Sq + i), so one kernel serves a full prefill and a chunk against a
// longer cache.  GQA goes by index, as the Pallas index_map does: query row
// bh reads K/V row bh / G with G = BH / BHk, and K/V are never repeated.
//
// Design: one block of 8 warps owns one (bh, 16-query tile); each warp owns
// two query rows.  The block walks the K/V tiles (32 keys each) that its
// queries can see, staged in shared memory as fp32; tiles fully masked by
// causality or the window are never loaded.  For each row, lane j scores
// key j of the tile (a D-long dot product against the shared query row),
// the tile's max and sum come from fixed butterfly shuffles, and the fp32
// running max, denominator and accumulator (each lane owns D/32 output
// columns) are rescaled once per tile, as in the Pallas kernel.  As there,
// p is rounded to v's dtype before the p.v product.  Ragged Sq and Sk are
// masked here (the Pallas kernel asserts divisibility): keys past Sk get
// probability 0, rows past Sq are computed but never stored.
//
// Shared memory: the three fp32 tiles take 4 * (BQ*D + BK*(D+1) + BK*D)
// bytes, 82,048 at D = 256 (recurrentgemma's heads), over the 48 KB a
// static array may hold, so they are one dynamic buffer and the launch
// opts in to more (cudaFuncAttributeMaxDynamicSharedMemorySize) where a
// head dim needs it.  At D = 256 each thread stages 32 keys and 32 values
// in registers beside 16 accumulators.
//
// What bounds it on the serving path: prefill of qwen3-0.6b at S = 256 (16
// query heads, 8 KV heads, D = 128, causal) is ~0.27 GFLOP over ~3.1 MB,
// ~1 us at 3.35 TB/s, so launch latency dominates the bound.  The scores
// and the p.v sum run on CUDA cores in fp32, one key per lane, and a call
// takes ~64 us on the H100 (PERF.md); mma/wgmma tiles are later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 16;
constexpr int BK = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;
constexpr float NEG_INF = -1e30f;  // masked score, as in the reference
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Sk, int G, int causal, int window,
                           float scale) {
  constexpr int ACC = (D + 31) / 32;
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][D]
  float* ks = qs + BQ * D;        // [BK][D + 1]: +1, lane j reads row j
                                  // conflict-free
  float* vs = ks + BK * (D + 1);  // [BK][D]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = Sk - Sq;
  const T* qb = q + (long long)bh * Sq * D;
  const T* kb = k + (long long)(bh / G) * Sk * D;
  const T* vb = v + (long long)(bh / G) * Sk * D;

  static_assert((BQ * D) % THREADS == 0 && (BK * D) % THREADS == 0,
                "tiles split evenly over the block");
  constexpr int Q_PT = BQ * D / THREADS;
  constexpr int KV_PT = BK * D / THREADS;
#pragma unroll
  for (int t = 0; t < Q_PT; ++t) {
    const int i = threadIdx.x + t * THREADS;
    const int r = i / D, c = i % D;
    qs[r * D + c] = (q0 + r < Sq)
                        ? repro::to_f32(qb[(long long)(q0 + r) * D + c])
                        : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][ACC];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int a = 0; a < ACC; ++a) acc[rr][a] = 0.f;
  }

  // keys any query of this tile can see (absolute positions)
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_hi + 1);
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / BK) * BK;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // all of a tile's loads issue before the first store (compile-time
    // trip count), then land in shared memory
    float kr[KV_PT], vr[KV_PT];
#pragma unroll
    for (int t = 0; t < KV_PT; ++t) {
      const int i = threadIdx.x + t * THREADS;
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      const long long off = (long long)(k0 + r) * D + c;
      kr[t] = in ? repro::to_f32(kb[off]) : 0.f;
      vr[t] = in ? repro::to_f32(vb[off]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < KV_PT; ++t) {
      const int i = threadIdx.x + t * THREADS;
      ks[(i / D) * (D + 1) + i % D] = kr[t];
      vs[i] = vr[t];
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
      const int qpos = q_offset + q0 + r;
      const int kpos = k0 + lane;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d)
        s = fmaf(qs[r * D + d], ks[lane * (D + 1) + d], s);
      s *= scale;
      bool valid = true;
      if (causal) valid = valid && qpos >= kpos;
      if (window > 0) valid = valid && (qpos - kpos) < window;
      s = (kpos >= Sk) ? -INFINITY : (valid ? s : NEG_INF);
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      const float pr = repro::round_through<T>(p);
#pragma unroll
      for (int a = 0; a < ACC; ++a) acc[rr][a] *= alpha;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(FULL, pr, j);
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const int d = lane + 32 * a;
          if (d < D) acc[rr][a] = fmaf(pj, vs[j * D + d], acc[rr][a]);
        }
      }
      m[rr] = m_new;
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    T* ob = out + ((long long)bh * Sq + q0 + r) * D;
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int d = lane + 32 * a;
      if (d < D) ob[d] = repro::from_f32<T>(acc[rr][a] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int BH, int BHk, int Sq, int Sk, int causal, int window,
                     cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D);
  static_assert(smem <= 232448, "tiles fit one block's shared memory");
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, BH / BHk,
      causal, window, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int BHk, int Sq, int Sk, int D, int causal,
                   int window, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, stream);
    case 256:
      return launch_d<T, 256>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int BH,
                                     int BHk, int Sq, int Sk, int D,
                                     int causal, int window, int dtype,
                                     void* stream) {
  if (BH <= 0 || BHk <= 0 || BH % BHk != 0 || BH > 65535 || Sq <= 0 ||
      Sk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(q, k, v, out, BH, BHk, Sq, Sk, D, causal, window, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, out, BH, BHk, Sq, Sk, D, causal,
                                   window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
