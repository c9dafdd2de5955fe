// K1's backward: the gradients of flash attention with respect to q, k and
// v, for Hopper (sm_90a), on the CUDA cores.
//
// The Pallas kernel repro/kernels/flash_attention.py:flash_attention has no
// backward of its own; the reference trains through its plain attention.
// The port's training forward runs K1, so its gradient needs a kernel too.
// It computes what kernels/flash_attention.py:flash_attention_bwd_ref
// defines in closed form: with P the forward's softmax (recomputed here),
//   dV = P^T dO,  dS = P * (dO V^T - rowsum(dO * O)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// dK and dV summed over the G query heads of each KV head.  Layouts are
// the forward's: q, out, dout (BH,Sq,D); k, v (BHk,Sk,D) with G = BH / BHk,
// query row bh reading KV row bh / G; queries right-aligned against the
// keys; the causal and window masks are the forward's (q_pos >= k_pos,
// q_pos - k_pos < window).  Inputs f32 or bf16, computed in fp32, the
// gradients stored in the inputs' dtype.
//
// Three launches, no atomics, every output written once by one block, so
// two runs give the same bits:
//   1. stats: one block per (bh, 32-query tile) walks the key tiles its
//      queries see and keeps the rows' running max and sum; it stores the
//      log-sum-exp L and D = rowsum(dO * O) in fp32 (BH, Sq) scratch;
//   2. dK, dV: one block per (bhk, 32-key tile) holds K and V, then walks
//      the G query heads of the group and, for each, the query tiles that
//      see the keys: it recomputes P = exp(S * scale - L) and dS and
//      accumulates dV += P^T dO and dK += dS^T Q in registers;
//   3. dQ: one block per (bh, 32-query tile) walks its key tiles again and
//      accumulates dQ += dS K.
// Tiles that causality or the window mask whole are never visited.  Each
// tile lives in shared memory as fp32 rows padded to D + 1 columns, so the
// lanes of a warp read different banks.  A block has 256 threads; eight
// consecutive lanes share one row of a 32 x 32 score tile (four columns
// each, reduced by shuffles inside the eight), and the same eight own
// every eighth column of a D-wide accumulator row.  Pass 2 holds four
// tiles and two 32 x 33 score tiles: 140,288 bytes at D = 256, which the
// launch opts in to (over the 48 KB default).
//
// What bounds it (H100 SXM, fp32 CUDA cores at 67 TFLOP/s): at qwen3's
// training shape (B 4, S 1024, 16 query over 8 KV heads, D 128, causal)
// one call does ~2.2e10 multiply-adds of visible work in its five
// products; every product reads its operands from shared memory, two
// loads a multiply-add in the inner loops, so shared-memory bandwidth, not
// the FMA units, sets the pace of this kernel.  Moving it to wgmma is a
// later step.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace fa_bwd {

constexpr int BQ = 32;          // query rows per tile
constexpr int BK = 32;          // key rows per tile
constexpr int THREADS = 256;
constexpr int LANES = 8;        // threads sharing one row of a score tile
constexpr int COLS = BK / LANES;  // score columns per thread
constexpr int SP = BK + 1;      // padded row of a score tile
constexpr float NEG = -1e30f;   // the running max before any visible key
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS == BQ * LANES && THREADS == BK * LANES,
              "one row of eight lanes per tile row");

template <int D>
__host__ __device__ constexpr int tile_floats() {
  return BQ * (D + 1);
}

template <int D>
__host__ __device__ constexpr size_t stats_smem() {
  return sizeof(float) * 2 * tile_floats<D>();
}

template <int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * tile_floats<D>() + 2 * BQ * SP + 2 * BQ);
}

template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return sizeof(float) * (4 * tile_floats<D>() + BQ * SP + 2 * BQ);
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  v += __shfl_xor_sync(FULL, v, 4);
  return v;
}

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 4));
  return v;
}

// rows [r0, r0 + 32) of a (S, D) matrix into a [32][D + 1] fp32 tile;
// rows past S read as zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        (r0 + r < S) ? repro::to_f32(src[(long long)(r0 + r) * D + c]) : 0.f;
  }
}

// out[c] = a[i] . b[j0 + 8c] over D, for this thread's row i = tid / 8 and
// columns j0 = tid % 8 (+ 8c) of a 32 x 32 tile
template <int D>
__device__ __forceinline__ void row_dots(const float* a, const float* b,
                                         float out[COLS]) {
  const int i = threadIdx.x / LANES, j0 = threadIdx.x % LANES;
#pragma unroll
  for (int c = 0; c < COLS; ++c) out[c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float x = a[i * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      out[c] = fmaf(x, b[(j0 + LANES * c) * (D + 1) + d], out[c]);
  }
}

__device__ __forceinline__ bool visible(int qi, int Sq, int kpos, int Sk,
                                        int q_offset, int causal,
                                        int window) {
  const int qpos = q_offset + qi;
  bool ok = qi < Sq && kpos < Sk;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && (qpos - kpos) < window;
  return ok;
}

// the key tiles [t_begin, t_end) of the query rows [q0, q0 + 32)
__device__ __forceinline__ void key_range(int q0, int Sq, int Sk,
                                          int q_offset, int causal,
                                          int window, int* k_begin,
                                          int* k_end) {
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int b = 0, e = Sk;
  if (causal) e = min(Sk, q_hi + 1);
  if (window > 0) b = max(0, q_lo - window + 1);
  *k_begin = (b / BK) * BK;
  *k_end = e;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    bwd_stats(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta, int Sq,
              int Sk, int G, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + tile_floats<D>();
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int q_offset = Sk - Sq;
  const int row = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const T* qb = q + (long long)bh * Sq * D;
  const T* kb = k + (long long)(bh / G) * Sk * D;

  // D = rowsum(dO * O): each of the row's eight lanes sums every eighth
  // column, then the eight partial sums in a fixed order
  float dsum = 0.f;
  if (q0 + row < Sq) {
    const long long base = ((long long)bh * Sq + q0 + row) * D;
    for (int c = lane; c < D; c += LANES)
      dsum = fmaf(repro::to_f32(dout[base + c]), repro::to_f32(o[base + c]),
                  dsum);
  }
  dsum = group_sum(dsum);

  load_tile<T, D>(qs, qb, q0, Sq);
  int k_begin, k_end;
  key_range(q0, Sq, Sk, q_offset, causal, window, &k_begin, &k_end);
  float m = NEG, l = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(ks, kb, k0, Sk);
    __syncthreads();
    float s[COLS];
    row_dots<D>(qs, ks, s);
    float tmax = NEG;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int kpos = k0 + lane + LANES * c;
      s[c] = visible(q0 + row, Sq, kpos, Sk, q_offset, causal, window)
                 ? s[c] * scale
                 : -INFINITY;
      tmax = fmaxf(tmax, s[c]);
    }
    const float m_new = fmaxf(m, group_max(tmax));
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) psum += expf(s[c] - m_new);
    l = l * expf(m - m_new) + group_sum(psum);
    m = m_new;
  }
  if (lane == 0 && q0 + row < Sq) {
    const long long at = (long long)bh * Sq + q0 + row;
    lse[at] = m + logf(fmaxf(l, 1e-30f));
    delta[at] = dsum;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int G,
             int causal, int window, float scale) {
  constexpr int ACC = D / LANES;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + tile_floats<D>();
  float* qs = vs + tile_floats<D>();
  float* dos = qs + tile_floats<D>();
  float* ps = dos + tile_floats<D>();      // [BQ][SP]: P
  float* dss = ps + BQ * SP;               // [BQ][SP]: dS
  float* ls = dss + BQ * SP;               // [BQ]: L of the tile's rows
  float* ds = ls + BQ;                     // [BQ]: D of the tile's rows
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int q_offset = Sk - Sq;
  const int row = threadIdx.x / LANES, lane = threadIdx.x % LANES;

  load_tile<T, D>(ks, k + (long long)kvh * Sk * D, k0, Sk);
  load_tile<T, D>(vs, v + (long long)kvh * Sk * D, k0, Sk);

  // the query rows that see any key of this tile
  int qi_begin = 0, qi_end = Sq;
  if (causal) qi_begin = max(0, k0 - q_offset);
  if (window > 0) qi_end = min(Sq, k0 + BK - 1 + window - q_offset);
  qi_begin = (qi_begin / BQ) * BQ;

  float acc_k[ACC], acc_v[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc_k[a] = acc_v[a] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int bh = kvh * G + g;
    const T* qb = q + (long long)bh * Sq * D;
    const T* db = dout + (long long)bh * Sq * D;
    for (int q0 = qi_begin; q0 < qi_end; q0 += BQ) {
      __syncthreads();
      load_tile<T, D>(qs, qb, q0, Sq);
      load_tile<T, D>(dos, db, q0, Sq);
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        const long long at = (long long)bh * Sq + qi;
        ls[threadIdx.x] = qi < Sq ? lse[at] : 0.f;
        ds[threadIdx.x] = qi < Sq ? delta[at] : 0.f;
      }
      __syncthreads();
      // thread: query row `row` of the tile, keys lane + 8c
      float s[COLS], dp[COLS];
      row_dots<D>(qs, ks, s);
      row_dots<D>(dos, vs, dp);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int j = lane + LANES * c;
        const bool ok = visible(q0 + row, Sq, k0 + j, Sk, q_offset, causal,
                                window);
        const float p = ok ? expf(s[c] * scale - ls[row]) : 0.f;
        ps[row * SP + j] = p;
        dss[row * SP + j] = p * (dp[c] - ds[row]);
      }
      __syncthreads();
      // thread: key row `row` of this block's tile, columns lane + 8a
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float p = ps[i * SP + row];
        const float dsv = dss[i * SP + row];
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const int d = lane + LANES * a;
          acc_v[a] = fmaf(p, dos[i * (D + 1) + d], acc_v[a]);
          acc_k[a] = fmaf(dsv, qs[i * (D + 1) + d], acc_k[a]);
        }
      }
    }
  }
  if (k0 + row < Sk) {
    const long long base = ((long long)kvh * Sk + k0 + row) * D;
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int d = lane + LANES * a;
      dk[base + d] = repro::from_f32<T>(acc_k[a] * scale);
      dv[base + d] = repro::from_f32<T>(acc_v[a]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, int Sq, int Sk, int G, int causal, int window,
           float scale) {
  constexpr int ACC = D / LANES;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + tile_floats<D>();
  float* ks = dos + tile_floats<D>();
  float* vs = ks + tile_floats<D>();
  float* dss = vs + tile_floats<D>();      // [BQ][SP]: dS
  float* ls = dss + BQ * SP;
  float* ds = ls + BQ;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int q_offset = Sk - Sq;
  const int row = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const T* kb = k + (long long)(bh / G) * Sk * D;
  const T* vb = v + (long long)(bh / G) * Sk * D;

  load_tile<T, D>(qs, q + (long long)bh * Sq * D, q0, Sq);
  load_tile<T, D>(dos, dout + (long long)bh * Sq * D, q0, Sq);
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    const long long at = (long long)bh * Sq + qi;
    ls[threadIdx.x] = qi < Sq ? lse[at] : 0.f;
    ds[threadIdx.x] = qi < Sq ? delta[at] : 0.f;
  }
  int k_begin, k_end;
  key_range(q0, Sq, Sk, q_offset, causal, window, &k_begin, &k_end);

  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(ks, kb, k0, Sk);
    load_tile<T, D>(vs, vb, k0, Sk);
    __syncthreads();
    float s[COLS], dp[COLS];
    row_dots<D>(qs, ks, s);
    row_dots<D>(dos, vs, dp);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int j = lane + LANES * c;
      const bool ok =
          visible(q0 + row, Sq, k0 + j, Sk, q_offset, causal, window);
      const float p = ok ? expf(s[c] * scale - ls[row]) : 0.f;
      dss[row * SP + j] = p * (dp[c] - ds[row]);
    }
    __syncthreads();
    // thread: query row `row`, columns lane + 8a
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float dsv = dss[row * SP + j];
#pragma unroll
      for (int a = 0; a < ACC; ++a)
        acc[a] = fmaf(dsv, ks[j * (D + 1) + lane + LANES * a], acc[a]);
    }
  }
  if (q0 + row < Sq) {
    const long long base = ((long long)bh * Sq + q0 + row) * D;
#pragma unroll
    for (int a = 0; a < ACC; ++a)
      dq[base + lane + LANES * a] = repro::from_f32<T>(acc[a] * scale);
  }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, float* lse, float* delta, int BH, int BHk,
                     int Sq, int Sk, int causal, int window,
                     cudaStream_t stream) {
  static_assert(dkdv_smem<D>() <= 232448, "tiles fit one block");
  const int G = BH / BHk;
  const float scale = 1.f / sqrtf((float)D);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  cudaError_t err = opt_in(bwd_stats<T, D>, stats_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 qgrid((Sq + BQ - 1) / BQ, BH);
  bwd_stats<T, D><<<qgrid, THREADS, stats_smem<D>(), stream>>>(
      qt, kt, static_cast<const T*>(o), dot, lse, delta, Sq, Sk, G, causal,
      window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = opt_in(bwd_dkdv<T, D>, dkdv_smem<D>())) != cudaSuccess)
    return err;
  const dim3 kgrid((Sk + BK - 1) / BK, BHk);
  bwd_dkdv<T, D><<<kgrid, THREADS, dkdv_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, G, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = opt_in(bwd_dq<T, D>, dq_smem<D>())) != cudaSuccess) return err;
  bwd_dq<T, D><<<qgrid, THREADS, dq_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk, G, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int BH, int BHk,
                   int Sq, int Sk, int D, int causal, int window,
                   cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, BH,
                             BHk, Sq, Sk, causal, window, s);
    case 32:
      return launch_d<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, BH,
                             BHk, Sq, Sk, causal, window, s);
    case 64:
      return launch_d<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, BH,
                             BHk, Sq, Sk, causal, window, s);
    case 128:
      return launch_d<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, BH,
                              BHk, Sq, Sk, causal, window, s);
    case 256:
      return launch_d<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta, BH,
                              BHk, Sq, Sk, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fa_bwd

// dq (BH,Sq,D), dk and dv (BHk,Sk,D) in the inputs' dtype; lse and delta
// are (BH, Sq) fp32 scratch.  Sq <= Sk (queries right-aligned).  Returns a
// cudaError_t (cudaErrorInvalidValue for a head dim or dtype it lacks).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int BH, int BHk, int Sq, int Sk, int D, int causal, int window,
    int dtype, void* stream) {
  if (BHk <= 0 || BH % BHk != 0 || Sq > Sk) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return fa_bwd::launch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                 BH, BHk, Sq, Sk, D, causal, window, s);
  if (dtype == repro::kBFloat16)
    return fa_bwd::launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse,
                                         delta, BH, BHk, Sq, Sk, D, causal,
                                         window, s);
  return cudaErrorInvalidValue;
}

// dynamic shared memory of the dK/dV pass at head dim D (the largest of
// the three), or -1 for a head dim the kernel lacks
extern "C" int repro_flash_attention_bwd_smem(int D) {
  switch (D) {
    case 16: return (int)fa_bwd::dkdv_smem<16>();
    case 32: return (int)fa_bwd::dkdv_smem<32>();
    case 64: return (int)fa_bwd::dkdv_smem<64>();
    case 128: return (int)fa_bwd::dkdv_smem<128>();
    case 256: return (int)fa_bwd::dkdv_smem<256>();
    default: return -1;
  }
}
