// K1's backward: the gradients of flash attention with respect to q, k and
// v, for Hopper (sm_90a).
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
// q_pos - k_pos < window).  Two routes, chosen by the wrapper before launch
// (kernels/flash_attention.py:bwd_route).  Both take three launches, no
// atomics, and write every output once from one block, in a fixed order:
//   1. stats: one block per (bh, query tile) walks the key tiles its
//      queries see and keeps the rows' running max and sum; it stores the
//      log-sum-exp L and D = rowsum(dO * O) in fp32 (BH, Sq) scratch;
//   2. dK, dV: one block per (bhk, key tile) holds K and V, then walks the
//      G query heads of the group in ascending order and, for each, the
//      query tiles that see the keys, ascending: it recomputes
//      P = exp(S * scale - L) and dS and accumulates dV += P^T dO and
//      dK += dS^T Q in registers;
//   3. dQ: one block per (bh, query tile) walks its key tiles again and
//      accumulates dQ += dS K.
// So two runs give the same bits, and every block's outputs depend on its
// own tile alone: a head's gradients have the same bits whatever the
// batch.  Tiles that causality or the window mask whole are never visited
// (the wgmma route's tile ranges, tc::key_tiles and tc::query_tiles, are
// copied by bwd_tile_pairs in tests/test_torch_train_kernels.py; the
// kernels' own check of their walk is chip_smoke.py's phase 30 (a), whose
// ragged and windowed calls are held against the plain version).
//
// bf16 at head dim 128 or 256 (every training call of the dense family):
//   wgmma fed by TMA, namespace fa_bwd::tc.  What bounds it (H100 SXM,
//   989 TFLOP/s bf16, 3.35 TB/s): at qwen3's training shape (B 4, S 1024,
//   16 query over 8 KV heads, D 128, causal) one product over the visible
//   pairs is ~8.6 GFLOP and the call moves ~50 MB, so the tensor cores
//   bound it.  The design does nine such products on whole 64 x 64
//   diagonal tiles (pass 1: S; pass 2: S twice, dP, dV, dK; pass 3: S, dP,
//   dQ), ~82 GFLOP, 0.083 ms at peak.  Each block has one producer warp
//   issuing TMA into 128-byte-swizzled tiles of 64 rows (3-D tensor maps,
//   one head a slab, so a box never crosses a head and rows past Sq or Sk
//   read as zero) through a ring of two stages, and consumer warpgroups
//   running m64n64k16 wgmma:
//   - pass 1: S = Q K^T (both operands K-major), the forward's masking and
//     online max and sum on the accumulator fragment; L is stored in the
//     log2 domain (m + log2 l, scores scaled by log2(e) / sqrt(D)), so
//     passes 2 and 3 take P = exp2(S * scale_log2 - L) as one FMA and one
//     exp2; D = rowsum(dO * O) from 16-byte loads, two threads a row;
//   - pass 2: K and V stay resident; the producer streams (Q, dO) tile
//     pairs, and puts the tile's L and D in the stage beside them.  Two
//     consumer warpgroups split the outputs, not the columns: warpgroup 0
//     computes S^T = K Q^T, P^T on its fragment, and dV += P^T dO;
//     warpgroup 1 computes S^T and dP^T = V dO^T, dS^T = P^T (dP^T - D),
//     and dK += dS^T Q.  P^T and dS^T are rounded to bf16 pairs in
//     registers, which is wgmma's A fragment, and dO and Q are MN-major B
//     operands in D/64 n64 pieces (the forward's O += P V step).  At D 256
//     a warpgroup's accumulator is 64 x 256 fp32, 128 registers a thread,
//     beside S^T and dP^T: splitting by output keeps one accumulator per
//     warpgroup at either head dim, needs no exchange of P^T or dS^T
//     through shared memory and no barrier between the warpgroups, and
//     costs one recomputed S^T (five products a tile pair for four), where
//     splitting the columns would recompute S^T and dP^T (six).  ptxas
//     budgets registers by whole warpgroups (168 a thread for three), and
//     warpgroup 1 needs ~200 at D 256, so the producer's warpgroup lowers
//     its budget to 40 and the consumers raise theirs to 232 (setmaxnreg);
//   - pass 3: Q and dO stay resident, K and V come through the ring; S and
//     dP by wgmma, then P, dS (bf16 A fragment) and dQ += dS K with K an
//     MN-major B, one consumer warpgroup.
//   Blocks start heaviest first: pass 2 walks key tile 0 (which a causal
//   call's every query tile sees) first, passes 1 and 3 the last query
//   tile first, with the heads as the grid's fastest index.  P and dS are
//   rounded to bf16 before their products, which the CUDA-core route does
//   not do; the sums stay fp32.
//
// fp32, and bf16 at head dims 16, 32 and 64: CUDA cores, namespace fa_bwd.
//   One block of 256 threads per tile of 32 rows.  Each tile lives in
//   shared memory as fp32 rows padded to D + 1 columns, so the lanes of a
//   warp read different banks; eight consecutive lanes share one row of a
//   32 x 32 score tile (four columns each, reduced by shuffles inside the
//   eight), and the same eight own every eighth column of a D-wide
//   accumulator row.  Pass 2 holds four tiles and two 32 x 33 score tiles:
//   140,288 bytes at D = 256, which the launch opts in to (over the 48 KB
//   default).  Every product reads both operands from shared memory, two
//   loads a multiply-add on the fp32 CUDA cores (67 TFLOP/s), so shared-
//   memory bandwidth sets its pace: fine for the fp32 parity runs and the
//   small head dims, which no full-width training call takes.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

namespace fa_bwd {
namespace tc {

using namespace hopper;

constexpr int T = 64;                  // rows of a tile: wgmma's m
constexpr int STAGES = 2;              // tiles (or tile pairs) in flight
constexpr int WG = 128;                // threads of a consumer warpgroup
constexpr uint32_t BOX = 64 * 64 * 2;  // one 64 x 64 bf16 TMA box
constexpr float NEG = -1e30f;          // masked score, as the forward's
constexpr unsigned FULL = 0xffffffffu;

// one 64-row bf16 tile of head dim D: D/64 swizzled boxes of 64 columns
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return T * D * 2;
}

// dynamic shared memory of each pass: its tiles, the pass-2 stages' L and
// D rows, the barriers (8 bytes each), and room to align the tiles to 1024
// bytes (the swizzle atom)
template <int D>
__host__ __device__ constexpr uint32_t stats_smem() {
  // Q; K through the ring; barriers: Q full, K full and empty per stage
  return (1 + STAGES) * tile_bytes<D>() + 8 * (1 + 2 * STAGES) + 1024;
}
template <int D>
__host__ __device__ constexpr uint32_t dkdv_smem() {
  // K, V; (Q, dO) pairs through the ring with 64 L and 64 D each;
  // barriers: K/V full, pair full and empty per stage
  return (2 + 2 * STAGES) * tile_bytes<D>() + STAGES * 2 * T * 4 +
         8 * (1 + 2 * STAGES) + 1024;
}
template <int D>
__host__ __device__ constexpr uint32_t dq_smem() {
  // Q, dO; (K, V) pairs through the ring; barriers: Q/dO full, pair full
  // and empty per stage
  return (2 + 2 * STAGES) * tile_bytes<D>() + 8 * (1 + 2 * STAGES) + 1024;
}

// the key tiles [*t_begin, *t_end) that the query rows [q0, q0 + 64) see;
// every tile in the range holds a visible pair
__device__ __forceinline__ void key_tiles(int q0, int Sq, int Sk, int causal,
                                          int window, int* t_begin,
                                          int* t_end) {
  const int q_offset = Sk - Sq;
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + T, Sq) - 1;
  int lo = 0, hi = Sk;
  if (causal) hi = min(Sk, q_hi + 1);
  if (window > 0) lo = max(0, q_lo - window + 1);
  *t_begin = lo / T;
  *t_end = lo < hi ? (hi + T - 1) / T : lo / T;
}

// the query tiles [*t_begin, *t_end) that see any key of [k0, k0 + 64)
__device__ __forceinline__ void query_tiles(int k0, int Sq, int Sk,
                                            int causal, int window,
                                            int* t_begin, int* t_end) {
  const int q_offset = Sk - Sq;
  const int k_hi = min(k0 + T, Sk) - 1;
  int lo = 0, hi = Sq;
  if (causal) lo = max(0, k0 - q_offset);
  if (window > 0) hi = min(Sq, k_hi + window - q_offset);
  *t_begin = lo / T;
  *t_end = lo < hi ? (hi + T - 1) / T : lo / T;
}

__device__ __forceinline__ bool visible(int qi, int Sq, int kpos, int Sk,
                                        int causal, int window) {
  const int qpos = Sk - Sq + qi;
  bool ok = qi < Sq && kpos < Sk;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && (qpos - kpos) < window;
  return ok;
}

// every (query, key) of the two 64-row tiles is visible
__device__ __forceinline__ bool whole_tile(int q0, int k0, int Sq, int Sk,
                                           int causal, int window) {
  const int q_lo = Sk - Sq + q0;
  return (!causal || k0 + T - 1 <= q_lo) &&
         (window <= 0 || q_lo + T - 1 - k0 < window) && k0 + T <= Sk &&
         q0 + T <= Sq;
}

// acc (64 x 64 fp32 fragment) += A . B^T over D in k16 steps, A and B two
// 64-row tiles, both K-major (D contiguous): 32 bytes along the swizzled
// rows of a box, the next box every 4 steps
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_m64n64k16<0>(acc, desc(a + off, 16, 1024), desc(b + off, 16, 1024),
                       kk > 0 ? 1 : 0);
  }
}

// acc (64 x D) += A . B: A the bf16 fragment of a 64 x 64 product (the
// accumulator layout packed in pairs), B a 64-row tile read MN-major (the
// transpose bit): 16 rows are two 8-row groups, 2048 bytes a k16 step,
// one n64 instruction per 64-column box
template <int D>
__device__ __forceinline__ void frag_dot(float (&acc)[D / 64][32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
      wgmma_m64n64k16_rs<1>(acc[n], a[k], desc(b + n * BOX + 2048 * k, 1024,
                                              1024), 1);
}

// the accumulator fragment as wgmma's A fragment in bf16: keys (or
// queries) 16k..16k+15 of the fragment are the k-th k16 step
__device__ __forceinline__ void pack(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[k][r] = pack_bf16(x[8 * k + 2 * r], x[8 * k + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N][32]) {
#pragma unroll
  for (int n = 0; n < N; ++n) fence_regs(acc[n]);
}

// rows [r0, r0 + 64) of the accumulator (thread (warp w, lane l): rows
// w*16 + l/4 and + 8, columns 8c + 2(l%4) and + 1 of each n64 piece) times
// mul, as bf16 rows of a (rows, D) slab; rows past `rows` are not stored
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 64][32],
                                           int r0, int rows, float mul) {
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int row0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + row0 + 8 * i;
    if (r >= rows) continue;
    __nv_bfloat16* orow = out + (long long)r * D;
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * n + 8 * c +
                                           2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[n][4 * c + 2 * i] * mul,
                                  acc[n][4 * c + 2 * i + 1] * mul);
  }
}

__device__ __forceinline__ uint32_t align_smem(uint8_t* raw) {
  return (smem_u32(raw) + 1023) & ~1023u;
}

// pass 1: L (log2 domain) and D = rowsum(dO * O) of one (bh, query tile)
template <int D>
__global__ void __launch_bounds__(WG + 32, 1)
    stats_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ lse, float* __restrict__ delta, int Sq,
                int Sk, int G, int causal, int window, float scale_log2) {
  constexpr int DB = D / 64;
  constexpr uint32_t TILE = tile_bytes<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t q_s = align_smem(smem_raw);
  const uint32_t k_s = q_s + TILE;                // STAGES tiles
  const uint32_t q_full = k_s + STAGES * TILE;
  const uint32_t k_full = q_full + 8;             // STAGES barriers
  const uint32_t empty = k_full + 8 * STAGES;     // STAGES barriers

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;   // last tiles first
  int t_begin, t_end;
  key_tiles(q0, Sq, Sk, causal, window, &t_begin, &t_end);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= WG) {
    if (tid == WG) {
      mbar_expect_tx(q_full, TILE);
      for (int b = 0; b < DB; ++b)
        tma_load(q_s + b * BOX, &map_q, 64 * b, q0, bh, q_full);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(k_full + 8 * stage, TILE);
        for (int b = 0; b < DB; ++b)
          tma_load(k_s + stage * TILE + b * BOX, &map_k, 64 * b, t * T,
                   bh / G, k_full + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // D: two threads a row, each half of it in 16-byte loads, then the two
  // halves in a fixed order
  {
    const int r = tid >> 1, half = tid & 1;
    float sum = 0.f;
    if (q0 + r < Sq) {
      const long long at = ((long long)bh * Sq + q0 + r) * D + half * (D / 2);
      const uint4* op = reinterpret_cast<const uint4*>(o + at);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll 4
      for (int c = 0; c < D / 16; ++c) {
        const uint4 a = op[c], b = dp[c];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]);
          const float2 y = __bfloat1622float2(b2[e]);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    if (half == 0 && q0 + r < Sq) delta[(long long)bh * Sq + q0 + r] = sum;
  }

  // the forward's online max and sum over the key tiles
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16 + (lane >> 2);
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * T;
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    mbar_wait(k_full + 8 * stage, phase);
    fence_regs(s);
    wgmma_fence();
    tile_dot<D>(s, q_s, k_s + stage * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(empty + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    const bool whole = whole_tile(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] *= scale_log2;
      if (!whole) {
        const int qi = q0 + row0 + 8 * ((j >> 1) & 1);
        const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        s[j] = kpos >= Sk ? -INFINITY
                          : (visible(qi, Sq, kpos, Sk, causal, window) ? s[j]
                                                                       : NEG);
      }
    }
    float mx[2] = {m_run[0], m_run[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
      sum[(j >> 1) & 1] += exp2f(s[j] - mx[(j >> 1) & 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
      l_run[i] = l_run[i] * exp2f(m_run[i] - mx[i]) + sum[i];
      m_run[i] = mx[i];
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + row0 + 8 * i;
      if (qi < Sq)
        lse[(long long)bh * Sq + qi] =
            m_run[i] + log2f(fmaxf(l_run[i], 1e-30f));
    }
  }
}

// pass 2, one consumer warpgroup: DK false accumulates dV += P^T dO, DK
// true dK += dS^T Q, over the (Q, dO) tile pairs the producer streams
template <int D, bool DK>
__device__ __forceinline__ void dkdv_consumer(
    uint32_t k_s, uint32_t v_s, uint32_t pair_s, const float* stats,
    uint32_t kv_full, uint32_t full, uint32_t empty, __nv_bfloat16* out,
    int kvh, int k0, int qt_begin, int qt_end, int Sq, int Sk, int G,
    int causal, int window, float scale_log2, float mul) {
  constexpr int DB = D / 64;
  constexpr uint32_t TILE = tile_bytes<D>();
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int row0 = warp * 16 + (lane >> 2);   // key rows row0, row0 + 8
  float acc[DB][32];
#pragma unroll
  for (int n = 0; n < DB; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[n][j] = 0.f;
  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int g = 0; g < G; ++g) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * T;
      const uint32_t q_st = pair_s + stage * 2 * TILE, do_st = q_st + TILE;
      const float* ls = stats + stage * 2 * T;   // L, then D, of 64 rows
      float s[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      mbar_wait(full + 8 * stage, phase);
      fence_regs(s);
      if constexpr (DK) fence_regs(dp);
      wgmma_fence();
      tile_dot<D>(s, k_s, q_st);                   // S^T = K Q^T
      if constexpr (DK) tile_dot<D>(dp, v_s, do_st);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (DK) fence_regs(dp);
      const bool whole = whole_tile(q0, k0, Sq, Sk, causal, window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);   // query
        float p = exp2f(fmaf(s[j], scale_log2, -ls[c]));
        if (!whole) {
          const int kpos = k0 + row0 + 8 * ((j >> 1) & 1);
          p = visible(q0 + c, Sq, kpos, Sk, causal, window) ? p : 0.f;
        }
        if constexpr (DK)
          s[j] = p * (dp[j] - ls[T + c]);
        else
          s[j] = p;
      }
      uint32_t a[4][4];
      pack(s, a);
      fence_acc(acc);
      wgmma_fence();
      frag_dot<D>(acc, a, DK ? q_st : do_st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(empty + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  store_rows<D>(out + (long long)kvh * Sk * D, acc, k0, Sk, mul);
}

// pass 2: dK and dV of one (bhk, key tile).  Three warpgroups: two
// consumers and a producer, one warp of which works.  ptxas budgets a
// block's registers by whole warpgroups, 168 a thread for three, and
// warpgroup 1 holds dK (64 x D fp32), S^T and dP^T: 192 at D 256.  So the
// producer warpgroup gives its registers up (40 a thread) and the
// consumers take 232.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(WG * PRODUCER_REGS + 2 * WG * CONSUMER_REGS <= 65536,
              "the register file holds the three warpgroups' budgets");

template <int D>
__global__ void __launch_bounds__(3 * WG, 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ lse,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int G,
               int causal, int window, float scale_log2, float scale) {
  constexpr int DB = D / 64;
  constexpr uint32_t TILE = tile_bytes<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t k_s = align_smem(smem_raw);
  const uint32_t v_s = k_s + TILE;
  const uint32_t pair_s = v_s + TILE;                 // STAGES x (Q, dO)
  const uint32_t stats_s = pair_s + STAGES * 2 * TILE;  // STAGES x (L, D)
  const uint32_t kv_full = stats_s + STAGES * 2 * T * 4;
  const uint32_t full = kv_full + 8;                  // STAGES barriers
  const uint32_t empty = full + 8 * STAGES;           // STAGES barriers
  float* stats = reinterpret_cast<float*>(
      smem_raw + (stats_s - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * T;          // key tile 0, the heaviest, first
  int qt_begin, qt_end;
  query_tiles(k0, Sq, Sk, causal, window, &qt_begin, &qt_end);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's expect_tx, then the warp's 32 arrivals after it
      // wrote the stage's L and D
      mbar_init(full + 8 * s, 1 + 32);
      mbar_init(empty + 8 * s, 2 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 2 * WG) {
    // producer: K and V once, then (Q, dO) of the G heads in order
    setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = tid - 2 * WG;
    if (lane >= 32) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * TILE);
      for (int b = 0; b < DB; ++b) {
        tma_load(k_s + b * BOX, &map_k, 64 * b, k0, kvh, kv_full);
        tma_load(v_s + b * BOX, &map_v, 64 * b, k0, kvh, kv_full);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0; g < G; ++g) {
      const int bh = kvh * G + g;
      for (int qt = qt_begin; qt < qt_end; ++qt) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        float* st = stats + stage * 2 * T;
        for (int i = lane; i < T; i += 32) {
          const int qi = qt * T + i;
          const long long at = (long long)bh * Sq + qi;
          st[i] = qi < Sq ? lse[at] : 0.f;
          st[T + i] = qi < Sq ? delta[at] : 0.f;
        }
        if (lane == 0) {
          const uint32_t q_st = pair_s + stage * 2 * TILE;
          mbar_expect_tx(full + 8 * stage, 2 * TILE);
          for (int b = 0; b < DB; ++b) {
            tma_load(q_st + b * BOX, &map_q, 64 * b, qt * T, bh,
                     full + 8 * stage);
            tma_load(q_st + TILE + b * BOX, &map_do, 64 * b, qt * T, bh,
                     full + 8 * stage);
          }
        }
        mbar_arrive(full + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  if (tid < WG)
    dkdv_consumer<D, false>(k_s, v_s, pair_s, stats, kv_full, full, empty,
                            dv, kvh, k0, qt_begin, qt_end, Sq, Sk, G, causal,
                            window, scale_log2, 1.f);
  else
    dkdv_consumer<D, true>(k_s, v_s, pair_s, stats, kv_full, full, empty, dk,
                           kvh, k0, qt_begin, qt_end, Sq, Sk, G, causal,
                           window, scale_log2, scale);
}

// pass 3: dQ of one (bh, query tile)
template <int D>
__global__ void __launch_bounds__(WG + 32, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const __grid_constant__ CUtensorMap map_do,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int G,
             int causal, int window, float scale_log2, float scale) {
  constexpr int DB = D / 64;
  constexpr uint32_t TILE = tile_bytes<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t q_s = align_smem(smem_raw);
  const uint32_t do_s = q_s + TILE;
  const uint32_t pair_s = do_s + TILE;                // STAGES x (K, V)
  const uint32_t qd_full = pair_s + STAGES * 2 * TILE;
  const uint32_t full = qd_full + 8;                  // STAGES barriers
  const uint32_t empty = full + 8 * STAGES;           // STAGES barriers

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;   // last tiles first
  int t_begin, t_end;
  key_tiles(q0, Sq, Sk, causal, window, &t_begin, &t_end);

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= WG) {
    if (tid == WG) {
      mbar_expect_tx(qd_full, 2 * TILE);
      for (int b = 0; b < DB; ++b) {
        tma_load(q_s + b * BOX, &map_q, 64 * b, q0, bh, qd_full);
        tma_load(do_s + b * BOX, &map_do, 64 * b, q0, bh, qd_full);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const uint32_t k_st = pair_s + stage * 2 * TILE;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, 2 * TILE);
        for (int b = 0; b < DB; ++b) {
          tma_load(k_st + b * BOX, &map_k, 64 * b, t * T, bh / G,
                   full + 8 * stage);
          tma_load(k_st + TILE + b * BOX, &map_v, 64 * b, t * T, bh / G,
                   full + 8 * stage);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16 + (lane >> 2);   // query rows row0, row0 + 8
  float l_row[2], d_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + 8 * i;
    const long long at = (long long)bh * Sq + qi;
    l_row[i] = qi < Sq ? lse[at] : 0.f;
    d_row[i] = qi < Sq ? delta[at] : 0.f;
  }
  float acc[DB][32];
#pragma unroll
  for (int n = 0; n < DB; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[n][j] = 0.f;
  mbar_wait(qd_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * T;
    const uint32_t k_st = pair_s + stage * 2 * TILE, v_st = k_st + TILE;
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    mbar_wait(full + 8 * stage, phase);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    tile_dot<D>(s, q_s, k_st);      // S = Q K^T
    tile_dot<D>(dp, do_s, v_st);    // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const bool whole = whole_tile(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      float p = exp2f(fmaf(s[j], scale_log2, -l_row[i]));
      if (!whole) {
        const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        p = visible(q0 + row0 + 8 * i, Sq, kpos, Sk, causal, window) ? p
                                                                      : 0.f;
      }
      s[j] = p * (dp[j] - d_row[i]);
    }
    uint32_t a[4][4];
    pack(s, a);
    fence_acc(acc);
    wgmma_fence();
    frag_dot<D>(acc, a, k_st);      // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<D>(dq + (long long)bh * Sq * D, acc, q0, Sq, scale);
}

// the opt-in above 48 KB of shared memory, once per kernel and device
template <typename K>
cudaError_t opt_in_once(K kernel, uint32_t smem, bool (&ready)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) ready[device] = true;
  return err;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int BH, int BHk,
                   int Sq, int Sk, int causal, int window,
                   cudaStream_t stream) {
  static_assert(dkdv_smem<D>() <= 232448 && dq_smem<D>() <= 232448,
                "tiles fit one block's shared memory");
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout)) % 16)
    return refuse("TMA needs 16-byte aligned q, k, v, out and dout");
  if (encoder() == nullptr)
    return refuse("cuTensorMapEncodeTiled is not available");
  // encoded after tensor_map has bound the device's primary context: the
  // backward runs on PyTorch's autograd worker thread
  Map mq, mk, mv, mdo;
  if (!map_heads(&mq.m, q, BH, Sq, D) || !map_heads(&mk.m, k, BHk, Sk, D) ||
      !map_heads(&mv.m, v, BHk, Sk, D) ||
      !map_heads(&mdo.m, dout, BH, Sq, D))
    return refuse("cuTensorMapEncodeTiled refused q, k, v or dout");
  static bool ready_stats[64] = {}, ready_dkdv[64] = {}, ready_dq[64] = {};
  cudaError_t err;
  if ((err = opt_in_once(stats_wgmma<D>, stats_smem<D>(), ready_stats)) !=
          cudaSuccess ||
      (err = opt_in_once(dkdv_wgmma<D>, dkdv_smem<D>(), ready_dkdv)) !=
          cudaSuccess ||
      (err = opt_in_once(dq_wgmma<D>, dq_smem<D>(), ready_dq)) != cudaSuccess)
    return err;
  const int G = BH / BHk;
  const float scale = 1.f / sqrtf((float)D);
  const float scale_log2 = 1.4426950408889634f * scale;
  const dim3 qgrid(BH, (Sq + T - 1) / T), kgrid(BHk, (Sk + T - 1) / T);
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(dout);
  stats_wgmma<D><<<qgrid, WG + 32, stats_smem<D>(), stream>>>(
      mq.m, mk.m, ob, dob, lse, delta, Sq, Sk, G, causal, window,
      scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_wgmma<D><<<kgrid, 3 * WG, dkdv_smem<D>(), stream>>>(
      mq.m, mk.m, mv.m, mdo.m, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, G, causal, window,
      scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_wgmma<D><<<qgrid, WG + 32, dq_smem<D>(), stream>>>(
      mq.m, mk.m, mv.m, mdo.m, lse, delta, static_cast<__nv_bfloat16*>(dq),
      Sq, Sk, G, causal, window, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace tc
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

// the bf16 wgmma route (kernels/flash_attention.py:bwd_route): head dim 128
// or 256, bf16 tensors of 16-byte aligned bases; lse and delta (BH, Sq)
// fp32 scratch, lse in the log2 domain
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int BH, int BHk, int Sq, int Sk, int D, int causal, int window,
    void* stream) {
  hopper::refusal() = "";
  if (BH <= 0 || BHk <= 0 || BH % BHk != 0 || Sq <= 0 || Sk <= 0 ||
      Sq > Sk || (Sq + 63) / 64 > 65535 || (Sk + 63) / 64 > 65535)
    return hopper::refuse("shapes: BH % BHk, 0 < Sq <= Sk, and fewer than "
                          "65,536 tiles of 64 rows");
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      return fa_bwd::tc::launch<128>(q, k, v, o, dout, dq, dk, dv, lse,
                                     delta, BH, BHk, Sq, Sk, causal, window,
                                     s);
    case 256:
      return fa_bwd::tc::launch<256>(q, k, v, o, dout, dq, dk, dv, lse,
                                     delta, BH, BHk, Sq, Sk, causal, window,
                                     s);
    default:
      return hopper::refuse("the wgmma route takes head dim 128 or 256");
  }
}

// dynamic shared memory of the wgmma route's pass (0 stats, 1 dK/dV, 2 dQ)
// at head dim D, or -1 for a head dim or pass it lacks
extern "C" int repro_flash_attention_bwd_wgmma_smem(int D, int pass) {
  using namespace fa_bwd::tc;
  if (D != 128 && D != 256) return -1;
  const bool wide = D == 256;
  switch (pass) {
    case 0: return (int)(wide ? stats_smem<256>() : stats_smem<128>());
    case 1: return (int)(wide ? dkdv_smem<256>() : dkdv_smem<128>());
    case 2: return (int)(wide ? dq_smem<256>() : dq_smem<128>());
    default: return -1;
  }
}
