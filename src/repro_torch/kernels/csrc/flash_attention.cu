// K1: flash attention with online softmax, causal and sliding-window masks
// and grouped-query heads, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (_kernel) and computes what repro/kernels/ref.py:flash_attention defines:
// q (BH,Sq,D), k and v (BHk,Sk,D), out (BH,Sq,D) in q's dtype.  Queries are
// right-aligned against the keys (query i sits at absolute position
// Sk - Sq + i), so one kernel serves a full prefill and a chunk against a
// longer cache, unless the caller gives a query start on the device
// (*q_start, an int32 each block reads when it begins): then query i sits
// at *q_start + i, which a captured graph may change between replays.  A
// warm prefix admission uses it: its suffix rows attend over the slot's
// whole gathered block row.  Both routes walk key
// tiles at absolute multiples of their width, so a query row at position p
// sees the same tiles in the same order whatever its tile's start; the
// extra tiles a longer key row or another start adds are masked for that
// row, and a masked tile leaves m, l and the accumulator bit for bit as
// they were (p = 0, alpha = 1; or, before the row's first visible key, a
// sum that the first visible tile multiplies by alpha = 0).  So a row's
// bits are those of the cold prefill at the same position, provided every
// key the kernel loads is finite (a masked key still meets p = 0 in p.v).
// GQA goes by index, as the Pallas index_map does: query row
// bh reads K/V row bh / G with G = BH / BHk, and K/V are never repeated.
// As in the Pallas kernel, the running max and sum are fp32 and p is
// rounded to v's dtype before the p.v product.  Ragged Sq and Sk are masked
// here (the Pallas kernel asserts divisibility): keys past Sk get
// probability 0, rows past Sq are computed but never stored.  Unmasked
// (causal = 0, no window: an encoder's self-attention, a decoder's
// cross-attention), every row sees every key and the query offset reaches
// no mask, so Sq may be less or more than Sk.  Two routes,
// chosen by the wrapper before launch (kernels/flash_attention.py:route):
//
// bf16 at head dim 128 or 256 (every served call): wgmma fed by TMA.
//   What bounds it (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): one qwen3-0.6b
//   prefill layer (S 256, 16 query heads over 8 KV heads, D 128, causal)
//   moves ~3.1 MB and does ~0.27 GFLOP, ~1 us either way: at S 256 a call
//   is bound by latency (launch, the first loads, one chain of dependent
//   tiles per block), not by bytes or tensor cores.
//   Design: one block owns one (bh, 64-query tile): a producer warp issues
//   TMA, one consumer warpgroup (128 threads) computes.  Q comes once, by
//   TMA, into 128-byte-swizzled shared memory; K and V tiles of 64 keys
//   follow through a ring of two stages (K and V each with a full barrier,
//   one empty barrier per stage), through 3-D tensor maps, so a tile never
//   reads across a head and the ragged key edge reads as zero.  Tiles fully
//   masked by causality or the window are never loaded.  Per tile: S = Q K^T
//   by wgmma m64n64k16 (both operands K-major, D/16 steps); scale and mask
//   by absolute positions (masking skipped on tiles every query sees whole);
//   the online softmax on the fp32 accumulator fragment, each thread
//   holding parts of two rows, reduced over the 4 threads of a quad; O
//   rescaled; P rounded to bf16 pairs in registers (the reference's
//   p.astype(v.dtype)), which is already wgmma's A fragment layout; O += P V
//   by wgmma with A from registers and V an MN-major B (the transpose bit),
//   as D/64 n64 instructions per 16 keys, each over one 64-column atom of V.
//   Epilogue O / l, rows past Sq not stored.  The G query heads of a KV head
//   are separate blocks (each reads the KV tiles, from L2 after the first).
//   Every block's result depends on its own (bh, tile) alone, so a head's
//   output has the same bits whatever the batch.
//
// fp32, and bf16 at the other head dims (16, 32, 64): CUDA cores, the
//   first kernel, unchanged.  One block of 8 warps owns one (bh, 16-query
//   tile); each warp owns two query rows.  The block walks the K/V tiles
//   (32 keys each)
//   its queries can see, staged in shared memory as fp32; for each row,
//   lane j scores key j of the tile, the tile's max and sum come from fixed
//   butterfly shuffles, and the fp32 running max, denominator and
//   accumulator (each lane owns D/32 output columns) are rescaled once per
//   tile.  The three fp32 tiles take 4 * (BQ*D + BK*(D+1) + BK*D) bytes,
//   82,048 at D = 256, over the 48 KB a static array may hold, so they are
//   one dynamic buffer and the launch opts in to more where a head dim
//   needs it.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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
                           const int* __restrict__ q_start, float scale) {
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
  const int q_offset = q_start != nullptr ? *q_start : Sk - Sq;
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
                     const int* q_start, cudaStream_t stream) {
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
      causal, window, q_start, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int BHk, int Sq, int Sk, int D, int causal,
                   int window, const int* qs, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, qs, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, qs, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, qs, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, qs, stream);
    case 256:
      return launch_d<T, 256>(q, k, v, out, BH, BHk, Sq, Sk, causal, window, qs, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace fa_tc {

using namespace hopper;

constexpr int BQ = 64;                     // query rows per block: wgmma's m
constexpr int BKV = 64;                    // keys per tile
constexpr int STAGES = 2;                  // K/V tiles in flight
constexpr int CONSUMERS = 128;             // one warpgroup
constexpr int THREADS = CONSUMERS + 32;    // + one producer warp
constexpr uint32_t BOX = 64 * 64 * 2;      // one 64 x 64 bf16 TMA box
constexpr float NEG = -1e30f;              // masked score, as the reference
constexpr unsigned FULL = 0xffffffffu;

// one 64-row tile of Q, K or V: D/64 boxes of 64 columns (128 bytes) each
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return BQ * D * 2;
}

template <int D>
__host__ __device__ constexpr uint32_t smem_bytes() {
  // Q, the K and V rings, the barriers (Q full; K full, V full and empty
  // per stage), and room to align the tiles to 1024 bytes (the swizzle atom)
  return (1 + 2 * STAGES) * tile_bytes<D>() + 8 * (1 + 3 * STAGES) + 1024;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 __nv_bfloat16* __restrict__ out, int Sq,
                                 int Sk, int G, int causal, int window,
                                 const int* __restrict__ q_start,
                                 float scale_log2) {
  constexpr int DB = D / 64;        // 64-column boxes (and n64 pieces) of D
  constexpr uint32_t TILE = tile_bytes<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + TILE;             // STAGES tiles
  const uint32_t v_s = k_s + STAGES * TILE;    // STAGES tiles
  const uint32_t q_full = v_s + STAGES * TILE;
  const uint32_t k_full = q_full + 8;          // STAGES x 8 bytes
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = bh / G;
  // keys any query of this tile can see (absolute positions)
  const int q_offset = q_start != nullptr ? *q_start : Sk - Sq;
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_hi + 1);
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  const int t_begin = k_begin / BKV;
  const int t_end = (k_end + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: Q once, then K and V tile after tile through the ring
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_full, TILE);
      for (int b = 0; b < DB; ++b)
        tma_load(q_s + b * BOX, &map_q, 64 * b, q0, bh, q_full);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(k_full + 8 * stage, TILE);
        for (int b = 0; b < DB; ++b)
          tma_load(k_s + stage * TILE + b * BOX, &map_k, 64 * b, t * BKV, kvh,
                   k_full + 8 * stage);
        mbar_expect_tx(v_full + 8 * stage, TILE);
        for (int b = 0; b < DB; ++b)
          tma_load(v_s + stage * TILE + b * BOX, &map_v, 64 * b, t * BKV, kvh,
                   v_full + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: thread (warp w, lane l) holds rows w*16 + l/4 and that + 8
  // of the tile (i = 0, 1), and in each accumulator the columns
  // 8c + 2(l%4) and + 1
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16 + (lane >> 2);
  float o[DB][32];
#pragma unroll
  for (int b = 0; b < DB; ++b)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[b][j] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    // S = Q K^T over D in k16 steps: 32 bytes along the swizzled rows of a
    // box, the next box every 4 steps
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    mbar_wait(k_full + 8 * stage, phase);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      wgmma_m64n64k16<0>(s, desc(q_s + off, 16, 1024),
                         desc(k_s + stage * TILE + off, 16, 1024),
                         kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale into the log2 domain, then mask by absolute position unless
    // every query of the tile sees every key of it
    const bool whole = (!causal || k0 + BKV - 1 <= q_lo) &&
                       (window <= 0 || q_hi - k0 < window) &&
                       k0 + BKV <= Sk;
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] *= scale_log2;
    if (!whole) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int qpos = q_lo + row0 + 8 * ((j >> 1) & 1);
        const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        bool ok = true;
        if (causal) ok = qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        s[j] = kpos >= Sk ? -INFINITY : (ok ? s[j] : NEG);
      }
    }
    // online softmax: row maxima over the quad, rescale, p = 2^(s - m)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      alpha[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = exp2f(s[j] - mx[(j >> 1) & 1]);
      sum[(j >> 1) & 1] += s[j];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int b = 0; b < DB; ++b)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[b][j] *= alpha[(j >> 1) & 1];
    // P in bf16: keys 16k..16k+15 of the S fragment are the A fragment of
    // the k-th k16 step (rows g, g + 8; keys 2(l%4), +1, +8, +9)
    uint32_t p[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[k][r] = pack_bf16(s[8 * k + 2 * r], s[8 * k + 2 * r + 1]);

    // O += P V: V (keys x D, D contiguous) is an MN-major B; 16 keys are
    // two 8-row groups (1024 bytes apart), 2048 bytes per k16 step
    mbar_wait(v_full + 8 * stage, phase);
#pragma unroll
    for (int b = 0; b < DB; ++b) fence_regs(o[b]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < DB; ++b)
        wgmma_m64n64k16_rs<1>(
            o[b], p[k],
            desc(v_s + stage * TILE + b * BOX + 2048 * k, 1024, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < DB; ++b) fence_regs(o[b]);
    mbar_arrive(empty + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // O / l in bf16; query rows past Sq are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + row0 + 8 * i;
    if (q >= Sq) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    __nv_bfloat16* orow = out + ((long long)blockIdx.y * Sq + q) * D;
#pragma unroll
    for (int b = 0; b < DB; ++b)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * b + 8 * c +
                                           2 * (lane & 3)) =
            __floats2bfloat162_rn(o[b][4 * c + 2 * i] * inv,
                                  o[b][4 * c + 2 * i + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int BHk, int Sq, int Sk, int causal, int window,
                   const int* q_start, cudaStream_t stream) {
  constexpr uint32_t smem = smem_bytes<D>();
  static_assert(smem <= 232448, "tiles fit one block's shared memory");
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return refuse("TMA needs 16-byte aligned q, k and v");
  if (encoder() == nullptr)
    return refuse("cuTensorMapEncodeTiled not found in the driver");
  Map mq, mk, mv;
  if (!map_heads(&mq.m, q, BH, Sq, D) || !map_heads(&mk.m, k, BHk, Sk, D) ||
      !map_heads(&mv.m, v, BHk, Sk, D))
    return refuse("cuTensorMapEncodeTiled refused q, k or v");
  // the opt-in above 48 KB of shared memory, once per device
  static bool ready[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(flash_attention_kernel_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_attention_kernel_wgmma<D><<<grid, THREADS, smem, stream>>>(
      mq.m, mk.m, mv.m, static_cast<__nv_bfloat16*>(out), Sq, Sk, BH / BHk,
      causal, window, q_start, 1.4426950408889634f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace fa_tc

// q_start: null (queries right-aligned), or the int32 query start on the
// device
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int BH,
                                     int BHk, int Sq, int Sk, int D,
                                     int causal, int window,
                                     const int* q_start, int dtype,
                                     void* stream) {
  if (BH <= 0 || BHk <= 0 || BH % BHk != 0 || BH > 65535 || Sq <= 0 ||
      Sk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(q, k, v, out, BH, BHk, Sq, Sk, D, causal, window,
                           q_start, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, out, BH, BHk, Sq, Sk, D, causal,
                                   window, q_start, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// the bf16 wgmma route (kernels/flash_attention.py:route): head dim 128 or
// 256, bf16 q, k, v of 16-byte aligned bases
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* out, int BH,
                                           int BHk, int Sq, int Sk, int D,
                                           int causal, int window,
                                           const int* q_start,
                                           void* stream) {
  hopper::refusal() = "";
  // more queries than keys only where every row sees every key (no mask,
  // no start): a causal row before the first key would get no tile at all
  const bool open = !causal && window <= 0 && q_start == nullptr;
  if (BH <= 0 || BHk <= 0 || BH % BHk != 0 || BH > 65535 || Sq <= 0 ||
      Sk <= 0 || (Sq > Sk && !open))
    return hopper::refuse("shapes: BH % BHk, BH <= 65535, 0 < Sq, 0 < Sk, "
                          "and Sq <= Sk unless unmasked");
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      return fa_tc::launch<128>(q, k, v, out, BH, BHk, Sq, Sk, causal,
                                window, q_start, s);
    case 256:
      return fa_tc::launch<256>(q, k, v, out, BH, BHk, Sq, Sk, causal,
                                window, q_start, s);
    default:
      return hopper::refuse("the wgmma route takes head dim 128 or 256");
  }
}


// dynamic shared memory of the wgmma route's block at head dim D (0: none)
extern "C" int repro_flash_attention_wgmma_smem(int D) {
  return D == 128   ? static_cast<int>(fa_tc::smem_bytes<128>())
         : D == 256 ? static_cast<int>(fa_tc::smem_bytes<256>())
                    : 0;
}
