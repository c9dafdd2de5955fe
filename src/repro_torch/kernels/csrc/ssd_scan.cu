// K4: Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py:ssd_scan (_kernel)
// and computes what it computes: for each (batch, head) the chunks of the
// sequence are scanned in order with the state h (P x N, fp32) kept on
// chip.  For a chunk of q positions, with da = dt * a and cs its inclusive
// cumsum (fp32):
//   att[i,j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j for j <= i, else 0,
//              the exponent taken only where j <= i (above the diagonal
//              it is positive and overflows: the reference's NaN guard),
//              rounded to the input dtype as the Pallas kernel casts it
//              before the x product;
//   y_i      = sum_j att[i,j] x_j + (C_i . h) * exp(cs_i), rounded once;
//   h        = h * exp(cs_last)
//              + sum_j (x_j * dt_j * exp(cs_last - cs_j)) B_j.
// Every product accumulates in fp32.  x (B,S,H,P), b and c (B,S,N) are in
// T and may be strided (last axis contiguous); dt (B,S,H) and a (H,) are
// fp32; h0 (B,H,P,N) fp32 or null (zeros); y (B,S,H,P) in T and hf
// (B,H,P,N) fp32 are contiguous.  The D-skip stays with the caller.  A
// last chunk shorter than the chunk length is masked here (the Pallas
// kernel asserts S % chunk == 0).
//
// What bounds it on the serving path (H100 SXM, 3.35 TB/s, 989 TFLOP/s
// bf16): one mamba2-130m admission call (B 1, S 256 in 2 chunks of 128,
// H 24, P 64, N 128, bf16) moves ~3.3 MB (x and y 0.79 MB each, b and c
// 0.07 MB each, dt 0.02 MB, h0 in and h_final out 0.79 MB each in fp32):
// ~0.99 us of memory time, against ~0.26 GFLOP, ~0.27 us at the tensor-core
// peak, so bytes bound it and the bound is below one launch's overhead:
// the time goes to latency (loads, one chain of dependent products per
// chunk).  Two routes, chosen by the wrapper before launch
// (kernels/ssd_scan.py:route):
//
// bf16 with P 64, N 64 or 128, chunks of 128 (or one chunk of S <= 128)
//   and operands TMA can read (every served call): wgmma fed by TMA,
//   namespace ssd_tc.  One block owns one (batch, head) and walks its
//   chunks in order: a producer thread loads each chunk's C and B (128 x N)
//   and x (128 x 64) by TMA through 3-D maps of the strided views (a box
//   never leaves its batch row or its head's 64 columns, and rows past S
//   read as zero) into a ring of two stages, so the second chunk lands
//   while the first is computed.  Two consumer warpgroups own 64 rows of
//   the chunk each.  y = C.h^T first, h fed as a hi + lo pair of bf16
//   tiles (~2^-16 relative error, where one bf16 rounding would put 2^-8
//   into every y), scaled per row by exp(cs_i).  Then the keys in halves
//   of 64 (rows 0..63 see only the first): C.B^T by m64n64k16 over N; the
//   mask, decay, dt and the bf16 rounding on the fp32 fragment in
//   registers, which is then the register A operand of att.x (x an
//   MN-major B, as K1's P.V), accumulated onto y.  The state stays in
//   registers as the fp32 accumulator of its update: warpgroup w owns
//   state columns 64w..64w+63 (N 64: warpgroup 0 alone), scales them by
//   exp(cs_last) and adds (x * w)^T . B by register-A wgmma, x * w in fp32
//   split into hi + lo bf16, B's chunk an MN-major B.  Halves keep a
//   thread under the 168 registers a 288-thread block allows.  The cumsum
//   is one warp's scan: four rows a lane, then a shuffle scan of the lane
//   totals, a fixed order.
//
// fp32, and shapes the wgmma route does not take: CUDA cores, the first
//   kernel, unchanged.  One block of 256 threads owns one (batch, head,
//   tile of PT = 16 state rows).  The rows of h evolve independently
//   (y[:, p] needs only h[p, :] and x[:, p]), so splitting P changes no
//   result and gives B x H x P/16 blocks.  Each chunk is staged in shared
//   memory as fp32: C and B (Q x N, rows padded to N + 1 so neighbouring
//   threads hit different banks), the Q x Q weights, the x tile and the
//   16 state rows, 216 KB at Q = N = 128, so one block per SM.  The
//   weights depend on the head but not on P, so the four blocks of a head
//   recompute them.  Any P and N and chunk <= 128 are masked here.
//
// Fixed order, no atomics: every output and state element is summed in
// one block in an order fixed by the shapes, and nothing is split across
// blocks, so a row's result never depends on the batch.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PT = 16;                  // state rows per block
constexpr int kMaxChunk = 128;          // tid < Q loads the (Q,) vectors
constexpr size_t kMaxSmem = 232448;     // dynamic shared memory per block

// floats of dynamic shared memory at chunk Q and state width N
// (kernels/ssd_scan.py: smem_bytes)
inline size_t smem_floats(int Q, int N) {
  return (size_t)2 * Q * (N + 1)  // C and B chunks
         + (size_t)Q * (Q + 1)    // decay-masked weights
         + (size_t)Q * PT         // x tile
         + (size_t)PT * (N + 1)   // state rows
         + (size_t)4 * Q;         // dt, cs, exp(cs), dt * exp(cs_last - cs)
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ h0,
                    T* __restrict__ y, float* __restrict__ hf, int S, int H,
                    int P, int N, int Q, long long sxb, long long sxs,
                    long long sxh, long long sdb, long long sds,
                    long long sbb, long long sbs, long long scb,
                    long long scs) {
  extern __shared__ float smem[];
  const int NP = N + 1, QP = Q + 1;
  float* cs_c = smem;              // [Q][NP] C chunk
  float* cs_b = cs_c + Q * NP;     // [Q][NP] B chunk
  float* att = cs_b + Q * NP;      // [Q][QP] decay-masked weights
  float* xs = att + Q * QP;        // [Q][PT] x tile
  float* hs = xs + Q * PT;         // [PT][NP] state rows
  float* dts = hs + PT * NP;       // [Q] dt
  float* cum = dts + Q;            // [Q] inclusive cumsum of dt * a
  float* ecum = cum + Q;           // [Q] exp(cum)
  float* wend = ecum + Q;          // [Q] dt * exp(cum_last - cum)

  const int p0 = blockIdx.x * PT;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(PT, P - p0);  // live state rows of this block
  const float ah = a[hh];
  const long long state0 = (((long long)bi * H + hh) * P + p0) * N;

  for (int e = tid; e < PT * N; e += THREADS) {
    const int p = e / N, n = e % N;
    hs[p * NP + n] = (h0 != nullptr && p < rows)
                         ? h0[state0 + (long long)p * N + n]
                         : 0.f;
  }

  const T* xb = x + bi * sxb + hh * sxh + p0;
  const float* db = dt + bi * sdb + hh;
  const T* bb = bm + bi * sbb;
  const T* cb = cm + bi * scb;
  T* yb = y + ((long long)bi * S * H + hh) * P + p0;
  const long long sys = (long long)H * P;  // y's stride along S

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int q = min(Q, S - s0);
    __syncthreads();  // the previous chunk is consumed, hs is initialised
    for (int e = tid; e < Q * N; e += THREADS) {
      const int j = e / N, n = e % N;
      float bv = 0.f, cv = 0.f;
      if (j < q) {
        bv = repro::to_f32(bb[(long long)(s0 + j) * sbs + n]);
        cv = repro::to_f32(cb[(long long)(s0 + j) * scs + n]);
      }
      cs_b[j * NP + n] = bv;
      cs_c[j * NP + n] = cv;
    }
    for (int e = tid; e < Q * PT; e += THREADS) {
      const int j = e / PT, p = e % PT;
      xs[e] = (j < q && p < rows)
                  ? repro::to_f32(xb[(long long)(s0 + j) * sxs + p])
                  : 0.f;
    }
    if (tid < Q) dts[tid] = tid < q ? db[(long long)(s0 + tid) * sds] : 0.f;
    __syncthreads();
    if (tid == 0) {  // the cumsum in one fixed order
      float run = 0.f;
      for (int j = 0; j < q; ++j) {
        run = __fadd_rn(run, __fmul_rn(dts[j], ah));  // no FMA contraction
        cum[j] = run;
      }
    }
    __syncthreads();
    const float last = cum[q - 1];
    if (tid < q) {
      ecum[tid] = expf(cum[tid]);
      wend[tid] = dts[tid] * expf(last - cum[tid]);
    }
    // att[i][j]: masked before the exp, rounded through T
    for (int e = tid; e < Q * Q; e += THREADS) {
      const int i = e / Q, j = e % Q;
      float v = 0.f;
      if (i < q && j <= i) {
        const float* ci = cs_c + i * NP;
        const float* bj = cs_b + j * NP;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc = fmaf(ci[n], bj[n], acc);
        v = repro::round_through<T>(acc * expf(cum[i] - cum[j]) * dts[j]);
      }
      att[i * QP + j] = v;
    }
    __syncthreads();
    // y = att . x + (C . h) * exp(cs), from the state before this chunk
    for (int e = tid; e < Q * PT; e += THREADS) {
      const int i = e / PT, p = e % PT;
      if (i >= q || p >= rows) continue;
      const float* ai = att + i * QP;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(ai[j], xs[j * PT + p], intra);
      const float* ci = cs_c + i * NP;
      const float* hp = hs + p * NP;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ci[n], hp[n], inter);
      yb[(long long)(s0 + i) * sys + p] =
          repro::from_f32<T>(intra + inter * ecum[i]);
    }
    __syncthreads();  // every output has read the old state
    const float decay = expf(last);
    for (int e = tid; e < PT * N; e += THREADS) {
      const int p = e / N, n = e % N;
      if (p >= rows) continue;
      float acc = 0.f;
      for (int j = 0; j < q; ++j)
        acc = fmaf(xs[j * PT + p] * wend[j], cs_b[j * NP + n], acc);
      hs[p * NP + n] = hs[p * NP + n] * decay + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < PT * N; e += THREADS) {
    const int p = e / N, n = e % N;
    if (p < rows) hf[state0 + (long long)p * N + n] = hs[p * NP + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, const void* h0, void* y,
                   void* hf, int B, int S, int H, int P, int N, int Q,
                   long long sxb, long long sxs, long long sxh, long long sdb,
                   long long sds, long long sbb, long long sbs, long long scb,
                   long long scs, cudaStream_t stream) {
  const size_t smem = smem_floats(Q, N) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((P + PT - 1) / PT, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hf), S, H, P, N, Q, sxb, sxs,
      sxh, sdb, sds, sbb, sbs, scb, scs);
  return cudaGetLastError();
}

}  // namespace

namespace ssd_tc {

using namespace hopper;

constexpr int Q = 128;                   // chunk rows: two warpgroups of 64
constexpr int P = 64;                    // head dim: one 128-byte box wide
constexpr int STAGES = 2;                // chunks in flight
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr uint32_t BOX = Q * 64 * 2;     // 128 rows x 64 bf16: 16 KB
constexpr uint32_t HBOX = P * 64 * 2;    // 64 rows x 64 bf16: 8 KB
constexpr unsigned FULL = 0xffffffffu;

// one stage of the ring: C and B (N/64 boxes each) and x (one box)
template <int N>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (2 * (N / 64) + 1) * BOX;
}

template <int N>
__host__ __device__ constexpr uint32_t smem_bytes() {
  // the ring, the hi and lo bf16 tiles of h (N/64 boxes each), four (Q,)
  // fp32 vectors (dt, cs, exp(cs), w), full and empty barriers, and room
  // to align the tiles to 1024 bytes (the swizzle atom)
  return STAGES * stage_bytes<N>() + 2 * (N / 64) * HBOX + 4 * Q * 4 +
         16 * STAGES + 1024;
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// make this thread's shared-memory stores visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of (row, col) in a 128-byte-swizzled tile of 64 bf16 columns
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col * 2) >> 4) ^ (row & 7)) << 4) + ((col * 2) & 15);
}

// v as a hi + lo pair of bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// Block (blockIdx.x, blockIdx.y) = (head, batch).  Consumer thread (warp
// group wg, warp w, lane l) holds, of every m64 fragment, rows
// g = w*16 + l/4 and g + 8 and columns 8c + 2(l%4) (+1).
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_scan_kernel_wgmma(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_b,
                          const __grid_constant__ CUtensorMap map_c,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ h0,
                          __nv_bfloat16* __restrict__ y,
                          float* __restrict__ hf, int S, int H,
                          long long sdb, long long sds) {
  constexpr int NB = N / 64;  // 64-column boxes of C, B and h
  constexpr uint32_t STAGE = stage_bytes<N>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t h_hi = ring + STAGES * STAGE;  // NB boxes of 64 x 64
  const uint32_t h_lo = h_hi + NB * HBOX;
  const uint32_t vecs = h_lo + NB * HBOX;
  const uint32_t full = vecs + 4 * Q * 4;      // STAGES x 8 bytes
  const uint32_t empty = full + 8 * STAGES;    // STAGES x 8 bytes
  // a shared-memory address as a pointer
  auto at_addr = [&](uint32_t addr) { return smem_raw + (addr - raw); };
  float* dts = reinterpret_cast<float*>(at_addr(vecs));  // dt
  float* cs = dts + Q;                         // inclusive cumsum of dt * a
  float* ecs = cs + Q;                         // exp(cs)
  float* wj = ecs + Q;                         // dt * exp(cs_last - cs)

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, bi = blockIdx.y;
  const int chunks = (S + Q - 1) / Q;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: C, B and x of chunk after chunk through the ring
    if (tid == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < chunks; ++t) {
        const uint32_t st = ring + stage * STAGE;
        const uint32_t bar = full + 8 * stage;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(bar, STAGE);
        for (int k = 0; k < NB; ++k) {
          tma_load(st + k * BOX, &map_c, 64 * k, t * Q, bi, bar);
          tma_load(st + (NB + k) * BOX, &map_b, 64 * k, t * Q, bi, bar);
        }
        tma_load(st + 2 * NB * BOX, &map_x, P * hh, t * Q, bi, bar);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = tid / 128;  // chunk rows 64 wg..; state columns 64 wg..
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int i0 = 64 * wg + g;  // this thread's chunk rows: i0 and i0 + 8
  const bool owner = wg < NB;  // holds state columns
  const float ah = a[hh];
  const long long state0 = ((long long)bi * H + hh) * P * N;

  // the state, h[p][64 wg + n] for p = g, g + 8: the n64 accumulator
  // fragment of its own update (value 4c + r: row g + 8 (r >= 2), column
  // 8c + cq + (r & 1))
  float hs[32];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2 v = make_float2(0.f, 0.f);
      if (owner && h0 != nullptr)
        v = *reinterpret_cast<const float2*>(
            h0 + state0 + (long long)(g + 8 * i) * N + 64 * wg + 8 * c + cq);
      hs[4 * c + 2 * i] = v.x;
      hs[4 * c + 2 * i + 1] = v.y;
    }

  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < chunks; ++t) {
    const int s0 = t * Q;
    const int q = min(Q, S - s0);
    // the last chunk's readers of the vectors and of h's tiles are done
    bar_consumers();
    if (tid < 32) {
      // dt and its cumsum in a fixed order: lane l owns rows 4l..4l+3,
      // summed in turn, then the lane totals by a shuffle scan
      float d[4], run = 0.f, cum[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * lane + k;
        d[k] = j < q ? dt[bi * sdb + (long long)(s0 + j) * sds + hh] : 0.f;
        run = __fadd_rn(run, __fmul_rn(d[k], ah));  // no FMA contraction
        cum[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(FULL, tot, o);
        if (lane >= o) tot = __fadd_rn(v, tot);
      }
      float before = __shfl_up_sync(FULL, tot, 1);
      if (lane == 0) before = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cs[4 * lane + k] = __fadd_rn(before, cum[k]);
        dts[4 * lane + k] = d[k];
      }
      __syncwarp();
      const float last = cs[q - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * lane + k;
        ecs[j] = expf(cs[j]);
        wj[j] = d[k] * expf(last - cs[j]);
      }
    }
    // h before this chunk as hi and lo bf16 tiles: rows p, columns n
    // (K-major B of C.h^T), box wg
    if (owner) {
      uint8_t* hi_p = at_addr(h_hi + wg * HBOX);
      uint8_t* lo_p = at_addr(h_lo + wg * HBOX);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t hi, lo;
          split_bf16(hs[4 * c + 2 * i], hs[4 * c + 2 * i + 1], hi, lo);
          const uint32_t off = swz(g + 8 * i, 8 * c + cq);
          *reinterpret_cast<uint32_t*>(hi_p + off) = hi;
          *reinterpret_cast<uint32_t*>(lo_p + off) = lo;
        }
      fence_async_smem();
    }
    bar_consumers();
    mbar_wait(full + 8 * stage, phase);

    const uint32_t c_s = ring + stage * STAGE;
    const uint32_t b_s = c_s + NB * BOX;
    const uint32_t x_s = b_s + NB * BOX;
    // y = C.h^T (this warpgroup's 64 rows x P) over N in k16 steps (32
    // bytes along the swizzled rows, the next box every 4 steps), h as its
    // hi and lo tiles, then scaled per row by exp(cs_i)
    float yv[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) yv[v] = 0.f;
    fence_regs(yv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t da =
          desc(c_s + (kk / 4) * BOX + wg * 64 * 128 + (kk % 4) * 32, 16, 1024);
      const uint32_t off = (kk / 4) * HBOX + (kk % 4) * 32;
      wgmma_ss<64, 0>(yv, da, desc(h_hi + off, 16, 1024), kk > 0 ? 1 : 0);
      wgmma_ss<64, 0>(yv, da, desc(h_lo + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yv);
    const float c_i[2] = {cs[i0], cs[i0 + 8]};
    const float e_i[2] = {ecs[i0], ecs[i0 + 8]};
#pragma unroll
    for (int v = 0; v < 32; ++v) yv[v] *= e_i[(v >> 1) & 1];

    // y += att.x over the keys j in halves of 64: rows 64 wg.. see the
    // halves jh <= wg only.  Per half, C.B^T (64 rows x 64 keys) over N;
    // att masked before the exponent, times dt_j, rounded to bf16 pairs:
    // keys 16k..16k+15 of the fragment are the A fragment of att.x's k-th
    // k16 step; x (rows j, columns p) is an MN-major B, a k16 step two
    // 8-row groups (2048 bytes)
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      if (jh > wg) break;  // warpgroup-uniform
      float cb[32];
#pragma unroll
      for (int v = 0; v < 32; ++v) cb[v] = 0.f;
      fence_regs(cb);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        wgmma_ss<64, 0>(cb, desc(c_s + off + wg * 64 * 128, 16, 1024),
                        desc(b_s + off + jh * 64 * 128, 16, 1024),
                        kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(cb);
      uint32_t at[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 8 * (r & 1);
          const int j = 64 * jh + 16 * k + 8 * (r >> 1) + cq;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = (j + e <= i && j + e < q)
                       ? cb[8 * k + 2 * r + e] *
                             expf(c_i[r & 1] - cs[j + e]) * dts[j + e]
                       : 0.f;
          at[k][r] = pack_bf16(v[0], v[1]);
        }
      fence_regs(yv);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64n64k16_rs<1>(yv, at[k],
                              desc(x_s + 2048 * (4 * jh + k), 1024, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(yv);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i0 + 8 * i >= q) continue;
      __nv_bfloat16* row =
          y + (((long long)bi * S + s0 + i0 + 8 * i) * H + hh) * P + cq;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) =
            __floats2bfloat162_rn(yv[4 * c + 2 * i], yv[4 * c + 2 * i + 1]);
    }

    // h = h * exp(cs_last) + (x * w)^T . B, in two halves of the keys: A
    // rows p = g, g + 8 and, at step k, columns j = 16k + cq (+1, +8, +9)
    // of the x tile times w_j in fp32, as hi and lo bf16; B's chunk (rows
    // j, columns n) an MN-major B
    if (owner) {
      const float decay = expf(cs[q - 1]);
#pragma unroll
      for (int v = 0; v < 32; ++v) hs[v] *= decay;
      const uint8_t* xp = at_addr(x_s);
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int p = g + 8 * (r & 1);
            const int j = 64 * kh + 16 * k + 8 * (r >> 1) + cq;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = j + e < q ? __bfloat162float(
                                     *reinterpret_cast<const __nv_bfloat16*>(
                                         xp + swz(j + e, p))) *
                                     wj[j + e]
                               : 0.f;
            split_bf16(v[0], v[1], ahi[k][r], alo[k][r]);
          }
        fence_regs(hs);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t db =
              desc(b_s + wg * BOX + 2048 * (4 * kh + k), 1024, 1024);
          wgmma_m64n64k16_rs<1>(hs, ahi[k], db, 1);
          wgmma_m64n64k16_rs<1>(hs, alo[k], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(hs);
      }
    }
    // this stage's tiles are read: hand it back to the producer
    mbar_arrive(empty + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (owner) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(hf + state0 + (long long)(g + 8 * i) * N +
                                   64 * wg + 8 * c + cq) =
            make_float2(hs[4 * c + 2 * i], hs[4 * c + 2 * i + 1]);
  }
}

// a bf16 (cols, S, B) view of row stride ld and batch stride bs (elements):
// boxes of 64 columns x 128 rows inside one batch
bool map_rows(CUtensorMap* out, const void* ptr, int cols, int S, int B,
              long long ld, long long bs) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)ld * 2, (uint64_t)bs * 2};
  const uint32_t box[3] = {64, Q, 1};
  return tensor_map(out, ptr, 3, dims, strides, box);
}

template <int N>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, const void* h0, void* y,
                   void* hf, int B, int S, int H, long long sxb, long long sxs,
                   long long sdb, long long sds, long long sbb, long long sbs,
                   long long scb, long long scs, cudaStream_t stream) {
  constexpr uint32_t smem = smem_bytes<N>();
  static_assert(smem <= 232448, "tiles fit one block's shared memory");
  if (encoder() == nullptr)
    return refuse("cuTensorMapEncodeTiled not found in the driver");
  Map mx, mb, mc;
  if (!map_rows(&mx.m, x, H * P, S, B, sxs, sxb) ||
      !map_rows(&mb.m, b, N, S, B, sbs, sbb) ||
      !map_rows(&mc.m, c, N, S, B, scs, scb))
    return refuse("cuTensorMapEncodeTiled refused x, b or c");
  // the opt-in above 48 KB of shared memory, once per device
  static bool ready[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(ssd_scan_kernel_wgmma<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const dim3 grid(H, B);
  ssd_scan_kernel_wgmma<N><<<grid, THREADS, smem, stream>>>(
      mx.m, mb.m, mc.m, static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(hf), S, H, sdb,
      sds);
  return cudaGetLastError();
}

}  // namespace ssd_tc

// Q: chunk length, 1 <= Q <= min(S, 128).  Strides are in elements.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* b, const void* c, const void* h0,
                              void* y, void* hf, int B, int S, int H, int P,
                              int N, int Q, long long sxb, long long sxs,
                              long long sxh, long long sdb, long long sds,
                              long long sbb, long long sbs, long long scb,
                              long long scs, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 ||
      N <= 0 || Q <= 0 || Q > kMaxChunk || Q > S)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, dt, a, b, c, h0, y, hf, B, S, H, P, N, Q, sxb,
                           sxs, sxh, sdb, sds, sbb, sbs, scb, scs, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, dt, a, b, c, h0, y, hf, B, S, H, P, N,
                                   Q, sxb, sxs, sxh, sdb, sds, sbb, sbs, scb,
                                   scs, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// the bf16 wgmma route (kernels/ssd_scan.py:route): P 64, N 64 or 128,
// chunks of 128 or one chunk of S <= 128, x's heads packed (sxh == P), and
// 16-byte aligned x, b and c with row and batch strides of 16 bytes
extern "C" int repro_ssd_scan_wgmma(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* h0, void* y, void* hf, int B, int S, int H,
    int P, int N, int Q, long long sxb, long long sxs, long long sxh,
    long long sdb, long long sds, long long sbb, long long sbs, long long scb,
    long long scs, void* stream) {
  hopper::refusal() = "";
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535)
    return hopper::refuse("shapes: 0 < B <= 65535, S > 0, 0 < H <= 65535");
  if (P != ssd_tc::P || sxh != ssd_tc::P)
    return hopper::refuse("the wgmma route takes P 64 with the heads packed");
  if (!(Q == ssd_tc::Q || (Q == S && S < ssd_tc::Q)))
    return hopper::refuse("the wgmma route takes chunks of 128 or one chunk");
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16 ||
      (sxb | sxs | sbb | sbs | scb | scs) % 8)
    return hopper::refuse("TMA needs 16-byte aligned x, b and c and strides");
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 64:
      return ssd_tc::launch<64>(x, dt, a, b, c, h0, y, hf, B, S, H, sxb, sxs,
                                sdb, sds, sbb, sbs, scb, scs, s);
    case 128:
      return ssd_tc::launch<128>(x, dt, a, b, c, h0, y, hf, B, S, H, sxb,
                                 sxs, sdb, sds, sbb, sbs, scb, scs, s);
    default:
      return hopper::refuse("the wgmma route takes N 64 or 128");
  }
}

// dynamic shared memory of the wgmma route's block at state width N (0:
// none)
extern "C" int repro_ssd_scan_wgmma_smem(int N) {
  return N == 64    ? static_cast<int>(ssd_tc::smem_bytes<64>())
         : N == 128 ? static_cast<int>(ssd_tc::smem_bytes<128>())
                    : 0;
}
