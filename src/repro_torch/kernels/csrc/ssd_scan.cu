// K4: Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py:ssd_scan (_kernel)
// and computes what it computes: for each (batch, head) the chunks of the
// sequence are scanned in order with the state h (P x N, fp32) kept on
// chip.  For a chunk of q positions, with da = dt * a and cs its inclusive
// cumsum (fp32, summed in order by one thread):
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
// (B,H,P,N) fp32 are contiguous.  The D-skip stays with the caller.
//
// Design: one block of 256 threads owns one (batch, head, tile of PT = 16
// state rows).  The rows of h evolve independently (y[:, p] needs only
// h[p, :] and x[:, p]), so splitting P changes no result and gives
// B x H x P/16 blocks: 96 for one mamba2-130m admission (H 24, P 64) on
// the 132 SMs, where one block per head would give 24.  Each chunk is
// staged in shared memory as fp32: C and B (Q x N, rows padded to N + 1
// so neighbouring threads hit different banks), the Q x Q weights, the
// x tile and the 16 state rows, 216 KB at Q = N = 128, so one block per
// SM.  The weights depend on the head but not on P, so the four blocks of
// a head recompute them: the price of the wider grid.  A last chunk
// shorter than Q, and any P and N, are masked here (the Pallas kernel
// asserts S % chunk == 0).
//
// Fixed order, no atomics: every output element and every state element
// is summed by one thread over n, then j, in ascending order, and nothing
// is split across blocks, so a row's result never depends on the batch.
//
// What bounds it on the serving path (H100 SXM, 3.35 TB/s, 989 TFLOP/s
// bf16): one mamba2-130m admission call (B 1, S 256 in 2 chunks of 128,
// H 24, P 64, N 128, bf16) moves ~3.3 MB (x and y 0.79 MB each, b and c
// 0.07 MB each, dt 0.02 MB, h0 in and h_final out 0.79 MB each in fp32):
// ~0.99 us of memory time, against ~0.26 GFLOP, ~0.27 us at the tensor-core
// peak, so bytes bound it and the bound is below one launch's overhead.
// This first version multiplies on CUDA cores from shared memory, one FMA
// at a time; wgmma tiles for C.B^T, att.x and the state update, and one
// C.B^T per chunk shared by the blocks of all heads, are later work
// (PERF.md has its time against the bound).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
