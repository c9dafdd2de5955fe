// Shared Hopper (sm_90a) primitives of the port's tensor-core kernels (K1,
// K2, K3): mbarrier rings, TMA loads, wgmma descriptors and instructions,
// and the host-side tensor-map encoder.  Everything here is either inlined
// device code or an inline host function, so any number of sources may
// include it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make barrier initialisation visible to the async proxy (TMA) and the
// other threads; call before the block's first __syncthreads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// wait for the phase of parity ``parity`` to complete; a wait of more than
// ~2^32 cycles (over a second) can only be a fault, and traps rather than
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start < 0)
      start = clock64();
    else if (clock64() - start > (1ll << 32))
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// 2-D TMA load of one box at (c0 innermost, c1) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 3-D TMA load of one box at (c0 innermost, c1, c2): a box never crosses
// the outermost index (a head, an expert), and TMA zero-fills what lies
// past the ragged edge of c0 and c1
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.  K-major tiles: the stride
// offset steps 8-row groups (1024 bytes for 128-byte rows).  MN-major tiles:
// the stride offset steps 8-row groups of K, the leading offset 64-element
// atoms of M or N (unused where M or N is 64)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x n, fp32) += A (64 x 16, from a descriptor) . B (16 x n, from a
// descriptor); TRANS_A 1: A is MN-major in shared memory; TRANS_B 1: B is
// MN-major (n contiguous; bf16 takes either); scale_d 0 overwrites d.
// Accumulator fragment: value 4c + r of thread (warp w, lane l) is row
// w*16 + l/4 (+8 for r >= 2) and column 8c + 2(l%4) (+1 for odd r)
template <int TRANS_A, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A),
        "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A),
        "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A),
        "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[24], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A),
        "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A),
        "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// the same with N a template argument (8, 16, 32, 48, 64, 128)
template <int N, int TRANS_A, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 8)
    wgmma_m64n8k16<TRANS_A, TRANS_B>(d, da, db, scale_d);
  else if constexpr (N == 16)
    wgmma_m64n16k16<TRANS_A, TRANS_B>(d, da, db, scale_d);
  else if constexpr (N == 32)
    wgmma_m64n32k16<TRANS_A, TRANS_B>(d, da, db, scale_d);
  else if constexpr (N == 48)
    wgmma_m64n48k16<TRANS_A, TRANS_B>(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_m64n64k16<TRANS_A, TRANS_B>(d, da, db, scale_d);
  else
    wgmma_m64n128k16<TRANS_A, TRANS_B>(d, da, db, scale_d);
}

// hand registers from one warpgroup to another (sm_90a): a warp-specialised
// kernel launched with more threads than its consumers' registers allow
// lowers its producer warpgroup's budget and raises its consumers'.  Every
// warp of the warpgroup executes it, and the branches that follow must not
// reconverge, or ptxas ignores it (warning C7508)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  static_assert(N >= 24 && N <= 256 && N % 8 == 0, "a multiple of 8");
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  static_assert(N >= 24 && N <= 256 && N % 8 == 0, "a multiple of 8");
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// why this thread's last call of a tensor-core route refused its operands
// ("" if it did not): each C entry clears it, repro_refusal() reads it
inline const char*& refusal() {
  static thread_local const char* why = "";
  return why;
}

inline cudaError_t refuse(const char* why) {
  refusal() = why;
  return cudaErrorInvalidValue;
}

// two fp32 values as one register of two bf16, the first in the low half
// (the element of the lower column in a wgmma A fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// tensor maps, encoded on the host through the driver entry point (no
// -lcuda), cached by everything they encode: a map is a pure function of
// (pointer, dims, strides, box), so a hit is always the right map
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

struct MapKey {
  uint64_t ptr, rank, dims[3], strides[2], box[3];
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || rank != o.rank) return false;
    for (int i = 0; i < 3; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i]) return false;
    return strides[0] == o.strides[0] && strides[1] == o.strides[1];
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = k.ptr;
    for (uint64_t v : {k.rank, k.dims[0], k.dims[1], k.dims[2], k.strides[0],
                       k.strides[1], k.box[0], k.box[1], k.box[2]})
      h = (h ^ v) * 0x100000001b3ull;
    return static_cast<size_t>(h);
  }
};
struct Map {
  alignas(64) CUtensorMap m;
};

// a bf16 tensor map of rank 2 or 3: ``dims`` innermost first, ``strides``
// the byte strides of dims 1.., ``box`` innermost first with 64 elements
// (128 bytes, swizzled) innermost; out-of-range elements read as zero
inline bool tensor_map(CUtensorMap* out, const void* ptr, int rank,
                       const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box) {
  // ctypes calls release the GIL: threads may meet here
  static std::mutex lock;
  static std::unordered_map<MapKey, Map, MapKeyHash> cache;
  const std::lock_guard<std::mutex> hold(lock);
  MapKey key{reinterpret_cast<uint64_t>(ptr), static_cast<uint64_t>(rank),
             {0, 0, 0}, {0, 0}, {0, 0, 0}};
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i > 0) key.strides[i - 1] = strides[i - 1];
  }
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second.m;
    return true;
  }
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  // cuTensorMapEncodeTiled works in the calling thread's context, and a
  // thread that has launched nothing yet may have none current
  // (PyTorch's autograd worker, which runs the gradients' products):
  // bind the device's primary context first
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaSetDevice(device) != cudaSuccess)
    return false;
  if (cache.size() >= 4096) cache.clear();
  Map map;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3];
  const cuuint32_t elem[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i > 0) s[i - 1] = strides[i - 1];
  }
  if (encode(&map.m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), d, s, b,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache.emplace(key, map);
  *out = map.m;
  return true;
}

// K1's operands: a (rows, D) bf16 slab per head, heads outermost, read
// in boxes of 64 rows x 64 columns, so a box never crosses a head and rows
// past ``rows`` read as zero
inline bool map_heads(CUtensorMap* out, const void* ptr, int heads, int rows,
                      int D) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)rows, (uint64_t)heads};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)rows * D * 2};
  const uint32_t box[3] = {64, 64, 1};
  return tensor_map(out, ptr, 3, dims, strides, box);
}

// K3's operands: a bf16 (E, rows, cols) stack, experts outermost, in
// boxes of box_rows x 64, so a box never crosses an expert and rows past
// ``rows`` read as zero
inline bool map_stack(CUtensorMap* out, const void* ptr, int E, int rows,
                      int cols, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)E};
  const uint64_t strides[2] = {(uint64_t)cols * 2,
                               (uint64_t)rows * cols * 2};
  const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
  return tensor_map(out, ptr, 3, dims, strides, box);
}

// the opt-in above 48 KB of dynamic shared memory for ``kern``, once per
// device (``ready``: one flag a device, kept by the caller per kernel)
inline cudaError_t opt_in_smem(const void* kern, uint32_t smem,
                               bool (&ready)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  return cudaSuccess;
}

}  // namespace hopper
