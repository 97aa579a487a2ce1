// Hopper (sm_90a) building blocks shared by the port's wgmma kernels (the
// dWs_att GEMM, dws_gemm.cu; the fused logit tail, logit_tail.cu; the fused
// gates+LSTM step, gates_lstm.cu) and its TMA attention cores (attn_core.cu,
// spatial_core.cu).
//
// * mbarrier helpers for a ring of shared-memory stages: one producer
//   thread arms a stage's "full" barrier with the bytes it expects, TMA
//   completes it; consumer warps arrive on its "empty" barrier when they
//   are done with it.  A wait that never completes traps after 2^26 tries,
//   so a fault in the ring's phases fails the launch instead of hanging
//   the card.
// * tma_load: one 2-D box of a tensor map into shared memory; bulk_load:
//   one contiguous 1-D span (cp.async.bulk), completing on an mbarrier;
//   prefetch_l2: a contiguous span into L2 without waiting for it.
// * sw128_desc / sw64_desc: the wgmma shared-memory descriptor of a
//   128- or 64-byte-swizzled operand, K-major or MN-major (the caller
//   passes the strides).
// * wgmma_bf16_256 / wgmma_bf16_128 / wgmma_s8_256: one m64n256 or
//   m64n128 product of a warpgroup (bf16 k16 with float32 sums, transpose
//   bits as template arguments; s8 k32 with int32 sums, both operands
//   K-major as the PTX requires).
// * encode_map: a 2-D tensor map (rows at any stride of whole 16 bytes)
//   with a 128-byte (or 64-byte) swizzle and
//   zero fill past the edges, encoded through cuTensorMapEncodeTiled
//   fetched from the CUDA runtime's entry-point query, so the library does
//   not link libcuda.
// * allow_smem: a kernel's dynamic shared-memory limit, raised once per
//   device rather than on every launch.
//
// Everything is in an anonymous namespace: each source that includes this
// header gets its own copy.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.  A wait that
// never completes (a fault in the ring's phases) traps, so the launch
// fails instead of hanging the card; a real wait lasts microseconds.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 26)) __trap();
  }
}

// Thread 0 makes `stages` full/empty barrier pairs at `full` (full[i] at
// full + 8 i, empty[i] at full + 8 (stages + i)): full completes on the
// producer's arrival plus its bytes, empty on one arrival per consumer
// warp.  The caller synchronises the block afterwards.
__device__ __forceinline__ void ring_init(uint32_t full, int stages,
                                          int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(full + 8 * (stages + i), consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16, below 2^20) from 16-byte aligned global
// memory to 16-byte aligned shared memory, counted on `bar`'s transaction
// bytes (the caller arms it with mbar_expect_tx).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Ask L2 for `bytes` (a multiple of 16) at 16-byte aligned `src`.
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}

// Order this thread's earlier shared-memory accesses (made through the
// generic proxy) before later TMA writes into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand whose
// swizzle atoms start 1024-byte aligned.  MN-major: lbo = bytes between
// 64-element MN atoms (one TMA box), sbo = bytes between groups of 8 K
// rows (1024), and a k16 step advances the address by 16 rows (2048
// bytes).  K-major: each row of the tile is one 128-byte swizzle row,
// sbo = bytes between groups of 8 rows (1024), lbo unused (16), and a
// k step advances the address by its 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// The same for a 64-byte swizzle (layout type 2), whose atoms are 8 rows
// of 64 bytes starting 512-byte aligned.  MN-major: lbo = bytes between
// 32-element MN atoms (one TMA box), sbo = bytes between groups of 8 K
// rows (512), and a k16 step advances the address by 16 rows (1024 bytes).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 2ull << 62;
}

#define STVD_WG_REGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "      \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "      \
  "%122, %123, %124, %125, %126, %127}"
#define STVD_WG_REGS64                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define STVD_WG_8(C, d, i)                                                \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define STVD_WG_128(C, d)                                                  \
  STVD_WG_8(C, d, 0), STVD_WG_8(C, d, 8), STVD_WG_8(C, d, 16),             \
      STVD_WG_8(C, d, 24), STVD_WG_8(C, d, 32), STVD_WG_8(C, d, 40),       \
      STVD_WG_8(C, d, 48), STVD_WG_8(C, d, 56), STVD_WG_8(C, d, 64),       \
      STVD_WG_8(C, d, 72), STVD_WG_8(C, d, 80), STVD_WG_8(C, d, 88),       \
      STVD_WG_8(C, d, 96), STVD_WG_8(C, d, 104), STVD_WG_8(C, d, 112),     \
      STVD_WG_8(C, d, 120)
#define STVD_WG_64(C, d)                                                   \
  STVD_WG_8(C, d, 0), STVD_WG_8(C, d, 8), STVD_WG_8(C, d, 16),             \
      STVD_WG_8(C, d, 24), STVD_WG_8(C, d, 32), STVD_WG_8(C, d, 40),       \
      STVD_WG_8(C, d, 48), STVD_WG_8(C, d, 56)
#define STVD_WG_F(x) "+f"(x)
#define STVD_WG_S(x) "+r"(x)

// d (64 x 256, this warpgroup's fragment) += A (64 x 16) B (16 x 256),
// bf16 operands in shared memory; kTA / kTB = 1 for an MN-major operand.
// Fragment layout of m64nN: d[4c + 2i + j] is row 16 (warp % 4) +
// lane / 4 + 8 i, column 8 c + 2 (lane % 4) + j.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16_256(float* d, uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " STVD_WG_REGS
      ", %128, %129, p, 1, 1, %131, %132;\n}\n"
      : STVD_WG_128(STVD_WG_F, d)
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTA), "n"(kTB));
}

// d (64 x 128, this warpgroup's fragment) += A (64 x 16) B (16 x 128),
// bf16 operands in shared memory, with the fragment layout above (c < 16).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16_128(float* d, uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " STVD_WG_REGS64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : STVD_WG_64(STVD_WG_F, d)
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTA), "n"(kTB));
}

// d (64 x 256 int32) += A (64 x 32) B (32 x 256), s8 operands, both
// K-major in shared memory (wgmma has no transpose for 8-bit types).
__device__ __forceinline__ void wgmma_s8_256(int* d, uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " STVD_WG_REGS
      ", %128, %129, p;\n}\n"
      : STVD_WG_128(STVD_WG_S, d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef STVD_WG_REGS
#undef STVD_WG_REGS64
#undef STVD_WG_8
#undef STVD_WG_64
#undef STVD_WG_128
#undef STVD_WG_F
#undef STVD_WG_S

// Keep the compiler from moving the N accumulators' reads or writes
// across the asynchronous products.
template <int N = 128>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N = 128>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// Register split of a warp-specialised block: the producer warpgroup
// gives registers up, the consumer warpgroups take them.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

constexpr size_t kSmemLimit = 232448;   // 227 KB, the most a block may use
constexpr int kMaxDevices = 64;

// Raises kernel `kern`'s dynamic shared memory limit to at least `smem` on
// the current device.  `allowed` (one array per kernel, zero at load)
// keeps the limit set so far on each device, so a launch calls
// cudaFuncSetAttribute only the first time it needs more there, not on
// every launch of a kernel that runs for tens of microseconds.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem,
                       std::atomic<int> (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int want = static_cast<int>(smem);
  if (dev >= kMaxDevices)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
  if (allowed[dev].load(std::memory_order_acquire) >= want) return cudaSuccess;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  if (allowed[dev].load(std::memory_order_relaxed) >= want) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           want);
  if (e == cudaSuccess) allowed[dev].store(want, std::memory_order_release);
  return e;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

inline int num_sms() {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (the CUDA library the runtime loaded provides it).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, width) tensor read in boxes of box_rows rows x
// box_width elements with 128-byte swizzle (box_width elements must be
// 128 bytes; with CU_TENSOR_MAP_SWIZZLE_64B, 64 bytes); reads past its
// edges (column width and row rows) fill zeros.  type is bf16 or uint8
// (int8 bits).  Rows are ld elements apart (0: width, a dense tensor):
// ld * element bytes must be a multiple of 16 and the base 16-byte
// aligned, so a width off the 16-byte grid is described by a buffer
// whose rows are padded to it, the map keeping the logical width.
inline bool encode_map(
    CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
    long long rows, long long width, int box_width, int box_rows,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
    long long ld = 0) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int elem = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {
      static_cast<cuuint64_t>(ld > 0 ? ld : width) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_width),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
