// Weight gradient of the region projection, for Hopper (sm_90a):
//
//   C (Dr, s) float32 = A^T @ B      A = regions (N, Dr), B = d(pregion) (N, s)
//
// Replaces the Pallas TPU kernel tools/probe_dws_gemm.py:dws_kernel (a
// K-streaming GEMM whose grid walks N with the (Dr, s) accumulator held in
// VMEM).  Its plain PyTorch version is stvd_torch/model/kernel.py:_dws_plain.
// In preset-2 training N = B*K*R = 87808, Dr = s = 1024, once per train
// step.
//
// Bound: 2 * 1024 * 87808 * 1024 = 184.5 GFLOP, ~0.19 ms at the bf16
// tensor-core peak (the 360 MB of bf16 operands take ~0.11 ms), so the
// product is compute-bound and only wgmma reaches that rate.
//
// Three routes, chosen by the caller from shapes, dtype and alignment
// (stvd_torch/model/kernel.py:dws_route), each writing per-split float32
// slots that a second launch sums in a fixed order into C: deterministic,
// no atomics (the TPU's sequential grid needed neither).
//
// * wgmma (bf16; Dr, s multiples of 8, 16-byte aligned bases): a 128 x 256
//   tile of C per block, over one N split.  One producer thread streams
//   64-row stages of A and B by TMA (2-D tensor maps, 128-byte swizzle,
//   zero fill past N, Dr and s) into a 4-stage mbarrier ring; two
//   consumer warpgroups each run m64n256k16 wgmma on them, both operands
//   MN-major in shared memory (the transpose bits set), so regions^T is
//   never copied.  128 x 256 tiles x 4 N splits = 128 blocks: one wave on
//   132 SMs.
// * wmma (bf16 otherwise): a 128 x 128 tile of 16 x 16 x 16 wmma fragments
//   over element loads, for ragged widths and unaligned bases.
// * f32: float32 FMA for float32 operands (the parity runs), 8 x 8 outputs
//   per thread in registers over double-buffered shared-memory stages.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at
                    // run time, so the library does not link libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// Route wgmma: TMA + mbarrier ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kTM = 128;                 // Dr rows of C per block
constexpr int kTN = 256;                 // s columns of C per block
constexpr int kTK = 64;                  // N rows per stage
constexpr int kRing = 4;                 // stages
constexpr int kBox = 64;                 // TMA box width: 128 bytes of bf16
constexpr int kBoxBytes = kBox * kTK * 2;             // 8 KB
constexpr int kABytes = kTM / kBox * kBoxBytes;       // 16 KB
constexpr int kStageBytes = kABytes + kTN / kBox * kBoxBytes;   // 48 KB
constexpr int kWgThreads = 384;          // warpgroups 0-1 consume, 2 loads
constexpr int kConsumerWarps = 8;
constexpr size_t kWgSmem = 1024 + kRing * kStageBytes + 2 * kRing * 8;

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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled MN-major operand:
// lbo = bytes between 64-element MN atoms, sbo = bytes between groups of
// 8 K rows (each K row is one 128-byte swizzle row).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// d (64 x 256, this warpgroup's fragment) += A (64 x 16) B (16 x 256),
// both MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_256(float* d, uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kWgThreads, 1)
dws_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 float* __restrict__ part, long long n, long long chunk,
                 int dr, int s) {
  extern __shared__ unsigned char wg_smem[];
  // 128-byte swizzle atoms are 1024 bytes and must start 1024-aligned
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t full = base + kRing * kStageBytes;   // full[kRing]
  const uint32_t empty = full + kRing * 8;            // empty[kRing]
  const int m0 = blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  const long long k_beg = blockIdx.z * chunk;
  const long long k_end = k_beg + chunk < n ? k_beg + chunk : n;
  const int nk = k_end > k_beg
                     ? static_cast<int>((k_end - k_beg + kTK - 1) / kTK) : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + 8 * i, 1);                 // the producer's arrival
      mbar_init(empty + 8 * i, kConsumerWarps);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kRing;
        mbar_wait(empty + 8 * st, ((kt / kRing) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, kStageBytes);
        const uint32_t a_s = base + st * kStageBytes;
        const int k = static_cast<int>(k_beg + 1LL * kt * kTK);
#pragma unroll
        for (int h = 0; h < kTM / kBox; ++h)
          tma_load(a_s + h * kBoxBytes, &map_a, full + 8 * st, m0 + h * kBox,
                   k);
#pragma unroll
        for (int q = 0; q < kTN / kBox; ++q)
          tma_load(a_s + kABytes + q * kBoxBytes, &map_b, full + 8 * st,
                   n0 + q * kBox, k);
      }
    }
  } else {
    // consumer warpgroups 0 and 1: Dr rows m0 + 64 * wg ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    const int lane = threadIdx.x & 31;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % kRing;
      mbar_wait(full + 8 * st, (kt / kRing) & 1);
      const uint32_t a_s = base + st * kStageBytes + wg * kBoxBytes;
      const uint32_t b_s = base + st * kStageBytes + kABytes;
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)   // 16 K rows = 2048 bytes
        wgmma_256(d, sw128_desc(a_s + kk * 2048, kBoxBytes, 1024),
                  sw128_desc(b_s + kk * 2048, kBoxBytes, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's products are done: hand its buffers back
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(d);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kRing));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);

    // fragment layout of m64nNk16: d[4c + 2i + j] is row 16 warp + lane/4
    // + 8i, column 8c + 2 (lane % 4) + j of this warpgroup's 64 x 256
    float* out = part + static_cast<long long>(blockIdx.z) * dr * s;
    const int row0 = m0 + wg * 64 + ((threadIdx.x & 127) >> 5) * 16 +
                     (lane >> 2);
    const int col0 = n0 + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < kTN / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i, col = col0 + 8 * c;
        // s % 8 == 0 and col is even, so col < s covers col + 1
        if (row < dr && col < s)
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * s +
                                     col) =
              make_float2(d[4 * c + 2 * i], d[4 * c + 2 * i + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// Route wmma: 16 x 16 x 16 bf16 fragments, element loads
// ---------------------------------------------------------------------------

constexpr int kBM = 128;              // Dr rows of C per block
constexpr int kBN = 128;              // s columns of C per block
constexpr int kBK = 32;               // N rows per stage
constexpr int kLd = kBM + 8;          // smem row stride (elements)
constexpr int kStages = 3;
constexpr int kEpiLd = kBN + 4;

// One stage: rows [k0, k0 + kBK) of A (cols m0..) and B (cols n0..), each
// stored k-major as (kBK, kLd), zero past N, Dr and s.
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* a_s, __nv_bfloat16* b_s,
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    long long k0, long long k_end, int m0, int n0, int dr, int s) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < 2 * kBK * kBM; e += kThreads) {
    const bool is_b = e >= kBK * kBM;
    const int ee = is_b ? e - kBK * kBM : e;
    const int kr = ee / kBM;
    const int col = ee - kr * kBM;
    const long long gk = k0 + kr;
    const int gc = (is_b ? n0 : m0) + col;
    const int width = is_b ? s : dr;
    const __nv_bfloat16* src = is_b ? b : a;
    (is_b ? b_s : a_s)[kr * kLd + col] =
        gk < k_end && gc < width ? src[gk * width + gc] : zero;
  }
}

// The A tile is kept k-major, which is A^T in column-major order: wmma
// loads it as a col_major matrix_a with no transpose copy.  Stage kt + 2
// is filled while stage kt is multiplied; the barrier at the top of each
// step orders the writes after the last reads of that buffer.
__global__ void __launch_bounds__(kThreads)
dws_mma_kernel(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ b, float* __restrict__ part,
               long long n, long long chunk, int dr, int s) {
  constexpr int kStageEl = 2 * kBK * kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* epi = reinterpret_cast<float*>(smem_raw);

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long k_beg = blockIdx.z * chunk;
  const long long k_end = k_beg + chunk < n ? k_beg + chunk : n;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;   // Dr rows 64*wm ..
  const int wn = warp & 3;    // s cols 32*wn ..

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = k_end > k_beg
                     ? static_cast<int>((k_end - k_beg + kBK - 1) / kBK) : 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) {
      __nv_bfloat16* a_s = ring + st * kStageEl;
      load_stage(a_s, a_s + kBK * kLd, a, b, k_beg + st * kBK, k_end, m0, n0,
                 dr, s);
    }
  }
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      __nv_bfloat16* a_s = ring + (nxt % kStages) * kStageEl;
      load_stage(a_s, a_s + kBK * kLd, a, b, k_beg + nxt * kBK, k_end, m0,
                 n0, dr, s);
    }
    const __nv_bfloat16* a_s = ring + (kt % kStages) * kStageEl;
    const __nv_bfloat16* b_s = a_s + kBK * kLd;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a_s + ks * 16 * kLd + wm * 64 + i * 16,
                               kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b_s + ks * 16 * kLd + wn * 32 + j * 16,
                               kLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(epi + (wm * 64 + i * 16) * kEpiLd + wn * 32 +
                                  j * 16,
                              acc[i][j], kEpiLd, wmma::mem_row_major);
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.z) * dr * s;
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN, c = e - r * kBN;
    if (m0 + r < dr && n0 + c < s)
      out[static_cast<long long>(m0 + r) * s + n0 + c] = epi[r * kEpiLd + c];
  }
}

// ---------------------------------------------------------------------------
// Route f32: a 128 x 128 tile, each thread an 8 x 8 block held in registers
// ---------------------------------------------------------------------------

constexpr int kFB = 128;   // Dr rows and s columns of C per block
constexpr int kFK = 8;     // N rows per stage

// Rows [k0, k0 + kFK) of a (width cols from c0) into registers: thread t
// takes row t / 32, columns 4 (t % 32) ..; zeros past k_end and width.
template <bool kVec>
__device__ __forceinline__ float4 load_f32(const float* __restrict__ a,
                                           long long k0, long long k_end,
                                           int c0, int width) {
  const int kr = threadIdx.x >> 5;
  const int col = c0 + 4 * (threadIdx.x & 31);
  const long long gk = k0 + kr;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (gk >= k_end) return v;
  const float* p = a + gk * width + col;
  if constexpr (kVec) {   // width % 4 == 0: the 4 columns are all in or out
    if (col < width) v = *reinterpret_cast<const float4*>(p);
  } else {
    if (col < width) v.x = p[0];
    if (col + 1 < width) v.y = p[1];
    if (col + 2 < width) v.z = p[2];
    if (col + 3 < width) v.w = p[3];
  }
  return v;
}

// Thread (ty, tx) of 16 x 16 owns rows 4 ty + {0..3} and 64 + 4 ty + {0..3},
// columns likewise from tx (two float4 reads of each stage row, no bank
// conflicts).  Stages are double-buffered: the next one is read into
// registers while this one is multiplied, then stored to the other buffer.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dws_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ part, long long n, long long chunk, int dr,
               int s) {
  __shared__ __align__(16) float a_s[2][kFK][kFB];
  __shared__ __align__(16) float b_s[2][kFK][kFB];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * kFB;
  const int n0 = blockIdx.y * kFB;
  const long long k_beg = blockIdx.z * chunk;
  const long long k_end = k_beg + chunk < n ? k_beg + chunk : n;
  const int kr = threadIdx.x >> 5, kc = 4 * (threadIdx.x & 31);
  float acc[8][8] = {};
  if (k_beg < k_end) {
    *reinterpret_cast<float4*>(&a_s[0][kr][kc]) =
        load_f32<kVec>(a, k_beg, k_end, m0, dr);
    *reinterpret_cast<float4*>(&b_s[0][kr][kc]) =
        load_f32<kVec>(b, k_beg, k_end, n0, s);
  }
  __syncthreads();
  int buf = 0;
  for (long long k0 = k_beg; k0 < k_end; k0 += kFK) {
    const bool more = k0 + kFK < k_end;
    float4 na, nb;
    if (more) {
      na = load_f32<kVec>(a, k0 + kFK, k_end, m0, dr);
      nb = load_f32<kVec>(b, k0 + kFK, k_end, n0, s);
    }
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[8], bv[8];
      *reinterpret_cast<float4*>(av) =
          *reinterpret_cast<const float4*>(&a_s[buf][kk][4 * ty]);
      *reinterpret_cast<float4*>(av + 4) =
          *reinterpret_cast<const float4*>(&a_s[buf][kk][64 + 4 * ty]);
      *reinterpret_cast<float4*>(bv) =
          *reinterpret_cast<const float4*>(&b_s[buf][kk][4 * tx]);
      *reinterpret_cast<float4*>(bv + 4) =
          *reinterpret_cast<const float4*>(&b_s[buf][kk][64 + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      // the other buffer was last read before the previous barrier
      *reinterpret_cast<float4*>(&a_s[buf ^ 1][kr][kc]) = na;
      *reinterpret_cast<float4*>(&b_s[buf ^ 1][kr][kc]) = nb;
    }
    __syncthreads();
    buf ^= 1;
  }
  float* out = part + static_cast<long long>(blockIdx.z) * dr * s;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = m0 + (i < 4 ? 4 * ty + i : 60 + 4 * ty + i);
      const int c = n0 + (j < 4 ? 4 * tx + j : 60 + 4 * tx + j);
      if (r < dr && c < s) out[static_cast<long long>(r) * s + c] = acc[i][j];
    }
}

// c[i] = sum over the splits of part[split][i], in split order
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ c, long long size,
                                     int splits) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= size) return;
  float v = 0.f;
  for (int sp = 0; sp < splits; ++sp) v += part[sp * size + i];
  c[i] = v;
}

// Route numbers shared with stvd_torch/model/kernel.py:DWS_ROUTES.
enum Route { kRouteWgmma = 0, kRouteMma = 1, kRouteF32 = 2 };

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (the CUDA library the runtime loaded provides it).
EncodeTiled encoder() {
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
    if (e == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, width) row-major bf16 tensor read in (kBox, kTK) boxes with
// 128-byte swizzle; reads past its edges fill zeros.
bool encode_map(CUtensorMap* map, const void* ptr, long long rows,
                int width) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(width) * 2};
  const cuuint32_t box[2] = {kBox, kTK};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const void* a, const void* b, float* part,
                         long long n, long long chunk, int splits, int dr,
                         int s, cudaStream_t st) {
  CUtensorMap map_a, map_b;
  if (!encode_map(&map_a, a, n, dr) || !encode_map(&map_b, b, n, s))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      dws_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid((dr + kTM - 1) / kTM, (s + kTN - 1) / kTN, splits);
  dws_wgmma_kernel<<<grid, kWgThreads, kWgSmem, st>>>(map_a, map_b, part, n,
                                                      chunk, dr, s);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* a, const void* b, float* part, long long n,
                       long long chunk, int splits, int dr, int s,
                       cudaStream_t st) {
  constexpr size_t ring =
      static_cast<size_t>(kStages) * 2 * kBK * kLd * sizeof(__nv_bfloat16);
  constexpr size_t epi = static_cast<size_t>(kBM) * kEpiLd * sizeof(float);
  constexpr size_t smem = ring > epi ? ring : epi;
  const cudaError_t e = cudaFuncSetAttribute(
      dws_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((dr + kBM - 1) / kBM, (s + kBN - 1) / kBN, splits);
  dws_mma_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), part, n, chunk, dr, s);
  return cudaGetLastError();
}

}  // namespace

// Number of N splits the launch uses for these sizes and route (the caller
// sizes the float32 scratch as splits * dr * s): as many as fit one wave
// of blocks on the card's SMs, at least one.
extern "C" int stvd_dws_splits(long long n, int dr, int s, int route) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int tm, tn, step, per_sm;
  if (route == kRouteWgmma) {
    tm = kTM, tn = kTN, step = kTK, per_sm = 1;
  } else if (route == kRouteMma) {
    tm = kBM, tn = kBN, step = kBK, per_sm = 2;
  } else {
    tm = kFB, tn = kFB, step = kFK, per_sm = 2;
  }
  const long long tiles =
      static_cast<long long>((dr + tm - 1) / tm) * ((s + tn - 1) / tn);
  // one wave: wgmma blocks fill an SM each, the others two to an SM
  long long splits = per_sm * sms / tiles;
  const long long max_by_n = (n + 4 * step - 1) / (4 * step);
  if (splits > max_by_n) splits = max_by_n;
  if (splits > 64) splits = 64;
  return splits < 1 ? 1 : static_cast<int>(splits);
}

// route: kRouteWgmma / kRouteMma take bf16 operands, kRouteF32 float32.
// part: float32 scratch of splits * dr * s; c: the (dr, s) float32 result.
// Returns the launches' cudaError_t (0 on success).
extern "C" int stvd_dws_gemm(const void* a, const void* b, int route,
                             void* part, void* c, long long n, int dr, int s,
                             int splits, void* stream) {
  if (n < 1 || dr < 1 || s < 1 || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma &&
      (dr % 8 != 0 || s % 8 != 0 || !aligned16(a) || !aligned16(b) ||
       n > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int step = route == kRouteWgmma ? kTK : route == kRouteMma ? kBK : kFK;
  long long chunk = (n + splits - 1) / splits;
  chunk = (chunk + step - 1) / step * step;
  float* pf = static_cast<float*>(part);
  cudaError_t e;
  if (route == kRouteWgmma) {
    e = launch_wgmma(a, b, pf, n, chunk, splits, dr, s, st);
  } else if (route == kRouteMma) {
    e = launch_mma(a, b, pf, n, chunk, splits, dr, s, st);
  } else if (route == kRouteF32) {
    const dim3 grid((dr + kFB - 1) / kFB, (s + kFB - 1) / kFB, splits);
    const float* af = static_cast<const float*>(a);
    const float* bf = static_cast<const float*>(b);
    if (dr % 4 == 0 && s % 4 == 0 && aligned16(a) && aligned16(b))
      dws_f32_kernel<true><<<grid, kThreads, 0, st>>>(af, bf, pf, n, chunk,
                                                      dr, s);
    else
      dws_f32_kernel<false><<<grid, kThreads, 0, st>>>(af, bf, pf, n, chunk,
                                                       dr, s);
    e = cudaGetLastError();
  } else {
    e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long size = static_cast<long long>(dr) * s;
  reduce_splits_kernel<<<static_cast<unsigned>((size + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, st>>>(pf, static_cast<float*>(c), size,
                                            splits);
  return static_cast<int>(cudaGetLastError());
}
