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

#include <cuda_bf16.h>
#include <mma.h>

#include "hopper.cuh"

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

  ring_init(full, kRing, kConsumerWarps);
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one thread issues every TMA load
    producer_regs();
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
    consumer_regs();
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
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)   // 16 K rows = 2048 bytes
        wgmma_bf16_256<1, 1>(d, sw128_desc(a_s + kk * 2048, kBoxBytes, 1024),
                             sw128_desc(b_s + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kRing));
    }
    wgmma_wait<0>();
    fence_acc(d);

    // fragment layout of m64nNk16: d[4c + 2i + j] is row 16 warp + lane/4
    // + 8i, column 8 * c + 2 (lane % 4) + j of this warpgroup's 64 x 256
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

// A (rows, width) row-major bf16 tensor read in (kBox, kTK) boxes
bool encode_operand(CUtensorMap* map, const void* ptr, long long rows,
                    int width) {
  return encode_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rows, width,
                    kBox, kTK);
}

cudaError_t launch_wgmma(const void* a, const void* b, float* part,
                         long long n, long long chunk, int splits, int dr,
                         int s, cudaStream_t st) {
  CUtensorMap map_a, map_b;
  if (!encode_operand(&map_a, a, n, dr) ||
      !encode_operand(&map_b, b, n, s))
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
  const int sms = num_sms();
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
