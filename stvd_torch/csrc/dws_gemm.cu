// Weight gradient of the region projection, for Hopper (sm_90a):
//
//   C (Dr, s) float32 = A^T @ B      A = regions (N, Dr), B = d(pregion) (N, s)
//
// Replaces the Pallas TPU kernel tools/probe_dws_gemm.py:dws_kernel (a
// K-streaming GEMM whose grid walks N with the (Dr, s) accumulator held in
// VMEM).  Its plain PyTorch version is stvd_torch/model/kernel.py:_dws_plain.
// bf16 operands take wmma bf16 -> f32; float32 operands take an exact FMA
// path.  In preset-2 training N = B*K*R = 87808, Dr = s = 1024, once per
// train step.
//
// Design: the output is only 1024 x 1024, i.e. 64 tiles of 128 x 128, too
// few to fill 132 SMs, so the grid also splits N.  Each block walks its
// share of N through a 3-stage cp.async ring (A tile kept k-major, which
// is A^T in column-major order: wmma loads it as a col_major matrix_a with
// no transpose copy), holds its 128 x 128 float32 tile in 8 warps' wmma
// accumulators and writes it to a per-split slot.  A second launch sums
// the splits in a fixed order into C: deterministic, no atomics (the
// TPU's sequential grid needed neither).  Ragged N, Dr and s are
// zero-filled; widths that are not whole 16-byte chunks take element loads.
//
// Bound: 2 * 1024 * 87808 * 1024 = 184.5 GFLOP, ~0.19 ms at the bf16
// tensor-core peak (the 360 MB of bf16 operands take ~0.11 ms).  wmma
// without wgmma/TMA reaches a fraction of that peak in this first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;              // Dr rows of C per block
constexpr int kBN = 128;              // s columns of C per block
constexpr int kBK = 32;               // N rows per stage
constexpr int kLd = kBM + 8;          // smem row stride (elements)
constexpr int kThreads = 256;         // 8 warps: 2 (Dr) x 4 (s)
constexpr int kStages = 3;
constexpr int kEpiLd = kBN + 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage: rows [k0, k0 + kBK) of A (cols m0..) and B (cols n0..), each
// stored k-major as (kBK, kLd).
template <bool kVec>
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* a_s, __nv_bfloat16* b_s,
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    long long k0, long long k_end, int m0, int n0, int dr, int s) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kCh = kBM / 8;   // 16-byte chunks per tile row
    for (int c = tid; c < 2 * kBK * kCh; c += kThreads) {
      const bool is_b = c >= kBK * kCh;
      const int cc = is_b ? c - kBK * kCh : c;
      const int kr = cc / kCh;
      const int col = (cc - kr * kCh) * 8;
      const long long gk = k0 + kr;
      const int gc = (is_b ? n0 : m0) + col;
      const int width = is_b ? s : dr;
      const bool ok = gk < k_end && gc < width;
      const __nv_bfloat16* src = is_b ? b : a;
      cp_async16((is_b ? b_s : a_s) + kr * kLd + col,
                 ok ? src + gk * width + gc : src, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < 2 * kBK * kBM; e += kThreads) {
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
}

template <bool kVec>
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
      load_stage<kVec>(a_s, a_s + kBK * kLd, a, b, k_beg + st * kBK, k_end,
                       m0, n0, dr, s);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      __nv_bfloat16* a_s = ring + (nxt % kStages) * kStageEl;
      load_stage<kVec>(a_s, a_s + kBK * kLd, a, b, k_beg + nxt * kBK, k_end,
                       m0, n0, dr, s);
    }
    cp_async_commit();
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
  cp_async_wait<0>();
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

// float32: thread (ty, tx) of a 64 x 64 tile owns a 4 x 4 block.
constexpr int kFB = 64;
constexpr int kFK = 16;

__global__ void __launch_bounds__(kThreads)
dws_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ part, long long n, long long chunk, int dr,
               int s) {
  __shared__ float a_s[kFK][kFB];
  __shared__ float b_s[kFK][kFB];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * kFB;
  const int n0 = blockIdx.y * kFB;
  const long long k_beg = blockIdx.z * chunk;
  const long long k_end = k_beg + chunk < n ? k_beg + chunk : n;
  float acc[4][4] = {};
  for (long long k0 = k_beg; k0 < k_end; k0 += kFK) {
    for (int e = threadIdx.x; e < kFK * kFB; e += kThreads) {
      const int kr = e / kFB, c = e - kr * kFB;
      const long long gk = k0 + kr;
      a_s[kr][c] = gk < k_end && m0 + c < dr ? a[gk * dr + m0 + c] : 0.f;
      b_s[kr][c] = gk < k_end && n0 + c < s ? b[gk * s + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.z) * dr * s;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
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

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <bool kVec>
cudaError_t launch_mma(const void* a, const void* b, float* part, long long n,
                       long long chunk, int splits, int dr, int s,
                       cudaStream_t st) {
  constexpr size_t ring =
      static_cast<size_t>(kStages) * 2 * kBK * kLd * sizeof(__nv_bfloat16);
  constexpr size_t epi = static_cast<size_t>(kBM) * kEpiLd * sizeof(float);
  constexpr size_t smem = ring > epi ? ring : epi;
  const cudaError_t e = cudaFuncSetAttribute(
      dws_mma_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((dr + kBM - 1) / kBM, (s + kBN - 1) / kBN, splits);
  dws_mma_kernel<kVec><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), part, n, chunk, dr, s);
  return cudaGetLastError();
}

}  // namespace

// Number of N splits the launch uses for these sizes (the caller sizes the
// float32 scratch as splits * dr * s): about two blocks per SM in all.
extern "C" int stvd_dws_splits(long long n, int dr, int s, int bf16) {
  const int tile = bf16 ? kBM : kFB;
  const long long tiles =
      static_cast<long long>((dr + tile - 1) / tile) * ((s + tile - 1) / tile);
  long long splits = (264 + tiles - 1) / tiles;
  const long long max_by_n = (n + 4 * kBK - 1) / (4 * kBK);
  if (splits > max_by_n) splits = max_by_n;
  if (splits > 64) splits = 64;
  return splits < 1 ? 1 : static_cast<int>(splits);
}

// bf16: operands bf16 (else float32).  part: float32 scratch of
// splits * dr * s; c: the (dr, s) float32 result.  Returns the launches'
// cudaError_t (0 on success).
extern "C" int stvd_dws_gemm(const void* a, const void* b, int bf16,
                             void* part, void* c, long long n, int dr, int s,
                             int splits, void* stream) {
  if (n < 1 || dr < 1 || s < 1 || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int step = bf16 ? kBK : kFK;
  long long chunk = (n + splits - 1) / splits;
  chunk = (chunk + step - 1) / step * step;
  float* pf = static_cast<float*>(part);
  cudaError_t e;
  if (bf16) {
    const bool vec = dr % 8 == 0 && s % 8 == 0 && aligned16(a) && aligned16(b);
    e = vec ? launch_mma<true>(a, b, pf, n, chunk, splits, dr, s, st)
            : launch_mma<false>(a, b, pf, n, chunk, splits, dr, s, st);
  } else {
    const dim3 grid((dr + kFB - 1) / kFB, (s + kFB - 1) / kFB, splits);
    dws_f32_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(a),
                                              static_cast<const float*>(b), pf,
                                              n, chunk, dr, s);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long size = static_cast<long long>(dr) * s;
  reduce_splits_kernel<<<static_cast<unsigned>((size + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, st>>>(pf, static_cast<float*>(c), size,
                                            splits);
  return static_cast<int>(cudaGetLastError());
}
