// Spatial-attention core of the preset-2 decode step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stvd/model/kernel.py:_spatial_kernel
// (pallas_call in _spatial_pallas_call).  Same contract as that call, with
// the plain PyTorch version in stvd_torch/model/step.py:_spatial_core:
//
//   e      = tanh(pregion[b, k, r, :] + h_satt[b*nb + j, :])      per beam j
//   score  = e . u_s + c_s
//   alpha  = softmax over the R regions of frame k (no mask)
//   spat   = sum_r alpha[r] * regions[b, k, r, :]
//
// pregion is float32, regions float32 or bf16 (upcast in registers, as the
// TPU kernel upcasts it); all sums are float32.  Outputs spat
// (Bc, nb, K, Dr) and alpha (Bc, nb, K, R), float32.  h_satt is a strided
// view of the h-projection output, read with its row stride; c_s arrives
// as a device pointer, so a step needs no host sync.  Each pregion and
// regions element is read from memory once for all nb beams: the region
// bank is never tiled nb-fold (the TPU kernel's rule).
//
// What bounds it on this card.  At preset 2 (Bc=256, nb=5, K=28, R=49,
// s=Dr=1024, regions bf16) a step reads 1.44 GB of pregion and 0.72 GB of
// regions, 0.67 ms at 3.35 TB/s; it also evaluates nb*Bc*K*R*s = 1.8e9
// tanh.  With libdevice's tanhf (~20 instructions, two MUFU operations)
// that is ~1.1 ms of instruction issue before any byte moves, so the
// first design (route "simple", below: a block per (row, frame), tanhf,
// 256 threads) was held by issue, not by bytes, at 2.0 ms.
//
// Route "tma" (the design for Hopper):
// * the score pass of attn_score.cuh: tanh(p + h) = 1 - 2 / (1 + 2^(C p)
//   2^(C h)), with 2^(C h) taken once per block and 2^(C p) once per
//   pregion element for all nb beams, so an element costs an fma, one
//   rcp.approx and an fma into the sum (sum(u) rides in the partials);
// * a block walks `fpb` frames of one context row (7 at K 28), so the
//   nb x s beam states are read once per 7 frames, and each warp keeps
//   its columns of them in registers: a warp always scores the same
//   256-column chunk of the region rows (8 warps, chunks a power of two);
// * units of (region, chunk), 49 x 4 at preset 2, are dealt round-robin to
//   the 8 warps (24.5 each, not 7 rounds of 8 regions), each warp reduces
//   its unit by shuffles, and a unit's pregion row is loaded one unit
//   ahead into registers and two ahead into L2;
// * the frame's regions slab (R x Dr, 100 KB in bf16) is fetched into
//   shared memory by one TMA bulk copy issued before the score pass, so it
//   lands while the tanh work runs; the weighted sum then reads shared
//   memory with 8- or 16-byte loads, a thread per 4 columns;
// * the per-chunk partial scores are summed in a fixed order and every
//   reduction has a fixed shape, so results repeat bit for bit.
// Two blocks fit an SM (~103 KB of shared memory each), so one block's
// softmax and weighted sum overlap the other's score pass, which still
// takes most of a frame's time: issue, not bytes, remains the limit.  The
// route needs s and Dr multiples of 8, s <= 2048, 16-byte aligned pregion
// and regions and a slab that fits shared memory; other shapes take
// "simple".

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_score.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// Route "simple" (the first design): a block per (row, frame), tanhf
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeams = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename RegT>
__global__ void __launch_bounds__(kThreads)
spatial_core_kernel(const float* __restrict__ h_satt, long long ld_h,
                    const float* __restrict__ pregion,
                    const RegT* __restrict__ regions,
                    const float* __restrict__ u_s,
                    const float* __restrict__ c_s, float* __restrict__ spat,
                    float* __restrict__ alpha, int nb, int k, int r, int s,
                    int dr) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;            // (nb, s) beam states of this context row
  float* u_sm = h_s + nb * s;   // (s,)
  float* al_s = u_sm + s;       // (nb, r) scores, then alpha
  const long long bk = blockIdx.x;  // b * k + frame
  const long long b = bk / k;
  const int kk = static_cast<int>(bk - b * k);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = b * nb;

  for (int i = tid; i < nb * s; i += kThreads) {
    const int j = i / s;
    h_s[i] = h_satt[(row0 + j) * ld_h + (i - j * s)];
  }
  for (int i = tid; i < s; i += kThreads) u_sm[i] = u_s[i];
  __syncthreads();

  // scores: a warp per region, every beam against one read of pregion
  const float c0 = *c_s;
  const float* pbase = pregion + bk * r * s;
  // float4 loads need s % 4 == 0 and a 16-byte aligned pregion (every
  // row then starts 16-byte aligned; shared memory is)
  const bool vec =
      (s & 3) == 0 && (reinterpret_cast<unsigned long long>(pregion) & 15) == 0;
  for (int rr = warp; rr < r; rr += kWarps) {
    const float* prow = pbase + static_cast<long long>(rr) * s;
    float acc[kMaxBeams];
#pragma unroll
    for (int j = 0; j < kMaxBeams; ++j) acc[j] = 0.f;
    if (vec) {
      const float4* prow4 = reinterpret_cast<const float4*>(prow);
      const float4* u4 = reinterpret_cast<const float4*>(u_sm);
      for (int c4 = lane; c4 < s / 4; c4 += 32) {
        const float4 p = prow4[c4];
        const float4 u = u4[c4];
#pragma unroll
        for (int j = 0; j < kMaxBeams; ++j) {
          if (j < nb) {
            const float4 h = reinterpret_cast<const float4*>(h_s + j * s)[c4];
            acc[j] += tanhf(p.x + h.x) * u.x + tanhf(p.y + h.y) * u.y +
                      tanhf(p.z + h.z) * u.z + tanhf(p.w + h.w) * u.w;
          }
        }
      }
    } else {
      for (int col = lane; col < s; col += 32) {
        const float p = prow[col];
        const float u = u_sm[col];
#pragma unroll
        for (int j = 0; j < kMaxBeams; ++j)
          if (j < nb) acc[j] += tanhf(p + h_s[j * s + col]) * u;
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxBeams; ++j) {
      if (j < nb) {
        const float sum = lane_sum(acc[j]);
        if (lane == 0) al_s[j * r + rr] = sum + c0;
      }
    }
  }
  __syncthreads();

  // softmax over the R regions: a warp per beam
  for (int j = warp; j < nb; j += kWarps) {
    float* srow = al_s + j * r;
    float m = -INFINITY;
    for (int rr = lane; rr < r; rr += 32) m = fmaxf(m, srow[rr]);
    m = lane_max(m);
    float sum = 0.f;
    for (int rr = lane; rr < r; rr += 32) {
      const float ex = expf(srow[rr] - m);
      srow[rr] = ex;
      sum += ex;
    }
    const float denom = fmaxf(lane_sum(sum), 1e-20f);
    float* arow = alpha + ((row0 + j) * k + kk) * r;
    for (int rr = lane; rr < r; rr += 32) {
      const float al = srow[rr] / denom;
      srow[rr] = al;
      arow[rr] = al;
    }
  }
  __syncthreads();

  // spat = sum_r alpha_r regions_r: threads stride over Dr, each regions
  // element read once for all beams
  const RegT* rbase = regions + bk * r * dr;
  for (int d = tid; d < dr; d += kThreads) {
    float acc[kMaxBeams];
#pragma unroll
    for (int j = 0; j < kMaxBeams; ++j) acc[j] = 0.f;
    for (int rr = 0; rr < r; ++rr) {
      const float v = to_f32(rbase[static_cast<long long>(rr) * dr + d]);
#pragma unroll
      for (int j = 0; j < kMaxBeams; ++j)
        if (j < nb) acc[j] += al_s[j * r + rr] * v;
    }
#pragma unroll
    for (int j = 0; j < kMaxBeams; ++j)
      if (j < nb) spat[((row0 + j) * k + kk) * dr + d] = acc[j];
  }
}

template <typename RegT>
cudaError_t launch(const void* h_satt, long long ld_h, const void* pregion,
                   const void* regions, const void* u_s, const void* c_s,
                   void* spat, void* alpha, int bc, int nb, int k, int r,
                   int s, int dr, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(nb) * s + s + static_cast<size_t>(nb) * r) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spatial_core_kernel<RegT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = static_cast<long long>(bc) * k;
  spatial_core_kernel<RegT><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(
      static_cast<const float*>(h_satt), ld_h,
      static_cast<const float*>(pregion), static_cast<const RegT*>(regions),
      static_cast<const float*>(u_s), static_cast<const float*>(c_s),
      static_cast<float*>(spat), static_cast<float*>(alpha), nb, k, r, s, dr);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route "tma"
// ---------------------------------------------------------------------------

constexpr int kTmaWarps = 8;   // chunks per region row must divide this
constexpr int kTmaThreads = 32 * kTmaWarps;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 lo = __bfloat1622float2(h2[0]);
  const float2 hi = __bfloat1622float2(h2[1]);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// Shared memory of route "tma": the mbarrier in 16 bytes, the regions
// slab (R, Dr), partial scores (nb, R, chunks) and alpha (nb, R).  stvd_torch/model/kernel.py:spatial_core_route repeats
// this sum.
inline size_t tma_smem(int nb, int r, int dr, int nq, size_t reg_bytes) {
  return 16 + static_cast<size_t>(r) * dr * reg_bytes +
         4 * static_cast<size_t>(nb) * r * (nq + 1);
}

template <int NB, typename RegT>
__global__ void __launch_bounds__(kTmaThreads, 2)
spatial_core_tma(const float* __restrict__ h_satt, long long ld_h,
                 const float* __restrict__ pregion,
                 const RegT* __restrict__ regions,
                 const float* __restrict__ u_s,
                 const float* __restrict__ c_s, float* __restrict__ spat,
                 float* __restrict__ alpha, int k, int r, int s, int dr,
                 int fpb, int nq) {
  extern __shared__ __align__(16) unsigned char tma_buf[];
  const uint32_t bar = smem_u32(tma_buf);
  RegT* slab = reinterpret_cast<RegT*>(tma_buf + 16);      // (R, Dr)
  const long long slab_elems = static_cast<long long>(r) * dr;
  const uint32_t slab_bytes =
      static_cast<uint32_t>(slab_elems * sizeof(RegT));
  float* part = reinterpret_cast<float*>(tma_buf + 16 + slab_bytes);
  float* al_s = part + NB * r * nq;    // part (NB, R, nq), then (NB, R)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int splits = (k + fpb - 1) / fpb;
  const long long b = blockIdx.x / splits;
  const int k0 = static_cast<int>(blockIdx.x - b * splits) * fpb;
  const int k1 = min(k, k0 + fpb);
  const long long row0 = b * NB;
  const float c0 = *c_s;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {    // the first frame's regions land during its scores
    mbar_expect_tx(bar, slab_bytes);
    bulk_load(smem_u32(slab), regions + (b * k + k0) * slab_elems, slab_bytes,
              bar);
  }
  const int q = warp & (nq - 1);
  const int qshift = __ffs(nq) - 1;
  ScoreLane<NB> lanes;
  lanes.load(h_satt, ld_h, row0, u_s, q, lane, s);
  const int units = r * nq;    // (region, chunk), region-major
  const bool live = q * 256 < s;
  const uint32_t chunk_bytes = 4u * static_cast<uint32_t>(
                                   min(256, s - q * 256));

  for (int kk = k0, it = 0; kk < k1; ++kk, ++it) {
    const long long bk = b * k + kk;
    const float* pbase = pregion + bk * r * s;
    float4 pa, pb;
    if (warp < units)
      load_row(pbase + static_cast<long long>(warp >> qshift) * s, q, lane, s,
               pa, pb);
    for (int u = warp; u < units; u += kTmaWarps) {
      const int rr = u >> qshift;
      const int un = u + kTmaWarps;
      float4 na, nb4;
      if (un < units)
        load_row(pbase + static_cast<long long>(un >> qshift) * s, q, lane, s,
                 na, nb4);
      const int uf = u + 2 * kTmaWarps;
      if (lane == 0 && live && uf < units)
        prefetch_l2(pbase + static_cast<long long>(uf >> qshift) * s + q * 256,
                    chunk_bytes);
      float acc[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[j] = lanes.usum;
      lanes.score(pa, pb, acc, h_satt, ld_h, row0, q, lane, s);
      store_beam_sums<NB>(acc, lane, part + rr * nq + q, r * nq);
      pa = na;
      pb = nb4;
    }
    __syncthreads();

    // softmax over the R regions: a warp per beam, chunks summed in order
    if (warp < NB) {
      const int j = warp;
      float* srow = al_s + j * r;
      float m = -INFINITY;
      for (int rr = lane; rr < r; rr += 32) {
        float sc = c0;
        for (int qq = 0; qq < nq; ++qq) sc += part[(j * r + rr) * nq + qq];
        srow[rr] = sc;
        m = fmaxf(m, sc);
      }
      m = lane_max(m);
      float sum = 0.f;
      for (int rr = lane; rr < r; rr += 32) {
        const float ex = expf(srow[rr] - m);
        srow[rr] = ex;
        sum += ex;
      }
      const float denom = fmaxf(lane_sum(sum), 1e-20f);
      float* arow = alpha + ((row0 + j) * k + kk) * r;
      for (int rr = lane; rr < r; rr += 32) {
        const float al = srow[rr] / denom;
        srow[rr] = al;
        arow[rr] = al;
      }
    }
    __syncthreads();

    // spat = sum_r alpha_r regions_r from the slab: a thread per 4 columns
    mbar_wait(bar, it & 1);
    for (int d4 = tid; d4 < dr / 4; d4 += kTmaThreads) {
      float acc[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      for (int rr = 0; rr < r; ++rr) {
        float v[4];
        load4(slab + static_cast<long long>(rr) * dr + 4 * d4, v);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float a = al_s[j * r + rr];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(a, v[i], acc[j][i]);
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
        *reinterpret_cast<float4*>(spat + ((row0 + j) * k + kk) * dr +
                                   4 * d4) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    __syncthreads();
    if (tid == 0 && kk + 1 < k1) {   // the slab is free: fetch the next frame's
      fence_proxy_async();
      mbar_expect_tx(bar, slab_bytes);
      bulk_load(smem_u32(slab), regions + (bk + 1) * slab_elems, slab_bytes,
                bar);
    }
  }
}

template <int NB, typename RegT>
cudaError_t launch_tma_nb(const void* h_satt, long long ld_h,
                          const void* pregion, const void* regions,
                          const void* u_s, const void* c_s, void* spat,
                          void* alpha, int bc, int k, int r, int s, int dr,
                          int fpb, cudaStream_t stream) {
  const int nq = score_chunks(s);
  const size_t smem = tma_smem(NB, r, dr, nq, sizeof(RegT));
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem(spatial_core_tma<NB, RegT>, smem, allowed);
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(bc) * ((k + fpb - 1) / fpb);
  spatial_core_tma<NB, RegT><<<static_cast<unsigned>(blocks), kTmaThreads,
                               smem, stream>>>(
      static_cast<const float*>(h_satt), ld_h,
      static_cast<const float*>(pregion), static_cast<const RegT*>(regions),
      static_cast<const float*>(u_s), static_cast<const float*>(c_s),
      static_cast<float*>(spat), static_cast<float*>(alpha), k, r, s, dr, fpb,
      nq);
  return cudaGetLastError();
}

template <typename RegT>
cudaError_t launch_tma(const void* h_satt, long long ld_h, const void* pregion,
                       const void* regions, const void* u_s, const void* c_s,
                       void* spat, void* alpha, int bc, int nb, int k, int r,
                       int s, int dr, int fpb, cudaStream_t stream) {
  if (s % 8 || dr % 8 || s > 256 * kTmaWarps || fpb < 1 ||
      !aligned16(pregion) || !aligned16(regions) ||
      tma_smem(nb, r, dr, score_chunks(s), sizeof(RegT)) > kSmemLimit ||
      static_cast<long long>(bc) * ((k + fpb - 1) / fpb) > 2147483647LL)
    return cudaErrorInvalidValue;
#define STVD_NB(N)                                                          \
  case N:                                                                   \
    return launch_tma_nb<N, RegT>(h_satt, ld_h, pregion, regions, u_s, c_s, \
                                  spat, alpha, bc, k, r, s, dr, fpb, stream);
  switch (nb) {
    STVD_NB(1) STVD_NB(2) STVD_NB(3) STVD_NB(4)
    STVD_NB(5) STVD_NB(6) STVD_NB(7) STVD_NB(8)
  }
#undef STVD_NB
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int stvd_spatial_core_max_beams() { return kMaxBeams; }

// Route 0 is "tma", 1 "simple" (stvd_torch/model/kernel.py:
// SPATIAL_CORE_ROUTES); fpb is route "tma"'s frames per block.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int stvd_spatial_core(const void* h_satt, long long ld_h,
                                 const void* pregion, const void* regions,
                                 int regions_bf16, const void* u_s,
                                 const void* c_s, void* spat, void* alpha,
                                 int bc, int nb, int k, int r, int s, int dr,
                                 int route, int fpb, void* stream) {
  if (bc < 1 || nb < 1 || nb > kMaxBeams || k < 1 || r < 1 || s < 1 ||
      dr < 1 || static_cast<long long>(bc) * k > 2147483647LL ||
      (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == 0)
    e = regions_bf16
            ? launch_tma<__nv_bfloat16>(h_satt, ld_h, pregion, regions, u_s,
                                        c_s, spat, alpha, bc, nb, k, r, s, dr,
                                        fpb, st)
            : launch_tma<float>(h_satt, ld_h, pregion, regions, u_s, c_s,
                                spat, alpha, bc, nb, k, r, s, dr, fpb, st);
  else
    e = regions_bf16
            ? launch<__nv_bfloat16>(h_satt, ld_h, pregion, regions, u_s, c_s,
                                    spat, alpha, bc, nb, k, r, s, dr, st)
            : launch<float>(h_satt, ld_h, pregion, regions, u_s, c_s, spat,
                            alpha, bc, nb, k, r, s, dr, st);
  return static_cast<int>(e);
}
