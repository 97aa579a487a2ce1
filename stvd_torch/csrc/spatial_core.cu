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
// (Bc, nb, K, Dr) and alpha (Bc, nb, K, R), float32.
//
// Design: one block per (context row b, frame k) computes all nb beams,
// so each pregion and regions element is read from memory once for every
// beam and the region bank is never tiled nb-fold (the attention core's
// rule).  The nb beam states (nb x s floats, 20 KB at nb=5, s=1024) and
// u_s sit in shared memory; h_satt is a strided view of the h-projection
// output, read with its row stride and never copied.  Warps own regions
// for the score pass (float4 loads of pregion when s % 4 == 0), one warp
// per beam runs the softmax, and threads own Dr columns for the weighted
// sum.  c_s arrives as a device pointer, so a step needs no host sync.
//
// Bound: at preset 2 (Bc=256, nb=5, K=28, R=49, s=Dr=1024) a step reads
// 1.44 GB of pregion and 0.72 GB of bf16 regions, 2.2 GB or ~0.65 ms at
// 3.35 TB/s, and evaluates nb*Bc*K*R*s = 1.8e9 tanhf, which at the card's
// float32 issue rate costs about as much again.  The plain version
// instead writes and reads a 7.2 GB float32 e_s every step.  tanhf (not
// tanh.approx) keeps the float32 parity bar of 1e-4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeams = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
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
        const float sum = warp_sum(acc[j]);
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
    m = warp_max(m);
    float sum = 0.f;
    for (int rr = lane; rr < r; rr += 32) {
      const float ex = expf(srow[rr] - m);
      srow[rr] = ex;
      sum += ex;
    }
    const float denom = fmaxf(warp_sum(sum), 1e-20f);
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

}  // namespace

extern "C" int stvd_spatial_core_max_beams() { return kMaxBeams; }

// Returns the cudaError_t of the launch (0 on success).
extern "C" int stvd_spatial_core(const void* h_satt, long long ld_h,
                                 const void* pregion, const void* regions,
                                 int regions_bf16, const void* u_s,
                                 const void* c_s, void* spat, void* alpha,
                                 int bc, int nb, int k, int r, int s, int dr,
                                 void* stream) {
  if (bc < 1 || nb < 1 || nb > kMaxBeams || k < 1 || r < 1 || s < 1 ||
      dr < 1 || static_cast<long long>(bc) * k > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      regions_bf16
          ? launch<__nv_bfloat16>(h_satt, ld_h, pregion, regions, u_s, c_s,
                                  spat, alpha, bc, nb, k, r, s, dr, st)
          : launch<float>(h_satt, ld_h, pregion, regions, u_s, c_s, spat,
                          alpha, bc, nb, k, r, s, dr, st);
  return static_cast<int>(e);
}
