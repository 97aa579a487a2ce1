// Score pass of the TMA attention cores (attn_core.cu, spatial_core.cu),
// and the device tanh it uses.
//
// Both cores score a context row against nb beam states:
//
//   score[j] = c + sum_col u[col] * tanh(p[col] + h[j][col])
//
// Writing tanh(x) = 1 - 2 / (1 + 2^(C x)) with C = 2 log2(e), the sum
// becomes c + sum(u) + sum_col (-2 u[col]) / (1 + 2^(C p) 2^(C h_j)).
// The factor 2^(C h_j) is taken once per block for every column a lane
// holds, and 2^(C p) once per element of the context row for all nb
// beams, so an element costs one fma (1 + the product), one rcp.approx
// and one fma into the sum: the exponential (a MUFU operation) is shared
// by the beams.  libdevice's tanhf instead runs a branchy sequence of ~20
// instructions with two MUFU operations; tanh.approx is one MUFU
// operation but has a relative error of ~2^-11, which the cores' parity
// bars (1e-4 against the plain version) do not allow.  The absolute error
// of this tanh is below ~3e-7 where |p| + |h| is small and grows by
// ~4.3e-8 (|p| + |h|) where p + h cancels (C p and C h are each rounded),
// as with the single-exponent form of C p + C h.
//
// The product form holds while |C p| and |C h| are at most 60 (|x| below
// ~20.8): 2^(+-60) times 2^(+-60) stays finite and normal.  A warp whose
// unit holds a larger, infinite or NaN p (or whose beam states do) scores
// that unit with the single-exponent form 1 / (1 + 2^(C (p + h))) instead,
// re-reading h from memory; on such inputs the tanh saturates anyway.
//
// The reciprocal is rcp.approx, a second MUFU operation.  Three Newton
// steps from an integer first guess, on the FP32 pipe, give the same
// accuracy; on an H100 the score pass ran slower with them on half or
// three quarters of its columns than with rcp.approx on all.
//
// stvd_tanh_f32 (attn_core.cu) exposes both forms, so they can be held
// against torch.tanh over a dense grid on the card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // kSmemLimit, allow_smem

namespace {

constexpr float kTwoLog2e = 2.885390081777927f;
constexpr float kSplitMax = 60.f;
constexpr unsigned kAllLanes = 0xffffffffu;
// 256-column chunks of a score row, rounded up to a power of two so that
// the chunk count divides the warp count (a warp then keeps one chunk).
// stvd_torch/model/kernel.py:score_chunks repeats this.
inline int score_chunks(int width) {
  int nq = 1;
  while (nq * 256 < width) nq *= 2;
  return nq;
}

__device__ __forceinline__ float ex2_approx(float a) {
  float t;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(a));
  return t;
}

__device__ __forceinline__ float rcp_approx(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// Whether C x = a lies in the product form's range (false for NaN).
__device__ __forceinline__ bool in_split_range(float a) {
  return fabsf(a) <= kSplitMax;
}

// 1 / (1 + 2^a), the single-exponent form: NaN stays NaN, +inf gives 0,
// -inf gives 1.
__device__ __forceinline__ float inv_one_plus_ex2(float a) {
  return rcp_approx(1.f + ex2_approx(a));
}

// tanh(p + h) as the score pass takes it: the product form in range, the
// single-exponent form out of it.
__device__ __forceinline__ float split_tanh(float p, float h) {
  const float ap = p * kTwoLog2e;
  const float ah = h * kTwoLog2e;
  if (!in_split_range(ap) || !in_split_range(ah))
    return fmaf(-2.f, inv_one_plus_ex2(kTwoLog2e * (p + h)), 1.f);
  const float d = fmaf(ex2_approx(ap), ex2_approx(ah), 1.f);
  return fmaf(-2.f, rcp_approx(d), 1.f);
}

__device__ __forceinline__ float lane_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAllLanes, v, o);
  return v;
}

__device__ __forceinline__ float lane_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kAllLanes, v, o));
  return v;
}

// dst[j * stride] = the warp's sum of v[j] for j < NB.  From 4 beams up
// the sums are reduce-scattered: exchanges across lanes 16, 8 and 4 apart
// halve the values each lane holds (slot j ends in lanes 4j..4j+3, 8 slots
// at most), two butterfly steps finish them, and lane 4j writes slot j:
// 9 shuffles for up to 8 sums instead of 5 a sum.  The order is fixed, so
// results repeat bit for bit.
template <int NB>
__device__ __forceinline__ void store_beam_sums(const float (&v)[NB],
                                                int lane, float* dst,
                                                int stride) {
  if (NB < 4) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float t = lane_sum(v[j]);
      if (lane == 0) dst[j * stride] = t;
    }
    return;
  }
  const bool up16 = lane & 16, up8 = lane & 8, up4 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = i < NB ? v[i] : 0.f;
    const float hi = i + 4 < NB ? v[i + 4] : 0.f;
    a[i] = (up16 ? hi : lo) +
           __shfl_xor_sync(kAllLanes, up16 ? lo : hi, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (up8 ? a[i + 2] : a[i]) +
           __shfl_xor_sync(kAllLanes, up8 ? a[i] : a[i + 2], 8);
  float c = (up4 ? b[1] : b[0]) +
            __shfl_xor_sync(kAllLanes, up4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(kAllLanes, c, 2);
  c += __shfl_xor_sync(kAllLanes, c, 1);
  const int j = lane >> 2;
  if ((lane & 3) == 0 && j < NB) dst[j * stride] = c;
}

// Columns of score chunk q held by a lane: 8 of the chunk's 256, as two
// float4s 128 columns apart, so each of a warp's two loads reads 512
// contiguous bytes.
__device__ __forceinline__ int chunk_col(int q, int lane, int half) {
  return q * 256 + half * 128 + lane * 4;
}

// One lane's view of nb beam states over its 8 columns of chunk q:
// 2^(C h_j), -2 u and sum(u).  Columns at or past `width` (a multiple of
// 4) hold u = 0 and add nothing.
template <int NB>
struct ScoreLane {
  float eh[NB][8];
  float u2[8];
  float usum;
  bool fast;    // every |C h_j| of the lane's columns is in range

  __device__ __forceinline__ void load(const float* __restrict__ h,
                                       long long ld_h, long long row0,
                                       const float* __restrict__ u, int q,
                                       int lane, int width) {
    usum = 0.f;
    fast = true;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = chunk_col(q, lane, half);
      const bool ok = c < width;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float uv = ok ? u[c + i] : 0.f;
        u2[4 * half + i] = -2.f * uv;
        usum += uv;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float a =
              ok ? kTwoLog2e * h[(row0 + j) * ld_h + c + i] : 0.f;
          fast = fast && in_split_range(a);
          eh[j][4 * half + i] = ex2_approx(a);
        }
      }
    }
  }

  // acc[j] += this lane's part of sum_col -2 u / (1 + 2^(C p) 2^(C h_j))
  // for one context row (pa, pb: its 8 columns of p).  Warp-uniform; the
  // beam states' arguments are those of load (re-read only out of range).
  __device__ __forceinline__ void score(float4 pa, float4 pb,
                                        float (&acc)[NB],
                                        const float* __restrict__ h,
                                        long long ld_h, long long row0,
                                        int q, int lane, int width) const {
    const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    float ep[8];
    bool ok = fast;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = kTwoLog2e * p[i];
      ok = ok && in_split_range(a);
      ep[i] = ex2_approx(a);
    }
    if (__all_sync(kAllLanes, ok)) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = fmaf(ep[i], eh[j][i], 1.f);
          acc[j] = fmaf(rcp_approx(d), u2[i], acc[j]);
        }
      }
      return;
    }
    // out of the product form's range: one exponent per element
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = chunk_col(q, lane, i >> 2) + (i & 3);
      if (c >= width) continue;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float a = kTwoLog2e * (p[i] + h[(row0 + j) * ld_h + c]);
        acc[j] = fmaf(inv_one_plus_ex2(a), u2[i], acc[j]);
      }
    }
  }
};

// The lane's two float4s of a score row (zeros past `width`).
__device__ __forceinline__ void load_row(const float* __restrict__ row, int q,
                                         int lane, int width, float4& pa,
                                         float4& pb) {
  const int c0 = chunk_col(q, lane, 0);
  const int c1 = chunk_col(q, lane, 1);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  pa = c0 < width ? __ldg(reinterpret_cast<const float4*>(row + c0)) : z;
  pb = c1 < width ? __ldg(reinterpret_cast<const float4*>(row + c1)) : z;
}

}  // namespace
