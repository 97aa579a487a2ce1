// Spatial backward step of the preset-2 train scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stvd/model/kernel.py:_make_spatial_bwd_kernel
// (pallas_call in _spatial_bwd_pallas_call, driven by spatial_bwd_pallas).
// Same contract, with the plain PyTorch version in
// stvd_torch/model/kernel.py:_spatial_bwd_plain.  Per (b, k), in the
// compute dtype T (float32 or bf16, every T op rounded as in the plain
// version) with float32 sums:
//
//   e_s      = tanh(pregion[b,k] + T(h_satt[b]))                (R, s)
//   dalpha   = regions[b,k] . dspat[b,k]                          (R,)
//   dss      = alpha_s * (dalpha - sum_r alpha_s * dalpha)        (R,)
//   du_s    += sum_r dss * e_s                                     (s,)
//   dpe      = T(dss * u_s) * (1 - e_s * e_s)                     (R, s) in T
//   Dpe     += dpe          in place, in the accumulator dtype A (f32 or bf16)
//   dh_satt += sum_r dpe                                           (s,)
//   spat_prev = sum_r T(alpha_prev) * regions[b,k]               (Dr,) in T
//
// Outputs dh_satt (B, s), du_s (s,), dss (B, K, R), float32, spat_prev
// (B, K, Dr) in T; Dpe (B, K, R, s) is updated in place.
//
// Bound: at preset 2 training (B 64, K 28, R 49, s = Dr = 1024), with bf16
// pregion, regions and Dpe, one call reads 180 MB each of pregion, regions
// and Dpe and writes 180 MB of Dpe: 720 MB, ~0.215 ms at 3.35 TB/s (float32
// Dpe: 1.08 GB, ~0.32 ms).  It also evaluates 9e7 tanhf and a chain of
// bf16 roundings per (region, column) element, whose instruction issue
// is of the same order and must hide under the loads: bf16 columns are
// taken in pairs with bf16x2 arithmetic to halve it.
//
// Design: one block per (b, k) row, each pregion, regions and Dpe element
// read once with 16-byte vector loads when the widths allow.  A pass over
// a width of `nvec` vectors maps the block's threads to `lanes` region
// lanes of `nct` column threads (nct a multiple of 32, so no warp spans
// two lanes): at bf16 and s = 1024, 128 vectors x 2 lanes, so every thread
// works.  Each thread walks its lane's regions kGroup at a time, all the
// group's loads issued before the arithmetic that uses them, and keeps
// its columns' sums (spat_prev, du_s, dh_satt) in registers; the lanes are
// combined once per row in shared memory, in lane order.  dalpha takes one
// warp reduction per group of regions.  The first group of the pregion
// pass is loaded before the barrier that waits for dss, so the stream of
// loads does not stop there; several blocks per SM cover the rest.
// Hopper blocks run in no order, so the sums over k (dh_satt) and over
// (b, k) (du_s), which the TPU kernel carried across its sequential grid,
// are per-block partials reduced by two more launches in a fixed order:
// deterministic, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;              // regions per thread per group
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round a float to T's precision
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// V consecutive elements at p, unconverted (zeros when !valid): 16-byte
// loads when V > 1 (the caller has checked widths and alignment), element
// loads when V == 1.
template <typename E, int V>
__device__ __forceinline__ void load_raw(const E* p, E* out, bool valid) {
  if constexpr (V == 1) {
    out[0] = valid ? p[0] : from_f<E>(0.f);
  } else {
    static_assert(V * sizeof(E) % 16 == 0, "vector of whole 16-byte words");
#pragma unroll
    for (int i = 0; i < static_cast<int>(V * sizeof(E) / 16); ++i)
      reinterpret_cast<uint4*>(out)[i] =
          valid ? reinterpret_cast<const uint4*>(p)[i] : make_uint4(0, 0, 0, 0);
  }
}

template <typename E, int V>
__device__ __forceinline__ void store_raw(E* p, const E* in) {
  if constexpr (V == 1) {
    p[0] = in[0];
  } else {
#pragma unroll
    for (int i = 0; i < static_cast<int>(V * sizeof(E) / 16); ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(in)[i];
  }
}

// One group of the pregion pass: pregion and Dpe of regions rr0,
// rr0 + lanes, ... (kGroup of them) at column vector cv.
template <typename T, typename A, int V>
__device__ __forceinline__ void load_group(const T* pre_row, const A* acc_row,
                                           T (*pv)[V], A (*av)[V], int rr0,
                                           int lanes, int r, int s, int cv,
                                           bool ok) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int rr = rr0 + g * lanes;
    const bool valid = ok && rr < r;
    const long long off = valid ? static_cast<long long>(rr) * s + cv * V : 0;
    load_raw<T, V>(pre_row + off, pv[g], valid);
    load_raw<A, V>(acc_row + off, av[g], valid);
  }
}

// The arithmetic of one pregion-pass group: e_s recomputed, du/dh summed
// in registers, Dpe += dpe in av.  kAll: every region of the group
// exists, so the regions' chains interleave with no branch; else the
// first `nvalid` do (a warp-uniform test).
//
// bf16 vectors take column pairs in bf16x2 arithmetic.  Each op there
// (p + h, e * e, 1 - e^2, T(g u) * (1 - e^2), Dpe + dpe) has two bf16
// operands and rounds its exact result once to bf16; the float32 op of
// the plain version is exact or lands far from a bf16 rounding midpoint
// on such operands, so its rounding to bf16 gives the same bits.
// g * u (float32 operands) and tanh stay float32 ops rounded to bf16.
// The products are __hmul2_rn, which the compiler may not contract with
// the following subtraction or addition into one fma (that would skip a
// rounding the plain version makes).
template <typename T, typename A, int V, bool kAll>
__device__ __forceinline__ void dpe_group(T (*pv)[V], A (*av)[V],
                                          const float* gg, const float* h_sm,
                                          const float* u_sm, int d0,
                                          int nvalid, float* du, float* dh) {
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {
    const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
#pragma unroll
    for (int i = 0; i < V; i += 2) {
      // h_sm holds bf16 values: the pack is exact
      const __nv_bfloat162 h2 =
          __floats2bfloat162_rn(h_sm[d0 + i], h_sm[d0 + i + 1]);
      const float u0 = u_sm[d0 + i], u1 = u_sm[d0 + i + 1];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (kAll || g < nvalid) {
          const float2 x = __bfloat1622float2(
              __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&pv[g][i]),
                      h2));
          const __nv_bfloat162 e =
              __floats2bfloat162_rn(tanhf(x.x), tanhf(x.y));
          const float2 ef = __bfloat1622float2(e);
          du[i] += gg[g] * ef.x;
          du[i + 1] += gg[g] * ef.y;
          const __nv_bfloat162 dpe = __hmul2_rn(
              __floats2bfloat162_rn(gg[g] * u0, gg[g] * u1),
              __hsub2(one, __hmul2_rn(e, e)));
          const float2 df = __bfloat1622float2(dpe);
          dh[i] += df.x;
          dh[i + 1] += df.y;
          if constexpr (sizeof(A) == 2) {
            __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(&av[g][i]);
            *a2 = __hadd2(*a2, dpe);
          } else {
            av[g][i] += df.x;
            av[g][i + 1] += df.y;
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float hh = h_sm[d0 + i], uu = u_sm[d0 + i];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (kAll || g < nvalid) {
          const float e = rnd<T>(tanhf(rnd<T>(to_f(pv[g][i]) + hh)));
          du[i] += gg[g] * e;
          const float one_m = rnd<T>(1.f - rnd<T>(e * e));
          const float dpe = rnd<T>(rnd<T>(gg[g] * uu) * one_m);
          dh[i] += dpe;
          av[g][i] = from_f<A>(to_f(av[g][i]) + dpe);
        }
      }
    }
  }
}

// T: compute dtype of pregion/regions/spat_prev; A: Dpe accumulator dtype;
// V: elements per vector (16 / sizeof(T), or 1).  (lanes_r, nct_r) and
// (lanes_s, nct_s) are the thread layouts of the regions pass (width Dr)
// and the pregion pass (width s).  A float32 Dpe under bf16 doubles the
// group's registers and would spill at three blocks per SM, so that case
// keeps two (up to 128 registers a thread), the others three.
template <typename T, typename A, int V>
__global__ void __launch_bounds__(kThreads, sizeof(A) > sizeof(T) ? 2 : 3)
spatial_bwd_kernel(const float* __restrict__ h_satt,
                   const T* __restrict__ pregion, const T* __restrict__ regions,
                   const float* __restrict__ alpha_s,
                   const float* __restrict__ alpha_prev,
                   const float* __restrict__ dspat,
                   const float* __restrict__ u_s, A* __restrict__ dpe_acc,
                   float* __restrict__ dh_part, float* __restrict__ du_part,
                   float* __restrict__ dss_out, T* __restrict__ spat_prev,
                   int k, int r, int s, int dr, int lanes_r, int nct_r,
                   int lanes_s, int nct_s) {
  extern __shared__ __align__(16) float smem[];
  float* h_sm = smem;              // (s,) T(h_satt) as float
  float* u_sm = h_sm + s;          // (s,)
  float* al_sm = u_sm + s;         // (r,) alpha_s
  float* alp_sm = al_sm + r;       // (r,) T(alpha_prev)
  float* dss_sm = alp_sm + r;      // (r,) dalpha, then dss
  float* red_sm = dss_sm + r;      // (kWarps, r) warp partials of dalpha
  float* comb_sm = red_sm + kWarps * r;   // lane partials, when lanes > 1

  const long long row = blockIdx.x;          // b * k + frame
  const long long b = row / k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* pre_row = pregion + row * r * s;
  const T* reg_row = regions + row * r * dr;
  A* acc_row = dpe_acc + row * r * s;

  for (int i = tid; i < s; i += kThreads) {
    h_sm[i] = rnd<T>(h_satt[b * s + i]);
    u_sm[i] = u_s[i];
  }
  for (int i = tid; i < r; i += kThreads) {
    al_sm[i] = alpha_s[row * r + i];
    alp_sm[i] = rnd<T>(alpha_prev[row * r + i]);
  }
  for (int i = tid; i < kWarps * r; i += kThreads) red_sm[i] = 0.f;
  __syncthreads();

  // regions pass: dalpha (warp partials) and spat_prev (registers)
  const int nv_r = dr / V;
  const int lr = tid / nct_r;              // region lane (warp-uniform)
  const int tr = tid - lr * nct_r;         // column thread
  if (lr < lanes_r) {
    for (int cv0 = 0; cv0 < nv_r; cv0 += nct_r) {
      const int cv = cv0 + tr;
      const bool ok = cv < nv_r;
      float ds[V], sp[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ds[i] = ok ? dspat[row * dr + cv * V + i] : 0.f;
        sp[i] = 0.f;
      }
      for (int rr0 = lr; rr0 < r; rr0 += lanes_r * kGroup) {
        alignas(16) T rv[kGroup][V];
        float ap[kGroup], part[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int rr = rr0 + g * lanes_r;
          const bool valid = ok && rr < r;
          load_raw<T, V>(reg_row + (valid ? static_cast<long long>(rr) * dr +
                                                cv * V
                                          : 0),
                         rv[g], valid);
          ap[g] = rr < r ? alp_sm[rr] : 0.f;
          part[g] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const float v = to_f(rv[g][i]);
            part[g] += v * ds[i];
            sp[i] += ap[g] * v;
          }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) part[g] = warp_sum(part[g]);
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int rr = rr0 + g * lanes_r;
            if (rr < r) red_sm[warp * r + rr] += part[g];
          }
        }
      }
      if (ok) {
        if (lanes_r == 1) {
          alignas(16) T out[V];
#pragma unroll
          for (int i = 0; i < V; ++i) out[i] = from_f<T>(sp[i]);
          store_raw<T, V>(spat_prev + row * dr + cv * V, out);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) comb_sm[lr * dr + cv * V + i] = sp[i];
        }
      }
    }
  }

  // the pregion pass's first group, loaded before the barrier: it does
  // not depend on dss
  const int nv_s = s / V;
  const int ls = tid / nct_s;
  const int ts = tid - ls * nct_s;
  alignas(16) T pv[kGroup][V];
  alignas(16) A av[kGroup][V];
  if (ls < lanes_s)
    load_group<T, A, V>(pre_row, acc_row, pv, av, ls, lanes_s, r, s, ts,
                        ts < nv_s);
  __syncthreads();

  if (lanes_r > 1)
    for (int c = tid; c < dr; c += kThreads) {
      float v = 0.f;
      for (int l = 0; l < lanes_r; ++l) v += comb_sm[l * dr + c];
      spat_prev[row * dr + c] = from_f<T>(v);
    }
  if (warp == 0) {
    float t = 0.f;
    for (int rr = lane; rr < r; rr += 32) {
      float d = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) d += red_sm[w * r + rr];
      dss_sm[rr] = d;
      t += al_sm[rr] * d;
    }
    t = warp_sum(t);
    for (int rr = lane; rr < r; rr += 32) {
      const float g = al_sm[rr] * (dss_sm[rr] - t);
      dss_sm[rr] = g;
      dss_out[row * r + rr] = g;
    }
  }
  __syncthreads();

  // pregion pass: recompute e_s, du_s / dh_satt (registers), Dpe += dpe
  if (ls < lanes_s) {
    for (int cv0 = 0; cv0 < nv_s; cv0 += nct_s) {
      const int cv = cv0 + ts;
      const bool ok = cv < nv_s;
      float du[V], dh[V];
#pragma unroll
      for (int i = 0; i < V; ++i) du[i] = dh[i] = 0.f;
      for (int rr0 = ls; rr0 < r; rr0 += lanes_s * kGroup) {
        if (cv0 != 0 || rr0 != ls)
          load_group<T, A, V>(pre_row, acc_row, pv, av, rr0, lanes_s, r, s,
                              cv, ok);
        float gg[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int rr = rr0 + g * lanes_s;
          gg[g] = rr < r ? dss_sm[rr] : 0.f;
        }
        const int nvalid = (r - rr0 + lanes_s - 1) / lanes_s;
        const int d0 = ok ? cv * V : 0;
        if (nvalid >= kGroup)
          dpe_group<T, A, V, true>(pv, av, gg, h_sm, u_sm, d0, nvalid, du,
                                   dh);
        else
          dpe_group<T, A, V, false>(pv, av, gg, h_sm, u_sm, d0, nvalid, du,
                                    dh);
        if (ok) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int rr = rr0 + g * lanes_s;
            if (rr < r)
              store_raw<A, V>(acc_row + static_cast<long long>(rr) * s +
                                  cv * V,
                              av[g]);
          }
        }
      }
      if (ok) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int d = cv * V + i;
          if (lanes_s == 1) {
            du_part[row * s + d] = du[i];
            dh_part[row * s + d] = dh[i];
          } else {
            comb_sm[ls * s + d] = du[i];
            comb_sm[(lanes_s + ls) * s + d] = dh[i];
          }
        }
      }
    }
  }
  if (lanes_s > 1) {
    __syncthreads();
    for (int c = tid; c < s; c += kThreads) {
      float du = 0.f, dh = 0.f;
      for (int l = 0; l < lanes_s; ++l) {
        du += comb_sm[l * s + c];
        dh += comb_sm[(lanes_s + l) * s + c];
      }
      du_part[row * s + c] = du;
      dh_part[row * s + c] = dh;
    }
  }
}

// dh_satt[b, d] = sum_k dh_part[b*K + k, d]; du_b[b, d] likewise.
__global__ void reduce_k_kernel(const float* __restrict__ dh_part,
                                const float* __restrict__ du_part,
                                float* __restrict__ dh_out,
                                float* __restrict__ du_b, int k, int s) {
  const long long b = blockIdx.y;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= s) return;
  float dh = 0.f, du = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const long long o = (b * k + kk) * s + d;
    dh += dh_part[o];
    du += du_part[o];
  }
  dh_out[b * s + d] = dh;
  du_b[b * s + d] = du;
}

// du_s[d] = sum_b du_b[b, d]
__global__ void reduce_b_kernel(const float* __restrict__ du_b,
                                float* __restrict__ du_out, int nb, int s) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= s) return;
  float du = 0.f;
  for (int b = 0; b < nb; ++b) du += du_b[static_cast<long long>(b) * s + d];
  du_out[d] = du;
}

// Thread layout of a pass over nvec vectors: column threads rounded up to
// whole warps (at most the block), the rest of the block as region lanes.
void layout(int nvec, int* lanes, int* nct) {
  int c = (nvec + 31) / 32 * 32;
  if (c > kThreads) c = kThreads;
  *nct = c;
  *lanes = kThreads / c;
}

template <typename T, typename A, int V>
cudaError_t launch_main(const void* h_satt, const void* pregion,
                        const void* regions, const void* alpha_s,
                        const void* alpha_prev, const void* dspat,
                        const void* u_s, void* dpe_acc, void* dh_part,
                        void* du_part, void* dss, void* spat_prev, int nb,
                        int k, int r, int s, int dr, cudaStream_t st) {
  int lanes_r, nct_r, lanes_s, nct_s;
  layout(dr / V, &lanes_r, &nct_r);
  layout(s / V, &lanes_s, &nct_s);
  long long comb = lanes_r > 1 ? 1LL * lanes_r * dr : 0;
  if (lanes_s > 1 && 2LL * lanes_s * s > comb) comb = 2LL * lanes_s * s;
  const size_t smem =
      sizeof(float) * (2LL * s + 3LL * r + 1LL * kWarps * r + comb);
  const cudaError_t e = cudaFuncSetAttribute(
      spatial_bwd_kernel<T, A, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  spatial_bwd_kernel<T, A, V><<<static_cast<unsigned>(nb) * k, kThreads, smem,
                                st>>>(
      static_cast<const float*>(h_satt), static_cast<const T*>(pregion),
      static_cast<const T*>(regions), static_cast<const float*>(alpha_s),
      static_cast<const float*>(alpha_prev), static_cast<const float*>(dspat),
      static_cast<const float*>(u_s), static_cast<A*>(dpe_acc),
      static_cast<float*>(dh_part), static_cast<float*>(du_part),
      static_cast<float*>(dss), static_cast<T*>(spat_prev), k, r, s, dr,
      lanes_r, nct_r, lanes_s, nct_s);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// vec: the caller's route (stvd_torch/model/kernel.py:spatial_bwd_route),
// checked here: 16-byte loads need whole vectors and aligned bases.
template <typename T, typename A>
cudaError_t launch_typed(const void* h_satt, const void* pregion,
                         const void* regions, const void* alpha_s,
                         const void* alpha_prev, const void* dspat,
                         const void* u_s, void* dpe_acc, void* dh_part,
                         void* du_part, void* dss, void* spat_prev, int nb,
                         int k, int r, int s, int dr, bool vec,
                         cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  if (vec && !(s % kV == 0 && dr % kV == 0 && aligned16(pregion) &&
               aligned16(regions) && aligned16(dpe_acc) &&
               aligned16(spat_prev)))
    return cudaErrorInvalidValue;
  return vec ? launch_main<T, A, kV>(h_satt, pregion, regions, alpha_s,
                                     alpha_prev, dspat, u_s, dpe_acc, dh_part,
                                     du_part, dss, spat_prev, nb, k, r, s, dr,
                                     st)
             : launch_main<T, A, 1>(h_satt, pregion, regions, alpha_s,
                                    alpha_prev, dspat, u_s, dpe_acc, dh_part,
                                    du_part, dss, spat_prev, nb, k, r, s, dr,
                                    st);
}

}  // namespace

// cd_bf16: pregion/regions/spat_prev are bf16 (else float32); acc_bf16:
// Dpe is bf16 (else float32; float32 compute takes float32 Dpe only).
// dh_part, du_part (B*K, s) and du_b (B, s) are float32 scratch.  vec: the
// 16-byte-load route (else element loads).  Returns the cudaError_t of the
// three launches (0 on success).
extern "C" int stvd_spatial_bwd(const void* h_satt, const void* pregion,
                                const void* regions, int cd_bf16,
                                const void* alpha_s, const void* alpha_prev,
                                const void* dspat, const void* u_s,
                                void* dpe_acc, int acc_bf16, void* dh_part,
                                void* du_part, void* du_b, void* dh_out,
                                void* du_out, void* dss, void* spat_prev,
                                int nb, int k, int r, int s, int dr,
                                int vec, void* stream) {
  if (nb < 1 || k < 1 || r < 1 || s < 1 || dr < 1 || (acc_bf16 && !cd_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!cd_bf16)
    e = launch_typed<float, float>(h_satt, pregion, regions, alpha_s,
                                   alpha_prev, dspat, u_s, dpe_acc, dh_part,
                                   du_part, dss, spat_prev, nb, k, r, s, dr,
                                   vec != 0, st);
  else if (acc_bf16)
    e = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        h_satt, pregion, regions, alpha_s, alpha_prev, dspat, u_s, dpe_acc,
        dh_part, du_part, dss, spat_prev, nb, k, r, s, dr, vec != 0, st);
  else
    e = launch_typed<__nv_bfloat16, float>(
        h_satt, pregion, regions, alpha_s, alpha_prev, dspat, u_s, dpe_acc,
        dh_part, du_part, dss, spat_prev, nb, k, r, s, dr, vec != 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_k((s + kThreads - 1) / kThreads, nb);
  reduce_k_kernel<<<grid_k, kThreads, 0, st>>>(
      static_cast<const float*>(dh_part), static_cast<const float*>(du_part),
      static_cast<float*>(dh_out), static_cast<float*>(du_b), k, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_b_kernel<<<(s + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(du_b), static_cast<float*>(du_out), nb, s);
  return static_cast<int>(cudaGetLastError());
}
