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
// Design: one block per (b, k) row reads each pregion, regions and Dpe
// element once (16-byte vector loads when the widths allow).  The regions
// pass forms dalpha (a warp reduction per region) and spat_prev (each
// thread owns columns) together; the pregion pass recomputes e_s and
// updates Dpe.  Hopper blocks run in no order, so the sums over k
// (dh_satt) and over (b, k) (du_s), which the TPU kernel carried across
// its sequential grid, are per-block partials reduced by two more
// launches in a fixed order: deterministic, no atomics.
//
// Bound: at preset 2 training (B 64, K 28, R 49, s = Dr = 1024), with bf16
// pregion, regions and Dpe, one call reads 180 MB each of pregion, regions
// and Dpe and writes 180 MB of Dpe: 720 MB, ~0.215 ms at 3.35 TB/s (float32
// Dpe: 1.08 GB, ~0.32 ms).  It also evaluates 9e7 tanhf.  The partials
// (2 x 7.3 MB) add ~5 %.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

// V consecutive elements at p: 16-byte loads when V > 1 (the caller has
// checked widths and alignment), element loads when V == 1.
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float* out) {
  if constexpr (V == 1) {
    out[0] = to_f(p[0]);
  } else {
    static_assert(V * sizeof(T) % 16 == 0, "vector of whole 16-byte words");
    alignas(16) T tmp[V];
#pragma unroll
    for (int i = 0; i < static_cast<int>(V * sizeof(T) / 16); ++i)
      reinterpret_cast<uint4*>(tmp)[i] = reinterpret_cast<const uint4*>(p)[i];
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f(tmp[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float* in) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(in[0]);
  } else {
    alignas(16) T tmp[V];
#pragma unroll
    for (int i = 0; i < V; ++i) tmp[i] = from_f<T>(in[i]);
#pragma unroll
    for (int i = 0; i < static_cast<int>(V * sizeof(T) / 16); ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(tmp)[i];
  }
}

// T: compute dtype of pregion/regions/spat_prev; A: Dpe accumulator dtype;
// V: elements per vector (16 / sizeof(T), or 1).
template <typename T, typename A, int V>
__global__ void __launch_bounds__(kThreads)
spatial_bwd_kernel(const float* __restrict__ h_satt,
                   const T* __restrict__ pregion, const T* __restrict__ regions,
                   const float* __restrict__ alpha_s,
                   const float* __restrict__ alpha_prev,
                   const float* __restrict__ dspat,
                   const float* __restrict__ u_s, A* __restrict__ dpe_acc,
                   float* __restrict__ dh_part, float* __restrict__ du_part,
                   float* __restrict__ dss_out, T* __restrict__ spat_prev,
                   int k, int r, int s, int dr) {
  extern __shared__ __align__(16) float smem[];
  float* h_sm = smem;              // (s,) T(h_satt) as float
  float* u_sm = h_sm + s;          // (s,)
  float* du_sm = u_sm + s;         // (s,) du_s partial
  float* dh_sm = du_sm + s;        // (s,) dh_satt partial
  float* dsp_sm = dh_sm + s;       // (dr,) dspat row
  float* sp_sm = dsp_sm + dr;      // (dr,) spat_prev sums
  float* al_sm = sp_sm + dr;       // (r,) alpha_s
  float* alp_sm = al_sm + r;       // (r,) T(alpha_prev)
  float* dss_sm = alp_sm + r;      // (r,) dalpha, then dss
  float* red_sm = dss_sm + r;      // (kWarps, r) warp partials of dalpha

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
    du_sm[i] = 0.f;
    dh_sm[i] = 0.f;
  }
  for (int i = tid; i < dr; i += kThreads) {
    dsp_sm[i] = dspat[row * dr + i];
    sp_sm[i] = 0.f;
  }
  for (int i = tid; i < r; i += kThreads) {
    al_sm[i] = alpha_s[row * r + i];
    alp_sm[i] = rnd<T>(alpha_prev[row * r + i]);
  }
  __syncthreads();

  // regions pass: dalpha (warp partials) and spat_prev (owned columns)
  const int nc_r = dr / V;
  for (int rr = 0; rr < r; ++rr) {
    float part = 0.f;
    const float ap = alp_sm[rr];
    for (int c = tid; c < nc_r; c += kThreads) {
      float v[V];
      load_v<T, V>(reg_row + static_cast<long long>(rr) * dr + c * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        part += v[i] * dsp_sm[c * V + i];
        sp_sm[c * V + i] += ap * v[i];
      }
    }
    part = warp_sum(part);
    if (lane == 0) red_sm[warp * r + rr] = part;
  }
  __syncthreads();
  for (int rr = tid; rr < r; rr += kThreads) {
    float d = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) d += red_sm[w * r + rr];
    dss_sm[rr] = d;
  }
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int rr = lane; rr < r; rr += 32) t += al_sm[rr] * dss_sm[rr];
    t = warp_sum(t);
    __syncwarp();
    for (int rr = lane; rr < r; rr += 32) {
      const float g = al_sm[rr] * (dss_sm[rr] - t);
      dss_sm[rr] = g;
      dss_out[row * r + rr] = g;
    }
  }
  __syncthreads();

  // pregion pass: recompute e_s, du_s / dh_satt partials, Dpe += dpe
  const int nc_s = s / V;
  for (int rr = 0; rr < r; ++rr) {
    const float g = dss_sm[rr];
    const long long off = static_cast<long long>(rr) * s;
    for (int c = tid; c < nc_s; c += kThreads) {
      float p[V], a[V];
      load_v<T, V>(pre_row + off + c * V, p);
      load_v<A, V>(acc_row + off + c * V, a);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int d = c * V + i;
        const float e = rnd<T>(tanhf(rnd<T>(p[i] + h_sm[d])));
        du_sm[d] += g * e;
        const float one_m = rnd<T>(1.f - rnd<T>(e * e));
        const float dpe = rnd<T>(rnd<T>(g * u_sm[d]) * one_m);
        dh_sm[d] += dpe;
        a[i] = a[i] + dpe;
      }
      store_v<A, V>(acc_row + off + c * V, a);
    }
  }
  // each thread reads back only the columns it wrote: no barrier needed
  for (int c = tid; c < nc_s; c += kThreads)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      du_part[row * s + c * V + i] = du_sm[c * V + i];
      dh_part[row * s + c * V + i] = dh_sm[c * V + i];
    }
  for (int c = tid; c < nc_r; c += kThreads)
    store_v<T, V>(spat_prev + row * dr + c * V, sp_sm + c * V);
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

template <typename T, typename A, int V>
cudaError_t launch_main(const void* h_satt, const void* pregion,
                        const void* regions, const void* alpha_s,
                        const void* alpha_prev, const void* dspat,
                        const void* u_s, void* dpe_acc, void* dh_part,
                        void* du_part, void* dss, void* spat_prev, int nb,
                        int k, int r, int s, int dr, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (4LL * s + 2LL * dr + 3LL * r + 1LL * kWarps * r);
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
      static_cast<float*>(dss), static_cast<T*>(spat_prev), k, r, s, dr);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <typename T, typename A>
cudaError_t launch_typed(const void* h_satt, const void* pregion,
                         const void* regions, const void* alpha_s,
                         const void* alpha_prev, const void* dspat,
                         const void* u_s, void* dpe_acc, void* dh_part,
                         void* du_part, void* dss, void* spat_prev, int nb,
                         int k, int r, int s, int dr, cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = s % kV == 0 && dr % kV == 0 && aligned16(pregion) &&
                   aligned16(regions) && aligned16(dpe_acc) &&
                   aligned16(spat_prev);
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
// dh_part, du_part (B*K, s) and du_b (B, s) are float32 scratch.  Returns
// the cudaError_t of the three launches (0 on success).
extern "C" int stvd_spatial_bwd(const void* h_satt, const void* pregion,
                                const void* regions, int cd_bf16,
                                const void* alpha_s, const void* alpha_prev,
                                const void* dspat, const void* u_s,
                                void* dpe_acc, int acc_bf16, void* dh_part,
                                void* du_part, void* du_b, void* dh_out,
                                void* du_out, void* dss, void* spat_prev,
                                int nb, int k, int r, int s, int dr,
                                void* stream) {
  if (nb < 1 || k < 1 || r < 1 || s < 1 || dr < 1 || (acc_bf16 && !cd_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!cd_bf16)
    e = launch_typed<float, float>(h_satt, pregion, regions, alpha_s,
                                   alpha_prev, dspat, u_s, dpe_acc, dh_part,
                                   du_part, dss, spat_prev, nb, k, r, s, dr,
                                   st);
  else if (acc_bf16)
    e = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        h_satt, pregion, regions, alpha_s, alpha_prev, dspat, u_s, dpe_acc,
        dh_part, du_part, dss, spat_prev, nb, k, r, s, dr, st);
  else
    e = launch_typed<__nv_bfloat16, float>(
        h_satt, pregion, regions, alpha_s, alpha_prev, dspat, u_s, dpe_acc,
        dh_part, du_part, dss, spat_prev, nb, k, r, s, dr, st);
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
