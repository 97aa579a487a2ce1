// Temporal-attention core of the decode step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stvd/model/kernel.py:_attn_core_kernel
// (pallas_call in _attn_core_pallas_call).  Same contract as that call,
// with the plain PyTorch version in stvd_torch/model/step.py:_attention_core:
//
//   e      = tanh(pctx[b, k, :] + h_att[b*nb + j, :])         per beam j
//   score  = e . u_att + c_att
//   alpha  = masked softmax over K (fill -1e30, denominator >= 1e-20;
//            a fully-masked row gives zeros)
//   ctx_t  = sum_k alpha[k] * ctx[b, k, :]
//   ctx_t *= sigmoid(beta_logit + b_sel)                  if selector
//
// pctx is float32, ctx float32 or bf16 (converted on load); all math is
// float32.  Outputs ctx_t (Bs, Dc) and alpha (Bs, K), float32.  One
// context row serves all nb beams of that row, so the context is read
// once per row and never tiled nb-fold (the TPU kernel's rule); h_att and
// beta_logit are strided rows, c_att and b_sel device pointers (the TPU
// kernel's SMEM scalars), so a step needs no host sync to read them.
//
// What bounds it on this card.  At preset 3 (Bc=256, nb=5, K=28,
// A=Dc=1024, ctx bf16) a row reads 28*1024*4 B of pctx + 28*1024*2 B of
// ctx = 168 KB, 43 MB a step (55 MB with the outputs, ~16 us at 3.35
// TB/s), against ~37 M tanh.  The first design (route "simple", below: a
// block per row, tanhf, three phases split by barriers) gave 256 blocks
// for 132 SMs, each streaming its 168 KB with 4- and 2-byte loads and
// reading ctx only after its scores: it was held by latency and too
// little parallelism, not by its bytes, at 0.15 ms.
//
// Route "cluster" (the design for Hopper):
// * a row's K frames are split over the CTAs of a thread-block cluster,
//   kc frames each, up to 4 CTAs a row; from 3 beams up 2, one wave
//   (~512 CTAs) at a decode batch of 256, whatever the row count, so a
//   row's sums run in one order at any batch
//   (stvd_torch/model/kernel.py:attention_core_split): 2 x 14 at preset 3,
//   4 x 7 at 1 beam (training, and path A's per-beam rows);
// * each CTA fetches its ctx slice into shared memory with one TMA bulk
//   copy, issued first, so it lands while the scores run, and asks L2 for
//   its pctx slice; pctx is read with 16-byte loads, a warp per
//   256-column chunk, through the score pass of attn_score.cuh (the
//   exponential shared by the nb beams, one rcp.approx an element);
// * the softmax is split: each CTA takes its masked scores' max; after a
//   cluster barrier every CTA reads the others' maxima from distributed
//   shared memory, forms exp(s - max) (0 where masked), its sum and its
//   partial sum_k p_k ctx_k, which it writes over its ctx slice once every
//   thread has read it; after a second barrier each CTA sums the partials
//   of every CTA in rank order for its share of the Dc columns and
//   divides by the summed denominator.  No atomics, and every sum has a
//   fixed order, so results repeat bit for bit; a CTA whose frames are all
//   masked adds zeros, and a fully-masked row still gives zeros.
// A CTA has four warps for A and Dc up to 1024 (preset 3, path A) and
// eight above, up to 2048 (preset 4: A = Dc = 2048, a float32 context):
// a warp keeps one 256-column score chunk and a thread 8 columns of Dc,
// so the math, the sums and their order are those of the four-warp CTA.
// At preset 4 (Bc=256, nb=5, K=28) a call moves pctx 58.7 MB, ctx 58.7 MB
// (float32), h_att 10.5 MB and ctx_t 10.5 MB: 138 MB, ~41 us at 3.35
// TB/s.  Its float32 slice of 14 frames would be 115 KB, one CTA an SM,
// so a row takes 4 CTAs of 7 frames (57 KB each) there
// (stvd_torch/model/kernel.py:attention_core_split).
// The route needs A and Dc multiples of 8 and at most 2048, 16-byte
// aligned pctx and ctx and a slice that fits shared memory; other shapes
// take "simple".

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_score.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// Route "simple" (the first design): a block per context row, tanhf
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeams = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename CtxT>
__global__ void __launch_bounds__(kThreads)
attn_core_kernel(const float* __restrict__ h_att, long long ld_h,
                 const float* __restrict__ beta_logit, long long ld_beta,
                 const float* __restrict__ pctx, const CtxT* __restrict__ ctx,
                 const float* __restrict__ mask,
                 const float* __restrict__ u_att,
                 const float* __restrict__ c_att,
                 const float* __restrict__ b_sel, int selector,
                 float* __restrict__ ctx_t, float* __restrict__ alpha,
                 int nb, int k, int a, int dc) {
  extern __shared__ float smem[];
  float* h_s = smem;            // (nb, a) beam states of this row
  float* al_s = smem + nb * a;  // (nb, k) scores, then alpha
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = static_cast<long long>(b) * nb;

  for (int i = tid; i < nb * a; i += kThreads) {
    const int j = i / a;
    h_s[i] = h_att[(row0 + j) * ld_h + (i - j * a)];
  }
  __syncthreads();

  // scores: a warp per frame, every beam against one read of pctx[b, k]
  const float c0 = *c_att;
  const float* prow0 = pctx + static_cast<long long>(b) * k * a;
  for (int kk = warp; kk < k; kk += kWarps) {
    const float* prow = prow0 + static_cast<long long>(kk) * a;
    float acc[kMaxBeams];
#pragma unroll
    for (int j = 0; j < kMaxBeams; ++j) acc[j] = 0.f;
    for (int col = lane; col < a; col += 32) {
      const float p = prow[col];
      const float u = u_att[col];
#pragma unroll
      for (int j = 0; j < kMaxBeams; ++j)
        if (j < nb) acc[j] += tanhf(p + h_s[j * a + col]) * u;
    }
#pragma unroll
    for (int j = 0; j < kMaxBeams; ++j) {
      if (j < nb) {
        const float s = lane_sum(acc[j]);
        if (lane == 0) al_s[j * k + kk] = s + c0;
      }
    }
  }
  __syncthreads();

  // masked softmax over K: a warp per beam
  const float* mrow = mask + static_cast<long long>(b) * k;
  for (int j = warp; j < nb; j += kWarps) {
    float* srow = al_s + j * k;
    float m = -INFINITY;
    for (int kk = lane; kk < k; kk += 32)
      m = fmaxf(m, mrow[kk] > 0.f ? srow[kk] : kNegInf);
    m = lane_max(m);
    float sum = 0.f;
    for (int kk = lane; kk < k; kk += 32) {
      const float ex = mrow[kk] > 0.f ? expf(srow[kk] - m) : 0.f;
      srow[kk] = ex;
      sum += ex;
    }
    const float denom = fmaxf(lane_sum(sum), 1e-20f);
    for (int kk = lane; kk < k; kk += 32) {
      const float al = srow[kk] / denom;
      srow[kk] = al;
      alpha[(row0 + j) * k + kk] = al;
    }
  }
  __syncthreads();

  // ctx_t = gate * sum_k alpha_k ctx_k: threads stride over Dc
  float gate[kMaxBeams];
#pragma unroll
  for (int j = 0; j < kMaxBeams; ++j) {
    gate[j] = 1.f;
    if (selector && j < nb)
      gate[j] = 1.f / (1.f + expf(-(beta_logit[(row0 + j) * ld_beta] + *b_sel)));
  }
  const CtxT* crow = ctx + static_cast<long long>(b) * k * dc;
  for (int d = tid; d < dc; d += kThreads) {
    float acc[kMaxBeams];
#pragma unroll
    for (int j = 0; j < kMaxBeams; ++j) acc[j] = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const float cv = to_f32(crow[static_cast<long long>(kk) * dc + d]);
#pragma unroll
      for (int j = 0; j < kMaxBeams; ++j)
        if (j < nb) acc[j] += al_s[j * k + kk] * cv;
    }
#pragma unroll
    for (int j = 0; j < kMaxBeams; ++j)
      if (j < nb) ctx_t[(row0 + j) * dc + d] = acc[j] * gate[j];
  }
}

template <typename CtxT>
cudaError_t launch(const void* h_att, long long ld_h, const void* beta_logit,
                   long long ld_beta, const void* pctx, const void* ctx,
                   const void* mask, const void* u_att, const void* c_att,
                   const void* b_sel, int selector, void* ctx_t, void* alpha,
                   int bc, int nb, int k, int a, int dc, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nb) * (a + k) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_core_kernel<CtxT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  attn_core_kernel<CtxT><<<bc, kThreads, smem, stream>>>(
      static_cast<const float*>(h_att), ld_h,
      static_cast<const float*>(beta_logit), ld_beta,
      static_cast<const float*>(pctx), static_cast<const CtxT*>(ctx),
      static_cast<const float*>(mask), static_cast<const float*>(u_att),
      static_cast<const float*>(c_att), static_cast<const float*>(b_sel),
      selector, static_cast<float*>(ctx_t), static_cast<float*>(alpha), nb, k,
      a, dc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route "cluster"
// ---------------------------------------------------------------------------

// Warps of a CTA: 4 for A and Dc up to 1024, 8 up to 2048 (score chunks
// per row must divide it; a thread holds 8 columns of Dc).
constexpr int kClWarps = 4;
constexpr int kClWideWarps = 8;
constexpr int kMaxSplits = 4;  // CTAs of a cluster (one row)

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Shared memory of route "cluster": the mbarrier in 16 bytes, the ctx
// slice (kc, Dc) and after it, in the same bytes, the float32 partial
// sums o (nb, Dc); then partial scores (nb, kc, chunks), scores / weights
// (nb, kc) and five nb-vectors (local max, cluster max, local sum,
// denominator, gate).  stvd_torch/model/kernel.py:_cluster_smem
// repeats this.
__host__ __device__ inline size_t slab_region(int nb, int kc, int dc,
                                              size_t ctx_bytes) {
  const size_t slab = static_cast<size_t>(kc) * dc * ctx_bytes;
  const size_t o = 4 * static_cast<size_t>(nb) * dc;
  return slab > o ? slab : o;
}

inline size_t cluster_smem(int nb, int kc, int dc, int nq, size_t ctx_bytes) {
  return 16 + slab_region(nb, kc, dc, ctx_bytes) +
         4 * (static_cast<size_t>(nb) * kc * (nq + 1) + 5 * nb);
}

template <int NB, int WARPS, typename CtxT>
__global__ void __launch_bounds__(32 * WARPS)
attn_core_cluster(const float* __restrict__ h_att, long long ld_h,
                  const float* __restrict__ beta_logit, long long ld_beta,
                  const float* __restrict__ pctx,
                  const CtxT* __restrict__ ctx,
                  const float* __restrict__ mask,
                  const float* __restrict__ u_att,
                  const float* __restrict__ c_att,
                  const float* __restrict__ b_sel, int selector,
                  float* __restrict__ ctx_t, float* __restrict__ alpha, int k,
                  int a, int dc, int kc, int nq) {
  constexpr int kClThreads = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char cl_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const uint32_t bar = smem_u32(cl_smem);
  // the ctx slice (kc, Dc), then in its place the partial sums o (NB, Dc)
  CtxT* slab = reinterpret_cast<CtxT*>(cl_smem + 16);
  float* o = reinterpret_cast<float*>(cl_smem + 16);
  float* part = reinterpret_cast<float*>(
      cl_smem + 16 + slab_region(NB, kc, dc, sizeof(CtxT)));   // (NB, kc, nq)
  float* sc = part + NB * kc * nq;                              // (NB, kc)
  float* mx = sc + NB * kc;       // local masked max per beam
  float* gm = mx + NB;            // cluster max
  float* ls = gm + NB;            // local sum of weights
  float* dn = ls + NB;            // cluster denominator
  float* gt = dn + NB;            // selector gate
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x / splits;
  const int k0 = rank * kc;
  const int nk = min(k, k0 + kc) - k0;    // >= 1 (the host's plan)
  const long long row0 = b * NB;
  const long long f0 = b * k + k0;        // first frame of this CTA
  const uint32_t slab_bytes =
      static_cast<uint32_t>(static_cast<size_t>(nk) * dc * sizeof(CtxT));
  const float c0 = *c_att;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {   // ctx lands while the scores run
    mbar_expect_tx(bar, slab_bytes);
    bulk_load(smem_u32(slab), ctx + f0 * dc, slab_bytes, bar);
    prefetch_l2(pctx + f0 * a, static_cast<uint32_t>(4ll * nk * a));
  }
  const int q = warp & (nq - 1);
  const int qshift = __ffs(nq) - 1;
  ScoreLane<NB> lanes;
  lanes.load(h_att, ld_h, row0, u_att, q, lane, a);

  // scores: units of (frame, chunk), frame-major, dealt to the warps
  const int units = nk * nq;
  const float* pbase = pctx + f0 * a;
  float4 pa, pb;
  if (warp < units)
    load_row(pbase + static_cast<long long>(warp >> qshift) * a, q, lane, a,
             pa, pb);
  for (int u = warp; u < units; u += WARPS) {
    const int f = u >> qshift;
    const int un = u + WARPS;
    float4 na, nb4;
    if (un < units)
      load_row(pbase + static_cast<long long>(un >> qshift) * a, q, lane, a,
               na, nb4);
    float acc[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j] = lanes.usum;
    lanes.score(pa, pb, acc, h_att, ld_h, row0, q, lane, a);
    store_beam_sums<NB>(acc, lane, part + f * nq + q, kc * nq);
    pa = na;
    pb = nb4;
  }
  __syncthreads();
  for (int i = tid; i < NB * nk; i += kClThreads) {
    const int j = i / nk;
    const int f = i - j * nk;
    float v = c0;
    for (int qq = 0; qq < nq; ++qq) v += part[(j * kc + f) * nq + qq];
    sc[j * kc + f] = mask[f0 + f] > 0.f ? v : kNegInf;
  }
  __syncthreads();
  if (tid < NB) {
    float m = -INFINITY;
    for (int f = 0; f < nk; ++f) m = fmaxf(m, sc[tid * kc + f]);
    mx[tid] = m;
  }
  cluster.sync();   // every CTA's local max is out

  if (tid < NB) {
    float m = -INFINITY;
    for (int c = 0; c < splits; ++c)
      m = fmaxf(m, *cluster.map_shared_rank(mx + tid, c));
    gm[tid] = m;
  }
  __syncthreads();
  for (int i = tid; i < NB * nk; i += kClThreads) {
    const int j = i / nk;
    const int f = i - j * nk;
    sc[j * kc + f] =
        mask[f0 + f] > 0.f ? expf(sc[j * kc + f] - gm[j]) : 0.f;
  }
  __syncthreads();
  if (tid < NB) {
    float l = 0.f;
    for (int f = 0; f < nk; ++f) l += sc[tid * kc + f];
    ls[tid] = l;
  }
  // o = sum_f p_f ctx_f over this CTA's frames: a thread per 8 columns
  // (Dc <= 8 * 32 * WARPS), held in registers until every thread has read
  // the slab, then written over it
  mbar_wait(bar, 0);
  const int d8 = tid;
  const bool col = d8 < dc / 8;
  float acc[NB][8];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
  if (col) {
    for (int f = 0; f < nk; ++f) {
      float v[8];
      load8(slab + static_cast<long long>(f) * dc + 8 * d8, v);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float pj = sc[j * kc + f];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(pj, v[i], acc[j][i]);
      }
    }
  }
  __syncthreads();   // the slab is read: o takes its place
  if (col) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float4* dst = reinterpret_cast<float4*>(o + j * dc + 8 * d8);
      dst[0] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      dst[1] = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
    }
  }
  cluster.sync();   // every CTA's partial sums and weights are out

  if (tid < NB) {
    float l = 0.f;
    for (int c = 0; c < splits; ++c) l += *cluster.map_shared_rank(ls + tid, c);
    dn[tid] = fmaxf(l, 1e-20f);
    gt[tid] = selector ? 1.f / (1.f + expf(-(beta_logit[(row0 + tid) * ld_beta]
                                             + *b_sel)))
                       : 1.f;
  }
  __syncthreads();
  for (int i = tid; i < NB * nk; i += kClThreads) {
    const int j = i / nk;
    const int f = i - j * nk;
    alpha[(row0 + j) * k + k0 + f] = sc[j * kc + f] / dn[j];
  }
  // this CTA's share of the Dc columns, summed over the CTAs in rank order
  const int per = (dc / 4 + splits - 1) / splits * 4;
  const int d_lo = rank * per;
  const int d_hi = min(dc, d_lo + per);
  const int n4 = d_hi > d_lo ? (d_hi - d_lo) / 4 : 0;
  for (int i = tid; i < NB * n4; i += kClThreads) {
    const int j = i / n4;
    const int d = d_lo + 4 * (i - j * n4);
    float4 w[kMaxSplits];    // every CTA's read in flight, then the sum
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c)
      if (c < splits)
        w[c] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(o + j * dc + d, c));
    float4 v = w[0];
#pragma unroll
    for (int c = 1; c < kMaxSplits; ++c) {
      if (c < splits) {
        v.x += w[c].x;
        v.y += w[c].y;
        v.z += w[c].z;
        v.w += w[c].w;
      }
    }
    const float g = gt[j];
    const float den = dn[j];
    *reinterpret_cast<float4*>(ctx_t + (row0 + j) * dc + d) =
        make_float4(v.x / den * g, v.y / den * g, v.z / den * g,
                    v.w / den * g);
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

template <int NB, int WARPS, typename CtxT>
cudaError_t launch_cluster_nb(const void* h_att, long long ld_h,
                              const void* beta_logit, long long ld_beta,
                              const void* pctx, const void* ctx,
                              const void* mask, const void* u_att,
                              const void* c_att, const void* b_sel,
                              int selector, void* ctx_t, void* alpha, int bc,
                              int k, int a, int dc, int kc,
                              cudaStream_t stream) {
  const int nq = score_chunks(a);
  const int splits = (k + kc - 1) / kc;
  const size_t smem = cluster_smem(NB, kc, dc, nq, sizeof(CtxT));
  auto kern = attn_core_cluster<NB, WARPS, CtxT>;
  static std::atomic<int> allowed[kMaxDevices];
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(bc * splits));
  cfg.blockDim = dim3(32 * WARPS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(h_att), ld_h,
      static_cast<const float*>(beta_logit), ld_beta,
      static_cast<const float*>(pctx), static_cast<const CtxT*>(ctx),
      static_cast<const float*>(mask), static_cast<const float*>(u_att),
      static_cast<const float*>(c_att), static_cast<const float*>(b_sel),
      selector, static_cast<float*>(ctx_t), static_cast<float*>(alpha), k, a,
      dc, kc, nq);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename CtxT>
cudaError_t launch_cluster(const void* h_att, long long ld_h,
                           const void* beta_logit, long long ld_beta,
                           const void* pctx, const void* ctx, const void* mask,
                           const void* u_att, const void* c_att,
                           const void* b_sel, int selector, void* ctx_t,
                           void* alpha, int bc, int nb, int k, int a, int dc,
                           int kc, cudaStream_t stream) {
  const int splits = kc >= 1 ? (k + kc - 1) / kc : 0;
  if (kc < 1 || splits > kMaxSplits || a % 8 || dc % 8 ||
      a > 256 * kClWideWarps || dc > 8 * 32 * kClWideWarps ||
      !aligned16(pctx) || !aligned16(ctx) ||
      cluster_smem(nb, kc, dc, score_chunks(a), sizeof(CtxT)) > kSmemLimit ||
      static_cast<long long>(bc) * splits > 2147483647LL)
    return cudaErrorInvalidValue;
  // the four-warp CTA where it covers A and Dc, so those shapes keep
  // their instantiation; eight warps above
  const bool wide = a > 256 * kClWarps || dc > 8 * 32 * kClWarps;
#define STVD_NB(N)                                                            \
  case N:                                                                     \
    return wide ? launch_cluster_nb<N, kClWideWarps, CtxT>(                   \
                      h_att, ld_h, beta_logit, ld_beta, pctx, ctx, mask,      \
                      u_att, c_att, b_sel, selector, ctx_t, alpha, bc, k, a,  \
                      dc, kc, stream)                                         \
                : launch_cluster_nb<N, kClWarps, CtxT>(                       \
                      h_att, ld_h, beta_logit, ld_beta, pctx, ctx, mask,      \
                      u_att, c_att, b_sel, selector, ctx_t, alpha, bc, k, a,  \
                      dc, kc, stream);
  switch (nb) {
    STVD_NB(1) STVD_NB(2) STVD_NB(3) STVD_NB(4)
    STVD_NB(5) STVD_NB(6) STVD_NB(7) STVD_NB(8)
  }
#undef STVD_NB
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The device tanh of the score pass, alone (for a sweep against torch.tanh)
// ---------------------------------------------------------------------------

template <int kMode>
__global__ void tanh_kernel(const float* __restrict__ p,
                            const float* __restrict__ h, float* __restrict__ y,
                            long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const float pv = p[i];
  const float hv = h[i];
  y[i] = kMode == 0 ? split_tanh(pv, hv)
         : kMode == 1
             ? fmaf(-2.f, inv_one_plus_ex2(kTwoLog2e * (pv + hv)), 1.f)
             : tanhf(pv + hv);
}

}  // namespace

extern "C" int stvd_attn_core_max_beams() { return kMaxBeams; }

// For n floats p and h: y = tanh(p + h) by the score pass's product form
// (mode 0, which takes the single-exponent form out of its range), by the
// single-exponent form alone (mode 1), or by libdevice's tanhf of fl(p +
// h) (mode 2).  Returns the launch's cudaError_t.
extern "C" int stvd_tanh_f32(const void* p, const void* h, void* y,
                             long long n, int mode, void* stream) {
  if (n < 1 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(p);
  const float* hf = static_cast<const float*>(h);
  float* yf = static_cast<float*>(y);
  if (mode == 0)
    tanh_kernel<0><<<blocks, 256, 0, st>>>(pf, hf, yf, n);
  else if (mode == 1)
    tanh_kernel<1><<<blocks, 256, 0, st>>>(pf, hf, yf, n);
  else
    tanh_kernel<2><<<blocks, 256, 0, st>>>(pf, hf, yf, n);
  return static_cast<int>(cudaGetLastError());
}

// Route 0 is "cluster", 1 "simple" (stvd_torch/model/kernel.py:
// ATTENTION_CORE_ROUTES); kc is route "cluster"'s frames per CTA.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int stvd_attn_core(const void* h_att, long long ld_h,
                              const void* beta_logit, long long ld_beta,
                              const void* pctx, const void* ctx, int ctx_bf16,
                              const void* mask, const void* u_att,
                              const void* c_att, const void* b_sel,
                              int selector, void* ctx_t, void* alpha, int bc,
                              int nb, int k, int a, int dc, int route, int kc,
                              void* stream) {
  if (bc < 1 || nb < 1 || nb > kMaxBeams || k < 1 || a < 1 || dc < 1 ||
      (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == 0)
    e = ctx_bf16 ? launch_cluster<__nv_bfloat16>(
                       h_att, ld_h, beta_logit, ld_beta, pctx, ctx, mask,
                       u_att, c_att, b_sel, selector, ctx_t, alpha, bc, nb, k,
                       a, dc, kc, s)
                 : launch_cluster<float>(h_att, ld_h, beta_logit, ld_beta,
                                         pctx, ctx, mask, u_att, c_att, b_sel,
                                         selector, ctx_t, alpha, bc, nb, k, a,
                                         dc, kc, s);
  else
    e = ctx_bf16 ? launch<__nv_bfloat16>(h_att, ld_h, beta_logit, ld_beta,
                                         pctx, ctx, mask, u_att, c_att, b_sel,
                                         selector, ctx_t, alpha, bc, nb, k, a,
                                         dc, s)
                 : launch<float>(h_att, ld_h, beta_logit, ld_beta, pctx, ctx,
                                 mask, u_att, c_att, b_sel, selector, ctx_t,
                                 alpha, bc, nb, k, a, dc, s);
  return static_cast<int>(e);
}
