// Fused logit tail of the decode step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stvd/model/kernel.py:_make_tail_kernel
// (pallas_call in _tail_pallas_call, built by make_logit_tail).  For an
// activation x (rows, dw) and the vocab projection W (dw, V), b (V,):
//
//   logits = x @ W + b                       (never written to memory)
//   lse    = logsumexp(logits) per row
//   vals, idx = exact top-k of logits per row (k <= 8), ordered by value
//               descending, ties to the lowest column (lax.top_k order)
//
// with the plain PyTorch version in stvd_torch/model/kernel.py:_logit_tail_plain.
//
// The TPU grid ran vocab tiles in order and carried a running (max,
// sumexp, top-k) through scratch; Hopper blocks run in no order, so the
// work is two passes: a tile pass writes one partial (max, sumexp, top-k
// values, top-k columns) per (row, vocab strip) into scratch the wrapper
// allocates, and tail_merge_kernel (a warp per row) combines the partials:
// the rescaled logsumexp lse = m + log(max(s, 1e-38)) and a k-way top-k
// merge in the same (value desc, column asc) order.  Columns >= V are
// masked inside the kernels.
//
// Bound: at rows=1280, dw=512, V=13056 the product is 2*1280*512*13056 =
// 17 GFLOP and W is 13.4 MB (bf16): ~17 us at the bf16 tensor-core peak,
// ~4 us of HBM.  x and W fit the 50 MB L2, so the tiles re-read them from
// there.  Three routes, picked by the caller from dtype, widths and
// alignment (stvd_torch/model/kernel.py:logit_tail_route):
//
// * wgmma (bf16; rows of x and W at strides of whole 16 bytes, 16-byte
//   aligned bases): a persistent, warp-specialised kernel.  A ragged dw or
//   V (the reference recipes' 468 and 13010 / 20000) comes in rows padded
//   to 128 bytes (stvd_torch/model/step.py:pad_cols); the tensor
//   maps keep the logical widths, so TMA fills zeros past them.  A tile
//   is 128 rows x 256 vocab columns; one producer thread streams 64-deep
//   stages of x (K-major) and W (MN-major: its transpose bit is set, so W
//   is never transposed) by TMA into a 4-stage mbarrier ring, and two
//   consumer warpgroups each run m64n256k16 wgmma on them.  The epilogue
//   stays in registers: in the accumulator layout a row's 256 columns sit
//   in the four lanes of one quad, so each thread keeps a sorted top-k and
//   (max, sumexp) over its 64 columns of each of its two rows, and the
//   quad merges them by shuffles.
//   The block walks tiles with its ring running on, so the next tile's
//   loads overlap this tile's epilogue.
// * wmma (other bf16): one block per 64-row x 128-column tile, logits into
//   shared memory through nvcuda::wmma (scalar staging, two barriers per
//   32-deep slice), then a warp per row takes k rounds of a warp-wide
//   arg-best, each restricted to candidates strictly after the previous
//   winner in (value desc, column asc) order.
// * f32: the same tile kernel with float32 FMAs (the parity runs).

#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;             // rows per tile
constexpr int BN = 128;            // vocab columns per tile
constexpr int LDC = BN + 4;        // padded row of the logits tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;
constexpr int kNoIdx = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileBytes = BM * LDC * 4;
constexpr int kStageBytes = 12288;  // A + B staging of either GEMM below

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (v, i) comes before (pv, pi): value descending, then column ascending
__device__ __forceinline__ bool before(float v, int i, float pv, int pi) {
  return v > pv || (v == pv && i < pi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Stage a (BM x bk) tile of x and a (bk x BN) tile of W, zero-filled
// outside the matrices; rows of x are ldx elements apart, rows of W ldw.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const T* __restrict__ w, T* a_s, T* b_s,
                                      int bk, int rows, int dw, int v, int ldx,
                                      int ldw, int m0, int n0, int k0) {
  const T zero = T(0.f);
  for (int i = threadIdx.x; i < BM * bk; i += kThreads) {
    const int r = i / bk, c = i - r * bk;
    const int gr = m0 + r, gc = k0 + c;
    a_s[i] = (gr < rows && gc < dw)
                 ? x[static_cast<long long>(gr) * ldx + gc] : zero;
  }
  for (int i = threadIdx.x; i < bk * BN; i += kThreads) {
    const int r = i / BN, c = i - r * BN;
    const int gr = k0 + r, gc = n0 + c;
    b_s[i] = (gr < dw && gc < v)
                 ? w[static_cast<long long>(gr) * ldw + gc] : zero;
  }
}

// bf16 logits tile on the tensor cores: 8 warps, each a 16-row strip of
// four 16x16 accumulators.
__device__ void gemm_tile(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          unsigned char* stage_buf, float* c_s, int rows,
                          int dw, int v, int ldx, int ldw, int m0, int n0) {
  using namespace nvcuda;
  constexpr int BK = 32;
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(stage_buf);
  __nv_bfloat16* b_s = a_s + BM * BK;
  const int warp = threadIdx.x >> 5;
  const int wr = warp & 3;         // 16-row strip
  const int wc = (warp >> 2) * 4;  // first of four 16-column fragments
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int k0 = 0; k0 < dw; k0 += BK) {
    stage(x, w, a_s, b_s, BK, rows, dw, v, ldx, ldw, m0, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::load_matrix_sync(af, a_s + wr * 16 * BK + kk, BK);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, b_s + kk * BN + (wc + f) * 16, BN);
        wmma::mma_sync(acc[f], af, bf, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 4; ++f)
    wmma::store_matrix_sync(c_s + wr * 16 * LDC + (wc + f) * 16, acc[f], LDC,
                            wmma::mem_row_major);
}

// float32 logits tile with FMAs: each thread owns 4 rows x 8 columns
// (columns tx + 16 j, so a warp reads neighbouring shared-memory words).
__device__ void gemm_tile(const float* __restrict__ x,
                          const float* __restrict__ w,
                          unsigned char* stage_buf, float* c_s, int rows,
                          int dw, int v, int ldx, int ldw, int m0, int n0) {
  constexpr int BK = 16;
  float* a_s = reinterpret_cast<float*>(stage_buf);
  float* b_s = a_s + BM * BK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < dw; k0 += BK) {
    stage(x, w, a_s, b_s, BK, rows, dw, v, ldx, ldw, m0, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[(ty * 4 + i) * BK + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = b_s[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      c_s[(ty * 4 + i) * LDC + tx + 16 * j] = acc[i][j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ part_m,
                 float* __restrict__ part_s, float* __restrict__ part_v,
                 int* __restrict__ part_i, int rows, int dw, int v, int ldx,
                 int ldw, int ksel, int ntiles) {
  __shared__ __align__(128) unsigned char smem[kTileBytes + kStageBytes];
  float* c_s = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  gemm_tile(x, w, smem + kTileBytes, c_s, rows, dw, v, ldx, ldw, m0, n0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < BM; r += kWarps) {
    const int gr = m0 + r;
    if (gr >= rows) break;
    float val[BN / 32];
    int col[BN / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      const int c = lane + 32 * q;
      const int gc = n0 + c;
      if (gc < v) {
        val[q] = c_s[r * LDC + c] + bias[gc];
        col[q] = gc;
      } else {
        val[q] = -INFINITY;
        col[q] = kNoIdx;
      }
      mx = fmaxf(mx, val[q]);
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q)
      if (col[q] != kNoIdx) s += expf(val[q] - mx);
    s = warp_sum(s);
    const long long slot = static_cast<long long>(gr) * ntiles + blockIdx.y;
    if (lane == 0) {
      part_m[slot] = mx;
      part_s[slot] = s;
    }
    float pv = 0.f;
    int pi = 0;
    for (int t = 0; t < ksel; ++t) {
      float bv = -INFINITY;
      int bi = kNoIdx;
#pragma unroll
      for (int q = 0; q < BN / 32; ++q)
        if ((t == 0 || before(pv, pi, val[q], col[q])) &&
            before(val[q], col[q], bv, bi)) {
          bv = val[q];
          bi = col[q];
        }
      warp_best(bv, bi);
      if (lane == 0) {
        part_v[slot * ksel + t] = bv;
        part_i[slot * ksel + t] = bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tail_merge_kernel(const float* __restrict__ part_m,
                  const float* __restrict__ part_s,
                  const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ vals,
                  long long* __restrict__ idx, float* __restrict__ lse,
                  int rows, int ntiles, int ksel) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float* pm = part_m + static_cast<long long>(r) * ntiles;
  const float* ps = part_s + static_cast<long long>(r) * ntiles;
  float m = -INFINITY;
  for (int t = lane; t < ntiles; t += 32) m = fmaxf(m, pm[t]);
  m = warp_max(m);
  float s = 0.f;
  for (int t = lane; t < ntiles; t += 32) s += ps[t] * expf(pm[t] - m);
  s = warp_sum(s);
  if (lane == 0) lse[r] = m + logf(fmaxf(s, 1e-38f));

  const int nc = ntiles * ksel;
  const float* cv = part_v + static_cast<long long>(r) * nc;
  const int* ci = part_i + static_cast<long long>(r) * nc;
  float pv = 0.f;
  int pi = 0;
  for (int t = 0; t < ksel; ++t) {
    float bv = -INFINITY;
    int bi = kNoIdx;
    for (int c = lane; c < nc; c += 32) {
      const float v = cv[c];
      const int i = ci[c];
      if ((t == 0 || before(pv, pi, v, i)) && before(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      vals[static_cast<long long>(r) * ksel + t] = bv;
      idx[static_cast<long long>(r) * ksel + t] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

// ---------------------------------------------------------------------------
// Route wgmma: TMA + mbarrier ring + wgmma, persistent and warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;             // rows per tile: two warpgroups
constexpr int kWgCols = 256;             // vocab columns per tile (a strip)
constexpr int kWgK = 64;                 // dw per stage: 128 bytes of bf16
constexpr int kWgRing = 4;               // stages
constexpr int kWgABytes = kWgRows * kWgK * 2;           // 16 KB, one box
constexpr int kWgBBoxBytes = 64 * kWgK * 2;             // 8 KB
constexpr int kWgStageBytes = kWgABytes + kWgCols / 64 * kWgBBoxBytes;
constexpr int kWgThreads = 384;          // warpgroups 0-1 consume, 2 loads
constexpr size_t kWgSmem = 1024 + kWgRing * kWgStageBytes + 2 * kWgRing * 8;

// Insert (v, c) into the descending list (lv, li) of K entries.  The
// caller visits its columns in ascending order, so v goes above an equal
// value only if it is strictly greater: ties keep the lower column first.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&lv)[K], int (&li)[K],
                                              float v, int c) {
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    const bool up = v > lv[t - 1];
    const bool here = v > lv[t];
    lv[t] = up ? lv[t - 1] : (here ? v : lv[t]);
    li[t] = up ? li[t - 1] : (here ? c : li[t]);
  }
  if (v > lv[0]) {
    lv[0] = v;
    li[0] = c;
  }
}

// The quad's (four lanes') sorted lists -> the K best of their union in
// (value desc, column asc) order, written to slot by lane t % 4 in round t.
// All 32 lanes call it (shuffles); `live` says whether the row exists.
template <int K>
__device__ __forceinline__ void quad_topk(float (&lv)[K], int (&li)[K],
                                          bool live, float* __restrict__ pv,
                                          int* __restrict__ pi, int q) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    float bv = lv[0];
    int bi = li[0];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (li[0] == bi) {   // this lane held the winner: pop it
#pragma unroll
      for (int u = 0; u + 1 < K; ++u) {
        lv[u] = lv[u + 1];
        li[u] = li[u + 1];
      }
      lv[K - 1] = -INFINITY;
      li[K - 1] = kNoIdx;
    }
    if (live && q == (t & 3)) {
      pv[t] = bv;
      pi[t] = bi;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kWgThreads, 1)
tail_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ bias, float* __restrict__ part_m,
                  float* __restrict__ part_s, float* __restrict__ part_v,
                  int* __restrict__ part_i, int rows, int dw, int v,
                  int nstrips) {
  extern __shared__ unsigned char wg_smem[];
  // 128-byte swizzle atoms are 1024 bytes and must start 1024-aligned
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t full = base + kWgRing * kWgStageBytes;   // full[kWgRing]
  const uint32_t empty = full + kWgRing * 8;              // empty[kWgRing]
  const int nrt = (rows + kWgRows - 1) / kWgRows;
  const int ntiles = nrt * nstrips;
  const int nk = (dw + kWgK - 1) / kWgK;
  const int wg = threadIdx.x / 128;

  ring_init(full, kWgRing, 8);
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one thread issues every TMA load; the ring's
    // stage counter runs on across tiles
    producer_regs();
    if (threadIdx.x == 2 * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile % nrt) * kWgRows;
        const int n0 = (tile / nrt) * kWgCols;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % kWgRing;
          mbar_wait(empty + 8 * st, ((it / kWgRing) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, kWgStageBytes);
          const uint32_t a_s = base + st * kWgStageBytes;
          tma_load(a_s, &map_x, full + 8 * st, kt * kWgK, m0);
#pragma unroll
          for (int q = 0; q < kWgCols / 64; ++q)
            tma_load(a_s + kWgABytes + q * kWgBBoxBytes, &map_w,
                     full + 8 * st, n0 + 64 * q, kt * kWgK);
        }
      }
    }
    return;
  }

  // consumer warpgroups 0 and 1: rows m0 + 64 * wg ..
  consumer_regs();
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  float d[128];
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = (tile % nrt) * kWgRows;
    const int strip = tile / nrt;
    const int n0 = strip * kWgCols;
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % kWgRing;
      mbar_wait(full + 8 * st, (it / kWgRing) & 1);
      const uint32_t a_s = base + st * kWgStageBytes + wg * (kWgABytes / 2);
      const uint32_t b_s = base + st * kWgStageBytes + kWgABytes;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgK / 16; ++kk)
        // x K-major: a k16 step is 32 bytes of each 128-byte row; W
        // MN-major: 16 rows of 128 bytes
        wgmma_bf16_256<0, 1>(d, sw128_desc(a_s + kk * 32, 16, 1024),
                             sw128_desc(b_s + kk * 2048, kWgBBoxBytes, 1024));
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kWgRing));
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kWgRing));

    // Epilogue in registers.  d[4c + 2i + j] is row r_i = 16 warp + lane/4
    // + 8i of this warpgroup's 64, column 8 * c + 2q + j of the strip: a
    // thread holds 64 columns of each of its two rows, in ascending order
    // of (c, j), and the quad's four lanes hold the whole strip.
    const int r0 = m0 + wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    float lv0[K], lv1[K];
    int li0[K], li1[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      lv0[t] = lv1[t] = -INFINITY;
      li0[t] = li1[t] = kNoIdx;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < kWgCols / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + 8 * c + 2 * q + j;
        const bool in = col < v;
        const float b = in ? bias[col] : 0.f;
        const float v0 = in ? d[4 * c + j] + b : -INFINITY;
        const float v1 = in ? d[4 * c + 2 + j] + b : -INFINITY;
        d[4 * c + j] = v0;
        d[4 * c + 2 + j] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
        insert_sorted<K>(lv0, li0, v0, col);
        insert_sorted<K>(lv1, li1, v1, col);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
    }
    // column n0 < v lies in lane q = 0, so both maxima are finite
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int c = 0; c < kWgCols / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s0 += __expf(d[4 * c + j] - mx0);   // exp(-inf) = 0 past V
        s1 += __expf(d[4 * c + 2 + j] - mx1);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s0 += __shfl_xor_sync(kFull, s0, o);
      s1 += __shfl_xor_sync(kFull, s1, o);
    }
    const bool live0 = r0 < rows, live1 = r0 + 8 < rows;
    const long long slot0 = static_cast<long long>(r0) * nstrips + strip;
    const long long slot1 = slot0 + 8LL * nstrips;
    quad_topk<K>(lv0, li0, live0, part_v + slot0 * K, part_i + slot0 * K, q);
    quad_topk<K>(lv1, li1, live1, part_v + slot1 * K, part_i + slot1 * K, q);
    if (q == 0) {
      if (live0) {
        part_m[slot0] = mx0;
        part_s[slot0] = s0;
      }
      if (live1) {
        part_m[slot1] = mx1;
        part_s[slot1] = s1;
      }
    }
  }
}

template <int K>
cudaError_t launch_wgmma_k(const CUtensorMap& map_x, const CUtensorMap& map_w,
                           const float* bias, float* part_m, float* part_s,
                           float* part_v, int* part_i, int rows, int dw, int v,
                           int nstrips, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      tail_wgmma_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmem));
  if (e != cudaSuccess) return e;
  const int ntiles = (rows + kWgRows - 1) / kWgRows * nstrips;
  const int sms = num_sms();
  tail_wgmma_kernel<K><<<ntiles < sms ? ntiles : sms, kWgThreads, kWgSmem,
                         stream>>>(map_x, map_w, bias, part_m, part_s, part_v,
                                   part_i, rows, dw, v, nstrips);
  return cudaGetLastError();
}

// The maps keep the logical widths dw and V over row strides ldx and ldw
// (multiples of 8): TMA fills zeros past dw in x and W and past V in W,
// whatever the padding of the rows holds.
cudaError_t launch_wgmma(const void* x, const void* w, const void* bias,
                         void* part_m, void* part_s, void* part_v,
                         void* part_i, void* vals, void* idx, void* lse,
                         int rows, int dw, int v, int ldx, int ldw, int ksel,
                         cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_map(&map_x, x, bf, rows, dw, kWgK, kWgRows,
                  CU_TENSOR_MAP_SWIZZLE_128B, ldx) ||
      !encode_map(&map_w, w, bf, dw, v, 64, kWgK, CU_TENSOR_MAP_SWIZZLE_128B,
                  ldw))
    return cudaErrorInvalidValue;
  // one instantiation per k: the per-thread top-k lists stay in registers
  typedef cudaError_t (*LaunchK)(const CUtensorMap&, const CUtensorMap&,
                                 const float*, float*, float*, float*, int*,
                                 int, int, int, int, cudaStream_t);
  static const LaunchK by_k[kMaxK] = {
      launch_wgmma_k<1>, launch_wgmma_k<2>, launch_wgmma_k<3>,
      launch_wgmma_k<4>, launch_wgmma_k<5>, launch_wgmma_k<6>,
      launch_wgmma_k<7>, launch_wgmma_k<8>};
  const int ns = (v + kWgCols - 1) / kWgCols;
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  const cudaError_t e =
      by_k[ksel - 1](map_x, map_w, static_cast<const float*>(bias), pm, ps,
                     pv, pi, rows, dw, v, ns, stream);
  if (e != cudaSuccess) return e;
  tail_merge_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      pm, ps, pv, pi, static_cast<float*>(vals), static_cast<long long*>(idx),
      static_cast<float*>(lse), rows, ns, ksel);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   void* part_m, void* part_s, void* part_v, void* part_i,
                   void* vals, void* idx, void* lse, int rows, int dw, int v,
                   int ldx, int ldw, int ksel, cudaStream_t stream) {
  const int ntiles = (v + BN - 1) / BN;
  const dim3 grid((rows + BM - 1) / BM, ntiles);
  tail_tile_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<float*>(part_m),
      static_cast<float*>(part_s), static_cast<float*>(part_v),
      static_cast<int*>(part_i), rows, dw, v, ldx, ldw, ksel, ntiles);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  tail_merge_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(vals), static_cast<long long*>(idx),
      static_cast<float*>(lse), rows, ntiles, ksel);
  return cudaGetLastError();
}

// Route numbers shared with stvd_torch/model/kernel.py:LOGIT_TAIL_ROUTES.
enum Route { kRouteWgmma = 0, kRouteMma = 1, kRouteF32 = 2 };

}  // namespace

// Number of per-row partials (vocab tiles or strips) the wrapper allocates
// for this route.
extern "C" int stvd_logit_tail_ntiles(int v, int route) {
  return route == kRouteWgmma ? (v + kWgCols - 1) / kWgCols
                              : (v + BN - 1) / BN;
}

// route kRouteWgmma / kRouteMma: x (rows, dw) and w (dw, v) bf16;
// kRouteF32: both float32.  Rows of x are ldx >= dw elements apart, rows
// of w ldw >= v (kRouteWgmma: both multiples of 8, so a ragged dw or V is
// served from padded rows).  bias (v,) float32.  Scratch, ntiles from
// stvd_logit_tail_ntiles: part_m, part_s (rows, ntiles) float32, part_v
// (rows, ntiles, ksel) float32, part_i (rows, ntiles, ksel) int32.
// Outputs: vals (rows, ksel) float32, idx (rows, ksel) int64, lse (rows,)
// float32.  Returns the cudaError_t of the launches (0 on success).
extern "C" int stvd_logit_tail(const void* x, const void* w, int route,
                               const void* bias, void* part_m, void* part_s,
                               void* part_v, void* part_i, void* vals,
                               void* idx, void* lse, int rows, int dw, int v,
                               int ksel, int ldx, int ldw, void* stream) {
  if (rows < 1 || dw < 1 || v < ksel || ksel < 1 || ksel > kMaxK ||
      ldx < dw || ldw < v)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma &&
      (ldx % 8 != 0 || ldw % 8 != 0 || !aligned16(x) || !aligned16(w)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == kRouteWgmma)
    e = launch_wgmma(x, w, bias, part_m, part_s, part_v, part_i, vals, idx,
                     lse, rows, dw, v, ldx, ldw, ksel, s);
  else if (route == kRouteMma)
    e = launch<__nv_bfloat16>(x, w, bias, part_m, part_s, part_v, part_i,
                              vals, idx, lse, rows, dw, v, ldx, ldw, ksel, s);
  else if (route == kRouteF32)
    e = launch<float>(x, w, bias, part_m, part_s, part_v, part_i, vals, idx,
                      lse, rows, dw, v, ldx, ldw, ksel, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
