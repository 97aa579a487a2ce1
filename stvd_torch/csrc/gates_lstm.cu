// Fused LSTM gates + state update of the decode step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stvd/model/kernel.py:_make_gates_kernel
// (pallas_call in _gates_pallas_call, driven by gates_lstm_pallas).  Same
// contract, with the plain PyTorch version in
// stvd_torch/model/step.py:_gates_lstm:
//
//   acc    = x @ w                 x (rows, Kx) = [emb | h | ctx_t],
//                                  w (Kx, 4 dim) = [W; U; Wc]
//   pre    = acc + b                              float32 / bf16 modes
//   pre    = float(acc) * (s_r[row] * scale[col]) + b       int8 (W8A8)
//   i, f, o, g = sigmoid, sigmoid, sigmoid, tanh of the four column blocks
//   c_t    = f * c + i * g;   h_t = o * tanh(c_t)
//
// Modes: float32 operands with float32 FMAs (the parity run), bf16
// operands with float32 sums, int8 operands with int32 sums.  The int32
// sums are exact, and the dequant is written with __fmul_rn/__fadd_rn so
// it is never contracted into an FMA: the int8 epilogue rounds exactly as
// the plain path does.  x and its row scales are made by the caller with
// the plain path's own torch ops, so both paths see the same x_q.  Outputs
// h_t, c_t (rows, dim) float32; the (rows, 4 dim) preactivation never
// reaches memory.  The TPU kernel needed a gate-interleaved copy of w for
// Mosaic's block rule; here a block reads the i/f/o/g columns of the plain
// stack at column g*dim + d, so precompute builds no interleaved copy.
//
// Bound: at preset 3 (rows 1280, Kx 5120, 4 dim 14336) a step does 188
// GFLOP and reads 147 MB of bf16 weights (73 MB int8): ~0.19 ms at the
// bf16 tensor-core peak, ~0.095 ms at the int8 peak; the product is
// compute-bound, and only wgmma reaches those rates.  Three routes, picked
// by the caller from mode, widths and alignment
// (stvd_torch/model/kernel.py:gates_route):
//
// * wgmma (bf16 and int8; TMA needs row strides of whole 16 bytes and
//   16-byte aligned bases): a persistent, warp-specialised kernel.  A tile
//   is 128 rows x a strip of 64 dims, all four gates: 256 columns of w
//   read as four 64-wide TMA boxes at columns g*dim + d0.  One producer
//   thread streams 128-byte-deep stages of x and w into a 4-stage
//   mbarrier ring; two consumer warpgroups each run m64n256 wgmma on them
//   (bf16 k16 with W MN-major, its transpose bit set; int8 k32, where
//   wgmma takes only K-major operands, so the int8 grid is stored K-major,
//   (4 dim, Kx), by step.quantize_weights).  In the accumulator layout a
//   thread holds the same dim offsets in all four 64-wide gate blocks, so
//   the dequant and the LSTM pointwise run in registers and h_t, c_t go
//   out as float32 pairs: no trip of the accumulators through shared
//   memory.  The epilogue's operands (c_prev into registers; bias and the
//   int8 scales into a small shared buffer) are loaded before the tile's
//   products, so their latency hides behind the mainloop.  The block walks
//   tiles (row tiles fastest, so concurrent tiles share their weight
//   strips in L2) with its ring running on across them.
// * wmma (bf16 and int8 shapes TMA cannot describe: depths or dims off
//   the 16-byte grid, unaligned bases): gates_mma.cuh's 128-row x 32-dim
//   tiles through nvcuda::wmma and a 3-stage cp.async ring, with the
//   epilogue through shared memory.  It masks any ragged shape.
// * f32: gates_mma.cuh's FMA kernel (float32 operands).

#include "gates_mma.cuh"
#include "hopper.cuh"

namespace {

// bias, and under int8 the W8A8 dequant, in the plain path's order
template <bool kQuant>
struct GatesEpi {
  const float* __restrict__ bias;
  const float* __restrict__ s_r;
  const float* __restrict__ scale;

  template <typename A>
  __device__ __forceinline__ float pre(A acc, int row, int col) const {
    if constexpr (kQuant)
      return __fadd_rn(__fmul_rn(static_cast<float>(acc),
                                 __fmul_rn(s_r[row], scale[col])),
                       bias[col]);
    else
      return __fadd_rn(static_cast<float>(acc), bias[col]);
  }
  __device__ __forceinline__ void emit(int, int, float) const {}
};

// ---------------------------------------------------------------------------
// Route wgmma: TMA + mbarrier ring + wgmma, persistent and warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;          // rows per tile: two warpgroups
constexpr int kWgDims = 64;           // dims per tile, x 4 gates = n 256
constexpr int kWgRing = 4;            // stages
constexpr int kWgStageK = 128;        // bytes of depth per stage
constexpr int kWgABytes = kWgRows * kWgStageK;          // 16 KB
constexpr int kWgBoxBytes = kWgDims * kWgStageK;        // 8 KB
constexpr int kWgStageBytes = kWgABytes + 4 * kWgBoxBytes;   // 48 KB
constexpr int kWgThreads = 384;       // warpgroups 0-1 consume, 2 loads
// a tile's epilogue operands: bias and (int8) column scales of its 256
// columns, (int8) row scales of its 128 rows; two buffers, by tile parity
constexpr int kWgParFloats = 2 * 4 * kWgDims + kWgRows;
constexpr size_t kWgSmem = 1024 + kWgRing * kWgStageBytes + 2 * kWgRing * 8 +
                           2 * kWgParFloats * sizeof(float);

template <bool kQuant>
struct WgTypes;
template <>
struct WgTypes<false> {   // bf16: k16 steps, W (Kx, 4 dim) MN-major
  using Acc = float;
  static constexpr int kDepth = kWgStageK / 2;   // elements per stage
  static constexpr int kStep = 16;
};
template <>
struct WgTypes<true> {    // int8: k32 steps, W^T (4 dim, Kx) K-major
  using Acc = int;
  static constexpr int kDepth = kWgStageK;
  static constexpr int kStep = 32;
};

// x is read K-major: box (128 rows x 128 bytes).  w, bf16: box (64 depth
// rows x 64 columns) of the (Kx, 4 dim) stack; int8: box (64 rows x 128
// bytes) of the (4 dim, Kx) K-major grid.  vec2: c_prev rows may be read
// as float pairs (dim even, 8-byte aligned).
template <bool kQuant>
__global__ void __launch_bounds__(kWgThreads, 1)
gates_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   GatesEpi<kQuant> epi, const float* __restrict__ c_prev,
                   float* __restrict__ h_out, float* __restrict__ c_out,
                   int rows, int kx, int dim, int vec2) {
  using T = WgTypes<kQuant>;
  extern __shared__ unsigned char wg_smem[];
  // 128-byte swizzle atoms are 1024 bytes and must start 1024-aligned
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t full = base + kWgRing * kWgStageBytes;   // full[kWgRing]
  const uint32_t empty = full + kWgRing * 8;              // empty[kWgRing]
  const int nrt = (rows + kWgRows - 1) / kWgRows;
  const int ntiles = nrt * ((dim + kWgDims - 1) / kWgDims);
  const int nk = (kx + T::kDepth - 1) / T::kDepth;
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
        const int d0 = (tile / nrt) * kWgDims;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % kWgRing;
          mbar_wait(empty + 8 * st, ((it / kWgRing) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, kWgStageBytes);
          const uint32_t a_s = base + st * kWgStageBytes;
          const int k0 = kt * T::kDepth;
          tma_load(a_s, &map_x, full + 8 * st, k0, m0);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const uint32_t b_s = a_s + kWgABytes + g * kWgBoxBytes;
            if constexpr (kQuant)
              tma_load(b_s, &map_w, full + 8 * st, k0, g * dim + d0);
            else
              tma_load(b_s, &map_w, full + 8 * st, g * dim + d0, k0);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups 0 and 1: rows m0 + 64 * wg ..
  consumer_regs();
  const int ct = threadIdx.x;   // 0..255
  const int lane = ct & 31;
  const int q = lane & 3;
  float* const par = reinterpret_cast<float*>(
      wg_smem + (empty + kWgRing * 8 - smem_u32(wg_smem)));
  typename T::Acc d[128];
  int it = 0, parity = 0;
  for (int tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, parity ^= 1) {
    const int m0 = (tile % nrt) * kWgRows;
    const int d0 = (tile / nrt) * kWgDims;
    // d[4c + 2i + j] is row 16 warp + lane/4 + 8i of this warpgroup's 64,
    // column 8c + 2q + j of the tile's 256: gate g = c / 8, dim d0 +
    // 8 (c % 8) + 2q + j.  So with c = c0 + 8g a thread holds all four
    // gates of its dims, and the LSTM runs in registers.
    const int r0 = m0 + wg * 64 + ((ct & 127) >> 5) * 16 + (lane >> 2);

    // The epilogue's loads are issued before the products, so they land
    // while the ring runs: this thread's c_prev in registers; one tile
    // column's bias and scale and one tile row's s_r, for shared memory.
    const int pd = d0 + (ct & 63);
    const int pcol = (ct >> 6) * dim + pd;
    const float pb = pd < dim ? epi.bias[pcol] : 0.f;
    const float ps = kQuant && pd < dim ? epi.scale[pcol] : 0.f;
    const float pr =
        kQuant && ct < kWgRows && m0 + ct < rows ? epi.s_r[m0 + ct] : 0.f;
    float cp[2][8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c0 = 0; c0 < 8; ++c0) {
        const int row = r0 + 8 * i;
        const int dd = d0 + 8 * c0 + 2 * q;
        const long long o = static_cast<long long>(row) * dim + dd;
        cp[i][c0][0] = cp[i][c0][1] = 0.f;
        if (row < rows && dd < dim) {
          if (vec2 && dd + 1 < dim) {
            const float2 v = *reinterpret_cast<const float2*>(c_prev + o);
            cp[i][c0][0] = v.x;
            cp[i][c0][1] = v.y;
          } else {
            cp[i][c0][0] = c_prev[o];
            if (dd + 1 < dim) cp[i][c0][1] = c_prev[o + 1];
          }
        }
      }

#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % kWgRing;
      mbar_wait(full + 8 * st, (it / kWgRing) & 1);
      const uint32_t a_s = base + st * kWgStageBytes + wg * (kWgABytes / 2);
      const uint32_t b_s = base + st * kWgStageBytes + kWgABytes;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kDepth / T::kStep; ++kk) {
        // x K-major: a step is 32 bytes of each 128-byte row
        const uint64_t da = sw128_desc(a_s + kk * 32, 16, 1024);
        if constexpr (kQuant)   // W^T K-major, 256 rows of 128 bytes
          wgmma_s8_256(d, da, sw128_desc(b_s + kk * 32, 16, 1024));
        else                    // W MN-major: 16 rows of 128 bytes a step
          wgmma_bf16_256<0, 1>(d, da,
                               sw128_desc(b_s + kk * 2048, kWgBoxBytes, 1024));
      }
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kWgRing));
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kWgRing));

    // This parity's buffer was last read in the tile before the previous
    // one, whose epilogue every consumer thread left before it reached
    // the previous tile's barrier.
    float* const pbuf = par + parity * kWgParFloats;
    pbuf[ct] = pb;
    if (kQuant) {
      pbuf[4 * kWgDims + ct] = ps;
      if (ct < kWgRows) pbuf[8 * kWgDims + ct] = pr;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");   // consumers only

    // The dequant as GatesEpi::pre does it, in the plain path's order.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= rows) continue;
      const float sr = kQuant ? pbuf[8 * kWgDims + row - m0] : 0.f;
#pragma unroll
      for (int c0 = 0; c0 < 8; ++c0) {
        const int dd = d0 + 8 * c0 + 2 * q;
        if (dd >= dim) continue;
        const bool pair = dd + 1 < dim;
        float pre[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int t = 64 * g + 8 * c0 + 2 * q + j;   // tile column
            const float acc =
                static_cast<float>(d[4 * (c0 + 8 * g) + 2 * i + j]);
            if constexpr (kQuant)
              pre[j][g] = __fadd_rn(
                  __fmul_rn(acc, __fmul_rn(sr, pbuf[4 * kWgDims + t])),
                  pbuf[t]);
            else
              pre[j][g] = __fadd_rn(acc, pbuf[t]);
          }
        const long long o = static_cast<long long>(row) * dim + dd;
        float h[2], c[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          lstm_cell(pre[j][0], pre[j][1], pre[j][2], pre[j][3], cp[i][c0][j],
                    &h[j], &c[j]);
        if (vec2 && pair) {
          *reinterpret_cast<float2*>(h_out + o) = make_float2(h[0], h[1]);
          *reinterpret_cast<float2*>(c_out + o) = make_float2(c[0], c[1]);
        } else {
          h_out[o] = h[0];
          c_out[o] = c[0];
          if (pair) {
            h_out[o + 1] = h[1];
            c_out[o + 1] = c[1];
          }
        }
      }
    }
  }
}

// x (rows, kx); w: bf16 the (kx, 4 dim) stack, int8 its (4 dim, kx)
// K-major grid.
template <bool kQuant>
cudaError_t launch_wgmma(const void* x, const void* w,
                         const GatesEpi<kQuant>& epi, const void* c_prev,
                         void* h_out, void* c_out, int rows, int kx, int dim,
                         cudaStream_t stream) {
  using T = WgTypes<kQuant>;
  const CUtensorMapDataType type = kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_x, map_w;
  const bool ok =
      encode_map(&map_x, x, type, rows, kx, T::kDepth, kWgRows) &&
      (kQuant ? encode_map(&map_w, w, type, 4LL * dim, kx, T::kDepth, 64)
              : encode_map(&map_w, w, type, kx, 4LL * dim, 64, T::kDepth));
  if (!ok) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gates_wgmma_kernel<kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmem));
  if (e != cudaSuccess) return e;
  const int ntiles =
      (rows + kWgRows - 1) / kWgRows * ((dim + kWgDims - 1) / kWgDims);
  const int sms = num_sms();
  const int vec2 = dim % 2 == 0 &&
                   (reinterpret_cast<unsigned long long>(c_prev) & 7) == 0;
  gates_wgmma_kernel<kQuant><<<ntiles < sms ? ntiles : sms, kWgThreads,
                               kWgSmem, stream>>>(
      map_x, map_w, epi, static_cast<const float*>(c_prev),
      static_cast<float*>(h_out), static_cast<float*>(c_out), rows, kx, dim,
      vec2);
  return cudaGetLastError();
}

// Route numbers shared with stvd_torch/model/kernel.py:GATES_ROUTES.
enum Route { kRouteWgmma = 0, kRouteMma = 1, kRouteF32 = 2 };

}  // namespace

// mode: 0 float32, 1 bf16, 2 int8 (W8A8; s_r and scale are read only
// here).  route: kRouteWgmma (bf16 or int8; w bf16 the (kx, 4 dim) stack,
// int8 its (4 dim, kx) K-major grid), kRouteMma (bf16 or int8, w the
// (kx, 4 dim) stack), kRouteF32 (float32).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int stvd_gates_lstm(const void* x, const void* w, int mode,
                               int route, const void* bias, const void* s_r,
                               const void* scale, const void* c_prev,
                               void* h_out, void* c_out, int rows, int kx,
                               int dim, void* stream) {
  if (rows < 1 || kx < 1 || dim < 1 || mode < 0 || mode > 2 ||
      (dim + kBD - 1) / kBD > 65535 || (route == kRouteF32) != (mode == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma &&
      (kx % (mode == 2 ? 16 : 8) != 0 || (mode == 1 && dim % 2 != 0) ||
       !aligned16(x) || !aligned16(w)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* sr = static_cast<const float*>(s_r);
  const float* sc = static_cast<const float*>(scale);
  cudaError_t e;
  if (route == kRouteF32) {
    e = launch_gates_f32(x, w, GatesEpi<false>{b, sr, sc}, c_prev, h_out,
                         c_out, rows, kx, dim, st);
  } else if (route == kRouteWgmma) {
    e = mode == 1 ? launch_wgmma<false>(x, w, GatesEpi<false>{b, sr, sc},
                                        c_prev, h_out, c_out, rows, kx, dim,
                                        st)
                  : launch_wgmma<true>(x, w, GatesEpi<true>{b, sr, sc},
                                       c_prev, h_out, c_out, rows, kx, dim,
                                       st);
  } else if (route == kRouteMma) {
    e = mode == 1 ? launch_gates_typed<__nv_bfloat16>(
                        x, w, GatesEpi<false>{b, sr, sc}, c_prev, h_out,
                        c_out, rows, kx, dim, st)
                  : launch_gates_typed<signed char>(
                        x, w, GatesEpi<true>{b, sr, sc}, c_prev, h_out,
                        c_out, rows, kx, dim, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
