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
// Mosaic's block rule; here a block reads the i/f/o/g blocks of the plain
// stack's transpose at rows g*dim + d, so precompute builds no interleaved
// copy.
//
// Bound: at preset 3 (rows 1280, Kx 5120, 4 dim 14336) a step does 188
// GFLOP and reads 147 MB of bf16 weights (73 MB int8): ~0.19 ms at the
// bf16 tensor-core peak, ~0.095 ms at the int8 peak; the product is
// compute-bound, and only wgmma reaches those rates.  Three routes, picked
// by the caller from mode, widths and alignment
// (stvd_torch/model/kernel.py:gates_route):
//
// * wgmma (bf16 and int8; TMA needs row strides of whole 16 bytes and
//   16-byte aligned bases): a persistent, warp-specialised kernel on
//   gates_wgmma.cuh's mainloop (shared with the train-scan tail).  A tile
//   is 128 rows x a strip of 64 dims, all four gates: 256 rows of the
//   stack's K-major (4 dim, Kx) transpose, read as four 64-row TMA boxes
//   from rows g*dim + d0.  A box may start at any row, so any dim is
//   served (an MN-major box would have to start its columns on a 16-byte
//   boundary, which dim 3518 puts off it); a Kx off the 16-byte
//   grid (the reference recipes' 5010 and 6034) comes in rows padded to
//   128 bytes, x and the transpose alike (stvd_torch/model/step.py:
//   padded, kmajor), the maps keeping the logical depth: rows a whole
//   128 bytes apart keep each box row on one 128-byte line (a stride of
//   16 bytes but not 128 made the bf16 kernel markedly slower).
//   One producer thread streams 128-byte-deep stages of x and w into a
//   4-stage mbarrier ring; two consumer warpgroups each run m64n256
//   wgmma on them (bf16 k16, int8 k32, both operands K-major, as wgmma
//   requires of 8-bit ones;
//   step.precompute and step.quantize_weights store the stacks so).  In
//   the accumulator layout a thread holds the same dim offsets in all
//   four 64-wide gate blocks, so the dequant and the LSTM pointwise run
//   in registers and h_t, c_t go out as float32 pairs: no trip of the
//   accumulators through shared memory.  The epilogue's operands (c_prev
//   into registers; bias and the int8 scales into a small shared buffer)
//   are loaded before the tile's products, so their latency hides behind
//   the mainloop; it masks dims past dim.  The block walks tiles (row
//   tiles fastest, so concurrent tiles share their weight strips in L2)
//   with its ring running on across them.
// * wmma (bf16 and int8 operands TMA cannot describe: unaligned bases or
//   row strides off the 16-byte grid): gates_mma.cuh's 128-row x 32-dim
//   tiles through nvcuda::wmma and a 3-stage cp.async ring over dense x
//   and the dense (Kx, 4 dim) stack, with the epilogue through shared
//   memory.  It masks any ragged shape.
// * f32: gates_mma.cuh's FMA kernel (float32 operands).

#include "gates_mma.cuh"
#include "gates_wgmma.cuh"
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
// Route wgmma: gates_wgmma.cuh's mainloop, 128-row x 64-dim tiles (two
// consumer warpgroups), this epilogue in registers
// ---------------------------------------------------------------------------

// The epilogue's operands of a tile are loaded before its products: this
// thread's c_prev into registers; one tile column's bias and scale and one
// tile row's s_r, written after the products into a shared buffer (two,
// by tile parity).  Then the dequant as GatesEpi::pre does it, in the
// plain path's order, and the LSTM.  vec2: c_prev rows may be read as
// float pairs (dim even, 8-byte aligned).
template <bool kQuant>
struct GatesWgEpi {
  static constexpr int kDims = 64;
  static constexpr int kRows = 128;
  // bias and (int8) column scales of 256 columns, (int8) row scales of 128
  static constexpr int kParFloats = 2 * 4 * kDims + kRows;
  static constexpr int kSmemBytes = 2 * kParFloats * sizeof(float);

  GatesEpi<kQuant> pre_op;
  const float* __restrict__ c_prev;
  float* __restrict__ h_out;
  float* __restrict__ c_out;
  int vec2;

  struct Pre {
    float pb, ps, pr;
    float cp[2][8][2];
  };

  __device__ __forceinline__ void prefetch(Pre& p, const WgTile& t,
                                           unsigned char*, int rows,
                                           int dim) const {
    const int pd = t.d0 + (t.ct & 63);
    const int pcol = (t.ct >> 6) * dim + pd;
    p.pb = pd < dim ? pre_op.bias[pcol] : 0.f;
    p.ps = kQuant && pd < dim ? pre_op.scale[pcol] : 0.f;
    p.pr = kQuant && t.ct < kRows && t.m0 + t.ct < rows
               ? pre_op.s_r[t.m0 + t.ct]
               : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c0 = 0; c0 < 8; ++c0) {
        const int row = t.r0 + 8 * i;
        const int dd = t.d0 + 8 * c0 + 2 * t.q;
        const long long o = static_cast<long long>(row) * dim + dd;
        p.cp[i][c0][0] = p.cp[i][c0][1] = 0.f;
        if (row < rows && dd < dim) {
          if (vec2 && dd + 1 < dim) {
            const float2 v = *reinterpret_cast<const float2*>(c_prev + o);
            p.cp[i][c0][0] = v.x;
            p.cp[i][c0][1] = v.y;
          } else {
            p.cp[i][c0][0] = c_prev[o];
            if (dd + 1 < dim) p.cp[i][c0][1] = c_prev[o + 1];
          }
        }
      }
  }

  template <typename Acc>
  __device__ __forceinline__ void finish(const Acc* d, const Pre& p,
                                         const WgTile& t,
                                         unsigned char* smem, int rows,
                                         int dim) const {
    // This parity's buffer was last read in the tile before the previous
    // one, whose epilogue every consumer thread left before it reached
    // the previous tile's barrier.
    float* const pbuf =
        reinterpret_cast<float*>(smem) + t.parity * kParFloats;
    pbuf[t.ct] = p.pb;
    if (kQuant) {
      pbuf[4 * kDims + t.ct] = p.ps;
      if (t.ct < kRows) pbuf[8 * kDims + t.ct] = p.pr;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");   // consumers only

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = t.r0 + 8 * i;
      if (row >= rows) continue;
      const float sr = kQuant ? pbuf[8 * kDims + row - t.m0] : 0.f;
#pragma unroll
      for (int c0 = 0; c0 < 8; ++c0) {
        const int dd = t.d0 + 8 * c0 + 2 * t.q;
        if (dd >= dim) continue;
        const bool pair = dd + 1 < dim;
        float pre[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int tc = 64 * g + 8 * c0 + 2 * t.q + j;   // tile column
            const float acc =
                static_cast<float>(d[4 * (c0 + 8 * g) + 2 * i + j]);
            if constexpr (kQuant)
              pre[j][g] = __fadd_rn(
                  __fmul_rn(acc, __fmul_rn(sr, pbuf[4 * kDims + tc])),
                  pbuf[tc]);
            else
              pre[j][g] = __fadd_rn(acc, pbuf[tc]);
          }
        const long long o = static_cast<long long>(row) * dim + dd;
        float h[2], c[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          lstm_cell(pre[j][0], pre[j][1], pre[j][2], pre[j][3],
                    p.cp[i][c0][j], &h[j], &c[j]);
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
};

// x (rows, kx), rows ldx elements apart, is read K-major in boxes of 128
// rows x 128 bytes; w is the stack's K-major (4 dim, kx) transpose, rows
// ldw elements apart, in boxes of 64 rows x 128 bytes (a gate's block
// starts at row g dim).  Both maps keep the logical depth kx: TMA fills
// zeros past it, whatever the padding of the rows holds.
template <bool kQuant>
cudaError_t launch_wgmma(const void* x, const void* w,
                         const GatesEpi<kQuant>& pre_op, const void* c_prev,
                         void* h_out, void* c_out, int rows, int kx, int dim,
                         int ldx, int ldw, cudaStream_t stream) {
  using S = WgShape<2, 64, kQuant, true>;
  const CUtensorMapDataType type = kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap map_x, map_w;
  const bool ok =
      encode_map(&map_x, x, type, rows, kx, S::kDepth, S::kRows, sw, ldx) &&
      encode_map(&map_w, w, type, 4LL * dim, kx, S::kDepth, 64, sw, ldw);
  if (!ok) return cudaErrorInvalidValue;
  const int vec2 = dim % 2 == 0 &&
                   (reinterpret_cast<unsigned long long>(c_prev) & 7) == 0;
  const GatesWgEpi<kQuant> epi{pre_op, static_cast<const float*>(c_prev),
                               static_cast<float*>(h_out),
                               static_cast<float*>(c_out), vec2};
  return launch_wg_gates<2, 64, kQuant, true>(map_x, map_w, epi, rows, kx,
                                              dim, stream);
}

// Route numbers shared with stvd_torch/model/kernel.py:GATES_ROUTES.
enum Route { kRouteWgmma = 0, kRouteMma = 1, kRouteF32 = 2 };

}  // namespace

// mode: 0 float32, 1 bf16, 2 int8 (W8A8; s_r and scale are read only
// here).  route: kRouteWgmma (bf16 or int8; w the stack's K-major (4 dim,
// kx) transpose; rows of x ldx and of w ldw elements apart, each a
// multiple of 16 bytes), kRouteMma (bf16 or int8) and kRouteF32 (float32)
// with x dense (ldx == kx) and w the dense (kx, 4 dim) stack (ldw == 4
// dim).  Returns the cudaError_t of the launch (0 on success).
extern "C" int stvd_gates_lstm(const void* x, const void* w, int mode,
                               int route, const void* bias, const void* s_r,
                               const void* scale, const void* c_prev,
                               void* h_out, void* c_out, int rows, int kx,
                               int dim, int ldx, int ldw, void* stream) {
  if (rows < 1 || kx < 1 || dim < 1 || mode < 0 || mode > 2 ||
      (dim + kBD - 1) / kBD > 65535 || (route == kRouteF32) != (mode == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per16 = mode == 2 ? 16 : 8;   // elements in 16 bytes
  if (route == kRouteWgmma
          ? (ldx < kx || ldw < kx || ldx % per16 != 0 || ldw % per16 != 0 ||
             !aligned16(x) || !aligned16(w))
          : (ldx != kx || ldw != 4 * dim))
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
                                        ldx, ldw, st)
                  : launch_wgmma<true>(x, w, GatesEpi<true>{b, sr, sc},
                                       c_prev, h_out, c_out, rows, kx, dim,
                                       ldx, ldw, st);
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
