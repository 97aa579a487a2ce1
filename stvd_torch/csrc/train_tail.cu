// Tail of one teacher-forced train-scan step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stvd/model/kernel.py:_make_train_tail_kernel
// (pallas_call in _train_tail_pallas_call, driven by train_tail_pallas).
// Same contract, with the plain PyTorch version in
// stvd_torch/model/kernel.py:_train_tail_plain:
//
//   pre = (x_pre + h_gates) + ctx_t @ Wc        per gate column, this order
//   i, f, o, g = sigmoid, sigmoid, sigmoid, tanh of the four column blocks
//   c_t = f * c + i * g;   h_t = o * tanh(c_t)
//
// ctx_t (rows, dc) and Wc (dc, 4 dim) in the compute dtype (bf16 with
// float32 sums, or float32); x_pre (rows, 4 dim) and h_gates (a column
// view of the h-projection, read through its row stride) float32.  Outputs
// h_t, c_t (rows, dim) and pre (rows, 4 dim), float32: the residuals the
// hand-derived backward reads.  Unlike the TPU kernel it takes any dim and
// dc, not only multiples of 128.
//
// Bound: at training rows 64, dc 1024, 4 dim 14336, bf16 Wc, one call
// reads 29 MB of Wc and 7.5 MB of addends and writes 5.5 MB (~43 MB,
// ~0.013 ms at 3.35 TB/s); its 1.9 GFLOP are ~2 us of tensor-core time.
// So the kernel is bound by streaming Wc, and what matters is keeping
// enough of it in flight from enough SMs.  Three routes, picked by the
// caller from dtype, widths and alignment
// (stvd_torch/model/kernel.py:train_tail_route):
//
// * wgmma (bf16; TMA needs rows of whole 16 bytes and 16-byte aligned
//   ctx_t and Wc, and a box's first column on a 16-byte boundary, so dc
//   and dim multiples of 8: Wc's gate blocks start at g dim + d0):
//   gates_wgmma.cuh's
//   mainloop with one consumer warpgroup and tiles of 64 rows x 32 dims x
//   4 gates, so the 64 training rows fill the tile and the 3584 dims make
//   112 strips, one block each (row tiles fastest past 64 rows).  Wc's
//   32-column boxes are 64 bytes wide, 64-byte swizzled; six 24 KB stages
//   keep ~100 KB of Wc in flight a block.  Before its products a tile
//   issues its addends: c_prev into registers, x_pre (by 16-byte cp.async
//   where its rows allow) and h_gates (by 4-byte cp.async: its row stride,
//   4 dim + attn + 1 floats, is no multiple of 16 bytes, so TMA cannot
//   describe it) into shared memory, rows padded to 40 floats so the
//   epilogue's float pairs hit distinct banks.  A thread's accumulators
//   hold the same dims of all four gates, so the adds (in the plain path's
//   order, __fadd_rn), the pre store and the LSTM run in registers, and
//   pre, h_t and c_t go out as float pairs.
// * wmma (other bf16 shapes and unaligned bases): gates_mma.cuh's product
//   (128 rows x 32 dims x 4 gates a block, nvcuda::wmma, a 3-stage
//   cp.async ring, the epilogue through shared memory), any ragged shape.
// * f32: gates_mma.cuh's FMA kernel (float32 operands, the parity runs).

#include "gates_mma.cuh"
#include "gates_wgmma.cuh"
#include "hopper.cuh"

namespace {

struct TailEpi {
  const float* __restrict__ x_pre;
  long long ld_xp;
  const float* __restrict__ h_gates;
  long long ld_hg;
  float* __restrict__ pre_out;
  long long ld_pre;

  template <typename A>
  __device__ __forceinline__ float pre(A acc, int row, int col) const {
    const float add = __fadd_rn(x_pre[row * ld_xp + col],
                                h_gates[row * ld_hg + col]);
    return __fadd_rn(add, static_cast<float>(acc));
  }
  __device__ __forceinline__ void emit(int row, int col, float v) const {
    pre_out[row * ld_pre + col] = v;
  }
};

// ---------------------------------------------------------------------------
// Route wgmma: gates_wgmma.cuh's mainloop, 64-row x 32-dim tiles (one
// consumer warpgroup), this epilogue in registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;   // 0 source bytes: the 4 bytes are zeroed
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

struct TailWgEpi {
  static constexpr int kDims = 32;
  static constexpr int kRows = 64;
  static constexpr int kLd = kDims + 8;        // floats a staged row
  static constexpr int kGate = kRows * kLd;    // floats a gate's block
  // x_pre, then h_gates: 4 gate blocks each
  static constexpr int kSmemBytes = 2 * 4 * kGate * sizeof(float);

  const float* __restrict__ x_pre;
  long long ld_xp;
  const float* __restrict__ h_gates;
  long long ld_hg;
  const float* __restrict__ c_prev;
  float* __restrict__ h_out;
  float* __restrict__ c_out;
  float* __restrict__ pre_out;
  // The route takes dim % 8 == 0, so a thread's dim pair is whole and a
  // gate block of x_pre is whole 16-byte chunks.  vec2: c_prev and the
  // outputs 8-byte aligned (float pairs); vec4: x_pre's base 16-byte
  // aligned and its row stride whole 16 bytes (16-byte copies).
  int vec2;
  int vec4;

  struct Pre {
    float cp[2][4][2];
  };

  __device__ __forceinline__ void prefetch(Pre& p, const WgTile& t,
                                           unsigned char* smem, int rows,
                                           int dim) const {
    float* const xs = reinterpret_cast<float*>(smem);
    float* const hs = xs + 4 * kGate;
    // the previous tile's epilogue has read the buffers
    if (!t.first) asm volatile("bar.sync 1, 128;\n" ::: "memory");
    // x_pre and h_gates of the tile's 64 rows x 4 gates x 32 dims; rows
    // and dims past the edges are zero-filled (and never stored)
    if (vec4) {
#pragma unroll 4
      for (int k = 0; k < 4 * kRows * kDims / 4 / 128; ++k) {
        const int e = t.ct + 128 * k;
        const int col = (e & 7) * 4, r = (e >> 3) & (kRows - 1);
        const int g = e >> 9;
        const int row = t.m0 + r, dd = t.d0 + col;
        const bool ok = row < rows && dd < dim;
        cp_async16(xs + g * kGate + r * kLd + col,
                   ok ? x_pre + row * ld_xp + g * dim + dd : x_pre, ok);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < 4 * kRows * kDims / 128; ++k) {
        const int e = t.ct + 128 * k;
        const int col = e & 31, r = (e >> 5) & (kRows - 1), g = e >> 11;
        const int row = t.m0 + r, dd = t.d0 + col;
        const bool ok = row < rows && dd < dim;
        cp_async4(xs + g * kGate + r * kLd + col,
                  ok ? x_pre + row * ld_xp + g * dim + dd : x_pre, ok);
      }
    }
#pragma unroll 4
    for (int k = 0; k < 4 * kRows * kDims / 128; ++k) {
      const int e = t.ct + 128 * k;
      const int col = e & 31, r = (e >> 5) & (kRows - 1), g = e >> 11;
      const int row = t.m0 + r, dd = t.d0 + col;
      const bool ok = row < rows && dd < dim;
      cp_async4(hs + g * kGate + r * kLd + col,
                ok ? h_gates + row * ld_hg + g * dim + dd : h_gates, ok);
    }
    cp_async_commit();
    // this thread's c_prev into registers
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c0 = 0; c0 < 4; ++c0) {
        const int row = t.r0 + 8 * i;
        const int dd = t.d0 + 8 * c0 + 2 * t.q;
        const long long o = static_cast<long long>(row) * dim + dd;
        p.cp[i][c0][0] = p.cp[i][c0][1] = 0.f;
        if (row < rows && dd < dim) {
          if (vec2) {
            const float2 v = *reinterpret_cast<const float2*>(c_prev + o);
            p.cp[i][c0][0] = v.x;
            p.cp[i][c0][1] = v.y;
          } else {
            p.cp[i][c0][0] = c_prev[o];
            p.cp[i][c0][1] = c_prev[o + 1];
          }
        }
      }
  }

  __device__ __forceinline__ void finish(const float* d, const Pre& p,
                                         const WgTile& t,
                                         unsigned char* smem, int rows,
                                         int dim) const {
    const float* const xs = reinterpret_cast<const float*>(smem);
    const float* const hs = xs + 4 * kGate;
    cp_async_wait<0>();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");   // every copy landed
    const long long ld_pre = 4LL * dim;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = t.r0 + 8 * i;
      if (row >= rows) continue;
      const int r = row - t.m0;
#pragma unroll
      for (int c0 = 0; c0 < 4; ++c0) {
        const int col = 8 * c0 + 2 * t.q;
        const int dd = t.d0 + col;
        if (dd >= dim) continue;
        float pre[2][4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 xp =
              *reinterpret_cast<const float2*>(xs + g * kGate + r * kLd + col);
          const float2 hg =
              *reinterpret_cast<const float2*>(hs + g * kGate + r * kLd + col);
          const float* const acc = d + 4 * (c0 + 4 * g) + 2 * i;
          pre[0][g] = __fadd_rn(__fadd_rn(xp.x, hg.x), acc[0]);
          pre[1][g] = __fadd_rn(__fadd_rn(xp.y, hg.y), acc[1]);
          float* const po = pre_out + row * ld_pre + g * dim + dd;
          if (vec2) {
            *reinterpret_cast<float2*>(po) = make_float2(pre[0][g], pre[1][g]);
          } else {
            po[0] = pre[0][g];
            po[1] = pre[1][g];
          }
        }
        const long long o = static_cast<long long>(row) * dim + dd;
        float h[2], c[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          lstm_cell(pre[j][0], pre[j][1], pre[j][2], pre[j][3],
                    p.cp[i][c0][j], &h[j], &c[j]);
        if (vec2) {
          *reinterpret_cast<float2*>(h_out + o) = make_float2(h[0], h[1]);
          *reinterpret_cast<float2*>(c_out + o) = make_float2(c[0], c[1]);
        } else {
          h_out[o] = h[0];
          c_out[o] = c[0];
          h_out[o + 1] = h[1];
          c_out[o + 1] = c[1];
        }
      }
    }
  }
};

// ctx_t (rows, dc) K-major in boxes of 64 rows x 128 bytes (128-byte
// swizzle); Wc (dc, 4 dim) in boxes of 64 depth rows x 32 columns
// (64-byte swizzle).
cudaError_t launch_wgmma(const void* x, const void* w, const TailWgEpi& epi,
                         int rows, int dc, int dim, cudaStream_t stream) {
  using S = WgShape<1, TailWgEpi::kDims, false>;
  static_assert(S::kRows == TailWgEpi::kRows, "one consumer warpgroup");
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_x, map_w;
  if (!encode_map(&map_x, x, bf, rows, dc, S::kDepth, S::kRows) ||
      !encode_map(&map_w, w, bf, dc, 4LL * dim, TailWgEpi::kDims, S::kDepth,
                  CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  return launch_wg_gates<1, TailWgEpi::kDims, false, false>(
      map_x, map_w, epi, rows, dc, dim, stream);
}

// Route numbers shared with stvd_torch/model/kernel.py:TRAIN_TAIL_ROUTES.
enum Route { kRouteWgmma = 0, kRouteMma = 1, kRouteF32 = 2 };

inline bool aligned(const void* p, unsigned long long bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// route: kRouteWgmma (bf16, dc and dim multiples of 8, ctx_t and Wc
// 16-byte aligned), kRouteMma (bf16), kRouteF32 (float32 operands).
// Returns the launch's cudaError_t (0 on success).
extern "C" int stvd_train_tail(const void* x, const void* w, int route,
                               const void* x_pre, long long ld_xp,
                               const void* h_gates, long long ld_hg,
                               const void* c_prev, void* h_out, void* c_out,
                               void* pre_out, int rows, int dc, int dim,
                               void* stream) {
  if (rows < 1 || dc < 1 || dim < 1 || (dim + kBD - 1) / kBD > 65535 ||
      route < kRouteWgmma || route > kRouteF32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma &&
      (dc % 8 != 0 || dim % 8 != 0 || !aligned16(x) || !aligned16(w)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x_pre);
  const float* hg = static_cast<const float*>(h_gates);
  float* pre = static_cast<float*>(pre_out);
  cudaError_t e;
  if (route == kRouteWgmma) {
    const int vec2 = aligned(c_prev, 8) && aligned(h_out, 8) &&
                     aligned(c_out, 8) && aligned(pre_out, 8);
    const int vec4 = ld_xp % 4 == 0 && aligned(x_pre, 16);
    const TailWgEpi epi{xp, ld_xp, hg, ld_hg,
                        static_cast<const float*>(c_prev),
                        static_cast<float*>(h_out), static_cast<float*>(c_out),
                        pre, vec2, vec4};
    e = launch_wgmma(x, w, epi, rows, dc, dim, st);
  } else {
    const TailEpi epi{xp, ld_xp, hg, ld_hg, pre, 4LL * dim};
    e = route == kRouteMma
            ? launch_gates_typed<__nv_bfloat16>(x, w, epi, c_prev, h_out,
                                                c_out, rows, dc, dim, st)
            : launch_gates_f32(x, w, epi, c_prev, h_out, c_out, rows, dc,
                               dim, st);
  }
  return static_cast<int>(e);
}
