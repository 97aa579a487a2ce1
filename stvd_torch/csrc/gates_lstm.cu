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
// operands with float32 sums (nvcuda::wmma bf16 -> f32), int8 operands
// with int32 sums (wmma s8 -> s32).  The int32 sums are exact, and the
// dequant is written with __fmul_rn/__fadd_rn so it is never contracted
// into an FMA: the int8 epilogue rounds exactly as the plain path does.
// x and its row scales are made by the caller with the plain path's own
// torch ops, so both paths see the same x_q.  Outputs h_t, c_t (rows,
// dim) float32; the (rows, 4 dim) preactivation never reaches memory.
//
// Design (gates_mma.cuh, shared with the train-scan tail): each block owns
// a tile of 128 rows and a strip of 32 dims, and all four gate columns of
// that strip (128 columns of w), so the LSTM epilogue runs in the block.
// The TPU kernel needed a gate-interleaved copy of w for Mosaic's block
// rule; here the block reads the i/f/o/g columns straight from the
// (Kx, 4 dim) stack by stride (column g*dim + d), so precompute builds no
// interleaved copy and the int8 grid is the very tensor the plain path
// multiplies.  Ragged rows, depths and dims are masked in the kernel, so
// it takes any shape.  The grid runs row tiles fastest, so the blocks of
// one dim strip share its weight columns in L2 and w is read from memory
// about once per step.
//
// Bound: at preset 3 (rows 1280, Kx 5120, 4 dim 14336) a step reads 147 MB
// of bf16 weights (73 MB int8) and does 188 GFLOP: ~0.19 ms of tensor-core
// time at the bf16 peak (0.1 ms int8), ~0.04 ms of memory.  This first
// version has no wgmma/TMA and stages through wmma, so it is expected
// well short of cuBLAS's 0.26 ms for the bf16 product alone.

#include "gates_mma.cuh"

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

}  // namespace

// mode: 0 float32, 1 bf16, 2 int8 (W8A8; s_r and scale are read only
// here).  Returns the cudaError_t of the launch (0 on success).
extern "C" int stvd_gates_lstm(const void* x, const void* w, int mode,
                               const void* bias, const void* s_r,
                               const void* scale, const void* c_prev,
                               void* h_out, void* c_out, int rows, int kx,
                               int dim, void* stream) {
  if (rows < 1 || kx < 1 || dim < 1 || mode < 0 || mode > 2 ||
      (dim + kBD - 1) / kBD > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* sr = static_cast<const float*>(s_r);
  const float* sc = static_cast<const float*>(scale);
  cudaError_t e;
  if (mode == 0) {
    e = launch_gates_f32(x, w, GatesEpi<false>{b, sr, sc}, c_prev, h_out,
                         c_out, rows, kx, dim, st);
  } else if (mode == 1) {
    e = launch_gates_typed<__nv_bfloat16>(x, w, GatesEpi<false>{b, sr, sc},
                                          c_prev, h_out, c_out, rows, kx, dim,
                                          st);
  } else {
    e = launch_gates_typed<signed char>(x, w, GatesEpi<true>{b, sr, sc},
                                        c_prev, h_out, c_out, rows, kx, dim,
                                        st);
  }
  return static_cast<int>(e);
}
