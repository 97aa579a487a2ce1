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
// ctx_t (rows, dc) and Wc (dc, 4 dim) in the compute dtype (bf16: wmma
// bf16 -> f32; float32: FMA); x_pre (rows, 4 dim) and h_gates (a column
// view of the h-projection, read through its row stride) float32.  Outputs
// h_t, c_t (rows, dim) and pre (rows, 4 dim), float32: the residuals the
// hand-derived backward reads.
//
// Design: the gates product of gates_mma.cuh (128 rows x 32 dims x 4 gates
// a block, Wc's gate columns read by stride, ragged edges masked), with an
// epilogue that adds the two float32 addends in the plain path's order,
// stores pre and runs the LSTM pointwise.  Unlike the TPU kernel it takes
// any dim and dc, not only multiples of 128.
//
// Bound: at training rows 64, dc 1024, 4 dim 14336, bf16 Wc, one call
// reads 29 MB of Wc and 7.5 MB of addends and writes 5.5 MB (~43 MB,
// ~0.013 ms at 3.35 TB/s); its 1.9 GFLOP are ~2 us of tensor-core time.
// With 64 rows only one row tile exists, so 112 blocks (one per dim strip)
// stream Wc once; what limits this first version is the wmma staging of
// a mostly-empty 128-row tile, not the bytes.

#include "gates_mma.cuh"

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

}  // namespace

// bf16: 0 float32 operands, 1 bf16.  Returns the launch's cudaError_t.
extern "C" int stvd_train_tail(const void* x, const void* w, int bf16,
                               const void* x_pre, long long ld_xp,
                               const void* h_gates, long long ld_hg,
                               const void* c_prev, void* h_out, void* c_out,
                               void* pre_out, int rows, int dc, int dim,
                               void* stream) {
  if (rows < 1 || dc < 1 || dim < 1 || (dim + kBD - 1) / kBD > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TailEpi epi{static_cast<const float*>(x_pre), ld_xp,
                    static_cast<const float*>(h_gates), ld_hg,
                    static_cast<float*>(pre_out), 4LL * dim};
  const cudaError_t e =
      bf16 ? launch_gates_typed<__nv_bfloat16>(x, w, epi, c_prev, h_out,
                                               c_out, rows, dc, dim, st)
           : launch_gates_f32(x, w, epi, c_prev, h_out, c_out, rows, dc, dim,
                              st);
  return static_cast<int>(e);
}
