// The LSTM-gates product with its epilogue in one block, for Hopper
// (sm_90a): the machinery shared by the decode gates+LSTM kernel
// (gates_lstm.cu) and the train-scan tail kernel (train_tail.cu).
//
//   acc = x @ w     x (rows, Kx), w (Kx, 4 dim), gate columns i, f, o, g
//   pre = Epi::pre(acc, row, col)           per gate column col = g*dim + d
//   c_t = sigmoid(f) * c + sigmoid(i) * tanh(g);  h_t = sigmoid(o) * tanh(c_t)
//
// Each block owns a tile of 128 rows and a strip of 32 dims, and all four
// gate columns of that strip (128 columns of w read straight from the
// (Kx, 4 dim) stack by stride), so the LSTM epilogue runs in the block and
// the (rows, 4 dim) product never reaches memory unless the epilogue
// stores it.  8 warps: warp (m, g) computes rows 64m..64m+63 of gate g,
// 4 x 2 wmma 16x16 accumulators (bf16 -> f32, or s8 -> s32).  Tiles of x
// and w stream through a 3-stage cp.async ring in shared memory laid out
// as 16-element slices, so every wmma pointer is 32-byte aligned.  Ragged
// rows, depths and dims are zero-filled; shapes whose depth or dim is not
// a whole number of 16-byte chunks take element loads instead of
// cp.async.  The grid runs row tiles fastest, so the blocks of one dim
// strip share its weight columns in L2.  float32 operands take a plain
// FMA kernel (the parity runs).
//
// Everything is in an anonymous namespace: each source that includes this
// header gets its own copy of the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;          // rows per block
constexpr int kBD = 32;           // dims per block
constexpr int kBN = 4 * kBD;      // w columns per block: i, f, o, g strips
constexpr int kThreads = 256;     // 8 warps: 2 (rows) x 4 (gates)
constexpr int kStages = 3;
constexpr int kSlice = 16;        // k / n elements of one smem slice row
constexpr int kEpiLd = kBN + 4;   // epilogue row stride (elements)

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kBK = 32;  // depth per stage (64 bytes a row)
};
template <>
struct Mma<signed char> {
  using Acc = int;
  static constexpr int kBK = 64;  // depth per stage (64 bytes a row)
};

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ void set_zero(__nv_bfloat16* v) {
  *v = __float2bfloat16(0.f);
}
__device__ __forceinline__ void set_zero(signed char* v) { *v = 0; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// LSTM pointwise for one (row, dim) from its four preactivations.
__device__ __forceinline__ void lstm_cell(float pi, float pf, float po,
                                          float pg, float c_prev, float* h,
                                          float* c) {
  const float c_new = sigmoid_f(pf) * c_prev + sigmoid_f(pi) * tanhf(pg);
  *c = c_new;
  *h = sigmoid_f(po) * tanhf(c_new);
}

// Stage layout (elements of T): A = x tile (kBM x kBK) as kBK/16 slices of
// (kBM x 16); B = w tile (kBK x kBN) as kBN/16 slices of (kBK x 16).
template <typename T, bool kVec>
__device__ __forceinline__ void load_stage(
    T* a_s, T* b_s, const T* __restrict__ x, const T* __restrict__ w,
    int rows, int kx, int dim, int m0, int d0, int k0) {
  constexpr int kBK = Mma<T>::kBK;
  const int tid = threadIdx.x;
  const long long ldw = 4LL * dim;
  if constexpr (kVec) {
    constexpr int kEl = 16 / sizeof(T);             // elements per chunk
    constexpr int kChA = kBK / kEl;                 // chunks per x row
    constexpr int kChB = kBN / kEl;                 // chunks per w row
    for (int c = tid; c < kBM * kChA; c += kThreads) {
      const int row = c / kChA;
      const int kc = (c - row * kChA) * kEl;
      const int gr = m0 + row, gk = k0 + kc;
      const bool ok = gr < rows && gk < kx;
      cp_async16(a_s + ((kc / kSlice) * kBM + row) * kSlice + kc % kSlice,
                 ok ? x + static_cast<long long>(gr) * kx + gk : x, ok);
    }
    for (int c = tid; c < kBK * kChB; c += kThreads) {
      const int kr = c / kChB;
      const int nc = (c - kr * kChB) * kEl;
      const int g = nc / kBD;
      const int gd = d0 + nc - g * kBD;
      const int gk = k0 + kr;
      const bool ok = gk < kx && gd < dim;
      cp_async16(b_s + ((nc / kSlice) * kBK + kr) * kSlice + nc % kSlice,
                 ok ? w + gk * ldw + static_cast<long long>(g) * dim + gd : w,
                 ok);
    }
  } else {
    T zero;
    set_zero(&zero);
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int row = e / kBK;
      const int kc = e - row * kBK;
      const int gr = m0 + row, gk = k0 + kc;
      a_s[((kc / kSlice) * kBM + row) * kSlice + kc % kSlice] =
          gr < rows && gk < kx ? x[static_cast<long long>(gr) * kx + gk] : zero;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kr = e / kBN;
      const int nc = e - kr * kBN;
      const int g = nc / kBD;
      const int gd = d0 + nc - g * kBD;
      const int gk = k0 + kr;
      b_s[((nc / kSlice) * kBK + kr) * kSlice + nc % kSlice] =
          gk < kx && gd < dim
              ? w[gk * ldw + static_cast<long long>(g) * dim + gd]
              : zero;
    }
  }
}

// Epi: pre(acc, row, col) -> the gate preactivation from the product's
// sum (int for s8, float otherwise); emit(row, col, pre) stores what the
// caller keeps of it.
template <typename T, bool kVec, typename Epi>
__global__ void __launch_bounds__(kThreads)
gates_mma_kernel(const T* __restrict__ x, const T* __restrict__ w, Epi epi,
                 const float* __restrict__ c_prev, float* __restrict__ h_out,
                 float* __restrict__ c_out, int rows, int kx, int dim) {
  using Acc = typename Mma<T>::Acc;
  constexpr int kBK = Mma<T>::kBK;
  constexpr int kStageEl = (kBM + kBN) * kBK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  Acc* epi_s = reinterpret_cast<Acc*>(smem_raw);  // reused after the K loop

  const int m0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kBD;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;   // rows 64*wm ..
  const int wg = warp & 3;    // gate i, f, o, g

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  const int nk = (kx + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) {
      T* a_s = ring + st * kStageEl;
      load_stage<T, kVec>(a_s, a_s + kBM * kBK, x, w, rows, kx, dim, m0, d0,
                          st * kBK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      T* a_s = ring + (nxt % kStages) * kStageEl;
      load_stage<T, kVec>(a_s, a_s + kBM * kBK, x, w, rows, kx, dim, m0, d0,
                          nxt * kBK);
    }
    cp_async_commit();
    const T* a_s = ring + (kt % kStages) * kStageEl;
    const T* b_s = a_s + kBM * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / kSlice; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(
            fa[i], a_s + (ks * kBM + wm * 64 + i * 16) * kSlice, kSlice);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j], b_s + ((wg * kBD) / kSlice + j) * kBK * kSlice +
                       ks * kSlice * kSlice,
            kSlice);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is dead: reuse it for the accumulators

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          epi_s + (wm * 64 + i * 16) * kEpiLd + wg * kBD + j * 16, acc[i][j],
          kEpiLd, wmma::mem_row_major);
  __syncthreads();

  // epilogue: a warp per row, a lane per dim of the strip
  for (int e = threadIdx.x; e < kBM * kBD; e += kThreads) {
    const int r = e / kBD;
    const int d = e - r * kBD;
    const int row = m0 + r;
    const int dd = d0 + d;
    if (row >= rows || dd >= dim) continue;
    const Acc* er = epi_s + r * kEpiLd + d;
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = g * dim + dd;
      pre[g] = epi.pre(er[g * kBD], row, col);
      epi.emit(row, col, pre[g]);
    }
    const long long o = static_cast<long long>(row) * dim + dd;
    lstm_cell(pre[0], pre[1], pre[2], pre[3], c_prev[o], h_out + o, c_out + o);
  }
}

// float32 operands: the parity runs' plain FMA product.  A block owns 64
// rows x 32 dims x 4 gates; thread (ty, tx) owns 8 rows of dim tx.
constexpr int kFBM = 64;
constexpr int kFBK = 16;

template <typename Epi>
__global__ void __launch_bounds__(kThreads)
gates_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 Epi epi, const float* __restrict__ c_prev,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 int rows, int kx, int dim) {
  __shared__ float a_s[kFBM][kFBK + 1];
  __shared__ float b_s[kFBK][kBN];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kFBM;
  const int d0 = blockIdx.y * kBD;
  const long long ldw = 4LL * dim;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;

  for (int k0 = 0; k0 < kx; k0 += kFBK) {
    for (int e = threadIdx.x; e < kFBM * kFBK; e += kThreads) {
      const int r = e / kFBK, kc = e - r * kFBK;
      const int gr = m0 + r, gk = k0 + kc;
      a_s[r][kc] =
          gr < rows && gk < kx ? x[static_cast<long long>(gr) * kx + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < kFBK * kBN; e += kThreads) {
      const int kr = e / kBN, nc = e - kr * kBN;
      const int g = nc / kBD, gd = d0 + nc - g * kBD, gk = k0 + kr;
      b_s[kr][nc] = gk < kx && gd < dim
                        ? w[gk * ldw + static_cast<long long>(g) * dim + gd]
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float bv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) bv[g] = b_s[kk][g * kBD + tx];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = a_s[ty * 8 + i][kk];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = fmaf(a, bv[g], acc[i][g]);
      }
    }
    __syncthreads();
  }
  const int dd = d0 + tx;
  if (dd >= dim) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= rows) continue;
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      pre[g] = epi.pre(acc[i][g], row, g * dim + dd);
      epi.emit(row, g * dim + dd, pre[g]);
    }
    const long long o = static_cast<long long>(row) * dim + dd;
    lstm_cell(pre[0], pre[1], pre[2], pre[3], c_prev[o], h_out + o, c_out + o);
  }
}

template <typename T, bool kVec, typename Epi>
cudaError_t launch_mma(const void* x, const void* w, const Epi& epi,
                       const void* c_prev, void* h_out, void* c_out, int rows,
                       int kx, int dim, cudaStream_t stream) {
  using Acc = typename Mma<T>::Acc;
  constexpr size_t ring = static_cast<size_t>(kStages) * (kBM + kBN) *
                          Mma<T>::kBK * sizeof(T);
  constexpr size_t epi_bytes = static_cast<size_t>(kBM) * kEpiLd * sizeof(Acc);
  constexpr size_t smem = ring > epi_bytes ? ring : epi_bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      gates_mma_kernel<T, kVec, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((rows + kBM - 1) / kBM, (dim + kBD - 1) / kBD);
  gates_mma_kernel<T, kVec, Epi><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), epi,
      static_cast<const float*>(c_prev), static_cast<float*>(h_out),
      static_cast<float*>(c_out), rows, kx, dim);
  return cudaGetLastError();
}

// cp.async moves 16-byte chunks: each x row and each gate strip of w must
// be a whole number of chunks, and both bases 16-byte aligned.
template <typename T, typename Epi>
cudaError_t launch_gates_typed(const void* x, const void* w, const Epi& epi,
                               const void* c_prev, void* h_out, void* c_out,
                               int rows, int kx, int dim,
                               cudaStream_t stream) {
  constexpr int kEl = 16 / sizeof(T);
  const bool vec = kx % kEl == 0 && dim % kEl == 0 &&
                   (reinterpret_cast<unsigned long long>(x) & 15) == 0 &&
                   (reinterpret_cast<unsigned long long>(w) & 15) == 0;
  return vec ? launch_mma<T, true>(x, w, epi, c_prev, h_out, c_out, rows, kx,
                                   dim, stream)
             : launch_mma<T, false>(x, w, epi, c_prev, h_out, c_out, rows, kx,
                                    dim, stream);
}

template <typename Epi>
cudaError_t launch_gates_f32(const void* x, const void* w, const Epi& epi,
                             const void* c_prev, void* h_out, void* c_out,
                             int rows, int kx, int dim, cudaStream_t stream) {
  const dim3 grid((rows + kFBM - 1) / kFBM, (dim + kBD - 1) / kBD);
  gates_f32_kernel<Epi><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), epi,
      static_cast<const float*>(c_prev), static_cast<float*>(h_out),
      static_cast<float*>(c_out), rows, kx, dim);
  return cudaGetLastError();
}

}  // namespace
