// The warp-specialised TMA + wgmma gates product, its epilogue in
// registers, for Hopper (sm_90a): the mainloop shared by the wgmma routes
// of the decode gates+LSTM step (gates_lstm.cu) and of the train-scan tail
// (train_tail.cu).
//
//   acc = x @ w     x (rows, Kx) K-major; w's four gate strips, columns
//                   g dim + d of the (Kx, 4 dim) stack (bf16, MN-major) or
//                   rows g dim + d of its K-major (4 dim, Kx) transpose
//                   (int8 always; bf16 with kWK)
//   Epi::prefetch   the epilogue's loads, issued before the tile's products
//                   so their latency hides behind the mainloop
//   Epi::finish     the pre-activations, the LSTM pointwise and the stores,
//                   from the accumulators in registers
//
// A tile is 64 kWgs rows x a strip of kDims dims, all four gates: 4 kDims
// columns of w read as four kDims-wide TMA boxes.  One producer thread
// streams 128-byte-deep stages of x and w into an mbarrier ring of as many
// stages as shared memory holds beside the epilogue's buffers (at most 8);
// kWgs consumer warpgroups each run m64n(4 kDims) wgmma on their 64 rows.
// bf16: k16 steps with w MN-major (its transpose bit set), boxes of 64
// depth rows x kDims columns, 128-byte swizzled at kDims 64 and 64-byte
// swizzled at kDims 32 (a 32-column bf16 box is 64 bytes wide); or, with
// kWK (kDims 64), w K-major in boxes of kDims rows x 128 bytes, whose first
// row g dim + d0 may be any row: no dim rule, where an MN-major box must
// start its columns on a 16-byte boundary.  int8 (kDims 64): k32 steps
// with w K-major, as wgmma takes 8-bit operands only so.  In the
// accumulator layout a thread holds the same dim offsets in all four gate
// blocks (WgTile), so the epilogue needs no trip of the accumulators
// through shared memory.  The block walks tiles (row tiles
// fastest, so concurrent tiles share their weight strips in L2) with its
// ring running on across them.
//
// Epi provides kSmemBytes (its shared buffers, 16-byte aligned after the
// ring), a register struct Pre, prefetch(Pre&, const WgTile&, smem, rows,
// dim) and finish(const Acc* d, const Pre&, const WgTile&, smem, rows,
// dim).  Its own barriers over the consumers are `bar.sync 1, 128 kWgs`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

template <int kWgs, int kDims, bool kQuant, bool kWK = kQuant>
struct WgShape {
  static_assert(kDims == 64 || (kDims == 32 && !kWK),
                "strips of 64 dims, or 32 in bf16 with w MN-major");
  static_assert(kWK || !kQuant, "int8 w is read K-major");
  using Acc = typename std::conditional<kQuant, int, float>::type;
  static constexpr int kRows = 64 * kWgs;              // rows per tile
  static constexpr int kThreads = 128 * (kWgs + 1);    // + the producer
  static constexpr int kStageK = 128;                  // depth bytes a stage
  static constexpr int kDepth = kQuant ? 128 : 64;     // depth elements
  static constexpr int kStep = kQuant ? 32 : 16;       // one wgmma's depth
  static constexpr int kAcc = 2 * kDims;               // m64n(4 kDims) / 128
  static constexpr int kABytes = kRows * kStageK;
  static constexpr int kBoxBytes = kDims * kStageK;    // one gate's box
  static constexpr int kStageBytes = kABytes + 4 * kBoxBytes;
};

// Ring stages: as many as fit beside the epilogue's buffers, the 1024
// bytes that align the ring, and each stage's two barriers; at most 8.
template <typename S, typename Epi>
struct WgRing {
  static constexpr int kFit = static_cast<int>(
      (kSmemLimit - 1024 - Epi::kSmemBytes) / (S::kStageBytes + 16));
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr size_t kSmem =
      1024 + kStages * (S::kStageBytes + 16) + Epi::kSmemBytes;
};

// Where a consumer thread's accumulators sit.  d[4 (c0 + (kDims / 8) g) +
// 2 i + j] is row r0 + 8 i of the tile, dim d0 + 8 c0 + 2 q + j, gate g
// (c0 < kDims / 8, i, j < 2): the m64nN fragment layout (hopper.cuh) with
// the tile's columns cut into four kDims-wide gate blocks.
struct WgTile {
  int m0, d0;   // the tile's first row and dim
  int r0;       // this thread's first row
  int ct;       // consumer thread, 0 .. 128 kWgs - 1
  int q;        // lane % 4
  int parity;   // the block's tile count, mod 2
  int first;    // whether this is the block's first tile
};

template <int kWgs, int kDims, bool kQuant, bool kWK, typename Epi>
__global__ void __launch_bounds__(WgShape<kWgs, kDims, kQuant, kWK>::kThreads,
                                  1)
    wg_gates_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w, Epi epi,
                    int rows, int kx, int dim) {
  using S = WgShape<kWgs, kDims, kQuant, kWK>;
  constexpr int kRing = WgRing<S, Epi>::kStages;
  extern __shared__ unsigned char wg_smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes and must start 1024-aligned
  const uint32_t base = (smem_u32(wg_smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + kRing * S::kStageBytes;   // full[kRing]
  const uint32_t empty = full + kRing * 8;               // empty[kRing]
  unsigned char* const epi_smem =
      wg_smem_raw + (empty + kRing * 8 - smem_u32(wg_smem_raw));
  const int nrt = (rows + S::kRows - 1) / S::kRows;
  const int ntiles = nrt * ((dim + kDims - 1) / kDims);
  const int nk = (kx + S::kDepth - 1) / S::kDepth;
  const int wg = threadIdx.x / 128;

  ring_init(full, kRing, 4 * kWgs);
  __syncthreads();

  if (wg == kWgs) {
    // producer warpgroup: one thread issues every TMA load; the ring's
    // stage counter runs on across tiles
    if constexpr (kWgs > 1) producer_regs();
    if (threadIdx.x == kWgs * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile % nrt) * S::kRows;
        const int d0 = (tile / nrt) * kDims;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % kRing;
          mbar_wait(empty + 8 * st, ((it / kRing) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, S::kStageBytes);
          const uint32_t a_s = base + st * S::kStageBytes;
          const int k0 = kt * S::kDepth;
          tma_load(a_s, &map_x, full + 8 * st, k0, m0);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const uint32_t b_s = a_s + S::kABytes + g * S::kBoxBytes;
            if constexpr (kWK)
              tma_load(b_s, &map_w, full + 8 * st, k0, g * dim + d0);
            else
              tma_load(b_s, &map_w, full + 8 * st, g * dim + d0, k0);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: rows m0 + 64 wg ..
  if constexpr (kWgs > 1) consumer_regs();
  const int ct = threadIdx.x;
  const int lane = ct & 31;
  typename S::Acc d[S::kAcc];
  WgTile t;
  t.ct = ct;
  t.q = lane & 3;
  t.parity = 0;
  t.first = 1;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, t.parity ^= 1, t.first = 0) {
    t.m0 = (tile % nrt) * S::kRows;
    t.d0 = (tile / nrt) * kDims;
    t.r0 = t.m0 + wg * 64 + ((ct & 127) >> 5) * 16 + (lane >> 2);
    typename Epi::Pre pre;
    epi.prefetch(pre, t, epi_smem, rows, dim);

#pragma unroll
    for (int i = 0; i < S::kAcc; ++i) d[i] = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % kRing;
      mbar_wait(full + 8 * st, (it / kRing) & 1);
      const uint32_t a_s =
          base + st * S::kStageBytes + wg * (S::kABytes / kWgs);
      const uint32_t b_s = base + st * S::kStageBytes + S::kABytes;
      fence_acc<S::kAcc>(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S::kDepth / S::kStep; ++kk) {
        // x K-major: a step is 32 bytes of each 128-byte row
        const uint64_t da = sw128_desc(a_s + kk * 32, 16, 1024);
        if constexpr (kQuant)   // W^T K-major, 256 rows of 128 bytes
          wgmma_s8_256(d, da, sw128_desc(b_s + kk * 32, 16, 1024));
        else if constexpr (kWK)   // the same, 16 bf16 of each row a step
          wgmma_bf16_256<0, 0>(d, da, sw128_desc(b_s + kk * 32, 16, 1024));
        else if constexpr (kDims == 64)   // 16 rows of 128 bytes a step
          wgmma_bf16_256<0, 1>(
              d, da, sw128_desc(b_s + kk * 2048, S::kBoxBytes, 1024));
        else                              // 16 rows of 64 bytes a step
          wgmma_bf16_128<0, 1>(
              d, da, sw64_desc(b_s + kk * 1024, S::kBoxBytes, 512));
      }
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      fence_acc<S::kAcc>(d);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kRing));
    }
    wgmma_wait<0>();
    fence_acc<S::kAcc>(d);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kRing));

    epi.finish(d, pre, t, epi_smem, rows, dim);
  }
}

// One launch: min(tiles, SMs) persistent blocks; the kernel's shared
// memory limit is raised once per device.  x is (rows, kx); map_w reads
// the bf16 (kx, 4 dim) stack or, with kWK (int8 always), its K-major
// (4 dim, kx) transpose.
template <int kWgs, int kDims, bool kQuant, bool kWK, typename Epi>
cudaError_t launch_wg_gates(const CUtensorMap& map_x, const CUtensorMap& map_w,
                            const Epi& epi, int rows, int kx, int dim,
                            cudaStream_t stream) {
  using S = WgShape<kWgs, kDims, kQuant, kWK>;
  constexpr size_t smem = WgRing<S, Epi>::kSmem;
  static_assert(smem <= kSmemLimit, "ring and epilogue exceed 227 KB");
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem(
      wg_gates_kernel<kWgs, kDims, kQuant, kWK, Epi>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int ntiles =
      (rows + S::kRows - 1) / S::kRows * ((dim + kDims - 1) / kDims);
  const int sms = num_sms();
  wg_gates_kernel<kWgs, kDims, kQuant, kWK, Epi>
      <<<ntiles < sms ? ntiles : sms, S::kThreads, smem, stream>>>(
          map_x, map_w, epi, rows, kx, dim);
  return cudaGetLastError();
}

}  // namespace
