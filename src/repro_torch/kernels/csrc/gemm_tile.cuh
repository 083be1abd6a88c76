// gemm_tile.cuh: the K loop of one (BM, BN) output tile of f32 tiled_gemm
// (tiled_gemm.cu's CUDA-core path; no other kernel includes it).
//
// One CTA of 256 threads (8 warps) owns the tile.  Warp ty computes rows
// ty, ty + 8, ... (BM / 8 of them) and lane tx the columns tx, tx + 32, ...
// (BN / 32), so each thread keeps a (BM / 8) x (BN / 32) register tile of
// accumulators.  K is stepped in BK chunks staged through shared memory,
// zero-filled past the ragged edges of M, K and N, so the caller pads
// nothing.  In the inner loop a warp reads one x value per row (a broadcast)
// and 32 consecutive w values per column group (one per bank).  Products
// accumulate in f32 by FMA in K order.

#pragma once

#include <cuda_runtime.h>

namespace gemm_tile {

constexpr int kThreads = 256;

template <int BM, int BN, int BK>
struct Tile {
  static constexpr int RM = BM / 8;    // rows per thread
  static constexpr int RN = BN / 32;   // columns per thread
  static_assert(BM % 8 == 0 && BN % 32 == 0, "tile must cover the warps");

  static constexpr size_t smem_bytes() {
    return sizeof(float) * static_cast<size_t>(BM * BK + BK * BN);
  }

  // acc[i][j] += sum_k x[m0 + ty + 8 i][k] * w[k][n0 + tx + 32 j].
  __device__ static void run(const float* __restrict__ x,
                             const float* __restrict__ w,
                             int m, int k, int n, int m0, int n0,
                             unsigned char* smem, float (&acc)[RM][RN]) {
    const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

    float* xs = reinterpret_cast<float*>(smem);     // [BM][BK]
    float* ws = xs + BM * BK;                       // [BK][BN]
    for (int k0 = 0; k0 < k; k0 += BK) {
      for (int idx = tid; idx < BM * BK; idx += kThreads) {
        const int r = idx / BK, kk = idx - r * BK;
        const int row = m0 + r, col = k0 + kk;
        xs[idx] = (row < m && col < k) ? x[(size_t)row * k + col] : 0.f;
      }
      for (int idx = tid; idx < BK * BN; idx += kThreads) {
        const int kk = idx / BN, c = idx - kk * BN;
        const int row = k0 + kk, col = n0 + c;
        ws[idx] = (row < k && col < n) ? w[(size_t)row * n + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = xs[(ty + 8 * i) * BK + kk];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = ws[kk * BN + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
};

// Instantiate BODY(BM, BK, BN) for the tile set core/tiling.py offers
// (TILED_BLOCK_M x TILED_BLOCK_K x TILED_BLOCK_N).
#define GEMM_TILE_FOR_N(BODY, BM, BK) BODY(BM, BK, 32) BODY(BM, BK, 64) \
  BODY(BM, BK, 128)
#define GEMM_TILE_FOR_K(BODY, BM) GEMM_TILE_FOR_N(BODY, BM, 16) \
  GEMM_TILE_FOR_N(BODY, BM, 32) GEMM_TILE_FOR_N(BODY, BM, 64)
#define GEMM_TILE_FOR_ALL(BODY) GEMM_TILE_FOR_K(BODY, 8) \
  GEMM_TILE_FOR_K(BODY, 16) GEMM_TILE_FOR_K(BODY, 32) GEMM_TILE_FOR_K(BODY, 64)

}  // namespace gemm_tile
