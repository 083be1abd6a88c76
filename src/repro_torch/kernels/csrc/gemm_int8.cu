// gemm_int8: (M, K) int8 @ (K, N) int8 -> int32 accumulator, flushed as
// acc * (x_scale * w_scale[n]) into f32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/gemm_int8.py::gemm_int8 (Pallas
// body _int8_kernel).  On the TPU the K loop was the sequential grid axis
// carrying the accumulator in VMEM scratch; here one CTA of 256 threads owns
// a (BM, BN) output tile, loops over K in BK chunks staged through shared
// memory, and keeps its accumulators in registers.
//
// What bounds it on this card: on the edge path (M = 8, K and N <= 250) a
// layer moves a few KiB and does ~10^5 int8 operations, so the launch binds,
// as it does for the per-layer rung that runs this kernel once per layer.
// At large shapes (the 256 x 1024 x 1024 check) operations bind; this simple
// CUDA-core __dp4a kernel is far from the int8 tensor-core rate, and
// mma.sync/wgmma with TMA staging is later work.  The design keeps it right
// and small: tiles come from the port's planner (core/tiling.py, the only
// tiles instantiated below), the kernel masks the ragged edge itself so the
// wrapper pads nothing, and the w tile is stored transposed in shared memory
// (rows padded by 4 bytes against bank conflicts) so each __dp4a reads 4
// consecutive K values of both operands.
//
// Numerics: the flush is __fmul_rn(acc_f, __fmul_rn(sx, sw[n])), the
// reference's order; bf16 rounds to nearest even (__float2bfloat16_rn).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
gemm_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ sw, float sx, void* __restrict__ out,
                 int out_bf16, int m, int k, int n) {
  constexpr int kPer = BM * BN / kThreads;  // outputs per thread
  constexpr int kWStride = BK + 4;          // transposed w tile row stride
  static_assert(BM * BN % kThreads == 0, "tile must cover whole threads");
  static_assert(BK % 4 == 0, "__dp4a takes 4 values");
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* xt = smem;             // [BM][BK]
  int8_t* wt = smem + BM * BK;   // [BN][BK + 4]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  int acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK, kk = idx - r * BK;
      const int row = m0 + r, col = k0 + kk;
      xt[idx] = (row < m && col < k) ? x[(size_t)row * k + col] : 0;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN, c = idx - kk * BN;
      const int row = k0 + kk, col = n0 + c;
      wt[c * kWStride + kk] = (row < k && col < n) ? w[(size_t)row * n + col]
                                                   : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int k4 = 0; k4 < BK / 4; ++k4) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int idx = tid + j * kThreads;
        const int r = idx / BN, c = idx - r * BN;
        const int xv = *reinterpret_cast<const int*>(xt + r * BK + 4 * k4);
        const int wv =
            *reinterpret_cast<const int*>(wt + c * kWStride + 4 * k4);
        acc[j] = __dp4a(xv, wv, acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int idx = tid + j * kThreads;
    const int r = idx / BN, c = idx - r * BN;
    const int row = m0 + r, col = n0 + c;
    if (row >= m || col >= n) continue;
    const float v =
        __fmul_rn(static_cast<float>(acc[j]), __fmul_rn(sx, sw[col]));
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[(size_t)row * n + col] =
          __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[(size_t)row * n + col] = v;
  }
}

template <int BM, int BN, int BK>
int launch(const int8_t* x, const int8_t* w, const float* sw, float sx,
           void* out, int out_bf16, int m, int k, int n, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const size_t smem = BM * BK + BN * (BK + 4);
  gemm_int8_kernel<BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      x, w, sw, sx, out, out_bf16, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tiles core/tiling.py offers (BLOCK_M x BLOCK_K x BLOCK_N); any other
// tile returns cudaErrorInvalidValue.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_gemm_int8(const int8_t* x, const int8_t* w,
                               const float* sw, float sx, void* out,
                               int out_bf16, int m, int k, int n, int bm,
                               int bk, int bn, void* stream) {
  if (m < 1 || k < 1 || n < 1 || (m + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM, BK, BN)                                            \
  if (bm == BM && bk == BK && bn == BN)                                   \
    return launch<BM, BN, BK>(x, w, sw, sx, out, out_bf16, m, k, n, st);
#define REPRO_TILES_N(BM, BK) \
  REPRO_TILE(BM, BK, 32) REPRO_TILE(BM, BK, 64) REPRO_TILE(BM, BK, 128)
#define REPRO_TILES_K(BM) \
  REPRO_TILES_N(BM, 32) REPRO_TILES_N(BM, 64) REPRO_TILES_N(BM, 128)
  REPRO_TILES_K(8)
  REPRO_TILES_K(16)
  REPRO_TILES_K(32)
  REPRO_TILES_K(64)
#undef REPRO_TILES_K
#undef REPRO_TILES_N
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
