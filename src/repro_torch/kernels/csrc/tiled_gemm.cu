// tiled_gemm: (M, K) @ (K, N) with explicit (BM, BK, BN) tiling.  int8
// operands accumulate in int32 and give int32, exactly; f32 and bf16
// operands accumulate in f32 and keep their type (bf16 rounded to nearest
// even).
//
// Replaces the TPU kernel src/repro/kernels/tiled_gemm.py::tiled_gemm
// (Pallas body _gemm_kernel), the API-level tile of the paper's Algorithm 2.
// On the TPU the K axis was the sequential grid axis carrying the
// accumulator in VMEM scratch between grid steps; here one CTA owns a
// (BM, BN) output tile and walks K itself (gemm_tile.cuh), the accumulators
// in registers, so nothing carries between blocks.  The block shape comes
// from the port's planner (core/tiling.py plan_tiled); only its tile set is
// instantiated below.
//
// What bounds it on this card: at the check's canonical case (64 x 256 x
// 512 bf16) a launch moves 0.36 MB, so the launch binds.  At large shapes
// (256 x 4096 x 4096) the work is operations-bound on tensor cores, and this
// kernel runs CUDA-core FMAs (__dp4a for int8) from shared memory, far below
// that rate; wgmma with TMA staging is later work.

#include "gemm_tile.cuh"

namespace {

using gemm_tile::Tile;

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(gemm_tile::kThreads)
tiled_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  void* __restrict__ out, int m, int k, int n) {
  using G = Tile<T, BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  typename G::Acc acc[G::RM][G::RN];
  G::run(x, w, m, k, n, m0, n0, smem, acc);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < G::RM; ++i) {
    const int row = m0 + ty + 8 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < G::RN; ++j) {
      const int col = n0 + tx + 32 * j;
      if (col >= n) continue;
      const size_t o = (size_t)row * n + col;
      if constexpr (G::kInt8)
        static_cast<int*>(out)[o] = acc[i][j];
      else if constexpr (std::is_same<T, __nv_bfloat16>::value)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(acc[i][j]);
      else
        static_cast<float*>(out)[o] = acc[i][j];
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch(const void* x, const void* w, void* out, int m, int k, int n,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  tiled_gemm_kernel<T, BM, BN, BK>
      <<<grid, gemm_tile::kThreads, Tile<T, BM, BN, BK>::smem_bytes(),
         stream>>>(static_cast<const T*>(x), static_cast<const T*>(w), out, m,
                   k, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int m, int k, int n,
             int bm, int bk, int bn, cudaStream_t st) {
#define REPRO_TILE(BM, BK, BN)              \
  if (bm == BM && bk == BK && bn == BN)     \
    return launch<T, BM, BN, BK>(x, w, out, m, k, n, st);
  GEMM_TILE_FOR_ALL(REPRO_TILE)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 int8 (out int32), 1 f32 (out f32), 2 bf16 (out bf16).  A tile
// outside core/tiling.py's set, or an empty or oversized grid, returns
// cudaErrorInvalidValue; otherwise returns cudaGetLastError() after the
// launch.  K = 0 gives zeros.
extern "C" int repro_tiled_gemm(const void* x, const void* w, void* out,
                                int dtype, int m, int k, int n, int bm,
                                int bk, int bn, void* stream) {
  if (m < 1 || k < 0 || n < 1 || bm < 1 || (m + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<int8_t>(x, w, out, m, k, n, bm, bk, bn, st);
    case 1:
      return dispatch<float>(x, w, out, m, k, n, bm, bk, bn, st);
    case 2:
      return dispatch<__nv_bfloat16>(x, w, out, m, k, n, bm, bk, bn, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
