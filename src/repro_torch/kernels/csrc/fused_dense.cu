// fused_dense: act(x @ w + b) (+ residual) in one launch, f32 accumulation,
// output in f32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/fused_dense.py::fused_dense
// (Pallas body _fused_kernel): the DR7' boundary eliminator, whose epilogue
// keeps the activation out of device memory between the GEMM and the
// elementwise ops.  Here one CTA owns a (BM, BN) output tile, walks K
// through shared memory (gemm_tile.cuh, the same K loop as tiled_gemm.cu)
// and applies the epilogue to its register accumulators in the reference's
// order (_flush): bias in f32, then the activation, then the residual in
// f32, then the cast.  The block shape comes from core/tiling.py's
// plan_dense, as the TPU wrapper took plan_api's.
//
// What bounds it on this card: on the float edge forward (M = 8, widths up
// to 320) a layer moves a few KiB and does ~10^6 FLOPs, so the launch binds;
// one launch per layer is the whole point of fusing the epilogue.
//
// Numerics: gelu is the tanh approximation (jax.nn.gelu's default, torch's
// approximate="tanh"), computed with tanhf, not erff.  No fast math.

#include "gemm_tile.cuh"

namespace {

using gemm_tile::Tile;

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3, kTanh = 4,
           kSigmoid = 5 };

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case kRelu:
      return y < 0.f ? 0.f : y;
    case kGelu: {
      const float inner = 0.7978845608028654f * (y + 0.044715f * y * y * y);
      return 0.5f * y * (1.f + tanhf(inner));
    }
    case kSilu:
      return y / (1.f + expf(-y));
    case kTanh:
      return tanhf(y);
    case kSigmoid:
      return 1.f / (1.f + expf(-y));
    default:
      return y;
  }
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(gemm_tile::kThreads)
fused_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ b, const T* __restrict__ residual,
                   void* __restrict__ out, int out_bf16, int act, int m,
                   int k, int n) {
  using G = Tile<T, BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[G::RM][G::RN];
  G::run(x, w, m, k, n, m0, n0, smem, acc);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < G::RN; ++j) {
    const int col = n0 + tx + 32 * j;
    if (col >= n) continue;
    const float bias = b[col];
#pragma unroll
    for (int i = 0; i < G::RM; ++i) {
      const int row = m0 + ty + 8 * i;
      if (row >= m) continue;
      const size_t o = (size_t)row * n + col;
      float y = activate(acc[i][j] + bias, act);
      if (residual != nullptr) y += gemm_tile::to_f32(residual[o]);
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(out)[o] = y;
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch(const void* x, const void* w, const float* b, const void* res,
           void* out, int out_bf16, int act, int m, int k, int n,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  fused_dense_kernel<T, BM, BN, BK>
      <<<grid, gemm_tile::kThreads, Tile<T, BM, BN, BK>::smem_bytes(),
         stream>>>(static_cast<const T*>(x), static_cast<const T*>(w), b,
                   static_cast<const T*>(res), out, out_bf16, act, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const float* b, const void* res,
             void* out, int out_bf16, int act, int m, int k, int n, int bm,
             int bk, int bn, cudaStream_t st) {
#define REPRO_TILE(BM, BK, BN)                                          \
  if (bm == BM && bk == BK && bn == BN)                                 \
    return launch<T, BM, BN, BK>(x, w, b, res, out, out_bf16, act, m, k, \
                                 n, st);
  GEMM_TILE_FOR_ALL(REPRO_TILE)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_bf16: x, w and the residual are bf16 (else f32); b is f32 (N,); the
// residual is null or (M, N); act is the Act code.  A tile outside
// core/tiling.py's set, an unknown act, or an empty or oversized grid
// returns cudaErrorInvalidValue; otherwise returns cudaGetLastError() after
// the launch.  K = 0 is legal: the epilogue runs on zero accumulators.
extern "C" int repro_fused_dense(const void* x, const void* w, const float* b,
                                 const void* residual, void* out, int x_bf16,
                                 int out_bf16, int act, int m, int k, int n,
                                 int bm, int bk, int bn, void* stream) {
  if (m < 1 || k < 0 || n < 1 || bm < 1 || (m + bm - 1) / bm > 65535 ||
      act < kNone || act > kSigmoid)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(x, w, b, residual, out, out_bf16, act, m,
                                   k, n, bm, bk, bn, st);
  return dispatch<float>(x, w, b, residual, out, out_bf16, act, m, k, n, bm,
                         bk, bn, st);
}
