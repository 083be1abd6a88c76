// tiled_gemm: (M, K) @ (K, N) with explicit (BM, BK, BN) tiling.  int8
// operands accumulate in int32 and give int32, exactly; f32 and bf16
// operands accumulate in f32 and keep their type (bf16 rounded to nearest
// even).
//
// Replaces the TPU kernel src/repro/kernels/tiled_gemm.py::tiled_gemm
// (Pallas body _gemm_kernel), the API-level tile of the paper's Algorithm 2.
// On the TPU the K axis was the sequential grid axis carrying the
// accumulator in VMEM scratch between grid steps; here one CTA owns a
// (BM, BN) output tile and walks K itself, the accumulators in registers,
// so nothing carries between blocks.  The block shape comes from the port's
// planner (core/tiling.py plan_tiled), one tile set per operand size; only
// those sets are instantiated below.
//
// What bounds it on this card: a large product (256 x 4096 x 4096) is
// operations-bound, and the card's bf16 and int8 rates live in the tensor
// cores; the check's canonical case (64 x 256 x 512) moves 0.36 MB, so the
// launch binds there.  So bf16 and int8 run on Hopper's tensor cores:
//
// * One CTA per (BM, BN) tile, BM in {64, 128}, BN in {64, 128, 256}, BK of
//   128 bytes (64 bf16, 128 int8).  BM / 64 consumer warpgroups each own 64
//   rows and issue wgmma with both operands in shared memory, accumulating
//   in registers (f32, or s32 for int8: exact).  One producer warpgroup
//   keeps a ring of 4 stages full, each guarded by a full and an empty
//   mbarrier, so loads run ahead of the products.  With two consumers,
//   setmaxnreg moves registers from the producer to them.
// * x arrives by TMA ([BM][BK], K-major, 128-byte swizzle) when its row
//   stride is a multiple of 16 bytes and its base 16-byte aligned.  bf16 w
//   arrives by TMA as BN / 64 boxes of [64 k][64 n] (N-major; wgmma's
//   transpose bit takes it as it is) under the same condition.  TMA's zero
//   fill covers ragged M, N and K edges.
// * Operands TMA cannot take (K * size or N * size not a multiple of 16,
//   a misaligned base) are staged by the producer warpgroup with masked
//   loads into the same swizzled layout: one launch, nothing padded.
// * 8-bit wgmma takes B only K-major, so the producer warpgroup builds the
//   int8 w tile as [BN][128 k]: each thread loads 16 rows x 4 columns of w
//   (4-byte loads where N % 4 == 0) and transposes them in registers with
//   __byte_perm, four 4 x 4 transposes.
// * The epilogue rounds once (bf16 round to nearest even) and masks ragged
//   stores.
//
// f32 stays on CUDA cores (gemm_tile.cuh, included by no other kernel): the
// tensor cores take f32 only as TF32, a 10-bit mantissa, which would break
// the reference's 1e-5.

#include <cstdint>
#include <cuda_bf16.h>
#include <type_traits>

#include "gemm_tile.cuh"
#include "hopper.cuh"

namespace {

using gemm_tile::Tile;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(gemm_tile::kThreads)
tiled_gemm_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ out,
                      int m, int k, int n) {
  using G = Tile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[G::RM][G::RN];
  G::run(x, w, m, k, n, m0, n0, smem, acc);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < G::RM; ++i) {
    const int row = m0 + ty + 8 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < G::RN; ++j) {
      const int col = n0 + tx + 32 * j;
      if (col < n) out[(size_t)row * n + col] = acc[i][j];
    }
  }
}

template <int BM, int BN, int BK>
int launch_f32(const void* x, const void* w, void* out, int m, int k, int n,
               cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  tiled_gemm_f32_kernel<BM, BN, BK>
      <<<grid, gemm_tile::kThreads, Tile<BM, BN, BK>::smem_bytes(),
         stream>>>(static_cast<const float*>(x),
                   static_cast<const float*>(w), static_cast<float*>(out), m,
                   k, n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 and int8: tensor cores
// ---------------------------------------------------------------------------

constexpr int kStages = 4;

template <typename T, int BM, int BN>
struct TcTile {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int BK = 128 / sizeof(T);          // 128-byte rows
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kABytes = BM * 128;            // x: [BM][BK]
  static constexpr int kBBytes = BN * 128;            // w: [BK][BN] or [BN][BK]
  // Registers after setmaxnreg (two consumers only): the int8 producer
  // holds 16 x 4 bytes of w, and their transpose, at once.  The 384 threads
  // start at 168 each (65,536 / 384, rounded down to 8); the consumers'
  // increase must fit in what the producer gives up, or it never returns.
  static constexpr int kProducerRegs = kInt8 ? 72 : 56;
  static constexpr int kConsumerRegs = kInt8 ? 216 : 224;
  static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168,
                "setmaxnreg: the consumers would wait for registers forever");
  static constexpr size_t smem_bytes() {
    return 1024 + static_cast<size_t>(kStages) * (kABytes + kBBytes) +
           2 * kStages * sizeof(uint64_t);
  }
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN is 64, 128 or 256");
};

struct TcArgs {
  const void* x;
  const void* w;
  void* out;
  int m, k, n;
  int x_tma;   // x arrives by TMA; else the producer stages it
  int w_tma;   // bf16 w arrives by TMA; else the producer stages it
  int w_vec;   // int8 w rows allow 4-byte loads
};

// 16 bytes of a row of T from element c (16 / sizeof(T) elements), zero
// past `len` or when the row is out of range.  Moves raw bits.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* row, int c, int len,
                                            bool row_ok) {
  using U = typename std::conditional<sizeof(T) == 1, uint8_t,
                                      uint16_t>::type;
  constexpr int E = 16 / sizeof(T);
  const U* src = reinterpret_cast<const U*>(row);
  union {
    uint4 v;
    U e[E];
  } u;
#pragma unroll
  for (int i = 0; i < E; ++i)
    u.e[i] = (row_ok && c + i < len) ? src[c + i] : U(0);
  return u.v;
}

// x tile rows [m0, m0 + BM), columns [k0, k0 + BK) into [BM][128 B].
template <typename T, int BM>
__device__ void stage_x(const TcArgs& a, int m0, int k0, uint8_t* dst,
                        int t) {
  const T* x = static_cast<const T*>(a.x);
  for (int c = t; c < BM * 8; c += 128) {
    const int r = c >> 3, j = c & 7, row = m0 + r;
    const T* src = x + static_cast<size_t>(row < a.m ? row : 0) * a.k;
    *reinterpret_cast<uint4*>(dst + hopper::sw128_offset(r, j)) =
        load_chunk(src, k0 + j * (16 / (int)sizeof(T)), a.k, row < a.m);
  }
}

// bf16 w tile rows [k0, k0 + 64), columns [n0, n0 + BN) into BN / 64 blocks
// of [64 k][64 n] (N-major).
template <int BN>
__device__ void stage_w_bf16(const TcArgs& a, int n0, int k0, uint8_t* dst,
                             int t) {
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  constexpr int kChunks = BN / 8;   // per k row
  for (int c = t; c < 64 * kChunks; c += 128) {
    const int kk = c / kChunks, q = c - kk * kChunks;
    const int row = k0 + kk;
    const __nv_bfloat16* src =
        w + static_cast<size_t>(row < a.k ? row : 0) * a.n;
    *reinterpret_cast<uint4*>(dst + (q >> 3) * 8192 +
                              hopper::sw128_offset(kk, q & 7)) =
        load_chunk(src, n0 + q * 8, a.n, row < a.k);
  }
}

// int8 w tile rows [k0, k0 + 128), columns [n0, n0 + BN) into [BN][128 k]
// (K-major).  Unit u: k chunk u % 8 (16 rows) x columns 4 (u / 8) .. + 3:
// 16 4-byte loads, four 4 x 4 byte transposes, four 16-byte stores.  The
// eight lanes of one column group write eight distinct 16-byte slots of
// each swizzled row, so the stores do not conflict.
template <int BN>
__device__ void stage_w_int8(const TcArgs& a, int n0, int k0, uint8_t* dst,
                             int t) {
  const uint8_t* w = static_cast<const uint8_t*>(a.w);
  for (int u = t; u < 2 * BN; u += 128) {
    const int kb = u & 7, ng = u >> 3;
    const int col = n0 + 4 * ng;
    uint32_t r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = k0 + kb * 16 + i;
      const bool ok = row < a.k;
      const uint8_t* src = w + static_cast<size_t>(ok ? row : 0) * a.n + col;
      if (a.w_vec) {
        r[i] = (ok && col < a.n) ? *reinterpret_cast<const uint32_t*>(src)
                                 : 0u;
      } else {
        r[i] = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ok && col + e < a.n) r[i] |= static_cast<uint32_t>(src[e])
                                           << (8 * e);
      }
    }
    uint32_t o[4][4];                   // o[g][c]: k 4 g .. 4 g + 3 of column c
#pragma unroll
    for (int g = 0; g < 4; ++g)
      hopper::transpose4(r[4 * g], r[4 * g + 1], r[4 * g + 2],
                         r[4 * g + 3], o[g]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint4*>(dst + hopper::sw128_offset(4 * ng + c, kb)) =
          make_uint4(o[0][c], o[1][c], o[2][c], o[3][c]);
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TcTile<T, BM, BN>::kThreads,
                                  (BM == 64 && BN < 256) ? 2 : 1)
tc_gemm_kernel(const __grid_constant__ CUtensorMap tmx,
               const __grid_constant__ CUtensorMap tmw, const TcArgs a) {
  using G = TcTile<T, BM, BN>;
  using Acc = typename std::conditional<G::kInt8, int, float>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = hopper::align_1024(smem_raw);      // kStages x [BM][128 B]
  uint8_t* ws = xs + kStages * G::kABytes;         // kStages x w tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kStages * G::kBBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = (a.k + G::BK - 1) / G::BK;
  const bool staged = !a.x_tma || !a.w_tma;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], staged ? 128 : 1);
      hopper::mbar_init(&empty[s], G::kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == G::kConsumers) {
    // Producer warpgroup.
    if constexpr (G::kConsumers == 2) hopper::setmaxnreg_dec<G::kProducerRegs>();
    const int t = threadIdx.x - 128 * G::kConsumers;
    if (!staged && t != 0) return;
    const uint32_t tx = (a.x_tma ? G::kABytes : 0) + (a.w_tma ? G::kBBytes : 0);
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      hopper::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
      uint8_t* xt = xs + s * G::kABytes;
      uint8_t* wt = ws + s * G::kBBytes;
      const int k0 = kt * G::BK;
      if (t == 0 && tx != 0) {
        hopper::mbar_expect_tx(&full[s], tx);
        if (a.x_tma) hopper::tma_load_2d(xt, &tmx, &full[s], k0, m0);
        if (a.w_tma) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load_2d(wt + j * 8192, &tmw, &full[s], n0 + 64 * j,
                                k0);
        }
      }
      if (staged) {
        if (!a.x_tma) stage_x<T, BM>(a, m0, k0, xt, t);
        if (!a.w_tma) {
          if constexpr (G::kInt8)
            stage_w_int8<BN>(a, n0, k0, wt, t);
          else
            stage_w_bf16<BN>(a, n0, k0, wt, t);
        }
        hopper::fence_proxy_async();
      }
      hopper::mbar_arrive(&full[s]);
    }
  } else {
    // Consumer warpgroup wg: rows m0 + 64 wg .. + 63.
    if constexpr (G::kConsumers == 2) hopper::setmaxnreg_inc<G::kConsumerRegs>();
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      hopper::mbar_wait(&full[s], (kt / kStages) & 1);
      const uint32_t xa = hopper::smem_u32(xs + s * G::kABytes) + wg * 64 * 128;
      const uint32_t wa = hopper::smem_u32(ws + s * G::kBBytes);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // 32 bytes of K per instruction
        const uint64_t da = hopper::desc_sw128(xa + 32 * kk, 16, 1024);
        if constexpr (G::kInt8)
          hopper::WgmmaS8SS<BN>::run(
              acc, da, hopper::desc_sw128(wa + 32 * kk, 16, 1024));
        else
          hopper::WgmmaBf16SS<BN, 1>::run(
              acc, da, hopper::desc_sw128(wa + 2048 * kk, 8192, 1024));
      }
      hopper::wgmma_commit();
      // The previous tile's products are done: release its stage.
      hopper::wgmma_wait<1>();
      if (kt > 0 && threadIdx.x % 128 == 0)
        hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
    const bool pairs = (a.n & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= a.n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= a.m) continue;
        const Acc v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const size_t o = static_cast<size_t>(row) * a.n + col;
        if constexpr (G::kInt8) {
          int* out = static_cast<int*>(a.out);
          if (pairs)
            *reinterpret_cast<int2*>(out + o) = make_int2(v0, v1);
          else {
            out[o] = v0;
            if (col + 1 < a.n) out[o + 1] = v1;
          }
        } else {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
          if (pairs)
            *reinterpret_cast<__nv_bfloat162*>(out + o) =
                __floats2bfloat162_rn(v0, v1);
          else {
            out[o] = __float2bfloat16_rn(v0);
            if (col + 1 < a.n) out[o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

template <typename T, int BM, int BN>
int launch_tc(const void* x, const void* w, void* out, int m, int k, int n,
              cudaStream_t stream) {
  using G = TcTile<T, BM, BN>;
  static bool raised = false;  // the >48 KB opt-in, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_gemm_kernel<T, BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::smem_bytes()));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  constexpr CUtensorMapDataType kType =
      G::kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto aligned = [](const void* p, long long row_bytes) {
    return row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  TcArgs a{x, w, out, m, k, n, 0, 0, 0};
  CUtensorMap tmx{}, tmw{};
  if (k > 0 && aligned(x, static_cast<long long>(k) * sizeof(T))) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * sizeof(T)};
    const cuuint32_t box[2] = {G::BK, BM};
    const int err = hopper::make_tma_map(&tmx, kType, 2, x, dims, strides, box);
    if (err != 0) return err;
    a.x_tma = 1;
  }
  if constexpr (G::kInt8) {
    a.w_vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  } else if (k > 0 && aligned(w, static_cast<long long>(n) * 2)) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 2};
    const cuuint32_t box[2] = {64, 64};
    const int err = hopper::make_tma_map(&tmw, kType, 2, w, dims, strides, box);
    if (err != 0) return err;
    a.w_tma = 1;
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  tc_gemm_kernel<T, BM, BN>
      <<<grid, G::kThreads, G::smem_bytes(), stream>>>(tmx, tmw, a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* x, const void* w, void* out, int m, int k, int n,
                 int bm, int bk, int bn, cudaStream_t st) {
#define REPRO_TILE(BM, BK, BN)              \
  if (bm == BM && bk == BK && bn == BN)     \
    return launch_f32<BM, BN, BK>(x, w, out, m, k, n, st);
  GEMM_TILE_FOR_ALL(REPRO_TILE)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core tile set (core/tiling.py TC_BLOCK_*): bk is 128 bytes.
template <typename T>
int dispatch_tc(const void* x, const void* w, void* out, int m, int k, int n,
                int bm, int bk, int bn, cudaStream_t st) {
  if (bk != TcTile<T, 64, 64>::BK) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_TC(BM, BN) \
  if (bm == BM && bn == BN) return launch_tc<T, BM, BN>(x, w, out, m, k, n, st);
  REPRO_TC(64, 64) REPRO_TC(64, 128) REPRO_TC(64, 256)
  REPRO_TC(128, 64) REPRO_TC(128, 128) REPRO_TC(128, 256)
#undef REPRO_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 int8 (out int32), 1 f32 (out f32), 2 bf16 (out bf16).  A tile
// outside core/tiling.py's set for the dtype, or an empty or oversized grid,
// returns cudaErrorInvalidValue; otherwise returns cudaGetLastError() after
// the launch.  K = 0 gives zeros.
extern "C" int repro_tiled_gemm(const void* x, const void* w, void* out,
                                int dtype, int m, int k, int n, int bm,
                                int bk, int bn, void* stream) {
  if (m < 1 || k < 0 || n < 1 || bm < 1 || (m + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_tc<int8_t>(x, w, out, m, k, n, bm, bk, bn, st);
    case 1:
      return dispatch_f32(x, w, out, m, k, n, bm, bk, bn, st);
    case 2:
      return dispatch_tc<__nv_bfloat16>(x, w, out, m, k, n, bm, bk, bn, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
