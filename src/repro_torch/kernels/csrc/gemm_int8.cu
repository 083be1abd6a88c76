// gemm_int8: (M, K) int8 @ (K, N) int8 -> int32 accumulator, flushed as
// acc * (x_scale * w_scale[n]) into f32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/gemm_int8.py::gemm_int8 (Pallas
// body _int8_kernel).  On the TPU the K loop was the sequential grid axis
// carrying the accumulator in VMEM scratch; here one CTA of 256 threads owns
// a (BM, BN) output tile, walks K in BK chunks through a three-stage ring in
// shared memory, and keeps its accumulators in registers.
//
// What bounds it on this card: on the edge path (M = 8, K and N <= 250) a
// layer moves a few KiB and does ~10^5 int8 operations, so the launch and the
// round trips to device memory bind, as they do for the per-layer rung that
// runs this kernel once per layer.  At large shapes (the 256 x 1024 x 1024
// check) operations bind.  The design:
//  * Products on the int8 tensor cores, mma.sync m16n8k32, computing the
//    transposed tile: A = 16 output columns x 32 K of the w tile, B = 8 rows
//    of the x tile, so M = 8 fills the instruction's n = 8 side.  Warps tile
//    the (BN / 16) x (BM / 8) instruction tiles.
//  * Loads run two tiles ahead of the products, so two tiles' round trips
//    to device memory overlap.  x tiles, K-contiguous as they lie, are
//    staged by 16-byte cp.async (rows past M and K read as zeros); a K
//    that is not a multiple of 16, which leaves rows unaligned, is staged
//    with masked byte loads into registers instead.
//  * w tiles are read as 4-byte words of 4 K-rows into registers,
//    transposed with __byte_perm into K-contiguous columns and stored just
//    before their tile's barrier.  Every load into registers is predicated
//    and left unread until then, so none stalls the loads after it; only
//    an N that is not a multiple of 4 (bytes, packed as they arrive, on the
//    edge path N = 2 and 5) waits for its loads.
//  * Every tile row is padded by 16 bytes, so ldmatrix reads conflict-free.
// The tiles come from the port's planner (core/tiling.py, the only tiles
// instantiated below), and the kernel masks the ragged edge itself, so the
// wrapper pads nothing.
//
// Numerics: int32 sums are exact in any order; the flush is
// __fmul_rn(acc_f, __fmul_rn(sx, sw[n])), the reference's order; bf16 rounds
// to nearest even (__float2bfloat16_rn).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSkew = 16;   // bytes added to every tile row (tiling.py SKEW)
constexpr int kStages = 3;  // the ring of x and w tiles (tiling.py STAGES)

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// How the 8 warps tile the (NT = BN / 16) x (MT = BM / 8) instruction tiles:
// a WN x WM grid of warps, each TN x TM tiles.  With fewer than 8 tiles a
// warp takes one and the rest only stage.
template <int BM, int BN>
struct Warps {
  static constexpr int MT = BM / 8, NT = BN / 16;
  static constexpr int WN =
      MT * NT < kWarps ? NT
      : (MT >= kWarps / cmin(NT, 4) ? cmin(NT, 4) : kWarps / MT);
  static constexpr int WM = MT * NT < kWarps ? MT : kWarps / WN;
  static constexpr int TN = NT / WN, TM = MT / WM;
  static_assert(WN * TN == NT && WM * TM == MT && WN * WM <= kWarps,
                "warp tiling must cover the tile");
};

template <int BM, int BN, int BK>
struct Stage {
  static constexpr int kStride = BK + kSkew;
  static constexpr int kX = BM * kStride;            // x tile bytes
  static constexpr int kBytes = (BM + BN) * kStride;  // x and w tiles
  static constexpr int kXChunks = BM * BK / 16;       // 16-byte x chunks
  static constexpr int kXPer = (kXChunks + kThreads - 1) / kThreads;
  static constexpr int kWUnits = BK * BN / 16;        // 4 x 4 byte w blocks
  static constexpr int kWPer = (kWUnits + kThreads - 1) / kThreads;
};

struct Args {
  const int8_t* x;
  const int8_t* w;
  int m, k, n;
  bool x16;   // x rows 16-byte aligned: K % 16 == 0, aligned base
  bool w4;    // w rows 4-byte aligned: N % 4 == 0, aligned base
};

// v = *p when ok, else v unchanged: a predicated load that no instruction
// waits for until the value is stored, so a tile's loads all fly at once.
// (A C++ conditional load compiles to a select, which stalls the warp on
// each load in turn.)
__device__ __forceinline__ void load_u32_if(uint32_t& v, const void* p,
                                            bool ok) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.u32 %0, [%1];\n}\n"
      : "+r"(v)
      : "l"(p), "r"(static_cast<int>(ok)));
}

__device__ __forceinline__ void load_u8_if(uint32_t& v, const void* p,
                                           bool ok) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.u8 %0, [%1];\n}\n"
      : "+r"(v)
      : "l"(p), "r"(static_cast<int>(ok)));
}

// The x tile of rows [m0, m0 + BM), columns [k0, k0 + BK) into dst
// ([BM][kStride]): by cp.async when aligned, else as masked byte loads into
// `regs` (one byte a register), packed and stored by store_x.
template <int BM, int BN, int BK>
__device__ __forceinline__ void load_x(const Args& a, int m0, int k0,
                                       uint8_t* dst, uint32_t (&regs)[
                                           Stage<BM, BN, BK>::kXPer][16]) {
  using S = Stage<BM, BN, BK>;
  constexpr int kPerRow = BK / 16;
#pragma unroll
  for (int j = 0; j < S::kXPer; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (S::kXChunks % kThreads != 0 && c >= S::kXChunks) break;
    const int r = c / kPerRow, q = c - r * kPerRow;
    const int row = m0 + r, col = k0 + 16 * q;
    const int8_t* src = a.x + (size_t)row * a.k + col;
    if (a.x16) {
      const bool ok = row < a.m && col < a.k;
      hopper::cp_async16(dst + r * S::kStride + 16 * q, ok ? src : a.x,
                         ok ? 16u : 0u);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        regs[j][e] = 0u;
        load_u8_if(regs[j][e], src + e, row < a.m && col + e < a.k);
      }
    }
  }
}

template <int BM, int BN, int BK>
__device__ __forceinline__ void store_x(const Args& a, uint8_t* dst,
                                        const uint32_t (&regs)[
                                            Stage<BM, BN, BK>::kXPer][16]) {
  using S = Stage<BM, BN, BK>;
  constexpr int kPerRow = BK / 16;
  if (a.x16) return;
#pragma unroll
  for (int j = 0; j < S::kXPer; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (S::kXChunks % kThreads != 0 && c >= S::kXChunks) break;
    const int r = c / kPerRow, q = c - r * kPerRow;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = regs[j][4 * i] | regs[j][4 * i + 1] << 8 |
             regs[j][4 * i + 2] << 16 | regs[j][4 * i + 3] << 24;
    *reinterpret_cast<uint4*>(dst + r * S::kStride + 16 * q) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Unit u of the w tile: K rows k0 + 4 kq .. + 3 of columns n0 + 4 nq .. + 3,
// with nq's low two bits fastest, then kq, then nq's high bits, so a warp
// reads 16 contiguous bytes from each of 8 rows.  Word i of the unit is
// row 4 kq + i.
template <int BK>
__device__ __forceinline__ void w_unit(int u, int& kq, int& nq) {
  constexpr int kKq = BK / 4;
  const int rest = u >> 2;
  kq = rest % kKq;
  nq = 4 * (rest / kKq) + (u & 3);
}

template <int BM, int BN, int BK>
__device__ __forceinline__ void load_w(const Args& a, int n0, int k0,
                                       uint32_t (&regs)[
                                           Stage<BM, BN, BK>::kWPer][4]) {
  using S = Stage<BM, BN, BK>;
#pragma unroll
  for (int j = 0; j < S::kWPer; ++j) {
    const int u = threadIdx.x + j * kThreads;
    if (S::kWUnits % kThreads != 0 && u >= S::kWUnits) break;
    int kq, nq;
    w_unit<BK>(u, kq, nq);
    const int col = n0 + 4 * nq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + 4 * kq + i;
      const int8_t* src = a.w + (size_t)row * a.n + col;
      uint32_t v = 0u;
      if (a.w4) {
        load_u32_if(v, src, row < a.k && col < a.n);
      } else if (row < a.k) {   // packed here: these loads are waited for
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < a.n)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(src[e]))
                 << (8 * e);
      }
      regs[j][i] = v;
    }
  }
}

// The units' words transposed into the K-contiguous w tile ([BN][kStride]).
template <int BM, int BN, int BK>
__device__ __forceinline__ void store_w(uint8_t* dst, const uint32_t (&regs)[
                                            Stage<BM, BN, BK>::kWPer][4]) {
  using S = Stage<BM, BN, BK>;
#pragma unroll
  for (int j = 0; j < S::kWPer; ++j) {
    const int u = threadIdx.x + j * kThreads;
    if (S::kWUnits % kThreads != 0 && u >= S::kWUnits) break;
    int kq, nq;
    w_unit<BK>(u, kq, nq);
    uint32_t o[4];
    hopper::transpose4(regs[j][0], regs[j][1], regs[j][2], regs[j][3], o);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(dst + (4 * nq + c) * S::kStride +
                                   4 * kq) = o[c];
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
gemm_int8_kernel(Args a, const float* __restrict__ sw, float sx,
                 void* __restrict__ out, int out_bf16) {
  using S = Stage<BM, BN, BK>;
  using W = Warps<BM, BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % W::WN, wm = warp / W::WN;
  const bool computes = warp < W::WN * W::WM;
  const int k_tiles = (a.k + BK - 1) / BK;

  // Lane roles in the fragments (hopper.cuh mma_s8_16832).
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * S::kStride +
                    (lane >> 4) * 16;
  const int b_off = (lane & 7) * S::kStride + ((lane >> 3) & 1) * 16;

  int acc[W::TN][W::TM][4];
#pragma unroll
  for (int i = 0; i < W::TN; ++i)
#pragma unroll
    for (int j = 0; j < W::TM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // A three-stage ring, two tiles ahead: step kt stores the w (and
  // unaligned x) words of tile kt, loaded two steps earlier, waits for its
  // x copies, and after the barrier issues tile kt + 2's loads into the
  // registers it just emptied and the ring slot step kt - 1 read.  Two
  // tiles' loads are in flight at once, and a K of up to two tiles loads
  // in one round trip.  Every issue commits one cp.async group.
  uint32_t xa[S::kXPer][16], xb[S::kXPer][16];
  uint32_t wa[S::kWPer][4], wb[S::kWPer][4];
  auto issue = [&](int kt, uint32_t (&xr)[S::kXPer][16],
                   uint32_t (&wr)[S::kWPer][4]) {
    load_x<BM, BN, BK>(a, m0, kt * BK, smem + (kt % kStages) * S::kBytes,
                       xr);
    hopper::cp_async_commit();
    load_w<BM, BN, BK>(a, n0, kt * BK, wr);
  };
  auto step = [&](int kt, uint32_t (&xr)[S::kXPer][16],
                  uint32_t (&wr)[S::kWPer][4]) {
    uint8_t* cur = smem + (kt % kStages) * S::kBytes;
    store_x<BM, BN, BK>(a, cur, xr);
    store_w<BM, BN, BK>(cur + S::kX, wr);
    if (kt + 1 < k_tiles)
      hopper::cp_async_wait_group<1>();   // tile kt + 1's may fly on
    else
      hopper::cp_async_wait_group<0>();
    __syncthreads();   // tile kt is in; every warp is done with tile kt - 1
    if (kt + 2 < k_tiles) issue(kt + 2, xr, wr);
    if (!computes) return;
    const uint32_t xs = hopper::smem_u32(cur);
    const uint32_t ws = hopper::smem_u32(cur + S::kX);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[W::TN][4], bf[W::TM][2];
#pragma unroll
      for (int i = 0; i < W::TN; ++i)
        hopper::ldmatrix_x4(af[i], ws + (wn * W::TN + i) * 16 * S::kStride +
                                       a_off + kk);
#pragma unroll
      for (int j = 0; j < W::TM; ++j)
        hopper::ldmatrix_x2(bf[j], xs + (wm * W::TM + j) * 8 * S::kStride +
                                       b_off + kk);
#pragma unroll
      for (int i = 0; i < W::TN; ++i)
#pragma unroll
        for (int j = 0; j < W::TM; ++j)
          hopper::mma_s8_16832(acc[i][j], af[i], bf[j]);
    }
  };
  issue(0, xa, wa);
  if (k_tiles > 1) issue(1, xb, wb);
  for (int kt = 0; kt < k_tiles; kt += 2) {
    step(kt, xa, wa);
    if (kt + 1 < k_tiles) step(kt + 1, xb, wb);
  }

  if (!computes) return;
  // acc[i][j][2h + e]: column n0 + 16 (wn TN + i) + lane / 4 + 8h, row
  // m0 + 8 (wm TM + j) + 2 (lane % 4) + e.
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < W::TN; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * (wn * W::TN + i) + gq + 8 * h;
      if (col >= a.n) continue;
      const float scale = __fmul_rn(sx, sw[col]);
#pragma unroll
      for (int j = 0; j < W::TM; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * (wm * W::TM + j) + 2 * tq + e;
          if (row >= a.m) continue;
          const float v =
              __fmul_rn(static_cast<float>(acc[i][j][2 * h + e]), scale);
          const size_t o = (size_t)row * a.n + col;
          if (out_bf16)
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
          else
            static_cast<float*>(out)[o] = v;
        }
    }
}

template <int BM, int BN, int BK>
int launch(const Args& a, const float* sw, float sx, void* out, int out_bf16,
           cudaStream_t stream) {
  constexpr size_t smem = kStages * Stage<BM, BN, BK>::kBytes;
  if (smem > 48 * 1024) {   // the opt-in, once per device and process
    static unsigned long long configured = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!(configured >> dev & 1ull)) {
      e = cudaFuncSetAttribute(gemm_int8_kernel<BM, BN, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      configured |= 1ull << dev;
    }
  }
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM);
  gemm_int8_kernel<BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      a, sw, sx, out, out_bf16);
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
  const Args a{x, w, m, k, n,
               k % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0,
               n % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 3) == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM, BK, BN) \
  if (bm == BM && bk == BK && bn == BN)  \
    return launch<BM, BN, BK>(a, sw, sx, out, out_bf16, st);
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
