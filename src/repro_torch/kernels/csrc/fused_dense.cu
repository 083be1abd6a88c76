// fused_dense: act(x @ w + b) (+ residual) in one launch, f32 accumulation,
// output in f32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/fused_dense.py::fused_dense
// (Pallas body _fused_kernel): the DR7' boundary eliminator, whose epilogue
// keeps the activation out of device memory between the GEMM and the
// elementwise ops.  The epilogue runs in the reference's order (_flush):
// bias in f32, then the activation, then the residual in f32, then the cast.
//
// What bounds it on this card: every caller runs M <= 64 rows (8 on the
// edge forward and the calibration pass) with K and N of a few hundred, so
// a layer moves a few KiB and does at most ~10^6 FLOPs: ~0.01 us of work.
// Its time is the launch, the round trips to device memory, and inside a
// CTA the issue of its copies and its shared-memory reads, which one SM's
// load pipes serve.  The design:
//  * One round trip.  A CTA owns a (BM, BN) output strip.  At entry every
//    thread issues its asynchronous copies (cp.async, 16 bytes where rows
//    allow, else 8 or 4; zero-filled past M, K and N) of the CTA's whole K
//    strip of x (BM x K) and w (K x BN) into shared memory, and predicated
//    loads of its outputs' bias and residual; nothing waits before the last
//    is issued.  Where a strip would pass the block's shared memory, K runs
//    in a ring of two block_k chunks, the next chunk in flight while the
//    current one is summed (core/tiling.py's planner picks the fewest
//    stages the budget allows).
//  * K split over the warps.  Each of the 8 warps sums a slice of the
//    chunk for the whole strip (lanes own columns, and rows where BN < 32),
//    reading 4 K values of an x row at once; the partial sums meet in
//    shared memory and each output's epilogue runs once, on one thread.
//    The serial FMA chain is K / 8 long, not K.
//  * Narrow strips.  A CTA's copies and sums take time in proportion to
//    the bytes and the shared-memory reads it has, so the planner takes
//    BN = 8 at M = 8: a layer of N = 104-136 runs on 13-17 SMs, each
//    moving and summing a 13th-17th of the w strip.
//  * Rows that are not 16-byte multiples (K = 27 or 250, N = 2 or 5) are
//    copied in the widest unit that divides them, in the same launch; bf16
//    rows of odd length take masked 2-byte loads.
//
// Numerics: f32 and bf16 operands stay in their type in shared memory and
// are widened at the product, which is exact in f32; sums are f32 FMAs, per
// warp in K order, then the warps' partials in warp order.  gelu is the tanh
// approximation (jax.nn.gelu's default, torch's approximate="tanh"),
// computed with tanhf, not erff.  No fast math.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // the split of K (tiling.FD_WARPS)
constexpr long long kSmemLimit = 232448;

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

// Shared memory of one CTA (tiling.py fused_dense_smem_bytes): `buffers`
// stage buffers of `chunk` K values, each the x rows (x_row bytes apiece,
// an odd number of 16-byte units) then w_rows rows of BN values; then the
// warps' f32 partial sums.
struct Layout {
  int chunk, x_row, w_rows, stage, buffers;
  long long bytes;
};

__host__ __device__ inline Layout layout(int bm, int bn, int k, int bk,
                                         int isz) {
  Layout l;
  l.chunk = k < bk ? k : bk;
  l.x_row = (l.chunk * isz + 15) / 16 * 16;
  if (l.x_row / 16 % 2 == 0) l.x_row += 16;
  l.w_rows = (l.chunk + 3) / 4 * 4;
  l.stage = bm * l.x_row + l.w_rows * bn * isz;
  l.buffers = k <= bk ? 1 : 2;
  l.bytes = static_cast<long long>(l.buffers) * l.stage +
            4LL * kWarps * bm * bn;
  return l;
}

struct Args {
  const void* x;
  const void* w;
  const float* b;
  const void* res;    // null or (M, N)
  void* out;
  int m, k, n, bk;
  int out_bf16, act;
  int gx, gw;         // copy unit of x and w rows in bytes: 16, 8, 4 or 2
  Layout lay;
};

// v = *p when ok, else v unchanged: predicated loads that nothing waits for
// until v is read.
__device__ __forceinline__ void ldg_u32_if(uint32_t& v, const void* p,
                                           bool ok) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.u32 %0, [%1];\n}\n"
      : "+r"(v)
      : "l"(p), "r"(static_cast<int>(ok)));
}

__device__ __forceinline__ void ldg_u16_if(uint32_t& v, const void* p,
                                           bool ok) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.u16 %0, [%1];\n}\n"
      : "+r"(v)
      : "l"(p), "r"(static_cast<int>(ok)));
}

// One g-byte unit (g = 16, 8 or 4, the same in every thread) from global to
// shared memory by cp.async; zeros when !ok.
__device__ __forceinline__ void cp_async_unit(int g, uint8_t* dst,
                                              const uint8_t* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const uint32_t n = ok ? static_cast<uint32_t>(g) : 0u;
  if (g == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else if (g == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of row_bytes (a multiple of 16) from src (row stride
// src_stride) to dst (row stride dst_stride), in g-byte units; rows at or
// past valid_rows and bytes at or past valid_bytes (a multiple of g) read as
// zeros.  A power-of-two team of threads takes each row, so no thread
// divides.  g = 2 (bf16 rows of odd length; kNarrow only) loads into
// registers, four units a thread in flight, and stores.
template <bool kNarrow>
__device__ __forceinline__ void copy_rows(int g, uint8_t* dst, int dst_stride,
                                          const uint8_t* src,
                                          size_t src_stride, int rows,
                                          int valid_rows, int row_bytes,
                                          int valid_bytes) {
  if (kNarrow && g == 2) {
    const int upr = row_bytes / 2, total = rows * upr;
    for (int base = threadIdx.x; base < total; base += 4 * kThreads) {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = base + j * kThreads;
        const int r = idx / upr, u = idx - r * upr;
        v[j] = 0u;
        ldg_u16_if(v[j], src + r * src_stride + 2 * u,
                   idx < total && r < valid_rows && 2 * u < valid_bytes);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = base + j * kThreads;
        if (idx >= total) break;
        const int r = idx / upr, u = idx - r * upr;
        *reinterpret_cast<uint16_t*>(dst + r * dst_stride + 2 * u) =
            static_cast<uint16_t>(v[j]);
      }
    }
    return;
  }
  const int shift = __ffs(g) - 1;
  const int upr = row_bytes >> shift;
  const int lt = upr <= 1 ? 0 : min(8, 32 - __clz(upr - 1));
  const int tpr = 1 << lt;
  for (int r = threadIdx.x >> lt; r < rows; r += kThreads >> lt) {
    const uint8_t* s = src + r * src_stride;
    for (int u = threadIdx.x & (tpr - 1); u < upr; u += tpr) {
      const int off = u << shift;
      const bool ok = r < valid_rows && off < valid_bytes;
      cp_async_unit(g, dst + r * dst_stride + off, ok ? s + off : src, ok);
    }
  }
}

// Issues the copies of K chunk c of the strip into buf.
template <typename T, int BM, int BN>
__device__ __forceinline__ void stage(const Args& a, int m0, int n0, int c,
                                      uint8_t* buf) {
  constexpr int isz = sizeof(T);
  const int k0 = c * a.bk;
  const int valid_k = min(a.bk, a.k - k0);
  const uint8_t* x = static_cast<const uint8_t*>(a.x) +
                     ((size_t)m0 * a.k + k0) * isz;
  copy_rows<isz == 2>(a.gx, buf, a.lay.x_row, x, (size_t)a.k * isz, BM,
                      a.m - m0, (a.lay.chunk * isz + 15) / 16 * 16,
                      valid_k * isz);
  const uint8_t* w = static_cast<const uint8_t*>(a.w) +
                     ((size_t)k0 * a.n + n0) * isz;
  copy_rows<isz == 2>(a.gw, buf + BM * a.lay.x_row, BN * isz, w,
                      (size_t)a.n * isz, a.lay.w_rows, valid_k, BN * isz,
                      (a.n - n0) * isz);
}

__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// How a warp's lanes cover the (BM, BN) strip: CL lanes across columns
// (columns lane % CL + CL j), RG row groups (rows lane / CL + RG i).
template <int BM, int BN>
struct Lanes {
  static constexpr int CL = BN < 32 ? BN : 32;
  static constexpr int RG = 32 / CL;
  static constexpr int RM = BM / RG, RN = BN / CL;
  static constexpr int kOut = BM * BN;
  static constexpr int kOutPer = (kOut + kThreads - 1) / kThreads;
  static_assert(RM * RG == BM && RN * CL == BN, "lanes must cover the strip");
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
fused_dense_kernel(const Args a) {
  using L = Lanes<BM, BN>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (a.k + a.bk - 1) / a.bk;

#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    if (c < nc) stage<T, BM, BN>(a, m0, n0, c, smem + c * a.lay.stage);
    cp_async_commit();
  }

  // This thread's outputs in the epilogue, and their bias and residual.
  float bias[L::kOutPer];
  uint32_t res[L::kOutPer];
#pragma unroll
  for (int j = 0; j < L::kOutPer; ++j) {
    const int o = threadIdx.x + j * kThreads;
    const int row = m0 + o / BN, col = n0 + o % BN;
    const bool ok = o < L::kOut && row < a.m && col < a.n;
    uint32_t bv = 0u;
    ldg_u32_if(bv, a.b + col, ok);
    bias[j] = __uint_as_float(bv);
    res[j] = 0u;
    if (a.res != nullptr) {
      const size_t e = (size_t)row * a.n + col;
      if constexpr (kBf16)
        ldg_u16_if(res[j], static_cast<const uint16_t*>(a.res) + e, ok);
      else
        ldg_u32_if(res[j], static_cast<const uint32_t*>(a.res) + e, ok);
    }
  }

  const int cg = lane % L::CL, rg = lane / L::CL;
  float acc[L::RM][L::RN];
#pragma unroll
  for (int i = 0; i < L::RM; ++i)
#pragma unroll
    for (int j = 0; j < L::RN; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const uint8_t* buf = smem + (c & 1) * a.lay.stage;
    const T* xs = reinterpret_cast<const T*>(buf);
    const T* ws = reinterpret_cast<const T*>(buf + BM * a.lay.x_row);
    const int x_stride = a.lay.x_row / static_cast<int>(sizeof(T));
    // This warp's slice of the chunk's K, in steps of 4.
    const int kq = (min(a.bk, a.k - c * a.bk) + 3) & ~3;
    const int slice = (kq + 4 * kWarps - 1) / (4 * kWarps) * 4;
    const int k_lo = warp * slice, k_hi = min(k_lo + slice, kq);
#pragma unroll 2
    for (int k = k_lo; k < k_hi; k += 4) {
      float wv[4][L::RN];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < L::RN; ++j)
          wv[kk][j] = to_f32(ws[(k + kk) * BN + cg + L::CL * j]);
#pragma unroll
      for (int i = 0; i < L::RM; ++i) {
        float xv[4];
        load4(xv, xs + (rg + L::RG * i) * x_stride + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < L::RN; ++j)
            acc[i][j] = fmaf(xv[kk], wv[kk][j], acc[i][j]);
      }
    }
    if (c + 2 < nc) {
      __syncthreads();
      stage<T, BM, BN>(a, m0, n0, c + 2, smem + (c & 1) * a.lay.stage);
      cp_async_commit();
    }
  }

  float* part = reinterpret_cast<float*>(smem + a.lay.buffers * a.lay.stage);
#pragma unroll
  for (int i = 0; i < L::RM; ++i)
#pragma unroll
    for (int j = 0; j < L::RN; ++j)
      part[warp * L::kOut + (rg + L::RG * i) * BN + cg + L::CL * j] =
          acc[i][j];
  __syncthreads();

#pragma unroll
  for (int j = 0; j < L::kOutPer; ++j) {
    const int o = threadIdx.x + j * kThreads;
    const int row = m0 + o / BN, col = n0 + o % BN;
    if (o >= L::kOut || row >= a.m || col >= a.n) continue;
    float s = part[o];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s += part[q * L::kOut + o];
    float y = activate(s + bias[j], a.act);
    if (a.res != nullptr)
      y += __uint_as_float(kBf16 ? res[j] << 16 : res[j]);
    const size_t e = (size_t)row * a.n + col;
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[e] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(a.out)[e] = y;
  }
}

template <typename T, int BM, int BN>
int launch(const Args& a, cudaStream_t stream) {
  // The opt-in above 48 KB, once per instance, device and process.
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(configured >> dev & 1ull)) {
    e = cudaFuncSetAttribute(fused_dense_kernel<T, BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << dev;
  }
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM);
  fused_dense_kernel<T, BM, BN>
      <<<grid, kThreads, static_cast<size_t>(a.lay.bytes), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Instantiate BODY(BM, BN) for the strips core/tiling.py offers
// (FD_BLOCK_M x FD_BLOCK_N, at most 512 outputs).
#define FD_FOR_ALL(BODY) BODY(8, 8) BODY(8, 16) BODY(8, 32) BODY(8, 64) \
  BODY(16, 8) BODY(16, 16) BODY(16, 32)

template <typename T>
int dispatch(const Args& a, int bm, int bn, cudaStream_t st) {
#define REPRO_TILE(BM, BN) \
  if (bm == BM && bn == BN) return launch<T, BM, BN>(a, st);
  FD_FOR_ALL(REPRO_TILE)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The widest copy unit (16, 8, 4 or 2 bytes) that divides both the base
// address and the row length in bytes; 1 if none does.
int copy_unit(const void* p, long long row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int g = 16; g >= 2; g >>= 1)
    if (a % g == 0 && row_bytes % g == 0) return g;
  return 1;
}

}  // namespace

// x_bf16: x, w and the residual are bf16 (else f32); b is f32 (N,); the
// residual is null or (M, N); act is the Act code; (bm, bk, bn) a tile of
// core/tiling.py's fused_dense set; smem_bytes the shared memory the wrapper
// sized the launch at (tiling.fused_dense_smem_bytes), refused unless it
// equals this source's layout().  An unknown tile or act, a misaligned
// operand, or an empty or oversized grid returns cudaErrorInvalidValue;
// otherwise returns cudaGetLastError() after the launch.  K = 0 is legal:
// the epilogue runs on zero sums.
extern "C" int repro_fused_dense(const void* x, const void* w, const float* b,
                                 const void* residual, void* out, int x_bf16,
                                 int out_bf16, int act, int m, int k, int n,
                                 int bm, int bk, int bn, int smem_bytes,
                                 void* stream) {
  const int isz = x_bf16 ? 2 : 4;
  if (m < 1 || k < 0 || n < 1 || bm < 1 || bn < 1 || bk < 16 || bk % 16 ||
      (m + bm - 1) / bm > 65535 || act < kNone || act > kSigmoid)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, w, b, residual, out, m, k, n, bk, out_bf16, act,
         copy_unit(x, static_cast<long long>(k) * isz),
         copy_unit(w, static_cast<long long>(n) * isz),
         layout(bm, bn, k, bk, isz)};
  if (a.gx < isz || a.gw < isz || a.lay.bytes > kSmemLimit ||
      a.lay.bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return dispatch<__nv_bfloat16>(a, bm, bn, st);
  return dispatch<float>(a, bm, bn, st);
}
