// flash_attention_bwd: the gradient of flash_attention.  Given q (B, Hq, S,
// D), k and v (B, Hkv, Sk, D), the forward's output o and the upstream dO,
// it writes dq, dk and dv in the inputs' dtype (f32 or bf16) with f32
// arithmetic throughout, for every option the forward takes but a query
// offset: causal or not, a sliding window, a logit softcap, the scale, GQA
// and MQA (KV head of query head h: h / (Hq / Hkv)), D a multiple of 8 up
// to 256.
//
// It replaces no TPU kernel: the JAX package trains through plain jnp
// attention (models/layers.py::chunked_attention) under jax.grad, and no
// Pallas kernel there has a custom_vjp.  The port's training forward runs
// the flash kernel (csrc/flash_attention.cu), so its gradient is a kernel
// too.  The semantics are flash_attention_plain's: masked logits and keys
// at or past Sk carry P = 0, a row with zero mass has o = 0 and zero
// gradients, the softcap chains as t = tanh(x / cap), dx = ds (1 - t^2),
// and then the scale.
//
// Two launches, no atomics, so the result is the same on every run:
//
// * flash_bwd_dq_kernel, one CTA per (batch * query head, query tile):
//   first D_i = rowsum(dO o) and, over the key tiles of the mask's band,
//   the row's log-sum-exp (the forward keeps no statistics, so it stays as
//   it is); both go to a workspace.  Then a second walk over the same key
//   tiles recomputes P = exp(s - lse), dP = dO V^T and dS, and accumulates
//   dQ = scale * dS K in registers.
// * flash_bwd_dkdv_kernel, one CTA per (batch * KV head, key tile): it
//   walks the query heads of its group and, for each, the query tiles of
//   the band, recomputes P and dS from the workspace's statistics, and
//   accumulates dV = P^T dO and dK = scale * dS^T Q in registers.
//
// What bounds it on this card: at gemma2-2b's training shape (S = 4096,
// D = 256) the five products are ~3.4e11 flops a layer against ~1e8 bytes,
// so operations bind.
//
// bf16 with D a multiple of 32 runs the products on the tensor cores
// (flash_bwd_tc_*): bf16 mma.sync m16n8k16 with f32 accumulation, tiles of
// 64 queries and 64 keys in shared memory (rows padded by 8 elements so
// that ldmatrix's eight rows fall on distinct banks), loaded by cp.async.
// The dq kernel's 4 warps own 16 query rows each: the logits and dP sit in
// registers as mma accumulators, a row's statistics reduce over the 4
// lanes of a quad, and dS feeds the dQ product as the A operand straight
// from registers (two accumulator tiles form one A fragment).  The dkdv
// kernel's 8 warps split the 64 x 64 logit tile 4 x 2 and the (64 x D)
// accumulators 4 x 2 (rows, halves of D); P and dS go through shared
// memory in bf16 and come back transposed by ldmatrix.trans as the A
// operand of dV = P^T dO and dK = dS^T Q.  P and dS are rounded to bf16
// before their products, as a bf16 flash backward does; everything else
// is f32.
//
// f32, and bf16 with another D, stay on the CUDA cores in f32 (bf16
// inputs widened as they are loaded): the tiles sit in shared memory as
// f32 rows padded by 4 floats (a quarter-warp's float4 reads of 8 rows hit
// distinct banks), each thread computes an R x R block of a logit tile
// (R = 4 at 64-row tiles, 2 at 32) and an R x 4C block of a (tile x D)
// accumulator.  At D = 256 the tiles are 32 rows (the four f32 tiles are
// 133 KB), at D <= 128 64 rows.  wgmma and TMA are later work.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kPad = 4;        // floats of padding per f32 tile row

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;   // contiguous (B, Hq, S, D)
  void* dk;   // contiguous (B, Hkv, Sk, D)
  void* dv;
  float* lse;  // (B * Hq * S) workspace: each row's log-sum-exp ...
  float* di;   // ... and rowsum(dO o)
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, g_sb, g_sh, g_ss;  // o and dO
  int hq, hkv, s, sk, d;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
};

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 lo = reinterpret_cast<const float4*>(src)[0];
  const float4 hi = reinterpret_cast<const float4*>(src)[1];
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float e) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, e);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                       float c, float e) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, e);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// Rows [0, valid) of a BT x d tile of T (row stride in elements) into
// shared memory as f32 rows of stride ld; rows past valid are zero.
template <typename T, int BT>
__device__ void load_tile(const T* src, long long row_stride, int valid,
                          int d, int ld, float* tile) {
  const int chunks = d / 8;
  for (int idx = threadIdx.x; idx < BT * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    float* dst = tile + r * ld + c;
    if (r < valid) {
      load8(src + r * row_stride + c, dst);
    } else {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(dst)[0] = z;
      reinterpret_cast<float4*>(dst)[1] = z;
    }
  }
}

// acc[i][j] = sum_k a[(ty + 16 i) * ld + k] * b[(tx + 16 j) * ld + k] over
// k < d: a block of a (BT x BT) tile A B^T, both operands row-major.
template <int R>
__device__ __forceinline__ void tile_abt(const float* a, const float* b,
                                         int ld, int d, float (&acc)[R][R]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < d; k += 4) {
    float4 av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * ld + k);
#pragma unroll
    for (int j = 0; j < R; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * ld + k);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][4c + e] += sum_m L(ty + 16 i, m) * x[m * ld + col + e] over m < BT,
// col = 4 tx + 64 c < d: a block of a (BT x d) product L X, where L is the
// (BT x BT) shared tile l (row stride lds) read as it is (kTrans false)
// or transposed.
template <int R, int C, int BT, bool kTrans>
__device__ __forceinline__ void tile_lx(const float* l, int lds,
                                        const float* x, int ld, int d,
                                        float (&acc)[R][4 * C]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int m = 0; m < BT; ++m) {
    float lv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      lv[i] = kTrans ? l[m * lds + ty + 16 * i] : l[(ty + 16 * i) * lds + m];
    const float* xrow = x + m * ld;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < d) {
        const float4 xv = *reinterpret_cast<const float4*>(xrow + col);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][4 * c + 0] = fmaf(lv[i], xv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(lv[i], xv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(lv[i], xv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(lv[i], xv.w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

// Rows ty + 16 i of a (BT x d) accumulator to dst (contiguous rows of d),
// rows at or past valid skipped.
template <typename T, int R, int C>
__device__ void store_rows(const float (&acc)[R][4 * C], T* dst, int valid,
                           int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r >= valid) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < d)
        store4(dst + static_cast<long long>(r) * d + col, acc[i][4 * c],
               acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
    }
  }
}

__device__ __forceinline__ bool kept(const Args& p, int qi, int kj) {
  bool ok = qi < p.s && kj < p.sk;
  if (p.causal) ok = ok && kj <= qi;
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// The logit of (qi, kj) from the dot product, and t = tanh(x / cap) (0
// without a softcap).
__device__ __forceinline__ float logit(const Args& p, float dot, float* t) {
  const float x = dot * p.scale;
  if (p.softcap > 0.f) {
    *t = tanhf(x / p.softcap);
    return p.softcap * *t;
  }
  *t = 0.f;
  return x;
}

// dS of one kept pair, with the softcap's chain and the scale.
__device__ __forceinline__ float dlogit(const Args& p, float prob, float dp,
                                        float di, float t) {
  float ds = prob * (dp - di);
  if (p.softcap > 0.f) ds *= 1.f - t * t;
  return ds * p.scale;
}

// The key tiles [*lo, *hi) that query rows q0 .. q0 + BT - 1 see.
template <int BT>
__device__ __forceinline__ void key_band(const Args& p, int q0, int* lo,
                                         int* hi) {
  const int n = (p.sk + BT - 1) / BT;
  *lo = 0;
  *hi = n;
  if (p.causal) *hi = min(n, (q0 + BT - 1) / BT + 1);
  if (p.window > 0 && q0 - p.window + 1 > 0) *lo = (q0 - p.window + 1) / BT;
}

// The query tiles [*lo, *hi) that see keys k0 .. k0 + BT - 1.
template <int BT>
__device__ __forceinline__ void query_band(const Args& p, int k0, int* lo,
                                           int* hi) {
  const int n = (p.s + BT - 1) / BT;
  *lo = p.causal ? min(n, k0 / BT) : 0;
  *hi = n;
  if (p.window > 0) {
    const long long last = static_cast<long long>(k0) + BT - 2 + p.window;
    *hi = static_cast<int>(min(static_cast<long long>(n), last / BT + 1));
  }
}

template <int BT, int DMAX>
struct Shape {
  static constexpr int R = BT / 16;     // logit-tile rows/cols a thread
  static constexpr int C = DMAX / 64;   // float4 column groups a thread
  static size_t dq_smem(int d) {
    return sizeof(float) * (4 * BT * (d + kPad) + BT * (BT + 1));
  }
  static size_t dkdv_smem(int d) {
    return sizeof(float) * (4 * BT * (d + kPad) + 2 * BT * (BT + 1) + 2 * BT);
  }
};

template <typename T, int BT, int DMAX>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(Args p) {
  using S = Shape<BT, DMAX>;
  constexpr int R = S::R, C = S::C;
  extern __shared__ __align__(16) float smem[];
  const int ld = p.d + kPad, lds = BT + 1;
  float* qs = smem;
  float* gs = qs + BT * ld;  // dO
  float* ks = gs + BT * ld;
  float* vs = ks + BT * ld;
  float* dss = vs + BT * ld;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh - b * p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = blockIdx.y * BT;
  const int valid = min(BT, p.s - q0);
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<T, BT>(static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                       q0 * p.q_ss,
                   p.q_ss, valid, p.d, ld, qs);
  load_tile<T, BT>(static_cast<const T*>(p.dout) + b * p.g_sb +
                       h * p.g_sh + q0 * p.g_ss,
                   p.g_ss, valid, p.d, ld, gs);
  // o goes through the K tile's buffer: D_i = rowsum(dO o).
  load_tile<T, BT>(static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh +
                       q0 * p.o_ss,
                   p.o_ss, valid, p.d, ld, ks);
  __syncthreads();
  float di[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float* gr = gs + (ty + 16 * i) * ld;
    const float* orow = ks + (ty + 16 * i) * ld;
    float acc = 0.f;
    for (int c = 4 * tx; c < p.d; c += 64) {
      const float4 gv = *reinterpret_cast<const float4*>(gr + c);
      const float4 ov = *reinterpret_cast<const float4*>(orow + c);
      acc = fmaf(gv.x, ov.x, acc);
      acc = fmaf(gv.y, ov.y, acc);
      acc = fmaf(gv.z, ov.z, acc);
      acc = fmaf(gv.w, ov.w, acc);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    di[i] = acc;
  }

  int t_lo, t_hi;
  key_band<BT>(p, q0, &t_lo, &t_hi);

  // Pass 1: each row's log-sum-exp over its kept keys.
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BT;
    __syncthreads();
    load_tile<T, BT>(kg + k0 * p.k_ss, p.k_ss, min(BT, p.sk - k0), p.d, ld,
                     ks);
    __syncthreads();
    float x[R][R];
    tile_abt<R>(qs, ks, ld, p.d, x);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float tc;
        const float s = logit(p, x[i][j], &tc);
        x[i][j] = kept(p, qi, k0 + tx + 16 * j) ? s : -INFINITY;
        tmax = fmaxf(tmax, x[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // Every lane of the warp reaches each shuffle: a row with nothing
      // kept yet (m_new = -inf) adds 0 and keeps l = 0.
      const float m_new = fmaxf(m[i], tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j)
        sum += x[i][j] == -INFINITY ? 0.f : expf(x[i][j] - m_new);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
    }
  }
  float lse[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    // A row with zero mass: every P is exp(s - inf) = 0.
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    const int r = ty + 16 * i;
    if (tx == 0 && r < valid) {
      const long long row = static_cast<long long>(bh) * p.s + q0 + r;
      p.lse[row] = lse[i];
      p.di[row] = di[i];
    }
  }

  // Pass 2: dQ = scale * dS K over the same key tiles.
  float acc[R][4 * C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4 * C; ++c) acc[i][c] = 0.f;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BT;
    const int kv = min(BT, p.sk - k0);
    __syncthreads();
    load_tile<T, BT>(kg + k0 * p.k_ss, p.k_ss, kv, p.d, ld, ks);
    load_tile<T, BT>(vg + k0 * p.v_ss, p.v_ss, kv, p.d, ld, vs);
    __syncthreads();
    float x[R][R], dp[R][R];
    tile_abt<R>(qs, ks, ld, p.d, x);
    tile_abt<R>(gs, vs, ld, p.d, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qi = q0 + ty + 16 * i, kj = k0 + tx + 16 * j;
        float tc;
        const float s = logit(p, x[i][j], &tc);
        const float prob = kept(p, qi, kj) ? expf(s - lse[i]) : 0.f;
        dss[(ty + 16 * i) * lds + tx + 16 * j] =
            dlogit(p, prob, dp[i][j], di[i], tc);
      }
    __syncthreads();
    tile_lx<R, C, BT, false>(dss, lds, ks, ld, p.d, acc);
  }
  T* dq = static_cast<T*>(p.dq) +
          (static_cast<long long>(bh) * p.s + q0) * p.d;
  store_rows<T, R, C>(acc, dq, valid, p.d);
}

template <typename T, int BT, int DMAX>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(Args p) {
  using S = Shape<BT, DMAX>;
  constexpr int R = S::R, C = S::C;
  extern __shared__ __align__(16) float smem[];
  const int ld = p.d + kPad, lds = BT + 1;
  float* ks = smem;
  float* vs = ks + BT * ld;
  float* qs = vs + BT * ld;
  float* gs = qs + BT * ld;  // dO
  float* ps = gs + BT * ld;
  float* dss = ps + BT * lds;
  float* lse_s = dss + BT * lds;
  float* di_s = lse_s + BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int bh = blockIdx.x;
  const int b = bh / p.hkv, hk = bh - b * p.hkv;
  const int group = p.hq / p.hkv;
  const int k0 = blockIdx.y * BT;
  const int kv = min(BT, p.sk - k0);
  load_tile<T, BT>(static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh +
                       k0 * p.k_ss,
                   p.k_ss, kv, p.d, ld, ks);
  load_tile<T, BT>(static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh +
                       k0 * p.v_ss,
                   p.v_ss, kv, p.d, ld, vs);

  float dk[R][4 * C], dv[R][4 * C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4 * C; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }
  int t_lo, t_hi;
  query_band<BT>(p, k0, &t_lo, &t_hi);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* gg = static_cast<const T*>(p.dout) + b * p.g_sb + h * p.g_sh;
    const long long stat0 = (static_cast<long long>(b) * p.hq + h) * p.s;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BT;
      const int qv = min(BT, p.s - q0);
      __syncthreads();
      load_tile<T, BT>(qg + q0 * p.q_ss, p.q_ss, qv, p.d, ld, qs);
      load_tile<T, BT>(gg + q0 * p.g_ss, p.g_ss, qv, p.d, ld, gs);
      for (int r = threadIdx.x; r < BT; r += kThreads) {
        lse_s[r] = r < qv ? p.lse[stat0 + q0 + r] : INFINITY;
        di_s[r] = r < qv ? p.di[stat0 + q0 + r] : 0.f;
      }
      __syncthreads();
      // Rows of the logit tile are queries, columns keys.
      float x[R][R], dp[R][R];
      tile_abt<R>(qs, ks, ld, p.d, x);
      tile_abt<R>(gs, vs, ld, p.d, dp);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          float tc;
          const float s = logit(p, x[i][j], &tc);
          const float prob =
              kept(p, q0 + r, k0 + c) ? expf(s - lse_s[r]) : 0.f;
          ps[r * lds + c] = prob;
          dss[r * lds + c] = dlogit(p, prob, dp[i][j], di_s[r], tc);
        }
      __syncthreads();
      tile_lx<R, C, BT, true>(ps, lds, gs, ld, p.d, dv);
      tile_lx<R, C, BT, true>(dss, lds, qs, ld, p.d, dk);
    }
  }
  const long long out0 = (static_cast<long long>(bh) * p.sk + k0) * p.d;
  store_rows<T, R, C>(dk, static_cast<T*>(p.dk) + out0, kv, p.d);
  store_rows<T, R, C>(dv, static_cast<T*>(p.dv) + out0, kv, p.d);
}

// ---------------------------------------------------------------------------
// bf16 with D % 32 == 0: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

constexpr int kTc = 64;        // query rows of a dq CTA, keys of a dkdv CTA
constexpr int kTcPad = 8;      // bf16 padding per shared row: a row stride of
                               // (d + 8) * 2 bytes puts ldmatrix's 8 rows on
                               // 8 distinct 16-byte bank groups
constexpr int kTcDqThreads = 128;    // 4 warps, 16 query rows each
constexpr int kTcDkdvThreads = 256;  // 8 warps

using bf16 = __nv_bfloat16;

// Rows [0, valid) of a kTc x d bf16 tile into shared memory (row stride ld
// elements) by cp.async, rows past valid zero; the caller commits and
// waits.
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* src,
                                        long long row_stride, int valid,
                                        int d, int ld) {
  const int chunks = d / 8;
  for (int idx = threadIdx.x; idx < kTc * chunks; idx += blockDim.x) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const bool in = r < valid;
    hopper::cp_async16(dst + r * ld + c, in ? src + r * row_stride + c : src,
                       in ? 16u : 0u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc = a block of A B^T (Q K^T, dO V^T): the 16 rows of A from a_row
// against 16 NP rows of B from b_row, both stored row-major with the
// contraction (k < d) along the row; acc[j] is the 16 x 8 tile of B rows
// b_row + 8 j .. + 7.
template <int NP>
__device__ __forceinline__ void tc_abt(const bf16* a, int a_row,
                                       const bf16* b, int b_row, int ld,
                                       int d, float (&acc)[2 * NP][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < d; kk += 16) {
    uint32_t af[4];
    hopper::ldmatrix_x4(af, hopper::smem_u32(
        a + (a_row + (lane & 15)) * ld + kk + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t bf[4];
      hopper::ldmatrix_x4(bf, hopper::smem_u32(
          b + (b_row + np * 16 + (lane >> 4) * 8 + (lane & 7)) * ld + kk +
          ((lane >> 3) & 1) * 8));
      hopper::mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
      hopper::mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// The B fragments of n-tiles 2 nb, 2 nb + 1 at contraction rows k0 .. k0 +
// 15 of a tile stored [k][n] (row stride ld), starting at column n0.
__device__ __forceinline__ void tc_b_kn(const bf16* b, int k0, int n0,
                                        int ld, uint32_t (&bf)[4]) {
  const int lane = threadIdx.x & 31;
  hopper::ldmatrix_x4_trans(bf, hopper::smem_u32(
      b + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 +
      (lane >> 4) * 8));
}

// Shared memory of the dq kernel (Q, dO, K, V tiles) and of the dkdv
// kernel (those, P and dS, and the rows' statistics), in bytes.
size_t tc_dq_smem(int d) { return 2 * 4 * kTc * (d + kTcPad); }
size_t tc_dkdv_smem(int d) {
  return 2 * (4 * kTc * (d + kTcPad) + 2 * kTc * (kTc + kTcPad)) +
         4 * 2 * kTc;
}

template <int DMAX>
__global__ void __launch_bounds__(kTcDqThreads, 1)
    flash_bwd_tc_dq_kernel(Args p) {
  constexpr int NT = DMAX / 8;  // dq n-tiles of a warp's 16 rows
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const int ld = p.d + kTcPad;
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* gs = qs + kTc * ld;  // dO
  bf16* ks = gs + kTc * ld;
  bf16* vs = ks + kTc * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh - b * p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = blockIdx.y * kTc;
  const int valid = min(kTc, p.s - q0);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  tc_load(qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh +
                  q0 * p.q_ss, p.q_ss, valid, p.d, ld);
  tc_load(gs, static_cast<const bf16*>(p.dout) + b * p.g_sb + h * p.g_sh +
                  q0 * p.g_ss, p.g_ss, valid, p.d, ld);
  hopper::cp_async_commit();
  hopper::cp_async_wait_group<0>();
  __syncthreads();

  // This thread's rows: r[0] = 16 warp + g, r[1] = r[0] + 8.
  const int r0 = warp * 16 + g;
  float di[2];
  const bf16* og = static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh +
                   q0 * p.o_ss;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float acc = 0.f;
    if (r < valid)
      for (int c = t; c < p.d; c += 4)
        acc = fmaf(__bfloat162float(gs[r * ld + c]),
                   __bfloat162float(og[r * p.o_ss + c]), acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    di[i] = acc;
  }

  int t_lo, t_hi;
  key_band<kTc>(p, q0, &t_lo, &t_hi);

  // Pass 1: each row's log-sum-exp over its kept keys.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kTc;
    __syncthreads();
    tc_load(ks, kg + k0 * p.k_ss, p.k_ss, min(kTc, p.sk - k0), p.d, ld);
    hopper::cp_async_commit();
    hopper::cp_async_wait_group<0>();
    __syncthreads();
    float x[8][4];
    tc_abt<4>(qs, warp * 16, ks, 0, ld, p.d, x);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r0 + 8 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float tc;
          const float s = logit(p, x[j][2 * i + e], &tc);
          x[j][2 * i + e] =
              kept(p, qi, k0 + j * 8 + 2 * t + e) ? s : -INFINITY;
          tmax = fmaxf(tmax, x[j][2 * i + e]);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[i], tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = x[j][2 * i + e];
          sum += s == -INFINITY ? 0.f : expf(s - m_new);
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
    }
  }
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    const int r = r0 + 8 * i;
    if (t == 0 && r < valid) {
      const long long row = static_cast<long long>(bh) * p.s + q0 + r;
      p.lse[row] = lse[i];
      p.di[row] = di[i];
    }
  }

  // Pass 2: dQ = dS K, dS from registers as the A operand.
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kTc;
    const int kv = min(kTc, p.sk - k0);
    __syncthreads();
    tc_load(ks, kg + k0 * p.k_ss, p.k_ss, kv, p.d, ld);
    tc_load(vs, vg + k0 * p.v_ss, p.v_ss, kv, p.d, ld);
    hopper::cp_async_commit();
    hopper::cp_async_wait_group<0>();
    __syncthreads();
    float x[8][4], dp[8][4];
    tc_abt<4>(qs, warp * 16, ks, 0, ld, p.d, x);
    tc_abt<4>(gs, warp * 16, vs, 0, ld, p.d, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float tc;
        const float s = logit(p, x[j][e], &tc);
        const float prob =
            kept(p, q0 + r0 + 8 * i, k0 + j * 8 + 2 * t + (e & 1))
                ? expf(s - lse[i])
                : 0.f;
        x[j][e] = dlogit(p, prob, dp[j][e], di[i], tc);
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
      const uint32_t af[4] = {pack2(x[2 * kk][0], x[2 * kk][1]),
                              pack2(x[2 * kk][2], x[2 * kk][3]),
                              pack2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                              pack2(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
      for (int nb = 0; nb < NT / 2; ++nb) {
        if (nb * 16 < p.d) {
          uint32_t bf[4];
          tc_b_kn(ks, kk * 16, nb * 16, ld, bf);
          hopper::mma_bf16_16816(acc[2 * nb], af, bf[0], bf[1]);
          hopper::mma_bf16_16816(acc[2 * nb + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  bf16* dq = static_cast<bf16*>(p.dq) +
             (static_cast<long long>(bh) * p.s + q0) * p.d;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * t;
    if (c < p.d) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        if (r < valid)
          *reinterpret_cast<uint32_t*>(dq + static_cast<long long>(r) * p.d +
                                       c) =
              pack2(acc[j][2 * i], acc[j][2 * i + 1]);
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kTcDkdvThreads, 1)
    flash_bwd_tc_dkdv_kernel(Args p) {
  constexpr int NT = DMAX / 16;  // dk/dv n-tiles of a warp (half of D)
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const int ld = p.d + kTcPad, ldp = kTc + kTcPad;
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = ks + kTc * ld;
  bf16* qs = vs + kTc * ld;
  bf16* gs = qs + kTc * ld;  // dO
  bf16* ps = gs + kTc * ld;
  bf16* dss = ps + kTc * ldp;
  float* lse_s = reinterpret_cast<float*>(dss + kTc * ldp);
  float* di_s = lse_s + kTc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // Logit tiles: query rows 16 (warp % 4) .., keys 32 (warp / 4) ..; the
  // dk/dv tiles: keys 16 (warp % 4) .., columns half (warp / 4) of D.
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;
  const int half = p.d / 2, c0 = (warp >> 2) * half;
  const int bh = blockIdx.x;
  const int b = bh / p.hkv, hk = bh - b * p.hkv;
  const int group = p.hq / p.hkv;
  const int k0 = blockIdx.y * kTc;
  const int kv = min(kTc, p.sk - k0);
  tc_load(ks, static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh +
                  k0 * p.k_ss, p.k_ss, kv, p.d, ld);
  tc_load(vs, static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh +
                  k0 * p.v_ss, p.v_ss, kv, p.d, ld);
  hopper::cp_async_commit();

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.f;
      dv[j][e] = 0.f;
    }
  int t_lo, t_hi;
  query_band<kTc>(p, k0, &t_lo, &t_hi);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* gg = static_cast<const bf16*>(p.dout) + b * p.g_sb +
                     h * p.g_sh;
    const long long stat0 = (static_cast<long long>(b) * p.hq + h) * p.s;
    for (int qt = t_lo; qt < t_hi; ++qt) {
      const int q0 = qt * kTc;
      const int qv = min(kTc, p.s - q0);
      __syncthreads();
      tc_load(qs, qg + q0 * p.q_ss, p.q_ss, qv, p.d, ld);
      tc_load(gs, gg + q0 * p.g_ss, p.g_ss, qv, p.d, ld);
      hopper::cp_async_commit();
      for (int r = threadIdx.x; r < kTc; r += kTcDkdvThreads) {
        lse_s[r] = r < qv ? p.lse[stat0 + q0 + r] : INFINITY;
        di_s[r] = r < qv ? p.di[stat0 + q0 + r] : 0.f;
      }
      hopper::cp_async_wait_group<0>();
      __syncthreads();
      float x[4][4], dp[4][4];
      tc_abt<2>(qs, wr, ks, wc, ld, p.d, x);
      tc_abt<2>(gs, wr, vs, wc, ld, p.d, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wr + g + 8 * i, c = wc + j * 8 + 2 * t;
          float pr[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float tc;
            const float s = logit(p, x[j][2 * i + e], &tc);
            pr[e] = kept(p, q0 + r, k0 + c + e) ? expf(s - lse_s[r]) : 0.f;
            ds[e] = dlogit(p, pr[e], dp[j][2 * i + e], di_s[r], tc);
          }
          *reinterpret_cast<uint32_t*>(ps + r * ldp + c) = pack2(pr[0], pr[1]);
          *reinterpret_cast<uint32_t*>(dss + r * ldp + c) =
              pack2(ds[0], ds[1]);
        }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's 64 queries.
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        uint32_t ap[4], ad[4];
        const int rowq = kq * 16 + ((lane >> 4) * 8) + (lane & 7);
        const int colk = wr + ((lane >> 3) & 1) * 8;
        hopper::ldmatrix_x4_trans(ap, hopper::smem_u32(ps + rowq * ldp + colk));
        hopper::ldmatrix_x4_trans(ad,
                                  hopper::smem_u32(dss + rowq * ldp + colk));
#pragma unroll
        for (int nb = 0; nb < NT / 2; ++nb) {
          if (nb * 16 < half) {
            uint32_t bf[4];
            tc_b_kn(gs, kq * 16, c0 + nb * 16, ld, bf);
            hopper::mma_bf16_16816(dv[2 * nb], ap, bf[0], bf[1]);
            hopper::mma_bf16_16816(dv[2 * nb + 1], ap, bf[2], bf[3]);
            tc_b_kn(qs, kq * 16, c0 + nb * 16, ld, bf);
            hopper::mma_bf16_16816(dk[2 * nb], ad, bf[0], bf[1]);
            hopper::mma_bf16_16816(dk[2 * nb + 1], ad, bf[2], bf[3]);
          }
        }
      }
    }
  }
  hopper::cp_async_wait_group<0>();  // K/V, if no query tile saw them
  const long long out0 = (static_cast<long long>(bh) * p.sk + k0) * p.d;
  bf16* dkg = static_cast<bf16*>(p.dk) + out0;
  bf16* dvg = static_cast<bf16*>(p.dv) + out0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = c0 + j * 8 + 2 * t;
    if (j * 8 < half) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wr + g + 8 * i;
        if (r < kv) {
          const long long o = static_cast<long long>(r) * p.d + c;
          *reinterpret_cast<uint32_t*>(dkg + o) =
              pack2(dk[j][2 * i], dk[j][2 * i + 1]);
          *reinterpret_cast<uint32_t*>(dvg + o) =
              pack2(dv[j][2 * i], dv[j][2 * i + 1]);
        }
      }
    }
  }
}

template <int DMAX>
int launch_tc(const Args& a, int batch, cudaStream_t stream) {
  static bool raised = false;  // the >48 KB opt-in, once per instantiation
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_tc_dq_kernel<DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tc_dq_smem(DMAX)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_tc_dkdv_kernel<DMAX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(tc_dkdv_smem(DMAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid_q(batch * a.hq, (a.s + kTc - 1) / kTc);
  flash_bwd_tc_dq_kernel<DMAX>
      <<<grid_q, kTcDqThreads, tc_dq_smem(a.d), stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k(batch * a.hkv, (a.sk + kTc - 1) / kTc);
  flash_bwd_tc_dkdv_kernel<DMAX>
      <<<grid_k, kTcDkdvThreads, tc_dkdv_smem(a.d), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BT, int DMAX>
int launch(const Args& a, int batch, cudaStream_t stream) {
  using S = Shape<BT, DMAX>;
  static bool raised = false;  // the >48 KB opt-in, once per instantiation
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, BT, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::dq_smem(DMAX)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, BT, DMAX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(S::dkdv_smem(DMAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid_q(batch * a.hq, (a.s + BT - 1) / BT);
  flash_bwd_dq_kernel<T, BT, DMAX>
      <<<grid_q, kThreads, S::dq_smem(a.d), stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k(batch * a.hkv, (a.sk + BT - 1) / BT);
  flash_bwd_dkdv_kernel<T, BT, DMAX>
      <<<grid_k, kThreads, S::dkdv_smem(a.d), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64, 64>(a, batch, stream);
  if (a.d <= 128) return launch<T, 64, 128>(a, batch, stream);
  return launch<T, 32, 256>(a, batch, stream);
}

int dispatch_bf16(const Args& a, int batch, cudaStream_t stream) {
  if (a.d % 32 != 0) return dispatch_d<__nv_bfloat16>(a, batch, stream);
  if (a.d <= 64) return launch_tc<64>(a, batch, stream);
  if (a.d <= 128) return launch_tc<128>(a, batch, stream);
  return launch_tc<256>(a, batch, stream);
}

}  // namespace

// q, k, v, o and dO in f32 (is_bf16 = 0) or bf16 (1), strides in elements
// with the last dimension contiguous; dq, dk and dv contiguous in the same
// dtype; ws holds 2 * B * Hq * S floats.  The query rows sit at key
// positions 0 .. S - 1 (no offset).  Refuses D > 256, D % 8 != 0,
// Hq % Hkv != 0 and grids past the hardware limits with
// cudaErrorInvalidValue; otherwise returns cudaGetLastError() after the
// two launches.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* ws, int is_bf16,
    int batch, int hq, int hkv, int s, int sk, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, long long g_sb,
    long long g_sh, long long g_ss, float scale, int causal, int window,
    float softcap, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1 || sk < 1 ||
      d < 8 || d > 256 || d % 8 != 0 ||
      static_cast<long long>(batch) * hq > 65535 || s > 65535 * 32 ||
      sk > 65535 * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * hq * s;
  const Args args{q,    k,    v,    o,    dout, dq,   dk,   dv,
                  ws,   ws + rows,
                  q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                  o_sb, o_sh, o_ss, g_sb, g_sh, g_ss,
                  hq,   hkv,  s,    sk,   d,
                  scale, softcap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_bf16(args, batch, st);
  return dispatch_d<float>(args, batch, st);
}
