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
// What bounds it on this card: at gemma2-2b's training shape (S = 4096,
// D = 256) the five products a backward needs (S again, dP, dV, dQ, dK)
// are ~3.4e11 flops a layer against ~1e8 bytes, so operations bind, and
// the bf16 rate lives in wgmma.  Past the products, the per-element work
// (the exponent, the cap's tanh, the masks) competes with them for the
// warpgroup's issue slots.
//
// bf16 with D a multiple of 32 (the tensor cores) takes P from the
// forward's row statistics (lse, natural-log units: flash_attention.cu
// writes it where training asks) and makes two or three launches, no
// atomics, so the result is the same on every run:
//
// * flash_bwd_wg_dq_kernel, one CTA per (batch * query head, 64 query
//   rows), the last query tiles first.  A producer thread loads Q and dO
//   once and streams K and V of the mask's band of 64-key tiles through a
//   2-stage TMA ring (full and empty mbarriers), reading the forward's
//   4-D strided tensor maps, so head-transposed views need no copy.  One
//   consumer warpgroup first writes D_i = rowsum(dO o) for the dkdv
//   launch, then per key tile: S = Q K^T by wgmma into registers, P =
//   exp2(x log2 e - lse log2 e) times the cap's 1 - t^2 in place, dP = dO
//   V^T, dS = P (dP - D_i) rounded to bf16 as the register A operand of
//   dQ += dS K (K read N-major by the transpose bit).  The scale is
//   applied once, to dQ.  At D = 256 (one CTA fills an SM's shared
//   memory: Q, dO and two K/V stages, 193 KB) the CTA is 384 threads,
//   the consumer at 240 registers (dQ's 128 f32 accumulators, S's and
//   dP's 64); at D <= 128 two CTAs of 256 share an SM, the consumer at
//   216.  The consumer's setmaxnreg is also what lets ptxas pipeline its
//   wgmma: without one it placed them in a divergent path and serialized
//   every instruction.
// * flash_bwd_wg_dkdv_kernel, one CTA per (batch * KV head * query-head
//   split, key tile), the first key tiles first.  The producer loads K
//   and V once and streams Q, dO and the 64 queries' lse and D_i of the
//   split's query heads over the keys' band through a TMA ring.  With
//   keys as wgmma's M rows, S^T = K Q^T lands in registers, P^T becomes
//   the A operand of dV += P^T dO beside the product dP^T = V dO^T, and
//   dS^T the A operand of dK += dS^T Q: no P or dS passes through shared
//   memory.  P is formed before dP^T's accumulators are live, so that
//   the cap's arithmetic never overlaps them.  The register budget: dK
//   and dV of 64 keys at D = 256 are 256 f32 registers a thread, past
//   setmaxnreg's 240, so at D = 256 the two consumer warpgroups share 64
//   keys, warpgroup 0 making dV (128 accumulators, 224 registers) and
//   warpgroup 1 dK (128 + S^T's and dP^T's 64, 256 registers), each
//   computing S^T itself: 8 products executed for the 5 counted.  At
//   D <= 128 each warpgroup owns 64 keys (128 a CTA) and makes both (64 +
//   64 accumulators, 240 registers): 7 products for 5.  The ring has 2
//   stages at D = 256 (194 KB of shared memory), 3 below.
// * Where B * Hkv * ceil(Sk / keys) CTAs fill fewer than about two waves
//   of the card (MQA: recurrentgemma-2b's one KV head gives 32), the
//   wrapper splits each KV head's group of query heads over CTAs
//   (flash_attention_bwd.py::dkdv_splits); each split writes f32 dK and
//   dV to a workspace and flash_bwd_sum_kernel adds the splits in split
//   order and rounds once to bf16.
//
// Masks apply only on the tiles the band's edges cross (the diagonal,
// the window's edge, the Sk and S edges).  TMA reads past an edge as
// zeros; a tile's statistics come as a box from the 16-byte boundary at
// or before its first row of the flat (B * Hq * S) arrays (TMA faults on
// a box that starts elsewhere), rows past S masked.  The cap is the
// forward's arithmetic, cap tanhf(x / cap) with x = dot scale.  P and dS
// are rounded to bf16 before their products, as a bf16 flash backward
// does; everything else is f32.
//
// f32, and bf16 with another D, stay on the CUDA cores in f32 and two
// launches (bf16 inputs widened as they are loaded):
//
// * flash_bwd_dq_kernel, one CTA per (batch * query head, query tile):
//   first D_i = rowsum(dO o) and, over the key tiles of the mask's band,
//   the row's log-sum-exp, both to a workspace.  Then a second walk over
//   the same key tiles recomputes P = exp(s - lse), dP = dO V^T and dS,
//   and accumulates dQ = scale * dS K in registers.
// * flash_bwd_dkdv_kernel, one CTA per (batch * KV head, key tile): it
//   walks the query heads of its group and, for each, the query tiles of
//   the band, recomputes P and dS from the workspace's statistics, and
//   accumulates dV = P^T dO and dK = scale * dS^T Q in registers.
//
// Their tiles sit in shared memory as f32 rows padded by 4 floats (a
// quarter-warp's float4 reads of 8 rows hit distinct banks), each thread
// computes an R x R block of a logit tile (R = 4 at 64-row tiles, 2 at
// 32) and an R x 4C block of a (tile x D) accumulator.  At D = 256 the
// tiles are 32 rows (the four f32 tiles are 133 KB), at D <= 128 64 rows.

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
// bf16 with D % 32 == 0: tensor cores (wgmma fed by TMA rings)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBT = 64;                 // rows of every tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDqRing = 2;
constexpr int kKvThreads = 384;         // 2 consumer warpgroups, a producer one

struct TcArgs {
  const void* o;
  void* dq;             // contiguous (B, Hq, S, D)
  void* dk;             // contiguous (B, Hkv, Sk, D)
  void* dv;
  float* part;          // nsplit > 1: [nsplit][dK, dV][B * Hkv * Sk * D]
  const float* lse;     // (B * Hq * S): the forward's statistics
  float* di;            // (B * Hq * S): rowsum(dO o), the dq kernel's
  long long o_sb, o_sh, o_ss;
  int hq, hkv, s, sk, d;
  float scale, softcap;  // softcap <= 0: none
  float c1, c2;          // logit2's factors for the scale and the cap
  int causal, window;    // window <= 0: none
  int nsplit;            // query-head splits of a KV head's group
};

// A 64 x DMAX bf16 tile in shared memory: DMAX / 64 column blocks of 64 rows
// of 128 bytes, 128-byte swizzled (hopper.cuh's layout).
template <int DMAX>
struct Tile {
  static constexpr int kBlocks = DMAX / 64;
  static constexpr int kBytes = kBlocks * kBT * 128;
};

// The k-th 16-column slice of a K-major 64-row tile at shared address a:
// the descriptor of an SS product's operand.
__device__ __forceinline__ uint64_t kmajor(uint32_t a, int kd) {
  return hopper::desc_sw128(a + (kd >> 2) * kBT * 128 + 32 * (kd & 3), 16,
                            1024);
}

// Rows 16 kk .. 16 kk + 15 of a 64-row tile read N-major (the transpose
// bit): the B operand of an RS product over the tile's rows.
__device__ __forceinline__ uint64_t nmajor(uint32_t a, int kk) {
  return hopper::desc_sw128(a + kk * 16 * 128, kBT * 128, 1024);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
}

// acc += A B^T over the full head dim (S, S^T, dP, dP^T), both operands
// 64-row K-major tiles.
template <int DMAX>
__device__ __forceinline__ void product_abt(float (&acc)[32], uint32_t a,
                                            uint32_t b) {
#pragma unroll
  for (int kd = 0; kd < DMAX / 16; ++kd)
    hopper::WgmmaBf16SS<64, 0>::run(acc, kmajor(a, kd), kmajor(b, kd));
}

// The logit's part of the exp2 form's argument, x log2(e), of a product
// entry, and the cap's chain factor 1 - t^2.  Without a cap x = dot scale
// (c1 = scale log2(e)); with one x = cap tanhf(dot scale / cap), as the
// forward computes it (c1 = scale, c2 = cap log2(e)).
template <bool kCap>
__device__ __forceinline__ float logit2(float dot, float c1, float c2,
                                        float cap, float* chain) {
  if constexpr (kCap) {
    const float t = tanhf(dot * c1 / cap);
    *chain = 1.f - t * t;
    return t * c2;
  }
  *chain = 1.f;
  return dot * c1;
}


__device__ __forceinline__ bool kept(const TcArgs& p, int qi, int kj) {
  bool ok = qi < p.s && kj < p.sk;
  if (p.causal) ok = ok && kj <= qi;
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// Whether the 64 x 64 block of queries q0.. and keys k0.. holds a pair the
// mask drops: the Sk and S edges, the causal diagonal, the window's edge.
__device__ __forceinline__ bool edge_tile(const TcArgs& p, int q0, int k0) {
  return k0 + kBT > p.sk || q0 + kBT > p.s ||
         (p.causal && k0 + kBT - 1 > q0) ||
         (p.window > 0 && k0 <= q0 + kBT - 1 - p.window);
}

// The 64-key tiles [*lo, *hi) that query rows q0 .. q0 + 63 see.
__device__ __forceinline__ void tc_key_band(const TcArgs& p, int q0, int* lo,
                                            int* hi) {
  const int n = (p.sk + kBT - 1) / kBT;
  *lo = 0;
  *hi = n;
  if (p.causal) *hi = min(n, (q0 + kBT - 1) / kBT + 1);
  if (p.window > 0 && q0 - p.window + 1 > 0) *lo = (q0 - p.window + 1) / kBT;
}

// The 64-query tiles [*lo, *hi) that see keys k0 .. k0 + 63.
__device__ __forceinline__ void tc_query_band(const TcArgs& p, int k0,
                                              int* lo, int* hi) {
  const int n = (p.s + kBT - 1) / kBT;
  *lo = p.causal ? min(n, k0 / kBT) : 0;
  *hi = n;
  if (p.window > 0) {
    const long long last = static_cast<long long>(k0) + kBT - 2 + p.window;
    *hi = static_cast<int>(min(static_cast<long long>(n), last / kBT + 1));
  }
}

// P (1 - t^2) of a dq tile in place of S; masks only where `edge`.  Rows
// r0, r0 + 8 of the tile (log-sum-exp lse2[0], lse2[1] in the exp2
// domain), columns 8 j + cq (+ 1).
template <bool kCap>
__device__ __forceinline__ void dq_probs(const TcArgs& p, float (&sc)[32],
                                         const float (&lse2)[2], bool edge,
                                         int q0, int k0, int r0, int cq) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int hh = (e >> 1) & 1;
    float chain;
    const float x2 = logit2<kCap>(sc[e], p.c1, p.c2, p.softcap, &chain);
    float pr = exp2f(x2 - lse2[hh]);
    if (edge && !kept(p, q0 + r0 + 8 * hh, k0 + 8 * (e >> 2) + cq + (e & 1)))
      pr = 0.f;
    sc[e] = pr * chain;
  }
}

// dS = P (1 - t^2) (dP - D_i) of a dq tile, rounded to bf16 in the A
// fragments of the dQ product.  The accumulator's layout is
// mma.m16n8k16's A fragment layout: keys 16 kk .. 16 kk + 15 form
// fragment kk.
__device__ __forceinline__ void dq_dscores(const float (&pc)[32],
                                           const float (&dp)[32],
                                           const float (&di)[2],
                                           uint32_t (&da)[4][4]) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const float d = di[(e >> 1) & 1];
    da[e >> 3][(e >> 1) & 3] =
        pack2(pc[e] * (dp[e] - d), pc[e + 1] * (dp[e + 1] - d));
  }
}

// The dq kernel's threads: a consumer warpgroup and the producer's (one
// more that only gives up its registers at D = 256, where 384 threads
// start at 168 registers and one CTA fills an SM's shared memory; two
// CTAs of 256 at D <= 128 start at 128).  The consumer's setmaxnreg is
// what lets ptxas pipeline its wgmma: without one, it found the wgmma in
// a divergent path and serialized each instruction.
template <int DMAX>
struct DqShape {
  static constexpr int kThreads = DMAX == 256 ? 384 : 256;
  static constexpr int kMinBlocks = DMAX == 256 ? 1 : 2;
  static constexpr int kConsumerRegs = DMAX == 256 ? 240 : 216;
  static constexpr int kProducerRegs = DMAX == 256 ? 24 : 40;
};

// dq: one CTA per (batch * query head, 64 query rows), the last query tiles
// (the most keys under a causal mask) launched first.  Warp 4 issues every
// TMA load: Q and dO once, then K and V of the band's key tiles through a
// kDqRing-stage ring.  Warpgroup 0 first writes D_i = rowsum(dO o), then
// per key tile computes S = Q K^T and dP = dO V^T into registers, forms
// dS = P (dP - D_i) (1 - t^2) with P = exp2(x log2 e - lse log2 e), and
// accumulates dQ += dS K with dS rounded to bf16 as the register A operand.
template <int DMAX>
__global__ void __launch_bounds__(DqShape<DMAX>::kThreads,
                                  DqShape<DMAX>::kMinBlocks)
flash_bwd_wg_dq_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tg,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const TcArgs p) {
  constexpr int kTile = Tile<DMAX>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align_1024(smem_raw);
  uint8_t* gs = qs + kTile;                   // dO
  uint8_t* ks = gs + kTile;                   // kDqRing tiles
  uint8_t* vs = ks + kDqRing * kTile;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + kDqRing * kTile);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kDqRing;

  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh - b * p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBT;
  int t_lo, t_hi;
  tc_key_band(p, q0, &t_lo, &t_hi);

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < kDqRing; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x / 128 != 0) {
    hopper::setmaxnreg_dec<DqShape<DMAX>::kProducerRegs>();
    if (threadIdx.x != 128) return;
    hopper::mbar_arrive_expect_tx(qbar, 2 * kTile);
    for (int j = 0; j < Tile<DMAX>::kBlocks; ++j) {
      hopper::tma_load_4d(qs + j * kBT * 128, &tq, qbar, 64 * j, q0, h, b);
      hopper::tma_load_4d(gs + j * kBT * 128, &tg, qbar, 64 * j, q0, h, b);
    }
    for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
      const int s = i % kDqRing;
      hopper::mbar_wait(&empty[s], ((i / kDqRing) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&full[s], 2 * kTile);
      for (int j = 0; j < Tile<DMAX>::kBlocks; ++j) {
        hopper::tma_load_4d(ks + s * kTile + j * kBT * 128, &tk, &full[s],
                            64 * j, t * kBT, hk, b);
        hopper::tma_load_4d(vs + s * kTile + j * kBT * 128, &tv, &full[s],
                            64 * j, t * kBT, hk, b);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<DqShape<DMAX>::kConsumerRegs>();
  // This thread holds tile rows r0 and r0 + 8, columns 8 j + cq (+ 1).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const long long stat0 = static_cast<long long>(bh) * p.s + q0;
  float lse2[2], di[2];
  hopper::mbar_wait(qbar, 0);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // Rows past S read the last row (no branch, so that the warps stay
    // converged for the wgmma that follows) and carry no probability.
    const int r = r0 + 8 * hh;
    const bool in = q0 + r < p.s;
    const int row = min(q0 + r, p.s - 1);
    // In the exp2 domain once a row.
    lse2[hh] = in ? p.lse[static_cast<long long>(bh) * p.s + row] * kLog2e
                  : INFINITY;
    // D_i over this thread's 16-byte chunks of the row, then the quad's.
    const bf16* orow = static_cast<const bf16*>(p.o) + b * p.o_sb +
                       h * p.o_sh + static_cast<long long>(row) * p.o_ss;
    float acc = 0.f;
    for (int c = 8 * (lane & 3); c < p.d; c += 32) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(
          gs + (c >> 6) * kBT * 128 + hopper::sw128_offset(r, (c & 63) >> 3));
      const bf16* oe = reinterpret_cast<const bf16*>(&ov);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc = fmaf(__bfloat162float(ge[e]), __bfloat162float(oe[e]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    di[hh] = in ? acc : 0.f;
    if (in && (lane & 3) == 0) p.di[stat0 + r] = acc;
  }

  float acc[DMAX / 2];
#pragma unroll
  for (int e = 0; e < DMAX / 2; ++e) acc[e] = 0.f;
  const uint32_t qa = hopper::smem_u32(qs), ga = hopper::smem_u32(gs);
  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int s = i % kDqRing;
    const int k0 = t * kBT;
    hopper::mbar_wait(&full[s], (i / kDqRing) & 1);
    const uint32_t ka = hopper::smem_u32(ks + s * kTile);
    const uint32_t va = hopper::smem_u32(vs + s * kTile);
    // S, then P, then dP: the probabilities' arithmetic runs while dP's
    // accumulators are not yet live.
    float sc[32], dp[32];
    zero(sc);
    hopper::wgmma_fence();
    product_abt<DMAX>(sc, qa, ka);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    const bool edge = edge_tile(p, q0, k0);
    if (p.softcap > 0.f)
      dq_probs<true>(p, sc, lse2, edge, q0, k0, r0, cq);
    else
      dq_probs<false>(p, sc, lse2, edge, q0, k0, r0, cq);
    zero(dp);
    hopper::wgmma_fence();
    product_abt<DMAX>(dp, ga, va);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    uint32_t da[4][4];
    dq_dscores(sc, dp, di, da);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaBf16RS<DMAX, 1>::run(acc, da[kk], nmajor(ka, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(da[kk]);
    if (threadIdx.x == 0) hopper::mbar_arrive(&empty[s]);
  }

  bf16* dq = static_cast<bf16*>(p.dq) + stat0 * p.d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (q0 + r >= p.s) continue;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < p.d)
        *reinterpret_cast<uint32_t*>(dq + static_cast<long long>(r) * p.d +
                                     col) =
            pack2(acc[4 * j + 2 * hh] * p.scale,
                  acc[4 * j + 2 * hh + 1] * p.scale);
    }
  }
}

// The dkdv kernel's shared memory: K and V of the CTA's keys, the ring's
// stages of Q and dO (1024-byte aligned, as the swizzle wants), each
// stage's lse and D_i values, then barriers.  A TMA copy starts on a
// 16-byte boundary of the flat (B * Hq * S) statistics, so a query tile's
// 64 values come in a box of kStatBox from the boundary at or before the
// tile's first row (its offset from there is (b * Hq + h) * S mod 4).
template <int DMAX>
struct KvShape {
  static constexpr bool kPair = DMAX == 256;  // both warpgroups on 64 keys
  static constexpr int kKeys = kPair ? 64 : 128;
  static constexpr int kRing = kPair ? 2 : 3;
  static constexpr int kTile = Tile<DMAX>::kBytes;
  static constexpr int kKV = (kKeys / kBT) * kTile;        // K or V
  static constexpr int kStatBox = kBT + 4;                 // floats
  static constexpr int kStatLd = 96;         // floats between 128-B slots
  static constexpr int kStage = 2 * kTile + 2 * kStatBox * 4;  // TMA bytes
  static constexpr size_t smem_bytes() {
    return 1024 + 2 * static_cast<size_t>(kKV) +
           kRing * (2 * static_cast<size_t>(kTile) + 2 * kStatLd * 4) +
           (1 + 2 * kRing) * sizeof(uint64_t);
  }
};

// One warpgroup's dK (which = 0, times the scale) or dV (1) of keys kw ..:
// bf16 into the output where there is one split, else f32 into the split's
// part.
template <int DMAX>
__device__ __forceinline__ void store_kv(const TcArgs& p,
                                         const float (&acc)[DMAX / 2],
                                         int which, float mul, int kw,
                                         int bhk, int split) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const long long n =
      static_cast<long long>(gridDim.x / p.nsplit) * p.sk * p.d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kw + r0 + 8 * hh;
    if (key >= p.sk) continue;
    const long long row = (static_cast<long long>(bhk) * p.sk + key) * p.d;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= p.d) continue;
      const float a0 = acc[4 * j + 2 * hh] * mul;
      const float a1 = acc[4 * j + 2 * hh + 1] * mul;
      if (p.nsplit == 1) {
        bf16* out = static_cast<bf16*>(which == 0 ? p.dk : p.dv);
        *reinterpret_cast<uint32_t*>(out + row + col) = pack2(a0, a1);
      } else {
        float* out = p.part + (2LL * split + which) * n;
        *reinterpret_cast<float2*>(out + row + col) = make_float2(a0, a1);
      }
    }
  }
}

// P^T of a dkdv tile from S^T, rounded to bf16 in the A fragments of the
// dV product; sc becomes P^T (1 - t^2), f32, for dS^T.  Masks only where
// `edge`.  Key rows r0, r0 + 8 of the tile, query columns 8 j + cq (+ 1),
// whose log-sum-exp is lse[c].
template <bool kCap>
__device__ __forceinline__ void kv_probs(const TcArgs& p, float (&sc)[32],
                                         const float* lse, bool edge, int q0,
                                         int kw, int r0, int cq,
                                         uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int hh = (e >> 1) & 1;
    const int c = 8 * (e >> 2) + cq;
    float pr[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float chain;
      const float x2 =
          logit2<kCap>(sc[e + u], p.c1, p.c2, p.softcap, &chain);
      pr[u] = exp2f(x2 - lse[c + u] * kLog2e);
      if (edge && !kept(p, q0 + c + u, kw + r0 + 8 * hh)) pr[u] = 0.f;
      sc[e + u] = pr[u] * chain;
    }
    pa[e >> 3][(e >> 1) & 3] = pack2(pr[0], pr[1]);
  }
}

// dS^T = P^T (1 - t^2) (dP^T - D_i) of a dkdv tile, rounded to bf16 in
// the A fragments of the dK product; D_i of query column c is dis[c].
__device__ __forceinline__ void kv_dscores(const float (&pc)[32],
                                           const float (&dp)[32],
                                           const float* dis, int cq,
                                           uint32_t (&da)[4][4]) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int c = 8 * (e >> 2) + cq;
    da[e >> 3][(e >> 1) & 3] = pack2(pc[e] * (dp[e] - dis[c]),
                                     pc[e + 1] * (dp[e + 1] - dis[c + 1]));
  }
}

// One consumer warpgroup of the dkdv kernel over its 64 keys kw .. (the
// K and V tiles at shared addresses ka, va): per query tile of the ring,
// S^T = K Q^T into registers, P^T, then dV += P^T dO (where it makes dV)
// beside dP^T = V dO^T (where it makes dK), then dS^T and dK += dS^T Q,
// P^T and dS^T rounded to bf16 as the register A operand.  Tiles outside
// this warpgroup's own band are released untouched.
template <int DMAX, bool kDV, bool kDK>
__device__ __forceinline__ void kv_consumer(
    const TcArgs& p, uint8_t* stages, const float* stats, uint64_t* full,
    uint64_t* empty, uint64_t* kvbar, uint32_t ka, uint32_t va, int kw,
    int bhk, int split, int t_lo, int t_hi, int g_lo, int g_hi) {
  using K = KvShape<DMAX>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r0 = warp * 16 + (lane >> 2);     // key rows r0, r0 + 8
  const int cq = 2 * (lane & 3);              // query columns 8 j + cq (+ 1)
  int own_lo, own_hi;
  tc_query_band(p, kw, &own_lo, &own_hi);
  const bool live = kw < p.sk;
  float dv[kDV ? DMAX / 2 : 1], dk[kDK ? DMAX / 2 : 1];
#pragma unroll
  for (int e = 0; e < DMAX / 2; ++e) {
    if constexpr (kDV) dv[e] = 0.f;
    if constexpr (kDK) dk[e] = 0.f;
  }
  hopper::mbar_wait(kvbar, 0);
  int i = 0;
  for (int g = g_lo; g < g_hi; ++g) {
    const int h = (bhk % p.hkv) * (p.hq / p.hkv) + g;
    const int off = ((bhk / p.hkv) * p.hq + h) * p.s & 3;
    for (int t = t_lo; t < t_hi; ++t, ++i) {
      const int s = i % K::kRing;
      hopper::mbar_wait(&full[s], (i / K::kRing) & 1);
      if (live && t >= own_lo && t < own_hi) {
        const int q0 = t * kBT;
        const uint32_t qa = hopper::smem_u32(stages + 2 * s * K::kTile);
        const uint32_t ga = qa + K::kTile;
        const float* lse = stats + 2 * K::kStatLd * s + off;
        // S^T, then P^T, then dV's product beside dP^T's, then dS^T: the
        // probabilities' arithmetic runs while dP^T's accumulators are not
        // yet live.
        float sc[32], dp[32];
        zero(sc);
        hopper::wgmma_fence();
        product_abt<DMAX>(sc, ka, qa);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        const bool edge = edge_tile(p, q0, kw);
        uint32_t pa[4][4];
        if (p.softcap > 0.f)
          kv_probs<true>(p, sc, lse, edge, q0, kw, r0, cq, pa);
        else
          kv_probs<false>(p, sc, lse, edge, q0, kw, r0, cq, pa);
        if constexpr (kDK) zero(dp);
        hopper::wgmma_fence();
        if constexpr (kDV) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::WgmmaBf16RS<DMAX, 1>::run(dv, pa[kk], nmajor(ga, kk));
        }
        if constexpr (kDK) product_abt<DMAX>(dp, va, ga);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        if constexpr (kDV) {
          hopper::fence_regs(dv);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(pa[kk]);
        }
        if constexpr (kDK) {
          hopper::fence_regs(dp);
          uint32_t da[4][4];
          kv_dscores(sc, dp, lse + K::kStatLd, cq, da);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::WgmmaBf16RS<DMAX, 1>::run(dk, da[kk], nmajor(qa, kk));
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dk);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(da[kk]);
        }
      }
      if ((threadIdx.x & 127) == 0) hopper::mbar_arrive(&empty[s]);
    }
  }

  if constexpr (kDK) store_kv<DMAX>(p, dk, 0, p.scale, kw, bhk, split);
  if constexpr (kDV) store_kv<DMAX>(p, dv, 1, 1.f, kw, bhk, split);
}

// dk, dv: one CTA per (batch * KV head * query-head split, key tile), the
// first key tiles (the most queries under a causal mask) launched first.
// Warpgroup 2's first thread loads K and V once and streams Q, dO, lse and
// D_i of the split's query heads over the keys' band through a ring.  At
// D <= 128 the two consumer warpgroups own 64 keys each (128 a CTA) and
// make both dK and dV; at D = 256 they share 64 keys, warpgroup 0 making
// dV and warpgroup 1 dK (each computes S^T itself).
template <int DMAX>
__global__ void __launch_bounds__(kKvThreads, 1)
flash_bwd_wg_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tg,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tl,
                         const __grid_constant__ CUtensorMap td,
                         const TcArgs p) {
  using K = KvShape<DMAX>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = hopper::align_1024(smem_raw);
  uint8_t* vs = ks + K::kKV;
  uint8_t* stages = vs + K::kKV;        // kRing x (Q, dO)
  float* stats = reinterpret_cast<float*>(stages + 2 * K::kRing * K::kTile);
  uint64_t* kvbar =
      reinterpret_cast<uint64_t*>(stats + 2 * K::kStatLd * K::kRing);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + K::kRing;

  const int split = blockIdx.x % p.nsplit;
  const int bhk = blockIdx.x / p.nsplit;
  const int b = bhk / p.hkv, hk = bhk - b * p.hkv;
  const int group = p.hq / p.hkv;
  const int g_lo = split * group / p.nsplit;
  const int g_hi = (split + 1) * group / p.nsplit;
  const int k0 = blockIdx.y * K::kKeys;
  int t_lo, t_hi, unused;
  tc_query_band(p, k0, &t_lo, &unused);
  tc_query_band(p, k0 + K::kKeys - kBT, &unused, &t_hi);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < K::kRing; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // 24 + 2 x 240 = 3 x 168: what the producer gives up, the consumers
    // take.
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != 256) return;
    hopper::mbar_arrive_expect_tx(kvbar, 2 * K::kKV);
    for (int w = 0; w < K::kKeys / kBT; ++w)
      for (int j = 0; j < Tile<DMAX>::kBlocks; ++j) {
        const int off = w * K::kTile + j * kBT * 128;
        hopper::tma_load_4d(ks + off, &tk, kvbar, 64 * j, k0 + w * kBT, hk, b);
        hopper::tma_load_4d(vs + off, &tv, kvbar, 64 * j, k0 + w * kBT, hk, b);
      }
    int i = 0;
    for (int g = g_lo; g < g_hi; ++g) {
      const int h = hk * group + g;
      const int row0 = (b * p.hq + h) * p.s;
      for (int t = t_lo; t < t_hi; ++t, ++i) {
        const int s = i % K::kRing;
        uint8_t* st = stages + 2 * s * K::kTile;
        float* sst = stats + 2 * K::kStatLd * s;
        hopper::mbar_wait(&empty[s], ((i / K::kRing) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], K::kStage);
        for (int j = 0; j < Tile<DMAX>::kBlocks; ++j) {
          hopper::tma_load_4d(st + j * kBT * 128, &tq, &full[s], 64 * j,
                              t * kBT, h, b);
          hopper::tma_load_4d(st + K::kTile + j * kBT * 128, &tg, &full[s],
                              64 * j, t * kBT, h, b);
        }
        const int first = (row0 + t * kBT) & ~3;
        hopper::tma_load_1d(sst, &tl, &full[s], first);
        hopper::tma_load_1d(sst + K::kStatLd, &td, &full[s], first);
      }
    }
    return;
  }

  // Each role takes its register budget in its own branch: the warpgroup
  // making dK at D = 256 holds the most (dK's 128 accumulators, S^T's and
  // dP^T's 64) and takes 256, the one making dV 224; at D <= 128 both
  // make both and take 240.  Each sums with the producer's 24 to 3 x 168.
  const int w = K::kPair ? 0 : wg;
  const uint32_t ka = hopper::smem_u32(ks + w * K::kTile);
  const uint32_t va = hopper::smem_u32(vs + w * K::kTile);
  const int kw = k0 + w * kBT;
  if (!K::kPair) {
    hopper::setmaxnreg_inc<240>();
    kv_consumer<DMAX, true, true>(p, stages, stats, full, empty, kvbar, ka,
                                  va, kw, bhk, split, t_lo, t_hi, g_lo, g_hi);
  } else if (wg == 0) {
    hopper::setmaxnreg_inc<224>();
    kv_consumer<DMAX, true, false>(p, stages, stats, full, empty, kvbar, ka,
                                   va, kw, bhk, split, t_lo, t_hi, g_lo,
                                   g_hi);
  } else {
    hopper::setmaxnreg_inc<256>();
    kv_consumer<DMAX, false, true>(p, stages, stats, full, empty, kvbar, ka,
                                   va, kw, bhk, split, t_lo, t_hi, g_lo,
                                   g_hi);
  }
}

// dK and dV of several splits: the f32 parts summed in split order and
// rounded once to bf16 (n elements each, a multiple of 4).
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* part, bf16* dk, bf16* dv, long long n,
                     int nsplit) {
  const long long step = 4LL * gridDim.x * blockDim.x;
  for (long long i = 4LL * (blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += step) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < nsplit; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(
            part + (2LL * s + which) * n + i);
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      uint2 raw;
      raw.x = pack2(a.x, a.y);
      raw.y = pack2(a.z, a.w);
      *reinterpret_cast<uint2*>((which == 0 ? dk : dv) + i) = raw;
    }
  }
}

size_t dq_smem(int dmax) {
  const size_t tile = static_cast<size_t>(dmax / 64) * kBT * 128;
  return 1024 + (2 + 2 * kDqRing) * tile + (1 + 2 * kDqRing) * 8;
}

template <int DMAX>
int launch_tc(const Args& a, const float* lse, int nsplit, float* part,
              int sms, int batch, cudaStream_t stream) {
  using K = KvShape<DMAX>;
  static bool raised = false;  // the >48 KB opt-in, once per instantiation
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_wg_dq_kernel<DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem(DMAX)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_wg_dkdv_kernel<DMAX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(K::smem_bytes()));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const long long rows = static_cast<long long>(batch) * a.hq * a.s;
  CUtensorMap tq, tg, tk, tv, tl, td;
  int err = hopper::bhsd_map(&tq, a.q, a.d, a.s, a.hq, batch, a.q_ss, a.q_sh,
                             a.q_sb, kBT);
  if (err == 0)
    err = hopper::bhsd_map(&tg, a.dout, a.d, a.s, a.hq, batch, a.g_ss,
                           a.g_sh, a.g_sb, kBT);
  if (err == 0)
    err = hopper::bhsd_map(&tk, a.k, a.d, a.sk, a.hkv, batch, a.k_ss, a.k_sh,
                           a.k_sb, kBT);
  if (err == 0)
    err = hopper::bhsd_map(&tv, a.v, a.d, a.sk, a.hkv, batch, a.v_ss, a.v_sh,
                           a.v_sb, kBT);
  if (err == 0) err = hopper::f32_map_1d(&tl, lse, rows, K::kStatBox);
  if (err == 0) err = hopper::f32_map_1d(&td, a.di, rows, K::kStatBox);
  if (err != 0) return err;
  const bool cap = a.softcap > 0.f;
  const TcArgs p{a.o,    a.dq,   a.dk,   a.dv,   part,   lse,
                 a.di,   a.o_sb, a.o_sh, a.o_ss, a.hq,   a.hkv,
                 a.s,    a.sk,   a.d,    a.scale, a.softcap,
                 cap ? a.scale : a.scale * kLog2e,
                 cap ? a.softcap * kLog2e : 0.f,
                 a.causal, a.window, nsplit};
  const dim3 grid_q(batch * a.hq, (a.s + kBT - 1) / kBT);
  flash_bwd_wg_dq_kernel<DMAX>
      <<<grid_q, DqShape<DMAX>::kThreads, dq_smem(DMAX), stream>>>(tq, tg, tk,
                                                                   tv, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_k(batch * a.hkv * nsplit, (a.sk + K::kKeys - 1) / K::kKeys);
  flash_bwd_wg_dkdv_kernel<DMAX>
      <<<grid_k, kKvThreads, K::smem_bytes(), stream>>>(tq, tg, tk, tv, tl,
                                                        td, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return static_cast<int>(e);
  const long long n = static_cast<long long>(batch) * a.hkv * a.sk * a.d;
  const long long want = (n / 4 + 255) / 256;
  const long long most = 8LL * sms;  // 8 blocks of 256 an SM
  const long long blocks = want < most ? want : most;
  flash_bwd_sum_kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(
      part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n, nsplit);
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

int dispatch_bf16(const Args& a, const float* lse, int nsplit, float* part,
                  int sms, int batch, cudaStream_t stream) {
  if (a.d % 32 != 0) return dispatch_d<__nv_bfloat16>(a, batch, stream);
  if (a.d <= 64)
    return launch_tc<64>(a, lse, nsplit, part, sms, batch, stream);
  if (a.d <= 128)
    return launch_tc<128>(a, lse, nsplit, part, sms, batch, stream);
  return launch_tc<256>(a, lse, nsplit, part, sms, batch, stream);
}

}  // namespace

// The keys of one dkdv CTA on the tensor cores at head dim d (a multiple
// of 32 up to 256): the unit of flash_attention_bwd.py::dkdv_splits.
extern "C" int repro_flash_bwd_keys(int d) {
  if (d <= 64) return KvShape<64>::kKeys;
  if (d <= 128) return KvShape<128>::kKeys;
  return KvShape<256>::kKeys;
}

// q, k, v, o and dO in f32 (is_bf16 = 0) or bf16 (1), strides in elements
// with the last dimension contiguous; dq, dk and dv contiguous in the same
// dtype.  lse holds the forward's B * Hq * S row statistics; ws holds B *
// Hq * S floats where the tensor cores run (bf16, D % 32 == 0), twice that
// elsewhere; where the tensor cores run and nsplit > 1, part holds nsplit *
// 2 * B * Hkv * Sk * D floats, and sms (the card's SM count) bounds the
// grid of the launch that sums them.  The query rows sit
// at key positions 0 .. S - 1 (no offset).  Refuses D > 256, D % 8 != 0,
// Hq % Hkv != 0, an nsplit outside [1, Hq / Hkv] (or above 1 off the tensor
// cores, or without part or sms) and grids past the hardware limits with
// cudaErrorInvalidValue; otherwise returns cudaGetLastError() after the
// last launch.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* ws, float* part, int nsplit, int sms, int is_bf16, int batch,
    int hq, int hkv, int s, int sk, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, long long g_sb, long long g_sh,
    long long g_ss, float scale, int causal, int window, float softcap,
    void* stream) {
  const long long rows = static_cast<long long>(batch) * hq * s;
  const bool tc = is_bf16 && d % 32 == 0;
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1 || sk < 1 ||
      d < 8 || d > 256 || d % 8 != 0 ||
      static_cast<long long>(batch) * hq > 65535 || s > 65535 * 32 ||
      sk > 65535 * 32 || nsplit < 1 || nsplit > hq / hkv ||
      (nsplit > 1 && (!tc || part == nullptr || sms < 1)) ||
      (tc && rows >= (1LL << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    // The tensor cores take the forward's statistics; D_i goes to ws.
    const Args args{q,    k,    v,    o,    dout, dq,   dk,   dv,
                    nullptr, ws,
                    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                    o_sb, o_sh, o_ss, g_sb, g_sh, g_ss,
                    hq,   hkv,  s,    sk,   d,
                    scale, softcap, causal, window};
    return dispatch_bf16(args, lse, nsplit, part, sms, batch, st);
  }
  // The CUDA cores recompute each row's log-sum-exp into ws.
  const Args args{q,    k,    v,    o,    dout, dq,   dk,   dv,
                  ws,   ws + rows,
                  q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                  o_sb, o_sh, o_ss, g_sb, g_sh, g_ss,
                  hq,   hkv,  s,    sk,   d,
                  scale, softcap, causal, window};
  if (is_bf16) return dispatch_d<__nv_bfloat16>(args, batch, st);
  return dispatch_d<float>(args, batch, st);
}
