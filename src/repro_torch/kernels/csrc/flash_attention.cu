// flash_attention: blocked online-softmax attention over (B, Hq, S, D)
// queries and (B, Hkv, Sk, D) keys/values, with causal masking, a sliding
// window, logit soft-capping cap * tanh(s / cap) and GQA (query head h reads
// KV head h / (Hq / Hkv)).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas body _flash_kernel).  On the TPU the KV axis was
// the sequential grid dimension carrying (m, l, acc) in VMEM scratch; here
// one CTA owns a 32-row query tile of one (batch, head) and walks the KV
// tiles itself in a loop, keeping the running max m and denominator l in
// registers (replicated over the 8 lanes of a row) and the f32 numerator in
// registers too (D/32 float4 per thread).  Whole KV tiles outside the
// causal/window band are never loaded, as the Pallas kernel skips them.
//
// Masking follows the reference: masked logits are -0.7 * FLT_MAX, their
// probabilities are zeroed, and a row with zero mass writes 0 (l == 0 -> 1).
// Unlike the Pallas kernel, keys at k_pos >= Sk are masked here in every
// mode: the Pallas kernel zero-pads K/V and leaves the pad to `causal`, so
// a non-causal call with a ragged Sk lets padded keys carry mass.
//
// What bounds it on this card: at the served shape (S = 4096, D = 256,
// window 2048) the work is ~6.4e10 flops against ~2e7 bytes, so operations
// bind.  This first version runs them as f32 FMAs on CUDA cores out of
// shared memory (Q, K, V tiles widened to f32, rows padded by 4 floats so a
// quarter-warp's float4 reads of 8 different rows hit 32 distinct banks), far
// from the bf16 tensor-core rate; mma.sync/wgmma with TMA staging is later
// work.  Shared memory is 3 * 32 * (D + 4) * 4 + 32 * 40 * 4 bytes (105 KB
// at D = 256), above the 48 KB default, so the limit is raised once per
// instantiation; two CTAs fit on an SM.
//
// Numerics: expf/tanhf and IEEE division (no fast math); the logit is
// dot(q, k) * scale as in the Pallas body.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;               // query rows per CTA = keys per tile
constexpr int kLanes = 8;               // threads per query row
constexpr int kThreads = kRows * kLanes;
constexpr int kCols = kRows / kLanes;   // logits per thread per tile
constexpr int kPad = 4;                 // floats of padding per Q/K/V row
constexpr int kPLd = kRows + 8;         // probability tile row stride
constexpr float kNeg = -0.7f * FLT_MAX;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int hq, hkv, s, sk, d;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
};

__device__ inline void load8(const float* src, float* dst) {
  const float4 lo = reinterpret_cast<const float4*>(src)[0];
  const float4 hi = reinterpret_cast<const float4*>(src)[1];
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

__device__ inline void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]);
  const float2 f3 = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
}

__device__ inline void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ inline void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&lo);
  raw.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// Rows [0, valid) of a kRows x d tile from global memory (row stride in
// elements) into shared memory as f32 with row stride ld; rows past valid
// are zero.
template <typename T>
__device__ void load_tile(const T* src, long long row_stride, int valid, int d,
                          int ld, float* tile) {
  const int chunks = d / 8;
  for (int idx = threadIdx.x; idx < kRows * chunks; idx += kThreads) {
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

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args p) {
  constexpr int kChunks = DMAX / (4 * kLanes);  // float4 per thread per row
  extern __shared__ __align__(16) float smem[];
  const int ld = p.d + kPad;
  float* qs = smem;
  float* ks = qs + kRows * ld;
  float* vs = ks + kRows * ld;
  float* ps = vs + kRows * ld;

  const int bh = blockIdx.y;
  const int b = bh / p.hq, h = bh - (bh / p.hq) * p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q_lo = blockIdx.x * kRows;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                q_lo * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile(qg, p.q_ss, min(kRows, p.s - q_lo), p.d, ld, qs);

  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x - row * kLanes;
  const int q_pos = q_lo + row;
  float m = kNeg, l = 0.f;
  float4 acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // KV tiles inside the causal/window band of this query tile.
  const int n_kv = (p.sk + kRows - 1) / kRows;
  int t_begin = 0, t_end = n_kv;
  if (p.causal) t_end = min(n_kv, (q_lo + kRows - 1) / kRows + 1);
  if (p.window > 0 && q_lo - p.window + 1 > 0)
    t_begin = (q_lo - p.window + 1) / kRows;

  for (int t = t_begin; t < t_end; ++t) {
    const int k_lo = t * kRows;
    __syncthreads();  // the previous tile's K/V/P reads (and the Q load) done
    const int valid = min(kRows, p.sk - k_lo);
    load_tile(kg + k_lo * p.k_ss, p.k_ss, valid, p.d, ld, ks);
    load_tile(vg + k_lo * p.v_ss, p.v_ss, valid, p.d, ld, vs);
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = 0.f;
    const float* qrow = qs + row * ld;
    for (int dd = 0; dd < p.d; dd += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + dd);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (lane + c * kLanes) * ld + dd);
        s[c] = fmaf(qv.x, kv.x, s[c]);
        s[c] = fmaf(qv.y, kv.y, s[c]);
        s[c] = fmaf(qv.z, kv.z, s[c]);
        s[c] = fmaf(qv.w, kv.w, s[c]);
      }
    }

    bool keep[kCols];
    float m_cur = kNeg;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int k_pos = k_lo + lane + c * kLanes;
      float x = s[c] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      bool ok = k_pos < p.sk;
      if (p.causal) ok = ok && k_pos <= q_pos;
      if (p.window > 0) ok = ok && k_pos > q_pos - p.window;
      keep[c] = ok;
      s[c] = ok ? x : kNeg;
      m_cur = fmaxf(m_cur, s[c]);
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1)
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
    const float m_new = fmaxf(m, m_cur);
    float row_sum = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float pr = keep[c] ? expf(s[c] - m_new) : 0.f;
      ps[row * kPLd + lane + c * kLanes] = pr;
      row_sum += pr;
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1)
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
    const float alpha = expf(m - m_new);
    l = l * alpha + row_sum;
    m = m_new;
    __syncwarp();  // a row's probabilities come from its own 8 lanes

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
    const float* prow = ps + row * kPLd;
    for (int j = 0; j < kRows; ++j) {
      const float pj = prow[j];
      const float* vrow = vs + j * ld;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = (lane + c * kLanes) * 4;
        if (col < p.d) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + col);
          acc[c].x = fmaf(pj, vv.x, acc[c].x);
          acc[c].y = fmaf(pj, vv.y, acc[c].y);
          acc[c].z = fmaf(pj, vv.z, acc[c].z);
          acc[c].w = fmaf(pj, vv.w, acc[c].w);
        }
      }
    }
  }

  if (q_pos >= p.s) return;
  const float denom = l == 0.f ? 1.f : l;
  T* orow = static_cast<T*>(p.out) +
            (static_cast<long long>(bh) * p.s + q_pos) * p.d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (lane + c * kLanes) * 4;
    if (col < p.d)
      store4(orow + col, make_float4(acc[c].x / denom, acc[c].y / denom,
                                     acc[c].z / denom, acc[c].w / denom));
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) * (3 * kRows * (d + kPad) + kRows * kPLd);
}

template <typename T, int DMAX>
int launch(const Args& args, int batch, cudaStream_t stream) {
  static bool raised = false;  // the >48 KB opt-in, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(DMAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((args.s + kRows - 1) / kRows, batch * args.hq);
  flash_kernel<T, DMAX><<<grid, kThreads, smem_bytes(args.d), stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& args, int batch, cudaStream_t stream) {
  if (args.d <= 64) return launch<T, 64>(args, batch, stream);
  if (args.d <= 128) return launch<T, 128>(args, batch, stream);
  return launch<T, 256>(args, batch, stream);
}

}  // namespace

// q/k/v/out in f32 (is_bf16 = 0) or bf16 (1); strides in elements, the last
// dimension contiguous.  out is contiguous (B, Hq, S, D).  Refuses D > 256,
// D % 8 != 0, Hq % Hkv != 0 and grids past the hardware limits with
// cudaErrorInvalidValue; otherwise returns cudaGetLastError() after the
// launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int is_bf16,
    int batch, int hq, int hkv, int s, int sk, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int window, float softcap, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1 || sk < 1 ||
      d < 8 || d > 256 || d % 8 != 0 ||
      static_cast<long long>(batch) * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{q,    k,    v,    out,  q_sb, q_sh,  q_ss,    k_sb,
                  k_sh, k_ss, v_sb, v_sh, v_ss, hq,    hkv,     s,
                  sk,   d,    scale, softcap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(args, batch, st)
                 : dispatch_d<float>(args, batch, st);
}
