// rwkv6_scan: the RWKV-6 recurrence with data-dependent decay.  Per row bh
// of (BH, T, D) inputs, along T, with a D x D f32 state S:
//
//   o_t[j] = sum_i r_t[i] S[i][j] + v_t[j] * sum_i r_t[i] u[i] k_t[i]
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// u is (H, D), row bh % H serving row bh; S starts from state0 or zero and
// is stored at the end when asked.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py::rwkv6_scan (Pallas
// body _rwkv6_kernel), widened to per-head u and a carried state as the
// model's rwkv6_chunked needs.  On the TPU time was blocked into VMEM chunks
// on a sequential grid axis with S in VMEM scratch.  Here one CTA of 2 D
// threads owns one row bh and walks all of T with S in registers.  Each
// thread holds an R x kCols tile of S: kCols = 4 adjacent columns and one
// of kSplit = 8 blocks of D / 8 rows; the 8 lanes of a column group are
// adjacent, so r_t . S closes with three shuffles, and every shared-memory
// operand a thread reads feeds kCols products.  r, k, u*k, w and v of kChunk
// steps are staged in shared memory, double-buffered with one __syncthreads
// per chunk; each thread fetches its share of the chunk after next into
// registers before it computes the current one, so kChunk steps of loads
// are in flight behind the arithmetic.  The bonus sum r_t . (u*k_t) does
// not depend on S: each warp computes it for a whole chunk at once.
//
// What bounds it on this card: per step and row it does ~5 D^2 f32 flops
// and moves ~4 D elements, so at the forward shape (64, 4096, 64) the f32
// operations (5.4 GFLOP at 67 TFLOP/s: 0.081 ms) bound it before the bytes
// (201 MB: 0.060 ms).  It runs BH CTAs, 64 at B = 1 on 132 SMs, each a
// serial chain over T with one or two warps per scheduler, so the latency
// of one step (loads, FMA chains, shuffles, the dependent update), not
// either rate, sets its time: ~27x the bound on an H100 SXM (PERF.md).
// The chunked form on tensor cores is later work.  At decode (T = 1) the
// D x D state read and written per row dominates the bytes.
//
// Shared memory: the 8 row blocks of a column group are read in one
// quarter-warp phase; row index i is stored at i + 4 (i / 32), which puts
// the 8 blocks' 16-byte reads in distinct banks for D = 32, 64 and 128.
//
// Numerics: f32 throughout with FMAs; sums are taken in another order than
// the plain PyTorch version's, so the two agree to f32 rounding, not bit for
// bit.  bf16 outputs round to nearest even.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;   // state columns per thread
constexpr int kSplit = 8;  // row blocks per column group (adjacent lanes)
constexpr int kChunk = 8;  // time steps staged per shared-memory buffer
constexpr unsigned kAll = 0xffffffffu;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void put(float* p, float x) { *p = x; }
__device__ inline void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Bank skew: 4 floats after every 32.
__host__ __device__ constexpr int skew(int i) { return i + (i / 32) * 4; }

template <int D>
struct Stage {  // kChunk steps of the inputs, in f32, skewed rows
  static constexpr int P = skew(D);
  float r[kChunk][P];
  float k[kChunk][P];
  float uk[kChunk][P];  // u[i] * k_t[i]
  float w[kChunk][P];
  float v[kChunk][P];
};

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// kChunk steps of one channel from t0 on; steps past t_len read as `pad`
// (w = 1 and k = 0 leave the state as it was).
template <typename X>
__device__ inline void fetch(float (&pre)[kChunk], const X* p, long long st,
                             int t0, int t_len, float pad) {
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const int t = t0 + s;
    pre[s] = t < t_len ? to_f32(p[st * t]) : pad;
  }
}

// One row of the thread's tile: S[i][c] = w_i S[i][c] + k_i v_c.
__device__ inline void decay_add(float (&row)[kCols], float w, float k,
                                 const float4& v) {
  row[0] = fmaf(w, row[0], k * v.x);
  row[1] = fmaf(w, row[1], k * v.y);
  row[2] = fmaf(w, row[2], k * v.z);
  row[3] = fmaf(w, row[3], k * v.w);
}

__device__ inline void dot_row(float (&y)[kCols], float r,
                               const float (&row)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) y[c] = fmaf(r, row[c], y[c]);
}

template <typename T, int D>
__global__ void __launch_bounds__(2 * D)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ out, float* __restrict__ s_out, int heads,
             int t_len, long long r_bh, long long r_t, long long k_bh,
             long long k_t, long long v_bh, long long v_t, long long w_bh,
             long long w_t) {
  constexpr int R = D / kSplit;  // rows per thread
  static_assert(R % 4 == 0 && (D / 4) % 4 == 0, "rows are read as float4");
  static_assert((D / kCols) * kSplit == 2 * D, "2 D threads per row bh");
  __shared__ __align__(16) Stage<D> stage[2];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // Compute role: columns [j0, j0 + kCols), rows [i0, i0 + R).
  const int q = tid % kSplit;
  const int j0 = (tid / kSplit) * kCols;
  const int i0 = q * R;
  // Load role: channel c of (r, w) for the first D threads, of (k, v) for
  // the rest; D >= 32, so the role is the same across a warp.
  const bool loads_rw = tid < D;
  const int c = tid % D;
  const float u_c = u[(bh % heads) * D + c];

  float S[R][kCols];
  if (s0 != nullptr) {
    const float* sp = s0 + static_cast<size_t>(bh) * D * D + j0;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float4 x = ld4(sp + (i0 + m) * D);
      S[m][0] = x.x;
      S[m][1] = x.y;
      S[m][2] = x.z;
      S[m][3] = x.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) S[m][cc] = 0.f;
  }

  const T* p0 = loads_rw ? r + r_bh * bh + c : k + k_bh * bh + c;
  const long long st0 = loads_rw ? r_t : k_t;
  float pre0[kChunk], pre1[kChunk];
  auto load = [&](int t0) {
    fetch(pre0, p0, st0, t0, t_len, 0.f);
    if (loads_rw) fetch(pre1, w + w_bh * bh + c, w_t, t0, t_len, 1.f);
    else fetch(pre1, v + v_bh * bh + c, v_t, t0, t_len, 0.f);
  };
  auto store = [&](Stage<D>& st) {
    const int cs = skew(c);
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      if (loads_rw) {
        st.r[s][cs] = pre0[s];
        st.w[s][cs] = pre1[s];
      } else {
        st.k[s][cs] = pre0[s];
        st.uk[s][cs] = u_c * pre0[s];
        st.v[s][cs] = pre1[s];
      }
    }
  };

  T* op = out + static_cast<size_t>(bh) * t_len * D + j0;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  load(0);
  store(stage[0]);
  if (n_chunks > 1) load(kChunk);
  __syncthreads();
  for (int ch = 0; ch < n_chunks; ++ch) {
    // stage[(ch + 1) & 1] was last read in chunk ch - 1, before the barrier.
    if (ch + 1 < n_chunks) store(stage[(ch + 1) & 1]);
    if (ch + 2 < n_chunks) load((ch + 2) * kChunk);
    const Stage<D>& st = stage[ch & 1];
    const int t0 = ch * kChunk;
    const int steps = min(kChunk, t_len - t0);

    // The chunk's bonus sums: lane 4 s + p adds quarter p of step s; after
    // the shuffles every lane of the four holds z_s.
    float z = 0.f;
    {
      const int s = lane >> 2;
      const int i = (lane & 3) * (D / 4);
#pragma unroll
      for (int m = 0; m < D / 4; m += 4) {
        const float4 rr = ld4(&st.r[s][skew(i + m)]);
        const float4 uu = ld4(&st.uk[s][skew(i + m)]);
        z = fmaf(rr.x, uu.x, z);
        z = fmaf(rr.y, uu.y, z);
        z = fmaf(rr.z, uu.z, z);
        z = fmaf(rr.w, uu.w, z);
      }
      z += __shfl_xor_sync(kAll, z, 1);
      z += __shfl_xor_sync(kAll, z, 2);
    }

    for (int s = 0; s < steps; ++s) {
      const float4 vv = ld4(&st.v[s][skew(j0)]);
      float y[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < R; m += 4) {
        const float4 rr = ld4(&st.r[s][skew(i0 + m)]);
        dot_row(y, rr.x, S[m]);
        dot_row(y, rr.y, S[m + 1]);
        dot_row(y, rr.z, S[m + 2]);
        dot_row(y, rr.w, S[m + 3]);
      }
#pragma unroll
      for (int o = 1; o < kSplit; o <<= 1)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          y[cc] += __shfl_xor_sync(kAll, y[cc], o);
      const float zs = __shfl_sync(kAll, z, 4 * s);
      if (q < kCols) {  // lane q of the group writes column j0 + q
        const float yq = q == 0 ? y[0] : q == 1 ? y[1] : q == 2 ? y[2] : y[3];
        const float vq = q == 0 ? vv.x : q == 1 ? vv.y : q == 2 ? vv.z : vv.w;
        put(op + static_cast<size_t>(t0 + s) * D + q, fmaf(vq, zs, yq));
      }
#pragma unroll
      for (int m = 0; m < R; m += 4) {
        const float4 ww = ld4(&st.w[s][skew(i0 + m)]);
        const float4 kk = ld4(&st.k[s][skew(i0 + m)]);
        decay_add(S[m], ww.x, kk.x, vv);
        decay_add(S[m + 1], ww.y, kk.y, vv);
        decay_add(S[m + 2], ww.z, kk.z, vv);
        decay_add(S[m + 3], ww.w, kk.w, vv);
      }
    }
    __syncthreads();
  }

  if (s_out != nullptr) {
    float* sp = s_out + static_cast<size_t>(bh) * D * D + j0;
#pragma unroll
    for (int m = 0; m < R; ++m)
      *reinterpret_cast<float4*>(sp + (i0 + m) * D) =
          make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
  }
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_out, int bh,
           int heads, int t_len, const long long* st, cudaStream_t stream) {
  rwkv6_kernel<T, D><<<bh, 2 * D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_out), heads, t_len, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* r, const void* k, const void* v,
             const void* w, const void* u, const void* s0, void* out,
             void* s_out, int bh, int heads, int t_len, const long long* st,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, out, s_out, bh, heads, t_len,
                           st, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, out, s_out, bh, heads, t_len,
                           st, stream);
    case 128:
      return launch<T, 128>(r, k, v, w, u, s0, out, s_out, bh, heads, t_len,
                            st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v: (BH, T, D) in f32 (is_bf16 = 0) or bf16 (1), element strides
// (*_bh, *_t) and a contiguous last axis; w: the same in f32; u: contiguous
// (heads, D) f32; s0: contiguous (BH, D, D) f32 or null for zeros; out:
// contiguous (BH, T, D) in r's type; s_out: contiguous (BH, D, D) f32, or
// null when the final state is not wanted.  D is 32, 64 or 128.  Returns
// cudaErrorInvalidValue for shapes it does not take, else cudaGetLastError()
// after the launch.
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* out, void* s_out, int is_bf16, int bh,
                                int heads, int t_len, int d, long long r_bh,
                                long long r_t, long long k_bh, long long k_t,
                                long long v_bh, long long v_t, long long w_bh,
                                long long w_t, void* stream) {
  if (bh < 1 || t_len < 1 || heads < 1 || bh % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {r_bh, r_t, k_bh, k_t, v_bh, v_t, w_bh, w_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(d, r, k, v, w, u, s0, out, s_out,
                                           bh, heads, t_len, st, s)
                 : launch_d<float>(d, r, k, v, w, u, s0, out, s_out, bh,
                                   heads, t_len, st, s);
}
