// rwkv6_scan_bwd: the gradient of the RWKV-6 recurrence of rwkv6_scan.cu.
// Per row bh of (BH, T, D) inputs, from S_0 = 0, with D x D f32 states:
//
//   o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   G_T = 0,  G_{t-1} = diag(w_t) G_t + r_t do_t^T
//
//   dr_t = S_{t-1} do_t + u*k_t (v_t.do_t)
//   dk_t = G_t v_t + u*r_t (v_t.do_t)
//   dv_t = G_t^T k_t + (r_t.(u*k_t)) do_t
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du  += r_t*k_t (v_t.do_t), summed over the rows bh of each head.
//
// Replaces no TPU kernel of its own: the JAX package trains RWKV through
// jax.grad of models/rwkv.py::rwkv6_chunked, the function of the TPU kernel
// src/repro/kernels/rwkv6.py::rwkv6_scan.  The port's forward runs the
// rwkv6_scan kernel, so its gradient is a kernel too.
//
// dw is taken directly, from S_{t-1} and G_t at the same step, and not
// through the cumulative-decay identity dlogw_t = X_t - k_t*(G_t v_t) with
// X_t = sum_j G_t[i][j] S_t[i][j]: that difference cancels to w_t dw_t, so
// dividing by w_t loses log10(1/w_t) digits, and the carried X_t gathers
// rounding over all of T (tests/test_torch_train_kernels.py measures it).
// S_{t-1} is rebuilt in reverse chunks instead:
//
// * rows blocks (a CTA per row bh and kLines<D> key rows i; the rows of S
//   and G are independent).  Pass A runs S forward and stores it at every
//   chunk start (the anchors, a workspace of (BH, T/kChunk - 1, D, D) f32).
//   Pass B walks the chunks backwards: it rebuilds S over the chunk from its
//   anchor, keeping each S_{t-1} in shared memory (the history) and giving
//   S_{t-1} do_t (dr) and du on the way, then runs G back over the chunk,
//   giving G_t v_t (dk) and dw from the history.
// * columns blocks (a CTA per row bh and kLines<D> value columns j): G's
//   columns back over T, giving G_t^T k_t (dv).  Only dv sums over i, so
//   holding G by columns here keeps every sum inside a CTA.
//
// Eight threads hold one row (or column) of S or G, each 4 (q + 8 m) ..
// 4 (q + 8 m) + 3 for m < D / 32, so a sum over it closes with three
// shuffles and each shared-memory operand is read as 16 bytes.  A chunk's
// r, k, v, do and w stream into one of two staging buffers by cp.async
// while the other chunk is computed.  du sums each row's partial over the
// rows bh of a head in a second small launch; nothing is summed by atomics,
// so a call is bit for bit the same each time.
//
// What bounds it on this card: per step and row the function does ~10 D^2
// f32 flops (S, S do, G, G v, G^T k) and moves ~7 D elements, so at
// (64, 4096, 64) the f32 operations (10.7 GFLOP at 67 TFLOP/s: 0.16 ms)
// bound it.  This kernel runs S twice (pass A and the rebuild) and G twice
// (rows and columns), ~16 D^2 f32 flops a row-step on CUDA cores in serial
// chains along T, and moves the anchors through device memory besides: the
// latency of a step and the 2 BH D / kLines<D> CTAs of a call set its time,
// several times the bound (PERF.md).
//
// Numerics: f32 throughout, FMAs, no tensor cores; sums in another order
// than the plain version's (kernels/rwkv6.py::rwkv6_scan_bwd_plain), which
// rebuilds S the same way in chunks of 16.  dw is exact at w = 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;    // threads holding one row (or column)
constexpr int kChunk = 16;   // steps per staged chunk, one anchor a chunk
constexpr unsigned kAll = 0xffffffffu;

// Rows (or columns) per CTA: the history of 16 rows at D = 128 would not
// leave room for two staging buffers.
template <int D>
constexpr int kLines = D == 128 ? 8 : 16;
template <int D>
constexpr int kThreads = kLanes * kLines<D>;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void put(float* p, float x) { *p = x; }
__device__ inline void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline float4 load4(const float* p) { return ld4(p); }
__device__ inline float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ inline float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
// x <- a x + b c, elementwise with a scalar a and b
__device__ inline void decay_add(float4& x, float a, float b, const float4& c) {
  x = make_float4(fmaf(a, x.x, b * c.x), fmaf(a, x.y, b * c.y),
                  fmaf(a, x.z, b * c.z), fmaf(a, x.w, b * c.w));
}
// x <- a x + b c, elementwise with vectors a and b and a scalar c
__device__ inline void decay_add(float4& x, const float4& a, const float4& b,
                                 float c) {
  x = make_float4(fmaf(a.x, x.x, b.x * c), fmaf(a.y, x.y, b.y * c),
                  fmaf(a.z, x.z, b.z * c), fmaf(a.w, x.w, b.w * c));
}

// The sum over the eight threads of a row (adjacent lanes).
__device__ inline float line_sum(float x) {
  x += __shfl_xor_sync(kAll, x, 1);
  x += __shfl_xor_sync(kAll, x, 2);
  return x + __shfl_xor_sync(kAll, x, 4);
}

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
struct Args {
  const T *r, *k, *v, *dout;
  const float *w, *u;
  T *dr, *dk, *dv;
  float *dw, *du_part, *anchors;
  int bh, heads, t_len;
  long long r_bh, r_t, k_bh, k_t, v_bh, v_t, w_bh, w_t, do_bh, do_t;
};

template <typename T, int D>
struct Smem {  // byte offsets
  static constexpr int NT = kThreads<D>;
  static constexpr int NV = D / (4 * kLanes);  // float4 of a row per thread
  static constexpr int tile = kChunk * D;       // elements of one (C, D) array
  // One staging buffer: r, k, v, do as they lie in memory, then w in f32.
  static constexpr int st_r = 0;
  static constexpr int st_k = st_r + tile * static_cast<int>(sizeof(T));
  static constexpr int st_v = st_k + tile * static_cast<int>(sizeof(T));
  static constexpr int st_do = st_v + tile * static_cast<int>(sizeof(T));
  static constexpr int st_w = st_do + tile * static_cast<int>(sizeof(T));
  static constexpr int st_bytes = st_w + tile * 4;
  static constexpr int scal = 2 * st_bytes;       // kChunk floats
  static constexpr int su = scal + kChunk * 4;    // D floats: u of the head
  static constexpr int hist = su + D * 4;         // (kChunk, NV, NT) float4
  static constexpr int bytes = hist + kChunk * NV * NT * 16;
  static_assert(st_bytes % 16 == 0 && hist % 16 == 0, "16-byte alignment");
  static_assert(bytes <= 232448, "fits the shared memory of one CTA");
  static_assert(NT % kChunk == 0 && (NT / kChunk) <= 32, "step dots");
};

// Rows t0 .. t0 + n - 1 of a (T, D) array with row stride ld elements into
// dst, 16 bytes a copy.
template <typename E, int D>
__device__ inline void stage_rows(unsigned char* dst, const E* src,
                                  long long ld, int t0, int n, int tid,
                                  int nt) {
  constexpr int per_row = D * static_cast<int>(sizeof(E)) / 16;
  for (int p = tid; p < n * per_row; p += nt) {
    const int row = p / per_row, q = p % per_row;
    cp_async16(dst + (row * per_row + q) * 16,
               src + ld * (t0 + row) + q * (16 / static_cast<int>(sizeof(E))));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads<D>)
rwkv6_bwd_kernel(const Args<T> a) {
  using L = Smem<T, D>;
  constexpr int NT = L::NT, NV = L::NV, NB = D / kLines<D>;
  extern __shared__ __align__(16) unsigned char sm[];
  float* scal = reinterpret_cast<float*>(sm + L::scal);
  float* su = reinterpret_cast<float*>(sm + L::su);
  float4* hist = reinterpret_cast<float4*>(sm + L::hist);

  const int tid = threadIdx.x;
  const int q = tid % kLanes;
  const bool rows = static_cast<int>(blockIdx.x) < a.bh * NB;
  const int blk = rows ? blockIdx.x : blockIdx.x - a.bh * NB;
  const int bh = blk / NB;
  const int x = (blk % NB) * kLines<D> + tid / kLanes;  // row i or column j
  const int n_chunks = (a.t_len + kChunk - 1) / kChunk;
  const T* rp = a.r + a.r_bh * bh;
  const T* kp = a.k + a.k_bh * bh;
  const T* vp = a.v + a.v_bh * bh;
  const T* dop = a.dout + a.do_bh * bh;
  const float* wp = a.w + a.w_bh * bh;
  const float* up = a.u + (bh % a.heads) * D;
  const size_t out_row = static_cast<size_t>(bh) * a.t_len * D;

  // Chunk c into buffer c & 1: the arrays of `want` (bits r, k, v, do, w).
  auto stage = [&](int c, int want) {
    unsigned char* b = sm + (c & 1) * L::st_bytes;
    const int t0 = c * kChunk, n = min(kChunk, a.t_len - t0);
    if (want & 1) stage_rows<T, D>(b + L::st_r, rp, a.r_t, t0, n, tid, NT);
    if (want & 2) stage_rows<T, D>(b + L::st_k, kp, a.k_t, t0, n, tid, NT);
    if (want & 4) stage_rows<T, D>(b + L::st_v, vp, a.v_t, t0, n, tid, NT);
    if (want & 8) stage_rows<T, D>(b + L::st_do, dop, a.do_t, t0, n, tid, NT);
    if (want & 16) stage_rows<float, D>(b + L::st_w, wp, a.w_t, t0, n, tid, NT);
    cp_async_commit();
  };
  auto arr = [&](int c, int off) {
    return reinterpret_cast<const T*>(sm + (c & 1) * L::st_bytes + off);
  };
  auto warr = [&](int c) {
    return reinterpret_cast<const float*>(sm + (c & 1) * L::st_bytes +
                                          L::st_w);
  };
  // scal[s] = sum_e f(s, e) over the chunk's steps, NT / kChunk threads a
  // step; the caller synchronizes before reading it.
  auto step_dots = [&](int steps, auto f) {
    constexpr int TPS = NT / kChunk;
    const int s = tid / TPS, p = tid % TPS;
    float acc = 0.f;
    if (s < steps)
      for (int e = p; e < D; e += TPS) acc += f(s, e);
#pragma unroll
    for (int o = 1; o < TPS; o <<= 1) acc += __shfl_xor_sync(kAll, acc, o);
    if (p == 0 && s < steps) scal[s] = acc;
  };
  constexpr int kR = 1, kK = 2, kV = 4, kDo = 8, kW = 16;

  if (!rows) {
    // ---- Columns: G[:, j] backwards over T; dv_t[j] = G_t^T k_t + z_t do_t[j]
    // with z_t = r_t . (u * k_t).  Thread q holds rows 4 (q + 8 m) .. + 3.
    const int j = x;
    for (int e = tid; e < D; e += NT) su[e] = up[e];
    float4 G[NV];
#pragma unroll
    for (int m = 0; m < NV; ++m) G[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    stage(n_chunks - 1, kR | kK | kDo | kW);
    for (int c = n_chunks - 1; c >= 0; --c) {
      cp_async_wait_all();
      __syncthreads();
      if (c > 0) stage(c - 1, kR | kK | kDo | kW);
      const int t0 = c * kChunk, steps = min(kChunk, a.t_len - t0);
      const T* sr = arr(c, L::st_r);
      const T* sk = arr(c, L::st_k);
      const T* sd = arr(c, L::st_do);
      const float* sw = warr(c);
      step_dots(steps, [&](int s, int e) {
        return to_f32(sr[s * D + e]) * su[e] * to_f32(sk[s * D + e]);
      });
      __syncthreads();
#pragma unroll 4
      for (int s = steps - 1; s >= 0; --s) {
        const float dd = to_f32(sd[s * D + j]);
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < NV; ++m) {
          const int i4 = 4 * (q + kLanes * m);
          acc = dot4(G[m], load4(sk + s * D + i4), acc);
          decay_add(G[m], ld4(sw + s * D + i4), load4(sr + s * D + i4), dd);
        }
        acc = line_sum(acc);
        if (q == 0)
          put(a.dv + out_row + static_cast<size_t>(t0 + s) * D + j,
              fmaf(scal[s], dd, acc));
      }
    }
    return;
  }

  // ---- Rows: row i of S and G; thread q holds columns 4 (q + 8 m) .. + 3.
  const int i = x;
  const float u_i = up[i];
  float* anchors = a.anchors + static_cast<size_t>(bh) * (n_chunks - 1) * D * D;
  float4 S[NV];
#pragma unroll
  for (int m = 0; m < NV; ++m) S[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  // Pass A: S forward over every chunk but the last; the state after chunk
  // c is the anchor of chunk c + 1, stored at slot c.
  if (n_chunks > 1) stage(0, kK | kV | kW);
  for (int c = 0; c + 1 < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();
    if (c + 2 < n_chunks) stage(c + 1, kK | kV | kW);
    const T* sk = arr(c, L::st_k);
    const T* sv = arr(c, L::st_v);
    const float* sw = warr(c);
#pragma unroll 4
    for (int s = 0; s < kChunk; ++s) {
      const float kk = to_f32(sk[s * D + i]), ww = sw[s * D + i];
#pragma unroll
      for (int m = 0; m < NV; ++m)
        decay_add(S[m], ww, kk, load4(sv + s * D + 4 * (q + kLanes * m)));
    }
    float* ap = anchors + (static_cast<size_t>(c) * D + i) * D;
#pragma unroll
    for (int m = 0; m < NV; ++m)
      *reinterpret_cast<float4*>(ap + 4 * (q + kLanes * m)) = S[m];
  }
  __syncthreads();  // every buffer read before pass B restages them

  // Pass B: chunks backwards.  The anchor of the next chunk is read into
  // registers while this one is computed.
  float4 G[NV], A[NV];
  auto read_anchor = [&](int c) {
#pragma unroll
    for (int m = 0; m < NV; ++m)
      A[m] = c == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                    : ld4(anchors + (static_cast<size_t>(c - 1) * D + i) * D +
                          4 * (q + kLanes * m));
  };
#pragma unroll
  for (int m = 0; m < NV; ++m) G[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  float du = 0.f;
  read_anchor(n_chunks - 1);
  stage(n_chunks - 1, kR | kK | kV | kDo | kW);
  for (int c = n_chunks - 1; c >= 0; --c) {
    cp_async_wait_all();
    __syncthreads();
    if (c > 0) stage(c - 1, kR | kK | kV | kDo | kW);
    const int t0 = c * kChunk, steps = min(kChunk, a.t_len - t0);
    const T* sr = arr(c, L::st_r);
    const T* sk = arr(c, L::st_k);
    const T* sv = arr(c, L::st_v);
    const T* sd = arr(c, L::st_do);
    const float* sw = warr(c);
    step_dots(steps, [&](int s, int e) {
      return to_f32(sv[s * D + e]) * to_f32(sd[s * D + e]);
    });
#pragma unroll
    for (int m = 0; m < NV; ++m) S[m] = A[m];
    if (c > 0) read_anchor(c - 1);
    __syncthreads();

    // The chunk forward from its anchor: history, S_{t-1} do_t, dr, du.
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float kk = to_f32(sk[s * D + i]), ww = sw[s * D + i];
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int j4 = 4 * (q + kLanes * m);
        hist[(s * NV + m) * NT + tid] = S[m];
        acc = dot4(S[m], load4(sd + s * D + j4), acc);
        decay_add(S[m], ww, kk, load4(sv + s * D + j4));
      }
      acc = line_sum(acc);
      const float vdo = scal[s], rr = to_f32(sr[s * D + i]);
      if (q == 0)
        put(a.dr + out_row + static_cast<size_t>(t0 + s) * D + i,
            fmaf(u_i * kk, vdo, acc));
      du = fmaf(rr * kk, vdo, du);
    }
    // G backwards over the chunk: G_t v_t (dk) and G_t . S_{t-1} (dw).
#pragma unroll 4
    for (int s = steps - 1; s >= 0; --s) {
      const float rr = to_f32(sr[s * D + i]), ww = sw[s * D + i];
      float acc_k = 0.f, acc_w = 0.f;
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int j4 = 4 * (q + kLanes * m);
        acc_k = dot4(G[m], load4(sv + s * D + j4), acc_k);
        acc_w = dot4(G[m], hist[(s * NV + m) * NT + tid], acc_w);
        decay_add(G[m], ww, rr, load4(sd + s * D + j4));
      }
      acc_k = line_sum(acc_k);
      acc_w = line_sum(acc_w);
      const size_t o = out_row + static_cast<size_t>(t0 + s) * D + i;
      if (q == 1) put(a.dk + o, fmaf(u_i * rr, scal[s], acc_k));
      if (q == 2) a.dw[o] = acc_w;
    }
  }
  if (q == 3) a.du_part[static_cast<size_t>(bh) * D + i] = du;
}

// du[h][i] = sum over b, in order, of the row partials of rows b H + h.
__global__ void du_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ du, int batch, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int b = 0; b < batch; ++b) s += part[static_cast<size_t>(b) * n + e];
  du[e] = s;
}

template <typename T, int D>
int launch(const Args<T>& a, float* du, cudaStream_t stream) {
  constexpr int smem = Smem<T, D>::bytes;
  auto kern = rwkv6_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = 2LL * a.bh * (D / kLines<D>);
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(grid), kThreads<D>, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = a.heads * D;
  du_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(a.du_part, du,
                                                      a.bh / a.heads, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const Args<T>& a, float* du, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(a, du, stream);
    case 64:
      return launch<T, 64>(a, du, stream);
    case 128:
      return launch<T, 128>(a, du, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
Args<T> args(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* dout, void* dr, void* dk, void* dv,
             void* dw, void* du_part, void* anchors, int bh, int heads,
             int t_len, const long long* st) {
  return Args<T>{static_cast<const T*>(r), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(dout),
                 static_cast<const float*>(w), static_cast<const float*>(u),
                 static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
                 static_cast<float*>(dw), static_cast<float*>(du_part),
                 static_cast<float*>(anchors), bh, heads, t_len,
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                 st[8], st[9]};
}

}  // namespace

// r, k, v, dout: (BH, T, D) in f32 (is_bf16 = 0) or bf16 (1), element
// strides (*_bh, *_t), a contiguous last axis, 16-byte aligned rows; w: the
// same in f32; u: contiguous (heads, D) f32.  dr, dk, dv: contiguous
// (BH, T, D) in r's type; dw: contiguous (BH, T, D) f32; du: contiguous
// (heads, D) f32; du_part: (BH, D) f32 scratch; anchors: (BH, ceil(T / 16)
// - 1, D, D) f32 scratch (unused when T <= 16).  D is 32, 64 or 128.  Two
// launches on the stream, no host sync.  Returns cudaErrorInvalidValue for
// shapes it does not take, else cudaGetLastError() after the launches.
// Steps between the states pass A keeps: the anchors workspace is
// (BH, ceil(T / chunk) - 1, D, D) f32.
extern "C" int repro_rwkv6_scan_bwd_chunk() { return kChunk; }

extern "C" int repro_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* dout, void* dr, void* dk, void* dv, void* dw, void* du,
    void* du_part, void* anchors, int is_bf16, int bh, int heads, int t_len,
    int d, long long r_bh, long long r_t, long long k_bh, long long k_t,
    long long v_bh, long long v_t, long long w_bh, long long w_t,
    long long do_bh, long long do_t, void* stream) {
  if (bh < 1 || t_len < 1 || heads < 1 || bh % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[10] = {r_bh, r_t, k_bh, k_t, v_bh,
                            v_t,  w_bh, w_t, do_bh, do_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* duf = static_cast<float*>(du);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(
        d,
        args<__nv_bfloat16>(r, k, v, w, u, dout, dr, dk, dv, dw, du_part,
                            anchors, bh, heads, t_len, st),
        duf, s);
  return launch_d<float>(d,
                         args<float>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                     du_part, anchors, bh, heads, t_len, st),
                         duf, s);
}
