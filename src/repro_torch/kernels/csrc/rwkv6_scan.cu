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
// on a sequential grid axis with S in VMEM scratch.  Two kernels here, one
// launch a call, chosen by the wrapper (kernels/rwkv6.py) from T:
//
// * rwkv6_kernel, the recurrence step by step, for short T (the decode
//   tick): one CTA of 2 D threads owns one row bh and walks all of T with
//   S in registers.  Each thread holds an R x kCols tile of S: kCols = 4
//   adjacent columns and one of kSplit = 8 blocks of D / 8 rows; the 8
//   lanes of a column group are adjacent, so r_t . S closes with three
//   shuffles, and every shared-memory operand a thread reads feeds kCols
//   products.  r, k, u*k, w and v of kChunk steps are staged in shared
//   memory, double-buffered with one __syncthreads per chunk; each thread
//   fetches its share of the chunk after next into registers before it
//   computes the current one.  The bonus sum r_t . (u*k_t) does not depend
//   on S: each warp computes it for a whole chunk at once.  At T = 1 the
//   D x D state read and written per row dominates the bytes.
// * rwkv6_chunk_kernel, the chunked form, for longer T (the forward, a
//   prefill, a later chunk from a carried state); see its section below.
//   Chunks of 64 steps turn 4096 dependent steps into 64 steps of small
//   matrix products, and a CTA per (row, 32 value columns) puts 128 CTAs on
//   the card at B = 1, where the step-by-step kernel runs 64.
//
// What bounds it on this card: per step and row the recurrence does
// ~5 D^2 f32 flops and moves ~4 D elements, so at the forward shape
// (64, 4096, 64) the f32 operations (5.4 GFLOP at 67 TFLOP/s: 0.081 ms)
// bound it before the bytes (201 MB: 0.060 ms).  The step-by-step kernel
// is a serial chain over T with one or two warps per scheduler: the latency
// of one step, not either rate, sets its time, ~27x the bound on an H100
// SXM.  The chunked kernel does ~1.3x the recurrence's flops (A and the
// inter-chunk products) as f32 FMAs on CUDA cores, one CTA of 8 warps an
// SM (its shared memory, up to 218 KB): latency and shared-memory traffic
// within that CTA, not the flops or the bytes, set its time, several
// times the bound (PERF.md).  Probes of other designs on the card (not kept): a
// 512-thread CTA and 3xTF32 mma.sync for the output and state products were
// both slower, the latter also less accurate.
//
// Shared memory: the 8 row blocks of a column group are read in one
// quarter-warp phase; row index i is stored at i + 4 (i / 32), which puts
// the 8 blocks' 16-byte reads in distinct banks for D = 32, 64 and 128.
//
// Numerics: f32 throughout with FMAs, no tensor cores (a TF32 operand's
// 2^-11 rounding would leave outputs of 1-10 ~1e-3 off); sums are taken in
// another order than the plain PyTorch version's, so both kernels agree with
// it to f32 rounding, not bit for bit.  The chunked form takes every decay
// product from its anchor and never divides, so it stays finite at w = 0
// and at the model's fastest decay.  bf16 outputs round to nearest even.

#include <cstdint>
#include <type_traits>
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

// ---------------------------------------------------------------------------
// The chunked form (T > 1).  One CTA of kThreadsC threads per (row bh,
// block of kDv value columns); it walks T in chunks of C steps with its
// D x kDv slice of S in shared memory.  Per chunk, with every product of w
// taken from its anchor, P_{a,b} = prod_{a <= s < b} w_s:
//
//   o_i = (r_i . P_{0,i}) S + sum_{j < i} A_ij v_j + (r_i . (u k_i)) v_i
//   A_ij = sum_d r_i[d] k_j[d] P_{j+1,i}[d]
//   S   <- diag(P_{0,C}) S + sum_j (k_j . P_{j+1,C}) v_j^T
//
// A is cut into sub-chunks of 16 steps.  Diagonal blocks (j, i in one
// sub-chunk) carry P_{j+1,i} along i, element by element.  Off-diagonal
// blocks (J < I, n the start of I, e_J the end of J) are products,
// A_ij = sum_d (r_i P_{n,i}) (k_j P_{j+1,e_J}) G_IJ, with G_IJ the product
// of the whole sub-chunks between.  r_i P_{0,i} and k_j P_{j+1,C} are
// running products from the chunk's ends.  No factor exceeds 1 and none
// is a quotient, so no decay, w = 0 and w = 1 included, can overflow or
// cancel.
//
// The column blocks of one row need the same A: at D >= 64 two of them
// form a cluster.  Each computes half of A's blocks into its own shared
// memory, then copies them into the peer's (st.shared::cluster); the
// cluster barrier is split into arrive and wait so that R-hat S and the
// state update overlap the exchange.  Warps 0-3 compute the outputs while
// warps 4-7 compute the next state, into the other of two S buffers.  The
// next chunk's r, k, w, v rows stream into a staging area by cp.async
// while the current one is computed.  Phases a chunk: (a) staged rows to
// f32, (b) the anchored factors, (c) A's blocks, (d) outputs and (e) the
// state.  Where training asks (a non-null `states`), (a) also stores the
// chunk's S_in for the backward (rwkv6_scan_bwd.cu); the arithmetic is the
// same either way.
// ---------------------------------------------------------------------------

constexpr int kThreadsC = 256;
constexpr int kSub = 16;   // steps per sub-chunk
constexpr int kDv = 32;    // value columns per CTA

template <typename T, int D, int C>
struct ChunkSmem {  // offsets in floats
  static constexpr int P = D + 4;        // row pitch of the (C, D) arrays
  static constexpr int PA = C + 4;       // row pitch of A
  static constexpr int NS = C / kSub;
  static constexpr int r = 0, k = r + C * P, w = k + C * P;
  static constexpr int rt = w + C * P;   // r_i P_{n,i}
  static constexpr int kb = rt + C * P;  // k_j P_{j+1,e_J}
  static constexpr int rh = kb + C * P;  // r_i P_{0,i}
  static constexpr int kh = rh + C * P;  // k_j P_{j+1,C}
  static constexpr int A = kh + C * P;
  static constexpr int v = A + C * PA;
  static constexpr int S = v + C * kDv;  // two (D, kDv) buffers: S in, S out
  static constexpr int u = S + 2 * D * kDv;
  static constexpr int gam = u + D;      // (NS, D) sub-chunk products
  static constexpr int gall = gam + NS * D;  // P_{0,C}
  static constexpr int stage = gall + D;
  // The next chunk as it lies in memory, copied by cp.async: r, k (C, D)
  // in T, w (C, D) f32, v (C, kDv) in T; offsets in bytes from stage.
  static constexpr int st_r = 0, st_k = st_r + C * D * sizeof(T);
  static constexpr int st_w = st_k + C * D * sizeof(T);
  static constexpr int st_v = st_w + C * D * 4;
  static constexpr int st_bytes = st_v + C * kDv * sizeof(T);
  static constexpr size_t bytes = sizeof(float) * stage + st_bytes;
  static_assert(stage % 4 == 0 && st_bytes % 16 == 0, "16-byte alignment");
  static_assert(bytes <= 232448, "fits the shared memory of one CTA");
};

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

__device__ inline unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The cluster barrier in two halves, each executed by every thread of
// every CTA of the cluster: shared-memory writes before an arrive, the
// peer's included, are visible after the matching wait.
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of p's counterpart in the shared memory of CTA `rank`.
__device__ inline unsigned peer_addr(const float* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return out;
}
__device__ inline void st_peer4(unsigned addr, const float4& x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}

// Copy rows t0 .. t0 + C - 1 (those before t_len) of a (T, W) array with
// row stride ld elements into dst, 16 bytes a copy.
template <typename E, int W, int C>
__device__ inline void stage_rows(char* dst, const E* src, long long ld,
                                  int t0, int t_len, int tid) {
  constexpr int per_row = W * static_cast<int>(sizeof(E)) / 16;
  for (int p = tid; p < C * per_row; p += kThreadsC) {
    const int row = p / per_row, q = p % per_row;
    if (t0 + row < t_len)
      cp_async16(dst + (row * per_row + q) * 16,
                 src + ld * (t0 + row) + q * (16 / sizeof(E)));
  }
}

// Four staged values as f32.
__device__ inline float4 load4(const float* p) { return ld4(p); }
__device__ inline float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ inline float4 mul4(const float4& a, const float4& b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ inline float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ inline float4 fma4(float a, const float4& b, const float4& c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z),
                     fmaf(a, b.w, c.w));
}

__device__ inline float4 scale4(float a, const float4& b) {
  return make_float4(a * b.x, a * b.y, a * b.z, a * b.w);
}

__device__ inline void put4(float* p, const float4& x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ inline void put4(__nv_bfloat16* p, const float4& x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// CTAs that share A: two column blocks of one row, where there are two.
template <int D>
constexpr int kCluster = D / kDv >= 2 ? 2 : 1;

template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreadsC, 1)
rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   T* __restrict__ out, float* __restrict__ s_out,
                   float* __restrict__ states, int heads, int t_len,
                   long long r_bh, long long r_t, long long k_bh,
                   long long k_t, long long v_bh, long long v_t,
                   long long w_bh, long long w_t) {
  using L = ChunkSmem<T, D, C>;
  constexpr int P = L::P, PA = L::PA, NS = L::NS;
  constexpr int NB = D / kDv;               // column blocks per row
  constexpr int CL = kCluster<D>;
  constexpr int DPT = D / 16;               // state rows per thread in (e)
  constexpr int DL = D / 4 < 16 ? D / 4 : 16;  // diagonal lanes per (I, j)
  constexpr int NQ = D / (4 * DL);          // channel quads per such lane
  constexpr int JW = 32 / DL;               // j per warp in the diagonal
  constexpr int TPI = kSub * DL;            // diagonal lanes per sub-chunk
  static_assert(D % kDv == 0 && (C == 32 || C == 64) && NS % CL == 0
                    && kThreadsC == 256 && kDv == 32,
                "tile shapes");
  extern __shared__ __align__(16) float sm[];
  float* sr = sm + L::r;
  float* sk = sm + L::k;
  float* sw = sm + L::w;
  float* srt = sm + L::rt;
  float* skb = sm + L::kb;
  float* srh = sm + L::rh;
  float* skh = sm + L::kh;
  float* sA = sm + L::A;
  float* sv = sm + L::v;
  float* sS = sm + L::S;
  float* su = sm + L::u;
  float* sg = sm + L::gam;
  float* sgall = sm + L::gall;
  char* stg = reinterpret_cast<char*>(sm + L::stage);
  const T* gr = reinterpret_cast<const T*>(stg + L::st_r);
  const T* gk = reinterpret_cast<const T*>(stg + L::st_k);
  const float* gw = reinterpret_cast<const float*>(stg + L::st_w);
  const T* gv = reinterpret_cast<const T*>(stg + L::st_v);

  const int bh = blockIdx.x / NB;
  const int c0 = (blockIdx.x % NB) * kDv;
  const int tid = threadIdx.x;
  const unsigned rank = CL > 1 ? cluster_rank() : 0;
  const T* rp = r + r_bh * bh;
  const T* kp = k + k_bh * bh;
  const T* vp = v + v_bh * bh + c0;
  const float* wp = w + w_bh * bh;

  // The chunk from t0 into the stage, in flight behind the compute.
  auto stage = [&](int t0) {
    stage_rows<T, D, C>(stg + L::st_r, rp, r_t, t0, t_len, tid);
    stage_rows<T, D, C>(stg + L::st_k, kp, k_t, t0, t_len, tid);
    stage_rows<float, D, C>(stg + L::st_w, wp, w_t, t0, t_len, tid);
    stage_rows<T, kDv, C>(stg + L::st_v, vp, v_t, t0, t_len, tid);
    cp_async_commit();
  };
  stage(0);
  for (int i = tid; i < D; i += kThreadsC) su[i] = u[(bh % heads) * D + i];
  for (int e = tid; e < D * kDv; e += kThreadsC) {
    const int d = e / kDv, c = e % kDv;
    sS[e] = s0 != nullptr ? s0[(static_cast<size_t>(bh) * D + d) * D + c0 + c]
                          : 0.f;
  }

  const int n_chunks = (t_len + C - 1) / C;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * C;
    // (a) The staged chunk into f32 rows; steps past t_len read as
    // r = k = v = 0, w = 1, which leave S as it was.  Then stage the next.
    cp_async_wait_all();
    __syncthreads();
    // This CTA has left A V of the last chunk: the peer may write its A.
    if constexpr (CL > 1) cluster_arrive();
    if (states != nullptr && ch > 0) {
      // Training's backward: the state at this chunk's start, S_in, whole
      // since the barrier above, into slot ch - 1 of the chunk states.
      const float* s_in = sS + (ch & 1) * D * kDv;
      float* sp = states + (static_cast<size_t>(bh) * (n_chunks - 1) + ch - 1)
                               * D * D + c0;
      for (int e = 4 * tid; e < D * kDv; e += 4 * kThreadsC)
        put4(sp + (e / kDv) * D + e % kDv, ld4(s_in + e));
    }
#pragma unroll
    for (int e = 4 * tid; e < C * D; e += 4 * kThreadsC) {
      const int row = e / D, col = e % D;
      const bool in = t0 + row < t_len;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sr + row * P + col) = in ? load4(gr + e) : z;
      *reinterpret_cast<float4*>(sk + row * P + col) = in ? load4(gk + e) : z;
      *reinterpret_cast<float4*>(sw + row * P + col) =
          in ? load4(gw + e) : make_float4(1.f, 1.f, 1.f, 1.f);
    }
#pragma unroll
    for (int e = 4 * tid; e < C * kDv; e += 4 * kThreadsC) {
      const bool in = t0 + e / kDv < t_len;
      *reinterpret_cast<float4*>(sv + e) =
          in ? load4(gv + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (ch + 1 < n_chunks) stage(t0 + C);

    // (b) Anchored factors per channel d, two roles, each reading its rows
    // once: r_i P_{n,i} forward from each sub-chunk's start (and gam_J =
    // P over sub-chunk J) beside r_i P_{0,i} forward from the chunk's start
    // (and P_{0,C}); k_j P_{j+1,e_J} backward from each sub-chunk's end
    // beside k_j P_{j+1,C} backward from the chunk's end.
    for (int task = tid; task < 2 * D; task += kThreadsC) {
      const int d = task % D;
      if (task < D) {
        float p = 1.f;
#pragma unroll
        for (int J = 0; J < NS; ++J) {
          float q = 1.f;
#pragma unroll
          for (int s = J * kSub; s < (J + 1) * kSub; ++s) {
            const float rr = sr[s * P + d], ww = sw[s * P + d];
            srt[s * P + d] = rr * q;
            srh[s * P + d] = rr * p;
            q *= ww;
            p *= ww;
          }
          sg[J * D + d] = q;
        }
        sgall[d] = p;
      } else {
        float p = 1.f;
#pragma unroll
        for (int J = NS - 1; J >= 0; --J) {
          float q = 1.f;
#pragma unroll
          for (int s = (J + 1) * kSub - 1; s >= J * kSub; --s) {
            const float kk = sk[s * P + d], ww = sw[s * P + d];
            skb[s * P + d] = kk * q;
            skh[s * P + d] = kk * p;
            q *= ww;
            p *= ww;
          }
        }
      }
    }
    __syncthreads();

    // (c) A's blocks, the diagonal ones of sub-chunks I = rank mod CL and
    // every CL-th off-diagonal one.  Diagonal: lane (I, j, dq) sums A_ij
    // for every i of sub-chunk I over the channel quads DL q + dq (the DL
    // lanes of a row read adjacent banks), carrying P_{j+1,i} along i;
    // i == j takes the bonus r_j . (u k_j).  A warp holds JW consecutive
    // j, so the rows i below its first j are zero and skipped; a thread's
    // second pass takes j in reverse, so every thread walks about as many
    // rows.
    for (int task = tid; task < (NS / CL) * TPI; task += kThreadsC) {
      const int jf = (task / DL) % kSub;
      const int j = (task / kThreadsC) & 1 ? kSub - 1 - jf : jf;
      const int I = task / TPI * CL + rank, dq = task % DL;
      const int n = I * kSub, i_lo = j & ~(JW - 1);
      float acc[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) acc[i] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int d4 = (DL * q + dq) * 4;
        const float4 kj = ld4(sk + (n + j) * P + d4);
        const float4 uk = mul4(kj, ld4(su + d4));
        // p = P_{j+1,i} for i > j, 0 for i <= j; e = [i == j] adds the
        // bonus at i == j and starts p there (fmaf(0, x, y) is y exactly).
        float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          if (i < i_lo) continue;
          const float e = i == j ? 1.f : 0.f;
          const float4 rr = ld4(sr + (n + i) * P + d4);
          const float4 ww = ld4(sw + (n + i) * P + d4);
          acc[i] = dot4(rr, fma4(e, uk, mul4(kj, p)), acc[i]);
          p = make_float4(fmaf(p.x, ww.x, e), fmaf(p.y, ww.y, e),
                          fmaf(p.z, ww.z, e), fmaf(p.w, ww.w, e));
        }
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int o = 1; o < DL; o <<= 1)
          acc[i] += __shfl_xor_sync(kAll, acc[i], o);
      if (dq == 0) {
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          sA[(n + i) * PA + n + j] = i >= j ? acc[i] : 0.f;
      }
    }
    // Off-diagonal: lane (a, b) sums A[16 I + a][16 J + b] of this CTA's
    // block pairs (every CL-th, from its rank) at once, one independent
    // chain each, times the whole sub-chunks between J and I.
    auto off_diagonal = [&](auto rank_c) {
      constexpr int NP = NS * (NS - 1) / 2;
      constexpr int R = decltype(rank_c)::value;
      const int a = tid >> 4, b = tid & 15;
      auto mine = [](int x) { return x % CL == R; };
      float acc[NP];
#pragma unroll
      for (int x = 0; x < NP; ++x) acc[x] = 0.f;
#pragma unroll 2
      for (int d4 = 0; d4 < D; d4 += 4) {
        float4 ri[NS], kj[NS], gm[NS];
#pragma unroll
        for (int I = 1; I < NS; ++I) ri[I] = ld4(srt + (I * kSub + a) * P + d4);
#pragma unroll
        for (int J = 0; J + 1 < NS; ++J)
          kj[J] = ld4(skb + (J * kSub + b) * P + d4);
#pragma unroll
        for (int M = 1; M + 1 < NS; ++M) gm[M] = ld4(sg + M * D + d4);
        int x = 0;
#pragma unroll
        for (int I = 1; I < NS; ++I) {
#pragma unroll
          for (int J = 0; J < I; ++J, ++x) {
            if (!mine(x)) continue;
            float4 g = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
            for (int M = J + 1; M < I; ++M) g = mul4(g, gm[M]);
            acc[x] = dot4(ri[I], J + 1 == I ? kj[J] : mul4(kj[J], g), acc[x]);
          }
        }
      }
      int x = 0;
#pragma unroll
      for (int I = 1; I < NS; ++I)
#pragma unroll
        for (int J = 0; J < I; ++J, ++x)
          if (mine(x)) sA[(I * kSub + a) * PA + J * kSub + b] = acc[x];
    };
    if constexpr (NS > 1) {
      if (rank == 0) off_diagonal(std::integral_constant<int, 0>{});
      else if constexpr (CL > 1) off_diagonal(std::integral_constant<int, 1>{});
    }
    __syncthreads();
    if constexpr (CL > 1) {
      // Once the peer has left A V of the last chunk, copy this CTA's
      // blocks of A into its sA, 64 float4 a block, every fourth block to
      // each quarter of the threads.
      cluster_wait();
      const unsigned peer_A = peer_addr(sA, rank ^ 1);
      int blk = 0;
#pragma unroll
      for (int I = 0; I < NS; ++I)
#pragma unroll
        for (int J = 0; J <= I; ++J) {
          const int x = J == I ? I : I * (I - 1) / 2 + J;
          if (x % CL != static_cast<int>(rank)) continue;
          if (blk++ % 4 == tid / 64) {
            const int q = tid % 64, row = kSub * I + q / 4;
            const int col = kSub * J + 4 * (q % 4);
            st_peer4(peer_A + 4 * (row * PA + col), ld4(sA + row * PA + col));
          }
        }
      cluster_arrive();
    }

    // (d) Outputs and the next state at once, from S_in = sS[ch & 1] into
    // S_out = sS[(ch + 1) & 1].
    const float* s_in = sS + (ch & 1) * D * kDv;
    float* s_nx = sS + ((ch + 1) & 1) * D * kDv;
    // Warps 0-3, outputs: rows 16 m + rq, one in each sub-chunk m (so every
    // thread has as many keys), columns 4 cq .. 4 cq + 3; R-hat S first,
    // while the peer's blocks of A arrive.
    const int rq = (tid >> 3) & 15, cq = tid & 7;
    float4 y[NS];
    if (tid < kThreadsC / 2) {
#pragma unroll
      for (int m = 0; m < NS; ++m) y[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 sv4[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) sv4[x] = ld4(s_in + (d + x) * kDv + 4 * cq);
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          const float4 rr = ld4(srh + (kSub * m + rq) * P + d);
          y[m] = fma4(rr.x, sv4[0], y[m]);
          y[m] = fma4(rr.y, sv4[1], y[m]);
          y[m] = fma4(rr.z, sv4[2], y[m]);
          y[m] = fma4(rr.w, sv4[3], y[m]);
        }
      }
    } else {
      // (e) Warps 4-7, the state: rows [DPT dq, DPT dq + DPT), columns
      // 4 cq .. 4 cq + 3: S_out = diag(P_{0,C}) S_in + K-hat^T V.
      const int d0 = ((tid - kThreadsC / 2) >> 3) * DPT;
      float4 acc[DPT];
#pragma unroll
      for (int m = 0; m < DPT; ++m)
        acc[m] = scale4(sgall[d0 + m], ld4(s_in + (d0 + m) * kDv + 4 * cq));
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        const float4 vv = ld4(sv + j * kDv + 4 * cq);
        float kk[DPT];
#pragma unroll
        for (int m = 0; m < DPT; m += 2) {
          const float2 k2 = *reinterpret_cast<const float2*>(
              skh + j * P + d0 + m);
          kk[m] = k2.x;
          kk[m + 1] = k2.y;
        }
#pragma unroll
        for (int m = 0; m < DPT; ++m) acc[m] = fma4(kk[m], vv, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < DPT; ++m)
        *reinterpret_cast<float4*>(s_nx + (d0 + m) * kDv + 4 * cq) = acc[m];
    }
    if constexpr (CL > 1) cluster_wait();  // A is whole
    if (tid < kThreadsC / 2) {
      // Keys of sub-chunk jb reach rows of sub-chunks m >= jb only.
#pragma unroll
      for (int jb = 0; jb < NS; ++jb) {
#pragma unroll 2
        for (int j = jb * kSub; j < (jb + 1) * kSub; j += 4) {
          float4 vv[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) vv[x] = ld4(sv + (j + x) * kDv + 4 * cq);
#pragma unroll
          for (int m = jb; m < NS; ++m) {
            const float4 aa = ld4(sA + (kSub * m + rq) * PA + j);
            y[m] = fma4(aa.x, vv[0], y[m]);
            y[m] = fma4(aa.y, vv[1], y[m]);
            y[m] = fma4(aa.z, vv[2], y[m]);
            y[m] = fma4(aa.w, vv[3], y[m]);
          }
        }
      }
      T* op = out + (static_cast<size_t>(bh) * t_len + t0) * D + c0 + 4 * cq;
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const int i = kSub * m + rq;
        if (t0 + i < t_len) put4(op + static_cast<size_t>(i) * D, y[m]);
      }
    }
  }
  __syncthreads();
  const float* s_end = sS + (n_chunks & 1) * D * kDv;

  if (s_out != nullptr) {
    for (int e = tid; e < D * kDv; e += kThreadsC) {
      const int d = e / kDv, c = e % kDv;
      s_out[(static_cast<size_t>(bh) * D + d) * D + c0 + c] = s_end[e];
    }
  }
}

template <typename T, int D, int C>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* out,
                   void* s_out, void* states, int bh, int heads, int t_len,
                   const long long* st, cudaStream_t stream) {
  constexpr size_t smem = ChunkSmem<T, D, C>::bytes;
  auto kern = rwkv6_chunk_kernel<T, D, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(bh) * (D / kDv);
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreadsC);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster<D>;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_out),
      static_cast<float*>(states), heads, t_len, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7]);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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

// The chunked form, with the arguments of repro_rwkv6_scan, the chunk
// states and the chunk length: 64 steps at D = 32 and 64, 32 at D = 128
// (shared memory).  states: contiguous (BH, ceil(T / chunk) - 1, D, D)
// f32, the state at the start of every chunk but the first, for
// training's backward; null (serving) writes nothing.  r, k, v, w must be
// 16-byte aligned with strides of whole 16-byte units.  One launch on the
// stream, no host sync.
extern "C" int repro_rwkv6_scan_chunked(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, void* out, void* s_out, void* states, int is_bf16,
    int bh, int heads, int t_len, int d, int chunk, long long r_bh,
    long long r_t, long long k_bh, long long k_t, long long v_bh,
    long long v_t, long long w_bh, long long w_t, void* stream) {
  if (bh < 1 || t_len < 1 || heads < 1 || bh % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {r_bh, r_t, k_bh, k_t, v_bh, v_t, w_bh, w_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CHUNKED(T, D, C)                                              \
  if (d == D && chunk == C)                                                 \
    return launch_chunked<T, D, C>(r, k, v, w, u, s0, out, s_out, states,  \
                                   bh, heads, t_len, st, s);
  if (is_bf16) {
    REPRO_CHUNKED(__nv_bfloat16, 32, 64)
    REPRO_CHUNKED(__nv_bfloat16, 64, 64)
    REPRO_CHUNKED(__nv_bfloat16, 128, 32)
  } else {
    REPRO_CHUNKED(float, 32, 64)
    REPRO_CHUNKED(float, 64, 64)
    REPRO_CHUNKED(float, 128, 32)
  }
#undef REPRO_CHUNKED
  return static_cast<int>(cudaErrorInvalidValue);
}
