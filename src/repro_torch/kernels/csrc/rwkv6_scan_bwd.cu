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
// The chunked backward.  T is cut into the forward's chunks of C steps
// (kernels/rwkv6.py::CHUNK, passed in); the forward's chunk kernel stores
// the state S_in at the start of every chunk but the first (the "states",
// (BH, ceil(T / C) - 1, D, D) f32), so nothing here runs S over T.  With
// P_{a,b} = prod_{a <= s < b} w_s inside a chunk and G_out the adjoint
// after it, three launches:
//
// * rwkv6_bwd_carry_kernel, G's carry over chunks, backwards: G_in =
//   diag(P_{0,C}) G_out + sum_i (r_i P_{0,i}) do_i^T, the forward's state
//   update transposed.  The only launch serial in T, over T / C chunks; a
//   CTA per (row, 32 columns of G), since the columns are independent:
//   4 D threads update G (4 x 2 each), 256 more stage the chunks by
//   cp.async in a ring of three and make the next chunk's r_i P_{0,i}
//   (each channel's running product cut into segments) beside the
//   update.  It writes each chunk's G_out (the "G states", shaped as the
//   states).
// * rwkv6_bwd_chunk_kernel, every chunk at once: persistent CTAs walk the
//   (row, chunk) items.  From S_in, G_out and the chunk's rows, with the
//   forward's sub-chunks of 16 steps and every decay taken as a product of
//   anchored factors (r_i P_{n,i} from a sub-chunk's start n, k_j P_{j+1,e}
//   to its end e, gam_J = P over sub-chunk J, and products of whole
//   sub-chunks between), never a quotient:
//     M_ab = v_a . do_b;  A_ba = sum_d r_b k_a P_{a+1,b} (the forward's A)
//     dv_a = G_out^T (k_a P_{a+1,C}) + sum_{b>a} A_ba do_b + z_a do_a
//     dr_b = S_{b-1} do_b, dk_a = G_a v_a, each split into what comes
//       before the sub-chunk K of the step (S_in and earlier sub-chunks:
//       "Yb", one (C, D) product per sub-chunk pair), after it (G_out and
//       later sub-chunks: "Za") and the pairs inside K (running products).
//   dw is the direct sum rowsum(G_t * S_{t-1}), expanded on the anchored
//   factors (form (a)): S_{t-1} and G_t are sums over S_in and the chunk's
//   k_a v_a^T, and over G_out and r_b do_b^T, so dw_t is a bilinear form in
//   the inner products sigma = rowsum(S_in * G_out), G_out v_a, S_in do_b
//   and M_ab, every factor of it an anchored product (none is w_t).  The
//   pairs that straddle K fold into Yb, Za and one vector X_K per
//   sub-chunk; the pairs inside K run step by step beside dr and dk.  Form
//   (a) and not a step-by-step sweep, because a sweep needs S and G at one
//   step, so the whole D x D history of a chunk, or S run twice.  It never
//   goes through the cumulative-decay identity, which cancels to w dw and
//   loses log10(1/w) digits (tests/test_torch_train_kernels.py measures
//   it), so dw is exact at w = 0.
// * du_sum_kernel: du's partials of each (row, chunk), summed over chunks
//   and then rows in a fixed order.  No atomics anywhere: a call gives the
//   same bits each time.
//
// The chunk kernel: one CTA of 512 threads (16 warps, 128 registers
// each) per SM, persistent over the items, with 205,568 bytes of shared
// memory at D = 64 (184,960 at D = 128): the chunk's rows in f32 with a
// padded pitch, the factors, Yb, Za, and M and A in one (C, C) array (M on
// and above the diagonal, A below).  Four phases a chunk between
// barriers: (1) the factors beside A's diagonal blocks and M; (2) Yb and
// Za as 4 x 4 register tiles (S_in do and G_out v, then the sub-chunk
// pairs), A's off-diagonal blocks, G_out^T k^; (3) dv; (4) the steps of
// each (sub-chunk, channel).  Each operand read from shared memory feeds 4
// products.  Where the states fit (D <= C) S_in and G_out are staged by
// cp.async behind phase 1, their 16-byte chunks swizzled by row so that
// the products' reads of rows 4 apart fall in distinct banks; at D = 128
// they are read through the L1.  In bf16 the next item's rows stream in
// behind phase 4, issued by the threads without a step task, into arrays
// phase 4 does not read (converted at the next item's start); f32 rows
// load at the item's start.  Everything that touches a state or a decay
// is f32 on the CUDA cores (a TF32 operand would miss the 1e-5 f32 hold);
// no tensor cores.
//
// What bounds it on this card: per step and row the function does
// 10 D^2 + 12 D f32 flops (kernels/rwkv6.py::work_bwd) and moves ~7 D
// elements, so at (64, 2048, 64) the f32 operations (5.4 GFLOP at
// 67 TFLOP/s: 0.082 ms) bound it.  This design executes ~14 D^2 a row-step
// (the carry 2 D^2, three (C, D, D) products 6 D^2, M, A, dv's and the
// blocked pair sums ~6 D^2 at C = D = 64) as f32 FMAs; shared-memory
// traffic and the phases' barriers keep it several times off the bound:
// 0.563 ms at (64, 2048, 64) bf16 on an H100 80GB HBM3 at 700 W
// (PERF.md), phase 2 the longest.  Scratch: the G states, (BH, ceil(T /
// C) - 1, D, D) f32, plus D floats a row; du's partial of chunk c goes
// into row 0 of chunk c's G state once that chunk's CTA has read it.
//
// Numerics: f32 throughout, FMAs; sums in another order than the plain
// version's (kernels/rwkv6.py::rwkv6_scan_bwd_plain, which rebuilds S step
// by step itself).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;     // chunk kernel
constexpr int kEb = 32;           // G columns per carry CTA
constexpr int kFac = 256;         // its staging and factor threads
constexpr int kSub = 16;          // steps per sub-chunk
constexpr unsigned kAll = 0xffffffffu;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void put(float* p, float x) { *p = x; }
__device__ inline void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline void st4(float* p, const float4& x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ inline float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ inline float4 mul4(const float4& a, const float4& b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ inline float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ inline float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}
// Four staged bf16 values of a row as f32.
__device__ inline float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ inline float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ inline float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ inline void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ inline void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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
__device__ inline void cp_async_wait_group1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// A barrier of the first n threads' warps (n a multiple of 32), id > 0.
__device__ inline void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Rows t0 .. t0 + n - 1 (n of them before t_len) of a (T, W) array with
// row stride ld elements into dst, row pitch `pitch` bytes, 16 bytes a
// copy; rows at or past t_len are filled with `pad` (w = 1 and r = k =
// v = do = 0 leave S and G as they were).
template <typename E, int W>
__device__ inline void stage_rows(unsigned char* dst, int pitch, const E* src,
                                  long long ld, int n, int valid, E pad,
                                  int tid, int nt) {
  constexpr int per_row = W * static_cast<int>(sizeof(E)) / 16;
  constexpr int per16 = 16 / static_cast<int>(sizeof(E));
  for (int p = tid; p < n * per_row; p += nt) {
    const int row = p / per_row, q = p % per_row;
    unsigned char* d = dst + row * pitch + q * 16;
    if (row < valid) {
      cp_async16(d, src + ld * row + q * per16);
    } else {
      E* e = reinterpret_cast<E*>(d);
#pragma unroll
      for (int x = 0; x < per16; ++x) e[x] = pad;
    }
  }
}

template <typename T>
struct Args {
  const T *r, *k, *v, *dout;
  const float *w, *u, *states;
  T *dr, *dk, *dv;
  float *dw, *gst, *du_tail;
  int bh, heads, t_len;
  long long r_bh, r_t, k_bh, k_t, v_bh, v_t, w_bh, w_t, do_bh, do_t;
};

__device__ inline float pad_of(float) { return 0.f; }
__device__ inline __nv_bfloat16 pad_of(__nv_bfloat16) {
  return __float2bfloat16_rn(0.f);
}

// ---------------------------------------------------------------------------
// Launch 1: G's carry over chunks, backwards.
// ---------------------------------------------------------------------------

template <typename T, int D, int C>
struct CarrySmem {  // byte offsets: three staging buffers, two of r P_{0,i}
  static constexpr int st_r = 0;
  static constexpr int st_w = st_r + C * D * static_cast<int>(sizeof(T));
  static constexpr int st_o = st_w + C * D * 4;
  static constexpr int st_bytes = st_o + C * kEb * static_cast<int>(sizeof(T));
  static constexpr int rh = 3 * st_bytes;           // 2 x (C, D) f32
  static constexpr int gall = rh + 2 * C * D * 4;   // 2 x D floats: P_{0,C}
  static constexpr int seg = gall + 2 * D * 4;      // (kFac / D, D) floats
  static constexpr int bytes = seg + kFac * 4;
  static_assert(st_o % 16 == 0 && st_bytes % 16 == 0, "16-byte alignment");
  static_assert(bytes <= 232448, "fits the shared memory of one CTA");
};

// 4 D threads hold G's kEb columns as 4 x 2 tiles; kFac more stage the
// chunks and make their factors, kFac / D of them a channel, each over a
// segment of the chunk.
template <int D>
constexpr int kThreadsG = 4 * D + kFac;

template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreadsG<D>, 1)
rwkv6_bwd_carry_kernel(const Args<T> a) {
  using L = CarrySmem<T, D, C>;
  constexpr int SEG = kFac / D, LEN = C / SEG;  // segments a channel, steps
  static_assert(kEb == 32 && 4 * D * 8 == D * kEb, "4 x 2 tiles");
  static_assert(SEG * LEN == C && kFac % 32 == 0, "segments");
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x;
  const bool tile = tid < 4 * D;
  const int f = tid - 4 * D;                 // index of a factor thread
  const int fd = f % D, fq = f / D;          // its channel and segment
  const int bh = blockIdx.x / (D / kEb);
  const int cb = (blockIdx.x % (D / kEb)) * kEb;
  const int d0 = 4 * (tid / (kEb / 2)), e0 = 2 * (tid % (kEb / 2));
  const int n = (a.t_len + C - 1) / C;
  const T* rp = a.r + a.r_bh * bh;
  const float* wp = a.w + a.w_bh * bh;
  const T* op = a.dout + a.do_bh * bh + cb;
  float* seg = reinterpret_cast<float*>(sm + L::seg);

  // Chunk c into staging buffer c % 3, by the factor threads.
  auto stage = [&](int c) {
    unsigned char* b = sm + (c % 3) * L::st_bytes;
    const int t0 = c * C, valid = min(C, a.t_len - t0);
    stage_rows<T, D>(b + L::st_r, D * sizeof(T), rp + a.r_t * t0, a.r_t, C,
                     valid, pad_of(T()), f, kFac);
    stage_rows<float, D>(b + L::st_w, D * 4, wp + a.w_t * t0, a.w_t, C,
                         valid, 1.f, f, kFac);
    stage_rows<T, kEb>(b + L::st_o, kEb * sizeof(T), op + a.do_t * t0,
                       a.do_t, C, valid, pad_of(T()), f, kFac);
    cp_async_commit();
  };
  // Once chunk c has landed (the factor threads' copies; `pending`: later
  // groups still in flight), r_i P_{0,i} and P_{0,C} into buffer c & 1:
  // each segment's running product of w, then times the earlier
  // segments' products.
  auto factors = [&](int c, bool pending) {
    if (pending) {
      cp_async_wait_group1();
    } else {
      cp_async_wait_all();
    }
    bar_sync(1, kFac);
    const unsigned char* b = sm + (c % 3) * L::st_bytes;
    const T* sr = reinterpret_cast<const T*>(b + L::st_r);
    const float* sw = reinterpret_cast<const float*>(b + L::st_w);
    float* rh = reinterpret_cast<float*>(sm + L::rh) + (c & 1) * C * D;
    // Every load ahead of the stores, which the compiler may not move
    // them across (the arrays share one shared-memory base).
    const int s0 = fq * LEN;
    float x[LEN];
#pragma unroll
    for (int s = 0; s < LEN; ++s) x[s] = sw[(s0 + s) * D + fd];
    float p = 1.f;
#pragma unroll
    for (int s = 0; s < LEN; ++s) {
      const float ws = x[s];
      x[s] = p;
      p *= ws;
    }
    seg[fq * D + fd] = p;
    bar_sync(1, kFac);
    float before = 1.f;
    for (int q = 0; q < fq; ++q) before *= seg[q * D + fd];
#pragma unroll
    for (int s = 0; s < LEN; ++s)
      rh[(s0 + s) * D + fd] = to_f32(sr[(s0 + s) * D + fd]) * (before * x[s]);
    if (fq == SEG - 1)
      reinterpret_cast<float*>(sm + L::gall)[(c & 1) * D + fd] = before * p;
  };

  float G[4][2] = {};
  if (!tile) {
    stage(n - 1);
    if (n > 2) stage(n - 2);
    factors(n - 1, n > 2);
  }
  // Chunk c: G_in = diag(P_{0,C}) G_out + sum_i (r_i P_{0,i}) do_i^T, from
  // its factors (made the iteration before) while the factor threads stage
  // chunk c - 2 and make chunk c - 1's.
  for (int c = n - 1; c >= 1; --c) {
    __syncthreads();   // chunk c's factors and rows are whole
    if (!tile) {
      if (c > 2) stage(c - 2);
      if (c > 1) factors(c - 1, c > 2);
      continue;
    }
    const float* rh = reinterpret_cast<const float*>(sm + L::rh) +
                      (c & 1) * C * D;
    const float4 g4 = ld4(reinterpret_cast<const float*>(sm + L::gall) +
                          (c & 1) * D + d0);
    const T* so = reinterpret_cast<const T*>(sm + (c % 3) * L::st_bytes +
                                             L::st_o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      G[i][0] *= comp(g4, i);
      G[i][1] *= comp(g4, i);
    }
#pragma unroll 4
    for (int s = 0; s < C; ++s) {
      const float4 rr = ld4(rh + s * D + d0);
      const float2 oo = load2(so + s * kEb + e0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        G[i][0] = fmaf(comp(rr, i), oo.x, G[i][0]);
        G[i][1] = fmaf(comp(rr, i), oo.y, G[i][1]);
      }
    }
    float* gp = a.gst + (static_cast<size_t>(bh) * (n - 1) + c - 1) * D * D +
                cb + e0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float2*>(gp + static_cast<size_t>(d0 + i) * D) =
          make_float2(G[i][0], G[i][1]);
  }
}

// ---------------------------------------------------------------------------
// Launch 2: every chunk at once.
// ---------------------------------------------------------------------------

template <typename T, int D, int C>
struct ChunkSmem {  // offsets in floats
  static constexpr int P = D + 4;    // pitch of the (C, D) arrays
  static constexpr int PC = C + 4;   // pitch of M and A
  static constexpr int NS = C / kSub;
  static constexpr int NP2 = (NS - 1) * (NS - 2) / 2;  // pairs J + 2 <= I
  static constexpr int r = 0, k = r + C * P, w = k + C * P;
  static constexpr int v = w + C * P;
  static constexpr int o = v + C * P;    // do
  // The factors; in bf16, once read, the next item's rows: r, k, v, do as
  // they lie in memory into rt and kb, w into kh.
  static constexpr int rt = o + C * P;   // r_b P_{n_I,b}
  static constexpr int kb = rt + C * P;  // k_a P_{a+1,e_J}
  static constexpr int kh = kb + C * P;  // k_a P_{a+1,C}
  // S_in, then what reaches row b from before its sub-chunk (Yb); G_out,
  // then what reaches row a from after (Za).  The states are staged here
  // where they fit, D <= C.
  static constexpr int yb = kh + C * P;
  static constexpr int za = yb + C * P;
  // (C, C): M[a][b] = v_a . do_b where a <= b, A[b][a] (the forward's)
  // where b > a; each is read on its own side of the diagonal only.
  static constexpr int MA = za + C * P;
  static constexpr int gam = MA + C * PC;  // (NS, D) sub-chunk products
  static constexpr int u = gam + NS * D;
  static constexpr int z = u + D;        // C: r_a . (u k_a)
  static constexpr int sig = z + C;      // D: rowsum(S_in * G_out)
  static constexpr int phy = sig + D;    // (C / 4, D): rows' r~ . (S_in do)
  static constexpr int phz = phy + (C / 4) * D;  // rows' k~ . (G_out v)
  static constexpr int phj = phz + (C / 4) * D;  // (NP2, 4, D): k~ M r~
  static constexpr int dup = phj + NP2 * 4 * D;  // (NS, D): du
  static constexpr int floats = dup + NS * D;
  static constexpr size_t bytes = sizeof(float) * floats;
  static_assert(P % 4 == 0 && PC % 4 == 0 && floats % 4 == 0, "alignment");
  static_assert(4 * C * D * sizeof(T) <= 2 * C * P * sizeof(float) ||
                    sizeof(T) == 4,
                "bf16 rows stage into rt and kb");
  static_assert(bytes <= 232448, "fits the shared memory of one CTA");
};

// A staged state (D x D f32, pitch P = D + 4): element (row, col) at row
// P + its 16-byte chunk XOR (row / 4) % 8.  Reads of rows 4 apart, the
// (C, D) products' pattern, then fall in distinct banks.
template <int D>
__device__ inline int st_off(int row, int col) {
  return row * (D + 4) + ((((col >> 2) ^ (row >> 2)) & 7) | ((col >> 2) & ~7))
                             * 4 + (col & 3);
}

// A D x D state from device memory into the swizzled layout, 16 bytes a
// copy, by threads t of nt.
template <int D>
__device__ inline void stage_state(float* dst, const float* src, int t,
                                   int nt) {
  for (int p = t; p < D * D / 4; p += nt) {
    const int row = p / (D / 4), col = 4 * (p % (D / 4));
    cp_async16(dst + st_off<D>(row, col), src + row * D + col);
  }
}

// The index of pair (J, I), J + 2 <= I < NS, among such pairs.
template <int NS>
__device__ inline int pair2(int J, int I) {
  int x = 0;
  for (int j = 0; j < J; ++j) x += NS - 2 - j;
  return x + I - J - 2;
}

// prod_{lo < m < hi, m != skip} gam_m, four channels from d4.
template <int D>
__device__ inline float4 gam_prod(const float* gam, int lo, int hi, int skip,
                                  int d4) {
  float4 g = make_float4(1.f, 1.f, 1.f, 1.f);
  for (int m = lo + 1; m < hi; ++m)
    if (m != skip) g = mul4(g, ld4(gam + m * D + d4));
  return g;
}

template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_bwd_chunk_kernel(const Args<T> a) {
  using L = ChunkSmem<T, D, C>;
  constexpr int P = L::P, PC = L::PC, NS = L::NS;
  constexpr int NF = C * D / 16;         // 4 x 4 tiles of a (C, D) product
  constexpr int NDV = C * D / 8;         // 4 x 2 tiles of dv
  constexpr int DL = D / 4 < 16 ? D / 4 : 16;  // lanes of a diagonal A row
  constexpr int NQ = D / (4 * DL);
  constexpr int NA = NS * kSub * DL;     // diagonal A lane tasks
  constexpr int T2 = kThreads - 2 * D;   // threads beside the factor tasks
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr bool kStage = D <= C;        // S_in and G_out into yb and za
  static_assert(NF <= kThreads / 2 && NDV <= kThreads && NS * D <= kThreads,
                "one tile a thread");
  static_assert(NA % 32 == 0 && T2 % 32 == 0 && 2 * D % 32 == 0,
                "warp-uniform diagonal tasks");
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* sm = reinterpret_cast<float*>(sm_raw);
  float* sr = sm + L::r;
  float* sk = sm + L::k;
  float* sw = sm + L::w;
  float* sv = sm + L::v;
  float* so = sm + L::o;
  float* srt = sm + L::rt;
  float* skb = sm + L::kb;
  float* skh = sm + L::kh;
  float* syb = sm + L::yb;
  float* sza = sm + L::za;
  float* sM = sm + L::MA;   // M above the diagonal and on it
  float* sA = sm + L::MA;   // A below it
  float* sg = sm + L::gam;
  float* su = sm + L::u;
  float* sz = sm + L::z;
  float* ssig = sm + L::sig;
  float* sphy = sm + L::phy;
  float* sphz = sm + L::phz;
  float* sphj = sm + L::phj;
  float* sdup = sm + L::dup;
  // bf16 rows r, k, v, do as they lie in memory, in the rt / kb arrays.
  unsigned char* raw = reinterpret_cast<unsigned char*>(srt);
  constexpr int raw_arr = C * D * static_cast<int>(sizeof(T));

  const int tid = threadIdx.x;
  const int n = (a.t_len + C - 1) / C;
  const int items = a.bh * n;

  // The rows of item x into shared memory: f32 rows straight into their
  // arrays, bf16 r, k, v, do as they lie into `raw`; w (f32) into sw.
  auto stage = [&](int x, int t, int nt) {
    const int bh = x / n, t0 = (x % n) * C;
    const int valid = min(C, a.t_len - t0);
    const T* src[4] = {a.r + a.r_bh * bh + a.r_t * t0,
                       a.k + a.k_bh * bh + a.k_t * t0,
                       a.v + a.v_bh * bh + a.v_t * t0,
                       a.dout + a.do_bh * bh + a.do_t * t0};
    const long long ld[4] = {a.r_t, a.k_t, a.v_t, a.do_t};
    float* dst[4] = {sr, sk, sv, so};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (kBf16)
        stage_rows<T, D>(raw + q * raw_arr, D * sizeof(T), src[q], ld[q], C,
                         valid, pad_of(T()), t, nt);
      else
        stage_rows<T, D>(reinterpret_cast<unsigned char*>(dst[q]), P * 4,
                         src[q], ld[q], C, valid, pad_of(T()), t, nt);
    }
    stage_rows<float, D>(reinterpret_cast<unsigned char*>(kBf16 ? skh : sw),
                         P * 4, a.w + a.w_bh * bh + a.w_t * t0, a.w_t, C,
                         valid, 1.f, t, nt);
    cp_async_commit();
  };

  // S_in and G_out of item x into Yb's and G_out's arrays (D <= C).
  auto stage_states = [&](int x, int t, int nt) {
    const int bh = x / n, c = x % n;
    if (c > 0)
      stage_state<D>(syb, a.states + (static_cast<size_t>(bh) * (n - 1) + c - 1)
                                      * D * D, t, nt);
    if (c + 1 < n)
      stage_state<D>(sza, a.gst + (static_cast<size_t>(bh) * (n - 1) + c) * D * D,
                  t, nt);
    cp_async_commit();
  };

  if constexpr (kBf16) {
    if (static_cast<int>(blockIdx.x) < items) stage(blockIdx.x, tid, kThreads);
  }
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bh = item / n, c = item % n, t0 = c * C;
    const float* s_in =
        c > 0 ? a.states + (static_cast<size_t>(bh) * (n - 1) + c - 1) * D * D
              : nullptr;
    float* g_out =
        c + 1 < n ? a.gst + (static_cast<size_t>(bh) * (n - 1) + c) * D * D
                  : nullptr;

    // ---- The rows in f32 (bf16: staged during the last item's steps,
    // w in k^'s array), the states where they fit; u of the row's head.
    if constexpr (!kBf16) stage(item, tid, kThreads);
    // The states land behind P1 (one more group, empty where D > C).
    if constexpr (kStage) {
      stage_states(item, tid, kThreads);
    } else {
      cp_async_commit();
    }
    // The states' rows: staged (pitch P) or in device memory (pitch D).
    const float* s_src = kStage ? syb : s_in;
    const float* g_src = kStage ? sza : g_out;
    // Element (row, col) of a state: swizzled when staged.
    auto srow = [](int row, int col) {
      return kStage ? st_off<D>(row, col) : row * D + col;
    };
    cp_async_wait_group1();
    __syncthreads();
    if constexpr (kBf16) {
      float* dst[4] = {sr, sk, sv, so};
      for (int e = 4 * tid; e < C * D; e += 4 * kThreads) {
        const int row = e / D, col = e % D;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st4(dst[q] + row * P + col,
              load4(reinterpret_cast<const T*>(raw + q * raw_arr) + e));
        st4(sw + row * P + col, ld4(skh + row * P + col));
      }
    }
    if (tid < D) su[tid] = a.u[(bh % a.heads) * D + tid];
    __syncthreads();

    // ---- P1: the anchored factors; A's diagonal blocks and z; M.
    if (tid < D) {
      // r~_s = r_s P_{n_J,s} forward from each sub-chunk's start, gam_J.
      const int d = tid;
      for (int J = 0; J < NS; ++J) {
        // A sub-chunk's loads ahead of its stores (one shared base).
        float rr[kSub], ww[kSub];
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          rr[s] = sr[(J * kSub + s) * P + d];
          ww[s] = sw[(J * kSub + s) * P + d];
        }
        float q = 1.f;
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          srt[(J * kSub + s) * P + d] = rr[s] * q;
          q *= ww[s];
        }
        sg[J * D + d] = q;
      }
    } else if (tid < 2 * D) {
      // k~_s = k_s P_{s+1,e_J} backward from each sub-chunk's end, and
      // k^_s = k_s P_{s+1,C} from the chunk's.
      const int d = tid - D;
      float p = 1.f;
      for (int J = NS - 1; J >= 0; --J) {
        float kk[kSub], ww[kSub];
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          kk[s] = sk[(J * kSub + s) * P + d];
          ww[s] = sw[(J * kSub + s) * P + d];
        }
        float q = 1.f;
#pragma unroll
        for (int s = kSub - 1; s >= 0; --s) {
          skb[(J * kSub + s) * P + d] = kk[s] * q;
          skh[(J * kSub + s) * P + d] = kk[s] * p;
          q *= ww[s];
          p *= ww[s];
        }
      }
    } else {
      const int t2 = tid - 2 * D;
      // A's diagonal blocks: lane (I, a, dq) sums A[n+i][n+a] for every i
      // of sub-chunk I over the channel quads DL q + dq, carrying
      // P_{a+1,i} along i (0 up to i = a, where the bonus z_a is taken).
      for (int task = t2; task < NA; task += T2) {
        const int I = task / (kSub * DL), aa = (task / DL) % kSub;
        const int dq = task % DL, n0 = I * kSub;
        float acc[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) acc[i] = 0.f;
        float accz = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int d4 = (DL * q + dq) * 4;
          const float4 kj = ld4(sk + (n0 + aa) * P + d4);
          accz = dot4(ld4(sr + (n0 + aa) * P + d4), mul4(kj, ld4(su + d4)),
                      accz);
          float4 p = zero4();
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            const float e1 = i == aa ? 1.f : 0.f;
            acc[i] = dot4(ld4(sr + (n0 + i) * P + d4), mul4(kj, p), acc[i]);
            const float4 ww = ld4(sw + (n0 + i) * P + d4);
            p = make_float4(fmaf(p.x, ww.x, e1), fmaf(p.y, ww.y, e1),
                            fmaf(p.z, ww.z, e1), fmaf(p.w, ww.w, e1));
          }
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int o = 1; o < DL; o <<= 1)
            acc[i] += __shfl_xor_sync(kAll, acc[i], o);
#pragma unroll
        for (int o = 1; o < DL; o <<= 1) accz += __shfl_xor_sync(kAll, accz, o);
        if (dq == 0) {
#pragma unroll
          for (int i = 0; i < kSub; ++i)
            if (i > aa) sA[(n0 + i) * PC + n0 + aa] = acc[i];
          sz[n0 + aa] = accz;
        }
      }
      // M's blocks (J, I), J <= I, as 4 x 4 tiles: M[a][b] = v_a . do_b.
      for (int x = t2; x < NS * (NS + 1) / 2 * 16; x += T2) {
        int blk = x / 16, I = 0;
        while (blk > I) blk -= ++I;
        const int J = blk;
        const int a0 = J * kSub + 4 * ((x % 16) / 4);
        const int b0 = I * kSub + 4 * (x % 4);
        float acc[4][4] = {};
#pragma unroll 4
        for (int e = 0; e < D; e += 4) {
          float4 va[4], ob[4];
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            va[y] = ld4(sv + (a0 + y) * P + e);
            ob[y] = ld4(so + (b0 + y) * P + e);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = dot4(va[i], ob[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (J < I) {
            st4(sM + (a0 + i) * PC + b0,
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
          } else {  // a diagonal block: M on and above the diagonal only
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (a0 + i <= b0 + j) sM[(a0 + i) * PC + b0 + j] = acc[i][j];
          }
        }
      }
    }
    cp_async_wait_all();   // the states
    __syncthreads();

    // ---- P2: Yb (S_in do and the earlier sub-chunks), Za (G_out v and
    // the later ones), A's off-diagonal blocks.  Tile f of a (C, D)
    // product: rows 4 tr .., columns 4 tc ..; a warp holds 4 row blocks by
    // 8 column blocks.
    const bool fam_y = tid < NF;
    const bool fam_z = tid >= kThreads / 2 && tid < kThreads / 2 + NF;
    const int f = fam_z ? tid - kThreads / 2 : tid;
    const int tc = (f / 4) % (D / 4), tr = f % 4 + 4 * (f / D);
    const int r0 = 4 * tr, c0 = 4 * tc;
    float acc[4][4] = {};    // Yb's or Za's tile, stored after the barrier
    if (fam_y || fam_z) {
      const int J0 = r0 / kSub;
      const bool has = (fam_y ? s_in : g_out) != nullptr;
      const float* g_mat = fam_y ? s_src : g_src;
      const float* x_mat = fam_y ? so : sv;
      // S_in do_b (Yb's) or G_out v_a (Za's).
      if (has) {
#pragma unroll(kStage ? 2 : 1)
        for (int e = 0; e < D; e += 4) {
          float4 xr[4], gd[4];
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            xr[y] = ld4(x_mat + (r0 + y) * P + e);
            gd[y] = ld4(g_mat + srow(c0 + y, e));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = dot4(xr[i], gd[j], acc[i][j]);
        }
      }
      {
        // Partials of Phi(-1, I) = sum_b r~_b . (S_in do_b) (Yb's) and of
        // Phi(J, NS) = sum_a k~_a . (G_out v_a) (Za's) over the tile's rows;
        // then the product of the sub-chunks before (after) the rows' own.
        const float* fac = fam_y ? srt : skb;
        float* ph = fam_y ? sphy : sphz;
        const float4 g = fam_y ? gam_prod<D>(sg, -1, J0, -1, c0)
                               : gam_prod<D>(sg, J0, NS, -1, c0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sum = fmaf(fac[(r0 + i) * P + c0 + j], acc[i][j], sum);
            acc[i][j] *= comp(g, j);
          }
          ph[tr * D + c0 + j] = sum;
        }
      }
      if (fam_y) {
        // Yb_b += sum_{J<I} Gamma(J,I) sum_{a in J} M[a][b] k~_a, Gamma
        // folded into k~.
        for (int J = 0; J < J0; ++J) {
          const float4 g = gam_prod<D>(sg, J, J0, -1, c0);
#pragma unroll 4
          for (int aa = J * kSub; aa < (J + 1) * kSub; ++aa) {
            const float4 mb = ld4(sM + aa * PC + r0);
            const float4 kd = mul4(ld4(skb + aa * P + c0), g);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(comp(mb, i), comp(kd, j), acc[i][j]);
          }
        }
      } else {
        // Za_a += sum_{I>J} Gamma(J,I) sum_{b in I} M[a][b] r~_b, and
        // Phi(J, I) = sum_{a in J} k~_a . (sum_{b in I} M[a][b] r~_b) for
        // I >= J + 2.
        for (int I = J0 + 1; I < NS; ++I) {
          float q[4][4] = {};
#pragma unroll 2
          for (int b = I * kSub; b < (I + 1) * kSub; b += 4) {
            float4 ma[4], rb[4];
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              ma[y] = ld4(sM + (r0 + y) * PC + b);
              rb[y] = ld4(srt + (b + y) * P + c0);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int zz = 0; zz < 4; ++zz)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  q[i][j] = fmaf(comp(ma[i], zz), comp(rb[zz], j), q[i][j]);
          }
          if (I >= J0 + 2) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float sum = 0.f;
#pragma unroll
              for (int i = 0; i < 4; ++i)
                sum = fmaf(skb[(r0 + i) * P + c0 + j], q[i][j], sum);
              sphj[(pair2<NS>(J0, I) * 4 + tr % 4) * D + c0 + j] = sum;
            }
          }
          const float4 g = gam_prod<D>(sg, J0, I, -1, c0);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(comp(g, j), q[i][j], acc[i][j]);
        }
      }
    }
    if (tid >= kThreads / 2 && tid < kThreads / 2 + D) {
      // sigma[d] = S_in[d] . G_out[d].
      const int d = tid - kThreads / 2;
      float sg2 = 0.f;
      if (s_in != nullptr && g_out != nullptr)
        for (int e = 0; e < D; e += 4)
          sg2 = dot4(ld4(s_src + srow(d, e)), ld4(g_src + srow(d, e)), sg2);
      ssig[d] = sg2;
    }
    // G_out^T k^_j, dv's first term, carried into P3; the tile: rows
    // 4 tv .., columns 2 cv ..
    const int cv = (tid / 4) % (D / 2), tv = tid % 4 + 4 * (tid / (2 * D));
    const int j0 = 4 * tv, e0 = 2 * cv;
    float dv[4][2] = {};
    if (tid < NDV && g_out != nullptr) {
      for (int d = 0; d < D; d += 4) {
        float4 kj[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) kj[y] = ld4(skh + (j0 + y) * P + d);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 g2 =
              *reinterpret_cast<const float2*>(g_src + srow(d + q, e0));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][0] = fmaf(comp(kj[i], q), g2.x, dv[i][0]);
            dv[i][1] = fmaf(comp(kj[i], q), g2.y, dv[i][1]);
          }
        }
      }
    }
    // A's off-diagonal blocks (J < I): A[b][a] = sum_d r~_b k~_a
    // prod_{J < m < I} gam_m, as 4 x 4 tiles.
    for (int x = tid; x < NS * (NS - 1) / 2 * 16; x += kThreads) {
      int blk = x / 16, I = 1;
      while (blk >= I) blk -= I++;
      const int J = blk;
      const int b0 = I * kSub + 4 * ((x % 16) / 4);
      const int a0 = J * kSub + 4 * (x % 4);
      float acc[4][4] = {};
#pragma unroll 2
      for (int d4 = 0; d4 < D; d4 += 4) {
        const float4 g = gam_prod<D>(sg, J, I, -1, d4);
        float4 rb[4], ka[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          rb[y] = ld4(srt + (b0 + y) * P + d4);
          ka[y] = mul4(ld4(skb + (a0 + y) * P + d4), g);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(rb[i], ka[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st4(sA + (b0 + i) * PC + a0,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
    __syncthreads();

    // ---- P3: Yb and Za over the states (read); dv out, dv_j =
    // G_out^T k^_j + sum_{b > j} A[b][j] do_b + z_j do_j.
    if (fam_y || fam_z) {
      float* dst = fam_y ? syb : sza;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st4(dst + (r0 + i) * P + c0,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
    if (tid < NDV) {
      // A's diagonal block: A[b][j] where b > j (M lies on and above).
      for (int b = (j0 / kSub) * kSub; b < (j0 / kSub + 1) * kSub; ++b) {
        const float4 aa = ld4(sA + b * PC + j0);
        const float2 ob = *reinterpret_cast<const float2*>(so + b * P + e0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = b > j0 + i ? comp(aa, i) : 0.f;
          dv[i][0] = fmaf(ai, ob.x, dv[i][0]);
          dv[i][1] = fmaf(ai, ob.y, dv[i][1]);
        }
      }
      for (int b = (j0 / kSub + 1) * kSub; b < C; ++b) {
        const float4 aa = ld4(sA + b * PC + j0);
        const float2 ob = *reinterpret_cast<const float2*>(so + b * P + e0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][0] = fmaf(comp(aa, i), ob.x, dv[i][0]);
          dv[i][1] = fmaf(comp(aa, i), ob.y, dv[i][1]);
        }
      }
      T* dvp = a.dv + (static_cast<size_t>(bh) * a.t_len + t0) * D + e0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + i;
        const float2 oj = *reinterpret_cast<const float2*>(so + j * P + e0);
        if (t0 + j < a.t_len)
          put2(dvp + static_cast<size_t>(j) * D, fmaf(sz[j], oj.x, dv[i][0]),
               fmaf(sz[j], oj.y, dv[i][1]));
      }
    }
    __syncthreads();
    // ---- P4: per (sub-chunk K, channel d), the pairs inside K step by
    // step: dr, dk, dw and du, from registers and M and Za.  bf16: the next
    // item's rows stream in behind these steps, by the threads without
    // one, into arrays the steps do not read (r, k, v, do into r~ and k~,
    // w into k^).
    if constexpr (kBf16) {
      if (item + static_cast<int>(gridDim.x) < items && tid >= NS * D)
        stage(item + gridDim.x, tid - NS * D, kThreads - NS * D);
    }
    if (tid < NS * D) {
      const int K = tid / D, d = tid % D, n0 = K * kSub;
      float rK[kSub], kK[kSub], wK[kSub], Lb[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        rK[t] = sr[(n0 + t) * P + d];
        kK[t] = sk[(n0 + t) * P + d];
        wK[t] = sw[(n0 + t) * P + d];
        Lb[t] = syb[(n0 + t) * P + d];
      }
      // X_K: the pairs (before K, after K), each Phi(J, I) times the whole
      // sub-chunks between J and I but K; J = -1 is S_in, I = NS G_out.
      float X = 0.f;
      for (int J = -1; J < K; ++J)
        for (int I = K + 1; I <= NS; ++I) {
          float phi = 0.f;
          if (J < 0 && I == NS) {
            phi = ssig[d];
          } else {
            const float* src = J < 0 ? sphy + 4 * I * D
                               : I == NS ? sphz + 4 * J * D
                                         : sphj + pair2<NS>(J, I) * 4 * D;
#pragma unroll
            for (int g = 0; g < 4; ++g) phi += src[g * D + d];
          }
          float gp = 1.f;
          for (int m = J + 1; m < I; ++m)
            if (m != K) gp *= sg[m * D + d];
          X = fmaf(gp, phi, X);
        }
      const float ud = su[d];
      // Lb[b] = what reaches row b (dr_b) from before step t; X what pairs
      // (before t, after K) carry.
      float du = 0.f;
      const size_t row0 = static_cast<size_t>(bh) * a.t_len + t0 + n0;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const float* mt = sM + (n0 + t) * PC + n0;
        const float vdo = mt[t];
        const float za = sza[(n0 + t) * P + d];
        float p = 1.f, a4 = 0.f, ak = 0.f;
#pragma unroll
        for (int b = t + 1; b < kSub; ++b) {
          const float rp = rK[b] * p;
          a4 = fmaf(rp, Lb[b], a4);
          ak = fmaf(rp, mt[b], ak);
          p *= wK[b];
        }
        a4 = fmaf(p, X, a4);
        ak = fmaf(p, za, ak);
        if (t0 + n0 + t < a.t_len) {
          const size_t o = (row0 + t) * D + d;
          put(a.dr + o, fmaf(ud * kK[t], vdo, Lb[t]));
          put(a.dk + o, fmaf(ud * rK[t], vdo, ak));
          a.dw[o] = a4;
        }
#pragma unroll
        for (int b = t + 1; b < kSub; ++b)
          Lb[b] = fmaf(wK[t], Lb[b], kK[t] * mt[b]);
        X = fmaf(wK[t], X, kK[t] * za);
        du = fmaf(rK[t] * kK[t], vdo, du);
      }
      sdup[K * D + d] = du;
    }
    __syncthreads();
    if (tid < D) {
      // du's partial of this item: into row 0 of its G state, which no one
      // reads any more, or after the G states for the last chunk.
      float sum = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < NS; ++k2) sum += sdup[k2 * D + tid];
      (g_out != nullptr ? g_out : a.du_tail + static_cast<size_t>(bh) * D)[tid] =
          sum;
    }
  }
}

// du[h][i] = sum over b, then over chunks c, in order, of the partials of
// rows b H + h (chunk c < n - 1 in row 0 of its G state, the last after).
__global__ void du_sum_kernel(const float* __restrict__ gst,
                              const float* __restrict__ tail,
                              float* __restrict__ du, int batch, int heads,
                              int n, int d) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= heads * d) return;
  const int h = x / d, i = x % d;
  float s = 0.f;
  for (int b = 0; b < batch; ++b) {
    const size_t bh = static_cast<size_t>(b) * heads + h;
    for (int c = 0; c + 1 < n; ++c)
      s += gst[((bh * (n - 1) + c) * d) * d + i];
    s += tail[bh * d + i];
  }
  du[x] = s;
}

template <typename T, int D, int C>
int launch(const Args<T>& a, float* du, int sms, cudaStream_t stream) {
  const int n = (a.t_len + C - 1) / C;
  if (n > 1) {
    constexpr int smem = CarrySmem<T, D, C>::bytes;
    auto kern = rwkv6_bwd_carry_kernel<T, D, C>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = static_cast<long long>(a.bh) * (D / kEb);
    if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    kern<<<static_cast<unsigned>(grid), kThreadsG<D>, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    constexpr size_t smem = ChunkSmem<T, D, C>::bytes;
    auto kern = rwkv6_bwd_chunk_kernel<T, D, C>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long items = static_cast<long long>(a.bh) * n;
    if (items > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = static_cast<int>(items < sms ? items : sms);
    kern<<<grid, kThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int hd = a.heads * D;
  du_sum_kernel<<<(hd + 255) / 256, 256, 0, stream>>>(
      a.gst, a.du_tail, du, a.bh / a.heads, a.heads, n, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> args(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* dout, const void* states, void* dr,
             void* dk, void* dv, void* dw, void* gst, void* du_tail, int bh,
             int heads, int t_len, const long long* st) {
  return Args<T>{static_cast<const T*>(r), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(dout),
                 static_cast<const float*>(w), static_cast<const float*>(u),
                 static_cast<const float*>(states), static_cast<T*>(dr),
                 static_cast<T*>(dk), static_cast<T*>(dv),
                 static_cast<float*>(dw), static_cast<float*>(gst),
                 static_cast<float*>(du_tail), bh, heads, t_len,
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                 st[8], st[9]};
}

}  // namespace

// r, k, v, dout: (BH, T, D) in f32 (is_bf16 = 0) or bf16 (1), element
// strides (*_bh, *_t), a contiguous last axis, 16-byte aligned rows; w: the
// same in f32; u: contiguous (heads, D) f32; states: the forward's S at the
// start of chunks 1 .. n - 1, contiguous (BH, n - 1, D, D) f32, n =
// ceil(T / chunk) (null when n = 1).  dr, dk, dv: contiguous (BH, T, D) in
// r's type; dw: contiguous (BH, T, D) f32; du: contiguous (heads, D) f32;
// work: (BH (n - 1) D D + BH D) f32 scratch, the G states then the last
// chunk's du partials.  D and chunk are the forward's pairs (32, 64),
// (64, 64), (128, 32); sms the card's SM count (the chunk kernel's grid).
// Three launches on the stream, no host sync.  Returns
// cudaErrorInvalidValue for shapes it does not take, else
// cudaGetLastError() after the launches.
extern "C" int repro_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* dout, const void* states, void* dr, void* dk, void* dv,
    void* dw, void* du, void* work, int is_bf16, int bh, int heads,
    int t_len, int d, int chunk, int sms, long long r_bh, long long r_t,
    long long k_bh, long long k_t, long long v_bh, long long v_t,
    long long w_bh, long long w_t, long long do_bh, long long do_t,
    void* stream) {
  if (bh < 1 || t_len < 1 || heads < 1 || bh % heads != 0 || sms < 1 ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[10] = {r_bh, r_t, k_bh, k_t, v_bh,
                            v_t,  w_bh, w_t, do_bh, do_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* duf = static_cast<float*>(du);
  const long long n = (t_len + chunk - 1) / chunk;
  float* gst = static_cast<float*>(work);
  float* tail = gst + static_cast<size_t>(bh) * (n - 1) * d * d;
#define REPRO_BWD(T, D, C)                                                  \
  if (d == D && chunk == C)                                                 \
    return launch<T, D, C>(args<T>(r, k, v, w, u, dout, states, dr, dk, dv, \
                                   dw, gst, tail, bh, heads, t_len, st),    \
                           duf, sms, s);
  if (is_bf16) {
    REPRO_BWD(__nv_bfloat16, 32, 64)
    REPRO_BWD(__nv_bfloat16, 64, 64)
    REPRO_BWD(__nv_bfloat16, 128, 32)
  } else {
    REPRO_BWD(float, 32, 64)
    REPRO_BWD(float, 64, 64)
    REPRO_BWD(float, 128, 32)
  }
#undef REPRO_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
