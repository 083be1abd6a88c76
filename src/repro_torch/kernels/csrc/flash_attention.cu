// flash_attention: blocked online-softmax attention over (B, Hq, S, D)
// queries and (B, Hkv, Sk, D) keys/values, with causal masking, a sliding
// window, logit soft-capping cap * tanh(s / cap) and GQA (query head h reads
// KV head h / (Hq / Hkv)).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas body _flash_kernel).  On the TPU the KV axis was
// the sequential grid dimension carrying (m, l, acc) in VMEM scratch; here
// one CTA owns a query tile of one (batch, head) and walks the KV tiles
// itself in a loop, the running max m, denominator l and f32 numerator in
// registers.  Whole KV tiles outside the causal/window band are never
// loaded, as the Pallas kernel skips them.
//
// Query row i sits at key position q_off + i (q_off = 0 but for a chunk of
// a prompt after q_off cached keys, the reference's chunked_attention
// q_offset; the TPU kernel has none): the causal mask keeps k_pos <= q_off
// + i, the window k_pos > q_off + i - window, and the band of KV tiles a
// query tile walks moves with it.
//
// Masking follows the reference: masked logits are -0.7 * FLT_MAX, their
// probabilities are zeroed, and a row with zero mass writes 0 (l == 0 -> 1).
//
// Row statistics for the backward: where `lse` is not null (training asks;
// serving passes null and nothing else changes), each query row also
// writes its log-sum-exp m + log(l) in natural-log units, m the row's
// largest kept logit and l its sum of exp(x - m), so that P = exp(x - lse).
// (The bf16 kernel runs its softmax in the exp2 form on natural-unit
// logits, so m and l are already in these units; the backward converts
// lse to the exp2 domain once a row.)  A row with zero mass writes +inf,
// which makes every P of the row exp(x - inf) = 0.
// Unlike the Pallas kernel, keys at k_pos >= Sk are masked here in every
// mode: the Pallas kernel zero-pads K/V and leaves the pad to `causal`, so
// a non-causal call with a ragged Sk lets padded keys carry mass.
//
// What bounds it on this card: at the served shape (S = 4096, D = 256,
// window 2048) the work is ~6.4e10 flops against ~2e7 bytes, so operations
// bind, and the bf16 rate lives in the tensor cores.  bf16 runs an
// FA3-shaped kernel (flash_tc_kernel):
//
// * One CTA of three warpgroups per (128 query rows, batch * head), the
//   last query tiles (the most keys under a causal mask) launched first:
//   two consumer warpgroups of 64 rows each and one producer warpgroup, of
//   which one thread issues every TMA load.  The consumers hold O in f32
//   registers (128 a thread at D = 256, beside 32 of S and 16 of P), more
//   than the 168 each of 384 threads starts with: setmaxnreg moves the
//   producer's down to 24 and the consumers' up to 240.
// * TMA loads Q once and streams K and V tiles of 64 keys through a
//   2-stage ring guarded by full and empty mbarriers.  q, k and v are
//   strided views (the model passes head-transposed projections), read
//   through 4-D tensor maps (D, S, H, B) in 64-column boxes, 128-byte
//   swizzle; out-of-bounds rows and columns read as zero, so a head dim
//   below the instance's bucket (64, 128, 256) is zero-padded in shared
//   memory and keys past Sk arrive as zeros.
// * S = Q K^T by wgmma m64n64k16 from shared memory (K's tile is K-major
//   for B); the online softmax runs on the accumulator registers, a row
//   across the four threads of a quad, in the exp2 form, with the masks
//   applied only on the diagonal, window-edge and Sk-edge tiles.  P is
//   rounded to bf16 in registers and fed as wgmma's register A operand
//   against V from shared memory under the transpose bit (m64n{D}k16).
//   Rounding P before P V is the only arithmetic the f32 reference does
//   not do; l sums the unrounded probabilities.
//
// f32 stays on CUDA cores (flash_kernel): the tensor cores take f32 only
// as TF32.  It runs one CTA per 32-row query tile, the Q, K, V tiles in
// shared memory with rows padded by 4 floats so a quarter-warp's float4
// reads of 8 different rows hit 32 distinct banks, f32 FMAs, expf/tanhf and
// IEEE division (no fast math); the logit is dot(q, k) * scale as in the
// Pallas body.  Its shared memory is 3 * 32 * (D + 4) * 4 + 32 * 40 * 4
// bytes (105 KB at D = 256), above the 48 KB default, so the limit is
// raised once per instantiation, as for the bf16 kernel's 193 KB.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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
  float* lse;  // null, or (B * Hq * S) row statistics
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int hq, hkv, s, sk, d;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
  int q_off;             // key position of query row 0
};

__device__ inline void load8(const float* src, float* dst) {
  const float4 lo = reinterpret_cast<const float4*>(src)[0];
  const float4 hi = reinterpret_cast<const float4*>(src)[1];
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

// Rows [0, valid) of a kRows x d tile from global memory (row stride in
// elements) into shared memory with row stride ld; rows past valid are
// zero.
__device__ void load_tile(const float* src, long long row_stride, int valid,
                          int d, int ld, float* tile) {
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

template <int DMAX>
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
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb +
                    h * p.q_sh + q_lo * p.q_ss;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile(qg, p.q_ss, min(kRows, p.s - q_lo), p.d, ld, qs);

  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x - row * kLanes;
  const int q_row = q_lo + row;
  const int q_pos = p.q_off + q_row;
  float m = kNeg, l = 0.f;
  float4 acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // KV tiles inside the causal/window band of this query tile, whose rows
  // sit at key positions qp_lo .. qp_lo + kRows - 1.
  const int qp_lo = p.q_off + q_lo;
  const int n_kv = (p.sk + kRows - 1) / kRows;
  int t_begin = 0, t_end = n_kv;
  if (p.causal) t_end = min(n_kv, (qp_lo + kRows - 1) / kRows + 1);
  if (p.window > 0 && qp_lo - p.window + 1 > 0)
    t_begin = (qp_lo - p.window + 1) / kRows;

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

  if (q_row >= p.s) return;
  if (p.lse != nullptr && lane == 0)
    p.lse[static_cast<long long>(bh) * p.s + q_row] =
        l == 0.f ? INFINITY : m + logf(l);
  const float denom = l == 0.f ? 1.f : l;
  float* orow = static_cast<float*>(p.out) +
                (static_cast<long long>(bh) * p.s + q_row) * p.d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (lane + c * kLanes) * 4;
    if (col < p.d)
      *reinterpret_cast<float4*>(orow + col) =
          make_float4(acc[c].x / denom, acc[c].y / denom, acc[c].z / denom,
                      acc[c].w / denom);
  }
}


size_t smem_bytes(int d) {
  return sizeof(float) * (3 * kRows * (d + kPad) + kRows * kPLd);
}

template <int DMAX>
int launch_f32(const Args& args, int batch, cudaStream_t stream) {
  static bool raised = false;  // the >48 KB opt-in, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(DMAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((args.s + kRows - 1) / kRows, batch * args.hq);
  flash_kernel<DMAX><<<grid, kThreads, smem_bytes(args.d), stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kQTile = 128;   // query rows per CTA, 64 per consumer
constexpr int kKTile = 64;    // keys per ring stage
constexpr int kRing = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int DMAX>
struct FlashTc {
  static constexpr int kBlocks = DMAX / 64;            // 64-column blocks
  static constexpr int kQBytes = kBlocks * kQTile * 128;
  static constexpr int kKVBytes = kBlocks * kKTile * 128;  // K or V, a stage
  static constexpr size_t smem_bytes() {
    return 1024 + kQBytes + 2 * kRing * static_cast<size_t>(kKVBytes) +
           (1 + 2 * kRing) * sizeof(uint64_t);
  }
};

struct TcArgs {
  void* out;   // contiguous (B, Hq, S, D)
  float* lse;  // null, or (B * Hq * S) row statistics
  int hq, hkv, s, sk, d;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
  int q_off;             // key position of query row 0
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kFlashThreads = 384;   // 2 consumer warpgroups + producer

template <int DMAX>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const TcArgs p) {
  using F = FlashTc<DMAX>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align_1024(smem_raw);   // kBlocks x [128][64]
  uint8_t* ks = qs + F::kQBytes;                // kRing x kBlocks x [64][64]
  uint8_t* vs = ks + kRing * F::kKVBytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + kRing * F::kKVBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kRing;

  // Later query tiles see more keys under a causal mask, so they start
  // first: blockIdx.y counts query tiles down from the last.
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh - b * p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kQTile;
  // KV tiles inside the causal/window band of this query tile, whose rows
  // sit at key positions qp_lo .. qp_lo + kQTile - 1.
  const int qp_lo = p.q_off + q_lo;
  const int n_kv = (p.sk + kKTile - 1) / kKTile;
  int t_begin = 0, t_end = n_kv;
  if (p.causal) t_end = min(n_kv, (qp_lo + kQTile - 1) / kKTile + 1);
  if (p.window > 0 && qp_lo - p.window + 1 > 0)
    t_begin = (qp_lo - p.window + 1) / kKTile;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < kRing; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // Producer: one thread issues every load.  The 384 threads start at
    // 168 registers; 24 + 2 x 240 = 3 x 168, so the consumers' increase
    // below is exactly what this warpgroup gives up.
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != 256) return;
    hopper::mbar_arrive_expect_tx(qbar, F::kQBytes);
    for (int j = 0; j < F::kBlocks; ++j)
      hopper::tma_load_4d(qs + j * kQTile * 128, &tq, qbar, 64 * j, q_lo, h,
                          b);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int s = i % kRing;
      hopper::mbar_wait(&empty[s], ((i / kRing) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&full[s], 2 * F::kKVBytes);
      uint8_t* kt = ks + s * F::kKVBytes;
      uint8_t* vt = vs + s * F::kKVBytes;
      for (int j = 0; j < F::kBlocks; ++j) {
        hopper::tma_load_4d(kt + j * kKTile * 128, &tk, &full[s], 64 * j,
                            t * kKTile, hk, b);
        hopper::tma_load_4d(vt + j * kKTile * 128, &tv, &full[s], 64 * j,
                            t * kKTile, hk, b);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q_lo + 64 wg .. + 63.  This thread
  // holds rows row0 and row0 + 8, columns 8 j + 2 (lane % 4) (+ 1).
  hopper::setmaxnreg_inc<240>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row0 = q_lo + wg * 64 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float o[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const float cap = p.softcap;
  const uint32_t qa = hopper::smem_u32(qs) + wg * 64 * 128;
  hopper::mbar_wait(qbar, 0);

  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % kRing;
    const int k_lo = t * kKTile;
    hopper::mbar_wait(&full[s], (i / kRing) & 1);
    const uint32_t ka = hopper::smem_u32(ks + s * F::kKVBytes);
    const uint32_t va = hopper::smem_u32(vs + s * F::kKVBytes);

    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd) {
      const uint32_t off = 32 * (kd & 3);   // 16 columns of a 64-wide block
      hopper::WgmmaBf16SS<64, 0>::run(
          sc,
          hopper::desc_sw128(qa + (kd >> 2) * kQTile * 128 + off, 16, 1024),
          hopper::desc_sw128(ka + (kd >> 2) * kKTile * 128 + off, 16, 1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // Logits, masks (only on tiles the band's edges cross), row maxima.
    const bool edge = k_lo + kKTile > p.sk ||
                      (p.causal && k_lo + kKTile - 1 > qp_lo) ||
                      (p.window > 0 && k_lo < qp_lo + kQTile - p.window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      float x = sc[e] * p.scale;
      if (cap > 0.f) x = cap * tanhf(x / cap);
      if (edge) {
        const int k_pos = k_lo + 8 * (e >> 2) + cq + (e & 1);
        const int q_pos = p.q_off + row0 + 8 * hh;
        bool ok = k_pos < p.sk;
        if (p.causal) ok = ok && k_pos <= q_pos;
        if (p.window > 0) ok = ok && k_pos > q_pos - p.window;
        // A masked logit counts as -0.7 FLT_MAX in the maximum and carries
        // no probability: -inf does both once the maximum starts at kNeg.
        if (!ok) x = -INFINITY;
      }
      sc[e] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
    float alpha[2], mlog[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      alpha[hh] = exp2f((m[hh] - m_new) * kLog2e);
      m[hh] = m_new;
      // A row with no key yet (m_new == kNeg) has only -inf logits; keep
      // the exponent finite, so exp2(-inf) gives 0, not NaN.
      mlog[hh] = m_new == kNeg ? 0.f : m_new * kLog2e;
      l[hh] *= alpha[hh];
    }
    // Probabilities; this thread's share of each row's sum (the quad's
    // shares are added once, at the end).
    uint32_t pa[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int hh = (e >> 1) & 1;
      const float p0 = exp2f(fmaf(sc[e], kLog2e, -mlog[hh]));
      const float p1 = exp2f(fmaf(sc[e + 1], kLog2e, -mlog[hh]));
      l[hh] += p0 + p1;
      // 16 keys per A fragment: e in [8 kk, 8 kk + 8) lands in register
      // (e / 2) % 4 of fragment kk (row, row + 8, then keys 8-15 of both):
      // mma.m16n8k16's A layout, which the accumulator's layout matches.
      pa[e >> 3][(e >> 1) & 3] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int e = 0; e < DMAX / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaBf16RS<DMAX, 1>::run(
          o, pa[kk],
          hopper::desc_sw128(va + kk * 16 * 128, kKTile * 128, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(pa[kk]);
    if ((threadIdx.x & 127) == 0) hopper::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv_den = 1.f / (sum == 0.f ? 1.f : sum);
    const int row = row0 + 8 * hh;
    if (row >= p.s) continue;
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[static_cast<long long>(bh) * p.s + row] =
          sum == 0.f ? INFINITY : m[hh] + logf(sum);
    __nv_bfloat16* orow =
        out + (static_cast<long long>(bh) * p.s + row) * p.d;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < p.d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv_den,
                                  o[4 * j + 2 * hh + 1] * inv_den);
    }
  }
}

template <int DMAX>
int launch_tc(const Args& a, int batch, cudaStream_t stream) {
  using F = FlashTc<DMAX>;
  static bool raised = false;  // the >48 KB opt-in, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(F::smem_bytes()));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  CUtensorMap tq, tk, tv;
  int err = hopper::bhsd_map(&tq, a.q, a.d, a.s, a.hq, batch, a.q_ss,
                             a.q_sh, a.q_sb, kQTile);
  if (err == 0)
    err = hopper::bhsd_map(&tk, a.k, a.d, a.sk, a.hkv, batch, a.k_ss, a.k_sh,
                           a.k_sb, kKTile);
  if (err == 0)
    err = hopper::bhsd_map(&tv, a.v, a.d, a.sk, a.hkv, batch, a.v_ss, a.v_sh,
                           a.v_sb, kKTile);
  if (err != 0) return err;
  const TcArgs p{a.out,   a.lse,     a.hq,     a.hkv,    a.s,  a.sk,
                 a.d,     a.scale,   a.softcap, a.causal, a.window,
                 a.q_off};
  const dim3 grid(batch * a.hq, (a.s + kQTile - 1) / kQTile);
  flash_tc_kernel<DMAX>
      <<<grid, kFlashThreads, F::smem_bytes(), stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(const Args& args, int batch, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    if (args.d <= 64) return launch_tc<64>(args, batch, st);
    if (args.d <= 128) return launch_tc<128>(args, batch, st);
    return launch_tc<256>(args, batch, st);
  }
  if (args.d <= 64) return launch_f32<64>(args, batch, st);
  if (args.d <= 128) return launch_f32<128>(args, batch, st);
  return launch_f32<256>(args, batch, st);
}

}  // namespace

// q/k/v/out in f32 (is_bf16 = 0) or bf16 (1); strides in elements, the last
// dimension contiguous.  out is contiguous (B, Hq, S, D); query row i sits
// at key position q_offset + i.  lse is null or (B * Hq * S) floats, each
// row's log-sum-exp (+inf for a row with zero mass).  Refuses D > 256,
// D % 8 != 0, Hq % Hkv != 0, a q_offset below 0 or with q_offset + S past
// 2^30 (flash_attention.py's MAX_POSITION) and grids past the hardware
// limits with cudaErrorInvalidValue; bf16 views TMA cannot map (a stride
// that is not a multiple of 8 elements, a base not 16-byte aligned) too.
// Otherwise returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int is_bf16,
    int batch, int hq, int hkv, int s, int sk, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int window, float softcap, int q_offset,
    float* lse, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1 || sk < 1 ||
      d < 8 || d > 256 || d % 8 != 0 ||
      static_cast<long long>(batch) * hq > 65535 || q_offset < 0 ||
      static_cast<long long>(q_offset) + s > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{q,    k,    v,    out,  lse,   q_sb,    q_sh,   q_ss,
                  k_sb, k_sh, k_ss, v_sb, v_sh,  v_ss,    hq,     hkv,
                  s,    sk,   d,    scale, softcap, causal, window, q_offset};
  return dispatch_d(args, batch, is_bf16, static_cast<cudaStream_t>(stream));
}
