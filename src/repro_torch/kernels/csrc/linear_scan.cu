// linear_scan: h_t = a_t * h_{t-1} + b_t along T from h_{-1} = 0,
// elementwise over (B, D); a, b and h are (B, T, D), the state is f32.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::linear_scan (Pallas
// body _scan_kernel), the RG-LRU recurrence of the Griffin layers.  On the
// TPU time was blocked into VMEM chunks on a sequential grid axis carrying
// h in VMEM scratch.  Here there are two paths, chosen by the wrapper
// (kernels/rglru.py) from T:
//
// * linear_scan_kernel, the one-token decode tick and short T: one thread
//   owns one (b, d) channel and walks all of T with h in a register,
//   consecutive threads on consecutive d so that every load and store of a
//   time step coalesces; loads run 8 steps ahead of the update.  At T = 1
//   the launch binds.
// * The two-pass chunked scan, for longer T.  T is cut into chunks of
//   kChunk = 64 steps and D into blocks of 128 channels, one CTA per
//   (block, chunk, b): 1,280 CTAs at the forward shape (1, 4096, 2560),
//   where the sequential kernel runs 10.  Pass 1 (chunk_aggregate_kernel)
//   walks every chunk but the last from h = 0 and writes its aggregate,
//   A = prod a_t and B = h at the chunk's end, to an f32 workspace of
//   (B, chunks - 1, 2, D).  Pass 2 (chunk_scan_kernel) folds the
//   aggregates of the chunks before its own into the carry, in order,
//   h_in = A_j h_in + B_j, from L2, then walks its chunk from h_in and
//   writes h.
//
// What bounds it on this card: the scan moves 3 B T D elements and does
// 2 B T D flops, so bytes bind: 126 MB, 0.038 ms at 3.35 TB/s at the
// forward shape.  The sequential kernel runs only B D threads, 2560 in 10
// CTAs at B = 1, too few loads in flight to stream at the card's rate; the
// chunked form keeps the whole card loading and reads a and b twice
// (~210 MB, ~0.063 ms at the forward shape), and lands within 1.4x of that.
// A single pass with decoupled look-back would read them once; it is not
// tried (PERF.md).
//
// Numerics: every step is h = __fadd_rn(__fmul_rn(a, h), b), no FMA
// contraction, the order of the plain PyTorch version, and so is the fold
// of the carries.  The first two chunks are bit for bit the sequential
// walk (their carry is 0 and then B_0 exactly); later chunks start from a
// carry rounded along another path, a few f32 ulps from the sequential h,
// and the difference decays with a.  bf16 outputs round to nearest even.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;  // time steps fetched before they are used
constexpr int kChunk = 64;   // time steps per chunk of the two-pass scan
constexpr int kBlockD = 128; // channels per CTA of the two-pass scan

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void put(float* p, float x) { *p = x; }
__device__ inline void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ out, int t_len, int d) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * t_len * d + col;
  const T* ap = a + base;
  const T* bp = b + base;
  T* op = out + base;
  float h = 0.f;
  int t = 0;
  for (; t + kAhead <= t_len; t += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const size_t off = static_cast<size_t>(t + u) * d;
      av[u] = to_f32(ap[off]);
      bv[u] = to_f32(bp[off]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      put(op + static_cast<size_t>(t + u) * d, h);
    }
  }
  for (; t < t_len; ++t) {
    const size_t off = static_cast<size_t>(t) * d;
    h = __fadd_rn(__fmul_rn(to_f32(ap[off]), h), to_f32(bp[off]));
    put(op + off, h);
  }
}

// Pass 1: the aggregate of chunk blockIdx.y: A = prod a_t, B = h_end from 0.
template <typename T>
__global__ void __launch_bounds__(kBlockD)
chunk_aggregate_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       float* __restrict__ agg, int t_len, int d,
                       int n_agg) {
  const int col = blockIdx.x * kBlockD + threadIdx.x;
  if (col >= d) return;
  const int ch = blockIdx.y;
  const size_t base =
      (static_cast<size_t>(blockIdx.z) * t_len + ch * kChunk) * d + col;
  const T* ap = a + base;
  const T* bp = b + base;
  float prod = 1.f, h = 0.f;
#pragma unroll 1
  for (int t = 0; t < kChunk; t += kAhead) {  // only full chunks come here
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const size_t off = static_cast<size_t>(t + u) * d;
      av[u] = to_f32(ap[off]);
      bv[u] = to_f32(bp[off]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      prod = __fmul_rn(av[u], prod);
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
    }
  }
  float* gp = agg + (static_cast<size_t>(blockIdx.z) * n_agg + ch) * 2 * d
              + col;
  gp[0] = prod;
  gp[d] = h;
}

// Pass 2: fold the carries of chunks 0 .. blockIdx.y - 1, then walk the
// chunk from the carry.  Steps past t_len are not walked (the reference
// pads them with a = 1, b = 0, which leaves h as it was).
template <typename T>
__global__ void __launch_bounds__(kBlockD)
chunk_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ agg, T* __restrict__ out,
                  int t_len, int d, int n_agg) {
  const int col = blockIdx.x * kBlockD + threadIdx.x;
  if (col >= d) return;
  const int ch = blockIdx.y;
  const float* gp = agg + static_cast<size_t>(blockIdx.z) * n_agg * 2 * d
                    + col;
  float h = 0.f;
  int j = 0;
  for (; j + kAhead <= ch; j += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      av[u] = gp[static_cast<size_t>(j + u) * 2 * d];
      bv[u] = gp[static_cast<size_t>(j + u) * 2 * d + d];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
  }
  for (; j < ch; ++j)
    h = __fadd_rn(__fmul_rn(gp[static_cast<size_t>(j) * 2 * d], h),
                  gp[static_cast<size_t>(j) * 2 * d + d]);
  const int t0 = ch * kChunk;
  const int steps = min(kChunk, t_len - t0);
  const size_t base = (static_cast<size_t>(blockIdx.z) * t_len + t0) * d + col;
  const T* ap = a + base;
  const T* bp = b + base;
  T* op = out + base;
  int t = 0;
  for (; t + kAhead <= steps; t += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const size_t off = static_cast<size_t>(t + u) * d;
      av[u] = to_f32(ap[off]);
      bv[u] = to_f32(bp[off]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      put(op + static_cast<size_t>(t + u) * d, h);
    }
  }
  for (; t < steps; ++t) {
    const size_t off = static_cast<size_t>(t) * d;
    h = __fadd_rn(__fmul_rn(to_f32(ap[off]), h), to_f32(bp[off]));
    put(op + off, h);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int batch, int t_len,
           int d, cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, batch);
  linear_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      t_len, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunked(const void* a, const void* b, float* agg, void* out,
                   int batch, int t_len, int d, cudaStream_t stream) {
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  const int blocks = (d + kBlockD - 1) / kBlockD;
  const int n_agg = n_chunks - 1;
  if (n_agg > 0) {
    chunk_aggregate_kernel<T><<<dim3(blocks, n_agg, batch), kBlockD, 0,
                                stream>>>(static_cast<const T*>(a),
                                          static_cast<const T*>(b), agg,
                                          t_len, d, n_agg);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  chunk_scan_kernel<T><<<dim3(blocks, n_chunks, batch), kBlockD, 0,
                         stream>>>(static_cast<const T*>(a),
                                   static_cast<const T*>(b), agg,
                                   static_cast<T*>(out), t_len, d, n_agg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, out: contiguous (B, T, D), all f32 (is_bf16 = 0) or all bf16 (1).
// Returns cudaErrorInvalidValue for empty or oversized shapes, else
// cudaGetLastError() after the launch.
extern "C" int repro_linear_scan(const void* a, const void* b, void* out,
                                 int is_bf16, int batch, int t_len, int d,
                                 void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, b, out, batch, t_len, d, st)
                 : launch<float>(a, b, out, batch, t_len, d, st);
}

// The two-pass chunked scan, as repro_linear_scan; agg is an f32 workspace
// of at least repro_linear_scan_workspace(batch, t_len, d) floats (none is
// read when T <= kChunk).  Two launches on the stream, no host sync.
extern "C" long long repro_linear_scan_workspace(int batch, int t_len,
                                                 int d) {
  const long long n_agg = (t_len + kChunk - 1) / kChunk - 1;
  return 2LL * batch * (n_agg > 0 ? n_agg : 0) * d;
}

extern "C" int repro_linear_scan_chunked(const void* a, const void* b,
                                         void* agg, void* out, int is_bf16,
                                         int batch, int t_len, int d,
                                         void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || d < 1
      || (t_len + kChunk - 1) / kChunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(agg);
  return is_bf16
             ? launch_chunked<__nv_bfloat16>(a, b, g, out, batch, t_len, d, st)
             : launch_chunked<float>(a, b, g, out, batch, t_len, d, st);
}
