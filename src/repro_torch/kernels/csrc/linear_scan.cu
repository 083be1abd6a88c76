// linear_scan: h_t = a_t * h_{t-1} + b_t along T from h_{-1} = 0,
// elementwise over (B, D); a, b and h are (B, T, D), the state is f32.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::linear_scan (Pallas
// body _scan_kernel), the RG-LRU recurrence of the Griffin layers.  On the
// TPU time was blocked into VMEM chunks on a sequential grid axis carrying
// h in VMEM scratch; here one thread owns one (b, d) channel and walks all
// of T with h in a register, consecutive threads on consecutive d so that
// every load and store of a time step coalesces.  Loads of a[t], b[t] do not
// depend on h, so the loop fetches 8 steps ahead before it updates h.
//
// What bounds it on this card: it moves 3 * B * T * D elements and does
// 2 * B * T * D flops, so bytes bind.  At B = 1, D = 2560 only 2560 threads
// (10 CTAs) run, so most of the card idles and the serial dependence on h
// sets the time over T = 4096; a chunked two-pass scan (per-chunk scans,
// then a scan of the chunk carries) is later work.  At decode (T = 1) the
// launch binds.
//
// Numerics: h = __fadd_rn(__fmul_rn(a, h), b), no FMA contraction, the order
// of the plain PyTorch version; bf16 outputs round to nearest even.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;  // time steps fetched before they are used

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

template <typename T>
int launch(const void* a, const void* b, void* out, int batch, int t_len,
           int d, cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, batch);
  linear_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      t_len, d);
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
