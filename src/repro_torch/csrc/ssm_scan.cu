// Diagonal linear-recurrence scan for Hopper (sm_90a): every state of
// h_t = a_t * h_{t-1} + b_t over [B, T, D], the scan of the SSM layers.
//
// Replaces: the Pallas TPU kernel of the JAX package,
//   src/repro/kernels/ssm_scan/ssm_scan.py
//   ssm_scan_batched (body _ssm_scan_kernel, doubling network _chunk_scan).
//
// What bounds it: a and b are read once and h written once, one
// multiply-add per element: 3 B T D values moved against B T D FMAs, so
// the scan is bound by memory bandwidth by two orders of magnitude. At
// Hymba-1.5B's SSM width (B = 2, T = 4096, D = 51,200 channels, float32)
// that is 5.03 GB, 1.50 ms at 3.35 TB/s.
//
// Design: one thread per (b, d) channel walks t in order and keeps the
// carry in a register. The TPU kernel's doubling network inside time
// chunks is not needed here: the card's parallelism comes from the B D
// independent channels, not from the time axis. A warp holds 32
// neighbouring channels, so each step's loads of a[b, t, d0:d0+32] are one
// coalesced request (128 bytes in float32). The loads of a step do not
// depend on the carry, so the thread loads U steps of a and b into
// registers before it runs them: that keeps enough bytes in flight to
// cover the memory latency at the main path's 102,400 channels. A
// bfloat16 step is half the bytes of a float32 one, so bfloat16 loads 16
// steps ahead where float32 and float64 load 8: no type has fewer bytes
// in flight per thread than float32. float32 and float64 compute in their
// own type; bfloat16 loads and stores bfloat16 and carries the state in
// float32.
//
// C interface (loaded with ctypes): ss_scan(dtype, B, T, D, a, b, h,
// stream) with dtype 0 = float32, 1 = float64, 2 = bfloat16 and densely
// packed [B, T, D] arrays. It launches on that stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ss {

constexpr int kThreads = 128;

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(double* p, double x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Thread i walks channel (i / D, i % D) over all `steps` states.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    int64_t BD, int64_t steps, int64_t D, const T* __restrict__ a,
    const T* __restrict__ b, T* __restrict__ h) {
  using A = typename Acc<T>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= BD) return;
  const int64_t bi = i / D;
  const int64_t o = bi * steps * D + (i - bi * D);
  A carry = A(0);
  int64_t t = 0;
  constexpr int U = sizeof(T) == 2 ? 16 : 8;
  for (; t + U <= steps; t += U) {
    A av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = widen(a[o + (t + u) * D]);
      bv[u] = widen(b[o + (t + u) * D]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      carry = av[u] * carry + bv[u];
      narrow(h + o + (t + u) * D, carry);
    }
  }
  for (; t < steps; ++t) {
    carry = widen(a[o + t * D]) * carry + widen(b[o + t * D]);
    narrow(h + o + t * D, carry);
  }
}

template <typename T>
int launch(int64_t B, int64_t steps, int64_t D, const void* a, const void* b,
           void* h, cudaStream_t s) {
  const int64_t BD = B * D;
  const unsigned blocks =
      static_cast<unsigned>((BD + kThreads - 1) / kThreads);
  ssm_scan_kernel<T><<<blocks, kThreads, 0, s>>>(
      BD, steps, D, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(h));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ss

extern "C" int ss_scan(int dtype, long long B, long long T, long long D,
                       const void* a, const void* b, void* h, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ss::launch<float>(B, T, D, a, b, h, s);
  if (dtype == 1) return ss::launch<double>(B, T, D, a, b, h, s);
  if (dtype == 2) return ss::launch<__nv_bfloat16>(B, T, D, a, b, h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
